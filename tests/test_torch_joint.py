"""The port's joint heads (``models/joint.py``) against the JAX package's:
``ConvJointHead`` (with and without the LayerNorm and the input dropout),
``TransformerJointHead`` (gated or not), ``RobertaClassificationHead`` and
the post-LN ``TorchTransformerEncoderLayer``, masked and unmasked, on a
batch with a short row and a fully masked one; the masked pools; the
converters; and the training-mode dropout by rate and mask shape.

The JAX heads' parameters are carried across with
``models/convert.joint_params_from_flax``. Bars: f32 outputs within 1e-5;
gradients (every parameter and both inputs) within 1e-5 of each tensor's
largest magnitude; a fully masked row pools to exactly 0 and passes exactly
0 gradient.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.models import joint as jjoint
from interspeech_ser_tpu_torch.models import joint
from interspeech_ser_tpu_torch.models.convert import joint_params_from_flax, joint_params_to_flax

torch.set_num_threads(2)
RNG = np.random.default_rng(11)
DW, DT, H = 12, 10, 8


def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(), 1e-30))


def batch():
    """Speech [3, 9, DW] and text [3, 6, DT] features: row 0 full, row 1
    short, row 2 fully masked (a padding row)."""
    wav = RNG.normal(size=(3, 9, DW)).astype(np.float32)
    txt = RNG.normal(size=(3, 6, DT)).astype(np.float32)
    wm = np.zeros((3, 9), np.float32)
    tm = np.zeros((3, 6), np.float32)
    wm[0], wm[1, :4] = 1, 1
    tm[0], tm[1, :3] = 1, 1
    return wav, txt, wm, tm


def flax_head(kind, **kw):
    if kind == "conv":
        return jjoint.ConvJointHead(DW, DT, H, **kw)
    return jjoint.TransformerJointHead(DW, DT, H, **kw)


def port_head(kind, params, classifier_layernorm=True, gated=False, **kw):
    if kind == "conv":
        head = joint.ConvJointHead(DW, DT, H, classifier_layernorm=classifier_layernorm, **kw)
    else:
        head = joint.TransformerJointHead(DW, DT, H, gated=gated, **kw)
    sd = joint_params_from_flax(jax.tree.map(np.asarray, params), kind, classifier_layernorm, 2, gated)
    assert list(sd) == list(head.state_dict()) or sorted(sd) == sorted(head.state_dict())
    head.load_state_dict(sd, strict=True)
    return head


def check_outputs_and_grads(fm, params, head, masked, gated):
    """Outputs, and the gradients of sum(out * cotangent) with respect to
    every parameter and both inputs, JAX vs port."""
    wav, txt, wm, tm = batch()
    cots = [RNG.normal(size=(3, 8)).astype(np.float32)] + ([RNG.normal(size=(3, H)).astype(np.float32)] * 2
                                                           if gated else [])
    masks = (jnp.asarray(wm), jnp.asarray(tm)) if masked else (None, None)

    def f(p, w, t):
        out = fm.apply({"params": p}, w, t, *masks)
        out = out if gated else (out,)
        return sum(jnp.sum(o * jnp.asarray(c)) for o, c in zip(out, cots)), out

    (_, want), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(wav),
                                                                            jnp.asarray(txt))
    w_t, t_t = torch.tensor(wav, requires_grad=True), torch.tensor(txt, requires_grad=True)
    out = head(w_t, t_t, *((torch.from_numpy(wm), torch.from_numpy(tm)) if masked else (None, None)))
    out = out if gated else (out,)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cots)).backward()
    for o, w in zip(out, want):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w), atol=1e-5, rtol=0)
    kind = "conv" if isinstance(head, joint.ConvJointHead) else "transformer"
    want_p = joint_params_from_flax(jax.tree.map(np.asarray, grads[0]), kind,
                                    getattr(head, "classifier_layernorm", True), 2, gated)
    for k, p in head.named_parameters():
        assert rel(p.grad.numpy(), want_p[k].numpy()) <= 1e-5, (k, rel(p.grad.numpy(), want_p[k].numpy()))
    for got, w in ((w_t.grad, grads[1]), (t_t.grad, grads[2])):
        assert rel(got.numpy(), np.asarray(w)) <= 1e-5
    if masked:  # the padding row: exactly 0 gradient into its features
        assert not w_t.grad[2].abs().any() and not t_t.grad[2].abs().any()
    return out


@pytest.mark.parametrize("ln,input_dropout,masked", [(True, True, True), (False, False, True), (True, True, False)])
def test_conv_head_matches_jax(ln, input_dropout, masked):
    fm = flax_head("conv", input_dropout=input_dropout, classifier_layernorm=ln, masked=masked)
    wav, txt, wm, tm = batch()
    params = fm.init(jax.random.PRNGKey(0), jnp.asarray(wav), jnp.asarray(txt))["params"]
    head = port_head("conv", params, ln, input_dropout=input_dropout, masked=masked)
    check_outputs_and_grads(fm, params, head, masked, False)


@pytest.mark.parametrize("gated,masked", [(False, True), (True, True), (True, False)])
def test_transformer_head_matches_jax(gated, masked):
    fm = flax_head("transformer", gated=gated, masked=masked)
    wav, txt, wm, tm = batch()
    params = fm.init(jax.random.PRNGKey(1), jnp.asarray(wav), jnp.asarray(txt))["params"]
    head = port_head("transformer", params, gated=gated, masked=masked)
    out = check_outputs_and_grads(fm, params, head, masked, gated)
    if gated and masked:  # the padding row's gated features: sigmoid(bias) * 0
        assert not out[1][2].abs().any() and not out[2][2].abs().any()


def test_masked_pools_and_a_fully_masked_row():
    """Both pools against JAX's on a short row and a dead row: the dead row
    max-pools to exactly 0 with exactly 0 gradient (not -1e30), in both."""
    x = RNG.normal(size=(3, 7, 5)).astype(np.float32)
    m = np.array([[1] * 7, [1, 1, 1, 0, 0, 0, 0], [0] * 7], np.float32)
    for mine, theirs in ((joint.masked_max_pool, jjoint._masked_max_pool),
                         (joint.masked_mean_pool, jjoint._masked_mean_pool)):
        for mask in (m, None):
            xt = torch.tensor(x, requires_grad=True)
            got = mine(xt, None if mask is None else torch.from_numpy(mask))
            got.sum().backward()
            f = lambda a: jnp.sum(theirs(a, None if mask is None else jnp.asarray(mask)))  # noqa: E731
            want = theirs(jnp.asarray(x), None if mask is None else jnp.asarray(mask))
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)
            np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jax.grad(f)(jnp.asarray(x))), atol=1e-6, rtol=0)
            if mask is not None:
                assert not got[2].abs().any() and not xt.grad[2].abs().any()
                assert not xt.grad[1, 3:].abs().any()


def test_max_pool_splits_a_tie_as_jax_does():
    x = np.zeros((1, 4, 2), np.float32)
    x[0, 1, 0] = x[0, 3, 0] = 2.0
    xt = torch.tensor(x, requires_grad=True)
    joint.masked_max_pool(xt, torch.ones(1, 4)).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jjoint._masked_max_pool(a, jnp.ones((1, 4)))))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


def test_encoder_layer_matches_torch_and_jax():
    """The post-LN layer against torch's own ``nn.TransformerEncoderLayer``
    (eval, key padding mask) and the JAX layer, on the same weights."""
    D, FF = 16, 64
    ref = torch.nn.TransformerEncoderLayer(D, 1, FF, dropout=0.5, batch_first=True).eval()
    mine = joint.TorchTransformerEncoderLayer(D, 1, FF)
    mine.load_state_dict(ref.state_dict(), strict=True)
    x = RNG.normal(size=(2, 9, D)).astype(np.float32)
    mask = np.ones((2, 9), np.float32)
    mask[1, 5:] = 0
    with torch.no_grad():
        got = mine(torch.from_numpy(x), torch.from_numpy(mask))
        want = ref(torch.from_numpy(x), src_key_padding_mask=torch.from_numpy(mask == 0))
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1, :5].numpy(), want[1, :5].numpy(), atol=1e-5, rtol=0)
    params = jjoint._tel_torch_to_flax({f"l.{k}": v.numpy() for k, v in ref.state_dict().items()}, "l")
    jl = jjoint.TorchTransformerEncoderLayer(D, 1, FF, dropout=0.5)
    want = jl.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_roberta_classification_head_matches_jax():
    D = 16
    fm = jjoint.RobertaClassificationHead(D, 8)
    hidden = RNG.normal(size=(3, 5, D)).astype(np.float32)
    params = fm.init(jax.random.PRNGKey(2), jnp.asarray(hidden))["params"]
    head = joint.RobertaClassificationHead(D, 8)
    head.load_state_dict({f"{m}.{t}": torch.tensor(np.asarray(params[m][f]).T if f == "kernel" else
                                                   np.asarray(params[m][f]))
                          for m in ("dense", "out_proj") for t, f in (("weight", "kernel"), ("bias", "bias"))})
    with torch.no_grad():
        got = head(torch.from_numpy(hidden))
    np.testing.assert_allclose(got.numpy(), np.asarray(fm.apply({"params": params}, jnp.asarray(hidden))),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind,ln,gated", [("conv", True, False), ("conv", False, False),
                                           ("transformer", True, False), ("transformer", True, True)])
def test_converters_match_jax(kind, ln, gated):
    """``joint_params_from_flax`` gives the JAX converter's ``final_ser.pt``
    keys and values; ``joint_params_to_flax`` gives back the JAX params; the
    port's ``*_flax_to_torch`` / ``*_torch_to_flax`` return the head's own
    state dict as f32 CPU copies and refuse a foreign key set."""
    wav, txt, _, _ = batch()
    fm = flax_head(kind, **({"classifier_layernorm": ln} if kind == "conv" else {"gated": gated}))
    params = jax.tree.map(np.asarray, fm.init(jax.random.PRNGKey(3), jnp.asarray(wav), jnp.asarray(txt))["params"])
    if kind == "conv":
        ref = jjoint.conv_joint_flax_to_torch(params, ln)
        to_file, from_file = (lambda sd: joint.conv_joint_flax_to_torch(sd, ln),
                              lambda sd: joint.conv_joint_torch_to_flax(sd, ln))
    else:
        ref = jjoint.transformer_joint_flax_to_torch(params, gated=gated)
        to_file, from_file = (lambda sd: joint.transformer_joint_flax_to_torch(sd, 2, gated),
                              lambda sd: joint.transformer_joint_torch_to_flax(sd, 2, gated))
    sd = joint_params_from_flax(params, kind, ln, 2, gated)
    assert set(sd) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k], err_msg=k)
    back = joint_params_to_flax(sd, kind, ln, 2, gated)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    file = to_file(sd)
    assert file.keys() == sd.keys() and all(torch.equal(file[k], sd[k]) for k in sd)
    assert all(torch.equal(from_file(file)[k], sd[k]) for k in sd)
    with pytest.raises(KeyError):
        to_file({**sd, "extra.weight": sd["classifier.0.weight"]})


def _record(monkeypatch, module, name, seen, rate_of=lambda p: p):
    """Record (rate, shape) of every dropout drawn through ``module.name``."""
    real = getattr(module, name)

    def recording(*args, **kw):
        if name == "dropout":  # (x, p, generator)
            if args[1] > 0:
                seen.append((round(args[1], 6), tuple(args[0].shape)))
        else:  # jax.random.bernoulli(key, p=keep, shape=...)
            seen.append((round(rate_of(kw["p"]), 6), tuple(kw["shape"])))
        return real(*args, **kw)
    monkeypatch.setattr(module, name, recording)


@pytest.mark.parametrize("kind", ["conv", "transformer"])
def test_training_dropout_rates_and_shapes_match_jax(kind, monkeypatch):
    """With a generator the port drops at the JAX head's rates on tensors of
    the JAX dropouts' shapes, the attention weights' included (the random
    streams differ, so the draws are compared as multisets of (rate,
    shape)); without one it is deterministic. A large tensor's kept share
    matches 1 - p and the kept values are scaled by 1 / (1 - p)."""
    from flax.linen import stochastic

    from interspeech_ser_tpu_torch.ops import attention_core

    wav, txt, wm, tm = batch()
    fm = flax_head(kind, gated=True) if kind == "transformer" else flax_head(kind)
    params = fm.init(jax.random.PRNGKey(4), jnp.asarray(wav), jnp.asarray(txt))["params"]
    jax_seen, seen = [], []
    _record(monkeypatch, stochastic.random, "bernoulli", jax_seen, rate_of=lambda keep: 1.0 - keep)
    fm.apply({"params": params}, jnp.asarray(wav), jnp.asarray(txt), jnp.asarray(wm), jnp.asarray(tm),
             deterministic=False, rngs={"dropout": jax.random.PRNGKey(5)})
    head = port_head(kind, params, gated=kind == "transformer")
    _record(monkeypatch, joint, "dropout", seen)
    _record(monkeypatch, attention_core, "dropout", seen)
    args = [torch.from_numpy(a) for a in (wav, txt, wm, tm)]
    g = torch.Generator().manual_seed(0)
    first = lambda o: o[0] if kind == "transformer" else o  # noqa: E731
    a = first(head(*args, generator=g))
    assert sorted(seen) == sorted(jax_seen) and len(seen) == (5 if kind == "conv" else 19)
    assert not torch.equal(a, first(head(*args, generator=g)))
    seen.clear()
    c, d = first(head(*args)), first(head(*args))
    assert not seen and torch.equal(c, d)
    x = torch.ones(200_000)
    y = attention_core.dropout(x, 0.5, torch.Generator().manual_seed(1))
    assert abs(float((y > 0).float().mean()) - 0.5) < 0.005 and set(torch.unique(y).tolist()) == {0.0, 2.0}
