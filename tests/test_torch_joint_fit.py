"""The port's joint trainers' ``fit`` against the JAX package's: the epoch
order of ``epoch_batches`` and of the balanced sampler, the cosine lr of
``cosine_step``, gradient accumulation with a short last group, and one
text-only train step (with and without focal loss) and fit.

The corpus and tokenizer are ``tests/test_torch_joint_engine.py``'s. Dropout
is off on both sides (the JAX engine's ``_apply`` forced deterministic, the
port's generator taken away), so that one epoch of each engine from the
same weights can be held together: parameters within 1e-5, dev losses
within 1e-5, the batches' rows equal. Text-only step: the loss within 1e-5
relative, each gradient within 1e-5 of its tensor's largest magnitude (of
1e-4 of the step's largest gradient where the tensor's is smaller: the
``key`` biases, whose gradient a softmax zeroes but for rounding).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.baseline import data as jdata
from interspeech_ser_tpu.train import joint_engine as jje
from interspeech_ser_tpu.train import losses as jlosses
from interspeech_ser_tpu_torch.baseline import data as bdata
from interspeech_ser_tpu_torch.models.convert import joint_params_from_flax, roberta_params_from_flax
from interspeech_ser_tpu_torch.train import joint_engine
from interspeech_ser_tpu_torch.utils.seeding import numpy_generator
from test_torch_joint_engine import N_TRAIN, dummy_tokenize, engines, head_kw, write_joint_corpus

torch.set_num_threads(2)


class RecordingRng:
    """A numpy Generator that records what ``choice`` draws and with which ``p``."""

    def __init__(self, rng):
        self.rng, self.draws = rng, []

    def choice(self, *args, **kw):
        out = self.rng.choice(*args, **kw)
        self.draws.append((np.asarray(kw.get("p")), np.asarray(out)))
        return out

    def __getattr__(self, name):
        return getattr(self.rng, name)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_joint_corpus(tmp_path_factory.mktemp("joint_fit"))


def test_cosine_step_lr_matches_optax():
    """The head's lr before each update: optax's schedule, clamped at T."""
    lr, t_max = 3e-4, 7
    sched = optax.cosine_decay_schedule(lr - 1e-6, t_max, alpha=0.0)
    for count in range(t_max + 3):
        want = float(sched(jnp.minimum(count, t_max)) + 1e-6)
        assert abs(joint_engine.cosine_step_lr(lr, count, t_max) - want) <= 1e-7 * lr, count


def test_epoch_order_and_balanced_weights_match_jax():
    lengths = np.asarray([3000, 9000, 17000, 40000, 16000, 2000] * 4)
    for shuffle in (True, False):
        a = bdata.epoch_batches(24, 2, numpy_generator(3), shuffle, lengths)
        b = jdata.epoch_batches(24, 2, numpy_generator(3), shuffle, lengths)
        assert [list(map(int, x)) for x in a] == [list(map(int, x)) for x in b]
    labs = np.eye(8)[[0, 3, 3, 5, 0, 0, 7]]
    np.testing.assert_array_equal(bdata.inverse_freq_sample_weights(labs), jdata.inverse_freq_sample_weights(labs))


def deterministic(je, pe):
    """Dropout off in both engines' training steps."""
    real = je._apply
    je._apply = lambda p, w, wm, ti, tm, det, dkey=None: real(p, w, wm, ti, tm, True)
    pe.generator = None


def run_fits(corpus, tmp_path, variant, monkeypatch, **kw):
    """One epoch of each engine from the same weights; -> (JAX best, port
    best, JAX head params, port head state, the rows each collated, the rng
    draws of each)."""
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jdata), ("port", bdata)):
        real = mod.collate_txt_wav
        monkeypatch.setattr(mod, "collate_txt_wav", lambda ws, ts, idxs, rows, _r=real, _n=name: (
            seen[_n].append((len(ws), [int(i) for i in idxs], rows)) or _r(ws, ts, idxs, rows)))
    je, pe = engines(corpus, variant)
    deterministic(je, pe)
    je.rng, pe.rng = RecordingRng(je.rng), RecordingRng(pe.rng)
    args = dict(label_path=str(corpus / "labels.csv"), audio_path=str(corpus / "audio"),
                txt_path=str(corpus / "transcripts.csv"), epochs=1, lr=1e-3, **kw)
    jbest = je.fit(model_path=str(tmp_path / "jax"), **args)
    pbest = pe.fit(model_path=str(tmp_path / "port"), **args)
    head = joint_params_from_flax(jax.tree.map(np.asarray, je.params["head"]), **head_kw(variant))
    return jbest, pbest, head, pe.head.state_dict(), seen, (je.rng.draws, pe.rng.draws)


def check_head(got, want, updates, lr):
    """Head parameters within 1e-5 of JAX's, but for the key third of each
    attention's ``in_proj_bias``: its true gradient is 0 (a softmax ignores a
    shift shared by a row's scores), so Adam turns each package's rounding
    noise (~1e-9) into steps of either sign; there both stay within
    ``updates`` steps of ``lr`` of each other."""
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        if k.endswith("self_attn.in_proj_bias"):
            third = len(w) // 3
            assert np.abs(g[third: 2 * third] - w[third: 2 * third]).max() <= 2 * updates * lr, k
            g, w = np.delete(g, np.s_[third: 2 * third]), np.delete(w, np.s_[third: 2 * third])
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=k)


def test_accumulation_and_cosine_fit_matches_jax(corpus, tmp_path, monkeypatch):
    """``large`` (``cosine_step``, dev weights of the dev split) for one epoch
    at batch 6 with 3 accumulation steps: 7 micro-batches of 2 rows in
    ``epoch_batches``' order, updates after 3, 3 and 1 (the short last group
    divided by 1). The rows, the head's parameters after the 3 updates and
    the dev loss equal JAX's; ``final_ser.pt`` of both the same. With the
    short group divided by 3 instead, the port's parameters leave the bar
    (so the comparison sees the divisor, though Adam scales out a divisor
    common to all updates)."""
    kw = dict(batch_size=6, accumulation_steps=3)
    jbest, pbest, want, got, seen, _ = run_fits(corpus, tmp_path, "large", monkeypatch, **kw)
    train = [s for s in seen["port"] if s[0] == N_TRAIN]
    assert seen["port"] == seen["jax"] and [len(s[1]) for s in train] == [2] * 7
    assert jbest["epoch"] == pbest["epoch"] == 0
    check_head(got, want, 3, 1e-3)
    assert abs(pbest["loss"] - jbest["loss"]) <= 1e-5
    jf = torch.load(tmp_path / "jax" / "final_ser.pt", weights_only=True)
    pf = torch.load(tmp_path / "port" / "final_ser.pt", weights_only=True)
    assert set(jf) == set(pf)
    check_head(pf, {k: torch.as_tensor(np.asarray(v)) for k, v in jf.items()}, 3, 1e-3)

    # the same port run with every update divided by accumulation_steps
    real = joint_engine._update
    monkeypatch.setattr(joint_engine, "_update", lambda opt, params, n: real(opt, params, 3))
    je, pe = engines(corpus, "large")
    pe.generator = None
    pe.fit(str(corpus / "labels.csv"), str(corpus / "audio"), str(corpus / "transcripts.csv"),
           str(tmp_path / "wrong"), epochs=1, lr=1e-3, **kw)
    with pytest.raises(AssertionError):
        check_head(pe.head.state_dict(), want, 3, 1e-3)


def test_balanced_cka_fit_matches_jax(corpus, tmp_path, monkeypatch):
    """``cka`` with balanced batches: the rows drawn with replacement by
    inverse class frequency (the same ``p`` and draws), the micro-batches,
    the parameters after the epoch and the dev loss. Micro-batches of 4
    rows: one of 2 that draws one row twice has a CKA term whose JAX
    gradient is NaN (``test_cka_of_vanished_features``)."""
    kw = dict(batch_size=8, accumulation_steps=2, use_balanced_batch=True)
    jbest, pbest, want, got, seen, (jd, pd_) = run_fits(corpus, tmp_path, "cka", monkeypatch, **kw)
    assert len(jd) == len(pd_) == 1
    np.testing.assert_array_equal(jd[0][0], pd_[0][0])
    np.testing.assert_array_equal(jd[0][1], pd_[0][1])
    assert seen["port"] == seen["jax"]
    assert [len(set(s[1])) > 1 for s in seen["port"] if s[0] == N_TRAIN] == [True] * 4
    check_head(got, want, 2, 1e-3)
    assert abs(pbest["loss"] - jbest["loss"]) <= 1e-5 and pbest["epoch"] == jbest["epoch"]


def test_cka_of_vanished_features():
    """A batch whose centred features vanish (one row drawn twice, or one
    live row beside padding): the CKA term is 1 in both packages; its JAX
    gradient is NaN (the square root at 0), the port's 0."""
    from interspeech_ser_tpu_torch.train import losses

    row = np.random.default_rng(2).normal(size=(1, 6)).astype(np.float32)
    for feats, mask in ((np.repeat(row, 2, 0), None), (np.concatenate([row, row + 1]), np.array([1, 0], np.float32))):
        m = None if mask is None else jnp.asarray(mask)
        value, grad = jax.value_and_grad(lambda a: jlosses.cka_loss(a, a * 2.0, m))(jnp.asarray(feats))
        a = torch.tensor(feats, requires_grad=True)
        got = losses.cka_loss(a, a * 2.0, None if mask is None else torch.from_numpy(mask))
        got.backward()
        assert float(value) == got.item() == 1.0
        assert np.isnan(np.asarray(grad)).any() and not a.grad.abs().any()


# -- the text-only trainer --------------------------------------------------------


def text_engines(corpus, seed=3):
    je = jje.TextOnlyEngine(str(corpus / "hf_roberta"), dummy_tokenize, seed=seed, n_devices=1)
    pe = joint_engine.TextOnlyEngine(str(corpus / "hf_roberta"), dummy_tokenize, seed=seed, device="cpu")
    p = jax.tree.map(np.asarray, je.params)
    pe.txt.load_state_dict(roberta_params_from_flax(p["txt"], je.txt_cfg))
    pe.cls_head.load_state_dict({f"{m}.{t}": torch.tensor(p["head"][m][f].T if f == "kernel" else p["head"][m][f])
                                 for m in ("dense", "out_proj") for t, f in (("weight", "kernel"), ("bias", "bias"))})
    return je, pe


def text_named(tree, je):
    t = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    out = {f"txt.{k}": v.numpy() for k, v in roberta_params_from_flax(t["txt"], je.txt_cfg).items()}
    out.update({f"cls_head.{m}.{n}": t["head"][m][f].T if f == "kernel" else t["head"][m][f]
                for m in ("dense", "out_proj") for n, f in (("weight", "kernel"), ("bias", "bias"))})
    return out


@pytest.mark.parametrize("use_focalloss", [False, True])
def test_text_only_step_matches_jax(corpus, use_focalloss):
    je, pe = text_engines(corpus)
    rng = np.random.default_rng(5)
    toks = dummy_tokenize(["sample text 3 " * 3, "", "sample text 1 sample", "x"])
    ids, mask = toks["input_ids"], toks["attention_mask"]
    ids[3], mask[3] = 0, 0  # a padding row, as fit fills one
    y = np.array([3, 0, 1, 0], np.int64)
    smask = np.array([1, 1, 1, 0], np.float32)
    cw = rng.uniform(0.5, 2.0, 8).astype(np.float32)

    def loss_fn(p):
        logits = je._apply(p, jnp.asarray(ids), jnp.asarray(mask), True)
        loss = jlosses.weighted_cross_entropy(logits, jnp.asarray(y), jnp.asarray(cw), jnp.asarray(smask))
        if use_focalloss:
            loss = loss + jlosses.focal_loss(logits, jnp.asarray(y), alpha=1.0, gamma=3.0, dynamic_alpha=True,
                                             sample_mask=jnp.asarray(smask))
        return loss

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(je.params)
    loss = pe.loss(ids, mask, y, smask, torch.from_numpy(cw), use_focalloss, deterministic=True)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want = text_named(want, je)
    got = {f"{m}.{k}": p.grad.numpy() for m in ("txt", "cls_head") for k, p in getattr(pe, m).named_parameters()}
    assert set(got) == set(want)
    floor = 1e-4 * max(np.abs(v).max() for v in want.values())
    for k in want:
        err = np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), floor)
        assert err <= 1e-5, (k, err)


def test_text_only_balanced_fit_matches_jax(corpus, tmp_path):
    """One balanced epoch at batch 4 with 2 accumulation steps (4
    micro-batches, the last with 2 padding rows): the same ``p`` and draws,
    the parameters after it within 1e-5, the dev loss and accuracy, and
    ``text_ser.pt``'s keys."""
    je, pe = text_engines(corpus)
    deterministic_text = je._apply
    je._apply = lambda p, i, m, det, dkey=None: deterministic_text(p, i, m, True)
    pe.generator = None
    je.rng, pe.rng = RecordingRng(je.rng), RecordingRng(pe.rng)
    args = dict(label_path=str(corpus / "labels.csv"), txt_path=str(corpus / "transcripts.csv"), batch_size=4,
                accumulation_steps=2, epochs=1, lr=1e-3, use_focalloss=True, use_balanced_batch=True)
    jbest = je.fit(model_path=str(tmp_path / "jax"), **args)
    pbest = pe.fit(model_path=str(tmp_path / "port"), **args)
    for (jp, jo), (pp, po) in zip(je.rng.draws, pe.rng.draws):
        np.testing.assert_array_equal(jp, pp)
        np.testing.assert_array_equal(jo, po)
    assert len(pe.rng.draws) == 1
    want = text_named(je.params, je)
    got = {f"{m}.{k}": v.numpy() for m in ("txt", "cls_head") for k, v in getattr(pe, m).state_dict().items()}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)
    assert abs(pbest["loss"] - jbest["loss"]) <= 1e-5 and pbest["acc"] == jbest["acc"]
    jf = torch.load(tmp_path / "jax" / "text_ser.pt", weights_only=True)
    pf = torch.load(tmp_path / "port" / "text_ser.pt", weights_only=True)
    assert set(jf) == set(pf) and all(np.abs(np.asarray(jf[k]) - pf[k].numpy()).max() <= 1e-5 for k in pf)
