"""The non-LoRA fine-tune methods (``adapter``, ``adapter_l``,
``embedding_prompt``, ``combined``) of the port's speech encoder, the
``models/lora.py`` fine-tune helpers, ``WavLMWrapperModel`` and
``lora_model.build_wavlm_wrapper`` against the JAX package's
(``lora_wavlm/model.py::build_wavlm_wrapper``).

Two small WavLM directories (D = 48, 2 layers, 4 heads): pre-LN with a
layer-norm frontend and post-LN with a group-norm frontend. A fresh adapter
outputs exactly 0, so the JAX wrapper's tuned tensors are redrawn (seeded,
non-zero) and carried into the port before the comparison. Tolerances:
logits and hidden states within 1e-4 max abs (f32, other summation orders);
every tuned and head gradient within 1e-4 of the largest entry of its
tensor; a fresh adapter's forward within 1e-6 of the base encoder's.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

from interspeech_ser_tpu.models import lora as jlora  # noqa: E402
from interspeech_ser_tpu.train.lora_engine import WavLMWrapperModel as JaxHead  # noqa: E402
from interspeech_ser_tpu_torch import lora_model  # noqa: E402
from interspeech_ser_tpu_torch.models import convert, lora  # noqa: E402
from interspeech_ser_tpu_torch.models.speech import Adapter, SpeechConfig, SpeechEncoderModel  # noqa: E402
from interspeech_ser_tpu_torch.train.lora_engine import WavLMWrapperModel  # noqa: E402

torch.set_num_threads(2)

PRE = dict(hidden_size=48, num_layers=2, num_heads=4, intermediate_size=96, conv_dim=(16,) * 3,
           conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2), conv_bias=True, feat_extract_norm="layer",
           do_stable_layer_norm=True, attention_type="wavlm", num_buckets=32, max_distance=64,
           num_conv_pos_embeddings=16, conv_pos_groups=4)
POST = dict(PRE, conv_bias=False, feat_extract_norm="group", do_stable_layer_norm=False)
LENGTHS = (3000, 2200)
RANK, HIDDEN = 4, 16


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{'pre', 'post'}: seeded HF-format WavLM directories (the port's HF key names)."""
    out = {}
    for name, cfg in (("pre", PRE), ("post", POST)):
        d = str(tmp_path_factory.mktemp(name))
        torch.manual_seed(3)
        model = SpeechEncoderModel(SpeechConfig(**cfg))
        with torch.no_grad():
            for n, p in model.named_parameters():
                if "norm" in n:  # off their ones / zeros init, so that a swapped norm shows
                    p.add_(0.1 * torch.randn(p.shape))
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({**model.config.to_hf(), "architectures": ["WavLMModel"]}, f)
        torch.save(model.state_dict(), os.path.join(d, "pytorch_model.bin"))
        out[name] = d
    return out


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    wav = np.zeros((len(LENGTHS), max(LENGTHS)), np.float32)
    mask = np.zeros_like(wav)
    for i, n in enumerate(LENGTHS):
        wav[i, :n] = rng.standard_normal(n)
        mask[i, :n] = 1
    return wav, mask


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max() <= 1e-4 * max(np.abs(ref).max(), 1e-6), (what, np.abs(got - ref).max())


@pytest.mark.parametrize("method,ln", [("adapter", "pre"), ("adapter", "post"), ("adapter_l", "pre"),
                                       ("embedding_prompt", "post"), ("embedding_prompt", "pre"),
                                       ("combined", "post"), ("lora", "pre")])
def test_wrapper_forward_and_grads_match_jax(dirs, method, ln):
    """Each method: the tuned set's names, the logits over a padded batch and
    the gradients of every tuned tensor and of the head, with non-zero
    adapter / LoRA-B weights."""
    spec = importlib.util.spec_from_file_location("lora_wavlm_model", os.path.join(ROOT, "lora_wavlm", "model.py"))
    jax_model = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_model)
    jax_build = jax_model.build_wavlm_wrapper

    jmodel, base, jtuned, jhead, jhead_params = jax_build(dirs[ln], method, lora_rank=RANK, hidden_dim=HIDDEN)
    base = jax.tree.map(jnp.asarray, base)  # the relative-position table is indexed under jit
    rng = np.random.default_rng(11)
    jtuned = jax.tree.map(lambda v: jnp.asarray(0.2 * rng.standard_normal(np.shape(v)), jnp.float32), jtuned)
    jl = jtuned["lora"] if method == "combined" else (jtuned if method == "lora" else {})
    jf = jtuned["finetune"] if method == "combined" else ({} if method == "lora" else jtuned)

    w = lora_model.build_wavlm_wrapper(dirs[ln], method, lora_rank=RANK, hidden_dim=HIDDEN, device="cpu")
    w.head.eval()
    full = jax.tree.map(np.asarray, jlora.merge_finetune_params(base, jf))
    port_sd = convert.speech_params_from_flax(full, w.encoder.config)
    assert set(w.finetune) == {k for k in port_sd if lora.is_finetune_key(k)}
    assert set(w.lora) == {k.rsplit(".", 1)[0] for k in jlora.lora_state_dict(jl)}
    with torch.no_grad():
        w.encoder.load_state_dict(port_sd, strict=True)
        w.head.load_state_dict(convert.flax_flat_to_port(convert.flatten_flax(jhead_params)), strict=True)
        for key, val in lora.lora_from_state_dict(jlora.lora_state_dict(jl)).items():
            for leaf in ("lora_A", "lora_B"):
                w.lora[key][leaf].copy_(val[leaf])

    wav, mask = _batch()

    def jloss(tl, tf, hp):
        p = jlora.merge_lora(jlora.merge_finetune_params(base, tf), tl, 16.0, RANK) if tl else \
            jlora.merge_finetune_params(base, tf)
        out = jmodel.apply({"params": p}, jnp.asarray(wav), jnp.asarray(mask))
        logits = jhead.apply({"params": hp}, out["hidden_states"], out["frame_mask"].sum(axis=1))
        return jnp.sum(logits ** 2), logits

    (_, jlogits), (gl, gf, gh) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jl, jf, jhead_params)
    logits = w.forward(torch.from_numpy(wav), torch.from_numpy(mask))
    logits.square().sum().backward()
    _close(logits.detach(), jlogits, "logits")
    grads = convert.speech_params_from_flax(jax.tree.map(np.asarray, jlora.merge_finetune_params(base, gf)),
                                            w.encoder.config)
    for name, prm in w.finetune.items():
        _close(prm.grad, grads[name], name)
    for key, val in lora.lora_from_state_dict(jlora.lora_state_dict(gl)).items():
        for leaf in ("lora_A", "lora_B"):
            _close(w.lora[key][leaf].grad, val[leaf], f"{key}.{leaf}")
    for name, g in convert.flax_flat_to_port(convert.flatten_flax(jax.tree.map(np.asarray, gh))).items():
        _close(dict(w.head.named_parameters())[name].grad, g, name)
    assert all(p.grad is None for n, p in w.encoder.named_parameters() if not lora.is_finetune_key(n))


@pytest.mark.parametrize("method", ["adapter", "adapter_l"])
@pytest.mark.parametrize("ln", ["pre", "post"])
def test_fresh_adapters_are_the_identity(dirs, method, ln):
    wav, mask = _batch(6)
    w = lora_model.build_wavlm_wrapper(dirs["pre" if ln == "pre" else "post"], method, device="cpu")
    base = lora_model.build_wavlm_wrapper(dirs["pre" if ln == "pre" else "post"], "lora", device="cpu")
    with torch.no_grad():
        out = w.hidden_states(torch.from_numpy(wav), torch.from_numpy(mask))["hidden_states"]
        ref = base.encoder(torch.from_numpy(wav), torch.from_numpy(mask))["hidden_states"]
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    assert all(float(p.abs().max()) > 0 for n, p in w.finetune.items() if ".down.weight" in n)


def test_prompt_padded_batch_equals_batch1(dirs):
    """embedding_prompt on the layer-norm frontend: each row of a padded batch
    equals its unpadded batch-1 forward (the prompt rows attend and are
    attended, the padded keys stay masked)."""
    w = lora_model.build_wavlm_wrapper(dirs["pre"], "embedding_prompt", device="cpu")
    wav, mask = _batch(7)
    with torch.no_grad():
        out = w.hidden_states(torch.from_numpy(wav), torch.from_numpy(mask))
        for i, n in enumerate(LENGTHS):
            single = w.hidden_states(torch.from_numpy(wav[i:i + 1, :n]))["last_hidden_state"][0]
            t = single.shape[0]
            np.testing.assert_allclose(out["last_hidden_state"][i, :t].numpy(), single.numpy(), atol=1e-5, rtol=0)


def test_init_distributions():
    """The prompt's bound is flax xavier_uniform's on (1, P, D), sqrt(6 / (P + D));
    ``Adapter.down`` is lecun-normal (truncated at 2 std), ``up`` zeros."""
    cfg = SpeechConfig(**dict(PRE, hidden_size=768, num_heads=12, intermediate_size=64,
                              finetune_method="combined"))
    layer = SpeechEncoderModel(cfg).encoder.layers[0]
    bound = (6.0 / (5 + 768)) ** 0.5
    prompt = layer.embed_prompt.detach()
    assert prompt.shape == (1, 5, 768) and float(prompt.abs().max()) <= bound and float(prompt.abs().max()) > 0.95 * bound
    assert abs(float(prompt.std()) - bound / 3 ** 0.5) < 0.05 * bound
    ad = Adapter(768, 128)
    ad.reset_parameters(torch.Generator().manual_seed(0))
    std = (1 / 768) ** 0.5
    w = ad.down.weight.detach()
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert abs(float(w.std()) - std) < 0.02 * std
    assert not ad.up.weight.any() and not ad.up.bias.any() and not ad.down.bias.any()
    x = torch.randn(2, 3, 768)
    assert not ad(x).any()


def test_split_merge_add_and_freeze(dirs):
    cfg = SpeechConfig(**dict(POST, finetune_method="combined"))
    model = SpeechEncoderModel(cfg)
    sd = model.state_dict()
    base, tuned = lora.split_finetune_params(sd)
    assert set(tuned) == {f"encoder.layers.{i}.{k}" for i in range(2) for k in (
        "adapter.down.weight", "adapter.down.bias", "adapter.up.weight", "adapter.up.bias", "embed_prompt")}
    merged = lora.merge_finetune_params(base, tuned)
    assert list(merged) and all(torch.equal(merged[k], sd[k]) for k in sd) and set(merged) == set(sd)
    base_sd = torch.load(os.path.join(dirs["post"], "pytorch_model.bin"), weights_only=True)
    a = lora.add_finetune_params(SpeechEncoderModel(cfg), base_sd, torch.Generator().manual_seed(1))
    b = lora.add_finetune_params(SpeechEncoderModel(cfg), base_sd, torch.Generator().manual_seed(1))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k  # the same draw
        if not lora.is_finetune_key(k):
            assert torch.equal(v, base_sd[k]), k
    with pytest.raises(KeyError):
        lora.add_finetune_params(SpeechEncoderModel(cfg), {**base_sd, "encoder.extra": torch.zeros(1)})
    lora.freeze_base(a)
    assert {n for n, p in a.named_parameters() if p.requires_grad} == set(tuned)


@pytest.mark.parametrize("use_conv_output", [True, False])
@pytest.mark.parametrize("with_lengths", [True, False])
def test_wavlm_wrapper_head_matches_jax(use_conv_output, with_lengths):
    rng = np.random.default_rng(3)
    states = [rng.standard_normal((2, 9, 12)).astype(np.float32) for _ in range(4)]
    lengths = np.asarray([9, 5], np.int32)
    jhead = JaxHead(num_layers=3, hidden_size=12, hidden_dim=8, output_class_num=4, use_conv_output=use_conv_output)
    params = jax.jit(jhead.init)(jax.random.PRNGKey(0), [jnp.asarray(s) for s in states])["params"]
    params = jax.tree.map(lambda v: np.asarray(v) + 0.1 * rng.standard_normal(np.shape(v)).astype(np.float32), params)
    ref = jhead.apply({"params": params}, [jnp.asarray(s) for s in states],
                      jnp.asarray(lengths) if with_lengths else None)
    head = WavLMWrapperModel(3, 12, hidden_dim=8, output_class_num=4, use_conv_output=use_conv_output).eval()
    assert head.layer_weights.shape == (4 if use_conv_output else 3,)
    head.load_state_dict(convert.flax_flat_to_port(convert.flatten_flax(params)), strict=True)
    with torch.no_grad():
        out = head([torch.from_numpy(s) for s in states], torch.from_numpy(lengths) if with_lengths else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
