"""The port's RoBERTa and DeBERTa-v2 against the JAX package's text models.

Small configs: 2 layers, D=64, 4 heads, FFN 128, vocab 300, 24 tokens.
One flax init, perturbed with seeded numpy noise so that no LayerNorm is
the identity, feeds both packages through ``models/convert.py``. Bars:
every f32 hidden state within 1e-4 max-abs, padded positions included
(same math, other summation orders); every bf16 hidden state at cosine
>= 0.999 (the two frameworks round to bf16 at other places); a batched
padded forward equal to each row's batch-1 forward on its tokens within
1e-5. The HF-directory loads are held to transformers' own forward on the
real tokens (HF lets padded queries attend, so their rows differ).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.models import text as jtext
from interspeech_ser_tpu_torch.models import text
from interspeech_ser_tpu_torch.models.convert import deberta_v2_params_from_flax, roberta_params_from_flax
from interspeech_ser_tpu_torch.models.loader import build_deberta_v2, build_roberta

torch.set_num_threads(2)

T = 24
LENGTHS = [24, 17, 5]
ROBERTA = dict(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
               max_position_embeddings=40)
DEBERTA = dict(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
               max_position_embeddings=64, position_buckets=8)


def _ids(pad: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = np.full((len(LENGTHS), T), pad, np.int64)
    mask = np.zeros((len(LENGTHS), T), np.int64)
    for i, n in enumerate(LENGTHS):
        ids[i, :n] = rng.integers(pad + 3, 300, size=n)
        mask[i, :n] = 1
    return ids, mask


def _perturbed(params, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _carry(family: str, dtype: str = "float32", **overrides):
    """(JAX model, flax params, port model) on one perturbed flax init."""
    if family == "roberta":
        kw = {**ROBERTA, **overrides}
        jcfg, cfg = jtext.RobertaConfig(**kw, dtype=dtype), text.RobertaConfig(**kw, dtype=dtype)
        jmodel, model, convert = jtext.RobertaModel(jcfg), text.RobertaModel(cfg), roberta_params_from_flax
    else:
        kw = {**DEBERTA, **overrides}
        jcfg = jtext.DebertaV2Config(**kw, dtype=dtype)
        cfg = text.DebertaV2Config(**kw, dtype=dtype)
        jmodel, model, convert = jtext.DebertaV2Model(jcfg), text.DebertaV2Model(cfg), deberta_v2_params_from_flax
    ids, mask = _ids(cfg.pad_token_id)
    params = _perturbed(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(mask))["params"], 2)
    model.load_state_dict(convert(params, cfg), strict=True)
    if dtype == "bfloat16":
        model = model.to(torch.bfloat16)
    return jmodel, params, model.eval()


def _both(jmodel, params, model, pad: int):
    ids, mask = _ids(pad)
    want = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))["hidden_states"]
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))["hidden_states"]
    assert len(got) == len(want) == 3
    return [(g.float().numpy(), np.asarray(w.astype(jnp.float32))) for g, w in zip(got, want)]


@pytest.mark.parametrize("family,overrides", [
    ("roberta", {}),
    ("deberta", {}),
    ("deberta", dict(position_buckets=-1, conv_kernel_size=0)),  # raw relative positions, no conv branch
    ("deberta", dict(conv_act="tanh", max_relative_positions=12)),
])
def test_every_hidden_state_matches_jax_f32(family, overrides):
    jmodel, params, model = _carry(family, **overrides)
    for i, (got, want) in enumerate(_both(jmodel, params, model, model.config.pad_token_id)):
        assert got.shape == (len(LENGTHS), T, 64)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=f"hidden_states[{i}]")


@pytest.mark.parametrize("family", ["roberta", "deberta"])
def test_every_hidden_state_matches_jax_bf16(family):
    jmodel, params, model = _carry(family, "bfloat16")
    for i, (got, want) in enumerate(_both(jmodel, params, model, model.config.pad_token_id)):
        assert _cos(got, want) >= 0.999, f"hidden_states[{i}] cosine {_cos(got, want)}"


@pytest.mark.parametrize("impl", ["flash", "oneshot"])
def test_roberta_under_each_jax_attention_kernel(impl, monkeypatch):
    """The JAX forward with its Pallas kernel (interpret mode) chosen by
    SER_TPU_ATTN_IMPL, against the port under the same setting (its K6 / K7
    plain version on the CPU)."""
    jmodel, params, model = _carry("roberta")
    monkeypatch.setenv("SER_TPU_ATTN_IMPL", impl)
    for i, (got, want) in enumerate(_both(jmodel, params, model, 1)):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=f"{impl} hidden_states[{i}]")


@pytest.mark.parametrize("family", ["roberta", "deberta"])
def test_batched_padded_equals_batch_1(family):
    _, _, model = _carry(family)
    ids, mask = _ids(model.config.pad_token_id, seed=5)
    with torch.no_grad():
        batched = model(torch.from_numpy(ids), torch.from_numpy(mask))["last_hidden_state"]
        for i, n in enumerate(LENGTHS):
            single = model(torch.from_numpy(ids[i:i + 1, :n]))["last_hidden_state"]
            torch.testing.assert_close(batched[i, :n], single[0], atol=1e-5, rtol=0)


def test_keep_limits_hidden_states():
    _, _, model = _carry("roberta")
    ids, mask = _ids(1)
    with torch.no_grad():
        full = model(torch.from_numpy(ids), torch.from_numpy(mask))
        kept = model(torch.from_numpy(ids), torch.from_numpy(mask), keep=(-1,))
        plain = model(torch.from_numpy(ids), torch.from_numpy(mask), plain=True)
    assert [h is None for h in kept["hidden_states"]] == [True, True, False]
    torch.testing.assert_close(kept["last_hidden_state"], full["last_hidden_state"], atol=0, rtol=0)
    torch.testing.assert_close(plain["last_hidden_state"], full["last_hidden_state"], atol=1e-5, rtol=0)


def _hf_roberta(head: bool):
    from transformers import RobertaConfig as HFConfig, RobertaForMaskedLM, RobertaModel as HFModel

    torch.manual_seed(0)
    cfg = HFConfig(vocab_size=300, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=128, max_position_embeddings=40, type_vocab_size=1, pad_token_id=1)
    return (RobertaForMaskedLM(cfg) if head else HFModel(cfg)).eval()


def _hf_deberta():
    from transformers import DebertaV2Config as HFConfig, DebertaV2Model as HFModel

    torch.manual_seed(1)
    cfg = HFConfig(vocab_size=300, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=128, max_position_embeddings=64, type_vocab_size=0,
                   relative_attention=True, position_buckets=8, norm_rel_ebd="layer_norm",
                   share_att_key=True, pos_att_type=["p2c", "c2p"], position_biased_input=False,
                   conv_kernel_size=3, conv_act="gelu", layer_norm_eps=1e-7)
    return HFModel(cfg).eval()


@pytest.mark.parametrize("kind", ["roberta", "roberta_mlm", "deberta"])
def test_strict_load_of_a_transformers_directory(kind, tmp_path):
    """save_pretrained (safetensors) -> build_* with a strict load; the
    hidden states equal transformers' on the real tokens within 2e-4."""
    hf = _hf_deberta() if kind == "deberta" else _hf_roberta(head=kind == "roberta_mlm")
    hf.save_pretrained(tmp_path)
    build = build_deberta_v2 if kind == "deberta" else build_roberta
    model, cfg = build(str(tmp_path))
    ids, mask = _ids(cfg.pad_token_id, seed=3)
    hf_base = getattr(hf, "roberta", hf)
    with torch.no_grad():
        want = hf_base(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                       output_hidden_states=True).hidden_states
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))["hidden_states"]
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        for row, n in enumerate(LENGTHS):
            torch.testing.assert_close(g[row, :n], w[row, :n], atol=2e-4, rtol=0, msg=f"h[{i}] row {row}")


@pytest.mark.parametrize("field,value", [("share_att_key", False), ("position_biased_input", True)])
def test_deberta_refuses_other_attention_variants(field, value, tmp_path):
    hf = {**text.DebertaV2Config(**DEBERTA).to_hf(), field: value}
    with pytest.raises(NotImplementedError, match=field):
        text.DebertaV2Config.from_hf(hf)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    with pytest.raises(NotImplementedError, match=field):
        build_deberta_v2(str(tmp_path))


def test_config_round_trip_and_presets():
    for cfg in (text.roberta_large(), text.deberta_v2_xxlarge(), text.DebertaV2Config(**DEBERTA)):
        assert type(cfg).from_hf(cfg.to_hf()) == cfg
    r, d = text.roberta_large(), text.deberta_v2_xxlarge("bfloat16")
    assert (r.num_layers, r.hidden_size, r.num_heads, r.intermediate_size, r.vocab_size) == (24, 1024, 16, 4096, 50265)
    assert (d.num_layers, d.hidden_size, d.num_heads, d.intermediate_size, d.vocab_size, d.att_span) == \
        (48, 1536, 24, 6144, 128100, 256)
    assert d.compute_dtype == torch.bfloat16


def test_log_buckets_match_jax():
    for t, buckets, max_pos in ((80, 256, 512), (24, 8, 64), (300, 32, 512), (10, -1, 512)):
        np.testing.assert_array_equal(text.log_bucket_positions(t, buckets, max_pos),
                                      jtext._log_bucket_positions(t, buckets, max_pos))
