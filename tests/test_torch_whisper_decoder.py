"""The port's Whisper decoder and greedy decoders against the JAX package.

The tiny config of tests/test_whisper_decoder.py (vocab 100, D 32, 4 heads,
2 layers, FFN 64, 40 positions); weights, encoder outputs and token ids
from a numpy seed. Bars: f32 logits (of order 5) within 2e-5 max-abs (the
same math in other summation orders); greedy tokens equal; the bf16 step
logits of the cached decoder within relative L2 0.03 of JAX's bf16
teacher-forced logits (readings 0.011-0.016 over three input seeds, while
JAX's bf16 logits sit 0.013-0.019 from its f32 ones) and within 1e-6 of the
port's own bf16 teacher-forced forward. That bar is loose: it cannot tell
f32 attention scores from bf16 ones. ``_f32_product``, which gives the bf16
products their f32 results, is held on its own here (the CPU route) and on
the card by chip_smoke.py's product check (the cuBLAS route).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interspeech_ser_tpu.models import whisper_decoder as jwd
from interspeech_ser_tpu_torch.models import whisper_decoder as wd
from interspeech_ser_tpu_torch.models.convert import whisper_decoder_params_from_flax
from interspeech_ser_tpu_torch.models.loader import build_whisper_decoder, whisper_decoder_state_dict_from_hf

torch.set_num_threads(2)

HF = dict(vocab_size=100, num_mel_bins=16, d_model=32, encoder_layers=1, encoder_attention_heads=4,
          encoder_ffn_dim=64, decoder_layers=2, decoder_attention_heads=4, decoder_ffn_dim=64,
          max_source_positions=30, max_target_positions=40, pad_token_id=0, bos_token_id=1, eos_token_id=2,
          decoder_start_token_id=1, suppress_tokens=None, begin_suppress_tokens=None)


def seeded_state_dict(cfg, seed: int = 5):
    """HF-named decoder weights from a numpy seed: linear weights and the
    embeddings N(0, 0.3), biases N(0, 0.1), LayerNorm scales 1 + N(0, 0.1).
    (transformers' init, std 0.02, makes a 2-layer decoder repeat its last
    prompt token forever, which would hide a wrong cache or mask.)"""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in wd.WhisperDecoderModel(cfg).state_dict().items()}
    sd = {}
    for k, shape in shapes.items():
        x = rng.normal(size=tuple(shape)).astype(np.float32)
        if "layer_norm" in k:
            x = (1.0 if k.endswith("weight") else 0.0) + 0.1 * x
        else:
            x = x * (0.1 if k.endswith("bias") else 0.3)
        sd[k] = torch.from_numpy(x)
    return sd


@pytest.fixture(scope="module")
def pair():
    """(HF state dict, JAX params, port decoder) with the same weights: the
    seeded weights loaded into transformers' ``WhisperModel`` (so that the
    names are HF's), the JAX params from ``whisper_decoder_hf_to_flax`` of
    its state dict, the port's from ``whisper_decoder_state_dict_from_hf``."""
    from transformers import WhisperConfig, WhisperModel

    cfg = wd.WhisperDecoderConfig.from_hf(HF)
    hf = WhisperModel(WhisperConfig(**HF)).eval()
    hf.decoder.load_state_dict(seeded_state_dict(cfg), strict=True)
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    params = jwd.whisper_decoder_hf_to_flax({k: v.numpy() for k, v in sd.items()},
                                            jwd.WhisperDecoderConfig(**_cfg_kwargs()))
    model = wd.WhisperDecoderModel(cfg)
    model.load_state_dict(whisper_decoder_state_dict_from_hf(sd), strict=True)
    return sd, params, model.eval()


def _jax(dtype="float32"):
    return jwd.WhisperDecoderModel(jwd.WhisperDecoderConfig(**{**_cfg_kwargs(), "dtype": dtype}))


def _cfg_kwargs():
    return dict(vocab_size=100, d_model=32, decoder_layers=2, decoder_attention_heads=4, decoder_ffn_dim=64,
                max_target_positions=40)


def _bf16(model):
    m = wd.WhisperDecoderModel(wd.WhisperDecoderConfig(**_cfg_kwargs(), dtype="bfloat16"))
    m.load_state_dict(model.state_dict())
    return m.eval()


def test_config_from_hf_and_large_v3():
    assert wd.WhisperDecoderConfig.from_hf(HF) == wd.WhisperDecoderConfig(**_cfg_kwargs())
    large = wd.whisper_large_v3_decoder()
    assert wd.WhisperDecoderConfig.from_hf(large.to_hf()) == large
    jlarge = jwd.WhisperDecoderConfig()
    assert large.to_hf() == {k: getattr(jlarge, k) for k in large.to_hf()}


@pytest.mark.parametrize("offset,valid", [(0, None), (3, (7, 4))])
def test_teacher_forced_logits_match_jax_f32(pair, offset, valid):
    _, params, model = pair
    rng = np.random.default_rng(15 + offset)
    B, S, T = 2, 12, 7
    enc = rng.normal(size=(B, S, 32)).astype(np.float32)
    ids = rng.integers(0, 100, size=(B, T))
    vl = None if valid is None else np.asarray(valid)
    want = _jax().apply({"params": params}, jnp.asarray(ids), jnp.asarray(enc), position_offset=offset,
                        valid_len=None if vl is None else jnp.asarray(vl))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(enc), position_offset=offset,
                    valid_len=None if vl is None else torch.from_numpy(vl))
    assert got.dtype == torch.float32 and got.shape == (B, T, 100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def _decode_both(params, model, enc, prompt, eot, n, sup, cached):
    jfn = jwd.greedy_decode_cached if cached else jwd.greedy_decode
    pfn = wd.greedy_decode_cached if cached else wd.greedy_decode
    want = np.asarray(jfn(_jax(), params, jnp.asarray(enc), np.asarray(prompt), eot, n, suppress_ids=sup))
    got = pfn(model, torch.from_numpy(enc), prompt, eot, n, suppress_ids=sup)
    assert got.dtype == torch.int64 and got.shape == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "recompute"])
@pytest.mark.parametrize("suppress", [False, True], ids=["plain", "suppress"])
def test_greedy_tokens_match_jax(pair, cached, suppress):
    """Equal tokens on three rows; EOT is row 0's third emitted token, so row
    0 finishes early (EOT from there on) while another row runs on."""
    _, params, model = pair
    enc = np.random.default_rng(21).normal(size=(3, 12, 32)).astype(np.float32)
    prompt, n = [1, 5], 8
    sup = np.arange(10, 60) if suppress else None
    probe, _ = _decode_both(params, model, enc, prompt, 99, n, sup, cached)
    eot = int(probe[0, len(prompt) + 2])
    got, want = _decode_both(params, model, enc, prompt, eot, n, sup, cached)
    np.testing.assert_array_equal(got, want)
    first = [list(r[len(prompt):]).index(eot) if eot in r[len(prompt):] else n for r in got]
    assert first[0] <= 2 and max(first) > first[0], (eot, got)
    assert (got[0, len(prompt) + first[0]:] == eot).all()
    if suppress:
        assert not np.isin(got[:, len(prompt):], sup).any()
    if cached:
        np.testing.assert_array_equal(wd.greedy_decode(model, torch.from_numpy(enc), prompt, eot, n, sup).numpy(), got)


def test_bf16_cached_logits_match_jax_bf16(pair):
    """bf16 step logits of the cached decoder, teacher-forced through its
    caches, against JAX's bf16 teacher-forced forward and the port's."""
    _, params, model = pair
    rng = np.random.default_rng(33)
    B, S, T = 2, 12, 9
    enc = rng.normal(size=(B, S, 32)).astype(np.float32)
    ids = rng.integers(0, 100, size=(B, T))
    want = np.asarray(_jax("bfloat16").apply({"params": params}, jnp.asarray(ids), jnp.asarray(enc)))
    bf = _bf16(model)
    tok = torch.from_numpy(ids)
    with torch.no_grad():
        state = wd.CachedDecoder(bf, torch.from_numpy(enc), T)
        got = torch.stack([state.step(tok[:, t], t) for t in range(T)], dim=1)
        forward = bf(tok, torch.from_numpy(enc))
        f32 = model(tok, torch.from_numpy(enc))
    assert got.dtype == torch.float32 and state.k_cache.dtype == torch.bfloat16
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 0.03, rel
    np.testing.assert_allclose(got.numpy(), forward.numpy(), atol=1e-6, rtol=0)
    # and bf16 is not f32 in disguise
    assert float((got - f32).abs().max()) > 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_f32_product_returns_the_f32_product(dtype):
    """[..., m, k] x [..., k, n] with broadcast leading dims -> the f32
    product of the operands upcast (bf16 x bf16 products are exact in f32),
    not its bf16 rounding."""
    g = torch.Generator().manual_seed(8)
    a = torch.randn(2, 3, 1, 16, generator=g).to(dtype)
    b = torch.randn(1, 3, 16, 7, generator=g).to(dtype)
    got = wd._f32_product(a, b)
    want = torch.matmul(a.float(), b.float())
    assert got.dtype == torch.float32 and got.shape == (2, 3, 1, 7)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    rel = float((torch.matmul(a, b).float() - want).norm() / want.norm())
    assert rel == 0 if dtype == torch.float32 else rel > 1e-4


def test_hf_and_flax_routes_give_the_same_weights(pair, tmp_path):
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    sd, params, model = pair
    via_flax = whisper_decoder_params_from_flax(params, wd.WhisperDecoderConfig(**_cfg_kwargs()))
    via_hf = whisper_decoder_state_dict_from_hf(sd)
    assert sorted(via_flax) == sorted(via_hf) == sorted(model.state_dict())
    for k, v in via_hf.items():
        torch.testing.assert_close(via_flax[k], v, atol=0, rtol=0, msg=k)
    # one WhisperForConditionalGeneration directory (safetensors, tied proj_out) builds the decoder
    torch.manual_seed(4)
    full = WhisperForConditionalGeneration(WhisperConfig(**HF)).eval()
    full.save_pretrained(str(tmp_path))
    built, cfg = build_whisper_decoder(str(tmp_path))
    assert cfg == wd.WhisperDecoderConfig(**_cfg_kwargs())
    want = {k[len("model.decoder."):]: v for k, v in full.state_dict().items() if k.startswith("model.decoder.")}
    assert sorted(built.state_dict()) == sorted(want)
    for k, v in built.state_dict().items():
        torch.testing.assert_close(v, want[k], atol=0, rtol=0, msg=k)


def test_positions_past_the_table_raise(pair):
    _, _, model = pair
    enc = torch.zeros(1, 4, 32)
    for fn in (wd.greedy_decode, wd.greedy_decode_cached):
        with pytest.raises(ValueError, match="max_target_positions"):
            fn(model, enc, [1, 5], 2, 39)  # 2 + 39 = 41 > 40
    with pytest.raises(ValueError, match="max_target_positions"):
        model(torch.zeros(1, 3, dtype=torch.long), enc, position_offset=38)
    assert wd.greedy_decode_cached(model, enc, [1, 5], 2, 38).shape == (1, 40)
