"""The port's Whisper encoder, loader and extraction against the JAX package.

Small Whisper config: 2 layers, D=128, 2 heads (head dim 64, as every
supported encoder), FFN 256, 16 mels. One flax init feeds both packages
through ``whisper_params_from_flax``; the extraction runs both packages'
``whisper_main`` on one HF directory written by transformers (used by this
test only). Bars: every f32 hidden state within 1e-5 max-abs (same math,
other summation orders; flax's LayerNorm uses E[x²]-E[x]², torch's a
two-pass variance); extracted ``.pt`` files within 1e-4, because the
log-mel in front of the encoder already differs by up to 1e-4 in the last
digits (tests/test_torch_mel.py).
"""

import os
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.models.whisper import WhisperEncoderConfig as JaxWhisperConfig
from interspeech_ser_tpu.models.whisper import WhisperEncoderModel as JaxWhisperModel
from interspeech_ser_tpu_torch.models.convert import whisper_params_from_flax
from interspeech_ser_tpu_torch.models.loader import build_whisper_encoder
from interspeech_ser_tpu_torch.models.whisper import (
    WhisperEncoderConfig,
    WhisperEncoderModel,
    sinusoidal_positions,
    whisper_large_v3,
)

torch.set_num_threads(2)

SMALL = dict(num_mel_bins=16, d_model=128, encoder_layers=2, encoder_attention_heads=2, encoder_ffn_dim=256)


@pytest.fixture(scope="module")
def carried():
    jcfg = JaxWhisperConfig(**SMALL)
    jmodel = JaxWhisperModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 300)))["params"]
    cfg = WhisperEncoderConfig(**SMALL)
    model = WhisperEncoderModel(cfg)
    model.load_state_dict(whisper_params_from_flax(jax.tree.map(np.asarray, params), cfg), strict=True)
    return jmodel, params, model.eval()


def test_every_hidden_state_matches_jax_f32(carried):
    jmodel, params, model = carried
    mel = np.random.default_rng(0).standard_normal((2, 16, 300)).astype(np.float32)
    want = jmodel.apply({"params": params}, jnp.asarray(mel))
    with torch.no_grad():
        got = model(torch.from_numpy(mel))
    assert len(got["hidden_states"]) == len(want["hidden_states"]) == 3
    for i, (a, b) in enumerate(zip(got["hidden_states"], want["hidden_states"])):
        assert a.shape == (2, 150, 128)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0, err_msg=f"hidden_states[{i}]")
    np.testing.assert_array_equal(got["last_hidden_state"].numpy(), got["hidden_states"][-1].numpy())


def test_keep_and_bf16(carried):
    _, _, model = carried
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 16, 300)).astype(np.float32))
    with torch.no_grad():
        full = model(mel)
        kept = model(mel, keep=(-2,))
        assert [h is None for h in kept["hidden_states"]] == [True, False, True]
        torch.testing.assert_close(kept["hidden_states"][1], full["hidden_states"][1], atol=0, rtol=0)
        bf = WhisperEncoderModel(WhisperEncoderConfig(**SMALL, dtype="bfloat16"))
        bf.load_state_dict(model.state_dict())
        out = bf.to(torch.bfloat16)(mel)["last_hidden_state"]
    assert out.dtype == torch.bfloat16
    cos = torch.nn.functional.cosine_similarity(out.float().flatten(), full["last_hidden_state"].flatten(), dim=0)
    assert cos >= 0.99


def test_config_and_positions():
    cfg = whisper_large_v3()
    assert (cfg.d_model, cfg.encoder_layers, cfg.encoder_attention_heads, cfg.encoder_ffn_dim, cfg.num_mel_bins) == (
        1280, 32, 20, 5120, 128)
    assert WhisperEncoderConfig.from_hf(cfg.to_hf()) == cfg
    from interspeech_ser_tpu.models.whisper import sinusoidal_positions as jax_positions

    np.testing.assert_array_equal(sinusoidal_positions(1500, 1280), jax_positions(1500, 1280))


def _write_wav(path, x):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def whisper_dir(tmp_path_factory):
    """An HF Whisper-encoder directory (3 layers, so that the mean of the last
    4 hidden states exists) and 3 wavs: 2 s + 17 samples, 5 s, and
    31 s (cut to 30 s in the batch; its frames capped at 1500)."""
    from transformers import WhisperConfig, WhisperModel

    root = tmp_path_factory.mktemp("whisper")
    torch.manual_seed(9)
    hf = WhisperConfig(num_mel_bins=16, d_model=128, encoder_layers=3, encoder_attention_heads=2,
                       encoder_ffn_dim=256, decoder_layers=1, decoder_attention_heads=2, decoder_ffn_dim=64,
                       max_source_positions=1500)
    WhisperModel(hf).encoder.save_pretrained(str(root / "hf"))
    (root / "wavs").mkdir()
    rng = np.random.default_rng(4)
    lengths = {"a": 32017, "b": 80000, "c": 496000}
    for name, n in lengths.items():
        t = np.arange(n) / 16000.0
        _write_wav(root / "wavs" / f"{name}.wav", 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t)
                   + 0.05 * rng.standard_normal(n))
    return root, lengths


def test_loader_reads_hf_whisper(whisper_dir, tmp_path):
    from interspeech_ser_tpu_torch.models.loader import load_hf_state_dict

    root, _ = whisper_dir
    model, cfg = build_whisper_encoder(str(root / "hf"))
    assert cfg == WhisperEncoderConfig(**{**SMALL, "encoder_layers": 3})
    sd = load_hf_state_dict(str(root / "hf"))  # the encoder-only save: no prefix
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k].float(), atol=0, rtol=0)
    # a full WhisperModel directory: the encoder prefix is stripped, the decoder dropped
    full = {f"model.encoder.{k}": v for k, v in sd.items()}
    full["model.decoder.layers.0.fc1.weight"] = torch.zeros(2, 2)
    os.makedirs(tmp_path / "full")
    torch.save(full, tmp_path / "full" / "pytorch_model.bin")
    with open(root / "hf" / "config.json") as f, open(tmp_path / "full" / "config.json", "w") as g:
        g.write(f.read())
    model2, _ = build_whisper_encoder(str(tmp_path / "full"))
    for k, v in model2.state_dict().items():
        torch.testing.assert_close(v, model.state_dict()[k], atol=0, rtol=0)
    with open(tmp_path / "full" / "config.json", "w") as g:
        g.write('{"model_type": "wavlm"}')
    with pytest.raises(ValueError, match="whisper"):
        build_whisper_encoder(str(tmp_path / "full"))


@pytest.mark.parametrize("average", ["n", "y"])
def test_extraction_matches_jax_file_for_file(whisper_dir, tmp_path, average):
    from interspeech_ser_tpu.preprocess_cli import whisper_main as jax_whisper_main
    from interspeech_ser_tpu_torch.preprocess_cli import whisper_main

    root, lengths = whisper_dir
    flags = ["--ssl_type", str(root / "hf"), "--wav_dir", str(root / "wavs"), "--use_average", average]
    want_stats = jax_whisper_main(flags + ["--save_path", str(tmp_path / "jax")])
    stats = whisper_main(flags + ["--save_path", str(tmp_path / "port"), "--device", "cpu"])
    assert stats.n_utts == want_stats.n_utts == 3 and stats.n_batches == 1
    for name, n in lengths.items():
        got = torch.load(tmp_path / "port" / f"{name}.pt", weights_only=True)
        want = torch.load(tmp_path / "jax" / f"{name}.pt", weights_only=True)
        assert got.dtype == torch.float32 and got.shape == want.shape == (min(-(-n // 320), 1500), 128)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0, err_msg=name)
