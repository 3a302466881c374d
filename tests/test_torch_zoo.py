"""The speech-encoder zoo in the port: the base shape (group-norm frontend,
post-LN stack, no conv bias, as wavlm-base-plus and wav2vec2-base), and
XL / XLS-R-2B-style configs (layer-norm frontend, pre-LN) at head dims 80
and 120, against the JAX ``SpeechEncoderModel`` and against HF
``Wav2Vec2Model`` / ``HubertModel`` / ``WavLMModel`` loaded by
``build_speech_encoder`` (transformers is used by this test only); then
the extraction pipeline's kernel routing and one ``lora_cli`` step on a
base-shaped directory.

Narrow configs: 2 layers, 3 conv layers of 16 channels, a 16-tap
positional conv in 4 groups. One flax init feeds both packages through
``speech_params_from_flax``. f32 tolerance 1e-4 max-abs over every hidden
state: the same math in other summation orders (flax's norms use
E[x²]-E[x]², torch's a two-pass variance).
"""

import dataclasses
import json
import os
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.models.speech import SpeechConfig as JaxSpeechConfig
from interspeech_ser_tpu.models.speech import SpeechEncoderModel as JaxSpeechEncoderModel
from interspeech_ser_tpu_torch.models import speech
from interspeech_ser_tpu_torch.models.convert import speech_params_from_flax
from interspeech_ser_tpu_torch.models.loader import build_speech_encoder
from interspeech_ser_tpu_torch.models.speech import SpeechConfig, SpeechEncoderModel

torch.set_num_threads(2)

NARROW = dict(num_layers=2, conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
              num_conv_pos_embeddings=16, conv_pos_groups=4, num_buckets=32, max_distance=64)
CONFIGS = {
    # wavlm-base-plus / wav2vec2-base shape: group norm, post-LN, no conv bias, head dim 64
    "wavlm_base": dict(hidden_size=128, num_heads=2, intermediate_size=256, conv_bias=False,
                       feat_extract_norm="group", do_stable_layer_norm=False, attention_type="wavlm"),
    "w2v2_base": dict(hidden_size=128, num_heads=2, intermediate_size=256, conv_bias=False,
                      feat_extract_norm="group", do_stable_layer_norm=False),
    # HuBERT-XL style: head dim 80; XLS-R-2B style: head dim 120
    "hubert_xl": dict(hidden_size=160, num_heads=2, intermediate_size=320, conv_bias=True,
                      feat_extract_norm="layer", do_stable_layer_norm=True, model_type="hubert"),
    "xlsr_2b": dict(hidden_size=240, num_heads=2, intermediate_size=480, conv_bias=True,
                    feat_extract_norm="layer", do_stable_layer_norm=True),
}
LENGTHS = (4000, 2500)


def _jax_kw(kw):
    return {k: v for k, v in kw.items() if k != "model_type"}


@pytest.fixture(scope="module", params=list(CONFIGS))
def carried(request):
    """(name, jax model, flax params, port model) from one flax init."""
    kw = {**NARROW, **CONFIGS[request.param]}
    jmodel = JaxSpeechEncoderModel(JaxSpeechConfig(**_jax_kw(kw)))
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 4000)), jnp.ones((1, 4000)))["params"]
    params = jax.tree.map(np.asarray, params)
    cfg = SpeechConfig(**kw)
    model = SpeechEncoderModel(cfg).eval()
    model.load_state_dict(speech_params_from_flax(params, cfg), strict=True)
    return request.param, jmodel, params, model


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    wav = np.zeros((len(LENGTHS), max(LENGTHS)), np.float32)
    mask = np.zeros_like(wav)
    for i, n in enumerate(LENGTHS):
        wav[i, :n] = rng.standard_normal(n)
        mask[i, :n] = 1.0
    return wav, mask


def test_every_hidden_state_matches_jax_f32(carried):
    name, jmodel, params, model = carried
    wav, mask = _batch()
    ref = jmodel.apply({"params": params}, jnp.asarray(wav), jnp.asarray(mask))
    with torch.no_grad():
        out = model(torch.from_numpy(wav), torch.from_numpy(mask))
    assert model.fused_frontend == (0 if CONFIGS[name]["feat_extract_norm"] == "group" else 1)
    assert len(out["hidden_states"]) == len(ref["hidden_states"]) == NARROW["num_layers"] + 1
    for ours, theirs in zip(out["hidden_states"], ref["hidden_states"]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4, rtol=0)


def test_kernel_routes_match_default_route_f32(carried, monkeypatch):
    """K8 (inference_kernels), K5 (SER_TPU_FFN_KERNEL=1) and K2 at depth 3
    (layer-norm frontends), each through its plain version on the CPU,
    against the default route: 1e-5 max-abs (the same sums, the bias added
    after the conv instead of inside it)."""
    name, _, _, model = carried
    wav, mask = _batch(8)
    with torch.no_grad():
        ref = model(torch.from_numpy(wav), torch.from_numpy(mask))["hidden_states"]
        monkeypatch.setenv("SER_TPU_FFN_KERNEL", "1")
        monkeypatch.setenv("SER_TPU_FRONTEND", "3")
        routed = speech.with_config(model, dataclasses.replace(model.config, inference_kernels=True))
        assert routed.fused_frontend == (0 if CONFIGS[name]["feat_extract_norm"] == "group" else 3)
        shared = [(a.data_ptr(), b.data_ptr()) for a, b in zip(routed.parameters(), model.parameters())]
        assert all(a == b for a, b in shared)  # the same storage, not a copy
        out = routed(torch.from_numpy(wav), torch.from_numpy(mask))["hidden_states"]
    for ours, theirs in zip(out, ref):
        torch.testing.assert_close(ours, theirs, atol=1e-5, rtol=0)


def _hf_model(name):
    from transformers import HubertConfig, HubertModel, Wav2Vec2Config, Wav2Vec2Model, WavLMConfig, WavLMModel

    kw = {**NARROW, **CONFIGS[name]}
    hf_kw = dict(
        hidden_size=kw["hidden_size"], num_hidden_layers=kw["num_layers"], num_attention_heads=kw["num_heads"],
        intermediate_size=kw["intermediate_size"], conv_dim=list(kw["conv_dim"]), conv_kernel=list(kw["conv_kernel"]),
        conv_stride=list(kw["conv_stride"]), num_feat_extract_layers=3, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, do_stable_layer_norm=kw["do_stable_layer_norm"],
        feat_extract_norm=kw["feat_extract_norm"], conv_bias=kw["conv_bias"], layerdrop=0.0,
    )
    if name == "wavlm_base":
        return WavLMModel(WavLMConfig(**hf_kw, num_buckets=32, max_bucket_distance=64))
    if name == "hubert_xl":
        return HubertModel(HubertConfig(**hf_kw))
    return Wav2Vec2Model(Wav2Vec2Config(**hf_kw))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loader_matches_hf(name, tmp_path):
    torch.manual_seed(3)
    hf = _hf_model(name).eval()
    with torch.no_grad():  # non-trivial norm parameters
        for n, p in hf.named_parameters():
            if "norm" in n:
                p.add_(0.1 * torch.randn_like(p))
    hf.save_pretrained(str(tmp_path), safe_serialization=name != "xlsr_2b")
    model, cfg, _ = build_speech_encoder(str(tmp_path))
    assert cfg.feat_extract_norm == CONFIGS[name]["feat_extract_norm"]
    assert cfg.hidden_size // cfg.num_heads in (64, 80, 120)
    with open(tmp_path / "config.json") as f:
        hf_json = json.load(f)
    assert cfg.to_hf()["model_type"] == hf_json["model_type"]
    assert SpeechConfig.from_hf(cfg.to_hf()) == cfg
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((1, 5000)).astype(np.float32))
    with torch.no_grad():
        ref = hf(x, output_hidden_states=True)
        out = model(x)
    assert len(out["hidden_states"]) == len(ref.hidden_states)
    for ours, theirs in zip(out["hidden_states"], ref.hidden_states):
        torch.testing.assert_close(ours, theirs, atol=1e-4, rtol=0)


def test_presets():
    xlsr, hubert = speech.wav2vec2_xlsr_2b(), speech.hubert_xlarge()
    assert (xlsr.hidden_size // xlsr.num_heads, hubert.hidden_size // hubert.num_heads) == (120, 80)
    assert (xlsr.to_hf()["model_type"], hubert.to_hf()["model_type"]) == ("wav2vec2", "hubert")
    for cfg in (xlsr, hubert):
        assert SpeechConfig.from_hf(cfg.to_hf()) == cfg
        assert not cfg.inference_kernels


def test_default_fused_frontend(monkeypatch):
    layer, group = speech.wav2vec2_xlsr_2b(), SpeechConfig()
    monkeypatch.delenv("SER_TPU_FRONTEND", raising=False)
    assert (speech.default_fused_frontend(layer), speech.default_fused_frontend(group)) == (1, 0)
    for n in range(0, 8):
        monkeypatch.setenv("SER_TPU_FRONTEND", str(n))
        assert (speech.default_fused_frontend(layer), speech.default_fused_frontend(group)) == (n, 0)
    monkeypatch.setenv("SER_TPU_FRONTEND", "xla")  # the JAX package's "no K2"
    assert (speech.default_fused_frontend(layer), speech.default_fused_frontend(group)) == (0, 0)
    for bad in ("8", "XLA", "-1", ""):
        monkeypatch.setenv("SER_TPU_FRONTEND", bad)
        with pytest.raises(ValueError, match="SER_TPU_FRONTEND"):
            speech.default_fused_frontend(layer)


def test_default_ffn_kernel_is_fixed_when_the_model_is_built(monkeypatch):
    """K5 needs SER_TPU_FFN_KERNEL=1 and inference_kernels; a built model
    keeps its route whatever the environment says later."""
    cfg = SpeechConfig(**{**NARROW, **CONFIGS["xlsr_2b"]}, inference_kernels=True)
    monkeypatch.delenv("SER_TPU_FFN_KERNEL", raising=False)
    assert not speech.default_ffn_kernel(cfg)
    monkeypatch.setenv("SER_TPU_FFN_KERNEL", "1")
    assert speech.default_ffn_kernel(cfg) and not speech.default_ffn_kernel(SpeechConfig())
    model = SpeechEncoderModel(cfg)
    monkeypatch.delenv("SER_TPU_FFN_KERNEL")
    assert model.ffn_kernel and all(layer.feed_forward.fused for layer in model.encoder.layers)
    assert not speech.with_config(model, cfg).ffn_kernel


def _write_wav(path, x):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def _write_port_dir(path, cfg):
    """A seeded HF directory written by the port itself (config + weights)."""
    torch.manual_seed(4)
    model = SpeechEncoderModel(cfg)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg.to_hf(), f)
    torch.save(model.state_dict(), os.path.join(path, "pytorch_model.bin"))


@pytest.mark.parametrize("name", ["xlsr_2b", "wavlm_base"])
def test_pipeline_routes_through_inference_kernels(name, tmp_path, monkeypatch):
    """SpeechExtractionPipeline sets inference_kernels on a copy of the
    config: K8 runs once per batch and K5 once per layer and batch under
    SER_TPU_FFN_KERNEL=1, K2 at SER_TPU_FRONTEND's depth for a layer-norm
    frontend and never for a group-norm one; the files equal a plain
    batch-1 forward of the loaded model within 1e-5 (layer norm; a
    group-norm frontend's statistics take in the batch's padding)."""
    from interspeech_ser_tpu_torch.extract.pipeline import SpeechExtractionPipeline
    from interspeech_ser_tpu_torch.ops.kernels import conv_frontend as kc, ffn_fused as kf, pos_conv as kp
    from interspeech_ser_tpu_torch.utils.audio import load_wav, normalize_waveform

    calls = {"pos_conv": 0, "ffn_fused": 0, "conv_frontend": []}

    def counted(key, fn):
        def run(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return run

    def counted_frontend(wav, layers, *args, **kw):
        calls["conv_frontend"].append(len(layers))
        return kc.conv_frontend_plain(wav, layers, *args, **kw)

    monkeypatch.setattr(speech, "pos_conv", counted("pos_conv", kp.pos_conv_plain))
    monkeypatch.setattr(speech, "ffn_fused", counted("ffn_fused", kf.ffn_fused_plain))
    monkeypatch.setattr(speech, "conv_frontend", counted_frontend)
    monkeypatch.setenv("SER_TPU_FFN_KERNEL", "1")
    monkeypatch.setenv("SER_TPU_FRONTEND", "2")
    cfg = SpeechConfig(**{**NARROW, **CONFIGS[name]})
    model_dir, wav_dir = tmp_path / "model", tmp_path / "wavs"
    _write_port_dir(str(model_dir), cfg)
    wav_dir.mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        _write_wav(wav_dir / f"u{i}.wav", 0.3 * rng.standard_normal(4000 + 1700 * i))
    model, cfg, do_norm = build_speech_encoder(str(model_dir))
    pipe = SpeechExtractionPipeline(model, cfg, device="cpu", num_workers=2)
    assert pipe.model.config.inference_kernels and not cfg.inference_kernels
    stats = pipe.run(str(wav_dir), str(tmp_path / "out"))
    assert stats.n_utts == 3 and stats.n_batches == 1
    assert calls["pos_conv"] == 1 and calls["ffn_fused"] == cfg.num_layers
    assert calls["conv_frontend"] == ([] if cfg.feat_extract_norm == "group" else [2])
    if cfg.feat_extract_norm == "layer":
        for i in range(3):
            y, _ = load_wav(str(wav_dir / f"u{i}.wav"))
            x = torch.from_numpy(normalize_waveform(y, do_norm))[None]
            with torch.no_grad():
                ref = model(x, plain=True)["last_hidden_state"][0]
            got = torch.load(tmp_path / "out" / f"u{i}.pt", weights_only=True)
            torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


def test_lora_cli_step_on_a_base_shaped_dir(tmp_path):
    """``lora_cli``'s default --ssl_type is wavlm-base-plus: one epoch of
    one step on a tiny directory of that shape (group-norm frontend, post-LN,
    no conv bias) writes a checkpoint with trained LoRA factors."""
    from interspeech_ser_tpu_torch import lora_cli

    cfg = SpeechConfig(**{**NARROW, **CONFIGS["wavlm_base"]})
    model_dir, wav_dir = tmp_path / "wavlm-base-plus", tmp_path / "wavs"
    _write_port_dir(str(model_dir), cfg)
    wav_dir.mkdir()
    rows = []
    for i in range(6):
        _write_wav(wav_dir / f"u{i}.wav", 0.3 * np.sin(np.arange(3200 + 400 * i) * (0.05 + 0.1 * (i % 2))))
        onehot = [str(float(c == i % 2)) for c in range(8)]
        rows.append(",".join([f"u{i}.wav", *onehot, "Train" if i < 4 else "Development"]))
    header = "FileName,Angry,Sad,Happy,Surprise,Fear,Disgust,Contempt,Neutral,Split_Set"
    (tmp_path / "labels.csv").write_text("\n".join([header, *rows]) + "\n")
    res = lora_cli.main(["--ssl_type", str(model_dir), "--label_path", str(tmp_path / "labels.csv"),
                         "--wav_dir", str(wav_dir), "--model_path", str(tmp_path / "exp"), "--epochs", "1",
                         "--batch_size", "4", "--device", "cpu"])
    assert len(res["losses"]) == 1 and np.isfinite(res["losses"]).all()
    sd = torch.load(res["checkpoint"], weights_only=True)
    assert sum(k.endswith(".lora_A") for k in sd) == 2 * cfg.num_layers
    assert any(float(v.abs().max()) > 0 for k, v in sd.items() if k.endswith("lora_B"))
