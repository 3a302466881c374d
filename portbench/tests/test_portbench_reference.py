"""The frozen references against the port's plain paths, at a tiny size on the CPU."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.bench import ROOT
from portbench.reference import fusion, wavlm, whisper
from portbench.reference.common import Ops, round_tf32

from .tiny import WAVLM, WHISPER


def test_reference_imports_no_program():
    code = ("import sys, portbench.reference.wavlm, portbench.reference.whisper, portbench.reference.fusion; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'interspeech_ser_tpu_torch', "
            "'interspeech_ser_tpu', 'jax', 'flax', 'jaxlib', 'optax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


def test_param_shapes_match_the_port():
    import json

    from interspeech_ser_tpu_torch.models.fusion import MultiModalEmotionClassifier
    from interspeech_ser_tpu_torch.models.speech import SpeechConfig, SpeechEncoderModel
    from interspeech_ser_tpu_torch.models.whisper import WhisperEncoderConfig, WhisperEncoderModel

    wl = json.loads((ROOT / "portbench/configs/wavlm_large.json").read_text())
    wh = json.loads((ROOT / "portbench/configs/whisper_large_v3.json").read_text())
    with torch.device("meta"):
        models = [(SpeechEncoderModel(SpeechConfig.from_hf(wl)), wavlm.param_shapes(wl)),
                  (WhisperEncoderModel(WhisperEncoderConfig.from_hf(wh)), whisper.param_shapes(wh)),
                  (MultiModalEmotionClassifier([1280, 1024], 512, 8), fusion.param_shapes([1280, 1024], 512, 8))]
    for model, shapes in models:
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_wavlm_reference_vs_port_batched():
    """Two utterances padded to whole seconds in one batch, through the
    port's model (plain paths on the CPU), against each one alone."""
    from interspeech_ser_tpu_torch.models.speech import SpeechConfig, SpeechEncoderModel, with_config

    p = weights.make(wavlm.param_shapes(WAVLM), 3, "cpu")
    cfg = SpeechConfig.from_hf(WAVLM)
    with torch.device("meta"):
        model = SpeechEncoderModel(cfg)
    model.load_state_dict(p, strict=True, assign=True)
    model = with_config(model, SpeechConfig.from_hf(WAVLM)).eval()
    rng = np.random.default_rng(0)
    wavs = [wavlm.normalize(rng.standard_normal(n).astype(np.float32)) for n in (9000, 14000)]
    batch = np.zeros((2, 16000), np.float32)
    mask = np.zeros((2, 16000), np.float32)
    for i, w in enumerate(wavs):
        batch[i, : len(w)], mask[i, : len(w)] = w, 1
    with torch.no_grad():
        out = model(torch.from_numpy(batch), torch.from_numpy(mask), keep=(-1,))["hidden_states"][-1]
        for i, w in enumerate(wavs):
            ref = wavlm.forward(p, WAVLM, torch.from_numpy(w), Ops())
            assert ref.shape[0] == wavlm.frame_count(len(w), WAVLM)
            assert _rel(out[i, : ref.shape[0]], ref) < 1e-5


def test_whisper_reference_vs_port():
    from interspeech_ser_tpu_torch.models.whisper import WhisperEncoderConfig, WhisperEncoderModel
    from interspeech_ser_tpu_torch.ops.mel import whisper_log_mel

    p = weights.make(whisper.param_shapes(WHISPER), 4, "cpu")
    with torch.device("meta"):
        model = WhisperEncoderModel(WhisperEncoderConfig.from_hf(WHISPER))
    model.load_state_dict(p, strict=True, assign=True)
    rng = np.random.default_rng(1)
    n = 37000
    wav = (0.3 * np.sin(np.arange(n) / 9.0) + 0.05 * rng.standard_normal(n)).astype(np.float32)
    padded = np.zeros((1, whisper.N_SAMPLES), np.float32)
    padded[0, :n] = wav
    with torch.no_grad():
        mel_port = whisper_log_mel(torch.from_numpy(padded), WHISPER["num_mel_bins"])
        mel_ref = whisper.log_mel(torch.from_numpy(padded[0]), WHISPER["num_mel_bins"], Ops())
        assert _rel(mel_port[0], mel_ref) < 1e-5
        out = model(mel_port, keep=(-1,))["hidden_states"][-1][0, : whisper.frame_count(n, WHISPER)]
        ref = whisper.forward(p, WHISPER, torch.from_numpy(wav), Ops())
    assert ref.shape == out.shape and _rel(out, ref) < 1e-5


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159], dtype=torch.float32)
    assert round_tf32(x).tolist() == pytest.approx([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.140625])


def test_tf32_matmul_gradient():
    a = torch.randn(5, 7, dtype=torch.float32, requires_grad=True)
    b = torch.randn(7, 3, dtype=torch.float32, requires_grad=True)
    Ops(tf32=True).matmul(a, b).sum().backward()
    assert _rel(a.grad, torch.ones(5, 3) @ b.detach().t()) < 3e-3
    assert _rel(b.grad, a.detach().t() @ torch.ones(5, 3)) < 3e-3
