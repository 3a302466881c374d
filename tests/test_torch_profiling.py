"""The port's ``utils/profiling.py`` against the JAX package's: ``StepTimer``
and ``RTFMeter`` reports byte-equal for the same inputs, readbacks of each
result shape, ``trace`` / ``annotate`` on the CPU, ``SER_TPU_TRACE``, and
the ``profile_trace`` entry point at a tiny width."""

import glob
import json
import os
import time

import pytest
import torch

from interspeech_ser_tpu.utils import profiling as ref
from interspeech_ser_tpu_torch.utils import profiling as port

torch.set_num_threads(2)


def test_spans_accumulate():
    t = port.StepTimer()
    for _ in range(3):
        with t.span("work"):
            time.sleep(0.01)
    assert t.counts["work"] == 3
    # lower bound only: wall time on a loaded host has no upper bound
    assert t.totals["work"] > 0.02
    assert "work" in t.report()


@pytest.mark.parametrize("shape", ["tensor", "tuple", "dict", "none"])
def test_result_getter_reads_back_the_first_tensor(shape):
    y = torch.arange(6.0).reshape(2, 3) * 3
    result = {"tensor": y, "tuple": (None, [y, torch.zeros(1)]), "dict": {"logits": y, "aux": torch.ones(2)},
              "none": None}[shape]
    assert port._first_leaf(result) is (None if shape == "none" else y)
    t, out = port.StepTimer(), {}
    with t.span("device", result_getter=lambda: out.get("y")):
        out["y"] = result
    assert t.counts["device"] == 1 and t.totals["device"] > 0


@pytest.mark.parametrize("totals,counts", [
    ({}, {}),
    ({"fwd": 1.23456789, "bwd": 0.0004, "a_step": 12.5}, {"fwd": 3, "bwd": 7, "a_step": 1}),
])
def test_step_timer_report_equals_jax(totals, counts):
    timers = [port.StepTimer(), ref.StepTimer()]
    for t in timers:
        t.totals, t.counts = dict(totals), dict(counts)
    assert timers[0].report() == timers[1].report()
    assert [timers[0].mean(k) for k in ("fwd", "none")] == [timers[1].mean(k) for k in ("fwd", "none")]


@pytest.mark.parametrize("sample_rate,adds", [
    (16000, [(0.5, 160000, None), (0.5, None, 10.0)]),
    (22050, [(0.123, 44100, None), (0.25, 1000, 3.5), (0.01, None, None)]),
    (16000, []),
])
def test_rtf_meter_report_equals_jax(sample_rate, adds):
    meters = [port.RTFMeter(sample_rate), ref.RTFMeter(sample_rate)]
    for m in meters:
        for s, n, a in adds:
            m.add(s, n_samples=n, audio_seconds=a)
    assert meters[0].report() == meters[1].report()
    assert meters[0].rtf == meters[1].rtf
    if not adds:
        assert meters[0].rtf == 0.0


def test_trace_writes_nested_spans(tmp_path, monkeypatch):
    monkeypatch.delenv("SER_TPU_TRACE", raising=False)
    with port.trace(str(tmp_path / "tr")) as tr:
        with port.annotate("outer_span"):
            with port.annotate("inner_span"):
                torch.randn(8, 8) @ torch.randn(8, 8)
    assert tr.path.endswith(".pt.trace.json") and glob.glob(str(tmp_path / "tr" / "*.pt.trace.json")) == [tr.path]
    with open(tr.path) as f:
        spans = {e["name"]: e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"}
    outer, inner = spans["outer_span"], spans["inner_span"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("env,enabled", [("0", True), (None, False), ("redirect", True)])
def test_trace_switches(tmp_path, monkeypatch, env, enabled):
    log_dir, other = tmp_path / "asked", tmp_path / "redirected"
    if env is None:
        monkeypatch.delenv("SER_TPU_TRACE", raising=False)
    else:
        monkeypatch.setenv("SER_TPU_TRACE", str(other) if env == "redirect" else env)
    with port.trace(str(log_dir), enabled=enabled) as tr:
        torch.ones(2) + 1
    assert not log_dir.exists()
    if env == "redirect":
        assert os.path.dirname(tr.path) == str(other) and os.path.exists(tr.path)
    else:
        assert tr is None and not other.exists()


def _tiny_wavlm(dtype="float32"):
    from interspeech_ser_tpu_torch.models import speech

    return speech.SpeechConfig(
        hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
        conv_dim=(16,) * 3, conv_kernel=(10, 8, 8), conv_stride=(5, 8, 8), conv_bias=True,
        feat_extract_norm="layer", do_stable_layer_norm=True, attention_type="wavlm",
        num_conv_pos_embeddings=16, conv_pos_groups=4, dtype=dtype)


def test_profile_trace_on_cpu(tmp_path, monkeypatch, capsys):
    from interspeech_ser_tpu_torch import profile_trace
    from interspeech_ser_tpu_torch.models import speech

    monkeypatch.setattr(speech, "wavlm_large", _tiny_wavlm)
    monkeypatch.delenv("SER_TPU_TRACE", raising=False)
    run = profile_trace.main(["--steps", "2", "--batch", "2", "--seconds", "0.5", "--log_dir", str(tmp_path),
                              "--device", "cpu", "--seed", "3"])
    assert run.spans == ["extract_step_0", "extract_step_1"] and run.samples_per_step == 2 * 8000
    with open(run.path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    assert names == run.spans
    assert sorted(run.timer.counts.items()) == [("extract_step_0", 1), ("extract_step_1", 1)]
    assert f"trace written under {tmp_path}" in capsys.readouterr().out


def test_profile_trace_default_device_needs_a_card(monkeypatch, tmp_path):
    from interspeech_ser_tpu_torch import profile_trace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        profile_trace.profile_trace(steps=1, log_dir=str(tmp_path))
    assert not os.listdir(tmp_path)
