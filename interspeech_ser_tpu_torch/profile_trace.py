"""Capture a ``torch.profiler`` trace of the extraction hot path.

    python -m interspeech_ser_tpu_torch.profile_trace [--model wavlm|whisper] [--steps 3] \
        [--batch 32] [--seconds 10.0] [--log_dir DIR] [--device cuda|cpu] [--seed 0]
    # -> DIR/<host>_<pid>.<ms>.pt.trace.json (open in Perfetto or TensorBoard)

Port of ``scripts/profile_trace.py`` with its flags, plus ``--device``
(``cuda`` by default; ``cpu`` only when asked) and ``--seed``. The model is
a seeded random init at full width, its parameters cast to bf16 once:

- ``wavlm``: WavLM-large (``models/speech.wavlm_large``) with the
  inference kernels on (K1 in each layer, K2's layer 0, K8), over
  ``[batch, 16000 * seconds]`` noise with an all-ones mask;
- ``whisper``: the Whisper-large-v3 encoder (``models/whisper.
  whisper_large_v3``) over ``ops/mel.whisper_log_mel`` of 8 x 30-s noise
  (``--batch`` and ``--seconds`` are WavLM's, as in the JAX script).

One forward and a readback run outside the trace (the warm-up). Then
``utils/profiling.trace`` records ``--steps`` forwards, each in
``StepTimer.span(f"extract_step_{i}")``: an ``annotate`` span around the
step's launches, then a readback of its output, so that the timer holds
each step's time to its last kernel. :func:`profile_trace` returns the
trace file, the span names and the timer.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import torch

from .utils.device import DEVICES, resolve_device
from .utils.profiling import DEFAULT_LOG_DIR, StepTimer, trace

WHISPER_ROWS, WHISPER_SAMPLES = 8, 480000  # the JAX script's Whisper batch: 8 x 30 s


@dataclasses.dataclass
class TraceRun:
    path: Optional[str]  # the Chrome-trace JSON (None when SER_TPU_TRACE=0)
    spans: List[str]  # the step spans, in order
    timer: StepTimer  # each step's seconds to its readback, under its span's name
    samples_per_step: int  # audio samples a step (batch x length)


def _seeded_init(model_cls, cfg, device: torch.device, gen: torch.Generator) -> torch.nn.Module:
    """``model_cls(cfg)`` built on ``device`` from a seed drawn from ``gen``;
    the global RNGs are left as they were."""
    seed = int(torch.randint(2 ** 31, (), generator=gen))
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []), torch.device(device):
        torch.manual_seed(seed)
        model = model_cls(cfg)
    return model.to(torch.bfloat16).eval()


def _model_step(model: str, batch: int, seconds: float, device: torch.device, gen: torch.Generator):
    """-> (forward, samples a step) of the chosen model at bf16."""
    if model == "wavlm":
        from .models.speech import SpeechEncoderModel, wavlm_large

        cfg = dataclasses.replace(wavlm_large(dtype="bfloat16"), inference_kernels=True)
        net = _seeded_init(SpeechEncoderModel, cfg, device, gen)
        wav = torch.randn(batch, int(16000 * seconds), generator=gen).to(device)
        mask = torch.ones_like(wav)
        return lambda: net(wav, mask, keep=(-1,))["last_hidden_state"], wav.numel()
    from .models.whisper import WhisperEncoderModel, whisper_large_v3
    from .ops.mel import whisper_log_mel

    cfg = whisper_large_v3(dtype="bfloat16")
    net = _seeded_init(WhisperEncoderModel, cfg, device, gen)
    wav = torch.randn(WHISPER_ROWS, WHISPER_SAMPLES, generator=gen).to(device)
    mel = whisper_log_mel(wav, num_mels=cfg.num_mel_bins)
    return lambda: net(mel, keep=(-1,))["last_hidden_state"], wav.numel()


@torch.inference_mode()
def profile_trace(model: str = "wavlm", steps: int = 3, batch: int = 32, seconds: float = 10.0,
                  log_dir: str = DEFAULT_LOG_DIR, device="cuda", seed: int = 0) -> TraceRun:
    """Trace ``steps`` forwards of ``model`` after a warm-up -> :class:`TraceRun`."""
    if model not in ("wavlm", "whisper"):
        raise ValueError(f"model {model!r}: expected wavlm or whisper")
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    step, samples = _model_step(model, batch, seconds, device, gen)
    step().reshape(-1)[:1].cpu()  # the warm-up, outside the trace
    timer, spans = StepTimer(), [f"extract_step_{i}" for i in range(steps)]
    with trace(log_dir) as tr:
        for name in spans:
            out = {}
            with timer.span(name, result_getter=lambda: out["y"]):
                out["y"] = step()
    return TraceRun(tr.path if tr else None, spans, timer, samples)


def main(argv: Optional[list] = None) -> TraceRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="wavlm", choices=["wavlm", "whisper"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--log_dir", default=DEFAULT_LOG_DIR)
    ap.add_argument("--device", default="cuda", choices=DEVICES, help="cuda unless asked: no card raises")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run = profile_trace(args.model, args.steps, args.batch, args.seconds, args.log_dir, args.device, args.seed)
    print(run.timer.report())
    print(f"trace written under {args.log_dir}" + (f": {run.path}" if run.path else ""))
    return run


if __name__ == "__main__":
    main()
