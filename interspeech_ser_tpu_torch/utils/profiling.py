"""Lightweight timing/observability utilities over ``torch.profiler``.

Port of ``interspeech_ser_tpu/utils/profiling.py`` with its API. The
reference's only profiling is bespoke ``perf_counter`` inference timing
with processed-audio-seconds accounting (reference:
benchmark/train_eval_files/eval_cat_ser.py:158-180, eval_dim_ser.py:159-162).
These helpers generalize that: a ``StepTimer`` accumulating named spans, an
``RTFMeter`` for inference-time-per-audio-second, and ``trace`` /
``annotate`` wrappers over ``torch.profiler`` for a Chrome trace
(``*.pt.trace.json``) that Perfetto and TensorBoard open.

A CUDA kernel launch returns before the kernel has run, so a host clock
around launches measures the launches, not the work. ``StepTimer.span``
with a ``result_getter`` therefore copies one element of the step's output
to the host before it stops the clock: the copy waits for every kernel
queued before it on that stream.

The program's own spans and counters (``span``, ``count``, read by
``snapshot``) sit on its hot path and cost one read of a flag while no
``torch.profiler`` session records. While one does, a span is also an
``annotate`` range named ``ser.<name>`` (it lands in the Chrome trace from
the thread that started the session; ranges opened on other threads may
not), and every span and counter, from any thread, is added to one
process-wide record that ``snapshot`` reads and ``reset`` clears. A span
is recorded only when a session records both where it opens and where it
closes, so one left open across a session's start or stop (a thread blocked
on a queue) is left out whole, and a lone session's record holds the spans
that lie inside it.
"""

from __future__ import annotations

import contextlib
import os
import socket
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

# /tmp/ser_tpu_trace, as in the JAX package, unless TMPDIR names another place
DEFAULT_LOG_DIR = os.path.join(tempfile.gettempdir(), "ser_tpu_trace")


class Trace:
    """What a ``trace()`` capture wrote: ``path`` is the Chrome-trace JSON,
    set when the block ends."""

    def __init__(self, log_dir: str) -> None:
        self.log_dir = log_dir
        self.path: Optional[str] = None

    def _write(self, prof) -> None:
        # tensorboard_trace_handler's file naming, with the path kept
        name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"
        self.path = os.path.join(self.log_dir, name)
        prof.export_chrome_trace(self.path)


@contextlib.contextmanager
def trace(log_dir: str = DEFAULT_LOG_DIR, enabled: bool = True):
    """Capture a ``torch.profiler`` trace around the wrapped block.

    Records the CPU and, when the process has a CUDA device, the card, and
    writes one ``*.pt.trace.json`` under ``log_dir`` (open it in Perfetto or
    TensorBoard). Set ``SER_TPU_TRACE=/path`` in the environment to
    redirect, or ``SER_TPU_TRACE=0`` / ``enabled=False`` to turn capture
    into a no-op that creates nothing (so call sites can leave the context
    manager in place). Yields a :class:`Trace` (``None`` when off).

    In a process that has run much GPU work untraced, ``torch.profiler`` has
    been seen to lose the kernel records at a session's start (the launch
    calls stay); a trace whose kernels must all be there is best taken in a
    fresh process, as ``profile_trace`` is.
    """
    env = os.environ.get("SER_TPU_TRACE")
    if env == "0" or not enabled:
        yield None
        return
    if env:
        log_dir = env
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    out = Trace(log_dir)
    with profile(activities=activities, on_trace_ready=out._write):
        yield out


def annotate(name: str):
    """Named ``record_function`` context — a span on the trace timeline
    inside a ``trace()`` capture. Kernels launched within it are tied to it
    through their launch events' correlation ids."""
    return record_function(name)


_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_SPANS: Dict[str, Tuple[int, float]] = {}  # name -> (occurrences, host seconds)
_COUNTERS: Dict[str, int] = {}  # name -> sum


class _Span:
    """A span opened while a session records: an ``annotate`` range and a
    host duration added to the record when it closes, raised or not, if a
    session still records then."""

    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        self.range = annotate(f"ser.{self.name}")
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        if _autograd_profiler._is_profiler_enabled:
            with _LOCK:
                n, s = _SPANS.get(self.name, (0, 0.0))
                _SPANS[self.name] = (n + 1, s + dt)
        return False


def span(name: str):
    """A context manager timing the block as the program's span ``name``.
    While no ``torch.profiler`` session records it reads one flag and does
    nothing else: no clock, no lock, no allocation."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the program's counter ``name`` while a session records."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def snapshot() -> Dict[str, Dict]:
    """The record so far: ``{"spans": {name: (occurrences, host seconds)},
    "counters": {name: sum}}``."""
    with _LOCK:
        return {"spans": dict(_SPANS), "counters": dict(_COUNTERS)}


def reset() -> None:
    """Clear the record."""
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()


def _first_leaf(out):
    """The first tensor of a tensor or a (nested) tuple / list / dict."""
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            leaf = _first_leaf(item)
            if leaf is not None:
                return leaf
        return None
    return out


class StepTimer:
    """Accumulate wall-time per named span; CUDA-safe when given an output.

    >>> timer = StepTimer()
    >>> with timer.span("forward", result_getter=lambda: logits):
    ...     logits = step(params, batch)
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str, result_getter=None):
        t0 = time.perf_counter()
        with annotate(name):
            yield
        if result_getter is not None:
            # force a device readback: the launches returned before the
            # kernels ran, and the copy waits for the stream that made it
            leaf = _first_leaf(result_getter())
            if leaf is not None:
                leaf.reshape(-1)[:1].cpu()
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def mean(self, name: str) -> float:
        return self.totals.get(name, 0.0) / max(self.counts.get(name, 0), 1)

    def report(self) -> str:
        parts = [
            f"{k}: total {self.totals[k]:.3f}s mean {self.mean(k) * 1000:.1f}ms "
            f"(n={self.counts[k]})"
            for k in sorted(self.totals)
        ]
        return "\n".join(parts)


class RTFMeter:
    """Inference-seconds per audio-second (the reference's eval printout)."""

    def __init__(self, sample_rate: int = 16000) -> None:
        self.sample_rate = sample_rate
        self.inference_s = 0.0
        self.audio_s = 0.0

    def add(self, inference_seconds: float, n_samples: Optional[int] = None,
            audio_seconds: Optional[float] = None) -> None:
        self.inference_s += inference_seconds
        if audio_seconds is not None:
            self.audio_s += audio_seconds
        elif n_samples is not None:
            self.audio_s += n_samples / self.sample_rate

    @property
    def rtf(self) -> float:
        return self.inference_s / self.audio_s if self.audio_s else 0.0

    def report(self) -> str:
        # matches the reference's wording (eval_dim_ser.py:159-162)
        return (
            f"Duration of whole dev+test set {self.audio_s} sec\n"
            f"Inference time {self.inference_s} sec\n"
            f"Inference time per sec {self.rtf} sec"
        )
