"""Host spans around the harness's calls into the program, and the device trace.

``Spans`` times the harness's own calls into each layer (``next()`` on a
batch stream, a forward, a copy's wait, a training step) on the host clock
while a window is open; inside a traced slice each span is also a
``record_function`` range, so that the trace can say what the host was doing
while the device sat idle.

``Trace`` reads the Chrome trace of ``torch.profiler`` over a traced slice:
the slice's length (its ``portbench.trace`` range), the union of device
activity (kernels, copies, fills) inside it, the device seconds of kernels
by name, of copies by kind, and the longest idle stretches by the span that
was open on the host.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_SPAN = "portbench.trace"


class Spans:
    def __init__(self):
        self.seconds: Dict[str, List[float]] = defaultdict(list)
        self.recording = False  # a window is open
        self.profiling = False  # a traced slice is open

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not (self.recording or self.profiling):
            yield
            return
        t0 = time.perf_counter()
        if self.profiling:
            from torch.profiler import record_function

            with record_function(f"portbench.{name}"):
                yield
        else:
            yield
        if self.recording:
            self.seconds[name].append(time.perf_counter() - t0)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' decoration,
    template and parameters; a copy's or fill's name as it is."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("(", "<"):
        name = name.split(stop, 1)[0]
    return name.strip()[:96]


def _union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device: List[dict]  # device events inside the slice: name, ts, dur (us), cat
    gaps: List[Tuple[float, str]]  # idle stretches: (seconds, the host span open at its middle)
    items: int = 0  # batches or steps run in the slice
    bounds: Dict[str, float] = field(default_factory=dict)  # kernel -> least seconds of the slice's work

    def kernel_seconds(self, names: Sequence[str]) -> float:
        return sum(e["dur"] for e in self.device if e["cat"] == "kernel" and any(n in e["name"] for n in names)) / 1e6

    def copy_seconds(self, kind: str) -> float:
        """Device seconds of the copies whose name holds ``kind`` (``HtoD``, ``DtoH``)."""
        return sum(e["dur"] for e in self.device if e["cat"] == "gpu_memcpy" and kind in e["name"]) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        by = defaultdict(float)
        for e in self.device:
            by[short_name(e["name"])] += e["dur"] / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> List[list]:
        """Idle seconds summed by the host span open during each idle stretch."""
        by = defaultdict(float)
        for s, name in self.gaps:
            by[name] += s
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def read_trace(path: str) -> Optional[Trace]:
    """The traced slice of a Chrome trace, or None when the trace holds no
    slice or no device event."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == TRACE_SPAN]
    if not window:
        return None
    w0 = window[0]["ts"]
    w1 = w0 + window[0]["dur"]
    device = [dict(name=e["name"], ts=e["ts"], dur=e["dur"], cat=e["cat"]) for e in xs
              if e.get("cat") in DEVICE_CATS and w0 <= e["ts"] and e["ts"] + e["dur"] <= w1]
    if not device:
        return None
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][len("portbench."):]) for e in xs
                    if e.get("cat") == "user_annotation" and e.get("name", "").startswith("portbench.")
                    and e["name"] != TRACE_SPAN), key=lambda s: s[0])
    gaps = []
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            mid = (a + b) / 2
            open_ = [s for s in spans if s[0] <= mid <= s[1]]
            gaps.append(((b - a) / 1e6, min(open_, key=lambda s: s[1] - s[0])[2] if open_ else "outside spans"))
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=sum(b - a for a, b in busy) / 1e6, device=device, gaps=gaps)
