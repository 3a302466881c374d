"""The harness: one cell of ``BENCHMARK.json`` a run, found by name.

A cell names a configuration (its file under ``portbench/configs``) and a
traffic mix (``portbench/traffic/<traffic>.json``, which names the driver in
``portbench/drivers`` that runs it and holds the generator's parameters);
the limits of its correctness check are ``portbench/limits/<cell>.json``;
each per-layer metric is read by ``portbench/metrics/<metric>.py``. A run:

1. set-up: the driver writes its inputs, makes its weights on the card from
   the seed, builds the program and warms every shape the traffic uses;
2. the window: the driver's steps, closed-loop, for ``--seconds`` on the
   host clock and on to the end of the pass over the inputs they are in,
   then a readback; nothing compiles inside it;
3. with ``--trace 1``, a traced slice after the window, under
   ``torch.profiler``;
4. the peak memory is read, the program's state freed, and the driver's
   check compares what the window produced with the plain reference;
5. the numbers compared go to standard error, each beside its limit, and
   the result is the last line of standard output.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .tracing import TRACE_SPAN, Spans, read_trace

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "interspeech_ser_tpu")


def process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


class MetricUnread(RuntimeError):
    """A traced run on the card found nothing to read for a per-layer metric declared for its cell."""


def require_read(cell: "Cell", metrics: Dict, on_card: bool) -> None:
    """Every per-layer metric that BENCHMARK.json gives a cell has something
    to read in a traced run on the card: one that reads nothing there has
    lost sight of its layer (a kernel renamed, its work moved to another),
    and the run gives no result. Off the card nothing is traced, and the
    trace's metrics are left out."""
    unread = [m["name"] for m in cell.per_layer if m["name"] not in metrics]
    if unread and on_card:
        raise MetricUnread(f"{cell.name}: read nothing for {', '.join(unread)}")


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(root / "portbench" / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, config, traffic, limits, w["chips"], e2e, layer)


def metric_reader(name: str, root: Path = ROOT):
    """``portbench/metrics/<name>.py``'s ``read(ctx)``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


@dataclasses.dataclass
class Run:
    """What a driver is given."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    workdir: str
    spans: Spans
    control: bool = False  # the check also reads the control (portbench/readings.py)


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader is given."""

    cell: Cell
    window: Dict  # seconds, units, items, flops
    spans: Dict[str, List[float]]
    trace: Optional[object]  # tracing.Trace of the traced slice, or None
    dtype: str


def _loop(driver, seconds: float, spans: Spans, whole: bool = False) -> Tuple[float, int, int]:
    """The driver's steps until ``seconds`` have passed (with ``whole``, and
    then on to the end of the pass over its inputs that it is in), then its
    readback -> (seconds from the first step to the readback's end, units,
    steps). Whole passes make every window the same mix of work: a pass's
    batches differ in utterances a second by 3.6x, so a window cut inside a
    pass reads up to 1% off by where it was cut."""
    t0 = time.perf_counter()
    t_end = t0 + seconds
    units = steps = 0
    while time.perf_counter() < t_end or (whole and not driver.pass_done()):
        units += driver.step()
        steps += 1
    with spans("finish"):
        units += driver.finish()
    return time.perf_counter() - t0, units, steps


def traced_slice(driver, seconds: float, spans: Spans, workdir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    driver.tracing = True
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    spans.profiling = True
    with record_function(TRACE_SPAN):
        _, _, items = _loop(driver, seconds, spans)
        torch.cuda.synchronize()
    spans.profiling = False
    prof.stop()
    driver.tracing = False
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    tr = read_trace(path)
    if tr is not None:
        tr.items, tr.bounds = items, dict(driver.trace_bounds)
        print(f"[portbench] trace: {os.path.getsize(path) / 2 ** 20:.2f} MiB, {items} steps, "
              f"{len(tr.device)} device events in {tr.window_s:.3f} s", file=sys.stderr)
    os.remove(path)
    return tr


def warm_profiler() -> None:
    """One empty profiler session in set-up, so that the traced slice
    starts with CUPTI already set up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, control: bool = False, root: Path = ROOT) -> Dict:
    """Set-up, window, traced slice, check -> the result, with the driver's
    readings (under ``control``, the control's too) in ``readings``."""
    import torch

    t_start = time.time() if t_start is None else t_start
    spans = Spans()
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        driver_mod = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
        run = Run(cell, seed, seconds, trace, device, workdir, spans, control)
        driver = driver_mod.Driver(run)
        driver.setup()
        if trace and device == "cuda":
            warm_profiler()
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.time() - t_start

        spans.recording = True
        driver.recording = True
        window_s, units, steps = _loop(driver, seconds, spans, whole=True)
        driver.recording = False
        spans.recording = False
        window = dict(seconds=window_s, units=units, items=steps, flops=driver.window_flops)

        tr = traced_slice(driver, cell.traffic["trace_seconds"], spans, workdir) if trace and device == "cuda" else None
        memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        driver.free()
        t_check = time.perf_counter()
        checks, readings = driver.check()
        print(f"[portbench] check: {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
        correct = bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)

        e2e = driver.end_to_end(window, setup_s)
        if trace:
            ctx = Context(cell, window, dict(spans.seconds), tr, cell.traffic["dtype"])
            metrics = {}
            for m in cell.per_layer:
                v = metric_reader(m["name"], root)(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            require_read(cell, metrics, on_card=device == "cuda")
        else:
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
        dev = {"platform": "gpu" if device == "cuda" else device,
               "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
               "count": cell.chips, "memory_peak_bytes": memory_peak}
        result = {"correct": correct, "attempted": driver.attempted, "failed": driver.failed,
                  "metrics": metrics, "device": dev}
        if tr is not None:
            dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
            result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
        result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
        result["readings"] = readings  # for portbench/readings.py; not part of the printed line
        for name, s in sorted(spans.seconds.items()):
            s = sorted(s)
            print(f"[portbench] span {name}: {len(s)} x, {sum(s):.3f} s, median {1e3 * s[len(s) // 2]:.3f} ms, "
                  f"max {1e3 * s[-1]:.3f} ms", file=sys.stderr)
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[portbench] {args.workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result", file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    except MetricUnread as e:
        print(f"[portbench] {e}: no result", file=sys.stderr)
        return 4
    result.pop("readings")
    print(f"[portbench] {power_limit()}; peaks: 67 TFLOP/s f32, 989 bf16, 3.35 TB/s (H100 SXM, 700 W)",
          file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"[portbench] loaded in this process: {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0
