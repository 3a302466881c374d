"""Perf-ledger suite artifacts: schema, regression comparator, tables.

Port of ``interspeech_ser_tpu/utils/benchsuite.py`` with the same names,
schema and outputs, so that both packages give the same verdicts on the
same artifacts. A bench script re-measures every headline metric on the
card and writes ONE artifact (``BENCH_SUITE_r{N}.json``) through this
module; the comparator diffs two artifacts and fails loudly on out-of-band
regressions.

Artifact schema::

    {"device": "...", "metrics": {
        "<name>": {"value": N, "unit": "...", "lo": N, "hi": N,
                    "higher_is_better": true, "config": "..."},
        ...}}

``lo``/``hi`` are the min/max over the suite's repeated timed runs — the
metric's observed noise band for that session.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

# run-to-run variance floor: the JAX package's value, kept so that both
# comparators give the same verdicts; it was not measured on the card
MIN_TOLERANCE = 0.03


def metric_entry(
    value: float,
    unit: str,
    samples: Optional[List[float]] = None,
    higher_is_better: bool = True,
    config: str = "",
) -> dict:
    samples = samples or [value]
    return {
        "value": round(value, 2),
        "unit": unit,
        "lo": round(min(samples), 2),
        "hi": round(max(samples), 2),
        "higher_is_better": higher_is_better,
        "config": config,
    }


def _rel_band(m: dict) -> float:
    v = abs(m["value"]) or 1.0
    return (m["hi"] - m["lo"]) / v


def compare_suites(old: dict, new: dict) -> Tuple[List[str], List[str]]:
    """→ (regressions, notes). A metric regresses when it moves in the
    BAD direction by more than the tolerance — the larger of each run's
    observed noise band and the ``MIN_TOLERANCE`` floor. Metrics present
    in only one artifact are notes (coverage changes), never failures."""
    regressions, notes = [], []
    om, nm = old.get("metrics", {}), new.get("metrics", {})
    for name in sorted(set(om) | set(nm)):
        if name not in om:
            notes.append(f"NEW metric {name}: {nm[name]['value']} {nm[name]['unit']}")
            continue
        if name not in nm:
            notes.append(f"metric {name} DROPPED (was {om[name]['value']})")
            continue
        o, n = om[name], nm[name]
        tol = max(MIN_TOLERANCE, _rel_band(o), _rel_band(n))
        hib = n.get("higher_is_better", True)
        ratio = (n["value"] / o["value"]) if o["value"] else 1.0
        bad = ratio < 1.0 - tol if hib else ratio > 1.0 + tol
        line = (
            f"{name}: {o['value']} -> {n['value']} {n['unit']} "
            f"({(ratio - 1.0) * 100:+.1f}%, tol ±{tol * 100:.0f}%)"
        )
        if bad:
            regressions.append(line)
        else:
            notes.append(line)
    return regressions, notes


def format_table(suite: dict) -> str:
    """Markdown table of a suite — generated, not hand-transcribed."""
    rows = ["| Metric | Value | Band (min-max) | Config |",
            "|---|---|---|---|"]
    for name, m in suite.get("metrics", {}).items():
        rows.append(
            f"| {name} | **{m['value']} {m['unit']}** "
            f"| {m['lo']}-{m['hi']} | {m.get('config', '')} |"
        )
    return "\n".join(rows)


def load_suite(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
