"""Collective audit: what a step really communicated.

Port of ``interspeech_ser_tpu/parallel/audit.py``. The JAX package compiles
the production step and scans its optimized HLO for collectives; here every
collective the port issues goes through ``parallel.mesh``'s helpers, which
report each call to ``record``. Inside ``collective_audit()`` the calls and
their elements add up per op kind (a gather counts the elements of its
result, as the HLO audit does), and ``audit_line`` prints them in the JAX
format: ``collectives: all-reduce×2 (1234 elems)``, or ``NONE`` when no
collective ran (a one-rank run: the helpers issue nothing there).

The HLO parser and ``lower_fusion_train_step`` have no counterpart: there is
no compiled program to read, only the calls themselves.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Union

import torch

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute", "all-to-all", "broadcast")

_ACTIVE: List[Dict[str, Dict[str, int]]] = []


def empty_audit() -> Dict[str, Dict[str, int]]:
    return {k: {"count": 0, "elements": 0} for k in COLLECTIVE_OPS}


@contextlib.contextmanager
def collective_audit():
    """Count every collective issued inside the context -> the per-op dict
    ``{op: {"count", "elements"}}`` (filled as the context runs)."""
    rec = empty_audit()
    _ACTIVE.append(rec)
    try:
        yield rec
    finally:
        _ACTIVE.remove(rec)


def record(op: str, elements: int) -> None:
    """Called by ``parallel.mesh`` for each collective it issues."""
    for rec in _ACTIVE:
        rec[op]["count"] += 1
        rec[op]["elements"] += int(elements)


def audit_line(audit: Dict[str, Dict[str, int]]) -> str:
    """One-line summary, as the JAX package's dryrun logs print it."""
    parts = [f"{op}×{rec['count']} ({rec['elements']} elems)" for op, rec in audit.items() if rec["count"]]
    return "collectives: " + (", ".join(parts) if parts else "NONE")


def param_elements(params: Union[torch.nn.Module, Dict[str, torch.Tensor], Iterable[torch.Tensor]]) -> int:
    """Elements of a parameter collection: a module's trainable parameters, a
    dict's values or an iterable of tensors."""
    if isinstance(params, torch.nn.Module):
        params = [p for p in params.parameters() if p.requires_grad]
    elif isinstance(params, dict):
        params = params.values()
    return sum(int(p.numel()) for p in params)
