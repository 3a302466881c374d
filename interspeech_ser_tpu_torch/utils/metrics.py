"""Host-side metrics, pure numpy.

Port of ``interspeech_ser_tpu/utils/metrics.py``'s ``macro_f1`` (sklearn
``f1_score(average='macro')`` semantics: per-class F1 with zero-division =
0, averaged over the classes seen in ``y_true`` or ``y_pred``),
``concordance_ccc`` (the challenge baseline's dimensional metric),
``accuracy`` (the text-only trainer's) and ``LogManager`` (the running stat
book).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def macro_f1(y_true, y_pred, num_classes: int = 8) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    f1 = np.zeros(num_classes, dtype=np.float64)
    for c in range(num_classes):
        tp = np.sum((y_pred == c) & (y_true == c))
        denom = np.sum(y_pred == c) + np.sum(y_true == c)
        f1[c] = 2 * tp / denom if denom > 0 else 0.0
    observed = np.union1d(np.unique(y_true), np.unique(y_pred)).astype(int)
    return float(np.mean(f1[observed]))


def accuracy(y_true, y_pred) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def concordance_ccc(pred, lab) -> float:
    """Concordance correlation coefficient with population (biased) moments,
    in float64: ``2 cov / (var_p + var_l + (m_p - m_l)^2 + 1e-9)``."""
    pred = np.asarray(pred, dtype=np.float64)
    lab = np.asarray(lab, dtype=np.float64)
    m_p, m_l = pred.mean(), lab.mean()
    d_p, d_l = pred - m_p, lab - m_l
    cov = np.mean(d_p * d_l)
    var_p = np.mean(d_p * d_p)
    var_l = np.mean(d_l * d_l)
    return float(2 * cov / (var_p + var_l + (m_p - m_l) ** 2 + 1e-9))


class LogManager:
    """Named lists of floats with mean summaries: ``alloc_stat_type_list``
    declares stats, ``add_stat`` appends, ``print_stat`` prints (and returns)
    ``name:mean`` at 4 decimals for the non-empty ones."""

    def __init__(self) -> None:
        self.stats: Dict[str, List[float]] = {}

    def alloc_stat_type_list(self, names: Sequence[str]) -> None:
        for name in names:
            self.stats[name] = []

    def init_stat(self) -> None:
        for name in self.stats:
            self.stats[name] = []

    def add_stat(self, name: str, value) -> None:
        self.stats[name].append(float(value))

    def print_stat(self) -> str:
        line = " ".join(f"{name}:{np.mean(vals):.4f}" for name, vals in self.stats.items() if vals)
        print(line)
        return line
