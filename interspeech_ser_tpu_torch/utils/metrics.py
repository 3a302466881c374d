"""Host-side metrics, pure numpy.

Port of ``interspeech_ser_tpu/utils/metrics.py``'s ``macro_f1`` (sklearn
``f1_score(average='macro')`` semantics: per-class F1 with zero-division =
0, averaged over the classes seen in ``y_true`` or ``y_pred``),
``concordance_ccc`` (the challenge baseline's dimensional metric; ``ccc``,
the same on device tensors),
``accuracy`` (the text-only trainer's) and ``micro_f1`` (its equal for
single-label classes), ``calc_err`` / ``calc_acc`` (error rate and accuracy
from logits, the baseline's loss manager) and ``LogManager`` (the running
stat book).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


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


def micro_f1(y_true, y_pred) -> float:
    """Micro F1: accuracy, for single-label classes."""
    return accuracy(y_true, y_pred)


def calc_err(pred_logits, labels) -> float:
    """The error rate of the logits' arg-max."""
    lab = np.asarray(labels)
    ans = np.argmax(np.asarray(pred_logits), axis=1)
    return float((len(lab) - (ans == lab).sum()) / len(lab))


def calc_acc(pred_logits, labels) -> float:
    return 1.0 - calc_err(pred_logits, labels)


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


def ccc(pred: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    """The CCC on the device, in the tensors' dtype, differentiable (``concordance_ccc``'s formula)."""
    m_p, m_l = pred.mean(), lab.mean()
    d_p, d_l = pred - m_p, lab - m_l
    cov = (d_p * d_l).mean()
    return 2 * cov / ((d_p * d_p).mean() + (d_l * d_l).mean() + (m_p - m_l) ** 2 + 1e-9)


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
