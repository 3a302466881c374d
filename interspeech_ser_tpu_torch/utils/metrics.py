"""Macro-F1 (sklearn ``f1_score(average='macro')`` semantics), pure numpy.

Port of ``interspeech_ser_tpu/utils/metrics.macro_f1``: per-class F1 with
zero-division = 0, averaged over the classes seen in ``y_true`` or ``y_pred``.
"""

from __future__ import annotations

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
