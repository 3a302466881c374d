"""Evaluation and fairness metrics of the lora_wavlm fine-tune.

Port of ``lora_wavlm/evaluation.py``: ``EvalMetric`` (accuracy, UAR,
confusion matrix, mean loss) and the three fairness metrics the reference
takes from holisticai, computed directly (demographic parity, statistical
parity, equality of opportunity). Host numpy; a group with no rows gives
what the JAX package gives (``nan`` from an empty mean in the parities, 0
true-positive rate in equality of opportunity).
"""

from __future__ import annotations

import numpy as np

from .train.lora_engine import uar


class EvalMetric:
    def __init__(self, num_classes: int = 4):
        self.num_classes = num_classes
        self.y_true, self.y_pred, self.losses = [], [], []

    def append_classification_results(self, labels, preds, loss=None) -> None:
        self.y_true.extend(np.asarray(labels).tolist())
        self.y_pred.extend(np.asarray(preds).tolist())
        if loss is not None:
            self.losses.append(float(loss))

    def classification_summary(self) -> dict:
        y_true, y_pred = np.asarray(self.y_true), np.asarray(self.y_pred)
        conf = np.zeros((self.num_classes, self.num_classes), dtype=np.int64)
        np.add.at(conf, (y_true.astype(np.int64), y_pred.astype(np.int64)), 1)
        return {
            "acc": float((y_true == y_pred).mean()) if len(y_true) else 0.0,
            "uar": uar(y_true, y_pred, self.num_classes),
            "conf": conf,
            "loss": float(np.mean(self.losses)) if self.losses else 0.0,
        }


def demographic_parity(y_pred, groups) -> float:
    """Max |P(y_hat = c | g) - P(y_hat = c | g')| over the predicted classes and group pairs."""
    y_pred, groups = np.asarray(y_pred), np.asarray(groups)
    max_gap = 0.0
    for c in np.unique(y_pred):
        rates = [float((y_pred[groups == g] == c).mean()) for g in np.unique(groups)]
        max_gap = max(max_gap, max(rates) - min(rates))
    return max_gap


def statistical_parity(y_pred, groups, favorable_class) -> float:
    """P(y_hat = c | g = 1) - P(y_hat = c | g = 0), a binary group coding."""
    y_pred, groups = np.asarray(y_pred), np.asarray(groups)
    return float((y_pred[groups == 1] == favorable_class).mean()) - float(
        (y_pred[groups == 0] == favorable_class).mean())


def equality_of_opportunity(y_true, y_pred, groups, favorable_class) -> float:
    """TPR(g = 1) - TPR(g = 0) for the favorable class."""
    y_true, y_pred, groups = np.asarray(y_true), np.asarray(y_pred), np.asarray(groups)

    def tpr(g):
        sel = (groups == g) & (y_true == favorable_class)
        return float((y_pred[sel] == favorable_class).mean()) if sel.sum() else 0.0

    return tpr(1) - tpr(0)
