"""The losses of the four lazy-fusion trainers, with torch-parity semantics.

Port of the subset of ``interspeech_ser_tpu/train/losses.py`` that
``bin/train_cat_{bimodal,trimodal}_lazy_*`` and the challenge baseline use:
weighted CE, focal loss with and without dynamic alpha, the ranking
trainers' soft-margin loss and the dimensional task's CCC loss.
Every loss takes an optional ``sample_mask`` (1 = real row, 0 = a padding
row that fills the fixed batch size): masked rows add nothing to the
numerator or the denominator, so a padded batch reduces as the unpadded one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return values.mean()
    mask = mask.to(values.dtype)
    return (values * mask).sum() / mask.sum().clamp_min(1e-12)


def weighted_cross_entropy(
    logits: torch.Tensor,  # [B, C]
    targets: torch.Tensor,  # [B] class indices
    class_weights: Optional[torch.Tensor] = None,  # [C]
    sample_mask: Optional[torch.Tensor] = None,  # [B]
) -> torch.Tensor:
    """torch ``CrossEntropyLoss(weight=w)``: the weighted mean divides by the
    sum of the rows' class weights, not by the batch size."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, targets[:, None])[:, 0]
    w = torch.ones_like(nll) if class_weights is None else class_weights[targets].to(nll.dtype)
    if sample_mask is not None:
        w = w * sample_mask.to(w.dtype)
    return (nll * w).sum() / w.sum().clamp_min(1e-12)


def focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    alpha: float = 1.0,
    gamma: float = 2.0,
    dynamic_alpha: bool = False,
    sample_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax-pt focal loss; ``dynamic_alpha`` weighs each row by 1 - pt
    (the trimodal trainers)."""
    probs = torch.softmax(logits.float(), dim=-1)
    pt = probs.gather(1, targets[:, None])[:, 0]
    ce = -torch.log(pt + 1e-8)
    modulating = (1.0 - pt) ** gamma
    a = (1.0 - pt) if dynamic_alpha else alpha
    return _masked_mean(a * modulating * ce, sample_mask)


def soft_margin_loss(
    logits: torch.Tensor,  # [B, 1] neutral-head logits
    targets_pm1: torch.Tensor,  # [B, 1] +-1 targets
    sample_mask: Optional[torch.Tensor] = None,  # [B]
) -> torch.Tensor:
    """torch ``SoftMarginLoss``: mean log(1 + exp(-y x)) over the elements."""
    x = logits.float()
    y = targets_pm1.float()
    per_elem = F.softplus(-y * x)
    if sample_mask is None:
        return per_elem.mean()
    mask = sample_mask.reshape(sample_mask.shape + (1,) * (per_elem.ndim - sample_mask.ndim))
    return _masked_mean(per_elem, mask.expand_as(per_elem))


def ccc_loss(
    pred: torch.Tensor,  # [B, A] predicted attributes
    lab: torch.Tensor,  # [B, A] labels
    sample_mask: Optional[torch.Tensor] = None,  # [B]
) -> torch.Tensor:
    """``sum over attributes of (1 - CCC)`` (``3 - sum CCC`` for arousal,
    dominance and valence), each CCC with population moments over the valid
    rows, in f32."""
    pred = pred.float()
    lab = lab.float()
    w = torch.ones(pred.shape[0], device=pred.device) if sample_mask is None else sample_mask.float()
    wsum = w.sum().clamp_min(1e-12)
    total = pred.new_zeros(())
    for i in range(pred.shape[1]):
        p, l = pred[:, i], lab[:, i]
        m_p = (p * w).sum() / wsum
        m_l = (l * w).sum() / wsum
        d_p, d_l = p - m_p, l - m_l
        cov = (d_p * d_l * w).sum() / wsum
        var_p = (d_p * d_p * w).sum() / wsum
        var_l = (d_l * d_l * w).sum() / wsum
        total = total + (1.0 - 2 * cov / (var_p + var_l + (m_p - m_l) ** 2 + 1e-9))
    return total
