"""The fusion trainers' losses, with torch-parity semantics.

Port of the subset of ``interspeech_ser_tpu/train/losses.py`` that the
lazy-fusion trainers (``bin/`` and the legacy ``bin/old`` ones) and the
challenge baseline use: weighted CE, focal loss with and without dynamic
alpha, the ranking trainers' soft-margin loss, the dimensional task's CCC
and MSE, label-smoothed CE, the hierarchical CE + KL loss, the gender SVM
hinge, linear CKA and the differentiable macro-F1; and the proto-angular
trainers' speaker-embedding losses (angular prototypical, GE2E). Plain
PyTorch, as they are plain XLA in the JAX package.
The classification and regression losses take an optional ``sample_mask``
(1 = real row, 0 = a padding row that fills the fixed batch size): masked
rows add nothing to the numerator or the denominator, so a padded batch
reduces as the unpadded one. ``diff_f1_loss`` takes no mask, and
``cka_loss`` works without one too: the legacy trainers call both on the
whole padded batch, as the JAX engine does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# 8x8 emotion similarity prior (Angry, Sad, Happy, Surprise, Fear, Disgust,
# Contempt, Neutral) of the hierarchical loss
EMOTION_SIMILARITY = np.asarray(
    [
        [1.00, 0.30, 0.10, 0.25, 0.30, 0.60, 0.70, 0.20],
        [0.30, 1.00, 0.10, 0.20, 0.40, 0.30, 0.40, 0.50],
        [0.10, 0.10, 1.00, 0.60, 0.15, 0.10, 0.15, 0.40],
        [0.25, 0.20, 0.60, 1.00, 0.50, 0.20, 0.20, 0.30],
        [0.30, 0.40, 0.15, 0.50, 1.00, 0.40, 0.30, 0.25],
        [0.60, 0.30, 0.10, 0.20, 0.40, 1.00, 0.65, 0.25],
        [0.70, 0.40, 0.15, 0.20, 0.30, 0.65, 1.00, 0.35],
        [0.20, 0.50, 0.40, 0.30, 0.25, 0.25, 0.35, 1.00],
    ],
    dtype=np.float32,
)


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


def smoothed_cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    smoothing: float = 0.0,
    class_weights: Optional[torch.Tensor] = None,
    sample_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Label-smoothed CE. Class weights scale each class's log-prob term;
    the reduction stays a plain mean over the rows (the reference's, unlike
    torch ``CrossEntropyLoss``)."""
    num_classes = logits.shape[-1]
    target = F.one_hot(targets, num_classes).float()
    if smoothing > 0:
        target = (1.0 - smoothing) * target + smoothing / num_classes
    per_class = -(target * F.log_softmax(logits.float(), dim=-1))
    if class_weights is not None:
        per_class = per_class * class_weights[None, :].float()
    return _masked_mean(per_class.sum(dim=-1), sample_mask)


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


def hierarchical_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    similarity_weight: float = 0.1,
    sample_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Weighted CE + ``similarity_weight`` x KL(targets smoothed by
    ``EMOTION_SIMILARITY`` || softmax), the KL a mean over the rows
    (``F.kl_div(..., 'batchmean')``)."""
    sim = torch.from_numpy(EMOTION_SIMILARITY).to(logits.device)
    ce = weighted_cross_entropy(logits, targets, class_weights, sample_mask)
    soft = F.one_hot(targets, logits.shape[-1]).float() @ sim
    soft = soft / soft.sum(dim=1, keepdim=True)
    logp = F.log_softmax(logits.float(), dim=-1)
    kl = (soft * (torch.log(soft + 1e-12) - logp)).sum(dim=-1)
    return ce + similarity_weight * _masked_mean(kl, sample_mask)


def svm_ranking_loss(
    logits: torch.Tensor,  # [B, 2] (female, male) scores
    targets: torch.Tensor,  # [B] 1 = male, 0 = female
    margin: float = 1.0,
    sample_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Hinge on the (male - female) score order: mean(max(margin - t (male -
    female), 0)) with t = 2y - 1 (the gender SVM trainer's ``SVMRankingLoss``)."""
    t = 2.0 * targets.float() - 1.0
    diff = torch.clamp(margin - t * (logits[:, 1].float() - logits[:, 0].float()), min=0.0)
    return _masked_mean(diff, sample_mask)


def cka_loss(
    feat_a: torch.Tensor,  # [B, D]
    feat_b: torch.Tensor,  # [B, D']
    sample_mask: Optional[torch.Tensor] = None,  # [B]
) -> torch.Tensor:
    """1 - linear CKA of two feature batches. With a mask the features are
    centred on the valid rows' mean and the padded rows zeroed, which gives
    the CKA of the valid rows alone. A batch whose centred features vanish
    (one live row, or one row drawn every time) gives 1 with a zero
    gradient; the JAX package's square root gives it a NaN gradient there,
    which a training step spreads to every parameter (ROADMAP.md §C)."""
    a, b = feat_a.float(), feat_b.float()
    if sample_mask is None:
        ac = a - a.mean(dim=0)
        bc = b - b.mean(dim=0)
    else:
        w = sample_mask.float()[:, None]
        n = w.sum().clamp_min(1.0)
        ac = (a - (a * w).sum(dim=0) / n) * w
        bc = (b - (b * w).sum(dim=0) / n) * w
    kc, lc = ac @ ac.T, bc @ bc.T
    hsic_kl = torch.trace(kc @ lc)
    hsic_kk = torch.trace(kc @ kc)
    hsic_ll = torch.trace(lc @ lc)
    prod = hsic_kk * hsic_ll
    root = torch.where(prod > 0, torch.sqrt(prod.clamp_min(torch.finfo(prod.dtype).tiny)), torch.zeros_like(prod))
    return 1.0 - hsic_kl / (root + 1e-8)


def diff_f1_loss(logits: torch.Tensor, one_hot_targets: torch.Tensor, epsilon: float = 1e-7) -> torch.Tensor:
    """1 - differentiable macro-F1 over sigmoid scores (every row counts)."""
    p = torch.sigmoid(logits.float())
    t = one_hot_targets.float()
    tp = (p * t).sum(dim=0)
    fp = (p * (1.0 - t)).sum(dim=0)
    fn = ((1.0 - p) * t).sum(dim=0)
    precision = tp / (tp + fp + epsilon)
    recall = tp / (tp + fn + epsilon)
    f1 = 2 * precision * recall / (precision + recall + epsilon)
    return 1.0 - f1.mean()


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


def mse_emotion(
    pred: torch.Tensor,  # [B, A]
    lab: torch.Tensor,  # [B, A]
    sample_mask: Optional[torch.Tensor] = None,  # [B]
) -> torch.Tensor:
    """Sum over attributes of each attribute's MSE over the valid rows."""
    se = (pred.float() - lab.float()) ** 2
    if sample_mask is None:
        return se.mean(dim=0).sum()
    w = sample_mask.float()[:, None]
    return ((se * w).sum(dim=0) / w.sum().clamp_min(1e-12)).sum()


# -- speaker-embedding losses (the proto-angular trainers) -------------------------------------------------------


def _cosine_sim(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    a_n = a / a.norm(dim=-1, keepdim=True).clamp_min(eps)
    b_n = b / b.norm(dim=-1, keepdim=True).clamp_min(eps)
    return (a_n * b_n).sum(dim=-1)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-8)


def angle_proto_loss(embeddings: torch.Tensor, w=10.0, b=-5.0) -> torch.Tensor:
    """Angular prototypical loss over [n_spk, n_utt, D] embeddings: each
    group's last utterance is its anchor, the mean of the rest its centroid;
    CE of ``cos(anchor, centroid) * max(w, 1e-6) + b`` against the group's own
    centroid. ``w`` and ``b`` may be tensors that train."""
    e = embeddings.float()
    cos = _unit(e[:, -1, :]) @ _unit(e[:, :-1, :].mean(dim=1)).t()  # [S, S]
    w = torch.as_tensor(w, dtype=torch.float32, device=e.device).clamp_min(1e-6)
    scores = cos * w + b
    return weighted_cross_entropy(scores, torch.arange(scores.shape[0], device=e.device))


def ge2e_loss(embeddings: torch.Tensor, w=10.0, b=-5.0, method: str = "softmax") -> torch.Tensor:
    """GE2E loss over [n_spk, n_utt, D] embeddings: each utterance scored
    against every group's centroid of the normalised embeddings, its own
    group's centroid leaving it out; ``softmax``: CE over the groups,
    ``contrast``: 1 - sigmoid(own score) + the largest sigmoid of another's."""
    e = embeddings.float()
    S, U, _ = e.shape
    e_n = _unit(e)
    loo = (e_n.sum(dim=1, keepdim=True) - e_n) / (U - 1)  # [S, U, D]
    cos_all = torch.einsum("sud,kd->suk", e_n, _unit(e_n.mean(dim=1)))  # [S, U, S]
    cos_own = (e_n * _unit(loo)).sum(dim=-1)  # [S, U]
    own_mask = torch.eye(S, device=e.device)[:, None, :]  # [S, 1, S]
    cos = cos_all * (1 - own_mask) + cos_own[:, :, None] * own_mask
    w = torch.as_tensor(w, dtype=torch.float32, device=e.device).clamp_min(1e-6)
    scores = cos * w + b
    own_idx = torch.arange(S, device=e.device)[:, None, None].expand(S, U, 1)
    if method == "softmax":
        return -torch.log_softmax(scores, dim=-1).gather(-1, own_idx).mean()
    sig = torch.sigmoid(scores)
    own = sig.gather(-1, own_idx)[..., 0]
    others_max = sig.masked_fill(own_mask.bool().expand_as(sig), float("-inf")).amax(dim=-1)
    return (1.0 - own + others_max).mean()
