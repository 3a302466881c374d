"""The lazy-fusion classifier's training steps in plain float32 PyTorch.

A frozen copy of the plain paths of the port's ``models/fusion.py``,
``ops/gru.py`` (``gru_scan``), ``ops/attention.py``, ``train/losses.py``
(weighted CE), ``train/data.py`` (the epoch's batch order and the padding)
and of torch's AdamW, over a dict of the classifier's torch-named tensors:

per modality  Linear(D_m -> H) -> LayerNorm -> BiGRU (masked: the carry
freezes on padded steps, the output is zero there) -> one-head cross
attention on the other modality (dropout on its weights), added to the GRU
output -> softmax pooling over the frames -> concat -> LayerNorm ->
Linear -> ReLU -> dropout -> Linear -> logits; the CE weighted by the
training set's inverse class frequencies; AdamW(betas 0.9 / 0.999, eps
1e-8, decay 1e-6 on every parameter).

Dropout draws its masks from a ``torch.Generator`` seeded as the engine
seeds its own, in the order the model draws them: the first modality's
attention weights, the second's, the classifier's hidden layer.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .common import Ops, layer_norm

NEG_INF = -1e30
MODALITIES = ("speech", "text")


def param_shapes(feat_dims: Sequence[int], hidden: int, num_emotions: int) -> Dict[str, tuple]:
    H = hidden
    shapes = {}
    for name, d in zip(MODALITIES, feat_dims):
        shapes[f"{name}_projection.weight"] = (H, d)
        shapes[f"{name}_projection.bias"] = (H,)
        shapes[f"{name}_norm.weight"] = (H,)
        shapes[f"{name}_norm.bias"] = (H,)
        for sfx in ("", "_reverse"):
            shapes[f"{name}_gru.weight_ih_l0{sfx}"] = (3 * H, H)
            shapes[f"{name}_gru.weight_hh_l0{sfx}"] = (3 * H, H)
            shapes[f"{name}_gru.bias_ih_l0{sfx}"] = (3 * H,)
            shapes[f"{name}_gru.bias_hh_l0{sfx}"] = (3 * H,)
        shapes[f"{name}_attention.in_proj_weight"] = (6 * H, 2 * H)
        shapes[f"{name}_attention.in_proj_bias"] = (6 * H,)
        shapes[f"{name}_attention.out_proj.weight"] = (2 * H, 2 * H)
        shapes[f"{name}_attention.out_proj.bias"] = (2 * H,)
        shapes[f"{name}_attn.weight"] = (1, 2 * H)
        shapes[f"{name}_attn.bias"] = (1,)
    n = 2 * H * len(feat_dims)
    shapes["layer_norm.weight"] = (n,)
    shapes["layer_norm.bias"] = (n,)
    shapes["classifier.0.weight"] = (H, n)
    shapes["classifier.0.bias"] = (H,)
    shapes["classifier.3.weight"] = (num_emotions, H)
    shapes["classifier.3.bias"] = (num_emotions,)
    return shapes


# -- the batches -------------------------------------------------------------


def class_weights(labels: np.ndarray) -> np.ndarray:
    """Inverse-frequency CE weights N / (C * n_c), 0 for an absent class."""
    counts = labels.sum(axis=0)
    C = labels.shape[1]
    return np.asarray([len(labels) / (C * c) if c else 0.0 for c in counts], np.float32)


def epoch_order(seed: int, sizes: np.ndarray, batch_size: int, bucket_window: int) -> List[List[int]]:
    """The first epoch's batches of an engine seeded with ``seed``: a
    permutation from numpy's PCG64, then each window of ``bucket_window``
    batches sorted (stably) by the size of the first modality's file."""
    order = np.random.Generator(np.random.PCG64(seed)).permutation(len(sizes))
    window = batch_size * bucket_window
    order = np.concatenate([c[np.argsort(sizes[c], kind="stable")]
                            for c in (order[s: s + window] for s in range(0, len(order), window))])
    return [list(order[i: i + batch_size]) for i in range(0, len(order), batch_size)]


def bucket(t: int, quantum: int, minimum: int = 64) -> int:
    """A batch's padded length: ``t`` rounded up to the quantum, at least 64 frames."""
    return max(minimum, -(-t // quantum) * quantum)


def collate(feats: Sequence[Sequence[torch.Tensor]], quantum: int, device):
    """Rows of per-modality [T, D] tensors -> per modality the zero-padded
    [B, T_bucket, D] batch and its [B, T_bucket] frame mask."""
    out, masks = [], []
    for m in range(len(feats[0])):
        rows = [f[m] for f in feats]
        T = bucket(max(r.shape[0] for r in rows), quantum)
        x = torch.zeros(len(rows), T, rows[0].shape[1], device=device)
        mask = torch.zeros(len(rows), T, device=device)
        for i, r in enumerate(rows):
            x[i, : r.shape[0]] = r
            mask[i, : r.shape[0]] = 1.0
        out.append(x)
        masks.append(mask)
    return out, masks


# -- the model -----------------------------------------------------------------


def gru_scan(x, w_ih, w_hh, b_ih, b_hh, mask, reverse: bool, ops: Ops):
    B, T, _ = x.shape
    H = w_hh.shape[1]
    xp = ops.linear(x, w_ih, b_ih)
    m = mask[:, :, None]
    h = x.new_zeros(B, H)
    out = [None] * T
    for t in (reversed(range(T)) if reverse else range(T)):
        hp = ops.linear(h, w_hh, b_hh)
        r = torch.sigmoid(xp[:, t, :H] + hp[:, :H])
        z = torch.sigmoid(xp[:, t, H: 2 * H] + hp[:, H: 2 * H])
        n = torch.tanh(xp[:, t, 2 * H:] + r * hp[:, 2 * H:])
        h = m[:, t] * ((1.0 - z) * n + z * h) + (1.0 - m[:, t]) * h
        out[t] = h * m[:, t]
    return torch.stack(out, dim=1)


def dropout(x, p: float, generator: torch.Generator):
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def cross_attention(p, name, query, kv, key_mask, p_drop, generator, ops: Ops):
    E = query.shape[-1]
    wq, wk, wv = p[f"{name}_attention.in_proj_weight"].chunk(3, dim=0)
    bq, bk, bv = p[f"{name}_attention.in_proj_bias"].chunk(3)
    q, k, v = ops.linear(query, wq, bq), ops.linear(kv, wk, bk), ops.linear(kv, wv, bv)
    scores = ops.matmul(q * E ** -0.5, k.transpose(1, 2)).masked_fill(~(key_mask > 0)[:, None, :], NEG_INF)
    w = dropout(torch.softmax(scores[:, None], dim=-1), p_drop, generator)[:, 0]  # the engine's [B, 1, Tq, Tk]
    return ops.linear(ops.matmul(w, v), p[f"{name}_attention.out_proj.weight"], p[f"{name}_attention.out_proj.bias"])


def logits(p, feats, masks, p_drop: float, generator: torch.Generator, ops: Ops):
    hidden = []
    for name, x, m in zip(MODALITIES, feats, masks):
        h = ops.linear(x, p[f"{name}_projection.weight"], p[f"{name}_projection.bias"])
        h = layer_norm(h, p[f"{name}_norm.weight"], p[f"{name}_norm.bias"])
        g = f"{name}_gru."
        fwd = gru_scan(h, p[g + "weight_ih_l0"], p[g + "weight_hh_l0"], p[g + "bias_ih_l0"], p[g + "bias_hh_l0"], m,
                       False, ops)
        bwd = gru_scan(h, p[g + "weight_ih_l0_reverse"], p[g + "weight_hh_l0_reverse"], p[g + "bias_ih_l0_reverse"],
                       p[g + "bias_hh_l0_reverse"], m, True, ops)
        hidden.append(torch.cat([fwd, bwd], dim=-1))
    pooled = []
    for i, name in enumerate(MODALITIES[: len(feats)]):
        total = hidden[i]
        for j in range(len(feats)):
            if j != i:
                total = total + cross_attention(p, name, hidden[i], hidden[j], masks[j], p_drop, generator, ops)
        s = ops.linear(total, p[f"{name}_attn.weight"], p[f"{name}_attn.bias"])
        s = s.masked_fill(~(masks[i] > 0)[:, :, None], NEG_INF)
        pooled.append((total * torch.softmax(s, dim=1)).sum(dim=1))
    fused = layer_norm(torch.cat(pooled, dim=-1), p["layer_norm.weight"], p["layer_norm.bias"])
    h = torch.relu(ops.linear(fused, p["classifier.0.weight"], p["classifier.0.bias"]))
    return ops.linear(dropout(h, p_drop, generator), p["classifier.3.weight"], p["classifier.3.bias"])


def weighted_ce(z, y, class_w):
    nll = -F.log_softmax(z, dim=-1).gather(1, y[:, None])[:, 0]
    w = class_w[y]
    return (nll * w).sum() / w.sum()


def cosine_lr(lr0: float, epoch: int, epochs: int, eta_min: float = 1e-6) -> float:
    return eta_min + (lr0 - eta_min) * (1 + math.cos(math.pi * epoch / epochs)) / 2


def train(p0: Dict[str, torch.Tensor], batches, class_w: torch.Tensor, lr: float, p_drop: float,
          generator: torch.Generator, ops: Ops, weight_decay: float = 1e-6):
    """AdamW steps from ``p0`` over ``batches`` of (feats, masks, labels
    [B, C]) -> (each step's loss, the first step's gradients, the
    parameters after the last step)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    b1, b2, eps = 0.9, 0.999, 1e-8
    for step, (feats, masks, labels) in enumerate(batches, start=1):
        loss = weighted_ce(logits(p, feats, masks, p_drop, generator, ops), labels.argmax(dim=1), class_w)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(p, grads)}
        with torch.no_grad():
            for (k, t), g in zip(p.items(), grads):
                t.mul_(1 - lr * weight_decay)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
                t.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** step))
    return losses, first, {k: t.detach() for k, t in p.items()}
