"""TDNN x-vector speaker embedder (speechbrain's ``spkrec-xvect-voxceleb``).

Port of ``interspeech_ser_tpu/models/xvector.py``: five dilated TDNN blocks
(Conv1d -> ReLU -> BatchNorm, the padded tail re-zeroed after each so that
the deeper dilated convs see a batch-1 run's zero boundary), masked mean ||
std statistics pooling, a Linear to the 512-d embedding. BatchNorm keeps
flax's running statistics (``ops/batch_norm.py``). Plain PyTorch: the JAX
package runs it on XLA convs, no kernel.

``xvector_from_speechbrain`` reads a speechbrain ``embedding_model.ckpt``
state dict (``blocks.{i}.conv.*``, ``blocks.{j}.norm.*``, the final
``w.weight`` / ``linear.weight``) into the port's names (``tdnn.{i}``,
``bn.{i}``, ``embedding``); ``xvector_to_speechbrain`` writes the names the
x-vector trainer saves as ``final_xvector.pt`` (Conv1d at ``blocks.{3i}``,
BatchNorm at ``blocks.{3i+2}``, the Linear at ``blocks.16.w``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batch_norm import RunningBatchNorm

# (out_channels, kernel, dilation) per TDNN block, as speechbrain's Xvector
TDNN_BLOCKS = ((512, 5, 1), (512, 3, 2), (512, 3, 3), (512, 1, 1), (1500, 1, 1))


class XVector(nn.Module):
    """fbank [B, T, in_feats] (+ live frames a row) -> embedding [B, lin_neurons]."""

    def __init__(self, in_feats: int = 24, lin_neurons: int = 512):
        super().__init__()
        chans = (in_feats,) + tuple(b[0] for b in TDNN_BLOCKS)
        self.tdnn = nn.ModuleList(nn.Conv1d(chans[i], ch, k, dilation=d, padding=(k - 1) * d // 2)
                                  for i, (ch, k, d) in enumerate(TDNN_BLOCKS))
        self.bn = nn.ModuleList(RunningBatchNorm(ch) for ch, _, _ in TDNN_BLOCKS)
        self.embedding = nn.Linear(2 * chans[-1], lin_neurons)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.float().transpose(1, 2)  # [B, F, T]
        m = None
        if lengths is not None:
            m = (torch.arange(x.shape[2], device=x.device)[None, :] < lengths[:, None]).float()[:, None, :]
        for conv, bn in zip(self.tdnn, self.bn):
            x = bn(F.relu(conv(x)))
            if m is not None:
                x = x * m
        if m is None:
            mean, var = x.mean(dim=2), x.var(dim=2, correction=0)
        else:
            denom = m.sum(dim=2).clamp_min(1.0)
            mean = (x * m).sum(dim=2) / denom
            var = ((x - mean[:, :, None]) ** 2 * m).sum(dim=2) / denom
        return self.embedding(torch.cat([mean, var.clamp_min(1e-10).sqrt()], dim=-1))


def _block_order(key: str) -> list:
    return [int(t) for t in key.split(".") if t.isdigit()]


def xvector_from_speechbrain(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A speechbrain x-vector state dict -> ``XVector``'s: the convs and norms
    in block order, the final linear (``w.weight`` or ``linear.weight``)."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    convs = sorted({k.rsplit(".conv.weight", 1)[0] for k in sd if k.endswith(".conv.weight")}, key=_block_order)
    norms = sorted({k.rsplit(".norm.weight", 1)[0] for k in sd if k.endswith(".norm.weight")}, key=_block_order)
    out: Dict[str, torch.Tensor] = {}
    for i, (ck, nk) in enumerate(zip(convs[: len(TDNN_BLOCKS)], norms)):
        w = sd[f"{ck}.conv.weight"]
        out[f"tdnn.{i}.weight"] = w
        out[f"tdnn.{i}.bias"] = sd.get(f"{ck}.conv.bias", torch.zeros(w.shape[0]))
        for name in ("weight", "bias", "running_mean", "running_var"):
            out[f"bn.{i}.{name}"] = sd[f"{nk}.norm.{name}"]
    lin = [k for k in sd if k.endswith("w.weight") or k.endswith("linear.weight")]
    if lin:
        out["embedding.weight"] = sd[lin[0]]
        out["embedding.bias"] = sd.get(lin[0].replace("weight", "bias"), torch.zeros(sd[lin[0]].shape[0]))
    return {k: v.float().clone() for k, v in out.items()}


def xvector_to_speechbrain(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``XVector``'s state dict -> speechbrain names (inverse of
    ``xvector_from_speechbrain``)."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(len(TDNN_BLOCKS)):
        conv, norm = 3 * i, 3 * i + 2  # Conv1d, ReLU (no parameters), BatchNorm1d
        out[f"blocks.{conv}.conv.weight"] = sd[f"tdnn.{i}.weight"]
        out[f"blocks.{conv}.conv.bias"] = sd[f"tdnn.{i}.bias"]
        for name in ("weight", "bias", "running_mean", "running_var"):
            out[f"blocks.{norm}.norm.{name}"] = sd[f"bn.{i}.{name}"]
    out["blocks.16.w.weight"] = sd["embedding.weight"]
    out["blocks.16.w.bias"] = sd["embedding.bias"]
    return out
