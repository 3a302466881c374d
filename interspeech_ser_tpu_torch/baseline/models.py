"""The challenge baseline's pooling and head.

Port of ``interspeech_ser_tpu/baseline/models.py``. Module and parameter
names are the reference's, so ``state_dict()`` is the contents of
``final_pool.pt`` (``sap_linear.*``, ``attention`` [D, 1]) and
``final_ser.pt`` (``fc.{i}.0.*`` the Linear, ``fc.{i}.1.*`` the LayerNorm,
``out.0.*``) with no converter.

``AttentiveStatisticsPooling`` is masked and batched: the frame count of a
row is ``floor((samples - 1) / 320) + 1`` clipped to T, frames past it get
a score of -1e30, and a row with no valid sample gets uniform weights. It
computes in f32 and returns the input's dtype; the head computes in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_core import dropout

NEG_INF = -1e30
HOP = 320  # samples a frame at 16 kHz (20 ms)


def frame_lengths_from_mask(mask: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Sample mask [B, L] -> frame counts [B] (int32), clipped to ``num_frames``."""
    feat_lens = torch.floor((mask.float().sum(dim=1) - 1) / HOP) + 1
    return feat_lens.to(torch.int32).clamp(0, num_frames)


class AttentiveStatisticsPooling(nn.Module):
    """[B, T, D] frames + sample mask [B, L] -> [B, 2D]: the attention-weighted
    mean and standard deviation (``sqrt(max(var, 1e-5))``) over valid frames."""

    def __init__(self, input_size: int):
        super().__init__()
        self.sap_linear = nn.Linear(input_size, input_size)
        self.attention = nn.Parameter(torch.randn(input_size, 1))

    def forward(self, xs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, T, _ = xs.shape
        frame_mask = torch.arange(T, device=xs.device)[None, :] < frame_lengths_from_mask(mask, T)[:, None]
        x32 = xs.float()
        h = torch.tanh(self.sap_linear(x32))
        w = (h @ self.attention.float())[..., 0].masked_fill(~frame_mask, NEG_INF)
        w = torch.softmax(w, dim=1)[:, :, None]
        mu = (x32 * w).sum(dim=1)
        var = (x32 ** 2 * w).sum(dim=1) - mu ** 2
        return torch.cat([mu, var.clamp_min(1e-5).sqrt()], dim=1).to(xs.dtype)


class EmotionRegression(nn.Module):
    """Dropout, then ``num_layers`` x [Linear -> LayerNorm(1e-5) -> ReLU ->
    Dropout], then Linear. Dropout runs only when the caller passes the
    ``torch.Generator`` that draws its masks (training)."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int, output_dim: int, dropout: float = 0.5):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * num_layers
        self.fc = nn.ModuleList(
            nn.Sequential(nn.Linear(dims[i], hidden_dim), nn.LayerNorm(hidden_dim, eps=1e-5))
            for i in range(num_layers)
        )
        self.out = nn.Sequential(nn.Linear(dims[-1], output_dim))
        self.dropout = dropout

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p = self.dropout if generator is not None else 0.0
        h = dropout(x, p, generator).float()
        for block in self.fc:
            h = dropout(F.relu(block(h)), p, generator)
        return self.out(h)
