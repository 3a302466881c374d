"""Batch normalisation whose running statistics follow flax's update.

The JAX package's ``nn.BatchNorm(momentum=0.9)`` keeps
``running = 0.9 * running + 0.1 * batch`` with the **biased** batch
variance, where ``torch.nn.BatchNorm*`` folds in the unbiased one (n / (n-1)
times larger). The reference encoders of the proto-angular and x-vector
trainers save ``running_var`` and evaluate with it after training, so the
port keeps flax's update: ``RunningBatchNorm`` normalises a training batch
with its own (biased) moments through ``F.batch_norm`` and moves the
buffers by flax's rule; in eval mode it uses the buffers. State-dict keys
are torch's ``weight``, ``bias``, ``running_mean``, ``running_var`` (no
``num_batches_tracked``: the reference checkpoints the JAX package writes
have none).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


MOMENTUM = 0.9  # flax's: the share of the old running value kept each step
EPS = 1e-5


class RunningBatchNorm(nn.Module):
    """BatchNorm over dim 1 of [B, C, ...] (every other dim reduced)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, EPS)
        with torch.no_grad():
            dims = [d for d in range(x.ndim) if d != 1]
            var, mean = torch.var_mean(x.detach().float(), dim=dims, correction=0)
            self.running_mean.mul_(MOMENTUM).add_(mean, alpha=1.0 - MOMENTUM)
            self.running_var.mul_(MOMENTUM).add_(var, alpha=1.0 - MOMENTUM)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, EPS)
