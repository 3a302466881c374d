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

Data parallelism (``sync``): the JAX package's data-parallel step takes a
BatchNorm's batch moments over the global batch. A BatchNorm given a mesh
with a data axis above one all-reduces, in one call, the per-channel sum and
sum of squares of its rank's rows and their count, with the gradient (the
backward all-reduces too: each rank's downstream gradient covers its own
rows); it normalises with the global moments and moves its running
statistics by them, the same on every rank.
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
        self.mesh = None  # set by ``sync``: global moments over its data axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, EPS)
        if self.mesh is not None and self.mesh.data > 1:
            return self._forward_global(x)
        with torch.no_grad():
            dims = [d for d in range(x.ndim) if d != 1]
            var, mean = torch.var_mean(x.detach().float(), dim=dims, correction=0)
            self.running_mean.mul_(MOMENTUM).add_(mean, alpha=1.0 - MOMENTUM)
            self.running_var.mul_(MOMENTUM).add_(var, alpha=1.0 - MOMENTUM)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, EPS)

    def _forward_global(self, x: torch.Tensor) -> torch.Tensor:
        from ..parallel.mesh import all_reduce_sum

        dims = [d for d in range(x.ndim) if d != 1]
        C = x.shape[1]
        xf = x.float()
        count = torch.full((1,), float(x.numel() // C), device=x.device)
        stats = all_reduce_sum(self.mesh, torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims), count]))
        n = stats[-1]
        mean = stats[:C] / n
        var = (stats[C: 2 * C] / n - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(MOMENTUM).add_(mean.detach(), alpha=1.0 - MOMENTUM)
            self.running_var.mul_(MOMENTUM).add_(var.detach(), alpha=1.0 - MOMENTUM)
        shape = [1, C] + [1] * (x.ndim - 2)
        scale = self.weight.float() * torch.rsqrt(var + EPS)
        y = (xf - mean.reshape(shape)) * scale.reshape(shape) + self.bias.float().reshape(shape)
        return y.to(x.dtype)


def sync(module: nn.Module, mesh) -> nn.Module:
    """Give every ``RunningBatchNorm`` in ``module`` the mesh whose data axis
    its training moments span -> ``module``."""
    for m in module.modules():
        if isinstance(m, RunningBatchNorm):
            m.mesh = mesh
    return module
