"""Gradient reversal (Ganin): the identity forward, the gradient times -lambda backward.

Port of ``interspeech_ser_tpu/ops/grl.py`` (a ``jax.custom_vjp`` there), for
the adversarial gender head of the legacy ``grlgender`` trainer.
"""

from __future__ import annotations

import torch


class GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, lambda_: float) -> torch.Tensor:
        ctx.lambda_ = lambda_
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return -ctx.lambda_ * g, None


def gradient_reversal(x: torch.Tensor, lambda_: float = 1.0) -> torch.Tensor:
    return GradientReversal.apply(x, lambda_)
