"""The products of the references in float32, or in TF32 for the control.

``Ops(tf32=False)`` computes every matmul and convolution in IEEE float32;
``Ops(tf32=True)`` rounds each operand to TF32's 10-bit mantissa first (round
to nearest even) and accumulates in float32, as the tensor cores do when
TF32 is on; in a backward pass the incoming gradient is rounded too. That is
the control of the f32 cells: the precision a later change would be tempted
to switch on. The rounding is done here, so the control reads the same on
any device and needs no global flag.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties to even)."""
    i = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((i >> 13) & 1)
    return ((i + bias) & -8192).view(torch.float32)


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ar, br = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ar, br)
        ctx.shapes = (a.shape, b.shape)
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = round_tf32(g)
        ga = (gr @ br.transpose(-1, -2)).sum_to_size(ctx.shapes[0])
        gb = (ar.transpose(-1, -2) @ gr).sum_to_size(ctx.shapes[1])
        return ga, gb


class Ops:
    """Matmuls and convolutions in float32, or TF32 for the control."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _RoundedMatmul.apply(a, b) if self.tf32 else a @ b

    def linear(self, x, w, b=None):
        y = self.matmul(x, w.t())
        return y if b is None else y + b

    def conv1d(self, x, w, b=None, stride=1, padding=0, groups=1):
        if self.tf32:
            x, w = round_tf32(x), round_tf32(w)
        return F.conv1d(x, w, b, stride=stride, padding=padding, groups=groups)


def layer_norm(x, w, b, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuBLAS and cuDNN while the references run."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
