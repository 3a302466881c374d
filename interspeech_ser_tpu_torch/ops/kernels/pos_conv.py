"""K8: the grouped positional convolution of the speech encoders.

Port of ``interspeech_ser_tpu/ops/pallas/pos_conv.py::pos_conv_grouped``.
The CUDA kernel is ``csrc/pos_conv.cu``; ``pos_conv_plain`` is the plain
PyTorch version (``F.conv1d`` with ``groups``). ``pos_conv`` launches the
kernel for a CUDA tensor and runs the plain version for a CPU tensor.
Inference only: the kernel has no backward, so the wrapper raises for
inputs that require grad.

Semantics (as the TPU kernel): a grouped Conv1d with SAME padding K // 2 on
both sides (so T + 1 output frames for an even K; the caller drops the last
one), x and the weight in the compute dtype (the dtype of ``x``), f32
accumulation, the sum rounded to the compute dtype once. Bias and GELU stay
outside. The TPU kernel took 64 channels per group only, a tiling limit of
that chip; the CUDA kernels take 48, 64, 80 and 120 (the base, large, XL
and XLS-R-2B encoders at 16 groups): bf16 on the tensor cores, f32 on the
FP32 pipes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)
GROUP_WIDTHS = (48, 64, 80, 120)  # channels per group the kernel takes


def pos_conv_plain(
    x: torch.Tensor,  # [B, T, D] in the compute dtype
    weight: torch.Tensor,  # [D, D / groups, K] (Conv1d layout)
    groups: int,
) -> torch.Tensor:  # [B, T + 2 * (K // 2) - K + 1, D] in x.dtype
    dt = x.dtype
    K = weight.shape[-1]
    y = F.conv1d(x.float().transpose(1, 2), weight.to(dt).float(), padding=K // 2, groups=groups)
    return y.transpose(1, 2).to(dt)


def pos_conv(x: torch.Tensor, weight: torch.Tensor, groups: int) -> torch.Tensor:
    """K8 on a CUDA tensor, the plain version on a CPU tensor."""
    if not x.is_cuda:
        return pos_conv_plain(x, weight, groups)
    global LAUNCHES
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise RuntimeError("pos_conv: the K8 kernel has no backward (inference only)")
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pos_conv kernel takes float32 or bfloat16, got {dt}")
    B, T, D = x.shape
    K = weight.shape[-1]
    C = D // groups
    if weight.shape != (D, C, K) or C * groups != D:
        raise ValueError(f"pos_conv: weight {tuple(weight.shape)} is not [D, D / {groups}, K] for D={D}")
    if C not in GROUP_WIDTHS or K > 256:
        raise NotImplementedError(f"pos_conv kernel takes {GROUP_WIDTHS} channels per group and K <= 256; "
                                  f"got C={C}, K={K}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernels read rows as 16-byte vectors
        x = x.clone()
    # every tap matrix one contiguous read: [G, K, C_out, C_in] for the
    # tensor-core kernel (bf16), [G, K, C_in, C_out] for the FP32 one
    w = weight.detach().to(dt).view(groups, C, C, K)
    w = (w.permute(0, 3, 1, 2) if dt == torch.bfloat16 else w.permute(0, 3, 2, 1)).contiguous()
    T_out = T + 2 * (K // 2) - K + 1
    y = torch.empty(B, T_out, D, device=x.device, dtype=dt)
    lib = _build.library()
    fn = lib.ser_pos_conv_bf16 if dt == torch.bfloat16 else lib.ser_pos_conv_f32
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), B, T, groups, C, K, _build.stream_ptr(x))
    _build.check(err, "pos_conv")
    LAUNCHES += 1
    return y
