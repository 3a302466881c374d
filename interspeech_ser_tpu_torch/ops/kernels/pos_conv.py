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
and XLS-R-2B encoders at 16 groups): bf16 as Hopper warpgroup products
(wgmma), f32 on the FP32 pipes. ``pos_conv_plan`` is the launch plan both
use (the launcher checks it); ``pos_conv_occupancy`` what the built kernel
makes of it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)
GROUP_WIDTHS = (48, 64, 80, 120)  # channels per group the kernel takes
MAX_TAPS = 256
SMEM_LIMIT = 232448  # the most shared memory a block may opt into on an H100 (227 KB)
F32_TAPS = 64  # taps a stage of the f32 kernel (one input channel's weights and input column)


@dataclass(frozen=True)
class PosConvPlan:
    dtype: torch.dtype
    C: int  # channels a group
    K: int  # taps
    frames: int  # output frames a block
    stages: int  # pipeline stages: bf16 tap matrices in the ring, f32 double-buffered channel stages
    threads: int
    smem_bytes: int  # dynamic shared memory a block
    blocks_per_sm: int  # resident blocks an SM the kernel is built for (its launch bounds)

    def grid(self, B: int, T: int, groups: int) -> Tuple[int, int, int]:
        """(frame tiles, groups, batch rows): every one of the T + 2 * (K // 2) - K + 1 output frames."""
        t_out = T + 2 * (self.K // 2) - self.K + 1
        return (-(-t_out // self.frames), groups, B)


def bf16_taps_per_step(C: int) -> int:
    """Taps the bf16 kernel multiplies between two barriers, since a tap's
    products are short: 4 at C = 48 and 2 at C = 64 (two blocks still fit an
    SM at K = 128), 2 at C = 80 and 1 at C = 120 (a ring of 4 steps fills
    the rest of shared memory)."""
    return 4 if C <= 48 else (2 if C <= 80 else 1)


def _bf16_smem(C: int, K: int, frames: int, stages: int) -> int:
    """The input slab [frames + K - 1, C] and the tap ring [stages x taps a
    step][C_out, C_in], C_in padded to 16 (16-byte chunks of 8 values)."""
    chunks = (C + 15) // 16 * 2
    return 16 * chunks * (frames + K - 1 + stages * bf16_taps_per_step(C) * C)


@functools.lru_cache(maxsize=64)
def pos_conv_plan(C: int, K: int, dtype: torch.dtype) -> PosConvPlan:
    """bf16: warpgroups of 64 frames, four (256 frames, 512 threads) when the
    input slab and a ring of 4 steps of tap matrices (``bf16_taps_per_step``
    each) fit ``SMEM_LIMIT`` (every C at K = 128), else 3 steps, then fewer
    frames; one block an SM. f32: 8 x 8 micro-tiles, 256
    frames a block at C <= 64, 128 above ((frames / 8) x (C / 8) <= 256
    threads), two stages of 64 taps of one input channel; two blocks an SM."""
    if C not in GROUP_WIDTHS or not 1 <= K <= MAX_TAPS or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"pos_conv_plan takes C in {GROUP_WIDTHS}, 1 <= K <= {MAX_TAPS}, f32 or bf16; "
                         f"got {C}, {K}, {dtype}")
    if dtype == torch.bfloat16:
        frames, stages = next((f, s) for f in (256, 128, 64) for s in (4, 3) if _bf16_smem(C, K, f, s) <= SMEM_LIMIT)
        return PosConvPlan(dtype, C, K, frames, stages, 128 * (frames // 64), _bf16_smem(C, K, frames, stages), 1)
    frames = 256 if C <= 64 else 128
    smem = 2 * 4 * (F32_TAPS * C + frames + F32_TAPS)
    return PosConvPlan(dtype, C, K, frames, 2, (frames // 8) * (C // 8), smem, 2)


def pos_conv_occupancy(plan: PosConvPlan) -> Tuple[int, int, int]:
    """(threads, shared bytes, resident blocks an SM) of the built kernel at
    ``plan``, the blocks from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    (registers included). Needs the card."""
    out = (ctypes.c_int * 3)()
    err = _build.library().ser_pos_conv_plan(int(plan.dtype == torch.bfloat16), plan.C, plan.K, plan.frames,
                                             plan.stages, out)
    _build.check(err, f"pos_conv_occupancy({plan})")
    return tuple(out)


def pos_conv_plain(
    x: torch.Tensor,  # [B, T, D] in the compute dtype
    weight: torch.Tensor,  # [D, D / groups, K] (Conv1d layout)
    groups: int,
) -> torch.Tensor:  # [B, T + 2 * (K // 2) - K + 1, D] in x.dtype
    dt = x.dtype
    K = weight.shape[-1]
    y = F.conv1d(x.float().transpose(1, 2), weight.to(dt).float(), padding=K // 2, groups=groups)
    return y.transpose(1, 2).to(dt)


def weight_layout(weight: torch.Tensor, groups: int, dtype: torch.dtype) -> torch.Tensor:
    """The weight (CUDA) rounded to the compute dtype and laid out so that a
    stage is one contiguous read: [G, K, C_out, C_in] for the bf16 kernel (a
    tap matrix), [G, C_in, K, C_out] for the f32 one (one input channel's
    taps). A transpose of the whole weight on every call, by the tiled
    ``pos_conv_layout_kernel`` (``chip_smoke.py`` times it apart)."""
    D, C, K = weight.shape
    w = weight.detach()
    if w.dtype not in (torch.float32, torch.bfloat16):
        w = w.float()
    w = w.contiguous()  # [G, C_out, C_in, K]
    bf16 = dtype == torch.bfloat16
    R, S = (C * C, K) if bf16 else (C, C * K)  # a group's [R, S] -> [S, R]
    out = torch.empty((groups, K, C, C) if bf16 else (groups, C, K, C), dtype=dtype, device=w.device)
    err = _build.library().ser_pos_conv_layout(w.data_ptr(), int(w.dtype == torch.bfloat16), out.data_ptr(), int(bf16),
                                               groups, R, S, _build.stream_ptr(w))
    _build.check(err, "pos_conv weight layout")
    return out


def launch(x: torch.Tensor, w: torch.Tensor, groups: int, K: int) -> torch.Tensor:
    """K8 on ``x`` [B, T, D] (CUDA, contiguous, 16-byte aligned) with the weight
    already in ``weight_layout``; counts the launch."""
    global LAUNCHES
    B, T, D = x.shape
    plan = pos_conv_plan(D // groups, K, x.dtype)
    y = torch.empty(B, T + 2 * (K // 2) - K + 1, D, device=x.device, dtype=x.dtype)
    lib = _build.library()
    fn = lib.ser_pos_conv_bf16 if x.dtype == torch.bfloat16 else lib.ser_pos_conv_f32
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), B, T, groups, plan.C, K, plan.frames, plan.stages,
             _build.stream_ptr(x))
    _build.check(err, "pos_conv")
    LAUNCHES += 1
    return y


def pos_conv(x: torch.Tensor, weight: torch.Tensor, groups: int) -> torch.Tensor:
    """K8 on a CUDA tensor, the plain version on a CPU tensor."""
    if not x.is_cuda:
        return pos_conv_plain(x, weight, groups)
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
    if weight.device != x.device:
        raise ValueError(f"pos_conv: weight on {weight.device}, x on {x.device}")
    if C not in GROUP_WIDTHS or K > MAX_TAPS:
        raise NotImplementedError(f"pos_conv kernel takes {GROUP_WIDTHS} channels per group and K <= {MAX_TAPS}; "
                                  f"got C={C}, K={K}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernels read rows as 16-byte vectors
        x = x.clone()
    return launch(x, weight_layout(weight, groups, dt), groups, K)
