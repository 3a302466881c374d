"""K2: the first n layers of the waveform frontend, each conv + bias +
LayerNorm(channels) + GELU, fused from the waveform (n = 1..7).

Port of ``interspeech_ser_tpu/ops/pallas/conv_frontend.py::
fused_conv_frontend`` at every depth of the layer-norm frontends. The CUDA
kernels are ``csrc/conv_frontend.cu``: one for layer 0 straight from the
waveform, one for each later 512 -> 512 layer, chained through the compute
dtype. ``conv_frontend_plain`` is the plain PyTorch version (conv0 as an
unfold/patch matmul, the later layers as ``F.conv1d``, LayerNorm with the
fast variance, GELU). ``conv_frontend`` launches the kernels for a CUDA
tensor and runs the plain version for a CPU tensor. Each launch is
counted where it is made: the layer-0 kernel in ``LAUNCHES`` (one a call),
the later-layer kernel in ``LAYER_LAUNCHES`` (depth - 1 a call).

Semantics (as the TPU kernel): a layer's input and conv weight are rounded
to the compute dtype and multiplied with f32 accumulation (layer 0 reads
the f32 waveform); the bias is added in f32; LayerNorm in f32 with
``var = E[y²] - E[y]²``; the normalised value is cast to the compute dtype,
then GELU (exact erf, or the tanh form when ``approx_gelu``), and the
result, in the compute dtype, feeds the next layer. The depth is
``len(layers)``. ``conv_frontend_plan`` is the layer-0 kernel's launch plan
(the launcher checks it); ``conv_frontend_occupancy`` what the built kernel
makes of it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = 0  # layer-0 kernel launches since the last reset (chip_smoke.py reads it)
LAYER_LAUNCHES = 0  # later-layer kernel launches since the last reset
CHANNELS = 512  # every layer-norm frontend of the zoo
MAX_TAPS = 16  # layer 0's k
H100_SMS = 132
L0_THREADS = 64  # f32: two warps, a lane owning 8 contiguous channels of a frame
L0_CHUNK = 64  # f32: frames whose 16-tap patches a block stages at a time
L0_STEP = 4  # f32: frames a lane computes at a time
MMA_WARPS = 16  # bf16: 512 threads, one block an SM; each warp owns a run of 16-frame tiles, two at a time
MMA_TILE = 16
GELU_TABLE = 65536  # bf16: gelu of every bf16 z, looked up


@dataclass(frozen=True)
class FrontendPlan:
    dtype: torch.dtype
    ksize: int
    threads: int
    blocks: int  # the grid: every block resident at once
    frames: int  # output frames a block owns: a contiguous run of the B * T0
    smem_bytes: int  # shared memory a block (static + dynamic)
    blocks_per_sm: int  # resident blocks an SM the kernel is built for (its launch bounds)


@functools.lru_cache(maxsize=256)
def conv_frontend_plan(B: int, T0: int, dtype: torch.dtype, ksize: int = 10, sms: int = H100_SMS) -> FrontendPlan:
    """The layer-0 kernel's grid: the card's resident blocks, each owning an
    equal contiguous run of the B * T0 output frames, so that no block waits
    for a second wave. f32 (``conv_frontend_kernel``): 64-thread blocks, 6
    an SM at k <= 10 (80 weight registers a lane), 4 up to k = 16, runs in
    steps of 4 frames; shared memory: 64 frames' patches, bias / ln_w /
    ln_b, the LayerNorm's partial sums. bf16 (``conv_frontend_mma_kernel``):
    one 512-thread block an SM, each warp a run of an even number of
    16-frame tiles (two at a time); shared
    memory: the 128-KB GELU table, the weights as mma fragments, bias / ln_w
    / ln_b."""
    if dtype not in (torch.float32, torch.bfloat16) or not 1 <= ksize <= MAX_TAPS or B < 1 or T0 < 1:
        raise ValueError(f"conv_frontend_plan takes f32 or bf16, 1 <= k <= {MAX_TAPS}, B, T0 >= 1; "
                         f"got {dtype}, {ksize}, {B}, {T0}")
    total = B * T0
    if dtype == torch.bfloat16:
        tiles = -(-total // MMA_TILE)
        per_warp = -(-tiles // (2 * sms * MMA_WARPS)) * 2  # a warp computes two tiles at a time
        blocks = -(-tiles // (per_warp * MMA_WARPS))
        smem = 2 * GELU_TABLE + 8 * (CHANNELS // 8) * 32 + 4 * 3 * CHANNELS
        return FrontendPlan(dtype, ksize, 32 * MMA_WARPS, blocks, per_warp * MMA_WARPS * MMA_TILE, smem, 1)
    per_sm = 6 if ksize <= 10 else 4
    blocks = min(sms * per_sm, -(-total // L0_STEP))
    frames = -(-(-(-total // blocks)) // L0_STEP) * L0_STEP
    blocks = -(-total // frames)
    smem = 4 * (L0_CHUNK * 16 + 3 * CHANNELS + 2 * 2 * 2 * L0_STEP)
    return FrontendPlan(dtype, ksize, L0_THREADS, blocks, frames, smem, per_sm)


def conv_frontend_occupancy(dtype: torch.dtype, ksize: int = 10, approx_gelu: bool = False) -> Tuple[int, int, int]:
    """(threads, shared bytes, resident blocks an SM) of the built layer-0
    kernel, the blocks from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    (registers included). Needs the card."""
    out = (ctypes.c_int * 3)()
    err = _build.library().ser_conv_frontend_plan(int(dtype == torch.bfloat16), ksize, int(bool(approx_gelu)), out)
    _build.check(err, f"conv_frontend_occupancy({dtype}, {ksize})")
    return tuple(out)


def gelu_table(approx_gelu: bool, device="cuda") -> torch.Tensor:
    """The bf16 layer-0 kernel's GELU table, bf16 [65536]: entry h is the
    kernel's gelu(z) (the erf or tanh expression in f32, rounded to bf16)
    for the bf16 z of bits h. Needs the card."""
    out = torch.empty(GELU_TABLE, dtype=torch.bfloat16, device=device)
    err = _build.library().ser_gelu_bf16_table(int(bool(approx_gelu)), out.data_ptr(), _build.stream_ptr(out))
    _build.check(err, "gelu_table")
    return out


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class FrontendLayer(NamedTuple):
    weight: torch.Tensor  # [C, C_in, k] (Conv1d layout)
    bias: Optional[torch.Tensor]  # [C]
    ln_weight: torch.Tensor  # [C]
    ln_bias: torch.Tensor  # [C]
    stride: int


def _norm_gelu(y: torch.Tensor, layer: FrontendLayer, dtype, approx_gelu: bool, eps: float) -> torch.Tensor:
    """+ bias, LayerNorm (fast variance, f32), cast, GELU."""
    if layer.bias is not None:
        y = y + layer.bias.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = (y * y).mean(dim=-1, keepdim=True) - mean * mean
    y = (y - mean) * torch.rsqrt(var.clamp_min(0.0) + eps)
    y = y * layer.ln_weight.float() + layer.ln_bias.float()
    return F.gelu(y.to(dtype), approximate="tanh" if approx_gelu else "none")


def conv_frontend_plain(
    wav: torch.Tensor,  # [B, L] f32
    layers: Sequence[FrontendLayer],  # the first ``depth`` frontend layers
    dtype: torch.dtype,
    approx_gelu: bool,
    eps: float = 1e-5,
) -> torch.Tensor:  # [B, T_depth, C] in dtype
    l0 = layers[0]
    C, _, k = l0.weight.shape
    patches = wav.float().unfold(1, k, l0.stride)  # [B, T0, k]
    y = patches.to(dtype).float() @ l0.weight.reshape(C, k).to(dtype).float().t()
    x = _norm_gelu(y, l0, dtype, approx_gelu, eps)
    for layer in layers[1:]:
        y = F.conv1d(x.float().transpose(1, 2), layer.weight.to(dtype).float(), stride=layer.stride)
        x = _norm_gelu(y.transpose(1, 2), layer, dtype, approx_gelu, eps)
    return x


def _f32(t: Optional[torch.Tensor], index: int) -> Optional[torch.Tensor]:
    """A small parameter as a contiguous f32 tensor on card ``index`` (itself when it is one)."""
    if t is None or (t.dtype == torch.float32 and t.get_device() == index and t.is_contiguous()):
        return t
    return t.detach().to(device=f"cuda:{index}", dtype=torch.float32).contiguous()


def conv_frontend(
    wav: torch.Tensor,
    layers: Sequence[FrontendLayer],
    dtype: torch.dtype,
    approx_gelu: bool,
    eps: float = 1e-5,
) -> torch.Tensor:
    """K2 on a CUDA tensor, the plain version on a CPU tensor. The host
    work before the layer-0 launch is kept to checks, one allocation and
    the call itself: a single call's time includes it."""
    if not wav.is_cuda:
        return conv_frontend_plain(wav, layers, dtype, approx_gelu, eps)
    global LAUNCHES, LAYER_LAUNCHES
    if wav.dim() != 2 or wav.dtype != torch.float32 or not wav.is_contiguous():
        raise ValueError("conv_frontend kernel takes a contiguous float32 [B, L] waveform")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv_frontend kernel computes in float32 or bfloat16, got {dtype}")
    if not 1 <= len(layers) <= 7:
        raise ValueError(f"conv_frontend fuses 1 to 7 layers, got {len(layers)}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for layer in layers for t in layer[:4]):
        raise RuntimeError("conv_frontend: the K2 kernels have no backward; run the plain path for gradients")
    for i, layer in enumerate(layers):
        C, c_in, k = layer.weight.shape
        if C != CHANNELS or c_in != (1 if i == 0 else CHANNELS) or (i == 0 and k > 16):
            raise NotImplementedError(
                f"conv_frontend kernels take C_in=1, k<=16 on layer 0 and 512 -> 512 channels after it; "
                f"layer {i} has weight {tuple(layer.weight.shape)}"
            )
    B, L = wav.shape
    lib = _build.library()
    bf16 = dtype == torch.bfloat16
    index = wav.get_device()
    stream = torch.cuda.current_stream(index).cuda_stream  # by index: a third of the host time of by device

    l0 = layers[0]
    k, s = l0.weight.shape[2], l0.stride
    T = (L - k) // s + 1
    if T < 1:
        raise ValueError(f"waveform of {L} samples is shorter than the {k}-tap conv")
    # the kernel reads the contiguous [512, 1, k] weight as [512, k]
    w, b, lw, lb = [_f32(t, index) for t in l0[:4]]
    x = torch.empty(B, T, CHANNELS, device=wav.device, dtype=dtype)
    plan = conv_frontend_plan(B, T, dtype, k, _sm_count(index))
    err = (lib.ser_conv_frontend_bf16 if bf16 else lib.ser_conv_frontend_f32)(
        wav.data_ptr(), w.data_ptr(), _build.ptr(b), lw.data_ptr(), lb.data_ptr(), x.data_ptr(),
        B, L, T, CHANNELS, k, s, eps, int(approx_gelu), plan.blocks, plan.frames, stream,
    )
    _build.check(err, "conv_frontend")
    LAUNCHES += 1
    for layer in layers[1:]:
        k, s = layer.weight.shape[2], layer.stride
        T_out = (T - k) // s + 1
        if T_out < 1:
            raise ValueError(f"a {T}-frame input is shorter than the {k}-tap conv")
        # rows tap * 512 + i, column c: frame t's window is k * 512 contiguous values
        w = layer.weight.detach().to(device=wav.device, dtype=dtype).float().permute(2, 1, 0)
        w = w.reshape(k * CHANNELS, CHANNELS).contiguous()
        b, lw, lb = [_f32(t, index) for t in layer[1:4]]
        y = torch.empty(B, T_out, CHANNELS, device=wav.device, dtype=dtype)
        err = (lib.ser_conv_layer_bf16 if bf16 else lib.ser_conv_layer_f32)(
            x.data_ptr(), w.data_ptr(), _build.ptr(b), lw.data_ptr(), lb.data_ptr(), y.data_ptr(),
            B, T, T_out, CHANNELS, CHANNELS, k, s, eps, int(approx_gelu), stream,
        )
        _build.check(err, "conv_frontend layer")
        LAYER_LAUNCHES += 1
        x, T = y, T_out
    return x
