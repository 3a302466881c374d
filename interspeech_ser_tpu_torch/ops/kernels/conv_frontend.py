"""K2: conv0 + bias + LayerNorm(channels) + GELU, fused from the waveform.

Port of ``interspeech_ser_tpu/ops/pallas/conv_frontend.py::
fused_conv_frontend`` at depth 1 (the inference default for layer-norm
models). The CUDA kernel is ``csrc/conv_frontend.cu``;
``conv_frontend_plain`` is the plain PyTorch version (conv0 as an
unfold/patch matmul, LayerNorm with the fast variance, GELU).
``conv_frontend`` launches the kernel for a CUDA tensor and runs the plain
version for a CPU tensor.

Semantics (as the TPU kernel): the waveform and the conv weight are rounded
to the compute dtype and multiplied with f32 accumulation; the bias is added
in f32; LayerNorm in f32 with ``var = E[y²] - E[y]²``; the normalised value is
cast to the compute dtype, then GELU (exact erf, or the tanh form when
``approx_gelu``). Deeper fused prefixes (depth 2-7) are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def conv_frontend_plain(
    wav: torch.Tensor,  # [B, L] f32
    weight: torch.Tensor,  # [C, 1, k] (Conv1d layout)
    bias: Optional[torch.Tensor],  # [C]
    ln_weight: torch.Tensor,  # [C]
    ln_bias: torch.Tensor,  # [C]
    stride: int,
    dtype: torch.dtype,
    approx_gelu: bool,
    eps: float = 1e-5,
) -> torch.Tensor:  # [B, T0, C] in dtype
    C, _, k = weight.shape
    patches = wav.float().unfold(1, k, stride)  # [B, T0, k]
    y = patches.to(dtype).float() @ weight.reshape(C, k).to(dtype).float().t()
    if bias is not None:
        y = y + bias.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = (y * y).mean(dim=-1, keepdim=True) - mean * mean
    y = (y - mean) * torch.rsqrt(var.clamp_min(0.0) + eps)
    y = y * ln_weight.float() + ln_bias.float()
    return F.gelu(y.to(dtype), approximate="tanh" if approx_gelu else "none")


def conv_frontend(
    wav: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    stride: int,
    dtype: torch.dtype,
    approx_gelu: bool,
    eps: float = 1e-5,
) -> torch.Tensor:
    """K2 on a CUDA tensor, the plain version on a CPU tensor."""
    if not wav.is_cuda:
        return conv_frontend_plain(
            wav, weight, bias, ln_weight, ln_bias, stride, dtype, approx_gelu, eps
        )
    global LAUNCHES
    if wav.dim() != 2 or wav.dtype != torch.float32 or not wav.is_contiguous():
        raise ValueError("conv_frontend kernel takes a contiguous float32 [B, L] waveform")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv_frontend kernel computes in float32 or bfloat16, got {dtype}")
    C, c_in, k = weight.shape
    if c_in != 1 or C != 512 or k > 16:
        raise NotImplementedError(
            f"conv_frontend kernel takes C_in=1, C=512, k<=16; got {tuple(weight.shape)}"
        )
    B, L = wav.shape
    T0 = (L - k) // stride + 1
    if T0 < 1:
        raise ValueError(f"waveform of {L} samples is shorter than the {k}-tap conv")

    def prep(t):  # small [C]-sized parameters, f32 on the waveform's device
        return None if t is None else t.detach().to(device=wav.device, dtype=torch.float32).contiguous()

    w, b, lw, lb = prep(weight.reshape(C, k)), prep(bias), prep(ln_weight), prep(ln_bias)
    out = torch.empty(B, T0, C, device=wav.device, dtype=dtype)
    lib = _build.library()
    fn = lib.ser_conv_frontend_bf16 if dtype == torch.bfloat16 else lib.ser_conv_frontend_f32
    err = fn(
        wav.data_ptr(), w.data_ptr(), _build.ptr(b), lw.data_ptr(), lb.data_ptr(),
        out.data_ptr(), B, L, T0, C, k, stride, float(eps), int(bool(approx_gelu)),
        _build.stream_ptr(wav),
    )
    _build.check(err, "conv_frontend")
    LAUNCHES += 1
    return out
