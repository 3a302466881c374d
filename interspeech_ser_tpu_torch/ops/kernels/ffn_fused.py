"""K5: the speech encoders' feed-forward pair in one kernel,
``gelu(x · W_upᵀ + b_up) · W_downᵀ + b_down``, with the [M, F] intermediate
never written to device memory.

Port of ``interspeech_ser_tpu/ops/pallas/ffn_fused.py::ffn_fused``. The CUDA
kernel is ``csrc/ffn_fused.cu``; ``ffn_fused_plain`` is the plain PyTorch
version. ``ffn_fused`` launches the kernel for a CUDA tensor and runs the
plain version for a CPU tensor. Inference only, like the JAX package: the
kernel has no backward, so the wrapper raises for inputs that require grad.

Semantics (as the TPU kernel): x and both weights in the compute dtype (the
dtype of ``x``), products accumulated in f32; ``b_up`` added in f32, GELU
(exact erf, or the tanh form) in f32, rounded to the compute dtype before
the second product; ``b_down`` added in f32 and the sum rounded once. The
weights come in torch's Linear layout: ``w_up`` [F, K], ``w_down`` [N, F].

The kernel is one cluster launch (8 CTAs split N and share each chunk of the
intermediate through distributed shared memory; bf16 on the tensor cores,
f32 on the FP32 pipes); its rows are staged by 16-byte ``cp.async``, so it
takes K and F that are multiples of 8 and 16-byte aligned tensors, and the
wrapper raises otherwise (the JAX kernel takes any K and F; every encoder
width is a multiple of 8). Any M, and any such F, is masked in the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)
WIDTHS = (768, 1024, 1280, 1920)  # output widths N the kernel takes: base, large, XL, XLS-R-2B


def ffn_fused_plain(
    x: torch.Tensor,  # [M, K] in the compute dtype
    w_up: torch.Tensor,  # [F, K]
    b_up: torch.Tensor,  # [F]
    w_down: torch.Tensor,  # [N, F]
    b_down: torch.Tensor,  # [N]
    approx_gelu: bool,
) -> torch.Tensor:  # [M, N] in x.dtype
    dt = x.dtype
    h = F.linear(x.float(), w_up.to(dt).float(), b_up.float())
    h = F.gelu(h, approximate="tanh" if approx_gelu else "none").to(dt)
    return F.linear(h.float(), w_down.to(dt).float(), b_down.float()).to(dt)


def ffn_fused(
    x: torch.Tensor,
    w_up: torch.Tensor,
    b_up: torch.Tensor,
    w_down: torch.Tensor,
    b_down: torch.Tensor,
    approx_gelu: bool,
) -> torch.Tensor:
    """K5 on a CUDA tensor, the plain version on a CPU tensor."""
    if not x.is_cuda:
        return ffn_fused_plain(x, w_up, b_up, w_down, b_down, approx_gelu)
    global LAUNCHES
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w_up, b_up, w_down, b_down)):
        raise RuntimeError("ffn_fused: the K5 kernel has no backward (inference only)")
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ffn_fused kernel takes float32 or bfloat16, got {dt}")
    M, K = x.shape
    Fd = w_up.shape[0]
    N = w_down.shape[0]
    if w_up.shape != (Fd, K) or w_down.shape != (N, Fd) or b_up.shape != (Fd,) or b_down.shape != (N,):
        raise ValueError(
            f"ffn_fused: x {tuple(x.shape)}, w_up {tuple(w_up.shape)}, b_up {tuple(b_up.shape)}, "
            f"w_down {tuple(w_down.shape)}, b_down {tuple(b_down.shape)} do not fit together"
        )
    if N not in WIDTHS:
        raise NotImplementedError(f"ffn_fused kernel takes output widths {WIDTHS}, got {N}")
    if K % 8 != 0 or Fd % 8 != 0:
        raise NotImplementedError(f"ffn_fused kernel takes K and F that are multiples of 8 (16-byte rows), "
                                  f"got K={K} F={Fd}")
    x = x.contiguous()
    wu = w_up.detach().to(dt).contiguous()
    wd = w_down.detach().to(dt).contiguous()
    bu = b_up.detach().float().contiguous()
    bd = b_down.detach().float().contiguous()
    for name, t in (("x", x), ("w_up", wu), ("w_down", wd)):
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"ffn_fused: {name} must start on a 16-byte boundary (cp.async)")
    out = torch.empty(M, N, device=x.device, dtype=dt)
    lib = _build.library()
    fn = lib.ser_ffn_fused_bf16 if dt == torch.bfloat16 else lib.ser_ffn_fused_f32
    err = fn(x.data_ptr(), wu.data_ptr(), bu.data_ptr(), wd.data_ptr(), bd.data_ptr(), out.data_ptr(),
             M, K, Fd, N, int(bool(approx_gelu)), _build.stream_ptr(x))
    _build.check(err, "ffn_fused")
    LAUNCHES += 1
    return out
