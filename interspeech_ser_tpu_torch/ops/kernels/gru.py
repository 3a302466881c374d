"""K3: masked bidirectional GRU recurrence, forward.

Port of ``interspeech_ser_tpu/ops/pallas/gru_kernel.py::gru_bidir_carries``
(forward) and its entry ``gru_sequence_bidir``. The CUDA kernel is
``csrc/gru_bidir.cu``; ``gru_bidir_carries_plain`` is the plain PyTorch
version (a loop over T). ``gru_bidir_carries`` launches the kernel for a
CUDA tensor and runs the plain version for a CPU tensor.

Both directions ride one call, stacked along batch: rows ``[:half]`` are the
forward direction, rows ``[half:]`` the backward direction with inputs and
mask already reversed in time. Gates follow torch (r, z, n; ``b_hn`` inside
the reset product); a masked step freezes the carry. The carries come back
unmasked, and ``gru_sequence_bidir`` multiplies by the mask.
"""

from __future__ import annotations

import torch

from . import _build

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def gru_bidir_carries_plain(
    x_proj: torch.Tensor,  # [2B, T, 3H] f32 input projections
    w_hh2: torch.Tensor,  # [2, H, 3H]
    b_hh2: torch.Tensor,  # [2, 3H]
    mask: torch.Tensor,  # [2B, T]
) -> torch.Tensor:  # [2B, T, H] unmasked carries
    B2, T, H3 = x_proj.shape
    H = H3 // 3
    half = B2 // 2
    x_proj = x_proj.float()
    w = w_hh2.float()
    b = b_hh2.float()
    m = mask.float()[:, :, None]
    h = x_proj.new_zeros(B2, H)
    out = []
    for t in range(T):
        hp = torch.cat([h[:half] @ w[0] + b[0], h[half:] @ w[1] + b[1]], dim=0)
        xp = x_proj[:, t]
        r = torch.sigmoid(xp[:, :H] + hp[:, :H])
        z = torch.sigmoid(xp[:, H : 2 * H] + hp[:, H : 2 * H])
        n = torch.tanh(xp[:, 2 * H :] + r * hp[:, 2 * H :])
        h_new = (1.0 - z) * n + z * h
        h = m[:, t] * h_new + (1.0 - m[:, t]) * h
        out.append(h)
    return torch.stack(out, dim=1)


def gru_bidir_carries(
    x_proj: torch.Tensor, w_hh2: torch.Tensor, b_hh2: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """K3 on a CUDA tensor, the plain version on a CPU tensor."""
    if not x_proj.is_cuda:
        return gru_bidir_carries_plain(x_proj, w_hh2, b_hh2, mask)
    global LAUNCHES
    B2, T, H3 = x_proj.shape
    H = H3 // 3
    if H3 != 3 * H or B2 % 2 != 0:
        raise ValueError(f"x_proj must be [2B, T, 3H], got {tuple(x_proj.shape)}")
    if w_hh2.shape != (2, H, H3) or b_hh2.shape != (2, H3) or mask.shape != (B2, T):
        raise ValueError(
            f"w_hh2 {tuple(w_hh2.shape)}, b_hh2 {tuple(b_hh2.shape)}, mask "
            f"{tuple(mask.shape)} do not match x_proj {tuple(x_proj.shape)}"
        )
    for name, t in (("x_proj", x_proj), ("w_hh2", w_hh2), ("b_hh2", b_hh2), ("mask", mask)):
        if t.dtype != torch.float32 or t.device != x_proj.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x_proj.device}")
    threads = min(1024, -(-H // 32) * 32)
    if H > 4 * threads:
        raise NotImplementedError(f"gru_bidir kernel takes H <= 4096, got {H}")
    out = torch.empty(B2, T, H, device=x_proj.device, dtype=torch.float32)
    err = _build.library().ser_gru_bidir_f32(
        x_proj.data_ptr(), w_hh2.data_ptr(), b_hh2.data_ptr(), mask.data_ptr(),
        out.data_ptr(), B2, T, H, threads, _build.stream_ptr(x_proj),
    )
    _build.check(err, "gru_bidir")
    LAUNCHES += 1
    return out


def gru_sequence_bidir(
    x_proj: torch.Tensor,  # [2B, T, 3H]: rows [:half] forward, [half:] time-reversed
    w_hh2: torch.Tensor,
    b_hh2: torch.Tensor,
    mask: torch.Tensor,  # [2B, T]
    half: int,
) -> torch.Tensor:  # [2B, T, H], zeros at masked steps
    if x_proj.shape[0] != 2 * half:
        raise ValueError(
            f"x_proj rows ({x_proj.shape[0]}) must be 2*half ({2 * half}): "
            "rows [:half] forward, [half:] time-reversed backward"
        )
    mask = mask.float()
    return gru_bidir_carries(x_proj, w_hh2, b_hh2, mask) * mask[:, :, None]
