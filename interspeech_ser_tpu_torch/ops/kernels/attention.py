"""K1: masked SDPA on [B, T, D] projection panels with a factored gated bias.

Port of ``interspeech_ser_tpu/ops/pallas/flash_attention_short.py::
attention_btd``. The CUDA kernel is ``csrc/attention_btd.cu`` (its header
says what bounds it and how it streams keys); ``attention_btd_plain`` is the
plain PyTorch version of the same function. ``attention_btd`` launches the
kernel for a CUDA tensor and runs the plain version for a CPU tensor.

Semantics, shared by both versions and the TPU kernel: per head h (columns
``h*hd:(h+1)*hd`` of D), ``softmax(scale*q.kᵀ + gate[b,h,q]*bias[h,q,k] +
key mask) . v``; q*scale rounded to the compute dtype, the bias cast to the
compute dtype, scores and softmax in f32, P rounded to v's dtype before P.V
with f32 accumulation, the result divided by ``max(l, 1e-30)``. A query row
whose keys are all masked is not defined (a real utterance has >= 1 frame).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def attention_btd_plain(
    q: torch.Tensor,  # [B, Tq, D]
    k: torch.Tensor,  # [B, Tk, D]
    v: torch.Tensor,  # [B, Tk, D]
    num_heads: int,
    key_mask: Optional[torch.Tensor] = None,  # [B, Tk], 1 = attend
    scale: Optional[float] = None,
    gate: Optional[torch.Tensor] = None,  # [B, H, Tq]
    pos_bias: Optional[torch.Tensor] = None,  # [H, Tq, Tk]
) -> torch.Tensor:  # [B, Tq, D] in q.dtype
    B, Tq, D = q.shape
    Tk = k.shape[1]
    H = num_heads
    hd = D // H
    dt = q.dtype
    if scale is None:
        scale = hd ** -0.5
    sc = torch.tensor(scale, dtype=dt, device=q.device)
    qh = (q.reshape(B, Tq, H, hd) * sc).transpose(1, 2).float()
    kh = k.reshape(B, Tk, H, hd).transpose(1, 2).float()
    vh = v.reshape(B, Tk, H, hd).transpose(1, 2).float()
    s = qh @ kh.transpose(-1, -2)  # [B, H, Tq, Tk] f32
    if pos_bias is not None:
        g = torch.ones(B, H, Tq, device=q.device) if gate is None else gate.float()
        s = s + g[..., None] * pos_bias.to(dt).float()[None]
    if key_mask is not None:
        s = s.masked_fill(~(key_mask > 0)[:, None, None, :], NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(v.dtype).float() @ vh) / l.clamp_min(1e-30)
    return o.to(dt).transpose(1, 2).reshape(B, Tq, D)


def attention_btd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    key_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    gate: Optional[torch.Tensor] = None,
    pos_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1 on a CUDA tensor, the plain version on a CPU tensor."""
    if not q.is_cuda:
        return attention_btd_plain(q, k, v, num_heads, key_mask, scale, gate, pos_bias)
    global LAUNCHES
    B, Tq, D = q.shape
    Tk = k.shape[1]
    H = num_heads
    if D % H != 0 or D // H != 64:
        raise NotImplementedError(f"attention_btd kernel needs head dim 64, got D={D} H={H}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention_btd kernel takes float32 or bfloat16, got {q.dtype}")
    if k.shape != (B, Tk, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {q.dtype} tensor on {q.device}")
    mask = None
    if key_mask is not None:
        if key_mask.shape != (B, Tk):
            raise ValueError(f"key_mask shape {tuple(key_mask.shape)} != {(B, Tk)}")
        mask = key_mask.to(device=q.device, dtype=torch.float32).contiguous()
    bias = g = None
    if pos_bias is not None:
        if pos_bias.shape != (H, Tq, Tk):
            raise ValueError(f"pos_bias shape {tuple(pos_bias.shape)} != {(H, Tq, Tk)}")
        bias = pos_bias.to(device=q.device, dtype=q.dtype).contiguous()
        if gate is None:
            g = torch.ones(B, H, Tq, device=q.device)
        else:
            if gate.shape != (B, H, Tq):
                raise ValueError(f"gate shape {tuple(gate.shape)} != {(B, H, Tq)}")
            g = gate.to(device=q.device, dtype=torch.float32).contiguous()
    if scale is None:
        scale = 64 ** -0.5
    out = torch.empty_like(q)
    lib = _build.library()
    fn = lib.ser_attention_btd_bf16 if q.dtype == torch.bfloat16 else lib.ser_attention_btd_f32
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(mask), _build.ptr(g),
        _build.ptr(bias), out.data_ptr(), B, Tq, Tk, H, 64, float(scale),
        _build.stream_ptr(q),
    )
    _build.check(err, "attention_btd")
    LAUNCHES += 1
    return out
