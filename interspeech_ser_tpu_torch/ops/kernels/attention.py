"""K1: masked SDPA on [B, T, D] projection panels with a factored gated bias,
and K4, its backward.

Port of ``interspeech_ser_tpu/ops/pallas/flash_attention_short.py::
attention_btd`` (K1) and ``interspeech_ser_tpu/ops/pallas/attention_bwd.py::
attention_btd_bwd`` (K4). The CUDA kernels are ``csrc/attention_btd.cu`` and
``csrc/attention_btd_bwd.cu`` (their headers say what bounds them and how
they stream); ``attention_btd_plain`` and ``attention_btd_bwd_plain`` are the
plain PyTorch versions of the same functions. Each launcher runs its kernel
for a CUDA tensor and its plain version for a CPU tensor.
``AttentionBtdTrain`` is the differentiable pair: K1 forward, K4 backward.
Both kernels take head dims 64, 80 and 120 (a template parameter). In bf16
every product runs on the tensor cores (``mma.sync`` m16n8k16, f32
accumulation); in f32 (the default of the extraction CLIs and of
``lora_cli``) on the FP32 pipes as IEEE fmaf, TF32 never: blocks of 256
threads owning 128 rows, register-blocked score micro-tiles of 8 rows x
T/16 streamed rows, tiles staged by ``cp.async`` and double-buffered.
``attention_f32_plan`` gives their tile sizes and shared memory (the CUDA
sources apply the same rule), ``attention_f32_occupancy`` what the built
kernels report. Every kernel stages the q, k, v (and g) panels by 16-byte
``cp.async``: a panel whose base is off 16 bytes is refused with a
``ValueError`` in either dtype (``_check_aligned``); there is no slower
copy route. A fresh PyTorch allocation, and any contiguous slice of one
along T, starts on 16 bytes.

Semantics, shared by both versions and the TPU kernel: per head h (columns
``h*hd:(h+1)*hd`` of D), ``softmax(scale*q.kᵀ + gate[b,h,q]*bias[h,q,k] +
key mask) . v`` with ``scale = hd ** -0.5`` unless given; q*scale rounded to
the compute dtype, the bias cast to the compute dtype, scores and softmax in
f32, P rounded to v's dtype before P.V with f32 accumulation, the result
divided by ``max(l, 1e-30)``. A query row whose keys are all masked gets
what the TPU kernel gives it: every key weighs exp(0) = 1, and so do the
zero keys it pads Tk with to a multiple of 128, so the row is ``sum(V) /
Tk_p`` (``dead_row_denominator``) and its backward takes P = 1 / Tk_p on
every key. The backward keeps the TPU
kernel's roundings: P is recomputed in f32, rounded to the compute dtype
before ``dV = Pᵀg``; dS is rounded to the compute dtype before ``dQ`` and
``dK``; ``dgate`` and ``dbias`` stay f32. K4 forms its scores exactly as K1
does, from the rounded q*scale, so that ``exp(s - lse)`` with K1's lse is
K1's P at every head dim; it takes ``dK = dSᵀ (q*scale)`` from the same
operand and ``dQ = scale * dS k``. The plain backward forms
``scale * (q.kᵀ)`` as the TPU kernel does; the two differ by the rounding
of q*scale.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
LAUNCHES = 0  # K1 launches since the last reset (chip_smoke.py reads it)
BWD_LAUNCHES = 0  # K4 launches (one per backward: its four CUDA launches count once)


def padded_tk(tk: int, block: int = 128) -> int:
    """The key length the TPU kernels pad to: a multiple of ``block`` (K1, K4 and K7
    take 128; K6 its own ``block_k``, ``attention_bhtd.flash_padded_tk``)."""
    return -(-tk // block) * block


def dead_row_denominator(l: torch.Tensor, m: torch.Tensor, n_pad: int) -> torch.Tensor:
    """The softmax denominator ``l`` with the TPU kernels' ``n_pad`` padded keys
    counted in a row whose keys are all masked (row max ``m`` still ``NEG_INF``):
    there every key, the padding's zero rows of V included, weighs exp(0) = 1,
    so the row gets ``sum(V) / (Tk + n_pad)``. Every other row keeps its bits:
    the padding's weight exp(NEG_INF - m) is 0 there."""
    return torch.where(m == NEG_INF, l + n_pad, l)


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
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = dead_row_denominator(p.sum(dim=-1, keepdim=True), m, padded_tk(Tk) - Tk)
    o = (p.to(v.dtype).float() @ vh) / l.clamp_min(1e-30)
    return o.to(dt).transpose(1, 2).reshape(B, Tq, D)


def attention_btd_bwd_plain(
    q: torch.Tensor,  # [B, Tq, D]
    k: torch.Tensor,  # [B, Tk, D]
    v: torch.Tensor,  # [B, Tk, D]
    g: torch.Tensor,  # [B, Tq, D] cotangent of the output
    num_heads: int,
    key_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    gate: Optional[torch.Tensor] = None,
    pos_bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """-> (dq, dk, dv in q.dtype, dgate [B,H,Tq] f32 | None, dbias [H,Tq,Tk] f32 | None),
    with P recomputed from q and k as ``attention_bwd._bwd_kernel`` does."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    H = num_heads
    hd = D // H
    dt = q.dtype
    if scale is None:
        scale = hd ** -0.5

    def heads(x, T):
        return x.reshape(B, T, H, hd).transpose(1, 2).float()

    qh, kh, vh, gh = heads(q, Tq), heads(k, Tk), heads(v, Tk), heads(g, Tq)
    s = (qh @ kh.transpose(-1, -2)) * scale  # [B, H, Tq, Tk] f32
    bias = gt = None
    if pos_bias is not None:
        gt = torch.ones(B, H, Tq, device=q.device) if gate is None else gate.float()
        bias = pos_bias.to(dt).float()
        s = s + gt[..., None] * bias[None]
    if key_mask is not None:
        s = s.masked_fill(~(key_mask > 0)[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    P = p / dead_row_denominator(p.sum(dim=-1, keepdim=True), m, padded_tk(Tk) - Tk).clamp_min(1e-30)  # f32
    dv = P.to(dt).float().transpose(-1, -2) @ gh
    dP = gh @ vh.transpose(-1, -2)
    dS = P * (dP - (P * dP).sum(dim=-1, keepdim=True))  # f32
    dSc = dS.to(dt).float()
    dq = (dSc @ kh) * scale
    dk = (dSc.transpose(-1, -2) @ qh) * scale

    def merge(x, T):
        return x.to(dt).transpose(1, 2).reshape(B, T, D)

    dgate = dbias = None
    if pos_bias is not None:
        dgate = (dS * bias[None]).sum(dim=-1)
        dbias = (gt[..., None] * dS).sum(dim=0)
    return merge(dq, Tq), merge(dk, Tk), merge(dv, Tk), dgate, dbias


K1_HEAD_DIMS = (64, 80, 120)  # WavLM-large / base / Whisper, HuBERT-XL, XLS-R-2B
K4_HEAD_DIMS = K1_HEAD_DIMS


def _prepare(q, k, v, num_heads, key_mask, gate, pos_bias, head_dims=K1_HEAD_DIMS):
    """Check what the kernels take; -> (mask f32 | None, gate f32 | None, bias in q.dtype | None)."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    H = num_heads
    if D % H != 0 or D // H not in head_dims:
        raise NotImplementedError(f"attention_btd kernels take head dims {head_dims}, got D={D} H={H}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention_btd kernels take float32 or bfloat16, got {q.dtype}")
    if k.shape != (B, Tk, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {q.dtype} tensor on {q.device}")
    mask = None
    if key_mask is not None:
        if key_mask.shape != (B, Tk):
            raise ValueError(f"key_mask shape {tuple(key_mask.shape)} != {(B, Tk)}")
        mask = key_mask.detach().to(device=q.device, dtype=torch.float32).contiguous()
    bias = g = None
    if pos_bias is not None:
        if pos_bias.shape != (H, Tq, Tk):
            raise ValueError(f"pos_bias shape {tuple(pos_bias.shape)} != {(H, Tq, Tk)}")
        bias = pos_bias.detach().to(device=q.device, dtype=q.dtype).contiguous()
        if gate is None:
            g = torch.ones(B, H, Tq, device=q.device)
        else:
            if gate.shape != (B, H, Tq):
                raise ValueError(f"gate shape {tuple(gate.shape)} != {(B, H, Tq)}")
            g = gate.detach().to(device=q.device, dtype=torch.float32).contiguous()
    return mask, g, bias


def _check_aligned(**tensors) -> None:
    """The kernels copy rows in 16-byte units (``cp.async``), in bf16 and in
    f32: their panels must start on 16 bytes (rows then do too, a row of D
    values being a multiple of 16 bytes at every head dim). Raises otherwise."""
    for name, t in tensors.items():
        if t.data_ptr() % 16 != 0:
            dt = "bf16" if t.dtype == torch.bfloat16 else "f32"
            raise ValueError(f"attention_btd kernels: {dt} {name} must start on a 16-byte boundary")


# The f32 kernels' launch plan (csrc/attention_f32.cuh holds the same rule).
F32_ROWS = 128  # rows a block owns, 8 a thread (queries; keys in the dK/dV pass)
F32_KINDS = ("fwd", "dkdv", "dq")  # K1; K4's dK/dV pass and dQ pass
SMEM_LIMIT = 232448  # the most shared memory a block may opt into on an H100 (227 KB)
SM_SMEM = 233472  # shared memory of an H100 SM (228 KB); each resident block also reserves 1 KB


@dataclass(frozen=True)
class F32Plan:
    kind: str  # "fwd", "dkdv" or "dq"
    hd: int
    bias: bool
    tile: int  # rows of the streamed tile: keys (fwd, dq) or queries (dkdv)
    stages: int  # streamed tiles in flight (double-buffered)
    smem_bytes: int  # dynamic shared memory a block
    blocks_per_sm: int  # resident blocks an SM as shared memory allows
    micro_tile: Tuple[int, int]  # a thread's score micro-tile: (own rows, streamed rows)


def _f32_smem_floats(kind: str, hd: int, bias: bool, t: int) -> int:
    s, r = hd + 4, F32_ROWS  # padded panel row: an odd number of 16-byte units
    weights = 2 if bias else 1  # the bias tile's two stages (P or dS lands on it), or one P / dS tile
    if kind == "fwd":  # q*scale; K, V x 2 stages; bias / P [rows][t + 4]; key flags x 2
        return r * s + 4 * t * s + weights * r * (t + 4) + 2 * t
    if kind == "dkdv":  # K, V; q*scale, dO x 2; bias / P and dS [t][rows + 4]; lse, delta, gate x 2
        return 2 * r * s + 4 * t * s + (weights + 1) * t * (r + 4) + 6 * t
    # dq: q*scale, dO; K, V x 2; bias / dS [rows][t + 4]; key flags x 2
    return 2 * r * s + 4 * t * s + weights * r * (t + 4) + 2 * t


def attention_f32_plan(hd: int, bias: bool, kind: str = "fwd") -> F32Plan:
    """The f32 kernel's plan: 128-row blocks of 256 threads, 8 rows a thread
    (one block an SM, up to 255 registers a thread); the streamed tile is the
    longest of 64, 32, 16 rows whose shared memory fits ``SMEM_LIMIT``."""
    if hd not in K1_HEAD_DIMS or kind not in F32_KINDS:
        raise ValueError(f"attention_f32_plan takes head dims {K1_HEAD_DIMS} and kinds {F32_KINDS}, got {hd}, {kind!r}")
    t = next(t for t in (64, 32, 16) if 4 * _f32_smem_floats(kind, hd, bias, t) <= SMEM_LIMIT)
    nbytes = 4 * _f32_smem_floats(kind, hd, bias, t)
    return F32Plan(kind, hd, bool(bias), t, 2, nbytes, SM_SMEM // (nbytes + 1024), (F32_ROWS // 16, t // 16))


def attention_f32_occupancy(hd: int, bias: bool, kind: str = "fwd") -> Tuple[int, int, int]:
    """(tile, shared bytes, resident blocks an SM) of the built f32 kernel, the
    blocks from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (registers
    included). Needs the card."""
    attention_f32_plan(hd, bias, kind)  # checks the arguments
    out = (ctypes.c_int * 3)()
    lib = _build.library()
    if kind == "fwd":
        err = lib.ser_attention_btd_f32_plan(hd, int(bias), out)
    else:
        err = lib.ser_attention_btd_bwd_f32_plan(F32_KINDS.index(kind), hd, int(bias), out)
    _build.check(err, f"attention_f32_occupancy({hd}, {bias}, {kind!r})")
    return tuple(out)


def _launch_forward(q, k, v, num_heads, key_mask, scale, gate, pos_bias, with_lse: bool):
    """K1 -> (out, lse [B, H, Tq] f32 or None)."""
    global LAUNCHES
    mask, g, bias = _prepare(q, k, v, num_heads, key_mask, gate, pos_bias)
    _check_aligned(q=q, k=k, v=v)
    B, Tq, D = q.shape
    hd = D // num_heads
    if scale is None:
        scale = hd ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty(B, num_heads, Tq, device=q.device, dtype=torch.float32) if with_lse else None
    lib = _build.library()
    fn = lib.ser_attention_btd_bf16 if q.dtype == torch.bfloat16 else lib.ser_attention_btd_f32
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(mask), _build.ptr(g),
        _build.ptr(bias), out.data_ptr(), _build.ptr(lse), B, Tq, k.shape[1], num_heads, hd,
        float(scale), _build.stream_ptr(q),
    )
    _build.check(err, "attention_btd")
    LAUNCHES += 1
    return out, lse


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
    """K1 on a CUDA tensor, the plain version on a CPU tensor. On the card,
    inputs that need a gradient must come through ``AttentionBtdTrain``."""
    if not q.is_cuda:
        return attention_btd_plain(q, k, v, num_heads, key_mask, scale, gate, pos_bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v, gate, pos_bias)):
        raise RuntimeError(
            "attention_btd: autograd cannot see into the K1 kernel; "
            "call AttentionBtdTrain.apply for inputs that require grad"
        )
    return _launch_forward(q, k, v, num_heads, key_mask, scale, gate, pos_bias, with_lse=False)[0]


def attention_btd_fwd(
    q, k, v, num_heads, key_mask=None, scale=None, gate=None, pos_bias=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 with its per-row log-sum-exp, the residual K4 reads (CUDA tensors only)."""
    if not q.is_cuda:
        raise ValueError("attention_btd_fwd launches K1: it takes CUDA tensors")
    return _launch_forward(q, k, v, num_heads, key_mask, scale, gate, pos_bias, with_lse=True)


def attention_btd_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    num_heads: int,
    key_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    gate: Optional[torch.Tensor] = None,
    pos_bias: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,  # K1's output   } the forward's residuals,
    lse: Optional[torch.Tensor] = None,  # K1's lse     } needed by the kernel only
    want_dgate: bool = True,
    want_dbias: bool = True,
) -> Tuple[Optional[torch.Tensor], ...]:
    """K4 on a CUDA tensor, the plain version on a CPU tensor
    -> (dq, dk, dv, dgate | None, dbias | None). ``want_dgate`` / ``want_dbias``
    False let the kernel skip those cotangents (None then)."""
    if not q.is_cuda:
        dq, dk, dv, dgate, dbias = attention_btd_bwd_plain(q, k, v, g, num_heads, key_mask, scale, gate, pos_bias)
        return dq, dk, dv, dgate if want_dgate else None, dbias if want_dbias else None
    global BWD_LAUNCHES
    mask, gt, bias = _prepare(q, k, v, num_heads, key_mask, gate, pos_bias, K4_HEAD_DIMS)
    B, Tq, D = q.shape
    Tk = k.shape[1]
    H = num_heads
    for name, t, shape, dtype in (("g", g, q.shape, q.dtype), ("out", out, q.shape, q.dtype),
                                  ("lse", lse, (B, H, Tq), torch.float32)):
        if t is None or t.shape != shape or t.dtype != dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"attention_btd_bwd: {name} must be a contiguous {dtype} {tuple(shape)} tensor "
                             f"on {q.device}")
    hd = D // H
    if scale is None:
        scale = hd ** -0.5
    _check_aligned(q=q, k=k, v=v, g=g, out=out)
    has_bias = bias is not None
    f32 = dict(device=q.device, dtype=torch.float32)
    delta = torch.empty(B, H, Tq, **f32)
    qs = torch.empty_like(q) if q.dtype == torch.bfloat16 else None  # q * scale, the bf16 passes' operand
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dgate = torch.empty(B, H, Tq, **f32) if has_bias and want_dgate else None
    dbias = torch.empty(H, Tq, Tk, **f32) if has_bias and want_dbias else None
    dbias_part = torch.empty(B, H, Tq, Tk, **f32) if dbias is not None else None
    lib = _build.library()
    fn = lib.ser_attention_btd_bwd_bf16 if q.dtype == torch.bfloat16 else lib.ser_attention_btd_bwd_f32
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), out.data_ptr(), _build.ptr(mask),
        _build.ptr(gt), _build.ptr(bias), lse.data_ptr(), delta.data_ptr(), _build.ptr(qs),
        _build.ptr(dbias_part), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _build.ptr(dgate),
        _build.ptr(dbias), B, Tq, Tk, H, hd, float(scale), _build.stream_ptr(q),
    )
    _build.check(err, "attention_btd_bwd")
    BWD_LAUNCHES += 1
    return dq, dk, dv, dgate, dbias


class AttentionBtdTrain(torch.autograd.Function):
    """Differentiable K1: forward ``attention_btd`` (with its lse on the card),
    backward ``attention_btd_bwd``. Saves ``(q, k, v, key_mask, gate,
    pos_bias)`` as ``_diff_fwd`` does, plus K1's output and lse for the
    kernel. Returns ``None`` for every input whose ``needs_input_grad`` is
    False and tells K4 to skip ``dgate`` / ``dbias`` then; the mask gets no
    gradient. On CPU tensors both directions run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, key_mask, scale, gate, pos_bias):
        if q.is_cuda:
            out, lse = attention_btd_fwd(q, k, v, num_heads, key_mask, scale, gate, pos_bias)
        else:
            out, lse = attention_btd_plain(q, k, v, num_heads, key_mask, scale, gate, pos_bias), None
        ctx.save_for_backward(q, k, v, key_mask, gate, pos_bias, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, gate, pos_bias, out, lse = ctx.saved_tensors
        need = ctx.needs_input_grad
        dq, dk, dv, dgate, dbias = attention_btd_bwd(
            q, k, v, g.contiguous(), ctx.num_heads, key_mask, ctx.scale, gate, pos_bias, out=out, lse=lse,
            want_dgate=need[6], want_dbias=need[7],
        )
        return (
            dq if need[0] else None,
            dk if need[1] else None,
            dv if need[2] else None,
            None,
            None,
            None,
            dgate.to(gate.dtype) if need[6] and dgate is not None else None,  # None: no bias, no effect
            dbias.to(pos_bias.dtype) if need[7] else None,
        )
