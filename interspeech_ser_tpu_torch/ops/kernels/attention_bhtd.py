"""K7 and K6: masked SDPA on [B, H, T, hd] heads with an optional factored bias.

Port of ``interspeech_ser_tpu/ops/pallas/flash_attention_short.py::
attention_bhtd`` (K7, one-shot, ``Tk <= MAX_ONESHOT_TK``) and
``interspeech_ser_tpu/ops/pallas/flash_attention.py::flash_attention`` (K6,
streaming, any length). The CUDA kernels are ``csrc/attention_bhtd.cu`` and
``csrc/flash_attention.cu`` (their headers say what bounds them and how they
tile); ``attention_bhtd_plain`` and ``flash_attention_plain`` are the plain
PyTorch versions of the same functions. Each launcher runs its kernel for a
CUDA tensor and its plain version for a CPU tensor. Neither kernel has a
backward: the launchers raise for inputs that require grad.

Semantics, shared by the kernels, their plain versions and the TPU kernels:
``softmax(scale * q.kᵀ + gate[b,h,q] * bias[h,q,k], masked keys) . v`` with
q.k accumulated in f32 and scaled after, scores and softmax in f32, a masked
key's score set to ``NEG_INF = -1e30``, P rounded to v's dtype before P.V
with f32 accumulation, and the result divided by ``max(l, 1e-30)``. So a
query row whose keys are all masked weighs every key exp(0) = 1, and so do
the zero keys its TPU kernel pads Tk with: the row is ``sum(V) / Tk_p``,
with ``Tk_p`` Tk rounded up to a multiple of 128 for K7 and of K6's
``block_k = min(256, max(128, Tk))`` for K6 (``attention.padded_tk``,
``flash_padded_tk``). K7 rounds the bias to the compute dtype, as its TPU
kernel does; K6 adds it in f32 as given. The gate defaults to 1.

The kernels take q, k, v as strided views (each row of hd contiguous), so
[B, T, H*hd] projections viewed as [B, H, T, hd] go in without a copy (K6 in
bf16, on the tensor cores, copies rows by 16-byte ``cp.async``: it raises on a
view whose pointer or batch / head / time strides are not 16-byte aligned; the
f32 kernels and K7 in bf16 copy such a view by smaller copies in the same
kernel), and they write their output in [B, T, H, hd] memory order (returned
as its [B, H, T, hd] view), so the caller's transpose back is free.

In f32 both kernels run on K1's FP32 register micro-tiles (256 threads own
64, 80 or 128 query rows, 4, 5 or 8 a thread; 64-key tiles staged by
``cp.async``): :func:`bhtd_f32_plan` gives the route, block rows and shared
memory their launchers pick, :func:`bhtd_f32_occupancy` what the built
kernel reports.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build
from .attention import SMEM_LIMIT, dead_row_denominator, padded_tk

NEG_INF = -1e30
MAX_ONESHOT_TK = 2048  # flash_attention_short.py: K7's key-length limit
LAUNCHES = 0  # K7 launches since the last reset (chip_smoke.py reads it)
FLASH_LAUNCHES = 0  # K6 launches


def flash_padded_tk(tk: int) -> int:
    """K6's padded key length: a multiple of ``block_k = min(256, max(128, Tk))``
    (``flash_attention.flash_attention``)."""
    return padded_tk(tk, min(256, max(128, tk)))


def _softmax_pv(q, k, v, key_mask, scale, gate, bias, tk_padded) -> torch.Tensor:
    """The plain one-pass form both kernels compute; ``bias`` already in the
    dtype its kernel adds it in, ``tk_padded`` the key length its TPU kernel
    pads to."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = (q.float() @ k.float().transpose(-1, -2)) * scale  # [B, H, Tq, Tk] f32
    if bias is not None:
        B, H, Tq = q.shape[:3]
        g = torch.ones(B, H, Tq, device=q.device) if gate is None else gate.float()
        s = s + g[..., None] * bias.float()[None]
    if key_mask is not None:
        s = s.masked_fill(~(key_mask > 0)[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = dead_row_denominator(p.sum(dim=-1, keepdim=True), m, tk_padded - k.shape[2])
    o = p.to(v.dtype).float() @ v.float()
    return (o / l.clamp_min(1e-30)).to(q.dtype)


def attention_bhtd_plain(
    q: torch.Tensor,  # [B, H, Tq, hd]
    k: torch.Tensor,  # [B, H, Tk, hd]
    v: torch.Tensor,  # [B, H, Tk, hd]
    key_mask: Optional[torch.Tensor] = None,  # [B, Tk], 1 = attend
    scale: Optional[float] = None,
    gate: Optional[torch.Tensor] = None,  # [B, H, Tq]
    pos_bias: Optional[torch.Tensor] = None,  # [H, Tq, Tk]
) -> torch.Tensor:  # [B, H, Tq, hd] in q.dtype
    """K7's function: the bias rounded to the compute dtype."""
    bias = None if pos_bias is None else pos_bias.to(q.dtype)
    return _softmax_pv(q, k, v, key_mask, scale, gate, bias, padded_tk(k.shape[2]))


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    gate: Optional[torch.Tensor] = None,
    pos_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K6's function: the bias added as given (in f32)."""
    return _softmax_pv(q, k, v, key_mask, scale, gate, pos_bias, flash_padded_tk(k.shape[2]))


# The f32 kernels' launch plan (csrc/attention_bhtd.cu and flash_attention.cu hold the same rule).
BHTD_KERNELS = ("attention_bhtd", "flash_attention")  # K7, K6
BHTD_F32_ROUTES = ("online", "scores_on_chip", "two_pass")  # the launchers' route numbers 0, 1, 2
BHTD_F32_TILE = 64  # keys a tile
BHTD_F32_ROWS = (64, 80, 128)  # query rows a block of 256 threads may own


def bhtd_f32_rows(tq: int) -> int:
    """Query rows an f32 K6 / K7 block owns: the fewest of 64, 80 or 128 that
    hold Tq (128 above 80), so that RoBERTa's 80 queries fill their block."""
    return next((r for r in BHTD_F32_ROWS if tq <= r), BHTD_F32_ROWS[-1])


@dataclass(frozen=True)
class BhtdF32Plan:
    kernel: str  # "attention_bhtd" (K7) or "flash_attention" (K6)
    route: str  # K6 "online"; K7 "scores_on_chip" or "two_pass"
    rows: int  # query rows a block of 256 threads owns
    tile: int  # keys a streamed tile
    smem_bytes: int  # dynamic shared memory a block


def _bhtd_f32_floats(route: str, rows: int, bias: bool, tkr: int) -> int:
    s = 64 + 4  # padded row of q, K, V: an odd number of 16-byte units
    if route == "scores_on_chip":  # q; a ring of two K-or-V tiles; score rows [rows][tkr + 4]; key flags
        return rows * s + 2 * BHTD_F32_TILE * s + rows * (tkr + 4) + tkr
    # q; K, V x 2 stages; bias / P [rows][68] x 2 stages (one without a bias); key flags x 2
    return rows * s + 4 * BHTD_F32_TILE * s + (2 if bias else 1) * rows * (BHTD_F32_TILE + 4) + 2 * BHTD_F32_TILE


def bhtd_f32_plan(kernel: str, tq: int, tk: int, bias: bool, hd: int = 64) -> BhtdF32Plan:
    """The f32 kernel's launch plan at (Tq, Tk, bias). K6: the online softmax
    at every length in blocks of ``bhtd_f32_rows(tq)`` query rows. K7: its
    scores kept on chip (shared memory) in blocks of the most of 128, 80 or
    64 rows, at most ``bhtd_f32_rows(tq)``, whose score rows fit beside q and
    two staged tiles (Tk <= 256, 512, 640), else two passes over the keys (the
    max, then P and P.V) in blocks of ``bhtd_f32_rows(tq)``."""
    if kernel not in BHTD_KERNELS or hd != 64 or tq < 1 or tk < 1:
        raise ValueError(f"bhtd_f32_plan takes kernels {BHTD_KERNELS}, head dim 64 and Tq, Tk >= 1, "
                         f"got {kernel!r}, hd {hd}, Tq {tq}, Tk {tk}")
    r = bhtd_f32_rows(tq)
    if kernel == "flash_attention":
        return BhtdF32Plan(kernel, "online", r, BHTD_F32_TILE, 4 * _bhtd_f32_floats("online", r, bias, 0))
    if tk > MAX_ONESHOT_TK:
        raise ValueError(f"bhtd_f32_plan: K7 takes Tk <= {MAX_ONESHOT_TK}, got {tk}")
    tkr = -(-tk // BHTD_F32_TILE) * BHTD_F32_TILE
    for on_chip in sorted(BHTD_F32_ROWS, reverse=True):
        nbytes = 4 * _bhtd_f32_floats("scores_on_chip", on_chip, bias, tkr)
        if on_chip <= r and nbytes <= SMEM_LIMIT:
            return BhtdF32Plan(kernel, "scores_on_chip", on_chip, BHTD_F32_TILE, nbytes)
    return BhtdF32Plan(kernel, "two_pass", r, BHTD_F32_TILE, 4 * _bhtd_f32_floats("two_pass", r, bias, tkr))


def bhtd_f32_occupancy(kernel: str, tq: int, tk: int, bias: bool) -> Tuple[str, int, int, int, int]:
    """(route, rows, tile, shared bytes, resident blocks an SM) of the f32
    kernel the built launcher picks at (Tq, Tk, bias), the blocks from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (registers included).
    Needs the card."""
    bhtd_f32_plan(kernel, tq, tk, bias)  # checks the arguments
    out = (ctypes.c_int * 5)()
    lib = _build.library()
    if kernel == "attention_bhtd":
        err = lib.ser_attention_bhtd_f32_plan(tq, tk, int(bias), out)
    else:
        err = lib.ser_flash_attention_f32_plan(tq, tk, int(bias), out)
    _build.check(err, f"bhtd_f32_occupancy({kernel!r}, {tq}, {tk}, {bias})")
    return (BHTD_F32_ROUTES[out[0]], *out[1:])


def _launch(name: str, q, k, v, key_mask, scale, gate, pos_bias, bias_dtype) -> torch.Tensor:
    """Check what the kernels take, allocate the output, launch ``ser_<name>_*``."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q, k, v must be [B, H, T, hd], got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    B, H, Tq, hd = q.shape
    Tk = k.shape[2]
    if hd != 64 or k.shape[:2] != (B, H) or k.shape[3] != hd:
        raise NotImplementedError(f"{name} kernel needs head dim 64 and matching q/k: "
                                  f"q {tuple(q.shape)} k {tuple(k.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {q.dtype}")
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"{name}: {n} must be a {q.dtype} tensor on {q.device} with contiguous rows")
    if name == "flash_attention" and q.dtype == torch.bfloat16:
        for n, t in (("q", q), ("k", k), ("v", v)):  # K6's tensor-core kernel copies rows in 16-byte units
            if t.data_ptr() % 16 != 0 or any(x % 8 != 0 for x in t.stride()[:3]):
                raise ValueError(f"{name}: bf16 {n} must start on 16 bytes with its batch, head and time "
                                 f"strides multiples of 8 elements (cp.async), got strides {t.stride()}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v, gate, pos_bias)):
        raise RuntimeError(f"{name}: the kernel has no backward; inputs that require grad go to "
                           "the plain attention")
    mask = None
    if key_mask is not None:
        if key_mask.shape != (B, Tk):
            raise ValueError(f"{name}: key_mask shape {tuple(key_mask.shape)} != {(B, Tk)}")
        mask = key_mask.to(device=q.device, dtype=torch.float32).contiguous()
    bias = g = None
    if pos_bias is not None:
        if pos_bias.shape != (H, Tq, Tk):
            raise ValueError(f"{name}: pos_bias shape {tuple(pos_bias.shape)} != {(H, Tq, Tk)}")
        bias = pos_bias.to(device=q.device, dtype=bias_dtype).contiguous()
        if gate is None:
            g = torch.ones(B, H, Tq, device=q.device)
        elif gate.shape != (B, H, Tq):
            raise ValueError(f"{name}: gate shape {tuple(gate.shape)} != {(B, H, Tq)}")
        else:
            g = gate.to(device=q.device, dtype=torch.float32).contiguous()
    if scale is None:
        scale = hd ** -0.5
    out = torch.empty(B, Tq, H, hd, device=q.device, dtype=q.dtype).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _build.library()
    fn = getattr(lib, f"ser_{name}_{'bf16' if q.dtype == torch.bfloat16 else 'f32'}")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(mask), _build.ptr(g), _build.ptr(bias),
             out.data_ptr(), strides, B, H, Tq, Tk, hd, float(scale), _build.stream_ptr(q))
    _build.check(err, name)
    return out


def attention_bhtd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    gate: Optional[torch.Tensor] = None,
    pos_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K7 on a CUDA tensor, the plain version on a CPU tensor. Raises above
    ``MAX_ONESHOT_TK`` keys, as the TPU kernel asserts."""
    if k.shape[2] > MAX_ONESHOT_TK:
        raise ValueError(f"attention_bhtd: Tk={k.shape[2]} > {MAX_ONESHOT_TK}; use flash_attention")
    if not q.is_cuda:
        return attention_bhtd_plain(q, k, v, key_mask, scale, gate, pos_bias)
    global LAUNCHES
    out = _launch("attention_bhtd", q, k, v, key_mask, scale, gate, pos_bias, q.dtype)
    LAUNCHES += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    gate: Optional[torch.Tensor] = None,
    pos_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K6 on a CUDA tensor, the plain version on a CPU tensor."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, key_mask, scale, gate, pos_bias)
    global FLASH_LAUNCHES
    out = _launch("flash_attention", q, k, v, key_mask, scale, gate, pos_bias, torch.float32)
    FLASH_LAUNCHES += 1
    return out
