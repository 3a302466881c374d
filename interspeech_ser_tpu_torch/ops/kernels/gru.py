"""K3 and K3b: masked bidirectional GRU recurrence, forward and backward;
K9: one direction of the same recurrence.

Port of ``interspeech_ser_tpu/ops/pallas/gru_kernel.py::gru_bidir_carries``
(the forward, K3) and its custom-VJP backward ``_gru_bidir_bwd`` (K3b), with
the entry ``gru_sequence_bidir``. The CUDA kernels are ``csrc/gru_bidir.cu``
and ``csrc/gru_bidir_bwd.cu``; ``gru_bidir_carries_plain`` and
``gru_bidir_carries_bwd_plain`` are the plain PyTorch versions (loops over
T). Each launcher runs its kernel for a CUDA tensor and its plain version
for a CPU tensor. ``GruBidirCarries`` is the ``torch.autograd.Function``
that joins them: K3 forward, K3b backward. On a CUDA tensor it is the only
way to K3 with gradients, since autograd cannot see into a kernel.

Both directions ride one call, stacked along batch: rows ``[:half]`` are the
forward direction, rows ``[half:]`` the backward direction with inputs and
mask already reversed in time. Gates follow torch (r, z, n; ``b_hn`` inside
the reset product); a masked step freezes the carry. The carries come back
unmasked, and ``gru_sequence_bidir`` multiplies by the mask outside the
Function, as the JAX package does.

K9 is the port of ``gru_kernel.py::gru_sequence``: one direction with a
``reverse`` flag, the outputs zero at masked steps. No path of the package
calls it (nor does the JAX package's); ``gru_sequence`` launches
``csrc/gru_bidir.cu``'s one-direction kernel for a CUDA tensor and runs
``gru_sequence_plain`` for a CPU tensor.

The plain versions compute in float32, or in float64 for float64 inputs
(so ``torch.autograd.gradcheck`` can hold the hand-derived backward to
numerical derivatives).

K3, K9 and K3b each have two routes, hand-written kernels in
``csrc/gru_bidir.cu`` (K3, K9) and ``csrc/gru_bidir_bwd.cu`` (K3b); a
planner picks one by this rule (``gru_bidir_plan``, ``gru_sequence_plan``,
``gru_bidir_bwd_plan``): for ``H <= 512`` the cluster route, where a
thread-block cluster of ``C = ceil(H / 32)`` CTAs holds one direction's
``w_hh`` on chip (registers and shared memory) for the whole sequence and
carries ``R = 16`` rows; for ``512 < H <= 4096`` one block a row, which
rereads ``w_hh`` from L2 at every step (a CTA's 3 x 32 columns of ``w_hh``
stop fitting its 227 KB above H = 512). K9 runs K3's cluster kernel for one
direction. K3b's cluster route is three stages, each a public function here
so that they can be timed apart: ``gate_preacts`` (the gate recompute
hoisted out of the loop, a tiled product), ``bwd_recurrence`` and
``bwd_weight_grads`` (dW and db, a tiled product split along the
row-steps). A launch that fails raises; nothing retries on the other route
or on the plain version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build

LAUNCHES = 0  # K3 launches since the last reset (chip_smoke.py reads it)
BWD_LAUNCHES = 0  # K3b launches since the last reset
SEQ_LAUNCHES = 0  # K9 launches since the last reset


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def gru_bidir_carries_plain(
    x_proj: torch.Tensor,  # [2B, T, 3H] input projections
    w_hh2: torch.Tensor,  # [2, H, 3H]
    b_hh2: torch.Tensor,  # [2, 3H]
    mask: torch.Tensor,  # [2B, T]
) -> torch.Tensor:  # [2B, T, H] unmasked carries
    B2, T, H3 = x_proj.shape
    H = H3 // 3
    half = B2 // 2
    dt = _compute_dtype(x_proj)
    x_proj = x_proj.to(dt)
    w = w_hh2.to(dt)
    b = b_hh2.to(dt)
    m = mask.to(dt)[:, :, None]
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


def gru_bidir_carries_bwd_plain(
    x_proj: torch.Tensor,  # [2B, T, 3H]
    w_hh2: torch.Tensor,  # [2, H, 3H]
    b_hh2: torch.Tensor,  # [2, 3H]
    mask: torch.Tensor,  # [2B, T]
    h: torch.Tensor,  # [2B, T, H] the forward's unmasked carries
    g: torch.Tensor,  # [2B, T, H] cotangent of the carries
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:  # dx_proj, dW_hh2, db_hh2
    """Reverse-time loop, line for line ``_gru_bidir_bwd_scan``."""
    B2, T, H3 = x_proj.shape
    H = H3 // 3
    B = B2 // 2
    dt = _compute_dtype(x_proj)

    def tm(a: torch.Tensor, t: int) -> torch.Tensor:  # step t, direction-split [2, B, w]
        return a[:, t].reshape(2, B, -1)

    xs = x_proj.to(dt)
    gs = g.to(dt)
    hs = h.to(dt)
    ms = mask.to(dt)[:, :, None]
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], dim=1)
    whh = w_hh2.to(dt)  # [2, H, 3H]
    bhh = b_hh2.to(dt)  # [2, 3H]
    dh = xs.new_zeros(2, B, H)
    dwhh = torch.zeros_like(whh)
    dbhh = torch.zeros_like(bhh)
    dxps = [None] * T
    for t in reversed(range(T)):
        g_t, hprev, xp_t, m_t = tm(gs, t), tm(h_prev, t), tm(xs, t), tm(ms, t)
        hp = torch.bmm(hprev, whh) + bhh[:, None, :]
        r = torch.sigmoid(xp_t[..., :H] + hp[..., :H])
        z = torch.sigmoid(xp_t[..., H : 2 * H] + hp[..., H : 2 * H])
        hn = hp[..., 2 * H :]
        n = torch.tanh(xp_t[..., 2 * H :] + r * hn)
        dht = g_t + dh
        dh_new = dht * m_t
        dh_skip = dht * (1.0 - m_t)
        dn_pre = dh_new * (1.0 - z) * (1.0 - n * n)
        dz_pre = dh_new * (hprev - n) * z * (1.0 - z)
        dr_pre = dn_pre * hn * r * (1.0 - r)
        dxp = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        dhp = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1)
        dh = dh_skip + dh_new * z + torch.bmm(dhp, whh.transpose(1, 2))
        dwhh = dwhh + torch.bmm(hprev.transpose(1, 2), dhp)
        dbhh = dbhh + dhp.sum(dim=1)
        dxps[t] = dxp.reshape(B2, H3)
    return torch.stack(dxps, dim=1), dwhh, dbhh


def _check_inputs(x_proj: torch.Tensor, w_hh2, b_hh2, mask, **more) -> Tuple[int, int, int]:
    B2, T, H3 = x_proj.shape
    H = H3 // 3
    if H3 != 3 * H or B2 % 2 != 0:
        raise ValueError(f"x_proj must be [2B, T, 3H], got {tuple(x_proj.shape)}")
    if w_hh2.shape != (2, H, H3) or b_hh2.shape != (2, H3) or mask.shape != (B2, T):
        raise ValueError(
            f"w_hh2 {tuple(w_hh2.shape)}, b_hh2 {tuple(b_hh2.shape)}, mask "
            f"{tuple(mask.shape)} do not match x_proj {tuple(x_proj.shape)}"
        )
    for name, t in more.items():
        if t.shape != (B2, T, H):
            raise ValueError(f"{name} must be {(B2, T, H)}, got {tuple(t.shape)}")
    tensors = {"x_proj": x_proj, "w_hh2": w_hh2, "b_hh2": b_hh2, "mask": mask, **more}
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.device != x_proj.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x_proj.device}")
    return B2, T, H


def _threads(H: int) -> int:
    threads = min(1024, -(-H // 32) * 32)
    if H > 4 * threads:
        raise NotImplementedError(f"gru_bidir kernels take H <= 4096, got {H}")
    return threads


CLUSTER_UNITS = 32  # hidden units (3 x 32 columns of w_hh) a CTA of the cluster route holds
CLUSTER_ROWS = 16  # rows a cluster carries
MAX_CLUSTER = 16  # CTAs a cluster at most (a non-portable size above 8)
CLUSTER_REG_DEPTH = 128  # depth rows of a CTA's w_hh columns held in registers (clusters of 4 CTAs and more)
BWD_REG_COLUMNS = 24  # K3b: of a CTA's 96 w_hh columns, those held in registers
SMEM_LIMIT = 232448  # shared memory a block may use on an H100 (227 KB)
SM_COUNT = 132  # streaming multiprocessors of an H100 SXM
GEMM_TILE = 128  # output tile of K3b's tiled products (csrc/gru_bidir_bwd.cu)


@dataclass(frozen=True)
class GruPlan:
    """A launch of K3, K9 or K3b's recurrence: ``route`` is ``"cluster"``
    (``cluster`` CTAs a cluster, ``rows`` rows each) or ``"row"`` (one block
    of ``threads`` a row); ``smem_bytes`` is a block's dynamic shared memory,
    ``grid`` its grid."""

    route: str
    cluster: int
    rows: int
    threads: int
    smem_bytes: int
    grid: Tuple[int, int, int]


def gru_bidir_plan(B2: int, H: int) -> GruPlan:
    """K3's route for ``2B = B2`` rows of hidden size ``H`` (the rule in the
    module docstring; ``csrc/gru_bidir.cu`` checks it)."""
    return _forward_plan(B2 // 2, H, 2)


def gru_sequence_plan(B: int, H: int) -> GruPlan:
    """K9's route for ``B`` rows of hidden size ``H``: K3's kernels for one
    direction."""
    return _forward_plan(B, H, 1)


def _forward_plan(rows: int, H: int, dirs: int) -> GruPlan:
    C = -(-H // CLUSTER_UNITS)
    if C <= MAX_CLUSTER:
        kp = C * CLUSTER_UNITS  # the depth, H rounded up to the cluster's units
        in_regs = CLUSTER_REG_DEPTH if C >= 4 else 0  # the first 128 of the depth stay in registers
        # w_hh columns less the part in registers, two h buffers, two staging tiles; two mbarriers
        smem = 4 * (3 * CLUSTER_UNITS * (kp - in_regs) + 2 * CLUSTER_ROWS * kp + 2 * CLUSTER_ROWS * CLUSTER_UNITS) + 16
        return GruPlan("cluster", C, CLUSTER_ROWS, 256, smem, (C, -(-rows // CLUSTER_ROWS), dirs))
    return GruPlan("row", 1, 1, _threads(H), 4 * H, (rows * dirs, 1, 1))


def gru_bidir_bwd_plan(B2: int, H: int) -> GruPlan:
    """K3b's recurrence route for ``2B = B2`` rows of hidden size ``H``
    (``csrc/gru_bidir_bwd.cu`` checks it). Cluster route: a CTA keeps 72 of
    its 96 w_hh columns in shared memory (24 in registers), two dhp tiles of
    16 rows and two receive buffers of C x 16 x 32 partial sums, and two
    mbarriers. Row route: 6H floats of shared memory a block."""
    C = -(-H // CLUSTER_UNITS)
    if C <= MAX_CLUSTER:
        cols = 3 * CLUSTER_UNITS
        kp = C * CLUSTER_UNITS
        smem = 4 * ((cols - BWD_REG_COLUMNS) * kp + 2 * CLUSTER_ROWS * cols + 2 * C * CLUSTER_ROWS * CLUSTER_UNITS) + 16
        return GruPlan("cluster", C, CLUSTER_ROWS, 256, smem, (C, -(-(B2 // 2) // CLUSTER_ROWS), 2))
    return GruPlan("row", 1, 1, _threads(H), 24 * H, (B2, 1, 1))


def dw_splits(B2: int, T: int, H: int) -> int:
    """Chunks S of the row-step axis for K3b's dW product, at most 16, each
    at least 512 row-steps: the S that takes the least time when each of the
    ``tiles x S`` blocks takes 1 / S of a whole tile's time and the card runs
    two blocks an SM at once (``ceil(tiles S / 264) / S``; the smallest such
    S). From four full waves of tiles on, no split (the last wave's waste is
    small, and the partial sums would be large)."""
    tiles = -(-3 * H // GEMM_TILE) * -(-H // GEMM_TILE) * 2
    most = 1 if tiles >= 8 * SM_COUNT else max(1, min(16, (B2 // 2) * T // 512))
    return min(range(1, most + 1), key=lambda s: (-(-tiles * s // (2 * SM_COUNT)) / s, s))


def max_active_clusters(H: int, kernel: str = "gru_bidir") -> int:
    """How many clusters of the cluster route of ``kernel`` (``gru_bidir``,
    ``gru_sequence`` or ``gru_bidir_bwd``) at hidden size ``H`` the card runs
    at once (``cudaOccupancyMaxActiveClusters``)."""
    plans = {"gru_bidir": gru_bidir_plan, "gru_sequence": gru_sequence_plan, "gru_bidir_bwd": gru_bidir_bwd_plan}
    plan = plans[kernel](2, H)
    if plan.route != "cluster":
        raise ValueError(f"H={H} takes the one-block-per-row route")
    n = ctypes.c_int(0)
    lib = _build.library()
    if kernel == "gru_bidir_bwd":
        err = lib.ser_gru_bwd_max_active_clusters(plan.cluster, ctypes.byref(n))
    else:
        err = lib.ser_gru_max_active_clusters(plan.cluster, int(kernel == "gru_sequence"), ctypes.byref(n))
    _build.check(err, kernel)
    return n.value


def gru_bidir_carries(
    x_proj: torch.Tensor, w_hh2: torch.Tensor, b_hh2: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """K3 on a CUDA tensor, the plain version on a CPU tensor. On the card,
    inputs that need a gradient must come through ``GruBidirCarries``."""
    if not x_proj.is_cuda:
        return gru_bidir_carries_plain(x_proj, w_hh2, b_hh2, mask)
    global LAUNCHES
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_proj, w_hh2, b_hh2)):
        raise RuntimeError(
            "gru_bidir_carries: autograd cannot see into the K3 kernel; "
            "call GruBidirCarries.apply for inputs that require grad"
        )
    B2, T, H = _check_inputs(x_proj, w_hh2, b_hh2, mask)
    plan = gru_bidir_plan(B2, H)
    out = torch.empty(B2, T, H, device=x_proj.device, dtype=torch.float32)
    err = _build.library().ser_gru_bidir_f32(
        x_proj.data_ptr(), w_hh2.data_ptr(), b_hh2.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B2, T, H, plan.cluster if plan.route == "cluster" else 0, plan.threads, _build.stream_ptr(x_proj),
    )
    _build.check(err, "gru_bidir")
    LAUNCHES += 1
    return out


def gru_bidir_carries_bwd(
    x_proj: torch.Tensor,
    w_hh2: torch.Tensor,
    b_hh2: torch.Tensor,
    mask: torch.Tensor,
    h: torch.Tensor,
    g: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3b on a CUDA tensor, the plain version on a CPU tensor
    -> (dx_proj [2B,T,3H], dW_hh2 [2,H,3H], db_hh2 [2,3H])."""
    if not x_proj.is_cuda:
        return gru_bidir_carries_bwd_plain(x_proj, w_hh2, b_hh2, mask, h, g)
    global BWD_LAUNCHES
    B2, T, H = _check_inputs(x_proj, w_hh2, b_hh2, mask, h=h, g=g)
    hp = gate_preacts(h, w_hh2, b_hh2) if gru_bidir_bwd_plan(B2, H).route == "cluster" else None
    dxp, dhp = bwd_recurrence(x_proj, w_hh2, b_hh2, mask, h, g, hp)
    del hp  # its [2B, T, 3H] go back to the allocator before dW's partial sums
    dw, db = bwd_weight_grads(h, dhp)
    BWD_LAUNCHES += 1
    return dxp, dw, db


def _check_stage(h: torch.Tensor, **more) -> Tuple[int, int, int]:
    """The shapes a K3b stage takes beside the carries ``h`` [2B, T, H]: all
    contiguous float32 on h's CUDA device."""
    B2, T, H = h.shape
    want = {"w_hh2": (2, H, 3 * H), "b_hh2": (2, 3 * H), "dhp": (B2, T, 3 * H)}
    for name, t in (("h", h), *more.items()):
        if B2 % 2 or (name != "h" and tuple(t.shape) != want[name]):
            raise ValueError(f"{name} {tuple(t.shape)} does not fit h {tuple(h.shape)}")
        if t.dtype != torch.float32 or t.device != h.device or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor on {h.device}")
    return B2, T, H


def gate_preacts(h: torch.Tensor, w_hh2: torch.Tensor, b_hh2: torch.Tensor) -> torch.Tensor:
    """K3b's first stage on the cluster route (CUDA tensors): the gate
    pre-activations ``h_prev . w_hh[d] + b_hh[d]`` of every row and step,
    [2B, T, 3H], from the forward's carries ``h`` (``h_prev`` is ``h`` one
    step back, zero at t = 0)."""
    B2, T, H = _check_stage(h, w_hh2=w_hh2, b_hh2=b_hh2)
    hp = torch.empty(B2, T, 3 * H, device=h.device, dtype=torch.float32)
    err = _build.library().ser_gru_bwd_gates_f32(
        h.data_ptr(), w_hh2.data_ptr(), b_hh2.data_ptr(), hp.data_ptr(), B2, T, H, _build.stream_ptr(h))
    _build.check(err, "gru_bidir_bwd gates")
    return hp


def bwd_recurrence(x_proj, w_hh2, b_hh2, mask, h, g, hp: Optional[torch.Tensor]):
    """K3b's recurrence (CUDA tensors) -> (dx_proj, dhp), both [2B, T, 3H];
    ``hp`` is ``gate_preacts``'s output on the cluster route, None on the
    row route (which recomputes the gates in its loop)."""
    B2, T, H = _check_inputs(x_proj, w_hh2, b_hh2, mask, h=h, g=g)
    plan = gru_bidir_bwd_plan(B2, H)
    if (hp is None) != (plan.route == "row"):
        raise ValueError(f"hp must be given on the cluster route and only there (H={H}: {plan.route} route)")
    dxp = torch.empty_like(x_proj)
    dhp = torch.empty_like(x_proj)  # the gate cotangents, for dW / db
    err = _build.library().ser_gru_bidir_bwd_f32(
        g.data_ptr(), h.data_ptr(), x_proj.data_ptr(), mask.data_ptr(), w_hh2.data_ptr(), b_hh2.data_ptr(),
        _build.ptr(hp), dxp.data_ptr(), dhp.data_ptr(), B2, T, H,
        plan.cluster if plan.route == "cluster" else 0, plan.threads, _build.stream_ptr(x_proj),
    )
    _build.check(err, "gru_bidir_bwd")
    return dxp, dhp


def bwd_weight_grads(h: torch.Tensor, dhp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3b's last stage (CUDA tensors) -> (dW_hh2 [2, H, 3H], db_hh2 [2, 3H]):
    ``h_prev^T . dhp`` and the sum of ``dhp`` over each direction's rows and
    steps, ``dw_splits`` partial sums added in a fixed order."""
    B2, T, H = _check_stage(h, dhp=dhp)
    splits = dw_splits(B2, T, H)
    dw = torch.empty(2, H, 3 * H, device=h.device, dtype=torch.float32)
    db = torch.empty(2, 3 * H, device=h.device, dtype=torch.float32)
    dw_part = torch.empty(splits, *dw.shape, device=h.device) if splits > 1 else None
    db_part = torch.empty(splits, *db.shape, device=h.device) if splits > 1 else None
    err = _build.library().ser_gru_bwd_dw_f32(
        h.data_ptr(), dhp.data_ptr(), _build.ptr(dw_part), _build.ptr(db_part), dw.data_ptr(), db.data_ptr(),
        B2, T, H, splits, _build.stream_ptr(h))
    _build.check(err, "gru_bidir_bwd dW")
    return dw, db


class GruBidirCarries(torch.autograd.Function):
    """Differentiable K3: forward ``gru_bidir_carries``, backward
    ``gru_bidir_carries_bwd``; saves ``(x_proj, w_hh2, b_hh2, mask, h)`` as
    ``_gru_bidir_fwd`` does. The mask gets no gradient."""

    @staticmethod
    def forward(ctx, x_proj, w_hh2, b_hh2, mask):
        h = gru_bidir_carries(x_proj, w_hh2, b_hh2, mask)
        ctx.save_for_backward(x_proj, w_hh2, b_hh2, mask, h)
        return h

    @staticmethod
    def backward(ctx, g):
        x_proj, w_hh2, b_hh2, mask, h = ctx.saved_tensors
        dxp, dw, db = gru_bidir_carries_bwd(x_proj, w_hh2, b_hh2, mask, h, g.contiguous())
        return dxp, dw, db, None


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
    mask = mask.to(_compute_dtype(x_proj))
    return GruBidirCarries.apply(x_proj, w_hh2, b_hh2, mask) * mask[:, :, None]


def gru_sequence_plain(
    x_proj: torch.Tensor,  # [B, T, 3H] input projections
    w_hh: torch.Tensor,  # [H, 3H]
    b_hh: torch.Tensor,  # [3H]
    mask: Optional[torch.Tensor] = None,  # [B, T]
    reverse: bool = False,
) -> torch.Tensor:  # [B, T, H], zeros at masked steps
    B, T, H3 = x_proj.shape
    H = H3 // 3
    dt = _compute_dtype(x_proj)
    xs = x_proj.to(dt)
    w, b = w_hh.to(dt), b_hh.to(dt)
    m = (x_proj.new_ones(B, T) if mask is None else mask).to(dt)[:, :, None]
    h = xs.new_zeros(B, H)
    out = [None] * T
    for t in (reversed(range(T)) if reverse else range(T)):
        hp = h @ w + b
        xp = xs[:, t]
        r = torch.sigmoid(xp[:, :H] + hp[:, :H])
        z = torch.sigmoid(xp[:, H : 2 * H] + hp[:, H : 2 * H])
        n = torch.tanh(xp[:, 2 * H :] + r * hp[:, 2 * H :])
        h = m[:, t] * ((1.0 - z) * n + z * h) + (1.0 - m[:, t]) * h
        out[t] = h * m[:, t]
    return torch.stack(out, dim=1)


def gru_sequence(
    x_proj: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    reverse: bool = False,
) -> torch.Tensor:
    """K9 on a CUDA tensor, the plain version on a CPU tensor. Forward only,
    as in the JAX package: the launcher raises for inputs that require grad."""
    if not x_proj.is_cuda:
        return gru_sequence_plain(x_proj, w_hh, b_hh, mask, reverse)
    global SEQ_LAUNCHES
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_proj, w_hh, b_hh)):
        raise RuntimeError("gru_sequence: the K9 kernel has no backward")
    B, T, H3 = x_proj.shape
    H = H3 // 3
    if mask is None:
        mask = torch.ones(B, T, device=x_proj.device)
    if H3 != 3 * H or w_hh.shape != (H, H3) or b_hh.shape != (H3,) or mask.shape != (B, T):
        raise ValueError(f"x_proj {tuple(x_proj.shape)}, w_hh {tuple(w_hh.shape)}, b_hh {tuple(b_hh.shape)}, "
                         f"mask {tuple(mask.shape)} do not fit together")
    for name, t in (("x_proj", x_proj), ("w_hh", w_hh), ("b_hh", b_hh), ("mask", mask)):
        if t.dtype != torch.float32 or t.device != x_proj.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x_proj.device}")
    plan = gru_sequence_plan(B, H)
    out = torch.empty(B, T, H, device=x_proj.device, dtype=torch.float32)
    err = _build.library().ser_gru_sequence_f32(
        x_proj.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B, T, H, int(bool(reverse)), plan.cluster if plan.route == "cluster" else 0, plan.threads,
        _build.stream_ptr(x_proj),
    )
    _build.check(err, "gru_sequence")
    SEQ_LAUNCHES += 1
    return out
