"""Bidirectional GRU with torch ``nn.GRU`` gates, names and layout.

Port of ``interspeech_ser_tpu/ops/gru.py``. Gate order r, z, n; the n-gate
hidden bias sits inside the reset product:

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h = (1 - z) * n + z * h

With a mask (1 = real frame) the carry freezes across padded steps and the
output is zero there, so a padded batched run equals per-utterance runs.

``BiGRU`` on a CUDA tensor runs the input projection as one ``torch.matmul``
per direction and the recurrence through kernel K3, both directions stacked
along batch (the backward one reversed in time); its gradient comes from
kernel K3b through ``GruBidirCarries``. On a CPU tensor it runs ``gru_scan``,
the plain version, once per direction, and autograd differentiates it.
``gru_scan_bidir_stacked`` is the plain stacked form (both directions in one
loop), the JAX package's one-scan BiGRU.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .kernels.gru import gru_sequence_bidir


def gru_scan(
    x: torch.Tensor,  # [B, T, I]
    h0: torch.Tensor,  # [B, H]
    w_ih: torch.Tensor,  # [3H, I] (torch weight_ih_l0)
    w_hh: torch.Tensor,  # [3H, H] (torch weight_hh_l0)
    b_ih: torch.Tensor,  # [3H]
    b_hh: torch.Tensor,  # [3H]
    mask: Optional[torch.Tensor] = None,  # [B, T], 1 = real frame
    reverse: bool = False,
) -> torch.Tensor:  # [B, T, H], zeros at masked steps
    B, T, _ = x.shape
    H = h0.shape[-1]
    x_proj = x.float() @ w_ih.float().t() + b_ih.float()  # [B, T, 3H]
    m = torch.ones(B, T, 1, device=x.device) if mask is None else mask.float()[:, :, None]
    w = w_hh.float().t()
    b = b_hh.float()
    h = h0.float()
    out = [None] * T
    for t in reversed(range(T)) if reverse else range(T):
        hp = h @ w + b
        xp = x_proj[:, t]
        r = torch.sigmoid(xp[:, :H] + hp[:, :H])
        z = torch.sigmoid(xp[:, H : 2 * H] + hp[:, H : 2 * H])
        n = torch.tanh(xp[:, 2 * H :] + r * hp[:, 2 * H :])
        h_new = (1.0 - z) * n + z * h
        h = m[:, t] * h_new + (1.0 - m[:, t]) * h
        out[t] = h * m[:, t]
    return torch.stack(out, dim=1).to(x.dtype)


def gru_scan_bidir_stacked(
    x: torch.Tensor,  # [B, T, I]
    h0: torch.Tensor,  # [B, H]
    params_fwd,  # (w_ih [3H, I], w_hh [3H, H], b_ih [3H], b_hh [3H]), torch layout
    params_bwd,  # the ``_reverse`` direction's
    mask: Optional[torch.Tensor] = None,  # [B, T], 1 = real frame
) -> torch.Tensor:  # [B, T, 2H] = concat(forward, backward), zeros at masked steps
    """Both directions in one loop over T, stacked on a leading [2] axis (the
    backward direction's inputs and mask reversed in time): the plain
    counterpart of the JAX package's one-scan BiGRU, equal to two
    ``gru_scan`` calls."""
    B, T, _ = x.shape
    H = h0.shape[-1]

    def proj(w_ih, b_ih):
        return x.float() @ w_ih.float().t() + b_ih.float()  # [B, T, 3H]

    xp = torch.stack([proj(params_fwd[0], params_fwd[2]), proj(params_bwd[0], params_bwd[2]).flip(1)])
    m = torch.ones(B, T, 1, device=x.device) if mask is None else mask.float()[:, :, None]
    m2 = torch.stack([m, m.flip(1)])  # [2, B, T, 1]
    w = torch.stack([params_fwd[1], params_bwd[1]]).float().transpose(1, 2)  # [2, H, 3H]
    b = torch.stack([params_fwd[3], params_bwd[3]]).float()[:, None]  # [2, 1, 3H]
    h = h0.float().expand(2, B, H)
    out = []
    for t in range(T):
        hp = torch.bmm(h, w) + b
        xt, mt = xp[:, :, t], m2[:, :, t]
        r = torch.sigmoid(xt[..., :H] + hp[..., :H])
        z = torch.sigmoid(xt[..., H:2 * H] + hp[..., H:2 * H])
        n = torch.tanh(xt[..., 2 * H:] + r * hp[..., 2 * H:])
        h = mt * ((1.0 - z) * n + z * h) + (1.0 - mt) * h
        out.append(h * mt)
    ys = torch.stack(out, dim=2)  # [2, B, T, H]
    return torch.cat([ys[0], ys[1].flip(1)], dim=-1).to(x.dtype)


class BiGRU(nn.Module):
    """Single-layer bidirectional GRU; state-dict keys as torch ``nn.GRU``
    (``weight_ih_l0``, ``weight_hh_l0``, ``bias_ih_l0``, ``bias_hh_l0`` and
    their ``_reverse`` twins). Output [B, T, 2H] = concat(forward, backward)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        H3 = 3 * hidden_size
        for sfx in ("", "_reverse"):
            self.register_parameter(f"weight_ih_l0{sfx}", nn.Parameter(torch.empty(H3, input_size)))
            self.register_parameter(f"weight_hh_l0{sfx}", nn.Parameter(torch.empty(H3, hidden_size)))
            self.register_parameter(f"bias_ih_l0{sfx}", nn.Parameter(torch.empty(H3)))
            self.register_parameter(f"bias_hh_l0{sfx}", nn.Parameter(torch.empty(H3)))
        bound = 1.0 / math.sqrt(hidden_size)  # torch's GRU init
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound)

    def _direction(self, sfx: str):
        return tuple(getattr(self, f"{n}_l0{sfx}") for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.forward_stacked(x, mask) if x.is_cuda else self.forward_scan(x, mask)

    def forward_scan(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The plain path: ``gru_scan`` per direction, differentiated by
        autograd (the CPU route, and the reference for the kernels' route)."""
        h0 = x.new_zeros(x.shape[0], self.hidden_size, dtype=torch.float32)
        fwd = gru_scan(x, h0, *self._direction(""), mask=mask)
        bwd = gru_scan(x, h0, *self._direction("_reverse"), mask=mask, reverse=True)
        return torch.cat([fwd, bwd], dim=-1)

    def forward_stacked(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Both directions in one differentiable K3 call (``GruBidirCarries``:
        K3 forward, K3b backward; their plain versions on a CPU tensor)."""
        B, T, _ = x.shape
        (wi_f, wh_f, bi_f, bh_f), (wi_b, wh_b, bi_b, bh_b) = (
            self._direction(""), self._direction("_reverse")
        )
        xf = x.float()
        xp_f = torch.matmul(xf, wi_f.float().t()) + bi_f.float()
        xp_b = (torch.matmul(xf, wi_b.float().t()) + bi_b.float()).flip(1)
        m = torch.ones(B, T, device=x.device) if mask is None else mask.float()
        out = gru_sequence_bidir(
            torch.cat([xp_f, xp_b], dim=0).contiguous(),
            torch.stack([wh_f.float().t(), wh_b.float().t()]).contiguous(),
            torch.stack([bh_f.float(), bh_b.float()]).contiguous(),
            torch.cat([m, m.flip(1)], dim=0).contiguous(),
            B,
        )
        return torch.cat([out[:B], out[B:].flip(1)], dim=-1).to(x.dtype)
