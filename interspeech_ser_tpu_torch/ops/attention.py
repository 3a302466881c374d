"""Masked multi-head attention and attention pooling for the fusion model.

Port of ``interspeech_ser_tpu/ops/attention.py``; plain PyTorch, as the JAX
package computes these with XLA einsums and no kernel (sequences of a few
hundred frames, 1-2 heads).

``TorchMultiheadAttention`` reproduces torch ``nn.MultiheadAttention``
(batch_first) with its state-dict keys (``in_proj_weight``,
``in_proj_bias``, ``out_proj.*``) and a key mask; in training mode it drops
attention weights at rate ``dropout``, with the mask drawn from the
``torch.Generator`` the caller passes. ``attention_pool`` is the
reference's softmax pooling over time, with padded frames given no weight.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .attention_core import NEG_INF, dot_product_attention_plain


class TorchMultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 1, dropout: float = 0.0):
        super().__init__()
        assert embed_dim % num_heads == 0
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(
        self,
        query: torch.Tensor,  # [B, Tq, E]
        key: torch.Tensor,  # [B, Tk, E]
        value: torch.Tensor,  # [B, Tk, E]
        key_mask: Optional[torch.Tensor] = None,  # [B, Tk], 1 = attend
        generator: Optional[torch.Generator] = None,  # dropout's mask, training mode
    ) -> torch.Tensor:
        E, H = self.embed_dim, self.num_heads
        hd = E // H
        dt = query.dtype
        wq, wk, wv = self.in_proj_weight.to(dt).chunk(3, dim=0)
        bq, bk, bv = self.in_proj_bias.to(dt).chunk(3)
        B, Tq, _ = query.shape
        Tk = key.shape[1]

        def heads(x, w, b, T):
            return (x @ w.t() + b).reshape(B, T, H, hd).transpose(1, 2)

        out = dot_product_attention_plain(
            heads(query, wq, bq, Tq), heads(key, wk, bk, Tk), heads(value, wv, bv, Tk),
            key_mask=key_mask, dropout_p=self.dropout if self.training else 0.0, generator=generator,
        )
        out = out.transpose(1, 2).reshape(B, Tq, E)
        return out @ self.out_proj.weight.to(dt).t() + self.out_proj.bias.to(dt)


def attention_pool(
    features: torch.Tensor,  # [B, T, D]
    scores: torch.Tensor,  # [B, T, 1] raw scores from a Linear(D, 1)
    mask: Optional[torch.Tensor] = None,  # [B, T], 1 = valid
) -> torch.Tensor:  # [B, D]
    s = scores.float()
    if mask is not None:
        s = s.masked_fill(~(mask > 0)[:, :, None], NEG_INF)
    w = torch.softmax(s, dim=1)
    return (features.float() * w).sum(dim=1).to(features.dtype)
