"""Scaled-dot-product attention core for the speech encoder.

Port of ``interspeech_ser_tpu/ops/attention_core.py``. The bias comes
FACTORED, ``gate [B,H,Tq] x shared_bias [H,Tq,Tk]`` (WavLM's gated
relative-position bias); a plain additive bias is the case gate = 1. The
softmax always runs in float32.

``dot_product_attention_btd`` is the single dispatch point of the encoder
(``ops/kernels/attention.py`` holds the kernels):
- a CUDA tensor with grad enabled and an input that requires grad goes to
  ``AttentionBtdTrain``, kernel K1 forward and kernel K4 backward;
- any other CUDA tensor goes to K1;
- a CPU tensor goes to K1's plain version, under ordinary autograd.
K1 and K4 stream over keys, so they have no length limit and no fallback.
The JAX package's TPU-only choices (the inference/training opt-ins, the
bf16-only and ``Tk >= 1024`` gating of the training pair) are gone: they
were measurements of a TPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels.attention import NEG_INF, AttentionBtdTrain, attention_btd, attention_btd_plain


def dot_product_attention_btd(
    q: torch.Tensor,  # [B, Tq, D], D = H * hd
    k: torch.Tensor,  # [B, Tk, D]
    v: torch.Tensor,  # [B, Tk, D]
    num_heads: int,
    key_mask: Optional[torch.Tensor] = None,  # [B, Tk], 1 = attend
    scale: Optional[float] = None,
    gate: Optional[torch.Tensor] = None,  # [B, H, Tq]
    shared_bias: Optional[torch.Tensor] = None,  # [H, Tq, Tk]
    plain: bool = False,  # force the plain version (reference runs on the card)
) -> torch.Tensor:  # [B, Tq, D]
    if plain:
        return attention_btd_plain(q, k, v, num_heads, key_mask, scale, gate, shared_bias)
    if q.is_cuda and torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, gate, shared_bias)
    ):
        return AttentionBtdTrain.apply(q, k, v, num_heads, key_mask, scale, gate, shared_bias)
    return attention_btd(q, k, v, num_heads, key_mask=key_mask, scale=scale, gate=gate, pos_bias=shared_bias)


def dot_product_attention(
    q: torch.Tensor,  # [B, H, Tq, hd]
    k: torch.Tensor,  # [B, H, Tk, hd]
    v: torch.Tensor,  # [B, H, Tk, hd]
    bias: Optional[torch.Tensor] = None,  # [B, H, Tq, Tk] pre-materialised
    key_mask: Optional[torch.Tensor] = None,  # [B, Tk], 1 = attend
    scale: Optional[float] = None,
    gate: Optional[torch.Tensor] = None,  # [B, H, Tq]
    shared_bias: Optional[torch.Tensor] = None,  # [H, Tq, Tk]
    dropout_p: float = 0.0,  # on the attention weights
    generator: Optional[torch.Generator] = None,  # draws the dropout mask
) -> torch.Tensor:
    """Plain masked SDPA on [B, H, T, hd] with an optional (factored) bias.

    As in the JAX package, bf16 inputs keep the score and bias chain in bf16
    and only the softmax runs in f32; f32 inputs stay f32 throughout.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    assert bias is None or shared_bias is None
    dt = q.dtype
    scores = (q * scale) @ k.transpose(-1, -2)  # in dt (f32 accumulation)
    if shared_bias is not None:
        b = shared_bias[None].to(dt)
        if gate is not None:
            b = gate[..., None].to(dt) * b
        scores = scores + b
    elif bias is not None:
        scores = scores + bias.to(dt)
    if key_mask is not None:
        scores = scores.float().masked_fill(~(key_mask > 0)[:, None, None, :], NEG_INF)
    weights = dropout(torch.softmax(scores.float(), dim=-1), dropout_p, generator).to(dt)
    return (weights.float() @ v.float()).to(dt)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (keep with probability 1 - p, scale by 1 / (1 - p))
    with its mask drawn from ``generator``; the identity when p == 0."""
    if p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)
