"""Scaled-dot-product attention core for the encoders.

Port of ``interspeech_ser_tpu/ops/attention_core.py``. The bias comes
FACTORED, ``gate [B,H,Tq] x shared_bias [H,Tq,Tk]`` (WavLM's gated
relative-position bias); a plain additive bias is the case gate = 1. The
softmax always runs in float32.

``dot_product_attention_btd`` is the single dispatch point of the speech
encoders on [B, T, D] panels (``ops/kernels/attention.py`` holds the kernels):
- a CUDA tensor with grad enabled and an input that requires grad goes to
  ``AttentionBtdTrain``, kernel K1 forward and kernel K4 backward;
- any other CUDA tensor goes to K1;
- a CPU tensor goes to K1's plain version, under ordinary autograd;
- under ``SER_TPU_ATTN_IMPL=xla`` every tensor goes to the plain attention
  on [B, H, T, hd] heads, as the JAX package's XLA route does (a route the
  user asks for, not a fallback).
K1 and K4 stream over keys, so they have no length limit and no fallback.
The JAX package's TPU-only choices (the inference/training opt-ins, the
bf16-only and ``Tk >= 1024`` gating of the training pair) are gone: they
were measurements of a TPU.

``dot_product_attention`` is the dispatch point on [B, H, T, hd] heads
(RoBERTa's self-attention; ``ops/kernels/attention_bhtd.py`` holds the
kernels). ``pick_impl`` chooses, as the JAX package's does: ``force_impl``
first (``oneshot``, ``flash`` or ``plain``), then ``SER_TPU_ATTN_IMPL``
(``oneshot``, ``flash``, or ``xla`` for ``plain``; any other value raises,
in both dispatchers), else K7 (one-shot) up to
``MAX_ONESHOT_TK`` keys and K6 (streaming) beyond. The chosen kernel's
wrapper runs its plain version for a CPU tensor. Neither kernel has a
backward or dropout: the fusion model's cross-attention, which needs both,
calls ``dot_product_attention_plain`` and never reaches them.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple

import torch

from .kernels.attention import NEG_INF, AttentionBtdTrain, attention_btd, attention_btd_plain
from .kernels.attention_bhtd import MAX_ONESHOT_TK, attention_bhtd, flash_attention

KERNEL_IMPLS = ("oneshot", "flash")
ENV_IMPLS = KERNEL_IMPLS + ("xla",)  # the SER_TPU_ATTN_IMPL values the port honours


def env_impl() -> Optional[str]:
    """``SER_TPU_ATTN_IMPL`` when set (one of ``ENV_IMPLS``, else it raises), or None."""
    env = os.environ.get("SER_TPU_ATTN_IMPL")
    if env and env not in ENV_IMPLS:
        raise ValueError(f"SER_TPU_ATTN_IMPL={env!r}: the port honours {'|'.join(ENV_IMPLS)}")
    return env or None


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
    if env_impl() == "xla":  # the JAX package's XLA route: plain attention on heads
        B, Tq, D = q.shape
        heads = [t.reshape(B, t.shape[1], num_heads, D // num_heads).transpose(1, 2) for t in (q, k, v)]
        out = dot_product_attention_plain(*heads, key_mask=key_mask, scale=scale, gate=gate,
                                          shared_bias=shared_bias)
        return out.transpose(1, 2).reshape(B, Tq, D)
    if q.is_cuda and torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, gate, shared_bias)
    ):
        return AttentionBtdTrain.apply(q, k, v, num_heads, key_mask, scale, gate, shared_bias)
    return attention_btd(q, k, v, num_heads, key_mask=key_mask, scale=scale, gate=gate, pos_bias=shared_bias)


def pick_impl(tk: int, force_impl: Optional[str] = None) -> str:
    """``oneshot`` (K7), ``flash`` (K6) or ``plain`` for a key length ``tk``."""
    if force_impl is not None:
        if force_impl not in KERNEL_IMPLS + ("plain",):
            raise ValueError(f"force_impl={force_impl!r}: expected one of {KERNEL_IMPLS + ('plain',)}")
        return force_impl
    env = env_impl()
    if env:
        return "plain" if env == "xla" else env
    return "oneshot" if tk <= MAX_ONESHOT_TK else "flash"


def dot_product_attention(
    q: torch.Tensor,  # [B, H, Tq, hd]
    k: torch.Tensor,  # [B, H, Tk, hd]
    v: torch.Tensor,  # [B, H, Tk, hd]
    key_mask: Optional[torch.Tensor] = None,  # [B, Tk], 1 = attend
    scale: Optional[float] = None,
    gate: Optional[torch.Tensor] = None,  # [B, H, Tq]
    shared_bias: Optional[torch.Tensor] = None,  # [H, Tq, Tk]
    force_impl: Optional[str] = None,  # 'oneshot' | 'flash' | 'plain'
) -> torch.Tensor:  # [B, H, Tq, hd]
    """Masked SDPA on [B, H, T, hd] through K7 or K6 (``pick_impl``)."""
    impl = pick_impl(k.shape[2], force_impl)
    if impl == "plain":
        return dot_product_attention_plain(q, k, v, key_mask=key_mask, scale=scale, gate=gate,
                                           shared_bias=shared_bias)
    kernel = attention_bhtd if impl == "oneshot" else flash_attention
    return kernel(q, k, v, key_mask=key_mask, scale=scale, gate=gate, pos_bias=shared_bias)


def dot_product_attention_plain(
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


# (start, stop, total) while a data-parallel rank runs rows [start, stop) of a
# global batch of ``total`` rows (``parallel.mesh.dropout_rows``); None on one device
ROW_SHARD: Optional[Tuple[int, int, int]] = None


@contextlib.contextmanager
def row_shard(start: int, stop: int, total: int):
    """Within the context ``dropout`` draws the mask of the global batch's
    ``total`` rows and keeps rows [start, stop) of it (rows past ``total``,
    the padding a rank holds, are kept whole), so that a data-parallel rank
    drops what the one-device run drops on its rows."""
    global ROW_SHARD
    prev, ROW_SHARD = ROW_SHARD, (start, stop, total)
    try:
        yield
    finally:
        ROW_SHARD = prev


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (keep with probability 1 - p, scale by 1 / (1 - p))
    with its mask drawn from ``generator``; the identity when p == 0. Dim 0
    is the batch: under ``row_shard`` the mask is the global batch's."""
    if p == 0.0:
        return x
    if ROW_SHARD is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    else:
        start, stop, total = ROW_SHARD
        assert x.shape[0] == stop - start, f"dropout on {x.shape[0]} rows under a row shard of {stop - start}"
        full = torch.rand((total,) + tuple(x.shape[1:]), generator=generator, device=x.device) >= p
        keep = torch.ones(x.shape, dtype=torch.bool, device=x.device)
        kept = max(0, min(stop, total) - start)
        keep[:kept] = full[start: start + kept]
    return x * keep.to(x.dtype) / (1.0 - p)
