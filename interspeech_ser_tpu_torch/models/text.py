"""Text encoders: RoBERTa-large and DeBERTa-v2-xxlarge.

Port of ``interspeech_ser_tpu/models/text.py``. Both models take
``input_ids [B, T]`` and ``attention_mask [B, T]`` and return every hidden
state with HF's indexing (``hidden_states[0]`` the embeddings, ``[i]``
layer i-1's output), for the layer-select and mean-of-last-4 options of the
extraction pipeline.

- RoBERTa: a post-LN BERT stack with RoBERTa's padding-offset position ids
  (``cumsum(mask) * mask + pad_token_id``). Its self-attention goes through
  ``ops.attention_core.dot_product_attention`` on [B, H, T, hd] heads: K7
  (one-shot) on the card by default, K6 (streaming) with
  ``SER_TPU_ATTN_IMPL=flash``, the plain versions on the CPU;
  ``plain=True`` forces the plain attention (a reference run on the card).
- DeBERTa-v2: disentangled attention (content-to-position and
  position-to-content terms over log-bucketed relative positions, keys and
  queries of the relative embeddings through the layer's own projections),
  LayerNormed relative embeddings, and a conv branch over the embeddings
  added into layer 0's output. Its attention is plain ``matmul``s, as the
  JAX package left it to XLA: the c2p/p2c products are windowed to the
  bucket range the relative positions reach, and the select is a
  ``torch.gather`` on them (the JAX package's one-hot matmul was a TPU
  device for the same select).

Modules carry HF's key names (``embeddings.word_embeddings.weight``,
``encoder.layer.3.attention.self.query.weight``, ...), so an HF checkpoint
loads with a strict ``load_state_dict`` once its ``roberta.`` or
``deberta.`` prefix is stripped (``models/loader.py``).

Compute dtype: f32 for parity, bf16 for throughput. Linear layers and the
conv run in the compute dtype; LayerNorms and softmaxes in f32; GELU is
exact (erf).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_core import dot_product_attention
from .speech import _dense, _layer_norm


def _compute_dtype(dtype: str) -> torch.dtype:
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _keep_set(keep: Optional[Iterable[int]], n: int) -> set:
    return set(range(n + 1)) if keep is None else {i % (n + 1) for i in keep}


# ---------------------------------------------------------------------------
# RoBERTa
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"  # compute dtype; parameters load in f32

    @property
    def compute_dtype(self) -> torch.dtype:
        return _compute_dtype(self.dtype)

    @classmethod
    def from_hf(cls, hf: Dict, dtype: str = "float32") -> "RobertaConfig":
        """From an HF ``config.json`` dict; a missing key takes the default
        of transformers' ``RobertaConfig``."""
        return cls(
            vocab_size=hf.get("vocab_size", 50265), hidden_size=hf.get("hidden_size", 768),
            num_layers=hf.get("num_hidden_layers", 12), num_heads=hf.get("num_attention_heads", 12),
            intermediate_size=hf.get("intermediate_size", 3072),
            max_position_embeddings=hf.get("max_position_embeddings", 512),
            type_vocab_size=hf.get("type_vocab_size", 2), pad_token_id=hf.get("pad_token_id", 1),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-12), dtype=dtype,
        )

    def to_hf(self) -> Dict:
        """The ``config.json`` fields :meth:`from_hf` reads."""
        return {
            "model_type": "roberta", "vocab_size": self.vocab_size, "hidden_size": self.hidden_size,
            "num_hidden_layers": self.num_layers, "num_attention_heads": self.num_heads,
            "intermediate_size": self.intermediate_size, "hidden_act": "gelu",
            "max_position_embeddings": self.max_position_embeddings, "type_vocab_size": self.type_vocab_size,
            "pad_token_id": self.pad_token_id, "bos_token_id": 0, "eos_token_id": 2,
            "layer_norm_eps": self.layer_norm_eps,
        }


def roberta_large(dtype: str = "float32") -> RobertaConfig:
    return RobertaConfig(dtype=dtype)


class _Linears(nn.Module):
    """A named group of Linear layers (HF's ``attention.self`` and friends)."""

    def __init__(self, names, d_in: int, d_out: int):
        super().__init__()
        for n in names:
            setattr(self, n, nn.Linear(d_in, d_out))


class _DenseNorm(nn.Module):
    """HF's ``*.output``: a Linear and the post-LN after the residual add."""

    def __init__(self, d_in: int, d_out: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=eps)

    def forward(self, h: torch.Tensor, residual: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        return _layer_norm(residual + _dense(h, self.dense, dt), self.LayerNorm).to(dt)


class _Attention(nn.Module):
    def __init__(self, names, D: int, eps: float):
        super().__init__()
        self.self = _Linears(names, D, D)
        self.output = _DenseNorm(D, D, eps)


class _Intermediate(nn.Module):
    def __init__(self, D: int, F_: int):
        super().__init__()
        self.dense = nn.Linear(D, F_)


class _PostLNLayer(nn.Module):
    """HF's BERT layer after its self-attention: dense + residual -> LN ->
    exact-GELU FFN -> dense + residual -> LN. The model computes the
    self-attention (``attention.self`` holds its projections) and passes
    its [B, T, D] output in."""

    def __init__(self, names, D: int, F_: int, eps: float):
        super().__init__()
        self.attention = _Attention(names, D, eps)
        self.intermediate = _Intermediate(D, F_)
        self.output = _DenseNorm(F_, D, eps)

    def forward(self, x: torch.Tensor, attn_out: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        x = self.attention.output(attn_out, x, dt)
        h = F.gelu(_dense(x, self.intermediate.dense, dt))
        return self.output(h, x, dt)


class _Embeddings(nn.Module):
    def __init__(self, vocab: int, D: int, eps: float, max_pos: int = 0, type_vocab: int = 0):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab, D)
        if max_pos:
            self.position_embeddings = nn.Embedding(max_pos, D)
        if type_vocab:
            self.token_type_embeddings = nn.Embedding(type_vocab, D)
        self.LayerNorm = nn.LayerNorm(D, eps=eps)


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layer = nn.ModuleList(layers)


class RobertaModel(nn.Module):
    """input_ids [B, T] + attention_mask -> hidden states (post-LN BERT).

    ``keep`` (HF indices, negatives allowed) limits which hidden states are
    kept; the others are ``None``."""

    def __init__(self, config: RobertaConfig):
        super().__init__()
        self.config = config
        D = config.hidden_size
        self.embeddings = _Embeddings(config.vocab_size, D, config.layer_norm_eps,
                                      config.max_position_embeddings, config.type_vocab_size)
        self.encoder = _Encoder(
            _PostLNLayer(("query", "key", "value"), D, config.intermediate_size, config.layer_norm_eps)
            for _ in range(config.num_layers)
        )

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, T] int
        attention_mask: Optional[torch.Tensor] = None,  # [B, T], 1 = token
        keep: Optional[Iterable[int]] = None,
        plain: bool = False,
    ) -> Dict:
        cfg = self.config
        dt = cfg.compute_dtype
        B, T = input_ids.shape
        H = cfg.num_heads
        hd = cfg.hidden_size // H
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        keep = _keep_set(keep, cfg.num_layers)
        emb = self.embeddings
        # RoBERTa's padding-offset position ids (HF create_position_ids_from_input_ids)
        mask_i = (input_ids != cfg.pad_token_id).long()
        position_ids = torch.cumsum(mask_i, dim=1) * mask_i + cfg.pad_token_id
        h = (emb.word_embeddings.weight[input_ids] + emb.position_embeddings.weight[position_ids]
             + emb.token_type_embeddings.weight[0])
        h = _layer_norm(h, emb.LayerNorm).to(dt)

        def heads(t: torch.Tensor) -> torch.Tensor:  # [B, T, D] -> a [B, H, T, hd] view
            return t.view(B, T, H, hd).transpose(1, 2)

        hidden: List[Optional[torch.Tensor]] = [h if 0 in keep else None]
        for i, layer in enumerate(self.encoder.layer):
            lin = layer.attention.self
            q, k, v = (heads(_dense(h, getattr(lin, n), dt)) for n in ("query", "key", "value"))
            out = dot_product_attention(q, k, v, key_mask=attention_mask, force_impl="plain" if plain else None)
            h = layer(h, out.transpose(1, 2).reshape(B, T, cfg.hidden_size), dt)
            hidden.append(h if i + 1 in keep else None)
        return {"last_hidden_state": h, "hidden_states": hidden}


# ---------------------------------------------------------------------------
# DeBERTa-v2
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DebertaV2Config:
    vocab_size: int = 128100
    hidden_size: int = 1536
    num_layers: int = 48
    num_heads: int = 24
    intermediate_size: int = 6144
    max_position_embeddings: int = 512
    position_buckets: int = 256
    max_relative_positions: int = -1
    pad_token_id: int = 0
    conv_kernel_size: int = 3
    conv_act: str = "gelu"
    layer_norm_eps: float = 1e-7
    dtype: str = "float32"  # compute dtype; parameters load in f32

    @property
    def compute_dtype(self) -> torch.dtype:
        return _compute_dtype(self.dtype)

    @property
    def att_span(self) -> int:
        if self.position_buckets > 0:
            return self.position_buckets
        mrp = self.max_relative_positions
        return mrp if mrp > 0 else self.max_position_embeddings

    @classmethod
    def from_hf(cls, hf: Dict, dtype: str = "float32") -> "DebertaV2Config":
        """From an HF ``config.json`` dict (a missing key takes the default of
        transformers' ``DebertaV2Config``). Only the deberta-v2-xxlarge card's
        attention variant is implemented; any other would compute different
        math, so it is refused."""
        if not hf.get("share_att_key", False):
            raise NotImplementedError(
                "DebertaV2 port requires share_att_key=True (the v2/v3 card setting); "
                "separate pos_{key,query}_proj not implemented"
            )
        if hf.get("position_biased_input", True):
            raise NotImplementedError(
                "DebertaV2 port requires position_biased_input=False (the v2/v3 card setting)"
            )
        return cls(
            vocab_size=hf.get("vocab_size", 128000), hidden_size=hf.get("hidden_size", 1536),
            num_layers=hf.get("num_hidden_layers", 24), num_heads=hf.get("num_attention_heads", 24),
            intermediate_size=hf.get("intermediate_size", 6144),
            max_position_embeddings=hf.get("max_position_embeddings", 512),
            position_buckets=hf.get("position_buckets", -1),
            max_relative_positions=hf.get("max_relative_positions", -1),
            pad_token_id=hf.get("pad_token_id", 0), conv_kernel_size=hf.get("conv_kernel_size", 0),
            conv_act=hf.get("conv_act", "tanh"), layer_norm_eps=hf.get("layer_norm_eps", 1e-7), dtype=dtype,
        )

    def to_hf(self) -> Dict:
        """The ``config.json`` fields of the card's variant that :meth:`from_hf` reads."""
        return {
            "model_type": "deberta-v2", "vocab_size": self.vocab_size, "hidden_size": self.hidden_size,
            "num_hidden_layers": self.num_layers, "num_attention_heads": self.num_heads,
            "intermediate_size": self.intermediate_size, "hidden_act": "gelu",
            "max_position_embeddings": self.max_position_embeddings, "type_vocab_size": 0,
            "relative_attention": True, "position_buckets": self.position_buckets,
            "max_relative_positions": self.max_relative_positions, "norm_rel_ebd": "layer_norm",
            "share_att_key": True, "pos_att_type": ["p2c", "c2p"], "position_biased_input": False,
            "pad_token_id": self.pad_token_id, "conv_kernel_size": self.conv_kernel_size,
            "conv_act": self.conv_act, "layer_norm_eps": self.layer_norm_eps,
        }


def deberta_v2_xxlarge(dtype: str = "float32") -> DebertaV2Config:
    return DebertaV2Config(dtype=dtype)


def log_bucket_1d(rel: np.ndarray, bucket_size: int, max_position: int) -> np.ndarray:
    """HF ``make_log_bucket_position`` on an array of relative offsets."""
    if bucket_size <= 0 or max_position <= 0:
        return rel.astype(np.int64)
    sign = np.sign(rel)
    mid = bucket_size // 2
    abs_pos = np.where((rel < mid) & (rel > -mid), mid - 1, np.abs(rel))
    log_pos = np.ceil(np.log(abs_pos / mid) / np.log((max_position - 1) / mid) * (mid - 1)) + mid
    return np.where(abs_pos <= mid, rel, log_pos * sign).astype(np.int64)


def log_bucket_positions(t: int, bucket_size: int, max_position: int) -> np.ndarray:
    """Log-bucketed relative positions ``bucket(q - k)``, [t, t]."""
    rel = np.arange(t)[:, None] - np.arange(t)[None, :]
    return log_bucket_1d(rel, bucket_size, max_position)


def _windowed_select(x_of, idx: np.ndarray, device) -> torch.Tensor:
    """y[..., q, k] = x[..., q, idx[q, k]], with x computed by ``x_of(lo, hi)``
    only over the bucket window [lo, hi) that ``idx`` reaches."""
    lo, hi = int(idx.min()), int(idx.max()) + 1
    x = x_of(lo, hi)  # [..., Q, hi - lo]
    index = torch.from_numpy(idx - lo).to(device).expand(*x.shape[:-2], *idx.shape)
    return torch.gather(x, -1, index)


class DebertaV2Model(nn.Module):
    """input_ids [B, T] + attention_mask -> hidden states. ``keep`` as in
    :class:`RobertaModel`."""

    def __init__(self, config: DebertaV2Config):
        super().__init__()
        self.config = config
        D = config.hidden_size
        eps = config.layer_norm_eps
        self.embeddings = _Embeddings(config.vocab_size, D, eps)
        self.encoder = _Encoder(
            _PostLNLayer(("query_proj", "key_proj", "value_proj"), D, config.intermediate_size, eps)
            for _ in range(config.num_layers)
        )
        self.encoder.rel_embeddings = nn.Embedding(2 * config.att_span, D)
        self.encoder.LayerNorm = nn.LayerNorm(D, eps=eps)
        if config.conv_kernel_size > 0:
            self.encoder.conv = nn.Module()
            k = config.conv_kernel_size
            self.encoder.conv.conv = nn.Conv1d(D, D, k, padding=(k - 1) // 2)
            self.encoder.conv.LayerNorm = nn.LayerNorm(D, eps=eps)

    def _attention(self, lin, x: torch.Tensor, pair_mask: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
        """Disentangled self-attention (content + c2p + p2c) -> [B, T, D]."""
        cfg = self.config
        dt = cfg.compute_dtype
        B, T, D = x.shape
        H = cfg.num_heads
        hd = D // H

        def heads(t: torch.Tensor, n: int) -> torch.Tensor:
            return t.view(B, n, H, hd).transpose(1, 2)

        q = heads(_dense(x, lin.query_proj, dt), T)
        k = heads(_dense(x, lin.key_proj, dt), T)
        v = heads(_dense(x, lin.value_proj, dt), T)
        scale = float(np.sqrt(hd * 3))  # content + c2p + p2c
        scores = q.float() @ (k / scale).float().transpose(-1, -2)  # [B, H, T, T] f32

        span = cfg.att_span
        mrp = cfg.max_relative_positions if cfg.max_relative_positions >= 1 else cfg.max_position_embeddings
        rel_pos = log_bucket_positions(T, cfg.position_buckets, mrp)
        # relative embeddings through the layer's own key / query projections
        pos_k = _dense(rel, lin.key_proj, dt).view(2 * span, H, hd).transpose(0, 1)  # [H, 2S, hd]
        pos_q = _dense(rel, lin.query_proj, dt).view(2 * span, H, hd).transpose(0, 1)
        # c2p: score[q, k] += q . pos_k[bucket(q - k) + S]
        c2p = _windowed_select(lambda lo, hi: q.float() @ pos_k[:, lo:hi].float().transpose(-1, -2),
                               np.clip(rel_pos + span, 0, 2 * span - 1), x.device)
        # p2c: score[q, k] += k . pos_q[S - bucket(k - q)]   (gathered as [k, q])
        p2c = _windowed_select(lambda lo, hi: k.float() @ pos_q[:, lo:hi].float().transpose(-1, -2),
                               np.clip(-rel_pos + span, 0, 2 * span - 1), x.device)
        scores = scores + c2p / scale + p2c.transpose(-1, -2) / scale
        scores = scores.masked_fill(~pair_mask[:, None], torch.finfo(torch.float32).min)
        weights = torch.softmax(scores, dim=-1).to(dt)
        out = (weights.float() @ v.float()).to(dt)
        return out.transpose(1, 2).reshape(B, T, D)

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, T] int
        attention_mask: Optional[torch.Tensor] = None,  # [B, T], 1 = token
        keep: Optional[Iterable[int]] = None,
    ) -> Dict:
        cfg = self.config
        dt = cfg.compute_dtype
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        keep = _keep_set(keep, cfg.num_layers)
        mask_f = attention_mask.float()[:, :, None]  # [B, T, 1]
        h = _layer_norm(self.embeddings.word_embeddings.weight[input_ids], self.embeddings.LayerNorm)
        h = (h * mask_f).to(dt)
        pair_mask = (mask_f * mask_f.transpose(1, 2)) > 0  # [B, T, T]
        enc = self.encoder
        rel = _layer_norm(enc.rel_embeddings.weight, enc.LayerNorm)[: 2 * cfg.att_span].to(dt)

        embedded = h
        hidden: List[Optional[torch.Tensor]] = [h if 0 in keep else None]
        for i, layer in enumerate(enc.layer):
            h = layer(h, self._attention(layer.attention.self, h, pair_mask, rel), dt)
            if i == 0 and cfg.conv_kernel_size > 0:
                # conv branch over the embeddings, residual into layer 0's output
                conv = enc.conv.conv
                c = F.conv1d(embedded.transpose(1, 2), conv.weight.to(dt), conv.bias.to(dt),
                             padding=conv.padding).transpose(1, 2)
                c = c * mask_f.to(dt)
                c = F.gelu(c) if cfg.conv_act == "gelu" else torch.tanh(c)
                h = _layer_norm(h + c, enc.conv.LayerNorm).to(dt) * mask_f.to(dt)
            hidden.append(h if i + 1 in keep else None)
        return {"last_hidden_state": h, "hidden_states": hidden}
