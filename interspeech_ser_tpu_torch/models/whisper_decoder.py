"""Whisper decoder and greedy transcription.

Port of ``interspeech_ser_tpu/models/whisper_decoder.py``: the standard
Whisper decoder (learned positions, pre-LN layers of causal self-attention,
cross-attention over the encoder's output and an exact-GELU FFN, ``k_proj``
without a bias, LayerNorms in f32, the f32 ``embed_tokens`` reused as the
tied f32 LM head) and two greedy decoders:

- :func:`greedy_decode` re-runs the whole causal forward for every token;
- :func:`greedy_decode_cached` casts the layer weights to the compute dtype
  once (LayerNorm parameters stay f32), projects each layer's cross K/V once,
  keeps the self-attention K/V in preallocated ``[L, B, H, P + N, hd]``
  caches and runs one single-token forward a step (:class:`CachedDecoder`).

Both run the fixed-length loop of the JAX ``scan`` (no early stop): prompt
positions only fill the cache, suppressed ids get ``NEG_INF``, a finished row
emits EOT, and the first maximum wins an argmax tie. Modules carry HF's
``WhisperDecoder`` key names, so its state dict loads as it is
(``models/loader.py`` strips the ``model.decoder.`` prefix).

Precision follows the JAX code: linear layers in the compute dtype,
attention scores and the weighted sum of the values accumulated and returned
in f32 (JAX's ``preferred_element_type=jnp.float32``), the softmax in f32 and
its weights rounded to the compute dtype. In bf16 a plain ``torch.matmul``
would round the scores to bf16, so :func:`_f32_product` asks cuBLAS for an
f32 output on the card (``torch.bmm(..., out_dtype=torch.float32)``) and
multiplies the operands upcast to f32 on the CPU, which is exact for bf16
inputs. The decoder reaches
no Pallas kernel in the JAX package and runs no hand-written kernel here.

Departure: a prompt plus ``max_new_tokens`` longer than
``max_target_positions`` raises ``ValueError``; the JAX cached decode
instead clamps the position index and reuses the last position.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .speech import _dense, _layer_norm

NEG_INF = -1e30  # the JAX package's ops/attention_core.NEG_INF


@dataclasses.dataclass(frozen=True)
class WhisperDecoderConfig:
    vocab_size: int = 51866
    d_model: int = 1280
    decoder_layers: int = 32
    decoder_attention_heads: int = 20
    decoder_ffn_dim: int = 5120
    max_target_positions: int = 448
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"  # compute dtype; parameters load in f32

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @classmethod
    def from_hf(cls, hf: Dict, dtype: str = "float32"):
        """Build from an HF Whisper ``config.json`` dict."""
        return cls(
            vocab_size=hf["vocab_size"],
            d_model=hf["d_model"],
            decoder_layers=hf["decoder_layers"],
            decoder_attention_heads=hf["decoder_attention_heads"],
            decoder_ffn_dim=hf["decoder_ffn_dim"],
            max_target_positions=hf["max_target_positions"],
            dtype=dtype,
        )

    def to_hf(self) -> Dict:
        """The ``config.json`` fields :meth:`from_hf` reads."""
        return {
            "vocab_size": self.vocab_size,
            "d_model": self.d_model,
            "decoder_layers": self.decoder_layers,
            "decoder_attention_heads": self.decoder_attention_heads,
            "decoder_ffn_dim": self.decoder_ffn_dim,
            "max_target_positions": self.max_target_positions,
        }


def whisper_large_v3_decoder(dtype: str = "float32") -> WhisperDecoderConfig:
    return WhisperDecoderConfig(dtype=dtype)


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over [..., m, k] x [..., k, n] with f32 accumulation and an
    f32 result, for f32 or bf16 operands of one dtype: on the card cuBLAS
    returns the bf16 product's f32 accumulator (``out_dtype``), on the CPU
    the bf16 operands are upcast, which is exact."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if not a.is_cuda:
        return torch.matmul(a.float(), b.float())
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    return torch.bmm(a3, b3, out_dtype=torch.float32).view(*lead, a.shape[-2], b.shape[-1])


def _attend(q, k, v, mask: Optional[torch.Tensor], dt: torch.dtype) -> torch.Tensor:
    """softmax(q k^T) v over [B, H, T, hd] heads (q already scaled); ``mask``
    (bool, broadcast over [B, H, Tq, Tk]) keeps the True scores."""
    s = _f32_product(q, k.transpose(-1, -2))
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1).to(dt)
    return _f32_product(w, v).to(dt)


class DecoderAttention(nn.Module):
    """Self-attention (causal) or cross-attention; ``k_proj`` has no bias."""

    def __init__(self, cfg: WhisperDecoderConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D, bias=False)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)

    def forward(self, x: torch.Tensor, kv: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        dt, H = cfg.compute_dtype, cfg.decoder_attention_heads
        B, Tq, D = x.shape
        hd = D // H
        heads = lambda t: t.view(B, t.shape[1], H, hd).transpose(1, 2)  # noqa: E731
        q = heads(_dense(x, self.q_proj, dt)) * hd ** -0.5
        k = heads(_dense(kv, self.k_proj, dt))
        v = heads(_dense(kv, self.v_proj, dt))
        out = _attend(q, k, v, mask, dt).transpose(1, 2).reshape(B, Tq, D)
        return _dense(out, self.out_proj, dt)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: WhisperDecoderConfig):
        super().__init__()
        self.cfg = cfg
        D, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = DecoderAttention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(D, eps=eps)
        self.encoder_attn = DecoderAttention(cfg)
        self.encoder_attn_layer_norm = nn.LayerNorm(D, eps=eps)
        self.fc1 = nn.Linear(D, cfg.decoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.decoder_ffn_dim, D)
        self.final_layer_norm = nn.LayerNorm(D, eps=eps)

    def forward(self, x: torch.Tensor, encoder_out: torch.Tensor, self_mask: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        h = _layer_norm(x, self.self_attn_layer_norm).to(dt)
        x = x + self.self_attn(h, h, self_mask)
        h = _layer_norm(x, self.encoder_attn_layer_norm).to(dt)
        x = x + self.encoder_attn(h, encoder_out, None)
        h = F.gelu(_dense(_layer_norm(x, self.final_layer_norm).to(dt), self.fc1, dt))
        return x + _dense(h, self.fc2, dt)


def check_length(cfg: WhisperDecoderConfig, total: int) -> None:
    if total > cfg.max_target_positions:
        raise ValueError(
            f"{total} decoder positions (prompt + max_new_tokens) exceed max_target_positions "
            f"{cfg.max_target_positions}"
        )


class WhisperDecoderModel(nn.Module):
    """Teacher-forced decoder forward: token ids [B, T] and the encoder's
    output [B, S, D] -> f32 logits [B, T, vocab]. ``position_offset`` shifts
    the learned positions; ``valid_len`` [B] hides the keys at and after it."""

    def __init__(self, config: WhisperDecoderConfig):
        super().__init__()
        self.config = config
        D = config.d_model
        self.embed_tokens = nn.Embedding(config.vocab_size, D)
        self.embed_positions = nn.Embedding(config.max_target_positions, D)
        self.layers = nn.ModuleList(DecoderLayer(config) for _ in range(config.decoder_layers))
        self.layer_norm = nn.LayerNorm(D, eps=config.layer_norm_eps)

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, T]
        encoder_out: torch.Tensor,  # [B, S, D]
        position_offset: int = 0,
        valid_len: Optional[torch.Tensor] = None,  # [B]
    ) -> torch.Tensor:
        cfg = self.config
        B, T = input_ids.shape
        check_length(cfg, position_offset + T)
        embed = self.embed_tokens.weight.float()
        pos = self.embed_positions.weight.float()[position_offset : position_offset + T]
        x = (embed[input_ids] + pos).to(cfg.compute_dtype)
        mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()[None, None]
        if valid_len is not None:
            keep = torch.arange(T, device=x.device)[None, :] < valid_len.to(x.device)[:, None]
            mask = mask & keep[:, None, None, :]
        for layer in self.layers:
            x = layer(x, encoder_out, mask)
        return _layer_norm(x, self.layer_norm) @ embed.T


def _suppress(logits: torch.Tensor, suppress: Optional[torch.Tensor]) -> torch.Tensor:
    return logits if suppress is None else logits.index_fill(1, suppress, NEG_INF)


def _start(encoder_out: torch.Tensor, prompt_ids: Sequence[int], eot_id: int, total: int):
    """(tokens [B, total] = the prompt then EOT, finished [B] all False)."""
    B, dev = encoder_out.shape[0], encoder_out.device
    tokens = torch.full((B, total), int(eot_id), dtype=torch.long, device=dev)
    tokens[:, : len(prompt_ids)] = torch.tensor([int(t) for t in prompt_ids], dtype=torch.long, device=dev)
    return tokens, torch.zeros(B, dtype=torch.bool, device=dev)


def _suppress_ids(suppress_ids, device) -> Optional[torch.Tensor]:
    if suppress_ids is None or len(suppress_ids) == 0:
        return None
    return torch.tensor([int(t) for t in suppress_ids], dtype=torch.long, device=device)


def _emit(tokens, finished, logits, i: int, eot_id: int) -> None:
    """Column ``i`` <- the argmax (first maximum), EOT once a row finished."""
    nxt = torch.where(finished, int(eot_id), logits.argmax(dim=-1))
    tokens[:, i] = nxt
    finished |= nxt == eot_id


@torch.no_grad()
def greedy_decode(
    decoder: WhisperDecoderModel,
    encoder_out: torch.Tensor,  # [B, S, D]
    prompt_ids: Sequence[int],  # [P] forced decoder start
    eot_id: int,
    max_new_tokens: int = 200,
    suppress_ids: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Greedy generation, the whole causal forward re-run for each token ->
    token ids [B, P + max_new_tokens] (int64)."""
    P = len(prompt_ids)
    total = P + max_new_tokens
    check_length(decoder.config, total)
    tokens, finished = _start(encoder_out, prompt_ids, eot_id, total)
    sup = _suppress_ids(suppress_ids, tokens.device)
    B = tokens.shape[0]
    for i in range(P, total):
        logits = decoder(tokens, encoder_out, valid_len=torch.full((B,), i, device=tokens.device))[:, i - 1]
        _emit(tokens, finished, _suppress(logits, sup), i, eot_id)
    return tokens


class CachedDecoder:
    """One batch's state for :func:`greedy_decode_cached`: the layer weights
    cast to the compute dtype once (LayerNorm parameters kept f32), each
    layer's cross K/V [B, H, S, hd] projected once, and the self-attention
    caches [L, B, H, total, hd]. :meth:`step` runs the single-token forward
    at one position."""

    def __init__(self, decoder: WhisperDecoderModel, encoder_out: torch.Tensor, total: int):
        cfg = decoder.config
        check_length(cfg, total)
        self.cfg, dt = cfg, cfg.compute_dtype
        self.H = cfg.decoder_attention_heads
        self.hd = cfg.d_model // self.H
        B = encoder_out.shape[0]
        cast = lambda t: None if t is None else t.detach().to(dt)  # noqa: E731
        f32 = lambda ln: (ln.weight.detach().float(), ln.bias.detach().float())  # noqa: E731
        self.layers: List[Dict] = []
        for layer in decoder.layers:
            p = {"ln1": f32(layer.self_attn_layer_norm), "ln2": f32(layer.encoder_attn_layer_norm),
                 "ln3": f32(layer.final_layer_norm)}
            for name, lin in (("q", layer.self_attn.q_proj), ("k", layer.self_attn.k_proj),
                              ("v", layer.self_attn.v_proj), ("o", layer.self_attn.out_proj),
                              ("cq", layer.encoder_attn.q_proj), ("co", layer.encoder_attn.out_proj),
                              ("fc1", layer.fc1), ("fc2", layer.fc2)):
                p[name] = (cast(lin.weight), cast(lin.bias))
            self.layers.append(p)
        self.embed = decoder.embed_tokens.weight.detach().float()
        self.pos = decoder.embed_positions.weight.detach().float()
        self.ln_f = f32(decoder.layer_norm)
        self.cross_kv = self.project_cross_kv(decoder, encoder_out)
        shape = (cfg.decoder_layers, B, self.H, total, self.hd)
        self.k_cache = torch.zeros(shape, dtype=dt, device=encoder_out.device)
        self.v_cache = torch.zeros(shape, dtype=dt, device=encoder_out.device)

    def project_cross_kv(self, decoder: WhisperDecoderModel, encoder_out: torch.Tensor) -> List[tuple]:
        dt = self.cfg.compute_dtype
        B, S, _ = encoder_out.shape
        enc = encoder_out.to(dt)
        heads = lambda t: t.view(B, S, self.H, self.hd).transpose(1, 2).contiguous()  # noqa: E731
        return [(heads(_dense(enc, layer.encoder_attn.k_proj, dt)), heads(_dense(enc, layer.encoder_attn.v_proj, dt)))
                for layer in decoder.layers]

    def _ln(self, x: torch.Tensor, wb) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), wb[0], wb[1], self.cfg.layer_norm_eps)

    def step(self, tok: torch.Tensor, idx: int, logits: bool = True) -> Optional[torch.Tensor]:
        """The token ids [B] at position ``idx`` -> next-token f32 logits
        [B, vocab] (None with ``logits=False``: a prompt position that only
        fills the caches)."""
        dt, H, hd = self.cfg.compute_dtype, self.H, self.hd
        B = tok.shape[0]
        D = H * hd
        lin = lambda x, wb: F.linear(x, wb[0], wb[1])  # noqa: E731
        heads = lambda t: t.view(B, H, 1, hd)  # noqa: E731  [B, 1, D] -> [B, H, 1, hd]
        x = (self.embed[tok] + self.pos[idx])[:, None, :].to(dt)  # [B, 1, D]
        for i, p in enumerate(self.layers):
            h = self._ln(x, p["ln1"]).to(dt)
            q = heads(lin(h, p["q"])) * hd ** -0.5
            self.k_cache[i, :, :, idx] = lin(h, p["k"]).view(B, H, hd)
            self.v_cache[i, :, :, idx] = lin(h, p["v"]).view(B, H, hd)
            o = _attend(q, self.k_cache[i, :, :, : idx + 1], self.v_cache[i, :, :, : idx + 1], None, dt)
            x = x + lin(o.reshape(B, 1, D), p["o"])
            h = self._ln(x, p["ln2"]).to(dt)
            q = heads(lin(h, p["cq"])) * hd ** -0.5
            ck, cv = self.cross_kv[i]
            x = x + lin(_attend(q, ck, cv, None, dt).reshape(B, 1, D), p["co"])
            h = F.gelu(lin(self._ln(x, p["ln3"]).to(dt), p["fc1"]))
            x = x + lin(h, p["fc2"])
        if not logits:
            return None
        return self._ln(x[:, 0], self.ln_f) @ self.embed.T


@torch.no_grad()
def greedy_decode_cached(
    decoder: WhisperDecoderModel,
    encoder_out: torch.Tensor,  # [B, S, D]
    prompt_ids: Sequence[int],  # [P] forced decoder start
    eot_id: int,
    max_new_tokens: int = 200,
    suppress_ids: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """KV-cached greedy generation: the tokens of :func:`greedy_decode`
    (up to rounding) -> token ids [B, P + max_new_tokens] (int64)."""
    P = len(prompt_ids)
    total = P + max_new_tokens
    state = CachedDecoder(decoder, encoder_out, total)
    tokens, finished = _start(encoder_out, prompt_ids, eot_id, total)
    sup = _suppress_ids(suppress_ids, tokens.device)
    for i in range(1, total):
        emit = i >= P
        logits = state.step(tokens[:, i - 1], i - 1, logits=emit)
        if emit:
            _emit(tokens, finished, _suppress(logits, sup), i, eot_id)
    return tokens
