"""Whisper encoder (large-v3 and its narrower relatives).

Port of ``interspeech_ser_tpu/models/whisper.py``: log-mel [B, M, 3000] ->
conv1 (k3, s1) -> GELU -> conv2 (k3, s2) -> GELU -> + positions -> pre-LN
transformer layers (``k_proj`` has no bias) -> final LayerNorm. The log-mel
frontend is ``ops/mel.py``.

Modules carry HF's encoder key names (``conv1.weight``,
``embed_positions.weight``, ``layers.3.self_attn.q_proj.weight``,
``layer_norm.bias``, ...), so an HF ``WhisperEncoder`` state dict loads
as it is (``models/loader.py`` strips a ``model.encoder.`` or ``encoder.``
prefix and drops decoder keys).

Compute dtype: f32 for parity, bf16 for throughput. Linear and conv layers
run in the compute dtype, LayerNorms and the softmax in f32, GELU is exact
(erf) in both, as in the JAX package. Every attention goes through
``dot_product_attention_btd``: K1 on the card (K1 + K4 when a LoRA factor
needs its gradient), the plain version on the CPU or with ``plain=True``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_core import dot_product_attention_btd
from .speech import _dense, _layer_norm


@dataclasses.dataclass(frozen=True)
class WhisperEncoderConfig:
    num_mel_bins: int = 128
    d_model: int = 1280
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    max_source_positions: int = 1500
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"  # compute dtype; parameters load in f32

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @classmethod
    def from_hf(cls, hf: Dict, dtype: str = "float32"):
        """Build from an HF Whisper ``config.json`` dict."""
        return cls(
            num_mel_bins=hf["num_mel_bins"],
            d_model=hf["d_model"],
            encoder_layers=hf["encoder_layers"],
            encoder_attention_heads=hf["encoder_attention_heads"],
            encoder_ffn_dim=hf["encoder_ffn_dim"],
            max_source_positions=hf["max_source_positions"],
            dtype=dtype,
        )

    def to_hf(self) -> Dict:
        """The ``config.json`` fields :meth:`from_hf` and the loader read."""
        return {
            "model_type": "whisper",
            "num_mel_bins": self.num_mel_bins,
            "d_model": self.d_model,
            "encoder_layers": self.encoder_layers,
            "encoder_attention_heads": self.encoder_attention_heads,
            "encoder_ffn_dim": self.encoder_ffn_dim,
            "max_source_positions": self.max_source_positions,
        }


def whisper_large_v3(dtype: str = "float32") -> WhisperEncoderConfig:
    return WhisperEncoderConfig(dtype=dtype)


def sinusoidal_positions(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoid table (also the init of ``embed_positions``)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


class WhisperAttention(nn.Module):
    def __init__(self, cfg: WhisperEncoderConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D, bias=False)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        q = _dense(x, self.q_proj, dt)
        k = _dense(x, self.k_proj, dt)
        v = _dense(x, self.v_proj, dt)
        out = dot_product_attention_btd(q, k, v, self.cfg.encoder_attention_heads, plain=plain)
        return _dense(out, self.out_proj, dt)


class WhisperEncoderLayer(nn.Module):
    """Pre-LN transformer layer with an exact-GELU FFN."""

    def __init__(self, cfg: WhisperEncoderConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.self_attn = WhisperAttention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(D, cfg.encoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_dim, D)
        self.final_layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        x = x + self.self_attn(_layer_norm(x, self.self_attn_layer_norm).to(dt), plain)
        h = _dense(_layer_norm(x, self.final_layer_norm).to(dt), self.fc1, dt)
        return x + _dense(F.gelu(h), self.fc2, dt)


class WhisperEncoderModel(nn.Module):
    """mel [B, num_mel_bins, 2 * max_source_positions] -> hidden states.

    Returns ``hidden_states`` (encoder_layers + 1 entries: [0] the embedded
    input, [i] layer i-1's output, the last entry carrying the final
    LayerNorm) and ``last_hidden_state``. ``keep`` (indices, negatives
    allowed) limits which hidden states are kept; the others are ``None``.
    """

    def __init__(self, config: WhisperEncoderConfig):
        super().__init__()
        self.config = config
        D = config.d_model
        self.conv1 = nn.Conv1d(config.num_mel_bins, D, 3, padding=1)
        self.conv2 = nn.Conv1d(D, D, 3, stride=2, padding=1)
        self.embed_positions = nn.Embedding(config.max_source_positions, D)
        with torch.no_grad():
            self.embed_positions.weight.copy_(
                torch.from_numpy(sinusoidal_positions(config.max_source_positions, D))
            )
        self.layers = nn.ModuleList(WhisperEncoderLayer(config) for _ in range(config.encoder_layers))
        self.layer_norm = nn.LayerNorm(D, eps=config.layer_norm_eps)

    def forward(
        self,
        input_features: torch.Tensor,  # [B, M, T_mel]
        keep: Optional[Iterable[int]] = None,
        plain: bool = False,
    ) -> Dict:
        cfg = self.config
        dt = cfg.compute_dtype
        n = cfg.encoder_layers
        keep = set(range(n + 1)) if keep is None else {i % (n + 1) for i in keep}

        def conv(x, c, stride):
            return F.gelu(F.conv1d(x, c.weight.to(dt), c.bias.to(dt), stride=stride, padding=1))

        x = conv(conv(input_features.to(dt), self.conv1, 1), self.conv2, 2).transpose(1, 2)
        h = x + self.embed_positions.weight[: x.shape[1]].to(dt)[None]
        hidden: List[Optional[torch.Tensor]] = [h if 0 in keep else None]
        for i, layer in enumerate(self.layers):
            h = layer(h, plain)
            hidden.append(h if i + 1 in keep else None)
        h = _layer_norm(h, self.layer_norm).to(dt)
        hidden[-1] = h if n in keep else None
        return {"last_hidden_state": h, "hidden_states": hidden}
