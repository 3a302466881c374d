"""Lazy-fusion emotion classifier (bimodal / trimodal), inference.

Port of ``interspeech_ser_tpu/models/fusion.py::MultiModalEmotionClassifier``
for the scoring path: masked inputs, no gender, MoE, gated or neutral head.
Module names are the reference's torch names, so a ``multimodal_ser.pt``
from the reference or from the JAX ``FusionEngine`` loads with ``strict``:

per modality  Linear(feat_dim -> H) -> LayerNorm -> BiGRU(H -> 2H)
-> cross-modal MultiheadAttention (residual sum over the other modalities)
-> softmax attention pooling -> concat -> LayerNorm -> Linear(-> H) -> ReLU
-> Dropout -> Linear(-> num_emotions) logits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.attention import TorchMultiheadAttention, attention_pool
from ..ops.gru import BiGRU
from .convert import MODALITY_NAMES


class MultiModalEmotionClassifier(nn.Module):
    def __init__(
        self,
        feat_dims: Sequence[int],
        fusion_hidden_dim: int = 512,
        num_emotions: int = 8,
        dropout: float = 0.5,
    ):
        super().__init__()
        n_mod = len(feat_dims)
        assert n_mod in (2, 3)
        H = fusion_hidden_dim
        self.names = MODALITY_NAMES[:n_mod]
        for name, d in zip(self.names, feat_dims):
            # reference head counts: 1, and 2 for the trimodal prosody attention
            heads = 2 if (n_mod == 3 and name == "prosody") else 1
            self.add_module(f"{name}_projection", nn.Linear(d, H))
            self.add_module(f"{name}_norm", nn.LayerNorm(H))
            self.add_module(f"{name}_gru", BiGRU(H, H))
            self.add_module(f"{name}_attention", TorchMultiheadAttention(2 * H, heads))
            self.add_module(f"{name}_attn", nn.Linear(2 * H, 1))
        self.layer_norm = nn.LayerNorm(2 * H * n_mod)
        self.classifier = nn.Sequential(
            nn.Linear(2 * H * n_mod, H), nn.ReLU(), nn.Dropout(dropout), nn.Linear(H, num_emotions)
        )

    def forward(
        self,
        feats: Sequence[torch.Tensor],  # per modality [B, T_m, D_m]
        masks: Optional[Sequence[torch.Tensor]] = None,  # per modality [B, T_m]
    ) -> torch.Tensor:  # [B, num_emotions]
        n_mod = len(self.names)
        assert len(feats) == n_mod
        if masks is None:
            masks = [None] * n_mod
        hidden = []
        for name, x, m in zip(self.names, feats, masks):
            h = getattr(self, f"{name}_norm")(getattr(self, f"{name}_projection")(x))
            hidden.append(getattr(self, f"{name}_gru")(h, m))
        pooled = []
        for i, name in enumerate(self.names):
            attn = getattr(self, f"{name}_attention")
            total = hidden[i]
            for j in range(n_mod):
                if j != i:
                    total = total + attn(hidden[i], hidden[j], hidden[j], key_mask=masks[j])
            pooled.append(attention_pool(total, getattr(self, f"{name}_attn")(total), masks[i]))
        return self.classifier(self.layer_norm(torch.cat(pooled, dim=-1)))
