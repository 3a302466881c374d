"""Lazy-fusion emotion classifier (bimodal / trimodal, optional neutral head)
and its legacy options.

Port of ``interspeech_ser_tpu/models/fusion.py::MultiModalEmotionClassifier``
with masked inputs. Module names are the reference's torch names, so a
``multimodal_ser.pt`` from the reference or from the JAX ``FusionEngine``
loads with ``strict``:

per modality  Linear(feat_dim -> H) -> LayerNorm -> BiGRU(H -> 2H)
-> cross-modal MultiheadAttention (residual sum over the other modalities)
-> softmax attention pooling -> concat -> LayerNorm -> Linear(-> H) -> ReLU
-> Dropout -> Linear(-> num_emotions) logits
[+ the ranking trainers' 1-logit ``neutral_classifier`` of the same shape].

The ``bin/old`` trainers' options, as in the JAX model:
- ``gender_head``: ``'grl'`` (gradient-reversed) or ``'aux'`` gender
  classifier on the fused representation (``fusion_variants.GenderAdversaryHead``);
- ``attention_heads``: the cross-attention head count (the legacy 4 and 8)
  instead of the reference's 1 (2 for the trimodal prosody attention);
- ``masked=False``: every mask dropped, padding included in the GRU, the
  attention and the pooling, as the reference's unmasked batches;
- ``gated_pool``: ``{mod}_gate`` Linear(2H -> 2H) and a sigmoid gate on each
  pooled representation (the ``fiona`` trainer);
- ``modality_norm=False``: no ``{mod}_norm`` (the gender SVM trainer).
The MoE and single-modality models are in ``fusion_variants.py``.

In training mode dropout (rate ``dropout``) acts on the attention weights
and after each head's ReLU, with masks drawn from the ``generator`` passed
to ``forward``. The heads keep ``nn.Sequential``'s numbering (``.0`` and
``.3``) for the checkpoint's key names; their dropout runs through that
generator rather than through the ``nn.Dropout`` at index 2.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from ..ops.attention import TorchMultiheadAttention, attention_pool
from ..ops.attention_core import dropout as drop
from ..ops.gru import BiGRU
from .convert import MODALITY_NAMES
from .fusion_variants import GenderAdversaryHead


def _head(d_in: int, hidden: int, d_out: int, dropout: float) -> nn.Sequential:
    return nn.Sequential(nn.Linear(d_in, hidden), nn.ReLU(), nn.Dropout(dropout), nn.Linear(hidden, d_out))


class MultiModalEmotionClassifier(nn.Module):
    def __init__(
        self,
        feat_dims: Sequence[int],
        fusion_hidden_dim: int = 512,
        num_emotions: int = 8,
        dropout: float = 0.5,
        neutral_head: bool = False,
        gender_head: Optional[str] = None,  # None | 'grl' | 'aux'
        attention_heads: Optional[int] = None,
        masked: bool = True,
        gated_pool: bool = False,
        modality_norm: bool = True,
    ):
        super().__init__()
        n_mod = len(feat_dims)
        assert n_mod in (2, 3)
        if gender_head not in (None, "grl", "aux"):
            raise ValueError(f"gender_head {gender_head!r}: None, 'grl' or 'aux'")
        H = fusion_hidden_dim
        self.names = MODALITY_NAMES[:n_mod]
        self.dropout = dropout
        self.masked = masked
        self.modality_norm = modality_norm
        self.gated_pool = gated_pool
        for name, d in zip(self.names, feat_dims):
            # reference head counts: 1, and 2 for the trimodal prosody attention
            heads = attention_heads or (2 if (n_mod == 3 and name == "prosody") else 1)
            self.add_module(f"{name}_projection", nn.Linear(d, H))
            if modality_norm:
                self.add_module(f"{name}_norm", nn.LayerNorm(H))
            self.add_module(f"{name}_gru", BiGRU(H, H))
            self.add_module(f"{name}_attention", TorchMultiheadAttention(2 * H, heads, dropout))
            self.add_module(f"{name}_attn", nn.Linear(2 * H, 1))
            if gated_pool:
                self.add_module(f"{name}_gate", nn.Linear(2 * H, 2 * H))
        self.layer_norm = nn.LayerNorm(2 * H * n_mod)
        self.classifier = _head(2 * H * n_mod, H, num_emotions, dropout)
        self.neutral_classifier = _head(2 * H * n_mod, H, 1, dropout) if neutral_head else None
        self.gender_classifier = None
        if gender_head is not None:
            self.gender_classifier = GenderAdversaryHead(2 * H * n_mod, H, use_grl=gender_head == "grl",
                                                         dropout=dropout)

    def _run_head(self, head: nn.Sequential, x: torch.Tensor, generator) -> torch.Tensor:
        h = torch.relu(head[0](x))
        return head[3](drop(h, self.dropout if self.training else 0.0, generator))

    def forward(
        self,
        feats: Sequence[torch.Tensor],  # per modality [B, T_m, D_m]
        masks: Optional[Sequence[torch.Tensor]] = None,  # per modality [B, T_m]
        output_dict: bool = False,
        generator: Optional[torch.Generator] = None,  # dropout masks (training mode)
    ) -> Union[torch.Tensor, Dict[str, Optional[torch.Tensor]]]:
        """Logits [B, num_emotions]; with ``output_dict`` a dict of ``logits``,
        ``neutral`` ([B, 1], or None without the neutral head), ``gender``
        ([B, 2], or None), ``pooled`` (per modality [B, 2H], after the gates)
        and ``fused`` (the normalised concatenation the heads read)."""
        n_mod = len(self.names)
        assert len(feats) == n_mod
        if masks is None or not self.masked:
            masks = [None] * n_mod
        hidden = []
        for name, x, m in zip(self.names, feats, masks):
            h = getattr(self, f"{name}_projection")(x)
            if self.modality_norm:
                h = getattr(self, f"{name}_norm")(h)
            hidden.append(getattr(self, f"{name}_gru")(h, m))
        pooled = []
        for i, name in enumerate(self.names):
            attn = getattr(self, f"{name}_attention")
            total = hidden[i]
            for j in range(n_mod):
                if j != i:
                    total = total + attn(hidden[i], hidden[j], hidden[j], key_mask=masks[j], generator=generator)
            pooled.append(attention_pool(total, getattr(self, f"{name}_attn")(total), masks[i]))
        if self.gated_pool:
            pooled = [p * torch.sigmoid(getattr(self, f"{name}_gate")(p)) for name, p in zip(self.names, pooled)]
        fused = self.layer_norm(torch.cat(pooled, dim=-1))
        logits = self._run_head(self.classifier, fused, generator)
        if not output_dict:
            return logits
        neutral = gender = None
        if self.neutral_classifier is not None:
            neutral = self._run_head(self.neutral_classifier, fused, generator)
        if self.gender_classifier is not None:
            gender = self.gender_classifier(fused, generator)
        return {"logits": logits, "neutral": neutral, "gender": gender, "pooled": pooled, "fused": fused}
