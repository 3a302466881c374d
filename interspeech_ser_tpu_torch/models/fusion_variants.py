"""The legacy fusion-model variants of the ``bin/old`` trainers.

Port of ``interspeech_ser_tpu/models/fusion_variants.py``:
- ``MoEEmotionClassifier``: a softmax gate over the masked mean of the raw
  features picks a weighted sum of ``num_experts`` fusion experts' logits;
  an expert (``_ExpertModule``) is the bimodal fusion classifier with no
  modality LayerNorm and 8-head cross attention. Each expert runs its own
  BiGRU per modality, so on the card a forward launches K3 (and a backward
  K3b) experts x modalities times.
- ``GenderAdversaryHead``: optional gradient reversal, then Linear(H) ->
  ReLU -> dropout -> Linear(2) on the fused representation (the ``grl`` and
  ``aux`` gender heads of ``MultiModalEmotionClassifier``).
- ``SingleModalitySERClassifier``: the wavlm-only classifier: input dropout
  0.5 -> ``wav_proj`` -> self-attention with a residual and ``attn_norm`` ->
  a k=3 ``conv1d`` and ``conv_norm`` -> a 32-frame max-pool that drops the
  remainder -> the mean over time -> Linear -> ReLU -> dropout 0.2 ->
  Linear. Only the attention reads the mask: the conv, the pool and the
  mean see the padded frames, as in the reference.

Module names follow the flax modules', so a checkpoint in the JAX engine's
flat key layout maps onto them leaf by leaf (``convert.flax_key_to_port``).
Dropout masks come from the ``generator`` passed to ``forward`` (training
mode only).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.attention import TorchMultiheadAttention, attention_pool
from ..ops.attention_core import dropout as drop
from ..ops.grl import gradient_reversal
from ..ops.gru import BiGRU

EXPERT_MODALITIES = ("speech", "text")


class _ExpertModule(nn.Module):
    """One MoE expert: the bimodal fusion classifier without modality
    LayerNorms, with 8-head cross attention."""

    def __init__(self, feat_dims: Sequence[int], fusion_hidden_dim: int, num_emotions: int, dropout: float):
        super().__init__()
        H = fusion_hidden_dim
        self.dropout = dropout
        for name, d in zip(EXPERT_MODALITIES, feat_dims):
            self.add_module(f"{name}_projection", nn.Linear(d, H))
            self.add_module(f"{name}_gru", BiGRU(H, H))
            self.add_module(f"{name}_attention", TorchMultiheadAttention(2 * H, 8, dropout))
            self.add_module(f"{name}_pool_attn", nn.Linear(2 * H, 1))
        self.layer_norm = nn.LayerNorm(4 * H)
        self.classifier_fc1 = nn.Linear(4 * H, H)
        self.classifier_fc2 = nn.Linear(H, num_emotions)

    def forward(self, feats, masks, generator=None) -> torch.Tensor:
        names = EXPERT_MODALITIES
        hidden = [getattr(self, f"{n}_gru")(getattr(self, f"{n}_projection")(x), m)
                  for n, x, m in zip(names, feats, masks)]
        pooled = []
        for i, name in enumerate(names):
            j = 1 - i
            attended = getattr(self, f"{name}_attention")(hidden[i], hidden[j], hidden[j], key_mask=masks[j],
                                                          generator=generator)
            final = hidden[i] + attended
            pooled.append(attention_pool(final, getattr(self, f"{name}_pool_attn")(final), masks[i]))
        h = torch.relu(self.classifier_fc1(self.layer_norm(torch.cat(pooled, dim=-1))))
        return self.classifier_fc2(drop(h, self.dropout if self.training else 0.0, generator))


class MoEEmotionClassifier(nn.Module):
    """Softmax-gated mixture of fusion experts (``bin/old/train_cat_bimodal_lazy_moe.py``)."""

    def __init__(self, feat_dims: Sequence[int], fusion_hidden_dim: int = 512, num_emotions: int = 8,
                 num_experts: int = 4, dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.num_experts = num_experts
        self.gate_fc1 = nn.Linear(sum(feat_dims), fusion_hidden_dim)
        self.gate_fc2 = nn.Linear(fusion_hidden_dim, num_experts)
        for e in range(num_experts):
            self.add_module(f"expert{e}", _ExpertModule(feat_dims, fusion_hidden_dim, num_emotions, dropout))

    def forward(
        self,
        feats: Sequence[torch.Tensor],  # per modality [B, T_m, D_m]
        masks: Optional[Sequence[torch.Tensor]] = None,  # per modality [B, T_m]
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:  # [B, num_emotions]
        if masks is None:
            masks = [None] * len(feats)
        means = []
        for x, m in zip(feats, masks):
            if m is None:
                means.append(x.mean(dim=1))
            else:
                m = m[:, :, None].to(x.dtype)
                means.append((x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0))
        g = torch.relu(self.gate_fc1(torch.cat(means, dim=-1)))
        g = drop(g, self.dropout if self.training else 0.0, generator)
        gates = torch.softmax(self.gate_fc2(g), dim=-1)  # [B, E]
        outs = torch.stack([getattr(self, f"expert{e}")(feats, masks, generator) for e in range(self.num_experts)],
                           dim=1)  # [B, E, C]
        return (outs * gates[:, :, None]).sum(dim=1)


class GenderAdversaryHead(nn.Module):
    """Gradient reversal (``use_grl``), then an MLP gender classifier."""

    def __init__(self, in_dim: int, hidden_dim: int, use_grl: bool = True, lambda_reversal: float = 1.0,
                 dropout: float = 0.5):
        super().__init__()
        self.use_grl = use_grl
        self.lambda_reversal = lambda_reversal
        self.dropout = dropout
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, 2)

    def forward(self, fused: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = gradient_reversal(fused, self.lambda_reversal) if self.use_grl else fused
        h = torch.relu(self.fc1(h))
        return self.fc2(drop(h, self.dropout if self.training else 0.0, generator))


class SingleModalitySERClassifier(nn.Module):
    """The wavlm-only lazy classifier (``bin/old/train_cat_wavlm_lazy.py``)."""

    def __init__(self, feat_dim: int = 1024, hidden_dim: int = 512, num_categories: int = 8, num_heads: int = 4):
        super().__init__()
        self.wav_proj = nn.Linear(feat_dim, hidden_dim)
        self.multihead_attn = TorchMultiheadAttention(hidden_dim, num_heads, 0.5)
        self.attn_norm = nn.LayerNorm(hidden_dim)
        self.conv1d = nn.Conv1d(hidden_dim, hidden_dim, 3, padding=1)
        self.conv_norm = nn.LayerNorm(hidden_dim)
        self.classifier_fc1 = nn.Linear(hidden_dim, hidden_dim)
        self.classifier_fc2 = nn.Linear(hidden_dim, num_categories)

    def forward(
        self,
        feats: torch.Tensor,  # [B, T, feat_dim]
        mask: Optional[torch.Tensor] = None,  # [B, T], read by the attention only
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:  # [B, num_categories]
        h = self.wav_proj(drop(feats, 0.5 if self.training else 0.0, generator))
        h = self.attn_norm(self.multihead_attn(h, h, h, key_mask=mask, generator=generator) + h)
        c = self.conv_norm(self.conv1d(h.transpose(1, 2)).transpose(1, 2))
        B, T, C = c.shape
        if T // 32 > 0:  # MaxPool1d(32, 32) over time, the remainder dropped
            c = c[:, : (T // 32) * 32].reshape(B, T // 32, 32, C).amax(dim=2)
        h = torch.relu(self.classifier_fc1(c.mean(dim=1)))
        return self.classifier_fc2(drop(h, 0.2 if self.training else 0.0, generator))
