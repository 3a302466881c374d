"""The joint RoBERTa + WavLM fine-tune heads (the ``bin/old/train_cat_roberta*`` family).

Port of ``interspeech_ser_tpu/models/joint.py``:

- ``ConvJointHead``: per modality Conv1d(k3, p1) -> ReLU -> Dropout ->
  Conv1d -> ReLU -> max pool over time, then concat -> [Linear, LayerNorm,
  ReLU, Dropout(0.2), Linear]; input dropout on both encoder outputs. The
  ftall script's variant: dropout 0.2, no input dropout, no LayerNorm.
- ``TransformerJointHead``: Dropout(0.5) -> Linear -> 2 post-LN 1-head
  ``TorchTransformerEncoderLayer``s (FFN 4H, dropout 0.5, ReLU) -> mean
  pool, per modality, then concat -> [Linear, ReLU, Dropout(0.2), Linear];
  ``gated`` adds per-modality sigmoid gates and returns ``(logits, wav_x,
  rob_x)``, the gated pooled features the CKA variants couple.
- ``RobertaClassificationHead``: HF's head of the text-only trainer (the
  ``<s>`` token -> dense -> tanh -> out_proj, dropout 0.1).

With ``masked=True`` (the default) the pools and the attention leave the
padding out and the conv head zeroes padded frames before each conv, so a
batched padded forward equals each row's unpadded batch-1 forward;
``masked=False`` is the reference's unmasked batched training. A fully
masked row (a padding row of a batch) max-pools to exactly 0, in the
forward and the backward, as in the JAX package.

Modules and parameters carry the reference's ``final_ser.pt`` names
(``wav_conv1.weight``, ``classifier.{0,1,4}.*``, ``wav_transformer.layers.0.
self_attn.in_proj_weight``, ``wav_gate.0.weight``, ...), so
``state_dict()`` is the file with no converter: the JAX package's
``conv_joint_flax_to_torch`` ... ``transformer_joint_torch_to_flax`` are here
checks of the key set that return f32 CPU copies. Moving a JAX head's
parameters across is ``models/convert.joint_params_from_flax`` /
``joint_params_to_flax``.

Dropout runs only when the caller passes the ``torch.Generator`` that draws
its masks (training); without one the heads are deterministic, whatever
their ``training`` flag.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import TorchMultiheadAttention
from ..ops.attention_core import NEG_INF, dropout


class TorchTransformerEncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer`` (post-LN, ReLU, batch_first) with
    a key mask: dropout in the attention, after it and twice in the FFN."""

    def __init__(self, d_model: int, nhead: int = 1, dim_feedforward: int = 2048, p: float = 0.5):
        super().__init__()
        self.self_attn = TorchMultiheadAttention(d_model, nhead, dropout=p)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.p = p

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p = self.p if generator is not None else 0.0
        self.self_attn.train(generator is not None)  # its weights' dropout follows the same rule
        h = self.self_attn(x, x, x, key_mask=key_mask, generator=generator)
        x = self.norm1(x + dropout(h, p, generator))
        h = dropout(F.relu(self.linear1(x)), p, generator)
        return self.norm2(x + dropout(self.linear2(h), p, generator))


class _Stack(nn.Module):
    """``nn.TransformerEncoder``'s key layout: ``layers.{i}``."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def masked_max_pool(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Max over time [B, T, D] -> [B, D], padding excluded when ``mask``
    ([B, T], 1 = valid) is given. A row with no valid frame pools to exactly
    0 and passes no gradient (-1e30 would overflow the next dense layer and
    poison the batch's shared gradients). ``amax`` splits a tie's gradient
    evenly, as JAX's max does."""
    if mask is None:
        return x.amax(dim=1)
    valid = mask > 0
    pooled = x.masked_fill(~valid[:, :, None], NEG_INF).amax(dim=1)
    return torch.where(valid.any(dim=1)[:, None], pooled, torch.zeros_like(pooled))


def masked_mean_pool(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the valid frames (a row with none: 0)."""
    if mask is None:
        return x.mean(dim=1)
    m = mask[:, :, None].to(x.dtype)
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)


class ConvJointHead(nn.Module):
    """The reference's ``MultimodalSERClassifier``, conv variant."""

    def __init__(self, wav_dim: int, txt_dim: int, hidden_dim: int = 512, num_categories: int = 8,
                 p: float = 0.5, input_dropout: bool = True, classifier_layernorm: bool = True,
                 masked: bool = True):
        super().__init__()
        H = hidden_dim
        self.wav_conv1 = nn.Conv1d(wav_dim, H, 3, padding=1)
        self.wav_conv2 = nn.Conv1d(H, H, 3, padding=1)
        self.rob_conv1 = nn.Conv1d(txt_dim, H, 3, padding=1)
        self.rob_conv2 = nn.Conv1d(H, H, 3, padding=1)
        layers = [nn.Linear(2 * H, H)] + ([nn.LayerNorm(H, eps=1e-5)] if classifier_layernorm else [])
        self.classifier = nn.Sequential(*layers, nn.ReLU(), nn.Dropout(0.2), nn.Linear(H, num_categories))
        self.p, self.input_dropout, self.masked = p, input_dropout, masked
        self.classifier_layernorm = classifier_layernorm

    def _branch(self, x, mask, conv1, conv2, generator):
        p = self.p if generator is not None else 0.0
        if self.input_dropout:
            x = dropout(x, p, generator)
        if mask is not None:  # encoder outputs are nonzero on padded frames: zero them for conv1's edge
            x = x * mask[:, :, None].to(x.dtype)
        x = dropout(F.relu(conv1(x.transpose(1, 2))).transpose(1, 2), p, generator)
        if mask is not None:  # and again for conv2's
            x = x * mask[:, :, None].to(x.dtype)
        return masked_max_pool(F.relu(conv2(x.transpose(1, 2))).transpose(1, 2), mask)

    def forward(self, wav_feats: torch.Tensor, txt_feats: torch.Tensor, wav_mask: Optional[torch.Tensor] = None,
                txt_mask: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.masked:
            wav_mask = txt_mask = None
        wav_x = self._branch(wav_feats, wav_mask, self.wav_conv1, self.wav_conv2, generator)
        rob_x = self._branch(txt_feats, txt_mask, self.rob_conv1, self.rob_conv2, generator)
        c = self.classifier
        h = c[0](torch.cat([wav_x, rob_x], dim=1))
        if self.classifier_layernorm:
            h = c[1](h)
        h = dropout(F.relu(h), 0.2 if generator is not None else 0.0, generator)
        return c[-1](h)


class TransformerJointHead(nn.Module):
    """The reference's ``MultimodalSERClassifier``, transformer variant
    (``gated``: the CKA scripts' sigmoid gates, and the gated pooled
    features returned beside the logits)."""

    def __init__(self, wav_dim: int, txt_dim: int, hidden_dim: int = 512, num_categories: int = 8,
                 num_layers: int = 2, gated: bool = False, masked: bool = True):
        super().__init__()
        H = hidden_dim
        for prefix, dim in (("wav", wav_dim), ("rob", txt_dim)):
            setattr(self, f"{prefix}_proj", nn.Linear(dim, H))
            setattr(self, f"{prefix}_transformer",
                    _Stack(TorchTransformerEncoderLayer(H, 1, 4 * H, 0.5) for _ in range(num_layers)))
            if gated:
                setattr(self, f"{prefix}_gate", nn.Sequential(nn.Linear(H, H), nn.Sigmoid()))
        self.classifier = nn.Sequential(nn.Linear(2 * H, H), nn.ReLU(), nn.Dropout(0.2), nn.Linear(H, num_categories))
        self.gated, self.masked, self.num_layers = gated, masked, num_layers

    def _branch(self, x, mask, prefix, generator):
        x = dropout(x, 0.5 if generator is not None else 0.0, generator)
        x = getattr(self, f"{prefix}_proj")(x)
        for layer in getattr(self, f"{prefix}_transformer").layers:
            x = layer(x, key_mask=mask, generator=generator)
        return masked_mean_pool(x, mask)

    def forward(self, wav_feats, txt_feats, wav_mask=None, txt_mask=None, generator=None):
        if not self.masked:
            wav_mask = txt_mask = None
        wav_x = self._branch(wav_feats, wav_mask, "wav", generator)
        rob_x = self._branch(txt_feats, txt_mask, "rob", generator)
        if self.gated:
            wav_x = wav_x * self.wav_gate(wav_x)
            rob_x = rob_x * self.rob_gate(rob_x)
        c = self.classifier
        h = dropout(F.relu(c[0](torch.cat([wav_x, rob_x], dim=1))), 0.2 if generator is not None else 0.0, generator)
        logits = c[-1](h)
        return (logits, wav_x, rob_x) if self.gated else logits


class RobertaClassificationHead(nn.Module):
    """HF ``RobertaClassificationHead``: the first token -> dropout -> dense
    -> tanh -> dropout -> out_proj."""

    def __init__(self, hidden_size: int, num_labels: int = 8, p: float = 0.1):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)
        self.out_proj = nn.Linear(hidden_size, num_labels)
        self.p = p

    def forward(self, hidden: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p = self.p if generator is not None else 0.0
        x = dropout(hidden[:, 0, :], p, generator)
        x = dropout(torch.tanh(self.dense(x)), p, generator)
        return self.out_proj(x)


# ---------------------------------------------------------------------------
# final_ser.pt: the heads' own state dicts, under the reference's names
# ---------------------------------------------------------------------------


def _checked(sd: Dict[str, torch.Tensor], head: nn.Module) -> Dict[str, torch.Tensor]:
    want = set(head.state_dict())
    if set(sd) != want:
        raise KeyError(f"final_ser.pt keys differ from the head's: missing {sorted(want - set(sd))}, "
                       f"unexpected {sorted(set(sd) - want)}")
    return {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in sd.items()}


def _conv_head(sd, classifier_layernorm: bool) -> ConvJointHead:
    w1, c2 = sd["wav_conv1.weight"], sd["wav_conv2.weight"]
    with torch.device("meta"):
        return ConvJointHead(w1.shape[1], sd["rob_conv1.weight"].shape[1], c2.shape[0],
                             classifier_layernorm=classifier_layernorm)


def _transformer_head(sd, num_layers: int, gated: bool) -> TransformerJointHead:
    w = sd["wav_proj.weight"]
    with torch.device("meta"):
        return TransformerJointHead(w.shape[1], sd["rob_proj.weight"].shape[1], w.shape[0],
                                    num_layers=num_layers, gated=gated)


def conv_joint_flax_to_torch(sd: Dict[str, torch.Tensor], classifier_layernorm: bool = True) -> Dict[str, torch.Tensor]:
    """A ``ConvJointHead`` state dict -> ``final_ser.pt`` (the same keys, f32 CPU copies)."""
    return _checked(sd, _conv_head(sd, classifier_layernorm))


def conv_joint_torch_to_flax(sd: Dict[str, torch.Tensor], classifier_layernorm: bool = True) -> Dict[str, torch.Tensor]:
    """``final_ser.pt`` -> a ``ConvJointHead`` state dict (the same keys)."""
    return _checked(sd, _conv_head(sd, classifier_layernorm))


def transformer_joint_flax_to_torch(sd: Dict[str, torch.Tensor], num_layers: int = 2,
                                    gated: bool = False) -> Dict[str, torch.Tensor]:
    """A ``TransformerJointHead`` state dict -> ``final_ser.pt``."""
    return _checked(sd, _transformer_head(sd, num_layers, gated))


def transformer_joint_torch_to_flax(sd: Dict[str, torch.Tensor], num_layers: int = 2,
                                    gated: bool = False) -> Dict[str, torch.Tensor]:
    """``final_ser.pt`` -> a ``TransformerJointHead`` state dict."""
    return _checked(sd, _transformer_head(sd, num_layers, gated))
