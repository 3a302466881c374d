"""Megatron tensor parallelism of the speech encoders over the model axis.

Port of ``interspeech_ser_tpu/extract/pipeline.py::_shard_encoder_params``
(the layout ``preprocess_cli --model_parallel`` asks for), for extraction:

- column-parallel: ``q_proj``, ``k_proj``, ``v_proj`` and
  ``intermediate_dense``, weights and biases: the rank keeps its rows of the
  [out, in] weights, whole heads (the output dim is head-major);
- row-parallel: ``out_proj`` and ``output_dense``: the rank keeps its
  columns of the weights; the bias stays whole and is added once, after the
  all-reduce of the partial products (``models/speech._row_parallel``);
- per-head extras cut to the rank's heads: WavLM's ``rel_attn_embed``
  [buckets, H] and ``gru_rel_pos_const`` [1, H, 1, 1]; ``gru_rel_pos_linear``
  (per head dim, shared by the heads) stays whole;
- everything else replicated: the conv frontend (K2), the positional conv
  (K8) and the LayerNorms.

Each rank's attention runs K1 over its ``H / mp`` heads at the unchanged head
dim, so two all-reduces a layer carry the model axis. The JAX package keeps
XLA under tensor parallelism (GSPMD cannot partition a Pallas call); here
every kernel call is local compute on the rank's shard, the same function,
so the port runs its kernels per rank (K5 stays off, as it does there).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

COLUMN = ("q_proj", "k_proj", "v_proj", "intermediate_dense")
ROW = ("out_proj", "output_dense")
PER_HEAD = ("rel_attn_embed.weight", "gru_rel_pos_const")  # head dim 1


def _chunk(t: torch.Tensor, dim: int, rank: int, mp: int) -> torch.Tensor:
    n = t.shape[dim]
    if n % mp:
        raise ValueError(f"dim {dim} of a {tuple(t.shape)} tensor does not split over {mp} model ranks")
    k = n // mp
    return t.narrow(dim, rank * k, k).contiguous().clone()


def shard_speech_state_dict(sd: Dict[str, torch.Tensor], rank: int, mp: int,
                            num_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The model rank ``rank``'s shard of a speech encoder's state dict (the
    port's key names) over ``mp`` model ranks. ``num_heads`` checks that the
    heads split evenly (``mp`` must divide H, or this raises)."""
    if num_heads is not None and num_heads % mp:
        raise ValueError(f"model_parallel={mp} does not divide the encoder's {num_heads} heads")
    out = {}
    for key, t in sd.items():
        parts = key.split(".")
        if len(parts) >= 2 and parts[-2] in COLUMN:
            out[key] = _chunk(t, 0, rank, mp)  # weight [out, in] rows / bias [out]
        elif len(parts) >= 2 and parts[-2] in ROW and parts[-1] == "weight":
            out[key] = _chunk(t, 1, rank, mp)  # weight [out, in] columns; the bias stays whole
        elif key.endswith(PER_HEAD):
            out[key] = _chunk(t, 1, rank, mp)  # [buckets, H] / [1, H, 1, 1]
        else:
            out[key] = t
    return out


def shard_speech_model(model, mesh):
    """A ``SpeechEncoderModel`` holding ``mesh``'s model rank's shard of
    ``model``'s parameters (copied), its attentions and feed-forwards
    summing over ``mesh``'s model axis. ``mesh.model == 1`` returns ``model``."""
    from ..models.speech import FeedForward, SpeechEncoderModel, SpeechSelfAttention

    if mesh.model == 1:
        return model
    cfg = dataclasses.replace(model.config, model_parallel=mesh.model)
    sd = shard_speech_state_dict(model.state_dict(), mesh.model_rank, mesh.model, num_heads=cfg.num_heads)
    with torch.device("meta"):
        out = SpeechEncoderModel(cfg)
    out.load_state_dict(sd, strict=True, assign=True)
    out.fused_frontend = model.fused_frontend
    for m in out.modules():
        if isinstance(m, (SpeechSelfAttention, FeedForward)):
            m.tp_mesh = mesh
    return out.train(model.training)
