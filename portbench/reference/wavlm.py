"""WavLM (layer-norm frontend, stable layer norm) in plain float32 PyTorch.

A frozen copy of the plain path of the port's ``models/speech.py`` for one
unpadded utterance: the 7-layer conv frontend (conv, LayerNorm over
channels, exact GELU), the feature projection, the grouped positional conv
(SAME padding, the last frame dropped, GELU), pre-LN transformer layers with
WavLM's gated relative-position bias (T5 buckets, the embedding on layer 0),
the closing LayerNorm. ``cfg`` is the configuration file's dict, in the keys
of the model's HF ``config.json``; ``p`` maps HF state-dict names to tensors.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .common import Ops, layer_norm


def param_shapes(cfg: Dict) -> Dict[str, tuple]:
    """Every parameter the forward reads, by name, with its shape."""
    D, H, Fd = cfg["hidden_size"], cfg["num_attention_heads"], cfg["intermediate_size"]
    shapes = {}
    c_in = 1
    for i, (c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        pre = f"feature_extractor.conv_layers.{i}"
        shapes[f"{pre}.conv.weight"] = (c, c_in, k)
        shapes[f"{pre}.conv.bias"] = (c,)
        shapes[f"{pre}.layer_norm.weight"] = (c,)
        shapes[f"{pre}.layer_norm.bias"] = (c,)
        c_in = c
    shapes["feature_projection.layer_norm.weight"] = (c_in,)
    shapes["feature_projection.layer_norm.bias"] = (c_in,)
    shapes["feature_projection.projection.weight"] = (D, c_in)
    shapes["feature_projection.projection.bias"] = (D,)
    G, K = cfg["num_conv_pos_embedding_groups"], cfg["num_conv_pos_embeddings"]
    shapes["encoder.pos_conv_embed.conv.weight"] = (D, D // G, K)
    shapes["encoder.pos_conv_embed.conv.bias"] = (D,)
    shapes["encoder.layer_norm.weight"] = (D,)
    shapes["encoder.layer_norm.bias"] = (D,)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layers.{i}"
        shapes[f"{pre}.attention.gru_rel_pos_const"] = (1, H, 1, 1)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{pre}.attention.{name}.weight"] = (D, D)
            shapes[f"{pre}.attention.{name}.bias"] = (D,)
        shapes[f"{pre}.attention.gru_rel_pos_linear.weight"] = (8, D // H)
        shapes[f"{pre}.attention.gru_rel_pos_linear.bias"] = (8,)
        if i == 0:
            shapes[f"{pre}.attention.rel_attn_embed.weight"] = (cfg["num_buckets"], H)
        for ln in ("layer_norm", "final_layer_norm"):
            shapes[f"{pre}.{ln}.weight"] = (D,)
            shapes[f"{pre}.{ln}.bias"] = (D,)
        shapes[f"{pre}.feed_forward.intermediate_dense.weight"] = (Fd, D)
        shapes[f"{pre}.feed_forward.intermediate_dense.bias"] = (Fd,)
        shapes[f"{pre}.feed_forward.output_dense.weight"] = (D, Fd)
        shapes[f"{pre}.feed_forward.output_dense.bias"] = (D,)
    return shapes


def frame_count(n_samples: int, cfg: Dict) -> int:
    """Frames the conv frontend makes of ``n_samples`` samples."""
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n_samples = (n_samples - k) // s + 1
    return n_samples


def normalize(wav: np.ndarray) -> np.ndarray:
    """The feature extractor's zero-mean, unit-variance normalisation."""
    wav = wav.astype(np.float32)
    return ((wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)).astype(np.float32)


def relative_position_buckets(t: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """T5-style bidirectional buckets of (key - query), [t, t]."""
    relative = np.arange(t)[None, :] - np.arange(t)[:, None]
    nb = num_buckets // 2
    buckets = (relative > 0).astype(np.int64) * nb
    rel_abs = np.abs(relative)
    max_exact = nb // 2
    large = max_exact + (np.log(np.maximum(rel_abs, 1) / max_exact) / np.log(max_distance / max_exact)
                         * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(rel_abs < max_exact, rel_abs, large)


def forward(p: Dict[str, torch.Tensor], cfg: Dict, wav: torch.Tensor, ops: Ops) -> torch.Tensor:
    """wav [L] float32, already normalised -> the last hidden state [T, D]."""
    eps = cfg["layer_norm_eps"]
    x = wav[None, None, :]  # [1, 1, L]
    for i, s in enumerate(cfg["conv_stride"]):
        pre = f"feature_extractor.conv_layers.{i}"
        y = ops.conv1d(x, p[f"{pre}.conv.weight"], p[f"{pre}.conv.bias"], stride=s)
        y = layer_norm(y.transpose(1, 2), p[f"{pre}.layer_norm.weight"], p[f"{pre}.layer_norm.bias"], eps)
        x = F.gelu(y).transpose(1, 2)
    h = layer_norm(x.transpose(1, 2)[0], p["feature_projection.layer_norm.weight"],
                   p["feature_projection.layer_norm.bias"], eps)
    h = ops.linear(h, p["feature_projection.projection.weight"], p["feature_projection.projection.bias"])
    T, D = h.shape
    K = cfg["num_conv_pos_embeddings"]
    pos = ops.conv1d(h.t()[None], p["encoder.pos_conv_embed.conv.weight"], p["encoder.pos_conv_embed.conv.bias"],
                     padding=K // 2, groups=cfg["num_conv_pos_embedding_groups"])[0].t()
    if K % 2 == 0:
        pos = pos[:-1]
    h = h + F.gelu(pos)

    H = cfg["num_attention_heads"]
    hd = D // H
    buckets = torch.from_numpy(relative_position_buckets(T, cfg["num_buckets"], cfg["max_bucket_distance"]))
    bias = p["encoder.layers.0.attention.rel_attn_embed.weight"][buckets.to(h.device)].permute(2, 0, 1)  # [H, T, T]
    scale = 1.0 / math.sqrt(hd)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layers.{i}"
        a = layer_norm(h, p[f"{pre}.layer_norm.weight"], p[f"{pre}.layer_norm.bias"], eps)
        q, k, v = (ops.linear(a, p[f"{pre}.attention.{n}.weight"], p[f"{pre}.attention.{n}.bias"]).reshape(T, H, hd)
                   .transpose(0, 1) for n in ("q_proj", "k_proj", "v_proj"))
        g = ops.linear(a.reshape(T, H, hd).transpose(0, 1), p[f"{pre}.attention.gru_rel_pos_linear.weight"],
                       p[f"{pre}.attention.gru_rel_pos_linear.bias"])  # [H, T, 8]
        g = torch.sigmoid(g.reshape(H, T, 2, 4).sum(-1))
        const = p[f"{pre}.attention.gru_rel_pos_const"].reshape(H, 1)
        gate = g[..., 0] * (g[..., 1] * const - 1.0) + 2.0  # [H, T]
        scores = ops.matmul(q * scale, k.transpose(1, 2)) + gate[..., None] * bias
        o = ops.matmul(torch.softmax(scores, dim=-1), v).transpose(0, 1).reshape(T, D)
        h = h + ops.linear(o, p[f"{pre}.attention.out_proj.weight"], p[f"{pre}.attention.out_proj.bias"])
        f = layer_norm(h, p[f"{pre}.final_layer_norm.weight"], p[f"{pre}.final_layer_norm.bias"], eps)
        f = F.gelu(ops.linear(f, p[f"{pre}.feed_forward.intermediate_dense.weight"],
                              p[f"{pre}.feed_forward.intermediate_dense.bias"]))
        h = h + ops.linear(f, p[f"{pre}.feed_forward.output_dense.weight"], p[f"{pre}.feed_forward.output_dense.bias"])
    return layer_norm(h, p["encoder.layer_norm.weight"], p["encoder.layer_norm.bias"], eps)
