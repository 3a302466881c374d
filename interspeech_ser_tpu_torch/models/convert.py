"""Weights carried across from the JAX package: flax-layout numpy -> torch.

Neither function needs jax: they take the JAX package's param trees as
nested dicts of numpy arrays and return the port's state dicts.

- :func:`speech_params_from_flax` mirrors ``speech_flax_to_hf``
  (interspeech_ser_tpu/models/convert_hf.py) and yields HF key names, with
  the positional conv kept as one plain (folded) ``weight``: layer-norm and
  group-norm frontends, with or without conv biases.
- :func:`whisper_params_from_flax` mirrors ``whisper_encoder_hf_to_flax``
  in reverse and yields HF Whisper-encoder key names.
- :func:`whisper_decoder_params_from_flax` mirrors ``whisper_decoder_hf_to_flax``
  in reverse and yields HF Whisper-decoder key names.
- :func:`roberta_params_from_flax` and :func:`deberta_v2_params_from_flax`
  mirror ``roberta_hf_to_flax`` and ``deberta_v2_hf_to_flax`` in reverse
  and yield HF RobertaModel / DebertaV2Model key names (no prefix).
- :func:`fusion_params_from_flax` mirrors ``convert_fusion.flax_to_torch``
  and yields the reference's ``multimodal_ser.pt`` names.
- :func:`ns3_params_from_flax` takes the JAX ``ProsodyExtractor``'s param
  dict and yields the port's ``ProsodyExtractor`` state dict (its pieces:
  :func:`ns3_transformer_params_from_flax`, :func:`facodec_encoder_params_from_flax`).
- :func:`baseline_params_from_flax` mirrors ``pooling_flax_to_torch`` and
  ``ser_flax_to_torch`` (interspeech_ser_tpu/baseline/models.py) and yields
  the challenge baseline's ``final_pool.pt`` / ``final_ser.pt`` names.

Layouts: a flax Dense kernel [in, out] is a torch Linear weight [out, in];
a flax Conv kernel [k, in/g, out] is a torch Conv1d weight [out, in/g, k].
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

MODALITY_NAMES = ("speech", "text", "prosody")


def _get(params: Dict, *path) -> np.ndarray:
    node = params
    for k in path:
        node = node[k]
    return np.asarray(node)


def _t(x: np.ndarray) -> np.ndarray:  # Dense kernel [in, out] -> Linear weight [out, in]
    return x.T


def _unconv(x: np.ndarray) -> np.ndarray:  # [k, in/g, out] -> [out, in/g, k]
    return np.transpose(x, (2, 1, 0))


def _to_torch(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()}  # copies


def speech_params_from_flax(params: Dict, config) -> Dict[str, torch.Tensor]:
    """JAX ``SpeechEncoderModel`` params -> the port's (HF-named) state dict."""
    g = lambda *p: _get(params, *p)  # noqa: E731
    sd: Dict[str, np.ndarray] = {}
    for i in range(len(config.conv_dim)):
        base = f"feature_extractor.conv_layers.{i}"
        sd[f"{base}.conv.weight"] = _unconv(g("feature_extractor", f"conv{i}", "kernel"))
        if config.conv_bias:
            sd[f"{base}.conv.bias"] = g("feature_extractor", f"conv{i}", "bias")
        if config.feat_extract_norm == "layer":
            sd[f"{base}.layer_norm.weight"] = g("feature_extractor", f"conv_ln{i}", "scale")
            sd[f"{base}.layer_norm.bias"] = g("feature_extractor", f"conv_ln{i}", "bias")
        elif i == 0:  # group mode: one GroupNorm, on layer 0 (named layer_norm in HF)
            sd[f"{base}.layer_norm.weight"] = g("feature_extractor", "group_norm", "scale")
            sd[f"{base}.layer_norm.bias"] = g("feature_extractor", "group_norm", "bias")
    sd["feature_projection.layer_norm.weight"] = g("fp_layer_norm", "scale")
    sd["feature_projection.layer_norm.bias"] = g("fp_layer_norm", "bias")
    sd["feature_projection.projection.weight"] = _t(g("fp_projection", "kernel"))
    sd["feature_projection.projection.bias"] = g("fp_projection", "bias")
    sd["encoder.pos_conv_embed.conv.weight"] = _unconv(g("pos_conv_embed", "conv", "kernel"))
    sd["encoder.pos_conv_embed.conv.bias"] = g("pos_conv_embed", "conv", "bias")
    sd["encoder.layer_norm.weight"] = g("encoder_layer_norm", "scale")
    sd["encoder.layer_norm.bias"] = g("encoder_layer_norm", "bias")
    for i in range(config.num_layers):
        base, src = f"encoder.layers.{i}", f"layer{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{base}.attention.{proj}.weight"] = _t(g(src, "attention", proj, "kernel"))
            sd[f"{base}.attention.{proj}.bias"] = g(src, "attention", proj, "bias")
        if config.attention_type == "wavlm":
            sd[f"{base}.attention.gru_rel_pos_linear.weight"] = _t(
                g(src, "attention", "gru_rel_pos_linear", "kernel")
            )
            sd[f"{base}.attention.gru_rel_pos_linear.bias"] = g(
                src, "attention", "gru_rel_pos_linear", "bias"
            )
            sd[f"{base}.attention.gru_rel_pos_const"] = g(src, "attention", "gru_rel_pos_const")
            if i == 0:
                sd[f"{base}.attention.rel_attn_embed.weight"] = g(src, "attention", "rel_attn_embed")
        for ln in ("layer_norm", "final_layer_norm"):
            sd[f"{base}.{ln}.weight"] = g(src, ln, "scale")
            sd[f"{base}.{ln}.bias"] = g(src, ln, "bias")
        for dense in ("intermediate_dense", "output_dense"):
            sd[f"{base}.feed_forward.{dense}.weight"] = _t(g(src, "feed_forward", dense, "kernel"))
            sd[f"{base}.feed_forward.{dense}.bias"] = g(src, "feed_forward", dense, "bias")
    return _to_torch(sd)


def whisper_params_from_flax(params: Dict, config) -> Dict[str, torch.Tensor]:
    """JAX ``WhisperEncoderModel`` params -> the port's (HF-named) state dict."""
    g = lambda *p: _get(params, *p)  # noqa: E731
    sd: Dict[str, np.ndarray] = {}
    for conv in ("conv1", "conv2"):
        sd[f"{conv}.weight"] = _unconv(g(conv, "kernel"))
        sd[f"{conv}.bias"] = g(conv, "bias")
    sd["embed_positions.weight"] = g("embed_positions")
    sd["layer_norm.weight"] = g("layer_norm", "scale")
    sd["layer_norm.bias"] = g("layer_norm", "bias")
    for i in range(config.encoder_layers):
        base, src = f"layers.{i}", f"layer{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{base}.self_attn.{proj}.weight"] = _t(g(src, "self_attn", proj, "kernel"))
            if proj != "k_proj":
                sd[f"{base}.self_attn.{proj}.bias"] = g(src, "self_attn", proj, "bias")
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{base}.{ln}.weight"] = g(src, ln, "scale")
            sd[f"{base}.{ln}.bias"] = g(src, ln, "bias")
        for fc in ("fc1", "fc2"):
            sd[f"{base}.{fc}.weight"] = _t(g(src, fc, "kernel"))
            sd[f"{base}.{fc}.bias"] = g(src, fc, "bias")
    return _to_torch(sd)


def whisper_decoder_params_from_flax(params: Dict, config) -> Dict[str, torch.Tensor]:
    """JAX ``WhisperDecoderModel`` params -> the port's (HF-named) state dict."""
    g = lambda *p: _get(params, *p)  # noqa: E731
    sd: Dict[str, np.ndarray] = {
        "embed_tokens.weight": g("embed_tokens"),
        "embed_positions.weight": g("embed_positions"),
        "layer_norm.weight": g("layer_norm", "scale"),
        "layer_norm.bias": g("layer_norm", "bias"),
    }
    for i in range(config.decoder_layers):
        base, src = f"layers.{i}", f"layer{i}"
        for attn in ("self_attn", "encoder_attn"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"{base}.{attn}.{proj}.weight"] = _t(g(src, attn, proj, "kernel"))
                if proj != "k_proj":
                    sd[f"{base}.{attn}.{proj}.bias"] = g(src, attn, proj, "bias")
        for ln in ("self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm"):
            sd[f"{base}.{ln}.weight"] = g(src, ln, "scale")
            sd[f"{base}.{ln}.bias"] = g(src, ln, "bias")
        for fc in ("fc1", "fc2"):
            sd[f"{base}.{fc}.weight"] = _t(g(src, fc, "kernel"))
            sd[f"{base}.{fc}.bias"] = g(src, fc, "bias")
    return _to_torch(sd)


def _post_ln_layers(sd: Dict[str, np.ndarray], g, n_layers: int, projections) -> None:
    """The BERT-layer keys shared by RoBERTa and DeBERTa-v2."""
    for i in range(n_layers):
        base, src = f"encoder.layer.{i}", f"layer{i}"
        for proj in projections:
            sd[f"{base}.attention.self.{proj}.weight"] = _t(g(src, "self", proj, "kernel"))
            sd[f"{base}.attention.self.{proj}.bias"] = g(src, "self", proj, "bias")
        for dst, name in (("attention.output.dense", "attn_output"), ("intermediate.dense", "intermediate"),
                          ("output.dense", "output")):
            sd[f"{base}.{dst}.weight"] = _t(g(src, name, "kernel"))
            sd[f"{base}.{dst}.bias"] = g(src, name, "bias")
        for dst, name in (("attention.output.LayerNorm", "attn_layer_norm"), ("output.LayerNorm", "output_layer_norm")):
            sd[f"{base}.{dst}.weight"] = g(src, name, "scale")
            sd[f"{base}.{dst}.bias"] = g(src, name, "bias")


def roberta_params_from_flax(params: Dict, config) -> Dict[str, torch.Tensor]:
    """JAX ``RobertaModel`` params -> the port's (HF-named) state dict."""
    g = lambda *p: _get(params, *p)  # noqa: E731
    sd: Dict[str, np.ndarray] = {
        "embeddings.word_embeddings.weight": g("word_embeddings"),
        "embeddings.position_embeddings.weight": g("position_embeddings"),
        "embeddings.token_type_embeddings.weight": g("token_type_embeddings"),
        "embeddings.LayerNorm.weight": g("emb_layer_norm", "scale"),
        "embeddings.LayerNorm.bias": g("emb_layer_norm", "bias"),
    }
    _post_ln_layers(sd, g, config.num_layers, ("query", "key", "value"))
    return _to_torch(sd)


def deberta_v2_params_from_flax(params: Dict, config) -> Dict[str, torch.Tensor]:
    """JAX ``DebertaV2Model`` params -> the port's (HF-named) state dict."""
    g = lambda *p: _get(params, *p)  # noqa: E731
    sd: Dict[str, np.ndarray] = {
        "embeddings.word_embeddings.weight": g("word_embeddings"),
        "embeddings.LayerNorm.weight": g("emb_layer_norm", "scale"),
        "embeddings.LayerNorm.bias": g("emb_layer_norm", "bias"),
        "encoder.rel_embeddings.weight": g("rel_embeddings"),
        "encoder.LayerNorm.weight": g("rel_emb_layer_norm", "scale"),
        "encoder.LayerNorm.bias": g("rel_emb_layer_norm", "bias"),
    }
    if config.conv_kernel_size > 0:
        sd["encoder.conv.conv.weight"] = _unconv(g("conv", "kernel"))
        sd["encoder.conv.conv.bias"] = g("conv", "bias")
        sd["encoder.conv.LayerNorm.weight"] = g("conv_layer_norm", "scale")
        sd["encoder.conv.LayerNorm.bias"] = g("conv_layer_norm", "bias")
    _post_ln_layers(sd, g, config.num_layers, ("query_proj", "key_proj", "value_proj"))
    return _to_torch(sd)


def fusion_params_from_flax(params: Dict, n_mod: int) -> Dict[str, torch.Tensor]:
    """JAX ``MultiModalEmotionClassifier`` params -> reference torch names."""
    g = lambda *p: _get(params, *p)  # noqa: E731
    sd: Dict[str, np.ndarray] = {}
    for mod in MODALITY_NAMES[:n_mod]:
        enc = f"{mod}_encoder"
        sd[f"{mod}_projection.weight"] = _t(g(enc, "projection", "kernel"))
        sd[f"{mod}_projection.bias"] = g(enc, "projection", "bias")
        sd[f"{mod}_norm.weight"] = g(enc, "norm", "scale")
        sd[f"{mod}_norm.bias"] = g(enc, "norm", "bias")
        for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
            sd[f"{mod}_gru.weight_ih_l0{sfx}"] = _t(g(enc, "gru", f"w_ih_{d}"))
            sd[f"{mod}_gru.weight_hh_l0{sfx}"] = _t(g(enc, "gru", f"w_hh_{d}"))
            sd[f"{mod}_gru.bias_ih_l0{sfx}"] = g(enc, "gru", f"b_ih_{d}")
            sd[f"{mod}_gru.bias_hh_l0{sfx}"] = g(enc, "gru", f"b_hh_{d}")
        att = f"{mod}_attention"
        sd[f"{att}.in_proj_weight"] = _t(g(att, "in_proj_kernel"))
        sd[f"{att}.in_proj_bias"] = g(att, "in_proj_bias")
        sd[f"{att}.out_proj.weight"] = _t(g(att, "out_kernel"))
        sd[f"{att}.out_proj.bias"] = g(att, "out_bias")
        sd[f"{mod}_attn.weight"] = _t(g(f"{mod}_pool_attn", "kernel"))
        sd[f"{mod}_attn.bias"] = g(f"{mod}_pool_attn", "bias")
    sd["layer_norm.weight"] = g("fusion_norm", "scale")
    sd["layer_norm.bias"] = g("fusion_norm", "bias")
    sd["classifier.0.weight"] = _t(g("classifier_fc1", "kernel"))
    sd["classifier.0.bias"] = g("classifier_fc1", "bias")
    sd["classifier.3.weight"] = _t(g("classifier_fc2", "kernel"))
    sd["classifier.3.bias"] = g("classifier_fc2", "bias")
    if "neutral_fc1" in params:  # the ranking trainers' neutral head
        sd["neutral_classifier.0.weight"] = _t(g("neutral_fc1", "kernel"))
        sd["neutral_classifier.0.bias"] = g("neutral_fc1", "bias")
        sd["neutral_classifier.3.weight"] = _t(g("neutral_fc2", "kernel"))
        sd["neutral_classifier.3.bias"] = g("neutral_fc2", "bias")
    return _to_torch(sd)


def ns3_transformer_params_from_flax(params: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``NS3TransformerEncoder`` params -> the port's (reference-named) state dict."""
    g = lambda *p: _get(params, *p)  # noqa: E731
    sd: Dict[str, np.ndarray] = {}
    n_layers = sum(1 for k in params if k.startswith("layer"))
    for i in range(n_layers):
        base, src = f"{prefix}layers.{i}", f"layer{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{base}.{ln}.weight"] = g(src, ln, "scale")
            sd[f"{base}.{ln}.bias"] = g(src, ln, "bias")
        sd[f"{base}.self_attn.in_proj_weight"] = _t(g(src, "self_attn", "in_proj_kernel"))
        sd[f"{base}.self_attn.in_proj_bias"] = g(src, "self_attn", "in_proj_bias")
        sd[f"{base}.self_attn.out_proj.weight"] = _t(g(src, "self_attn", "out_kernel"))
        sd[f"{base}.self_attn.out_proj.bias"] = g(src, "self_attn", "out_bias")
        sd[f"{base}.ffn.ffn_1.weight"] = _unconv(g(src, "ffn_1", "kernel"))
        sd[f"{base}.ffn.ffn_1.bias"] = g(src, "ffn_1", "bias")
        sd[f"{base}.ffn.ffn_2.weight"] = _t(g(src, "ffn_2", "kernel"))
        sd[f"{base}.ffn.ffn_2.bias"] = g(src, "ffn_2", "bias")
    sd[f"{prefix}last_ln.weight"] = g("last_ln", "scale")
    sd[f"{prefix}last_ln.bias"] = g("last_ln", "bias")
    return _to_torch(sd)


def facodec_encoder_params_from_flax(params: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``FACodecEncoderV2Model`` params -> the port's (reference-named) state dict."""
    g = lambda *p: _get(params, *p)  # noqa: E731
    sd: Dict[str, np.ndarray] = {}

    def conv(dst, *src):
        sd[f"{prefix}{dst}.weight"] = _unconv(g(*src, "kernel"))
        sd[f"{prefix}{dst}.bias"] = g(*src, "bias")

    def act(dst, *src):
        sd[f"{prefix}{dst}.act.alpha"] = g(*src, "alpha")
        sd[f"{prefix}{dst}.act.beta"] = g(*src, "beta")

    n_blocks = sum(1 for k in params if k.startswith("block"))
    conv("block.0", "conv_in")
    for i in range(n_blocks):
        base, blk = f"block.{i + 1}.block", f"block{i}"
        for j in range(3):
            unit = f"{base}.{j}.block"
            act(f"{unit}.0", blk, f"res{j + 1}", "act1")
            conv(f"{unit}.1", blk, f"res{j + 1}", "conv1")
            act(f"{unit}.2", blk, f"res{j + 1}", "act2")
            conv(f"{unit}.3", blk, f"res{j + 1}", "conv2")
        act(f"{base}.3", blk, "act")
        conv(f"{base}.4", blk, "down")
    act(f"block.{n_blocks + 1}", "act_out")
    conv(f"block.{n_blocks + 2}", "conv_out")
    return _to_torch(sd)


def ns3_params_from_flax(params: Dict, with_speaker: bool = False) -> Dict[str, torch.Tensor]:
    """JAX ``ProsodyExtractor.params`` -> the port's ``ProsodyExtractor`` state dict."""
    g = lambda *p: _get(params, *p)  # noqa: E731
    sd = _to_torch({
        "melspec_linear.weight": _t(g("melspec_linear", "kernel")),
        "melspec_linear.bias": g("melspec_linear", "bias"),
        "fvq.in_proj.weight": _t(g("fvq", "in_kernel")),
        "fvq.in_proj.bias": g("fvq", "in_bias"),
        "fvq.out_proj.weight": _t(g("fvq", "out_kernel")),
        "fvq.out_proj.bias": g("fvq", "out_bias"),
        "fvq.codebook.weight": g("fvq", "codebook"),
    })
    sd.update(ns3_transformer_params_from_flax(params["melspec_encoder"], "melspec_encoder."))
    if with_speaker:
        sd.update(facodec_encoder_params_from_flax(params["encoder"], "encoder."))
        sd.update(ns3_transformer_params_from_flax(params["timbre_encoder"], "timbre_encoder."))
    return sd


def baseline_params_from_flax(pool: Dict, head: Dict) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """JAX ``AttentiveStatisticsPooling`` and ``EmotionRegression`` params ->
    the port's (pool, head) state dicts."""
    pool_sd = {
        "sap_linear.weight": _t(_get(pool, "sap_linear", "kernel")),
        "sap_linear.bias": _get(pool, "sap_linear", "bias"),
        "attention": _get(pool, "attention"),
    }
    head_sd: Dict[str, np.ndarray] = {}
    for i in range(sum(1 for k in head if k.startswith("fc"))):
        head_sd[f"fc.{i}.0.weight"] = _t(_get(head, f"fc{i}", "kernel"))
        head_sd[f"fc.{i}.0.bias"] = _get(head, f"fc{i}", "bias")
        head_sd[f"fc.{i}.1.weight"] = _get(head, f"ln{i}", "scale")
        head_sd[f"fc.{i}.1.bias"] = _get(head, f"ln{i}", "bias")
    head_sd["out.0.weight"] = _t(_get(head, "out", "kernel"))
    head_sd["out.0.bias"] = _get(head, "out", "bias")
    return _to_torch(pool_sd), _to_torch(head_sd)
