"""Weights carried across from the JAX package: flax-layout numpy -> torch.

Neither function needs jax: they take the JAX package's param trees as
nested dicts of numpy arrays and return the port's state dicts.

- :func:`speech_params_from_flax` mirrors ``speech_flax_to_hf``
  (interspeech_ser_tpu/models/convert_hf.py) and yields HF key names, with
  the positional conv kept as one plain (folded) ``weight``: layer-norm and
  group-norm frontends, with or without conv biases, and each layer's
  ``adapter`` / ``embed_prompt`` where the params have them.
- :func:`whisper_params_from_flax` mirrors ``whisper_encoder_hf_to_flax``
  in reverse and yields HF Whisper-encoder key names.
- :func:`whisper_decoder_params_from_flax` mirrors ``whisper_decoder_hf_to_flax``
  in reverse and yields HF Whisper-decoder key names.
- :func:`roberta_params_from_flax` and :func:`deberta_v2_params_from_flax`
  mirror ``roberta_hf_to_flax`` and ``deberta_v2_hf_to_flax`` in reverse
  and yield HF RobertaModel / DebertaV2Model key names (no prefix).
- :func:`fusion_params_from_flax` mirrors ``convert_fusion.flax_to_torch``
  and yields the reference's ``multimodal_ser.pt`` names, with the legacy
  gates (``{mod}_gate``), the gender head (``gender_classifier.fc{1,2}``)
  and without the modality norms where the params lack them;
  :func:`variant_params_from_flax` does the same for the MoE and
  single-modality models, whose port modules carry the flax names. Both go
  leaf by leaf (:func:`flax_key_to_port`);
  :func:`port_key_to_flax` is the way back, which writes the JAX engine's
  flat checkpoint keys (``a.b.kernel``, ``[in, out]`` Dense kernels) for
  the variants that have no reference naming (``moe``, ``single``, any
  gender head).
- :func:`ns3_params_from_flax` takes the JAX ``ProsodyExtractor``'s param
  dict and yields the port's ``ProsodyExtractor`` state dict (its pieces:
  :func:`ns3_transformer_params_from_flax`, :func:`facodec_encoder_params_from_flax`).
- :func:`facodec_decoder_params_from_flax` and :func:`facodec_redecoder_params_from_flax`
  take the JAX ``FACodecDecoderFull`` / ``FACodecRedecoder`` params and yield
  the port modules' (reference-named) state dicts.
- :func:`baseline_params_from_flax` mirrors ``pooling_flax_to_torch`` and
  ``ser_flax_to_torch`` (interspeech_ser_tpu/baseline/models.py) and yields
  the challenge baseline's ``final_pool.pt`` / ``final_ser.pt`` names.
- :func:`style_embedding_params_from_flax`, :func:`proto_ser_params_from_flax`,
  :func:`bidir_reference_encoder_params_from_flax`,
  :func:`reference_encoder_classifier_params_from_flax` and
  :func:`xvector_params_from_flax` take the JAX proto-angular, information-
  encoder and x-vector nets' params (and BatchNorm ``batch_stats``) and yield
  the port modules' state dicts; :func:`emotion_regression_params_from_flax`
  the x-vector (and baseline) head's.
- :func:`joint_params_from_flax` mirrors ``conv_joint_flax_to_torch`` and
  ``transformer_joint_flax_to_torch`` (interspeech_ser_tpu/models/joint.py)
  and yields the joint heads' ``final_ser.pt`` names;
  :func:`joint_params_to_flax` is the way back.

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
        if "adapter" in params[src]:  # the fine-tune hooks (config.finetune_method)
            for dense in ("down", "up"):
                sd[f"{base}.adapter.{dense}.weight"] = _t(g(src, "adapter", dense, "kernel"))
                sd[f"{base}.adapter.{dense}.bias"] = g(src, "adapter", dense, "bias")
        if "embed_prompt" in params[src]:
            sd[f"{base}.embed_prompt"] = g(src, "embed_prompt")
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


# flax leaf name -> the port's, where they differ (a Dense / Conv ``kernel``
# and a LayerNorm ``scale`` both become ``weight``)
_FLAX_LEAVES = {"kernel": "weight", "scale": "weight", "in_proj_kernel": "in_proj_weight",
                "out_kernel": "out_proj.weight", "out_bias": "out_proj.bias"}
for _d, _sfx in (("fwd", ""), ("bwd", "_reverse")):
    for _flax, _port in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"), ("b_ih", "bias_ih_l0"),
                         ("b_hh", "bias_hh_l0")):
        _FLAX_LEAVES[f"{_flax}_{_d}"] = f"{_port}{_sfx}"
_PORT_LEAVES = {v: k for k, v in _FLAX_LEAVES.items() if k not in ("kernel", "scale")}
# the leaves stored [in, out] in flax and [out, in] in torch
_TRANSPOSED = {"in_proj_kernel", "out_kernel", "w_ih_fwd", "w_hh_fwd", "w_ih_bwd", "w_hh_bwd"}


def fusion_renames(n_mod: int) -> Dict[str, str]:
    """Module paths of the port's fusion model (the reference's torch names)
    -> the JAX ``MultiModalEmotionClassifier``'s; the rest are equal."""
    r = {"layer_norm": "fusion_norm"}
    for mod in MODALITY_NAMES[:n_mod]:
        for part in ("projection", "norm", "gru"):
            r[f"{mod}_{part}"] = f"{mod}_encoder.{part}"
        r[f"{mod}_attn"] = f"{mod}_pool_attn"
    for head, flax in (("classifier", "classifier"), ("neutral_classifier", "neutral")):
        r[f"{head}.0"], r[f"{head}.3"] = f"{flax}_fc1", f"{flax}_fc2"
    return r


def flatten_flax(params: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested flax params -> ``{"a.b.leaf": array}``, the JAX engine's flat
    checkpoint keys (``interspeech_ser_tpu/train/engine.py::save_torch_checkpoint``)."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in params.items():
        if isinstance(v, dict):
            flat.update(flatten_flax(v, f"{prefix}{k}."))
        else:
            flat[f"{prefix}{k}"] = np.asarray(v)
    return flat


def flax_key_to_port(key: str, value: np.ndarray, renames: Dict[str, str] = None) -> Tuple[str, np.ndarray]:
    """One flat flax leaf -> (the port's state-dict key, its value in torch layout)."""
    module, leaf = key.rsplit(".", 1) if "." in key else ("", key)
    module = {v: k for k, v in (renames or {}).items()}.get(module, module)
    value = np.asarray(value)
    if leaf == "kernel":
        value = _unconv(value) if value.ndim == 3 else _t(value)
    elif leaf in _TRANSPOSED:
        value = _t(value)
    port_leaf = _FLAX_LEAVES.get(leaf, leaf)
    return (f"{module}.{port_leaf}" if module else port_leaf), value


def port_key_to_flax(key: str, value: np.ndarray, renames: Dict[str, str] = None) -> Tuple[str, np.ndarray]:
    """One port state-dict entry -> (the flat flax key, its value in flax layout)."""
    parts = key.split(".")
    n_leaf = 2 if len(parts) > 2 and parts[-2] == "out_proj" else 1
    module, leaf = ".".join(parts[:-n_leaf]), ".".join(parts[-n_leaf:])
    module = (renames or {}).get(module, module)
    value = np.asarray(value)
    if leaf == "weight":
        flax_leaf = "scale" if value.ndim == 1 else "kernel"
        value = _unconv(value) if value.ndim == 3 else _t(value) if value.ndim == 2 else value
    else:
        flax_leaf = _PORT_LEAVES.get(leaf, leaf)
        if flax_leaf in _TRANSPOSED:
            value = _t(value)
    return (f"{module}.{flax_leaf}" if module else flax_leaf), np.ascontiguousarray(value)


def is_flax_flat(sd: Dict) -> bool:
    """Whether a state dict has the JAX engine's flat flax keys (a leaf no
    torch module names: ``kernel``, ``scale``, a GRU's ``w_ih_fwd`` ...)."""
    return any(k.rsplit(".", 1)[-1] in _FLAX_LEAVES for k in sd)


def flax_flat_to_port(flat: Dict, renames: Dict[str, str] = None) -> Dict[str, torch.Tensor]:
    out = dict(flax_key_to_port(k, v, renames) for k, v in flat.items())
    return _to_torch(out)


def port_to_flax_flat(sd: Dict[str, torch.Tensor], renames: Dict[str, str] = None) -> Dict[str, np.ndarray]:
    return dict(port_key_to_flax(k, v.detach().cpu().numpy(), renames) for k, v in sd.items())


def fusion_params_from_flax(params: Dict, n_mod: int) -> Dict[str, torch.Tensor]:
    """JAX ``MultiModalEmotionClassifier`` params -> the port's fusion model
    (reference torch names), with its gates, gender head and neutral head
    when the params have them."""
    return flax_flat_to_port(flatten_flax(params), fusion_renames(n_mod))


def variant_params_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``MoEEmotionClassifier`` or ``SingleModalitySERClassifier`` params
    -> the port's (whose modules carry the flax names)."""
    return flax_flat_to_port(flatten_flax(params))


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


def _resunit_pairs(sd: Dict[str, np.ndarray], p: Dict, prefix: str) -> None:
    """A flax ``_ResidualUnit`` (act1, conv1, act2, conv2) -> the port's ``ResidualUnit`` under ``prefix``."""
    for j, name in ((0, "act1"), (2, "act2")):
        sd[f"{prefix}.block.{j}.act.alpha"] = _get(p, name, "alpha")
        sd[f"{prefix}.block.{j}.act.beta"] = _get(p, name, "beta")
    for j, name in ((1, "conv1"), (3, "conv2")):
        sd[f"{prefix}.block.{j}.weight"] = _unconv(_get(p, name, "kernel"))
        sd[f"{prefix}.block.{j}.bias"] = _get(p, name, "bias")


def _hifigan_pairs(sd: Dict[str, np.ndarray], p: Dict, prefix: str) -> None:
    n = sum(1 for k in p if k.startswith("up"))
    for i, name in ((0, "conv_in"), (n + 2, "conv_out")):
        sd[f"{prefix}.{i}.weight"] = _unconv(_get(p, name, "kernel"))
        sd[f"{prefix}.{i}.bias"] = _get(p, name, "bias")
    for i in range(n):
        up, base = p[f"up{i}"], f"{prefix}.{i + 1}.block"
        sd[f"{base}.0.act.alpha"] = _get(up, "act", "alpha")
        sd[f"{base}.0.act.beta"] = _get(up, "act", "beta")
        sd[f"{base}.1.weight"] = _get(up, "up_kernel")  # torch layout [in, out, k] on both sides
        sd[f"{base}.1.bias"] = _get(up, "up_bias")
        for j in range(3):
            _resunit_pairs(sd, up[f"res{j + 1}"], f"{base}.{j + 2}")
    sd[f"{prefix}.{n + 1}.act.alpha"] = _get(p, "act_out", "alpha")
    sd[f"{prefix}.{n + 1}.act.beta"] = _get(p, "act_out", "beta")


def _dense_as(sd: Dict[str, np.ndarray], p: Dict, dst: str) -> None:
    sd[f"{dst}.weight"] = _t(_get(p, "kernel"))
    sd[f"{dst}.bias"] = _get(p, "bias")


def _vq_bank_pairs(sd: Dict[str, np.ndarray], bank: Dict, prefix: str) -> None:
    """A flax ``ResidualVQBank`` (``vq{i}``) -> the port's ``ResidualVQBank`` under ``prefix``."""
    for i in range(len(bank)):
        vq, base = bank[f"vq{i}"], f"{prefix}layers.{i}"
        sd[f"{base}.in_proj.weight"] = _t(_get(vq, "in_kernel"))
        sd[f"{base}.in_proj.bias"] = _get(vq, "in_bias")
        sd[f"{base}.out_proj.weight"] = _t(_get(vq, "out_kernel"))
        sd[f"{base}.out_proj.bias"] = _get(vq, "out_bias")
        sd[f"{base}._codebook.weight"] = _get(vq, "codebook")


def facodec_decoder_params_from_flax(params: Dict, with_predictors: bool = False) -> Dict[str, torch.Tensor]:
    """JAX ``FACodecDecoderFull`` params -> the port's ``FACodecDecoderFull`` state dict."""
    sd: Dict[str, np.ndarray] = {}
    for b, bank in enumerate(("prosody_vq", "content_vq", "residual_vq")):
        _vq_bank_pairs(sd, params[bank], f"quantizer.{b}.")
    _dense_as(sd, params["timbre_linear"], "timbre_linear")
    _hifigan_pairs(sd, params["model"], "model")
    if with_predictors:
        for name in ("f0_predictor", "phone_predictor"):
            p = params[name]
            for j in range(3):
                _resunit_pairs(sd, p[f"res{j + 1}"], f"{name}.model.{j}")
            sd[f"{name}.model.3.act.alpha"] = _get(p, "act", "alpha")
            sd[f"{name}.model.3.act.beta"] = _get(p, "act", "beta")
            for i in range(sum(1 for k in p if k.startswith("head"))):
                _dense_as(sd, p[f"head{i}"], f"{name}.heads.{i}")
    out = _to_torch(sd)
    out.update(ns3_transformer_params_from_flax(params["timbre_encoder"], "timbre_encoder."))
    return out


def facodec_redecoder_params_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``FACodecRedecoder`` params -> the port's ``FACodecRedecoder`` state dict."""
    sd: Dict[str, np.ndarray] = {}
    for name in ("prosody", "content", "residual"):
        for i in range(sum(1 for k in params if k.startswith(f"{name}_emb"))):
            sd[f"{name}_embs.{i}.weight"] = _get(params, f"{name}_emb{i}")
    enc, dst = params["timbre_cond_prosody_enc"], "timbre_cond_prosody_enc"
    for i in range(sum(1 for k in enc if k.startswith("layer"))):
        src, base = enc[f"layer{i}"], f"{dst}.layers.{i}"
        for ln in ("ln_1", "ln_2"):
            _dense_as(sd, src[f"{ln}_style"], f"{base}.{ln}.style")
        sd[f"{base}.self_attn.in_proj_weight"] = _t(_get(src, "self_attn", "in_proj_kernel"))
        sd[f"{base}.self_attn.in_proj_bias"] = _get(src, "self_attn", "in_proj_bias")
        sd[f"{base}.self_attn.out_proj.weight"] = _t(_get(src, "self_attn", "out_kernel"))
        sd[f"{base}.self_attn.out_proj.bias"] = _get(src, "self_attn", "out_bias")
        sd[f"{base}.ffn.ffn_1.weight"] = _unconv(_get(src, "ffn_1", "kernel"))
        sd[f"{base}.ffn.ffn_1.bias"] = _get(src, "ffn_1", "bias")
        _dense_as(sd, src["ffn_2"], f"{base}.ffn.ffn_2")
    _dense_as(sd, enc["last_ln_style"], f"{dst}.last_ln.style")
    _dense_as(sd, params["timbre_linear"], "timbre_linear")
    _hifigan_pairs(sd, params["model"], "model")
    return _to_torch(sd)


def baseline_params_from_flax(pool: Dict, head: Dict) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """JAX ``AttentiveStatisticsPooling`` and ``EmotionRegression`` params ->
    the port's (pool, head) state dicts."""
    pool_sd = {
        "sap_linear.weight": _t(_get(pool, "sap_linear", "kernel")),
        "sap_linear.bias": _get(pool, "sap_linear", "bias"),
        "attention": _get(pool, "attention"),
    }
    return _to_torch(pool_sd), emotion_regression_params_from_flax(head)


def emotion_regression_params_from_flax(head: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``EmotionRegression`` params -> the port's head (``final_ser.pt`` names)."""
    head_sd: Dict[str, np.ndarray] = {}
    for i in range(sum(1 for k in head if k.startswith("fc"))):
        head_sd[f"fc.{i}.0.weight"] = _t(_get(head, f"fc{i}", "kernel"))
        head_sd[f"fc.{i}.0.bias"] = _get(head, f"fc{i}", "bias")
        head_sd[f"fc.{i}.1.weight"] = _get(head, f"ln{i}", "scale")
        head_sd[f"fc.{i}.1.bias"] = _get(head, f"ln{i}", "bias")
    head_sd["out.0.weight"] = _t(_get(head, "out", "kernel"))
    head_sd["out.0.bias"] = _get(head, "out", "bias")
    return _to_torch(head_sd)


def _dense_pairs(path: tuple, key: str) -> list:
    """(flax path, port key, layout) of a Dense / Linear."""
    return [(path + ("kernel",), f"{key}.weight", "dense"), (path + ("bias",), f"{key}.bias", "same")]


def _joint_pairs(head: str, classifier_layernorm: bool, num_layers: int, gated: bool) -> list:
    """(flax path, port key, layout) of every leaf of a joint head: layout
    ``dense`` ([in, out] <-> [out, in]), ``conv`` ([k, in, out] <-> [out, in, k])
    or ``same``."""
    pairs = []
    if head == "conv":
        for name in ("wav_conv1", "wav_conv2", "rob_conv1", "rob_conv2"):
            pairs += [((name, "kernel"), f"{name}.weight", "conv"), ((name, "bias"), f"{name}.bias", "same")]
        pairs += _dense_pairs(("cls_dense",), "classifier.0")
        if classifier_layernorm:  # Sequential: Linear, LayerNorm, ReLU, Dropout, Linear
            pairs += [(("cls_norm", "scale"), "classifier.1.weight", "same"),
                      (("cls_norm", "bias"), "classifier.1.bias", "same")]
        return pairs + _dense_pairs(("cls_out",), f"classifier.{4 if classifier_layernorm else 3}")
    for prefix in ("wav", "rob"):
        pairs += _dense_pairs((f"{prefix}_proj",), f"{prefix}_proj")
        for i in range(num_layers):  # TorchTransformerEncoderLayer: torch's nn.TransformerEncoderLayer keys
            src, dst = (f"{prefix}_transformer_{i}",), f"{prefix}_transformer.layers.{i}"
            pairs += [(src + ("self_attn", "in_proj_kernel"), f"{dst}.self_attn.in_proj_weight", "dense"),
                      (src + ("self_attn", "in_proj_bias"), f"{dst}.self_attn.in_proj_bias", "same"),
                      (src + ("self_attn", "out_kernel"), f"{dst}.self_attn.out_proj.weight", "dense"),
                      (src + ("self_attn", "out_bias"), f"{dst}.self_attn.out_proj.bias", "same")]
            for m in ("linear1", "linear2"):
                pairs += _dense_pairs(src + (m,), f"{dst}.{m}")
            for m in ("norm1", "norm2"):
                pairs += [(src + (m, "scale"), f"{dst}.{m}.weight", "same"),
                          (src + (m, "bias"), f"{dst}.{m}.bias", "same")]
        if gated:
            pairs += _dense_pairs((f"{prefix}_gate",), f"{prefix}_gate.0")
    return pairs + _dense_pairs(("cls_dense",), "classifier.0") + _dense_pairs(("cls_out",), "classifier.3")


_JOINT_LAYOUT = {"dense": _t, "conv": _unconv, "same": lambda x: x}


def joint_params_from_flax(params: Dict, head: str = "conv", classifier_layernorm: bool = True,
                           num_layers: int = 2, gated: bool = False) -> Dict[str, torch.Tensor]:
    """JAX ``ConvJointHead`` (``head='conv'``) or ``TransformerJointHead``
    params -> the port head's state dict, the reference's ``final_ser.pt``
    names (mirrors ``conv_joint_flax_to_torch`` / ``transformer_joint_flax_to_torch``)."""
    pairs = _joint_pairs(head, classifier_layernorm, num_layers, gated)
    return _to_torch({key: _JOINT_LAYOUT[layout](_get(params, *path)) for path, key, layout in pairs})


def joint_params_to_flax(sd: Dict[str, torch.Tensor], head: str = "conv", classifier_layernorm: bool = True,
                         num_layers: int = 2, gated: bool = False) -> Dict:
    """The way back: a port joint head's state dict (or ``final_ser.pt``) ->
    the JAX head's nested param dict of f32 numpy arrays."""
    out: Dict = {}
    for path, key, layout in _joint_pairs(head, classifier_layernorm, num_layers, gated):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        v = sd[key].detach().cpu().float().numpy()
        node[path[-1]] = np.ascontiguousarray(_JOINT_LAYOUT[layout](v))  # each layout is its own inverse
    return out


def _conv2d(x: np.ndarray) -> np.ndarray:  # flax Conv kernel [kh, kw, in, out] -> torch [out, in, kh, kw]
    return np.transpose(x, (3, 2, 0, 1))


def _dense(sd: Dict[str, np.ndarray], params: Dict, name: str, key: str = None) -> None:
    sd[f"{key or name}.weight"] = _t(_get(params, name, "kernel"))
    sd[f"{key or name}.bias"] = _get(params, name, "bias")


def _bigru(sd: Dict[str, np.ndarray], gru: Dict, prefix: str) -> None:
    """JAX ``BiGRU`` (``w_ih_fwd`` [in, 3H] ...) -> torch ``nn.GRU`` names."""
    for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
        sd[f"{prefix}weight_ih_l0{sfx}"] = _t(_get(gru, f"w_ih_{d}"))
        sd[f"{prefix}weight_hh_l0{sfx}"] = _t(_get(gru, f"w_hh_{d}"))
        sd[f"{prefix}bias_ih_l0{sfx}"] = _get(gru, f"b_ih_{d}")
        sd[f"{prefix}bias_hh_l0{sfx}"] = _get(gru, f"b_hh_{d}")


def _conv_bn_stack(sd: Dict[str, np.ndarray], params: Dict, batch_stats: Dict, conv: str, bn: str) -> None:
    """The 6 x [Conv2d, BatchNorm] stack of the reference encoders."""
    for i in range(6):
        sd[f"{conv}.{i}.weight"] = _conv2d(_get(params, f"conv{i}", "kernel"))
        sd[f"{conv}.{i}.bias"] = _get(params, f"conv{i}", "bias")
        sd[f"{bn}.{i}.weight"] = _get(params, f"bn{i}", "scale")
        sd[f"{bn}.{i}.bias"] = _get(params, f"bn{i}", "bias")
        sd[f"{bn}.{i}.running_mean"] = _get(batch_stats, f"bn{i}", "mean")
        sd[f"{bn}.{i}.running_var"] = _get(batch_stats, f"bn{i}", "var")


def style_embedding_params_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``StyleEmbeddingNet`` -> the port's (``projection``, ``gru``,
    ``pool_attn``, ``embedding`` [+ ``classifier``])."""
    sd: Dict[str, np.ndarray] = {}
    for name in ("projection", "pool_attn", "embedding", "classifier"):
        if name in params:
            _dense(sd, params, name)
    _bigru(sd, params["gru"], "gru.")
    return _to_torch(sd)


def proto_ser_params_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``ProtoSERNet`` -> the port's, whose keys are the reference's
    ``angle_ser.pt`` names."""
    sd: Dict[str, np.ndarray] = {}
    _dense(sd, params, "wav_proj")
    mha = params["multihead_attn"]
    sd["multihead_attn.in_proj_weight"] = _t(_get(mha, "in_proj_kernel"))
    sd["multihead_attn.in_proj_bias"] = _get(mha, "in_proj_bias")
    sd["multihead_attn.out_proj.weight"] = _t(_get(mha, "out_kernel"))
    sd["multihead_attn.out_proj.bias"] = _get(mha, "out_bias")
    for name in ("attn_norm", "conv_norm"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _get(params, name, "scale"), _get(params, name, "bias")
    sd["conv1d.weight"] = _unconv(_get(params, "conv1d", "kernel"))
    sd["conv1d.bias"] = _get(params, "conv1d", "bias")
    _dense(sd, params, "attn_pooling")
    if "classifier_fc1" in params:
        _dense(sd, params, "classifier_fc1", "classifier.0")
        _dense(sd, params, "classifier_fc2", "classifier.3")
    return _to_torch(sd)


def bidir_reference_encoder_params_from_flax(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``BidirectionalReferenceEncoder`` (params + batch stats) -> the
    port's (``convs``, ``bns``, ``recurrence``)."""
    sd: Dict[str, np.ndarray] = {}
    _conv_bn_stack(sd, params, batch_stats, "convs", "bns")
    _bigru(sd, params["recurrence"], "recurrence.")
    return _to_torch(sd)


def reference_encoder_classifier_params_from_flax(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``ReferenceEncoderClassifier`` (params + batch stats) -> the port's
    (``conv``, ``bn``, ``gru_*`` in torch layout, [``proj``,] ``classifier_layer``)."""
    sd: Dict[str, np.ndarray] = {}
    _conv_bn_stack(sd, params, batch_stats, "conv", "bn")
    for n in ("ih", "hh"):
        sd[f"gru_weight_{n}"] = _t(_get(params, f"gru_w_{n}"))
        sd[f"gru_bias_{n}"] = _get(params, f"gru_b_{n}")
    for name in ("proj", "classifier_layer"):
        if name in params:
            _dense(sd, params, name)
    return _to_torch(sd)


def xvector_params_from_flax(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``XVector`` (params + batch stats) -> the port's (``tdnn``, ``bn``, ``embedding``)."""
    sd: Dict[str, np.ndarray] = {}
    for i in range(sum(1 for k in params if k.startswith("tdnn"))):
        sd[f"tdnn.{i}.weight"] = _unconv(_get(params, f"tdnn{i}", "kernel"))
        sd[f"tdnn.{i}.bias"] = _get(params, f"tdnn{i}", "bias")
        sd[f"bn.{i}.weight"] = _get(params, f"bn{i}", "scale")
        sd[f"bn.{i}.bias"] = _get(params, f"bn{i}", "bias")
        sd[f"bn.{i}.running_mean"] = _get(batch_stats, f"bn{i}", "mean")
        sd[f"bn.{i}.running_var"] = _get(batch_stats, f"bn{i}", "var")
    _dense(sd, params, "embedding")
    return _to_torch(sd)
