"""Load a local HF-format speech, Whisper (encoder and decoder) or text
checkpoint, or the NS3 FACodec ``.bin`` files, into the port's models.

Port of ``interspeech_ser_tpu/models/loader.py::build_speech_encoder``,
``build_whisper_encoder``, ``build_roberta`` and ``build_deberta_v2``, and
of ``whisper_decoder_hf_to_flax`` (``models/whisper_decoder.py``), without
transformers or safetensors: ``config.json`` is read with ``json``,
weights come from ``pytorch_model.bin`` (``torch.load(weights_only=True)``)
or ``model.safetensors`` (a small reader below), sharded or not. The
positional conv's weight norm is folded into a plain kernel
(:func:`speech_state_dict_from_hf`), and unfolded again for an HF-format
file (:func:`speech_state_dict_to_hf`, the challenge baseline's
``final_ssl.pt``).

Also the port of the FACodec converters of
``interspeech_ser_tpu/models/ns3/facodec.py`` (``ns3_encoder_params_from_torch``,
``ns3_decoder_prosody_params_from_torch``): :func:`ns3_state_dict_from_reference`
reads the reference's ``ns3_facodec_{encoder,decoder}_v2.bin`` key names,
with FACodec's ``dim=0`` weight norm folded; and of ``facodec_decoder.py``'s
``ns3_decoder_full_params_from_torch`` / ``ns3_redecoder_params_from_torch``:
:func:`ns3_decoder_full_state_dict_from_reference` and
:func:`ns3_redecoder_state_dict_from_reference` (the port's modules carry the
reference's names, so only the weight norms are folded; a transposed conv's
``dim=0`` is its input channel, g ``[in, 1, 1]``, the norm over (out, k)).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch

from .ns3.facodec import ProsodyExtractor
from .ns3.facodec_decoder import FACodecDecoderFull, FACodecRedecoder
from .speech import SpeechConfig, SpeechEncoderModel
from .text import DebertaV2Config, DebertaV2Model, RobertaConfig, RobertaModel
from .whisper import WhisperEncoderConfig, WhisperEncoderModel
from .whisper_decoder import WhisperDecoderConfig, WhisperDecoderModel

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
# HF keys the inference encoder has no use for
_UNUSED_KEYS = ("masked_spec_embed",)
# HF text-model keys extraction has no use for (the pooler; older
# checkpoints' position-id buffers)
_UNUSED_TEXT_PREFIXES = ("pooler.", "embeddings.position_ids", "embeddings.token_type_ids")


def resolve_dir(path_or_name: str) -> str:
    """A local HF model directory; hub names resolve only as local paths."""
    if os.path.isdir(path_or_name):
        return path_or_name
    raise FileNotFoundError(
        f"{path_or_name!r} is not a local model directory: the port reads HF-format "
        "directories (config.json + weights) only and has no hub access"
    )


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.safetensors`` file: 8-byte little-endian header length, a
    JSON header ``{name: {dtype, shape, data_offsets}}``, then raw bytes."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        dt = _ST_DTYPES[meta["dtype"]]
        count = (end - start) // torch.empty((), dtype=dt).element_size()
        t = torch.frombuffer(data, dtype=dt, count=count, offset=start) if count else torch.empty(0, dtype=dt)
        out[name] = t.reshape(meta["shape"])
    return out


def load_hf_state_dict(path_or_name: str) -> Dict[str, torch.Tensor]:
    d = resolve_dir(path_or_name)
    load_bin = lambda p: torch.load(p, map_location="cpu", weights_only=True)  # noqa: E731
    for index_name, loader, single in (
        ("model.safetensors.index.json", load_safetensors, "model.safetensors"),
        ("pytorch_model.bin.index.json", load_bin, "pytorch_model.bin"),
    ):
        idx = os.path.join(d, index_name)
        if os.path.exists(idx):
            with open(idx) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            sd: Dict[str, torch.Tensor] = {}
            for s in shards:
                sd.update(loader(os.path.join(d, s)))
            return sd
        if os.path.exists(os.path.join(d, single)):
            return loader(os.path.join(d, single))
    raise FileNotFoundError(f"no model weights found under {d}")


def _strip_prefix(sd: Dict[str, torch.Tensor], prefixes) -> Dict[str, torch.Tensor]:
    for p in prefixes:
        if any(k.startswith(p) for k in sd):
            return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
    return sd


def fold_weight_norm(sd: Dict[str, torch.Tensor], prefix: str, dim: int = 2) -> Dict[str, torch.Tensor]:
    """torch ``weight_norm(dim=dim)`` params (either key style) -> one plain
    ``{prefix}.weight`` = g * v / ||v||, the norm over every dim but ``dim``.
    ``dim=2``: the wav2vec2-family positional conv (g [1, 1, k], the norm
    over (out, in)); ``dim=0``: FACodec's convs and linears (g [out, 1, 1]
    or [out, 1], the norm over each output channel's (in, k))."""
    sd = dict(sd)
    for g_name, v_name in (
        (f"{prefix}.parametrizations.weight.original0", f"{prefix}.parametrizations.weight.original1"),
        (f"{prefix}.weight_g", f"{prefix}.weight_v"),
    ):
        if g_name in sd:
            g = sd.pop(g_name).float()
            v = sd.pop(v_name).float()
            norm = v.pow(2).sum(dim=[d for d in range(v.dim()) if d != dim], keepdim=True).sqrt()
            sd[f"{prefix}.weight"] = v * (g / norm.clamp_min(1e-12))
    return sd


_WN_SUFFIXES = (".weight_g", ".parametrizations.weight.original0")
# the port's ProsodyExtractor prefix -> the reference decoder's
_NS3_DECODER_PREFIXES = {
    "fvq.in_proj.": "quantizer.0.layers.0.in_proj.",
    "fvq.out_proj.": "quantizer.0.layers.0.out_proj.",
    "fvq.codebook.": "quantizer.0.layers.0._codebook.",
}


def _fold_all_weight_norms(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    for key in list(sd):
        for suffix in _WN_SUFFIXES:
            if key.endswith(suffix):
                sd = fold_weight_norm(sd, key[: -len(suffix)], dim=0)
    return sd


def ns3_state_dict_from_reference(
    decoder_sd: Dict[str, torch.Tensor], encoder_sd: Optional[Dict[str, torch.Tensor]] = None,
    with_speaker: bool = False,
) -> Dict[str, torch.Tensor]:
    """FACodecDecoderV2 (and, ``with_speaker``, FACodecEncoderV2) state dicts
    -> :class:`ProsodyExtractor`'s. Only the extraction subset is read (the
    decoder's other quantizers, predictors and vocoder, and the encoder's
    resampling-filter buffers, are left); a missing key raises."""
    dec = _fold_all_weight_norms(dict(decoder_sd))
    enc = _fold_all_weight_norms(dict(encoder_sd)) if with_speaker else {}
    out = {}
    with torch.device("meta"):
        keys = list(ProsodyExtractor(with_speaker=with_speaker).state_dict())
    for key in keys:
        if key.startswith("encoder."):
            src, ref = enc, key[len("encoder."):]
        else:
            src, ref = dec, key
            for mine, theirs in _NS3_DECODER_PREFIXES.items():
                if key.startswith(mine):
                    ref = theirs + key[len(mine):]
        if ref not in src:
            raise KeyError(f"{ref} ({'encoder' if src is enc else 'decoder'} checkpoint)")
        out[key] = src[ref].float()
    return out


def build_prosody_extractor(decoder_ckpt: str, encoder_ckpt: Optional[str] = None,
                            with_speaker: bool = False) -> ProsodyExtractor:
    """-> the extractor in f32 on the CPU from the reference's ``.bin`` files
    (``torch.load(weights_only=True)``), loaded strictly."""
    load = lambda p: torch.load(p, map_location="cpu", weights_only=True)  # noqa: E731
    sd = ns3_state_dict_from_reference(load(decoder_ckpt), load(encoder_ckpt) if with_speaker else None,
                                       with_speaker)
    model = ProsodyExtractor(with_speaker=with_speaker)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _reference_subset(sd: Dict[str, torch.Tensor], model_cls, what: str, **kw) -> Dict[str, torch.Tensor]:
    """A reference FACodec state dict, its weight norms (``dim=0``, either key
    style) folded, cut to the keys of ``model_cls(**kw)`` in f32; a missing key raises."""
    folded = _fold_all_weight_norms(dict(sd))
    with torch.device("meta"):
        keys = list(model_cls(**kw).state_dict())
    missing = [k for k in keys if k not in folded]
    if missing:
        raise KeyError(f"{what} checkpoint lacks {len(missing)} keys, e.g. {missing[:3]}")
    return {k: folded[k].float() for k in keys}


def ns3_decoder_full_state_dict_from_reference(sd: Dict[str, torch.Tensor], **config) -> Dict[str, torch.Tensor]:
    """The reference FACodecDecoder's state dict -> the state dict of
    :class:`FACodecDecoderFull` built with ``config`` (its constructor's
    arguments: ``up_ratios``, ``with_predictors``, ...): the three VQ banks,
    the timbre encoder and linear, the HiFiGAN, and the f0 / phone heads
    ``with_predictors``; other keys are left."""
    return _reference_subset(sd, FACodecDecoderFull, "FACodec decoder", **config)


def ns3_redecoder_state_dict_from_reference(sd: Dict[str, torch.Tensor], **config) -> Dict[str, torch.Tensor]:
    """The reference FACodecRedecoder's state dict -> :class:`FACodecRedecoder`'s (built with ``config``)."""
    return _reference_subset(sd, FACodecRedecoder, "FACodec redecoder", **config)


def _load_reference(ckpt: str, model_cls, to_state_dict, **config):
    sd = to_state_dict(torch.load(ckpt, map_location="cpu", weights_only=True), **config)
    model = model_cls(**config)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def build_facodec_decoder(ckpt: str, **config) -> FACodecDecoderFull:
    """-> the full decoder (built with ``config``) in f32 on the CPU from a reference ``.bin``, loaded strictly."""
    return _load_reference(ckpt, FACodecDecoderFull, ns3_decoder_full_state_dict_from_reference, **config)


def build_facodec_redecoder(ckpt: str, **config) -> FACodecRedecoder:
    """-> the redecoder (built with ``config``) in f32 on the CPU from a reference ``.bin``, loaded strictly."""
    return _load_reference(ckpt, FACodecRedecoder, ns3_redecoder_state_dict_from_reference, **config)


POS_CONV = "encoder.pos_conv_embed.conv"


def speech_state_dict_from_hf(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An HF WavLM / wav2vec2 / HuBERT state dict (or a ``final_ssl.pt``) ->
    the port's ``SpeechEncoderModel`` state dict in f32: a ``wavlm.``,
    ``wav2vec2.`` or ``hubert.`` prefix stripped, the positional conv's weight
    norm folded, ``masked_spec_embed`` dropped."""
    sd = fold_weight_norm(_strip_prefix(sd, ("wavlm.", "wav2vec2.", "hubert.")), POS_CONV)
    return {k: v.float() for k, v in sd.items() if k not in _UNUSED_KEYS}


def speech_state_dict_to_hf(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A port ``SpeechEncoderModel`` state dict -> the HF state dict the JAX
    package's ``speech_flax_to_hf`` writes (``final_ssl.pt``), as f32 CPU
    copies: the positional conv's kernel w unfolded into torch's weight-norm
    parametrization, ``original0`` = g = ||w|| over (out, in) [1, 1, k] and
    ``original1`` = v = w; every other key as it is. g is computed as
    :func:`fold_weight_norm` computes the norm of v, so folding the file back
    gives w bit for bit."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        v = v.detach().to("cpu", torch.float32, copy=True)
        if k == f"{POS_CONV}.weight":
            out[f"{POS_CONV}.parametrizations.weight.original0"] = v.pow(2).sum(dim=[0, 1], keepdim=True).sqrt()
            out[f"{POS_CONV}.parametrizations.weight.original1"] = v
        else:
            out[k] = v
    return out


def read_config(path_or_name: str) -> Dict:
    """The directory's ``config.json`` as a dict."""
    with open(os.path.join(resolve_dir(path_or_name), "config.json")) as f:
        return json.load(f)


def build_speech_encoder(
    path_or_name: str, dtype: str = "float32"
) -> Tuple[SpeechEncoderModel, SpeechConfig, bool]:
    """-> (model in f32 on the CPU, config, do_normalize). Takes a WavLM,
    wav2vec2 or HuBERT directory, layer-norm (large / XL) or group-norm
    (base) frontend, pre- or post-LN stack; keys under a ``wavlm.``,
    ``wav2vec2.`` or ``hubert.`` prefix are kept with the prefix stripped,
    ``masked_spec_embed`` (pre-training only) is dropped, and the load is
    strict."""
    d = resolve_dir(path_or_name)
    cfg = SpeechConfig.from_hf(read_config(d), dtype=dtype)
    with torch.device("meta"):  # no throwaway random init of the weights
        model = SpeechEncoderModel(cfg)
    model.load_state_dict(speech_state_dict_from_hf(load_hf_state_dict(d)), strict=True, assign=True)
    model.eval()
    do_normalize = True
    pp = os.path.join(d, "preprocessor_config.json")
    if os.path.exists(pp):
        with open(pp) as f:
            do_normalize = bool(json.load(f).get("do_normalize", True))
    return model, cfg, do_normalize


def read_whisper_config(path_or_name: str) -> Dict:
    """A Whisper directory's ``config.json``; any other model type raises."""
    d = resolve_dir(path_or_name)
    hf = read_config(d)
    if hf.get("model_type") != "whisper":
        raise ValueError(f"{d}: model_type {hf.get('model_type')!r} is not 'whisper'")
    return hf


def build_whisper_encoder(
    path_or_name: str, dtype: str = "float32", state_dict: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[WhisperEncoderModel, WhisperEncoderConfig]:
    """-> (encoder in f32 on the CPU, config). Takes a Whisper directory only;
    keys under a ``model.encoder.`` or ``encoder.`` prefix are kept with the
    prefix stripped (the decoder's are dropped), and the load is strict.
    ``state_dict``: the directory's weights, already read."""
    cfg = WhisperEncoderConfig.from_hf(read_whisper_config(path_or_name), dtype=dtype)
    sd = load_hf_state_dict(path_or_name) if state_dict is None else state_dict
    sd = _strip_prefix(sd, ("model.encoder.", "encoder."))
    with torch.device("meta"):
        model = WhisperEncoderModel(cfg)
    model.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True, assign=True)
    return model.eval(), cfg


def whisper_decoder_state_dict_from_hf(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An HF ``WhisperForConditionalGeneration`` / ``WhisperModel`` state dict
    -> the port's ``WhisperDecoderModel`` state dict in f32: the keys under
    ``model.decoder.`` or ``decoder.`` with the prefix stripped (the
    encoder's and the tied ``proj_out`` dropped), as ``whisper_decoder_hf_to_flax``
    reads them."""
    return {k: v.float() for k, v in _strip_prefix(sd, ("model.decoder.", "decoder.")).items()}


def build_whisper_decoder(
    path_or_name: str, dtype: str = "float32", state_dict: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[WhisperDecoderModel, WhisperDecoderConfig]:
    """-> (decoder in f32 on the CPU, config) from the same ``config.json``
    and weights as :func:`build_whisper_encoder`, so that one HF
    ``WhisperForConditionalGeneration`` directory builds both halves; the
    load is strict. ``state_dict``: the directory's weights, already read."""
    cfg = WhisperDecoderConfig.from_hf(read_whisper_config(path_or_name), dtype=dtype)
    sd = load_hf_state_dict(path_or_name) if state_dict is None else state_dict
    with torch.device("meta"):
        model = WhisperDecoderModel(cfg)
    model.load_state_dict(whisper_decoder_state_dict_from_hf(sd), strict=True, assign=True)
    return model.eval(), cfg


def _build_text(path_or_name: str, dtype: str, config_cls, model_cls, prefix: str):
    d = resolve_dir(path_or_name)
    cfg = config_cls.from_hf(read_config(d), dtype=dtype)
    sd = _strip_prefix(load_hf_state_dict(d), (prefix,))
    sd = {k: v.float() for k, v in sd.items() if not k.startswith(_UNUSED_TEXT_PREFIXES)}
    with torch.device("meta"):
        model = model_cls(cfg)
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval(), cfg


def build_roberta(path_or_name: str, dtype: str = "float32") -> Tuple[RobertaModel, RobertaConfig]:
    """-> (model in f32 on the CPU, config). Keys under ``roberta.`` are kept
    with the prefix stripped (an ``lm_head`` is dropped); the load is strict."""
    return _build_text(path_or_name, dtype, RobertaConfig, RobertaModel, "roberta.")


def build_deberta_v2(path_or_name: str, dtype: str = "float32") -> Tuple[DebertaV2Model, DebertaV2Config]:
    """-> (model in f32 on the CPU, config). Keys under ``deberta.`` are kept
    with the prefix stripped; the load is strict."""
    return _build_text(path_or_name, dtype, DebertaV2Config, DebertaV2Model, "deberta.")
