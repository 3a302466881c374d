"""LoRA as a transform of an HF-named state dict.

Port of ``interspeech_ser_tpu/models/lora.py``. Covers both of the
reference's LoRA variants: peft on ``q_proj`` / ``v_proj`` (r=8, alpha=16;
the production ``whisper_lora_ser.pt``) and loralib on the FFN dense layers;
and the helpers of the non-LoRA methods (``adapter``, ``adapter_l``,
``embedding_prompt``, ``combined``; ``models/speech.py``), whose parameters
live inside the encoder under the names in ``FINETUNE_KEYS``:
:func:`split_finetune_params` / :func:`merge_finetune_params` over a state
dict, :func:`add_finetune_params` and :func:`freeze_base`.

No module surgery: the factors live in a dict ``{flax path: {"lora_A": A
[in, r], "lora_B": B [r, out]}}`` and merge functionally, ``W' = W +
(alpha/r) (A @ B)`` (transposed into torch's [out, in]), the delta cast to
W's dtype, exactly as the JAX package merges. Training differentiates the
merge, so gradients reach only the factors.

The checkpoint format is shared with the JAX package: factors under the
JAX package's flax paths (``layer3.self_attn.q_proj.kernel.lora_A``, A as
[in, r] and B as [r, out]), so a checkpoint written by either package loads
into either. :func:`flax_path` maps the port's HF module names to those
paths.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

Lora = Dict[str, Dict[str, torch.Tensor]]  # "layer3.attention.q_proj.kernel" -> {"lora_A", "lora_B"}

_LAYER = re.compile(r"^(?:encoder\.)?layers\.(\d+)\.(.+)$")


def flax_path(name: str) -> Optional[Tuple[str, ...]]:
    """HF name of a layer's weight -> the JAX package's param path, e.g.
    ``encoder.layers.3.attention.q_proj.weight`` (WavLM) or
    ``layers.3.self_attn.q_proj.weight`` (Whisper) -> ``("layer3", ...,
    "q_proj", "kernel")``; None for a name outside the layer stack."""
    m = _LAYER.match(name)
    if m is None:
        return None
    parts = [f"layer{m.group(1)}", *m.group(2).split(".")]
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return tuple(parts)


def match_attention_qv(path: Tuple[str, ...]) -> bool:
    """peft target_modules=['q_proj', 'v_proj'] (speech and Whisper)."""
    return len(path) >= 2 and path[-2] in ("q_proj", "v_proj") and path[-1] == "kernel"


def match_ffn_dense(path: Tuple[str, ...]) -> bool:
    """loralib targets: the FFN's intermediate and output dense layers."""
    return len(path) >= 2 and path[-2] in ("intermediate_dense", "output_dense") and path[-1] == "kernel"


def init_lora(
    generator: torch.Generator,
    state_dict: Dict[str, torch.Tensor],
    match_fn: Callable[[Tuple[str, ...]], bool] = match_attention_qv,
    rank: int = 8,
) -> Lora:
    """For each matched [out, in] weight: A [in, r] kaiming-uniform as peft
    draws it, B [r, out] zeros (the merge is the identity at init)."""
    lora: Lora = {}
    for name, w in state_dict.items():
        path = flax_path(name)
        if path is None or not match_fn(path) or w.dim() != 2:
            continue
        fan_in = w.shape[1]
        bound = math.sqrt(6.0 / fan_in)
        a = (torch.rand(fan_in, rank, generator=generator) * 2 - 1) * bound
        lora[".".join(path)] = {"lora_A": a, "lora_B": torch.zeros(rank, w.shape[0])}
    return lora


def lora_targets(state_dict: Dict[str, torch.Tensor], lora: Lora) -> Dict[str, torch.Tensor]:
    """The entries of ``state_dict`` that ``lora`` adapts."""
    return {n: w for n, w in state_dict.items() if ".".join(flax_path(n) or ()) in lora}


def merge_lora(state_dict: Dict[str, torch.Tensor], lora: Lora, alpha: float = 16.0, rank: int = 8):
    """W' = W + (alpha/r) (A @ B)ᵀ for adapted weights, the rest untouched."""
    scale = alpha / rank
    out = {}
    for name, w in state_dict.items():
        pair = lora.get(".".join(flax_path(name) or ()))
        if pair is None:
            out[name] = w
        else:
            delta = (pair["lora_A"].to(w.device) @ pair["lora_B"].to(w.device)) * scale
            out[name] = w + delta.t().to(w.dtype)
    return out


# -- checkpoint I/O ----------------------------------------------------------


def lora_state_dict(lora: Lora) -> Dict[str, torch.Tensor]:
    """Flat dict of only the factors, under the JAX package's names."""
    return {f"{path}.{leaf}": t.detach() for path, pair in lora.items() for leaf, t in pair.items()}


def _tensor(x) -> torch.Tensor:
    """A float32 CPU copy of a tensor or numpy array (e.g. from the JAX package's loader)."""
    return torch.tensor(np.asarray(x, dtype=np.float32))


def lora_from_state_dict(sd: Dict[str, torch.Tensor]) -> Lora:
    lora: Lora = {}
    for key, val in sd.items():
        path, _, leaf = key.rpartition(".")
        if leaf in ("lora_A", "lora_B"):
            lora.setdefault(path, {})[leaf] = _tensor(val)
    return lora


def lora_from_peft_state_dict(sd: Dict[str, torch.Tensor], layer_prefix: str = "encoder.layers.") -> Lora:
    """peft names (``...encoder.layers.{i}.{attention|self_attn}.{proj}.
    lora_A.default.weight``, torch [r, in] / [out, r]) -> our dict, [in, r] /
    [r, out]."""
    lora: Lora = {}
    for key, val in sd.items():
        if ".lora_A." not in key and ".lora_B." not in key:
            continue
        idx = key.find(layer_prefix)
        if idx < 0:
            continue
        layer_i, module, proj = key[idx + len(layer_prefix):].split(".")[:3]
        which = "lora_A" if ".lora_A." in key else "lora_B"
        lora.setdefault(f"layer{layer_i}.{module}.{proj}.kernel", {})[which] = _tensor(val).t().contiguous()
    return lora


def lora_from_checkpoint(sd: Dict[str, torch.Tensor]) -> Lora:
    """The factors of a checkpoint in either format: peft's or the JAX package's."""
    if any(".lora_A.default." in k for k in sd):
        return lora_from_peft_state_dict(sd)
    return lora_from_state_dict(sd)


# -- the non-LoRA methods (adapter / adapter_l / embedding_prompt / combined) ----

FINETUNE_KEYS = ("adapter", "embed_prompt")


def is_finetune_key(name: str) -> bool:
    """Whether a state-dict name lies under an adapter or is a prompt."""
    return any(part in FINETUNE_KEYS for part in name.split("."))


def split_finetune_params(state_dict: Dict[str, torch.Tensor]):
    """state dict -> (frozen base, tuned adapter / prompt entries), by name."""
    base = {k: v for k, v in state_dict.items() if not is_finetune_key(k)}
    tuned = {k: v for k, v in state_dict.items() if is_finetune_key(k)}
    return base, tuned


def merge_finetune_params(base: Dict[str, torch.Tensor], tuned: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`split_finetune_params`."""
    return {**base, **tuned}


def add_finetune_params(model: nn.Module, base_state_dict: Dict[str, torch.Tensor],
                        generator: Optional[torch.Generator] = None) -> nn.Module:
    """Load the pretrained ``base_state_dict`` into ``model`` (a
    ``SpeechEncoderModel`` whose config sets ``finetune_method``) and draw its
    adapters and prompts afresh from ``generator``, layer by layer. Any
    other missing or unexpected key raises."""
    from .speech import Adapter, EncoderLayer, init_prompt

    missing, unexpected = model.load_state_dict(base_state_dict, strict=False)
    base_missing = [k for k in missing if not is_finetune_key(k)]
    if base_missing or unexpected:
        raise KeyError(f"base weights: missing {base_missing[:3]}, unexpected {list(unexpected)[:3]}")
    for mod in model.modules():
        if isinstance(mod, EncoderLayer) and hasattr(mod, "embed_prompt"):
            init_prompt(mod.embed_prompt, generator)
        elif isinstance(mod, Adapter):
            mod.reset_parameters(generator)
    return model


def freeze_base(model: nn.Module) -> nn.Module:
    """``requires_grad_(False)`` on every parameter but the adapters and prompts."""
    for name, prm in model.named_parameters():
        prm.requires_grad_(is_finetune_key(name))
    return model
