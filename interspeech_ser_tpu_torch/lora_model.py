"""The lora_wavlm wrapper: a speech encoder with a parameter-efficient
fine-tune method and the layer-weighted head.

Port of ``lora_wavlm/model.py::build_wavlm_wrapper`` (same arguments and
defaults). ``finetune_method``:
- ``lora``: loralib-style factors on the FFN denses (``models/lora.py``,
  ``match_ffn_dense``), merged into the frozen encoder at each forward;
- ``adapter`` | ``adapter_l`` | ``embedding_prompt``: the encoder rebuilt
  with that hook in every layer (``models/speech.py``), the pretrained
  weights loaded, the adapters / prompts drawn afresh;
- ``combined``: both, LoRA on the FFN denses plus ``adapter_l`` plus prompts.
The base weights are frozen (``requires_grad_(False)``); the tuned set is
the LoRA factors and / or the adapter and prompt parameters. On the card
every attention of a forward that needs a gradient runs kernel K1 and its
backward K4 (``ops/attention_core.py``), and a layer-norm frontend's layer 0
runs K2.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .models import lora as lora_lib
from .models.loader import build_speech_encoder
from .models.speech import SpeechEncoderModel
from .train.lora_engine import WavLMWrapperModel
from .utils.device import resolve_device

METHODS = ("lora", "adapter", "adapter_l", "embedding_prompt", "combined")
LORA_ALPHA = 16.0  # the merge's alpha, the JAX package's merge_lora default


@dataclasses.dataclass
class WavLMWrapper:
    """What :func:`build_wavlm_wrapper` returns: the encoder (base frozen),
    the head, and the tuned set (``lora``: LoRA factors; ``finetune``: the
    adapter / prompt parameters of the encoder, by state-dict name)."""

    encoder: SpeechEncoderModel
    head: WavLMWrapperModel
    lora: lora_lib.Lora
    finetune: Dict[str, torch.nn.Parameter]
    method: str
    lora_rank: int
    do_normalize: bool

    def trainable(self):
        """The tuned tensors and the head's parameters, for an optimizer."""
        return ([t for pair in self.lora.values() for t in pair.values()] + list(self.finetune.values())
                + list(self.head.parameters()))

    def hidden_states(self, wav: torch.Tensor, mask: Optional[torch.Tensor] = None, plain: bool = False) -> Dict:
        """The encoder's output dict for waveforms [B, L] (sample mask [B, L]),
        the LoRA factors merged, ``W + (LORA_ALPHA / rank) A @ B``, where there are any."""
        if not self.lora:
            return self.encoder(wav, mask, plain=plain)
        base = lora_lib.lora_targets(self.encoder.state_dict(), self.lora)
        merged = lora_lib.merge_lora(base, self.lora, LORA_ALPHA, self.lora_rank)
        return torch.func.functional_call(self.encoder, merged, (wav, mask), {"plain": plain}, strict=False)

    def forward(self, wav: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, plain: bool = False) -> torch.Tensor:
        """Logits [B, output_class_num]; the head pools over each row's valid frames."""
        out = self.hidden_states(wav, mask, plain=plain)
        lengths = out["frame_mask"].sum(dim=1)
        return self.head(out["hidden_states"], lengths if mask is not None else None, generator)


def build_wavlm_wrapper(
    ssl_type: str = "microsoft/wavlm-base-plus",  # a local HF-format directory
    finetune_method: str = "lora",
    lora_rank: int = 16,
    hidden_dim: int = 256,
    output_class_num: int = 4,
    use_conv_output: bool = True,
    seed: int = 7,
    device="cuda",  # "cpu" only when asked: no card raises
) -> WavLMWrapper:
    """-> the encoder (base frozen), the head and the tuned set on ``device``.
    The fresh tensors are drawn from ``seed``: the LoRA factors, then the
    adapters / prompts layer by layer, then the head."""
    if finetune_method not in METHODS:
        raise ValueError(f"finetune_method {finetune_method!r}: expected one of {METHODS}")
    device = resolve_device(device)
    base, cfg, do_normalize = build_speech_encoder(ssl_type)
    gen = torch.Generator().manual_seed(seed)
    lora: lora_lib.Lora = {}
    if finetune_method in ("lora", "combined"):
        lora = lora_lib.init_lora(gen, base.state_dict(), lora_lib.match_ffn_dense, lora_rank)
    encoder = base
    if finetune_method != "lora":
        cfg = dataclasses.replace(cfg, finetune_method=finetune_method)
        with torch.device("meta"):
            encoder = SpeechEncoderModel(cfg)
        encoder = lora_lib.add_finetune_params(encoder.to_empty(device="cpu"), base.state_dict(), gen)
    encoder = lora_lib.freeze_base(encoder.to(device)).eval()
    lora = {p: {n: t.to(device).requires_grad_() for n, t in pair.items()} for p, pair in lora.items()}
    finetune = {n: p for n, p in encoder.named_parameters() if p.requires_grad}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(torch.randint(2 ** 31, (), generator=gen)))
        head = WavLMWrapperModel(cfg.num_layers, cfg.hidden_size, hidden_dim, output_class_num, use_conv_output)
    return WavLMWrapper(encoder, head.to(device), lora, finetune, finetune_method, lora_rank, do_normalize)
