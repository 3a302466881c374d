"""Speech SSL encoders: WavLM, wav2vec2 (XLS-R) and HuBERT in one skeleton.

Port of ``interspeech_ser_tpu/models/speech.py``: 7-layer strided conv
frontend (hop 320 at 16 kHz) -> feature projection -> grouped positional
conv -> transformer stack. The families differ in attention (WavLM adds a
gated relative position bias), in the frontend's norm (``'layer'``: a
LayerNorm over channels after every conv, the large / XL checkpoints;
``'group'``: a per-channel GroupNorm over time on layer 0 only, the base
checkpoints) and in where the stack normalises (``do_stable_layer_norm``:
pre-LN with a closing LayerNorm; otherwise post-LN with the encoder's
LayerNorm before the first layer). Presets: ``wavlm_large``,
``wav2vec2_xlsr_2b``, ``hubert_xlarge``.

Modules carry HF's state-dict key names (``feature_extractor.conv_layers.0.
conv.weight``, ``encoder.layers.3.attention.q_proj.weight``, ...), so an HF
checkpoint loads without a converter (``models/loader.py`` folds the
positional conv's weight norm first).

Compute dtype: f32 for parity, bf16 for throughput. Linear and conv layers
run in the compute dtype; LayerNorms and the softmax run in f32. Padded
frames are zeroed before the positional conv and masked out of attention,
so a batched padded forward equals each utterance's batch-1 forward.

Kernels on a CUDA tensor (each falls to its plain version on a CPU tensor,
and ``plain=True`` forces the plain versions, a reference run on the card):
- K1, every attention (K1 + K4 when a gradient is needed);
- K2, the first ``fused_frontend`` layers of a layer-norm frontend
  (``default_fused_frontend``: ``SER_TPU_FRONTEND``, else 1; ``xla`` or
  ``0`` runs no K2, as in the JAX package; a group-norm frontend runs no
  K2, its GroupNorm needs the whole sequence);
- K8, the positional conv, and K5, each feed-forward pair under
  ``SER_TPU_FFN_KERNEL=1`` (``default_ffn_kernel``), only with
  ``inference_kernels`` set: neither kernel has a backward, so the
  extraction pipeline sets it on a copy of the config and training leaves
  it off.
Both environment variables are read once, when the model is built, so a
model's routes stay fixed for its life.

``SpeechConfig.finetune_method`` adds the parameter-efficient fine-tune
hooks of every layer (``adapter``, ``adapter_l``, ``embedding_prompt``,
``combined``; see ``EncoderLayer``): their parameters carry the JAX
package's names, ``encoder.layers.{i}.adapter.{down,up}.*`` and
``encoder.layers.{i}.embed_prompt`` (``models/lora.py`` splits them out).

Tensor parallelism (``SpeechConfig.model_parallel`` > 1, built by
``parallel/tp.py``): each attention holds its rank's ``H / mp`` heads (the
column shards of q / k / v, the per-head slices of WavLM's relative-position
embedding and gate constant) and each feed-forward its ``F / mp`` columns;
the row-parallel ``out_proj`` / ``output_dense`` products are summed over
the model axis by one all-reduce each (in f32), and their bias added once,
after it. An inference path: the sums carry no gradient.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_core import dot_product_attention_btd
from ..ops.kernels.conv_frontend import FrontendLayer, conv_frontend, conv_frontend_plain
from ..ops.kernels.ffn_fused import ffn_fused, ffn_fused_plain
from ..ops.kernels.pos_conv import pos_conv, pos_conv_plain


@dataclasses.dataclass(frozen=True)
class SpeechConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # 'group' (base) | 'layer' (large/XL)
    do_stable_layer_norm: bool = False
    attention_type: str = "standard"  # 'standard' | 'wavlm'
    model_type: str = "wav2vec2"  # HF family of a standard-attention encoder: 'wav2vec2' | 'hubert'
    # the no-backward kernels K8 and K5: the extraction pipeline sets this on
    # a copy of the config; training leaves it off
    inference_kernels: bool = False
    num_buckets: int = 320
    max_distance: int = 800
    num_conv_pos_embeddings: int = 128
    conv_pos_groups: int = 16
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"  # compute dtype; parameters load in f32
    # parameter-efficient fine-tune hooks (lora_wavlm/model.py): 'adapter' | 'adapter_l' |
    # 'embedding_prompt' | 'combined' (LoRA itself is a state-dict transform, models/lora.py)
    finetune_method: Optional[str] = None
    adapter_hidden_dim: int = 128
    adapter_scalar: float = 0.1
    embedding_prompt_dim: int = 5
    # tensor parallelism: the model axis this rank's shard of the attention and
    # feed-forward belongs to (parallel/tp.py builds such a model)
    model_parallel: int = 1

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def use_approx_gelu(self) -> bool:
        """tanh GELU in bf16 (its error is below bf16 rounding), exact erf in f32."""
        return self.dtype == "bfloat16"

    @property
    def gelu_mode(self) -> str:
        return "tanh" if self.use_approx_gelu else "none"

    @classmethod
    def from_hf(cls, hf: Dict, dtype: str = "float32"):
        """Build from an HF WavLM/Wav2Vec2/Hubert ``config.json`` dict."""
        return cls(
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            conv_dim=tuple(hf["conv_dim"]),
            conv_kernel=tuple(hf["conv_kernel"]),
            conv_stride=tuple(hf["conv_stride"]),
            conv_bias=bool(hf.get("conv_bias", False)),
            feat_extract_norm=hf.get("feat_extract_norm", "group"),
            do_stable_layer_norm=bool(hf.get("do_stable_layer_norm", False)),
            attention_type="wavlm" if hf.get("model_type") == "wavlm" else "standard",
            model_type="hubert" if hf.get("model_type") == "hubert" else "wav2vec2",
            num_buckets=hf.get("num_buckets", 320),
            max_distance=hf.get("max_bucket_distance", 800),
            num_conv_pos_embeddings=hf.get("num_conv_pos_embeddings", 128),
            conv_pos_groups=hf.get("num_conv_pos_embedding_groups", 16),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
            dtype=dtype,
        )

    def to_hf(self) -> Dict:
        """The ``config.json`` fields :meth:`from_hf` reads."""
        return {
            "model_type": "wavlm" if self.attention_type == "wavlm" else self.model_type,
            "hidden_size": self.hidden_size,
            "num_hidden_layers": self.num_layers,
            "num_attention_heads": self.num_heads,
            "intermediate_size": self.intermediate_size,
            "conv_dim": list(self.conv_dim),
            "conv_kernel": list(self.conv_kernel),
            "conv_stride": list(self.conv_stride),
            "num_feat_extract_layers": len(self.conv_dim),
            "conv_bias": self.conv_bias,
            "feat_extract_norm": self.feat_extract_norm,
            "do_stable_layer_norm": self.do_stable_layer_norm,
            "num_buckets": self.num_buckets,
            "max_bucket_distance": self.max_distance,
            "num_conv_pos_embeddings": self.num_conv_pos_embeddings,
            "num_conv_pos_embedding_groups": self.conv_pos_groups,
            "layer_norm_eps": self.layer_norm_eps,
        }


def wavlm_large(dtype: str = "float32") -> SpeechConfig:
    return SpeechConfig(
        hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096,
        conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True,
        attention_type="wavlm", dtype=dtype,
    )


def wav2vec2_xlsr_2b(dtype: str = "float32") -> SpeechConfig:
    return SpeechConfig(
        hidden_size=1920, num_layers=48, num_heads=16, intermediate_size=7680,
        conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True,
        attention_type="standard", model_type="wav2vec2", dtype=dtype,
    )


def hubert_xlarge(dtype: str = "float32") -> SpeechConfig:
    return SpeechConfig(
        hidden_size=1280, num_layers=48, num_heads=16, intermediate_size=5120,
        conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True,
        attention_type="standard", model_type="hubert", dtype=dtype,
    )


FRONTEND_DEPTHS = ("xla",) + tuple(str(n) for n in range(0, 8))  # the SER_TPU_FRONTEND values the port honours


def default_fused_frontend(cfg: SpeechConfig) -> int:
    """How many frontend layers K2 runs: ``SER_TPU_FRONTEND=<n>`` (0..7; ``xla``
    means 0, every conv layer on the cuDNN route, as in the JAX package; any
    other value raises), else 1, for a layer-norm frontend; 0 for a
    group-norm one, whose GroupNorm needs the whole sequence."""
    env = os.environ.get("SER_TPU_FRONTEND")
    if env is not None and env not in FRONTEND_DEPTHS:
        raise ValueError(f"SER_TPU_FRONTEND={env!r}: the port honours {'|'.join(FRONTEND_DEPTHS)}")
    if cfg.feat_extract_norm != "layer" or env == "xla":
        return 0
    return min(int(env or 1), len(cfg.conv_dim))


def default_ffn_kernel(cfg: SpeechConfig) -> bool:
    """Whether each feed-forward pair runs K5: ``SER_TPU_FFN_KERNEL=1`` with
    ``inference_kernels`` set, on one model rank (K5 stays off under tensor
    parallelism, as the JAX package keeps XLA there)."""
    return cfg.inference_kernels and cfg.model_parallel == 1 and os.environ.get("SER_TPU_FFN_KERNEL") == "1"


def feat_extract_output_length(length, config: SpeechConfig):
    """Conv-frontend output length (ints or integer tensors)."""
    for k, s in zip(config.conv_kernel, config.conv_stride):
        length = (length - k) // s + 1
    return length


def _dense(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dt), lin.weight.to(dt), None if lin.bias is None else lin.bias.to(dt))


def _row_parallel(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype, mesh) -> torch.Tensor:
    """A row-parallel Linear: the rank's partial product, summed in f32 over
    the model axis, then the bias, once."""
    from ..parallel.mesh import all_reduce

    part = F.linear(x.to(dt), lin.weight.to(dt)).float()
    return (all_reduce(mesh, part, "model") + lin.bias.float()).to(dt)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in f32 on any input dtype (params upcast)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps)


class ConvLayer(nn.Module):
    """One frontend layer: conv -> norm -> GELU. HF's ``*LayerNormConvLayer``
    (``norm='layer'``), ``*GroupNormConvLayer`` (``'group'``: GroupNorm with
    one group per channel, named ``layer_norm`` as in HF) or
    ``*NoLayerNormConvLayer`` (``None``)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, s: int, bias: bool, eps: float, norm: Optional[str]):
        super().__init__()
        self.stride = s
        self.conv = nn.Conv1d(in_ch, out_ch, k, stride=s, bias=bias)
        if norm == "layer":
            self.layer_norm = nn.LayerNorm(out_ch, eps=eps)
        elif norm == "group":
            self.layer_norm = nn.GroupNorm(out_ch, out_ch, eps=1e-5)

    def fused(self) -> FrontendLayer:
        return FrontendLayer(self.conv.weight, self.conv.bias, self.layer_norm.weight, self.layer_norm.bias,
                             self.stride)


class ConvFeatureExtractor(nn.Module):
    """7-layer strided conv frontend. Its first ``depth`` layers (layer-norm
    mode) run fused from the waveform (K2, or its plain version on the CPU);
    the rest run layer by layer, layer 0 as a patch matmul."""

    def __init__(self, cfg: SpeechConfig):
        super().__init__()
        if cfg.feat_extract_norm not in ("layer", "group"):
            raise ValueError(f"feat_extract_norm {cfg.feat_extract_norm!r}: expected 'layer' or 'group'")
        self.cfg = cfg
        chans = (1,) + tuple(cfg.conv_dim)
        layer_mode = cfg.feat_extract_norm == "layer"
        self.conv_layers = nn.ModuleList(
            ConvLayer(chans[i], chans[i + 1], k, s, cfg.conv_bias, cfg.layer_norm_eps,
                      "layer" if layer_mode else ("group" if i == 0 else None))
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride))
        )

    def forward(self, wav: torch.Tensor, depth: int, plain: bool = False) -> torch.Tensor:  # [B, L] -> [B, T, C]
        cfg = self.cfg
        dt = cfg.compute_dtype
        x = wav
        if depth:  # layer-norm frontends only (default_fused_frontend)
            x = (conv_frontend_plain if plain else conv_frontend)(
                wav.float().contiguous(), [layer.fused() for layer in self.conv_layers[:depth]], dt,
                cfg.use_approx_gelu, cfg.layer_norm_eps,
            )  # [B, T, C] in dt
        for i in range(depth, len(self.conv_layers)):
            layer = self.conv_layers[i]
            conv = layer.conv
            bias = None if conv.bias is None else conv.bias.to(dt)
            if i == 0:  # C_in = 1: the patch matmul, as the JAX package runs it
                C, _, k = conv.weight.shape
                y = wav.to(dt).unfold(1, k, layer.stride) @ conv.weight.reshape(C, k).to(dt).t()
                if bias is not None:
                    y = y + bias
            else:
                y = F.conv1d(x.transpose(1, 2), conv.weight.to(dt), bias, stride=layer.stride).transpose(1, 2)
            if cfg.feat_extract_norm == "layer":
                y = _layer_norm(y, layer.layer_norm).to(dt)
            elif i == 0:  # per-channel statistics over the whole (padded) sequence, f32
                gn = layer.layer_norm
                y = F.group_norm(y.float().transpose(1, 2), gn.num_groups, gn.weight.float(), gn.bias.float(),
                                 gn.eps).transpose(1, 2).to(dt)
            x = F.gelu(y, approximate=cfg.gelu_mode)
        return x


class FeatureProjection(nn.Module):
    def __init__(self, cfg: SpeechConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embedding (k=128, 16 groups, SAME padding,
    last frame dropped for an even kernel, GELU). The checkpoint's weight
    norm is folded into ``conv.weight`` at load time."""

    def __init__(self, cfg: SpeechConfig):
        super().__init__()
        self.cfg = cfg
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(
            cfg.hidden_size, cfg.hidden_size, k, padding=k // 2, groups=cfg.conv_pos_groups
        )

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:  # [B, T, D]
        cfg = self.cfg
        dt = cfg.compute_dtype
        k = cfg.num_conv_pos_embeddings
        if cfg.inference_kernels:  # K8, then the bias outside the kernel as in the JAX package
            h = (pos_conv_plain if plain else pos_conv)(x.to(dt), self.conv.weight, cfg.conv_pos_groups)
            h = h + self.conv.bias.to(dt)
        elif dt == torch.bfloat16 and not x.is_cuda:
            # torch's CPU conv1d returns wrong bf16 values for some grouped shapes (8 channels a
            # group, k=16: wrong in every digit); the same bf16 operands, accumulated in f32 and
            # rounded, are what a bf16 conv computes
            h = F.conv1d(
                x.float().transpose(1, 2), self.conv.weight.to(dt).float(), self.conv.bias.to(dt).float(),
                padding=k // 2, groups=cfg.conv_pos_groups,
            ).to(dt).transpose(1, 2)
        else:
            h = F.conv1d(
                x.transpose(1, 2), self.conv.weight.to(dt), self.conv.bias.to(dt),
                padding=k // 2, groups=cfg.conv_pos_groups,
            ).transpose(1, 2)
        if k % 2 == 0:
            h = h[:, :-1]
        return F.gelu(h, approximate=cfg.gelu_mode)


def relative_position_buckets(tq: int, tk: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """WavLM's bucketed relative positions (T5-style, bidirectional), [tq, tk]."""
    relative = np.arange(tk)[None, :] - np.arange(tq)[:, None]
    nb = num_buckets // 2
    buckets = (relative > 0).astype(np.int64) * nb
    rel_abs = np.abs(relative)
    max_exact = nb // 2
    is_small = rel_abs < max_exact
    large = max_exact + (
        np.log(np.maximum(rel_abs, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(is_small, rel_abs, large)


class SpeechSelfAttention(nn.Module):
    """Self-attention; the WavLM flavour adds the gated relative position
    bias (the embedding lives on layer 0 and is shared by every layer)."""

    def __init__(self, cfg: SpeechConfig, has_relative_position_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        D, H, mp = cfg.hidden_size, cfg.num_heads, cfg.model_parallel
        self.q_proj = nn.Linear(D, D // mp)
        self.k_proj = nn.Linear(D, D // mp)
        self.v_proj = nn.Linear(D, D // mp)
        self.out_proj = nn.Linear(D // mp, D)
        self.has_relative_position_bias = has_relative_position_bias
        self.tp_mesh = None  # the model axis's mesh when model_parallel > 1 (parallel/tp.py)
        if cfg.attention_type == "wavlm":
            self.gru_rel_pos_linear = nn.Linear(D // H, 8)
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, H // mp, 1, 1))
            if has_relative_position_bias:
                self.rel_attn_embed = nn.Embedding(cfg.num_buckets, H // mp)

    def forward(self, x, key_mask, position_bias, plain: bool = False):
        cfg = self.cfg
        D, mp = cfg.hidden_size, cfg.model_parallel
        hd = D // cfg.num_heads
        H = cfg.num_heads // mp  # this rank's heads
        dt = cfg.compute_dtype
        B, T, _ = x.shape
        q = _dense(x, self.q_proj, dt)
        k = _dense(x, self.k_proj, dt)
        v = _dense(x, self.v_proj, dt)
        gate = None
        if cfg.attention_type == "wavlm":
            if self.has_relative_position_bias:
                buckets = torch.from_numpy(
                    relative_position_buckets(T, T, cfg.num_buckets, cfg.max_distance)
                ).to(x.device)
                # [H, T, T] f32, built once, shared by every layer, as in the JAX package: each
                # attention rounds it to the compute dtype, so the layers' gradients sum in f32
                position_bias = self.rel_attn_embed.weight[buckets].permute(2, 0, 1).contiguous()
            assert position_bias is not None, "layers > 0 need layer 0's position_bias"
            # per-(batch, head, query) gate from the layer's input x, per head (the rank's heads)
            gate_in = x.reshape(B, T, cfg.num_heads, hd)
            if mp > 1:
                gate_in = gate_in[:, :, self.tp_mesh.model_rank * H: (self.tp_mesh.model_rank + 1) * H]
            gate_in = gate_in.transpose(1, 2)  # [B, H, T, hd]
            proj = _dense(gate_in, self.gru_rel_pos_linear, dt).float()
            gates = torch.sigmoid(proj.reshape(B, H, T, 2, 4).sum(-1))  # [B, H, T, 2]
            const = self.gru_rel_pos_const.float().reshape(1, H, 1)
            gate = gates[..., 0] * (gates[..., 1] * const - 1.0) + 2.0  # [B, H, T]
        out = dot_product_attention_btd(
            q, k, v, H, key_mask=key_mask, gate=gate,
            shared_bias=position_bias if cfg.attention_type == "wavlm" else None,
            plain=plain,
        )
        if mp > 1:
            return _row_parallel(out, self.out_proj, dt, self.tp_mesh), position_bias
        return _dense(out, self.out_proj, dt), position_bias


class FeedForward(nn.Module):
    def __init__(self, cfg: SpeechConfig, fused: bool = False):
        super().__init__()
        self.cfg = cfg
        self.fused = fused  # K5 (default_ffn_kernel)
        mp = cfg.model_parallel
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size // mp)
        self.output_dense = nn.Linear(cfg.intermediate_size // mp, cfg.hidden_size)
        self.tp_mesh = None  # the model axis's mesh when model_parallel > 1 (parallel/tp.py)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        if self.fused:  # K5
            up, down = self.intermediate_dense, self.output_dense
            out = (ffn_fused_plain if plain else ffn_fused)(
                x.to(dt).reshape(-1, x.shape[-1]), up.weight, up.bias, down.weight, down.bias, cfg.use_approx_gelu,
            )
            return out.reshape(x.shape)
        h = F.gelu(_dense(x, self.intermediate_dense, dt), approximate=cfg.gelu_mode)
        if cfg.model_parallel > 1:
            return _row_parallel(h, self.output_dense, dt, self.tp_mesh)
        return _dense(h, self.output_dense, dt)


FINETUNE_METHODS = ("adapter", "adapter_l", "embedding_prompt", "combined")


class Adapter(nn.Module):
    """Bottleneck adapter: down-projection, ReLU, a zero-init up-projection,
    times ``scalar``, so that a fresh adapter outputs exactly 0. The reference
    never defines its ``Adapter`` (an unbound name in lora_wavlm/model.py);
    this is the JAX package's design. It runs in f32 on any input dtype, as
    flax promotes a bf16 input against f32 parameters."""

    def __init__(self, hidden_size: int, bottleneck: int, scalar: float = 0.1):
        super().__init__()
        self.scalar = scalar
        self.down = nn.Linear(hidden_size, bottleneck)
        self.up = nn.Linear(bottleneck, hidden_size)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """``down`` lecun-normal (a normal truncated at 2 std, scaled to
        variance 1 / fan_in, flax's ``lecun_normal``), ``up`` and both biases zeros."""
        std = (1.0 / self.down.in_features) ** 0.5 / 0.87962566103423978
        lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # the normal's CDF at -2
        with torch.no_grad():
            u = torch.rand(self.down.weight.shape, generator=generator) * (1.0 - 2.0 * lo) + lo
            w = (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)).clamp(-2.0, 2.0)  # inverse CDF in [-2, 2]
            self.down.weight.copy_(w * std)
            for t in (self.down.bias, self.up.weight, self.up.bias):
                t.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scalar * self.up(torch.relu(self.down(x.float())))


def init_prompt(prompt: torch.Tensor, generator: Optional[torch.Generator] = None) -> None:
    """flax ``xavier_uniform`` on (1, P, D): fan_in = P, fan_out = D, bound
    sqrt(6 / (P + D)) (torch's ``xavier_uniform_`` would read fan_in = P * D)."""
    _, P, D = prompt.shape
    bound = (6.0 / (P + D)) ** 0.5
    with torch.no_grad():
        prompt.copy_((torch.rand(prompt.shape, generator=generator) * 2 - 1) * bound)


class EncoderLayer(nn.Module):
    """Transformer layer: pre-LN (``do_stable_layer_norm``) or post-LN, with
    the fine-tune hooks of ``cfg.finetune_method``, in the JAX package's order:
    ``adapter`` reads the attention residual (pre-LN: x after attention;
    post-LN: x_res before ``layer_norm``) and is added after the FFN residual;
    ``adapter_l`` / ``combined`` add ``adapter(x)`` after the FFN (post-LN:
    before ``final_layer_norm``); ``embedding_prompt`` / ``combined`` prepend
    P learned rows before attention (the key mask extended by ones; layer 0's
    relative-position bias built over T + P) and strip them after the layer."""

    def __init__(self, cfg: SpeechConfig, has_relative_position_bias: bool = False, ffn_kernel: bool = False):
        super().__init__()
        self.cfg = cfg
        ft = cfg.finetune_method
        if ft is not None and ft not in FINETUNE_METHODS:
            raise ValueError(f"finetune_method {ft!r}: expected one of {FINETUNE_METHODS}")
        self.attention = SpeechSelfAttention(cfg, has_relative_position_bias)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg, ffn_kernel)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        if ft in ("adapter", "adapter_l", "combined"):
            self.adapter = Adapter(cfg.hidden_size, cfg.adapter_hidden_dim, cfg.adapter_scalar)
        if ft in ("embedding_prompt", "combined"):
            self.embed_prompt = nn.Parameter(torch.empty(1, cfg.embedding_prompt_dim, cfg.hidden_size))
            init_prompt(self.embed_prompt)

    def forward(self, x, key_mask, position_bias, plain: bool = False):
        dt = self.cfg.compute_dtype
        ft = self.cfg.finetune_method
        P = self.cfg.embedding_prompt_dim if ft in ("embedding_prompt", "combined") else 0
        if P:
            B = x.shape[0]
            x = torch.cat([self.embed_prompt.to(x.dtype).expand(B, -1, -1), x], dim=1)
            if key_mask is not None:
                key_mask = torch.cat([key_mask.new_ones(B, P), key_mask], dim=1)
        if self.cfg.do_stable_layer_norm:
            h, position_bias = self.attention(
                _layer_norm(x, self.layer_norm).to(dt), key_mask, position_bias, plain
            )
            x = x + h
            adapt_h = self.adapter(x) if ft == "adapter" else None
            x = x + self.feed_forward(_layer_norm(x, self.final_layer_norm).to(dt), plain)
        else:
            h, position_bias = self.attention(x, key_mask, position_bias, plain)
            x_res = x + h
            adapt_h = self.adapter(x_res) if ft == "adapter" else None
            x = _layer_norm(x_res, self.layer_norm).to(dt)
            x = x + self.feed_forward(x, plain)
        if adapt_h is not None:
            x = x + adapt_h
        if ft in ("adapter_l", "combined"):
            x = x + self.adapter(x)
        if not self.cfg.do_stable_layer_norm:
            x = _layer_norm(x, self.final_layer_norm).to(dt)
        return (x[:, P:] if P else x), position_bias


class Encoder(nn.Module):
    def __init__(self, cfg: SpeechConfig, ffn_kernel: bool = False):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, has_relative_position_bias=(i == 0), ffn_kernel=ffn_kernel)
            for i in range(cfg.num_layers)
        )


class SpeechEncoderModel(nn.Module):
    """wav -> conv frontend -> projection -> transformer stack.

    Returns ``hidden_states`` (num_layers + 1 entries, HF indexing: [0] the
    post-positional-conv embeddings (after the encoder's LayerNorm for a
    post-LN stack), [i] layer i-1's output, the last entry carrying the
    closing LayerNorm of a pre-LN stack), ``last_hidden_state`` and the
    frame-level ``frame_mask``. ``keep`` (HF indices, negatives allowed)
    limits which hidden states are kept; the others are ``None``.
    ``fused_frontend`` is K2's depth, from ``default_fused_frontend``, and
    ``ffn_kernel`` whether the feed-forward pairs run K5, from
    ``default_ffn_kernel``; both are fixed when the model is built.
    """

    def __init__(self, config: SpeechConfig):
        super().__init__()
        self.config = config
        self.fused_frontend = default_fused_frontend(config)
        self.ffn_kernel = default_ffn_kernel(config)
        self.feature_extractor = ConvFeatureExtractor(config)
        self.feature_projection = FeatureProjection(config)
        self.encoder = Encoder(config, self.ffn_kernel)

    def forward(
        self,
        wav: torch.Tensor,  # [B, L], already feature-extractor normalised
        wav_mask: Optional[torch.Tensor] = None,  # [B, L], 1 = valid sample
        keep: Optional[Iterable[int]] = None,
        plain: bool = False,
    ) -> Dict:
        cfg = self.config
        dt = cfg.compute_dtype
        n = cfg.num_layers
        keep = set(range(n + 1)) if keep is None else {i % (n + 1) for i in keep}
        feats = self.feature_extractor(wav, self.fused_frontend, plain)
        B, T, _ = feats.shape
        if wav_mask is not None:
            lengths = feat_extract_output_length(wav_mask.sum(dim=-1).long(), cfg)
            frame_mask = (torch.arange(T, device=wav.device)[None, :] < lengths[:, None]).float()
        else:
            frame_mask = torch.ones(B, T, device=wav.device)

        fp = self.feature_projection
        h = _dense(_layer_norm(feats, fp.layer_norm), fp.projection, dt)
        h = h * frame_mask[:, :, None].to(dt)  # zero padded frames before the pos conv
        h = h + self.encoder.pos_conv_embed(h, plain)
        if not cfg.do_stable_layer_norm:
            h = _layer_norm(h, self.encoder.layer_norm).to(dt)

        hidden: List[Optional[torch.Tensor]] = [h if 0 in keep else None]
        position_bias = None
        for i, layer in enumerate(self.encoder.layers):
            h, position_bias = layer(h, frame_mask, position_bias, plain)
            hidden.append(h if i + 1 in keep else None)
        if cfg.do_stable_layer_norm:
            h = _layer_norm(h, self.encoder.layer_norm).to(dt)
            hidden[-1] = h if n in keep else None
        return {"last_hidden_state": h, "hidden_states": hidden, "frame_mask": frame_mask}


def with_config(model: SpeechEncoderModel, config: SpeechConfig) -> SpeechEncoderModel:
    """The same parameters (shared, not copied) under another config, with
    K2's depth and K5's route from ``default_fused_frontend`` and
    ``default_ffn_kernel`` of that config."""
    with torch.device("meta"):
        out = SpeechEncoderModel(config)
    out.load_state_dict(model.state_dict(), strict=True, assign=True)
    return out.train(model.training)
