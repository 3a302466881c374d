"""NS3 FACodec prosody path (NaturalSpeech3 encoder / decoder subset), in plain PyTorch.

Port of ``interspeech_ser_tpu/models/ns3/facodec.py``, which computes it
with XLA convolutions and einsums and no Pallas kernel, so this path has no
hand-written kernel either: cuDNN convolutions and cuBLAS GEMMs on the card.

The reference extracts two trimodal prosody features per utterance: the
wav padded to a multiple of 200 samples, its 80-bin log-mel cut to the
first 20 bins, ``melspec_linear`` (20 -> 256), a 4-layer NS3 transformer
and the prosody factorized VQ (1024 x 8 codebook), decoded through the
un-normalised codebook -> [T, 256]; the speaker variant adds the
FACodecEncoderV2 conv stack (SnakeBeta activations with alias-free
kaiser-sinc resampling, hop 200) through the timbre transformer -> [T, 512].

Layouts are feature-first inside the conv stack (``[B, C, T]``, PyTorch's
conv idiom) and feature-last (``[B, T, C]``) at the module edges. The NS3
transformer keeps the reference's positional-encoding quirk: a batch-first
tensor gets ``pe[b]`` on every step of row b (``pe_batch1=True`` gives every
row ``pe[0]``, what each utterance sees in the reference's batch-1 runs).
State-dict names follow the reference where a module has one (``block.*``
of the encoder, ``layers.*`` / ``last_ln`` of a transformer);
``models/loader.py::ns3_state_dict_from_reference`` maps the reference's
``.bin`` files onto :class:`ProsodyExtractor`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import TorchMultiheadAttention
from ...ops.mel import get_prosody_feature

HOP = 200  # samples a frame (the product of the encoder's strides)


# -- alias-free SnakeBeta activation -------------------------------------------


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    time = np.arange(-half_size, half_size) + 0.5 if even else np.arange(kernel_size) - half_size
    f = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    f /= f.sum()
    return f.astype(np.float32)


# the low-pass filter of both the 2x upsample and the 2x downsample
RESAMPLE_FILTER = kaiser_sinc_filter1d(0.25, 0.3, 12)


def snake_beta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """x + 1 / (exp(beta) + 1e-9) * sin^2(x * exp(alpha)); x [B, C, T], log-scale parameters [C]."""
    a = torch.exp(alpha)[None, :, None]
    b = torch.exp(beta)[None, :, None]
    return x + (1.0 / (b + 1e-9)) * torch.sin(x * a).square()


def upsample2(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """2x kaiser-sinc upsample, [B, C, T] -> [B, C, 2T]: 5 samples of
    replicate padding, a stride-2 depthwise transposed conv, times 2, and
    the 15 samples the padding produced cut from each end."""
    C, k = x.shape[1], filt.shape[-1]
    pad = k // 2 - 1
    y = 2.0 * F.conv_transpose1d(F.pad(x, (pad, pad), mode="replicate"), filt.expand(C, 1, k), stride=2, groups=C)
    return y[..., pad * 2 + (k - 2) // 2: -(pad * 2 + (k - 1) // 2)]


def downsample2(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """2x low-pass downsample, [B, C, 2T] -> [B, C, T]: replicate padding
    (5 samples left, 6 right) and a stride-2 depthwise conv."""
    C, k = x.shape[1], filt.shape[-1]
    x = F.pad(x, (k // 2 - int(k % 2 == 0), k // 2), mode="replicate")
    return F.conv1d(x, filt.expand(C, 1, k), stride=2, groups=C)


class SnakeBeta(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))


class SnakeAct1d(nn.Module):
    """The reference's ``Activation1d(SnakeBeta)``: 2x upsample, SnakeBeta, 2x downsample."""

    def __init__(self, channels: int):
        super().__init__()
        self.act = SnakeBeta(channels)
        self.register_buffer("filter", torch.from_numpy(RESAMPLE_FILTER).view(1, 1, -1), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        h = snake_beta(upsample2(x, self.filter), self.act.alpha, self.act.beta)
        return downsample2(h, self.filter)


# -- FACodecEncoderV2 conv stack ---------------------------------------------


class ResidualUnit(nn.Module):
    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.block = nn.Sequential(
            SnakeAct1d(dim), nn.Conv1d(dim, dim, 7, dilation=dilation, padding=3 * dilation),
            SnakeAct1d(dim), nn.Conv1d(dim, dim, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block(x)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int):
        super().__init__()
        half = dim // 2
        self.block = nn.Sequential(
            ResidualUnit(half, 1), ResidualUnit(half, 3), ResidualUnit(half, 9), SnakeAct1d(half),
            nn.Conv1d(half, dim, 2 * stride, stride=stride, padding=stride // 2 + stride % 2),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class FACodecEncoderV2Model(nn.Module):
    """wav [B, L] (L a multiple of the strides' product) -> [B, L / prod(up_ratios), out_channels]."""

    def __init__(self, ngf: int = 32, up_ratios: Tuple[int, ...] = (2, 4, 5, 5), out_channels: int = 256):
        super().__init__()
        d = ngf
        blocks = [nn.Conv1d(1, d, 7, padding=3)]
        for stride in up_ratios:
            d *= 2
            blocks.append(EncoderBlock(d, stride))
        blocks += [SnakeAct1d(d), nn.Conv1d(d, out_channels, 3, padding=1)]
        self.block = nn.Sequential(*blocks)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.block(wav.float()[:, None]).transpose(1, 2)


# -- NS3 transformer ------------------------------------------------------------


def ns3_positional_table(max_len: int, d_model: int) -> np.ndarray:
    position = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


class ConvFFN(nn.Module):
    def __init__(self, hidden: int, filter_size: int, kernel_size: int):
        super().__init__()
        self.ffn_1 = nn.Conv1d(hidden, filter_size, kernel_size, padding=kernel_size // 2)
        self.ffn_2 = nn.Linear(filter_size, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, hidden]
        return self.ffn_2(F.relu(self.ffn_1(x.transpose(1, 2)).transpose(1, 2)))


class NS3Layer(nn.Module):
    """Pre-LN: self-attention, then a conv FFN (kernel 5) with ReLU."""

    def __init__(self, hidden: int, heads: int, filter_size: int, kernel_size: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(hidden, eps=1e-5)
        self.self_attn = TorchMultiheadAttention(hidden, heads)
        self.ln_2 = nn.LayerNorm(hidden, eps=1e-5)
        self.ffn = ConvFFN(hidden, filter_size, kernel_size)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.ln_1(x)
        x = x + self.self_attn(h, h, h, key_mask=key_mask)
        h = self.ln_2(x)
        if key_mask is not None:
            # the padded tail is zero before the conv FFN, so the last valid
            # frame sees zeros past it, as at the reference's unpadded edge
            h = h * key_mask[:, :, None].to(h.dtype)
        return x + self.ffn(h)


class NS3TransformerEncoder(nn.Module):
    """The reference's 4-layer pre-LN transformer with its positional
    encoding: row b gets ``pe[b]`` at every step (``pe_batch1=True``: every
    row gets ``pe[0]``)."""

    def __init__(self, hidden: int = 256, heads: int = 4, layers: int = 4, filter_size: int = 1024,
                 kernel_size: int = 5, max_len: int = 5000):
        super().__init__()
        self.layers = nn.ModuleList(NS3Layer(hidden, heads, filter_size, kernel_size) for _ in range(layers))
        self.last_ln = nn.LayerNorm(hidden, eps=1e-5)
        self.register_buffer("pe", torch.from_numpy(ns3_positional_table(max_len, hidden)), persistent=False)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None, pe_batch1: bool = False):
        x = x + (self.pe[0][None, None] if pe_batch1 else self.pe[: x.shape[0]][:, None])
        for layer in self.layers:
            x = layer(x, key_mask)
        return self.last_ln(x)


# -- factorized VQ ------------------------------------------------------------


def fvq_forward(
    z: torch.Tensor,  # [B, T, D] pre-projection latents
    in_weight: torch.Tensor,  # [d_code, D]
    in_bias: torch.Tensor,
    out_weight: torch.Tensor,  # [D, d_code]
    out_bias: torch.Tensor,
    codebook: torch.Tensor,  # [N, d_code]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (quantized [B, T, D], indices [B, T] int64); the inference path.
    The distance is the reference's expression in its order, on
    L2-normalised vectors; the decode reads the un-normalised codebook."""
    z_e = z @ in_weight.t() + in_bias
    e = z_e / torch.linalg.vector_norm(z_e, dim=-1, keepdim=True).clamp_min(1e-12)
    c = codebook / torch.linalg.vector_norm(codebook, dim=-1, keepdim=True).clamp_min(1e-12)
    dist = (e * e).sum(-1, keepdim=True) - 2 * e @ c.t() + (c * c).sum(-1)[None, None, :]
    indices = torch.argmax(-dist, dim=-1)
    return codebook[indices] @ out_weight.t() + out_bias, indices


class FactorizedVQ(nn.Module):
    def __init__(self, dim: int = 256, code_dim: int = 8, codebook_size: int = 1024):
        super().__init__()
        self.in_proj = nn.Linear(dim, code_dim)
        self.out_proj = nn.Linear(code_dim, dim)
        self.codebook = nn.Embedding(codebook_size, code_dim)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return fvq_forward(z, self.in_proj.weight, self.in_proj.bias, self.out_proj.weight, self.out_proj.bias,
                           self.codebook.weight)


# -- the extractor --------------------------------------------------------------


class ProsodyExtractor(nn.Module):
    """The decoder's prosody path (and, ``with_speaker``, the encoder's conv
    stack through the timbre transformer).

    ``forward`` is the reference's literal forward (batch-1 runs, golden
    tests). ``extract_batched`` is the pipeline path: host reflect-padded
    mel input, frame masks and every row given ``pe[0]``, which reproduces
    each utterance's batch-1 output inside a padded batch. The prosody
    branch is exact; in the speaker variant the conv stack sees the
    bucket's zero padding past each utterance's end (the resampling
    replicate-pads the bucket edge, not the utterance's), so
    ``tail_exact`` re-runs the stack on a right-aligned window of
    ``TAIL_WINDOW_FRAMES`` frames that ends at each utterance's true end and
    overwrites its last ``FIX_FRAMES`` valid frames with those values.
    Utterances shorter than the window keep the approximation (~3 frames).
    ``codes`` gives the VQ indices (int32, as the JAX package saves them).
    """

    TAIL_WINDOW_FRAMES = 96
    FIX_FRAMES = 48

    def __init__(self, with_speaker: bool = False, tail_exact: bool = True):
        super().__init__()
        self.with_speaker = with_speaker
        self.tail_exact = tail_exact
        self.melspec_linear = nn.Linear(20, 256)
        self.melspec_encoder = NS3TransformerEncoder()
        self.fvq = FactorizedVQ()
        if with_speaker:
            self.encoder = FACodecEncoderV2Model()
            self.timbre_encoder = NS3TransformerEncoder()

    def prosody_latents(self, wav: torch.Tensor, pre_padded: bool = False, key_mask=None, pe_batch1=False):
        """The prosody transformer's output, [B, T, 256]: the VQ's input."""
        f0 = self.melspec_linear(get_prosody_feature(wav, pre_padded).transpose(1, 2))
        return self.melspec_encoder(f0, key_mask=key_mask, pe_batch1=pe_batch1)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """wav [B, L], L % 200 == 0 -> prosody [B, T, 256] (speaker: [B, T, 512])."""
        out, _ = self.fvq(self.prosody_latents(wav))
        if not self.with_speaker:
            return out
        return torch.cat([out, self.timbre_encoder(self.encoder(wav))], dim=-1)

    def extract_batched(
        self,
        wav: torch.Tensor,  # [B, Lb] zero-padded to the bucket, each L_i % 200 == 0
        wav_reflect: torch.Tensor,  # [B, Lb + 824], each utterance reflect-padded by 412 on the host
        frame_mask: torch.Tensor,  # [B, Lb / 200], 1 for t < L_i / 200
    ) -> torch.Tensor:
        out, _ = self.fvq(self.prosody_latents(wav_reflect, pre_padded=True, key_mask=frame_mask, pe_batch1=True))
        if not self.with_speaker:
            return out
        enc = self.encoder(wav)
        if self.tail_exact:
            enc = self._fix_tail(wav, enc, frame_mask)
        enc = enc * frame_mask[:, :, None]
        timbre = self.timbre_encoder(enc, key_mask=frame_mask, pe_batch1=True)
        return torch.cat([out, timbre], dim=-1)

    def _fix_tail(self, wav: torch.Tensor, enc: torch.Tensor, frame_mask: torch.Tensor) -> torch.Tensor:
        """Overwrite each utterance's last FIX_FRAMES conv features with an
        exact re-run on a right-aligned tail window (its true end at the
        tensor's edge, so every replicate pad acts on its real last samples).
        Source indices before a row's start (all of them in a zero row of
        the batch padding) are clamped into range and their samples zeroed."""
        R, FIX = self.TAIL_WINDOW_FRAMES, self.FIX_FRAMES
        Lb = wav.shape[1]
        T, C = enc.shape[1], enc.shape[2]
        t_valid = frame_mask.sum(dim=1).to(torch.int64)  # [B]
        src = (t_valid * HOP)[:, None] - R * HOP + torch.arange(R * HOP, device=wav.device)[None]
        tail = torch.gather(wav, 1, src.clamp(0, Lb - 1)) * (src >= 0)
        enc_tail = self.encoder(tail)  # [B, R, C]
        t = torch.arange(T, device=wav.device)[None]
        tail_idx = (t - t_valid[:, None] + R).clamp(0, R - 1)
        gathered = torch.gather(enc_tail, 1, tail_idx[:, :, None].expand(-1, -1, C))
        fix = (t >= t_valid[:, None] - FIX) & (t < t_valid[:, None]) & (t_valid[:, None] >= R)
        return torch.where(fix[:, :, None], gathered, enc)

    def codes(self, wav: torch.Tensor) -> torch.Tensor:
        """Prosody VQ indices [B, T] int32 of the literal forward (the
        ``..._prosodycodes`` variant)."""
        _, idx = self.fvq(self.prosody_latents(wav))
        return idx.to(torch.int32)
