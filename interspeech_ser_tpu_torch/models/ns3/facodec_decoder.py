"""FACodec full decoder and redecoder (NaturalSpeech3), in plain PyTorch.

Port of ``interspeech_ser_tpu/models/ns3/facodec_decoder.py``, which computes
it with XLA convolutions and einsums and no Pallas kernel, so this path has
no hand-written kernel either: cuDNN convolutions, cuBLAS GEMMs and the
plain attention of ``ops/attention.py`` on the card.

The rest of the codec beyond the prosody extraction of ``facodec.py``: the
three residual-VQ banks (prosody, content, residual) with the training path
(straight-through estimator, commitment and codebook losses, quantizer
dropout), the styled HiFiGAN upsampling decoder (hop 200), the f0 / phone
predictor heads, and ``FACodecRedecoder``, which re-synthesises audio from
codes under another speaker embedding.

Layouts as in ``facodec.py``: channels-first (``[B, C, T]``) inside the conv
stacks (``HiFiGANDecoder``, ``DecoderBlock``, ``CNNLSTMHead``), feature-last
(``[B, T, C]``) at the edges of the banks, the decoder and the redecoder;
codes are ``[n_q, B, T]``, waveforms ``[B, T * 200]``. State-dict names are
the reference's (``quantizer.{0,1,2}.layers.{i}.{in_proj,out_proj,_codebook}``,
``timbre_encoder.*``, ``timbre_linear``, ``model.{i}.block.*``,
``{f0,phone}_predictor.{model,heads}``; the redecoder's ``{prosody,content,
residual}_embs.{i}`` and ``timbre_cond_prosody_enc.layers.{i}.ln_{1,2}.style``),
so ``models/loader.py`` loads a reference ``.bin`` once its weight norms are
folded.

Quantizer dropout draws each row's quantizer count from a ``torch.Generator``
the caller passes, on the host, so a run on the card and one on the CPU with
the same generator draw the same counts. The variances of the style norms are
biased (``correction=0``), as ``jnp.var`` is. The timbre encoder and
``StyleNS3Encoder`` keep the reference's positional-encoding quirk: row b gets
``pe[b]`` at every step, so a speaker embedding or a redecoded row depends on
its batch row.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.attention import TorchMultiheadAttention
from .facodec import ConvFFN, NS3TransformerEncoder, ResidualUnit, SnakeAct1d, fvq_forward, ns3_positional_table

PHONE_CLASSES = 5003


def _style_linear(dim: int) -> nn.Linear:
    """Linear(dim, 2 dim) whose bias starts at ones for the gamma half and zeros for the beta half."""
    lin = nn.Linear(dim, 2 * dim)
    with torch.no_grad():
        lin.bias[:dim].fill_(1.0)
        lin.bias[dim:].zero_()
    return lin


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """No-affine LayerNorm over the last axis in f32, biased variance, eps 1e-5."""
    m = x.float()
    return (m - m.mean(-1, keepdim=True)) * torch.rsqrt(m.var(-1, keepdim=True, correction=0) + 1e-5)


def style_condition(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The timbre norm, then the per-channel style scale and shift: x [B, T, C], gamma / beta [B, C]."""
    return _normalize(x) * gamma[:, None, :] + beta[:, None, :]


# -- factorized VQ (training path) and the residual-VQ bank -------------------


class FactorizedVQ(nn.Module):
    """One FVQ stage: in_proj -> L2-normalised codebook lookup -> out_proj.

    Inference is ``fvq_forward``. Training takes the un-normalised
    ``codebook[idx]``, the per-row commitment loss (x ``commitment``) plus
    the codebook MSE over the low-dim space, and the straight-through
    estimator."""

    def __init__(self, dim: int, codebook_dim: int = 8, codebook_size: int = 1024, commitment: float = 0.005):
        super().__init__()
        self.commitment = commitment
        self.in_proj = nn.Linear(dim, codebook_dim)
        self.out_proj = nn.Linear(codebook_dim, dim)
        self._codebook = nn.Embedding(codebook_size, codebook_dim)

    def forward(self, z: torch.Tensor, train: bool = False):
        """z [B, T, D] -> (z_q [B, T, D], idx [B, T] int64, loss [B])."""
        cb = self._codebook.weight
        if not train:
            z_q, idx = fvq_forward(z, self.in_proj.weight, self.in_proj.bias, self.out_proj.weight,
                                   self.out_proj.bias, cb)
            return z_q, idx, z.new_zeros(z.shape[0], dtype=torch.float32)
        z_e = z @ self.in_proj.weight.t() + self.in_proj.bias
        e = z_e / torch.linalg.vector_norm(z_e, dim=-1, keepdim=True).clamp_min(1e-12)
        c = cb / torch.linalg.vector_norm(cb, dim=-1, keepdim=True).clamp_min(1e-12)
        dist = (e * e).sum(-1, keepdim=True) - 2 * e @ c.t() + (c * c).sum(-1)[None, None, :]
        idx = torch.argmax(-dist, dim=-1)
        z_qc = cb[idx]
        commit = (z_e - z_qc.detach()).square().mean(dim=(1, 2)) * self.commitment
        codebook_loss = (z_qc - z_e.detach()).square().mean(dim=(1, 2))
        z_qc = z_e + (z_qc - z_e).detach()  # straight-through estimator
        return z_qc @ self.out_proj.weight.t() + self.out_proj.bias, idx, commit + codebook_loss

    def embed_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T] -> out-projected code vectors [B, T, D]."""
        return self._codebook.weight[codes] @ self.out_proj.weight.t() + self.out_proj.bias


class ResidualVQBank(nn.Module):
    """SoundStream's residual VQ over FVQ stages. In training the first
    ``int(B * quantizer_dropout)`` rows use a drawn number of quantizers
    (uniform in 1..n for ``'linear'``; ``2 ** randint(1, max(int(log2 n), 2))``,
    exclusive, for ``'exp'``: n = 8 draws only 2 and 4, n <= 3 only 2)."""

    def __init__(self, num_quantizers: int, dim: int, codebook_dim: int = 8, codebook_size: int = 1024,
                 commitment: float = 0.005, quantizer_dropout: float = 0.0, dropout_type: str = "linear"):
        super().__init__()
        if dropout_type not in ("linear", "exp"):
            raise ValueError(f"dropout_type {dropout_type!r}: expected 'linear' or 'exp'")
        self.num_quantizers = num_quantizers
        self.quantizer_dropout = quantizer_dropout
        self.dropout_type = dropout_type
        self.layers = nn.ModuleList(
            FactorizedVQ(dim, codebook_dim, codebook_size, commitment) for _ in range(num_quantizers)
        )

    def draw_counts(self, batch: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Each row's quantizer count in training, [B] float32 on the CPU (n + 1: every quantizer)."""
        n = self.num_quantizers
        nq = torch.full((batch,), float(n + 1))
        if self.quantizer_dropout > 0:
            if generator is None:
                raise ValueError("quantizer dropout needs a torch.Generator")
            if self.dropout_type == "exp":
                drop = 2 ** torch.randint(1, max(int(math.log2(n)), 2), (batch,), generator=generator)
            else:
                drop = torch.randint(1, n + 1, (batch,), generator=generator)
            n_drop = int(batch * self.quantizer_dropout)
            nq[:n_drop] = drop[:n_drop].float()
        return nq

    def forward(self, x: torch.Tensor, n_quantizers: Optional[int] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x [B, T, D] -> (quantized [B, T, D], codes [n, B, T], losses [n],
        per-stage quantized [n, B, T, D])."""
        B = x.shape[0]
        if train:
            nq = self.draw_counts(B, generator)
        else:
            nq = torch.full((B,), float(self.num_quantizers if n_quantizers is None else n_quantizers))
        nq = nq.to(x.device)
        out = torch.zeros_like(x)
        residual = x
        codes, losses, each = [], [], []
        for i, layer in enumerate(self.layers):
            q, code, loss = layer(residual, train=train)
            mask = (i < nq).to(x.dtype)
            residual = residual - q
            out = out + q * mask[:, None, None]
            losses.append((loss * mask).mean())
            codes.append(code)
            each.append(q)
        return out, torch.stack(codes), torch.stack(losses), torch.stack(each)

    def vq2emb(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [n, B, T] -> the summed code vectors [B, T, D]."""
        out = 0.0
        for layer, c in zip(self.layers, codes):
            out = out + layer.embed_codes(c)
        return out


# -- the styled HiFiGAN decoder ---------------------------------------------------


def conv_transpose_padding(stride: int) -> Tuple[int, int]:
    """(padding, output_padding) of a ``2s``-tap, stride-``s`` transposed conv whose output is exactly ``T * s``."""
    return stride // 2 + stride % 2, stride % 2


class DecoderBlock(nn.Module):
    """SnakeBeta -> weight-normed ConvTranspose1d(2s, stride s) -> 3 residual units (dilations 1, 3, 9)."""

    def __init__(self, input_dim: int, output_dim: int, stride: int):
        super().__init__()
        pad, out_pad = conv_transpose_padding(stride)
        self.block = nn.Sequential(
            SnakeAct1d(input_dim),
            nn.ConvTranspose1d(input_dim, output_dim, 2 * stride, stride=stride, padding=pad, output_padding=out_pad),
            ResidualUnit(output_dim, 1), ResidualUnit(output_dim, 3), ResidualUnit(output_dim, 9),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C_in, T] -> [B, C_out, T * s]
        return self.block(x)


class HiFiGANDecoder(nn.Sequential):
    """conv (k 7) -> one ``DecoderBlock`` per ratio, halving the channels ->
    SnakeBeta -> conv (k 7) to one channel -> tanh. [B, in_channels, T] ->
    wav [B, T * prod(up_ratios)]."""

    def __init__(self, in_channels: int = 256, upsample_initial_channel: int = 1536,
                 up_ratios: Tuple[int, ...] = (5, 5, 4, 2)):
        ch = upsample_initial_channel
        out_dim = ch // 2 ** len(up_ratios)
        super().__init__(
            nn.Conv1d(in_channels, ch, 7, padding=3),
            *(DecoderBlock(ch // 2 ** i, ch // 2 ** (i + 1), s) for i, s in enumerate(up_ratios)),
            SnakeAct1d(out_dim), nn.Conv1d(out_dim, 1, 7, padding=3), nn.Tanh(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[:, 0]


class CNNLSTMHead(nn.Module):
    """3 residual units (dilations 1, 2, 3) + SnakeBeta + linear heads (the
    reference's CNNLSTM; there is no LSTM). [B, C, T] -> ``heads`` tensors
    [B, T, outdim] ([B, outdim] with ``global_pred``)."""

    def __init__(self, indim: int, outdim: int, heads: int, global_pred: bool = False):
        super().__init__()
        self.global_pred = global_pred
        self.model = nn.Sequential(ResidualUnit(indim, 1), ResidualUnit(indim, 2), ResidualUnit(indim, 3),
                                   SnakeAct1d(indim))
        self.heads = nn.ModuleList(nn.Linear(indim, outdim) for _ in range(heads))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = self.model(x).transpose(1, 2)
        if self.global_pred:
            h = h.mean(dim=1)
        return [head(h) for head in self.heads]


# -- the full decoder ------------------------------------------------------------


class FACodecDecoderFull(nn.Module):
    """Three residual-VQ banks + the timbre encoder + the styled HiFiGAN.

    ``quantize``: x [B, T, C] -> ((q_p, q_c, q_r), codes [6, B, T], losses
    [6]), the residual bank fed x - (q_p + q_c) detached. ``decode``: the
    per-bank quantized latents and a speaker embedding [B, C] -> wav."""

    def __init__(self, in_channels: int = 256, upsample_initial_channel: int = 1536,
                 up_ratios: Tuple[int, ...] = (5, 5, 4, 2), vq_num_q_p: int = 1, vq_num_q_c: int = 2,
                 vq_num_q_r: int = 3, codebook_size: int = 1024, codebook_dim: int = 8,
                 quantizer_dropout: float = 0.0, dropout_type: str = "linear", with_predictors: bool = False):
        super().__init__()
        self.num_q = (vq_num_q_p, vq_num_q_c, vq_num_q_r)
        self.with_predictors = with_predictors
        self.quantizer = nn.ModuleList(
            ResidualVQBank(n, in_channels, codebook_dim, codebook_size, quantizer_dropout=quantizer_dropout,
                           dropout_type=dropout_type)
            for n in self.num_q
        )
        self.timbre_encoder = NS3TransformerEncoder(hidden=in_channels, heads=4, layers=4, filter_size=1024,
                                                    kernel_size=5)
        self.timbre_linear = _style_linear(in_channels)
        self.model = HiFiGANDecoder(in_channels, upsample_initial_channel, up_ratios)
        if with_predictors:
            self.f0_predictor = CNNLSTMHead(in_channels, 1, 2)
            self.phone_predictor = CNNLSTMHead(in_channels, PHONE_CLASSES, 1)

    def _quantize(self, x_p, x, n_quantizers, train, generator):
        prosody_vq, content_vq, residual_vq = self.quantizer
        qp, cp, lp, _ = prosody_vq(x_p, n_quantizers, train, generator)
        qc, cc, lc, _ = content_vq(x, n_quantizers, train, generator)
        qr, cr, lr, _ = residual_vq(x - (qp + qc).detach(), n_quantizers, train, generator)
        return (qp, qc, qr), torch.cat([cp, cc, cr]), torch.cat([lp, lc, lr])

    def quantize(self, x: torch.Tensor, n_quantizers: Optional[int] = None, train: bool = False,
                 generator: Optional[torch.Generator] = None):
        """The three banks on x [B, T, C]; in training each bank draws its
        dropout counts from ``generator`` in turn (prosody, content, residual)."""
        return self._quantize(x, x, n_quantizers, train, generator)

    def quantize_v2(self, x: torch.Tensor, prosody_latents: torch.Tensor, n_quantizers: Optional[int] = None,
                    train: bool = False, generator: Optional[torch.Generator] = None):
        """FACodecDecoderV2's quantize: the prosody bank takes the melspec-encoded
        prosody latents [B, T, C] (``ProsodyExtractor.prosody_latents``), the
        content and residual banks x."""
        return self._quantize(prosody_latents, x, n_quantizers, train, generator)

    def speaker_embedding(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, C] -> the timbre encoder's output mean-pooled over time, [B, C]."""
        return self.timbre_encoder(x).mean(dim=1)

    def decode(self, quantized: Sequence[torch.Tensor], speaker_embedding: torch.Tensor,
               use_residual: bool = True) -> torch.Tensor:
        x = quantized[0] + quantized[1]
        if use_residual and len(quantized) > 2:
            x = x + quantized[2]
        gamma, beta = self.timbre_linear(speaker_embedding).chunk(2, dim=-1)
        return self.model(style_condition(x, gamma, beta).transpose(1, 2))

    def predict(self, quantized: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The auxiliary predictions: f0 and uv [B, T] from the prosody latents, phone logits [B, T, 5003] from the content ones."""
        if not self.with_predictors:
            raise ValueError("built without the predictor heads (with_predictors=False)")
        f0, uv = self.f0_predictor(quantized[0].transpose(1, 2))
        (phone,) = self.phone_predictor(quantized[1].transpose(1, 2))
        return {"f0": f0[..., 0], "uv": uv[..., 0], "phone": phone}

    def forward(self, x: torch.Tensor, speaker_embedding: Optional[torch.Tensor] = None,
                n_quantizers: Optional[int] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Autoencode: quantize -> (the speaker embedding of x unless given) ->
        decode -> (wav, codes, vq losses) (and the predictions with the heads)."""
        quantized, codes, losses = self.quantize(x, n_quantizers, train, generator)
        if speaker_embedding is None:
            speaker_embedding = self.speaker_embedding(x)
        wav = self.decode(quantized, speaker_embedding)
        if self.with_predictors:
            return wav, codes, losses, self.predict(quantized)
        return wav, codes, losses

    def codes_to_wav(self, codes: torch.Tensor, speaker_embedding: torch.Tensor,
                     use_residual: bool = True) -> torch.Tensor:
        """codes [6, B, T] -> wav: each bank's summed code vectors, then ``decode``."""
        p, c, r = self.num_q
        prosody_vq, content_vq, residual_vq = self.quantizer
        quantized = [prosody_vq.vq2emb(codes[:p]), content_vq.vq2emb(codes[p:p + c])]
        if use_residual and r > 0:
            quantized.append(residual_vq.vq2emb(codes[p + c:]))
        return self.decode(quantized, speaker_embedding, use_residual)


# -- the redecoder ---------------------------------------------------------------


class StyleAdaptiveLayerNorm(nn.Module):
    """No-affine LayerNorm, then gamma * x + beta from ``style`` applied to the time-mean of the condition."""

    def __init__(self, hidden: int):
        super().__init__()
        self.style = _style_linear(hidden)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:  # [B, T, C], [B, T', C]
        gamma, beta = self.style(cond.mean(dim=1, keepdim=True)).chunk(2, dim=-1)
        return gamma * _normalize(x) + beta


class StyleNS3Layer(nn.Module):
    """The NS3 transformer layer with style-adaptive LayerNorms (``use_cln``)."""

    def __init__(self, hidden: int, heads: int, filter_size: int, kernel_size: int):
        super().__init__()
        self.ln_1 = StyleAdaptiveLayerNorm(hidden)
        self.self_attn = TorchMultiheadAttention(hidden, heads)
        self.ln_2 = StyleAdaptiveLayerNorm(hidden)
        self.ffn = ConvFFN(hidden, filter_size, kernel_size)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = self.ln_1(x, cond)
        x = x + self.self_attn(h, h, h)
        return x + self.ffn(self.ln_2(x, cond))


class StyleNS3Encoder(nn.Module):
    """The redecoder's 4-layer conditional transformer; a final style-adaptive
    LayerNorm; row b gets ``pe[b]`` at every step (the reference's quirk)."""

    def __init__(self, hidden: int = 256, heads: int = 4, layers: int = 4, filter_size: int = 1024,
                 kernel_size: int = 5, max_len: int = 5000):
        super().__init__()
        self.layers = nn.ModuleList(StyleNS3Layer(hidden, heads, filter_size, kernel_size) for _ in range(layers))
        self.last_ln = StyleAdaptiveLayerNorm(hidden)
        self.register_buffer("pe", torch.from_numpy(ns3_positional_table(max_len, hidden)), persistent=False)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        x = x + self.pe[: x.shape[0]][:, None]
        for layer in self.layers:
            x = layer(x, cond)
        return self.last_ln(x, cond)


class FACodecRedecoder(nn.Module):
    """Audio from codes under a swapped speaker embedding: per-quantizer code
    embeddings (normal(1e-5) init), the prosody ones through a conditional
    transformer on the speaker, plus the content (and, ``use_residual``, the
    residual) ones, the timbre style, and a 1280-channel styled HiFiGAN."""

    def __init__(self, in_channels: int = 256, upsample_initial_channel: int = 1280,
                 up_ratios: Tuple[int, ...] = (5, 5, 4, 2), vq_num_q_p: int = 1, vq_num_q_c: int = 2,
                 vq_num_q_r: int = 3, codebook_size: int = 1024):
        super().__init__()
        self.num_q = (vq_num_q_p, vq_num_q_c, vq_num_q_r)

        def embs(n):
            out = nn.ModuleList(nn.Embedding(codebook_size, in_channels) for _ in range(n))
            for e in out:
                nn.init.normal_(e.weight, std=1e-5)
            return out

        self.prosody_embs = embs(vq_num_q_p)
        self.content_embs = embs(vq_num_q_c)
        self.residual_embs = embs(vq_num_q_r)
        self.timbre_cond_prosody_enc = StyleNS3Encoder(hidden=in_channels)
        self.timbre_linear = _style_linear(in_channels)
        self.model = HiFiGANDecoder(in_channels, upsample_initial_channel, up_ratios)

    def forward(self, codes: torch.Tensor, speaker_embedding: torch.Tensor, use_residual: bool = False):
        """codes [6, B, T] + speaker [B, C] -> wav [B, T * 200]."""
        p, c, _ = self.num_q
        x_p = 0.0
        for i, emb in enumerate(self.prosody_embs):
            x_p = x_p + emb(codes[i])
        cond = speaker_embedding[:, None, :].expand_as(x_p)
        x = self.timbre_cond_prosody_enc(x_p, cond)
        for i, emb in enumerate(self.content_embs):
            x = x + emb(codes[p + i])
        if use_residual:
            for i, emb in enumerate(self.residual_embs):
                x = x + emb(codes[p + c + i])
        gamma, beta = self.timbre_linear(speaker_embedding).chunk(2, dim=-1)
        return self.model(style_condition(x, gamma, beta).transpose(1, 2))
