"""Whisper's log-mel and encoder in plain float32 PyTorch.

A frozen copy of the plain path of the port's ``ops/mel.py`` and
``models/whisper.py`` for one utterance: the waveform zero-padded (or cut)
to 30 s; the log-mel of HF's ``WhisperFeatureExtractor`` (n_fft 400, hop
160, periodic Hann, reflect padding, power spectrum, slaney mel bank over
0-8 kHz, log10, the last frame dropped, a floor 8 under the maximum, then
(x + 4) / 4), here through ``torch.stft`` where the port multiplies by DFT
bases; conv1 (k3) and conv2 (k3, stride 2) with exact GELU, the position
table, pre-LN layers (``k_proj`` without bias), the final LayerNorm; the
output cut to ``min(ceil(n / 320), 1500)`` frames.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .common import Ops, layer_norm

N_SAMPLES = 480000  # 30 s at 16 kHz


def param_shapes(cfg: Dict) -> Dict[str, tuple]:
    D, M, Fd = cfg["d_model"], cfg["num_mel_bins"], cfg["encoder_ffn_dim"]
    shapes = {"conv1.weight": (D, M, 3), "conv1.bias": (D,), "conv2.weight": (D, D, 3), "conv2.bias": (D,),
              "embed_positions.weight": (cfg["max_source_positions"], D)}
    for i in range(cfg["encoder_layers"]):
        pre = f"layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{pre}.self_attn.{name}.weight"] = (D, D)
            if name != "k_proj":
                shapes[f"{pre}.self_attn.{name}.bias"] = (D,)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            shapes[f"{pre}.{ln}.weight"] = (D,)
            shapes[f"{pre}.{ln}.bias"] = (D,)
        shapes[f"{pre}.fc1.weight"] = (Fd, D)
        shapes[f"{pre}.fc1.bias"] = (Fd,)
        shapes[f"{pre}.fc2.weight"] = (D, Fd)
        shapes[f"{pre}.fc2.bias"] = (D,)
    shapes["layer_norm.weight"] = (D,)
    shapes["layer_norm.bias"] = (D,)
    return shapes


def frame_count(n_samples: int, cfg: Dict) -> int:
    return min(math.ceil(n_samples / 320), cfg["max_source_positions"])


def mel_filter_bank(num_bins: int, num_mels: int, sr: int = 16000, fmax: float = 8000.0) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangular bank, [num_bins, num_mels]."""

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        logstep = 27.0 / np.log(6.4)
        with np.errstate(divide="ignore"):
            log_branch = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) * logstep
        return np.where(f >= 1000.0, log_branch, 3.0 * f / 200.0)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), 200.0 * m / 3.0)

    fft_freqs = np.linspace(0, sr // 2, num_bins)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(fmax), num_mels + 2))
    fdiff = np.diff(f_pts)
    slopes = f_pts[None, :] - fft_freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / fdiff[:-1], slopes[:, 2:] / fdiff[1:]))
    fb *= (2.0 / (f_pts[2: num_mels + 2] - f_pts[:num_mels]))[None, :]
    return fb.astype(np.float32)


def log_mel(wav: torch.Tensor, num_mels: int, ops: Ops) -> torch.Tensor:
    """wav [480000] -> [num_mels, 3000]."""
    window = torch.hann_window(400, periodic=True, dtype=torch.float32, device=wav.device)
    spec = torch.stft(wav, 400, 160, window=window, center=True, pad_mode="reflect", return_complex=True)
    power = (spec.abs() ** 2).t()  # [3001, 201]
    fb = torch.from_numpy(mel_filter_bank(201, num_mels)).to(wav.device)
    log_spec = torch.log10(ops.matmul(power, fb).clamp_min(1e-10))[:-1]
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).t()


def forward(p: Dict[str, torch.Tensor], cfg: Dict, wav: torch.Tensor, ops: Ops) -> torch.Tensor:
    """wav [n] float32 at 16 kHz -> the last hidden state [frame_count(n), D]."""
    n = wav.shape[0]
    padded = F.pad(wav[:N_SAMPLES], (0, max(0, N_SAMPLES - n)))
    mel = log_mel(padded, cfg["num_mel_bins"], ops)[None]
    x = F.gelu(ops.conv1d(mel, p["conv1.weight"], p["conv1.bias"], padding=1))
    x = F.gelu(ops.conv1d(x, p["conv2.weight"], p["conv2.bias"], stride=2, padding=1))[0].t()  # [1500, D]
    T, D = x.shape
    h = x + p["embed_positions.weight"][:T]
    H = cfg["encoder_attention_heads"]
    hd = D // H
    scale = 1.0 / math.sqrt(hd)
    for i in range(cfg["encoder_layers"]):
        pre = f"layers.{i}.self_attn"
        a = layer_norm(h, p[f"layers.{i}.self_attn_layer_norm.weight"], p[f"layers.{i}.self_attn_layer_norm.bias"])
        q = ops.linear(a, p[f"{pre}.q_proj.weight"], p[f"{pre}.q_proj.bias"]).reshape(T, H, hd).transpose(0, 1)
        k = ops.linear(a, p[f"{pre}.k_proj.weight"]).reshape(T, H, hd).transpose(0, 1)
        v = ops.linear(a, p[f"{pre}.v_proj.weight"], p[f"{pre}.v_proj.bias"]).reshape(T, H, hd).transpose(0, 1)
        w = torch.softmax(ops.matmul(q * scale, k.transpose(1, 2)), dim=-1)
        o = ops.matmul(w, v).transpose(0, 1).reshape(T, D)
        h = h + ops.linear(o, p[f"{pre}.out_proj.weight"], p[f"{pre}.out_proj.bias"])
        f = layer_norm(h, p[f"layers.{i}.final_layer_norm.weight"], p[f"layers.{i}.final_layer_norm.bias"])
        f = F.gelu(ops.linear(f, p[f"layers.{i}.fc1.weight"], p[f"layers.{i}.fc1.bias"]))
        h = h + ops.linear(f, p[f"layers.{i}.fc2.weight"], p[f"layers.{i}.fc2.bias"])
    h = layer_norm(h, p["layer_norm.weight"], p["layer_norm.bias"])
    return h[: frame_count(n, cfg)]
