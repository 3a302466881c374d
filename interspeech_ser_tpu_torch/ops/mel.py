"""Whisper's log-mel frontend, in plain PyTorch.

Port of the Whisper half of ``interspeech_ser_tpu/ops/mel.py``, which
computes it with XLA matmuls and no Pallas kernel: HF
``WhisperFeatureExtractor`` semantics (n_fft 400, hop 160, periodic Hann,
reflect pad, power spectrogram, slaney mel bank over 0-8 kHz, log10, the
final frame dropped, a per-sample floor at max - 8, then (x + 4) / 4). The
STFT is one framed matmul against DFT bases built in float64 and cast to
float32, so on the card it is two cuBLAS GEMMs.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hz, min_log_mel = 1000.0, 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    with np.errstate(divide="ignore"):
        log_branch = min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) * logstep
    return np.where(freq >= min_log_hz, log_branch, mels)


def mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(mels >= min_log_mel, 1000.0 * np.exp(logstep * (mels - min_log_mel)), freq)


def mel_filter_bank_slaney(
    num_frequency_bins: int,
    num_mel_filters: int,
    min_frequency: float,
    max_frequency: float,
    sampling_rate: int,
    norm: Optional[str] = "slaney",
) -> np.ndarray:
    """Triangular slaney-scale mel bank, [num_frequency_bins, num_mel] float32."""
    fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)
    mel_freqs = np.linspace(
        hz_to_mel_slaney(min_frequency), hz_to_mel_slaney(max_frequency), num_mel_filters + 2
    )
    filter_freqs = mel_to_hz_slaney(mel_freqs)
    fdiff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]  # [bins, mel + 2]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb *= (2.0 / (filter_freqs[2: num_mel_filters + 2] - filter_freqs[:num_mel_filters]))[None, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _dft_bases(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Periodic-Hann-windowed cos / -sin bases, [n_fft, 1 + n_fft // 2] float32."""
    n = np.arange(n_fft)
    angle = 2.0 * np.pi * np.outer(n, np.arange(1 + n_fft // 2)) / n_fft
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))
    return (np.cos(angle) * win[:, None]).astype(np.float32), (-np.sin(angle) * win[:, None]).astype(np.float32)


def stft_power(wav: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Power spectrogram [B, 1 + L // hop, 1 + n_fft // 2] float32 of [B, L]
    (centred: reflect-padded by n_fft // 2 on both sides)."""
    pad = n_fft // 2
    x = F.pad(wav.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(1, n_fft, hop_length)  # [B, F, n_fft]
    cos_b, sin_b = (torch.from_numpy(b).to(wav.device) for b in _dft_bases(n_fft))
    real = frames @ cos_b
    imag = frames @ sin_b
    return real * real + imag * imag


def whisper_log_mel(
    wav: torch.Tensor,  # [B, 480000]: 30 s, already padded or cut
    num_mels: int = 128,
    n_fft: int = 400,
    hop_length: int = 160,
    sampling_rate: int = 16000,
) -> torch.Tensor:  # [B, num_mels, 3000] float32
    power = stft_power(wav, n_fft, hop_length)  # [B, 3001, 201]
    fb = torch.from_numpy(mel_filter_bank_slaney(1 + n_fft // 2, num_mels, 0.0, 8000.0, sampling_rate))
    log_spec = torch.log10((power @ fb.to(power.device)).clamp_min(1e-10))[:, :-1, :]
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(1, 2)
