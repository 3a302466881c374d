"""Whisper's and NS3 FACodec's log-mel frontends, in plain PyTorch.

Port of the Whisper half of ``interspeech_ser_tpu/ops/mel.py``, which
computes it with XLA matmuls and no Pallas kernel: HF
``WhisperFeatureExtractor`` semantics (n_fft 400, hop 160, periodic Hann,
reflect pad, power spectrogram, slaney mel bank over 0-8 kHz, log10, the
final frame dropped, a per-sample floor at max - 8, then (x + 4) / 4). The
STFT is one framed matmul against DFT bases built in float64 and cast to
float32, so on the card it is two cuBLAS GEMMs.

Also the port of ``ns3_mel_spectrogram`` / ``get_prosody_feature``
(``interspeech_ser_tpu/models/ns3/facodec.py:42-67``): an 800-sample
periodic Hann centred in a 1024-point frame, hop 200, ``center=False``
after a 412-sample reflect pad, magnitude, slaney mel 0-8 kHz, natural log.

And ``speechbrain_fbank`` (``interspeech_ser_tpu/ops/mel.py:148-217``), the
x-vector trainer's features: speechbrain's ``Fbank`` as
``spkrec-xvect-voxceleb`` runs it (a periodic Hamming window of 400 samples,
hop 160, centre reflect pad, the power spectrum as two GEMMs against DFT
bases, a 24-band HTK mel bank over 0-8 kHz, 10 log10 with an 80-dB floor
under each utterance's maximum), then the sentence mean over each
utterance's ``1 + len // 160`` live frames subtracted.
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
def _dft_bases(n_fft: int, win_length: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Periodic-Hann-windowed cos / -sin bases, [n_fft, 1 + n_fft // 2] float32.
    ``win_length < n_fft``: the window is defined on ``win_length`` samples
    and centred inside the frame, zeros around it (torch.stft semantics)."""
    n = np.arange(n_fft)
    angle = 2.0 * np.pi * np.outer(n, np.arange(1 + n_fft // 2)) / n_fft
    if win_length is None or win_length >= n_fft:
        win = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))
    else:
        m = np.arange(win_length)
        off = (n_fft - win_length) // 2
        win = np.zeros(n_fft)
        win[off:off + win_length] = 0.5 * (1.0 - np.cos(2.0 * np.pi * m / win_length))
    return (np.cos(angle) * win[:, None]).astype(np.float32), (-np.sin(angle) * win[:, None]).astype(np.float32)


def stft_power(
    wav: torch.Tensor, n_fft: int, hop_length: int, *, win_length: Optional[int] = None, center: bool = True
) -> torch.Tensor:
    """Power spectrogram [B, num_frames, 1 + n_fft // 2] float32 of [B, L].
    ``center``: reflect-padded by n_fft // 2 on both sides first, so
    num_frames = 1 + L // hop; else num_frames = 1 + (L - n_fft) // hop."""
    x = wav.float()
    if center:
        pad = n_fft // 2
        x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(1, n_fft, hop_length)  # [B, F, n_fft]
    cos_b, sin_b = (torch.from_numpy(b).to(wav.device) for b in _dft_bases(n_fft, win_length))
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


NS3_PAD = 412  # (n_fft - hop) / 2 of the FACodec melspec


def ns3_mel_spectrogram(wav: torch.Tensor, pre_padded: bool = False) -> torch.Tensor:
    """[B, L] -> log-mel [B, 80, T], T = 1 + (L - 200) // 200.

    ``pre_padded=True`` takes a wav that the host already reflect-padded by
    412 samples on each side (each utterance before the bucket's zero
    padding), so the frames up to an utterance's true length are those of
    its batch-1 computation."""
    x = wav.float()
    if not pre_padded:
        x = F.pad(x[:, None], (NS3_PAD, NS3_PAD), mode="reflect")[:, 0]
    power = stft_power(x, 1024, 200, win_length=800, center=False)
    mag = torch.sqrt(power + 1e-9)  # [B, T, 513]
    fb = torch.from_numpy(mel_filter_bank_slaney(513, 80, 0.0, 8000.0, 16000)).to(mag.device)
    return torch.log((mag @ fb).clamp_min(1e-5)).transpose(1, 2)


def get_prosody_feature(wav: torch.Tensor, pre_padded: bool = False) -> torch.Tensor:
    """The first 20 mel bins of :func:`ns3_mel_spectrogram`, [B, 20, T]."""
    return ns3_mel_spectrogram(wav, pre_padded)[:, :20, :]


def hz_to_mel_htk(freq):
    return 2595.0 * np.log10(1.0 + np.asarray(freq, np.float64) / 700.0)


def mel_to_hz_htk(mels):
    return 700.0 * (10.0 ** (np.asarray(mels, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=4)
def _htk_mel_bank(num_bins: int, num_mels: int, fmin: float, fmax: float, sr: int) -> np.ndarray:
    """Triangular HTK-scale mel bank (no norm), [num_bins, num_mels] float32."""
    fft_freqs = np.linspace(0, sr / 2, num_bins)
    f_pts = mel_to_hz_htk(np.linspace(hz_to_mel_htk(fmin), hz_to_mel_htk(fmax), num_mels + 2))
    fdiff = np.diff(f_pts)
    slopes = f_pts[None, :] - fft_freqs[:, None]
    return np.maximum(0.0, np.minimum(-slopes[:, :-2] / fdiff[:-1], slopes[:, 2:] / fdiff[1:])).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _hamming_bases(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    n = np.arange(n_fft)
    win = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / n_fft)  # periodic Hamming
    angle = 2.0 * np.pi * np.outer(n, np.arange(1 + n_fft // 2)) / n_fft
    return (np.cos(angle) * win[:, None]).astype(np.float32), (-np.sin(angle) * win[:, None]).astype(np.float32)


def speechbrain_fbank(
    wav: torch.Tensor,  # [B, L] at 16 kHz
    num_mels: int = 24,
    n_fft: int = 400,
    hop_length: int = 160,
    sampling_rate: int = 16000,
    lengths: Optional[torch.Tensor] = None,  # [B] live samples a row
) -> torch.Tensor:
    """speechbrain ``Fbank`` + sentence mean normalisation -> [B, 1 + L // hop, num_mels]
    float32. With ``lengths`` the mean runs over each row's ``1 + len // hop``
    frames; the 80-dB floor is under each row's maximum over all frames."""
    pad = n_fft // 2
    x = F.pad(wav.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(1, n_fft, hop_length)  # [B, F, n_fft]
    cos_b, sin_b = (torch.from_numpy(b).to(wav.device) for b in _hamming_bases(n_fft))
    real, imag = frames @ cos_b, frames @ sin_b
    fb = torch.from_numpy(_htk_mel_bank(1 + n_fft // 2, num_mels, 0.0, sampling_rate / 2, sampling_rate))
    log_mel = 10.0 * torch.log10(((real * real + imag * imag) @ fb.to(wav.device)).clamp_min(1e-10))
    log_mel = torch.maximum(log_mel, log_mel.amax(dim=(1, 2), keepdim=True) - 80.0)
    if lengths is None:
        return log_mel - log_mel.mean(dim=1, keepdim=True)
    live = 1 + lengths.to(torch.int64) // hop_length
    m = (torch.arange(frames.shape[1], device=wav.device)[None, :] < live[:, None]).float()[:, :, None]
    return log_mel - (log_mel * m).sum(dim=1, keepdim=True) / m.sum(dim=1, keepdim=True).clamp_min(1.0)
