"""torchaudio-semantics log-mel frontend on the host (numpy).

Port of ``interspeech_ser_tpu/ops/melspec_ta.py``. The melspec
proto-angular trainers compute features on the fly with
``torchaudio.transforms.MelSpectrogram(sample_rate, n_fft=800,
win_length=400, hop_length=160, n_mels=80)`` then ``AmplitudeToDB()``;
this reproduces those semantics without torchaudio:

- center=True reflect padding of n_fft // 2 samples on both sides;
- a periodic Hann window of ``win_length`` centred in n_fft zeros;
- the power spectrogram over n_fft // 2 + 1 bins;
- an HTK mel bank with ``all_freqs = linspace(0, sample_rate // 2,
  n_freqs)``: the constructor's ``sample_rate`` builds the bank even when
  the audio's rate differs. The reference's non-gender script passes
  ``sample_rate=1600`` for 16-kHz audio, which squeezes the 80 triangles
  into the lowest part of the spectrum; it is kept, as the JAX package
  keeps it;
- ``AmplitudeToDB(stype='power', top_db=None)``: 10 log10(max(x, 1e-10)).

It runs where the wavs are read, on the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def melscale_fbanks(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_mels: int,
    sample_rate: int,
) -> np.ndarray:
    """torchaudio.functional.melscale_fbanks (norm=None, mel_scale='htk').

    Returns [n_freqs, n_mels] float32. ``all_freqs`` spans
    [0, sample_rate // 2] — integer floor-division, as torchaudio does.
    """
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]  # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


class TorchaudioMelSpectrogram:
    """wav [L] float32 → log-mel [T, n_mels] float32 (reference layout)."""

    def __init__(
        self,
        sample_rate: int = 16000,
        n_fft: int = 800,
        win_length: int = 400,
        hop_length: int = 160,
        n_mels: int = 80,
    ):
        self.n_fft = n_fft
        self.hop = hop_length
        # periodic Hann of win_length, centered zero-pad to n_fft
        w = np.hanning(win_length + 1)[:-1].astype(np.float64)
        left = (n_fft - win_length) // 2
        self.window = np.zeros(n_fft, np.float64)
        self.window[left : left + win_length] = w
        self.fb = melscale_fbanks(
            n_fft // 2 + 1, 0.0, sample_rate / 2.0, n_mels, sample_rate
        )

    def power_spectrogram(self, wav: np.ndarray) -> np.ndarray:
        """[L] → [n_freqs, T] power-2 spectrogram (center, reflect pad)."""
        x = np.asarray(wav, np.float64)
        pad = self.n_fft // 2
        x = np.pad(x, pad, mode="reflect")
        n_frames = 1 + (len(x) - self.n_fft) // self.hop
        idx = (
            np.arange(self.n_fft)[None, :]
            + self.hop * np.arange(n_frames)[:, None]
        )
        frames = x[idx] * self.window[None, :]
        spec = np.fft.rfft(frames, axis=1)  # [T, n_freqs]
        return (spec.real ** 2 + spec.imag ** 2).T  # [n_freqs, T]

    def __call__(self, wav: np.ndarray, log: bool = True) -> np.ndarray:
        spec = self.power_spectrogram(wav)  # [n_freqs, T]
        mel = self.fb.T.astype(np.float64) @ spec  # [n_mels, T]
        if log:
            mel = 10.0 * np.log10(np.maximum(mel, 1e-10))
        # reference saves .squeeze(0).transpose(0, 1) → [T, n_mels]
        return mel.T.astype(np.float32)
