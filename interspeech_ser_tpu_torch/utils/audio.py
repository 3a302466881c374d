"""Host-side WAV decode + resample (stdlib ``wave`` + scipy only).

Port of ``interspeech_ser_tpu/utils/audio.py`` without its native C++
loader (that comes later): PCM WAV payloads of 8/16/24/32 bits decode
through ``wave``, multi-channel audio is mixed down, and other rates are
resampled with ``scipy.signal.resample_poly``.
"""

from __future__ import annotations

import wave
from math import gcd
from typing import Tuple

import numpy as np


def load_wav(path: str, target_sr: int = 16000) -> Tuple[np.ndarray, int]:
    """Decode a PCM WAV to mono float32 in [-1, 1] at ``target_sr``."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())

    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
        x = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"{path}: unsupported sample width {width}")

    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    if sr != target_sr:
        from scipy.signal import resample_poly

        g = gcd(sr, target_sr)
        x = resample_poly(x, target_sr // g, sr // g).astype(np.float32)
        sr = target_sr
    return x, sr


def normalize_waveform(x: np.ndarray, do_normalize: bool = True) -> np.ndarray:
    """HF Wav2Vec2FeatureExtractor zero-mean / unit-variance normalisation."""
    if not do_normalize:
        return x.astype(np.float32)
    return ((x - x.mean()) / np.sqrt(x.var() + 1e-7)).astype(np.float32)
