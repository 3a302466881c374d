"""Host-side WAV decode + resample.

Port of ``interspeech_ser_tpu/utils/audio.py``: the native C++ loader
(``utils/native_audio.py``, built from ``native/ser_audio.cpp`` at first use)
first, then the python path when the library cannot be had or fails on a
file; ``SER_TPU_NATIVE=0`` forces python. The python path decodes PCM WAV
payloads of 8/16/24/32 bits through ``wave``, mixes multi-channel audio
down, and resamples other rates with ``scipy.signal.resample_poly``; the
native one resamples with its own windowed-sinc filter (same length
``ceil(n * target / rate)``, other values). At 16 kHz the two agree to
1e-6.

:func:`load_wavs` reads a list of files through the native batch loader
(its ``std::thread`` pool, no interpreter lock), the python path for a file it
fails on. ``LOADS`` counts the files each loader decoded in this process;
the first use of each is printed once.
"""

from __future__ import annotations

import threading
import wave
from math import gcd
from typing import List, Sequence, Tuple

import numpy as np

from . import native_audio

LOADS = {"native": 0, "python": 0}
_LOCK = threading.Lock()


def _count(loader: str, n: int = 1) -> None:
    if n == 0:
        return
    with _LOCK:
        LOADS[loader] += n
        first = LOADS[loader] == n
    if first:
        why = "" if loader == "native" else f" (native loader: {native_audio.BUILD_ERROR or 'off or failed on a file'})"
        print(f"[audio] wav loader: {loader}{why}", flush=True)


def load_wav(path: str, target_sr: int = 16000) -> Tuple[np.ndarray, int]:
    """Decode a PCM WAV to mono float32 in [-1, 1] at ``target_sr``."""
    res = native_audio.load_wav_native(path, target_sr)
    if res is not None:
        _count("native")
        return res[0], target_sr
    _count("python")
    return load_wav_python(path, target_sr), target_sr


def load_wavs(paths: Sequence[str], target_sr: int = 16000) -> List[np.ndarray]:
    """:func:`load_wav`'s samples for each of ``paths``, the native ones
    decoded together on the batch loader's threads."""
    res = native_audio.load_batch_native(paths, target_sr) or [None] * len(paths)
    _count("native", sum(r is not None for r in res))
    return [r if r is not None else load_wav(p, target_sr)[0] for p, r in zip(paths, res)]


def load_wav_python(path: str, target_sr: int = 16000) -> np.ndarray:
    """The python path: ``wave`` and ``scipy.signal.resample_poly``."""
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
    return x


def normalize_waveform(x: np.ndarray, do_normalize: bool = True) -> np.ndarray:
    """HF Wav2Vec2FeatureExtractor zero-mean / unit-variance normalisation."""
    if not do_normalize:
        return x.astype(np.float32)
    return ((x - x.mean()) / np.sqrt(x.var() + 1e-7)).astype(np.float32)
