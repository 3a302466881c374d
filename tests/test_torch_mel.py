"""Whisper's log-mel frontend (``ops/mel.py``) against the JAX package's.

Both compute the same f32 matmul DFT from the same float64-built bases; the
sums run in other orders. Bars: the mel bank equal to the bit (same numpy
code); the power spectrogram within 1e-5 relative; the log-mel within 1e-4
absolute (log10 of sums of ~400 products, then (x + 4) / 4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interspeech_ser_tpu.ops import mel as jmel
from interspeech_ser_tpu_torch.ops import mel

torch.set_num_threads(2)


def _wavs(n=2, length=480000, seed=0):
    """Seeded tones in noise with a silent tail (the 30-s padding)."""
    rng = np.random.default_rng(seed)
    t = np.arange(length) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400, (n, 1)) * t) + 0.05 * rng.standard_normal((n, length))
    x[:, length * 2 // 3:] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("num_mels", [80, 128])
def test_mel_filter_bank_equals_jax(num_mels):
    got = mel.mel_filter_bank_slaney(201, num_mels, 0.0, 8000.0, 16000)
    want = jmel.mel_filter_bank_slaney(201, num_mels, 0.0, 8000.0, 16000)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mel.hz_to_mel_slaney([0.0, 700.0, 1000.0, 4000.0]),
                                  jmel.hz_to_mel_slaney([0.0, 700.0, 1000.0, 4000.0]))
    np.testing.assert_array_equal(mel.mel_to_hz_slaney([0.0, 10.0, 15.0, 40.0]),
                                  jmel.mel_to_hz_slaney([0.0, 10.0, 15.0, 40.0]))


def test_stft_power_matches_jax():
    x = _wavs(2, 16037, seed=1)
    got = mel.stft_power(torch.from_numpy(x), 400, 160).numpy()
    want = np.asarray(jmel.stft_power(jnp.asarray(x), 400, 160))
    assert got.shape == want.shape == (2, 1 + 16037 // 160, 201)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_whisper_log_mel_matches_jax():
    x = _wavs()
    got = mel.whisper_log_mel(torch.from_numpy(x), 128).numpy()
    want = np.asarray(jmel.whisper_log_mel(jnp.asarray(x), 128))
    assert got.shape == want.shape == (2, 128, 3000)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
