"""The port's native wav loader (``utils/native_audio.py``, built here with
the host compiler from ``native/ser_audio.cpp`` into ``build/native/``)
against the JAX package's native and python paths.

The JAX package's native path is its own ctypes binding over
``native/libser_audio.so`` when that is built, else over the port's build of
the same source. Bars (those of tests/test_native_audio.py): at 16 kHz the
native samples within 1e-6 of the python path's; resampled audio of the
same length as the python path's within 2 samples, its 440-Hz tone's peak
within 2 bins; the port's native loader within 1e-6 of the JAX package's
(the same C++ built with other flags); under ``SER_TPU_NATIVE=0`` the
port's samples equal to the JAX package's python path's.
"""

import os
import wave

import numpy as np
import pytest

from interspeech_ser_tpu_torch.utils import audio, native_audio

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _write(path, x, sr=16000, width=2, channels=1):
    x = np.clip(np.asarray(x), -1, 1)
    data = {1: lambda: (x * 127 + 128).astype(np.uint8), 2: lambda: (x * 32767).astype("<i2"),
            4: lambda: (x * 2147483647).astype("<i4")}[width]()
    if channels == 2:
        data = np.stack([data, data[::-1]], axis=1).reshape(-1)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's native loader, over native/libser_audio.so or the
    port's build of the same source; its probe cache restored after."""
    from interspeech_ser_tpu.utils import native_audio as jna

    lib = os.path.join(ROOT, "native", "libser_audio.so")
    if not os.path.exists(lib):
        lib = str(native_audio.build())
    monkeypatch.setattr(jna, "_find_lib", lambda: lib)
    monkeypatch.setattr(jna, "_TRIED", False)
    monkeypatch.setattr(jna, "_LIB", None)
    monkeypatch.delenv("SER_TPU_NATIVE", raising=False)
    assert jna.available()
    return jna


def _jax_python(monkeypatch, path):
    from interspeech_ser_tpu.utils import native_audio as jna
    from interspeech_ser_tpu.utils.audio import load_wav as jax_load_wav

    with monkeypatch.context() as m:
        m.setattr(jna, "_TRIED", True)
        m.setattr(jna, "_LIB", None)
        return jax_load_wav(path)[0]


@pytest.mark.parametrize("width,channels", [(2, 1), (2, 2), (4, 1), (1, 1)])
def test_16k_matches_jax_native_and_python(tmp_path, monkeypatch, jax_native, width, channels):
    p = str(tmp_path / "a.wav")
    _write(p, np.random.default_rng(width + channels).normal(size=8000) * 0.2, width=width, channels=channels)
    before = dict(audio.LOADS)
    ours, sr = audio.load_wav(p)
    assert sr == 16000 and ours.dtype == np.float32 and audio.LOADS["native"] == before["native"] + 1
    np.testing.assert_allclose(ours, jax_native.load_wav_native(p, 16000)[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours, _jax_python(monkeypatch, p), atol=1e-6, rtol=0)


@pytest.mark.parametrize("sr,channels", [(22050, 2), (44100, 1), (8000, 1)])
def test_resampled_matches_jax_native(tmp_path, monkeypatch, jax_native, sr, channels):
    t = np.arange(sr) / sr
    p = str(tmp_path / "b.wav")
    _write(p, 0.5 * np.sin(2 * np.pi * 440 * t), sr=sr, channels=channels)
    ours, out_sr = audio.load_wav(p)
    got, orig = native_audio.load_wav_native(p, 16000)
    assert out_sr == 16000 and orig == sr
    np.testing.assert_array_equal(ours, got)
    np.testing.assert_allclose(ours, jax_native.load_wav_native(p, 16000)[0], atol=1e-6, rtol=0)
    py = _jax_python(monkeypatch, p)
    assert abs(len(ours) - len(py)) <= 2 and abs(len(ours) - 16000) <= 2
    spec = np.abs(np.fft.rfft(ours[:16000]))
    assert abs(int(np.argmax(spec[10:])) + 10 - 440) <= 2


def test_batch_loader(tmp_path, jax_native):
    rng = np.random.default_rng(1)
    paths = []
    for i in range(6):
        paths.append(str(tmp_path / f"c{i}.wav"))
        _write(paths[-1], rng.normal(size=4000 + 100 * i) * 0.2, sr=(16000, 22050)[i % 2])
    paths.append(str(tmp_path / "missing.wav"))
    res = native_audio.load_batch_native(paths)
    want = jax_native.load_batch_native(paths, num_threads=4)
    assert res[-1] is None and want[-1] is None and len(res) == 7
    for i in range(6):
        np.testing.assert_array_equal(res[i], native_audio.load_wav_native(paths[i])[0])
        np.testing.assert_allclose(res[i], want[i], atol=1e-6, rtol=0)
    assert native_audio.load_wav_native(paths[-1]) is None


def test_load_wavs_batches_native_and_falls_back_per_file(tmp_path, monkeypatch):
    """``audio.load_wavs``: the batch loader's samples, each equal to
    ``load_wav``'s, counted as native reads; a file the batch loader returns
    None for goes through ``load_wav``, here its python path."""
    rng = np.random.default_rng(2)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"w{i}.wav"))
        _write(paths[-1], rng.normal(size=3000 + 50 * i) * 0.2, sr=(16000, 44100, 8000)[i])
    before = dict(audio.LOADS)
    got = audio.load_wavs(paths)
    assert audio.LOADS == {"native": before["native"] + 3, "python": before["python"]}
    for p, y in zip(paths, got):
        np.testing.assert_array_equal(y, audio.load_wav(p)[0])
    # the python path takes the files the batch loader returns None for
    monkeypatch.setattr(native_audio, "load_batch_native", lambda ps, sr=16000: [None] * len(ps))
    monkeypatch.setenv("SER_TPU_NATIVE", "0")
    before = dict(audio.LOADS)
    fallback = audio.load_wavs(paths)
    assert audio.LOADS == {"native": before["native"], "python": before["python"] + 3}
    np.testing.assert_array_equal(fallback[0], got[0])
    np.testing.assert_array_equal(fallback[1], audio.load_wav_python(paths[1]))


def test_native_off_forces_the_python_path(tmp_path, monkeypatch):
    p = str(tmp_path / "d.wav")
    _write(p, np.random.default_rng(3).normal(size=5000) * 0.2, sr=22050)
    monkeypatch.setenv("SER_TPU_NATIVE", "0")
    assert not native_audio.available()
    before = dict(audio.LOADS)
    ours, sr = audio.load_wav(p)
    assert audio.LOADS["python"] == before["python"] + 1 and audio.LOADS["native"] == before["native"]
    np.testing.assert_array_equal(ours, _jax_python(monkeypatch, p))
    monkeypatch.delenv("SER_TPU_NATIVE")
    assert native_audio.available()


def test_build_lands_under_build_and_falls_back_without_a_compiler(tmp_path, monkeypatch, capsys):
    lib = native_audio.build()
    assert lib.parent.parent == native_audio.BUILD_ROOT and lib.name == "libser_audio.so"
    assert native_audio.build() == lib  # keyed by the source's hash: built once
    assert str(native_audio.BUILD_ROOT).startswith(os.path.join(ROOT, "build"))
    p = str(tmp_path / "e.wav")
    _write(p, np.random.default_rng(4).normal(size=3000) * 0.2)
    monkeypatch.setattr(native_audio, "BUILD_ROOT", tmp_path / "fresh")
    monkeypatch.setattr(native_audio, "_compiler", lambda: None)
    monkeypatch.setattr(audio, "LOADS", {"native": 0, "python": 0})
    native_audio.reset_cache()
    try:
        assert not native_audio.available() and "no C++ compiler" in native_audio.BUILD_ERROR
        ours, _ = audio.load_wav(p)
        assert audio.LOADS == {"native": 0, "python": 1}
        assert "wav loader: python (native loader: no C++ compiler" in capsys.readouterr().out
        np.testing.assert_array_equal(ours, _jax_python(monkeypatch, p))
    finally:
        monkeypatch.undo()
        native_audio.reset_cache()
    assert native_audio.available()
