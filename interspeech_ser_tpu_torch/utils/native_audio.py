"""ctypes binding for the native audio loader, built from ``native/ser_audio.cpp``.

Port of ``interspeech_ser_tpu/utils/native_audio.py``. The C++ library
decodes PCM WAV (8/16/24/32-bit int, 32-bit float), mixes down to mono,
resamples with a windowed-sinc filter and can normalise, one file at a time
or over a ``std::thread`` batch. ``utils/audio.py::load_wav`` uses it first
and falls back to its python path when the library cannot be had;
``SER_TPU_NATIVE=0`` forces the python path.

The port builds the library itself at first use (never at import), from the
checkout's ``native/ser_audio.cpp``, with the host compiler and the flags of
``native/Makefile`` less ``-march=native`` (a library built on one machine
may run on another's CPU):

    g++ -O3 -fPIC -std=c++17 -Wall -shared -o build/native/<hash>/libser_audio.so \
        native/ser_audio.cpp -lpthread

into ``build/`` at the root of the checkout, keyed by a hash of the source
and the flags; nothing is written under ``native/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "ser_audio.cpp"
BUILD_ROOT = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
BATCH_THREADS = 8  # the std::threads of one load_batch_native call

_LIB = None
_TRIED = False
_PROBE = threading.Lock()  # loader threads wait for one build
BUILD_ERROR: Optional[str] = None  # why the last probe found no library


def _compiler() -> Optional[str]:
    for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


def build() -> Path:
    """Compile the library if this hash has none yet; return its path."""
    if not SOURCE.exists():
        raise FileNotFoundError(f"{SOURCE} is missing")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_ROOT / h / "libser_audio.so"
    if lib.exists():
        return lib
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (CXX, g++, c++ or clang++) on PATH")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"libser_audio.so.tmp{os.getpid()}"
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)  # atomic: a half-written library is never loaded
    return lib


def get_lib():
    """The bound library, built at the first call; None under
    ``SER_TPU_NATIVE=0`` or when it cannot be built or loaded."""
    global _LIB, _TRIED, BUILD_ERROR
    if os.environ.get("SER_TPU_NATIVE") == "0":
        return None
    with _PROBE:
        if not _TRIED:
            _LIB, BUILD_ERROR = _bind()
            _TRIED = True
    return _LIB


def _bind():
    try:
        lib = ctypes.CDLL(str(build()))
        lib.ser_audio_load.restype = ctypes.c_long
        lib.ser_audio_load.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.POINTER(ctypes.c_int),
        ]
        lib.ser_audio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.ser_audio_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.POINTER(ctypes.c_long),
        ]
        return lib, None
    except (OSError, RuntimeError) as e:
        return None, str(e)


def reset_cache() -> None:
    """Forget the probe, so that the next call builds or loads again."""
    global _LIB, _TRIED
    with _PROBE:
        _LIB = None
        _TRIED = False


def available() -> bool:
    return get_lib() is not None


def load_wav_native(path: str, target_sr: int = 16000, normalize: bool = False):
    """-> (samples float32 in [-1, 1], original rate), or None on failure."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    sr = ctypes.c_int(0)
    n = lib.ser_audio_load(os.fsencode(path), target_sr, int(normalize), ctypes.byref(out), ctypes.byref(sr))
    if n < 0:
        return None
    arr = np.ctypeslib.as_array(out, shape=(n,)).copy() if n else np.zeros(0, np.float32)
    lib.ser_audio_free(out)
    return arr, int(sr.value)


def load_batch_native(
    paths: Sequence[str], target_sr: int = 16000, normalize: bool = False,
) -> Optional[List[Optional[np.ndarray]]]:
    """The files decoded on BATCH_THREADS threads -> a list with None for a
    file that failed, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    outs = (ctypes.POINTER(ctypes.c_float) * n)()
    lengths = (ctypes.c_long * n)()
    lib.ser_audio_load_batch(c_paths, n, target_sr, int(normalize), BATCH_THREADS, outs, lengths)
    result: List[Optional[np.ndarray]] = []
    for i in range(n):
        if lengths[i] < 0:
            result.append(None)
            continue
        arr = np.ctypeslib.as_array(outs[i], shape=(lengths[i],)).copy() if lengths[i] else np.zeros(0, np.float32)
        lib.ser_audio_free(outs[i])
        result.append(arr)
    return result
