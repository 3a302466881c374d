"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

All sources under ``interspeech_ser_tpu_torch/csrc/`` compile into one
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<hash>/libser_kernels.so csrc/*.cu

The build runs at first use (never at import), into ``build/`` at the root
of the checkout, keyed by a hash of the sources: an edited source builds a
fresh library, an unchanged one is reused. Every entry point takes device
pointers and the CUDA stream as ``c_void_p``, ints as ``c_int``, and returns
``cudaGetLastError()`` after its launch; :func:`check` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "kernels"
SOURCES = ("attention_btd.cu", "conv_frontend.cu", "gru_bidir.cu", "gru_bidir_bwd.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> argument types (all return int: a cudaError_t)
SIGNATURES = {
    # q, k, v, key_mask, gate, bias, out, B, Tq, Tk, H, hd, scale, stream
    "ser_attention_btd_f32": [_P] * 7 + [_I] * 5 + [_F, _P],
    "ser_attention_btd_bf16": [_P] * 7 + [_I] * 5 + [_F, _P],
    # wav, weight, bias, ln_w, ln_b, out, B, L, T0, C, k, stride, eps, approx_gelu, stream
    "ser_conv_frontend_f32": [_P] * 6 + [_I] * 6 + [_F, _I, _P],
    "ser_conv_frontend_bf16": [_P] * 6 + [_I] * 6 + [_F, _I, _P],
    # x_proj, w_hh2, b_hh2, mask, out, B2, T, H, threads, stream
    "ser_gru_bidir_f32": [_P] * 5 + [_I] * 4 + [_P],
    # g, h, x_proj, mask, w_hh2, b_hh2, dxp, dhp scratch, dw, db, B2, T, H, threads, stream
    "ser_gru_bidir_bwd_f32": [_P] * 10 + [_I] * 4 + [_P],
    "ser_cuda_error_string": [_I],
}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if this hash has no library yet; return its path.

    The compiler's ``-Xptxas -v`` report (registers, shared memory, spills
    per kernel) is kept beside the library as ``build.log``."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "libser_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libser_kernels.so.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC_DIR / s) for s in SOURCES)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}"
    (out_dir / "build.log").write_text(log + f"\nseconds: {time.perf_counter() - t0:.2f}\n")
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
    os.replace(tmp, lib)  # atomic: a half-written library is never loaded
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with typed entries."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_char_p if name == "ser_cuda_error_string" else ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().ser_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> "int | None":
    return None if t is None else t.data_ptr()
