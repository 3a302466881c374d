"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

All sources under ``interspeech_ser_tpu_torch/csrc/`` compile into one
shared library with a plain C interface: one nvcc per source, all started
together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c -o build/kernels/<hash>/<source>.o csrc/<source>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o .../libser_kernels.so *.o

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
SOURCES = ("attention_btd.cu", "attention_btd_bwd.cu", "attention_bhtd.cu", "flash_attention.cu", "conv_frontend.cu",
           "gru_bidir.cu", "gru_bidir_bwd.cu", "ffn_fused.cu", "pos_conv.cu")
HEADERS = ("attention_bhtd_common.cuh", "attention_f32.cuh", "attention_mma.cuh", "gru_cluster.cuh",
           "wgmma.cuh")  # included by sources: part of the hash
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.POINTER(ctypes.c_longlong)
# entry point -> argument types (all return int: a cudaError_t)
SIGNATURES = {
    # q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, hd, scale, stream
    "ser_attention_btd_f32": [_P] * 8 + [_I] * 5 + [_F, _P],
    "ser_attention_btd_bf16": [_P] * 8 + [_I] * 5 + [_F, _P],
    # hd, bias, int[3] out: tile, shared bytes, blocks an SM (the f32 K1 kernel)
    "ser_attention_btd_f32_plan": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    # kind (1: dK/dV, 2: dQ), hd, bias, int[3] out (the f32 K4 passes)
    "ser_attention_btd_bwd_f32_plan": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    # q, k, v, key_mask, gate, bias, out, strides (12 x int64: b, h, t of q, k, v,
    # out), B, H, Tq, Tk, hd, scale, stream
    "ser_attention_bhtd_f32": [_P] * 7 + [_LL] + [_I] * 5 + [_F, _P],
    "ser_attention_bhtd_bf16": [_P] * 7 + [_LL] + [_I] * 5 + [_F, _P],
    "ser_flash_attention_f32": [_P] * 7 + [_LL] + [_I] * 5 + [_F, _P],
    # Tq, Tk, bias, int[5] out: route, rows, tile keys, shared bytes, blocks an SM
    "ser_attention_bhtd_f32_plan": [_I] * 3 + [ctypes.POINTER(ctypes.c_int)],
    "ser_flash_attention_f32_plan": [_I] * 3 + [ctypes.POINTER(ctypes.c_int)],
    "ser_flash_attention_bf16": [_P] * 7 + [_LL] + [_I] * 5 + [_F, _P],
    # q, k, v, g, out, key_mask, gate, bias, lse, delta, q*scale and dbias
    # scratch, dq, dk, dv, dgate, dbias, B, Tq, Tk, H, hd, scale, stream
    "ser_attention_btd_bwd_f32": [_P] * 17 + [_I] * 5 + [_F, _P],
    "ser_attention_btd_bwd_bf16": [_P] * 17 + [_I] * 5 + [_F, _P],
    # wav, weight, bias, ln_w, ln_b, out, B, L, T0, C, k, stride, eps, approx_gelu, blocks,
    # frames a block, stream
    "ser_conv_frontend_f32": [_P] * 6 + [_I] * 6 + [_F, _I, _I, _I, _P],
    "ser_conv_frontend_bf16": [_P] * 6 + [_I] * 6 + [_F, _I, _I, _I, _P],
    # bf16, k, approx_gelu, int[3] out: threads, static shared bytes, blocks an SM (layer 0)
    "ser_conv_frontend_plan": [_I] * 3 + [ctypes.POINTER(ctypes.c_int)],
    # approx_gelu, out (bf16 [65536]), stream: the layer-0 kernel's bf16 GELU table
    "ser_gelu_bf16_table": [_I, _P, _P],
    # x, weight, bias, ln_w, ln_b, out, B, T_in, T_out, C_in, C, k, stride, eps, approx_gelu, stream
    "ser_conv_layer_f32": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
    "ser_conv_layer_bf16": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
    # x, w_up, b_up, w_down, b_down, out, M, K, F, N, approx_gelu, stream
    "ser_ffn_fused_f32": [_P] * 6 + [_I] * 5 + [_P],
    "ser_ffn_fused_bf16": [_P] * 6 + [_I] * 5 + [_P],
    # x, w, y, B, T, G, C, K, frames a block, stages, stream
    "ser_pos_conv_f32": [_P] * 3 + [_I] * 7 + [_P],
    "ser_pos_conv_bf16": [_P] * 3 + [_I] * 7 + [_P],
    # bf16, C, K, frames, stages, int[3] out: threads, shared bytes, blocks an SM
    "ser_pos_conv_plan": [_I] * 5 + [ctypes.POINTER(ctypes.c_int)],
    # src, src bf16, dst, dst bf16, G, R, S, stream: K8's weight layout, dst[g][s][r] = src[g][r][s]
    "ser_pos_conv_layout": [_P, _I, _P, _I, _I, _I, _I, _P],
    # x_proj, w_hh2, b_hh2, mask, out, B2, T, H, cluster (0: one block a row), threads, stream
    "ser_gru_bidir_f32": [_P] * 5 + [_I] * 5 + [_P],
    # cluster, seq (0: K3, 1: K9), int* count
    "ser_gru_max_active_clusters": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    # x_proj, w_hh, b_hh, mask, out, B, T, H, reverse, cluster (0: one block a row), threads, stream
    "ser_gru_sequence_f32": [_P] * 5 + [_I] * 6 + [_P],
    # h, w_hh2, b_hh2, hp, B2, T, H, stream
    "ser_gru_bwd_gates_f32": [_P] * 4 + [_I] * 3 + [_P],
    # g, h, x_proj, mask, w_hh2, b_hh2, hp, dxp, dhp, B2, T, H, cluster (0: one block a row), threads, stream
    "ser_gru_bidir_bwd_f32": [_P] * 9 + [_I] * 5 + [_P],
    # h, dhp, dw_part, db_part, dw, db, B2, T, H, splits, stream
    "ser_gru_bwd_dw_f32": [_P] * 6 + [_I] * 4 + [_P],
    # cluster, int* count
    "ser_gru_bwd_max_active_clusters": [_I, ctypes.POINTER(ctypes.c_int)],
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
    for name in SOURCES + HEADERS:
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
    nvcc, pid = _nvcc(), os.getpid()
    t0 = time.perf_counter()
    objs = [str(out_dir / f"{name}.{pid}.o") for name in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC_DIR / name)] for name, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    log, failed = [], False
    for cmd, proc in zip(cmds, procs):  # all compile at once; wait for each in turn
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        failed |= proc.returncode != 0
    tmp = out_dir / f"libser_kernels.so.tmp{pid}"
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}")
        failed = res.returncode != 0
    text = "\n".join(log)
    (out_dir / "build.log").write_text(text + f"\nseconds: {time.perf_counter() - t0:.2f}\n")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{text}")
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
