"""Peaks, kernel bounds and model FLOPs, as functions of shapes.

Peaks are NVIDIA's published dense figures for the H100 SXM (700 W):
67 TFLOP/s float32 off the tensor cores (what an f32 cell with TF32 off
runs on), 989 TFLOP/s bf16, 3.35 TB/s of HBM. A kernel's least time is the
larger of its operations over the peak and its bytes over the bandwidth;
operations count the work these inputs need (live frames, live keys), so
that a share of it cannot pass 100% unless the time misses work. The K1,
K3 and K3b counts are those of the port's kernel table (``chip_smoke.py``),
with K1's query rows counted live as its keys are.

Model FLOPs count multiply-adds as 2 and cover the matmuls and
convolutions; a training step is the forward, plus twice it for the
backward, less the input gradient of each modality's first projection,
which nothing needs.
"""

from __future__ import annotations

from typing import Dict, Sequence

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12

# the profiler's names of the port's kernels that a metric reads (substrings), by kernel
KERNELS = {
    "K1": ("attention_btd_f32_kernel", "attention_btd_mma_kernel"),
    "K3": ("gru_bidir_kernel", "gru_bidir_cluster_kernel"),
    "K3b": ("gru_bidir_bwd_kernel", "gru_bidir_bwd_cluster_kernel", "gru_gemm_kernel", "gru_dw_reduce_kernel"),
}


def least_seconds(flops: float, nbytes: float, dtype: str = "float32") -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def k1_seconds(lengths: Sequence[int], T: int, D: int, H: int, bias: bool, dtype: str = "float32") -> float:
    """One K1 call on a [B, T, D] batch whose rows hold ``lengths`` live
    frames (queries and keys): QK^T, PV and the softmax over live pairs;
    q, k, v and out once, the gate, the [H, T, T] bias and the mask."""
    item = 4 if dtype == "float32" else 2
    pairs = sum(n * n for n in lengths)
    flops = 4 * D * pairs + 8 * H * pairs
    nbytes = item * 4 * D * sum(lengths) + 4 * len(lengths) * T
    if bias:
        nbytes += 4 * (len(lengths) * H * T + H * T * T)
    return least_seconds(flops, nbytes, dtype)


def _gru_bytes(rows: int, T: int, H: int) -> int:
    return 4 * (rows * T * 3 * H + 2 * H * 3 * H + 2 * 3 * H + rows * T + rows * T * H)


def k3_seconds(valid: int, rows: int, T: int, H: int) -> float:
    """One K3 call: ``rows`` = both directions' rows (2B), ``valid`` their
    live steps summed; x_proj, w_hh, b_hh, the mask and the output once."""
    return least_seconds(valid * (6 * H * H + 12 * H), _gru_bytes(rows, T, H))


def k3b_seconds(valid: int, rows: int, T: int, H: int) -> float:
    """K3b's kernels of one backward: gate recompute, recurrence and dW;
    its inputs (x_proj, w_hh, b_hh, mask, h, the cotangent) and outputs
    (dx_proj, dh, dW, db) once."""
    nbytes = _gru_bytes(rows, T, H) + 4 * (rows * T * H + rows * T * 3 * H + rows * H + 2 * H * 3 * H + 2 * 3 * H)
    return least_seconds(valid * (18 * H * H + 30 * H), nbytes)


def wavlm_flops(n_samples: int, cfg: Dict) -> float:
    """One utterance through the conv frontend, projection, positional conv and layers."""
    flops, t, c_in = 0.0, n_samples, 1
    for c, k, s in zip(cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"]):
        t = (t - k) // s + 1
        flops += 2 * t * c * c_in * k
        c_in = c
    D, Fd, L = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    G, K = cfg["num_conv_pos_embedding_groups"], cfg["num_conv_pos_embeddings"]
    flops += 2 * t * c_in * D + 2 * t * D * (D // G) * K
    return flops + L * (8 * t * D * D + 4 * t * t * D + 4 * t * D * Fd)


def whisper_flops(cfg: Dict) -> float:
    """One 30-s input: the DFT and mel products, both convs and the layers."""
    frames, D, M = 3001, cfg["d_model"], cfg["num_mel_bins"]
    flops = 2 * 2 * frames * 400 * 201 + 2 * frames * 201 * M
    T = cfg["max_source_positions"]
    flops += 2 * 2 * T * D * M * 3 + 2 * T * D * D * 3
    return flops + cfg["encoder_layers"] * (8 * T * D * D + 4 * T * T * D + 4 * T * D * cfg["encoder_ffn_dim"])


def fusion_step_flops(speech: Sequence[int], text: Sequence[int], dims: Sequence[int], H: int, classes: int) -> float:
    """One training step of the bimodal classifier over rows of ``speech`` /
    ``text`` live frames: projections, both GRU directions (input products
    and recurrence), the two cross attentions, pooling and the heads."""
    E = 2 * H
    fwd, first = 0.0, 0.0
    for lengths, d in zip((speech, text), dims):
        n = sum(lengths)
        first += 2 * n * d * H
        fwd += 2 * n * d * H + 2 * (2 * n * H * 3 * H + 2 * n * H * 3 * H) + 2 * n * E
    for q, k in ((speech, text), (text, speech)):
        fwd += sum(2 * a * E * E + 4 * b * E * E + 4 * a * b * E + 2 * a * E * E for a, b in zip(q, k))
    fwd += len(speech) * (2 * 2 * E * H + 2 * H * classes)
    return 3 * fwd - first
