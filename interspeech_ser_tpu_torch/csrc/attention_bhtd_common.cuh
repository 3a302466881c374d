// Shared by K6 (flash_attention.cu) and K7 (attention_bhtd.cu): masked SDPA
// on [B, H, T, hd] heads with head dim 64.
//
// Their f32 kernels (the bf16 ones run on the tensor cores, attention_mma.cuh)
// give one query row to TPR = 4 neighbouring threads of a warp:
// while scoring, thread `part` of the row takes keys part, part+4, ... of a
// 64-key tile; while summing P.V it owns the output's float4 chunks part,
// part+4, part+8, part+12 (16 of the 64 columns). Row reductions (max, sum)
// are two xor-shuffles among those 4 lanes. K/V tiles sit in shared memory
// as f32 rows padded to HD + 4 floats, so the 4 key rows (or the 4 column
// chunks) a warp reads at once fall in different banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mma.cuh"

namespace bhtd {

using attn_mma::flash_padded_tk;
using attn_mma::oneshot_padded_tk;

constexpr int HD = 64;       // head dim (RoBERTa-large, WavLM, Whisper)
constexpr int TPR = 4;       // threads per query row
constexpr int BK = 64;       // keys per tile
constexpr int KV_LD = HD + 4;  // padded shared-memory row of a K/V tile
constexpr float NEG_INF = -1e30f;  // masked score, as in the TPU kernels (not -inf)

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [k0, k0 + BK) of one head's [T, HD] panel (rows `ld` elements apart)
// into `tile` as f32, zeros past `Tk`; all `nthreads` threads of the block
// take part, neighbouring threads on neighbouring columns.
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ src, long long ld, int k0,
                                          int Tk, int tid, int nthreads) {
  for (int idx = tid; idx < BK * HD; idx += nthreads) {
    const int r = idx / HD, c = idx % HD;
    const int kj = k0 + r;
    tile[r * KV_LD + c] = kj < Tk ? src[kj * ld + c] : 0.f;
  }
}

// q . k for one query row held in registers and one key row of a tile.
__device__ __forceinline__ float dot_row(const float (&qr)[HD], const float* krow_f) {
  const float4* krow = reinterpret_cast<const float4*>(krow_f);
  float s = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < HD / 4; ++d4) {
    const float4 kk = krow[d4];
    s = fmaf(qr[4 * d4 + 0], kk.x, s);
    s = fmaf(qr[4 * d4 + 1], kk.y, s);
    s = fmaf(qr[4 * d4 + 2], kk.z, s);
    s = fmaf(qr[4 * d4 + 3], kk.w, s);
  }
  return s;
}

// acc (this thread's 4 float4 chunks of the row) += p * v_row
__device__ __forceinline__ void axpy_chunks(float (&acc)[16], float p, const float* vrow_f, int part) {
  const float4* vrow = reinterpret_cast<const float4*>(vrow_f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 vv = vrow[part + TPR * i];
    acc[4 * i + 0] = fmaf(p, vv.x, acc[4 * i + 0]);
    acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
  }
}

// out_row's chunks part, part+4, ... = acc / max(l, 1e-30)
__device__ __forceinline__ void store_chunks(float* __restrict__ orow, const float (&acc)[16], float l, int part) {
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * (part + TPR * i);
#pragma unroll
    for (int e = 0; e < 4; ++e) orow[c + e] = acc[4 * i + e] / den;
  }
}

}  // namespace bhtd
