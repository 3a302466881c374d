// Shared by K6 (flash_attention.cu) and K7 (attention_bhtd.cu): masked SDPA
// on [B, H, T, hd] heads with head dim 64.
//
// Their f32 kernels (the bf16 ones run on the tensor cores, attention_mma.cuh)
// are built on K1's FP32 register micro-tiles (attention_f32.cuh): IEEE fmaf,
// TF32 off; 256 threads own 16 * RI query rows (RI = 4, 5 or 8: the fewest of
// 64, 80 and 128 rows that hold Tq, block_rows), thread t rows g + 16i
// (g = t >> 4, i < RI), so a row's 16 threads are one half-warp
// (lane l = t & 15); of a 64-key tile lane l takes keys l + 16j, j < 4: a
// score micro-tile of RI x 4 and an output micro-tile of RI x 4 columns
// (4l .. 4l + 3). q, K and V land in shared rows padded to HD + 4 floats by
// cp.async (stage_rows_ld: 16 bytes a copy when the view allows it, else 4),
// the bias tile and the key flags by 4-byte cp.async; row max and sum go over
// the row's half-warp by xor-shuffles in a fixed order, so a rerun gives the
// same bits and so do aligned and misaligned copies of the same data.
//
// The function differs from K1's in two places, both the TPU kernels': q . k
// is accumulated in f32 and scaled AFTER the product (K1 scales q first), and
// a masked key's score is -1e30, not -inf, so a batch row with no live key
// weighs every key exp(0) = 1 (and its TPU kernel's zero-padded keys too:
// sum(V) / Tk_p).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_f32.cuh"
#include "attention_mma.cuh"

namespace bhtd {

using attn_mma::flash_padded_tk;
using attn_mma::oneshot_padded_tk;

constexpr int HD = 64;             // head dim (RoBERTa-large, WavLM, Whisper)
constexpr float NEG_INF = -1e30f;  // masked score, as in the TPU kernels (not -inf)

struct Strides {  // elements: batch, head, time, for q, k, v and out
  long long q[3], k[3], v[3], o[3];
};

inline Strides unpack(const long long* strides) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  return st;
}

// May a kernel copy q, k, v (elements of `elem` bytes) by 16-byte cp.async?
// Every row of each must start on 16 bytes: the pointer and its batch, head
// and time strides.
inline int rows_aligned16(const void* q, const void* k, const void* v, const long long* strides, int elem) {
  int ok = 1;
  const void* ptrs[3] = {q, k, v};
  for (int a = 0; a < 3; ++a) {
    ok &= (reinterpret_cast<uintptr_t>(ptrs[a]) % 16) == 0;
    for (int i = 0; i < 3; ++i) ok &= strides[3 * a + i] * elem % 16 == 0;
  }
  return ok;
}

namespace f32 {

constexpr int BK = 64;          // keys a tile
constexpr int RJ = BK / 16;     // keys of a tile a thread owns
constexpr int STR = HD + 4;     // padded shared row of q, K, V
constexpr int PSTR = BK + 4;    // padded row of a bias / P tile (an odd number of float4)

// Query rows a block owns: the fewest of 64, 80 or 128 that hold Tq (128
// above 80), so that RoBERTa's 80 queries fill their block.
inline int block_rows(int Tq) { return Tq <= 64 ? 64 : Tq <= 80 ? 80 : 128; }

// Does batch row b have a live key? (All of the block's threads call it.) Only
// then may a tile whose keys are all masked be skipped: it adds exp(-1e30 - m) = 0
// and lowers no max; in a row with none, every key weighs 1.
__device__ __forceinline__ int live_batch_row(const float* __restrict__ mask_b, int Tk, int tid) {
  if (mask_b == nullptr) return 1;
  int any = 0;
  for (int j = tid; j < Tk; j += attn_f32::THREADS) any |= mask_b[j] > 0.f;
  return __syncthreads_or(any);
}

// the 64 key flags of the tile at k0 into fl (> 0: live), by 4-byte cp.async
// from the [Tk] mask row; keys at or past Tk get 0
__device__ __forceinline__ void stage_flags(float* fl, const float* __restrict__ mask_b, int k0, int n, int Tk,
                                            int tid) {
  for (int c = tid; c < n; c += attn_f32::THREADS) {
    const int kj = k0 + c;
    if (mask_b != nullptr) attn_f32::cp_async4(fl + c, kj < Tk ? mask_b + kj : mask_b, kj < Tk);
    else fl[c] = kj < Tk ? 1.f : 0.f;
  }
}

// gate[b, h, q] of this thread's rows g + 16i (0 past Tq)
template <int RI, bool BIAS>
__device__ __forceinline__ void load_gate(float (&gr)[RI], const float* __restrict__ gate, int b, int h, int H,
                                          int q0, int Tq, int g) {
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + g + 16 * i;
    gr[i] = (BIAS && qi < Tq) ? gate[((size_t)b * H + h) * Tq + qi] : 0.f;
  }
}

// The scores of this thread's RI x RJ micro-tile against the K tile kt (key
// rows l + 16j): q . k as one fmaf chain over the depth, times scale, plus
// gate * bias (bias element of row i, key c at bt[16 i bstr + c]: bt is the
// thread's row g of a bias tile), a masked key (flag <= 0) -1e30, a key at
// or past kn (none at all) -inf.
template <int RI, bool BIAS>
__device__ __forceinline__ void score_tile(float (&s)[RI][RJ], const float* qs, const float* kt, const float* bt,
                                           int bstr, const float (&gr)[RI], const float* fl, int kn, float scale,
                                           int g, int l) {
  attn_f32::dot_tile<HD, RI, RJ>(s, qs + g * STR, 16 * STR, kt + l * STR, 16 * STR);
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int c = l + 16 * j;
      float x = s[i][j] * scale;
      if constexpr (BIAS) x = fmaf(gr[i], bt[16 * i * bstr + c], x);
      x = fl[c] > 0.f ? x : NEG_INF;
      s[i][j] = c < kn ? x : -INFINITY;
    }
}

// this thread's rows of the output: o / max(l, 1e-30) with l the row's sum
// over its half-warp (plus the padded keys when every key was masked, m still -1e30)
template <int RI>
__device__ __forceinline__ void store_rows(float* __restrict__ ob, long long ld, float (&o)[RI][4],
                                           const float (&m)[RI], float (&lsum)[RI], float pad, int q0, int Tq,
                                           int g, int l) {
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    float s = attn_f32::half_warp_sum(lsum[i]);
    if (m[i] == NEG_INF) s += pad;  // every key masked: the padding counts
    const int qi = q0 + g + 16 * i;
    if (qi < Tq) attn_f32::store_cols<HD>(ob + qi * ld, o[i], 1.f / fmaxf(s, 1e-30f), l);
  }
}

}  // namespace f32

}  // namespace bhtd
