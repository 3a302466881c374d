// FP32-pipe building blocks shared by K1 (attention_btd.cu) and K4
// (attention_btd_bwd.cu) in f32, with TF32 off: IEEE fmaf products over
// register-blocked micro-tiles of operands staged in shared memory by
// cp.async and double-buffered. K6 and K7 use them too, on [B, H, T, hd]
// strides (stage_rows_ld; attention_bhtd_common.cuh).
//
// Every block has 256 threads and owns ROWS = 128 rows (queries in K1 and
// K4's dQ pass, keys in the dK/dV pass), RI = 8 to a thread: thread t holds
// rows g + 16i, g = t >> 4, i < 8, so the 16 threads that share rows are one
// half-warp (lane l = t & 15) and the two half-warps of a warp own
// neighbouring rows. A streamed tile of T rows of the other side (keys in K1
// and dQ, queries in dK/dV; T = 64, 32 or 16) gives lane l rows l + 16j,
// j < T / 16. Score micro-tiles are 8 x (T / 16). One block an SM (up to
// 227 KB of shared memory, up to 255 registers a thread): against 4 rows a
// thread in 64-row blocks, two an SM, its larger micro-tiles load fewer
// shared words for the same FMAs, and it was faster at every head dim on an
// H100.
//
// Shared layouts. A panel tile is [rows][STR] floats, STR = HD + 4: rows
// stay 16-byte aligned for cp.async and a row is an odd number of 16-byte
// units, so the 16 rows l + 16j that a half-warp reads at one depth as
// float4 fall in distinct bank groups, and so do the two half-warps' own
// rows (conflict-free, "padded rows": no transpose on staging). Score tiles
// (the bias tile, then P or dS) are [rows][T + 4] in K1 and dQ, and
// [T][ROWS + 4] in dK/dV with a thread's 8 keys stored side by side
// (column 8g + i for key g + 16i), so that they are float4s; their float4
// reads are conflict-free too.
//
// Operand reuse. dot_tile reads, per 4 depths, 8 + T/16 float4 for
// 32 T/16 FMAs: 128 FMAs from 12 float4 loads at T = 64 (10.7 FMAs a load
// instruction); a warp's 1024 FMAs a depth read 16 words of its own rows
// (broadcast within each half-warp) and 64 of the tile, 12.8 FMAs a
// distinct shared word. acc_tile, the products with P or dS, reads 8
// weights and hd/16 columns a key: 32 FMAs from 3 loads at hd 64.
//
// Tile sizes: the longest T in (64, 32, 16) whose shared memory fits 227 KB.
// ops/kernels/attention.py's attention_f32_plan is the same rule in Python.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "attention_mma.cuh"

namespace attn_f32 {

using attn_mma::cp_async16;
using attn_mma::cp_async_commit;
using attn_mma::cp_async_wait;
using attn_mma::smem_u32;

constexpr int THREADS = 256;
constexpr int RI = 8;                   // rows a thread owns
constexpr int ROWS = 16 * RI;           // rows a block owns
constexpr size_t SMEM_LIMIT = 232448;  // the most a block may opt into (227 KB): one block an SM

enum Kind { FWD = 0, DKDV = 1, DQ = 2 };

// shared floats of one block: K1 (t keys a tile), dK/dV (t queries), dQ (t keys)
__host__ __device__ constexpr size_t smem_floats(int kind, int hd, bool bias, int t) {
  const size_t s = (size_t)hd + 4, w = bias ? 2 : 1;
  return kind == FWD ? ROWS * s + 4 * t * s + w * ROWS * (size_t)(t + 4) + 2 * t
       : kind == DKDV ? 2 * ROWS * s + 4 * t * s + (w + 1) * (size_t)t * (ROWS + 4) + 6 * t
                      : 2 * ROWS * s + 4 * t * s + w * ROWS * (size_t)(t + 4) + 2 * t;
}
__host__ __device__ constexpr size_t smem_bytes(int kind, int hd, bool bias, int t) {
  return 4 * smem_floats(kind, hd, bias, t);
}

// A kernel's streamed tile: the longest of 64, 32, 16 rows whose shared memory fits SMEM_LIMIT
template <int KIND, int HD, bool BIAS>
struct Plan {
  static constexpr int T = smem_bytes(KIND, HD, BIAS, 64) <= SMEM_LIMIT   ? 64
                         : smem_bytes(KIND, HD, BIAS, 32) <= SMEM_LIMIT ? 32 : 16;
  static constexpr size_t BYTES = smem_bytes(KIND, HD, BIAS, T);
};

// The head-dim columns a lane owns as an output width (P.V, dV, dK, dQ):
// float4 chunks at 64m + 4l (m < NF4, those below HD), and at hd 80 one
// more column at 64 + l. hd 64: 4 columns; 80: 5; 120: 8 (lanes 14, 15 own 4).
template <int HD>
struct Cols {
  static constexpr int NF4 = HD / 64 + (HD % 64 >= 32 ? 1 : 0);
  static constexpr bool TAIL = HD % 64 == 16;
  static constexpr int NC = 4 * NF4 + (TAIL ? 1 : 0);
  static_assert(HD % 64 == 0 || HD % 64 == 16 || HD % 64 >= 32, "head dims 64, 80, 120");
  __device__ static __forceinline__ bool has(int m, int l) { return 64 * m + 4 * l < HD; }
};

__device__ __forceinline__ float comp(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// 4-byte copy device -> shared, or 4 zero bytes when !pred (src must still be a valid address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 4 : 0));
}

// rows [r0, r0 + R) of a [*, D] f32 panel (head h's HD columns) into a [R][HD + 4]
// tile by 16-byte cp.async; rows at or past n are zero-filled
template <int HD, int R>
__device__ __forceinline__ void stage_rows(float* tile, const float* panel, int r0, int n, int D, int h, int tid) {
  constexpr int CH = HD / 4, STR = HD + 4;
  for (int idx = tid; idx < R * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * 4;
    const bool ok = r0 + r < n;
    cp_async16(tile + r * STR + c, panel + (size_t)(ok ? r0 + r : 0) * D + h * HD + c, ok);
  }
}

// rows [r0, r0 + R) of one head's [T, HD] panel whose rows lie `ld` elements
// apart (a [B, H, T, hd] view with any batch, head and time strides, each row
// contiguous) into a [R][HD + 4] tile; rows at or past n are zero-filled. By
// 16-byte cp.async when the view's pointer and strides are 16-byte multiples
// (`aligned`), else by 4-byte cp.async: the same values land either way.
template <int HD, int R>
__device__ __forceinline__ void stage_rows_ld(float* tile, const float* panel, long long ld, int r0, int n,
                                              bool aligned, int tid) {
  constexpr int CH = HD / 4, STR = HD + 4;
  for (int idx = tid; idx < R * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * 4;
    const bool ok = r0 + r < n;
    const float* src = panel + (ok ? (long long)(r0 + r) * ld : 0) + c;
    float* dst = tile + r * STR + c;
    if (aligned) {
      cp_async16(dst, src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(dst + e, src + e, ok);
    }
  }
}

// the chunks this thread staged with stage_rows<HD, R>, times s: q * scale in
// place, after the thread's own cp.async wait and before the block's barrier
template <int HD, int R>
__device__ __forceinline__ void scale_rows(float* tile, float s, int tid) {
  constexpr int CH = HD / 4, STR = HD + 4;
  for (int idx = tid; idx < R * CH; idx += THREADS) {
    float4* p = reinterpret_cast<float4*>(tile + (idx / CH) * STR + (idx % CH) * 4);
    float4 x = *p;
    x.x *= s;
    x.y *= s;
    x.z *= s;
    x.w *= s;
    *p = x;
  }
}

// an [R x C] tile of a row-major f32 matrix (row stride ld) from (r0, c0) into
// shared rows of `stride` floats by 4-byte cp.async (a row of Tk or Tq values
// starts on any 4-byte boundary); elements past (nrows, ncols) are zero-filled.
// PERM > 0 stores column c at (c % 16) PERM + c / 16: a thread's keys g + 16i side by side
template <int R, int C, int PERM = 0>
__device__ __forceinline__ void stage_elems(float* tile, int stride, const float* src, int r0, int c0, int nrows,
                                            int ncols, size_t ld, int tid) {
  for (int idx = tid; idx < R * C; idx += THREADS) {
    const int r = idx / C, c = idx % C;
    const bool ok = r0 + r < nrows && c0 + c < ncols;
    const int cd = PERM > 0 ? (c % 16) * PERM + c / 16 : c;
    cp_async4(tile + r * stride + cd, ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
  }
}

// acc[i][j] = sum_d a[i * as + d] * b[j * bs + d], d = 0 .. HD-1 in order, one
// fmaf chain an element (K1 and K4 form the scores in the same order, so K4's
// exp(s - lse) is K1's P); a and b 16-byte aligned, as and bs multiples of 4
template <int HD, int RI, int RJ>
__device__ __forceinline__ void dot_tile(float (&acc)[RI][RJ], const float* a, int as, const float* b, int bs) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 x[RI], y[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) x[i] = *reinterpret_cast<const float4*>(a + i * as + d);
#pragma unroll
    for (int j = 0; j < RJ; ++j) y[j] = *reinterpret_cast<const float4*>(b + j * bs + d);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// o[i][.] += sum_k W(i, k) * x[k * xs + this lane's columns], k = 0 .. K-1 in
// order, for the RI rows i a thread owns. ROWK: W(i, k) = w[i * ws + k] (K1's P
// and dQ's dS, [rows][keys]: 4 keys a float4); else W(i, k) = w[k * ws + i]
// (dK/dV's P and dS, [queries][keys]: 4 rows a float4)
template <int HD, int RI, int K, bool ROWK>
__device__ __forceinline__ void acc_tile(float (&o)[RI][Cols<HD>::NC], const float* w, int ws, const float* x,
                                         int xs, int l) {
  typedef Cols<HD> Cl;
  constexpr int NW = ROWK ? RI : 4 * (RI / 4);  // float4 weights a step of 4 keys
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 4) {
    float4 wk[NW];
#pragma unroll
    for (int e = 0; e < NW; ++e)
      wk[e] = *reinterpret_cast<const float4*>(ROWK ? w + e * ws + k0 : w + (k0 + e / (RI / 4)) * ws + 4 * (e % (RI / 4)));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* xr = x + (k0 + u) * xs;
      float4 xv[Cl::NF4];
#pragma unroll
      for (int m = 0; m < Cl::NF4; ++m)
        xv[m] = Cl::has(m, l) ? *reinterpret_cast<const float4*>(xr + 64 * m + 4 * l) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float xt = Cl::TAIL ? xr[64 + l] : 0.f;
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float wi = ROWK ? comp(wk[i], u) : comp(wk[u * (RI / 4) + i / 4], i % 4);
#pragma unroll
        for (int m = 0; m < Cl::NF4; ++m) {
          o[i][4 * m + 0] = fmaf(wi, xv[m].x, o[i][4 * m + 0]);
          o[i][4 * m + 1] = fmaf(wi, xv[m].y, o[i][4 * m + 1]);
          o[i][4 * m + 2] = fmaf(wi, xv[m].z, o[i][4 * m + 2]);
          o[i][4 * m + 3] = fmaf(wi, xv[m].w, o[i][4 * m + 3]);
        }
        if constexpr (Cl::TAIL) o[i][4 * Cl::NF4] = fmaf(wi, xt, o[i][4 * Cl::NF4]);
      }
    }
  }
}

// row r of a thread's output micro-tile, o[r][.] * s, into a [*, D] panel row
template <int HD>
__device__ __forceinline__ void store_cols(float* row, const float (&o)[Cols<HD>::NC], float s, int l) {
  typedef Cols<HD> Cl;
#pragma unroll
  for (int m = 0; m < Cl::NF4; ++m)
    if (Cl::has(m, l))
      *reinterpret_cast<float4*>(row + 64 * m + 4 * l) =
          make_float4(o[4 * m] * s, o[4 * m + 1] * s, o[4 * m + 2] * s, o[4 * m + 3] * s);
  if constexpr (Cl::TAIL) row[64 + l] = o[4 * Cl::NF4] * s;
}

// the sum over the 16 lanes of a half-warp (xor butterfly: every lane gets the same bits)
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

}  // namespace attn_f32
