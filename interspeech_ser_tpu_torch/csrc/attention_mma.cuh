// Tensor-core building blocks shared by K1 (attention_btd.cu) and K4
// (attention_btd_bwd.cu) in bf16: cp.async tile staging, ldmatrix fragment
// loads and mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t):
//   A (16 x 16, row-major): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same),
//                           a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, same)
//   B (16 x 8, k x n):      b0 (k 2t, 2t+1; n g), b1 (k 2t+8, 2t+9; n g)
//   C (16 x 8, f32):        c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// so the C fragments of two neighbouring n8 tiles, rounded to bf16 and
// packed in pairs, are the A fragment of the next product (P.V, P^T.dO,
// dS.K, ...) without a trip through shared memory.
//
// Shared tiles are [rows][STR] bf16 with STR = HDP + 8: the head dim padded
// to a multiple of 16 (the k16 depth of a product; hd 120 -> 128, the pad
// columns zero) plus 8, so that a row is an odd number of 16-byte units and
// the 8 rows an ldmatrix reads fall in 8 different bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_mma {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The key length a TPU kernel pads Tk to with zero keys. In a query row whose
// keys are all masked every key weighs exp(0) = 1, the padded ones included,
// so the row is sum(V) / padded and its backward takes P = 1 / padded on
// every key. K1, K4 and K7 pad to a multiple of 128; K6 to a multiple of its
// block_k = min(256, max(128, Tk)).
__host__ __device__ __forceinline__ int oneshot_padded_tk(int Tk) { return (Tk + 127) / 128 * 128; }
__host__ __device__ __forceinline__ int flash_padded_tk(int Tk) {
  const int bk = Tk < 128 ? 128 : (Tk > 256 ? 256 : Tk);
  return (Tk + bk - 1) / bk * bk;
}

template <int HD>
struct Dims {
  static constexpr int HDP = (HD + 15) / 16 * 16;  // depth of Q.K^T / dO.V^T, zero-padded
  static constexpr int KC = HDP / 16;              // k16 steps over the head dim
  static constexpr int NT = HD / 8;                // n8 steps over the head dim as an output width
  static constexpr int STR = HDP + 8;              // shared row stride in elements
  static constexpr int CH = HD / 8;                // 16-byte chunks of a row in device memory
  static_assert(HD % 8 == 0, "rows are copied in 16-byte chunks");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte copy device -> shared, or 16 zero bytes when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

// A fragment (16 rows x k16 step kc) of a [rows][STR] tile whose first row is `tile`
template <int STR>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int kc, int lane) {
  const int mi = lane >> 3;
  ldsm_x4(a, tile + ((lane & 7) + (mi & 1) * 8) * STR + kc * 16 + (mi >> 1) * 8);
}

// B fragments of two n8 tiles (rows n0..n0+15 of a [n][k] tile) at k16 step kc:
// b[0], b[1] for rows n0..n0+7, b[2], b[3] for rows n0+8..n0+15
template <int STR>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile, int n0, int kc, int lane) {
  const int mi = lane >> 3;
  ldsm_x4(b, tile + (n0 + (lane & 7) + (mi >> 1) * 8) * STR + kc * 16 + (mi & 1) * 8);
}

// A = C fragments of two neighbouring n8 tiles, rounded to bf16
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// acc[16 x HD] += A[16 x 16] . X[k0 .. k0+15][0 .. HD-1], X a [k][n] tile
// (rows k, the head dim along the row), B fragments by ldmatrix.trans
template <int HD, int STR>
__device__ __forceinline__ void mma_a_xkn(float (&acc)[HD / 8][4], const uint32_t (&a)[4], const bf16* tile,
                                          int k0, int lane) {
  constexpr int NT = HD / 8;
  const int mi = lane >> 3;
  const bf16* row = tile + (k0 + (lane & 7) + (mi & 1) * 8) * STR;
#pragma unroll
  for (int dp = 0; dp < NT / 2; ++dp) {
    uint32_t b[4];
    ldsm_x4_t(b, row + dp * 16 + (mi >> 1) * 8);
    mma16816(acc[2 * dp], a, b[0], b[1]);
    mma16816(acc[2 * dp + 1], a, b[2], b[3]);
  }
  if constexpr (NT % 2 == 1) {  // hd 120: the 15th n8 step (lanes 16-31 give unused addresses)
    uint32_t b0, b1;
    ldsm_x2_t(b0, b1, row + (NT - 1) * 8);
    mma16816(acc[NT - 1], a, b0, b1);
  }
}

// s[16 x 8*NS] = A_tile[16 x HDP] . N_tile[n0 .. n0+8*NS-1]^T (both [row][STR], depth the head dim)
template <int HD, int NS>
__device__ __forceinline__ void mma_rows_nk(float (&s)[NS][4], const bf16* a_tile, const bf16* n_tile, int lane) {
  constexpr int STR = Dims<HD>::STR;
#pragma unroll
  for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < Dims<HD>::KC; ++kc) {
    uint32_t a[4];
    load_a<STR>(a, a_tile, kc, lane);
#pragma unroll
    for (int np = 0; np < NS / 2; ++np) {
      uint32_t b[4];
      load_b_nk<STR>(b, n_tile, np * 16, kc, lane);
      mma16816(s[2 * np], a, b[0], b[1]);
      mma16816(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// cp.async rows [r0, r0 + R) of a [*, D] panel (head column h * HD) into a
// [R][STR] tile; rows at or past `n` are zero-filled
template <int HD, int R, int THREADS>
__device__ __forceinline__ void stage_rows(bf16* tile, const bf16* panel, int r0, int n, int D, int h, int tid) {
  constexpr int CH = Dims<HD>::CH;
  constexpr int STR = Dims<HD>::STR;
  for (int idx = tid; idx < R * CH; idx += THREADS) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const bool ok = r0 + r < n;
    cp_async16(tile + r * STR + c, panel + (size_t)(ok ? r0 + r : 0) * D + h * HD + c, ok);
  }
}

// zero the pad columns HD .. HDP-1 of `rows` rows (hd 120 only); cp.async never writes them
template <int HD, int THREADS>
__device__ __forceinline__ void zero_pad(bf16* tile, int rows, int tid) {
  constexpr int HDP = Dims<HD>::HDP, STR = Dims<HD>::STR;
  if constexpr (HDP > HD) {
    static_assert(HDP - HD == 8, "one 16-byte pad unit a row");
    for (int r = tid; r < rows; r += THREADS) *reinterpret_cast<uint4*>(tile + r * STR + HD) = make_uint4(0, 0, 0, 0);
  }
}

// An [R x C] bf16 tile of a panel (row stride ld) on its way to shared
// memory through registers, so that its loads fly while the current tile is
// computed: thread tid holds elements e * THREADS + tid, two to a register.
// 2-byte loads, since a row of Tk bf16 values starts on any 2-byte boundary.
template <int R, int C, int THREADS>
struct TileRegs {
  static constexpr int PER = R * C / THREADS;
  static constexpr int RSTEP = THREADS / C;  // rows between a thread's elements
  static_assert(PER % 2 == 0 && THREADS % C == 0, "whole rows, pairs of elements");
  uint32_t v[PER / 2];

  __device__ __forceinline__ void load(const bf16* panel, int r0, int c0, int nrows, int ncols, size_t ld,
                                       int tid) {
    const int r = r0 + tid / C, c = c0 + tid % C;
    const unsigned short* p = reinterpret_cast<const unsigned short*>(panel) + (size_t)r * ld + c;
#pragma unroll
    for (int i = 0; i < PER / 2; ++i) {
      const int ra = r + 2 * i * RSTEP, rb = ra + RSTEP;
      const uint32_t lo = (c < ncols && ra < nrows) ? __ldg(p + (size_t)(2 * i) * RSTEP * ld) : 0u;
      const uint32_t hi = (c < ncols && rb < nrows) ? __ldg(p + (size_t)(2 * i + 1) * RSTEP * ld) : 0u;
      v[i] = lo | (hi << 16);
    }
  }

  __device__ __forceinline__ void store(bf16* tile, int stride, int tid) const {
    unsigned short* t = reinterpret_cast<unsigned short*>(tile) + (tid / C) * stride + tid % C;
#pragma unroll
    for (int i = 0; i < PER / 2; ++i) {
      t[(2 * i) * RSTEP * stride] = (unsigned short)(v[i] & 0xffffu);
      t[(2 * i + 1) * RSTEP * stride] = (unsigned short)(v[i] >> 16);
    }
  }
};

}  // namespace attn_mma
