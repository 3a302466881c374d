// K5: the speech encoders' feed-forward pair in one kernel,
//   out = gelu(x . W_up^T + b_up) . W_down^T + b_down,
// with the [M, F] intermediate never written to device memory.
//
// Replaces interspeech_ser_tpu/ops/pallas/ffn_fused.py (ffn_fused ->
// _kernel), the JAX package's opt-in SER_TPU_FFN_KERNEL=1.
//
// Semantics (as the TPU kernel): x and both weights in the compute dtype,
// products accumulated in f32; b_up added in f32, GELU (exact erf, or the
// tanh form) in f32, the result rounded to the compute dtype before the
// second product; b_down added in f32 and the sum rounded once. The weights
// come in torch's Linear layout: W_up [F, K], W_down [N, F] (row = output).
//
// Design: a thread-block cluster of 8 CTAs owns BM = 128 rows. CTA c keeps
// the f32 accumulators of output columns [c*N/8, (c+1)*N/8) in registers
// (N/8 = 96, 128, 160 or 240 at the four widths) and the cluster walks F in
// chunks of FC intermediate columns (512 in bf16, 256 in f32):
//   A. CTA c computes only its FC/8 columns of the chunk's h,
//      h[128, FC/8] = gelu(x[128, :] . W_up[slice, :]^T + b_up), rounds them
//      to the compute dtype into slot c of its own h buffer [128][FC], then
//      copies that slot into slot c of the 7 peers' h buffers through
//      distributed shared memory (16-byte stores to cluster.map_shared_rank
//      addresses), so no intermediate column is computed twice;
//   B. after a cluster barrier every CTA holds the chunk's whole h and runs
//      acc += h[128, FC] . W_down[its columns, chunk]^T from local shared
//      memory.
// A second, split cluster barrier (arrive after phase B, wait before the next
// push, with phase A in between) keeps a CTA from overwriting a peer's h
// buffer that the peer still reads. Every operand tile (x and W_up for A,
// W_down for B) streams through one cp.async ring (3 stages in bf16, 4 in
// f32) of rows padded by 16 bytes to an odd number of 16-byte units, so
// ldmatrix and float4 reads are conflict-free; A's tiles are 64 (bf16) or 32
// (f32) deep, B's half that. The ring runs across the A / B boundary and
// across chunks, so the next phase's tiles load while this one computes.
// Every cluster walks F in the same order, so the weight chunks in flight
// stay in the 50 MB L2 (the two bf16 panels at XLS-R-2B are 59 MB).
//
// bf16 products run on the tensor cores: mma.sync.m16n8k16 (bf16 in, f32
// out) with ldmatrix fragments from attention_mma.cuh. The 8 warps form a
// 4 x 2 grid: warp (wr, wc) owns rows 32wr .. 32wr+31 (two m16 tiles) and
// slice columns 32wc .. 32wc+31 in A, output columns wc*N/16 .. +N/16-1 in
// B (15 n8 tiles at N = 1920, the odd one by an ldmatrix.x2), so each B
// fragment it loads feeds two products. wgmma, TMA and multicast of the x
// tiles are later work. f32 (the parity mode, TF32 off) keeps the same
// cluster structure with register-blocked FFMA micro-tiles on the FP32
// pipes: 4 rows x 4 slice columns a thread in A, 8 rows x N/128 columns in
// B, every operand a float4 read of shared memory.
//
// Budget per CTA at N = 1920: shared memory 216,064 bytes in bf16 (the h
// buffer, 133,120 in either dtype, and 3 stages of 27,648) and 225,280 in
// f32 (4 stages of 23,040), one CTA an SM; 256 threads with up to 255
// registers each (bf16: 120 f32 accumulators of B and 32 of A; f32: 120 and
// 16).
//
// Bytes a level moves per FLOP at XLS-R-2B (M = 7984, K = N = 1920,
// F = 7680; 471 GFLOP), bf16:
//   device memory: x and out once (61 MB) and the weights about once per
//     wave of resident clusters (5 x 59 MB): ~0.36 GB, 0.0008 B/FLOP,
//     0.11 ms at 3.35 TB/s;
//   L2 -> shared memory: per CTA and chunk x[128, 1920] (492 KB, read again
//     for every chunk), its W_up slice and its W_down slice (246 KB each):
//     7.4 GB over 15 chunks x 504 CTAs, 0.016 B/FLOP, about 1.35 ms at an L2
//     rate near 5.5 TB/s; half of it is x;
//   distributed shared memory: 7 x 16 KB a CTA and chunk, 0.9 GB, 0.002 B/FLOP;
//   shared memory -> registers (ldmatrix): 0.063 B/FLOP in A (two A and two
//     B fragments for 8 products a warp and k16 step), 0.040 in B (2 + 7.5
//     for 30): 24 GB, about 0.7 ms at 128 bytes a clock an SM;
//   the tensor cores: 471 GFLOP, 0.48 ms at the 989 TFLOP/s peak.
// On paper the L2 traffic of re-reading x once per chunk bounds the design
// (multicast of x to the cluster would cut it 8-fold), then mma.sync issue;
// device memory does not. In f32 the products (7.0 ms at the FP32 peak) bound
// it; its L2 traffic (22 GB, 0.047 B/FLOP) stays below them.
//
// What the card shows (chip_smoke.py, bf16 at the XLS-R-2B widths by rows;
// H100 80GB HBM3 at 700 W): 8 and 15 clusters take the same 1.05 ms, 16 take
// 1.98, 32 take 2.85 and XLS-R-2B's 63 take 4.68. So 15 clusters are
// resident at once, XLS-R-2B runs in 5 waves of about 0.95 ms, and a wave of
// 8 clusters takes as long as one of 15: no card-wide resource (L2 or device
// bandwidth) bounds it, each SM's own pipeline does, at about 98 TFLOP/s.
// Every level budgeted above needs at most 1.35 of those 4.68 ms, so the
// likely cause is that the copies are exposed, not hidden: with 8 warps an SM and
// a block-wide barrier every step, a step waits for a tile issued two steps
// before. Which share the copies take is not measured. An mbarrier pipeline
// (TMA, with x multicast to the cluster, and a producer warp) is the next
// step.
//
// Rows past M are masked (zero-filled loads, no stores), not padded in
// device memory; F may be any multiple of 8: the tail chunk's columns past F
// load as zeros, so their h is gelu(0) = 0 and they add nothing. K and F must
// be multiples of 8 (16-byte rows for cp.async; the wrapper checks), where the
// JAX kernel takes any; every encoder width is such a multiple. Every
// sum runs in one fixed order and no two CTAs share an output (no atomics),
// so a rerun is bit-identical. Inference only.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using attn_mma::bf16;

constexpr int CLUSTER = 8;   // CTAs a cluster: output columns and each chunk's h split 8 ways
constexpr int THREADS = 256;
constexpr int BM = 128;      // rows a cluster owns

// Per dtype: FC intermediate columns a chunk; KSA / KSB the reduction step of
// a phase-A / phase-B tile (rows of 128 + 16 and 64 + 16 bytes: odd numbers of
// 16-byte units, so ldmatrix and float4 reads are conflict-free); the ring's
// depth; the h buffer's row stride HLD (1040 bytes).
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int FC = 512, KSA = 64, KSB = 32, STAGES = 3, HLD = FC + 8;
};
template <>
struct Cfg<float> {
  static constexpr int FC = 256, KSA = 32, KSB = 16, STAGES = 4, HLD = FC + 4;
};

template <typename T, int NC>
struct Layout {
  typedef Cfg<T> C;
  static constexpr int FC = C::FC, KSA = C::KSA, KSB = C::KSB, HLD = C::HLD, STAGES = C::STAGES;
  static constexpr int SW = FC / CLUSTER;        // this CTA's h columns a chunk
  static constexpr int E = 16 / sizeof(T);       // elements a 16-byte copy
  static constexpr int LDA = KSA + E, LDB = KSB + E;  // staged row strides, elements
  static constexpr int STAGE = (BM + SW) * LDA > NC * LDB ? (BM + SW) * LDA : NC * LDB;  // elements
  static constexpr size_t h_bytes = (size_t)BM * HLD * sizeof(T);
  static constexpr size_t bytes = h_bytes + (size_t)STAGES * STAGE * sizeof(T);
  static_assert(SW * sizeof(T) == 128, "a slot row is 8 16-byte units");
  static_assert(NC % 16 == 0 && NC <= 256, "N/8 in n16 steps");
  static_assert(bytes <= 232448, "one CTA's shared memory");
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// B fragment of one n8 tile (rows n0..n0+7 of a [n][k] tile) at k16 step kc
template <int STR>
__device__ __forceinline__ void load_b_nk_x2(uint32_t& b0, uint32_t& b1, const bf16* tile, int n0, int kc,
                                             int lane) {
  const bf16* p = tile + (n0 + (lane & 7)) * STR + kc * 16 + ((lane >> 3) & 1) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(attn_mma::smem_u32(p)));
}

__device__ __forceinline__ float gelu(float z, int approx) {
  if (approx) {
    const float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
    return 0.5f * z * (1.f + tanhf(u));
  }
  return 0.5f * z * (1.f + erff(z * 0.7071067811865476f));
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS, 1) ffn_fused_kernel(
    const T* __restrict__ x,           // [M, K]
    const T* __restrict__ w_up,        // [F, K]
    const float* __restrict__ b_up,    // [F]
    const T* __restrict__ w_down,      // [N, F]
    const float* __restrict__ b_down,  // [N]
    T* __restrict__ out,               // [M, N]
    int M, int K, int F, int approx_gelu) {
  typedef Layout<T, NC> L;
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int FC = L::FC, SW = L::SW, KSA = L::KSA, KSB = L::KSB, LDA = L::LDA, LDB = L::LDB, HLD = L::HLD;
  constexpr int E = L::E, STAGES = L::STAGES, STAGE = L::STAGE;
  constexpr int N = NC * CLUSTER;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hbuf = reinterpret_cast<T*>(smem_raw);               // [BM][HLD]: the chunk's h, slot c = columns c*SW..
  T* ring = reinterpret_cast<T*>(smem_raw + L::h_bytes);  // [STAGES][STAGE]

  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nA = (K + KSA - 1) / KSA, nB = FC / KSB, per_chunk = nA + nB;
  const int nchunks = (F + FC - 1) / FC;
  const int total = nchunks * per_chunk;

  // the operand tile of step `step` into its stage of the ring
  auto issue = [&](int step) {
    T* dst = ring + (step % STAGES) * STAGE;
    const int j = step / per_chunk, r = step % per_chunk;
    if (r < nA) {  // x rows m0.., W_up rows of this CTA's slice; columns k0 .. k0+KSA-1
      constexpr int CPR = KSA / E;
      const int k0 = r * KSA;
      for (int idx = tid; idx < (BM + SW) * CPR; idx += THREADS) {
        const int row = idx / CPR, u = idx % CPR, col = k0 + u * E;
        const T* src;
        bool ok;
        if (row < BM) {
          ok = m0 + row < M && col < K;
          src = x + (ok ? (size_t)(m0 + row) * K + col : 0);
        } else {
          const int f = j * FC + c * SW + row - BM;
          ok = f < F && col < K;
          src = w_up + (ok ? (size_t)f * K + col : 0);
        }
        attn_mma::cp_async16(dst + row * LDA + u * E, src, ok);
      }
    } else {  // W_down rows of this CTA's outputs; chunk columns f0 .. f0+KSB-1
      constexpr int CPR = KSB / E;
      const int f0 = j * FC + (r - nA) * KSB;
      for (int idx = tid; idx < NC * CPR; idx += THREADS) {
        const int n = idx / CPR, u = idx % CPR, f = f0 + u * E;
        const bool ok = f < F;
        attn_mma::cp_async16(dst + n * LDB + u * E, w_down + (ok ? (size_t)(c * NC + n) * F + f : 0), ok);
      }
    }
  };

  // bf16: warps in a 4 x 2 grid, warp (wr, wc) owns rows 32wr .. 32wr+31 (two m16
  //   tiles; fragment rows g, g+8, columns 2t, 2t+1 of each n8 tile), slice
  //   columns 32wc .. +31 in phase A and output columns wc*NC/2 .. +NC/2-1 in B
  // f32, phase A: rows ra + 32i (i < 4), slice columns ca + 8jj (jj < 4);
  //      phase B: rows rb + 16i (i < 8), output columns cb + 16jj (jj < NC/16)
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;
  const int ra = warp * 4 + lane / 8, ca = lane % 8;
  const int rb = warp * 2 + lane / 16, cb = lane % 16;
  constexpr int NBH = NC / 16;               // bf16: n8 tiles of a warp's half of the outputs
  constexpr int A_ACC = BF16 ? 2 * 4 : 4;    // bf16: (m16, n8) tiles; f32: 4 x 4
  constexpr int B_ACC = BF16 ? 2 * NBH : 8;  // bf16: (m16, n8) tiles; f32: 8 x NC/16
  constexpr int B_IN = BF16 ? 4 : NC / 16;
  float accA[A_ACC][4];
  float accB[B_ACC][B_IN];
#pragma unroll
  for (int i = 0; i < B_ACC; ++i)
#pragma unroll
    for (int e = 0; e < B_IN; ++e) accB[i][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) issue(s);
    attn_mma::cp_async_commit();
  }
  cluster_arrive();  // this CTA runs, and its h buffer is free

  for (int step = 0; step < total; ++step) {
    attn_mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step's tile is in, and every thread is done with the stage refilled below
    if (step + STAGES - 1 < total) issue(step + STAGES - 1);
    attn_mma::cp_async_commit();
    const T* tile = ring + (step % STAGES) * STAGE;
    const int j = step / per_chunk, r = step % per_chunk;
    if (r < nA) {
      // ---- phase A: accA += x[:, k0:k0+KSA] . W_up[slice, k0:k0+KSA]^T
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < A_ACC; ++i) accA[i][0] = accA[i][1] = accA[i][2] = accA[i][3] = 0.f;
      }
      const T* xs = tile;
      const T* us = tile + BM * LDA;
      if constexpr (BF16) {
#pragma unroll
        for (int kc = 0; kc < KSA / 16; ++kc) {
          uint32_t a[2][4], b[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) attn_mma::load_a<LDA>(a[mi], xs + (32 * wr + 16 * mi) * LDA, kc, lane);
#pragma unroll
          for (int np = 0; np < 2; ++np) attn_mma::load_b_nk<LDA>(b[np], us, 32 * wc + 16 * np, kc, lane);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              attn_mma::mma16816(accA[mi * 4 + 2 * np], a[mi], b[np][0], b[np][1]);
              attn_mma::mma16816(accA[mi * 4 + 2 * np + 1], a[mi], b[np][2], b[np][3]);
            }
        }
      } else {
#pragma unroll
        for (int k4 = 0; k4 < KSA; k4 += 4) {
          float4 xv[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = *reinterpret_cast<const float4*>(xs + (ra + 32 * i) * LDA + k4);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) wv[jj] = *reinterpret_cast<const float4*>(us + (ca + 8 * jj) * LDA + k4);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              float a = accA[i][jj];
              a = fmaf(xv[i].x, wv[jj].x, a);
              a = fmaf(xv[i].y, wv[jj].y, a);
              a = fmaf(xv[i].z, wv[jj].z, a);
              accA[i][jj] = fmaf(xv[i].w, wv[jj].w, a);
            }
        }
      }
      if (r == nA - 1) {
        // h slice = gelu(accA + b_up), rounded, into slot c of this CTA's h buffer
        const int fs = j * FC + c * SW;  // first intermediate column of the slice
        if constexpr (BF16) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int col = 32 * wc + 8 * n + 2 * t, row = 32 * wr + 16 * mi + g + 8 * i;
                const float* acc = accA[mi * 4 + n];
                const float b0 = fs + col < F ? b_up[fs + col] : 0.f;
                const float b1 = fs + col + 1 < F ? b_up[fs + col + 1] : 0.f;
                *reinterpret_cast<__nv_bfloat162*>(hbuf + row * HLD + c * SW + col) = __floats2bfloat162_rn(
                    gelu(acc[2 * i] + b0, approx_gelu), gelu(acc[2 * i + 1] + b1, approx_gelu));
              }
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int col = ca + 8 * jj;
            const float bu = fs + col < F ? b_up[fs + col] : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) hbuf[(ra + 32 * i) * HLD + c * SW + col] = gelu(accA[i][jj] + bu, approx_gelu);
          }
        }
        __syncthreads();  // the slot is written
        cluster_wait();   // every peer is done reading its h buffer (the previous chunk's phase B)
        for (int idx = tid; idx < BM * 8; idx += THREADS) {
          const int row = idx / 8, u = idx % 8;
          uint4* src = reinterpret_cast<uint4*>(hbuf + row * HLD + c * SW) + u;
          const uint4 val = *src;
#pragma unroll
          for (int p = 1; p < CLUSTER; ++p) *cluster.map_shared_rank(src, (c + p) % CLUSTER) = val;
        }
        cluster_arrive();
        cluster_wait();  // every slice of the chunk is in every h buffer
      }
    } else {
      // ---- phase B: accB += h[:, f0:f0+KSB] . W_down[outputs, f0:f0+KSB]^T
      const T* wd = tile;
      const T* hk = hbuf + (r - nA) * KSB;
      if constexpr (BF16) {
#pragma unroll
        for (int kc = 0; kc < KSB / 16; ++kc) {
          uint32_t a[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) attn_mma::load_a<HLD>(a[mi], hk + (32 * wr + 16 * mi) * HLD, kc, lane);
          const int n0 = wc * (NC / 2);
#pragma unroll
          for (int np = 0; np < NBH / 2; ++np) {
            uint32_t b[4];
            attn_mma::load_b_nk<LDB>(b, wd, n0 + 16 * np, kc, lane);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              attn_mma::mma16816(accB[mi * NBH + 2 * np], a[mi], b[0], b[1]);
              attn_mma::mma16816(accB[mi * NBH + 2 * np + 1], a[mi], b[2], b[3]);
            }
          }
          if constexpr (NBH % 2 == 1) {  // N = 1920: the 15th n8 tile of the half
            uint32_t b0, b1;
            load_b_nk_x2<LDB>(b0, b1, wd, n0 + 8 * (NBH - 1), kc, lane);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) attn_mma::mma16816(accB[mi * NBH + NBH - 1], a[mi], b0, b1);
          }
        }
      } else {
#pragma unroll
        for (int k4 = 0; k4 < KSB; k4 += 4) {
          float4 hv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) hv[i] = *reinterpret_cast<const float4*>(hk + (rb + 16 * i) * HLD + k4);
#pragma unroll
          for (int jj = 0; jj < NC / 16; ++jj) {
            const float4 w = *reinterpret_cast<const float4*>(wd + (cb + 16 * jj) * LDB + k4);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              float a = accB[i][jj];
              a = fmaf(hv[i].x, w.x, a);
              a = fmaf(hv[i].y, w.y, a);
              a = fmaf(hv[i].z, w.z, a);
              accB[i][jj] = fmaf(hv[i].w, w.w, a);
            }
          }
        }
      }
      if (r == per_chunk - 1 && j + 1 < nchunks) cluster_arrive();  // done reading this chunk's h
    }
  }

  // out = accB + b_down, rounded once
  if constexpr (BF16) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = m0 + 32 * wr + 16 * mi + g + 8 * i;
        if (row >= M) continue;
#pragma unroll
        for (int n = 0; n < NBH; ++n) {
          const int col = c * NC + wc * (NC / 2) + 8 * n + 2 * t;
          const float* acc = accB[mi * NBH + n];
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(acc[2 * i] + b_down[col], acc[2 * i + 1] + b_down[col + 1]);
        }
      }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + rb + 16 * i;
      if (row >= M) continue;
#pragma unroll
      for (int jj = 0; jj < NC / 16; ++jj) {
        const int col = c * NC + cb + 16 * jj;
        out[(size_t)row * N + col] = accB[i][jj] + b_down[col];
      }
    }
  }
}

template <typename T, int NC>
int launch_n(const void* x, const void* w_up, const void* b_up, const void* w_down, const void* b_down,
             void* out, int M, int K, int F, int approx_gelu, void* stream) {
  constexpr size_t smem = Layout<T, NC>::bytes;
  auto kern = ffn_fused_kernel<T, NC>;
  static bool configured = false;  // the attribute is per kernel and per process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, (M + BM - 1) / BM, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, (const T*)x, (const T*)w_up, (const float*)b_up,
                                             (const T*)w_down, (const float*)b_down, (T*)out, M, K, F,
                                             approx_gelu);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w_up, const void* b_up, const void* w_down, const void* b_down, void* out,
           int M, int K, int F, int N, int approx_gelu, void* stream) {
  if (M < 1 || K < 8 || F < 8 || K % 8 != 0 || F % 8 != 0) return (int)cudaErrorInvalidValue;
  switch (N) {  // the zoo's widths: base, large, XL, XLS-R-2B
    case 768: return launch_n<T, 96>(x, w_up, b_up, w_down, b_down, out, M, K, F, approx_gelu, stream);
    case 1024: return launch_n<T, 128>(x, w_up, b_up, w_down, b_down, out, M, K, F, approx_gelu, stream);
    case 1280: return launch_n<T, 160>(x, w_up, b_up, w_down, b_down, out, M, K, F, approx_gelu, stream);
    case 1920: return launch_n<T, 240>(x, w_up, b_up, w_down, b_down, out, M, K, F, approx_gelu, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ser_ffn_fused_f32(const void* x, const void* w_up, const void* b_up,
                                 const void* w_down, const void* b_down, void* out, int M, int K,
                                 int F, int N, int approx_gelu, void* stream) {
  return launch<float>(x, w_up, b_up, w_down, b_down, out, M, K, F, N, approx_gelu, stream);
}

extern "C" int ser_ffn_fused_bf16(const void* x, const void* w_up, const void* b_up,
                                  const void* w_down, const void* b_down, void* out, int M, int K,
                                  int F, int N, int approx_gelu, void* stream) {
  return launch<bf16>(x, w_up, b_up, w_down, b_down, out, M, K, F, N, approx_gelu, stream);
}
