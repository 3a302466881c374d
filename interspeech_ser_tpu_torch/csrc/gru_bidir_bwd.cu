// K3b: masked bidirectional GRU recurrence, backward.
//
// Replaces interspeech_ser_tpu/ops/pallas/gru_kernel.py
// (_gru_bidir_bwd -> _bidir_bwd_kernel_impl -> _kernel_bidir_bwd), the
// custom-VJP backward of K3 on the fusion trainer's path.
//
// Layout as K3 (csrc/gru_bidir.cu): rows [0, half) are the forward
// direction, rows [half, 2*half) the backward direction, already reversed
// in time. Walking t = T-1 ... 0 with h_prev = h[t-1] (zero at t = 0) and
// dh the running cotangent of the carry:
//   hp = h_prev . w_hh[d] + b_hh[d];  r, z, n recomputed as in the forward
//   dht = g[t] + dh;  dh_new = m * dht;  dh_skip = (1 - m) * dht
//   dn = dh_new (1 - z)(1 - n^2);  dz = dh_new (h_prev - n) z (1 - z)
//   dr = dn * hn * r (1 - r)                      (hn = hp[2H:])
//   dx_proj[t] = [dr, dz, dn];  dhp = [dr, dz, dn * r]
//   dh = dh_skip + dh_new * z + dhp . w_hh[d]^T
//   dW_hh[d] += h_prev^T dhp;  db_hh[d] += dhp      (summed over rows and t)
// A padded step (m = 0) gives dx_proj = 0 and dhp = 0 and passes dht on.
//
// What bounds it on an H100: the serial chain of T steps, each a
// matrix-vector product per row against w_hh[d]^T (3 MB in f32 at H = 512).
// The TPU kernel kept w_hh in VMEM; here, as in K3, a thread-block CLUSTER
// holds it on chip for the whole sequence (H <= 512), in three launches:
//
// 1. gru_gemm_kernel<false>, the gate recompute hoisted out of the loop: hp
//    = h_prev . w_hh[d] + b_hh[d] for every row and step at once, a tiled
//    product on the FP32 pipes (128 x 128 output tiles, 8 x 8 a thread,
//    operands staged through shared memory and double-buffered in
//    registers). hp needs only the saved carries, never dh, so it leaves the
//    serial chain; it costs one [2B, T, 3H] scratch.
// 2. gru_bidir_bwd_cluster_kernel, the recurrence: a cluster of C =
//    ceil(H / 32) CTAs owns one direction and a group of R = 16 rows; CTA c
//    keeps the r, z and n columns of its U = 32 hidden units,
//    w_hh[d][:, {0,H,2H} + 32c .. +31] (192 KB at H = 512), on chip for all
//    T steps: columns 0..23 of the 96 in registers (96 floats a thread),
//    columns 24..95 in shared memory, depth-contiguous. Per step:
//      gates of its (row, unit) pairs from x_proj, hp, h_prev, g, m and the
//        pair's dh (the next step's inputs load while this one computes);
//        dx_proj and dhp to device memory, dhp into a tile [R][96];
//      if some row of the group is live at t (the same mask vote in every
//      warp of the cluster, as K3's): the transposed product's partial sums
//        p_c[row, i] = sum over its 96 columns k of dhp[row, k] w[i, k], for
//        all C U units i (thread = 4 consecutive units x 8 rows, columns in
//        a fixed order), sent as a REDUCE-SCATTER: the R x 4 block of units
//        4q.. goes by st.async into receive slot c of the CTA owning them,
//        counted by that CTA's mbarrier; then it waits for its C slots and
//        sums them in peer order 0 .. C-1: dh = dh_skip + dh_new z + sum.
//    No cluster barrier runs inside the loop. A CTA writes a peer's receive
//    buffer b only after receiving that peer's blocks of the step in
//    between, which the peer sent after it had read buffer b (the protocol
//    of K3). The wait traps after 2^24 polls: a fault is a launch error.
//    Shared memory a CTA: 4 (72 Kp + 2 R 96 + 2 C R U) + 16 bytes, Kp = C U:
//    225,296 at H = 512; 256 threads, 228 registers. The H100 holds 7 such
//    clusters of 16 at once (ser_gru_bwd_max_active_clusters), so 2B = 128
//    rows (8 clusters) take two waves. Each step is the same product as K3's
//    (2 R Kp 96 = 1.6 MFLOP a CTA on the FP32 pipes) plus the exchange:
//    chip_smoke.py reads about 7.4 us a step-wave, as K3's 7.1.
// 3. gru_gemm_kernel<true> (+ gru_dw_reduce_kernel), dW_hh and db_hh: the
//    product h_prev^T . dhp over all rows and steps of a direction, the same
//    tiled product with the row-step axis split into S chunks so that the
//    blocks fill whole waves of two an SM (gru.py: dw_splits; 96 tiles x 11
//    at H = 512), S partial sums added in order s = 0 .. S-1 by a second
//    small kernel. db rides the first row of tiles.
// Every sum runs in one fixed order and nothing uses atomics, so a rerun
// gives the same bits. Wider H (512 < H <= 4096) takes one block a row
// (gru_bidir_bwd_kernel, below): thread j owns hidden units j, j +
// blockDim, ..., recomputes the gates in the loop and rereads w_hh from L2
// at every step; its 6H floats of dynamic shared memory are opted in above
// 48 KB. The wrapper's launch planner (ops/kernels/gru.py:
// gru_bidir_bwd_plan) picks the route; the entry point checks the plan.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gru_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gru_cluster;

// -- the one-block-per-row route (H > 512) ------------------------------------

__global__ void gru_bidir_bwd_kernel(const float* __restrict__ g,       // [2B, T, H]
                                     const float* __restrict__ h,       // [2B, T, H]
                                     const float* __restrict__ x_proj,  // [2B, T, 3H]
                                     const float* __restrict__ mask,    // [2B, T]
                                     const float* __restrict__ w_hh2,   // [2, H, 3H]
                                     const float* __restrict__ b_hh2,   // [2, 3H]
                                     float* __restrict__ dxp,           // [2B, T, 3H]
                                     float* __restrict__ dhp_out,       // [2B, T, 3H]
                                     int half, int T, int H) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  float* hprev_s = smem;        // [H]  carry entering step t
  float* dh_s = hprev_s + H;    // [H]  running carry cotangent
  float* part_s = dh_s + H;     // [H]  dh_skip + dh_new * z
  float* dhp_s = part_s + H;    // [3H] gate cotangents for the transposed product
  const int row = blockIdx.x;
  const int dir = row < half ? 0 : 1;
  const float* w = w_hh2 + (size_t)dir * H * H3;
  const float* bh = b_hh2 + (size_t)dir * H3;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int j = threadIdx.x; j < H; j += blockDim.x) dh_s[j] = 0.f;

  for (int t = T - 1; t >= 0; --t) {
    const size_t rt = (size_t)row * T + t;
    for (int j = threadIdx.x; j < H; j += blockDim.x)
      hprev_s[j] = t > 0 ? h[(rt - 1) * H + j] : 0.f;
    __syncthreads();  // hprev_s ready; last step's dh_s, part_s, dhp_s reads done

    const float m = mask[rt];
    const float* xp = x_proj + rt * H3;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float ar = bh[j], az = bh[H + j], an = bh[2 * H + j];
#pragma unroll 4
      for (int i = 0; i < H; ++i) {
        const float hi = hprev_s[i];
        const float* wr = w + (size_t)i * H3;
        ar = fmaf(hi, wr[j], ar);
        az = fmaf(hi, wr[H + j], az);
        an = fmaf(hi, wr[2 * H + j], an);
      }
      const float r = sigmoidf_(xp[j] + ar);
      const float z = sigmoidf_(xp[H + j] + az);
      const float n = tanhf(xp[2 * H + j] + r * an);
      const float dht = g[rt * H + j] + dh_s[j];
      const float dh_new = dht * m;
      const float dh_skip = dht * (1.f - m);
      const float dn = dh_new * (1.f - z) * (1.f - n * n);
      const float dz = dh_new * (hprev_s[j] - n) * z * (1.f - z);
      const float dr = dn * an * r * (1.f - r);
      float* dx = dxp + rt * H3;
      float* dp = dhp_out + rt * H3;
      dx[j] = dr;
      dx[H + j] = dz;
      dx[2 * H + j] = dn;
      dp[j] = dr;
      dp[H + j] = dz;
      dp[2 * H + j] = dn * r;
      dhp_s[j] = dr;
      dhp_s[H + j] = dz;
      dhp_s[2 * H + j] = dn * r;
      part_s[j] = dh_skip + dh_new * z;
    }
    __syncthreads();  // dhp_s, part_s complete; every read of dh_s for step t done

    // dh = part + dhp . w^T: one warp per hidden unit i, lanes along w's row i
    for (int i = warp; i < H; i += n_warps) {
      const float* wi = w + (size_t)i * H3;
      float s = 0.f;
      for (int k = lane; k < H3; k += 32) s = fmaf(dhp_s[k], wi[k], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) dh_s[i] = part_s[i] + s;
    }
    // the barrier at the top of the next step orders these dh_s writes
  }
}

// -- the tiled products: the gate recompute and dW ---------------------------
//
// Row-step n of direction d is row d*half + n / T at step n % T; its carry
// entering the step is h_prev(n) = h[row, t-1] (zero at t = 0).
//   gates (DW = false): hp[n, :] = h_prev(n) . w_hh[d] + b_hh[d]
//                       (M = half T, N = 3H, depth H)
//   dW    (DW = true):  dw[s][d] = sum over split s's row-steps n of
//                       h_prev(n)^T dhp[n]  (M = H, N = 3H, depth: the
//                       row-steps n in [s k_chunk, (s+1) k_chunk))
// Block (x, y, z): output tile rows 128 y.., columns 128 x..; z = 2 s + d.
// Thread (tx, ty) = (tid % 16, tid / 16) owns rows 4 ty + {0..3} and 64 +
// 4 ty + {0..3}, columns 4 tx + {0..3} and 64 + 4 tx + {0..3}. Depth steps
// of 8: each thread loads 4 elements of A's tile and 4 of B's into
// registers while the block computes on the other shared-memory buffer.
constexpr int GT = 128;       // output tile
constexpr int GK = 8;         // depth a stage
constexpr int GLD = GT + 4;   // padded shared row: conflict-free transposed stores

template <bool DW>
__global__ void __launch_bounds__(256) gru_gemm_kernel(
    const float* __restrict__ h,     // [2B, T, H] the forward's carries
    const float* __restrict__ rhs,   // gates: w_hh2 [2, H, 3H]; dW: dhp [2B, T, 3H]
    const float* __restrict__ bias,  // gates: b_hh2 [2, 3H]; dW: unused
    float* __restrict__ out,         // gates: hp [2B, T, 3H]; dW: dw_part [S, 2, H, 3H]
    float* __restrict__ db_part,     // dW: [S, 2, 3H]; gates: unused
    int half, int T, int H, int k_chunk) {
  __shared__ __align__(16) float As[2][GK][GLD];
  __shared__ __align__(16) float Bs[2][GK][GLD];
  const int H3 = 3 * H;
  const int d = blockIdx.z & 1, s = blockIdx.z >> 1;
  const int M = DW ? H : half * T;
  const int N = H3;
  const int m0 = blockIdx.y * GT, n0 = blockIdx.x * GT;
  const int K = DW ? half * T : H;
  const int kb = DW ? s * k_chunk : 0;
  const int ke = DW ? min(K, kb + k_chunk) : K;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* w = rhs + (size_t)d * H * H3;  // gates only

  // rows of H and 3H floats start on 16 bytes when H % 4 == 0 (and the
  // tensors do): then 4 consecutive elements load as one float4
  const bool vec = (H & 3) == 0 && (reinterpret_cast<uintptr_t>(h) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(rhs) & 15) == 0;
  // elements p[0 .. 3], those from `valid` on as 0
  auto load4 = [&](const float* p, int valid, float (&v)[4]) {
    if (vec && valid >= 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = e < valid ? p[e] : 0.f;
    }
  };
  // row-step n of direction d as (row, t); its carry h_prev is h[row, t-1]
  // (none at t = 0)
  const int kk = tid >> 5, c4 = (tid & 31) * 4;
  // gates: this thread's row-step m0 + tid / 2 for every stage; dW: the
  // row-step kb + kk of the first stage, advanced 8 a stage
  int n = DW ? kb + kk : m0 + (tid >> 1);
  int nr = n / T, nt = n % T;
  // this thread's share of depth stage k0: A(m, k) and B(k, n) elements
  float ar[4], br[4];
  auto load = [&](int k0) {
    const size_t rt = ((size_t)d * half + nr) * T + nt;  // row-step n's (row, t) in [2B, T]
    if (DW) {  // A(i, n) = h_prev(n, i) and B(n, j) = dhp[n, j]: stage row n = k0 + kk
      const bool live = n < ke;
      load4(h + (live && nt > 0 ? (rt - 1) * H : 0) + m0 + c4, live && nt > 0 ? H - (m0 + c4) : 0, ar);
      load4(rhs + (live ? rt * H3 : 0) + n0 + c4, live ? N - (n0 + c4) : 0, br);
      n += GK;  // the next stage's row-step
      nt += GK;
      while (nt >= T) nt -= T, ++nr;
    } else {  // A(n, k) = h_prev(n, k): 4 consecutive k of row-step n; B(k, j) = w[k, j]
      const int kq = (tid & 1) * 4;
      const bool live = n < M && nt > 0;
      load4(h + (live ? (rt - 1) * H : 0) + k0 + kq, live ? K - (k0 + kq) : 0, ar);
      const int k = k0 + kk;
      load4(w + (size_t)(k < K ? k : 0) * H3 + n0 + c4, k < K ? N - (n0 + c4) : 0, br);
    }
  };
  auto store = [&](int buf) {
    if (DW) {
#pragma unroll
      for (int e = 0; e < 4; ++e) As[buf][kk][c4 + e] = ar[e];
    } else {
      const int mm = tid >> 1, kq = (tid & 1) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) As[buf][kq + e][mm] = ar[e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) Bs[buf][kk][c4 + e] = br[e];
  };

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  float dbs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // dW: column sums of dhp (db), row of tiles 0, ty 0
  const bool do_db = DW && blockIdx.y == 0 && ty == 0;

  const int stages = ke > kb ? (ke - kb + GK - 1) / GK : 0;
  if (stages > 0) {
    load(kb);
    store(0);
  }
  __syncthreads();
  for (int st = 0; st < stages; ++st) {
    const int buf = st & 1;
    if (st + 1 < stages) load(kb + (st + 1) * GK);
#pragma unroll
    for (int q = 0; q < GK; ++q) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][q][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][q][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][q][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][q][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
      if (do_db) {
#pragma unroll
        for (int b = 0; b < 8; ++b) dbs[b] += bv[b];
      }
    }
    if (st + 1 < stages) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int m = m0 + (a < 4 ? 4 * ty + a : 64 + 4 * ty + a - 4);
    if (m >= M) continue;
    float* o;
    const float* bb = nullptr;
    if (DW) {
      o = out + (((size_t)s * 2 + d) * H + m) * H3;
    } else {
      const size_t row = (size_t)d * half + m / T;
      o = out + (row * T + m % T) * H3;
      bb = bias + (size_t)d * H3;
    }
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = n0 + (b < 4 ? 4 * tx + b : 64 + 4 * tx + b - 4);
      if (j < N) o[j] = DW ? acc[a][b] : acc[a][b] + bb[j];
    }
  }
  if (do_db) {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = n0 + (b < 4 ? 4 * tx + b : 64 + 4 * tx + b - 4);
      if (j < N) db_part[((size_t)s * 2 + d) * H3 + j] = dbs[b];
    }
  }
}

// dw = sum of the S partial products in order s = 0 .. S-1; db likewise
__global__ void gru_dw_reduce_kernel(const float* __restrict__ dw_part, const float* __restrict__ db_part,
                                     float* __restrict__ dw, float* __restrict__ db, int S, int H) {
  const size_t nw = (size_t)2 * H * 3 * H, nb = (size_t)2 * 3 * H;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nw + nb; i += (size_t)gridDim.x * blockDim.x) {
    const bool is_w = i < nw;
    const float* src = is_w ? dw_part + i : db_part + (i - nw);
    const size_t stride = is_w ? nw : nb;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += src[s * stride];
    (is_w ? dw[i] : db[i - nw]) = acc;
  }
}

// -- the cluster route (H <= 512): the recurrence ---------------------------
//
// Block (c, group, d) of a (C, groups, 2) grid, clusters of (C, 1, 1).

constexpr int BW_U = 32;         // hidden units a CTA owns (its w_hh columns: 3 x 32)
constexpr int BW_R = 16;         // rows a cluster carries
constexpr int BW_COLS = 3 * BW_U;  // w_hh columns a CTA holds
constexpr int BW_THREADS = 256;  // 8 warps
constexpr int BW_MAX = 16;       // CTAs a cluster at most (non-portable above 8)
constexpr int BW_REGC = 24;      // of those columns, held in registers (4 depths each: 96 floats a thread)

// shared memory of one CTA at cluster size C: columns 24..95 of its w_hh
// slice [72][Kp], two dhp tiles [2][R][96], two receive buffers [2][C][R][U]
// (f32, Kp = C U), then the receive buffers' mbarriers
__host__ __device__ constexpr size_t bwd_cluster_smem_bytes(int C) {
  return sizeof(float) * ((size_t)(BW_COLS - BW_REGC) * C * BW_U + (size_t)2 * BW_R * BW_COLS +
                          (size_t)2 * C * BW_R * BW_U) +
         2 * sizeof(unsigned long long);
}

__global__ void __launch_bounds__(BW_THREADS, 1) gru_bidir_bwd_cluster_kernel(
    const float* __restrict__ g,       // [2B, T, H]
    const float* __restrict__ h,       // [2B, T, H]
    const float* __restrict__ x_proj,  // [2B, T, 3H]
    const float* __restrict__ hp,      // [2B, T, 3H] h_prev . w_hh + b_hh (gru_gemm_kernel<false>)
    const float* __restrict__ mask,    // [2B, T]
    const float* __restrict__ w_hh2,   // [2, H, 3H]
    float* __restrict__ dxp,           // [2B, T, 3H]
    float* __restrict__ dhp_out,       // [2B, T, 3H]
    int half, int T, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int grp = blockIdx.y, d = blockIdx.z;
  const int Kp = C * BW_U;  // the cluster's units, H rounded up (zero rows of w_hh past H)
  const int KQ = Kp / 4;    // quads of 4 units
  const int H3 = 3 * H;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                          // [72][Kp]: column 24 + j, depth-contiguous
  float* dts = ws + (size_t)(BW_COLS - BW_REGC) * Kp;        // [2][R][96]: dhp of this CTA's columns
  float* rcv = dts + 2 * BW_R * BW_COLS;                     // [2][C][R][U]: partial sums of its units, by sender
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(rcv + (size_t)2 * C * BW_R * BW_U);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // product role: units 4 tq .. 4 tq + 3 of the cluster, rows 8 rh .. 8 rh + 7
  const int tq = tid & 127, rh = tid >> 7;
  const bool has_quad = tq < KQ;
  // gate role: unit u = lane of this CTA, rows 2 warp and 2 warp + 1 of the group
  const int u = lane, unit = c * BW_U + u;
  const bool unit_ok = unit < H;

  // w_hh[d]'s columns of this CTA's units, once for the whole sequence;
  // column col is w[:, (col / U) H + c U + col % U]
  const float* w = w_hh2 + (size_t)d * H * H3;
  auto wcol = [&](int k, int col) -> float {
    const int un = c * BW_U + col % BW_U;
    return (k < H && un < H) ? w[(size_t)k * H3 + (col / BW_U) * H + un] : 0.f;
  };
  float4 wreg[BW_REGC];  // depths 4 tq .. 4 tq + 3 of columns 0..23
#pragma unroll
  for (int j = 0; j < BW_REGC; ++j) {
    const int k = 4 * tq;
    wreg[j] = has_quad ? make_float4(wcol(k, j), wcol(k + 1, j), wcol(k + 2, j), wcol(k + 3, j))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int idx = tid; idx < (BW_COLS - BW_REGC) * Kp; idx += BW_THREADS)
    ws[idx] = wcol(idx % Kp, BW_REGC + idx / Kp);
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) mbar_init(smem_addr(mbar + b), 1);
    fence_mbarrier_init();
  }

  int grow[2];
  bool ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rd = grp * BW_R + 2 * warp + i;  // row within the direction
    ok[i] = rd < half && unit_ok;
    grow[i] = d * half + (rd < half ? rd : 0);
  }
  // lane l (mod 16) reads row l's mask: the warp's vote says whether any row is live
  const int rf = grp * BW_R + (lane & 15);
  const bool flag_ok = rf < half;
  const int frow = d * half + (flag_ok ? rf : 0);

  struct Step {
    float x[2][3], p[2][3], hprev[2], g[2], m[2], flag;
  };
  auto load_step = [&](int t, Step& st) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t rt = (size_t)grow[i] * T + t;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        st.x[i][q] = ok[i] ? x_proj[rt * H3 + q * H + unit] : 0.f;
        st.p[i][q] = ok[i] ? hp[rt * H3 + q * H + unit] : 0.f;
      }
      st.hprev[i] = ok[i] && t > 0 ? h[(rt - 1) * H + unit] : 0.f;
      st.g[i] = ok[i] ? g[rt * H + unit] : 0.f;
      st.m[i] = ok[i] ? mask[rt] : 0.f;
    }
    st.flag = flag_ok ? mask[(size_t)frow * T + t] : 0.f;
  };
  Step cur_in;
  if (T > 0) load_step(T - 1, cur_in);
  float dh[2] = {0.f, 0.f};  // the carry cotangents of this thread's (row, unit) pairs

  cluster_arrive();  // every CTA's slice and mbarriers are in place
  cluster_wait();

  const float4* ws4 = reinterpret_cast<const float4*>(ws);  // column 24 + j, quad q: ws4[j KQ + q]
  int cur = 0;                    // the dhp tile and receive buffer of this step
  uint32_t parity[2] = {0u, 0u};  // the phase of each receive buffer's mbarrier this CTA waits for next
  for (int t = T - 1; t >= 0; --t) {
    Step nxt_in{};
    if (t > 0) load_step(t - 1, nxt_in);
    // the same vote in every warp of every CTA of the cluster: all skip the product, or none
    const bool live = __any_sync(0xffffffffu, cur_in.flag != 0.f);
    float dpv[2][3], part[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float r = sigmoidf_(cur_in.x[i][0] + cur_in.p[i][0]);
      const float z = sigmoidf_(cur_in.x[i][1] + cur_in.p[i][1]);
      const float hn = cur_in.p[i][2];
      const float n = tanhf(cur_in.x[i][2] + r * hn);
      const float m = cur_in.m[i];
      const float dht = cur_in.g[i] + dh[i];
      const float dh_new = dht * m;
      const float dh_skip = dht * (1.f - m);
      const float dn = dh_new * (1.f - z) * (1.f - n * n);
      const float dz = dh_new * (cur_in.hprev[i] - n) * z * (1.f - z);
      const float dr = dn * hn * r * (1.f - r);
      part[i] = dh_skip + dh_new * z;
      dpv[i][0] = ok[i] ? dr : 0.f;
      dpv[i][1] = ok[i] ? dz : 0.f;
      dpv[i][2] = ok[i] ? dn * r : 0.f;
      if (ok[i]) {
        const size_t o = ((size_t)grow[i] * T + t) * H3 + unit;
        dxp[o] = dr;
        dxp[o + H] = dz;
        dxp[o + 2 * H] = dn;
        dhp_out[o] = dpv[i][0];
        dhp_out[o + H] = dpv[i][1];
        dhp_out[o + 2 * H] = dpv[i][2];
      }
    }
    if (live) {
      float* dt = dts + cur * BW_R * BW_COLS;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 3; ++q) dt[(2 * warp + i) * BW_COLS + q * BW_U + u] = dpv[i][q];
      __syncthreads();  // the dhp tile is written
      const uint32_t mb = smem_addr(mbar + cur);
      if (tid == 0) mbar_arrive_expect_tx(mb, C * BW_R * BW_U * 4);
      if (has_quad) {
        // p[row, 4 tq + e] = sum over columns col = 0 .. 95 of dhp[row, col] w[4 tq + e, col]
        float acc[8][4];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
        const float4* d4 = reinterpret_cast<const float4*>(dt + rh * 8 * BW_COLS);  // row r: + r * 24
        auto quad = [&](const float4 (&wv)[4], int cq) {  // columns 4 cq .. 4 cq + 3
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float4 dv = d4[r * (BW_COLS / 4) + cq];
            const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[r][0] = fmaf(dd[j], wv[j].x, acc[r][0]);
              acc[r][1] = fmaf(dd[j], wv[j].y, acc[r][1]);
              acc[r][2] = fmaf(dd[j], wv[j].z, acc[r][2]);
              acc[r][3] = fmaf(dd[j], wv[j].w, acc[r][3]);
            }
          }
        };
#pragma unroll
        for (int cq = 0; cq < BW_REGC / 4; ++cq) {
          const float4 wv[4] = {wreg[4 * cq], wreg[4 * cq + 1], wreg[4 * cq + 2], wreg[4 * cq + 3]};
          quad(wv, cq);
        }
#pragma unroll 2
        for (int cq = BW_REGC / 4; cq < BW_COLS / 4; ++cq) {
          const int j = 4 * cq - BW_REGC;
          const float4 wv[4] = {ws4[(size_t)j * KQ + tq], ws4[(size_t)(j + 1) * KQ + tq],
                                ws4[(size_t)(j + 2) * KQ + tq], ws4[(size_t)(j + 3) * KQ + tq]};
          quad(wv, cq);
        }
        // units 4 tq .. belong to CTA tq / 8 (its units 4 (tq % 8) ..): into its slot c
        const int peer = tq >> 3, u0 = (tq & 7) * 4;
        const uint32_t slot = smem_addr(rcv + ((size_t)cur * C + c) * BW_R * BW_U);
        const uint32_t pmb = peer_addr(mb, peer);
#pragma unroll
        for (int r = 0; r < 8; ++r)
          st_async16(peer_addr(slot + (uint32_t)(((rh * 8 + r) * BW_U + u0) * sizeof(float)), peer),
                     make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]), pmb);
      }
      mbar_wait(mb, parity[cur]);  // every CTA's partial sums for this CTA's units are here
      parity[cur] ^= 1u;
      const float* rb = rcv + (size_t)cur * C * BW_R * BW_U;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float back = 0.f;
        for (int p = 0; p < C; ++p) back += rb[((size_t)p * BW_R + 2 * warp + i) * BW_U + u];
        dh[i] = part[i] + back;
      }
      cur ^= 1;
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) dh[i] = part[i];
    }
    cur_in = nxt_in;
  }
  cluster_arrive();  // no CTA leaves while a peer may still write into its shared memory
  cluster_wait();
}

// The cluster kernel's attributes, set once a process: dynamic shared memory
// up to the largest cluster's need, and clusters of more than 8 CTAs; and
// the row kernel's dynamic shared memory up to 6H floats at H = 4096.
cudaError_t set_attributes() {
  static cudaError_t status = [] {
    cudaError_t err = cudaFuncSetAttribute(gru_bidir_bwd_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bwd_cluster_smem_bytes(BW_MAX));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gru_bidir_bwd_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gru_bidir_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 6 * 4096 * (int)sizeof(float));
    return err;
  }();
  return status;
}

cudaLaunchConfig_t cluster_config(int C, int groups, cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, groups, 2);
  cfg.blockDim = dim3(BW_THREADS, 1, 1);
  cfg.dynamicSmemBytes = bwd_cluster_smem_bytes(C);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// K3b's first launch on the cluster route: the gate pre-activations
// hp = h_prev . w_hh[d] + b_hh[d] for every row and step.
extern "C" int ser_gru_bwd_gates_f32(const void* h, const void* w_hh2, const void* b_hh2, void* hp, int B2,
                                     int T, int H, void* stream) {
  if (B2 % 2 != 0 || B2 < 2 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const int M = B2 / 2 * T;
  dim3 grid((3 * H + GT - 1) / GT, (M + GT - 1) / GT, 2);
  gru_gemm_kernel<false><<<grid, 256, 0, (cudaStream_t)stream>>>((const float*)h, (const float*)w_hh2,
                                                                  (const float*)b_hh2, (float*)hp, nullptr, B2 / 2,
                                                                  T, H, 0);
  return (int)cudaGetLastError();
}

// K3b's recurrence: the cluster route (`cluster` = ceil(H / 32) CTAs, hp
// from ser_gru_bwd_gates_f32) or one block of `threads` a row (cluster = 0;
// hp unused). Writes dx_proj and the gate cotangents dhp.
extern "C" int ser_gru_bidir_bwd_f32(const void* g, const void* h, const void* x_proj, const void* mask,
                                     const void* w_hh2, const void* b_hh2, const void* hp, void* dxp, void* dhp,
                                     int B2, int T, int H, int cluster, int threads, void* stream) {
  if (B2 % 2 != 0 || B2 < 2 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t aerr = set_attributes();
  if (aerr != cudaSuccess) return (int)aerr;
  const int half = B2 / 2;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster == 0) {
    if (threads < 32 || threads > 1024 || threads % 32 != 0 || H > 4 * threads || H > 4096)
      return (int)cudaErrorInvalidValue;
    gru_bidir_bwd_kernel<<<B2, threads, 6 * H * sizeof(float), s>>>(
        (const float*)g, (const float*)h, (const float*)x_proj, (const float*)mask, (const float*)w_hh2,
        (const float*)b_hh2, (float*)dxp, (float*)dhp, half, T, H);
    return (int)cudaGetLastError();
  }
  if (cluster != (H + BW_U - 1) / BW_U || cluster > BW_MAX || hp == nullptr) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(cluster, (half + BW_R - 1) / BW_R, attr, s);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gru_bidir_bwd_cluster_kernel, (const float*)g, (const float*)h,
                                             (const float*)x_proj, (const float*)hp, (const float*)mask,
                                             (const float*)w_hh2, (float*)dxp, (float*)dhp, half, T, H);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// K3b's last launch(es): dW_hh2 and db_hh2 from the carries and dhp, the
// row-steps split into `splits` chunks (partial sums in dw_part [S, 2, H,
// 3H] and db_part [S, 2, 3H], then added in order); with splits = 1 the
// product writes dw and db directly (the part pointers unused).
extern "C" int ser_gru_bwd_dw_f32(const void* h, const void* dhp, void* dw_part, void* db_part, void* dw, void* db,
                                  int B2, int T, int H, int splits, void* stream) {
  if (B2 % 2 != 0 || B2 < 2 || T < 1 || H < 1 || splits < 1 || splits > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int K = B2 / 2 * T;
  const int chunk = ((K + splits - 1) / splits + GK - 1) / GK * GK;
  float* wp = (float*)(splits > 1 ? dw_part : dw);
  float* bp = (float*)(splits > 1 ? db_part : db);
  if (wp == nullptr || bp == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid((3 * H + GT - 1) / GT, (H + GT - 1) / GT, 2 * splits);
  gru_gemm_kernel<true><<<grid, 256, 0, s>>>((const float*)h, (const float*)dhp, nullptr, wp, bp, B2 / 2, T, H,
                                             chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  gru_dw_reduce_kernel<<<1024, 256, 0, s>>>(wp, bp, (float*)dw, (float*)db, splits, H);
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` CTAs of K3b's cluster route the card runs at
// once (cudaOccupancyMaxActiveClusters), into *n.
extern "C" int ser_gru_bwd_max_active_clusters(int cluster, int* n) {
  if (cluster < 1 || cluster > BW_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t err = set_attributes();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(cluster, 64, attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(n, gru_bidir_bwd_cluster_kernel, &cfg);
}
