// K3: masked bidirectional GRU recurrence, forward.
//
// Replaces interspeech_ser_tpu/ops/pallas/gru_kernel.py
// (gru_bidir_carries -> _bidir_carries_impl -> _kernel_bidir), the
// fusion classifier's BiGRU at eval and in training (K3b is its backward).
//
// Rows [0, half) are the forward direction, rows [half, 2*half) the
// backward direction with their inputs already reversed in time. Per step,
// with torch's gate order and b_hn inside the reset product:
//   hp = h . w_hh[d] + b_hh[d]                 (w_hh[d]: [H, 3H], row-major)
//   r = sigmoid(xr + hr); z = sigmoid(xz + hz); n = tanh(xn + r * hn)
//   h_new = (1 - z) * n + z * h;  h = m * h_new + (1 - m) * h  (frozen when m = 0)
// and the kernel writes the unmasked carry h for every step; the wrapper
// multiplies by the mask, as the TPU kernel's wrapper does. All in f32.
//
// The TPU kernel kept w_hh resident in VMEM for the whole sequence. An SM
// holds at most 227 KB of shared memory, and w_hh[d] is 3 MB at H = 512,
// so here a thread-block CLUSTER holds it (gru_bidir_cluster_kernel, H <=
// 512): a cluster of C = ceil(H / 32) CTAs owns one direction and a group of
// R = 16 rows, and CTA c keeps the r, z and n columns of its U = 32 hidden
// units, w_hh[d][:, {0,H,2H} + 32c .. +31] (192 KB in f32 at H = 512; C = 16
// there, a non-portable cluster size), on chip for all T steps: depth rows
// 0..127 in registers (96 floats a thread, from C = 4 up), the rest in
// shared memory. Loop structure, per CTA:
//   load its w_hh slice once (global -> registers + shared);       <- once
//   for t in 0 .. T-1:
//     if no row of the group is live at t (mask exactly 0): carries stay;
//     else:
//       partial dot products of the R carries (h buffer cur, [R][Kp]) with
//         the slice, 4 lanes a unit splitting the depth, then a
//         reduce-scatter of the 4 partials by shuffles;
//       gates for (row, unit) pairs; new carries into a staging tile;
//       the staging tile into h buffer cur^1 of EVERY CTA of the cluster
//         by st.async (16-byte asynchronous stores into distributed shared
//         memory, each counted by the receiver's mbarrier on arrival);
//       store this step's carries; wait on this CTA's mbarrier of buffer
//         cur^1 until all C parts have landed; cur ^= 1.
// So each element of w_hh is read from L2 once per launch for each cluster
// that holds it (8 clusters at 2B = 128 rows), never once per step. No
// cluster barrier runs inside the loop: a CTA writes buffer cur^1 of a peer
// only after receiving that peer's previous carries, which the peer sent
// after it stopped reading that buffer. The next step's x_proj and mask
// values load into registers while a step computes. Shared memory a CTA:
// 4 (3 U (Kp - 128) + 2 R Kp + 2 R U) + 16 bytes, Kp = C U: 217,104 at
// H = 512. 256 threads: 8 warps = 4 unit groups x 2 row halves of 8 rows;
// lanes = 8 units x 4 depth quarters; w_hh quads are XOR-swizzled by column
// so the 8 lanes of a 128-bit shared load hit 8 bank groups. 240 registers.
//
// What bounds it on an H100: the serial chain of T steps, each 2 R Kp 3U =
// 1.6 MFLOP a CTA at H = 512 on the FP32 pipes (3.4 us at one SM's 128 FFMA
// a clock at 1.8 GHz) plus the exchange; chip_smoke.py reads about 7 us a
// step. cudaOccupancyMaxActiveClusters (ser_gru_max_active_clusters) says
// the H100 holds 7 clusters of 16 such CTAs at once, so the fusion batch's
// 8 clusters (2B = 128) take two waves, and 2B <= 112 takes one. TF32 tensor
// cores would cut the products but not keep f32. Wider H (512 < H <= 4096)
// keeps the one-block-per-row kernel (gru_bidir_kernel): thread j owns
// hidden units j, j+blockDim, ... and every block rereads its direction's
// w_hh from L2 at every step. The wrapper's launch planner (ops/kernels/
// gru.py: gru_bidir_plan) picks the route; the entry point checks the plan.
//
// K9: one direction of the same masked GRU, with a `reverse` flag.
//
// Replaces interspeech_ser_tpu/ops/pallas/gru_kernel.py (gru_sequence ->
// _kernel). Rows are independent sequences; with reverse = 1 the step
// order runs from T-1 down to 0, which is the TPU kernel's flip of the
// inputs, forward run and flip of the outputs in one pass, indexing x_proj,
// mask and out in place. The kernel writes h * m for every step (0 at a
// masked step, where the carry is frozen), as the TPU kernel does. For H <=
// 512 it is the cluster kernel above with SEQ = true (one direction: a grid
// of depth 1, w_hh on chip for the whole sequence; B = 64 rows are 4
// clusters, one wave); wider H takes the one-block-per-row
// gru_sequence_kernel, bound by its L2 rereads of w_hh at every step. The
// planner (gru.py: gru_sequence_plan) picks the route.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gru_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gru_cluster;

__global__ void gru_bidir_kernel(const float* __restrict__ x_proj,  // [2B, T, 3H]
                                 const float* __restrict__ w_hh2,   // [2, H, 3H]
                                 const float* __restrict__ b_hh2,   // [2, 3H]
                                 const float* __restrict__ mask,    // [2B, T]
                                 float* __restrict__ out,           // [2B, T, H]
                                 int half, int T, int H) {
  extern __shared__ float h_s[];  // [H]
  const int row = blockIdx.x;
  const int dir = row < half ? 0 : 1;
  const int H3 = 3 * H;
  const float* w = w_hh2 + (size_t)dir * H * H3;
  const float* bh = b_hh2 + (size_t)dir * H3;
  for (int j = threadIdx.x; j < H; j += blockDim.x) h_s[j] = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float m = mask[(size_t)row * T + t];
    const float* xp = x_proj + ((size_t)row * T + t) * H3;
    float* o = out + ((size_t)row * T + t) * H;
    // at most 4 hidden units per thread (H <= 4 * blockDim, checked by the wrapper)
    float h_next[4];
    int n_own = 0;
    for (int j = threadIdx.x; j < H; j += blockDim.x, ++n_own) {
      float ar = bh[j], az = bh[H + j], an = bh[2 * H + j];
#pragma unroll 4
      for (int i = 0; i < H; ++i) {
        const float hi = h_s[i];
        const float* wr = w + (size_t)i * H3;
        ar = fmaf(hi, wr[j], ar);
        az = fmaf(hi, wr[H + j], az);
        an = fmaf(hi, wr[2 * H + j], an);
      }
      const float r = sigmoidf_(xp[j] + ar);
      const float z = sigmoidf_(xp[H + j] + az);
      const float n = tanhf(xp[2 * H + j] + r * an);
      const float hp = h_s[j];
      const float hn = (1.f - z) * n + z * hp;
      h_next[n_own] = m * hn + (1.f - m) * hp;
    }
    __syncthreads();  // every thread has read h_s for this step
    n_own = 0;
    for (int j = threadIdx.x; j < H; j += blockDim.x, ++n_own) {
      h_s[j] = h_next[n_own];
      o[j] = h_next[n_own];
    }
    __syncthreads();
  }
}


// ---------------------------------------------------------------------------
// The cluster route. Block (c, group, d) of a (C, groups, 2) grid, clusters
// of (C, 1, 1): CTA c of the cluster for direction d and rows
// group*R .. group*R+R-1 of that direction.

constexpr int CL_U = 32;         // hidden units a CTA holds (its w_hh columns: 3 x 32)
constexpr int CL_R = 16;         // rows a cluster carries
constexpr int CL_THREADS = 256;  // 8 warps
constexpr int CL_MAX = 16;       // CTAs a cluster at most (non-portable above 8)
constexpr int CL_REGJ = 8;       // depth steps (16 of the depth each) whose w_hh stays in registers, C >= 4

// depth steps in registers at cluster size C: 8 (the first 128 of the depth,
// 96 floats a thread) from C = 4 up, else none
__host__ __device__ constexpr int cluster_regj(int C) { return C >= 4 ? CL_REGJ : 0; }

// shared memory of one CTA at cluster size C: the part of the w_hh slice
// not in registers [3U][Kp - 16 regj], two h buffers [2][R][Kp] and two
// staging tiles [2][R][U], f32 (Kp = C U), then the two h buffers' mbarriers
__host__ __device__ constexpr size_t cluster_smem_bytes(int C) {
  return sizeof(float) * ((size_t)3 * CL_U * (C * CL_U - 16 * cluster_regj(C)) + (size_t)2 * CL_R * C * CL_U +
                          (size_t)2 * CL_R * CL_U) +
         2 * sizeof(unsigned long long);
}

// SEQ: K9, one direction (a grid of depth 1; half = B rows), step s at time
// T-1-s when `reverse`, and h * m written out; otherwise K3 (reverse unused).
template <int REGJ, bool SEQ>
__global__ void __launch_bounds__(CL_THREADS, 1) gru_bidir_cluster_kernel(
    const float* __restrict__ x_proj,  // [2B, T, 3H]  (K9: [B, T, 3H])
    const float* __restrict__ w_hh2,   // [2, H, 3H]   (K9: [H, 3H])
    const float* __restrict__ b_hh2,   // [2, 3H]      (K9: [3H])
    const float* __restrict__ mask,    // [2B, T]      (K9: [B, T])
    float* __restrict__ out,           // [2B, T, H]   (K9: [B, T, H])
    int half, int T, int H, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int grp = blockIdx.y, d = blockIdx.z;
  const int Kp = C * CL_U;        // the depth, H rounded up to the cluster's units (zero rows past H)
  const int KQ = Kp / 4;          // 16-byte quads a row
  const int SQ = KQ - 4 * REGJ;   // quads a w_hh column keeps in shared memory (the rest are in registers)
  const int H3 = 3 * H;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                        // [3U][4 SQ]: column col = gate * U + u, quads swizzled
  float* hs = ws + (size_t)3 * CL_U * 4 * SQ;  // [2][R][Kp]: the group's carries, every unit of the cluster
  float* stg = hs + (size_t)2 * CL_R * Kp;  // [2][R][U]: this CTA's new carries, before the copy to peers
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(stg + 2 * CL_R * CL_U);  // [2]: h buffer full

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ul = lane & 7, kq = lane >> 3;  // unit within the warp's 8; depth quarter (quads kq, kq + 4, ...)
  const int u = (warp & 3) * 8 + ul;        // this thread's unit within the CTA
  const int rh = warp >> 2;                 // row half: rows rh*8 .. rh*8+7 of the group
  const int unit = c * CL_U + u;            // its hidden unit
  const bool unit_ok = unit < H;

  // w_hh[d]'s columns of this CTA's units, once for the whole sequence: this
  // thread's quads 4j + kq (j < REGJ) of its unit's three columns into
  // registers, quads from 4 REGJ on into shared memory, quad q of column col
  // at quad (q - 4 REGJ) ^ (col & 7) of its row
  const float* w = w_hh2 + (size_t)d * H * H3;
  float4 wreg[3][REGJ > 0 ? REGJ : 1];
#pragma unroll
  for (int j = 0; j < REGJ; ++j) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * (4 * j + kq) + i;
        e[i] = (k < H && unit_ok) ? w[(size_t)k * H3 + g * H + unit] : 0.f;
      }
      wreg[g][j] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
  for (int idx = tid; idx < 4 * SQ * 3 * CL_U; idx += CL_THREADS) {
    const int ks = idx / (3 * CL_U), col = idx % (3 * CL_U);
    const int k = 16 * REGJ + ks;
    const int un = c * CL_U + col % CL_U;
    const float val = (k < H && un < H) ? w[(size_t)k * H3 + (col / CL_U) * H + un] : 0.f;
    ws[(size_t)col * 4 * SQ + ((((ks >> 2) ^ (col & 7))) << 2) + (ks & 3)] = val;
  }
  for (int idx = tid; idx < 2 * CL_R * Kp; idx += CL_THREADS) hs[idx] = 0.f;
  // h buffer b is full when this CTA has announced its bytes (one arrival)
  // and every CTA's R x U carries have landed (C R U 4 bytes of st.async)
  if (tid == 0) {
    for (int b = 0; b < 2; ++b)
      mbar_init(smem_addr(mbar + b), 1);
    fence_mbarrier_init();
  }
  const float* bh = b_hh2 + (size_t)d * H3;
  const float br = unit_ok ? bh[unit] : 0.f, bz = unit_ok ? bh[H + unit] : 0.f,
              bn = unit_ok ? bh[2 * H + unit] : 0.f;

  // the (row, unit) pairs this thread finalizes: rows rh*8 + 2*kq + i
  int grow[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rd = grp * CL_R + rh * 8 + 2 * kq + i;  // row within the direction
    row_ok[i] = rd < half;
    grow[i] = d * half + (row_ok[i] ? rd : 0);
  }
  // lane l (mod 16) reads row l's mask: the warp's vote says whether any row is live
  const int rf = grp * CL_R + (lane & 15);
  const bool flag_ok = rf < half;
  const int frow = d * half + (flag_ok ? rf : 0);

  // the time index of step s: K9 in reverse walks T-1 .. 0 in place
  auto tix = [&](int s) { return (SEQ && reverse) ? T - 1 - s : s; };
  float xc[2][3], mc[2], fc;  // this step's inputs
  auto load_step = [&](int s, float (&xv)[2][3], float (&mv)[2], float& fv) {
    const int t = tix(s);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* xp = x_proj + ((size_t)grow[i] * T + t) * H3;
      const bool ok = row_ok[i] && unit_ok;
      xv[i][0] = ok ? xp[unit] : 0.f;
      xv[i][1] = ok ? xp[H + unit] : 0.f;
      xv[i][2] = ok ? xp[2 * H + unit] : 0.f;
      mv[i] = row_ok[i] ? mask[(size_t)grow[i] * T + t] : 0.f;
    }
    fv = flag_ok ? mask[(size_t)frow * T + t] : 0.f;
  };
  if (T > 0) load_step(0, xc, mc, fc);
  float hreg[2] = {0.f, 0.f};  // the carries of this thread's (row, unit) pairs

  cluster_arrive();  // every CTA's slice, zeroed h buffers and mbarriers are in place
  cluster_wait();

  const float4* ws4 = reinterpret_cast<const float4*>(ws) + (size_t)u * SQ;  // gate g's column: + g * U * SQ
  int cur = 0;             // the h buffer this step reads; every CTA writes the other
  uint32_t parity[2] = {0u, 0u};  // the phase of each h buffer's mbarrier this CTA waits for next
  for (int s = 0; s < T; ++s) {
    const int t = tix(s);
    float xn[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}}, mn[2] = {0.f, 0.f}, fn = 0.f;
    if (s + 1 < T) load_step(s + 1, xn, mn, fn);
    // the same vote in every warp of every CTA of the cluster: all skip, or none
    const bool live = __any_sync(0xffffffffu, fc != 0.f);
    if (live) {
      const float4* hs4 = reinterpret_cast<const float4*>(hs + (size_t)cur * CL_R * Kp) + (size_t)rh * 8 * KQ;
      float acc[3][8];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[g][r] = 0.f;
      auto step4 = [&](const float4 (&wv)[3], int q) {  // the 4 depths of quad q
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 hv = hs4[(size_t)r * KQ + q];
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            float a = acc[g][r];
            a = fmaf(hv.x, wv[g].x, a);
            a = fmaf(hv.y, wv[g].y, a);
            a = fmaf(hv.z, wv[g].z, a);
            a = fmaf(hv.w, wv[g].w, a);
            acc[g][r] = a;
          }
        }
      };
#pragma unroll
      for (int j = 0; j < REGJ; ++j) {
        const float4 wv[3] = {wreg[0][j], wreg[1][j], wreg[2][j]};
        step4(wv, 4 * j + kq);
      }
#pragma unroll 2
      for (int qs = kq; qs < SQ; qs += 4) {
        const int sq = qs ^ ul;  // (col & 7) == ul for every gate's column of this unit
        const float4 wv[3] = {ws4[sq], ws4[(size_t)CL_U * SQ + sq], ws4[(size_t)2 * CL_U * SQ + sq]};
        step4(wv, 4 * REGJ + qs);
      }
      // reduce-scatter over the 4 depth quarters (lanes xor 16, then xor 8):
      // lane kq keeps rows 2*kq and 2*kq + 1
      const bool hi = kq >= 2, lo = kq & 1;
      float half4[3][4];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float send = hi ? acc[g][r] : acc[g][r + 4];
          const float keep = hi ? acc[g][r + 4] : acc[g][r];
          half4[g][r] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
        }
      float fin[3][2];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float send = lo ? half4[g][r] : half4[g][r + 2];
          const float keep = lo ? half4[g][r + 2] : half4[g][r];
          fin[g][r] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float r = sigmoidf_(xc[i][0] + (fin[0][i] + br));
        const float z = sigmoidf_(xc[i][1] + (fin[1][i] + bz));
        const float n = tanhf(xc[i][2] + r * (fin[2][i] + bn));
        const float hp = hreg[i];
        const float hn = (1.f - z) * n + z * hp;
        hreg[i] = unit_ok ? mc[i] * hn + (1.f - mc[i]) * hp : 0.f;
        stg[cur * CL_R * CL_U + (rh * 8 + 2 * kq + i) * CL_U + u] = hreg[i];
      }
      const int nxt = cur ^ 1;
      __syncthreads();  // the staging tile is written
      if (tid == 0)
        mbar_arrive_expect_tx(smem_addr(mbar + nxt), C * CL_R * CL_U * 4);
      // the staging tile into h buffer nxt of every CTA (this one's too),
      // columns c*U ..: asynchronous stores that the receiver's mbarrier
      // counts. A CTA reads buffer nxt again only after its mbarrier says
      // every CTA's part has landed; and every CTA stopped reading buffer nxt
      // (last step's cur) before it sent the carries this step waited for.
      const float4* stg4 = reinterpret_cast<const float4*>(stg + cur * CL_R * CL_U);
      const uint32_t nxt_base = smem_addr(hs + (size_t)nxt * CL_R * Kp + c * CL_U);
      const uint32_t nxt_mbar = smem_addr(mbar + nxt);
      for (int idx = tid; idx < C * CL_R * (CL_U / 4); idx += CL_THREADS) {
        const int p = idx / (CL_R * (CL_U / 4)), e = idx % (CL_R * (CL_U / 4));
        const int r = e / (CL_U / 4), q4 = e % (CL_U / 4);
        st_async16(peer_addr(nxt_base + (uint32_t)((r * Kp + 4 * q4) * sizeof(float)), p), stg4[e],
                   peer_addr(nxt_mbar, p));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row_ok[i] && unit_ok) out[((size_t)grow[i] * T + t) * H + unit] = SEQ ? hreg[i] * mc[i] : hreg[i];
      mbar_wait(nxt_mbar, parity[nxt]);  // every CTA's carries are here
      parity[nxt] ^= 1u;
      cur = nxt;
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row_ok[i] && unit_ok) out[((size_t)grow[i] * T + t) * H + unit] = SEQ ? hreg[i] * mc[i] : hreg[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mc[i] = mn[i];
#pragma unroll
      for (int g = 0; g < 3; ++g) xc[i][g] = xn[i][g];
    }
    fc = fn;
  }
  cluster_arrive();  // no CTA leaves while a peer may still write into its shared memory
  cluster_wait();
}

// The cluster kernel for cluster size C, its attributes set once a process:
// dynamic shared memory up to the largest cluster's need, and clusters of
// more than 8 CTAs.
typedef void (*ClusterKernel)(const float*, const float*, const float*, const float*, float*, int, int, int, int);
cudaError_t cluster_kernel(int C, bool seq, ClusterKernel* kern) {
  static cudaError_t status = [] {
    cudaError_t err = cudaSuccess;
    const ClusterKernel kernels[4] = {gru_bidir_cluster_kernel<0, false>, gru_bidir_cluster_kernel<CL_REGJ, false>,
                                      gru_bidir_cluster_kernel<0, true>, gru_bidir_cluster_kernel<CL_REGJ, true>};
    for (ClusterKernel k : kernels) {
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cluster_smem_bytes(CL_MAX));
      if (err == cudaSuccess) err = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    return err;
  }();
  if (seq)
    *kern = cluster_regj(C) > 0 ? gru_bidir_cluster_kernel<CL_REGJ, true> : gru_bidir_cluster_kernel<0, true>;
  else
    *kern = cluster_regj(C) > 0 ? gru_bidir_cluster_kernel<CL_REGJ, false> : gru_bidir_cluster_kernel<0, false>;
  return status;
}

// Launch the cluster route: grid (C, ceil(half / R), dirs), clusters of (C, 1, 1).
cudaError_t launch_cluster(bool seq, int C, int dirs, const float* x_proj, const float* w_hh, const float* b_hh,
                           const float* mask, float* out, int half, int T, int H, int reverse, cudaStream_t stream) {
  ClusterKernel kern;
  const cudaError_t cerr = cluster_kernel(C, seq, &kern);
  if (cerr != cudaSuccess) return cerr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (half + CL_R - 1) / CL_R, dirs);
  cfg.blockDim = dim3(CL_THREADS, 1, 1);
  cfg.dynamicSmemBytes = cluster_smem_bytes(C);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, x_proj, w_hh, b_hh, mask, out, half, T, H, reverse);
  return err != cudaSuccess ? err : cudaGetLastError();
}

__global__ void gru_sequence_kernel(const float* __restrict__ x_proj,  // [B, T, 3H]
                                    const float* __restrict__ w_hh,    // [H, 3H]
                                    const float* __restrict__ b_hh,    // [3H]
                                    const float* __restrict__ mask,    // [B, T]
                                    float* __restrict__ out,           // [B, T, H]
                                    int T, int H, int reverse) {
  extern __shared__ float h_s[];  // [H]
  const int row = blockIdx.x;
  const int H3 = 3 * H;
  for (int j = threadIdx.x; j < H; j += blockDim.x) h_s[j] = 0.f;
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    const float m = mask[(size_t)row * T + t];
    const float* xp = x_proj + ((size_t)row * T + t) * H3;
    float* o = out + ((size_t)row * T + t) * H;
    float h_next[4];  // at most 4 hidden units per thread (checked by the wrapper)
    int n_own = 0;
    for (int j = threadIdx.x; j < H; j += blockDim.x, ++n_own) {
      float ar = b_hh[j], az = b_hh[H + j], an = b_hh[2 * H + j];
#pragma unroll 4
      for (int i = 0; i < H; ++i) {
        const float hi = h_s[i];
        const float* wr = w_hh + (size_t)i * H3;
        ar = fmaf(hi, wr[j], ar);
        az = fmaf(hi, wr[H + j], az);
        an = fmaf(hi, wr[2 * H + j], an);
      }
      const float r = sigmoidf_(xp[j] + ar);
      const float z = sigmoidf_(xp[H + j] + az);
      const float n = tanhf(xp[2 * H + j] + r * an);
      const float hp = h_s[j];
      const float hn = (1.f - z) * n + z * hp;
      h_next[n_own] = m * hn + (1.f - m) * hp;
    }
    __syncthreads();  // every thread has read h_s for this step
    n_own = 0;
    for (int j = threadIdx.x; j < H; j += blockDim.x, ++n_own) {
      h_s[j] = h_next[n_own];
      o[j] = h_next[n_own] * m;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int ser_gru_bidir_f32(const void* x_proj, const void* w_hh2, const void* b_hh2,
                                 const void* mask, void* out, int B2, int T, int H, int cluster,
                                 int threads, void* stream) {
  if (B2 % 2 != 0 || B2 < 2 || T < 0 || H < 1) return (int)cudaErrorInvalidValue;
  if (cluster == 0) {  // one block per row
    if (threads < 32 || threads > 1024 || H > 4 * threads) return (int)cudaErrorInvalidValue;
    gru_bidir_kernel<<<B2, threads, H * sizeof(float), (cudaStream_t)stream>>>(
        (const float*)x_proj, (const float*)w_hh2, (const float*)b_hh2, (const float*)mask,
        (float*)out, B2 / 2, T, H);
    return (int)cudaGetLastError();
  }
  // the cluster route: the plan must be ceil(H / 32) CTAs, at most 16
  if (cluster != (H + CL_U - 1) / CL_U || cluster > CL_MAX) return (int)cudaErrorInvalidValue;
  return (int)launch_cluster(false, cluster, 2, (const float*)x_proj, (const float*)w_hh2, (const float*)b_hh2,
                             (const float*)mask, (float*)out, B2 / 2, T, H, 0, (cudaStream_t)stream);
}

// How many clusters of `cluster` CTAs of the cluster route the card runs at
// once (cudaOccupancyMaxActiveClusters), into *n: K3's kernel (seq = 0) or
// K9's (seq = 1).
extern "C" int ser_gru_max_active_clusters(int cluster, int seq, int* n) {
  if (cluster < 1 || cluster > CL_MAX) return (int)cudaErrorInvalidValue;
  ClusterKernel kern;
  const cudaError_t err = cluster_kernel(cluster, seq != 0, &kern);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = cluster_smem_bytes(cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 64, 2);
  cfg.blockDim = dim3(CL_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(n, kern, &cfg);
}

extern "C" int ser_gru_sequence_f32(const void* x_proj, const void* w_hh, const void* b_hh,
                                    const void* mask, void* out, int B, int T, int H, int reverse,
                                    int cluster, int threads, void* stream) {
  if (B < 1 || T < 0 || H < 1) return (int)cudaErrorInvalidValue;
  if (cluster != 0) {  // the cluster route: the plan must be ceil(H / 32) CTAs, at most 16
    if (cluster != (H + CL_U - 1) / CL_U || cluster > CL_MAX) return (int)cudaErrorInvalidValue;
    return (int)launch_cluster(true, cluster, 1, (const float*)x_proj, (const float*)w_hh, (const float*)b_hh,
                               (const float*)mask, (float*)out, B, T, H, reverse, (cudaStream_t)stream);
  }
  if (threads < 32 || threads > 1024 || H > 4 * threads) return (int)cudaErrorInvalidValue;
  gru_sequence_kernel<<<B, threads, H * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)x_proj, (const float*)w_hh, (const float*)b_hh, (const float*)mask,
      (float*)out, T, H, reverse);
  return (int)cudaGetLastError();
}
