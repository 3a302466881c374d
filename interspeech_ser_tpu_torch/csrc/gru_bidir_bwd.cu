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
// What bounds it on an H100: like K3, the serial recurrence. Each step does
// two matrix-vector products against w_hh[d] (3 MB in f32 at H = 512),
// which is read from L2 at every step by every block. The design mirrors
// K3: one block per row, looping backwards over T; thread j owns hidden
// units j, j + blockDim, ... for the gate recompute (columns j, H+j, 2H+j
// of w_hh, coalesced across the warp). The transposed product needs row i
// of w_hh for hidden unit i, which a thread-per-unit loop would read with
// a stride of 3H between neighbouring threads; here one warp takes one row
// i at a time, its lanes read w_hh[i, k] for consecutive k (coalesced), and
// a shuffle tree sums the lanes in a fixed order.
//
// dW_hh and db_hh are the product h_prev^T . dhp over all rows and steps of
// a direction, [H, B*T] x [B*T, 3H]. The recurrence kernel writes dhp to a
// scratch buffer; a second launch reduces it with a 64 x 64 tiled product
// (16 steps of the B*T axis per tile, 4 x 4 outputs a thread, FP32 pipes).
// Every output element is summed by one thread in one fixed order, with no
// atomics, so two runs give the same bits. db_hh rides the same tiles.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

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

// dw[d] = sum over rows r of direction d and steps t of h_prev[r,t]^T dhp[r,t];
// db[d] = sum of dhp[r,t]. Block (x, y, d): output tile k in [64x, 64x+64),
// i in [64y, 64y+64). Thread (tx, ty) owns i = 64y + ty + 16a, k = 64x + tx + 16b.
constexpr int TILE = 64;
constexpr int KSTEP = 16;

__global__ void gru_bidir_dw_kernel(const float* __restrict__ h,    // [2B, T, H]
                                    const float* __restrict__ dhp,  // [2B, T, 3H]
                                    float* __restrict__ dw,         // [2, H, 3H]
                                    float* __restrict__ db,         // [2, 3H]
                                    int half, int T, int H) {
  __shared__ float a_s[KSTEP][TILE];
  __shared__ float b_s[KSTEP][TILE];
  const int H3 = 3 * H;
  const int d = blockIdx.z;
  const int i0 = blockIdx.y * TILE, k0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int N = half * T;
  const bool do_db = blockIdx.y == 0 && ty == 0;
  float acc[4][4] = {};
  float bsum[4] = {};
  for (int n0 = 0; n0 < N; n0 += KSTEP) {
    for (int e = threadIdx.x; e < KSTEP * TILE; e += blockDim.x) {
      const int kk = e / TILE, c = e % TILE;
      const int n = n0 + kk;
      float av = 0.f, bv = 0.f;
      if (n < N) {
        const int t = n % T;
        const size_t rt = (size_t)(d * half + n / T) * T + t;
        if (t > 0 && i0 + c < H) av = h[(rt - 1) * H + i0 + c];
        if (k0 + c < H3) bv = dhp[rt * H3 + k0 + c];
      }
      a_s[kk][c] = av;
      b_s[kk][c] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KSTEP; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = a_s[kk][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = b_s[kk][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
      if (do_db) {
#pragma unroll
        for (int b = 0; b < 4; ++b) bsum[b] += bv[b];
      }
    }
    __syncthreads();
  }
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    for (int b = 0; b < 4; ++b) {
      const int k = k0 + tx + 16 * b;
      if (i < H && k < H3) dw[((size_t)d * H + i) * H3 + k] = acc[a][b];
    }
  }
  if (do_db)
    for (int b = 0; b < 4; ++b) {
      const int k = k0 + tx + 16 * b;
      if (k < H3) db[(size_t)d * H3 + k] = bsum[b];
    }
}

}  // namespace

extern "C" int ser_gru_bidir_bwd_f32(const void* g, const void* h, const void* x_proj,
                                     const void* mask, const void* w_hh2, const void* b_hh2,
                                     void* dxp, void* dhp, void* dw, void* db, int B2, int T,
                                     int H, int threads, void* stream) {
  if (B2 % 2 != 0 || threads < 32 || threads > 1024 || threads % 32 != 0 || H > 4 * threads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  gru_bidir_bwd_kernel<<<B2, threads, 6 * H * sizeof(float), s>>>(
      (const float*)g, (const float*)h, (const float*)x_proj, (const float*)mask,
      (const float*)w_hh2, (const float*)b_hh2, (float*)dxp, (float*)dhp, B2 / 2, T, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((3 * H + TILE - 1) / TILE, (H + TILE - 1) / TILE, 2);
  gru_bidir_dw_kernel<<<grid, 256, 0, s>>>((const float*)h, (const float*)dhp, (float*)dw,
                                           (float*)db, B2 / 2, T, H);
  return (int)cudaGetLastError();
}
