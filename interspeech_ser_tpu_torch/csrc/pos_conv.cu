// K8: the grouped positional convolution of the speech encoders.
//
// Replaces interspeech_ser_tpu/ops/pallas/pos_conv.py (pos_conv_grouped ->
// _kernel).
//
// The positional embedding of WavLM / wav2vec2 / HuBERT is a grouped Conv1d
// with K = 128 taps and G = 16 groups of C = D / G channels (48 for the base
// encoders, 64 for WavLM-large, 80 for HuBERT-XL, 120 for XLS-R-2B), SAME
// padding K/2 on both sides, so T + 1 output frames for an even K (the
// caller drops the last one). Per batch row b, group g, output frame t and
// output channel o of the group:
//   y[b, t, g*C + o] = sum_{tap < K} sum_{i < C} w[g, tap, i, o] * xpad[b, t + tap, g*C + i]
// with xpad[j] = x[j - K/2] inside [0, T) and 0 outside, inputs in the
// compute dtype and f32 accumulation; the sum is rounded to the compute
// dtype once. Bias and GELU stay outside the kernel, as in the TPU kernel.
//
// What bounds it on an H100: it is a chain of [frames, C] x [C, C] products
// (2 * B * (T+1) * D * K * C operations: 472 GFLOP at XLS-R-2B, B=16,
// T=499), so it is bound by operations in both dtypes (x and y are read and
// written once). The TPU kernel held a group's whole padded time slab and
// all K of its [C, C] tap matrices in VMEM (7.4 MB of taps at C=120 in f32).
// Here a block owns (b, g, a tile of output frames) and walks the taps; the
// launch plan (frames a block, pipeline stages, threads, shared bytes) is
// ops/kernels/pos_conv.py's pos_conv_plan, which the wrapper passes in and
// the launcher checks.
//
// bf16 (pos_conv_wgmma_kernel): Hopper warpgroup products. A block of
// frames / 64 warpgroups (4 at K = 128: 256 frames, 16 warps an SM) stages
// the group's [frames + K - 1, C] input slab once and streams the K tap
// matrices [C_out, C_in] through a ring of 4 steps by cp.async, two steps
// ahead, one barrier a step; a step is one tap at C = 120, two at C = 64
// and 80 and four at C = 48, where a tap's products are too short to pay
// for a barrier of 16 warps.
// Each warpgroup owns 64 frames x all C outputs
// (C / 2 f32 accumulators a thread) and issues, per tap, C_in / 16
// wgmma.m64nCk16 with BOTH operands read from shared memory: frame t's row
// at tap j is slab row t + j, and the slab is stored chunk-major ([C / 8]
// [rows][8], wgmma.cuh), so the A operand of tap j is the descriptor of tap
// 0 moved on by j rows; the one-row shift that breaks an 8-row-aligned
// layout costs nothing here. C_in is zero-padded to the k16 depth (120 ->
// 128). The tap matrix is read once by all four warpgroups (256 frames
// share it: half the L2 re-reads of the 128-frame mma.sync kernel this
// replaces); the products of bf16 values are exact, so this is the same
// function. Each warpgroup keeps two steps' products in flight
// (wgmma.wait_group 1) and a ring slot is refilled only after the barrier
// that follows every warpgroup's wait for it. No atomics: the sum order is
// fixed, a rerun is bit-identical.
//
// f32 (pos_conv_f32_kernel): the FP32 pipes, IEEE fmaf (TF32 off, as the
// reference's f32 mode requires). The reduction runs input channel by input
// channel, and within one input channel tap by tap, so that a thread keeps
// its window of the input column in registers: it owns 8 consecutive frames
// x 8 output channels (64 accumulators), and frame f at tap j + 1 reads the
// value frame f + 1 read at tap j, so each tap costs one new slab value and
// two float4 of the tap row for 64 FMAs (21 FMAs a shared load; the kernel
// this replaces did 5.3). A stage is one input channel's [64 taps, C_out]
// weights (the wrapper lays the weight out as [G, C_in, K, C_out], so a
// stage is one contiguous read) and that channel's input column, double
// buffered by cp.async, one barrier a stage. 128 frames a block at C = 80
// and 120, 256 at C = 48 and 64; (frames / 8) x (C / 8) threads, two
// blocks an SM. A thread's 8 channels are two runs of 4 (o and C/2 + o),
// so that a quarter-warp's float4 reads fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int SMEM_LIMIT = 232448;  // the most shared memory a block may opt into (227 KB)

// ---- f32: FP32 pipes -----------------------------------------------------------

constexpr int F_RT = 8;      // frames a thread
constexpr int F_RO = 8;      // output channels a thread (two runs of 4)
constexpr int F_TAPS = 64;   // taps a stage
constexpr int F_STAGES = 2;  // double-buffered
constexpr int F_THREADS_MAX = 256;

__host__ __device__ inline int f32_threads(int C, int frames) { return (frames / F_RT) * (C / F_RO); }
__host__ __device__ inline int f32_stage_floats(int C, int frames) { return F_TAPS * C + frames + F_TAPS; }
inline size_t f32_smem_bytes(int C, int frames) {
  return (size_t)F_STAGES * f32_stage_floats(C, frames) * sizeof(float);
}

// taps u0 .. u0 + 7 of a stage (those below nt when GUARD): a[(r + u) % 8] holds frame r's input at
// tap u, xs[f0 + r + u]; after tap u, frame 0's value is spent and frame 7's at tap u + 1 takes its slot
template <int C, bool GUARD>
__device__ __forceinline__ void f32_taps(float (&acc)[F_RT][F_RO], float (&a)[F_RT], const float* ws, const float* xs,
                                         int f0, int o0, int u0, int nt) {
#pragma unroll
  for (int uu = 0; uu < F_RT; ++uu) {
    const int u = u0 + uu;
    if (!GUARD || u < nt) {
      const float4 w0 = *reinterpret_cast<const float4*>(ws + u * C + o0);
      const float4 w1 = *reinterpret_cast<const float4*>(ws + u * C + C / 2 + o0);
      const float xn = xs[f0 + u + F_RT];
      const float wv[F_RO] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int r = 0; r < F_RT; ++r) {
        const float xr = a[(r + uu) % F_RT];
#pragma unroll
        for (int o = 0; o < F_RO; ++o) acc[r][o] = fmaf(xr, wv[o], acc[r][o]);
      }
      a[uu] = xn;
    }
  }
}

template <int C>
__global__ void __launch_bounds__(F_THREADS_MAX, 2) pos_conv_f32_kernel(
    const float* __restrict__ x,  // [B, T, G*C]
    const float* __restrict__ w,  // [G, C_in, K, C_out]
    float* __restrict__ y,        // [B, T+1, G*C]
    int T_in, int G, int K, int frames) {
  constexpr int NCG = C / F_RO;  // column groups
  constexpr int HALF = C / 2;
  extern __shared__ __align__(16) float fsm[];
  const int stage_floats = f32_stage_floats(C, frames);

  const int tid = threadIdx.x;
  const int cg = tid % NCG, rg = tid / NCG;
  const int f0 = F_RT * rg, o0 = 4 * cg;
  const int t0 = blockIdx.x * frames;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int D = G * C;
  const int pad = K / 2;
  const int T_out = T_in + 2 * pad - K + 1;
  const int nchunks = (K + F_TAPS - 1) / F_TAPS;
  const int nstages = C * nchunks;
  const int xrows = frames + F_TAPS;  // a stage's input column: its frames' windows over 64 taps
  const int threads = blockDim.x;

  // stage s: input channel s / nchunks, taps [64 * (s % nchunks), + 64)
  auto load_stage = [&](int s, int buf) {
    float* ws = fsm + buf * stage_floats;
    float* xs = ws + F_TAPS * C;
    const int i = s / nchunks, j0 = (s % nchunks) * F_TAPS;
    const int nt = min(F_TAPS, K - j0);
    const float* src = w + (((size_t)g * C + i) * K + j0) * C;
    for (int idx = tid; idx < nt * C / 4; idx += threads) attn_mma::cp_async16(ws + 4 * idx, src + 4 * idx, true);
    for (int r = tid; r < xrows; r += threads) {
      const int t = t0 + j0 + r - pad;
      const bool ok = t >= 0 && t < T_in;
      wg::cp_async4(xs + r, x + ((size_t)b * T_in + (ok ? t : 0)) * D + g * C + i, ok);
    }
    attn_mma::cp_async_commit();
  };

  float acc[F_RT][F_RO];
#pragma unroll
  for (int r = 0; r < F_RT; ++r)
#pragma unroll
    for (int o = 0; o < F_RO; ++o) acc[r][o] = 0.f;

  load_stage(0, 0);
  for (int s = 0; s < nstages; ++s) {
    attn_mma::cp_async_wait<0>();
    __syncthreads();  // stage s is in for everyone, and everyone is done with stage s - 1's buffer
    if (s + 1 < nstages) load_stage(s + 1, (s + 1) & 1);
    const float* ws = fsm + (s & 1) * stage_floats;
    const float* xs = ws + F_TAPS * C;
    const int nt = min(F_TAPS, K - (s % nchunks) * F_TAPS);
    float a[F_RT];  // frames f0 .. f0 + 7 at the stage's first tap
    {
      const float4 lo = *reinterpret_cast<const float4*>(xs + f0);
      const float4 hi = *reinterpret_cast<const float4*>(xs + f0 + 4);
      a[0] = lo.x, a[1] = lo.y, a[2] = lo.z, a[3] = lo.w, a[4] = hi.x, a[5] = hi.y, a[6] = hi.z, a[7] = hi.w;
    }
    if (nt == F_TAPS) {  // every stage but a last partial one: no guard, so loads can move ahead of the FMAs
#pragma unroll 1
      for (int u0 = 0; u0 < F_TAPS; u0 += F_RT) f32_taps<C, false>(acc, a, ws, xs, f0, o0, u0, nt);
    } else {
      for (int u0 = 0; u0 < nt; u0 += F_RT) f32_taps<C, true>(acc, a, ws, xs, f0, o0, u0, nt);
    }
  }

#pragma unroll
  for (int r = 0; r < F_RT; ++r) {
    const int t = t0 + f0 + r;
    if (t >= T_out) continue;
    float* yr = y + ((size_t)b * T_out + t) * D + g * C;
    *reinterpret_cast<float4*>(yr + o0) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(yr + HALF + o0) = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
}

// ---- bf16: warpgroup products ------------------------------------------------

constexpr int WG_ROWS = 64;     // frames a warpgroup
constexpr int WG_THREADS = 128;

__host__ __device__ constexpr int wg_chunks(int C) { return (C + 15) / 16 * 2; }  // 16-byte chunks of C_in, k16-padded
// taps a step (one barrier, one wgmma group), since a tap's products are short: 4 at C = 48 and
// 2 at C = 64, where two blocks still fit an SM at K = 128 (4 at C = 64 would leave room for one),
// 2 at C = 80 and 1 at C = 120, where a ring of 4 steps fills the rest
__host__ __device__ constexpr int wg_taps_per_step(int C) { return C <= 48 ? 4 : (C <= 80 ? 2 : 1); }
__host__ __device__ inline int wg_threads(int frames) { return WG_THREADS * (frames / WG_ROWS); }
inline size_t wg_smem_bytes(int C, int K, int frames, int stages) {
  return (size_t)16 * wg_chunks(C) * (frames + K - 1 + stages * wg_taps_per_step(C) * C);
}

template <int C>
__global__ void __launch_bounds__(512, 1) pos_conv_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x,  // [B, T, G*C]
    const __nv_bfloat16* __restrict__ w,  // [G, K, C_out, C_in]
    __nv_bfloat16* __restrict__ y,        // [B, T+1, G*C]
    int T_in, int G, int K, int frames, int stages) {
  constexpr int KC8 = wg_chunks(C);  // chunks a row holds in shared memory (the pad chunk is zero)
  constexpr int V = C / 8;           // chunks of a row in device memory
  constexpr int KS = KC8 / 2;        // k16 steps a tap
  constexpr int NACC = C / 2;
  constexpr int TPS = wg_taps_per_step(C);
  extern __shared__ __align__(128) __nv_bfloat16 bsm[];
  const int rows = frames + K - 1;
  __nv_bfloat16* slab = bsm;                            // [KC8][rows][8]
  __nv_bfloat16* ring = slab + (size_t)KC8 * rows * 8;  // [stages * TPS][KC8][C][8]: step p's taps in slots of p % stages

  const int tid = threadIdx.x, threads = blockDim.x;
  const int wgi = tid / WG_THREADS;
  const int t0 = blockIdx.x * frames;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int D = G * C;
  const int pad = K / 2;
  const int T_out = T_in + 2 * pad - K + 1;

  // the slab: row r is input frame t0 + r - pad (zeros outside [0, T) and in the pad chunk)
  for (int idx = tid; idx < rows * KC8; idx += threads) {
    const int r = idx / KC8, c = idx % KC8;
    const int t = t0 + r - pad;
    const bool ok = c < V && t >= 0 && t < T_in;
    attn_mma::cp_async16(slab + ((size_t)c * rows + r) * 8,
                         x + ((size_t)b * T_in + (ok ? t : 0)) * D + g * C + 8 * (ok ? c : 0), ok);
  }
  attn_mma::cp_async_commit();
  const __nv_bfloat16* wg_taps = w + (size_t)g * K * C * C;
  auto load_step = [&](int p) {  // the taps of step p
#pragma unroll
    for (int q = 0; q < TPS; ++q) {
      const int j = p * TPS + q;
      if (j >= K) break;
      __nv_bfloat16* dst = ring + (size_t)((p % stages) * TPS + q) * KC8 * C * 8;
      const __nv_bfloat16* src = wg_taps + (size_t)j * C * C;
      for (int idx = tid; idx < C * KC8; idx += threads) {
        const int o = idx / KC8, c = idx % KC8;
        attn_mma::cp_async16(dst + ((size_t)c * C + o) * 8, src + (size_t)o * C + 8 * (c < V ? c : 0), c < V);
      }
    }
  };
  const int nsteps = (K + TPS - 1) / TPS;
  for (int p = 0; p < stages - 2; ++p) {  // steps ahead of the first product
    if (p < nsteps) load_step(p);
    attn_mma::cp_async_commit();
  }

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  const uint32_t lbo_a = (uint32_t)rows * 16, lbo_b = (uint32_t)C * 16;
  const __nv_bfloat16* a_base = slab + (size_t)(wgi * WG_ROWS) * 8;

  for (int p = 0; p < nsteps; ++p) {
    // groups committed so far: slab, steps 0 .. p + stages - 3; step p must be in
    if (stages >= 4)
      attn_mma::cp_async_wait<1>();
    else
      attn_mma::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();  // step p is in for everyone; every warpgroup is done with step p - 2's ring slots
    if (p + stages - 2 < nsteps) load_step(p + stages - 2);
    attn_mma::cp_async_commit();
#pragma unroll
    for (int i = 0; i < NACC; ++i) wg::pin(acc[i]);
    wg::fence();
#pragma unroll
    for (int q = 0; q < TPS; ++q) {
      const int j = p * TPS + q;
      if (j >= K) break;
      const __nv_bfloat16* a_tap = a_base + (size_t)j * 8;  // frame t's row at tap j: slab row t + j
      const __nv_bfloat16* b_tap = ring + (size_t)((p % stages) * TPS + q) * KC8 * C * 8;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const uint64_t da = wg::desc(a_tap + (size_t)(2 * s) * rows * 8, lbo_a, 128);
        const uint64_t db = wg::desc(b_tap + (size_t)(2 * s) * C * 8, lbo_b, 128);
        wg::WgmmaSS<C>::run(acc, da, db, (j | s) != 0);
      }
    }
    wg::commit();
    wg::wait<1>();
#pragma unroll
    for (int i = 0; i < NACC; ++i) wg::pin(acc[i]);
  }
  wg::wait<0>();
#pragma unroll
  for (int i = 0; i < NACC; ++i) wg::pin(acc[i]);

  const int lane = tid & 31, warp = (tid % WG_THREADS) >> 5;
  const int row = wgi * WG_ROWS + warp * 16 + (lane >> 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + row + 8 * half;
    if (t >= T_out) continue;
    __nv_bfloat16* yr = y + ((size_t)b * T_out + t) * D + g * C + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(yr + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2 * half], acc[4 * n + 2 * half + 1]);
  }
}

// ---- the weight's layout -----------------------------------------------------
//
// Each call lays the Conv1d weight [G, C_out, C_in, K] out for its kernel,
// rounded to the compute dtype: [G, K, C_out, C_in] for bf16 (a tap matrix
// a stage), [G, C_in, K, C_out] for f32 (an input channel's taps a stage).
// Both are a transpose per group, dst[g][s][r] = src[g][r][s], of an
// [R, S] matrix ([C_out C_in, K] and [C_out, C_in K]). 32 x 32 tiles pass
// through shared memory so that the reads run along s and the writes along
// r, each coalesced (a strided copy reads a 32-byte sector for every 4 or 2
// bytes it keeps). The rounding is round-to-nearest-even, as torch's cast.

constexpr int LT = 32;  // a tile's side; 32 x 8 threads

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(LT * 8) pos_conv_layout_kernel(const Tin* __restrict__ src, Tout* __restrict__ dst,
                                                                 int R, int S) {
  __shared__ float tile[LT][LT + 1];
  const size_t off = (size_t)blockIdx.z * R * S;
  const int r0 = blockIdx.y * LT, s0 = blockIdx.x * LT, tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = ty; i < LT; i += 8)
    if (r0 + i < R && s0 + tx < S) tile[i][tx] = to_f32(src[off + (size_t)(r0 + i) * S + s0 + tx]);
  __syncthreads();
#pragma unroll
  for (int i = ty; i < LT; i += 8)
    if (s0 + i < S && r0 + tx < R) put(dst + off + (size_t)(s0 + i) * R + r0 + tx, tile[tx][i]);
}

template <typename Tin, typename Tout>
int layout(const void* src, void* dst, int G, int R, int S, void* stream) {
  const dim3 grid((S + LT - 1) / LT, (R + LT - 1) / LT, G);
  pos_conv_layout_kernel<Tin, Tout><<<grid, dim3(LT, 8), 0, (cudaStream_t)stream>>>((const Tin*)src, (Tout*)dst, R, S);
  return (int)cudaGetLastError();
}

// ---- launch ----------------------------------------------------------------

// the plan the wrapper passes in (pos_conv.pos_conv_plan): checked, not chosen, here
bool plan_ok(bool bf16, int C, int K, int frames, int stages) {
  if (K < 1 || K > 256 || frames < 64 || frames % 64 != 0) return false;
  if (bf16) return frames <= 256 && stages >= 3 && stages <= 4 && wg_smem_bytes(C, K, frames, stages) <= SMEM_LIMIT;
  return stages == F_STAGES && f32_threads(C, frames) <= F_THREADS_MAX && f32_smem_bytes(C, frames) <= SMEM_LIMIT;
}

template <int C>
int launch_c(bool bf16, const void* x, const void* w, void* y, int B, int T_in, int G, int K, int frames, int stages,
             void* stream) {
  const int T_out = T_in + 2 * (K / 2) - K + 1;
  dim3 grid((T_out + frames - 1) / frames, G, B);
  cudaError_t err;
  if (bf16) {
    const size_t smem = wg_smem_bytes(C, K, frames, stages);
    err = cudaFuncSetAttribute(pos_conv_wgmma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    pos_conv_wgmma_kernel<C><<<grid, wg_threads(frames), smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y, T_in, G, K, frames, stages);
  } else {
    const size_t smem = f32_smem_bytes(C, frames);
    err = cudaFuncSetAttribute(pos_conv_f32_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    pos_conv_f32_kernel<C><<<grid, f32_threads(C, frames), smem, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w, (float*)y, T_in, G, K, frames);
  }
  return (int)cudaGetLastError();
}

// threads, shared bytes and resident blocks an SM of the kernel at this plan
template <int C>
int plan_c(bool bf16, int K, int frames, int stages, int* out) {
  const void* kern = bf16 ? (const void*)pos_conv_wgmma_kernel<C> : (const void*)pos_conv_f32_kernel<C>;
  const int threads = bf16 ? wg_threads(frames) : f32_threads(C, frames);
  const size_t smem = bf16 ? wg_smem_bytes(C, K, frames, stages) : f32_smem_bytes(C, frames);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = threads;
  out[1] = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kern, threads, smem);
}

int launch(bool bf16, const void* x, const void* w, void* y, int B, int T_in, int G, int C, int K, int frames,
           int stages, void* stream) {
  if (G < 1 || B < 1 || T_in < 1 || !plan_ok(bf16, C, K, frames, stages)) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 48: return launch_c<48>(bf16, x, w, y, B, T_in, G, K, frames, stages, stream);
    case 64: return launch_c<64>(bf16, x, w, y, B, T_in, G, K, frames, stages, stream);
    case 80: return launch_c<80>(bf16, x, w, y, B, T_in, G, K, frames, stages, stream);
    case 120: return launch_c<120>(bf16, x, w, y, B, T_in, G, K, frames, stages, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ser_pos_conv_f32(const void* x, const void* w, void* y, int B, int T, int G, int C, int K, int frames,
                                int stages, void* stream) {
  return launch(false, x, w, y, B, T, G, C, K, frames, stages, stream);
}

extern "C" int ser_pos_conv_bf16(const void* x, const void* w, void* y, int B, int T, int G, int C, int K,
                                 int frames, int stages, void* stream) {
  return launch(true, x, w, y, B, T, G, C, K, frames, stages, stream);
}

// dst[g][s][r] = src[g][r][s] in the compute dtype (dst_bf16) from an f32 or bf16 (src_bf16) weight
extern "C" int ser_pos_conv_layout(const void* src, int src_bf16, void* dst, int dst_bf16, int G, int R, int S,
                                   void* stream) {
  if (G < 1 || R < 1 || S < 1 || (R + LT - 1) / LT > 65535) return (int)cudaErrorInvalidValue;
  if (src_bf16)
    return dst_bf16 ? layout<__nv_bfloat16, __nv_bfloat16>(src, dst, G, R, S, stream)
                    : layout<__nv_bfloat16, float>(src, dst, G, R, S, stream);
  return dst_bf16 ? layout<float, __nv_bfloat16>(src, dst, G, R, S, stream)
                  : layout<float, float>(src, dst, G, R, S, stream);
}

// out: [threads, shared bytes, blocks an SM] of the bf16 (1) or f32 (0) kernel at this plan
extern "C" int ser_pos_conv_plan(int bf16, int C, int K, int frames, int stages, int* out) {
  if (!plan_ok(bf16 != 0, C, K, frames, stages)) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 48: return plan_c<48>(bf16 != 0, K, frames, stages, out);
    case 64: return plan_c<64>(bf16 != 0, K, frames, stages, out);
    case 80: return plan_c<80>(bf16 != 0, K, frames, stages, out);
    case 120: return plan_c<120>(bf16 != 0, K, frames, stages, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
