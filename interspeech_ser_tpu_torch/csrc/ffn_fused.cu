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
// What bounds it on an H100: the TPU kernel held both weight panels whole in
// VMEM and walked M; at XLS-R-2B (K = N = 1920, F = 7680) the panels are
// 59 MB in bf16 and 118 MB in f32, hundreds of times a block's 227 KB of
// shared memory. Here one block owns BM = 16 rows and ALL N outputs: their
// f32 accumulators live in registers (8 rows x N/128 columns per thread,
// 120 floats at N = 1920), and the block walks F in chunks of FC = 256:
//   A. h[16, 256] = gelu(x[16, :] . W_up[chunk, :]^T + b_up), K in steps
//      of 32 staged in shared memory; each thread owns 8 rows x 2 columns
//      of h, so per K step it reads two float4 broadcasts of x and two
//      conflict-free values of W_up for 16 FMAs;
//   B. acc += h . W_down[:, chunk]^T, W_down staged 128 output columns at a
//      time ([256, 128] f32, rows padded to 129 floats so the transposing
//      store is conflict-free); per h column a thread reads two float4
//      broadcasts of h and one value of W_down for 8 FMAs.
// Then out = acc + b_down. Every sum runs in one fixed order and no block
// shares an output (no atomics), so a rerun is bit-identical. Each block
// streams both weight matrices once from L2 (16 FMAs per staged weight), so
// the kernel is bound by operations on the FP32 pipes and by L2 bandwidth,
// not by device memory: x and out are read and written once and the
// intermediate (M x F: 245 MB in f32 at XLS-R-2B, B=16, T=499) never is.
// Tensor-core products (mma.sync / wgmma on bf16) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 16;    // rows per block
constexpr int FC = 256;   // intermediate columns per chunk
constexpr int KC = 32;    // reduction step of phase A
constexpr int NCH = 128;  // output columns staged per step of phase B

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// NPT: output columns per thread (N / 128)
template <typename T, int NPT>
__global__ void __launch_bounds__(THREADS) ffn_fused_kernel(
    const T* __restrict__ x,         // [M, K]
    const T* __restrict__ w_up,      // [F, K]
    const float* __restrict__ b_up,  // [F]
    const T* __restrict__ w_down,    // [N, F]
    const float* __restrict__ b_down,  // [N]
    T* __restrict__ out,             // [M, N]
    int M, int K, int F, int approx_gelu) {
  constexpr int N = NPT * NCH;
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [KC][BM]     x step, transposed
  float* us = xs + KC * BM;          // [FC][KC + 1] W_up step
  float* hs = us + FC * (KC + 1);    // [FC][BM]     h chunk, transposed
  float* ds = hs + FC * BM;          // [FC][NCH + 1] W_down step, transposed

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  // phase A ownership: rows 8*ah .. 8*ah+7, h columns af and af + 128
  const int ah = tid / 128, af = tid % 128;
  // phase B ownership: rows 8*bh .. 8*bh+7, output columns bn + 128 * j
  const int bh = tid / 128, bn = tid % 128;

  float acc[8][NPT];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < NPT; ++j) acc[r][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += FC) {
    // ---- phase A: h = gelu(x . W_up[f0:f0+FC]^T + b_up) --------------------
    float ha[8][2];
#pragma unroll
    for (int r = 0; r < 8; ++r) ha[r][0] = ha[r][1] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KC) {
      __syncthreads();  // the previous step's tiles (and phase B's hs) are consumed
      for (int idx = tid; idx < BM * KC; idx += THREADS) {
        const int m = idx % BM, kk = idx / BM;  // consecutive threads, consecutive shared words
        const int row = m0 + m, col = k0 + kk;
        xs[kk * BM + m] = (row < M && col < K) ? to_f(x[(size_t)row * K + col]) : 0.f;
      }
      for (int idx = tid; idx < FC * KC; idx += THREADS) {
        const int f = idx / KC, kk = idx % KC;
        const int fr = f0 + f, col = k0 + kk;
        us[f * (KC + 1) + kk] = (fr < F && col < K) ? to_f(w_up[(size_t)fr * K + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        const float4 xa = *reinterpret_cast<const float4*>(xs + kk * BM + 8 * ah);
        const float4 xb = *reinterpret_cast<const float4*>(xs + kk * BM + 8 * ah + 4);
        const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const float u0 = us[af * (KC + 1) + kk];
        const float u1 = us[(af + 128) * (KC + 1) + kk];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          ha[r][0] = fmaf(xv[r], u0, ha[r][0]);
          ha[r][1] = fmaf(xv[r], u1, ha[r][1]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int f = af + 128 * c;
      const float bu = f0 + f < F ? b_up[f0 + f] : 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float z = ha[r][c] + bu;
        float gz;
        if (approx_gelu) {
          const float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
          gz = 0.5f * z * (1.f + tanhf(u));
        } else {
          gz = 0.5f * z * (1.f + erff(z * 0.7071067811865476f));
        }
        // columns past F contribute nothing (their W_down columns read as 0)
        hs[f * BM + 8 * ah + r] = BF16 ? round_bf16(gz) : gz;
      }
    }

    // ---- phase B: acc += h . W_down[:, f0:f0+FC]^T ---------------------------
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      __syncthreads();  // hs is written; the previous W_down step is consumed
      for (int idx = tid; idx < NCH * FC; idx += THREADS) {
        const int nn = idx / FC, f = idx % FC;
        const int fr = f0 + f;
        ds[f * (NCH + 1) + nn] = fr < F ? to_f(w_down[(size_t)(j * NCH + nn) * F + fr]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int f = 0; f < FC; ++f) {
        const float4 ha4 = *reinterpret_cast<const float4*>(hs + f * BM + 8 * bh);
        const float4 hb4 = *reinterpret_cast<const float4*>(hs + f * BM + 8 * bh + 4);
        const float hv[8] = {ha4.x, ha4.y, ha4.z, ha4.w, hb4.x, hb4.y, hb4.z, hb4.w};
        const float wv = ds[f * (NCH + 1) + bn];
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r][j] = fmaf(hv[r], wv, acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = m0 + 8 * bh + r;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int n = j * NCH + bn;
      store(out + (size_t)row * N + n, acc[r][j] + b_down[n]);
    }
  }
}

template <typename T, int NPT>
int launch_n(const void* x, const void* w_up, const void* b_up, const void* w_down,
             const void* b_down, void* out, int M, int K, int F, int approx_gelu, void* stream) {
  const size_t smem = (size_t)(KC * BM + FC * (KC + 1) + FC * BM + FC * (NCH + 1)) * sizeof(float);
  auto kern = ffn_fused_kernel<T, NPT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(M + BM - 1) / BM, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w_up, (const float*)b_up, (const T*)w_down, (const float*)b_down,
      (T*)out, M, K, F, approx_gelu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w_up, const void* b_up, const void* w_down,
           const void* b_down, void* out, int M, int K, int F, int N, int approx_gelu,
           void* stream) {
  if (M < 1 || K < 1 || F < 1) return (int)cudaErrorInvalidValue;
  switch (N) {  // the zoo's widths: base, large, XL, XLS-R-2B
    case 768: return launch_n<T, 6>(x, w_up, b_up, w_down, b_down, out, M, K, F, approx_gelu, stream);
    case 1024: return launch_n<T, 8>(x, w_up, b_up, w_down, b_down, out, M, K, F, approx_gelu, stream);
    case 1280: return launch_n<T, 10>(x, w_up, b_up, w_down, b_down, out, M, K, F, approx_gelu, stream);
    case 1920: return launch_n<T, 15>(x, w_up, b_up, w_down, b_down, out, M, K, F, approx_gelu, stream);
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
  return launch<__nv_bfloat16>(x, w_up, b_up, w_down, b_down, out, M, K, F, N, approx_gelu, stream);
}
