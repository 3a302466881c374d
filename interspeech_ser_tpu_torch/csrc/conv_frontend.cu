// K2: conv0 + bias + LayerNorm(channels) + GELU of the waveform frontend,
// fused straight from the waveform.
//
// Replaces interspeech_ser_tpu/ops/pallas/conv_frontend.py
// (fused_conv_frontend -> _kernel) at depth 1, the inference default for
// layer-norm models (WavLM-large: C_in=1, k=10, s=5, 512 channels).
//
//   y[c]  = sum_t round(w[c, t]) * round(wav[f*s + t]) (+ bias[c])   (f32 accumulate)
//   yn[c] = (y[c] - mean) * rsqrt(max(E[y^2] - mean^2, 0) + eps) * ln_w[c] + ln_b[c]
//   out   = gelu(round(yn))     exact erf GELU, or the tanh form
// where round() is the compute dtype (identity in f32, bf16 in bf16 mode).
//
// What bounds it on an H100: each output value costs k=10 FMAs and a share
// of one LayerNorm, while the [B, ~32k, 512] layer-0 activation is the
// largest tensor of the whole encoder (262 MB in bf16 at B=8, 10 s). So the
// kernel is bound by the single write of that output to device memory. The
// design writes it exactly once, in the compute dtype, with no [B, T, 512]
// f32 intermediate and no second pass for the norm: one warp owns one
// frame, each lane holds C/32 channels in registers, and the LayerNorm's two
// sums (sum y, sum y^2) are warp-shuffle reductions with no block barrier.
// The conv weights (20 KB) live in shared memory; the 10 waveform samples
// of a frame are one broadcast load per tap. The TPU kernel's time-tile
// geometry (it recomputed deeper layers from the waveform per tile) is not
// needed at depth 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr int FRAMES_PER_BLOCK = 256;
constexpr int MAX_K = 16;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// CPL: channels per lane (C = 32 * CPL)
template <typename T, int CPL>
__global__ void __launch_bounds__(WARPS * 32) conv_frontend_kernel(
    const float* __restrict__ wav,     // [B, L]
    const float* __restrict__ weight,  // [C, k]
    const float* __restrict__ bias,    // [C] or null
    const float* __restrict__ ln_w,    // [C]
    const float* __restrict__ ln_b,    // [C]
    T* __restrict__ out,               // [B, T0, C]
    int L, int T0, int ksize, int stride, float eps, int approx_gelu) {
  constexpr int C = 32 * CPL;
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ float smem[];
  float* w_s = smem;               // [k][C], rounded to the compute dtype
  float* b_s = w_s + MAX_K * C;    // [C]
  float* lw_s = b_s + C;           // [C]
  float* lb_s = lw_s + C;          // [C]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  for (int i = tid; i < ksize * C; i += blockDim.x) {
    const int c = i % C, t = i / C;
    const float wv = weight[c * ksize + t];
    w_s[t * C + c] = BF16 ? round_bf16(wv) : wv;
  }
  for (int c = tid; c < C; c += blockDim.x) {
    b_s[c] = bias != nullptr ? bias[c] : 0.f;
    lw_s[c] = ln_w[c];
    lb_s[c] = ln_b[c];
  }
  __syncthreads();

  const float* x = wav + (size_t)b * L;
  const int f_begin = blockIdx.x * FRAMES_PER_BLOCK;
  const int f_end = min(f_begin + FRAMES_PER_BLOCK, T0);
  const float inv_c = 1.f / (float)C;
  for (int f = f_begin + warp; f < f_end; f += WARPS) {
    float y[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) y[i] = b_s[lane + 32 * i];  // bias added in f32
    const float* xs = x + (size_t)f * stride;
    for (int t = 0; t < ksize; ++t) {
      const float xv = BF16 ? round_bf16(xs[t]) : xs[t];
#pragma unroll
      for (int i = 0; i < CPL; ++i) y[i] = fmaf(w_s[t * C + lane + 32 * i], xv, y[i]);
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      s1 += y[i];
      s2 = fmaf(y[i], y[i], s2);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mean = s1 * inv_c;
    const float var = fmaxf(s2 * inv_c - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    T* orow = out + ((size_t)b * T0 + f) * C;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      float z = (y[i] - mean) * rstd * lw_s[c] + lb_s[c];
      if (BF16) z = round_bf16(z);
      float gz;
      if (approx_gelu) {
        const float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
        gz = 0.5f * z * (1.f + tanhf(u));
      } else {
        gz = 0.5f * z * (1.f + erff(z * 0.7071067811865476f));
      }
      store(orow + c, gz);
    }
  }
}

template <typename T>
int launch(const void* wav, const void* weight, const void* bias, const void* ln_w,
           const void* ln_b, void* out, int B, int L, int T0, int channels, int ksize,
           int stride, float eps, int approx_gelu, void* stream) {
  constexpr int CPL = 16, C = 32 * CPL;  // 512 channels: every layer-norm frontend of the zoo
  if (ksize < 1 || ksize > MAX_K || channels != C) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(MAX_K * C + 3 * C) * sizeof(float);
  auto kern = conv_frontend_kernel<T, CPL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T0 + FRAMES_PER_BLOCK - 1) / FRAMES_PER_BLOCK, B);
  kern<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const float*)wav, (const float*)weight, (const float*)bias, (const float*)ln_w,
      (const float*)ln_b, (T*)out, L, T0, ksize, stride, eps, approx_gelu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ser_conv_frontend_f32(const void* wav, const void* weight, const void* bias,
                                     const void* ln_w, const void* ln_b, void* out, int B,
                                     int L, int T0, int C, int ksize, int stride, float eps,
                                     int approx_gelu, void* stream) {
  return launch<float>(wav, weight, bias, ln_w, ln_b, out, B, L, T0, C, ksize, stride, eps,
                       approx_gelu, stream);
}

extern "C" int ser_conv_frontend_bf16(const void* wav, const void* weight, const void* bias,
                                      const void* ln_w, const void* ln_b, void* out, int B,
                                      int L, int T0, int C, int ksize, int stride, float eps,
                                      int approx_gelu, void* stream) {
  return launch<__nv_bfloat16>(wav, weight, bias, ln_w, ln_b, out, B, L, T0, C, ksize, stride,
                               eps, approx_gelu, stream);
}
