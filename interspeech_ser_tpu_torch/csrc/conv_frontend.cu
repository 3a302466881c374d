// K2: the waveform frontend's first n layers (n = 1..7), each
// conv + bias + LayerNorm(channels) + GELU, from the waveform.
//
// Replaces interspeech_ser_tpu/ops/pallas/conv_frontend.py
// (fused_conv_frontend -> _kernel) at every depth of the layer-norm
// frontends (WavLM-large, wav2vec2-XLS-R-2B, HuBERT-XL: C_in=1, k=10, s=5,
// then 512 -> 512 channels with k = 3,3,3,3,2,2 and s = 2).
//
// Layer 0, straight from the waveform:
//   y[c]  = sum_t round(w[c, t]) * round(wav[f*s + t]) (+ bias[c])   (f32 accumulate)
//   yn[c] = (y[c] - mean) * rsqrt(max(E[y^2] - mean^2, 0) + eps) * ln_w[c] + ln_b[c]
//   out   = gelu(round(yn))     exact erf GELU, or the tanh form
// Layers 1..n-1, on the previous layer's output x (compute dtype):
//   y[t, c] = sum_{tap < k} sum_{i < 512} round(w[tap, i, c]) * x[s*t + tap, i]  (+ bias[c])
// then the same LayerNorm, rounding and GELU; round() is the compute dtype
// (identity in f32, bf16 in bf16 mode).
//
// What bounds it on an H100. Layer 0: each output value costs k=10 FMAs and
// a share of one LayerNorm, while the [B, ~32k, 512] layer-0 activation is
// the largest tensor of the whole encoder (262 MB in bf16 at B=8, 10 s). So
// layer 0 is bound by the single write of that output to device memory.
// Its kernel writes it exactly once, in the compute dtype, with no
// [B, T, 512] f32 intermediate and no second pass for the norm: one warp
// owns one frame, each lane holds C/32 channels in registers, and the
// LayerNorm's two sums (sum y, sum y^2) are warp-shuffle reductions with no
// block barrier. The conv weights (20 KB) live in shared memory; the 10
// waveform samples of a frame are one broadcast load per tap.
//
// Layers 1-6 are the other way round: 48 GFLOP per 10-s utterance of
// 512 x 512 tap products against about 67 MB of activations, so they are
// bound by operations. The TPU kernel recomputed every output tile from the
// waveform to keep the deeper activations out of HBM (each fused layer
// widens its input tile to s*(n-1)+k frames), which on this card would
// cost more than it saves: a tile of 8 final frames needs 527 layer-0
// frames in flight (1 MB of f32, four times a block's 227 KB), and a
// smaller tile recomputes up to a quarter of the layer-0 and layer-1 work.
// Here the deeper layers go through a global scratch instead: each later
// layer is one launch that reads the previous layer's output once (in the
// compute dtype, so the whole chain's round trip is ~1% of its operations'
// time at HBM speed) and writes its own output once, with the bias,
// LayerNorm, rounding and GELU fused into the product's epilogue: no f32
// intermediate, no transposes, no separate norm pass. That layer kernel is
// an implicit-im2col product: output frame t's input window is the k*512
// contiguous values starting at frame s*t. One block owns 32 frames and all
// 512 channels; each warp owns 4 frames, each lane 16 channels (64 f32
// accumulators), and the reduction walks k*512 in steps of 32 staged in
// shared memory. Every frame's 512 channels sit in one warp, so the
// LayerNorm's sums are warp shuffles again. FP32 pipes only; tensor cores
// are later work.

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


// ---- layers 1..n-1 --------------------------------------------------------

constexpr int LC = 512;          // channels in and out of every later layer
constexpr int LBM = 32;          // frames per block
constexpr int LKC = 32;          // reduction step
constexpr int LTHREADS = 256;    // 8 warps x 4 frames

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(LTHREADS) conv_layer_kernel(
    const T* __restrict__ x,           // [B, T_in, 512] previous layer's output
    const float* __restrict__ weight,  // [k * 512, 512]: row tap*512 + i, column c
    const float* __restrict__ bias,    // [512] or null
    const float* __restrict__ ln_w,    // [512]
    const float* __restrict__ ln_b,    // [512]
    T* __restrict__ out,               // [B, T_out, 512]
    int T_in, int T_out, int ksize, int stride, float eps, int approx_gelu) {
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ __align__(16) float lsmem[];
  float (*bs)[LC] = reinterpret_cast<float (*)[LC]>(lsmem);                // [LKC][LC] weight rows
  float (*as)[LKC + 1] = reinterpret_cast<float (*)[LKC + 1]>(lsmem + LKC * LC);  // [LBM][LKC+1] windows

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * LBM;
  const int kdim = ksize * LC;
  const T* xb = x + (size_t)b * T_in * LC;

  float acc[4][16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += LKC) {
    __syncthreads();
    for (int idx = tid; idx < LBM * LKC; idx += LTHREADS) {
      const int r = idx / LKC, kk = idx % LKC;
      const int t = t0 + r;
      as[r][kk] = t < T_out ? to_f(xb[(size_t)t * stride * LC + k0 + kk]) : 0.f;
    }
    for (int idx = tid; idx < LKC * LC / 4; idx += LTHREADS) {
      const int kk = idx / (LC / 4), c4 = idx % (LC / 4);
      reinterpret_cast<float4*>(&bs[kk][0])[c4] =
          reinterpret_cast<const float4*>(weight + (size_t)(k0 + kk) * LC)[c4];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < LKC; ++kk) {
      float a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = as[4 * warp + r][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 w4 = reinterpret_cast<const float4*>(&bs[kk][0])[lane + 32 * j];
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][4 * j + e] = fmaf(a[r], wv[e], acc[r][4 * j + e]);
      }
    }
  }

  // epilogue: + bias, LayerNorm over the frame's 512 channels (one warp), round, GELU
  const float inv_c = 1.f / (float)LC;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 4 * (lane + 32 * (j / 4)) + (j % 4);
      const float y = acc[r][j] + (bias != nullptr ? bias[c] : 0.f);
      acc[r][j] = y;
      s1 += y;
      s2 = fmaf(y, y, s2);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const int t = t0 + 4 * warp + r;
    if (t >= T_out) continue;
    const float mean = s1 * inv_c;
    const float rstd = rsqrtf(fmaxf(s2 * inv_c - mean * mean, 0.f) + eps);
    T* orow = out + ((size_t)b * T_out + t) * LC;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 4 * (lane + 32 * (j / 4)) + (j % 4);
      float z = (acc[r][j] - mean) * rstd * ln_w[c] + ln_b[c];
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
int launch_layer(const void* x, const void* weight, const void* bias, const void* ln_w,
                 const void* ln_b, void* out, int B, int T_in, int T_out, int c_in, int channels,
                 int ksize, int stride, float eps, int approx_gelu, void* stream) {
  if (c_in != LC || channels != LC || ksize < 1 || stride < 1 || T_out < 1 ||
      (T_out - 1) * stride + ksize > T_in)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(LKC * LC + LBM * (LKC + 1)) * sizeof(float);
  auto kern = conv_layer_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_out + LBM - 1) / LBM, B);
  kern<<<grid, LTHREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)weight, (const float*)bias, (const float*)ln_w,
      (const float*)ln_b, (T*)out, T_in, T_out, ksize, stride, eps, approx_gelu);
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

extern "C" int ser_conv_layer_f32(const void* x, const void* weight, const void* bias,
                                  const void* ln_w, const void* ln_b, void* out, int B, int T_in,
                                  int T_out, int c_in, int C, int ksize, int stride, float eps,
                                  int approx_gelu, void* stream) {
  return launch_layer<float>(x, weight, bias, ln_w, ln_b, out, B, T_in, T_out, c_in, C, ksize,
                             stride, eps, approx_gelu, stream);
}

extern "C" int ser_conv_layer_bf16(const void* x, const void* weight, const void* bias,
                                   const void* ln_w, const void* ln_b, void* out, int B, int T_in,
                                   int T_out, int c_in, int C, int ksize, int stride, float eps,
                                   int approx_gelu, void* stream) {
  return launch_layer<__nv_bfloat16>(x, weight, bias, ln_w, ln_b, out, B, T_in, T_out, c_in, C,
                                     ksize, stride, eps, approx_gelu, stream);
}
