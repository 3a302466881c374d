// K1: masked SDPA on [B, T, D] projection panels with a factored gated bias.
//
// Replaces interspeech_ser_tpu/ops/pallas/flash_attention_short.py
// (attention_btd -> _kernel_btd and its no-bias / no-mask variants).
//
// Per head h (columns h*hd .. h*hd+hd-1 of D; hd = 64, 80 or 120):
//   out = softmax(scale*q . k^T + gate[b,h,q] * bias[h,q,k], masked keys) . v
// with f32 scores and softmax, q*scale rounded to the compute dtype, the
// bias already in the compute dtype (the wrapper casts it), P rounded to v's
// dtype before P.V with f32 accumulation, and the result divided by
// max(l, 1e-30).
//
// Head dims: 64 (WavLM-large, wav2vec2 / HuBERT / WavLM base, Whisper),
// 80 (HuBERT-XL, D=1280 over 16 heads) and 120 (wav2vec2-XLS-R-2B, D=1920
// over 16 heads). The TPU kernel served the odd widths by padding lanes to
// lcm(hd, 128); here hd is a template parameter.
//
// What bounds it on an H100: the TPU kernel held a whole [Tk, D] K/V panel
// in VMEM (about 4 MB at Tk=499, D=1024 in f32), far over the 227 KB of
// shared memory a block may use. This kernel instead streams K/V tiles of
// 64 keys with an online softmax (running max and denominator in f32), so
// it has no length limit. One block owns (b, h, 64 queries). At hd=64 each
// of its 64 threads owns one query row and keeps q and the accumulator in
// registers (128 floats). At hd=80 and 120 one row's q and accumulator
// would be 160 and 240 floats, over what a thread can hold without spilling,
// so P=2 neighbouring threads share a row: each owns hd/2 columns of q and
// of the accumulator, the two partial dot products meet in one xor-shuffle,
// and both keep the same running max and denominator. Threads read the K/V
// tile from shared memory as float4 broadcasts. Scores and P.V run on the
// FP32 pipes (no tensor cores yet), so at WavLM shapes the kernel is bound
// by shared-memory issue rate and FP32 throughput, not by device memory:
// q/k/v/out are read or written once, and the shared [H, Tq, Tk] bias
// (16 MB in f32 at T=499) stays in the 50 MB L2 across the batch. wgmma,
// TMA and warp specialisation are later work.
//
// Masked keys (key_mask == 0, or index >= Tk) get no weight at all: a tile
// whose keys are all masked leaves the running max, denominator and
// accumulator untouched, instead of adding exp(0) terms.
//
// With a non-null `lse` the kernel also writes each row's log-sum-exp
// m + log(l) ([B, H, Tq] f32; -inf for a row whose keys are all masked), so
// that K4 (attention_btd_bwd.cu) can recompute P = exp(s - lse) without a
// second pass over the keys. Inference passes null and writes nothing more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;  // queries per block
constexpr int BK = 64;  // keys per tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// HD: head dim; P: threads per query row (each owns HD / P columns)
template <typename T, int HD, int P>
__global__ void __launch_bounds__(BQ * P) attention_btd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ key_mask,  // [B, Tk] or null
    const float* __restrict__ gate,      // [B, H, Tq] or null (with bias)
    const T* __restrict__ bias,          // [H, Tq, Tk] or null
    T* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, int H, float scale) {
  constexpr int HP = HD / P;  // head-dim columns a thread owns
  constexpr int THREADS = BQ * P;
  static_assert(HP % 4 == 0, "a thread's columns are read as float4");
  __shared__ __align__(16) float kv[BK][HD];  // K tile, then V tile
  __shared__ float sc[BQ][BK + 1];            // bias tile, then scores
  __shared__ float valid[BK];

  const int tid = threadIdx.x;
  const int row = tid / P;        // query row within the block
  const int c0 = (tid % P) * HP;  // first head-dim column this thread owns
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * HD;
  const int qi = q0 + row;
  const bool row_ok = qi < Tq;

  // q * scale in the compute dtype (the scale itself is rounded first)
  const float sc_c = round_to<T>(scale);
  float qr[HP];
  {
    const T* qrow = q + ((size_t)b * Tq + (row_ok ? qi : 0)) * D + h * HD + c0;
#pragma unroll
    for (int d = 0; d < HP; ++d) qr[d] = row_ok ? round_to<T>(to_f(qrow[d]) * sc_c) : 0.f;
  }
  const float g = (bias != nullptr && row_ok) ? gate[((size_t)b * H + h) * Tq + qi] : 0.f;

  float acc[HP];
#pragma unroll
  for (int d = 0; d < HP; ++d) acc[d] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    // cooperative, coalesced tile loads: consecutive threads, consecutive columns
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int r = idx / HD, c = idx % HD;
      const int kj = k0 + r;
      kv[r][c] = kj < Tk ? to_f(k[((size_t)b * Tk + kj) * D + h * HD + c]) : 0.f;
    }
    if (bias != nullptr) {
      for (int idx = tid; idx < BQ * BK; idx += THREADS) {
        const int r = idx / BK, c = idx % BK;
        const int qq = q0 + r, kj = k0 + c;
        sc[r][c] = (qq < Tq && kj < Tk) ? to_f(bias[((size_t)h * Tq + qq) * Tk + kj]) : 0.f;
      }
    }
    for (int j = tid; j < BK; j += THREADS) {
      const int kj = k0 + j;
      valid[j] = (kj < Tk && (key_mask == nullptr || key_mask[(size_t)b * Tk + kj] > 0.f)) ? 1.f : 0.f;
    }
    __syncthreads();

    float tmax = -INFINITY;
    for (int j = 0; j < BK; ++j) {
      const float bj = bias != nullptr ? sc[row][j] : 0.f;  // read before sc[row][j] is overwritten
      const float4* krow = reinterpret_cast<const float4*>(&kv[j][c0]);
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < HP / 4; ++d4) {
        const float4 kk = krow[d4];
        s = fmaf(qr[4 * d4 + 0], kk.x, s);
        s = fmaf(qr[4 * d4 + 1], kk.y, s);
        s = fmaf(qr[4 * d4 + 2], kk.z, s);
        s = fmaf(qr[4 * d4 + 3], kk.w, s);
      }
      if constexpr (P > 1) {
#pragma unroll
        for (int off = 1; off < P; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        __syncwarp();  // the row's other threads have read bj before it is overwritten
      }
      if (bias != nullptr) s += g * bj;
      s = valid[j] > 0.f ? s : -INFINITY;
      sc[row][j] = s;  // the row's P threads write the same value
      tmax = fmaxf(tmax, s);
    }
    __syncthreads();

    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int r = idx / HD, c = idx % HD;
      const int kj = k0 + r;
      kv[r][c] = kj < Tk ? to_f(v[((size_t)b * Tk + kj) * D + h * HD + c]) : 0.f;
    }
    __syncthreads();

    const float m_new = fmaxf(m, tmax);
    if (m_new != -INFINITY) {  // else: every key so far masked, nothing to add
      const float alpha = expf(m - m_new);  // exp(-inf) = 0 on the first live tile
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HP; ++d) acc[d] *= alpha;
      for (int j = 0; j < BK; ++j) {
        const float s = sc[row][j];
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        l += p;
        const float pr = round_to<T>(p);
        const float4* vrow = reinterpret_cast<const float4*>(&kv[j][c0]);
#pragma unroll
        for (int d4 = 0; d4 < HP / 4; ++d4) {
          const float4 vv = vrow[d4];
          acc[4 * d4 + 0] = fmaf(pr, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(pr, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(pr, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(pr, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
    __syncthreads();  // kv and sc are rewritten by the next tile
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = out + ((size_t)b * Tq + qi) * D + h * HD + c0;
#pragma unroll
    for (int d = 0; d < HP; ++d) orow[d] = from_f<T>(acc[d] * inv);
    if (lse != nullptr && c0 == 0) lse[((size_t)b * H + h) * Tq + qi] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

template <typename T, int HD, int P>
int launch_hd(const void* q, const void* k, const void* v, const void* key_mask,
              const void* gate, const void* bias, void* out, void* lse, int B, int Tq,
              int Tk, int H, float scale, void* stream) {
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  attention_btd_kernel<T, HD, P><<<grid, BQ * P, 0, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)key_mask,
      (const float*)gate, (const T*)bias, (T*)out, (float*)lse, Tq, Tk, H, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* key_mask,
           const void* gate, const void* bias, void* out, void* lse, int B, int Tq,
           int Tk, int H, int hd, float scale, void* stream) {
  switch (hd) {
    case 64:
      return launch_hd<T, 64, 1>(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, scale, stream);
    case 80:
      return launch_hd<T, 80, 2>(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, scale, stream);
    case 120:
      return launch_hd<T, 120, 2>(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* ser_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int ser_attention_btd_f32(const void* q, const void* k, const void* v,
                                     const void* key_mask, const void* gate,
                                     const void* bias, void* out, void* lse, int B,
                                     int Tq, int Tk, int H, int hd, float scale,
                                     void* stream) {
  return launch<float>(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, hd, scale,
                       stream);
}

extern "C" int ser_attention_btd_bf16(const void* q, const void* k, const void* v,
                                      const void* key_mask, const void* gate,
                                      const void* bias, void* out, void* lse, int B,
                                      int Tq, int Tk, int H, int hd, float scale,
                                      void* stream) {
  return launch<__nv_bfloat16>(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H,
                               hd, scale, stream);
}
