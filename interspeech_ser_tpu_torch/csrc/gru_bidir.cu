// K3: masked bidirectional GRU recurrence, forward.
//
// Replaces interspeech_ser_tpu/ops/pallas/gru_kernel.py
// (gru_bidir_carries -> _bidir_carries_impl -> _kernel_bidir), the
// fusion classifier's BiGRU at eval.
//
// Rows [0, half) are the forward direction, rows [half, 2*half) the
// backward direction with their inputs already reversed in time. Per step,
// with torch's gate order and b_hn inside the reset product:
//   hp = h . w_hh[d] + b_hh[d]                 (w_hh[d]: [H, 3H], row-major)
//   r = sigmoid(xr + hr); z = sigmoid(xz + hz); n = tanh(xn + r * hn)
//   h_new = (1 - z) * n + z * h;  h = m * h_new + (1 - m) * h  (frozen when m = 0)
// and the kernel writes the unmasked carry h for every step; the wrapper
// multiplies by the mask, as the TPU kernel's wrapper does.
//
// What bounds it on an H100: the recurrence is serial in T, and every step
// needs all of w_hh[d] (3 MB in f32 at H=512; 6.3 MB for both directions).
// That does not fit the 227 KB of shared memory, but it stays in the 50 MB
// L2. The design is the simple right one: one block per row (rows are
// independent, so there is no grid-wide synchronisation), looping over T;
// thread j owns hidden units j, j+blockDim, ... and computes the three dot
// products of h (in shared memory, a broadcast read) with columns j, H+j and
// 2H+j of w_hh, so neighbouring threads read neighbouring columns
// (coalesced). Every block rereads its direction's w_hh from L2 at every
// step, so the kernel is bound by L2 bandwidth per SM and by the serial
// latency of the two block barriers per step. Several rows per block (one
// w_hh read shared by a whole direction), clusters, or w_hh kept in
// registers across a persistent grid are later work.
//
// K9: one direction of the same masked GRU, with a `reverse` flag.
//
// Replaces interspeech_ser_tpu/ops/pallas/gru_kernel.py (gru_sequence ->
// _kernel). Rows are independent sequences; with reverse = 1 the step
// order runs from T-1 down to 0, which is the TPU kernel's flip of the
// inputs, forward run and flip of the outputs in one pass. The kernel
// writes h * m for every step (0 at a masked step, where the carry is
// frozen), as the TPU kernel does. It is K3's one-block-per-row recurrence
// with w_hh shared by every row, and is bound the same way.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

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
                                 const void* mask, void* out, int B2, int T, int H,
                                 int threads, void* stream) {
  if (B2 % 2 != 0 || threads < 32 || threads > 1024 || H > 4 * threads)
    return (int)cudaErrorInvalidValue;
  gru_bidir_kernel<<<B2, threads, H * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)x_proj, (const float*)w_hh2, (const float*)b_hh2, (const float*)mask,
      (float*)out, B2 / 2, T, H);
  return (int)cudaGetLastError();
}

extern "C" int ser_gru_sequence_f32(const void* x_proj, const void* w_hh, const void* b_hh,
                                    const void* mask, void* out, int B, int T, int H, int reverse,
                                    int threads, void* stream) {
  if (threads < 32 || threads > 1024 || H > 4 * threads) return (int)cudaErrorInvalidValue;
  gru_sequence_kernel<<<B, threads, H * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)x_proj, (const float*)w_hh, (const float*)b_hh, (const float*)mask,
      (float*)out, T, H, reverse);
  return (int)cudaGetLastError();
}
