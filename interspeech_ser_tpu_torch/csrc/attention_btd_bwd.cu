// K4: the backward of K1 (masked SDPA on [B, T, D] panels with a factored
// gated bias), with P recomputed from q and k.
//
// Replaces interspeech_ser_tpu/ops/pallas/attention_bwd.py
// (attention_btd_bwd -> _bwd_kernel and its no-bias variant).
//
// Per head h (columns h*64 .. h*64+63 of D), with S = scale*q.k^T +
// gate[b,h,q]*bias[h,q,k] over live keys and P = softmax(S):
//   dV = P^T g          (P rounded to the compute dtype first)
//   dP = g V^T,  dS = P * (dP - delta),  delta = rowsum(g * out)
//   dQ = scale * dS K,  dK = scale * dS^T Q   (dS rounded to the compute dtype)
//   dgate[b,h,q] = sum_k dS * bias            (f32)
//   dbias[h,q,k] = sum_b gate[b,h,q] * dS     (f32)
// delta stands in for the TPU kernel's rowsum(P * dP): the two are equal,
// since rowsum(P * (g V^T)) = g . (P V) = g . out.
//
// What bounds it on an H100: the TPU kernel held whole [Tq, Tk] score tiles
// per head in VMEM; at Tk = 1500 one such tile is 9 MB in f32, forty times
// the 227 KB of shared memory a block may use. Here nothing of size Tq x Tk
// is ever stored (except dbias's per-batch terms, below): K1 writes each
// row's log-sum-exp, and every pass recomputes P = exp(S - lse) tile by tile.
// Four launches:
//   1. delta: one warp per (b, q, h) row, rowsum(g * out) in f32.
//   2. dK, dV (key-major): one block of 128 threads owns (b, h, 64 keys);
//      two neighbouring threads share a key, each holding one half of the
//      head dim of its k and v rows and of the dK, dV accumulators in
//      registers (128 floats a thread), and stream tiles of 32 queries whose
//      q and g halves they read as shared-memory broadcasts; one shuffle
//      completes each 64-wide dot product.
//   3. dQ, dgate (query-major): the same split over (b, h, 64 queries), with
//      q, g and the dQ accumulator in registers, streaming tiles of 32 keys.
//      When dbias is wanted it writes gate * dS for its batch row to a
//      [B, H, Tq, Tk] f32 scratch (coalesced, through shared memory).
//   4. dbias: the scratch summed over b in order 0..B-1.
// Every output is summed by one thread in one fixed order, with no atomics,
// so a rerun is bit-identical. All arithmetic runs on the FP32 pipes (no
// tensor cores yet): the kernel is bound by FP32 issue and shared-memory
// bandwidth, not by device memory (q, k, v, g are read a few times, from
// L2). Splitting each row over two threads halves the live floats a thread
// holds (128 instead of 192, which spilled) and feeds every FMA from a
// broadcast float4. wgmma and TMA are later work.
//
// Scores use scale * (q . k) as the TPU kernel's backward does; K1 rounds
// q * scale to the compute dtype first. For a power-of-two scale (head dim
// 64 gives 1/8) the two are the same number, so P here is K1's P.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HD = 64;    // head dim: WavLM-large, the base encoders, Whisper (not HuBERT-XL's
                          // 80 or XLS-R-2B's 120, which K1 serves and this kernel does not yet)
constexpr int HH = HD / 2;  // each of a row's two threads owns one half of the head dim
constexpr int SP = HD + 8;  // padded shared row: half 1 starts 4 words after half 0 ends
constexpr int ROWS = 64;    // keys (key-major) or queries (query-major) per block
constexpr int THREADS = 2 * ROWS;
constexpr int TILE = 32;    // queries (key-major) or keys (query-major) per streamed tile

// shared-row index of head-dim column c: the two halves sit in different
// banks, so a pair's threads read their halves in one broadcast each
__device__ __forceinline__ int hpad(int c) { return c + ((c / HH) << 2); }

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

// the full 64-wide dot product of a row whose halves two neighbouring lanes hold
__device__ __forceinline__ float dot_pair(const float* r, const float* __restrict__ s) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
  float acc = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < HH / 4; ++d4) {
    const float4 x = s4[d4];
    acc = fmaf(r[4 * d4 + 0], x.x, acc);
    acc = fmaf(r[4 * d4 + 1], x.y, acc);
    acc = fmaf(r[4 * d4 + 2], x.z, acc);
    acc = fmaf(r[4 * d4 + 3], x.w, acc);
  }
  return acc + __shfl_xor_sync(0xffffffffu, acc, 1);
}

__device__ __forceinline__ void axpy_half(float a, const float* __restrict__ s, float* acc) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
  for (int d4 = 0; d4 < HH / 4; ++d4) {
    const float4 x = s4[d4];
    acc[4 * d4 + 0] = fmaf(a, x.x, acc[4 * d4 + 0]);
    acc[4 * d4 + 1] = fmaf(a, x.y, acc[4 * d4 + 1]);
    acc[4 * d4 + 2] = fmaf(a, x.z, acc[4 * d4 + 2]);
    acc[4 * d4 + 3] = fmaf(a, x.w, acc[4 * d4 + 3]);
  }
}

// 1. delta[b, h, q] = sum_d g[b, q, h*64 + d] * out[b, q, h*64 + d]
template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(const T* __restrict__ g, const T* __restrict__ out,
                                                    float* __restrict__ delta, int B, int Tq, int H) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);  // (b*Tq + q)*H + h
  const int lane = threadIdx.x & 31;
  if (row >= B * Tq * H) return;  // whole warps leave together
  const size_t base = (size_t)row * HD;
  float s = to_f(g[base + lane]) * to_f(out[base + lane]) +
            to_f(g[base + lane + 32]) * to_f(out[base + lane + 32]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) {
    const int h = row % H, bq = row / H;
    const int q = bq % Tq, b = bq / Tq;
    delta[((size_t)b * H + h) * Tq + q] = s;
  }
}

// 2. dK, dV: block (b, h, 64 keys); threads 2j and 2j+1 own key j's halves
template <typename T>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ key_mask,
    const float* __restrict__ gate, const T* __restrict__ bias,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int H, float scale) {
  __shared__ __align__(16) float qs[TILE][SP];
  __shared__ __align__(16) float gs[TILE][SP];
  __shared__ float lse_s[TILE], delta_s[TILE], gate_s[TILE];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int k0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * HD;
  const int kj = k0 + (tid >> 1);
  const bool key_ok = kj < Tk && (key_mask == nullptr || key_mask[(size_t)b * Tk + kj] > 0.f);

  float kr[HH], vr[HH], dk_acc[HH], dv_acc[HH];
  {
    const size_t off = ((size_t)b * Tk + (kj < Tk ? kj : 0)) * D + h * HD + half * HH;
#pragma unroll
    for (int d = 0; d < HH; ++d) {
      kr[d] = kj < Tk ? to_f(k[off + d]) : 0.f;
      vr[d] = kj < Tk ? to_f(v[off + d]) : 0.f;
      dk_acc[d] = 0.f;
      dv_acc[d] = 0.f;
    }
  }

  for (int q0 = 0; q0 < Tq; q0 += TILE) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < TILE * HD; idx += THREADS) {
      const int r = idx / HD, c = idx % HD;
      const int qi = q0 + r;
      const size_t off = ((size_t)b * Tq + qi) * D + h * HD + c;
      qs[r][hpad(c)] = qi < Tq ? to_f(q[off]) : 0.f;
      gs[r][hpad(c)] = qi < Tq ? to_f(g[off]) : 0.f;
    }
    if (tid < TILE) {
      const int qi = q0 + tid;
      const bool ok = qi < Tq;
      const size_t row = ((size_t)b * H + h) * Tq + qi;
      lse_s[tid] = ok ? lse[row] : -INFINITY;
      delta_s[tid] = ok ? delta[row] : 0.f;
      gate_s[tid] = (ok && bias != nullptr) ? (gate != nullptr ? gate[row] : 1.f) : 0.f;
    }
    __syncthreads();
    const int nq = min(TILE, Tq - q0);
    for (int i = 0; i < nq; ++i) {
      const float L = lse_s[i];
      if (L == -INFINITY) continue;  // a query whose keys are all masked: P = 0 (same i for all threads)
      const float* qrow = &qs[i][half * (HH + 4)];
      const float* grow = &gs[i][half * (HH + 4)];
      float s = dot_pair(kr, qrow) * scale;  // every lane shuffles: masked keys are computed, then zeroed
      if (bias != nullptr && kj < Tk) s += gate_s[i] * to_f(bias[((size_t)h * Tq + q0 + i) * Tk + kj]);
      const float p = key_ok ? expf(s - L) : 0.f;
      const float dp = dot_pair(vr, grow);
      const float ds = p * (dp - delta_s[i]);
      axpy_half(round_to<T>(p), grow, dv_acc);
      axpy_half(round_to<T>(ds), qrow, dk_acc);
    }
  }

  if (kj < Tk) {
    const size_t off = ((size_t)b * Tk + kj) * D + h * HD + half * HH;
#pragma unroll
    for (int d = 0; d < HH; ++d) {
      dk[off + d] = from_f<T>(dk_acc[d] * scale);
      dv[off + d] = from_f<T>(dv_acc[d]);
    }
  }
}

// 3. dQ, dgate (and dbias's per-batch terms): block (b, h, 64 queries);
//    threads 2i and 2i+1 own query i's halves
template <typename T>
__global__ void __launch_bounds__(THREADS) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ key_mask,
    const float* __restrict__ gate, const T* __restrict__ bias,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, float* __restrict__ dgate, float* __restrict__ dbias_part,
    int Tq, int Tk, int H, float scale) {
  __shared__ __align__(16) float ks[TILE][SP];
  __shared__ __align__(16) float vs[TILE][SP];
  __shared__ float bs[ROWS][TILE + 1];  // bias tile, then gate * dS for dbias
  __shared__ float valid[TILE];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int r = tid >> 1;
  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * HD;
  const int qi = q0 + r;
  const bool row_ok = qi < Tq;
  const size_t hrow = ((size_t)b * H + h) * Tq + (row_ok ? qi : 0);

  float qr[HH], gr[HH], dq_acc[HH];
  {
    const size_t off = ((size_t)b * Tq + (row_ok ? qi : 0)) * D + h * HD + half * HH;
#pragma unroll
    for (int d = 0; d < HH; ++d) {
      qr[d] = row_ok ? to_f(q[off + d]) : 0.f;
      gr[d] = row_ok ? to_f(g[off + d]) : 0.f;
      dq_acc[d] = 0.f;
    }
  }
  const float L = row_ok ? lse[hrow] : -INFINITY;
  const float dlt = row_ok ? delta[hrow] : 0.f;
  const float gt = (row_ok && bias != nullptr) ? (gate != nullptr ? gate[hrow] : 1.f) : 0.f;
  const bool live = row_ok && L != -INFINITY;
  float dgate_acc = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += TILE) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < TILE * HD; idx += THREADS) {
      const int rr = idx / HD, c = idx % HD;
      const int kk = k0 + rr;
      const size_t off = ((size_t)b * Tk + kk) * D + h * HD + c;
      ks[rr][hpad(c)] = kk < Tk ? to_f(k[off]) : 0.f;
      vs[rr][hpad(c)] = kk < Tk ? to_f(v[off]) : 0.f;
    }
    if (bias != nullptr) {
      for (int idx = tid; idx < ROWS * TILE; idx += THREADS) {
        const int rr = idx / TILE, c = idx % TILE;
        const int qq = q0 + rr, kk = k0 + c;
        bs[rr][c] = (qq < Tq && kk < Tk) ? to_f(bias[((size_t)h * Tq + qq) * Tk + kk]) : 0.f;
      }
    }
    if (tid < TILE) {
      const int kk = k0 + tid;
      valid[tid] = (kk < Tk && (key_mask == nullptr || key_mask[(size_t)b * Tk + kk] > 0.f)) ? 1.f : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < TILE; ++j) {
      float ds = 0.f;
      if (valid[j] > 0.f) {  // the same j for all threads: the shuffles stay whole-warp
        const float bij = bias != nullptr ? bs[r][j] : 0.f;  // read before the shuffles below
        const float s = dot_pair(qr, &ks[j][half * (HH + 4)]) * scale + gt * bij;
        const float p = live ? expf(s - L) : 0.f;
        const float dp = dot_pair(gr, &vs[j][half * (HH + 4)]);
        ds = p * (dp - dlt);
        dgate_acc = fmaf(ds, bij, dgate_acc);
        axpy_half(round_to<T>(ds), &ks[j][half * (HH + 4)], dq_acc);
      }
      if (dbias_part != nullptr && half == 0) bs[r][j] = gt * ds;  // after both threads' reads (shuffle above)
    }
    if (dbias_part != nullptr) {
      __syncthreads();
      for (int idx = tid; idx < ROWS * TILE; idx += THREADS) {  // coalesced along keys
        const int rr = idx / TILE, c = idx % TILE;
        const int qq = q0 + rr, kk = k0 + c;
        if (qq < Tq && kk < Tk) dbias_part[(((size_t)b * H + h) * Tq + qq) * Tk + kk] = bs[rr][c];
      }
    }
  }

  if (row_ok) {
    const size_t off = ((size_t)b * Tq + qi) * D + h * HD + half * HH;
#pragma unroll
    for (int d = 0; d < HH; ++d) dq[off + d] = from_f<T>(dq_acc[d] * scale);
    if (dgate != nullptr && half == 0) dgate[hrow] = dgate_acc;
  }
}

// 4. dbias[i] = sum_b part[b][i], b in order
__global__ void __launch_bounds__(256) dbias_reduce_kernel(const float* __restrict__ part,
                                                           float* __restrict__ dbias, int B,
                                                           size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += part[(size_t)b * n + i];
    dbias[i] = s;
  }
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, const void* out,
               const void* key_mask, const void* gate, const void* bias, const void* lse,
               void* delta, void* dbias_part, void* dq, void* dk, void* dv, void* dgate,
               void* dbias, int B, int Tq, int Tk, int H, int hd, float scale, void* stream) {
  if (hd != HD) return (int)cudaErrorInvalidValue;
  if ((dbias != nullptr) != (dbias_part != nullptr)) return (int)cudaErrorInvalidValue;
  if ((dgate != nullptr || dbias != nullptr) && bias == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)B * Tq * H;
  delta_kernel<T><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, st>>>(
      (const T*)g, (const T*)out, (float*)delta, B, Tq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<T><<<dim3((Tk + ROWS - 1) / ROWS, H, B), THREADS, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, (const float*)key_mask,
      (const float*)gate, (const T*)bias, (const float*)lse, (const float*)delta, (T*)dk,
      (T*)dv, Tq, Tk, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T><<<dim3((Tq + ROWS - 1) / ROWS, H, B), THREADS, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, (const float*)key_mask,
      (const float*)gate, (const T*)bias, (const float*)lse, (const float*)delta, (T*)dq,
      (float*)dgate, (float*)dbias_part, Tq, Tk, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dbias != nullptr) {
    const size_t n = (size_t)H * Tq * Tk;
    const size_t blocks = (n + 255) / 256;
    dbias_reduce_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, st>>>(
        (const float*)dbias_part, (float*)dbias, B, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, g, out, key_mask, gate, bias, lse, delta scratch [B,H,Tq] f32,
// dbias scratch [B,H,Tq,Tk] f32 (null unless dbias), dq, dk, dv, dgate
// [B,H,Tq] f32 (or null), dbias [H,Tq,Tk] f32 (or null), B, Tq, Tk, H, hd,
// scale, stream
extern "C" int ser_attention_btd_bwd_f32(
    const void* q, const void* k, const void* v, const void* g, const void* out,
    const void* key_mask, const void* gate, const void* bias, const void* lse, void* delta,
    void* dbias_part, void* dq, void* dk, void* dv, void* dgate, void* dbias, int B, int Tq,
    int Tk, int H, int hd, float scale, void* stream) {
  return launch_bwd<float>(q, k, v, g, out, key_mask, gate, bias, lse, delta, dbias_part, dq,
                           dk, dv, dgate, dbias, B, Tq, Tk, H, hd, scale, stream);
}

extern "C" int ser_attention_btd_bwd_bf16(
    const void* q, const void* k, const void* v, const void* g, const void* out,
    const void* key_mask, const void* gate, const void* bias, const void* lse, void* delta,
    void* dbias_part, void* dq, void* dk, void* dv, void* dgate, void* dbias, int B, int Tq,
    int Tk, int H, int hd, float scale, void* stream) {
  return launch_bwd<__nv_bfloat16>(q, k, v, g, out, key_mask, gate, bias, lse, delta,
                                   dbias_part, dq, dk, dv, dgate, dbias, B, Tq, Tk, H, hd,
                                   scale, stream);
}
