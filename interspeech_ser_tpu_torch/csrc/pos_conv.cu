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
// T=499), so it is bound by operations, not by device memory (x and y are
// read and written once). The TPU kernel held a group's whole padded time
// slab and all K of its [C, C] tap matrices in VMEM (7.4 MB of taps at
// C=120 in f32). Here a block owns (b, g, a tile of output frames), stages
// the group's [tile + K - 1, C] input slab in shared memory once and walks
// the K taps, one [C, C] tap matrix at a time.
//
// bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulation; the
// products of bf16 values are exact, so this is the same function). A block
// of 4 warps owns 128 frames; each warp owns 32 frames (two m16 tiles) x
// all C outputs (C/8 n8 tiles: 60 f32 accumulators a thread at C=120).
// Frame t's input row at tap j is slab row t + j, so the A fragments come
// straight from the slab by ldmatrix, with no im2col copy. Tap matrices
// are [C_out, C_in] (the B fragments' layout), double-buffered by cp.async
// so that tap j+1 loads while tap j multiplies. C_in is padded with zeros
// to the mma depth of 16 (120 -> 128), and every shared row to an odd
// number of 16-byte units, so the eight rows an ldmatrix reads fall in
// eight different bank groups.
//
// f32 runs on the FP32 pipes: a block of 2C threads owns 64 frames, stages
// each [C, C] tap matrix (57.6 KB at C=120) while the next one is already
// on its way into registers, and each thread owns 4 frames x 8 output
// channels (32 f32 accumulators), per input channel reading 4 slab values
// (rows padded to C + 1 floats, so the four frames fall in different
// banks) and two float4 of the tap matrix for 32 FMAs. The wrapper passes
// the weight rounded to the compute dtype, as [G, K, C_out, C_in] for bf16
// and [G, K, C_in, C_out] for f32, so every tap matrix is one contiguous
// read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---- f32: FP32 pipes -----------------------------------------------------------

constexpr int TT = 64;  // output frames per block
constexpr int RT = 4;   // frames per thread
constexpr int RO = 8;   // output channels per thread

template <int C>
__global__ void __launch_bounds__(2 * C) pos_conv_kernel(
    const float* __restrict__ x,  // [B, T, G*C]
    const float* __restrict__ w,  // [G, K, C_in, C_out]
    float* __restrict__ y,        // [B, T+1, G*C]
    int T_in, int G, int K) {
  constexpr int THREADS = 2 * C;
  constexpr int CP = C + 1;                // padded slab row
  constexpr int WPT = C * C / THREADS;     // tap-matrix values each thread stages (C / 2)
  constexpr int NTC = C / RO;              // channel groups
  static_assert((TT / RT) * NTC == THREADS, "one 4 x 8 tile per thread");
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                        // [C][C] current tap matrix
  float* xs = ws + C * C;                  // [TT + K - 1][CP] input slab

  const int tid = threadIdx.x;
  const int tc = tid % NTC, tr = tid / NTC;
  const int f0 = tr * RT, o0 = tc * RO;
  const int t0 = blockIdx.x * TT;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int D = G * C;
  const int pad = K / 2;
  const int T_out = T_in + 2 * pad - K + 1;
  const int rows = TT + K - 1;

  for (int idx = tid; idx < rows * C; idx += THREADS) {
    const int r = idx / C, i = idx % C;
    const int src = t0 + r - pad;
    xs[r * CP + i] = (src >= 0 && src < T_in) ? x[((size_t)b * T_in + src) * D + g * C + i] : 0.f;
  }

  const float* wg = w + (size_t)g * K * C * C;
  float wreg[WPT];
#pragma unroll
  for (int u = 0; u < WPT; ++u) wreg[u] = wg[tid + u * THREADS];

  float acc[RT][RO];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int o = 0; o < RO; ++o) acc[r][o] = 0.f;

  for (int tap = 0; tap < K; ++tap) {
    __syncthreads();  // everyone is done with the previous tap matrix (and the slab is loaded)
#pragma unroll
    for (int u = 0; u < WPT; ++u) ws[tid + u * THREADS] = wreg[u];
    __syncthreads();
    if (tap + 1 < K) {  // the next tap's matrix travels while this one is used
      const float* wn = wg + (size_t)(tap + 1) * C * C;
#pragma unroll
      for (int u = 0; u < WPT; ++u) wreg[u] = wn[tid + u * THREADS];
    }
    const float* xr = xs + (tap + f0) * CP;
#pragma unroll 4
    for (int i = 0; i < C; ++i) {
      float a[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) a[r] = xr[r * CP + i];
      const float4 w0 = *reinterpret_cast<const float4*>(ws + i * C + o0);
      const float4 w1 = *reinterpret_cast<const float4*>(ws + i * C + o0 + 4);
      const float wv[RO] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int o = 0; o < RO; ++o) acc[r][o] = fmaf(a[r], wv[o], acc[r][o]);
    }
  }

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int t = t0 + f0 + r;
    if (t >= T_out) continue;
    float* yr = y + ((size_t)b * T_out + t) * D + g * C + o0;
#pragma unroll
    for (int o = 0; o < RO; ++o) yr[o] = acc[r][o];
  }
}

// ---- bf16: tensor cores ------------------------------------------------------

constexpr int MB = 128;    // output frames per block
constexpr int MWARPS = 4;  // each warp: 32 frames (two m16 tiles) x all C outputs

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a . b: a 16x16 (row-major), b 16x8 (col-major), d 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

template <int C>
struct MmaShape {
  static constexpr int CK = (C + 15) / 16 * 16;  // C_in padded to the mma depth (zeros)
  static constexpr int SP = CK + 8;              // shared row stride: an odd number of 16-byte units
  static constexpr int NT = C / 8;               // n8 tiles of the output channels
  static constexpr int V = C / 8;                // 16-byte vectors in a row of C bf16
  static_assert((SP / 8) % 2 == 1, "ldmatrix rows must fall in different bank groups");
  static size_t smem_bytes(int K) { return (size_t)(MB + K - 1 + 2 * C) * SP * sizeof(__nv_bfloat16); }
};

template <int C>
__global__ void __launch_bounds__(MWARPS * 32) pos_conv_mma_kernel(
    const __nv_bfloat16* __restrict__ x,  // [B, T, G*C]
    const __nv_bfloat16* __restrict__ w,  // [G, K, C_out, C_in]
    __nv_bfloat16* __restrict__ y,        // [B, T+1, G*C]
    int T_in, int G, int K) {
  using S = MmaShape<C>;
  constexpr int SP = S::SP, NT = S::NT, V = S::V, THREADS = MWARPS * 32;
  extern __shared__ __align__(16) __nv_bfloat16 msmem[];
  const int rows = MB + K - 1;
  __nv_bfloat16* xs = msmem;             // [rows][SP] input slab
  __nv_bfloat16* ws = xs + rows * SP;    // [2][C][SP] tap matrices, double-buffered

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * MB;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int D = G * C;
  const int pad = K / 2;
  const int T_out = T_in + 2 * pad - K + 1;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // the slab (zeros outside [0, T) and in the pad columns); the weight
  // buffers' pad columns (cp.async fills columns < C only)
  for (int idx = tid; idx < rows * (SP / 8); idx += THREADS) {
    const int r = idx / (SP / 8), v = idx % (SP / 8);
    const int src = t0 + r - pad;
    uint4 val = zero;
    if (v < V && src >= 0 && src < T_in)
      val = *reinterpret_cast<const uint4*>(x + ((size_t)b * T_in + src) * D + g * C + 8 * v);
    *reinterpret_cast<uint4*>(xs + r * SP + 8 * v) = val;
  }
  for (int idx = tid; idx < 2 * C * (SP / 8 - V); idx += THREADS) {
    const int r = idx / (SP / 8 - V), v = V + idx % (SP / 8 - V);
    *reinterpret_cast<uint4*>(ws + r * SP + 8 * v) = zero;
  }
  const __nv_bfloat16* wg = w + (size_t)g * K * C * C;
  auto load_tap = [&](int tap) {
    __nv_bfloat16* dst = ws + (tap & 1) * C * SP;
    const __nv_bfloat16* src = wg + (size_t)tap * C * C;
    for (int idx = tid; idx < C * V; idx += THREADS) {
      const int o = idx / V, v = idx % V;
      cp_async16(dst + o * SP + 8 * v, src + o * C + 8 * v);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  load_tap(0);

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int m0 = warp * 32;
  for (int tap = 0; tap < K; ++tap) {
    if (tap + 1 < K) {
      load_tap(tap + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // this tap's matrix (and, the first time, the slab) is in
    const __nv_bfloat16* wb = ws + (tap & 1) * C * SP;
#pragma unroll
    for (int k0 = 0; k0 < S::CK; k0 += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], xs + (m0 + 16 * mt + tap + (lane & 15)) * SP + k0 + 8 * (lane >> 4));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        unsigned bf[2];
        ldmatrix_x2(bf, wb + (8 * nt + (lane & 7)) * SP + k0 + 8 * ((lane >> 3) & 1));
        mma_bf16(acc[0][nt], a[0], bf);
        mma_bf16(acc[1][nt], a[1], bf);
      }
    }
    __syncthreads();  // this buffer is refilled two taps on
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + m0 + 16 * mt + 8 * half + (lane >> 2);
      if (t >= T_out) continue;
      __nv_bfloat16* yr = y + ((size_t)b * T_out + t) * D + g * C + 2 * (lane & 3);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(yr + 8 * nt) =
            __floats2bfloat162_rn(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
    }
  }
}

// bf16 -> the tensor-core kernel, f32 -> the FP32 one
template <typename T, int C>
int launch_c(const void* x, const void* w, void* y, int B, int T_in, int G, int K, void* stream) {
  const int T_out = T_in + 2 * (K / 2) - K + 1;
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    const size_t smem = MmaShape<C>::smem_bytes(K);
    err = cudaFuncSetAttribute(pos_conv_mma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T_out + MB - 1) / MB, G, B);
    pos_conv_mma_kernel<C><<<grid, MWARPS * 32, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y, T_in, G, K);
  } else {
    const size_t smem = (size_t)(C * C + (TT + K - 1) * (C + 1)) * sizeof(float);
    err = cudaFuncSetAttribute(pos_conv_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T_out + TT - 1) / TT, G, B);
    pos_conv_kernel<C><<<grid, 2 * C, smem, (cudaStream_t)stream>>>((const float*)x, (const float*)w, (float*)y,
                                                                   T_in, G, K);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, void* y, int B, int T_in, int G, int C, int K, void* stream) {
  if (K < 1 || K > 256 || G < 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 48: return launch_c<T, 48>(x, w, y, B, T_in, G, K, stream);
    case 64: return launch_c<T, 64>(x, w, y, B, T_in, G, K, stream);
    case 80: return launch_c<T, 80>(x, w, y, B, T_in, G, K, stream);
    case 120: return launch_c<T, 120>(x, w, y, B, T_in, G, K, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ser_pos_conv_f32(const void* x, const void* w, void* y, int B, int T, int G, int C,
                                int K, void* stream) {
  return launch<float>(x, w, y, B, T, G, C, K, stream);
}

extern "C" int ser_pos_conv_bf16(const void* x, const void* w, void* y, int B, int T, int G, int C,
                                 int K, void* stream) {
  return launch<__nv_bfloat16>(x, w, y, B, T, G, C, K, stream);
}
