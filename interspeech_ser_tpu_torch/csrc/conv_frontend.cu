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
// What bounds layer 0 on an H100: each output value costs k=10 FMAs, a
// share of one LayerNorm and one GELU, while the [B, ~32k, 512] layer-0
// activation is the largest tensor of the whole encoder (262 MB in bf16 at
// B=8, 10 s). Its kernels write it exactly once, in the compute dtype, with
// no f32 intermediate and no second pass over memory, so the single write
// bounds it (0.0798 ms in bf16, 0.158 in f32 at [8, 160000]) -- if the
// instructions a value costs fit under that write. In f32 they barely do:
// about 46 a value (k FMAs, ~28 for erff, the norm), 131 M values at 128
// lanes an SM-clock. The kernel this replaces spent ~55 (a shared-memory
// load for every tap's weight, 2-byte stores in bf16).
//
// f32 (conv_frontend_kernel): a lane owns 8 contiguous channels for the
// whole launch, so their k taps' weights stay in registers (80 at k <= 10;
// a 16-tap instance takes k <= 16), and each frame's values leave as two
// float4 (a warp writes 1 KB contiguous). Two warps (64 threads, one
// block) hold a frame's 512 channels; each lane works on 4 frames at a
// time, and the LayerNorm's 8 sums (sum y, sum y^2 of 4 frames) are
// reduce-scattered across the warp by shuffles (reduce_scatter: 7 + 2
// shuffle-adds for all 8, not 40), then the two warps' halves meet in
// shared memory, one barrier per 4 frames. The frames' 16-tap patches are
// staged in shared memory 64 frames at a time (one thread a frame), read as
// broadcast float4. The grid is the card's resident blocks (6 an SM), each
// owning a contiguous run of the B * T0 output frames (the run crosses
// batch rows freely: the output row is the flat frame index), so no wave is
// left part full. The conv sum is bit for bit the replaced kernel's (bias,
// then fmaf tap by tap); the LayerNorm's sums are taken in another fixed
// order.
//
// bf16 (conv_frontend_mma_kernel): the k FMAs a value go to the tensor
// cores (mma.sync m16n8k16, taps padded to 16 with zeros, the bias as the
// accumulator's input; products of bf16 values are exact) and GELU to a
// table: z is rounded to bf16 before GELU, so it is one of 65536 values, and
// gelu_table_kernel evaluates the same erff / tanhf expression in f32,
// rounded to bf16, for every one of them, once a device; each block copies
// the 128-KB table to shared memory (same bits as evaluating it). One
// 512-thread block an SM; each warp owns a run of 16-frame tiles and works
// on two at a time, wholly on its own: pass 1 multiplies a tile group of
// 32 channels at a time and keeps only sum y and sum y^2 of each row (a
// quad of lanes holds a row's 32 channels: two shuffles finish the 512),
// pass 2 multiplies again, normalises, rounds, looks GELU up and stores 8
// channels (16 bytes) a lane, as streaming stores (st.global.cs: the
// activation is written once and is five times the L2). The n8 tiles'
// columns are permuted (column n of tile j of a group is channel
// 8 (n / 2) + 2 j + n % 2) so that a lane's
// accumulators are 8 consecutive channels. About 11 instructions a value,
// no barrier after the prologue; the table's random 2-byte reads (~3.5
// shared-memory wavefronts a warp-load) are the next limit.
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
#include <stdint.h>

namespace {

constexpr int MAX_K = 16;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <bool APPROX>
__device__ __forceinline__ float gelu(float z) {
  if (APPROX) {
    const float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
    return 0.5f * z * (1.f + tanhf(u));
  }
  return 0.5f * z * (1.f + erff(z * 0.7071067811865476f));
}

// ---- layer 0 ----------------------------------------------------------------

constexpr int C0 = 512;  // channels of every layer-norm frontend of the zoo

// f32: a lane owns 8 channels of a frame, two warps (one block) a frame
constexpr int L0_CPL = 8;                 // channels a lane
constexpr int L0_THREADS = C0 / L0_CPL;   // 64
constexpr int L0_CHUNK = 64;              // frames whose patches are staged at a time (one a thread)
constexpr int L0_STEP = 4;                // frames a lane computes at a time
constexpr int L0_TAPS = 16;               // a staged patch: taps 0..15, zero past k

// The warp's sums of NV values (NV a power of 2 up to 32), reduce-scattered:
// each halving step sends half the values across one lane bit and keeps the
// other half, so all NV cost NV - 1 shuffle-adds plus log2(32 / NV) for the
// last one, and lane l ends with value l / (32 / NV). A fixed order: a rerun
// gives the same bits, and the 32 / NV lanes holding a value agree on it.
template <int NV>
__device__ __forceinline__ float reduce_scatter(float (&s)[NV], int lane) {
#pragma unroll
  for (int half = NV / 2, bit = 16; half >= 1; half >>= 1, bit >>= 1) {
    const bool hi = lane & bit;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = hi ? s[k] : s[k + half];
      s[k] = (hi ? s[k + half] : s[k]) + __shfl_xor_sync(0xffffffffu, send, bit);
    }
  }
  float v = s[0];
#pragma unroll
  for (int bit = 16 / NV; bit >= 1; bit >>= 1) v += __shfl_xor_sync(0xffffffffu, v, bit);
  return v;
}

// launch bounds: 6 blocks an SM at k <= 10 (80 weight registers a lane), 4 up to k = 16 (128)
template <int KMAX, bool APPROX>
__global__ void __launch_bounds__(L0_THREADS, (KMAX <= 10 ? 6 : 4)) conv_frontend_kernel(
    const float* __restrict__ wav,     // [B, L]
    const float* __restrict__ weight,  // [C, k]
    const float* __restrict__ bias,    // [C] or null
    const float* __restrict__ ln_w,    // [C]
    const float* __restrict__ ln_b,    // [C]
    float* __restrict__ out,           // [B, T0, C]: row = flat frame index
    int L, int T0, int total, int per_block, int ksize, int stride, float eps) {
  __shared__ __align__(16) float patch[L0_CHUNK][L0_TAPS];
  __shared__ __align__(16) float prm[3][C0];                // bias, ln_w, ln_b
  __shared__ __align__(16) float part[2][2][2 * L0_STEP];  // [parity][warp][sum y, sum y^2 of each frame]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = L0_CPL * tid;
  float w[KMAX][L0_CPL];
#pragma unroll
  for (int t = 0; t < KMAX; ++t)
#pragma unroll
    for (int e = 0; e < L0_CPL; ++e) w[t][e] = t < ksize ? weight[(c0 + e) * ksize + t] : 0.f;
  for (int c = tid; c < C0; c += L0_THREADS) {
    prm[0][c] = bias != nullptr ? bias[c] : 0.f;
    prm[1][c] = ln_w[c];
    prm[2][c] = ln_b[c];
  }

  const float inv_c = 1.f / (float)C0;
  const int f_begin = blockIdx.x * per_block;
  const int f_end = min(f_begin + per_block, total);
  int par = 0;
  for (int cf = f_begin; cf < f_end; cf += L0_CHUNK) {
    const int n = min(L0_CHUNK, f_end - cf);
    __syncthreads();  // the last chunk's patches are read (and, the first time, prm is in)
    {
      float v[L0_TAPS];
      const int phi = cf + min(tid, n - 1);
      const int b = phi / T0;
      const float* xs = wav + (size_t)b * L + (size_t)(phi - b * T0) * stride;
#pragma unroll
      for (int t = 0; t < L0_TAPS; ++t) v[t] = (tid < n && t < ksize) ? xs[t] : 0.f;
#pragma unroll
      for (int t = 0; t < L0_TAPS; t += 4)
        *reinterpret_cast<float4*>(&patch[tid][t]) = make_float4(v[t], v[t + 1], v[t + 2], v[t + 3]);
    }
    __syncthreads();
    for (int f = 0; f < n; f += L0_STEP) {
      float acc[L0_STEP][L0_CPL];
      {
        const float4 b0 = *reinterpret_cast<const float4*>(&prm[0][c0]);
        const float4 b1 = *reinterpret_cast<const float4*>(&prm[0][c0 + 4]);
        const float bv[L0_CPL] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < L0_STEP; ++i) {
          float x[(KMAX + 3) / 4 * 4];
#pragma unroll
          for (int t = 0; t < KMAX; t += 4) {
            const float4 q = *reinterpret_cast<const float4*>(&patch[f + i][t]);  // rows past n are zero
            x[t] = q.x, x[t + 1] = q.y, x[t + 2] = q.z, x[t + 3] = q.w;
          }
#pragma unroll
          for (int e = 0; e < L0_CPL; ++e) {
            float y = bv[e];  // bias first, in f32
#pragma unroll
            for (int t = 0; t < KMAX; ++t) y = fmaf(w[t][e], x[t], y);
            acc[i][e] = y;
          }
        }
      }
      // sum y and sum y^2 of each frame over the lane's 8 channels, then
      // reduce-scattered over the warp and the two warps' halves added
      float s[2 * L0_STEP];
#pragma unroll
      for (int i = 0; i < L0_STEP; ++i) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int e = 0; e < L0_CPL; ++e) {
          s1 += acc[i][e];
          s2 = fmaf(acc[i][e], acc[i][e], s2);
        }
        s[2 * i] = s1;
        s[2 * i + 1] = s2;
      }
      const float v = reduce_scatter<2 * L0_STEP>(s, lane);
      if ((lane & (32 / (2 * L0_STEP) - 1)) == 0) part[par][warp][lane / (32 / (2 * L0_STEP))] = v;
      __syncthreads();
      float tot[2 * L0_STEP];
#pragma unroll
      for (int k = 0; k < 2 * L0_STEP; k += 4) {
        const float4 p0 = *reinterpret_cast<const float4*>(&part[par][0][k]);
        const float4 p1 = *reinterpret_cast<const float4*>(&part[par][1][k]);
        tot[k] = p0.x + p1.x, tot[k + 1] = p0.y + p1.y, tot[k + 2] = p0.z + p1.z, tot[k + 3] = p0.w + p1.w;
      }
      par ^= 1;  // the next step writes the other half: no second barrier
      float lw[L0_CPL], lb[L0_CPL];
#pragma unroll
      for (int e = 0; e < L0_CPL; e += 4) {
        const float4 a = *reinterpret_cast<const float4*>(&prm[1][c0 + e]);
        const float4 bb = *reinterpret_cast<const float4*>(&prm[2][c0 + e]);
        lw[e] = a.x, lw[e + 1] = a.y, lw[e + 2] = a.z, lw[e + 3] = a.w;
        lb[e] = bb.x, lb[e + 1] = bb.y, lb[e + 2] = bb.z, lb[e + 3] = bb.w;
      }
#pragma unroll
      for (int i = 0; i < L0_STEP; ++i) {
        if (f + i >= n) break;
        const float mean = tot[2 * i] * inv_c;
        const float rstd = rsqrtf(fmaxf(tot[2 * i + 1] * inv_c - mean * mean, 0.f) + eps);
        float o[L0_CPL];
#pragma unroll
        for (int e = 0; e < L0_CPL; ++e) o[e] = gelu<APPROX>((acc[i][e] - mean) * rstd * lw[e] + lb[e]);
        float* orow = out + (size_t)(cf + f + i) * C0 + c0;
        *reinterpret_cast<float4*>(orow) = make_float4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<float4*>(orow + 4) = make_float4(o[4], o[5], o[6], o[7]);
      }
    }
  }
}

// bf16: tensor-core conv, two passes over each pair of 16-frame tiles, GELU looked up
constexpr int M_WARPS = 16;                  // 512 threads, one block an SM
constexpr int M_THREADS = 32 * M_WARPS;
constexpr int M_TILE = 16;                   // frames a warp computes at a time (the mma's rows)
constexpr int M_NT = C0 / 8;                 // n8 tiles of the 512 channels
constexpr int GELU_ALL = 65536;              // every bf16 bit pattern
constexpr size_t M_SMEM = 2 * GELU_ALL + 8 * M_NT * 32 + 4 * 3 * C0;  // table, B fragments, bias / ln_w / ln_b

__device__ __align__(16) unsigned short g_gelu_bf16[2][GELU_ALL];  // [approx][bits of z]: bits of gelu(z)

template <bool APPROX>
__global__ void gelu_table_kernel() {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h < GELU_ALL)
    g_gelu_bf16[APPROX][h] =
        __bfloat16_as_ushort(__float2bfloat16(gelu<APPROX>(__bfloat162float(__ushort_as_bfloat16((unsigned short)h)))));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d = a . b + (c0, c1 in both rows): bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bias(float (&d)[4], const uint32_t (&a)[4], uint2 b, float c0, float c1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %10, %11};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y), "f"(c0), "f"(c1));
}

// y of the rows g, g + 8 of both 16-frame tiles at group G's 32 channels: d[u][j][0..1] row g of
// tile u, d[u][j][2..3] row g + 8, channels 32 G + 8 t + 2 j + (0, 1); the group's B fragments and
// bias are read once for both tiles
__device__ __forceinline__ void conv_group(float (&d)[2][4][4], const uint32_t (&a)[2][4], const uint2* bfrag,
                                           const float* bias, int G, int lane) {
  const float4 b0 = *reinterpret_cast<const float4*>(bias + 32 * G + 8 * (lane & 3));
  const float4 b1 = *reinterpret_cast<const float4*>(bias + 32 * G + 8 * (lane & 3) + 4);
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint2 bf = bfrag[(4 * G + j) * 32 + lane];
    mma_bias(d[0][j], a[0], bf, bv[2 * j], bv[2 * j + 1]);
    mma_bias(d[1][j], a[1], bf, bv[2 * j], bv[2 * j + 1]);
  }
}

template <bool APPROX>
__global__ void __launch_bounds__(M_THREADS, 1) conv_frontend_mma_kernel(
    const float* __restrict__ wav,     // [B, L]
    const float* __restrict__ weight,  // [C, k]
    const float* __restrict__ bias,    // [C] or null
    const float* __restrict__ ln_w,    // [C]
    const float* __restrict__ ln_b,    // [C]
    __nv_bfloat16* __restrict__ out,   // [B, T0, C]: row = flat frame index
    int L, int T0, int total, int tiles_per_warp, int ksize, int stride, float eps) {
  extern __shared__ __align__(16) unsigned char msm[];
  unsigned short* tab = reinterpret_cast<unsigned short*>(msm);               // [65536]
  uint2* bfrag = reinterpret_cast<uint2*>(msm + 2 * GELU_ALL);                // [n8 tile][lane]
  float* prm = reinterpret_cast<float*>(msm + 2 * GELU_ALL + 8 * M_NT * 32);  // [3][512]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  {
    const uint4* src = reinterpret_cast<const uint4*>(g_gelu_bf16[APPROX]);
    for (int i = tid; i < GELU_ALL / 8; i += M_THREADS) reinterpret_cast<uint4*>(tab)[i] = src[i];
  }
  // n8 tile nt = 4 G + j, column n -> channel 32 G + 8 (n / 2) + 2 j + n % 2, so that a lane's
  // accumulators of the group's 4 tiles are 8 consecutive channels of each of its rows;
  // lane (g, t) holds taps 2t, 2t + 1 (b.x) and 2t + 8, 2t + 9 (b.y) of column g, rounded to bf16
  for (int i = tid; i < M_NT * 32; i += M_THREADS) {
    const int nt = i / 32, gg = (i % 32) >> 2, tt = i & 3;
    const float* wc = weight + (size_t)(32 * (nt / 4) + 8 * (gg >> 1) + 2 * (nt % 4) + (gg & 1)) * ksize;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int tap = 2 * tt + (q & 1) + 8 * (q >> 1);
      v[q] = tap < ksize ? wc[tap] : 0.f;
    }
    bfrag[i] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
  for (int c = tid; c < C0; c += M_THREADS) {
    prm[c] = bias != nullptr ? bias[c] : 0.f;
    prm[C0 + c] = ln_w[c];
    prm[2 * C0 + c] = ln_b[c];
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const float inv_c = 1.f / (float)C0;
  const int tile0 = (blockIdx.x * M_WARPS + warp) * tiles_per_warp;
  const int tile_end = min(tile0 + tiles_per_warp, (total + M_TILE - 1) / M_TILE);
  for (int tile = tile0; tile < tile_end; tile += 2) {  // two tiles at a time (tiles_per_warp is even)
    // A: rows g and g + 8 (frames) of each tile, taps 2t, 2t + 1, 2t + 8, 2t + 9; zero past k and
    // past the last frame. Row r (0..3) is frame 16 tile + g + 8 r.
    uint32_t a[2][4];
    int phi[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      phi[r] = tile * M_TILE + g + 8 * r;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (phi[r] < total) {
        const int b = phi[r] / T0;
        const float* xs = wav + (size_t)b * L + (size_t)(phi[r] - b * T0) * stride;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int tap = 2 * t + (q & 1) + 8 * (q >> 1);
          if (tap < ksize) v[q] = xs[tap];
        }
      }
      a[r >> 1][r & 1] = pack_bf16(v[0], v[1]);
      a[r >> 1][2 + (r & 1)] = pack_bf16(v[2], v[3]);
    }
    // pass 1: sum y and sum y^2 of each row over the lane's channels, then over the quad
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int G = 0; G < C0 / 32; ++G) {
      float d[2][4][4];
      conv_group(d, a, bfrag, prm, G, lane);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float y = d[r >> 1][j][2 * (r & 1) + e];
            s[2 * r] += y;
            s[2 * r + 1] = fmaf(y, y, s[2 * r + 1]);
          }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], 1);
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], 2);
    }
    float mean[4], rstd[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      mean[r] = s[2 * r] * inv_c;
      rstd[r] = rsqrtf(fmaxf(s[2 * r + 1] * inv_c - mean[r] * mean[r], 0.f) + eps);
    }
    // pass 2: the same products again, normalised, rounded, GELU by table, 16-byte stores
#pragma unroll 1
    for (int G = 0; G < C0 / 32; ++G) {
      float d[2][4][4];
      conv_group(d, a, bfrag, prm, G, lane);
      const int c = 32 * G + 8 * t;
      float lw[8], lb[8];
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        const float4 q = *reinterpret_cast<const float4*>(prm + C0 + c + e);
        const float4 w4 = *reinterpret_cast<const float4*>(prm + 2 * C0 + c + e);
        lw[e] = q.x, lw[e + 1] = q.y, lw[e + 2] = q.z, lw[e + 3] = q.w;
        lb[e] = w4.x, lb[e + 1] = w4.y, lb[e + 2] = w4.z, lb[e + 3] = w4.w;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint32_t o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unsigned short gz[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float z = (d[r >> 1][j][2 * (r & 1) + e] - mean[r]) * rstd[r] * lw[2 * j + e] + lb[2 * j + e];
            gz[e] = tab[__bfloat16_as_ushort(__float2bfloat16(z))];
          }
          o[j] = gz[0] | ((uint32_t)gz[1] << 16);
        }
        if (phi[r] < total)
          __stcs(reinterpret_cast<uint4*>(out + (size_t)phi[r] * C0 + c), make_uint4(o[0], o[1], o[2], o[3]));
      }
    }
  }
}

// once a device for `approx`: the table filled (then the stream synchronised, so that a launch on
// any stream finds it) and the mma kernel's shared-memory limit raised, so a launch is one call
int mma_ready(int approx, cudaStream_t s) {
  static bool ready[64][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && ready[dev][approx != 0]) return 0;
  const void* kern = approx ? (const void*)conv_frontend_mma_kernel<true> : (const void*)conv_frontend_mma_kernel<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)M_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (approx)
    gelu_table_kernel<true><<<GELU_ALL / 256, 256, 0, s>>>();
  else
    gelu_table_kernel<false><<<GELU_ALL / 256, 256, 0, s>>>();
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  if (err == cudaSuccess && dev < 64) ready[dev][approx != 0] = true;
  return (int)err;
}

template <int KMAX>
const void* l0_f32_kernel(int approx) {
  return approx ? (const void*)conv_frontend_kernel<KMAX, true> : (const void*)conv_frontend_kernel<KMAX, false>;
}

const void* l0_kernel(bool bf16, int ksize, int approx) {
  if (bf16)
    return approx ? (const void*)conv_frontend_mma_kernel<true> : (const void*)conv_frontend_mma_kernel<false>;
  return ksize <= 10 ? l0_f32_kernel<10>(approx) : l0_f32_kernel<16>(approx);
}

// blocks x per_block frames: the plan the wrapper passes in (conv_frontend.conv_frontend_plan); the
// bf16 kernel's warps own per_block / (16 x 16) tiles of 16 frames each, an even number
int launch(bool bf16, const void* wav, const void* weight, const void* bias, const void* ln_w,
           const void* ln_b, void* out, int B, int L, int T0, int channels, int ksize,
           int stride, float eps, int approx_gelu, int blocks, int per_block, void* stream) {
  const long long total = (long long)B * T0;
  const int unit = bf16 ? 2 * M_WARPS * M_TILE : L0_STEP;  // bf16: an even number of tiles a warp
  if (ksize < 1 || ksize > MAX_K || channels != C0 || stride < 1 || T0 < 1 || blocks < 1 || per_block < 1 ||
      per_block % unit != 0 || (long long)blocks * per_block < total || total > 0x7fffffff ||
      (long long)(T0 - 1) * stride + ksize > L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int n = (int)total;
  int per = bf16 ? per_block / (M_WARPS * M_TILE) : per_block;
  void* args[] = {(void*)&wav, (void*)&weight, (void*)&bias, (void*)&ln_w, (void*)&ln_b, (void*)&out, (void*)&L,
                  (void*)&T0, (void*)&n, (void*)&per, (void*)&ksize, (void*)&stride, (void*)&eps};
  const void* kern = l0_kernel(bf16, ksize, approx_gelu);
  if (bf16) {
    const int err = mma_ready(approx_gelu, s);
    if (err != 0) return err;
    return (int)cudaLaunchKernel(kern, dim3(blocks), dim3(M_THREADS), args, M_SMEM, s);
  }
  return (int)cudaLaunchKernel(kern, dim3(blocks), dim3(L0_THREADS), args, 0, s);
}

// threads, shared bytes (static + dynamic) and resident blocks an SM of the layer-0 kernel
int l0_plan(bool bf16, int ksize, int approx, int* out) {
  if (ksize < 1 || ksize > MAX_K) return (int)cudaErrorInvalidValue;
  const void* kern = l0_kernel(bf16, ksize, approx);
  const size_t dyn = bf16 ? M_SMEM : 0;
  cudaError_t err = bf16 ? cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn)
                         : cudaSuccess;
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  out[0] = bf16 ? M_THREADS : L0_THREADS;
  out[1] = (int)(attr.sharedSizeBytes + dyn);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kern, out[0], dyn);
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
                                     int approx_gelu, int blocks, int per_block, void* stream) {
  return launch(false, wav, weight, bias, ln_w, ln_b, out, B, L, T0, C, ksize, stride, eps, approx_gelu, blocks,
                per_block, stream);
}

extern "C" int ser_conv_frontend_bf16(const void* wav, const void* weight, const void* bias,
                                      const void* ln_w, const void* ln_b, void* out, int B,
                                      int L, int T0, int C, int ksize, int stride, float eps,
                                      int approx_gelu, int blocks, int per_block, void* stream) {
  return launch(true, wav, weight, bias, ln_w, ln_b, out, B, L, T0, C, ksize, stride, eps, approx_gelu, blocks,
                per_block, stream);
}

// the bf16 layer-0 kernel's GELU table, out [65536] bf16: entry h is gelu(z) for z of bf16 bits h
extern "C" int ser_gelu_bf16_table(int approx_gelu, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int err = mma_ready(approx_gelu, s);
  if (err != 0) return err;
  return (int)cudaMemcpyFromSymbolAsync(out, g_gelu_bf16, sizeof(unsigned short) * GELU_ALL,
                                        sizeof(unsigned short) * GELU_ALL * (approx_gelu ? 1 : 0),
                                        cudaMemcpyDeviceToDevice, s);
}

// out: [threads, shared bytes, blocks an SM] of the layer-0 kernel (bf16 1 or f32 0) for k taps
extern "C" int ser_conv_frontend_plan(int bf16, int ksize, int approx_gelu, int* out) {
  return l0_plan(bf16 != 0, ksize, approx_gelu, out);
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
