// K4: the backward of K1 (masked SDPA on [B, T, D] panels with a factored
// gated bias), with P recomputed from K1's log-sum-exp.
//
// Replaces interspeech_ser_tpu/ops/pallas/attention_bwd.py
// (attention_btd_bwd -> _bwd_kernel and its no-bias variant).
//
// Per head h (columns h*hd .. h*hd+hd-1 of D; hd = 64, 80 or 120, a
// template parameter, as in K1), with S = round(q*scale) . k^T +
// gate[b,h,q]*bias[h,q,k] over live keys and P = softmax(S):
//   dV = P^T g          (P rounded to the compute dtype first)
//   dP = g V^T,  dS = P * (dP - delta),  delta = rowsum(g * out)
//   dQ = scale * dS K,  dK = dS^T round(q*scale)   (dS rounded to the compute dtype)
//   dgate[b,h,q] = sum_k dS * bias            (f32)
//   dbias[h,q,k] = sum_b gate[b,h,q] * dS     (f32)
// delta stands in for the TPU kernel's rowsum(P * dP): the two are equal,
// since rowsum(P * (g V^T)) = g . (P V) = g . out.
//
// A batch row whose keys are all masked (K1 wrote lse -inf for its query
// rows; the mask is per batch row, so its lse[b, h, 0] tells) takes the TPU
// kernel's P = 1 / Tk_p on every key, Tk_p being Tk padded to a multiple of
// 128: the padded keys' zero K, V and bias add nothing, and its keys get the
// gradients of that uniform P.
//
// Scores are formed exactly as K1 forms them, from q*scale rounded to the
// compute dtype (the scale rounded first), so that exp(S - lse) with K1's
// lse is K1's P at every head dim: the TPU kernel's scale * (q . k) agrees
// with it only where the scale is a power of two (hd 64 gives 1/8), not at
// hd 80 or 120. dK takes the same rounded operand, which is scale * dS^T q
// up to that rounding; dQ keeps the chain rule's scale.
//
// What bounds it on an H100: the TPU kernel held whole [Tq, Tk] score tiles
// per head in VMEM; at Tk = 1500 one such tile is 9 MB in f32, forty times
// the 227 KB of shared memory a block may use. Here nothing of size Tq x Tk
// is ever stored (except dbias's per-batch terms, below): every pass
// recomputes P = exp(S - lse) tile by tile. Four launches:
//   1. delta: one warp per (b, q, h) row, rowsum(g * out) in f32; in bf16 it
//      also writes round(q * scale), the scores' left operand, to a scratch.
//   2. dK, dV (key-major): a block owns (b, h, 64 keys) and streams tiles of
//      queries; a block whose keys are all masked writes zeros and leaves.
//   3. dQ, dgate (query-major): a block owns (b, h, 64 queries) and streams
//      tiles of keys, skipping a tile whose keys are all masked. When dbias
//      is wanted it writes gate * dS for its batch row to a [B, H, Tq, Tk]
//      f32 scratch (coalesced, through shared memory).
//   4. dbias: the scratch summed over b in order 0..B-1.
// Every output is summed by one thread in one fixed order, with no atomics,
// so a rerun is bit-identical.
//
// bf16 (dkdv_mma_kernel, dq_mma_kernel): 4 warps a block, each owning 16 of
// its 64 rows; the streamed tiles of 32 rows (q*scale and dO, or K and V)
// are staged by cp.async and double-buffered, the bias tile, lse, delta,
// gate and key flags through registers. Every product runs on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate, fragments by ldmatrix):
// S and dP (depth hd, zero-padded to 128 at hd 120 in shared memory only),
// then dV += P^T dO and dK += dS^T (q*scale) (pass 2) or dQ += dS K
// (pass 3), whose A operand is P or dS straight from the accumulator
// registers, rounded to bf16, and whose B operand comes by ldmatrix.trans,
// hd in n8 steps (8, 10, 15). The dK, dV accumulators (2 x hd/8 x 4 floats a
// thread) stay in registers for the whole pass. It is bound by mma.sync
// issue and the f32 elementwise work between the products (exp2, the dS
// chain), not by device memory: q, k, v, g are read a few times, from L2.
// wgmma, TMA and warp specialisation are later work.
//
// f32 (dkdv_kernel, dq_kernel), the parity mode with TF32 off, stays on the
// FP32 pipes: P neighbouring threads share a row (P=2 at hd 64, P=4 at hd
// 80 and 120, so that k, v and the two accumulators take 4 x hd/P <= 128
// floats a thread without spilling), each holding hd/P columns; a dot
// product takes log2(P) xor-shuffles, and every FMA is fed by a
// shared-memory broadcast (float4, or float2 at hd 120).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_mma.cuh"

namespace {

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

// 1. delta[b, h, q] = sum_d g[b, q, h*HD + d] * out[b, q, h*HD + d], one warp a row;
//    with a non-null qs also qs = round(q * round(scale)), the scores' left operand (bf16)
template <typename T, int HD>
__global__ void __launch_bounds__(256) delta_kernel(const T* __restrict__ g, const T* __restrict__ out,
                                                    const T* __restrict__ q, T* __restrict__ qs,
                                                    float* __restrict__ delta, int B, int Tq, int H,
                                                    float scale) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);  // (b*Tq + q)*H + h
  const int lane = threadIdx.x & 31;
  if (row >= B * Tq * H) return;  // whole warps leave together
  const size_t base = (size_t)row * HD;
  const float sc = round_to<T>(scale);
  float s = 0.f;
  for (int d = lane; d < HD; d += 32) {
    s = fmaf(to_f(g[base + d]), to_f(out[base + d]), s);
    if (qs != nullptr) qs[base + d] = from_f<T>(to_f(q[base + d]) * sc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) {
    const int h = row % H, bq = row / H;
    const int q = bq % Tq, b = bq / Tq;
    delta[((size_t)b * H + h) * Tq + q] = s;
  }
}

// ---------------------------------------------------------------------------
// f32 on the FP32 pipes. P neighbouring threads share a row, each holding
// HP = HD / P columns of it; a shared row keeps each part 4 words apart, so
// that a row's P threads read their parts as broadcasts in distinct banks.

template <int HD>
struct Split {
  static constexpr int P = HD == 64 ? 2 : 4;  // 4 at hd 80 / 120: 2 would hold 160 / 240 floats a thread
  static constexpr int HP = HD / P;
  static constexpr int SP = HD + 4 * P;       // padded shared row
  static constexpr int VW = HP % 4 == 0 ? 4 : 2;  // shared reads as float4 (hd 64, 80) or float2 (hd 120)
};

constexpr int ROWS = 64;  // keys (key-major) or queries (query-major) per block
constexpr int TILE = 32;  // queries (key-major) or keys (query-major) per streamed tile

template <int HD>
__device__ __forceinline__ int hpad(int c) { return c + (c / Split<HD>::HP) * 4; }

// the full dot product of a row whose parts P neighbouring lanes hold
template <int HD>
__device__ __forceinline__ float dot_part(const float* r, const float* __restrict__ s) {
  typedef Split<HD> Sp;
  float acc = 0.f;
  if constexpr (Sp::VW == 4) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
    for (int d4 = 0; d4 < Sp::HP / 4; ++d4) {
      const float4 x = s4[d4];
      acc = fmaf(r[4 * d4 + 0], x.x, acc);
      acc = fmaf(r[4 * d4 + 1], x.y, acc);
      acc = fmaf(r[4 * d4 + 2], x.z, acc);
      acc = fmaf(r[4 * d4 + 3], x.w, acc);
    }
  } else {
    const float2* s2 = reinterpret_cast<const float2*>(s);
#pragma unroll
    for (int d2 = 0; d2 < Sp::HP / 2; ++d2) {
      const float2 x = s2[d2];
      acc = fmaf(r[2 * d2 + 0], x.x, acc);
      acc = fmaf(r[2 * d2 + 1], x.y, acc);
    }
  }
#pragma unroll
  for (int off = 1; off < Sp::P; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

template <int HD>
__device__ __forceinline__ void axpy_part(float a, const float* __restrict__ s, float* acc) {
  typedef Split<HD> Sp;
  if constexpr (Sp::VW == 4) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
    for (int d4 = 0; d4 < Sp::HP / 4; ++d4) {
      const float4 x = s4[d4];
      acc[4 * d4 + 0] = fmaf(a, x.x, acc[4 * d4 + 0]);
      acc[4 * d4 + 1] = fmaf(a, x.y, acc[4 * d4 + 1]);
      acc[4 * d4 + 2] = fmaf(a, x.z, acc[4 * d4 + 2]);
      acc[4 * d4 + 3] = fmaf(a, x.w, acc[4 * d4 + 3]);
    }
  } else {
    const float2* s2 = reinterpret_cast<const float2*>(s);
#pragma unroll
    for (int d2 = 0; d2 < Sp::HP / 2; ++d2) {
      const float2 x = s2[d2];
      acc[2 * d2 + 0] = fmaf(a, x.x, acc[2 * d2 + 0]);
      acc[2 * d2 + 1] = fmaf(a, x.y, acc[2 * d2 + 1]);
    }
  }
}

// 2. dK, dV: block (b, h, 64 keys); threads P*j .. P*j+P-1 own key j's parts.
//    The query tile holds q * scale (K1's left operand): S = (q*scale) . k and
//    dK = dS^T (q*scale), which is scale * dS^T q.
template <int HD>
__global__ void __launch_bounds__(ROWS * Split<HD>::P) dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ key_mask,
    const float* __restrict__ gate, const float* __restrict__ bias,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tk, int H, float scale) {
  typedef Split<HD> Sp;
  constexpr int P = Sp::P, HP = Sp::HP, SP = Sp::SP, THREADS = ROWS * P;
  __shared__ __align__(16) float qs[TILE][SP];
  __shared__ __align__(16) float gs[TILE][SP];
  __shared__ float lse_s[TILE], delta_s[TILE], gate_s[TILE];

  const int tid = threadIdx.x;
  const int part = tid % P;
  const int k0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * HD;
  const int kj = k0 + tid / P;
  const bool dead = lse[((size_t)b * H + h) * Tq] == -INFINITY;  // the batch row has no live key
  const float p_dead = 1.f / (float)attn_mma::oneshot_padded_tk(Tk);
  const bool key_ok = kj < Tk && (key_mask == nullptr || key_mask[(size_t)b * Tk + kj] > 0.f);

  float kr[HP], vr[HP], dk_acc[HP], dv_acc[HP];
  {
    const size_t off = ((size_t)b * Tk + (kj < Tk ? kj : 0)) * D + h * HD + part * HP;
#pragma unroll
    for (int d = 0; d < HP; ++d) {
      kr[d] = kj < Tk ? k[off + d] : 0.f;
      vr[d] = kj < Tk ? v[off + d] : 0.f;
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
      qs[r][hpad<HD>(c)] = qi < Tq ? q[off] * scale : 0.f;
      gs[r][hpad<HD>(c)] = qi < Tq ? g[off] : 0.f;
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
      const float* qrow = &qs[i][part * (HP + 4)];
      const float* grow = &gs[i][part * (HP + 4)];
      float s = dot_part<HD>(kr, qrow);  // every lane shuffles: masked keys are computed, then zeroed
      if (bias != nullptr && kj < Tk) s += gate_s[i] * bias[((size_t)h * Tq + q0 + i) * Tk + kj];
      const float p = dead ? (kj < Tk ? p_dead : 0.f) : (key_ok ? expf(s - L) : 0.f);
      const float dp = dot_part<HD>(vr, grow);
      const float ds = p * (dp - delta_s[i]);
      axpy_part<HD>(p, grow, dv_acc);
      axpy_part<HD>(ds, qrow, dk_acc);
    }
  }

  if (kj < Tk) {
    const size_t off = ((size_t)b * Tk + kj) * D + h * HD + part * HP;
#pragma unroll
    for (int d = 0; d < HP; ++d) {
      dk[off + d] = dk_acc[d];
      dv[off + d] = dv_acc[d];
    }
  }
}

// 3. dQ, dgate (and dbias's per-batch terms): block (b, h, 64 queries);
//    threads P*i .. P*i+P-1 own query i's parts; q * scale in registers
template <int HD>
__global__ void __launch_bounds__(ROWS * Split<HD>::P) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ key_mask,
    const float* __restrict__ gate, const float* __restrict__ bias,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, float* __restrict__ dgate, float* __restrict__ dbias_part,
    int Tq, int Tk, int H, float scale) {
  typedef Split<HD> Sp;
  constexpr int P = Sp::P, HP = Sp::HP, SP = Sp::SP, THREADS = ROWS * P;
  __shared__ __align__(16) float ks[TILE][SP];
  __shared__ __align__(16) float vs[TILE][SP];
  __shared__ float bs[ROWS][TILE + 1];  // bias tile, then gate * dS for dbias
  __shared__ float valid[TILE];

  const int tid = threadIdx.x;
  const int part = tid % P;
  const int r = tid / P;
  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * HD;
  const int qi = q0 + r;
  const bool row_ok = qi < Tq;
  const size_t hrow = ((size_t)b * H + h) * Tq + (row_ok ? qi : 0);

  float qr[HP], gr[HP], dq_acc[HP];
  {
    const size_t off = ((size_t)b * Tq + (row_ok ? qi : 0)) * D + h * HD + part * HP;
#pragma unroll
    for (int d = 0; d < HP; ++d) {
      qr[d] = row_ok ? q[off + d] * scale : 0.f;
      gr[d] = row_ok ? g[off + d] : 0.f;
      dq_acc[d] = 0.f;
    }
  }
  const float L = row_ok ? lse[hrow] : -INFINITY;
  const float dlt = row_ok ? delta[hrow] : 0.f;
  const float gt = (row_ok && bias != nullptr) ? (gate != nullptr ? gate[hrow] : 1.f) : 0.f;
  const bool dead = lse[((size_t)b * H + h) * Tq] == -INFINITY;  // the batch row has no live key
  const float p_dead = 1.f / (float)attn_mma::oneshot_padded_tk(Tk);
  float dgate_acc = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += TILE) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < TILE * HD; idx += THREADS) {
      const int rr = idx / HD, c = idx % HD;
      const int kk = k0 + rr;
      const size_t off = ((size_t)b * Tk + kk) * D + h * HD + c;
      ks[rr][hpad<HD>(c)] = kk < Tk ? k[off] : 0.f;
      vs[rr][hpad<HD>(c)] = kk < Tk ? v[off] : 0.f;
    }
    if (bias != nullptr) {
      for (int idx = tid; idx < ROWS * TILE; idx += THREADS) {
        const int rr = idx / TILE, c = idx % TILE;
        const int qq = q0 + rr, kk = k0 + c;
        bs[rr][c] = (qq < Tq && kk < Tk) ? bias[((size_t)h * Tq + qq) * Tk + kk] : 0.f;
      }
    }
    if (tid < TILE) {
      const int kk = k0 + tid;
      valid[tid] = (kk < Tk && (key_mask == nullptr || key_mask[(size_t)b * Tk + kk] > 0.f)) ? 1.f : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < TILE; ++j) {
      float ds = 0.f;
      if (valid[j] > 0.f || (dead && k0 + j < Tk)) {  // the same j for all threads: whole-warp shuffles
        const float bij = bias != nullptr ? bs[r][j] : 0.f;  // read before the shuffles below
        const float s = dot_part<HD>(qr, &ks[j][part * (HP + 4)]) + gt * bij;
        const float p = dead ? p_dead : (row_ok ? expf(s - L) : 0.f);
        const float dp = dot_part<HD>(gr, &vs[j][part * (HP + 4)]);
        ds = p * (dp - dlt);
        dgate_acc = fmaf(ds, bij, dgate_acc);
        axpy_part<HD>(ds, &ks[j][part * (HP + 4)], dq_acc);
      }
      __syncwarp();                                               // the row's reads of bs[r][j] are done
      if (dbias_part != nullptr && part == 0) bs[r][j] = gt * ds;
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
    const size_t off = ((size_t)b * Tq + qi) * D + h * HD + part * HP;
#pragma unroll
    for (int d = 0; d < HP; ++d) dq[off + d] = dq_acc[d] * scale;
    if (dgate != nullptr && part == 0) dgate[hrow] = dgate_acc;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: 4 warps a block, each owning 16 of the block's
// 64 rows (keys in pass 2, queries in pass 3); the other side streams in
// tiles of 32 rows, staged by cp.async (bias, lse, delta, gate, key flags
// through registers), double-buffered. qs is the delta pass's q * scale.

using attn_mma::bf16;
constexpr int MB = 64;    // rows a block owns
constexpr int MT = 32;    // rows a streamed tile holds
constexpr int MMA_THREADS = 128;
constexpr int DKDV_BSTR = MB + 8;  // bias tile [MT queries][MB keys]
constexpr int DQ_BSTR = MT + 8;    // bias tile [MB queries][MT keys]

template <int HD, bool BIAS>
struct DkdvSmem {
  typedef attn_mma::Dims<HD> Dm;
  static constexpr size_t own = (size_t)MB * Dm::STR;   // K or V, staged once
  static constexpr size_t tile = (size_t)MT * Dm::STR;  // one stage of q * scale or dO
  static constexpr size_t bias = BIAS ? (size_t)MT * DKDV_BSTR : 0;
  static constexpr size_t bytes = (2 * own + 4 * tile + 2 * bias) * sizeof(bf16) + 3 * 2 * MT * sizeof(float);
};

template <int HD, bool BIAS>
struct DqSmem {
  typedef attn_mma::Dims<HD> Dm;
  static constexpr size_t own = (size_t)MB * Dm::STR;   // q * scale or dO, staged once
  static constexpr size_t tile = (size_t)MT * Dm::STR;  // one stage of K or V
  static constexpr size_t bias = BIAS ? (size_t)MB * DQ_BSTR : 0;
  static constexpr size_t dbs = BIAS ? (size_t)MB * (MT + 1) : 0;  // gate * dS, f32
  static constexpr size_t bytes =
      (2 * own + 4 * tile + 2 * bias) * sizeof(bf16) + (2 * MT + dbs) * sizeof(float);
};

// 2. dK, dV: block (b, h, 64 keys), warp w keys 16w .. 16w+15, query tiles of 32
template <int HD, bool BIAS>
__global__ void __launch_bounds__(MMA_THREADS) dkdv_mma_kernel(
    const bf16* __restrict__ qs_g, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ key_mask, const float* __restrict__ gate,
    const bf16* __restrict__ bias, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk, int H) {
  using namespace attn_mma;
  typedef Dims<HD> Dm;
  typedef DkdvSmem<HD, BIAS> Sm;
  constexpr int STR = Dm::STR, NT = Dm::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ksm = reinterpret_cast<bf16*>(smem_raw);
  bf16* vsm = ksm + Sm::own;
  bf16* qsm = vsm + Sm::own;       // [2][MT][STR]
  bf16* gsm = qsm + 2 * Sm::tile;  // [2][MT][STR]
  bf16* bsm = gsm + 2 * Sm::tile;  // [2][MT][DKDV_BSTR]
  float* lse_s = reinterpret_cast<float*>(bsm + 2 * Sm::bias);  // [2][MT], log2 units
  float* dl_s = lse_s + 2 * MT;
  float* gt_s = dl_s + 2 * MT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * MB, h = blockIdx.y, b = blockIdx.z;
  const int D = H * HD;
  const bool dead = lse[((size_t)b * H + h) * Tq] == -INFINITY;  // the batch row has no live key
  const float p_dead = 1.f / (float)oneshot_padded_tk(Tk);
  auto key_ok = [&](int kj) {  // a key with weight (in a dead batch row every key has 1 / Tk_p)
    return kj < Tk && (dead || key_mask == nullptr || key_mask[(size_t)b * Tk + kj] > 0.f);
  };
  if (!__syncthreads_or(tid < MB && key_ok(k0 + tid))) {  // every key masked: dK = dV = 0
    for (int idx = tid; idx < MB * HD; idx += MMA_THREADS) {
      const int kj = k0 + idx / HD;
      if (kj < Tk) {
        const size_t off = ((size_t)b * Tk + kj) * D + h * HD + idx % HD;
        dk[off] = __float2bfloat16(0.f);
        dv[off] = __float2bfloat16(0.f);
      }
    }
    return;
  }
  const int kr = warp * 16 + gq;  // this thread's keys: kr and kr + 8 of the block
  const bool kok[2] = {key_ok(k0 + kr), key_ok(k0 + kr + 8)};

  zero_pad<HD, MMA_THREADS>(ksm, MB, tid);
  zero_pad<HD, MMA_THREADS>(vsm, MB, tid);
  zero_pad<HD, MMA_THREADS>(qsm, 2 * MT, tid);
  zero_pad<HD, MMA_THREADS>(gsm, 2 * MT, tid);
  const bf16* qb = qs_g + (size_t)b * Tq * D;
  const bf16* gb = g + (size_t)b * Tq * D;
  stage_rows<HD, MB, MMA_THREADS>(ksm, k + (size_t)b * Tk * D, k0, Tk, D, h, tid);
  stage_rows<HD, MB, MMA_THREADS>(vsm, v + (size_t)b * Tk * D, k0, Tk, D, h, tid);
  stage_rows<HD, MT, MMA_THREADS>(qsm, qb, 0, Tq, D, h, tid);
  stage_rows<HD, MT, MMA_THREADS>(gsm, gb, 0, Tq, D, h, tid);
  cp_async_commit();

  TileRegs<MT, MB, MMA_THREADS> bpre;  // bias [queries][the block's keys]
  const bf16* bias_h = bias + (size_t)h * Tq * Tk;
  float lpre = 0.f, dpre = 0.f, gpre = 0.f;
  auto prefetch = [&](int q0) {
    if constexpr (BIAS) bpre.load(bias_h, q0, k0, Tq, Tk, Tk, tid);
    if (tid < MT) {
      const int qi = q0 + tid;
      const size_t row = ((size_t)b * H + h) * Tq + qi;
      lpre = qi < Tq ? lse[row] * LOG2E : -INFINITY;
      dpre = qi < Tq ? delta[row] : 0.f;
      gpre = (BIAS && qi < Tq) ? gate[row] : 0.f;
    }
  };
  auto commit_prefetch = [&](int st) {
    if constexpr (BIAS) bpre.store(bsm + st * Sm::bias, DKDV_BSTR, tid);
    if (tid < MT) {
      lse_s[st * MT + tid] = lpre;
      dl_s[st * MT + tid] = dpre;
      gt_s[st * MT + tid] = gpre;
    }
  };
  prefetch(0);
  commit_prefetch(0);

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int nq = (Tq + MT - 1) / MT;
  for (int i = 0; i < nq; ++i) {
    const int st = i & 1;
    if (i + 1 < nq) {
      stage_rows<HD, MT, MMA_THREADS>(qsm + (st ^ 1) * Sm::tile, qb, (i + 1) * MT, Tq, D, h, tid);
      stage_rows<HD, MT, MMA_THREADS>(gsm + (st ^ 1) * Sm::tile, gb, (i + 1) * MT, Tq, D, h, tid);
      cp_async_commit();
      prefetch((i + 1) * MT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qsm + st * Sm::tile;
    const bf16* gt = gsm + st * Sm::tile;
    // S^T = K (q*scale)^T and dP^T = V dO^T for this warp's 16 keys x 32 queries
    float s[MT / 8][4], dp[MT / 8][4];
    mma_rows_nk<HD, MT / 8>(s, ksm + warp * 16 * STR, qt, lane);
    mma_rows_nk<HD, MT / 8>(dp, vsm + warp * 16 * STR, gt, lane);
    const bf16* bt = bsm + st * Sm::bias;
#pragma unroll
    for (int n = 0; n < MT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ih = e >> 1, c = 8 * n + 2 * t + (e & 1);  // key kr + 8 ih, query c of the tile
        const float L = lse_s[st * MT + c];
        float x = s[n][e];
        if constexpr (BIAS) x += gt_s[st * MT + c] * bf(bt[c * DKDV_BSTR + kr + 8 * ih]);
        const float p = dead ? (kok[ih] ? p_dead : 0.f) : ((kok[ih] && L != -INFINITY) ? exp2f(x * LOG2E - L) : 0.f);
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dl_s[st * MT + c]);
      }
    }
    // dV += round(P)^T dO, dK += round(dS)^T (q*scale): queries are the depth
#pragma unroll
    for (int kc2 = 0; kc2 < MT / 16; ++kc2) {
      uint32_t a[4];
      c_to_a(a, s[2 * kc2], s[2 * kc2 + 1]);
      mma_a_xkn<HD, STR>(dv_acc, a, gt, kc2 * 16, lane);
      c_to_a(a, dp[2 * kc2], dp[2 * kc2 + 1]);
      mma_a_xkn<HD, STR>(dk_acc, a, qt, kc2 * 16, lane);
    }
    if (i + 1 < nq) commit_prefetch(st ^ 1);
    __syncthreads();  // stage st is rewritten by tile i + 2
  }

#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int kj = k0 + kr + 8 * ih;
    if (kj >= Tk) continue;
    const size_t off = ((size_t)b * Tk + kj) * D + h * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n) =
          __floats2bfloat162_rn(dk_acc[n][2 * ih], dk_acc[n][2 * ih + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n) =
          __floats2bfloat162_rn(dv_acc[n][2 * ih], dv_acc[n][2 * ih + 1]);
    }
  }
}

// 3. dQ, dgate, dbias's per-batch terms: block (b, h, 64 queries), warp w
//    queries 16w .. 16w+15, key tiles of 32
template <int HD, bool BIAS>
__global__ void __launch_bounds__(MMA_THREADS) dq_mma_kernel(
    const bf16* __restrict__ qs_g, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ g, const float* __restrict__ key_mask, const float* __restrict__ gate,
    const bf16* __restrict__ bias, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, float* __restrict__ dgate, float* __restrict__ dbias_part, int Tq, int Tk,
    int H, float scale) {
  using namespace attn_mma;
  typedef Dims<HD> Dm;
  typedef DqSmem<HD, BIAS> Sm;
  constexpr int STR = Dm::STR, NT = Dm::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qsm = reinterpret_cast<bf16*>(smem_raw);
  bf16* gsm = qsm + Sm::own;
  bf16* ksm = gsm + Sm::own;       // [2][MT][STR]
  bf16* vsm = ksm + 2 * Sm::tile;  // [2][MT][STR]
  bf16* bsm = vsm + 2 * Sm::tile;  // [2][MB][DQ_BSTR]
  float* valid = reinterpret_cast<float*>(bsm + 2 * Sm::bias);  // [2][MT]
  float* dbs = valid + 2 * MT;                                   // [MB][MT + 1]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * MB, h = blockIdx.y, b = blockIdx.z;
  const int D = H * HD;
  const int r = warp * 16 + gq;  // this thread's queries: r and r + 8 of the block
  float L[2], dlt[2], gtr[2];
  bool live[2];
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int qi = q0 + r + 8 * ih;
    const size_t row = ((size_t)b * H + h) * Tq + (qi < Tq ? qi : 0);
    L[ih] = qi < Tq ? lse[row] * LOG2E : -INFINITY;
    dlt[ih] = qi < Tq ? delta[row] : 0.f;
    gtr[ih] = (BIAS && qi < Tq) ? gate[row] : 0.f;
    live[ih] = L[ih] != -INFINITY;
  }
  const bool dead = lse[((size_t)b * H + h) * Tq] == -INFINITY;  // the batch row has no live key
  const float p_dead = 1.f / (float)oneshot_padded_tk(Tk);

  zero_pad<HD, MMA_THREADS>(qsm, MB, tid);
  zero_pad<HD, MMA_THREADS>(gsm, MB, tid);
  zero_pad<HD, MMA_THREADS>(ksm, 2 * MT, tid);
  zero_pad<HD, MMA_THREADS>(vsm, 2 * MT, tid);
  const bf16* kb = k + (size_t)b * Tk * D;
  const bf16* vb = v + (size_t)b * Tk * D;
  stage_rows<HD, MB, MMA_THREADS>(qsm, qs_g + (size_t)b * Tq * D, q0, Tq, D, h, tid);
  stage_rows<HD, MB, MMA_THREADS>(gsm, g + (size_t)b * Tq * D, q0, Tq, D, h, tid);
  stage_rows<HD, MT, MMA_THREADS>(ksm, kb, 0, Tk, D, h, tid);
  stage_rows<HD, MT, MMA_THREADS>(vsm, vb, 0, Tk, D, h, tid);
  cp_async_commit();

  TileRegs<MB, MT, MMA_THREADS> bpre;  // bias [the block's queries][keys]
  const bf16* bias_h = bias + (size_t)h * Tq * Tk;
  float vpre = 0.f;
  auto prefetch = [&](int k0) {
    if constexpr (BIAS) bpre.load(bias_h, q0, k0, Tq, Tk, Tk, tid);
    if (tid < MT) {
      const int kj = k0 + tid;
      vpre = (kj < Tk && (key_mask == nullptr || key_mask[(size_t)b * Tk + kj] > 0.f)) ? 1.f : 0.f;
    }
  };
  auto commit_prefetch = [&](int st) {
    if constexpr (BIAS) bpre.store(bsm + st * Sm::bias, DQ_BSTR, tid);
    if (tid < MT) valid[st * MT + tid] = vpre;
  };
  prefetch(0);
  commit_prefetch(0);

  float dq_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;
  float dgate_acc[2] = {0.f, 0.f};

  const int nk = (Tk + MT - 1) / MT;
  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    if (j + 1 < nk) {
      stage_rows<HD, MT, MMA_THREADS>(ksm + (st ^ 1) * Sm::tile, kb, (j + 1) * MT, Tk, D, h, tid);
      stage_rows<HD, MT, MMA_THREADS>(vsm + (st ^ 1) * Sm::tile, vb, (j + 1) * MT, Tk, D, h, tid);
      cp_async_commit();
      prefetch((j + 1) * MT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // a tile whose keys are all masked adds nothing (its dbias terms are 0), unless the batch row is dead
    const int any = __syncthreads_or(tid < MT && valid[st * MT + tid] > 0.f) || dead;
    if (any) {
      const bf16* kt = ksm + st * Sm::tile;
      float s[MT / 8][4], dp[MT / 8][4];
      mma_rows_nk<HD, MT / 8>(s, qsm + warp * 16 * STR, kt, lane);
      mma_rows_nk<HD, MT / 8>(dp, gsm + warp * 16 * STR, vsm + st * Sm::tile, lane);
      const bf16* bt = bsm + st * Sm::bias;
#pragma unroll
      for (int n = 0; n < MT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ih = e >> 1, c = 8 * n + 2 * t + (e & 1);  // query r + 8 ih, key c of the tile
          float bij = 0.f;
          if constexpr (BIAS) bij = bf(bt[(r + 8 * ih) * DQ_BSTR + c]);
          const float x = s[n][e] + gtr[ih] * bij;
          const float p = dead ? (j * MT + c < Tk ? p_dead : 0.f)
                               : ((valid[st * MT + c] > 0.f && live[ih]) ? exp2f(x * LOG2E - L[ih]) : 0.f);
          const float ds = p * (dp[n][e] - dlt[ih]);
          if constexpr (BIAS) {
            dgate_acc[ih] = fmaf(ds, bij, dgate_acc[ih]);
            if (dbias_part != nullptr) dbs[(r + 8 * ih) * (MT + 1) + c] = gtr[ih] * ds;
          }
          s[n][e] = ds;
        }
      }
      // dQ += round(dS) K: keys are the depth
#pragma unroll
      for (int kc2 = 0; kc2 < MT / 16; ++kc2) {
        uint32_t a[4];
        c_to_a(a, s[2 * kc2], s[2 * kc2 + 1]);
        mma_a_xkn<HD, STR>(dq_acc, a, kt, kc2 * 16, lane);
      }
    }
    if (BIAS && dbias_part != nullptr) {
      __syncthreads();
      const int k0 = j * MT;
      for (int idx = tid; idx < MB * MT; idx += MMA_THREADS) {  // coalesced along keys
        const int rr = idx / MT, c = idx % MT;
        const int qq = q0 + rr, kk = k0 + c;
        if (qq < Tq && kk < Tk)
          dbias_part[(((size_t)b * H + h) * Tq + qq) * Tk + kk] = any ? dbs[rr * (MT + 1) + c] : 0.f;
      }
    }
    if (j + 1 < nk) commit_prefetch(st ^ 1);
    __syncthreads();  // stage st (and dbs) are rewritten by the next tiles
  }

#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    float dg = dgate_acc[ih];
    dg += __shfl_xor_sync(0xffffffffu, dg, 1);
    dg += __shfl_xor_sync(0xffffffffu, dg, 2);
    const int qi = q0 + r + 8 * ih;
    if (qi >= Tq) continue;
    const size_t off = ((size_t)b * Tq + qi) * D + h * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq + off + 8 * n) =
          __floats2bfloat162_rn(dq_acc[n][2 * ih] * scale, dq_acc[n][2 * ih + 1] * scale);
    if (BIAS && dgate != nullptr && t == 0) dgate[((size_t)b * H + h) * Tq + qi] = dg;
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

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *q, *k, *v, *g, *out, *key_mask, *gate, *bias, *lse;
  void *delta, *qs, *dbias_part, *dq, *dk, *dv, *dgate, *dbias;
  int B, Tq, Tk, H;
  float scale;
  cudaStream_t st;
};

template <int HD, bool BIAS>
cudaError_t passes_bf16(const Args& a) {
  typedef DkdvSmem<HD, BIAS> S2;
  typedef DqSmem<HD, BIAS> S3;
  static bool configured = false;  // the attribute is per kernel and per process
  if (!configured) {
    cudaError_t err = allow_smem(dkdv_mma_kernel<HD, BIAS>, S2::bytes);
    if (err == cudaSuccess) err = allow_smem(dq_mma_kernel<HD, BIAS>, S3::bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dkdv_mma_kernel<HD, BIAS><<<dim3((a.Tk + MB - 1) / MB, a.H, a.B), MMA_THREADS, S2::bytes, a.st>>>(
      (const bf16*)a.qs, (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.g, (const float*)a.key_mask,
      (const float*)a.gate, (const bf16*)a.bias, (const float*)a.lse, (const float*)a.delta, (bf16*)a.dk,
      (bf16*)a.dv, a.Tq, a.Tk, a.H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_mma_kernel<HD, BIAS><<<dim3((a.Tq + MB - 1) / MB, a.H, a.B), MMA_THREADS, S3::bytes, a.st>>>(
      (const bf16*)a.qs, (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.g, (const float*)a.key_mask,
      (const float*)a.gate, (const bf16*)a.bias, (const float*)a.lse, (const float*)a.delta, (bf16*)a.dq,
      (float*)a.dgate, (float*)a.dbias_part, a.Tq, a.Tk, a.H, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t passes_f32(const Args& a) {
  constexpr int THREADS = ROWS * Split<HD>::P;
  dkdv_kernel<HD><<<dim3((a.Tk + ROWS - 1) / ROWS, a.H, a.B), THREADS, 0, a.st>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.g, (const float*)a.key_mask,
      (const float*)a.gate, (const float*)a.bias, (const float*)a.lse, (const float*)a.delta, (float*)a.dk,
      (float*)a.dv, a.Tq, a.Tk, a.H, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<HD><<<dim3((a.Tq + ROWS - 1) / ROWS, a.H, a.B), THREADS, 0, a.st>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.g, (const float*)a.key_mask,
      (const float*)a.gate, (const float*)a.bias, (const float*)a.lse, (const float*)a.delta, (float*)a.dq,
      (float*)a.dgate, (float*)a.dbias_part, a.Tq, a.Tk, a.H, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
int launch_hd(const Args& a) {
  const long long rows = (long long)a.B * a.Tq * a.H;
  delta_kernel<T, HD><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, a.st>>>(
      (const T*)a.g, (const T*)a.out, (const T*)a.q, (T*)a.qs, (float*)a.delta, a.B, a.Tq, a.H, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (sizeof(T) == 2)
    err = a.bias != nullptr ? passes_bf16<HD, true>(a) : passes_bf16<HD, false>(a);
  else
    err = passes_f32<HD>(a);
  if (err != cudaSuccess) return (int)err;
  if (a.dbias != nullptr) {
    const size_t n = (size_t)a.H * a.Tq * a.Tk;
    const size_t blocks = (n + 255) / 256;
    dbias_reduce_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, a.st>>>(
        (const float*)a.dbias_part, (float*)a.dbias, a.B, n);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const Args& a, int hd) {
  if ((a.dbias != nullptr) != (a.dbias_part != nullptr)) return (int)cudaErrorInvalidValue;
  if ((a.dgate != nullptr || a.dbias != nullptr) && a.bias == nullptr) return (int)cudaErrorInvalidValue;
  if ((sizeof(T) == 2) != (a.qs != nullptr)) return (int)cudaErrorInvalidValue;  // bf16 needs the q*scale scratch
  switch (hd) {
    case 64:
      return launch_hd<T, 64>(a);
    case 80:
      return launch_hd<T, 80>(a);
    case 120:
      return launch_hd<T, 120>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, g, out, key_mask, gate, bias, lse, delta scratch [B,H,Tq] f32,
// q*scale scratch [B,Tq,D] (bf16 only, else null), dbias scratch
// [B,H,Tq,Tk] f32 (null unless dbias), dq, dk, dv, dgate [B,H,Tq] f32 (or
// null), dbias [H,Tq,Tk] f32 (or null), B, Tq, Tk, H, hd, scale, stream
#define SER_BWD_ENTRY(NAME, T)                                                                           \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* g, const void* out,    \
                      const void* key_mask, const void* gate, const void* bias, const void* lse,      \
                      void* delta, void* qs, void* dbias_part, void* dq, void* dk, void* dv,          \
                      void* dgate, void* dbias, int B, int Tq, int Tk, int H, int hd, float scale,    \
                      void* stream) {                                                                  \
    const Args a{q,  k,  v,  g,     out,   key_mask, gate, bias, lse, delta, qs, dbias_part,             \
                 dq, dk, dv, dgate, dbias, B,        Tq,   Tk,   H,   scale, (cudaStream_t)stream};      \
    return launch_bwd<T>(a, hd);                                                                       \
  }

SER_BWD_ENTRY(ser_attention_btd_bwd_f32, float)
SER_BWD_ENTRY(ser_attention_btd_bwd_bf16, __nv_bfloat16)
