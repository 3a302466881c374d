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
//   2. dK, dV (key-major): a block owns (b, h, 64 keys; 128 in f32) and
//      streams tiles of queries; a block whose keys are all masked writes
//      zeros and leaves.
//   3. dQ, dgate (query-major): a block owns (b, h, 64 queries; 128 in f32) and streams
//      tiles of keys, skipping a tile whose keys are all masked. When dbias
//      is wanted it writes gate * dS for its batch row to a [B, H, Tq, Tk]
//      f32 scratch (coalesced: through shared memory in bf16, straight from
//      registers in runs of 16 keys in f32).
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
// f32 (dkdv_f32_kernel, dq_f32_kernel), with TF32 off: what every
// `lora_cli` fine-tune runs (LoRAFTEngine's default dtype). IEEE fmaf on the
// FP32 pipes over register-blocked micro-tiles (attention_f32.cuh): 256
// threads a block, each owning 8 of its 128 rows; S (or S^T) and dP as
// 8 x T/16 micro-tiles from padded shared rows (float4 reads), P and dS
// through shared tiles read back only by the half-warp that owns their rows,
// the output accumulators (dK and dV, or dQ) in registers for the whole pass. The streamed tiles, the bias
// tile (which replaces a global load a score), lse, delta, gate and the key
// flags are staged by cp.async and double-buffered, one block barrier a
// tile. What bounds it: the FFMA rate and the shared-memory loads that feed it.
// At the Whisper shape the two passes run seven products (S and dP in
// each), 322 GFLOP, 4.8 ms at the FP32 peak of 67 TFLOP/s; the bound
// counts five (3.4 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_f32.cuh"
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
// f32 on the FP32 pipes (attention_f32.cuh): blocks of 256 threads owning
// 128 rows, 8 a thread (rows g + 16i, g = t >> 4, i < 8); lane l = t & 15
// takes rows l + 16j of the streamed tile. The streamed tiles, the bias tile
// and the per-row vectors are staged by cp.async into stage i & 1 while tile
// i - 1 is computed, one block barrier a tile.

// 2. dK, dV: block (b, h, ROWS keys); query tiles of QT (Plan<DKDV>). K and V
//    stay in shared memory, dK and dV in registers (a thread's 8 keys x
//    hd/16 columns) for the whole pass. Per tile: S^T = K (q*scale)^T and
//    dP^T = V dO^T as 8-key x QT/16-query micro-tiles, P = exp(S - lse),
//    dS = P (dP - delta); P (over the bias tile it came from) and dS go to
//    shared [QT][ROWS + 4] tiles, a thread's keys side by side, that only
//    the keys' own half-warp reads back: dV += P^T dO, dK += dS^T (q*scale).
template <int HD, bool BIAS>
__global__ void __launch_bounds__(attn_f32::THREADS, 1)
    dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ g, const float* __restrict__ key_mask, const float* __restrict__ gate,
                    const float* __restrict__ bias, const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tk, int H, float scale) {
  using namespace attn_f32;
  typedef Cols<HD> Cl;
  typedef Plan<DKDV, HD, BIAS> Pl;
  constexpr int QT = Pl::T, QJ = QT / 16, STR = HD + 4, PSTR = ROWS + 4;
  extern __shared__ __align__(16) float smem_f[];
  float* ksm = smem_f;                             // [ROWS][STR]
  float* vsm = ksm + ROWS * STR;                   // [ROWS][STR]
  float* qsm = vsm + ROWS * STR;                   // [2][QT][STR] q * scale
  float* gsm = qsm + 2 * QT * STR;                 // [2][QT][STR] dO
  float* psm = gsm + 2 * QT * STR;                 // [BIAS ? 2 : 1][QT][PSTR]: the bias tile, then P
  float* dsm = psm + (BIAS ? 2 : 1) * QT * PSTR;   // [QT][PSTR] dS
  float* vec = dsm + QT * PSTR;                    // [2][3][QT] lse, delta, gate

  const int tid = threadIdx.x, l = tid & 15, gi = tid >> 4;
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int D = H * HD;
  const size_t hrow = ((size_t)b * H + h) * Tq;
  const bool dead = lse[hrow] == -INFINITY;  // the batch row has no live key
  const float p_dead = 1.f / (float)attn_mma::oneshot_padded_tk(Tk);
  auto key_ok = [&](int kj) {  // a key with weight (in a dead batch row every key has 1 / Tk_p)
    return kj < Tk && (dead || key_mask == nullptr || key_mask[(size_t)b * Tk + kj] > 0.f);
  };
  if (!__syncthreads_or(tid < ROWS && key_ok(k0 + tid))) {  // every key masked: dK = dV = 0
    for (int idx = tid; idx < ROWS * (HD / 4); idx += THREADS) {
      const int kj = k0 + idx / (HD / 4);
      if (kj < Tk) {
        const size_t off = ((size_t)b * Tk + kj) * D + h * HD + (idx % (HD / 4)) * 4;
        *reinterpret_cast<float4*>(dk + off) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dv + off) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }
  bool kok[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) kok[i] = key_ok(k0 + gi + 16 * i);

  const float* qb = q + (size_t)b * Tq * D;
  const float* gb = g + (size_t)b * Tq * D;
  auto stage = [&](int i, int st) {
    const int q0 = i * QT;
    stage_rows<HD, QT>(qsm + st * QT * STR, qb, q0, Tq, D, h, tid);
    stage_rows<HD, QT>(gsm + st * QT * STR, gb, q0, Tq, D, h, tid);
    if constexpr (BIAS)
      stage_elems<QT, ROWS, RI>(psm + st * QT * PSTR, PSTR, bias + (size_t)h * Tq * Tk, q0, k0, Tq, Tk, Tk, tid);
    float* vs = vec + st * 3 * QT;
    stage_elems<1, QT>(vs, QT, lse + hrow, 0, q0, 1, Tq, 0, tid);
    stage_elems<1, QT>(vs + QT, QT, delta + hrow, 0, q0, 1, Tq, 0, tid);
    if constexpr (BIAS) stage_elems<1, QT>(vs + 2 * QT, QT, gate + hrow, 0, q0, 1, Tq, 0, tid);
    cp_async_commit();
  };
  stage_rows<HD, ROWS>(ksm, k + (size_t)b * Tk * D, k0, Tk, D, h, tid);
  stage_rows<HD, ROWS>(vsm, v + (size_t)b * Tk * D, k0, Tk, D, h, tid);
  stage(0, 0);

  float dk_acc[RI][Cl::NC], dv_acc[RI][Cl::NC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < Cl::NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int nq = (Tq + QT - 1) / QT;
  for (int it = 0; it < nq; ++it) {
    const int st = it & 1;
    cp_async_wait<0>();
    scale_rows<HD, QT>(qsm + st * QT * STR, scale, tid);  // the chunks this thread copied
    __syncthreads();  // stage st ready; tile it - 1 consumed by every thread
    if (it + 1 < nq) stage(it + 1, st ^ 1);
    const float* qt = qsm + st * QT * STR;
    const float* gt = gsm + st * QT * STR;
    const float* vs = vec + st * 3 * QT;
    float* pt = psm + (BIAS ? st : 0) * QT * PSTR + gi * RI;  // this thread's keys, side by side
    float* dt = dsm + gi * RI;
    float s[RI][QJ], dp[RI][QJ];
    dot_tile<HD, RI, QJ>(s, ksm + gi * STR, 16 * STR, qt + l * STR, 16 * STR);  // S^T, as K1 forms S
#pragma unroll
    for (int jj = 0; jj < QJ; ++jj) {
      const int c = l + 16 * jj, qi = it * QT + c;
      const float L = vs[c];
#pragma unroll
      for (int e = 0; e < RI / 4; ++e) {
        float4 bb = make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (BIAS) bb = *reinterpret_cast<const float4*>(pt + c * PSTR + 4 * e);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = 4 * e + u;
          float x = s[i][jj];
          if constexpr (BIAS) x = fmaf(vs[2 * QT + c], comp(bb, u), x);
          s[i][jj] = dead ? (k0 + gi + 16 * i < Tk && qi < Tq ? p_dead : 0.f)
                          : ((kok[i] && qi < Tq && L != -INFINITY) ? expf(x - L) : 0.f);
        }
        *reinterpret_cast<float4*>(pt + c * PSTR + 4 * e) =
            make_float4(s[4 * e][jj], s[4 * e + 1][jj], s[4 * e + 2][jj], s[4 * e + 3][jj]);
      }
    }
    dot_tile<HD, RI, QJ>(dp, vsm + gi * STR, 16 * STR, gt + l * STR, 16 * STR);  // dP^T
#pragma unroll
    for (int jj = 0; jj < QJ; ++jj) {
      const int c = l + 16 * jj;
      const float dl = vs[QT + c];
#pragma unroll
      for (int e = 0; e < RI / 4; ++e)
        *reinterpret_cast<float4*>(dt + c * PSTR + 4 * e) = make_float4(
            s[4 * e][jj] * (dp[4 * e][jj] - dl), s[4 * e + 1][jj] * (dp[4 * e + 1][jj] - dl),
            s[4 * e + 2][jj] * (dp[4 * e + 2][jj] - dl), s[4 * e + 3][jj] * (dp[4 * e + 3][jj] - dl));
    }
    __syncwarp();  // the keys' P and dS come from this half-warp alone
    acc_tile<HD, RI, QT, false>(dv_acc, pt, PSTR, gt, STR, l);  // dV += P^T dO
    acc_tile<HD, RI, QT, false>(dk_acc, dt, PSTR, qt, STR, l);  // dK += dS^T (q*scale)
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kj = k0 + gi + 16 * i;
    if (kj >= Tk) continue;
    const size_t off = ((size_t)b * Tk + kj) * D + h * HD;
    store_cols<HD>(dk + off, dk_acc[i], 1.f, l);
    store_cols<HD>(dv + off, dv_acc[i], 1.f, l);
  }
}

// 3. dQ, dgate, dbias's per-batch terms: block (b, h, ROWS queries); key
//    tiles of KT (Plan<DQ>), a tile whose keys are all masked skipped (unless
//    the batch row is dead). q * scale and dO stay in shared memory, dQ in
//    registers. S and dP as 8-query x KT/16-key micro-tiles (S exactly as K1
//    forms it), dS = P (dP - delta) to shared memory over the bias tile,
//    dQ += dS K; dgate = rowsum(dS * bias) per thread in key order, then over
//    the row's half-warp; gate * dS goes straight from registers to the
//    [B, H, Tq, Tk] scratch (each store instruction fills two runs of 16
//    consecutive keys).
template <int HD, bool BIAS>
__global__ void __launch_bounds__(attn_f32::THREADS, 1)
    dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ g, const float* __restrict__ key_mask, const float* __restrict__ gate,
                  const float* __restrict__ bias, const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, float* __restrict__ dgate, float* __restrict__ dbias_part, int Tq, int Tk,
                  int H, float scale) {
  using namespace attn_f32;
  typedef Cols<HD> Cl;
  typedef Plan<DQ, HD, BIAS> Pl;
  constexpr int KT = Pl::T, KJ = KT / 16, STR = HD + 4, BSTR = KT + 4;
  extern __shared__ __align__(16) float smem_f[];
  float* qsm = smem_f;                             // [ROWS][STR] q * scale
  float* gsm = qsm + ROWS * STR;                   // [ROWS][STR] dO
  float* ksm = gsm + ROWS * STR;                   // [2][KT][STR]
  float* vsm = ksm + 2 * KT * STR;                 // [2][KT][STR]
  float* bsm = vsm + 2 * KT * STR;                 // [BIAS ? 2 : 1][ROWS][BSTR]: the bias tile, then dS
  float* fl = bsm + (BIAS ? 2 : 1) * ROWS * BSTR;  // [2][KT] key flags

  const int tid = threadIdx.x, l = tid & 15, gi = tid >> 4;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int D = H * HD;
  const size_t hrow = ((size_t)b * H + h) * Tq;
  const bool dead = lse[hrow] == -INFINITY;  // the batch row has no live key
  const float p_dead = 1.f / (float)attn_mma::oneshot_padded_tk(Tk);
  float L[RI], dlt[RI], gtr[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + gi + 16 * i;
    L[i] = qi < Tq ? lse[hrow + qi] : -INFINITY;  // -inf: no weight (a row past Tq)
    dlt[i] = qi < Tq ? delta[hrow + qi] : 0.f;
    gtr[i] = (BIAS && qi < Tq) ? gate[hrow + qi] : 0.f;
  }

  const float* kb = k + (size_t)b * Tk * D;
  const float* vb = v + (size_t)b * Tk * D;
  const float* mask_b = key_mask != nullptr ? key_mask + (size_t)b * Tk : nullptr;
  auto stage = [&](int j, int st) {
    const int k0 = j * KT;
    stage_rows<HD, KT>(ksm + st * KT * STR, kb, k0, Tk, D, h, tid);
    stage_rows<HD, KT>(vsm + st * KT * STR, vb, k0, Tk, D, h, tid);
    if constexpr (BIAS)
      stage_elems<ROWS, KT>(bsm + st * ROWS * BSTR, BSTR, bias + (size_t)h * Tq * Tk, q0, k0, Tq, Tk, Tk, tid);
    if (tid < KT) {
      const int kj = k0 + tid;
      if (mask_b != nullptr) cp_async4(fl + st * KT + tid, kj < Tk ? mask_b + kj : mask_b, kj < Tk);
      else fl[st * KT + tid] = kj < Tk ? 1.f : 0.f;
    }
    cp_async_commit();
  };
  stage_rows<HD, ROWS>(qsm, q + (size_t)b * Tq * D, q0, Tq, D, h, tid);
  stage_rows<HD, ROWS>(gsm, g + (size_t)b * Tq * D, q0, Tq, D, h, tid);
  stage(0, 0);

  float dq_acc[RI][Cl::NC], dgate_acc[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    dgate_acc[i] = 0.f;
#pragma unroll
    for (int c = 0; c < Cl::NC; ++c) dq_acc[i][c] = 0.f;
  }

  const int nk = (Tk + KT - 1) / KT;
  for (int j = 0; j < nk; ++j) {
    const int st = j & 1, k0 = j * KT;
    cp_async_wait<0>();
    if (j == 0) scale_rows<HD, ROWS>(qsm, scale, tid);  // the chunks this thread copied
    // the one barrier of the tile; a tile whose keys are all masked adds
    // nothing (its dbias terms are 0), unless the batch row is dead
    const bool any = __syncthreads_or(tid < KT && fl[st * KT + tid] > 0.f) || dead;
    if (j + 1 < nk) stage(j + 1, st ^ 1);
    if (!any) {
      if (BIAS && dbias_part != nullptr) {
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int jj = 0; jj < KJ; ++jj) {
            const int qi = q0 + gi + 16 * i, kj = k0 + l + 16 * jj;
            if (qi < Tq && kj < Tk) dbias_part[(hrow + qi) * Tk + kj] = 0.f;
          }
      }
      continue;
    }
    const float* ft = fl + st * KT;
    const float* kt = ksm + st * KT * STR;
    float* bt = bsm + (BIAS ? st : 0) * ROWS * BSTR + gi * BSTR;  // row i of this thread at bt + 16 i BSTR
    float s[RI][KJ], dp[RI][KJ], bij[RI][KJ];
    dot_tile<HD, RI, KJ>(s, qsm + gi * STR, 16 * STR, kt + l * STR, 16 * STR);  // S, as K1 forms it
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) {
        const int c = l + 16 * jj;
        float x = s[i][jj];
        bij[i][jj] = 0.f;
        if constexpr (BIAS) {
          bij[i][jj] = bt[16 * i * BSTR + c];
          x = fmaf(gtr[i], bij[i][jj], x);
        }
        s[i][jj] = dead ? (k0 + c < Tk ? p_dead : 0.f)
                        : ((ft[c] > 0.f && L[i] != -INFINITY) ? expf(x - L[i]) : 0.f);
      }
    dot_tile<HD, RI, KJ>(dp, gsm + gi * STR, 16 * STR, vsm + st * KT * STR + l * STR, 16 * STR);  // dP
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = q0 + gi + 16 * i;
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) {
        const int c = l + 16 * jj;
        const float ds = s[i][jj] * (dp[i][jj] - dlt[i]);
        if constexpr (BIAS) {
          dgate_acc[i] = fmaf(ds, bij[i][jj], dgate_acc[i]);
          if (dbias_part != nullptr && qi < Tq && k0 + c < Tk) dbias_part[(hrow + qi) * Tk + k0 + c] = gtr[i] * ds;
        }
        bt[16 * i * BSTR + c] = ds;  // where this thread read its bias: no other thread's
      }
    }
    __syncwarp();  // the rows' dS come from this half-warp alone
    acc_tile<HD, RI, KT, true>(dq_acc, bt, 16 * BSTR, kt, STR, l);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const float dg = half_warp_sum(dgate_acc[i]);
    const int qi = q0 + gi + 16 * i;
    if (qi >= Tq) continue;
    store_cols<HD>(dq + ((size_t)b * Tq + qi) * D + h * HD, dq_acc[i], scale, l);
    if (BIAS && dgate != nullptr && l == 0) dgate[hrow + qi] = dg;
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

template <int HD, bool BIAS>
cudaError_t passes_f32(const Args& a) {
  using namespace attn_f32;
  typedef Plan<DKDV, HD, BIAS> P2;
  typedef Plan<DQ, HD, BIAS> P3;
  static bool configured = false;  // the attribute is per kernel and per process
  if (!configured) {
    cudaError_t err = allow_smem(dkdv_f32_kernel<HD, BIAS>, P2::BYTES);
    if (err == cudaSuccess) err = allow_smem(dq_f32_kernel<HD, BIAS>, P3::BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dkdv_f32_kernel<HD, BIAS><<<dim3((a.Tk + ROWS - 1) / ROWS, a.H, a.B), THREADS, P2::BYTES, a.st>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.g, (const float*)a.key_mask,
      (const float*)a.gate, (const float*)a.bias, (const float*)a.lse, (const float*)a.delta, (float*)a.dk,
      (float*)a.dv, a.Tq, a.Tk, a.H, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_f32_kernel<HD, BIAS><<<dim3((a.Tq + ROWS - 1) / ROWS, a.H, a.B), THREADS, P3::BYTES, a.st>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.g, (const float*)a.key_mask,
      (const float*)a.gate, (const float*)a.bias, (const float*)a.lse, (const float*)a.delta, (float*)a.dq,
      (float*)a.dgate, (float*)a.dbias_part, a.Tq, a.Tk, a.H, a.scale);
  return cudaGetLastError();
}

// tile, shared bytes and resident blocks an SM of the dK/dV (kind 1) or dQ
// (kind 2) f32 pass
template <int KIND, int HD, bool BIAS, typename K>
int f32_plan_of(K kernel, int* out) {
  typedef attn_f32::Plan<KIND, HD, BIAS> Pl;
  cudaError_t err = allow_smem(kernel, Pl::BYTES);
  if (err != cudaSuccess) return (int)err;
  out[0] = Pl::T;
  out[1] = (int)Pl::BYTES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, attn_f32::THREADS, Pl::BYTES);
}

template <int HD, bool BIAS>
int f32_plan(int kind, int* out) {
  return kind == attn_f32::DKDV ? f32_plan_of<attn_f32::DKDV, HD, BIAS>(dkdv_f32_kernel<HD, BIAS>, out)
                                : f32_plan_of<attn_f32::DQ, HD, BIAS>(dq_f32_kernel<HD, BIAS>, out);
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
    err = a.bias != nullptr ? passes_f32<HD, true>(a) : passes_f32<HD, false>(a);
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

// out: [tile, shared bytes, blocks an SM] of the f32 dK/dV (kind 1) or dQ (kind 2) pass
extern "C" int ser_attention_btd_bwd_f32_plan(int kind, int hd, int bias, int* out) {
  if (kind != attn_f32::DKDV && kind != attn_f32::DQ) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return bias ? f32_plan<64, true>(kind, out) : f32_plan<64, false>(kind, out);
    case 80:
      return bias ? f32_plan<80, true>(kind, out) : f32_plan<80, false>(kind, out);
    case 120:
      return bias ? f32_plan<120, true>(kind, out) : f32_plan<120, false>(kind, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
SER_BWD_ENTRY(ser_attention_btd_bwd_bf16, __nv_bfloat16)
