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
// over 16 heads), a template parameter. The TPU kernel held a whole
// [Tk, D] K/V panel in VMEM (about 4 MB at Tk=499, D=1024 in f32), far over
// the 227 KB of shared memory a block may use; both kernels here stream K/V
// tiles of 64 keys (32 in f32 at hd 120 with a bias) with an online softmax
// (running max and denominator in f32), so they have no length limit. One
// block owns (b, h, 64 queries) in bf16, (b, h, 128 queries) in f32.
//
// bf16, on the tensor cores (attention_btd_mma_kernel): 4 warps, each
// owning 16 query rows. K and V tiles are staged by cp.async into padded
// shared rows and double-buffered, the bias tile and the key flags travel
// through registers, so tile j+1 loads while tile j is computed.
// S = round_bf16(q*scale) . K^T runs on mma.sync.m16n8k16 (bf16 in, f32
// out; fragments by ldmatrix), hd 120 zero-padded to a depth of 128 in
// shared memory only; bias, gate and mask are applied in the accumulator's
// fragment layout, the online softmax stays in f32 registers (exp2 of
// log2e-scaled scores), and P, rounded to bf16, is used straight from its
// accumulator registers as the A operand of P.V, with V's fragments by
// ldmatrix.trans, hd in n8 steps (8, 10, 15). A tile whose keys are all
// masked is skipped by the whole block. What bounds it: at WavLM shapes the
// products are ~5 GFLOP, 5 us at the bf16 peak, and q/k/v/out are read or
// written once (15 MB, 4.4 us at 3.35 TB/s); the kernel is bound by
// mma.sync issue (wgmma, which needs 64-row warpgroup tiles and TMA-fed
// shared operands, is later work), by the f32 softmax between the two
// products and by the 2-byte bias loads (a bias row of Tk bf16 values
// starts on any 2-byte boundary, so cp.async cannot stage it).
//
// f32 (attention_btd_f32_kernel), with TF32 off as in the reference's f32
// mode, stays on the FP32 pipes as IEEE fmaf: the default `--dtype` of every
// extraction CLI and of every `lora_cli` fine-tune. Block (b, h, 128
// queries), 256 threads, each owning an 8-query x (BK / 16)-key micro-tile
// of S and an 8-query x hd/16-column micro-tile of the output, from operands
// in shared memory (attention_f32.cuh: padded rows, float4 reads, 10.7 FMAs
// a load at BK = 64). q * scale stays in shared memory for the block's life;
// K, V, the bias tile and the key flags are staged by cp.async and
// double-buffered, one block barrier a tile. The online softmax stays in
// registers: a row's 16 threads are one half-warp, its max and sum go over
// them by xor-shuffles (a fixed order: the same bits on a rerun); P goes to
// shared memory ([128][BK + 4], over the bias tile it came from) and only
// the row's own half-warp reads it back. What bounds it: the products are ~5
// GFLOP at WavLM shapes (0.08 ms at the FP32 peak of 67 TFLOP/s), so the
// FFMA rate, the shared-memory loads that feed it and the expf of the softmax;
// q/k/v/out move 65 MB (0.02 ms). The shared [H, Tq, Tk] bias (16 MB in f32
// at T=499) stays in the 50 MB L2 across the batch.
//
// Masked keys (key_mask == 0, or index >= Tk) get no weight at all: a tile
// whose keys are all masked leaves the running max, denominator and
// accumulator untouched, instead of adding exp(0) terms. A batch row whose
// keys are ALL masked (the mask is per batch row, so every query row of the
// block at once) gets what the TPU kernel gives it: there every key weighs
// exp(0) = 1, and so do the zero keys it pads Tk with to Tk_p, a multiple of
// 128, so each of its query rows is sum(V over the Tk keys) / Tk_p. The
// block finds that case at the end (no row has l > 0) and sums V's columns
// in one more pass over the keys.
//
// With a non-null `lse` the kernel also writes each row's log-sum-exp
// m + log(l) ([B, H, Tq] f32), so that K4 (attention_btd_bwd.cu) can
// recompute P = exp(s - lse) without a second pass over the keys; a row
// whose keys are all masked gets -inf, which K4 reads as P = 1 / Tk_p on
// every key. Inference passes null and writes nothing more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_f32.cuh"
#include "attention_mma.cuh"

namespace {

constexpr int BQ = 64;  // queries per block
constexpr int BK = 64;  // keys per tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Every query row of a block whose batch row has no live key:
// out = sum_j V[j] / Tk_p, in f32, one column a thread; `colsum` holds HD floats.
template <typename T>
__device__ __forceinline__ void dead_rows_colsum(float* colsum, const T* __restrict__ v, int b, int h, int Tk,
                                                 int D, int HD, int tid, int nthreads) {
  const float tkp = (float)attn_mma::oneshot_padded_tk(Tk);
  for (int c = tid; c < HD; c += nthreads) {
    const T* col = v + (size_t)b * Tk * D + h * HD + c;
    float s = 0.f;
    for (int j = 0; j < Tk; ++j) s += to_f(col[(size_t)j * D]);
    colsum[c] = s / tkp;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// f32 on the FP32 pipes (attention_f32.cuh): block (b, h, 128 queries), 256
// threads; thread t owns queries g + 16i, g = t >> 4, i < 8, and, of each
// key tile of BK (64, or 32 at hd 120 with a bias), keys l + 16j, l = t & 15.
// The tile's K, V, bias and key flags are staged by cp.async (16 bytes a
// chunk for the K and V panels; 4 bytes for the bias and flags, whose rows
// start on any 4-byte boundary) into stage j & 1 while tile j - 1 is
// computed; one block barrier a tile.
template <int HD, bool BIAS>
__global__ void __launch_bounds__(attn_f32::THREADS, 1)
    attention_btd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                             const float* __restrict__ key_mask,  // [B, Tk] or null
                             const float* __restrict__ gate,      // [B, H, Tq] (with bias)
                             const float* __restrict__ bias,      // [H, Tq, Tk] (with bias)
                             float* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, int H, float scale) {
  using namespace attn_f32;
  typedef Cols<HD> Cl;
  typedef Plan<FWD, HD, BIAS> Pl;
  constexpr int BK = Pl::T, RJ = BK / 16, STR = HD + 4, PSTR = BK + 4;
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;                             // [ROWS][STR] q * scale
  float* ks = qs + ROWS * STR;                    // [2][BK][STR]
  float* vs = ks + 2 * BK * STR;                  // [2][BK][STR]
  float* ps = vs + 2 * BK * STR;                  // [BIAS ? 2 : 1][ROWS][PSTR]: the bias tile, then P
  float* fl = ps + (BIAS ? 2 : 1) * ROWS * PSTR;  // [2][BK] key flags (> 0: live)

  const int tid = threadIdx.x, l = tid & 15, g = tid >> 4;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int D = H * HD;
  const float* kb = k + (size_t)b * Tk * D;
  const float* vb = v + (size_t)b * Tk * D;
  const float* mask_b = key_mask != nullptr ? key_mask + (size_t)b * Tk : nullptr;

  auto stage = [&](int j, int st) {
    const int k0 = j * BK;
    stage_rows<HD, BK>(ks + st * BK * STR, kb, k0, Tk, D, h, tid);
    stage_rows<HD, BK>(vs + st * BK * STR, vb, k0, Tk, D, h, tid);
    if constexpr (BIAS) stage_elems<ROWS, BK>(ps + st * ROWS * PSTR, PSTR, bias + (size_t)h * Tq * Tk, q0, k0, Tq, Tk, Tk, tid);
    if (tid < BK) {
      const int kj = k0 + tid;
      if (mask_b != nullptr) cp_async4(fl + st * BK + tid, kj < Tk ? mask_b + kj : mask_b, kj < Tk);
      else fl[st * BK + tid] = kj < Tk ? 1.f : 0.f;
    }
    cp_async_commit();
  };
  stage(0, 0);
  // q * scale in f32 (the bf16 kernel rounds the same product to bf16)
  for (int idx = tid; idx < ROWS * (HD / 4); idx += THREADS) {
    const int r = idx / (HD / 4), c = (idx % (HD / 4)) * 4, qi = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < Tq) x = *reinterpret_cast<const float4*>(q + ((size_t)b * Tq + qi) * D + h * HD + c);
    *reinterpret_cast<float4*>(qs + r * STR + c) = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }
  float gr[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + g + 16 * i;
    gr[i] = (BIAS && qi < Tq) ? gate[((size_t)b * H + h) * Tq + qi] : 0.f;
  }

  float o[RI][Cl::NC], m[RI], lsum[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    lsum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < Cl::NC; ++c) o[i][c] = 0.f;
  }

  const int nt = (Tk + BK - 1) / BK;
  for (int j = 0; j < nt; ++j) {
    const int st = j & 1;
    cp_async_wait<0>();
    // the one barrier of the tile: stage st has landed, and every thread is
    // done with tile j - 1, whose stage the next copies overwrite
    const int any = __syncthreads_or(tid < BK && fl[st * BK + tid] > 0.f);
    if (j + 1 < nt) stage(j + 1, st ^ 1);
    if (!any) continue;  // every key of the tile masked: nothing changes
    const float* ft = fl + st * BK;
    float* pt = ps + (BIAS ? st : 0) * ROWS * PSTR + g * PSTR;  // row i of this thread at pt + 16 i PSTR
    float s[RI][RJ];
    dot_tile<HD, RI, RJ>(s, qs + g * STR, 16 * STR, ks + st * BK * STR + l * STR, 16 * STR);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        const int c = l + 16 * jj;
        float x = s[i][jj];
        if constexpr (BIAS) x = fmaf(gr[i], pt[16 * i * PSTR + c], x);
        x = ft[c] > 0.f ? x : -INFINITY;
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      // a row with no live key yet: o and l are 0 and stay 0 (exp(-inf) = 0)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      lsum[i] *= alpha;
#pragma unroll
      for (int c = 0; c < Cl::NC; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        const float p = expf(s[i][jj] - m_use);
        lsum[i] += p;
        pt[16 * i * PSTR + l + 16 * jj] = p;  // where this thread read its bias: no other thread's
      }
      m[i] = m_new;
    }
    __syncwarp();  // the rows' P come from this half-warp alone
    acc_tile<HD, RI, BK, true>(o, pt, 16 * PSTR, vs + st * BK * STR, STR, l);
  }

  bool live = false;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    lsum[i] = half_warp_sum(lsum[i]);
    live |= lsum[i] > 0.f;
  }
  // the batch row has no live key: every row is sum(V) / Tk_p, into qs[0 .. HD)
  const bool dead = !__syncthreads_or(live);
  if (dead) dead_rows_colsum<float>(qs, v, b, h, Tk, D, HD, tid, THREADS);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + g + 16 * i;
    if (qi >= Tq) continue;
    float* orow = out + ((size_t)b * Tq + qi) * D + h * HD;
    if (dead) {
      float col[Cl::NC];
#pragma unroll
      for (int m4 = 0; m4 < Cl::NF4; ++m4)
#pragma unroll
        for (int e = 0; e < 4; ++e) col[4 * m4 + e] = Cl::has(m4, l) ? qs[64 * m4 + 4 * l + e] : 0.f;
      if constexpr (Cl::TAIL) col[4 * Cl::NF4] = qs[64 + l];
      store_cols<HD>(orow, col, 1.f, l);
    } else {
      store_cols<HD>(orow, o[i], 1.f / fmaxf(lsum[i], 1e-30f), l);
    }
    if (lse != nullptr && l == 0) lse[((size_t)b * H + h) * Tq + qi] = dead ? -INFINITY : m[i] + logf(lsum[i]);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores. Block: (b, h, 64 queries), 4 warps, warp w owns
// query rows 16w .. 16w+15. Key tiles of 64: K, V by cp.async and the bias
// tile and key flags through registers, both double-buffered, so tile j+1
// loads while tile j is computed.

constexpr int MMA_THREADS = 128;
constexpr int BIAS_STR = BK + 8;  // bias tile row stride: the 8 rows of a fragment read hit 8 bank groups

template <int HD, bool BIAS>
struct FwdSmem {
  typedef attn_mma::Dims<HD> Dm;
  static constexpr size_t q_elems = (size_t)BQ * Dm::STR;
  static constexpr size_t kv_elems = (size_t)BK * Dm::STR;  // one stage of K (or V)
  static constexpr size_t bias_elems = BIAS ? (size_t)BQ * BIAS_STR : 0;
  static constexpr size_t bytes =
      (q_elems + 4 * kv_elems + 2 * bias_elems) * sizeof(__nv_bfloat16) + 2 * BK * sizeof(float);
};

template <int HD, bool BIAS>
__global__ void __launch_bounds__(MMA_THREADS) attention_btd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_mask,
    const float* __restrict__ gate, const __nv_bfloat16* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, int H, float scale) {
  using namespace attn_mma;
  typedef Dims<HD> Dm;
  typedef FwdSmem<HD, BIAS> Sm;
  constexpr int STR = Dm::STR, NT = Dm::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + Sm::q_elems;        // [2][BK][STR]
  bf16* vs = ks + 2 * Sm::kv_elems;   // [2][BK][STR]
  bf16* bs = vs + 2 * Sm::kv_elems;   // [2][BQ][BIAS_STR]
  float* valid = reinterpret_cast<float*>(bs + 2 * Sm::bias_elems);  // [2][BK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int D = H * HD;
  const bf16* kb = k + (size_t)b * Tk * D;
  const bf16* vb = v + (size_t)b * Tk * D;

  zero_pad<HD, MMA_THREADS>(qs, BQ, tid);
  zero_pad<HD, MMA_THREADS>(ks, 2 * BK, tid);
  zero_pad<HD, MMA_THREADS>(vs, 2 * BK, tid);

  // q * scale rounded to bf16 (the scale rounded first), as the f32-pipe kernel does
  const float sc = round_to<__nv_bfloat16>(scale);
  for (int idx = tid; idx < BQ * Dm::CH; idx += MMA_THREADS) {
    const int r = idx / Dm::CH, c = (idx % Dm::CH) * 8;
    const int qi = q0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (qi < Tq) raw = *reinterpret_cast<const uint4*>(q + ((size_t)b * Tq + qi) * D + h * HD + c);
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(p2[e]);
      p2[e] = __floats2bfloat162_rn(f.x * sc, f.y * sc);
    }
    *reinterpret_cast<uint4*>(qs + r * STR + c) = raw;
  }

  // the next tile's bias and key flags travel through registers
  TileRegs<BQ, BK, MMA_THREADS> bpre;
  const bf16* bias_h = bias + (size_t)h * Tq * Tk;
  float vpre = 0.f;
  auto prefetch = [&](int k0) {
    if constexpr (BIAS) bpre.load(bias_h, q0, k0, Tq, Tk, Tk, tid);
    if (tid < BK) {
      const int kj = k0 + tid;
      vpre = (kj < Tk && (key_mask == nullptr || key_mask[(size_t)b * Tk + kj] > 0.f)) ? 1.f : 0.f;
    }
  };
  auto commit_prefetch = [&](int st) {
    if constexpr (BIAS) bpre.store(bs + st * Sm::bias_elems, BIAS_STR, tid);
    if (tid < BK) valid[st * BK + tid] = vpre;
  };

  const int nt = (Tk + BK - 1) / BK;
  stage_rows<HD, BK, MMA_THREADS>(ks, kb, 0, Tk, D, h, tid);
  stage_rows<HD, BK, MMA_THREADS>(vs, vb, 0, Tk, D, h, tid);
  cp_async_commit();
  prefetch(0);
  commit_prefetch(0);

  const int r_lo = warp * 16 + g;  // this thread's two rows: r_lo and r_lo + 8
  float gr[2] = {0.f, 0.f};
  if constexpr (BIAS) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + r_lo + 8 * i;
      gr[i] = qi < Tq ? gate[((size_t)b * H + h) * Tq + qi] : 0.f;
    }
  }
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the denominator
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int j = 0; j < nt; ++j) {
    const int st = j & 1;
    if (j + 1 < nt) {
      stage_rows<HD, BK, MMA_THREADS>(ks + (st ^ 1) * Sm::kv_elems, kb, (j + 1) * BK, Tk, D, h, tid);
      stage_rows<HD, BK, MMA_THREADS>(vs + (st ^ 1) * Sm::kv_elems, vb, (j + 1) * BK, Tk, D, h, tid);
      cp_async_commit();
      prefetch((j + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // a tile whose keys are all masked changes nothing: the block skips it
    const int any = __syncthreads_or(tid < BK && valid[st * BK + tid] > 0.f);
    if (any) {
      // S = round(q*scale) K^T: Q's fragments are reloaded from shared memory
      // each tile, which keeps registers for the accumulators
      float s[BK / 8][4];
      mma_rows_nk<HD, BK / 8>(s, qs + warp * 16 * STR, ks + st * Sm::kv_elems, lane);
      // bias, mask and the row max, in the accumulator's layout
      const float* vt = valid + st * BK;
      const bf16* bt = bs + st * Sm::bias_elems;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, c = 8 * n + 2 * t + (e & 1);
          float x = s[n][e];
          if constexpr (BIAS) x += gr[i] * bf(bt[(r_lo + 8 * i) * BIAS_STR + c]);
          x = vt[c] > 0.f ? x * LOG2E : -INFINITY;
          s[n][e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        // a row with no live key yet: o and l are 0 and stay 0 (exp2(-inf) = 0)
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[i] - m_use);
        l[i] *= alpha;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[n][2 * i] *= alpha;
          o[n][2 * i + 1] *= alpha;
        }
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          const float p0 = exp2f(s[n][2 * i] - m_use), p1 = exp2f(s[n][2 * i + 1] - m_use);
          l[i] += p0 + p1;
          s[n][2 * i] = p0;
          s[n][2 * i + 1] = p1;
        }
        m[i] = m_new;
      }
      // O += round_bf16(P) . V: P's accumulator fragments are the A operand
      const bf16* vt2 = vs + st * Sm::kv_elems;
#pragma unroll
      for (int kc2 = 0; kc2 < BK / 16; ++kc2) {
        uint32_t a[4];
        c_to_a(a, s[2 * kc2], s[2 * kc2 + 1]);
        mma_a_xkn<HD, STR>(o, a, vt2, kc2 * 16, lane);
      }
    }
    if (j + 1 < nt) commit_prefetch(st ^ 1);
    __syncthreads();  // stage st is rewritten by tile j + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const bool dead = !__syncthreads_or(l[0] > 0.f || l[1] > 0.f);  // the batch row has no live key
  if (dead) dead_rows_colsum<bf16>(valid, v, b, h, Tk, D, HD, tid, MMA_THREADS);  // valid: 2 * BK >= HD floats
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r_lo + 8 * i;
    if (qi >= Tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = out + ((size_t)b * Tq + qi) * D + h * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(orow + c) =
          dead ? __floats2bfloat162_rn(valid[c], valid[c + 1])
               : __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
    if (lse != nullptr && t == 0)
      lse[((size_t)b * H + h) * Tq + qi] = dead ? -INFINITY : m[i] * LN2 + logf(l[i]);
  }
}

template <int HD, bool BIAS>
int launch_mma(const void* q, const void* k, const void* v, const void* key_mask, const void* gate,
               const void* bias, void* out, void* lse, int B, int Tq, int Tk, int H, float scale,
               void* stream) {
  constexpr size_t bytes = FwdSmem<HD, BIAS>::bytes;
  static bool configured = false;  // the attribute is per kernel and per process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(attention_btd_mma_kernel<HD, BIAS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  attention_btd_mma_kernel<HD, BIAS><<<grid, MMA_THREADS, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const float*)key_mask,
      (const float*)gate, (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, (float*)lse, Tq, Tk, H, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mma_hd(const void* q, const void* k, const void* v, const void* key_mask, const void* gate,
                  const void* bias, void* out, void* lse, int B, int Tq, int Tk, int H, float scale,
                  void* stream) {
  return bias != nullptr
             ? launch_mma<HD, true>(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, scale, stream)
             : launch_mma<HD, false>(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, scale, stream);
}

// f32 on the FP32 pipes
template <int HD, bool BIAS>
int launch_f32_hd(const void* q, const void* k, const void* v, const void* key_mask, const void* gate,
                  const void* bias, void* out, void* lse, int B, int Tq, int Tk, int H, float scale, void* stream) {
  using namespace attn_f32;
  typedef Plan<FWD, HD, BIAS> Pl;
  constexpr size_t bytes = Pl::BYTES;
  static bool configured = false;  // the attribute is per kernel and per process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(attention_btd_f32_kernel<HD, BIAS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((Tq + ROWS - 1) / ROWS, H, B);
  attention_btd_f32_kernel<HD, BIAS><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)key_mask, (const float*)gate,
      (const float*)bias, (float*)out, (float*)lse, Tq, Tk, H, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32_bias(const void* q, const void* k, const void* v, const void* key_mask, const void* gate,
                    const void* bias, void* out, void* lse, int B, int Tq, int Tk, int H, float scale, void* stream) {
  return bias != nullptr
             ? launch_f32_hd<HD, true>(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, scale, stream)
             : launch_f32_hd<HD, false>(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, scale, stream);
}

int launch_f32(const void* q, const void* k, const void* v, const void* key_mask,
               const void* gate, const void* bias, void* out, void* lse, int B, int Tq,
               int Tk, int H, int hd, float scale, void* stream) {
  switch (hd) {
    case 64:
      return launch_f32_bias<64>(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, scale, stream);
    case 80:
      return launch_f32_bias<80>(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, scale, stream);
    case 120:
      return launch_f32_bias<120>(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// tile, shared bytes and resident blocks an SM of the f32 kernel at (HD, BIAS)
template <int HD, bool BIAS>
int f32_plan(int* out) {
  using namespace attn_f32;
  typedef Plan<FWD, HD, BIAS> Pl;
  constexpr int t = Pl::T;
  constexpr size_t bytes = Pl::BYTES;
  cudaError_t err = cudaFuncSetAttribute(attention_btd_f32_kernel<HD, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = t;
  out[1] = (int)bytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], attention_btd_f32_kernel<HD, BIAS>, THREADS,
                                                            bytes);
}

int launch_bf16(const void* q, const void* k, const void* v, const void* key_mask,
                const void* gate, const void* bias, void* out, void* lse, int B, int Tq,
                int Tk, int H, int hd, float scale, void* stream) {
  switch (hd) {
    case 64:
      return launch_mma_hd<64>(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, scale, stream);
    case 80:
      return launch_mma_hd<80>(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, scale, stream);
    case 120:
      return launch_mma_hd<120>(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, scale, stream);
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
  return launch_f32(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, hd, scale, stream);
}

// out: [tile keys, shared bytes, blocks an SM] of the f32 kernel at head dim hd, with or without the bias
extern "C" int ser_attention_btd_f32_plan(int hd, int bias, int* out) {
  switch (hd) {
    case 64:
      return bias ? f32_plan<64, true>(out) : f32_plan<64, false>(out);
    case 80:
      return bias ? f32_plan<80, true>(out) : f32_plan<80, false>(out);
    case 120:
      return bias ? f32_plan<120, true>(out) : f32_plan<120, false>(out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ser_attention_btd_bf16(const void* q, const void* k, const void* v,
                                      const void* key_mask, const void* gate,
                                      const void* bias, void* out, void* lse, int B,
                                      int Tq, int Tk, int H, int hd, float scale,
                                      void* stream) {
  return launch_bf16(q, k, v, key_mask, gate, bias, out, lse, B, Tq, Tk, H, hd, scale, stream);
}
