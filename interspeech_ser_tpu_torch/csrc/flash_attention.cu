// K6: streaming (flash) masked SDPA on [B, H, T, hd] heads, any key length.
//
// Replaces interspeech_ser_tpu/ops/pallas/flash_attention.py
// (flash_attention -> _kernel). Per (b, h):
//   out = softmax(scale * q . k^T + gate[b,h,q] * bias[h,q,k], masked keys) . v
// with the scores and the softmax in f32 (q . k accumulated in f32, then
// scaled), a masked key's score set to -1e30 and the running max starting at
// -1e30, the bias in f32 as given, P rounded to v's dtype before P.V with
// f32 accumulation, and the result divided by max(l, 1e-30). A query row
// whose keys are all masked (its max still -1e30 at the end) weighs every key
// exp(0) = 1, and its l also counts the zero keys the TPU kernel pads Tk with
// to a multiple of its block_k = min(256, max(128, Tk)): it is sum(V) / Tk_p.
//
// The TPU kernel walked a sequential grid of 256 x 256 (q, k) blocks and
// carried the running max m, denominator l and accumulator in VMEM scratch
// from one k step to the next. Blocks of a GPU grid run in no order, so here
// one block owns (b, h, 64 queries) and loops over the keys itself, in 64-key
// tiles, with the online-softmax rescale per tile:
//   m' = max(m, tile max); alpha = exp(m - m'); l = l*alpha + sum exp(s - m');
//   acc = acc*alpha + round(exp(s - m')) . V_tile.
//
// bf16, on the tensor cores (flash_attention_mma_kernel): 4 warps, each
// owning 16 query rows, whose Q fragments (4 k16 steps of ldmatrix) stay in
// registers for the whole pass. K and V tiles of 64 keys are staged in bf16 by
// cp.async into rows padded to 72 elements and double-buffered, so tile j+1
// loads while tile j is computed; the key flags travel through registers and
// the f32 bias tile by 4-byte cp.async (a bias row of Tk floats starts on any
// 4-byte boundary). S = Q . K^T runs on mma.sync.m16n8k16 (bf16 in, f32 out),
// the scale is applied to the f32 product, then gate * bias, the mask (-1e30)
// and the Tk tail (no weight) in the accumulator's fragment layout; the row
// max and sum take two xor-shuffles within the quad of lanes that hold a row.
// P, rounded to bf16, is the A operand of P.V straight from its registers,
// V's fragments by ldmatrix.trans. When the batch row has a live key, a tile
// whose keys are all masked is skipped by the whole block (it would add
// exp(-1e30 - m) = 0); when it has none, every tile counts.
//
// What bounds the bf16 kernel, at the long shape (B=8, H=20, T=1500, hd 64;
// 92 GFLOP of products): device memory moves q, k, v and out once, 123 MB or
// 0.0013 bytes a FLOP (0.037 ms at 3.35 TB/s); L2 -> shared memory moves K
// and V once per 64-query block, 24 blocks per head, 1.47 GB or 0.016 bytes a
// FLOP (about 0.27 ms at an L2 rate near 5.5 TB/s); shared memory ->
// registers (ldmatrix of K and V, per warp) 5.9 GB or 0.064 bytes a FLOP;
// and the f32 softmax between the two products, 360 M exponentials on the
// 16-a-clock MUFU pipe of each SM (0.09 ms). So it is bound by L2 bandwidth
// and mma.sync issue together, not by device memory; a 128-query block
// (halving the L2 traffic), wgmma and TMA are later work. With the bias
// (WavLM, T=499) the f32 bias tile, 16 KB a tile, is the largest stream.
// What the card shows (chip_smoke.py, H100 80GB HBM3 at 700 W): 0.64 ms at
// the long shape, 148 TFLOP/s of products and 15% of its bound (SDPA takes
// 0.29), 0.18 ms at WavLM's shape with the bias (SDPA 0.13) and 0.085 ms at
// RoBERTa's (SDPA 0.057), where each head's second 64-query block holds 16
// live rows (T = 80).
//
// f32 (flash_attention_f32_kernel<RI, BIAS>), the parity mode with TF32
// off, runs on the FP32 pipes on K1's register micro-tiles
// (attention_bhtd_common.cuh): K1's online-softmax loop on K6's strides and
// K6's function. A block of 256 threads owns (b, h, 16 * RI queries): RI =
// 8 (128 rows) for long queries, 5 or 4 (80 or 64 rows, block_rows) for
// Tq <= 80 or 64, so RoBERTa's 80 queries fill their block as in K7; a
// thread rows g + 16i and, of each 64-key tile, keys l + 16j (j < 4): an
// RI x 4 score micro-tile and an RI x 4-column output micro-tile. q stays in
// shared memory for the block's life; K, V, the f32 bias tile and the key
// flags are staged by cp.async (16 bytes a copy for q, K and V when the view
// allows it, else 4; 4 for the bias and flags) into stage j & 1 while tile
// j - 1 is computed, one block barrier a tile; the running max starts at
// -1e30 and is rescaled per tile over the row's half-warp; P goes over the
// bias elements the same thread read and only the row's half-warp reads it
// back. 174,592 bytes of shared memory with a bias (139,776 without) at 128
// rows: one block an SM (168 registers); two at 80 and 64 rows (at most 128).
// What bounds it at the long shape (B=8, H=20, T=1500; 92 GFLOP of products,
// 1.42 ms at the FP32 peak): the products, as in K1 at Whisper-large-v3's
// layer, whose loop this is; its times are in PERF.md.
//
// q, k, v and out may be strided views (each row of hd elements contiguous);
// the bf16 kernel needs 16-byte aligned pointers and row strides (the wrapper
// checks), the f32 kernel takes any.

#include "attention_bhtd_common.cuh"

namespace {

using namespace bhtd;

// ---------------------------------------------------------------------------
// f32 on the FP32 pipes

namespace fp32 {

using attn_f32::acc_tile;
using attn_f32::cp_async_commit;
using attn_f32::cp_async_wait;
using attn_f32::half_warp_max;
using attn_f32::stage_elems;
using attn_f32::stage_rows_ld;
using attn_f32::THREADS;
using bhtd::f32::BK;
using bhtd::f32::block_rows;
using bhtd::f32::live_batch_row;
using bhtd::f32::load_gate;
using bhtd::f32::PSTR;
using bhtd::f32::RJ;
using bhtd::f32::score_tile;
using bhtd::f32::stage_flags;
using bhtd::f32::store_rows;
using bhtd::f32::STR;

constexpr int ROUTE_ONLINE = 0;  // K7's routes are 1 and 2 (attention_bhtd.cu)

// shared bytes of a block owning 16 * RI query rows
template <int RI, bool BIAS>
constexpr size_t smem_bytes() {
  return 4 * (16 * (size_t)RI * STR + 4 * BK * STR + (BIAS ? 2 : 1) * 16 * (size_t)RI * PSTR + 2 * BK);
}

template <int RI, bool BIAS>
__global__ void __launch_bounds__(THREADS, RI < 8 ? 2 : 1) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ key_mask,  // [B, Tk] or null
    const float* __restrict__ gate,      // [B, H, Tq] (BIAS)
    const float* __restrict__ bias,      // [H, Tq, Tk] f32 (BIAS)
    float* __restrict__ out, Strides st, int Tq, int Tk, int H, float scale, int aligned) {
  constexpr int ROWS = 16 * RI;
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;                              // [ROWS][STR] q
  float* ks = qs + ROWS * STR;                     // [2][BK][STR]
  float* vs = ks + 2 * BK * STR;                   // [2][BK][STR]
  float* ps = vs + 2 * BK * STR;                   // [BIAS ? 2 : 1][ROWS][PSTR]: the bias tile, then P
  float* fl = ps + (BIAS ? 2 : 1) * ROWS * PSTR;   // [2][BK] key flags (> 0: live)

  const int tid = threadIdx.x, l = tid & 15, g = tid >> 4;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const bool al = aligned != 0;
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  const float* mask_b = key_mask != nullptr ? key_mask + (size_t)b * Tk : nullptr;
  const float* bias_h = BIAS ? bias + (size_t)h * Tq * Tk : nullptr;

  auto stage = [&](int j) {
    const int s = j & 1, k0 = j * BK;
    stage_rows_ld<HD, BK>(ks + s * BK * STR, kb, st.k[2], k0, Tk, al, tid);
    stage_rows_ld<HD, BK>(vs + s * BK * STR, vb, st.v[2], k0, Tk, al, tid);
    if constexpr (BIAS) stage_elems<ROWS, BK>(ps + s * ROWS * PSTR, PSTR, bias_h, q0, k0, Tq, Tk, Tk, tid);
    stage_flags(fl + s * BK, mask_b, k0, BK, Tk, tid);
    cp_async_commit();
  };
  stage_rows_ld<HD, ROWS>(qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, Tq, al, tid);
  stage(0);
  const int live_row = live_batch_row(mask_b, Tk, tid);  // while the copies fly
  float gr[RI];
  load_gate<RI, BIAS>(gr, gate, b, h, H, q0, Tq, g);

  float o[RI][4], m[RI], lsum[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    lsum[i] = 0.f;
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  }
  const int nt = (Tk + BK - 1) / BK;
  for (int j = 0; j < nt; ++j) {
    const int s = j & 1;
    const float* ft = fl + s * BK;
    cp_async_wait<0>();
    // the tile's one barrier: stage s has landed, and every thread is done
    // with tile j - 1, whose stage the next copies overwrite
    const int any = __syncthreads_or(tid < BK && ft[tid] > 0.f);
    if (j + 1 < nt) stage(j + 1);
    if (!any && live_row) continue;  // every key of the tile masked: it adds nothing
    float* pt = ps + (BIAS ? s : 0) * ROWS * PSTR + g * PSTR;  // row i of this thread at pt + 16 i PSTR
    float sc[RI][RJ];
    score_tile<RI, BIAS>(sc, qs, ks + s * BK * STR, pt, PSTR, gr, ft, Tk - j * BK, scale, g, l);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) mx = fmaxf(mx, sc[i][jj]);
      const float m_new = fmaxf(m[i], half_warp_max(mx));  // >= -1e30, where m starts
      const float alpha = expf(m[i] - m_new);
      lsum[i] *= alpha;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        const float p = expf(sc[i][jj] - m_new);
        lsum[i] += p;
        pt[16 * i * PSTR + l + 16 * jj] = p;  // where this thread read its bias: no other thread's
      }
      m[i] = m_new;
    }
    __syncwarp();  // a row's P comes from its own half-warp alone
    acc_tile<HD, RI, BK, true>(o, pt, 16 * PSTR, vs + s * BK * STR, STR, l);
  }
  store_rows<RI>(out + b * st.o[0] + h * st.o[1], st.o[2], o, m, lsum, (float)(flash_padded_tk(Tk) - Tk), q0, Tq,
                 g, l);
}

// the kernel's opt-in to its dynamic shared memory, once per instantiation
template <int RI, bool BIAS>
int configure() {
  static int err = (int)cudaFuncSetAttribute(flash_attention_f32_kernel<RI, BIAS>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<RI, BIAS>());
  return err;
}

template <int RI, bool BIAS>
int launch(const void* q, const void* k, const void* v, const void* key_mask, const void* gate, const void* bias,
           void* out, const Strides& st, int B, int H, int Tq, int Tk, float scale, int aligned, void* stream) {
  const int err = configure<RI, BIAS>();
  if (err != 0) return err;
  dim3 grid((Tq + 16 * RI - 1) / (16 * RI), H, B);
  flash_attention_f32_kernel<RI, BIAS><<<grid, THREADS, smem_bytes<RI, BIAS>(), (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)key_mask, (const float*)gate,
      (const float*)bias, (float*)out, st, Tq, Tk, H, scale, aligned);
  return (int)cudaGetLastError();
}

// blocks of block_rows(Tq) query rows: 64, 80 or 128
template <bool BIAS>
int launch_rows(const void* q, const void* k, const void* v, const void* key_mask, const void* gate,
                const void* bias, void* out, const Strides& st, int B, int H, int Tq, int Tk, float scale,
                int aligned, void* stream) {
  switch (block_rows(Tq)) {
    case 64:
      return launch<4, BIAS>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, aligned, stream);
    case 80:
      return launch<5, BIAS>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, aligned, stream);
    default:
      return launch<8, BIAS>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, aligned, stream);
  }
}

// route (0: online softmax), rows, tile keys, shared bytes and resident blocks an SM
template <int RI, bool BIAS>
int occupancy(int* out) {
  const int err = configure<RI, BIAS>();
  if (err != 0) return err;
  out[0] = ROUTE_ONLINE;
  out[1] = 16 * RI;
  out[2] = BK;
  out[3] = (int)smem_bytes<RI, BIAS>();
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], flash_attention_f32_kernel<RI, BIAS>, THREADS,
                                                            smem_bytes<RI, BIAS>());
}

template <bool BIAS>
int occupancy_rows(int Tq, int* out) {
  switch (block_rows(Tq)) {
    case 64:
      return occupancy<4, BIAS>(out);
    case 80:
      return occupancy<5, BIAS>(out);
    default:
      return occupancy<8, BIAS>(out);
  }
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bf16 on the tensor cores. Block: (b, h, 64 queries), 4 warps, warp w owns
// query rows 16w .. 16w+15 of the block.

constexpr int MMA_THREADS = 128;
constexpr int MMA_BQ = 64;           // queries per block
constexpr int MMA_BK = 64;           // keys per tile
constexpr int STR = HD + 8;          // bf16 row stride of the Q, K, V tiles (odd number of 16-byte units)

// The bias of the score epilogue, kept apart so that a variant can stage
// another bias (K7's, in the compute dtype) or keep its scores resident:
// K6's is f32 [H, Tq, Tk], staged a [64 queries][64 keys] tile at a time by
// 4-byte cp.async (a row of Tk floats starts on any 4-byte boundary).
struct BiasF32 {
  static constexpr int LD = MMA_BK + 4;  // the 8 rows of a fragment read fall in 8 bank groups
  static constexpr size_t bytes = (size_t)MMA_BQ * LD * sizeof(float);
  __device__ static void stage(float* tile, const float* __restrict__ bias_h, int q0, int k0, int Tq, int Tk,
                               int tid) {
    for (int idx = tid; idx < MMA_BQ * MMA_BK; idx += MMA_THREADS) {
      const int r = idx / MMA_BK, c = idx % MMA_BK;
      const bool ok = q0 + r < Tq && k0 + c < Tk;
      const float* src = bias_h + (ok ? (size_t)(q0 + r) * Tk + k0 + c : 0);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(attn_mma::smem_u32(tile + r * LD + c)),
                   "l"(src), "r"(ok ? 4 : 0));
    }
  }
  __device__ static float at(const float* tile, int r, int c) { return tile[r * LD + c]; }
};

template <bool BIAS>
struct MmaSmem {
  static constexpr size_t tile = (size_t)MMA_BK * STR;  // one K or V stage, bf16 elements
  static constexpr size_t bytes = ((size_t)MMA_BQ * STR + 4 * tile) * sizeof(__nv_bfloat16) +
                                  2 * MMA_BK * sizeof(float) + (BIAS ? 2 * BiasF32::bytes : 0);
};

template <bool BIAS>
__global__ void __launch_bounds__(MMA_THREADS) flash_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ key_mask,  // [B, Tk] or null
    const float* __restrict__ gate,      // [B, H, Tq] (with bias)
    const float* __restrict__ bias,      // [H, Tq, Tk] f32 (BIAS)
    __nv_bfloat16* __restrict__ out, Strides st, int Tq, int Tk, int H, float scale) {
  using namespace attn_mma;
  typedef MmaSmem<BIAS> Sm;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][STR]
  bf16* ks = qs + MMA_BQ * STR;                  // [2][BK][STR]
  bf16* vs = ks + 2 * Sm::tile;                  // [2][BK][STR]
  float* valid = reinterpret_cast<float*>(vs + 2 * Sm::tile);  // [2][BK]: key < Tk and not masked
  float* bs = valid + 2 * MMA_BK;                               // [2][BQ][BiasF32::LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * MMA_BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + h * st.k[1];
  const bf16* vb = v + b * st.v[0] + h * st.v[1];
  const float* bias_h = BIAS ? bias + (size_t)h * Tq * Tk : nullptr;

  // may an all-masked tile be skipped? Only if the batch row has a live key
  int live_row = 1;
  if (key_mask != nullptr) {
    int any = 0;
    for (int j = tid; j < Tk; j += MMA_THREADS) any |= key_mask[(size_t)b * Tk + j] > 0.f;
    live_row = __syncthreads_or(any);
  }

  auto stage_kv = [&](int k0, int s) {
    for (int idx = tid; idx < MMA_BK * (HD / 8); idx += MMA_THREADS) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
      const bool ok = k0 + r < Tk;
      const long long row = ok ? k0 + r : 0;
      cp_async16(ks + s * Sm::tile + r * STR + c, kb + row * st.k[2] + c, ok);
      cp_async16(vs + s * Sm::tile + r * STR + c, vb + row * st.v[2] + c, ok);
    }
    if constexpr (BIAS) BiasF32::stage(bs + s * (BiasF32::bytes / sizeof(float)), bias_h, q0, k0, Tq, Tk, tid);
  };
  auto key_flag = [&](int kj) {
    return (kj < Tk && (key_mask == nullptr || key_mask[(size_t)b * Tk + kj] > 0.f)) ? 1.f : 0.f;
  };

  for (int idx = tid; idx < MMA_BQ * (HD / 8); idx += MMA_THREADS) {
    const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
    const bool ok = q0 + r < Tq;
    cp_async16(qs + r * STR + c, qb + (long long)(ok ? q0 + r : 0) * st.q[2] + c, ok);
  }
  stage_kv(0, 0);
  cp_async_commit();
  if (tid < MMA_BK) valid[tid] = key_flag(tid);

  const int r_lo = warp * 16 + g;  // this thread's rows: r_lo and r_lo + 8 of the block
  float gr[2] = {0.f, 0.f};
  if constexpr (BIAS) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + r_lo + 8 * i;
      gr[i] = qi < Tq ? gate[((size_t)b * H + h) * Tq + qi] : 0.f;
    }
  }
  uint32_t qf[HD / 16][4];  // Q's A fragments, for the whole pass
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's part of the row's denominator
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int nt = (Tk + MMA_BK - 1) / MMA_BK;
  float vpre = 0.f;
  for (int j = 0; j < nt; ++j) {
    const int s = j & 1;
    if (j + 1 < nt) {
      stage_kv((j + 1) * MMA_BK, s ^ 1);
      cp_async_commit();
      if (tid < MMA_BK) vpre = key_flag((j + 1) * MMA_BK + tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int any = __syncthreads_or(tid < MMA_BK && valid[s * MMA_BK + tid] > 0.f);
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) load_a<STR>(qf[kc], qs + warp * 16 * STR, kc, lane);
    }
    if (any || !live_row) {
      const bf16* kt = ks + s * Sm::tile;
      float sc[MMA_BK / 8][4];
#pragma unroll
      for (int n = 0; n < MMA_BK / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
        for (int np = 0; np < MMA_BK / 16; ++np) {
          uint32_t bf[4];
          load_b_nk<STR>(bf, kt, np * 16, kc, lane);
          mma16816(sc[2 * np], qf[kc], bf[0], bf[1]);
          mma16816(sc[2 * np + 1], qf[kc], bf[2], bf[3]);
        }
      }
      // scale, bias, mask and Tk tail, and the row max, in the accumulator's layout
      const float* vt = valid + s * MMA_BK;
      const float* bt = bs + s * (BiasF32::bytes / sizeof(float));
      const int kn = Tk - j * MMA_BK;  // keys of this tile below Tk
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < MMA_BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, c = 8 * n + 2 * t + (e & 1);
          float x = sc[n][e] * scale;
          if constexpr (BIAS) x += gr[i] * BiasF32::at(bt, r_lo + 8 * i, c);
          x = vt[c] > 0.f ? x : NEG_INF;
          x = c < kn ? x : -INFINITY;  // past Tk: no key at all
          sc[n][e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);  // >= -1e30: key 0 of the tile is below Tk
        const float alpha = expf(m[i] - m_new);
        l[i] *= alpha;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o[n][2 * i] *= alpha;
          o[n][2 * i + 1] *= alpha;
        }
#pragma unroll
        for (int n = 0; n < MMA_BK / 8; ++n) {
          const float p0 = expf(sc[n][2 * i] - m_new), p1 = expf(sc[n][2 * i + 1] - m_new);
          l[i] += p0 + p1;
          sc[n][2 * i] = p0;
          sc[n][2 * i + 1] = p1;
        }
        m[i] = m_new;
      }
      // O += round_bf16(P) . V
      const bf16* vt2 = vs + s * Sm::tile;
#pragma unroll
      for (int kc2 = 0; kc2 < MMA_BK / 16; ++kc2) {
        uint32_t a[4];
        c_to_a(a, sc[2 * kc2], sc[2 * kc2 + 1]);
        mma_a_xkn<HD, STR>(o, a, vt2, kc2 * 16, lane);
      }
    }
    if (j + 1 < nt && tid < MMA_BK) valid[(s ^ 1) * MMA_BK + tid] = vpre;
    __syncthreads();  // stage s is rewritten by tile j + 2
  }

  const float pad = (float)(flash_padded_tk(Tk) - Tk);
  bf16* ob = out + b * st.o[0] + h * st.o[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (m[i] == NEG_INF) l[i] += pad;  // every key masked: the padding counts
    const int qi = q0 + r_lo + 8 * i;
    if (qi >= Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    bf16* orow = ob + (long long)qi * st.o[2];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * i] / den, o[n][2 * i + 1] / den);
  }
}

template <bool BIAS>
int launch_mma(const void* q, const void* k, const void* v, const void* key_mask, const void* gate,
               const void* bias, void* out, const Strides& st, int B, int H, int Tq, int Tk, float scale,
               void* stream) {
  constexpr size_t bytes = MmaSmem<BIAS>::bytes;
  static bool configured = false;  // the attribute is per kernel and per process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(flash_attention_mma_kernel<BIAS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((Tq + MMA_BQ - 1) / MMA_BQ, H, B);
  flash_attention_mma_kernel<BIAS><<<grid, MMA_THREADS, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const float*)key_mask,
      (const float*)gate, (const float*)bias, (__nv_bfloat16*)out, st, Tq, Tk, H, scale);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, const void* key_mask, const void* gate,
               const void* bias, void* out, const long long* strides, int B, int H, int Tq, int Tk, int hd,
               float scale, void* stream) {
  if (hd != HD || Tk < 1 || Tq < 1) return (int)cudaErrorInvalidValue;
  const int aligned = rows_aligned16(q, k, v, strides, 4);
  const Strides st = unpack(strides);
  return bias != nullptr
             ? fp32::launch_rows<true>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, aligned, stream)
             : fp32::launch_rows<false>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, aligned, stream);
}

int launch_bf16(const void* q, const void* k, const void* v, const void* key_mask, const void* gate,
                const void* bias, void* out, const long long* strides, int B, int H, int Tq, int Tk, int hd,
                float scale, void* stream) {
  if (hd != HD || Tk < 1 || Tq < 1) return (int)cudaErrorInvalidValue;
  const Strides st = unpack(strides);
  return bias != nullptr ? launch_mma<true>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, stream)
                         : launch_mma<false>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, stream);
}

}  // namespace

extern "C" int ser_flash_attention_f32(const void* q, const void* k, const void* v,
                                       const void* key_mask, const void* gate, const void* bias,
                                       void* out, const long long* strides, int B, int H, int Tq,
                                       int Tk, int hd, float scale, void* stream) {
  return launch_f32(q, k, v, key_mask, gate, bias, out, strides, B, H, Tq, Tk, hd, scale, stream);
}

// out: route (0: online softmax), rows, tile keys, shared bytes and resident blocks an SM
// of the f32 kernel at (Tq, Tk, bias): its block rows follow Tq, nothing else Tk
extern "C" int ser_flash_attention_f32_plan(int Tq, int Tk, int bias, int* out) {
  if (Tk < 1 || Tq < 1) return (int)cudaErrorInvalidValue;
  return bias ? fp32::occupancy_rows<true>(Tq, out) : fp32::occupancy_rows<false>(Tq, out);
}

extern "C" int ser_flash_attention_bf16(const void* q, const void* k, const void* v,
                                        const void* key_mask, const void* gate, const void* bias,
                                        void* out, const long long* strides, int B, int H, int Tq,
                                        int Tk, int hd, float scale, void* stream) {
  return launch_bf16(q, k, v, key_mask, gate, bias, out, strides, B, H, Tq, Tk, hd, scale, stream);
}
