// K7: one-shot masked SDPA on [B, H, T, hd] heads, Tk <= 2048.
//
// Replaces interspeech_ser_tpu/ops/pallas/flash_attention_short.py
// (attention_bhtd -> _kernel). Per (b, h):
//   out = softmax(scale * q . k^T + gate[b,h,q] * bias[h,q,k], masked keys) . v
// with the scores and the softmax in f32, a masked key's score set to
// -1e30, the bias rounded to the compute dtype (the wrapper casts it), P
// rounded to v's dtype before P.V with f32 accumulation, and the result
// divided by max(l, 1e-30). A query row whose keys are all masked (its max
// still -1e30) weighs every key 1, and its l also counts the zero keys the
// TPU kernel pads Tk with to a multiple of 128: it is sum(V) / Tk_p.
//
// What makes it one-shot: the TPU kernel held a whole [Tk, hd] K/V panel per
// (b, h) in VMEM and took the EXACT row max before any exponential, with no
// running rescale (that is K6). Both kernels here keep that function.
//
// bf16, on the tensor cores (attention_bhtd_mma_kernel): a block owns (b, h,
// 64 queries), 4 warps of 16 query rows, Q's fragments in registers. K and V
// tiles of 64 keys are staged in bf16 by 16-byte cp.async into rows padded
// to 72 elements, double-buffered; S = Q . K^T runs on mma.sync.m16n8k16
// (bf16 in, f32 out) and is scaled after the product; gate * bias (the bias
// tile in bf16, [64 q][64 k], through registers by 2-byte loads: a bias row
// of Tk values starts on any 2-byte boundary), the mask (-1e30) and the Tk
// tail (no key) are applied in the accumulator's layout; P, rounded to bf16,
// is the A operand of P.V straight from its registers, V by ldmatrix.trans.
// The exact max, two ways:
//   Tk <= 128 (RoBERTa's 80): both tiles' scores stay in registers (64
//     floats a thread), the max is taken over them, then P, l and P.V;
//   128 < Tk <= 2048: two passes over the keys. Pass 1 computes S tile by
//     tile and keeps only the row max; pass 2 computes S again, then P, l
//     (summed from the unrounded f32 exponentials) and P.V. One more Q . K^T
//     and no score storage, so shared memory stays at 64 KB a block with a
//     bias and 46 KB without, for any Tk.
// A tile whose keys are all masked is skipped by the whole block when the
// batch row has a live key (it adds exp(-1e30 - m) = 0 and lowers no max);
// when it has none, every tile counts. A warp whose 16 rows all lie past Tq
// skips the products (RoBERTa's T = 80: 3 of the 4 warps of each head's
// second block). q, k and v may be strided views (rows contiguous): views
// whose pointer or batch / head / time strides are not 16-byte multiples
// are staged by 2-byte loads instead of cp.async (a runtime branch, the
// same kernel). Registers are held to 4 blocks an SM (128) on the
// scores-in-registers route and 3 (145-155) on the two-pass route.
//
// What bounds the bf16 kernel: at RoBERTa-large's shape (B=64, H=16, T=80;
// 1.7 GFLOP) the bound is device memory (q, k, v, out once: 21 MB, 6.3 us
// at 3.35 TB/s), but each block loads its K/V tiles and then computes on
// them, with nothing to overlap, and 2048 blocks take about 4 waves: it is
// bound by load latency. At the
// WavLM shape with the bias (B=8, H=16, T=499) it makes two passes, three
// products per tile pair, and reads the bf16 bias twice by 2-byte loads
// through registers (a bias row of 499 values starts on any 2-byte
// boundary); at Tk = 2048 the 128 MB bias no longer fits L2. wgmma, TMA and
// 16-byte bias loads where Tk allows are later work.
//
// f32 (attention_bhtd_f32_kernel<RI, BIAS, RES>), the parity mode with TF32
// off, runs on the FP32 pipes on K1's register micro-tiles
// (attention_bhtd_common.cuh): 256 threads own 16 * RI query rows, a thread
// rows g + 16i and, of each 64-key tile, keys l + 16j; q, K, V, the bias and
// the key flags are staged by cp.async into padded rows, double-buffered,
// one block barrier a step. The exact max, two routes, chosen by the
// launcher from Tq and Tk (plan; attention_bhtd.py's bhtd_f32_plan is the
// same rule):
//   scores on chip (RES), where the block's [rows][Tk_r + 4] score rows fit
//     in shared memory beside q and a ring of two K-or-V tiles (Tk <= 256 at
//     128 rows, 512 at 80, 640 at 64; the launcher takes the most rows, at
//     most block_rows(Tq), that fit): the whole bias block is staged into
//     the score rows first; steps 0 .. nt-1 compute S tile by tile over it
//     and keep the row max in registers; then the half-warp max, and steps
//     nt .. 2nt-1 turn a tile's scores into P in place and add P.V of the V
//     tile staged meanwhile;
//   two passes (Tk > 640): pass 1 computes S tile by tile (K and the bias
//     tile) and keeps only the max; pass 2 computes S again, P, l and P.V (K,
//     V and the bias tile), P written over the bias elements the same thread
//     read. 174,592 bytes of shared memory with a bias (139,776 without) at
//     128 rows, for any Tk: no query block shrinks as Tk grows.
// A tile whose keys are all masked is skipped by the whole block when the
// batch row has a live key; when it has none, every tile counts (P = 1).
// q, k and v whose pointer or strides are not 16-byte multiples are staged
// by 4-byte cp.async on a runtime branch of the same kernel.
//
// Block rows (median of 21 runs on an H100 80GB HBM3 at 700 W, two runs,
// each block size forced in plan() for the measurement). At RoBERTa-large's shape (B=64, H=16,
// Tq = Tk = 80, ragged mask) a 128-row block leaves 48 of its rows idle and
// makes 1024 blocks at one an SM (168 registers, 137,728 bytes): 0.1838 /
// 0.1806 ms. 64-row blocks (two an SM, 2048 blocks, the second of each head
// 16 rows full): 0.1940 / 0.1772. 80-row blocks, the queries filling them
// (RI = 5, 128 registers, 99,328 bytes, two an SM): 0.1323 / 0.1315, the
// choice: block_rows(Tq) is the fewest of 64, 80 and 128 rows that hold Tq.
// At the WavLM shape with the bias (Tq = Tk = 499) 128-row blocks take two
// passes, 0.4678 / 0.4748 ms, and 80- or 64-row blocks keep the scores on
// chip, 0.4042 / 0.4043 and 0.4180 / 0.4032: hence the most rows that keep
// the scores on chip, before two passes. What bounds it: the FP32 products
// (its share of the 67-TFLOP/s peak is in PERF.md), at one or two blocks an
// SM with nothing but the double-buffered copies to hide their latency.
//
// q, k, v and out may be strided views (each row of hd elements contiguous),
// so RoBERTa's [B, T, H*hd] projections go in, and its output comes out, with
// no transpose copies.

#include "attention_bhtd_common.cuh"

namespace {

using namespace bhtd;

// ---------------------------------------------------------------------------
// f32 on the FP32 pipes

namespace fp32 {

using attn_f32::acc_tile;
using attn_f32::cp_async4;
using attn_f32::cp_async_commit;
using attn_f32::cp_async_wait;
using attn_f32::half_warp_max;
using attn_f32::SMEM_LIMIT;
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

enum Route { SCORES_ON_CHIP = 1, TWO_PASS = 2 };  // 0 is K6's online softmax (flash_attention.cu)

// shared floats of a block owning 16 * ri query rows, keys padded to tkr
__host__ __device__ constexpr size_t smem_floats(int ri, bool bias, int route, int tkr) {
  return route == SCORES_ON_CHIP
             ? 16 * (size_t)ri * STR + 2 * BK * STR + 16 * (size_t)ri * (tkr + 4) + tkr
             : 16 * (size_t)ri * STR + 4 * BK * STR + (bias ? 2 : 1) * 16 * (size_t)ri * PSTR + 2 * BK;
}

template <int RI, bool BIAS, bool RES>
__global__ void __launch_bounds__(THREADS, RI < 8 ? 2 : 1) attention_bhtd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ key_mask,  // [B, Tk] or null
    const float* __restrict__ gate,      // [B, H, Tq] (BIAS)
    const float* __restrict__ bias,      // [H, Tq, Tk] (BIAS)
    float* __restrict__ out, Strides st, int Tq, int Tk, int H, float scale, int aligned) {
  constexpr int ROWS = 16 * RI;
  extern __shared__ __align__(16) float smem_f[];
  const int nt = (Tk + BK - 1) / BK, tkr = nt * BK;
  const int pstr = RES ? tkr + 4 : PSTR;
  float* qs = smem_f;                        // [ROWS][STR] q
  float* ks = qs + ROWS * STR;               // [2][BK][STR]: K tiles (RES: K tiles, then V tiles)
  float* vs = ks + 2 * BK * STR;             // [2][BK][STR]: V tiles (two passes)
  float* ps = RES ? vs : vs + 2 * BK * STR;  // RES: [ROWS][tkr + 4] bias, S, then P; else [2 | 1][ROWS][PSTR]
  float* fl = ps + (RES ? 1 : (BIAS ? 2 : 1)) * ROWS * pstr;  // key flags, RES: [tkr]; else [2][BK]

  const int tid = threadIdx.x, l = tid & 15, g = tid >> 4;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const bool al = aligned != 0;
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  const float* mask_b = key_mask != nullptr ? key_mask + (size_t)b * Tk : nullptr;
  const float* bias_h = BIAS ? bias + (size_t)h * Tq * Tk : nullptr;

  // step i < nt computes the scores of key tile i, step nt + j P and P.V of tile j
  auto stage = [&](int i) {
    const int j = i < nt ? i : i - nt, s = i & 1, k0 = j * BK;
    if constexpr (RES) {
      stage_rows_ld<HD, BK>(ks + s * BK * STR, i < nt ? kb : vb, i < nt ? st.k[2] : st.v[2], k0, Tk, al, tid);
    } else {
      stage_rows_ld<HD, BK>(ks + s * BK * STR, kb, st.k[2], k0, Tk, al, tid);
      if (i >= nt) stage_rows_ld<HD, BK>(vs + s * BK * STR, vb, st.v[2], k0, Tk, al, tid);
      if constexpr (BIAS) stage_elems<ROWS, BK>(ps + s * ROWS * PSTR, PSTR, bias_h, q0, k0, Tq, Tk, Tk, tid);
      stage_flags(fl + s * BK, mask_b, k0, BK, Tk, tid);
    }
    cp_async_commit();
  };
  stage_rows_ld<HD, ROWS>(qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, Tq, al, tid);
  if constexpr (RES) {  // the whole bias block into the score rows, every key flag
    if constexpr (BIAS) {
      for (int idx = tid; idx < ROWS * tkr; idx += THREADS) {
        const int r = idx / tkr, c = idx % tkr;
        const bool ok = q0 + r < Tq && c < Tk;
        cp_async4(ps + r * pstr + c, ok ? bias_h + (size_t)(q0 + r) * Tk + c : bias_h, ok);
      }
    }
    stage_flags(fl, mask_b, 0, tkr, Tk, tid);
  }
  stage(0);
  const int live_row = live_batch_row(mask_b, Tk, tid);  // while the copies fly
  float gr[RI];
  load_gate<RI, BIAS>(gr, gate, b, h, H, q0, Tq, g);

  float o[RI][4], m[RI], lsum[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    lsum[i] = 0.f;
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  }
  for (int i = 0; i < 2 * nt; ++i) {
    const int j = i < nt ? i : i - nt, s = i & 1;
    const float* ft = fl + (RES ? j : s) * BK;
    cp_async_wait<0>();
    // the step's one barrier: its copies have landed, and every thread is
    // done with step i - 1, whose stage the next copies overwrite
    const int any = __syncthreads_or(tid < BK && ft[tid] > 0.f);
    if (i + 1 < 2 * nt) stage(i + 1);
    if (i == nt) {  // the exact row max, before any exponential
#pragma unroll
      for (int r = 0; r < RI; ++r) m[r] = half_warp_max(m[r]);
    }
    if (!any && live_row) continue;  // every key of the tile masked: it adds nothing
    const float* kt = ks + s * BK * STR;  // RES, i >= nt: the V tile
    float* pt = RES ? ps + g * pstr + j * BK : ps + (BIAS ? s : 0) * ROWS * PSTR + g * PSTR;
    float sc[RI][RJ];
    if (RES && i >= nt) {
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int jj = 0; jj < RJ; ++jj) sc[r][jj] = pt[16 * r * pstr + l + 16 * jj];
    } else {
      score_tile<RI, BIAS>(sc, qs, kt, pt, pstr, gr, ft, Tk - j * BK, scale, g, l);
    }
    if (i < nt) {
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int jj = 0; jj < RJ; ++jj) {
          m[r] = fmaxf(m[r], sc[r][jj]);
          if constexpr (RES) pt[16 * r * pstr + l + 16 * jj] = sc[r][jj];  // over the bias element it read
        }
      continue;
    }
    // P = exp(s - max) over the bias / score elements this thread owns, then P.V
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        const float p = expf(sc[r][jj] - m[r]);
        lsum[r] += p;
        pt[16 * r * pstr + l + 16 * jj] = p;
      }
    __syncwarp();  // a row's P comes from its own half-warp alone
    acc_tile<HD, RI, BK, true>(o, pt, 16 * pstr, RES ? kt : vs + s * BK * STR, STR, l);
  }
  store_rows<RI>(out + b * st.o[0] + h * st.o[1], st.o[2], o, m, lsum, (float)(oneshot_padded_tk(Tk) - Tk), q0, Tq,
                 g, l);
}

struct Plan {
  int route, rows;
  size_t bytes;
};

// The launcher's rule: the scores on chip in blocks of the most of 128, 80
// or 64 query rows, at most block_rows(Tq), whose score rows fit beside the
// staged tiles (Tk <= 256, 512, 640); else two passes in blocks of
// block_rows(Tq).
Plan plan(int Tq, int Tk, bool bias) {
  const int r0 = block_rows(Tq);
  const int tkr = (Tk + BK - 1) / BK * BK;
  const int on_chip_rows[3] = {128, 80, 64};
  for (const int r : on_chip_rows) {
    const size_t res = 4 * smem_floats(r / 16, bias, SCORES_ON_CHIP, tkr);
    if (r <= r0 && res <= SMEM_LIMIT) return {SCORES_ON_CHIP, r, res};
  }
  return {TWO_PASS, r0, 4 * smem_floats(r0 / 16, bias, TWO_PASS, tkr)};
}

// the kernel's opt-in to dynamic shared memory, once per instantiation: the
// most it can take (any Tk on the scores-on-chip route, its fixed size else)
template <int RI, bool BIAS, bool RES>
int configure() {
  static int err = (int)cudaFuncSetAttribute(attention_bhtd_f32_kernel<RI, BIAS, RES>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             RES ? (int)SMEM_LIMIT : (int)(4 * smem_floats(RI, BIAS, TWO_PASS, 0)));
  return err;
}

template <int RI, bool BIAS, bool RES>
int launch(const void* q, const void* k, const void* v, const void* key_mask, const void* gate, const void* bias,
           void* out, const Strides& st, int B, int H, int Tq, int Tk, float scale, int aligned, size_t bytes,
           void* stream) {
  const int err = configure<RI, BIAS, RES>();
  if (err != 0) return err;
  dim3 grid((Tq + 16 * RI - 1) / (16 * RI), H, B);
  attention_bhtd_f32_kernel<RI, BIAS, RES><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)key_mask, (const float*)gate,
      (const float*)bias, (float*)out, st, Tq, Tk, H, scale, aligned);
  return (int)cudaGetLastError();
}

// route, rows, tile keys, shared bytes and resident blocks an SM of the kernel the launcher picks
template <int RI, bool BIAS, bool RES>
int occupancy(const Plan& p, int* out) {
  const int err = configure<RI, BIAS, RES>();
  if (err != 0) return err;
  out[0] = p.route;
  out[1] = p.rows;
  out[2] = BK;
  out[3] = (int)p.bytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], attention_bhtd_f32_kernel<RI, BIAS, RES>,
                                                            THREADS, p.bytes);
}

template <bool BIAS, bool RES>
int launch_rows(const void* q, const void* k, const void* v, const void* key_mask, const void* gate,
                const void* bias, void* out, const Strides& st, int B, int H, int Tq, int Tk, float scale,
                int aligned, const Plan& p, void* stream) {
  switch (p.rows) {
    case 64:
      return launch<4, BIAS, RES>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, aligned, p.bytes, stream);
    case 80:
      return launch<5, BIAS, RES>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, aligned, p.bytes, stream);
    default:
      return launch<8, BIAS, RES>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, aligned, p.bytes, stream);
  }
}

template <bool BIAS>
int launch_bias(const void* q, const void* k, const void* v, const void* key_mask, const void* gate,
                const void* bias, void* out, const Strides& st, int B, int H, int Tq, int Tk, float scale,
                int aligned, const Plan& p, void* stream) {
  return p.route == TWO_PASS
             ? launch_rows<BIAS, false>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, aligned, p, stream)
             : launch_rows<BIAS, true>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, aligned, p, stream);
}

template <bool BIAS, bool RES>
int occupancy_rows(const Plan& p, int* out) {
  switch (p.rows) {
    case 64:
      return occupancy<4, BIAS, RES>(p, out);
    case 80:
      return occupancy<5, BIAS, RES>(p, out);
    default:
      return occupancy<8, BIAS, RES>(p, out);
  }
}

template <bool BIAS>
int occupancy_bias(const Plan& p, int* out) {
  return p.route == TWO_PASS ? occupancy_rows<BIAS, false>(p, out) : occupancy_rows<BIAS, true>(p, out);
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bf16 on the tensor cores. Block: (b, h, 64 queries), 4 warps, warp w owns
// query rows 16w .. 16w+15 of the block.

constexpr int MMA_THREADS = 128;
constexpr int MBQ = 64;              // queries per block
constexpr int MBK = 64;              // keys per tile
constexpr int STR = HD + 8;          // bf16 row stride of the Q, K, V tiles (odd number of 16-byte units)
constexpr int BSTR = MBK + 8;        // bf16 row stride of a bias tile
constexpr int TILE = MBK * STR;      // one K or V stage, elements
constexpr int BTILE = MBQ * BSTR;    // one bias stage, elements
// Q, two K and two V stages, two bias stages (with a bias), two stages of key flags
template <bool BIAS>
constexpr size_t mma_smem() {
  return ((size_t)MBQ * STR + 4 * TILE + (BIAS ? 2 * BTILE : 0)) * sizeof(__nv_bfloat16) + 2 * MBK * sizeof(float);
}

// rows [r0, r0 + 64) of one head's [T, HD] panel (rows `ld` elements apart)
// into a [64][STR] tile; rows at or past `n` are zero. 16-byte cp.async when
// the panel is aligned, else 2-byte loads through registers.
__device__ __forceinline__ void stage64(__nv_bfloat16* tile, const __nv_bfloat16* __restrict__ panel, long long ld,
                                        int r0, int n, bool aligned, int tid) {
  for (int idx = tid; idx < MBK * (HD / 8); idx += MMA_THREADS) {
    const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
    const bool ok = r0 + r < n;
    const __nv_bfloat16* src = panel + (long long)(ok ? r0 + r : 0) * ld + c;
    if (aligned) {
      attn_mma::cp_async16(tile + r * STR + c, src, ok);
    } else {
      const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (ok) {
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = (uint32_t)__ldg(s16 + 2 * e) | ((uint32_t)__ldg(s16 + 2 * e + 1) << 16);
      }
      *reinterpret_cast<uint4*>(tile + r * STR + c) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// RES: Tk <= 2 * MBK, every score in registers; else the two-pass form.
template <bool BIAS, bool RES>
__global__ void __launch_bounds__(MMA_THREADS, RES ? 4 : 3) attention_bhtd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ key_mask,       // [B, Tk] or null
    const float* __restrict__ gate,           // [B, H, Tq] (with bias)
    const __nv_bfloat16* __restrict__ bias,   // [H, Tq, Tk] bf16 (BIAS)
    __nv_bfloat16* __restrict__ out, Strides st, int Tq, int Tk, int H, float scale, int aligned) {
  using namespace attn_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [MBQ][STR]
  bf16* ks = qs + MBQ * STR;                     // [2][MBK][STR]
  bf16* vs = ks + 2 * TILE;                      // [2][MBK][STR]
  bf16* bs = vs + 2 * TILE;                      // [2][MBQ][BSTR] (BIAS)
  float* valid = reinterpret_cast<float*>(bs + (BIAS ? 2 * BTILE : 0));  // [2][MBK]: key < Tk and not masked

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * MBQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + h * st.k[1];
  const bf16* vb = v + b * st.v[0] + h * st.v[1];
  const bf16* bias_h = BIAS ? bias + (size_t)h * Tq * Tk : nullptr;
  const bool al = aligned != 0;
  const bool warp_on = q0 + warp * 16 < Tq;  // a warp whose rows all lie past Tq computes nothing
  const int nt = (Tk + MBK - 1) / MBK;

  // may an all-masked tile be skipped? Only if the batch row has a live key
  int live_row = 1;
  if (key_mask != nullptr) {
    int any = 0;
    for (int j = tid; j < Tk; j += MMA_THREADS) any |= key_mask[(size_t)b * Tk + j] > 0.f;
    live_row = __syncthreads_or(any);
  }

  // the bias tile and the key flags of a tile travel through registers
  TileRegs<MBQ, MBK, MMA_THREADS> bpre;
  float vpre = 0.f;
  auto prefetch = [&](int k0) {
    if constexpr (BIAS) bpre.load(bias_h, q0, k0, Tq, Tk, Tk, tid);
    if (tid < MBK) {
      const int kj = k0 + tid;
      vpre = (kj < Tk && (key_mask == nullptr || key_mask[(size_t)b * Tk + kj] > 0.f)) ? 1.f : 0.f;
    }
  };
  auto commit_prefetch = [&](int s) {
    if constexpr (BIAS) bpre.store(bs + s * BTILE, BSTR, tid);
    if (tid < MBK) valid[s * MBK + tid] = vpre;
  };

  const int r_lo = warp * 16 + g;  // this thread's rows: r_lo and r_lo + 8 of the block
  float gr[2] = {0.f, 0.f};
  if constexpr (BIAS) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + r_lo + 8 * i;
      gr[i] = qi < Tq ? gate[((size_t)b * H + h) * Tq + qi] : 0.f;
    }
  }

  // S of the tile in stage s (keys j*64 ..), scaled, biased and masked, in
  // the accumulator's layout; mx[i] takes the max of row r_lo + 8i
  uint32_t qf[HD / 16][4];
  auto scores = [&](float (&sc)[MBK / 8][4], int s, int j, float (&mx)[2]) {
#pragma unroll
    for (int n = 0; n < MBK / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    const bf16* kt = ks + s * TILE;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < MBK / 16; ++np) {
        uint32_t bfr[4];
        load_b_nk<STR>(bfr, kt, np * 16, kc, lane);
        mma16816(sc[2 * np], qf[kc], bfr[0], bfr[1]);
        mma16816(sc[2 * np + 1], qf[kc], bfr[2], bfr[3]);
      }
    }
    const float* vt = valid + s * MBK;
    const bf16* bt = bs + s * BTILE;
    const int kn = Tk - j * MBK;  // keys of this tile below Tk
#pragma unroll
    for (int n = 0; n < MBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = 8 * n + 2 * t + (e & 1);
        float x = sc[n][e] * scale;
        if constexpr (BIAS) x += gr[i] * bf(bt[(r_lo + 8 * i) * BSTR + c]);
        x = vt[c] > 0.f ? x : NEG_INF;
        x = c < kn ? x : -INFINITY;  // past Tk: no key at all
        sc[n][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
  };
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's part of the row's denominator
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // P = exp(s - m), l += P, O += round_bf16(P) . V of stage s
  auto accumulate = [&](float (&sc)[MBK / 8][4], int s) {
#pragma unroll
    for (int n = 0; n < MBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[n][e] - m[e >> 1]);
        l[e >> 1] += p;
        sc[n][e] = p;
      }
    }
    const bf16* vt = vs + s * TILE;
#pragma unroll
    for (int kc2 = 0; kc2 < MBK / 16; ++kc2) {
      uint32_t a[4];
      c_to_a(a, sc[2 * kc2], sc[2 * kc2 + 1]);
      mma_a_xkn<HD, STR>(o, a, vt, kc2 * 16, lane);
    }
  };
  auto quad_max = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    }
  };

  for (int idx = tid; idx < MBQ * (HD / 8); idx += MMA_THREADS) {
    const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
    const bool ok = q0 + r < Tq;
    const bf16* src = qb + (long long)(ok ? q0 + r : 0) * st.q[2] + c;
    if (al) {
      cp_async16(qs + r * STR + c, src, ok);
    } else {
      const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (ok) {
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = (uint32_t)__ldg(s16 + 2 * e) | ((uint32_t)__ldg(s16 + 2 * e + 1) << 16);
      }
      *reinterpret_cast<uint4*>(qs + r * STR + c) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }

  if constexpr (RES) {
    // every tile (one or two) staged at once; the scores of both stay in registers
    for (int j = 0; j < nt; ++j) {
      stage64(ks + j * TILE, kb, st.k[2], j * MBK, Tk, al, tid);
      stage64(vs + j * TILE, vb, st.v[2], j * MBK, Tk, al, tid);
      prefetch(j * MBK);
      commit_prefetch(j);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (warp_on) {
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) load_a<STR>(qf[kc], qs + warp * 16 * STR, kc, lane);
      float sc[2][MBK / 8][4];
      scores(sc[0], 0, 0, m);
      if (nt > 1) scores(sc[1], 1, 1, m);
      quad_max();
      accumulate(sc[0], 0);
      if (nt > 1) accumulate(sc[1], 1);
    }
  } else {
    // two passes over the keys: steps i < nt take the row max (K only),
    // steps i >= nt recompute S and accumulate (K and V); step i + 1's tiles
    // load while step i computes
    const int total = 2 * nt;
    auto stage = [&](int i, int s) {
      const int j = i < nt ? i : i - nt;
      stage64(ks + s * TILE, kb, st.k[2], j * MBK, Tk, al, tid);
      if (i >= nt) stage64(vs + s * TILE, vb, st.v[2], j * MBK, Tk, al, tid);
    };
    stage(0, 0);
    cp_async_commit();
    prefetch(0);
    commit_prefetch(0);
    for (int i = 0; i < total; ++i) {
      const int s = i & 1;
      const int j = i < nt ? i : i - nt;
      if (i + 1 < total) {
        stage(i + 1, s ^ 1);
        cp_async_commit();
        prefetch((i + 1 < nt ? i + 1 : i + 1 - nt) * MBK);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      const int any = __syncthreads_or(tid < MBK && valid[s * MBK + tid] > 0.f);
      if (i == 0 && warp_on) {
#pragma unroll
        for (int kc = 0; kc < HD / 16; ++kc) load_a<STR>(qf[kc], qs + warp * 16 * STR, kc, lane);
      }
      if (warp_on && (any || !live_row)) {
        float sc[MBK / 8][4];
        if (i < nt) {
          scores(sc, s, j, m);
        } else {
          float unused[2] = {-INFINITY, -INFINITY};
          scores(sc, s, j, unused);
          accumulate(sc, s);
        }
      }
      if (i == nt - 1) quad_max();  // the exact row max, before any exponential
      if (i + 1 < total) commit_prefetch(s ^ 1);
      __syncthreads();  // stage s is rewritten by step i + 2
    }
  }

  const float pad = (float)(oneshot_padded_tk(Tk) - Tk);
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

template <bool BIAS, bool RES>
int launch_mma(const void* q, const void* k, const void* v, const void* key_mask, const void* gate,
               const void* bias, void* out, const Strides& st, int B, int H, int Tq, int Tk, float scale,
               int aligned, void* stream) {
  static bool configured = false;  // the attribute is per kernel and per process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(attention_bhtd_mma_kernel<BIAS, RES>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)mma_smem<BIAS>());
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((Tq + MBQ - 1) / MBQ, H, B);
  attention_bhtd_mma_kernel<BIAS, RES><<<grid, MMA_THREADS, mma_smem<BIAS>(), (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const float*)key_mask,
      (const float*)gate, (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, st, Tq, Tk, H, scale, aligned);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, const void* key_mask, const void* gate,
               const void* bias, void* out, const long long* strides, int B, int H, int Tq, int Tk, int hd,
               float scale, void* stream) {
  if (hd != HD || Tk < 1 || Tk > 2048 || Tq < 1) return (int)cudaErrorInvalidValue;
  const fp32::Plan p = fp32::plan(Tq, Tk, bias != nullptr);
  const int aligned = rows_aligned16(q, k, v, strides, 4);
  const Strides st = unpack(strides);
  return bias != nullptr
             ? fp32::launch_bias<true>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, aligned, p, stream)
             : fp32::launch_bias<false>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, aligned, p, stream);
}

int launch_bf16(const void* q, const void* k, const void* v, const void* key_mask, const void* gate,
                const void* bias, void* out, const long long* strides, int B, int H, int Tq, int Tk, int hd,
                float scale, void* stream) {
  if (hd != HD || Tk < 1 || Tk > 2048 || Tq < 1) return (int)cudaErrorInvalidValue;
  const Strides st = unpack(strides);
  const int aligned = rows_aligned16(q, k, v, strides, 2);
  const bool res = Tk <= 2 * MBK;
  if (bias != nullptr)
    return res ? launch_mma<true, true>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, aligned, stream)
               : launch_mma<true, false>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, aligned, stream);
  return res ? launch_mma<false, true>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, aligned, stream)
             : launch_mma<false, false>(q, k, v, key_mask, gate, bias, out, st, B, H, Tq, Tk, scale, aligned, stream);
}

}  // namespace

extern "C" int ser_attention_bhtd_f32(const void* q, const void* k, const void* v,
                                      const void* key_mask, const void* gate, const void* bias,
                                      void* out, const long long* strides, int B, int H, int Tq,
                                      int Tk, int hd, float scale, void* stream) {
  return launch_f32(q, k, v, key_mask, gate, bias, out, strides, B, H, Tq, Tk, hd, scale, stream);
}

// out: route (1 scores on chip, 2 two passes), rows, tile keys, shared bytes and resident
// blocks an SM of the f32 kernel the launcher picks at (Tq, Tk, bias)
extern "C" int ser_attention_bhtd_f32_plan(int Tq, int Tk, int bias, int* out) {
  if (Tk < 1 || Tk > 2048 || Tq < 1) return (int)cudaErrorInvalidValue;
  const fp32::Plan p = fp32::plan(Tq, Tk, bias != 0);
  return bias ? fp32::occupancy_bias<true>(p, out) : fp32::occupancy_bias<false>(p, out);
}

extern "C" int ser_attention_bhtd_bf16(const void* q, const void* k, const void* v,
                                       const void* key_mask, const void* gate, const void* bias,
                                       void* out, const long long* strides, int B, int H, int Tq,
                                       int Tk, int hd, float scale, void* stream) {
  return launch_bf16(q, k, v, key_mask, gate, bias, out, strides, B, H, Tq, Tk, hd, scale, stream);
}
