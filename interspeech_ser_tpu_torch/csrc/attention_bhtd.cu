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
// (b, h) in VMEM and took the exact row max before any exponential. A block
// here may hold 227 KB of shared memory, less than one f32 K panel at
// Tk = 2048, so the block instead keeps its queries' [bq, Tk] f32 SCORE rows
// in shared memory and streams K, then V, in 64-key tiles:
//   1. scores of every key (the bias tile staged into the score rows first),
//      and the exact row max;
//   2. exp(s - max) in place and the row sum;
//   3. P.V over V tiles.
// There is no running rescale of the accumulator (that is K6). bq is 64, 32
// or 16 query rows, the largest whose score rows fit; at RoBERTa's Tk = 80
// everything fits at bq = 64.
//
// What bounds it on an H100: q, k, v and out are read or written once per
// block (K and V once per query tile); the products run on the FP32 pipes
// from shared memory, so at RoBERTa-large's shape (hd = 64, Tk = 80) the
// kernel is bound by shared-memory issue rate and FP32 throughput, not by
// device memory. wgmma and TMA are later work.
//
// q, k, v and out may be strided views (each row of hd elements contiguous),
// so RoBERTa's [B, T, H*hd] projections go in, and its output comes out, with
// no transpose copies.

#include "attention_bhtd_common.cuh"

namespace {

using namespace bhtd;

struct Strides {  // elements: batch, head, time, for q, k, v and out
  long long q[3], k[3], v[3], o[3];
};

template <typename T>
__global__ void attention_bhtd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                      const T* __restrict__ v,
                                      const float* __restrict__ key_mask,  // [B, Tk] or null
                                      const float* __restrict__ gate,      // [B, H, Tq] or null (with bias)
                                      const T* __restrict__ bias,          // [H, Tq, Tk] or null
                                      T* __restrict__ out, Strides st, int Tq, int Tk, int H,
                                      int bq, int s_ld, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int tkr = (Tk + BK - 1) / BK * BK;
  float* kv = smem;               // [BK][KV_LD]: a K tile, then a V tile
  float* valid = kv + BK * KV_LD;  // [tkr]
  float* S = valid + tkr;          // [bq][s_ld]: scores, then P

  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int r = tid / TPR, part = tid % TPR;
  const int q0 = blockIdx.x * bq;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qi = q0 + r;
  const bool row_ok = qi < Tq;
  float* srow = S + (size_t)r * s_ld;

  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  float qr[HD];
  {
    const T* qrow = q + b * st.q[0] + h * st.q[1] + (row_ok ? qi : 0) * st.q[2];
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = row_ok ? to_f(qrow[d]) : 0.f;
  }
  const float g = (bias != nullptr && row_ok) ? gate[((size_t)b * H + h) * Tq + qi] : 0.f;
  for (int j = tid; j < tkr; j += nthreads)
    valid[j] = (j < Tk && (key_mask == nullptr || key_mask[(size_t)b * Tk + j] > 0.f)) ? 1.f : 0.f;

  // 1. scores and the exact row max
  float m = -INFINITY;
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    load_tile(kv, kb, st.k[2], k0, Tk, tid, nthreads);
    if (bias != nullptr) {
      for (int idx = tid; idx < bq * BK; idx += nthreads) {
        const int rr = idx / BK, c = idx % BK;
        const int qq = q0 + rr, kj = k0 + c;
        S[(size_t)rr * s_ld + kj] = (qq < Tq && kj < Tk) ? to_f(bias[((size_t)h * Tq + qq) * Tk + kj]) : 0.f;
      }
    }
    __syncthreads();
    for (int i = 0; i < BK / TPR; ++i) {
      const int j = part + TPR * i;
      const int kj = k0 + j;
      if (kj < Tk) {
        float s = dot_row(qr, kv + j * KV_LD) * scale;
        if (bias != nullptr) s += g * srow[kj];
        s = valid[kj] > 0.f ? s : NEG_INF;
        srow[kj] = s;
        m = fmaxf(m, s);
      }
    }
    __syncthreads();  // kv is rewritten by the next tile
  }
  m = row_max(m);

  // 2. P = exp(s - max) in place, and the row sum
  float l = 0.f;
  for (int j = part; j < Tk; j += TPR) {
    const float e = expf(srow[j] - m);
    srow[j] = e;
    l += e;
  }
  l = row_sum(l);
  if (m == NEG_INF) l += (float)(oneshot_padded_tk(Tk) - Tk);  // every key masked: the padding counts

  // 3. P.V, V streamed in tiles; P rounded to v's dtype
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    load_tile(kv, vb, st.v[2], k0, Tk, tid, nthreads);
    __syncthreads();  // also orders step 2's writes to P before these reads
    const int jn = min(BK, Tk - k0);
    for (int j = 0; j < jn; ++j) axpy_chunks(acc, round_to<T>(srow[k0 + j]), kv + j * KV_LD, part);
    __syncthreads();
  }
  if (row_ok) store_chunks<T>(out + b * st.o[0] + h * st.o[1] + qi * st.o[2], acc, l, part);
}

// shared memory for `bq` query rows at key length Tk, in bytes
size_t smem_bytes(int bq, int Tk) {
  const int tkr = (Tk + BK - 1) / BK * BK;
  return sizeof(float) * ((size_t)BK * KV_LD + tkr + (size_t)bq * (tkr + 4));
}

constexpr size_t SMEM_LIMIT = 227 * 1024;

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* key_mask, const void* gate,
           const void* bias, void* out, const long long* strides, int B, int H, int Tq, int Tk,
           int hd, float scale, void* stream) {
  if (hd != HD || Tk < 1 || Tk > 2048 || Tq < 1) return (int)cudaErrorInvalidValue;
  int bq = 64;
  while (bq > 16 && smem_bytes(bq, Tk) > SMEM_LIMIT) bq /= 2;
  const size_t smem = smem_bytes(bq, Tk);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_bhtd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const int tkr = (Tk + BK - 1) / BK * BK;
  dim3 grid((Tq + bq - 1) / bq, H, B);
  attention_bhtd_kernel<T><<<grid, bq * TPR, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)key_mask, (const float*)gate,
      (const T*)bias, (T*)out, st, Tq, Tk, H, bq, tkr + 4, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ser_attention_bhtd_f32(const void* q, const void* k, const void* v,
                                      const void* key_mask, const void* gate, const void* bias,
                                      void* out, const long long* strides, int B, int H, int Tq,
                                      int Tk, int hd, float scale, void* stream) {
  return launch<float>(q, k, v, key_mask, gate, bias, out, strides, B, H, Tq, Tk, hd, scale, stream);
}

extern "C" int ser_attention_bhtd_bf16(const void* q, const void* k, const void* v,
                                       const void* key_mask, const void* gate, const void* bias,
                                       void* out, const long long* strides, int B, int H, int Tq,
                                       int Tk, int hd, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, key_mask, gate, bias, out, strides, B, H, Tq, Tk, hd, scale,
                               stream);
}
