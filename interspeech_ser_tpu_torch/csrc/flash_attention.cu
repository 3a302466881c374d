// K6: streaming (flash) masked SDPA on [B, H, T, hd] heads, any key length.
//
// Replaces interspeech_ser_tpu/ops/pallas/flash_attention.py
// (flash_attention -> _kernel). Per (b, h):
//   out = softmax(scale * q . k^T + gate[b,h,q] * bias[h,q,k], masked keys) . v
// with the scores and the softmax in f32, a masked key's score set to
// -1e30 and the running max starting at -1e30 (so a query row whose keys are
// all masked gets the uniform mean of V, as on the TPU), the bias in f32 as
// given, P rounded to v's dtype before P.V with f32 accumulation, and the
// result divided by max(l, 1e-30).
//
// The TPU kernel walked a sequential grid of 256 x 256 (q, k) blocks and
// carried the running max m, denominator l and accumulator in VMEM scratch
// from one k step to the next. Blocks of a GPU grid run in no order, so here
// one block owns (b, h, 64 queries) and loops over the keys itself, in 64-key
// tiles staged in shared memory, with the online-softmax rescale per tile:
//   m' = max(m, tile max); alpha = exp(m - m'); l = l*alpha + sum exp(s - m');
//   acc = acc*alpha + round(exp(s - m')) . V_tile.
// Four threads share a query row (attention_bhtd_common.cuh), so a block is
// 256 threads and holds two 17 KB tiles: no length limit, unlike K7.
//
// What bounds it on an H100: q, k, v and out are read or written once per
// block, the f32 bias tile once; the products run on the FP32 pipes from
// shared memory (no tensor cores yet), so it is bound by FP32 issue rate at
// every shape the port runs, not by device memory. wgmma, TMA and double
// buffering of the tiles are later work.
//
// q, k, v and out may be strided views (each row of hd elements contiguous).

#include "attention_bhtd_common.cuh"

namespace {

using namespace bhtd;

constexpr int BQ = 64;  // query rows per block
constexpr int S_LD = BK + 4;  // padded score-tile row (S_LD % 32 == 4: no bank conflicts)

struct Strides {  // elements: batch, head, time, for q, k, v and out
  long long q[3], k[3], v[3], o[3];
};

template <typename T>
__global__ void __launch_bounds__(BQ * TPR) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ key_mask,  // [B, Tk] or null
    const float* __restrict__ gate,      // [B, H, Tq] or null (with bias)
    const float* __restrict__ bias,      // [H, Tq, Tk] or null
    T* __restrict__ out, Strides st, int Tq, int Tk, int H, float scale) {
  __shared__ __align__(16) float kv[BK * KV_LD];  // K tile, then V tile
  __shared__ float sc[BQ * S_LD];                 // bias tile, scores, then P
  __shared__ float valid[BK];

  constexpr int nthreads = BQ * TPR;
  const int tid = threadIdx.x;
  const int r = tid / TPR, part = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qi = q0 + r;
  const bool row_ok = qi < Tq;
  float* srow = sc + r * S_LD;

  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  float qr[HD];
  {
    const T* qrow = q + b * st.q[0] + h * st.q[1] + (row_ok ? qi : 0) * st.q[2];
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = row_ok ? to_f(qrow[d]) : 0.f;
  }
  const float g = (bias != nullptr && row_ok) ? gate[((size_t)b * H + h) * Tq + qi] : 0.f;

  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  float m = NEG_INF;
  float l = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    load_tile(kv, kb, st.k[2], k0, Tk, tid, nthreads);
    if (bias != nullptr) {
      for (int idx = tid; idx < BQ * BK; idx += nthreads) {
        const int rr = idx / BK, c = idx % BK;
        const int qq = q0 + rr, kj = k0 + c;
        sc[rr * S_LD + c] = (qq < Tq && kj < Tk) ? bias[((size_t)h * Tq + qq) * Tk + kj] : 0.f;
      }
    }
    if (tid < BK) {
      const int kj = k0 + tid;
      valid[tid] = (kj < Tk && (key_mask == nullptr || key_mask[(size_t)b * Tk + kj] > 0.f)) ? 1.f : 0.f;
    }
    __syncthreads();

    const int jn = min(BK, Tk - k0);
    float tmax = -INFINITY;
    for (int i = 0; i < BK / TPR; ++i) {
      const int j = part + TPR * i;
      if (j < jn) {
        float s = dot_row(qr, kv + j * KV_LD) * scale;
        if (bias != nullptr) s += g * srow[j];
        s = valid[j] > 0.f ? s : NEG_INF;
        srow[j] = s;
        tmax = fmaxf(tmax, s);
      }
    }
    const float m_new = fmaxf(m, row_max(tmax));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    for (int i = 0; i < BK / TPR; ++i) {
      const int j = part + TPR * i;
      if (j < jn) {
        const float e = expf(srow[j] - m_new);
        srow[j] = e;
        psum += e;
      }
    }
    l = l * alpha + row_sum(psum);
    __syncthreads();  // every thread is done with the K tile

    load_tile(kv, vb, st.v[2], k0, Tk, tid, nthreads);
    __syncthreads();  // also orders the P writes above before the reads below
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= alpha;
    for (int j = 0; j < jn; ++j) axpy_chunks(acc, round_to<T>(srow[j]), kv + j * KV_LD, part);
    m = m_new;
    __syncthreads();  // kv and sc are rewritten by the next tile
  }
  if (row_ok) store_chunks<T>(out + b * st.o[0] + h * st.o[1] + qi * st.o[2], acc, l, part);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* key_mask, const void* gate,
           const void* bias, void* out, const long long* strides, int B, int H, int Tq, int Tk,
           int hd, float scale, void* stream) {
  if (hd != HD || Tk < 1 || Tq < 1) return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T><<<grid, BQ * TPR, 0, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)key_mask, (const float*)gate,
      (const float*)bias, (T*)out, st, Tq, Tk, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ser_flash_attention_f32(const void* q, const void* k, const void* v,
                                       const void* key_mask, const void* gate, const void* bias,
                                       void* out, const long long* strides, int B, int H, int Tq,
                                       int Tk, int hd, float scale, void* stream) {
  return launch<float>(q, k, v, key_mask, gate, bias, out, strides, B, H, Tq, Tk, hd, scale, stream);
}

extern "C" int ser_flash_attention_bf16(const void* q, const void* k, const void* v,
                                        const void* key_mask, const void* gate, const void* bias,
                                        void* out, const long long* strides, int B, int H, int Tq,
                                        int Tk, int hd, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, key_mask, gate, bias, out, strides, B, H, Tq, Tk, hd, scale,
                               stream);
}
