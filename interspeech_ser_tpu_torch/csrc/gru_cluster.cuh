// Helpers of the GRU kernels' thread-block-cluster routes (K3, K9 in
// gru_bidir.cu; K3b in gru_bidir_bwd.cu): cluster barriers, distributed
// shared memory addresses, st.async stores counted by the receiver's
// mbarrier, and an mbarrier wait that traps instead of hanging.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gru_cluster {

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// the same shared location in CTA `rank` of the cluster (shared::cluster address)
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(local), "r"(rank));
  return out;
}

// 16 bytes into a peer's shared memory; its mbarrier counts them on arrival
__device__ __forceinline__ void st_async16(uint32_t dst, float4 v, uint32_t mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(mbar)
               : "memory");
}

// Wait for phase `parity` of a local mbarrier to complete. A protocol fault
// would spin for ever: after 2^24 polls (seconds; a step waits microseconds)
// the kernel traps, so the fault surfaces as a launch error.
__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void mbar_init(uint32_t mbar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mbar), "r"(count) : "memory");
}

// this CTA's thread announces `bytes` of st.async for the current phase (its one arrival)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t mbar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

}  // namespace gru_cluster
