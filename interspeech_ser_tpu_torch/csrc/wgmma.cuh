// Hopper warpgroup products (wgmma) and the small copy helpers K8 needs
// beyond attention_mma.cuh: shared-memory matrix descriptors for the
// no-swizzle K-major layout, the fence / commit / wait of an asynchronous
// wgmma group, 4-byte cp.async and the async-proxy fence, and
// wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate, both operands in shared
// memory) at the four widths the positional conv runs: N = 48, 64, 80, 120.
//
// Layout (PTX ISA, "canonical layouts", K-major, no swizzle): a core matrix
// is 8 rows x 16 bytes (8 bf16 along K) stored as 128 contiguous bytes. The
// descriptor's LBO is the byte step between core matrices adjacent along K,
// its SBO the byte step between 8-row groups. Both operands here are stored
// chunk-major, [K / 8][rows][8]: 16-byte chunk c of row r at (c * rows + r)
// * 16 bytes, so SBO = 128 and LBO = rows * 16, and any 8 consecutive rows
// starting at ANY row form a core matrix. That is what lets the
// positional conv's A operand (the input slab shifted by one row per tap)
// come straight from shared memory at every tap.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// descriptor of a K-major, no-swizzle operand whose first core matrix is at `p`
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across a wgmma
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// shared-memory writes of this thread (cp.async, st.shared) made visible to the async proxy that wgmma reads
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// 4-byte copy device -> shared (cached in L1), or 4 zero bytes when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(pred ? 4 : 0));
}

// d[64 x N] (+)= A[64 x 16] . B[16 x N], A and B K-major in shared memory;
// d as wgmma lays it out: thread (warp w of the group, lane 4 g + t) holds
// rows 16 w + g (d[4 j], d[4 j + 1]: columns 8 j + 2 t, + 1) and 16 w + g + 8
// (d[4 j + 2], d[4 j + 3]). scale_d = 0 overwrites d.
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<48> {
  __device__ __forceinline__ static void run(float (&d)[24], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<80> {
  __device__ __forceinline__ static void run(float (&d)[40], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39"
        "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<120> {
  __device__ __forceinline__ static void run(float (&d)[60], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %62, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59"
        "}, %60, %61, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

}  // namespace wg
