// Hopper's asynchronous data path, shared by the GEMM kernels
// (wa16_matmul.cu, w6ax_matmul.cu):
//
//   mbarriers     mbar_init / mbar_expect_tx / mbar_arrive / mbar_wait
//   TMA           tma_load: a 2-D box of a tensor map into shared memory,
//                 completed on an mbarrier; make_map encodes the map on the
//                 host (cuTensorMapEncodeTiled from the driver, found through
//                 the runtime, so no link flag is needed)
//   wgmma         wgmma_fence / wgmma_commit / wgmma_wait, and desc_sw128:
//                 the shared-memory descriptor of a 128-byte-swizzled operand
//   barriers      consumers_sync<N>: named barrier 1 over the N consumer
//                 threads; fence_proxy_async: generic-proxy writes to shared
//                 memory made visible to the async proxy (wgmma, TMA)
#pragma once

#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// 2-D TMA load of a box at (c0 = column, c1 = row) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// the consumer threads' own barrier (id 1; the producer warps are not in it)
template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory, visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// ---- host side ----------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no link flag)
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a 2-D map of a row-major [rows, cols] array with row stride row_bytes,
// read in boxes of [box_rows, box_cols]; elements past the edges read 0.
// False for a base or row stride that is not 16-byte aligned (TMA's rule).
inline bool make_map(CUtensorMap* map, CUtensorMapDataType dt, const void* base, uint64_t cols, uint64_t rows,
                     uint64_t row_bytes, uint32_t box_cols, uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr || base == nullptr || reinterpret_cast<uintptr_t>(base) % 16 || row_bytes % 16) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, dt, 2, const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
