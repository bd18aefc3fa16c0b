// Asynchronous 16-byte copies from global to shared memory (cp.async,
// sm_80 and later), as the attention kernels stage their K/V rows:
//
//   cp_async16(dst, src, n)   copy n (16 or 0) bytes, zero-fill the rest
//   cp_async_commit()         close the copies issued so far into a group
//   cp_async_wait<N>()        wait until at most N groups are in flight
#pragma once

#include <stdint.h>

namespace cp_async {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// src_bytes 0 reads nothing and fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace cp_async
