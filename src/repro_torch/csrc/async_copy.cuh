// Copies from device to shared memory and the launch's shared-memory
// limit, shared by the kernels that stage tiles in shared memory
// (flash_attention.cu, decode_attention.cu, vtrace.cu).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace repro_async {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst, or 16 zero bytes where !valid (src is
// then not read, but must be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from src to shared dst, or zeros where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Raise KERN's dynamic shared-memory limit to `bytes` on the current
// device, calling the runtime only when the limit there is lower (the
// call costs more than a launch, and launches are on the serving path)
template <auto KERN>
cudaError_t raise_smem_limit(size_t bytes) {
  constexpr int kDevices = 64;
  static size_t limit[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && limit[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(
      KERN, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kDevices) limit[dev] = bytes;
  return err;
}

}  // namespace repro_async
