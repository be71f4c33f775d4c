// Pieces shared by the two attention kernels (flash_attention.cu, K4, and
// decode_attention.cu, K5): the store of a float32 result in the
// output's dtype, the widening of 16 bytes of bf16 or f32 to
// float32 registers, cp.async copies from device to shared memory, and the
// launch's shared-memory limit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace repro_attn {

constexpr float kNegInf = -1e30f;  // NEG_INF of the Pallas kernels

__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
// round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes of T -> float32 values (bf16 widens exactly: a shift)
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void to_f32(const uint4& r, float* out) {
    out[0] = __uint_as_float(r.x);
    out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z);
    out[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void to_f32(const uint4& r, float* out) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

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

}  // namespace repro_attn
