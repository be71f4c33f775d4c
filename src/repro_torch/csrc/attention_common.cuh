// Pieces shared by the two attention kernels (flash_attention.cu, K4, and
// decode_attention.cu, K5): the store of a float32 result in the
// output's dtype and the widening of 16 bytes of bf16 or f32 to float32
// registers. The copies into shared memory are in async_copy.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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

}  // namespace repro_attn
