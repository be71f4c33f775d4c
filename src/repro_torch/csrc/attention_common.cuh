// Pieces shared by the two attention kernels (flash_attention.cu, K4, and
// decode_attention.cu, K5): element conversion, the tile load from device
// memory into float32 shared memory, one online-softmax step over a 64-key
// tile of scores, and the probability-times-V update of the accumulator.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace repro_attn {

constexpr int kThreads = 128;      // 4 warps a block
constexpr int kTileK = 64;         // keys per kv tile: two per lane in softmax
constexpr int kLdP = kTileK + 4;   // row stride of the score tile (floats)
constexpr float kNegInf = -1e30f;  // NEG_INF of the Pallas kernels

// Row stride (floats) of a K tile in shared memory. The 4 floats of
// padding keep rows 16-byte aligned for float4 reads and put the rows that
// one quarter-warp reads at once on distinct banks.
template <int D>
__host__ __device__ constexpr int ld_k() {
  return D + 4;
}

__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
// round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16 bytes of T <-> float32 values
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
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Copy ROWS rows of D elements (row r at src + r * row_stride) into
// dst[r * ld + d] as float32, 16 bytes a thread, consecutive threads on
// consecutive addresses. Each thread issues up to 8 loads before it
// stores any, so they are in flight together. Rows at or past `valid` are
// written as zeros (the ragged edge) and never read. The caller checks that
// src, row_stride, dst and ld keep every row 16-byte aligned.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          size_t row_stride, int valid) {
  constexpr int kVec = Vec16<T>::n;
  constexpr int kPerRow = D / kVec;
  constexpr int kTotal = ROWS * kPerRow;
  constexpr int kBatch = 8;
  static_assert(D % kVec == 0, "D must be a multiple of 16 bytes");
  for (int base = 0; base < kTotal; base += kBatch * kThreads) {
    uint4 raw[kBatch];
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      const int idx = base + threadIdx.x + it * kThreads;
      const int r = idx / kPerRow;
      raw[it] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < kTotal && r < valid) {
        raw[it] = *reinterpret_cast<const uint4*>(
            src + r * row_stride + (idx % kPerRow) * kVec);
      }
    }
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      const int idx = base + threadIdx.x + it * kThreads;
      if (idx < kTotal) {
        float vals[kVec];
        Vec16<T>::to_f32(raw[it], vals);
        float* out = dst + (idx / kPerRow) * ld + (idx % kPerRow) * kVec;
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          *reinterpret_cast<float4*>(out + e) =
              make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
        }
      }
    }
  }
}

// dot(a[0:D], b[0:D]) in ascending order of d, from 16-byte aligned
// shared memory, with fused multiply-adds
template <int D>
__device__ __forceinline__ float dot_smem(const float* a, const float* b) {
  float acc = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    const float4 x = ld4(a + d);
    const float4 y = ld4(b + d);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// One online-softmax step for `rows` rows of kTileK scores held in
// P[i * kLdP + j], as the Pallas kernels compute it:
//   m_new = max(m, max_j s);  p = exp(s - m_new);  corr = exp(m - m_new);
//   l = l * corr + sum_j p.
// P is overwritten with p; corr[i] is left for the accumulator update.
// One warp per row, two columns per lane, reductions by shuffles.
__device__ __forceinline__ void softmax_step(float* P, int rows, float* m,
                                             float* l, float* corr) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = warp; i < rows; i += kThreads / 32) {
    float* prow = P + i * kLdP;
    const float s0 = prow[lane];
    const float s1 = prow[lane + 32];
    float mx = fmaxf(s0, s1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_prev = m[i];
    const float m_new = fmaxf(m_prev, mx);
    const float p0 = expf(s0 - m_new);
    const float p1 = expf(s1 - m_new);
    float sum = p0 + p1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    prow[lane] = p0;
    prow[lane + 32] = p1;
    __syncwarp();
    if (lane == 0) {
      const float c = expf(m_prev - m_new);
      corr[i] = c;
      l[i] = l[i] * c + sum;
      m[i] = m_new;
    }
  }
}

// The accumulator of up to MAX_ROWS rows x D columns over kThreads threads.
// Thread t owns the columns col(k) = t % min(D, kThreads) + k * kThreads
// and the rows row(m) = t / D + m * (kThreads / D) (a power-of-two D):
// every lane of a warp shares its rows, so a read of P is a broadcast, and
// consecutive lanes own consecutive columns of V.
template <int D, int MAX_ROWS>
struct Acc {
  static constexpr int kCols = D > kThreads ? D / kThreads : 1;
  static constexpr int kRowStep = D > kThreads ? 1 : kThreads / D;
  static constexpr int kRows = (MAX_ROWS + kRowStep - 1) / kRowStep;
  float v[kRows][kCols];

  __device__ __forceinline__ static int row(int m) {
    return (D > kThreads ? 0 : static_cast<int>(threadIdx.x) / D) +
           m * kRowStep;
  }
  __device__ __forceinline__ static int col(int k) {
    return static_cast<int>(threadIdx.x) % (D < kThreads ? D : kThreads) +
           k * kThreads;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int k = 0; k < kCols; ++k) v[m][k] = 0.0f;
  }

  // v = v * corr[row] + sum_j P[row][j] V[j][col] over one kTileK tile
  __device__ __forceinline__ void update(const float* P, const float* V,
                                         const float* corr, int rows) {
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      if (row(m) < rows) {
        const float c = corr[row(m)];
#pragma unroll
        for (int k = 0; k < kCols; ++k) v[m][k] *= c;
      }
    }
    for (int j = 0; j < kTileK; j += 4) {
      float vv[kCols][4];
#pragma unroll
      for (int k = 0; k < kCols; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) vv[k][e] = V[(j + e) * D + col(k)];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        if (row(m) < rows) {
          const float4 p = ld4(P + row(m) * kLdP + j);
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            v[m][k] = fmaf(p.x, vv[k][0], v[m][k]);
            v[m][k] = fmaf(p.y, vv[k][1], v[m][k]);
            v[m][k] = fmaf(p.z, vv[k][2], v[m][k]);
            v[m][k] = fmaf(p.w, vv[k][3], v[m][k]);
          }
        }
      }
    }
  }
};

}  // namespace repro_attn
