// Decode attention for Hopper (sm_90a): kernel K5, with a plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel decode_attention_pallas
// (src/repro/kernels/decode_attention.py, body _decode_kernel): one query
// token per sequence, q (B, H, D), against a KV cache k/v (B, S, K, D),
// with an additive float32 bias (B, S) (0 where a slot is valid, -1e30
// where it is masked) added to the scaled scores before the max; online
// softmax over S in float32; output acc / max(l, 1e-30) in q's dtype.
// Inputs are bfloat16 (the serving path) or float32, D in {32, 64, 128,
// 256}, G = H / K at most 16.
//
// What bounds it on this card: bytes. Every cache element is read once
// for 2 * G multiply-adds, about 4 operations a byte for G = 4 in bf16,
// far below the ridge. At the serving path's decode shape (B, H, K, S, D)
// = (16, 32, 8, 128, 128) it moves 8.7 MB, 0.0026 ms at 3.35 TB/s, so a
// launch costs more than the bound there; at decode_32k (B = 8, S =
// 32768) it moves 1.07 GB, 0.32 ms.
//
// What the design does about it: one block of 128 threads per (b, kv
// head, split of S) serves the G query heads of that group, as the Pallas
// kernel's `qg` does, so each K and V element is read from device memory
// once for all G heads. The TPU kernel's sequential grid axis over S
// chunks, with (m, l, acc) in VMEM scratch, becomes a loop inside the
// block over 64-key chunks: K and V rows are read 16 bytes a thread, 8
// loads in flight per thread, coalesced, into float32 shared memory; m and
// l stay in shared memory and acc (G x D) in registers. A ragged S is an
// index test: keys past S are masked, not padded. At B x K = 64 blocks
// (decode_32k) one block per (b, kv head) would leave most of the 132 SMs
// idle with one slow stream each, so the wrapper splits S across blocks
// when B x K is small against the SM count: each split writes its
// unnormalised (m, l, acc) to float32 scratch and a second, small kernel
// combines them (acc_s and l_s rescaled by exp(m_s - max m)). With one
// split (the serving path's shape) the first kernel writes the output
// itself and the combine is not launched.
//
// Build: see repro_torch/kernels/build.py. The dot products use explicit
// fmaf, so they are fused whatever -fmad says.

#include "attention_common.cuh"

namespace {

using namespace repro_attn;

constexpr int kMaxG = 16;

template <int D>
size_t smem_floats(int G) {
  return static_cast<size_t>(kMaxG) * D            // q rows of the group
         + kTileK * ld_k<D>()                       // k chunk, padded rows
         + kTileK * D                               // v chunk
         + static_cast<size_t>(G) * kLdP            // scores / probabilities
         + 3 * static_cast<size_t>(G);              // m, l, corr
}

// grid (K, B, nsplit); split z covers keys [z * split_len, (z + 1) *
// split_len) of S. With nsplit == 1 it writes o; else part_m/part_l
// (B, K, nsplit, G) and part_acc (B, K, nsplit, G, D).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ bias, T* __restrict__ o,
                        float* __restrict__ part_m,
                        float* __restrict__ part_l,
                        float* __restrict__ part_acc, int S, int H, int KH,
                        int split_len, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int G = H / KH;
  float* Qs = smem;
  float* Ks = Qs + kMaxG * D;
  float* Vs = Ks + kTileK * ld_k<D>();
  float* Ps = Vs + kTileK * D;
  float* row_m = Ps + G * kLdP;
  float* row_l = row_m + G;
  float* row_c = row_l + G;

  const int tid = threadIdx.x;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const size_t kv_stride = static_cast<size_t>(KH) * D;  // s -> s + 1
  // the group's G query heads are contiguous: (b, kh * G .. kh * G + G - 1)
  const size_t q_off = (static_cast<size_t>(b) * H + kh * G) * D;
  const T* kb = k + static_cast<size_t>(b) * S * kv_stride +
                static_cast<size_t>(kh) * D;
  const T* vb = v + static_cast<size_t>(b) * S * kv_stride +
                static_cast<size_t>(kh) * D;
  const float* biasb = bias + static_cast<size_t>(b) * S;
  const int s_lo = split * split_len;
  const int s_hi = min(S, s_lo + split_len);

  load_rows<T, D, kMaxG>(Qs, D, q + q_off, D, G);
  if (tid < G) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.0f;
  }
  Acc<D, kMaxG> acc;
  acc.zero();

  for (int s0 = s_lo; s0 < s_hi; s0 += kTileK) {
    __syncthreads();  // the last chunk's readers are done with K, V and P
    const int rows = min(kTileK, s_hi - s0);
    load_rows<T, D, kTileK>(Ks, ld_k<D>(), kb + s0 * kv_stride, kv_stride,
                            rows);
    load_rows<T, D, kTileK>(Vs, D, vb + s0 * kv_stride, kv_stride, rows);
    __syncthreads();

    // scores: (head g, key j) = (idx / 64, idx % 64)
    for (int idx = tid; idx < G * kTileK; idx += kThreads) {
      const int g = idx / kTileK;
      const int j = idx % kTileK;
      const float dot = dot_smem<D>(Qs + g * D, Ks + j * ld_k<D>());
      Ps[g * kLdP + j] = j < rows ? dot * scale + biasb[s0 + j] : kNegInf;
    }
    __syncthreads();
    softmax_step(Ps, G, row_m, row_l, row_c);
    __syncthreads();
    acc.update(Ps, Vs, row_c, G);
  }
  __syncthreads();

  using A = Acc<D, kMaxG>;
  const size_t part = (static_cast<size_t>(b) * KH + kh) * nsplit + split;
#pragma unroll
  for (int m = 0; m < A::kRows; ++m) {
    const int g = A::row(m);
    if (g < G) {
#pragma unroll
      for (int c = 0; c < A::kCols; ++c) {
        if (nsplit == 1) {
          store_from_f32(o + q_off + g * D + A::col(c),
                         acc.v[m][c] / fmaxf(row_l[g], 1e-30f));
        } else {
          part_acc[(part * G + g) * D + A::col(c)] = acc.v[m][c];
        }
      }
    }
  }
  if (nsplit > 1 && tid < G) {
    part_m[part * G + tid] = row_m[tid];
    part_l[part * G + tid] = row_l[tid];
  }
}

// grid (K, B): o[b, kh * G + g, d] = sum_s w_s acc_s / max(sum_s w_s l_s,
// 1e-30) with w_s = exp(m_s - max_s m_s), over the nsplit splits
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ part_m,
               const float* __restrict__ part_l,
               const float* __restrict__ part_acc, T* __restrict__ o, int H,
               int KH, int D, int nsplit) {
  const int G = H / KH;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const size_t part0 = (static_cast<size_t>(b) * KH + kh) * nsplit;
  const size_t q_off = (static_cast<size_t>(b) * H + kh * G) * D;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = kNegInf;
    for (int s = 0; s < nsplit; ++s)
      mx = fmaxf(mx, part_m[(part0 + s) * G + g]);
    float l = 0.0f;
    float a = 0.0f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(part_m[(part0 + s) * G + g] - mx);
      l = fmaf(w, part_l[(part0 + s) * G + g], l);
      a = fmaf(w, part_acc[((part0 + s) * G + g) * D + d], a);
    }
    store_from_f32(o + q_off + idx, a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, float* part_m, float* part_l, float* part_acc, int B,
           int S, int H, int KH, int nsplit, int split_len, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>(H / KH) * sizeof(float);
  auto kern = decode_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(KH, B, nsplit), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), part_m, part_l,
      part_acc, S, H, KH, split_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  combine_kernel<T><<<dim3(KH, B), kThreads, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(o), H, KH, D, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const float* bias,
             void* o, float* part_m, float* part_l, float* part_acc, int B,
             int S, int H, int KH, int D, int nsplit, int split_len,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, bias, o, part_m, part_l, part_acc, B, S,
                           H, KH, nsplit, split_len, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, bias, o, part_m, part_l, part_acc, B, S,
                           H, KH, nsplit, split_len, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, bias, o, part_m, part_l, part_acc, B,
                            S, H, KH, nsplit, split_len, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, bias, o, part_m, part_l, part_acc, B,
                            S, H, KH, nsplit, split_len, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H, D), k/v (B, S, KH, D), bias (B, S) float32, o (B, H, D); all
// contiguous and 16-byte aligned; q/k/v/o bfloat16 when is_bf16 else
// float32. S is cut into nsplit splits of split_len keys (a multiple of
// 64; the last may be short, none empty); with nsplit > 1, part_m and
// part_l hold B * KH * nsplit * G floats and part_acc that times D.
// Launches on the caller's stream, allocates nothing, returns a
// cudaError_t code.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const float* bias,
                                      void* o, float* part_m, float* part_l,
                                      float* part_acc, int B, int S, int H,
                                      int KH, int D, int nsplit,
                                      int split_len, float scale, int is_bf16,
                                      void* stream) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0 || H / KH > kMaxG ||
      nsplit < 1 || split_len < 1 || split_len % kTileK != 0 ||
      static_cast<long long>(nsplit - 1) * split_len >= S ||
      static_cast<long long>(nsplit) * split_len < S)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_d<__nv_bfloat16>(q, k, v, bias, o, part_m, part_l,
                                           part_acc, B, S, H, KH, D, nsplit,
                                           split_len, scale, s)
                 : launch_d<float>(q, k, v, bias, o, part_m, part_l,
                                   part_acc, B, S, H, KH, D, nsplit,
                                   split_len, scale, s);
}
