// Flash attention forward for Hopper (sm_90a): kernel K4, with a plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py, body _flash_kernel): causal or
// full GQA attention with an optional sliding window over q (B, T, H, D)
// and k/v (B, S, K, D), positions counted from 0 on both sides, softmax
// kept online in float32 (running max m, sum l, accumulator acc), output
// acc / max(l, 1e-30) in q's dtype. Inputs are bfloat16 (the serving
// path) or float32 (the checks), D in {32, 64, 128, 256}.
//
// What bounds it on this card: at the serving path's prefill shape
// (B, T, H, K, D) = (16, 128, 32, 8, 128) it reads 25 MB and writes 17
// MB for 2.2 GFLOP of causal work, about 52 operations a byte, below the
// card's ridge (~295 for bf16 on the tensor cores), so bytes bound it
// (0.0125 ms at 3.35 TB/s). At long contexts the T^2 work grows past the
// bytes and the arithmetic bounds it. This first version does that
// arithmetic on the float32 SIMT cores, from shared memory, at a fraction
// of the tensor cores' rate; wgmma and TMA are later work.
//
// What the design does about it: one block of 128 threads per (b, query
// head, tile of 32 query rows); the kv head is h / (H / K). The TPU
// kernel's sequential kv grid axis, with (m, l, acc) in VMEM scratch,
// becomes a loop inside the block over 64-key tiles, with m and l in
// shared memory and acc in registers (32 x D values over 128 threads).
// The loop starts at the window's edge and stops at the causal frontier,
// so tiles the Pallas kernel skips with its `live` test cost nothing
// here. Inside a tile the mask is per element (key past S, causal,
// window), as the Pallas kernel's; a ragged T or S is an index test, not
// a pad. K and V tiles are read once per query tile, 16 bytes a thread,
// converted to float32 in shared memory (rows of K padded by 4 floats so
// the score loop's 16-byte reads are free of bank conflicts); the q tile
// stays in shared memory for the whole loop. The score and P x V loops
// read shared memory 16 bytes at a time, so each read feeds 4 to 16
// multiply-adds. Dynamic shared memory is 91 KB at D = 128, so the launch
// raises the kernel's limit first.
//
// Build: see repro_torch/kernels/build.py. The dot products use explicit
// fmaf, so they are fused whatever -fmad says.

#include "attention_common.cuh"

namespace {

using namespace repro_attn;

constexpr int kTileQ = 32;  // query rows a block
static_assert(kThreads == 2 * kTileK, "score loop: 2 row groups x 64 keys");

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kTileQ) * D      // q tile
         + kTileK * ld_k<D>()                  // k tile, padded rows
         + kTileK * D                          // v tile
         + kTileQ * kLdP                       // scores / probabilities
         + 3 * kTileQ;                         // m, l, corr
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Tq,
                       int S, int H, int KH, int causal, int window,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTileQ * D;
  float* Vs = Ks + kTileK * ld_k<D>();
  float* Ps = Vs + kTileK * D;
  float* row_m = Ps + kTileQ * kLdP;
  float* row_l = row_m + kTileQ;
  float* row_c = row_l + kTileQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const size_t q_stride = static_cast<size_t>(H) * D;    // t -> t + 1
  const size_t kv_stride = static_cast<size_t>(KH) * D;  // s -> s + 1
  const size_t q_off = (static_cast<size_t>(b) * Tq + q0) * q_stride +
                       static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * S * kv_stride +
                static_cast<size_t>(kh) * D;
  const T* vb = v + static_cast<size_t>(b) * S * kv_stride +
                static_cast<size_t>(kh) * D;

  const int q_rows = min(kTileQ, Tq - q0);
  load_rows<T, D, kTileQ>(Qs, D, q + q_off, q_stride, q_rows);
  if (tid < kTileQ) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.0f;
  }
  Acc<D, kTileQ> acc;
  acc.zero();

  // kv range that any row of this tile can see
  const int kv_lo = window ? max(0, q0 - window + 1) : 0;
  const int kv_hi = causal ? min(S, q0 + q_rows) : S;

  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += kTileK) {
    __syncthreads();  // the last tile's readers are done with K, V and P
    const int kv_rows = min(kTileK, S - kv0);
    load_rows<T, D, kTileK>(Ks, ld_k<D>(), kb + kv0 * kv_stride, kv_stride,
                            kv_rows);
    load_rows<T, D, kTileK>(Vs, D, vb + kv0 * kv_stride, kv_stride,
                            kv_rows);
    __syncthreads();

    // scores: key j = tid % 64 against rows i0, i0 + 2, ..., i0 + 30; the
    // q rows are read as broadcasts, each K row once per 4 d
    {
      const int j = tid & (kTileK - 1);
      const int i0 = tid / kTileK;
      float sc[kTileQ / 2];
#pragma unroll
      for (int r = 0; r < kTileQ / 2; ++r) sc[r] = 0.0f;
      const float* krow = Ks + j * ld_k<D>();
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 kd = ld4(krow + d);
#pragma unroll
        for (int r = 0; r < kTileQ / 2; ++r) {
          const float4 qd = ld4(Qs + (i0 + 2 * r) * D + d);
          sc[r] = fmaf(qd.x, kd.x, sc[r]);
          sc[r] = fmaf(qd.y, kd.y, sc[r]);
          sc[r] = fmaf(qd.z, kd.z, sc[r]);
          sc[r] = fmaf(qd.w, kd.w, sc[r]);
        }
      }
      const int kpos = kv0 + j;
#pragma unroll
      for (int r = 0; r < kTileQ / 2; ++r) {
        const int i = i0 + 2 * r;
        const int qpos = q0 + i;
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        Ps[i * kLdP + j] = ok ? sc[r] * scale : kNegInf;
      }
    }
    __syncthreads();
    softmax_step(Ps, kTileQ, row_m, row_l, row_c);
    __syncthreads();
    acc.update(Ps, Vs, row_c, kTileQ);
  }
  __syncthreads();

  using A = Acc<D, kTileQ>;
#pragma unroll
  for (int m = 0; m < A::kRows; ++m) {
    const int i = A::row(m);
    if (i < q_rows) {
      const float l = fmaxf(row_l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < A::kCols; ++c) {
        store_from_f32(o + q_off + i * q_stride + A::col(c),
                       acc.v[m][c] / l);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int S, int H, int KH, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + kTileQ - 1) / kTileQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tq, S, H, KH, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Tq, int S, int H, int KH, int D, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Tq, S, H, KH, causal, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Tq, S, H, KH, causal, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Tq, S, H, KH, causal, window,
                            scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Tq, S, H, KH, causal, window,
                            scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Tq, H, D), k/v (B, S, KH, D), o (B, Tq, H, D), all contiguous and
// 16-byte aligned, bfloat16 when is_bf16 else float32. Launches on the
// caller's stream, allocates nothing, returns a cudaError_t code.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int Tq,
                                     int S, int H, int KH, int D, int causal,
                                     int window, float scale, int is_bf16,
                                     void* stream) {
  if (B < 1 || Tq < 1 || S < 1 || KH < 1 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, B, Tq, S, H, KH, D,
                                           causal, window, scale, s)
                 : launch_d<float>(q, k, v, o, B, Tq, S, H, KH, D, causal,
                                   window, scale, s);
}
