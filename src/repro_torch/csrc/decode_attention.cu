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
// = (16, 32, 8, 128, 128) it moves 8.7 MB, 0.0026 ms at 3.35 TB/s, so
// latency and the launch cost more than the bound there; at decode_32k
// (B = 8, S = 32768) it moves 1.07 GB, 0.32 ms.
//
// What the design does about it: one block of 8 warps per (b, kv head,
// split of S) serves the G query heads of that group, as the Pallas
// kernel's `qg` does, so each K and V element is read from device memory
// once for all G heads. The TPU kernel's sequential grid axis over S
// chunks, with (m, l, acc) in VMEM scratch, becomes a split of the keys
// inside the block: warp w owns tiles w, w + 8, w + 16, ... of its split,
// each tile 2 KB of K and 2 KB of V (4 to 32 keys, by D and dtype; 8 at
// D = 128 in bf16), with its own (m, l, acc) for the G heads in
// registers. Each warp keeps its own three-stage ring of bf16 (or f32)
// tiles in shared memory, filled by cp.async, so two tiles are in flight
// while it computes on the third; nothing is widened in shared memory, and
// no barrier spans the block until the end. Scores: 1 to 8 lanes per key
// (joined by shuffles), widening 16 bytes of K at a time against q in f32
// shared memory; K rows are padded by 16 bytes so a quarter-warp's reads
// fall on distinct banks. P V: a lane per D / 32 columns, P broadcast from
// shared memory. The dot products stay f32 on the SIMT cores: a bf16 x
// bf16 product is exact in f32 and P stays f32, so the numerics are the
// Pallas kernel's; the tensor cores would buy nothing where bytes bound.
// At the end the warps merge their (m, l, acc) in shared memory (over the
// ring). A ragged S is an index test (keys past the split copy zeros and
// take p = 0); a warp or split that sees only masked keys holds m = -1e30,
// or l = 0, and merges without NaN. At D = 128 in bf16 a block holds 106
// KB of shared memory, so two fit an SM (16 warps, 128 KB of K and V in
// flight). When B x K is small against the SM count the wrapper splits S
// across blocks, about eight blocks an SM: four waves, so the last wave's
// idle SMs cost little (four beat two at decode_32k on the card). Each
// split writes its unnormalised
// (m, l, acc) to float32 scratch and a second, small kernel combines
// them. With one split (the serving path's shape) the first kernel writes
// the output itself and the combine is not launched.
//
// Build: see repro_torch/kernels/build.py. The dot products use explicit
// fmaf, so they are fused whatever -fmad says.

#include "async_copy.cuh"
#include "attention_common.cuh"

namespace {

using namespace repro_async;
using namespace repro_attn;

constexpr int kMaxG = 16;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;
constexpr int kSplitChunk = 64;  // a split's keys: a multiple of any tile

template <typename T, int D>
struct Cfg {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kTk0 = 2048 / kRowBytes;
  static constexpr int kTk = kTk0 < 4 ? 4 : (kTk0 > 32 ? 32 : kTk0);  // keys
  static constexpr int kLPK = 32 / kTk;         // lanes a key (scores)
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kEPC = Vec16<T>::n;      // elements a 16-byte chunk
  static constexpr int kLd = kRowBytes + 16;    // padded row (bytes)
  static constexpr int kCPL = D / 32;           // V columns a lane
  static constexpr int kStageBytes = 2 * kTk * kLd + 4 * kTk;  // K, V, bias
  static constexpr int kRingBytes = kWarps * kStages * kStageBytes;
  static_assert(kSplitChunk % kTk == 0 && kChunks % kLPK == 0, "tiles");
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// N consecutive elements of T at p (aligned to their size, or 16 bytes)
// as float32
template <typename T, int N>
__device__ __forceinline__ void load_cols(const uint8_t* p, float* out) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      Vec16<T>::to_f32(reinterpret_cast<const uint4*>(p)[i],
                       out + i * Vec16<T>::n);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      out[i] = reinterpret_cast<const float*>(p)[i];
  } else if constexpr (kBytes == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(r.x << 16);
    out[1] = __uint_as_float(r.x & 0xffff0000u);
    out[2] = __uint_as_float(r.y << 16);
    out[3] = __uint_as_float(r.y & 0xffff0000u);
  } else if constexpr (kBytes == 4) {
    const uint32_t r = *reinterpret_cast<const uint32_t*>(p);
    out[0] = __uint_as_float(r << 16);
    out[1] = __uint_as_float(r & 0xffff0000u);
  } else {
    out[0] = __uint_as_float(
        static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
  }
}

template <typename T, int D>
size_t smem_bytes(int G) {
  using C = Cfg<T, D>;
  const size_t merge = static_cast<size_t>(kWarps) * G * (D + 2) * 4;
  return static_cast<size_t>(G) * D * 4              // q rows, f32
         + static_cast<size_t>(kWarps) * G * C::kTk * 4  // p, a warp's tile
         + (merge > C::kRingBytes ? merge : C::kRingBytes);
}

// grid (K, B, nsplit); split z covers keys [z * split_len, (z + 1) *
// split_len) of S. With nsplit == 1 it writes o; else part_m/part_l
// (B, K, nsplit, G) and part_acc (B, K, nsplit, G, D).
template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ bias, T* __restrict__ o,
                        float* __restrict__ part_m,
                        float* __restrict__ part_l,
                        float* __restrict__ part_acc, int S, int H, int KH,
                        int split_len, float scale) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int G = H / KH;
  float* Qs = reinterpret_cast<float*>(smem);  // [G][D]
  float* Ps = Qs + G * D;                      // [warp][G][kTk]
  uint8_t* ring = reinterpret_cast<uint8_t*>(Ps + kWarps * G * C::kTk);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
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

  // this warp's tiles of the split: w, w + kWarps, ...
  const int split_tiles = (s_hi - s_lo + C::kTk - 1) / C::kTk;
  const int my_tiles =
      split_tiles > warp ? (split_tiles - warp + kWarps - 1) / kWarps : 0;
  uint8_t* wring = ring + warp * kStages * C::kStageBytes;

  // copy this warp's n-th tile into stage n % kStages: lanes over (row,
  // 16-byte chunk), a row's chunks on consecutive lanes; keys past the
  // split copy zeros (from a mapped address, s_lo's row)
  auto issue = [&](int n) {
    const int s0 = s_lo + (warp + n * kWarps) * C::kTk;
    uint8_t* st = wring + (n % kStages) * C::kStageBytes;
    for (int idx = lane; idx < C::kTk * C::kChunks; idx += 32) {
      const int r = idx / C::kChunks;
      const int c = idx % C::kChunks;
      const bool ok = s0 + r < s_hi;
      const size_t g = static_cast<size_t>(ok ? s0 + r : s_lo) * kv_stride +
                       c * C::kEPC;
      cp_async16(st + r * C::kLd + c * 16, kb + g, ok);
      cp_async16(st + (C::kTk + r) * C::kLd + c * 16, vb + g, ok);
    }
    if (lane < C::kTk) {
      const bool ok = s0 + lane < s_hi;
      cp_async4(st + 2 * C::kTk * C::kLd + 4 * lane,
                biasb + (ok ? s0 + lane : s_lo), ok);
    }
  };

  // start the copies, then widen the group's q rows to f32 meanwhile
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) {
    if (n < my_tiles) issue(n);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < G * D; i += kThreads)
    Qs[i] = to_f32(q[q_off + i]);
  __syncthreads();

  float m[GMAX], l[GMAX], acc[GMAX][C::kCPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < C::kCPL; ++c) acc[g][c] = 0.0f;
  }
  const int j = lane % C::kTk;    // this lane's key in a tile (scores)
  const int sub = lane / C::kTk;  // and its share of the key's chunks
  float* P = Ps + warp * G * C::kTk;

  for (int n = 0; n < my_tiles; ++n) {
    if (n + kStages - 1 < my_tiles) issue(n + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile n has landed
    __syncwarp();
    const uint8_t* st = wring + (n % kStages) * C::kStageBytes;
    const int s0 = s_lo + (warp + n * kWarps) * C::kTk;

    // scores of key j for the G heads; chunks sub, sub + kLPK, ...
    float dot[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) dot[g] = 0.0f;
    const uint8_t* krow = st + j * C::kLd;
#pragma unroll 4
    for (int i = 0; i < C::kChunks / C::kLPK; ++i) {
      const int c = sub + i * C::kLPK;
      float kf[C::kEPC];
      Vec16<T>::to_f32(*reinterpret_cast<const uint4*>(krow + c * 16), kf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float* qg = Qs + g * D + c * C::kEPC;
#pragma unroll
          for (int e = 0; e < C::kEPC; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qg + e);
            dot[g] = fmaf(qv.x, kf[e], dot[g]);
            dot[g] = fmaf(qv.y, kf[e + 1], dot[g]);
            dot[g] = fmaf(qv.z, kf[e + 2], dot[g]);
            dot[g] = fmaf(qv.w, kf[e + 3], dot[g]);
          }
        }
      }
    }
    const bool valid = s0 + j < s_hi;
    const float bj =
        *reinterpret_cast<const float*>(st + 2 * C::kTk * C::kLd + 4 * j);

    // online softmax over the tile's keys, for each head
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        float d = dot[g];
#pragma unroll
        for (int off = C::kTk; off < 32; off *= 2)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        const float sc = valid ? d * scale + bj : kNegInf;
        float mx = sc;
#pragma unroll
        for (int off = C::kTk / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[g], mx);
        const float p = valid ? expf(sc - m_new) : 0.0f;
        float sum = p;
#pragma unroll
        for (int off = C::kTk / 2; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float corr = expf(m[g] - m_new);
        l[g] = l[g] * corr + sum;
        m[g] = m_new;
#pragma unroll
        for (int c = 0; c < C::kCPL; ++c) acc[g][c] *= corr;
        if (sub == 0) P[g * C::kTk + j] = p;
      }
    }
    __syncwarp();

    // acc += p V over the tile's keys, columns lane * kCPL ...
    const uint8_t* vt = st + C::kTk * C::kLd + lane * C::kCPL * sizeof(T);
#pragma unroll 2
    for (int j4 = 0; j4 < C::kTk; j4 += 4) {
      float vv[4][C::kCPL];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        load_cols<T, C::kCPL>(vt + (j4 + e) * C::kLd, vv[e]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float4 p4 = *reinterpret_cast<const float4*>(
              P + g * C::kTk + j4);
#pragma unroll
          for (int c = 0; c < C::kCPL; ++c) {
            acc[g][c] = fmaf(p4.x, vv[0][c], acc[g][c]);
            acc[g][c] = fmaf(p4.y, vv[1][c], acc[g][c]);
            acc[g][c] = fmaf(p4.z, vv[2][c], acc[g][c]);
            acc[g][c] = fmaf(p4.w, vv[3][c], acc[g][c]);
          }
        }
      }
    }
    __syncwarp();  // the stage and P are free for the next copy
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: reuse it

  // merge the warps' (m, l, acc): w_w = exp(m_w - max m)
  float* cm = reinterpret_cast<float*>(ring);  // [warp][G]
  float* cl = cm + kWarps * G;                 // [warp][G]
  float* ca = cl + kWarps * G;                 // [warp][G][D]
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      if (lane == 0) {
        cm[warp * G + g] = m[g];
        cl[warp * G + g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < C::kCPL; ++c)
        ca[(warp * G + g) * D + lane * C::kCPL + c] = acc[g][c];
    }
  }
  __syncthreads();
  const size_t part = (static_cast<size_t>(b) * KH + kh) * nsplit + split;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, cm[w * G + g]);
    float lsum = 0.0f;
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wgt = expf(cm[w * G + g] - mx);
      lsum = fmaf(wgt, cl[w * G + g], lsum);
      a = fmaf(wgt, ca[(w * G + g) * D + idx % D], a);
    }
    if (nsplit == 1) {
      store_from_f32(o + q_off + idx, a / fmaxf(lsum, 1e-30f));
    } else {
      part_acc[part * G * D + idx] = a;
      if (idx % D == 0) {
        part_m[part * G + g] = mx;
        part_l[part * G + g] = lsum;
      }
    }
  }
}

// grid (K, B, G), D threads: o[b, kh * G + g, d] = sum_s w_s acc_s /
// max(sum_s w_s l_s, 1e-30) with w_s = exp(m_s - max_s m_s), over the
// nsplit splits. The weights go through shared memory (2 * nsplit
// floats), and the sum over splits is unrolled so its loads overlap.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ part_m,
                               const float* __restrict__ part_l,
                               const float* __restrict__ part_acc,
                               T* __restrict__ o, int H, int KH,
                               int nsplit) {
  extern __shared__ float w[];  // [nsplit] weights, then [nsplit] w * l
  const int G = H / KH;
  const int D = blockDim.x;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = blockIdx.z;
  const int d = threadIdx.x;
  const size_t part0 = (static_cast<size_t>(b) * KH + kh) * nsplit;
  for (int s = d; s < nsplit; s += D) w[s] = part_m[(part0 + s) * G + g];
  __syncthreads();
  float mx = kNegInf;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, w[s]);
  __syncthreads();
  for (int s = d; s < nsplit; s += D) {
    const float ws = expf(w[s] - mx);
    w[s] = ws;
    w[nsplit + s] = ws * part_l[(part0 + s) * G + g];
  }
  __syncthreads();
  float l = 0.0f;
  float a = 0.0f;
  const float* acc = part_acc + (part0 * G + g) * D + d;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    l += w[nsplit + s];
    a = fmaf(w[s], acc[static_cast<size_t>(s) * G * D], a);
  }
  store_from_f32(o + (static_cast<size_t>(b) * H + kh * G + g) * D + d,
                 a / fmaxf(l, 1e-30f));
}

template <typename T, int D, int GMAX>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, float* part_m, float* part_l, float* part_acc, int B,
           int S, int H, int KH, int nsplit, int split_len, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(H / KH);
  cudaError_t err =
      raise_smem_limit<decode_attention_kernel<T, D, GMAX>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_kernel<T, D, GMAX>
      <<<dim3(KH, B, nsplit), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), part_m, part_l,
      part_acc, S, H, KH, split_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  combine_kernel<T><<<dim3(KH, B, H / KH), D, 2 * nsplit * sizeof(float),
                      stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(o), H, KH, nsplit);
  return static_cast<int>(cudaGetLastError());
}

// the head group's size rounded up to 1, 2, 4, 8 or 16 (the register
// arrays' extent; the kernel skips heads past G)
template <typename T, int D>
int launch_g(const void* q, const void* k, const void* v, const float* bias,
             void* o, float* part_m, float* part_l, float* part_acc, int B,
             int S, int H, int KH, int nsplit, int split_len, float scale,
             cudaStream_t stream) {
  const int G = H / KH;
#define REPRO_K5_LAUNCH(GM)                                                 \
  return launch<T, D, GM>(q, k, v, bias, o, part_m, part_l, part_acc, B, S, \
                          H, KH, nsplit, split_len, scale, stream)
  if (G <= 1) REPRO_K5_LAUNCH(1);
  if (G <= 2) REPRO_K5_LAUNCH(2);
  if (G <= 4) REPRO_K5_LAUNCH(4);
  if (G <= 8) REPRO_K5_LAUNCH(8);
  REPRO_K5_LAUNCH(16);
#undef REPRO_K5_LAUNCH
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const float* bias,
             void* o, float* part_m, float* part_l, float* part_acc, int B,
             int S, int H, int KH, int D, int nsplit, int split_len,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_g<T, 32>(q, k, v, bias, o, part_m, part_l, part_acc, B,
                             S, H, KH, nsplit, split_len, scale, stream);
    case 64:
      return launch_g<T, 64>(q, k, v, bias, o, part_m, part_l, part_acc, B,
                             S, H, KH, nsplit, split_len, scale, stream);
    case 128:
      return launch_g<T, 128>(q, k, v, bias, o, part_m, part_l, part_acc, B,
                              S, H, KH, nsplit, split_len, scale, stream);
    case 256:
      return launch_g<T, 256>(q, k, v, bias, o, part_m, part_l, part_acc, B,
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
      nsplit < 1 || split_len < 1 || split_len % kSplitChunk != 0 ||
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
