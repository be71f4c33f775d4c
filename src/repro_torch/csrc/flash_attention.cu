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
// (B, T, H, K, D) = (16, 128, 32, 8, 128) it reads 25 MB and writes 17 MB
// for 2.2 GFLOP of causal work, about 52 operations a byte, below the
// card's ridge (~295 for bf16 on the tensor cores): bytes bound it (0.0125
// ms at 3.35 TB/s). At T = S = 4,096 the causal work is 137 GFLOP against
// 75 MB, and the tensor cores' rate bounds it (0.139 ms at 989 TFLOP/s).
//
// bfloat16: a tensor-core kernel in the shape of FlashAttention-3. A
// block of 384 threads owns 128 query rows of one (batch, query head) at
// a time; the kv head is h / (H / K). Blocks are persistent: one an SM,
// each walking work items j, j + #SMs, ..., the query tiles with the most
// causal work first. Warpgroup 0 is the producer: one thread keeps TMA
// copies of bf16 Q, K and V tiles (swizzled, never widened) in flight
// into shared memory (Q double-buffered, K and V in a two-stage ring),
// signalled by mbarriers (full: bytes landed; empty: the eight consumer
// warps are done), so the next item's tiles land while this one is
// computed. Warpgroups 1 and 2 consume 64 rows each: S = Q K^T by wgmma
// (Q and K from shared memory) into f32 registers, the online softmax in
// registers (row max and sum by shuffles inside each four-lane row group,
// exp2 with the scale folded in), then O += P V by wgmma with P from
// registers and V from shared memory read MN-major. The two warpgroups
// take turns at the tensor cores (named barriers): one issues its P V and
// next Q K^T while the other computes its softmax. setmaxnreg moves
// registers from the producer to the consumers. The loop starts at the
// window's edge and stops at the causal frontier, so tiles the Pallas
// kernel skips cost nothing; the per-element mask (key past S, causal,
// window) runs only on tiles that cross an edge; a ragged T or S is the
// TMA box's zero fill, that mask and the store's clipping. The output is
// written over the item's Q tile in shared memory and stored by TMA.
// Tiles, by head dim (keys a kv tile, swizzle, shared memory): D = 32:
// 128 keys, 64 B, 49 KB; D = 64: 128, 128 B, 97 KB; D = 128: 128, 128 B,
// 193 KB; D = 256: 64 keys, 128 B, 193 KB with one Q buffer (the O
// accumulator alone is 128 registers a thread there).
//
// The numerics are the reference's, not FlashAttention's. The Pallas
// kernel and the plain version multiply P in float32 by V; the tensor
// cores take bf16 operands. P rounded to bf16 (as FlashAttention and the
// library call do) puts 9.6% of the outputs at (2, 128, 32, 8, 128) past
// the one-bf16-ulp tolerance the checks hold K4 to (100,443 of 1,048,576
// in the CPU emulation of tests/test_torch_attention_splitp.py). So P is
// split in two bf16 terms, P_hi = bf16(P) and P_lo = bf16(P - P_hi), and
// O += P_hi V + P_lo V in the f32 accumulator: P carries ~16 significant
// bits, and the emulation puts every output within the tolerance. It
// costs a second P V product: 1.5x the tensor-core work of a bf16-P
// kernel. The score product needs no split: a bf16 x bf16 product is
// exact in f32.
//
// float32: the tensor cores have no float32 route that keeps the checks'
// 1e-5 (TF32 keeps 10 bits), and the serving path is bf16, so float32
// inputs (used only by checks) keep the SIMT kernel of the first port: a
// block of 128 threads per (b, head, 32 query rows) loops over 64-key
// tiles in float32 shared memory, acc in registers.
//
// Build: see repro_torch/kernels/build.py. The SIMT dot products use
// explicit fmaf, so they are fused whatever -fmad says.

#include <cuda.h>
#include <dlfcn.h>

#include "async_copy.cuh"
#include "attention_common.cuh"

namespace {

using namespace repro_async;
using namespace repro_attn;

// ---------------------------------------------------------------------------
// float32: SIMT

namespace simt {

constexpr int kThreads = 128;      // 4 warps a block
constexpr int kTileQ = 32;         // query rows a block
constexpr int kTileK = 64;         // keys per kv tile: two per lane in softmax
constexpr int kLdP = kTileK + 4;   // row stride of the score tile (floats)
static_assert(kThreads == 2 * kTileK, "score loop: 2 row groups x 64 keys");

// Row stride (floats) of a K tile in shared memory. The 4 floats of
// padding keep rows 16-byte aligned for float4 reads and put the rows that
// one quarter-warp reads at once on distinct banks.
template <int D>
__host__ __device__ constexpr int ld_k() {
  return D + 4;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Copy ROWS rows of D floats (row r at src + r * row_stride) into
// dst[r * ld + d], 16 bytes a thread, consecutive threads on consecutive
// addresses, up to 8 loads in flight a thread. Rows at or past `valid` are
// written as zeros (the ragged edge) and never read.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src,
                                          size_t row_stride, int valid) {
  constexpr int kPerRow = D / 4;
  constexpr int kTotal = ROWS * kPerRow;
  constexpr int kBatch = 8;
  for (int base = 0; base < kTotal; base += kBatch * kThreads) {
    float4 raw[kBatch];
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      const int idx = base + threadIdx.x + it * kThreads;
      const int r = idx / kPerRow;
      raw[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < kTotal && r < valid)
        raw[it] = ld4(src + r * row_stride + (idx % kPerRow) * 4);
    }
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      const int idx = base + threadIdx.x + it * kThreads;
      if (idx < kTotal)
        *reinterpret_cast<float4*>(dst + (idx / kPerRow) * ld +
                                   (idx % kPerRow) * 4) = raw[it];
    }
  }
}

// One online-softmax step for kTileQ rows of kTileK scores held in
// P[i * kLdP + j], as the Pallas kernel computes it:
//   m_new = max(m, max_j s);  p = exp(s - m_new);  corr = exp(m - m_new);
//   l = l * corr + sum_j p.
// P is overwritten with p; corr[i] is left for the accumulator update.
// One warp per row, two columns per lane, reductions by shuffles.
__device__ __forceinline__ void softmax_step(float* P, float* m, float* l,
                                             float* corr) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = warp; i < kTileQ; i += kThreads / 32) {
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

// The accumulator of kTileQ rows x D columns over kThreads threads.
// Thread t owns the columns col(k) = t % min(D, kThreads) + k * kThreads
// and the rows row(m) = t / D + m * (kThreads / D) (a power-of-two D):
// every lane of a warp shares its rows, so a read of P is a broadcast, and
// consecutive lanes own consecutive columns of V.
template <int D>
struct Acc {
  static constexpr int kCols = D > kThreads ? D / kThreads : 1;
  static constexpr int kRowStep = D > kThreads ? 1 : kThreads / D;
  static constexpr int kRows = (kTileQ + kRowStep - 1) / kRowStep;
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
                                         const float* corr) {
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const float c = corr[row(m)];
#pragma unroll
      for (int k = 0; k < kCols; ++k) v[m][k] *= c;
    }
    for (int j = 0; j < kTileK; j += 4) {
      float vv[kCols][4];
#pragma unroll
      for (int k = 0; k < kCols; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) vv[k][e] = V[(j + e) * D + col(k)];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
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
};

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kTileQ) * D      // q tile
         + kTileK * ld_k<D>()                  // k tile, padded rows
         + kTileK * D                          // v tile
         + kTileQ * kLdP                       // scores / probabilities
         + 3 * kTileQ;                         // m, l, corr
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int Tq, int S, int H, int KH, int causal, int window,
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
  const float* kb = k + static_cast<size_t>(b) * S * kv_stride +
                    static_cast<size_t>(kh) * D;
  const float* vb = v + static_cast<size_t>(b) * S * kv_stride +
                    static_cast<size_t>(kh) * D;

  const int q_rows = min(kTileQ, Tq - q0);
  load_rows<D, kTileQ>(Qs, D, q + q_off, q_stride, q_rows);
  if (tid < kTileQ) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.0f;
  }
  Acc<D> acc;
  acc.zero();

  // kv range that any row of this tile can see
  const int kv_lo = window ? max(0, q0 - window + 1) : 0;
  const int kv_hi = causal ? min(S, q0 + q_rows) : S;

  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += kTileK) {
    __syncthreads();  // the last tile's readers are done with K, V and P
    const int kv_rows = min(kTileK, S - kv0);
    load_rows<D, kTileK>(Ks, ld_k<D>(), kb + kv0 * kv_stride, kv_stride,
                         kv_rows);
    load_rows<D, kTileK>(Vs, D, vb + kv0 * kv_stride, kv_stride, kv_rows);
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
    softmax_step(Ps, row_m, row_l, row_c);
    __syncthreads();
    acc.update(Ps, Vs, row_c);
  }
  __syncthreads();

#pragma unroll
  for (int m = 0; m < Acc<D>::kRows; ++m) {
    const int i = Acc<D>::row(m);
    if (i < q_rows) {
      const float l = fmaxf(row_l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < Acc<D>::kCols; ++c)
        o[q_off + i * q_stride + Acc<D>::col(c)] = acc.v[m][c] / l;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int S, int H, int KH, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = raise_smem_limit<flash_attention_kernel<D>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + kTileQ - 1) / kTileQ, H, B);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Tq, S, H, KH,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), TMA, mbarriers

namespace tc {

constexpr int kBlockM = 128;   // query rows a block: 2 consumer warpgroups
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kStages = 2;     // K/V tiles in the ring
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kCW = D >= 64 ? 64 : 32;     // elements a swizzled row
  static constexpr int kRowBytes = 2 * kCW;         // 128 or 64
  static constexpr int kNB = D / kCW;               // column blocks a tile
  static constexpr int kBN = D == 256 ? 64 : 128;   // keys a kv tile
  static constexpr int kGroupBytes = 8 * kRowBytes; // 8 rows: a swizzle atom
  static constexpr uint64_t kLayout = kCW == 64 ? 1 : 2;  // 128 B / 64 B
  static constexpr int kQBlock = kBlockM * kRowBytes;     // one column block
  static constexpr int kKVBlock = kBN * kRowBytes;
  static constexpr int kQBytes = kNB * kQBlock;
  static constexpr int kKVBytes = kNB * kKVBlock;
  // Q is double-buffered where it fits: the next item's Q lands while the
  // current one's tiles are computed
  static constexpr int kQBufs = D == 256 ? 1 : 2;
  static constexpr int kBarOff = kQBufs * kQBytes + 2 * kStages * kKVBytes;
  // 1 KB of slack to align the base to the 1024-byte swizzle atom, and the
  // mbarriers after the tiles
  static constexpr size_t kSmem = 1024 + kBarOff + 8 * (2 * kQBufs +
                                                       4 * kStages);
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// one box of shared memory to a 4-d tensor map, in the bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// named barriers among the consumer threads (0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads of wgmma results above the wait,
// or reusing the registers of an in-flight A operand before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (m64 x n128, f32) = A (m64 x k16) * B (n128 x k16)^T [+ D], A and B
// bf16 in shared memory, both K-major, named by their descriptors
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D (m64 x n64, f32) = A (m64 x k16) * B (n64 x k16)^T [+ D], A and B
// bf16 in shared memory, both K-major, named by their descriptors
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D (m64 x n256, f32) += A (m64 x k16, bf16, registers) * B (k16 x n256,
// bf16 in shared memory, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (m64 x n128, f32) += A (m64 x k16, bf16, registers) * B (k16 x n128,
// bf16 in shared memory, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (m64 x n64, f32) += A (m64 x k16, bf16, registers) * B (k16 x n64,
// bf16 in shared memory, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (m64 x n32, f32) += A (m64 x k16, bf16, registers) * B (k16 x n32,
// bf16 in shared memory, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc) {
  if constexpr (N == 128) wgmma_ss_n128(d, da, db, acc);
  else wgmma_ss_n64(d, da, db, acc);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 256) wgmma_rs_n256(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n32(d, a, db);
}

// the kv tiles a block of query rows [q0, q0 + rows) reads: kv_lo and
// the count of kBN-key tiles up to the causal frontier (0 when none)
struct KvRange {
  int kv_lo;
  int n_tiles;
};
__device__ __forceinline__ KvRange kv_range(int q0, int rows, int S,
                                            int causal, int window,
                                            int bn) {
  const int kv_lo = window ? max(0, q0 - window + 1) : 0;
  const int kv_hi = causal ? min(S, q0 + rows) : S;
  return {kv_lo, kv_hi > kv_lo ? (kv_hi - kv_lo + bn - 1) / bn : 0};
}

// work item i of a launch: (query tile, head, batch), the query tiles
// with the most causal work first
struct Item {
  int q0;
  int h;
  int b;
};
__device__ __forceinline__ Item item_at(int i, int nq, int H, int B,
                                        int causal) {
  const int rank = i / (H * B);
  const int hb = i % (H * B);
  return {(causal ? nq - 1 - rank : rank) * kBlockM, hb % H, hb / H};
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A tile's K stage is released once S = Q K^T is done, its V stage once
// P V is; the other consumer warpgroup's products run under this one's
// softmax. Persistent: block j takes work items j, j + gridDim.x, ...
// (gridDim.x at most the SM count), so the producer loads the next item's
// Q and first K/V tiles while the consumers finish the current one.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o, int B,
                       int Tq, int S, int H, int KH, int causal, int window,
                       float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = base;                               // [qbuf][block][row]
  uint8_t* Ks = base + C::kQBufs * C::kQBytes;      // [stage][block][row]
  uint8_t* Vs = Ks + kStages * C::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + C::kBarOff);
  uint64_t* q_empty = q_full + C::kQBufs;
  uint64_t* k_full = q_empty + C::kQBufs;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int nq = (Tq + kBlockM - 1) / kBlockM;
  const int n_items = nq * H * B;
  const int G = H / KH;

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kQBufs; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], kConsumerWarps);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&k_empty[i], kConsumerWarps);
      mbar_init(&v_empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;  // kv tiles issued, over all items: the ring position
      int qi = 0;  // items begun
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++qi) {
        const Item w = item_at(i, nq, H, B, causal);
        const int qb = qi % C::kQBufs;
        if (qi >= C::kQBufs)
          mbar_wait(&q_empty[qb], ((qi / C::kQBufs) & 1) ^ 1);
        mbar_expect_tx(&q_full[qb], C::kQBytes);
        for (int c = 0; c < C::kNB; ++c)
          tma_load(Qs + qb * C::kQBytes + c * C::kQBlock, &tm_q, &q_full[qb],
                   c * C::kCW, w.h, w.q0, w.b);
        const KvRange r = kv_range(w.q0, min(kBlockM, Tq - w.q0), S, causal,
                                   window, C::kBN);
        for (int t = 0; t < r.n_tiles; ++t, ++it) {
          const int st = it % kStages;
          const uint32_t free_parity = ((it / kStages) & 1) ^ 1;
          const int kv0 = r.kv_lo + t * C::kBN;
          if (it >= kStages) mbar_wait(&k_empty[st], free_parity);
          mbar_expect_tx(&k_full[st], C::kKVBytes);
          for (int c = 0; c < C::kNB; ++c)
            tma_load(Ks + st * C::kKVBytes + c * C::kKVBlock, &tm_k,
                     &k_full[st], c * C::kCW, w.h / G, kv0, w.b);
          if (it >= kStages) mbar_wait(&v_empty[st], free_parity);
          mbar_expect_tx(&v_full[st], C::kKVBytes);
          for (int c = 0; c < C::kNB; ++c)
            tma_load(Vs + st * C::kKVBytes + c * C::kKVBlock, &tm_v,
                     &v_full[st], c * C::kCW, w.h / G, kv0, w.b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int col0 = 2 * (lane & 3);  // in each 8-column block
    float acc[D / 2];  // O: n8 column block j in acc[4 j .. 4 j + 3]
    uint32_t p_hi[C::kBN / 16][4], p_lo[C::kBN / 16][4];

    // this warp's arrival on a barrier of the eight consumer warps
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    auto fence_pv = [&]() {
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
    };
    // O += P_hi V + P_lo V over the tile in stage st, 16 keys a step, all
    // D columns a product: V read MN-major, its column blocks (swizzle
    // atoms along D) kKVBlock bytes apart (the leading byte offset), its
    // 8-key groups kGroupBytes apart (the stride byte offset)
    auto issue_pv = [&](int st) {
      const uint32_t v_base = smem_addr(Vs + st * C::kKVBytes);
#pragma unroll
      for (int kk = 0; kk < C::kBN / 16; ++kk) {
        const uint64_t dv = make_desc(v_base + kk * 16 * C::kRowBytes,
                                      C::kKVBlock, C::kGroupBytes,
                                      C::kLayout);
        wgmma_rs<D>(acc, p_hi[kk], dv);
        wgmma_rs<D>(acc, p_lo[kk], dv);
      }
      wg_commit();
    };
    // S = Q K^T over the tile in stage st, 16 columns of D a step: column
    // block c, and 32 bytes a step inside its swizzled rows
    auto issue_s = [&](float (&s)[C::kBN / 2], uint32_t q_base, int st) {
      const uint32_t k_base = smem_addr(Ks + st * C::kKVBytes);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = (kk * 16) / C::kCW;
        const uint32_t off = ((kk * 16) % C::kCW) * 2;
        const uint64_t da = make_desc(q_base + c * C::kQBlock + off, 16,
                                      C::kGroupBytes, C::kLayout);
        const uint64_t db = make_desc(k_base + c * C::kKVBlock + off, 16,
                                      C::kGroupBytes, C::kLayout);
        wgmma_ss<C::kBN>(s, da, db, kk > 0);
      }
      wg_commit();
    };
    // The two warpgroups take turns at the tensor cores (named barriers 1
    // and 2): each issues its products, passes the turn, and computes its
    // softmax while the other's products run. Warpgroup 0 starts.
    const int my_turn = 1 + wg;
    const int their_turn = 2 - wg;
    if (wg == 1) bar_arrive(their_turn, 256);

    int it = 0;
    int qi = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++qi) {
      const Item w = item_at(i, nq, H, B, causal);
      const int qb = qi % C::kQBufs;
      const int m0 = w.q0 + wg * 64;                // this warpgroup's rows
      const int row0 = m0 + warp * 16 + lane / 4;   // and row0 + 8
      const KvRange r = kv_range(w.q0, min(kBlockM, Tq - w.q0), S, causal,
                                 window, C::kBN);
      float m[2] = {kNegInf, kNegInf};  // running max, log2 domain
      float l[2] = {0.0f, 0.0f};        // this thread's share of row sums
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] = 0.0f;

      // the softmax of the scores s of the tile at kv0: mask, the online
      // update of m, l and O, and P in two bf16 terms
      auto softmax = [&](float (&s)[C::kBN / 2], int kv0) {
        // mask the raw scores, only on tiles across an edge: a row's keys
        // kv0 + col0 + c are valid for lo <= c <= hi. A masked score is
        // -inf, not kNegInf: with D = 256 (64-key tiles) a window can mask
        // a row's whole first tile, and -1e30 * scale_log2 would then be
        // the row's running max, where fmaf(x, scale_log2, -m) leaves the
        // rounding residual of that product (up to ~1e21) and exp2 of it
        // is inf. -inf scales to -inf and exp2 of it is 0 whatever m is,
        // and m itself starts at the finite kNegInf, so corr stays finite
        const bool edge = kv0 + C::kBN > S ||
                          (causal && kv0 + C::kBN - 1 > m0) ||
                          (window && kv0 <= m0 + 63 - window);
        if (edge) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int qpos = row0 + 8 * rr;
            const int hi = (causal ? min(S - 1, qpos) : S - 1) - kv0 - col0;
            const int lo = window ? qpos - window + 1 - kv0 - col0 : -1;
#pragma unroll
            for (int j = 0; j < C::kBN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = j * 8 + e;
                float& x = s[j * 4 + 2 * rr + e];
                x = (c <= hi && c >= lo) ? x : -INFINITY;
              }
          }
        }
        // rows row0 (rr = 0) and row0 + 8 (rr = 1), in the log2 domain
        // with the scale folded in; a row's values live in the four lanes
        // of one row group. p overwrites s.
        float corr[2];
        float rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < C::kBN / 8; ++j)
            mx = fmaxf(mx, fmaxf(s[j * 4 + 2 * rr], s[j * 4 + 2 * rr + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[rr], mx * scale_log2);
          corr[rr] = fast_exp2(m[rr] - m_new);
          m[rr] = m_new;
#pragma unroll
          for (int j = 0; j < C::kBN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[j * 4 + 2 * rr + e];
              x = fast_exp2(fmaf(x, scale_log2, -m_new));
              rs[rr] += x;
            }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * corr[rr] + rs[rr];
#pragma unroll
        for (int j = 0; j < D / 2; ++j) acc[j] *= corr[(j >> 1) & 1];
        // the A fragments of keys 16 kk .. 16 kk + 15: (row0, keys 0-7),
        // (row0 + 8, 0-7), (row0, 8-15), (row0 + 8, 8-15)
#pragma unroll
        for (int kk = 0; kk < C::kBN / 16; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = (2 * kk + (e >> 1)) * 4 + 2 * (e & 1);
            const uint32_t hi = pack_bf16(s[j], s[j + 1]);
            const float h0 = __uint_as_float(hi << 16);
            const float h1 = __uint_as_float(hi & 0xffff0000u);
            p_hi[kk][e] = hi;
            p_lo[kk][e] = pack_bf16(s[j] - h0, s[j + 1] - h1);
          }
        }
      };

      uint8_t* qtile = Qs + qb * C::kQBytes + wg * 64 * C::kRowBytes;
      const uint32_t q_base = smem_addr(qtile);
      mbar_wait(&q_full[qb], (qi / C::kQBufs) & 1);
      // turn 0 issues S(0); turn t issues P(t-1) V and S(t); the last
      // turn P(n-1) V. No wgmma is issued under a condition of its own:
      // ptxas serialises the wgmmas of a divergent path. Each S lands in
      // a fresh accumulator (scale-d 0 at the first step), so no value of
      // the last softmax flows into it.
      if (r.n_tiles > 0) {
        int prev_st = it % kStages;
        {
          float s[C::kBN / 2];
          bar_sync(my_turn, 256);
          mbar_wait(&k_full[prev_st], (it / kStages) & 1);
          wg_fence();
          issue_s(s, q_base, prev_st);
          bar_arrive(their_turn, 256);
          wg_wait<0>();
          fence_regs(s);
          release(&k_empty[prev_st]);
          softmax(s, r.kv_lo);
          ++it;
        }
        for (int t = 1; t < r.n_tiles; ++t, ++it) {
          const int st = it % kStages;
          float s[C::kBN / 2];
          bar_sync(my_turn, 256);
          mbar_wait(&v_full[prev_st], ((it - 1) / kStages) & 1);
          mbar_wait(&k_full[st], (it / kStages) & 1);
          fence_pv();
          wg_fence();
          issue_pv(prev_st);
          issue_s(s, q_base, st);
          bar_arrive(their_turn, 256);
          wg_wait<0>();
          fence_pv();
          fence_regs(s);
          release(&v_empty[prev_st]);
          release(&k_empty[st]);
          softmax(s, r.kv_lo + t * C::kBN);
          prev_st = st;
        }
        bar_sync(my_turn, 256);
        mbar_wait(&v_full[prev_st], ((it - 1) / kStages) & 1);
        fence_pv();
        wg_fence();
        issue_pv(prev_st);
        bar_arrive(their_turn, 256);
        wg_wait<0>();
        fence_pv();
        release(&v_empty[prev_st]);
      }

      // out = acc / max(l, 1e-30) in bf16, written over this warpgroup's
      // rows of the Q tile (no S product reads them now) in the same
      // swizzled layout, then stored by TMA (rows past T are clipped)
      float inv[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
        inv[rr] = __frcp_rn(fmaxf(l[rr], 1e-30f));
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = warp * 16 + lane / 4 + 8 * rr;  // of the 64
        const int swz = C::kCW == 64 ? (row & 7) : ((row >> 1) & 3);
#pragma unroll
        for (int c = 0; c < C::kNB; ++c)
#pragma unroll
          for (int j = 0; j < C::kCW / 8; ++j)
            *reinterpret_cast<uint32_t*>(qtile + c * C::kQBlock +
                                         row * C::kRowBytes +
                                         ((j ^ swz) << 4) + 2 * col0) =
                pack_bf16(acc[(c * C::kCW / 8 + j) * 4 + 2 * rr] * inv[rr],
                          acc[(c * C::kCW / 8 + j) * 4 + 2 * rr + 1] *
                              inv[rr]);
      }
      // the writes, visible to the TMA engine, from all 128 threads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(3 + wg, 128);
      if ((threadIdx.x & 127) == 0) {
        for (int c = 0; c < C::kNB; ++c)
          tma_store(&tm_o, qtile + c * C::kQBlock, c * C::kCW, w.h, m0, w.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(&q_empty[qb], 4);  // for this warpgroup's four warps
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, from the libcuda the process has
// loaded (no link against libcuda, so no stub library at build time)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// a (batch, rows, heads, D) bf16 tensor as a 4-d map, a box of `box_rows`
// rows x cw elements of one head, swizzled to match the wgmma layout
bool make_map(CUtensorMap* map, const void* ptr, int batch, int rows,
              int heads, int D, int box_rows, int cw) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;  // bytes
  const cuuint64_t strides[3] = {row, row * heads, row * heads * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cw), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the SM count of the current device, read once per device
int sm_count() {
  constexpr int kDevices = 64;
  static int count[kDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kDevices && count[dev]) return count[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < kDevices) count[dev] = n;
  return n;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int S, int H, int KH, int causal, int window, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  if (!encode_tiled()) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!make_map(&tm_q, q, B, Tq, H, D, kBlockM, C::kCW) ||
      !make_map(&tm_k, k, B, S, KH, D, C::kBN, C::kCW) ||
      !make_map(&tm_v, v, B, S, KH, D, C::kBN, C::kCW) ||
      !make_map(&tm_o, o, B, Tq, H, D, 64, C::kCW))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = raise_smem_limit<flash_attention_kernel<D>>(C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items =
      static_cast<long long>((Tq + kBlockM - 1) / kBlockM) * H * B;
  const int sms = sm_count();
  if (sms < 1 || items > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = items < sms ? static_cast<int>(items) : sms;
  flash_attention_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, B, Tq, S, H, KH, causal, window,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int S, int H, int KH, int causal, int window, float scale,
           int is_bf16, cudaStream_t stream) {
  return is_bf16 ? tc::launch<D>(q, k, v, o, B, Tq, S, H, KH, causal, window,
                                 scale, stream)
                 : simt::launch<D>(q, k, v, o, B, Tq, S, H, KH, causal,
                                   window, scale, stream);
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
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, B, Tq, S, H, KH, causal, window, scale,
                        is_bf16, s);
    case 64:
      return launch<64>(q, k, v, o, B, Tq, S, H, KH, causal, window, scale,
                        is_bf16, s);
    case 128:
      return launch<128>(q, k, v, o, B, Tq, S, H, KH, causal, window, scale,
                         is_bf16, s);
    case 256:
      return launch<256>(q, k, v, o, B, Tq, S, H, KH, causal, window, scale,
                         is_bf16, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
