// V-trace kernels for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/vtrace.py:
//   * repro_vtrace      <- vtrace_pallas (body _vtrace_kernel): the V-trace
//     reverse recurrence on time-major (T, B) float32 inputs.
//   * repro_loss_vtrace <- loss_vtrace_pallas (body _loss_vtrace_kernel):
//     log-softmax over A, target log-prob, per-step negative entropy, the
//     clipped importance weights rho/c, then the same recurrence.
//
// What bounds them on this card. The recurrence
//   acc_s = delta_s + coef_s * acc_{s+1},  delta_s = rho (r + g V_{s+1} - V),
//   coef_s = g c
// is serial in time and independent across batch columns; everything else
// (the log-softmax, tlp, entropy, rho, c, delta, coef, and afterwards
// vs_s = V + acc_s and pg_s, which needs acc_{s+1}) is independent across
// rows (s, b). At the learner's (20, 32, 3) the work is 38 KB: the launch
// and the wrapper's host path set the call's time, and the device time is
// latency (the loads, then 20 dependent steps). At (100, 256, 18) the 4.6
// MB moved set the bound (1.4 us at 3.35 TB/s); K1 moves 8 T B 4 bytes.
// Both are far below the card's ridge point (a few flops a byte).
//
// What the design does about it. One launch a call, three phases a block:
//   (a) every row of the block's T chunk at once, one thread a row across
//       all of the block's threads: the log-softmax, tlp, neg-entropy and
//       rho/c in the same per-row arithmetic and left-to-right A order as
//       the plain version, then delta and coef into shared memory. The
//       chunk's logits/one-hot tile (128 A contiguous bytes a time step for
//       32 columns) and its (T, B) rows come in by 16-byte cp.async (4-byte
//       where B or B A is not a multiple of 4), double-buffered: the next
//       chunk's copies are in flight under the current one.
//   (b) the chain: one warp, a lane a column, walks the chunk in reverse
//       with only acc = delta + coef * acc on it: delta and coef of the
//       next 8 steps are read from shared memory while the current 8 are
//       walked, with no branch between steps, and the first ones before
//       the carry from the next block has come.
//   (c) vs and pg for every row at once, written out coalesced.
// A block owns a tile of 32 batch columns and a segment of T. Where one
// block a tile would leave most SMs idle (and its bytes would queue on one
// SM), T is split over a thread-block cluster of up to 8 blocks on 8 SMs:
// every block runs (a) on its own segment at once; the segments' chains
// then run last to first, each block storing its final acc into the
// previous block's shared memory with st.async (distributed shared memory,
// counted on that block's mbarrier: no fence on the sending side). The
// order of every rounding is the serial loop's, so nothing is
// reassociated; the chain is the only serial work.
// kernels/vtrace.py:plan_vtrace picks the tile width, the cluster, the
// segments and chunks, the threads and the shared memory (this file's
// smem_layout, which the launch checks against).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false. -fmad=false keeps each multiply and
// add rounded on its own, as the plain PyTorch versions round them; with
// the plain K2 summing over A in this loop's order, the kernels agree with
// their plain versions bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

using namespace repro_async;

constexpr int kWidth = 32;      // batch columns a tile: a lane each in (b)
constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kPrefetch = 8;    // chain steps read ahead into registers
constexpr int kHead = 16;       // bytes ahead of the arrays: the mbarrier

struct Args {
  const float* logits;  // (T, B, A), K2 only
  const float* onehot;  // (T, B, A), K2 only
  // the (T, B) rows a stage holds: K2 blp, disc, rew, v, vtp1; K1 rho, c,
  // disc, rew, v, vtp1
  const float* rows[6];
  float* out;  // K2 (4, T, B): tlp, ne, vs, pg; K1 (2, T, B): vs, pg
  int T, B, A;
  int width, cluster, seg, chunk;
  int vec_rows, vec_logits, stage_logits;
  float rho_bar, c_bar, lambda;
  int clip_rho, clip_c;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared memory: kHead bytes for the carry mbarrier, then in floats two
// stages of [row arrays (5 or 6) | logits | one-hot], the work rows, and
// the 32 carries. Work row r (of chunk + kPrefetch, the first kPrefetch
// padding) holds a (delta, coef) pair for each of the tile's columns,
// delta becoming acc once the chain has passed. Every array starts
// 16-byte aligned. Mirrored by kernels/vtrace.py:smem_bytes.
struct Layout {
  int rows4, logit4, stage, work;
  size_t bytes;
};

__host__ __device__ inline Layout smem_layout(bool loss, int chunk, int width,
                                              int a, bool stage_logits) {
  Layout l;
  l.rows4 = round4(chunk * width);
  l.logit4 = (loss && stage_logits) ? round4(chunk * width * a) : 0;
  l.stage = (loss ? 5 : 6) * l.rows4 + 2 * l.logit4;
  l.work = round4(2 * (chunk + kPrefetch) * width);
  l.bytes = kHead + 4 * static_cast<size_t>(2 * l.stage + l.work + kWidth);
  return l;
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// This thread's arrival on bar, which now also waits for `bytes` of stores
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for phase 0 of bar to complete, seeing at cluster scope what the
// stores it counted wrote. A phase that never completes traps after about
// two seconds (a launch error) rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
    if (!done && clock64() - start > (4ll << 30)) __trap();
  }
}

// Store x into the previous block's carry slot with st.async, which counts
// its 4 bytes against that block's carry mbarrier.
__device__ __forceinline__ void hand_carry(uint32_t carry, uint32_t bar,
                                           float x) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(carry),
      "f"(x), "r"(bar)
      : "memory");
}

// n time steps of count floats each, at src + s * src_stride, to dst +
// s * dst_stride, by the whole block: 16-byte cp.async pieces where vec
// (then src, dst, both strides and count are multiples of 4 floats), else
// 4-byte ones. A step of 32 pieces or more goes to one warp, a lane a
// piece; shorter steps are spread over all threads.
__device__ __forceinline__ void stage_steps(float* dst, int dst_stride,
                                            const float* src,
                                            size_t src_stride, int n,
                                            int count, bool vec) {
  const int shift = vec ? 2 : 0;
  const int per = count >> shift;  // pieces a time step
  auto copy = [&](int s, int piece) {
    const int q = piece << shift;
    float* d = dst + s * dst_stride + q;
    const float* g = src + s * src_stride + q;
    if (vec)
      cp_async16(d, g, true);
    else
      cp_async4(d, g, true);
  };
  if (per >= 32) {
    const int warps = blockDim.x >> 5;
    for (int s = threadIdx.x >> 5; s < n; s += warps)
      for (int piece = threadIdx.x & 31; piece < per; piece += 32)
        copy(s, piece);
  } else {
    for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
      const int s = i / per;
      copy(s, i - s * per);
    }
  }
}

// Copy time steps [s0, s0 + n) of the tile's nb columns from b0 into a
// stage, and commit them as one cp.async group.
template <bool LOSS>
__device__ __forceinline__ void stage_chunk(const Args& p, const Layout& l,
                                            float* st, int b0, int nb, int s0,
                                            int n) {
  constexpr int kRows = LOSS ? 5 : 6;
  const size_t off = static_cast<size_t>(s0) * p.B + b0;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    stage_steps(st + r * l.rows4, p.width, p.rows[r] + off, p.B, n, nb,
                p.vec_rows);
  if (LOSS && p.stage_logits) {
    const size_t row = static_cast<size_t>(p.B) * p.A;
    const int wa = p.width * p.A;
    float* lg = st + kRows * l.rows4;
    stage_steps(lg, wa, p.logits + off * p.A, row, n, nb * p.A,
                p.vec_logits);
    stage_steps(lg + l.logit4, wa, p.onehot + off * p.A, row, n, nb * p.A,
                p.vec_logits);
  }
  cp_async_commit();
}

// K2's terms of one row of A logits and its one-hot, in the plain
// version's order: the max, the sum of exp from left to right, the log of
// it, then tlp and neg-entropy from left to right.
__device__ __forceinline__ void row_terms(const float* row, const float* oh,
                                          int A, float* tlp_out,
                                          float* ne_out) {
  float m = row[0];
  for (int a = 1; a < A; ++a) m = fmaxf(m, row[a]);
  float sum = 0.0f;
  for (int a = 0; a < A; ++a) sum += expf(row[a] - m);
  const float lse = logf(sum);
  float tlp = 0.0f;
  float ne = 0.0f;
  for (int a = 0; a < A; ++a) {
    const float lp = row[a] - m - lse;
    tlp += lp * oh[a];
    ne += expf(lp) * lp;
  }
  *tlp_out = tlp;
  *ne_out = ne;
}

// The chain over a chunk of n steps for one column. q is the column's
// (delta, coef) pair in the chunk's last work row; row r - 1 lies 2 width
// floats below row r. The constructor reads the first steps' pairs (before
// the carry it will need has come); run() then computes acc = delta +
// coef * acc (rounded twice, no fma) from the last step to the first,
// each acc stored over its delta. The top n % 8 steps go first, so every
// later group of 8 is whole: its pairs are read while the group before it
// is walked (reads past row 0 land in the padding rows), and the chain
// waits on the multiply and the add only, with no branch between steps.
struct Walk {
  static constexpr int G = kPrefetch;
  float d[G], c[G], dn[G], cn[G];
  float* q;
  float* g;
  int top, groups, stride;

  __device__ __forceinline__ static void pair(const float* r, float* d,
                                              float* c) {
    const float2 v = *reinterpret_cast<const float2*>(r);
    *d = v.x;
    *c = v.y;
  }

  __device__ __forceinline__ Walk(float* q_, int n, int width)
      : q(q_), top(n % G), groups(n / G), stride(2 * width) {
    if (top > 0) {
#pragma unroll
      for (int u = 0; u < G - 1; ++u) pair(q - u * stride, &d[u], &c[u]);
    }
    g = q - top * stride;  // the first whole group's last row
#pragma unroll
    for (int u = 0; u < G; ++u) pair(g - u * stride, &dn[u], &cn[u]);
  }

  __device__ __forceinline__ float run(float acc) {
#pragma unroll
    for (int u = 0; u < G - 1; ++u) {
      if (u < top) {
        acc = d[u] + c[u] * acc;
        q[-u * stride] = acc;
      }
    }
    for (int k = groups; k > 0; --k) {
#pragma unroll
      for (int u = 0; u < G; ++u) {
        d[u] = dn[u];
        c[u] = cn[u];
      }
#pragma unroll
      for (int u = 0; u < G; ++u)
        pair(g - (G + u) * stride, &dn[u], &cn[u]);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        acc = d[u] + c[u] * acc;
        g[-u * stride] = acc;
      }
      g -= G * stride;
    }
    return acc;
  }
};

// (s, col) of row i of a chunk whose time steps are width rows long
__device__ __forceinline__ void split_row(int i, int width, int* s,
                                          int* col) {
  *s = width == kWidth ? i / kWidth : i / width;
  *col = i - *s * width;
}

// grid: cluster * tiles blocks, clusters of `cluster` consecutive blocks;
// a cluster owns a tile of `width` batch columns, its rank-k block the
// time steps [k seg, min(T, (k + 1) seg)), in chunks of `chunk` steps.
template <bool LOSS>
__global__ void __launch_bounds__(kMaxThreads)
vtrace_tile_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l =
      smem_layout(LOSS, p.chunk, p.width, p.A, p.stage_logits != 0);
  const uint32_t bar_carry = smem_addr(smem);
  float* base = reinterpret_cast<float*>(smem + kHead);
  float* work = base + 2 * l.stage;
  float* carry = work + l.work;

  const int rank = blockIdx.x % p.cluster;
  const int b0 = (blockIdx.x / p.cluster) * p.width;
  const int nb = min(p.width, p.B - b0);
  const int s_lo = rank * p.seg;
  const int s_hi = min(p.T, s_lo + p.seg);
  const int nchunks = (s_hi - s_lo + p.chunk - 1) / p.chunk;
  const bool clustered = p.cluster > 1;
  const bool fed = clustered && rank + 1 < p.cluster;  // gets a carry
  const int stride = 2 * p.width;                      // work rows
  const size_t tb = static_cast<size_t>(p.T) * p.B;
  float* vs_out = p.out + (LOSS ? 2 : 0) * tb;
  float* pg_out = vs_out + tb;

  if (fed) {
    if (threadIdx.x == 0) {
      // its own arrival and the 32 carries' 128 bytes complete it
      mbar_init(bar_carry);
      mbar_expect(bar_carry, kWidth * 4);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
  }
  if (clustered) cluster_arrive();  // waited on before the first hand-over

  // chunks from the last to the first; chunk j is [s_lo + j chunk, ...)
  auto chunk_lo = [&](int j) { return s_lo + j * p.chunk; };
  auto chunk_len = [&](int j) {
    return min(s_hi, chunk_lo(j) + p.chunk) - chunk_lo(j);
  };
  stage_chunk<LOSS>(p, l, base, b0, nb, chunk_lo(nchunks - 1),
                    chunk_len(nchunks - 1));
  if (nchunks > 1)
    stage_chunk<LOSS>(p, l, base + l.stage, b0, nb, chunk_lo(nchunks - 2),
                      chunk_len(nchunks - 2));

  float acc = 0.0f;  // the chain warp's carry, a lane a column
  for (int it = 0; it < nchunks; ++it) {
    const int j = nchunks - 1 - it;
    const int s0 = chunk_lo(j);
    const int n = chunk_len(j);
    float* st = base + (it & 1) * l.stage;
    float* st_rho = st;  // K2 writes rho over blp; K1 stages rho here
    const float* st_disc = st + (LOSS ? 1 : 2) * l.rows4;
    const float* st_rew = st_disc + l.rows4;
    const float* st_v = st_rew + l.rows4;
    const float* st_vtp1 = st_v + l.rows4;
    if (it + 1 < nchunks)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();

    // (a) every row of the chunk at once
    for (int i = threadIdx.x; i < n * p.width; i += blockDim.x) {
      int s, col;
      split_row(i, p.width, &s, &col);
      if (col >= nb) continue;
      float rho, c;
      if constexpr (LOSS) {
        const size_t g = static_cast<size_t>(s0 + s) * p.B + b0 + col;
        const float* row;
        const float* oh;
        if (p.stage_logits) {
          row = st + 5 * l.rows4 + i * p.A;
          oh = row + l.logit4;
        } else {
          row = p.logits + g * p.A;
          oh = p.onehot + g * p.A;
        }
        float tlp, ne;
        row_terms(row, oh, p.A, &tlp, &ne);
        p.out[g] = tlp;
        p.out[tb + g] = ne;
        const float rho_raw = expf(tlp - st_rho[i]);
        rho = p.clip_rho ? fminf(p.rho_bar, rho_raw) : rho_raw;
        c = p.lambda * (p.clip_c ? fminf(p.c_bar, rho_raw) : rho_raw);
        st_rho[i] = rho;
      } else {
        rho = st_rho[i];
        c = st[l.rows4 + i];
      }
      const float disc = st_disc[i];
      float* w = work + (kPrefetch + s) * stride + 2 * col;
      w[0] = rho * (st_rew[i] + disc * st_vtp1[i] - st_v[i]);
      w[1] = disc * c;
    }
    if (clustered && it == 0) cluster_wait();
    __syncthreads();

    // (b) the chain, one warp
    if (threadIdx.x < kWidth) {
      const int lane = threadIdx.x;
      // the acc entering this chunk: the next block's, or this block's
      auto take_carry = [&]() {
        if (it == 0 && fed) {
          mbar_wait(bar_carry);
          acc = carry[lane];
        } else {
          carry[lane] = acc;  // for (c)
        }
      };
      float* q = work + (kPrefetch + n - 1) * stride + 2 * lane;
      if (p.width == kWidth) {
        Walk w(q, n, kWidth);
        take_carry();
        acc = w.run(acc);
      } else {
        take_carry();
        if (lane < p.width) acc = Walk(q, n, p.width).run(acc);
      }
      if (j == 0 && rank > 0)
        hand_carry(map_rank(smem_addr(carry + lane), rank - 1),
                   map_rank(bar_carry, rank - 1), acc);
    }
    __syncthreads();

    // (c) vs and pg for every row at once: pg_s reads acc_{s+1}
    for (int i = threadIdx.x; i < n * p.width; i += blockDim.x) {
      int s, col;
      split_row(i, p.width, &s, &col);
      if (col >= nb) continue;
      const size_t g = static_cast<size_t>(s0 + s) * p.B + b0 + col;
      const float* w = work + (kPrefetch + s) * stride + 2 * col;
      const float a_next = s + 1 < n ? w[stride] : carry[col];
      const float v = st_v[i];
      vs_out[g] = v + w[0];
      pg_out[g] =
          st_rho[i] * (st_rew[i] + st_disc[i] * (st_vtp1[i] + a_next) - v);
    }
    if (it + 2 < nchunks) {
      __syncthreads();  // (c) has read the stage the next copies refill
      stage_chunk<LOSS>(p, l, st, b0, nb, chunk_lo(j - 2), chunk_len(j - 2));
    }
  }
}

// A plain launch for one block a tile, a cluster launch otherwise.
template <bool LOSS>
int launch_kernel(const Args& p, int threads, size_t smem,
                  cudaStream_t stream) {
  cudaError_t err =
      raise_smem_limit<vtrace_tile_kernel<LOSS>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p.B + p.width - 1) / p.width;
  if (p.cluster == 1) {
    vtrace_tile_kernel<LOSS><<<tiles, threads, smem, stream>>>(p);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.cluster * tiles);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, vtrace_tile_kernel<LOSS>, p);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// Check the plan against the shapes (it comes from plan_vtrace), pick
// 16-byte copies where the rows' sizes and addresses allow them, then
// launch.
template <bool LOSS>
int launch(Args& p, int threads, int smem, cudaStream_t stream) {
  const Layout l =
      smem_layout(LOSS, p.chunk, p.width, p.A, p.stage_logits != 0);
  const bool ok = p.T >= 1 && p.B >= 1 && p.width == min(kWidth, p.B) &&
                  p.cluster >= 1 && p.cluster <= kMaxCluster && p.seg >= 1 &&
                  (p.cluster - 1) * p.seg < p.T && p.cluster * p.seg >= p.T &&
                  p.chunk >= 1 && p.chunk <= p.seg && threads >= kWidth &&
                  threads <= kMaxThreads && threads % kWidth == 0 &&
                  l.bytes == static_cast<size_t>(smem);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  bool rows_aligned = p.B % 4 == 0;
  for (int r = 0; r < (LOSS ? 5 : 6); ++r)
    rows_aligned = rows_aligned && aligned16(p.rows[r]);
  p.vec_rows = rows_aligned;
  p.vec_logits = LOSS && (static_cast<size_t>(p.B) * p.A) % 4 == 0 &&
                 aligned16(p.logits) && aligned16(p.onehot);
  return launch_kernel<LOSS>(p, threads, l.bytes, stream);
}

}  // namespace

// Inputs (T, B) float32 (K2's logits and one-hot (T, B, A)), contiguous;
// out holds (2, T, B) for K1 (vs, pg) and (4, T, B) for K2 (tlp, ne, vs,
// pg). cluster, seg, chunk, threads, stage_logits and smem are
// plan_vtrace's; a plan that does not fit the shapes is refused with
// cudaErrorInvalidValue. Each entry point launches once on the caller's
// stream, allocates nothing and returns cudaGetLastError() so a refused
// launch is seen at once.
extern "C" int repro_vtrace(const float* rho, const float* c,
                            const float* disc, const float* rew,
                            const float* v, const float* vtp1, float* out,
                            int T, int B, int cluster, int seg, int chunk,
                            int threads, int smem, void* stream) {
  Args p = {};
  p.rows[0] = rho;
  p.rows[1] = c;
  p.rows[2] = disc;
  p.rows[3] = rew;
  p.rows[4] = v;
  p.rows[5] = vtp1;
  p.out = out;
  p.T = T;
  p.B = B;
  p.A = 0;
  p.width = B < kWidth ? B : kWidth;
  p.cluster = cluster;
  p.seg = seg;
  p.chunk = chunk;
  return launch<false>(p, threads, smem, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_loss_vtrace(const float* logits, const float* onehot,
                                 const float* blp, const float* disc,
                                 const float* rew, const float* v,
                                 const float* vtp1, float* out, int T, int B,
                                 int A, int cluster, int seg, int chunk,
                                 int threads, int stage_logits, int smem,
                                 float rho_bar, int clip_rho, float c_bar,
                                 int clip_c, float lambda, void* stream) {
  Args p = {};
  p.logits = logits;
  p.onehot = onehot;
  p.rows[0] = blp;
  p.rows[1] = disc;
  p.rows[2] = rew;
  p.rows[3] = v;
  p.rows[4] = vtp1;
  p.out = out;
  p.T = T;
  p.B = B;
  p.A = A;
  p.width = B < kWidth ? B : kWidth;
  p.cluster = cluster;
  p.seg = seg;
  p.chunk = chunk;
  p.stage_logits = stage_logits;
  p.rho_bar = rho_bar;
  p.clip_rho = clip_rho;
  p.c_bar = c_bar;
  p.clip_c = clip_c;
  p.lambda = lambda;
  if (A < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(p, threads, smem, static_cast<cudaStream_t>(stream));
}
