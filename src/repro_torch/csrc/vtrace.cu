// V-trace kernels for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/vtrace.py:
//   * repro_vtrace      <- vtrace_pallas (body _vtrace_kernel): the V-trace
//     reverse recurrence on time-major (T, B) float32 inputs.
//   * repro_loss_vtrace <- loss_vtrace_pallas (body _loss_vtrace_kernel):
//     log-softmax over A, target log-prob, per-step negative entropy, the
//     clipped importance weights rho/c, then the same recurrence.
//
// What bounds them on this card: the recurrence is sequential in time and
// independent across batch columns, so there is one value (acc) carried per
// column. At the learner's shapes (T=20, B=32, A=3) the work is a few
// kilobytes: the launch, not memory or arithmetic, sets the time. At large
// shapes they are bound by memory: K1 moves 8*T*B*4 bytes, K2 reads
// 2*T*B*A*4 + 5*T*B*4 and writes 4*T*B*4 bytes, with a handful of flops per
// byte, far below the card's ridge point.
//
// What the design does about it: one thread per batch column, 128 threads
// a block, ceil(B/128) blocks. The TPU kernel's sequential grid over
// reversed T chunks, with acc carried in VMEM scratch, becomes a loop
// inside the thread with acc in a register. Loads and stores at s*B + b are
// coalesced across a warp because the layout is time-major. The ragged B
// edge is masked by the thread-index test; nothing is padded or copied. K2
// keeps its row's log-softmax in registers (max, then sum of exp, then tlp
// and neg-entropy in a third pass that reads the row from L1), so logits
// never round-trip through device memory between the softmax and the scan.
// The A dimension is not padded to 128 lanes: that padding exists only for
// the TPU's tiling.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false. -fmad=false keeps each multiply and
// add rounded on its own, as the plain PyTorch versions round them; with
// the plain K2 summing over A in this loop's order, the kernels agree with
// their plain versions bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;

// One reverse step of the recurrence; returns the new accumulator.
__device__ __forceinline__ float vtrace_step(float rho, float c, float disc,
                                             float rew, float v, float vtp1,
                                             float acc, float* vs_out,
                                             float* pg_out) {
  *pg_out = rho * (rew + disc * (vtp1 + acc) - v);
  const float delta = rho * (rew + disc * vtp1 - v);
  acc = delta + disc * c * acc;
  *vs_out = v + acc;
  return acc;
}

__global__ void __launch_bounds__(kThreads)
vtrace_kernel(const float* __restrict__ rho, const float* __restrict__ c,
              const float* __restrict__ disc, const float* __restrict__ rew,
              const float* __restrict__ v, const float* __restrict__ vtp1,
              float* __restrict__ vs, float* __restrict__ pg, int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float acc = 0.0f;
  for (int s = T - 1; s >= 0; --s) {
    const size_t i = static_cast<size_t>(s) * B + b;
    acc = vtrace_step(rho[i], c[i], disc[i], rew[i], v[i], vtp1[i], acc,
                      &vs[i], &pg[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
loss_vtrace_kernel(const float* __restrict__ logits,
                   const float* __restrict__ onehot,
                   const float* __restrict__ blp,
                   const float* __restrict__ disc,
                   const float* __restrict__ rew,
                   const float* __restrict__ v,
                   const float* __restrict__ vtp1,
                   float* __restrict__ tlp_out, float* __restrict__ ne_out,
                   float* __restrict__ vs, float* __restrict__ pg, int T,
                   int B, int A, float rho_bar, int clip_rho, float c_bar,
                   int clip_c, float lambda) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float acc = 0.0f;
  for (int s = T - 1; s >= 0; --s) {
    const size_t i = static_cast<size_t>(s) * B + b;
    const float* row = logits + i * A;
    const float* oh = onehot + i * A;
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
    tlp_out[i] = tlp;
    ne_out[i] = ne;
    const float rho_raw = expf(tlp - blp[i]);
    const float rho = clip_rho ? fminf(rho_bar, rho_raw) : rho_raw;
    const float c = lambda * (clip_c ? fminf(c_bar, rho_raw) : rho_raw);
    acc = vtrace_step(rho, c, disc[i], rew[i], v[i], vtp1[i], acc, &vs[i],
                      &pg[i]);
  }
}

inline int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so a refused launch is seen at once.
extern "C" int repro_vtrace(const float* rho, const float* c,
                            const float* disc, const float* rew,
                            const float* v, const float* vtp1, float* vs,
                            float* pg, int T, int B, void* stream) {
  vtrace_kernel<<<blocks_for(B), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(rho, c, disc, rew, v,
                                                       vtp1, vs, pg, T, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_loss_vtrace(const float* logits, const float* onehot,
                                 const float* blp, const float* disc,
                                 const float* rew, const float* v,
                                 const float* vtp1, float* tlp, float* ne,
                                 float* vs, float* pg, int T, int B, int A,
                                 float rho_bar, int clip_rho, float c_bar,
                                 int clip_c, float lambda, void* stream) {
  loss_vtrace_kernel<<<blocks_for(B), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      logits, onehot, blp, disc, rew, v, vtp1, tlp, ne, vs, pg, T, B, A,
      rho_bar, clip_rho, c_bar, clip_c, lambda);
  return static_cast<int>(cudaGetLastError());
}
