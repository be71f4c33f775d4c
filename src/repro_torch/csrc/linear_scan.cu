// The diagonal linear recurrence (K3) for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel linear_scan_pallas (body _scan_kernel) of
// src/repro/kernels/linear_scan.py: h_t = a_t * h_{t-1} + b_t over (T, N)
// float32, h_{-1} = h0 (N,) or zeros. On the serving path it is the Mamba-2
// cross-chunk state pass: T = chunks, N = batch * heads * head_dim * state.
//
// What bounds it on this card: two flops per element against 12 bytes moved
// (a and b read once, h written once), far below the ridge point, so memory:
// 3 * T * N * 4 bytes (+ 4 * N for h0) over 3.35 TB/s.
//
// What the design does about it: one thread owns one channel n and walks
// t = 0..T-1 with h in a register, so the TPU kernel's sequential grid over
// T chunks, its carry in VMEM scratch and its a = 1 padding to the block
// sizes all go. Neighbouring threads own neighbouring channels, so each
// step's loads of a and b and store of h are coalesced across a warp (the
// layout is time-major, row t at t * N). The loop is unrolled so that the
// loads of a few steps, which do not depend on h, are in flight together.
// A ragged N is the thread-index test; a null h0 means zeros. Offsets are
// int64: T * N passes 2^31 at long contexts.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false. -fmad=false keeps the multiply and
// the add rounded apart, as the plain PyTorch loop rounds them, so the two
// agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ h0, float* __restrict__ h,
                   int64_t T, int64_t N) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  float acc = h0 != nullptr ? h0[n] : 0.0f;
#pragma unroll 8
  for (int64_t t = 0; t < T; ++t) {
    const int64_t i = t * N + n;
    acc = a[i] * acc + b[i];
    h[i] = acc;
  }
}

}  // namespace

// Launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so a refused launch is seen at once.
extern "C" int repro_linear_scan(const float* a, const float* b,
                                 const float* h0, float* h, int64_t T,
                                 int64_t N, void* stream) {
  const int64_t blocks = (N + kThreads - 1) / kThreads;
  linear_scan_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, b, h0, h, T,
                                                            N);
  return static_cast<int>(cudaGetLastError());
}
