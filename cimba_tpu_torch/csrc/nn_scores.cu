// The AWACS detection MLP (K5) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package
// (cimba_tpu/models/awacs.py: nn_scores -> _nn_kernel, body _nn_forward):
//   h1 = relu(F W1 + b1), h2 = relu(h1 W2 + b2),
//   p  = sigmoid([h2, g] W3 + b3)
// over M rows, F [M, 8], g [M], W1 [8, 32], W2 [32, 32], W3 [33, 1],
// all f32.  The TPU kernel runs the stack on the MXU over one lane's
// rows padded to 128; here one launch covers every row of every lane
// (M = lanes x targets) and needs no padding.
//
// Design: one thread per row.  The 1378 weight and bias floats are
// loaded once per block into shared memory (every thread of a warp reads
// the same words: a broadcast, no bank conflict); the row's 8 features
// and h1[32], h2[32] stay in registers.  The row's arithmetic is
// csrc/nn_row.cuh, which the AWACS dwell kernel (csrc/awacs_chunk.cu)
// shares: on the AWACS path the MLP runs inside that kernel, and this
// standalone launch serves models.awacs.nn_forward (nn_scores, and the
// plain engine's dwell on the card).
//
// What bounds it on this card: operations.  Per row 2 x (8x32 + 32x32
// + 33) = 2626 multiply-add operations, 65 bias adds, 64 relu compares
// and the sigmoid, against 40 bytes of input and output (8 features, g,
// one score): ~2760 / 40 = 69 operations a byte, far above the card's
// ~20 f32 operations per byte of device memory.  Built with
// --fmad=false (as every kernel of the port), the multiplies and adds
// issue separately, twice the instructions of fused multiply-adds;
// fused forms and 3xTF32 tensor-core products are later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "nn_row.cuh"

namespace cimba {
namespace nn {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ feats, const float* __restrict__ g,
          const float* __restrict__ weights, float* __restrict__ out,
          int64_t m) {
  __shared__ __align__(16) float w[N_WEIGHTS];
  for (int i = threadIdx.x; i < N_WEIGHTS; i += blockDim.x) w[i] = weights[i];
  __syncthreads();
  const int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= m) return;
  float f[F];
#pragma unroll
  for (int k = 0; k < F; ++k) f[k] = feats[r * F + k];
  out[r] = row(w, f, g[r]);
}

}  // namespace nn
}  // namespace cimba

// Plain C interface (loaded with ctypes).  feats [m, 8], g [m], weights
// the 1378 packed floats, out [m]: device pointers.  Launches on
// ``stream`` without synchronising; returns cudaGetLastError() after the
// launch (0 = ok), or -2 for m <= 0.
extern "C" int cimba_nn_scores(const float* feats, const float* g,
                               const float* weights, float* out, int64_t m,
                               void* stream) {
  using cimba::nn::kThreads;
  if (m <= 0) return -2;
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  cimba::nn::nn_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      feats, g, weights, out, m);
  return static_cast<int>(cudaGetLastError());
}
