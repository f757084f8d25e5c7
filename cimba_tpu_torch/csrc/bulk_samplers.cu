// Bulk Threefry samplers for Hopper (sm_90a): the kernels K2, K3 and K4.
//
// Replace the Pallas kernels of the JAX package
// (cimba_tpu/random/pallas_kernels.py: _run <- exponential_block (K2),
// normal_block (K3), exponential_block_zig (K4)), which fill an [R, n]
// block of variates with each stream's Threefry counter advanced in the
// kernel: sample j of stream r uses counter base_r + j (K4: counters
// strided by n, see exp_zig_kernel).
//
// Design: one thread per sample (r, j), in a grid-stride loop over the
// 64-bit flat index r * n + j; consecutive threads write consecutive
// samples of a row.  The thread of sample (r, 0) also writes stream r's
// advanced counter, so a call is one launch.  K4's two 256-entry tables
// are loaded once per block into shared memory: lanes index different
// layers, which constant memory would serialise.
//
// What bounds it on this card: instruction issue.  Each sample costs one
// 20-round Threefry-2x32 block (~73 integer operations as Hopper executes
// them, a rotate being one funnel shift; K4 one to three blocks, as its
// rounds accept) and a log1p or erf_inv, against 4 or 8 bytes of output:
// ~20 (f32) or ~10 (f64) integer operations per byte, where the card
// issues ~10 per byte it can move, so f32 is bound by issue and f64 by
// issue and bytes about equally.  K4's rounds stop at the first accept
// (the counters are positional, so skipping a round an earlier one made
// moot changes no value).
//
// Built with --fmad=false so float results follow the plain PyTorch
// version's separately rounded operations (the same CUDA log1p, exp and
// sqrt): kernel and plain version are expected to agree bit for bit.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "erfinv.cuh"
#include "threefry.cuh"

namespace cimba {
namespace blocks {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;
constexpr int kZigRounds = 2;

struct Streams {
  const int64_t* k0;
  const int64_t* k1;
  const int64_t* lo;
  const int64_t* hi;
  int64_t* new_lo;
  int64_t* new_hi;
};

// the Threefry words of stream r at counter base_r + off, with the u32
// carry of the JAX kernels' _block_bits
__device__ __forceinline__ void bits_at(const Streams& s, int64_t r,
                                        uint32_t off, uint32_t& b0,
                                        uint32_t& b1) {
  const uint32_t lo = uint32_t(s.lo[r]) + off;
  const uint32_t hi = uint32_t(s.hi[r]) + (lo < off ? 1u : 0u);
  threefry2x32(uint32_t(s.k0[r]), uint32_t(s.k1[r]), lo, hi, b0, b1);
}

// uniform01_53 of the profile: f32 takes 24 bits of the high word, f64 a
// 53-bit significand from both words
__device__ __forceinline__ float u53(uint32_t, uint32_t b1, float) {
  return float(int32_t(b1 >> 8)) * 0x1p-24f;
}
__device__ __forceinline__ double u53(uint32_t b0, uint32_t b1, double) {
  return double(b1) * 0x1p-32 + double(b0 >> 11) * 0x1p-53;
}

__device__ __forceinline__ float log1p_of(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_of(double x) { return log1p(x); }
__device__ __forceinline__ float exp_of(float x) { return expf(x); }
__device__ __forceinline__ double exp_of(double x) { return exp(x); }

// out[r * n + j] = value(r, j) for every sample, grid-stride; the thread
// of (r, 0) writes stream r's counter advanced by `consumed`
template <typename R, typename F>
__device__ void for_each_sample(const Streams& s, R* out, int64_t rows,
                                int64_t n, uint32_t consumed, F value) {
  const int64_t total = rows * n;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t dr = stride / n, dj = stride % n;
  int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t r = i / n, j = i - r * n;
  for (; i < total; i += stride) {
    if (j == 0) {
      const uint32_t lo = uint32_t(s.lo[r]) + consumed;
      s.new_lo[r] = lo;
      s.new_hi[r] = uint32_t(s.hi[r]) + (lo < consumed ? 1u : 0u);
    }
    out[i] = value(r, uint32_t(j));
    r += dr;
    j += dj;
    if (j >= n) {
      j -= n;
      ++r;
    }
  }
}

// K2: -log1p(-u), u the profile's uniform01_53 of counter base + j
template <typename R>
__global__ void __launch_bounds__(kThreads)
exponential_kernel(Streams s, R* out, int64_t rows, int64_t n) {
  for_each_sample(s, out, rows, n, uint32_t(n), [&](int64_t r, uint32_t j) {
    uint32_t b0, b1;
    bits_at(s, r, j, b0, b1);
    return -log1p_of(-u53(b0, b1, R(0)));
  });
}

// K3: sqrt(2) * erf_inv(clip(2u - 1, -1 + eps/2, 1 - eps/2))
template <typename R>
__global__ void __launch_bounds__(kThreads)
normal_kernel(Streams s, R* out, int64_t rows, int64_t n) {
  const double tiny = (sizeof(R) == 4 ? 0x1p-23 : 0x1p-52) / 2.0;
  const R lo = R(-1.0 + tiny), hi = R(1.0 - tiny);
  const R sqrt2 = R(1.4142135623730951);
  for_each_sample(s, out, rows, n, uint32_t(n), [&](int64_t r, uint32_t j) {
    uint32_t b0, b1;
    bits_at(s, r, j, b0, b1);
    R x = R(2) * u53(b0, b1, R(0)) - R(1);
    x = x < lo ? lo : (x > hi ? hi : x);
    return sqrt2 * erf_inv(x);
  });
}

// K4: up to kZigRounds ziggurat rounds, then an exact inversion.  Round
// k takes its layer word at counter base + 2kn + j and, on a layer-0
// miss, its tail word at base + (2k+1)n + j; the fallback takes base +
// 4n + j.  The layer, x and y tests are the JAX kernel's (a full-width
// u32 convert for x, 24 bits of the low word for y); the tail and the
// fallback use the profile's uniform01_53.
template <typename R>
__global__ void __launch_bounds__(kThreads)
exp_zig_kernel(Streams s, R* out, const R* xt, const R* yt, int64_t rows,
               int64_t n, double r_exp, double v_exp) {
  __shared__ R xs_tab[256];
  __shared__ R ys_tab[256];
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    xs_tab[t] = xt[t];
    ys_tab[t] = yt[t];
  }
  __syncthreads();
  const R* xs = xs_tab;
  const R* ys = ys_tab;
  const R r_const = R(r_exp);
  const R base_w = R(v_exp) / ys[255];
  const uint32_t un = uint32_t(n);
  for_each_sample(
      s, out, rows, n, uint32_t((2 * kZigRounds + 1) * n),
      [&](int64_t r, uint32_t j) {
        for (int k = 0; k < kZigRounds; ++k) {
          uint32_t b0, b1;
          bits_at(s, r, 2 * k * un + j, b0, b1);
          const int layer = int(b0 & 0xFFu);
          const bool is0 = layer == 0;
          const R x = R(b1) * R(0x1p-32) * (is0 ? base_w : xs[layer]);
          const bool hot = x < (is0 ? r_const : xs[layer - 1]);
          if (hot) return x;
          if (is0) {  // the exact memoryless tail: r + Exp(1)
            uint32_t t0, t1;
            bits_at(s, r, (2 * k + 1) * un + j, t0, t1);
            return r_const - log1p_of(-u53(t0, t1, R(0)));
          }
          const R u2 = R(b0 >> 8) * R(0x1p-24);
          const R ylo = ys[layer];
          const R y = ylo + u2 * (ys[layer - 1] - ylo);
          if (y < exp_of(-x)) return x;
        }
        uint32_t f0, f1;
        bits_at(s, r, 2 * kZigRounds * un + j, f0, f1);
        return -log1p_of(-u53(f0, f1, R(0)));
      });
}

template <typename R>
int launch(int kind, const int64_t* k0, const int64_t* k1,
           const int64_t* lo, const int64_t* hi, int64_t* new_lo,
           int64_t* new_hi, R* out, const R* xt, const R* yt, int64_t rows,
           int64_t n, double r_exp, double v_exp, void* stream) {
  if (rows <= 0 || n <= 0) return -2;
  const Streams s{k0, k1, lo, hi, new_lo, new_hi};
  const int64_t want = (rows * n + kThreads - 1) / kThreads;
  const int blocks = int(want < kMaxBlocks ? want : kMaxBlocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    exponential_kernel<R><<<blocks, kThreads, 0, st>>>(s, out, rows, n);
  } else if (kind == 1) {
    normal_kernel<R><<<blocks, kThreads, 0, st>>>(s, out, rows, n);
  } else {
    exp_zig_kernel<R><<<blocks, kThreads, 0, st>>>(s, out, xt, yt, rows, n,
                                                   r_exp, v_exp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace blocks
}  // namespace cimba

// Plain C interface (loaded with ctypes).  k0, k1, lo, hi: the [R]
// stream words (u32 values in int64); new_lo, new_hi: [R] outputs, the
// advanced counters; out: [R, n] samples; xt, yt: K4's 256-entry tables
// in the output's dtype (unused by K2 and K3).  Launches on ``stream``
// without synchronising; returns cudaGetLastError() after the launch
// (0 = ok), or -2 for an empty block.
#define CIMBA_BLOCK_ENTRY(NAME, KIND, R)                                     \
  extern "C" int NAME(const int64_t* k0, const int64_t* k1,                 \
                      const int64_t* lo, const int64_t* hi, int64_t* new_lo, \
                      int64_t* new_hi, R* out, const R* xt, const R* yt,     \
                      int64_t rows, int64_t n, double r_exp, double v_exp,   \
                      void* stream) {                                        \
    return cimba::blocks::launch<R>(KIND, k0, k1, lo, hi, new_lo, new_hi,    \
                                    out, xt, yt, rows, n, r_exp, v_exp,      \
                                    stream);                                 \
  }

CIMBA_BLOCK_ENTRY(cimba_exponential_block_f32, 0, float)
CIMBA_BLOCK_ENTRY(cimba_exponential_block_f64, 0, double)
CIMBA_BLOCK_ENTRY(cimba_normal_block_f32, 1, float)
CIMBA_BLOCK_ENTRY(cimba_normal_block_f64, 1, double)
CIMBA_BLOCK_ENTRY(cimba_exponential_block_zig_f32, 2, float)
CIMBA_BLOCK_ENTRY(cimba_exponential_block_zig_f64, 2, double)
