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

// XLA's erf_inv (Giles' polynomials in w = -log1p(-x*x)), term for term
// as cimba_tpu_torch/random/distributions.py:_erf_inv evaluates it; the
// coefficients are rounded from double as the plain version rounds them
__device__ float erf_inv(float x) {
  const double lt5[9] = {
      2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
      0.00021858087,  -0.00125372503, -0.00417768164, 0.246640727,
      1.50140941};
  const double ge5[9] = {
      -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
      0.00573950773,   -0.0076224613,  0.00943887047, 1.00167406,
      2.83297682};
  float w = -log1pf(x * -x);
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = float(lt ? lt5[0] : ge5[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) p = float(lt ? lt5[i] : ge5[i]) + p * w;
  return fabsf(x) == 1.0f ? x * INFINITY : p * x;
}

__device__ double erf_inv(double x) {
  const double lt625[23] = {
      -3.6444120640178196996e-21, -1.685059138182016589e-19,
      1.2858480715256400167e-18,  1.115787767802518096e-17,
      -1.333171662854620906e-16,  2.0972767875968561637e-17,
      6.6376381343583238325e-15,  -4.0545662729752068639e-14,
      -8.1519341976054721522e-14, 2.6335093153082322977e-12,
      -1.2975133253453532498e-11, -5.4154120542946279317e-11,
      1.051212273321532285e-09,   -4.1126339803469836976e-09,
      -2.9070369957882005086e-08, 4.2347877827932403518e-07,
      -1.3654692000834678645e-06, -1.3882523362786468719e-05,
      0.0001867342080340571352,   -0.00074070253416626697512,
      -0.0060336708714301490533,  0.24015818242558961693,
      1.6536545626831027356};
  const double lt16[19] = {
      2.2137376921775787049e-09,  9.0756561938885390979e-08,
      -2.7517406297064545428e-07, 1.8239629214389227755e-08,
      1.5027403968909827627e-06,  -4.013867526981545969e-06,
      2.9234449089955446044e-06,  1.2475304481671778723e-05,
      -4.7318229009055733981e-05, 6.8284851459573175448e-05,
      2.4031110387097893999e-05,  -0.0003550375203628474796,
      0.00095328937973738049703,  -0.0016882755560235047313,
      0.0024914420961078508066,   -0.0037512085075692412107,
      0.005370914553590063617,    1.0052589676941592334,
      3.0838856104922207635};
  const double ge16[17] = {
      -2.7109920616438573243e-11, -2.5556418169965252055e-10,
      1.5076572693500548083e-09,  -3.7894654401267369937e-09,
      7.6157012080783393804e-09,  -1.4960026627149240478e-08,
      2.9147953450901080826e-08,  -6.7711997758452339498e-08,
      2.2900482228026654717e-07,  -9.9298272942317002539e-07,
      4.5260625972231537039e-06,  -1.9681778105531670567e-05,
      7.5995277030017761139e-05,  -0.00021503011930044477347,
      -0.00013871931833623122026, 1.0103004648645343977,
      4.8499064014085844221};
  double w = -log1p(x * -x);
  const bool a = w < 6.25, b = w < 16.0;
  w = a ? w - 3.125 : sqrt(w) - (b ? 3.25 : 5.0);
  // branch a: 23 terms, branch b: 19, otherwise 17
  double p = a ? lt625[0] : (b ? lt16[0] : ge16[0]);
#pragma unroll
  for (int i = 1; i < 17; ++i)
    p = (a ? lt625[i] : (b ? lt16[i] : ge16[i])) + p * w;
  if (b) {
#pragma unroll
    for (int i = 17; i < 19; ++i) p = (a ? lt625[i] : lt16[i]) + p * w;
  }
  if (a) {
#pragma unroll
    for (int i = 19; i < 23; ++i) p = lt625[i] + p * w;
  }
  return fabs(x) == 1.0 ? x * INFINITY : p * x;
}

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
