// The device samplers of the chunk kernels (csrc/queue_chunk.cu), one
// Threefry-2x32 block a draw, each as cimba_tpu_torch/random/
// distributions.py computes it from that block's two words (b0, b1):
// uniform01 and uniform01_53, the standard exponential -log1p(-u53), the
// standard normal sqrt2 * erf_inv(clip(2 u53 - 1)), and the samplers a
// generated instance names (uniform01, exponential, uniform, normal,
// lognormal, triangular).  Built with --fmad=false and CUDA's math library, as torch
// runs them on the card, so a variate equals the plain version's bit for
// bit.
//
// A parameter is a Python number of the block (Lit, weakly typed as torch
// takes it: arithmetic among such numbers in double, then rounded to the
// sample's dtype R where it meets the sample) or a tensor value of dtype
// T (the arithmetic in T, the result in the dtype torch promotes T and R
// to).  A sampler's parameters are all Lits or all tensors of one dtype.
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "erfinv.cuh"

namespace cimba {

__device__ __forceinline__ float log1p_of(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_of(double x) { return log1p(x); }
__device__ __forceinline__ float exp_of(float x) { return expf(x); }
__device__ __forceinline__ double exp_of(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_of(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_of(double x) { return sqrt(x); }

// uniform01_53: f32 takes 24 bits of the high word, f64 a 53-bit
// significand from both words
__device__ __forceinline__ float u53_of(uint32_t, uint32_t b1, float) {
  return float(int32_t(b1 >> 8)) * 0x1p-24f;
}
__device__ __forceinline__ double u53_of(uint32_t b0, uint32_t b1, double) {
  return double(b1) * 0x1p-32 + double(b0 >> 11) * 0x1p-53;
}

// uniform01: f32 24 bits of the high word (as uniform01_53), f64 32 bits
__device__ __forceinline__ float u01_of(uint32_t b1, float) {
  return float(int32_t(b1 >> 8)) * 0x1p-24f;
}
__device__ __forceinline__ double u01_of(uint32_t b1, double) {
  return double(b1) * 0x1p-32;
}

// the normal's clip of 2u - 1, one step of the dtype inside (-1, 1)
template <typename R>
__device__ __forceinline__ R normal_clip(R u) {
  constexpr double tiny = (sizeof(R) == 4 ? 0x1p-23 : 0x1p-52) / 2.0;
  const R lo = R(-1.0 + tiny), hi = R(1.0 - tiny);
  const R x = R(2) * u - R(1);
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename R>
__device__ __forceinline__ R std_exponential(uint32_t b0, uint32_t b1) {
  return -log1p_of(-u53_of(b0, b1, R(0)));
}

template <typename R>
__device__ __forceinline__ R std_normal(uint32_t b0, uint32_t b1) {
  const R x = normal_clip(u53_of(b0, b1, R(0)));
  return R(1.4142135623730951) * erf_inv_w(x, -log1p_of(x * -x));
}

// a Python number of the block
struct Lit {
  double v;
};

// a parameter's roles: raw (its own arithmetic: double for a Lit, T for a
// tensor) and, where it meets a sample of dtype R, its value in the
// result's dtype O
template <typename R, typename A>
struct Par {
  using O = std::common_type_t<A, R>;
  __device__ static A raw(A a) { return a; }
};
template <typename R>
struct Par<R, Lit> {
  using O = R;
  __device__ static double raw(Lit a) { return a.v; }
};

template <typename R, typename A>
using out_t = typename Par<R, A>::O;

// distributions.uniform01
template <typename R>
__device__ __forceinline__ R uniform01(uint32_t, uint32_t b1) {
  return u01_of(b1, R(0));
}

// distributions.exponential: mean * x
template <typename R, typename A>
__device__ __forceinline__ out_t<R, A> exponential(uint32_t b0, uint32_t b1,
                                                   A mean) {
  using O = out_t<R, A>;
  return O(Par<R, A>::raw(mean)) * O(std_exponential<R>(b0, b1));
}

// distributions.uniform: lo + (hi - lo) * u
template <typename R, typename A>
__device__ __forceinline__ out_t<R, A> uniform(uint32_t, uint32_t b1, A lo,
                                               A hi) {
  using O = out_t<R, A>;
  using P = Par<R, A>;
  const R u = u01_of(b1, R(0));
  return O(P::raw(lo)) + O(P::raw(hi) - P::raw(lo)) * O(u);
}

// distributions.normal: mu + sigma * z
template <typename R, typename A>
__device__ __forceinline__ out_t<R, A> normal(uint32_t b0, uint32_t b1, A mu,
                                              A sigma) {
  using O = out_t<R, A>;
  using P = Par<R, A>;
  return O(P::raw(mu)) + O(P::raw(sigma)) * O(std_normal<R>(b0, b1));
}

// distributions.lognormal: exp(normal(m, s))
template <typename R, typename A>
__device__ __forceinline__ out_t<R, A> lognormal(uint32_t b0, uint32_t b1,
                                                 A m, A s) {
  return exp_of(normal<R>(b0, b1, m, s));
}

// distributions.triangular (inversion): the left branch below the mode's
// quantile fc, else the right
template <typename R, typename A>
__device__ __forceinline__ out_t<R, A> triangular(uint32_t, uint32_t b1, A lo,
                                                  A mode, A hi) {
  using O = out_t<R, A>;
  using P = Par<R, A>;
  const R u = u01_of(b1, R(0));
  const auto hl = P::raw(hi) - P::raw(lo);
  const auto fc = (P::raw(mode) - P::raw(lo)) / hl;
  const O left =
      O(P::raw(lo)) + sqrt_of(O(u) * O(hl) * O(P::raw(mode) - P::raw(lo)));
  const O right = O(P::raw(hi)) - sqrt_of(O(R(1) - u) * O(hl) *
                                          O(P::raw(hi) - P::raw(mode)));
  return O(u) < O(fc) ? left : right;
}

}  // namespace cimba
