// The device samplers of the chunk kernels (csrc/queue_chunk.cu), one
// Threefry-2x32 block a draw, each as cimba_tpu_torch/random/
// distributions.py computes it from that block's two words (b0, b1):
// uniform01 and uniform01_53, the standard exponential -log1p(-u53), the
// standard normal sqrt2 * erf_inv(clip(2 u53 - 1)), and the samplers a
// generated instance names (uniform01, exponential, uniform, normal,
// lognormal, triangular, the integer dice; and gamma, beta and pert,
// whose Marsaglia-Tsang rejection loop draws a data-dependent number of
// blocks through the lane's own counter, `next`).  Built with
// --fmad=false and CUDA's math library, as torch runs them on the card,
// so a variate equals the plain version's bit for bit.
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
__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ double log_of(double x) { return log(x); }
__device__ __forceinline__ float pow_of(float x, float y) {
  return powf(x, y);
}
__device__ __forceinline__ double pow_of(double x, double y) {
  return pow(x, y);
}

// torch.maximum(x, y) for a y that is not NaN: NaN propagates
template <typename R>
__device__ __forceinline__ R max_nan(R x, R y) {
  return (x != x || x > y) ? x : y;
}

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

// distributions.dice(a, b): a plus the block's 64-bit word (b1 the high
// half) modulo the faces' count b - a + 1, an int64 (discrete_uniform's
// one draw; the count is in (0, 2^47), checked where the call is emitted)
__device__ __forceinline__ int64_t dice(uint32_t b0, uint32_t b1, int64_t a,
                                        int64_t b) {
  const uint64_t n = uint64_t(b - a + 1);
  return a + int64_t(((uint64_t(b1) << 32) | uint64_t(b0)) % n);
}

// distributions.std_gamma of a shape in R (Marsaglia-Tsang): rounds of a
// (std_normal, uniform01) pair of blocks until one is accepted, then the
// boost's uniform01, drawn whether the shape is boosted (< 1) or not.
// (1 + c z)^3 is y * y * y, as the plain version computes it; max(., 1e-300)
// is max(., 0) in f32, where 1e-300 rounds to 0.
template <typename R, class D>
__device__ __forceinline__ R std_gamma(const D& next, R shape) {
  const bool boosted = shape < R(1);
  const R d_shape = boosted ? shape + R(1) : shape;
  const R d = d_shape - R(1.0 / 3.0);
  const R c = R(1) / sqrt_of(R(9) * d);
  R x = R(0);
  bool accepted = false;
  while (!accepted) {
    uint32_t b0, b1;
    next(b0, b1);
    const R z = std_normal<R>(b0, b1);
    next(b0, b1);
    const R u = u01_of(b1, R(0));
    const R y = R(1) + c * z;
    const R v = y * y * y;
    const R lhs = log_of(max_nan(u, R(1e-300)));
    const R rhs = R(0.5) * z * z + d - d * v +
                  d * log_of(max_nan(v, R(1e-300)));
    accepted = v > R(0) && lhs < rhs;
    x = d * v;
  }
  uint32_t b0, b1;
  next(b0, b1);
  const R u = max_nan(u01_of(b1, R(0)), R(1e-300));
  if (!boosted) return x;
  return x * pow_of(u, R(1) / max_nan(shape, R(1e-12)));
}

// distributions.beta on [lo, hi] of shapes a, b already in their raw
// type: lo + (hi - lo) * X / (X + Y), X and Y gammas
template <typename R, class D, typename A, typename B>
__device__ __forceinline__ out_t<R, A> beta_of(const D& next, B a, B b, A lo,
                                               A hi) {
  using O = out_t<R, A>;
  using P = Par<R, A>;
  const R x = std_gamma<R>(next, R(a));
  const R y = std_gamma<R>(next, R(b));
  const R z = x / (x + y);
  return O(P::raw(lo)) + O(P::raw(hi) - P::raw(lo)) * O(z);
}

// distributions.gamma: scale * std_gamma(shape)
template <typename R, class D, typename A>
__device__ __forceinline__ out_t<R, A> gamma(const D& next, A shape,
                                             A scale) {
  using O = out_t<R, A>;
  using P = Par<R, A>;
  return O(P::raw(scale)) * O(std_gamma<R>(next, R(P::raw(shape))));
}

// distributions.beta(a, b, lo, hi)
template <typename R, class D, typename A>
__device__ __forceinline__ out_t<R, A> beta(const D& next, A a, A b, A lo,
                                            A hi) {
  using P = Par<R, A>;
  return beta_of<R>(next, P::raw(a), P::raw(b), lo, hi);
}

// distributions.pert (pert_mod with lam = 4): a beta on [lo, hi] with
// shapes 1 + 4 (mode - lo) / (hi - lo) and 1 + 4 (hi - mode) / (hi - lo),
// computed in the parameters' raw type
template <typename R, class D, typename A>
__device__ __forceinline__ out_t<R, A> pert(const D& next, A lo, A mode,
                                            A hi) {
  using P = Par<R, A>;
  const auto span = P::raw(hi) - P::raw(lo);
  using T = decltype(span);
  const T a = T(1.0) + T(4.0) * (P::raw(mode) - P::raw(lo)) / span;
  const T b = T(1.0) + T(4.0) * (P::raw(hi) - P::raw(mode)) / span;
  return beta_of<R>(next, a, b, lo, hi);
}

}  // namespace cimba
