// The Pébay single-sample merge of stats.summary.add on the card, shared
// by the chunk kernels (queue_chunk.cu, awacs_chunk.cu).
#pragma once

namespace cimba {

// a stats.summary.Summary of one lane
template <typename R>
struct Sum {
  R n, w, mn, mx, m1, m2, m3, m4;
};

// summary.add(a, x, bw): the Pébay merge of a with the singleton
// (1, bw, x, x, x, 0, 0, 0), in the reference's operation order (x**3 =
// x*(x*x), x**4 = (x*x)*(x*x) as XLA evaluates integer powers)
template <typename R>
__device__ __forceinline__ Sum<R> add(const Sum<R>& a, R x, R bw) {
  const R bn = R(1), bm1 = x, bm2 = R(0), bm3 = R(0), bm4 = R(0);
  const R w = a.w + bw;
  const R safe_w = w > R(0) ? w : R(1);
  const R d = bm1 - a.m1;
  const R frac_b = bw / safe_w;
  const R m1 = a.m1 + d * frac_b;
  const R wa_wb = a.w * bw;
  const R sw2 = safe_w * safe_w;
  const R sw3 = safe_w * (safe_w * safe_w);
  const R d2 = d * d;
  const R m2 = a.m2 + bm2 + d * d * wa_wb / safe_w;
  const R m3 = a.m3 + bm3 + d * d2 * wa_wb * (a.w - bw) / sw2 +
               R(3) * d * (a.w * bm2 - bw * a.m2) / safe_w;
  const R m4 = a.m4 + bm4 +
               d2 * d2 * wa_wb * (a.w * a.w - wa_wb + bw * bw) / sw3 +
               R(6) * d * d * (a.w * a.w * bm2 + bw * bw * a.m2) / sw2 +
               R(4) * d * (a.w * bm3 - bw * a.m3) / safe_w;
  const bool take_a = bw == R(0);
  const bool take_b = a.w == R(0);
  Sum<R> o;
  o.n = a.n + bn;
  o.w = w;
  o.mn = a.mn < x ? a.mn : x;
  o.mx = a.mx > x ? a.mx : x;
  o.m1 = take_a ? a.m1 : (take_b ? bm1 : m1);
  o.m2 = take_a ? a.m2 : (take_b ? bm2 : m2);
  o.m3 = take_a ? a.m3 : (take_b ? bm3 : m3);
  o.m4 = take_a ? a.m4 : (take_b ? bm4 : m4);
  return o;
}

}  // namespace cimba
