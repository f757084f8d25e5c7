// XLA's erf_inv (the chlo legalisation: Giles' polynomials in w =
// -log1p(-x*x)), term for term as
// cimba_tpu_torch/random/distributions.py:_erf_inv evaluates it; the
// coefficients are rounded from double as the plain version rounds them.
// Shared by K3 (bulk_samplers.cu, the normal block) and the mg1 instance
// of K1 (queue_chunk.cu, the lognormal service draw), so the two cannot
// drift apart.  f32: two branches of 9 terms, split at w = 5; f64: three
// branches of 23, 19 and 17 terms, split at w = 6.25 and w = 16.  K3 runs
// the central branch alone (erf_inv_w_central) in a warp whose lanes all
// fall in it.
#pragma once

#include <cmath>

// the central branches' coefficients (w < 5 in f32, w < 6.25 in f64),
// shared by erf_inv_w and erf_inv_w_central
#define CIMBA_ERF_LT5                                                   \
  2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,      \
      0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,       \
      1.50140941
#define CIMBA_ERF_LT625                                                 \
  -3.6444120640178196996e-21, -1.685059138182016589e-19,                \
      1.2858480715256400167e-18, 1.115787767802518096e-17,              \
      -1.333171662854620906e-16, 2.0972767875968561637e-17,             \
      6.6376381343583238325e-15, -4.0545662729752068639e-14,            \
      -8.1519341976054721522e-14, 2.6335093153082322977e-12,            \
      -1.2975133253453532498e-11, -5.4154120542946279317e-11,           \
      1.051212273321532285e-09, -4.1126339803469836976e-09,             \
      -2.9070369957882005086e-08, 4.2347877827932403518e-07,            \
      -1.3654692000834678645e-06, -1.3882523362786468719e-05,           \
      0.0001867342080340571352, -0.00074070253416626697512,             \
      -0.0060336708714301490533, 0.24015818242558961693,                \
      1.6536545626831027356

namespace cimba {

// erf_inv(x) given w = -log1p(x * -x), the argument of its polynomial
__device__ __forceinline__ float erf_inv_w(float x, float w) {
  const double lt5[9] = {CIMBA_ERF_LT5};
  const double ge5[9] = {
      -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
      0.00573950773,   -0.0076224613,  0.00943887047, 1.00167406,
      2.83297682};
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = float(lt ? lt5[0] : ge5[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) p = float(lt ? lt5[i] : ge5[i]) + p * w;
  return fabsf(x) == 1.0f ? x * INFINITY : p * x;
}

__device__ __forceinline__ double erf_inv_w(double x, double w) {
  const double lt625[23] = {CIMBA_ERF_LT625};
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

// erf_inv_w's central branch alone, for callers that know every lane of
// the warp has w < 5 (f32) or w < 6.25 (f64): the same operations in the
// same order as erf_inv_w on such a w (|x| < 1 there), without the
// branch selects and the sqrt
__device__ __forceinline__ float erf_inv_w_central(float x, float w) {
  const double lt5[9] = {CIMBA_ERF_LT5};
  w = w - 2.5f;
  float p = float(lt5[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) p = float(lt5[i]) + p * w;
  return p * x;
}

__device__ __forceinline__ double erf_inv_w_central(double x, double w) {
  const double lt625[23] = {CIMBA_ERF_LT625};
  w = w - 3.125;
  double p = lt625[0];
#pragma unroll
  for (int i = 1; i < 23; ++i) p = lt625[i] + p * w;
  return p * x;
}

__device__ __forceinline__ float erf_inv(float x) {
  return erf_inv_w(x, -log1pf(x * -x));
}

__device__ __forceinline__ double erf_inv(double x) {
  return erf_inv_w(x, -log1p(x * -x));
}

}  // namespace cimba
