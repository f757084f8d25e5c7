// One row of the AWACS detection MLP, shared by K5 (nn_scores.cu) and the
// AWACS dwell kernel (awacs_chunk.cu), so the two cannot drift apart.
//
//   h1 = relu(F W1 + b1), h2 = relu(h1 W2 + b2),
//   p  = sigmoid([h2, g] W3 + b3)
//
// F [8] features and g (the range gaussian), all f32 on the CUDA cores (no
// TF32): the reference holds its kernel to f32 roundoff.  Each output sums
// its terms in index order and adds its bias last, as a dot product
// followed by the bias add.  The loops run the input index outermost, so
// the weights of one input are a contiguous row read four at a time from
// shared memory (16-byte loads) while every output keeps its own running
// sum in a register; each output's order of operations is unchanged.
// Callers build with --fmad=false, so the multiplies and adds round
// separately.
#pragma once

#include <cstdint>

namespace cimba {
namespace nn {

constexpr int F = 8;    // features per row
constexpr int H = 32;   // hidden width
// packed weights: w1 [F][H], b1 [H], w2 [H][H], b2 [H], w3 [H + 1], b3
constexpr int OFF_W1 = 0;
constexpr int OFF_B1 = OFF_W1 + F * H;
constexpr int OFF_W2 = OFF_B1 + H;
constexpr int OFF_B2 = OFF_W2 + H * H;
constexpr int OFF_W3 = OFF_B2 + H;
constexpr int OFF_B3 = OFF_W3 + H + 1;
constexpr int N_WEIGHTS = OFF_B3 + 1;  // 1378
static_assert(OFF_W2 % 4 == 0 && OFF_B1 % 4 == 0 && OFF_B2 % 4 == 0,
              "rows of four weights must be 16-byte aligned");

// out[j] = relu(sum_k in[k] * w[k][j] + b[j]), k ascending, for an
// [N][H] weight block at w and a bias row at b (shared memory, 16-byte
// aligned)
template <int N>
__device__ __forceinline__ void dense_relu(const float (&in)[N],
                                           const float* w, const float* b,
                                           float (&out)[H]) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int j4 = 0; j4 < H / 4; ++j4) {
    const float4 c = w4[j4];
    out[4 * j4] = in[0] * c.x;
    out[4 * j4 + 1] = in[0] * c.y;
    out[4 * j4 + 2] = in[0] * c.z;
    out[4 * j4 + 3] = in[0] * c.w;
  }
#pragma unroll
  for (int k = 1; k < N; ++k) {
#pragma unroll
    for (int j4 = 0; j4 < H / 4; ++j4) {
      const float4 c = w4[k * (H / 4) + j4];
      out[4 * j4] = out[4 * j4] + in[k] * c.x;
      out[4 * j4 + 1] = out[4 * j4 + 1] + in[k] * c.y;
      out[4 * j4 + 2] = out[4 * j4 + 2] + in[k] * c.z;
      out[4 * j4 + 3] = out[4 * j4 + 3] + in[k] * c.w;
    }
  }
  const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
  for (int j4 = 0; j4 < H / 4; ++j4) {
    const float4 c = b4[j4];
    const float a0 = out[4 * j4] + c.x, a1 = out[4 * j4 + 1] + c.y;
    const float a2 = out[4 * j4 + 2] + c.z, a3 = out[4 * j4 + 3] + c.w;
    out[4 * j4] = a0 > 0.0f ? a0 : 0.0f;
    out[4 * j4 + 1] = a1 > 0.0f ? a1 : 0.0f;
    out[4 * j4 + 2] = a2 > 0.0f ? a2 : 0.0f;
    out[4 * j4 + 3] = a3 > 0.0f ? a3 : 0.0f;
  }
}

// the detection probability of one row; w: the N_WEIGHTS packed floats in
// shared memory, 16-byte aligned
__device__ __forceinline__ float row(const float* w, const float (&f)[F],
                                     float g) {
  float h1[H];
  dense_relu<F>(f, w + OFF_W1, w + OFF_B1, h1);
  float h2[H];
  dense_relu<H>(h1, w + OFF_W2, w + OFF_B2, h2);
  float logit = h2[0] * w[OFF_W3];
#pragma unroll
  for (int k = 1; k < H; ++k) logit = logit + h2[k] * w[OFF_W3 + k];
  logit = logit + g * w[OFF_W3 + H];
  logit = logit + w[OFF_B3];
  return 1.0f / (1.0f + expf(-logit));
}

// models/awacs._nn_features of one target, operation for operation as
// torch runs it on the card: the position and velocity already cast to
// f32; r2 = x*x + y*y; and each division by a Python number is torch's
// CUDA division by a host scalar, a multiplication by the scalar's f32
// reciprocal (BinaryDivTrueKernel.cu)
__device__ __forceinline__ void features(float px, float py, float vx,
                                         float vy, float (&f)[F],
                                         float& g) {
  constexpr float kInvRange2 = 1.0f / 1600.0f;    // DETECT_RANGE**2
  constexpr float kInvArena = 1.0f / 100.0f;      // ARENA
  constexpr float kInvArena2 = 1.0f / 10000.0f;   // ARENA**2
  constexpr float kInvSpeed = 1.0f / 5.0f;        // SPEED
  constexpr float kInvRadial = 1.0f / 200.0f;     // SPEED * DETECT_RANGE
  const float r2 = px * px + py * py;
  g = expf(-r2 * kInvRange2);
  f[0] = px * kInvArena;
  f[1] = py * kInvArena;
  f[2] = r2 * kInvArena2;
  f[3] = g;
  f[4] = vx * kInvSpeed;
  f[5] = vy * kInvSpeed;
  f[6] = (px * vx + py * vy) * kInvRadial;
  f[7] = 1.0f;
}

}  // namespace nn
}  // namespace cimba
