// Bulk Threefry samplers for Hopper (sm_90a): the kernels K2, K3 and K4.
//
// Replace the Pallas kernels of the JAX package
// (cimba_tpu/random/pallas_kernels.py: _run <- exponential_block (K2),
// normal_block (K3), exponential_block_zig (K4)), which fill an [R, n]
// block of variates with each stream's Threefry counter advanced in the
// kernel: sample j of stream r uses counter base_r + j (K4: counters
// strided by n, see exp_zig_kernel).
//
// What bounds them on this card: operations, not bytes.  Each sample costs
// one 20-round Threefry-2x32 block (~73 integer operations as Hopper
// executes them; K4 one to three blocks, as its rounds accept) and a log1p
// or erf_inv, against 4 or 8 bytes of output.  Of a block's instructions,
// ptxas issues the adds on the FMA pipe (IMAD) and the 20 funnel-shift
// rotates, the 20 xors and the key injections on the integer ALU pipe,
// 64 lanes a clock an SM: that pipe holds f32's K2 and K3.  In f64, CUDA's
// log1p and K3's polynomial (22 multiplies and 22 adds, separately
// rounded) on the FP64 pipe take more than the words do.
//
// K2 and K3: each thread draws a run of consecutive samples of one row (8
// in f32; in f64 8 for K2, 4 for K3: kRun), in a grid-stride loop over
// the runs of the block, with 32-bit in-row indices.  A run loads its
// stream's four words once, computes the key schedule once
// (ThreefryKey), and draws all its words before its values, so the
// samples' chains interleave; its samples are stored as 16-byte vectors
// where the row allows, so a warp's stores cover contiguous bytes.  The
// grid is the card's SMs times the blocks the occupancy calculator lets
// reside on one.  In f64, CUDA's log1p branches on its argument, and a
// warp of uniform draws runs both of its paths: a whole warp sorts its
// arguments by that branch through shared memory first (log1p_run).
// K3's erf_inv takes its central branch alone (erf_inv_w_central, no
// selects, no sqrt) in a warp whose lanes all fall in it: ~90 % of the
// votes in f32 (one a sample) and ~88 % in f64 (one a run of 4).  The
// thread of run (r, 0) also writes stream r's advanced counter, so a call
// is one launch.
//
// K4 (the ziggurat): runs of kRunZig samples of one row a thread, on the
// same card-sized grid, with the run's stream and key schedule loaded
// once.  Round 1 of the whole run first: its layer words, then each
// sample's x and hot test from one shared-memory load of the layer's
// (scale, limit) pair, the scale taken times 2**-32 (exact, so x's bits
// are the plain version's).  About 2 % of samples miss round 1 (a wedge
// or a layer-0 tail; half of them go on to round 2); a warp that ran each
// miss where it fell would run the slow paths with one lane of 32 in
// half its steps.  So a
// ballot gathers the warp's misses, with their stream and round-1 words,
// into the warp's queue in shared memory, and a warp whose queue holds
// 32 works through 32 at once, one a lane: the wedge's exp, the tail's
// log1p, round 2 and the fallback run on dense lanes (zig_finish).  A
// sample's value depends on its counters alone, so a value computed in
// another lane is the same; the queued lane stores it over the run's
// placeholder, a __syncwarp after the run's store.  Misses past a full
// queue wait in their lane's mask for the next room (zig_overflow).
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
constexpr int kZigRounds = 2;
// K2 and K3: consecutive samples a thread draws from one row (kRun)
constexpr int kRun32 = 8;     // K2 and K3, f32
constexpr int kRunExp64 = 8;  // K2, f64
constexpr int kRunNor64 = 4;  // K3, f64: 8 took 76 registers and ran slower
constexpr int kRunZig = 8;    // K4, both profiles
// K4: a warp's queue of round-1 misses, and the count it is worked at
constexpr unsigned kZigQueue = 64;
constexpr unsigned kZigBatch = kZigQueue < 32 ? kZigQueue : 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;

struct Streams {
  const int64_t* k0;
  const int64_t* k1;
  const int64_t* lo;
  const int64_t* hi;
  int64_t* new_lo;
  int64_t* new_hi;
};

// One stream's Threefry-2x32 key schedule, held in registers for a run
// of its counters: block() gives threefry2x32's words (threefry.cuh,
// which K1 keeps as it is), word() those of counter base + off with the
// u32 carry of the JAX kernels' _block_bits.  With threefry2x32 called
// for each sample, ptxas gave K2 f64's run of 8 an 8 B stack frame.
struct ThreefryKey {
  uint32_t k0, k1, a1, a2, a3, a4, a5, b1, b2, b3, b4, b5;

  __device__ __forceinline__ ThreefryKey(uint32_t key0, uint32_t key1)
      : k0(key0), k1(key1) {
    const uint32_t ks2 = key0 ^ key1 ^ 0x1BD11BDAu;
    a1 = key1; b1 = ks2 + 1u;
    a2 = ks2;  b2 = key0 + 2u;
    a3 = key0; b3 = key1 + 3u;
    a4 = key1; b4 = ks2 + 4u;
    a5 = ks2;  b5 = key0 + 5u;
  }

  __device__ __forceinline__ void block(uint32_t c0, uint32_t c1,
                                        uint32_t& o0, uint32_t& o1) const {
    uint32_t x0 = c0 + k0;
    uint32_t x1 = c1 + k1;
#define CIMBA_TFK_ROUND(r) \
  x0 += x1;                \
  x1 = rotl32(x1, r);      \
  x1 ^= x0;
#define CIMBA_TFK_A \
  CIMBA_TFK_ROUND(13) CIMBA_TFK_ROUND(15) CIMBA_TFK_ROUND(26) CIMBA_TFK_ROUND(6)
#define CIMBA_TFK_B \
  CIMBA_TFK_ROUND(17) CIMBA_TFK_ROUND(29) CIMBA_TFK_ROUND(16) CIMBA_TFK_ROUND(24)
    CIMBA_TFK_A x0 += a1; x1 += b1;
    CIMBA_TFK_B x0 += a2; x1 += b2;
    CIMBA_TFK_A x0 += a3; x1 += b3;
    CIMBA_TFK_B x0 += a4; x1 += b4;
    CIMBA_TFK_A x0 += a5; x1 += b5;
#undef CIMBA_TFK_B
#undef CIMBA_TFK_A
#undef CIMBA_TFK_ROUND
    o0 = x0;
    o1 = x1;
  }

  __device__ __forceinline__ void word(uint32_t lo, uint32_t hi, uint32_t off,
                                       uint32_t& o0, uint32_t& o1) const {
    const uint32_t c0 = lo + off;
    block(c0, hi + (c0 < off ? 1u : 0u), o0, o1);
  }
};

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

// 16 bytes of samples, v[0..] to p (16-byte aligned)
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// out[r, j] = the value of (b0, b1), the Threefry words of stream r at
// counter base_r + j (ThreefryKey::word), for every sample: each
// thread takes runs of S consecutive samples of one row, grid-stride over
// the block's rows x ceil(n / S) runs.  A run's words are all drawn
// before its values are computed (`values`, a functor on N words at once:
// N = S, or 1 for each sample of a row's short last run, n % S), so the
// samples' chains interleave.  `vec`: every full run starts 16-byte
// aligned (n and the output's address allow it), and is stored as
// 16-byte vectors.  The thread of run (r, 0) writes stream r's counter
// advanced by n.
template <typename R, int S, typename F>
__device__ __forceinline__ void for_each_run(const Streams& s, R* out,
                                             int64_t rows, uint32_t n,
                                             bool vec, F values) {
  static_assert(S * sizeof(R) % 16 == 0, "a run fills 16-byte vectors");
  const uint32_t runs = (n - 1) / S + 1;
  const uint32_t stride = gridDim.x * blockDim.x;
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t dr = stride / runs, dk = stride % runs;
  int64_t r = t / runs;
  uint32_t k = t % runs;
  while (r < rows) {
    const ThreefryKey key(uint32_t(s.k0[r]), uint32_t(s.k1[r]));
    const uint32_t lo = uint32_t(s.lo[r]), hi = uint32_t(s.hi[r]);
    const uint32_t j0 = k * S;
    if (k == 0) {
      const uint32_t nlo = lo + n;
      s.new_lo[r] = nlo;
      s.new_hi[r] = hi + (nlo < n ? 1u : 0u);
    }
    R* row = out + r * int64_t(n);
    if (n - j0 >= uint32_t(S)) {
      uint32_t b0[S], b1[S];
      R v[S];
#pragma unroll
      for (int i = 0; i < S; ++i)
        key.word(lo, hi, j0 + uint32_t(i), b0[i], b1[i]);
      values(b0, b1, v);
      if (vec) {
#pragma unroll
        for (int i = 0; i < S; i += 16 / int(sizeof(R)))
          store16(row + j0 + i, v + i);
      } else {
#pragma unroll
        for (int i = 0; i < S; ++i) row[j0 + i] = v[i];
      }
    } else {
      for (uint32_t off = j0; off < n; ++off) {
        uint32_t b0[1], b1[1];
        R v[1];
        key.word(lo, hi, off, b0[0], b1[0]);
        values(b0, b1, v);
        row[off] = v[0];
      }
    }
    r += dr;
    k += dk;
    if (k >= runs) {
      k -= runs;
      ++r;
    }
  }
}

// the run of kernel KIND (0: K2, 1: K3) in the profile of R
template <typename R, int KIND>
constexpr int kRun = sizeof(R) == 4 ? kRun32 : KIND == 0 ? kRunExp64
                                                         : kRunNor64;

// a[i] = log1p(a[i]) for a run of f64 samples.  CUDA's log1p takes one
// of two paths by its argument (|a| below about 0.4, or not), and a warp
// whose lanes hold both runs both, one after the other: a warp of uniform
// draws always does.  So where all 32 lanes are here together, the
// warp's 32 N arguments are first sorted by that test through shared
// memory (a value moves to another lane and back; its log1p is the same
// wherever it is computed), so that at most one of the N calls holds both
// kinds.  f32's log1pf costs the same either way and is called in place.
template <int N>
__device__ __forceinline__ void log1p_run(double (&a)[N]) {
  __shared__ double slots[kThreads * N];
  if (__activemask() == 0xFFFFFFFFu) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned lt = (1u << lane) - 1u;
    double* warp = slots + (threadIdx.x - lane) * N;
    unsigned small[N], tot = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      small[i] = __ballot_sync(0xFFFFFFFFu, fabs(a[i]) < 0.4);
      tot += __popc(small[i]);
    }
    // the sorted order: the small arguments by (i, lane), then the rest
    unsigned dest[N], below = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      dest[i] = (small[i] >> lane) & 1u
                    ? below + __popc(small[i] & lt)
                    : tot + 32u * i - below + __popc(~small[i] & lt);
      below += __popc(small[i]);
      warp[dest[i]] = a[i];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < N; ++i)
      warp[32 * i + lane] = log1p(warp[32 * i + lane]);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = warp[dest[i]];
    __syncwarp();
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = log1p(a[i]);
  }
}

// whether a run of N samples of R computes its log1ps through log1p_run
template <typename R, int N>
constexpr bool kSorted = sizeof(R) == 8 && N > 1;

// K2's values: -log1p(-u), u the profile's uniform01_53 of the words
template <typename R>
struct Exponentials {
  template <int N>
  __device__ __forceinline__ void operator()(const uint32_t (&b0)[N],
                                             const uint32_t (&b1)[N],
                                             R (&v)[N]) const {
    if constexpr (kSorted<R, N>) {
      R a[N];
#pragma unroll
      for (int i = 0; i < N; ++i) a[i] = -u53(b0[i], b1[i], R(0));
      log1p_run(a);
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = -a[i];
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = -log1p_of(-u53(b0[i], b1[i], R(0)));
    }
  }
};

// erf_inv's central branch ends at w = 5 (f32) or 6.25 (f64)
__device__ __forceinline__ bool central(float w) { return w < 5.0f; }
__device__ __forceinline__ bool central(double w) { return w < 6.25; }

// K3's values: sqrt(2) * erf_inv(clip(2u - 1, -1 + eps/2, 1 - eps/2)).
// Every sample's w first; then a warp whose lanes all have w in the
// central branch evaluates it alone (the same operations, so the same
// bits): in f64 one vote for the run (0.1 % of samples have w >= 6.25,
// so a warp's 128 miss it ~12 % of the time), in f32 one a sample (0.34 %
// have w >= 5: a vote over a warp's 256 would miss ~58 %)
template <typename R>
struct Normals {
  template <int N>
  __device__ __forceinline__ void operator()(const uint32_t (&b0)[N],
                                             const uint32_t (&b1)[N],
                                             R (&v)[N]) const {
    const double tiny = (sizeof(R) == 4 ? 0x1p-23 : 0x1p-52) / 2.0;
    const R lo = R(-1.0 + tiny), hi = R(1.0 - tiny);
    const R sqrt2 = R(1.4142135623730951);
    R x[N], w[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      x[i] = R(2) * u53(b0[i], b1[i], R(0)) - R(1);
      x[i] = x[i] < lo ? lo : (x[i] > hi ? hi : x[i]);
      if constexpr (kSorted<R, N>)
        w[i] = x[i] * -x[i];
      else
        w[i] = -log1p_of(x[i] * -x[i]);
    }
    if constexpr (kSorted<R, N>) {
      log1p_run(w);
#pragma unroll
      for (int i = 0; i < N; ++i) w[i] = -w[i];
    }
    if constexpr (sizeof(R) == 8) {
      bool all = true;
#pragma unroll
      for (int i = 0; i < N; ++i) all = all && central(w[i]);
      if (__all_sync(__activemask(), all)) {
#pragma unroll
        for (int i = 0; i < N; ++i)
          v[i] = sqrt2 * erf_inv_w_central(x[i], w[i]);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] = sqrt2 * erf_inv_w(x[i], w[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = __all_sync(__activemask(), central(w[i]))
                   ? sqrt2 * erf_inv_w_central(x[i], w[i])
                   : sqrt2 * erf_inv_w(x[i], w[i]);
    }
  }
};

// K2: -log1p(-u), u the profile's uniform01_53 of counter base + j
template <typename R>
__global__ void __launch_bounds__(kThreads)
exponential_kernel(Streams s, R* out, int64_t rows, uint32_t n, bool vec) {
  for_each_run<R, kRun<R, 0>>(s, out, rows, n, vec, Exponentials<R>());
}

// K3: sqrt(2) * erf_inv(clip(2u - 1)), as Normals computes it
template <typename R>
__global__ void __launch_bounds__(kThreads)
normal_kernel(Streams s, R* out, int64_t rows, uint32_t n, bool vec) {
  for_each_run<R, kRun<R, 1>>(s, out, rows, n, vec, Normals<R>());
}

// K4's layer l: round 1 takes x = R(b1) * w and accepts it where x <
// lim.  w is the layer's width times 2**-32 (layer 0: the base strip's
// v / y[255]), lim the width of the layer below (layer 0: r); the pair
// is one shared-memory load
template <typename R>
struct alignas(2 * sizeof(R)) ZigLayer {
  R w, lim;
};

// a round-1 miss of K4 in its warp's queue: the stream, the round-1
// words, the sample's column j and its offset in the output
struct ZigMiss {
  uint32_t k0, k1, lo, hi, b0, b1, j;
  int64_t at;
};

// K4's tables in shared memory (lay[0].lim is r, where the tail starts)
template <typename R>
struct ZigTables {
  ZigLayer<R> lay[256];
  R ys[256];
};

// the wedge's test of a round's x in layer l (1 <= l <= 255): y, from 24
// bits of b0, under the density at x
template <typename R>
__device__ __forceinline__ bool zig_wedge(const ZigTables<R>& z, int l,
                                          uint32_t b0, R x) {
  const R u2 = R(b0 >> 8) * R(0x1p-24);
  const R ylo = z.ys[l];
  const R y = ylo + u2 * (z.ys[l - 1] - ylo);
  return y < exp_of(-x);
}

// the value of a sample that missed round 1 (m: its queue entry): round
// 1's wedge or tail, then round 2 (its layer word at base + 2n + j, its
// tail word at base + 3n + j), then the fallback at base + 4n + j.  The
// tail is the exact memoryless r + Exp(1); tail and fallback take the
// profile's uniform01_53
template <typename R>
__device__ __forceinline__ R zig_finish(const ZigTables<R>& z, uint32_t n,
                                        const ZigMiss& m) {
  static_assert(kZigRounds == 2, "zig_finish runs rounds 1 and 2");
  const ThreefryKey key(m.k0, m.k1);
  uint32_t b0 = m.b0, b1 = m.b1;
  int l = int(b0 & 0xFFu);
  R x = R(b1) * z.lay[l].w;
  bool tail = l == 0;
  uint32_t off = n + m.j;
  if (!tail) {
    if (zig_wedge(z, l, b0, x)) return x;
    key.word(m.lo, m.hi, 2 * n + m.j, b0, b1);
    l = int(b0 & 0xFFu);
    x = R(b1) * z.lay[l].w;
    if (x < z.lay[l].lim) return x;
    tail = l == 0;
    if (!tail && zig_wedge(z, l, b0, x)) return x;
    off = (tail ? 3 : 4) * n + m.j;
  }
  key.word(m.lo, m.hi, off, b0, b1);
  const R v = log1p_of(-u53(b0, b1, R(0)));
  return tail ? z.lay[0].lim - v : -v;
}

// the warp's last `cnt` queued misses, one a lane: each lane stores its
// miss's value (over the placeholder its own lane stored before the
// __syncwarp)
template <typename R>
__device__ __forceinline__ void zig_flush(const ZigTables<R>& z, uint32_t n,
                                          R* out, const ZigMiss* q,
                                          unsigned& qn, unsigned cnt) {
  __syncwarp();
  for (unsigned e = threadIdx.x & 31u; e < cnt; e += 32) {
    const ZigMiss& m = q[qn - cnt + e];
    out[m.at] = zig_finish(z, n, m);
  }
  __syncwarp();
  qn -= cnt;
}

// misses that found the queue full (bit i of `pend`: sample j0 + i of
// the lane's run, whose output starts at `at0`), after the run's store:
// the queue is worked empty and they are queued, their round-1 words
// drawn again, until none is left
template <typename R>
__device__ __forceinline__ void zig_overflow(const ZigTables<R>& z,
                                             uint32_t n, R* out, ZigMiss* q,
                                             unsigned& qn, unsigned pend,
                                             const ThreefryKey& key,
                                             uint32_t lo, uint32_t hi,
                                             uint32_t j0, int64_t at0) {
  const unsigned lt = (1u << (threadIdx.x & 31u)) - 1u;
  while (__any_sync(kFull, pend != 0)) {
    while (qn > 0) zig_flush(z, n, out, q, qn, qn < 32 ? qn : 32u);
#pragma unroll 1
    for (int i = 0; i < kRunZig; ++i) {
      const bool p = (pend >> i) & 1u;
      const unsigned bal = __ballot_sync(kFull, p);
      const unsigned slot = qn + __popc(bal & lt);
      if (p && slot < kZigQueue) {
        uint32_t b0, b1;
        key.word(lo, hi, j0 + uint32_t(i), b0, b1);
        q[slot] = ZigMiss{key.k0, key.k1, lo, hi, b0, b1, j0 + uint32_t(i),
                          at0 + i};
        pend &= ~(1u << i);
      }
      qn = qn + __popc(bal) < kZigQueue ? qn + __popc(bal) : kZigQueue;
    }
  }
}

// K4: up to kZigRounds ziggurat rounds, then an exact inversion.  Round
// k takes its layer word at counter base + 2kn + j and, on a layer-0
// miss, its tail word at base + (2k+1)n + j; the fallback takes base +
// 4n + j.  The layer, x and y tests are the JAX kernel's (a full-width
// u32 convert for x, 24 bits of the low word for y); the tail and the
// fallback use the profile's uniform01_53.  Each thread takes runs of S
// samples of a row, grid-stride over rows x ceil(n / S) runs as
// for_each_run, but the warp steps together (a lane past the last run
// votes no miss) so that its ballots and its queue see every lane.  The
// thread of run (r, 0) writes stream r's counter advanced by 5n.  Under
// launch bounds of kThreads alone ptxas held K4 f64 to 64 registers and
// spilled; asking for 2 resident blocks an SM lets it take 76 (f32 60)
// and spill nothing.
template <typename R>
__global__ void __launch_bounds__(kThreads, 2)
exp_zig_kernel(Streams s, R* out, const R* xt, const R* yt, int64_t rows,
               uint32_t n, bool vec, double r_exp, double v_exp) {
  constexpr int S = kRunZig;
  static_assert(S * sizeof(R) % 16 == 0 && S <= 32, "a run of K4");
  __shared__ ZigTables<R> z;
  __shared__ ZigMiss queues[kThreads / 32][kZigQueue];
  const R r_const = R(r_exp);
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    const R w = t == 0 ? R(v_exp) / yt[255] : xt[t];
    z.lay[t].w = w * R(0x1p-32);
    z.lay[t].lim = t == 0 ? r_const : xt[t - 1];
    z.ys[t] = yt[t];
  }
  __syncthreads();
  const unsigned lt = (1u << (threadIdx.x & 31u)) - 1u;
  ZigMiss* q = queues[threadIdx.x >> 5];
  unsigned qn = 0;  // the warp's queued misses, the same in every lane
  const uint32_t consumed = uint32_t(2 * kZigRounds + 1) * n;
  const uint32_t runs = (n - 1) / S + 1;
  const uint32_t stride = gridDim.x * blockDim.x;
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t dr = stride / runs, dk = stride % runs;
  int64_t r = t / runs;
  uint32_t k = t % runs;
  for (;;) {
    const bool active = r < rows;
    if (!__any_sync(kFull, active)) break;
    while (qn >= kZigBatch) zig_flush(z, n, out, q, qn, kZigBatch);
    uint32_t k0 = 0, k1 = 0, lo = 0, hi = 0;
    if (active) {
      k0 = uint32_t(s.k0[r]);
      k1 = uint32_t(s.k1[r]);
      lo = uint32_t(s.lo[r]);
      hi = uint32_t(s.hi[r]);
      if (k == 0) {
        const uint32_t nlo = lo + consumed;
        s.new_lo[r] = nlo;
        s.new_hi[r] = hi + (nlo < consumed ? 1u : 0u);
      }
    }
    const ThreefryKey key(k0, k1);
    const uint32_t j0 = k * S;
    const int64_t at0 = r * int64_t(n) + j0;
    uint32_t b0[S], b1[S];
#pragma unroll
    for (int i = 0; i < S; ++i)
      key.word(lo, hi, j0 + uint32_t(i), b0[i], b1[i]);
    R v[S];
    unsigned pend = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const ZigLayer<R> L = z.lay[b0[i] & 0xFFu];
      v[i] = R(b1[i]) * L.w;
      const bool miss = active && j0 + uint32_t(i) < n && !(v[i] < L.lim);
      const unsigned bal = __ballot_sync(kFull, miss);
      if (miss) {
        const unsigned slot = qn + __popc(bal & lt);
        if (slot < kZigQueue)
          q[slot] = ZigMiss{k0, k1, lo, hi, b0[i], b1[i], j0 + uint32_t(i),
                            at0 + i};
        else
          pend |= 1u << i;
      }
      qn += __popc(bal);  // past kZigQueue only until the run's end
    }
    qn = qn < kZigQueue ? qn : kZigQueue;
    if (active) {
      R* p = out + at0;
      if (vec && n - j0 >= uint32_t(S)) {
#pragma unroll
        for (int i = 0; i < S; i += 16 / int(sizeof(R))) store16(p + i, v + i);
      } else {
#pragma unroll
        for (int i = 0; i < S; ++i)
          if (j0 + uint32_t(i) < n) p[i] = v[i];
      }
    }
    if (__any_sync(kFull, pend != 0))
      zig_overflow(z, n, out, q, qn, pend, key, lo, hi, j0, at0);
    if (active) {
      r += dr;
      k += dk;
      if (k >= runs) {
        k -= runs;
        ++r;
      }
    }
  }
  while (qn > 0) zig_flush(z, n, out, q, qn, qn < 32 ? qn : 32u);
}

// the blocks of `kern` that reside on the card at once: its SMs times the
// blocks of it that reside on one (looked up once a device)
template <typename K>
int resident_blocks(K kern, int (&resident)[kMaxDevices], int& blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return -3;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (sms * per_sm <= 0) return -3;
    resident[dev] = sms * per_sm;
  }
  blocks = resident[dev];
  return 0;
}

// a launch of runs of S samples a thread over rows x ceil(n / S): the
// grid is the card's resident blocks of `kern` (`resident` its per-device
// cache), fewer for a small block; go(blocks, vec) launches the kernel
// with its own arguments, vec where rows of n may be stored as 16-byte
// vectors
template <int S, typename R, typename K, typename Go>
int launch_runs(K kern, int (&resident)[kMaxDevices], int64_t rows,
                int64_t n, const R* out, Go go) {
  int most = 0;
  const int rc = resident_blocks(kern, resident, most);
  if (rc != 0) return rc;
  const int64_t units = rows * ((n - 1) / S + 1);
  const int64_t want = (units + kThreads - 1) / kThreads;
  const bool vec = n % (16 / sizeof(R)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  go(int(want < most ? want : most), vec);
  return static_cast<int>(cudaGetLastError());
}

// K2 (kind 0), K3 (1) or K4 (2)
template <typename R>
int launch(int kind, const int64_t* k0, const int64_t* k1,
           const int64_t* lo, const int64_t* hi, int64_t* new_lo,
           int64_t* new_hi, R* out, const R* xt, const R* yt, int64_t rows,
           int64_t n, double r_exp, double v_exp, void* stream) {
  if (rows <= 0 || n <= 0) return -2;
  const Streams s{k0, k1, lo, hi, new_lo, new_hi};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t un = uint32_t(n);
  if (kind == 0) {
    static int resident[kMaxDevices];
    return launch_runs<kRun<R, 0>>(
        exponential_kernel<R>, resident, rows, n, out,
        [&](int blocks, bool vec) {
          exponential_kernel<R><<<blocks, kThreads, 0, st>>>(s, out, rows, un,
                                                             vec);
        });
  }
  if (kind == 1) {
    static int resident[kMaxDevices];
    return launch_runs<kRun<R, 1>>(
        normal_kernel<R>, resident, rows, n, out, [&](int blocks, bool vec) {
          normal_kernel<R><<<blocks, kThreads, 0, st>>>(s, out, rows, un, vec);
        });
  }
  static int resident[kMaxDevices];
  return launch_runs<kRunZig>(
      exp_zig_kernel<R>, resident, rows, n, out, [&](int blocks, bool vec) {
        exp_zig_kernel<R><<<blocks, kThreads, 0, st>>>(s, out, xt, yt, rows,
                                                       un, vec, r_exp, v_exp);
      });
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
