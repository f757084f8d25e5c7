// The two kernels of the chunk-kernel bisect (K6) for Hopper (sm_90a).
//
// Replace the first two stages of the JAX package's Mosaic bisect
// (tools/mosaic_bisect.py: stage 0 "copy", stage 1 "pop"), which wrap
// the engine's plumbing and its event pick in their own pallas_call so
// that a failing chunk kernel can be cut down to the smallest slice that
// still fails.  Both take the Sim through the same leaf-pointer array as
// the chunk kernels (cimba_tpu_torch/core/kernel_run.py), so they test
// what every chunk kernel shares.
//
// * sim_copy: every leaf of a Sim, in -> out, byte for byte.  It checks
//   the ctypes pointer array, the leaf order, the dtypes and the
//   lane-first contiguity: a wrong one shows as a copy that differs.
// * peek: per lane, the port's event pick, eventset.peek_merged: the
//   (time asc, prio desc, seq asc) lexmin over the general event table
//   and the dense wake table, prio read from procs.prio, the lowest
//   index winning ties, and its Event fields (time, prio, kind, subj,
//   arg, found, handle).  The reference's stage 1 pops argmin32 of the
//   event times, because in its engine that argmin is the pick; in the
//   port the pick is peek_merged, so this kernel computes that.
//
// What bounds them on this card: bytes.  sim_copy moves the whole Sim
// (each byte read once and written once), so it is one launch over all
// leaves as flat bytes: the host cuts every leaf into 16-byte words
// (its 16-byte-aligned body) and single bytes (an unaligned head and
// tail, e.g. a bool leaf of an odd lane count), gives each leaf its run
// of thread blocks (a prefix sum of blocks over the leaves), and in a
// block neighbouring threads take neighbouring words, four words a
// thread loaded before any is stored.  The peek reads the two tables'
// times once and little else.  Where a lane's rows are short (mmc's 14
// events and 4 wakes: PEEK_STAGED_COLS columns at most), a warp stages
// its 32 lanes' rows of both tables' times, contiguous in the lane-first
// tables, in shared memory by asynchronous copies of 32 neighbouring
// elements (cp.async: all of them in flight at once), and each thread
// folds its lane's rows there.  Where they are long (AWACS's 1001
// wakes), a group of G threads a lane (a power of two up to 32) reads
// them in place, thread g taking columns g, g + G, ....  Either way the
// fold has two phases: the times (the row's minimum as torch's amin
// gives it, and its least finite time), then prio, seq and the fields of
// the columns at that time alone (Fold); a group combines each phase by
// butterfly shuffles.  On an H100 (chip_smoke.py --ab): for mmc's rows
// (R=65536) a group of 16 threads a lane took 4.5 times the one-thread
// kernel this replaces, loads into registers before the stores to shared
// memory 0.9 times, and these copies with the two phases 0.75 times; for
// AWACS's (R=4096) the groups of 32 took 0.05 times one unstaged thread a
// lane and 0.025 times the kernel this replaces.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cimba {
namespace bisect {

constexpr int MAX_LEAVES = 96;
constexpr int32_t I32_MIN = INT32_MIN, I32_MAX = INT32_MAX;
constexpr int GEN_SHIFT = 16;

// every Sim's leading leaves, in the reference's jax.tree.leaves order
// (kernel_run._HEAD): the peek reads these
enum Head {
  CLOCK, REP, KEY0, KEY1, CTR_LO, CTR_HI,
  EV_TIME, EV_PRIO, EV_SEQ, EV_KIND, EV_SUBJ, EV_ARG, EV_GEN, EV_NEXT_SEQ,
  EV_OVERFLOW,
  WK_TIME, WK_SIG, WK_SEQ,
  PC, STATUS, PRIO,
  N_HEAD
};

// the copy: each leaf's body in 16-byte words, then its head and tail
// bytes; leaf k owns blocks first_block[k] .. first_block[k + 1] - 1
constexpr int COPY_THREADS = 256;
constexpr int COPY_WORDS = 4;  // units a thread
constexpr int COPY_UNITS = COPY_THREADS * COPY_WORDS;  // units a block

struct CopyArgs {
  const unsigned char* in[MAX_LEAVES];
  unsigned char* out[MAX_LEAVES];
  long long words[MAX_LEAVES];  // 16-byte words of the aligned body
  long long bytes[MAX_LEAVES];  // the leaf's bytes
  unsigned char head[MAX_LEAVES];  // bytes before the body (0-15)
  int first_block[MAX_LEAVES + 1];
  int n;
};

__global__ void __launch_bounds__(COPY_THREADS)
copy_kernel(const __grid_constant__ CopyArgs a) {
  // this block's leaf: the k with first_block[k] <= b < first_block[k+1]
  const int b = blockIdx.x;
  int lo = 0, hi = a.n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (a.first_block[mid] <= b)
      lo = mid;
    else
      hi = mid;
  }
  const unsigned char* in = a.in[lo];
  unsigned char* out = a.out[lo];
  const long long words = a.words[lo];
  const long long head = a.head[lo];
  const long long units = words + (a.bytes[lo] - 16 * words);
  const long long u0 =
      (long long)(b - a.first_block[lo]) * COPY_UNITS + threadIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(in + head);
  uint4* dst = reinterpret_cast<uint4*>(out + head);
  uint4 v[COPY_WORDS];
#pragma unroll
  for (int i = 0; i < COPY_WORDS; ++i) {
    const long long u = u0 + i * COPY_THREADS;
    if (u < words) v[i] = src[u];
  }
#pragma unroll
  for (int i = 0; i < COPY_WORDS; ++i) {
    const long long u = u0 + i * COPY_THREADS;
    if (u < words) {
      dst[u] = v[i];
    } else if (u < units) {  // a head or tail byte
      const long long e = u - words;
      const long long off = e < head ? e : head + 16 * words + (e - head);
      out[off] = in[off];
    }
  }
}

struct HeadPtrs {
  const void* p[N_HEAD];
};

template <typename R>
struct PeekOut {
  R* time;
  int32_t *prio, *kind, *subj, *arg;
  bool* found;
  int32_t* handle;
};

template <typename R>
__device__ __forceinline__ bool finite(R x) {
  return x == x && x != R(INFINITY) && x != R(-INFINITY);
}

// one thread's, then its group's, lexmin of a table row: the row's
// minimum time as torch's amin gives it (NaN where the row has one), its
// least finite time t, and over the columns at t the (prio desc, seq
// asc) key, its lowest column (n where the row has none) and the int32
// wrapping sums of the NF fields over every column of that key
template <typename R, int NF>
struct Fold {
  R t_min, t;
  int32_t p, s, slot;
  uint32_t f[NF];
};

// a fold with no column yet: the reference's identities (+inf, int32
// min, int32 max)
template <typename R, int NF>
__device__ __forceinline__ Fold<R, NF> fold_empty(int n) {
  Fold<R, NF> a;
  a.t_min = a.t = R(INFINITY);
  a.p = I32_MIN;
  a.s = I32_MAX;
  a.slot = n;
  for (int k = 0; k < NF; ++k) a.f[k] = 0;
  return a;
}

// the times of columns g, g + G, ... of a row of n, then of the group
// (butterfly shuffles over its G threads, G a power of two; every thread
// of the warp takes part)
template <typename R, int NF>
__device__ __forceinline__ void fold_times(Fold<R, NF>& a, const R* time,
                                           int n, int g, int G) {
  for (int i = g; i < n; i += G) {
    const R t = time[i];
    a.t_min = (t < a.t_min || t != t) ? t : a.t_min;
    a.t = finite(t) && t < a.t ? t : a.t;
  }
  for (int m = G >> 1; m > 0; m >>= 1) {
    const R t_min = __shfl_xor_sync(0xFFFFFFFFu, a.t_min, m);
    const R t = __shfl_xor_sync(0xFFFFFFFFu, a.t, m);
    a.t_min = (t_min < a.t_min || t_min != t_min) ? t_min : a.t_min;
    a.t = t < a.t ? t : a.t;
  }
}

// where the row's minimum is finite (so a.t is it): the key of its
// columns at that time, the thread's and then the group's (every thread
// of the warp shuffles); prio, seq and the fields are read of those
// columns alone.  A better key resets the sums, an equal one adds to them
template <typename R, int NF>
__device__ __forceinline__ void fold_key(Fold<R, NF>& a, const R* time,
                                         const int32_t* prio,
                                         const int32_t* seq,
                                         const int32_t* const (&fld)[NF],
                                         int n, int g, int G) {
  const int cols = finite(a.t_min) ? n : 0;
  for (int i = g; i < cols; i += G) {
    if (time[i] != a.t) continue;
    const int32_t p = prio[i], s = seq[i];
    uint32_t f[NF];
    for (int k = 0; k < NF; ++k) f[k] = uint32_t(fld[k][i]);
    const bool better = p > a.p || (p == a.p && s < a.s);
    if (!better && (p != a.p || s != a.s)) continue;
    if (better) {
      a.p = p;
      a.s = s;
      a.slot = i;
      for (int k = 0; k < NF; ++k) a.f[k] = 0;
    }
    a.slot = a.slot < i ? a.slot : i;
    for (int k = 0; k < NF; ++k) a.f[k] += f[k];
  }
  for (int m = G >> 1; m > 0; m >>= 1) {
    const int32_t p = __shfl_xor_sync(0xFFFFFFFFu, a.p, m);
    const int32_t s = __shfl_xor_sync(0xFFFFFFFFu, a.s, m);
    const int32_t slot = __shfl_xor_sync(0xFFFFFFFFu, a.slot, m);
    uint32_t f[NF];
    for (int k = 0; k < NF; ++k)
      f[k] = __shfl_xor_sync(0xFFFFFFFFu, a.f[k], m);
    const bool better = p > a.p || (p == a.p && s < a.s);
    if (better) {
      a.p = p;
      a.s = s;
      a.slot = slot;
      for (int k = 0; k < NF; ++k) a.f[k] = f[k];
    } else if (p == a.p && s == a.s) {
      a.slot = slot < a.slot ? slot : a.slot;
      for (int k = 0; k < NF; ++k) a.f[k] += f[k];
    }
  }
}

// the row's pick as peek_merged reads it: found where the minimum time
// is finite; else the minimum time and the identities, no field
template <typename R, int NF>
__device__ __forceinline__ bool fold_found(Fold<R, NF>& a, int n) {
  const R t_min = a.t_min;
  const bool found = finite(t_min);
  if (!found) {
    a = fold_empty<R, NF>(n);
    a.t_min = a.t = t_min;
  }
  a.slot = a.slot < n - 1 ? a.slot : n - 1;
  return found;
}

// one element of a table's times into shared memory: an asynchronous
// copy on the card (cp.async: a warp's copies all in flight at once),
// a plain one elsewhere
template <typename R>
__device__ __forceinline__ void stage(R* dst, const R* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(int(sizeof(R)))
               : "memory");
#else
  *dst = *src;
#endif
}

// the thread's staged copies complete
__device__ __forceinline__ void staged() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// the peek's block, and the most columns (event and wake) a lane may have
// for its warp to stage both tables' times in shared memory
constexpr int PEEK_THREADS = 128;
constexpr int PEEK_STAGED_COLS = 48;

// a group of G threads a lane (lane = global thread / G; STAGED: G == 1,
// the rows staged and folded with a stride the compiler knows); every
// thread of the block runs to the end, so that the groups' shuffles see
// whole warps.  Under launch bounds of PEEK_THREADS alone ptxas gave the
// grouped f64 instance an 8 B frame; asking for 8 resident blocks (64
// registers) leaves every instance without one
template <typename R, bool STAGED>
__global__ void __launch_bounds__(PEEK_THREADS, 8)
peek_kernel(HeadPtrs h, int lanes, int E, int P, int wake_kind,
            int group, PeekOut<R> o) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int G = STAGED ? 1 : group;
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = gt / G, g = gt % G;
  const bool live = l < lanes;
  const int ne = live ? E : 0, nw = live ? P : 0;
  const size_t e0 = live ? size_t(l) * E : 0, w0 = live ? size_t(l) * P : 0;
  const R* et = static_cast<const R*>(h.p[EV_TIME]) + e0;
  const R* wt = static_cast<const R*>(h.p[WK_TIME]) + w0;
  if (STAGED) {
    const int lane = threadIdx.x & 31, l0 = gt - lane;
    const int rows = lanes - l0 < 32 ? lanes - l0 : 32;
    R* st = reinterpret_cast<R*>(dyn_smem) + (threadIdx.x >> 5) * 32 * (E + P);
    const R* te = static_cast<const R*>(h.p[EV_TIME]) + size_t(l0) * E;
    const R* tw = static_cast<const R*>(h.p[WK_TIME]) + size_t(l0) * P;
    for (int k = lane; k < rows * E; k += 32) stage(st + k, te + k);
    for (int k = lane; k < rows * P; k += 32) stage(st + 32 * E + k, tw + k);
    staged();
    __syncwarp();
    et = st + lane * E;
    wt = st + 32 * E + lane * P;
  }
  const int32_t* ep = static_cast<const int32_t*>(h.p[EV_PRIO]) + e0;
  const int32_t* es = static_cast<const int32_t*>(h.p[EV_SEQ]) + e0;
  const int32_t* const ef[4] = {
      static_cast<const int32_t*>(h.p[EV_KIND]) + e0,
      static_cast<const int32_t*>(h.p[EV_SUBJ]) + e0,
      static_cast<const int32_t*>(h.p[EV_ARG]) + e0,
      static_cast<const int32_t*>(h.p[EV_GEN]) + e0};
  const int32_t* wq = static_cast<const int32_t*>(h.p[WK_SEQ]) + w0;
  const int32_t* pp = static_cast<const int32_t*>(h.p[PRIO]) + w0;
  const int32_t* const wf[1] = {static_cast<const int32_t*>(h.p[WK_SIG]) +
                                w0};

  // general table: each field as the sum over the hits, as peek_merged's
  // one-hot pick reads it; dense wakes, prio read live from procs.prio
  Fold<R, 4> me = fold_empty<R, 4>(E);
  Fold<R, 1> mw = fold_empty<R, 1>(P);
  fold_times(me, et, ne, g, G);
  fold_times(mw, wt, nw, g, G);
  fold_key(me, et, ep, es, ef, ne, g, G);
  fold_key(mw, wt, pp, wq, wf, nw, g, G);
  if (!live || g != 0) return;
  const bool found_e = fold_found(me, E);
  const bool found_w = fold_found(mw, P);
  const bool wake_first =
      found_w &&
      (!found_e || mw.t < me.t ||
       (mw.t == me.t && (mw.p > me.p || (mw.p == me.p && mw.s < me.s))));
  const bool found = found_e || found_w;
  o.time[l] = wake_first ? mw.t : me.t;
  o.prio[l] = wake_first ? mw.p : me.p;
  o.kind[l] = wake_first ? int32_t(wake_kind) : int32_t(me.f[0]);
  o.subj[l] = wake_first ? int32_t(mw.slot) : int32_t(me.f[1]);
  o.arg[l] = wake_first ? int32_t(mw.f[0]) : int32_t(me.f[2]);
  o.found[l] = found;
  o.handle[l] = (found && !wake_first)
                    ? int32_t((me.f[3] << GEN_SHIFT) | uint32_t(me.slot))
                    : int32_t(-1);
}

template <typename R>
int peek(void* const* leaves, int n_leaves, int lanes, int event_cap,
         int n_procs, int wake_kind, void* const* out, void* stream) {
  if (n_leaves < N_HEAD) return -1;
  if (lanes <= 0 || event_cap <= 0 || n_procs <= 0) return -2;
  HeadPtrs h;
  for (int i = 0; i < N_HEAD; ++i) h.p[i] = leaves[i];
  PeekOut<R> o{static_cast<R*>(out[0]),       static_cast<int32_t*>(out[1]),
               static_cast<int32_t*>(out[2]), static_cast<int32_t*>(out[3]),
               static_cast<int32_t*>(out[4]), static_cast<bool*>(out[5]),
               static_cast<int32_t*>(out[6])};
  // one thread a lane, its warp's rows staged, where they fit; else a
  // group of the lane's longer row, rounded up to a power of two, at most
  // a warp
  int G = 1;
  size_t smem = 0;
  if (event_cap + n_procs <= PEEK_STAGED_COLS) {
    smem = size_t(PEEK_THREADS) * (event_cap + n_procs) * sizeof(R);
  } else {
    const int row = event_cap > n_procs ? event_cap : n_procs;
    while (G < row && G < 32) G *= 2;
  }
  const long long threads = (long long)lanes * G;
  const int blocks = int((threads + PEEK_THREADS - 1) / PEEK_THREADS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G == 1)
    peek_kernel<R, true><<<blocks, PEEK_THREADS, smem, st>>>(
        h, lanes, event_cap, n_procs, wake_kind, G, o);
  else
    peek_kernel<R, false><<<blocks, PEEK_THREADS, 0, st>>>(
        h, lanes, event_cap, n_procs, wake_kind, G, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bisect
}  // namespace cimba

// Plain C interface (loaded with ctypes).  Both launch on ``stream``
// without synchronising and return cudaGetLastError() after the launch
// (0 = ok), or -1 / -2 for a bad leaf count / an empty launch.
//
// cimba_sim_copy: ins/outs the leaves' device pointers, row the elements
// a lane of each leaf, size its element bytes (1, 4 or 8).  A leaf whose
// in and out pointers differ in their offset from 16 bytes is copied
// bytewise.
extern "C" int cimba_sim_copy(void* const* ins, void* const* outs,
                              const int* row, const int* size, int n_leaves,
                              int lanes, void* stream) {
  using namespace cimba::bisect;
  if (n_leaves <= 0 || n_leaves > MAX_LEAVES) return -1;
  if (lanes <= 0) return -2;
  CopyArgs a{};
  a.n = n_leaves;
  long long blocks = 0;
  for (int k = 0; k < n_leaves; ++k) {
    if (size[k] != 1 && size[k] != 4 && size[k] != 8) return -1;
    const long long bytes = (long long)lanes * row[k] * size[k];
    const uintptr_t pi = reinterpret_cast<uintptr_t>(ins[k]);
    const uintptr_t po = reinterpret_cast<uintptr_t>(outs[k]);
    long long head = 0, words = 0;
    if (pi % 16 == po % 16) {
      head = (16 - (long long)(pi % 16)) % 16;
      head = head < bytes ? head : bytes;
      words = (bytes - head) / 16;
    }
    a.in[k] = static_cast<const unsigned char*>(ins[k]);
    a.out[k] = static_cast<unsigned char*>(outs[k]);
    a.words[k] = words;
    a.bytes[k] = bytes;
    a.head[k] = static_cast<unsigned char>(head);
    a.first_block[k] = static_cast<int>(blocks);
    blocks += (words + (bytes - 16 * words) + COPY_UNITS - 1) / COPY_UNITS;
    if (blocks > INT32_MAX) return -2;
  }
  a.first_block[n_leaves] = static_cast<int>(blocks);
  if (blocks == 0) return 0;
  copy_kernel<<<static_cast<int>(blocks), COPY_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// cimba_peek_<f32|f64>: leaves the Sim's device pointers (at least its
// head leaves, kernel_run._HEAD order); out the Event's seven [L] device
// outputs (time, prio, kind, subj, arg, found, handle).
extern "C" int cimba_peek_f32(void* const* leaves, int n_leaves, int lanes,
                              int event_cap, int n_procs, int wake_kind,
                              void* const* out, void* stream) {
  return cimba::bisect::peek<float>(leaves, n_leaves, lanes, event_cap,
                                    n_procs, wake_kind, out, stream);
}

extern "C" int cimba_peek_f64(void* const* leaves, int n_leaves, int lanes,
                              int event_cap, int n_procs, int wake_kind,
                              void* const* out, void* stream) {
  return cimba::bisect::peek<double>(leaves, n_leaves, lanes, event_cap,
                                     n_procs, wake_kind, out, stream);
}
