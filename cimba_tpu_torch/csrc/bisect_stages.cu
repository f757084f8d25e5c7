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
// thread loaded before any is stored.  The peek is one thread per lane,
// which loops over its lane's table rows (AWACS's 1001 wake rows
// included): the lane-first rows are uncoalesced across a warp, and at
// ~0.01 ms a call on a tool's path that is left as it is.

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
__device__ bool finite(R x) {
  return x == x && x != R(INFINITY) && x != R(-INFINITY);
}

// the lexmin of one table row: (found, t_min, p_max, s_min) with the
// fold identities of an empty row (+inf, int32 min, int32 max)
template <typename R>
struct Min {
  bool found;
  R t;
  int32_t p, s;
};

template <typename R>
__device__ Min<R> lexmin(const R* time, const int32_t* prio,
                         const int32_t* seq, int n) {
  Min<R> m{false, R(INFINITY), I32_MIN, I32_MAX};
  for (int i = 0; i < n; ++i) m.t = time[i] < m.t ? time[i] : m.t;
  m.found = finite(m.t);
  if (!m.found) return m;
  for (int i = 0; i < n; ++i)
    if (time[i] == m.t && prio[i] > m.p) m.p = prio[i];
  for (int i = 0; i < n; ++i)
    if (time[i] == m.t && prio[i] == m.p && seq[i] < m.s) m.s = seq[i];
  return m;
}

template <typename R>
__device__ bool hit(const Min<R>& m, R t, int32_t p, int32_t s) {
  return m.found && t == m.t && p == m.p && s == m.s;
}

template <typename R>
__global__ void __launch_bounds__(128)
peek_kernel(HeadPtrs h, int lanes, int E, int P, int wake_kind,
            PeekOut<R> o) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const size_t e0 = size_t(l) * E, w0 = size_t(l) * P;
  const R* et = static_cast<const R*>(h.p[EV_TIME]) + e0;
  const int32_t* ep = static_cast<const int32_t*>(h.p[EV_PRIO]) + e0;
  const int32_t* es = static_cast<const int32_t*>(h.p[EV_SEQ]) + e0;
  const int32_t* ek = static_cast<const int32_t*>(h.p[EV_KIND]) + e0;
  const int32_t* eu = static_cast<const int32_t*>(h.p[EV_SUBJ]) + e0;
  const int32_t* ea = static_cast<const int32_t*>(h.p[EV_ARG]) + e0;
  const int32_t* eg = static_cast<const int32_t*>(h.p[EV_GEN]) + e0;
  const R* wt = static_cast<const R*>(h.p[WK_TIME]) + w0;
  const int32_t* wg = static_cast<const int32_t*>(h.p[WK_SIG]) + w0;
  const int32_t* wq = static_cast<const int32_t*>(h.p[WK_SEQ]) + w0;
  const int32_t* pp = static_cast<const int32_t*>(h.p[PRIO]) + w0;

  // general table: the first hit's slot (E - 1 when none), and each
  // field as the sum over the hits, as peek_merged's one-hot pick reads
  // it (int32, wrapping)
  const Min<R> me = lexmin(et, ep, es, E);
  int slot_e = E;
  uint32_t kind_e = 0, subj_e = 0, arg_e = 0, gen_e = 0;
  for (int i = 0; i < E; ++i)
    if (hit(me, et[i], ep[i], es[i])) {
      slot_e = slot_e < i ? slot_e : i;
      kind_e += uint32_t(ek[i]);
      subj_e += uint32_t(eu[i]);
      arg_e += uint32_t(ea[i]);
      gen_e += uint32_t(eg[i]);
    }
  slot_e = slot_e < E - 1 ? slot_e : E - 1;
  // dense wakes, prio read live from procs.prio
  const Min<R> mw = lexmin(wt, pp, wq, P);
  int pid_w = P;
  uint32_t sig_w = 0;
  for (int q = 0; q < P; ++q)
    if (hit(mw, wt[q], pp[q], wq[q])) {
      pid_w = pid_w < q ? pid_w : q;
      sig_w += uint32_t(wg[q]);
    }
  pid_w = pid_w < P - 1 ? pid_w : P - 1;
  const bool wake_first =
      mw.found &&
      (!me.found || mw.t < me.t ||
       (mw.t == me.t && (mw.p > me.p || (mw.p == me.p && mw.s < me.s))));
  const bool found = me.found || mw.found;
  o.time[l] = wake_first ? mw.t : me.t;
  o.prio[l] = wake_first ? mw.p : me.p;
  o.kind[l] = wake_first ? int32_t(wake_kind) : int32_t(kind_e);
  o.subj[l] = wake_first ? int32_t(pid_w) : int32_t(subj_e);
  o.arg[l] = wake_first ? int32_t(sig_w) : int32_t(arg_e);
  o.found[l] = found;
  o.handle[l] = (found && !wake_first)
                    ? int32_t((gen_e << GEN_SHIFT) | uint32_t(slot_e))
                    : int32_t(-1);
}

constexpr int kThreads = 128;

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
  const int blocks = (lanes + kThreads - 1) / kThreads;
  peek_kernel<R><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      h, lanes, event_cap, n_procs, wake_kind, o);
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
