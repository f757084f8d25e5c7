// The AWACS kernels for Hopper (sm_90a): the event-loop chunk (K1's AWACS
// instance) and the boundary round's dwell (K5's MLP fused into one
// engine step).
//
// The chunk replaces, for the AWACS spec, the Pallas chunk mega-kernel of
// the JAX package (cimba_tpu/core/pallas_run.py: make_kernel_run ->
// build_chunk_call, body _kernel_body), which advances every live lane by
// up to chunk_steps engine steps and defers boundary-block dispatches to
// its host loop.  The dwell replaces that host loop's boundary step
// (_boundary_apply: one ordinary engine step on the frozen lanes), whose
// detection MLP is the Pallas kernel of cimba_tpu/models/awacs.py
// (nn_scores -> _nn_kernel): here the step, the features and the MLP are
// one launch.  The single-queue instances of K1 are csrc/queue_chunk.cu;
// the standalone MLP is csrc/nn_scores.cu, whose row arithmetic
// (csrc/nn_row.cuh) the dwell shares.
//
// What a lane computes.  The chunk: exactly what
// cimba_tpu_torch.core.loop.make_run(spec, max_steps=chunk_steps,
// defer_boundary=True) computes for the spec of
// cimba_tpu_torch.models.awacs.build(n): the (time, prio desc, seq) pick
// over the dense wake table of n + 1 processes (the lowest pid winning
// ties) and the general event table (the lowest slot winning ties); an
// event whose subject sits at the sensor's pc (the boundary block
// sensor_dwell) is left in its table and freezes the lane with
// boundary_pending set; otherwise the clock advances, n_events counts it,
// and the subject resumes: block tgt_leg (the five column reads at the
// pid, the uniform heading, the soft bounce with cos/sin/sqrt, the five
// writes, the exponential leg), then hold or exit with finish_process's
// timer cancel.  The heading and the leg are drawn on every dispatch, one
// counter tick each.  A chained entry into the sensor's block fails the
// lane with ERR_BOUNDARY.  The dwell: for each lane with boundary_pending
// set, exactly one loop.make_step(spec) (defer off), then the flag
// cleared; the sensor's block extrapolates every target, draws the scan
// noise (one tick), scores each target (the MLP, or the linear falloff of
// scoring "threshold"), counts p_det > noise, adds the count to the
// detections summary (stats.summary.add), counts the dwell, stops the
// lane at t_end and holds for the next dwell or exits.  Lanes not pending
// are not touched.  The order of every state write follows the plain
// engine, because wake seqs are assigned in that order and decide ties.
//
// Design.  A lane is a group of LT threads (half a warp in the chunk, a
// warp in the dwell), which run the lane's scalar step in lockstep: every thread holds the same lane scalars (clock, counter,
// next_seq, flags, counts) and the same copy of the dispatched pid's
// fields, loaded by all (one broadcast transaction each), and only the
// group's first thread stores.  Nothing is broadcast by shuffles and the
// group never diverges on the step's branches.  The per-pid columns
// (~100 KB a lane in f32 at 1000 targets) stay in device memory.
//
// The chunk's pick is a two-level minimum (the reference's BlockMin,
// cimba_tpu/core/eventset.py:303-405, applied to the wake table).  Thread
// t owns the contiguous block of pids [t S, (t + 1) S), S = ceil(P / LT),
// and keeps that block's best (time, prio, seq, pid) in registers across
// events; the lane's pick is the shuffle minimum of the LT block bests.
// An event changes the wake row of the dispatched pid only, so only its
// block's best can change: as soon as the pick is known, the group loads
// that block's rows (S contiguous rows, coalesced: NPRE rows a thread,
// 4 at 1000 targets) beside the dispatched pid's fields, before the step
// writes anything; after the step the dispatched pid's row is taken from
// registers, the block's minimum is reduced by shuffles and its owner
// keeps it.  Per event that is one round of independent loads and two
// shuffle reductions, where a rescan of all P rows would take ~32
// dependent load rounds a thread at 1000 targets.  The general event table's minimum is cached in
// registers for the chunk and rescanned only when the kernel writes the
// table (a pop, or finish's timer cancel).  An event taken from the
// general table (AWACS schedules none) rescans every block.  This is
// exact only while, within a chunk, (1) only the dispatched pid's
// wakes.time / wakes.seq change in an event, (2) procs.prio never
// changes and (3) the general table is written by the kernel's own pops
// and cancels only: tests/test_torch_awacs_invariants.py checks them on
// the plain engine.  tgt_leg computes its two Threefry blocks side by
// side (they depend only on the counter), and cos, sin, sqrt and log1p
// are independent of each other: the step is one chain of ~3 load and
// compute rounds, not ~10.
//
// The dwell: one warp a lane, the lane's pick a strided scan and a
// shuffle minimum, the step as in the chunk, and the sensor block spread
// over the warp: thread t extrapolates and scores targets t, t + 32, ...
// (coalesced column loads; the MLP's 1378 weights in shared memory, the
// row csrc/nn_row.cuh), and the count, an exact integer, is a warp sum.
//
// What bounds them on this card.  The chunk, by the count of work, bytes
// — the lane state it must read and write (PERF.md, K1's AWACS bound);
// in practice the latency of each event's chain (a load round, two
// shuffle reductions, two Threefry blocks and the transcendental
// functions), since every lane's events are serial.  The dwell,
// operations: ~2,760 f32 operations a target for the MLP against 20-40
// bytes of columns.  Registers: the chunk's launch bounds cap a thread at
// 65536 / (128 x LT / 4) registers, the most under which every lane of a
// 4096-lane run is resident at once (chip_smoke.py fails on a stack frame
// or a spill in either kernel).
//
// Built with --fmad=false so float results follow the plain PyTorch
// engine's separately rounded multiplies and adds.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "horizon.cuh"
#include "nn_row.cuh"
#include "summary.cuh"
#include "threefry.cuh"
#include "trig.cuh"

namespace cimba {
namespace awacs {

constexpr int MAX_CHAIN = 1024;
constexpr int kThreads = 128;
// the chunk's threads a lane (16: 8 and 32 measured, PERF.md), and the
// blocks an SM must hold for every lane of a 4096-lane run to be
// resident (4096 x LT / 128 blocks on 132 SMs): the launch bound that
// sets the register cap (128 registers at 16 threads a lane)
constexpr int LT = 16;
static_assert(LT == 32 || LT == 16 || LT == 8, "a lane is 8, 16 or 32 threads");
constexpr int kChunkMinBlocks = LT / 4;
// rows of the dispatched pid's block that each thread loads before the
// step: all of them while P <= 1024
constexpr int NPRE = (1024 + LT * LT - 1) / (LT * LT);

// command tags, statuses, signals, kinds, error codes: the reference's
constexpr int C_HOLD = 0, C_EXIT = 1, C_JUMP = 2, N_COMMANDS = 28;
constexpr int NO_PEND = -1, SUCCESS = 0, RUNNING = 1, FINISHED = 2;
constexpr int K_PROC = 0, K_TIMER = 1;
constexpr int ERR_EVENT_OVERFLOW = 1, ERR_CHAIN_RUNAWAY = 3, ERR_USER = 4,
              ERR_BOUNDARY = 6;
constexpr int32_t I32_MIN = INT32_MIN, I32_MAX = INT32_MAX;

// block pcs in registration order (awacs.BLOCK_NAMES)
constexpr int TGT_LEG = 0, SENSOR_DWELL = 1, N_BLOCKS = 2;

// the model's constants (cimba_tpu_torch/models/awacs.py)
constexpr double ARENA = 100.0, SPEED = 5.0, LEG_MEAN = 4.0;
constexpr double DETECT_RANGE = 40.0;
constexpr double DWELL = 0.04 * 25;
constexpr double TWO_PI = 6.283185307179586;  // 2.0 * math.pi

// Sim leaves in the reference's jax.tree.leaves order (the user dict's
// keys sorted; the detections summary's fields in order)
enum Leaf {
  CLOCK, REP, KEY0, KEY1, CTR_LO, CTR_HI,
  EV_TIME, EV_PRIO, EV_SEQ, EV_KIND, EV_SUBJ, EV_ARG, EV_GEN, EV_NEXT_SEQ,
  EV_OVERFLOW,
  WK_TIME, WK_SIG, WK_SEQ,
  PC, STATUS, PRIO, PEND_TAG, PEND_F, PEND_F2, PEND_F3, PEND_I, PEND_PC,
  PEND_GUARD, PEND_SEQ, AWAIT_PID, AWAIT_EVT, EXIT_SIG, GOT, LOCALS_F,
  LOCALS_I,
  GUARD_NEXT_SEQ,
  D_N, D_W, D_MN, D_MX, D_M1, D_M2, D_M3, D_M4,
  U_DWELLS, U_POS_X, U_POS_Y, U_T_END, U_T_MARK, U_VEL_X, U_VEL_Y,
  DONE, ERR, N_EVENTS, BOUNDARY_PENDING,
  N_LEAVES,
  T_STOP = N_LEAVES  // the per-lane horizon, where the Sim carries one
};

struct Ptrs {
  void* p[N_LEAVES + 1];
};

template <typename R>
struct Cmd {
  int32_t tag;
  R f, f2, f3;
  int32_t i;
  int32_t next_pc;
};

template <typename R>
__device__ __forceinline__ R inf_of() {
  return R(INFINITY);
}

// jnp.isfinite
template <typename R>
__device__ __forceinline__ bool finite(R x) {
  return x == x && x != inf_of<R>() && x != -inf_of<R>();
}

__device__ __forceinline__ float log1p_of(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_of(double x) { return log1p(x); }
__device__ __forceinline__ float sqrt_of(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_of(double x) { return sqrt(x); }

// uniform01: f32 takes 24 bits of the high word, f64 the high word
__device__ __forceinline__ float u01_of(uint32_t, uint32_t b1, float) {
  return float(int32_t(b1 >> 8)) * 0x1p-24f;
}
__device__ __forceinline__ double u01_of(uint32_t, uint32_t b1, double) {
  return double(b1) * 0x1p-32;
}
// uniform01_53: f32 as uniform01, f64 a 53-bit significand
__device__ __forceinline__ float u53_of(uint32_t b0, uint32_t b1, float z) {
  return u01_of(b0, b1, z);
}
__device__ __forceinline__ double u53_of(uint32_t b0, uint32_t b1, double) {
  return double(b1) * 0x1p-32 + double(b0 >> 11) * 0x1p-53;
}

// jnp.maximum(x, 0): NaN propagates
template <typename R>
__device__ __forceinline__ R nanmax0(R x) {
  return (x != x || x > R(0)) ? x : R(0);
}

// an event's ordering key: (time asc, prio desc, seq asc, index asc),
// the index a pid or a general-table slot
template <typename R>
struct Key {
  R t;
  int32_t p, s, i;
};

template <typename R>
__device__ __forceinline__ bool before(const Key<R>& a, const Key<R>& b) {
  if (a.t != b.t) return a.t < b.t;
  if (a.p != b.p) return a.p > b.p;
  if (a.s != b.s) return a.s < b.s;
  return a.i < b.i;
}

// the fold identity of an empty row (the reference's _lexmin)
template <typename R>
__device__ __forceinline__ Key<R> no_key() {
  return Key<R>{inf_of<R>(), I32_MIN, I32_MAX, I32_MAX};
}

// the threads of the calling thread's lane group of G
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    const unsigned t = threadIdx.x % 32u;
    return ((1u << G) - 1u) << (t / G * G);
  }
}

// the least key of the group (every thread ends with it)
template <int G, typename R>
__device__ __forceinline__ Key<R> group_min(Key<R> k, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2) {
    const Key<R> o{__shfl_xor_sync(mask, k.t, off, G),
                   __shfl_xor_sync(mask, k.p, off, G),
                   __shfl_xor_sync(mask, k.s, off, G),
                   __shfl_xor_sync(mask, k.i, off, G)};
    if (before(o, k)) k = o;
  }
  return k;
}

// the compiler cannot see through this copy of the lane index, so it
// recomputes each row address where it is used instead of keeping them
// all live across the event loop
__device__ __forceinline__ int opaque(int x) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+r"(x));
#endif
  return x;
}

// one lane's rows of the Sim's leaves: E event slots, P processes, P - 1
// target columns
struct Where {
  const Ptrs& ps;
  int l, E, P;

  template <typename T>
  __device__ __forceinline__ T* at(Leaf k) const {
    return static_cast<T*>(ps.p[k]) + l;
  }
  template <typename T>
  __device__ __forceinline__ T* rowE(Leaf k) const {
    return static_cast<T*>(ps.p[k]) + size_t(l) * E;
  }
  template <typename T>
  __device__ __forceinline__ T* rowP(Leaf k) const {
    return static_cast<T*>(ps.p[k]) + size_t(l) * P;
  }
  template <typename T>
  __device__ __forceinline__ T* rowX(Leaf k) const {
    return static_cast<T*>(ps.p[k]) + size_t(l) * (P - 1);
  }
};

// the least wake key over pids first, first + stride, ... < end (loads in
// batches of eight; prio and seq read only where a time ties or beats the
// best so far)
template <typename R>
__device__ __forceinline__ Key<R> scan_wakes(const Where& w, int first,
                                             int stride, int end) {
  const R* wt = w.rowP<R>(WK_TIME);
  const int32_t* prio = w.rowP<int32_t>(PRIO);
  const int32_t* wseq = w.rowP<int32_t>(WK_SEQ);
  Key<R> best = no_key<R>();
  for (int q0 = first; q0 < end; q0 += 8 * stride) {
    R tv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = q0 + j * stride;
      tv[j] = q < end ? wt[q] : inf_of<R>();
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = q0 + j * stride;
      if (q < end && tv[j] <= best.t) {
        const Key<R> c{tv[j], prio[q], wseq[q], q};
        if (before(c, best)) best = c;
      }
    }
  }
  return best;
}

// the dispatched pid's fields, as the group holds them in registers:
// loaded all at once when the pick is known, then kept equal to what the
// step stores
template <typename R>
struct Row {
  int32_t sig, pc, status, pend_tag;
  R t_mark, pos_x, pos_y, vel_x, vel_y;  // its target columns
};

template <typename R>
__device__ __forceinline__ Row<R> load_row(const Where& w, int q) {
  const int idx = q < w.P - 2 ? q : w.P - 2;  // targets are pids 0..P-2
  return Row<R>{w.rowP<int32_t>(WK_SIG)[q],  w.rowP<int32_t>(PC)[q],
                w.rowP<int32_t>(STATUS)[q],  w.rowP<int32_t>(PEND_TAG)[q],
                w.rowX<R>(U_T_MARK)[idx],    w.rowX<R>(U_POS_X)[idx],
                w.rowX<R>(U_POS_Y)[idx],     w.rowX<R>(U_VEL_X)[idx],
                w.rowX<R>(U_VEL_Y)[idx]};
}

// One lane as its group of G threads holds it.  ROUND: the boundary
// round's step (defer off, the sensor's block run by the group);
// otherwise the chunk's (defer on).  Every method is inlined, so the
// struct lives in registers.
template <typename R, typename C, int G, bool ROUND>
struct Lane {
  bool lead;      // the group's first thread: the one that stores
  unsigned mask;  // the group's threads
  int tid;        // the thread's index in the group
  R clock;
  uint32_t k0, k1, lo, hi;
  int32_t next_seq;
  R t_end;
  bool done, pending;
  int32_t err;
  C n_events;
  Key<R> e;   // the general table's minimum (i: its slot)
  bool fast;  // this event came from the wakes: only its pid's row changed
  R xt;       // the dispatched pid's wake time and seq after the event
  int32_t xs;
  const float* wsh;  // ROUND: the MLP's weights in shared memory
  bool nn;           // ROUND: scoring "nn" (else "threshold")

  __device__ __forceinline__ void load(const Where& w) {
    clock = *w.at<R>(CLOCK);
    k0 = uint32_t(*w.at<int64_t>(KEY0));
    k1 = uint32_t(*w.at<int64_t>(KEY1));
    lo = uint32_t(*w.at<int64_t>(CTR_LO));
    hi = uint32_t(*w.at<int64_t>(CTR_HI));
    next_seq = *w.at<int32_t>(EV_NEXT_SEQ);
    t_end = *w.at<R>(U_T_END);
    done = *w.at<bool>(DONE);
    pending = *w.at<bool>(BOUNDARY_PENDING);
    err = *w.at<int32_t>(ERR);
    n_events = *w.at<C>(N_EVENTS);
    scan_events(w);
  }

  __device__ __forceinline__ void store(const Where& w) const {
    if (!lead) return;
    *w.at<R>(CLOCK) = clock;
    *w.at<int64_t>(CTR_LO) = int64_t(lo);
    *w.at<int64_t>(CTR_HI) = int64_t(hi);
    *w.at<int32_t>(EV_NEXT_SEQ) = next_seq;
    *w.at<bool>(DONE) = done;
    *w.at<bool>(BOUNDARY_PENDING) = pending;
    *w.at<int32_t>(ERR) = err;
    *w.at<C>(N_EVENTS) = n_events;
  }

  // the general table's (time, prio desc, seq) minimum, lowest slot
  // winning ties; after the group's own stores to the table
  __device__ __forceinline__ void scan_events(const Where& w) {
    __syncwarp(mask);
    const R* et = w.rowE<R>(EV_TIME);
    const int32_t* ep = w.rowE<int32_t>(EV_PRIO);
    const int32_t* es = w.rowE<int32_t>(EV_SEQ);
    Key<R> b = no_key<R>();
    for (int i = 0; i < w.E; ++i) {
      const Key<R> c{et[i], ep[i], es[i], i};
      if (before(c, b)) b = c;
    }
    e = b;
  }

  __device__ __forceinline__ void set_err(int32_t code) {
    if (err == 0) err = code;
  }

  __device__ __forceinline__ void draw(uint32_t& b0, uint32_t& b1) {
    threefry2x32(k0, k1, lo, hi, b0, b1);
    lo += 1u;
    if (lo == 0u) hi += 1u;
  }

  __device__ __forceinline__ void schedule_wake(const Where& w, int p,
                                                int32_t sig, R t) {
    if (finite(t)) {
      if (lead) {
        w.rowP<R>(WK_TIME)[p] = t;
        w.rowP<int32_t>(WK_SIG)[p] = sig;
        w.rowP<int32_t>(WK_SEQ)[p] = next_seq;
      }
      xt = t;
      xs = next_seq;
      next_seq += 1;
    } else {
      set_err(ERR_EVENT_OVERFLOW);
    }
  }

  __device__ __forceinline__ void finish(const Where& w, int p) {
    if (lead) {
      w.rowP<int32_t>(PEND_TAG)[p] = NO_PEND;
      w.rowP<int32_t>(PEND_GUARD)[p] = -1;
      w.rowP<R>(WK_TIME)[p] = inf_of<R>();
    }
    xt = inf_of<R>();
    // cancel p's timers: only a finite slot can be one
    if (finite(e.t)) {
      __syncwarp(mask);
      R* et = w.rowE<R>(EV_TIME);
      const int32_t* ek = w.rowE<int32_t>(EV_KIND);
      const int32_t* esub = w.rowE<int32_t>(EV_SUBJ);
      int32_t* eg = w.rowE<int32_t>(EV_GEN);
      bool hit = false;
      for (int i = 0; i < w.E; ++i)
        if (finite(et[i]) && ek[i] == K_TIMER && esub[i] == p) {
          if (lead) {
            et[i] = inf_of<R>();
            eg[i] += 1;
          }
          hit = true;
        }
      if (hit) scan_events(w);
    }
    if (lead) {
      w.rowP<int32_t>(STATUS)[p] = FINISHED;
      w.rowP<int32_t>(EXIT_SIG)[p] = SUCCESS;
    }
  }

  // returns "yielded"; a spec without queues fails every other verb
  __device__ __forceinline__ bool apply(const Where& w, int p,
                                        const Cmd<R>& c, Row<R>& row) {
    const int tag = c.tag < 0 ? 0 : (c.tag > N_COMMANDS - 1 ? N_COMMANDS - 1
                                                            : c.tag);
    switch (tag) {
      case C_HOLD:
        schedule_wake(w, p, SUCCESS, clock + nanmax0(c.f));
        if (lead) w.rowP<int32_t>(PC)[p] = c.next_pc;
        row.pc = c.next_pc;
        return true;
      case C_EXIT:
        finish(w, p);
        row.status = FINISHED;
        return true;
      case C_JUMP:
        if (lead) w.rowP<int32_t>(PC)[p] = c.next_pc;
        row.pc = c.next_pc;
        return false;
      default:
        set_err(ERR_USER);
        return true;
    }
  }

  __device__ __forceinline__ Cmd<R> tgt_leg(const Where& w, int p,
                                            Row<R>& row) {
    const int idx = p < w.P - 2 ? p : w.P - 2;
    // the heading's Threefry block and the leg's: independent chains
    uint32_t a0, a1, b0, b1;
    draw(a0, a1);
    draw(b0, b1);
    const R dt = clock - row.t_mark;
    const R px = row.pos_x + row.vel_x * dt;
    const R py = row.pos_y + row.vel_y * dt;
    const R heading = R(0) + R(TWO_PI) * u01_of(a0, a1, R(0));
    const R r = sqrt_of(px * px + py * py);
    const bool outside = r > R(ARENA);
    const R r_min = R(1e-6);
    const R inv_r = R(1) / (r < r_min ? r_min : r);
    R cos_h, sin_h;
    sincos_of(heading, cos_h, sin_h);  // csrc/trig.cuh: heading in [0, 2 pi)
    const R vx = R(SPEED) * (outside ? -px * inv_r : cos_h);
    const R vy = R(SPEED) * (outside ? -py * inv_r : sin_h);
    if (lead) {
      w.rowX<R>(U_POS_X)[idx] = px;
      w.rowX<R>(U_POS_Y)[idx] = py;
      w.rowX<R>(U_VEL_X)[idx] = vx;
      w.rowX<R>(U_VEL_Y)[idx] = vy;
      w.rowX<R>(U_T_MARK)[idx] = clock;
    }
    row.pos_x = px;
    row.pos_y = py;
    row.vel_x = vx;
    row.vel_y = vy;
    row.t_mark = clock;
    const R leg = R(LEG_MEAN) * -log1p_of(-u53_of(b0, b1, R(0)));
    if (clock >= t_end) return Cmd<R>{C_EXIT, R(0), R(0), R(0), 0, 0};
    return Cmd<R>{C_HOLD, leg, R(0), R(0), 0, TGT_LEG};
  }

  // the sensor's block (the dwell only): every target extrapolated and
  // scored by the group, the count of p_det > noise summed
  __device__ __forceinline__ Cmd<R> sensor_dwell(const Where& w) {
    __syncwarp(mask);  // the group's stores to the columns come first
    uint32_t b0, b1;
    draw(b0, b1);
    const R noise = u01_of(b0, b1, R(0));
    const R* t_mark = w.rowX<R>(U_T_MARK);
    const R* pos_x = w.rowX<R>(U_POS_X);
    const R* pos_y = w.rowX<R>(U_POS_Y);
    const R* vel_x = w.rowX<R>(U_VEL_X);
    const R* vel_y = w.rowX<R>(U_VEL_Y);
    int count = 0;
#pragma unroll 1
    for (int i = tid; i < w.P - 1; i += G) {
      // the weights' address, opaque to the compiler: it would hoist
      // all 1378 shared-memory loads out of the loop (a 5 KB frame)
      const float* wl = wsh + opaque(0);
      const R dt = clock - t_mark[i];
      const R vx = vel_x[i], vy = vel_y[i];
      const R px = pos_x[i] + vx * dt;
      const R py = pos_y[i] + vy * dt;
      R p_det;
      if (nn) {
        float f[nn::F], g;
        nn::features(float(px), float(py), float(vx), float(vy), f, g);
        p_det = R(nn::row(wl, f, g));
      } else {
        // torch's CUDA division by a host scalar: times its reciprocal
        const R v = R(1.2) - sqrt_of(px * px + py * py) *
                                 (R(1) / R(DETECT_RANGE));
        p_det = v < R(0) ? R(0) : (v > R(1) ? R(1) : v);
      }
      count += p_det > noise ? 1 : 0;
    }
    count = __reduce_add_sync(mask, count);
    Sum<R> d{*w.at<R>(D_N),  *w.at<R>(D_W),  *w.at<R>(D_MN),
             *w.at<R>(D_MX), *w.at<R>(D_M1), *w.at<R>(D_M2),
             *w.at<R>(D_M3), *w.at<R>(D_M4)};
    d = add(d, R(count), R(1));
    if (lead) {
      *w.at<R>(D_N) = d.n;
      *w.at<R>(D_W) = d.w;
      *w.at<R>(D_MN) = d.mn;
      *w.at<R>(D_MX) = d.mx;
      *w.at<R>(D_M1) = d.m1;
      *w.at<R>(D_M2) = d.m2;
      *w.at<R>(D_M3) = d.m3;
      *w.at<R>(D_M4) = d.m4;
      *w.at<int32_t>(U_DWELLS) += 1;
    }
    const bool stop = clock >= t_end;
    done = done || stop;  // api.stop
    if (stop) return Cmd<R>{C_EXIT, R(0), R(0), R(0), 0, 0};
    return Cmd<R>{C_HOLD, R(DWELL), R(0), R(0), 0, SENSOR_DWELL};
  }

  __device__ __forceinline__ void resume(const Where& w, int p, int32_t sig, Row<R>& row) {
    if (lead) w.rowP<R>(WK_TIME)[p] = inf_of<R>();
    xt = inf_of<R>();
    const bool has_pend = row.pend_tag != NO_PEND;
    Cmd<R> pend{NO_PEND, R(0), R(0), R(0), 0, 0};
    if (has_pend)  // no AWACS block pends; read only where one did
      pend = Cmd<R>{row.pend_tag,
                    w.rowP<R>(PEND_F)[p],
                    w.rowP<R>(PEND_F2)[p],
                    w.rowP<R>(PEND_F3)[p],
                    w.rowP<int32_t>(PEND_I)[p],
                    w.rowP<int32_t>(PEND_PC)[p]};
    if (lead) {
      w.rowP<int32_t>(PEND_TAG)[p] = NO_PEND;
      w.rowP<int32_t>(PEND_GUARD)[p] = -1;
    }
    row.pend_tag = NO_PEND;
    bool use_pend = has_pend && sig == SUCCESS;
    bool yielded = false;
    int n = 0;
    while (!yielded && row.status == RUNNING && err == 0 && n < MAX_CHAIN) {
      // one apply for the retried command and a block's (two inlined
      // copies would select between their addresses: a stack frame)
      Cmd<R> c = pend;
      if (!use_pend) {
        const int b = row.pc < 0 ? 0 : (row.pc > N_BLOCKS - 1 ? N_BLOCKS - 1
                                                              : row.pc);
        if (b == TGT_LEG) {
          c = tgt_leg(w, p, row);
        } else if constexpr (ROUND) {
          c = sensor_dwell(w);
        } else {
          // boundary blocks are entered by dispatch only (their stub
          // exits)
          if (row.pc == SENSOR_DWELL) set_err(ERR_BOUNDARY);
          c = Cmd<R>{C_EXIT, R(0), R(0), R(0), 0, 0};
        }
      }
      yielded = apply(w, p, c, row);
      use_pend = false;
      ++n;
    }
    if (n >= MAX_CHAIN) set_err(ERR_CHAIN_RUNAWAY);
  }

  // One engine step given the wake table's pick k and the fields of its
  // pid (row); returns whether the lane stepped.  The chunk steps a live
  // lane only (make_cond with defer_boundary and the horizon) and freezes
  // one whose next dispatch is the sensor (pending); the dwell steps any
  // lane that has an event (make_step).
  __device__ __forceinline__ bool step(const Where& w, const Key<R>& k, Row<R> row,
                       int horizon, R t_hor) {
    const bool found_w = finite(k.t);
    const bool found_e = finite(e.t);
    bool live;
    if constexpr (ROUND) {
      live = found_e || found_w;
      done = done || !live;
    } else {
      const R nxt = k.t < e.t ? k.t : e.t;
      live = !done && err == 0 && !pending && (found_e || found_w);
      live = live && within_horizon(nxt, horizon, t_hor, w.ps.p[T_STOP],
                                    w.l);
    }
    if (!live) return false;
    const bool wake_first =
        found_w &&
        (!found_e || k.t < e.t ||
         (k.t == e.t && (k.p > e.p || (k.p == e.p && k.s < e.s))));
    fast = wake_first;
    int32_t subj, kind, arg;
    if (wake_first) {
      subj = k.i;
      kind = K_PROC;
      arg = row.sig;
    } else {
      __syncwarp(mask);
      subj = w.rowE<int32_t>(EV_SUBJ)[e.i];
      kind = w.rowE<int32_t>(EV_KIND)[e.i];
      arg = w.rowE<int32_t>(EV_ARG)[e.i];
      row = load_row<R>(w, subj < 0 ? 0 : (subj > w.P - 1 ? w.P - 1 : subj));
    }
    if constexpr (!ROUND) {
      // the boundary defer: peek, do not consume
      if (kind <= K_TIMER && row.pc == SENSOR_DWELL) {
        pending = true;
        return true;
      }
    }
    if (wake_first) {
      clock = k.t;
      if (lead) w.rowP<R>(WK_TIME)[k.i] = inf_of<R>();
      xt = inf_of<R>();
      xs = k.s;
    } else {
      clock = e.t;
      if (lead) {
        w.rowE<R>(EV_TIME)[e.i] = inf_of<R>();
        w.rowE<int32_t>(EV_GEN)[e.i] += 1;
      }
      scan_events(w);
    }
    n_events += 1;
    // K_PROC and K_TIMER both resume; the model has no user handlers
    if (subj >= 0 && subj < w.P && row.status == RUNNING)
      resume(w, subj, arg, row);
    return true;
  }
};

template <typename R, typename C>
__device__ __forceinline__ void chunk_lane(const Ptrs& ps, int l, int E, int P,
                           int chunk_steps, int horizon, R t_hor) {
  Lane<R, C, LT, false> s;
  s.tid = threadIdx.x % LT;
  s.lead = s.tid == 0;
  s.mask = group_mask<LT>();
  s.load(Where{ps, l, E, P});
  // thread tid owns the block of pids [tid S, (tid + 1) S)
  const int S = (P + LT - 1) / LT;
  const int own = s.tid * S;
  const int own_end = own + S < P ? own + S : P;
  Key<R> best = scan_wakes<R>(Where{ps, l, E, P}, own, 1, own_end);
  Key<R> k = group_min<LT>(best, s.mask);
  for (int n = 0; n < chunk_steps; ++n) {
    const Where w{ps, opaque(l), E, P};
    const int q = k.i < 0 ? 0 : (k.i > P - 1 ? P - 1 : k.i);
    const Row<R> row = load_row<R>(w, q);
    // the rows of q's block as they stand before the step (only q's own
    // row can change in it)
    const int b = q / S * S;
    const int b_end = b + S < P ? b + S : P;
    Key<R> cand[NPRE];
#pragma unroll
    for (int j = 0; j < NPRE; ++j) {
      const int qq = b + s.tid + j * LT;
      cand[j] = qq < b_end ? Key<R>{w.rowP<R>(WK_TIME)[qq],
                                    w.rowP<int32_t>(PRIO)[qq],
                                    w.rowP<int32_t>(WK_SEQ)[qq], qq}
                           : no_key<R>();
    }
    if (!s.step(w, k, row, horizon, t_hor) || s.pending) break;
    if (s.fast) {
      Key<R> c = no_key<R>();
#pragma unroll
      for (int j = 0; j < NPRE; ++j) {
        Key<R> x = cand[j];
        if (x.i == q) {
          x.t = s.xt;
          x.s = s.xs;
        }
        if (before(x, c)) c = x;
      }
      if (b_end - b > NPRE * LT) {  // P > 1024: the block's other rows
        __syncwarp(s.mask);
        const Key<R> rest = scan_wakes<R>(w, b + s.tid + NPRE * LT, LT,
                                          b_end);
        if (before(rest, c)) c = rest;
      }
      c = group_min<LT>(c, s.mask);
      if (s.tid == q / S) best = c;
    } else {
      // an event of the general table: every block again
      __syncwarp(s.mask);
      best = scan_wakes<R>(w, own, 1, own_end);
    }
    __syncwarp(s.mask);
    k = group_min<LT>(best, s.mask);
  }
  s.store(Where{ps, l, E, P});
}

template <typename R, typename C>
__global__ void __launch_bounds__(kThreads, kChunkMinBlocks)
chunk_kernel(const __grid_constant__ Ptrs ps, int lanes, int E, int P,
             int chunk_steps, int horizon, R t_hor) {
  const int l = (blockIdx.x * blockDim.x + threadIdx.x) / LT;
  if (l < lanes) chunk_lane<R, C>(ps, l, E, P, chunk_steps, horizon, t_hor);
}

// the boundary round: one warp a lane
template <typename R, typename C>
__global__ void __launch_bounds__(kThreads, 1)
dwell_kernel(const __grid_constant__ Ptrs ps, int lanes, int E, int P,
             const float* __restrict__ weights, bool nn) {
  __shared__ __align__(16) float wsh[nn::N_WEIGHTS];
  if (nn)
    for (int i = threadIdx.x; i < nn::N_WEIGHTS; i += blockDim.x)
      wsh[i] = weights[i];
  __syncthreads();
  constexpr int G = 32;
  const int l = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (l >= lanes) return;
  const Where w{ps, l, E, P};
  if (!*w.at<bool>(BOUNDARY_PENDING)) return;
  Lane<R, C, G, true> s;
  s.tid = threadIdx.x % G;
  s.lead = s.tid == 0;
  s.mask = group_mask<G>();
  s.wsh = wsh;
  s.nn = nn;
  s.load(w);
  const Key<R> k = group_min<G>(scan_wakes<R>(w, s.tid, G, P), s.mask);
  const int q = k.i < 0 ? 0 : (k.i > P - 1 ? P - 1 : k.i);
  s.step(w, k, load_row<R>(w, q), H_NONE, R(0));
  s.pending = false;
  s.store(w);
}

// csrc/trig.cuh's cos and sin on an array, for holding them against
// torch.cos and torch.sin (chip_smoke.py)
template <typename R>
__global__ void __launch_bounds__(kThreads)
sincos_kernel(const R* __restrict__ x, R* __restrict__ c,
              R* __restrict__ s, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) sincos_of(x[i], c[i], s[i]);
}

template <typename R>
int launch_sincos(const R* x, R* c, R* s, int64_t n, void* stream) {
  if (n <= 0) return -2;
  sincos_kernel<R><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                     kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, c, s, n);
  return static_cast<int>(cudaGetLastError());
}

// the Sim's leaves, and its t_stop after them where it carries one (the
// dwell does not read it: the horizon is a term of make_cond only)
inline bool load_ptrs(void* const* leaves, int n_leaves, Ptrs& ps) {
  if (n_leaves != N_LEAVES && n_leaves != N_LEAVES + 1) return false;
  ps.p[T_STOP] = nullptr;
  for (int i = 0; i < n_leaves; ++i) ps.p[i] = leaves[i];
  return true;
}

template <typename R, typename C>
int launch_chunk(void* const* leaves, int n_leaves, int lanes, int event_cap,
                 int n_procs, int chunk_steps, int horizon, double t_end,
                 void* stream) {
  Ptrs ps;
  if (horizon < H_NONE || horizon > H_LANE) return -5;
  if (!load_ptrs(leaves, n_leaves, ps) ||
      (n_leaves == N_LEAVES + 1) != (horizon == H_LANE))
    return -1;
  if (lanes <= 0 || chunk_steps <= 0 || n_procs < 2) return -2;
  constexpr int per_block = kThreads / LT;
  const int blocks = (lanes + per_block - 1) / per_block;
  chunk_kernel<R, C><<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      ps, lanes, event_cap, n_procs, chunk_steps, horizon, R(t_end));
  return static_cast<int>(cudaGetLastError());
}

template <typename R, typename C>
int launch_dwell(void* const* leaves, int n_leaves, int lanes, int event_cap,
                 int n_procs, const float* weights, int scoring_nn,
                 void* stream) {
  Ptrs ps;
  if (!load_ptrs(leaves, n_leaves, ps)) return -1;
  if (lanes <= 0 || n_procs < 2 || (scoring_nn && weights == nullptr))
    return -2;
  constexpr int per_block = kThreads / 32;
  const int blocks = (lanes + per_block - 1) / per_block;
  dwell_kernel<R, C><<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      ps, lanes, event_cap, n_procs, weights, scoring_nn != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace awacs
}  // namespace cimba

// Plain C interface (loaded with ctypes).  leaves: the Sim's device
// pointers in cimba::awacs::Leaf order, with the Sim's t_stop last where
// it carries one; n_procs = targets + 1.  Each launches on ``stream``
// without synchronising and returns cudaGetLastError() after the launch
// (0 = ok), or -1 / -2 / -5 for a wrong leaf count / bad shape / no such
// horizon (cimba::Horizon: 0 none, 1 t_end, 2 each lane's t_stop).
extern "C" int cimba_awacs_chunk_f32(void* const* leaves, int n_leaves,
                                     int lanes, int event_cap, int n_procs,
                                     int chunk_steps, int horizon,
                                     double t_end, void* stream) {
  return cimba::awacs::launch_chunk<float, int32_t>(
      leaves, n_leaves, lanes, event_cap, n_procs, chunk_steps, horizon,
      t_end, stream);
}

extern "C" int cimba_awacs_chunk_f64(void* const* leaves, int n_leaves,
                                     int lanes, int event_cap, int n_procs,
                                     int chunk_steps, int horizon,
                                     double t_end, void* stream) {
  return cimba::awacs::launch_chunk<double, int64_t>(
      leaves, n_leaves, lanes, event_cap, n_procs, chunk_steps, horizon,
      t_end, stream);
}

// The boundary round: one engine step on every lane with
// boundary_pending set, which it clears.  weights: K5's 1378 packed f32
// weights on the device (read when scoring_nn is 1; scoring "threshold"
// is 0).
extern "C" int cimba_awacs_dwell_f32(void* const* leaves, int n_leaves,
                                     int lanes, int event_cap, int n_procs,
                                     const float* weights, int scoring_nn,
                                     void* stream) {
  return cimba::awacs::launch_dwell<float, int32_t>(
      leaves, n_leaves, lanes, event_cap, n_procs, weights, scoring_nn,
      stream);
}

extern "C" int cimba_awacs_dwell_f64(void* const* leaves, int n_leaves,
                                     int lanes, int event_cap, int n_procs,
                                     const float* weights, int scoring_nn,
                                     void* stream) {
  return cimba::awacs::launch_dwell<double, int64_t>(
      leaves, n_leaves, lanes, event_cap, n_procs, weights, scoring_nn,
      stream);
}

// cos and sin of n arguments as the chunk computes a heading's (x, c, s:
// device pointers)
extern "C" int cimba_awacs_sincos_f32(const float* x, float* c, float* s,
                                      int64_t n, void* stream) {
  return cimba::awacs::launch_sincos<float>(x, c, s, n, stream);
}

extern "C" int cimba_awacs_sincos_f64(const double* x, double* c,
                                      double* s, int64_t n, void* stream) {
  return cimba::awacs::launch_sincos<double>(x, c, s, n, stream);
}
