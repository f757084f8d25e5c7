// The AWACS event-loop chunk kernel for Hopper (sm_90a).
//
// Replaces, for the AWACS spec, the Pallas chunk mega-kernel of the JAX
// package (cimba_tpu/core/pallas_run.py: make_kernel_run ->
// build_chunk_call, body _kernel_body), which advances every live lane
// by up to chunk_steps engine steps and defers boundary-block dispatches
// to its host loop.  Its single-queue instances (M/M/1, M/M/c) are
// csrc/queue_chunk.cu.
//
// What one lane computes: exactly what cimba_tpu_torch.core.loop.make_run
// (spec, max_steps=chunk_steps, defer_boundary=True) computes for the
// spec of cimba_tpu_torch.models.awacs.build(n): the (time, prio desc,
// seq) pick over the dense wake table of n + 1 processes (prio read live
// from procs.prio, the lowest pid winning ties) and the general event
// table (lowest slot winning ties); an event whose subject sits at the
// sensor's pc (the boundary block sensor_dwell) is left in its table and
// freezes the lane with boundary_pending set; otherwise the clock
// advances, n_events counts it, and the subject resumes: block tgt_leg
// (the five column reads at the pid, the uniform heading, the soft
// bounce with cos/sin/sqrt, the five writes, the exponential leg), then
// hold or exit with finish_process's timer cancel.  The heading is drawn
// before the bounce test and the leg after the writes, both on every
// dispatch, one counter tick each.  A chained entry into the sensor's
// block fails the lane with ERR_BOUNDARY.  The order of every state
// write follows the plain engine, because wake seqs are assigned in that
// order and decide ties.
//
// Design: one warp per replication lane.  The lane's wake row is
// contiguous in the lane-first layout, so the 32 threads scan it
// coalesced (thread t takes pids t, t+32, ...), each keeping its best
// (time, prio, seq, pid), and reduce the 32 candidates by shuffles;
// every thread ends with the same pick.  Thread 0 then runs the step's
// scalar logic — the event-table pick, the liveness test, the dispatch
// and the block — holding the lane's scalars (clock, RNG words,
// next_seq, flags, counts) in registers, and a __syncwarp orders its
// writes before the next scan.  The per-pid columns (~100 KB a lane in
// f32 at 1000 targets) stay in device memory.
//
// What bounds it on this card: by the count of work, bytes — the lane
// state the chunk reads and writes once (PERF.md, K1's AWACS bound).
// Each event reads the lane's 1001 wake times (4 or 8 bytes each; prio
// and seq only where a time ties the best so far) at ~2 operations an
// entry, and the block's scalar chain — two Threefry blocks, cos, sin,
// sqrt, log1p, a division — is ~400 operations on one thread.  In
// practice the time is latency: the scan's ~32 load rounds a thread and
// thread 0's chain of dependent global loads, which the lane's warp
// waits on; how the two share it is an open question (PERF.md).
//
// Built with --fmad=false so float results follow the plain PyTorch
// engine's separately rounded multiplies and adds.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "threefry.cuh"

namespace cimba {
namespace awacs {

constexpr int MAX_CHAIN = 1024;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

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
  N_LEAVES
};

struct Ptrs {
  void* p[N_LEAVES];
};

template <typename R>
struct Cmd {
  int32_t tag;
  R f, f2, f3;
  int32_t i;
  int32_t next_pc;
};

template <typename R>
__device__ R inf_of() {
  return R(INFINITY);
}

// jnp.isfinite
template <typename R>
__device__ bool finite(R x) {
  return x == x && x != inf_of<R>() && x != -inf_of<R>();
}

__device__ float log1p_of(float x) { return log1pf(x); }
__device__ double log1p_of(double x) { return log1p(x); }
__device__ float cos_of(float x) { return cosf(x); }
__device__ double cos_of(double x) { return cos(x); }
__device__ float sin_of(float x) { return sinf(x); }
__device__ double sin_of(double x) { return sin(x); }
__device__ float sqrt_of(float x) { return sqrtf(x); }
__device__ double sqrt_of(double x) { return sqrt(x); }

// uniform01: f32 takes 24 bits of the high word, f64 the high word
__device__ float u01_of(uint32_t, uint32_t b1, float) {
  return float(int32_t(b1 >> 8)) * 0x1p-24f;
}
__device__ double u01_of(uint32_t, uint32_t b1, double) {
  return double(b1) * 0x1p-32;
}
// uniform01_53: f32 as uniform01, f64 a 53-bit significand
__device__ float u53_of(uint32_t b0, uint32_t b1, float z) {
  return u01_of(b0, b1, z);
}
__device__ double u53_of(uint32_t b0, uint32_t b1, double) {
  return double(b1) * 0x1p-32 + double(b0 >> 11) * 0x1p-53;
}

// jnp.maximum(x, 0): NaN propagates
template <typename R>
__device__ R nanmax0(R x) {
  return (x != x || x > R(0)) ? x : R(0);
}

// (time asc, prio desc, seq asc, pid asc): is a before b?
template <typename R>
__device__ bool before(R ta, int32_t pa, int32_t sa, int32_t ia, R tb,
                       int32_t pb, int32_t sb, int32_t ib) {
  if (ta != tb) return ta < tb;
  if (pa != pb) return pa > pb;
  if (sa != sb) return sa < sb;
  return ia < ib;
}

template <typename T>
__device__ T* leaf(const Ptrs& ps, Leaf k) {
  return static_cast<T*>(ps.p[k]);
}

// One lane's state as thread 0 of its warp holds it: scalars in
// registers, per-pid rows as pointers into the lane's rows.
template <typename R, typename C>
struct Lane {
  int E, P;
  R clock;
  uint32_t k0, k1, lo, hi;
  R* ev_time;
  int32_t *ev_prio, *ev_seq, *ev_kind, *ev_subj, *ev_arg, *ev_gen;
  int32_t next_seq;
  R* wt;
  int32_t *wsig, *wseq;
  int32_t *pc, *status, *prio, *pend_tag, *pend_i, *pend_pc, *pend_guard,
      *exit_sig;
  R *pend_f, *pend_f2, *pend_f3;
  R *pos_x, *pos_y, *vel_x, *vel_y, *t_mark;
  R t_end;
  bool done, pending;
  int32_t err;
  C n_events;

  __device__ void set_err(int32_t code) {
    if (err == 0) err = code;
  }

  __device__ void draw(uint32_t& b0, uint32_t& b1) {
    threefry2x32(k0, k1, lo, hi, b0, b1);
    lo += 1u;
    if (lo == 0u) hi += 1u;
  }

  __device__ void schedule_wake(int p, int32_t sig, R t) {
    if (finite(t)) {
      wt[p] = t;
      wsig[p] = sig;
      wseq[p] = next_seq;
      next_seq += 1;
    } else {
      set_err(ERR_EVENT_OVERFLOW);
    }
  }

  __device__ void finish(int p) {
    pend_tag[p] = NO_PEND;
    pend_guard[p] = -1;
    wt[p] = inf_of<R>();
    for (int i = 0; i < E; ++i)
      if (finite(ev_time[i]) && ev_kind[i] == K_TIMER && ev_subj[i] == p) {
        ev_time[i] = inf_of<R>();
        ev_gen[i] += 1;
      }
    status[p] = FINISHED;
    exit_sig[p] = SUCCESS;
  }

  // returns "yielded"; a spec without queues fails every other verb
  __device__ bool apply(int p, const Cmd<R>& c) {
    const int tag = c.tag < 0 ? 0 : (c.tag > N_COMMANDS - 1 ? N_COMMANDS - 1
                                                            : c.tag);
    switch (tag) {
      case C_HOLD:
        schedule_wake(p, SUCCESS, clock + nanmax0(c.f));
        pc[p] = c.next_pc;
        return true;
      case C_EXIT:
        finish(p);
        return true;
      case C_JUMP:
        pc[p] = c.next_pc;
        return false;
      default:
        set_err(ERR_USER);
        return true;
    }
  }

  __device__ Cmd<R> tgt_leg(int p) {
    // target index: pids 0..P-2 are the targets
    const int idx = p < P - 2 ? p : P - 2;
    const R dt = clock - t_mark[idx];
    const R px = pos_x[idx] + vel_x[idx] * dt;
    const R py = pos_y[idx] + vel_y[idx] * dt;
    uint32_t b0, b1;
    draw(b0, b1);
    const R heading = R(0) + R(TWO_PI) * u01_of(b0, b1, R(0));
    const R r = sqrt_of(px * px + py * py);
    const bool outside = r > R(ARENA);
    const R r_min = R(1e-6);
    const R inv_r = R(1) / (r < r_min ? r_min : r);
    const R vx = R(SPEED) * (outside ? -px * inv_r : cos_of(heading));
    const R vy = R(SPEED) * (outside ? -py * inv_r : sin_of(heading));
    pos_x[idx] = px;
    pos_y[idx] = py;
    vel_x[idx] = vx;
    vel_y[idx] = vy;
    t_mark[idx] = clock;
    draw(b0, b1);
    const R leg = R(LEG_MEAN) * -log1p_of(-u53_of(b0, b1, R(0)));
    if (clock >= t_end) return Cmd<R>{C_EXIT, R(0), R(0), R(0), 0, 0};
    return Cmd<R>{C_HOLD, leg, R(0), R(0), 0, TGT_LEG};
  }

  __device__ void resume(int p, int32_t sig) {
    wt[p] = inf_of<R>();
    const Cmd<R> pend{pend_tag[p], pend_f[p], pend_f2[p],
                      pend_f3[p],  pend_i[p], pend_pc[p]};
    const bool has_pend = pend.tag != NO_PEND;
    pend_tag[p] = NO_PEND;
    pend_guard[p] = -1;
    bool use_pend = has_pend && sig == SUCCESS;
    bool yielded = false;
    int n = 0;
    while (!yielded && status[p] == RUNNING && err == 0 && n < MAX_CHAIN) {
      if (use_pend) {
        yielded = apply(p, pend);
      } else {
        // boundary blocks are entered by dispatch only
        if (pc[p] == SENSOR_DWELL) set_err(ERR_BOUNDARY);
        int b = pc[p];
        b = b < 0 ? 0 : (b > N_BLOCKS - 1 ? N_BLOCKS - 1 : b);
        const Cmd<R> c = b == TGT_LEG
                             ? tgt_leg(p)
                             : Cmd<R>{C_EXIT, R(0), R(0), R(0), 0, 0};
        yielded = apply(p, c);
      }
      use_pend = false;
      ++n;
    }
    if (n >= MAX_CHAIN) set_err(ERR_CHAIN_RUNAWAY);
  }

  // One step, given the wake table's pick; returns whether the lane was
  // live (make_cond with defer_boundary) and so stepped.
  __device__ bool step(R t_w, int32_t p_w, int32_t s_w, int32_t pid_w,
                       bool has_t_end, R t_hor) {
    // general table: (time asc, prio desc, seq asc), lowest slot wins
    R t_e = inf_of<R>();
    int slot_e = 0;
    int32_t p_e = I32_MIN, s_e = I32_MAX;
    for (int i = 0; i < E; ++i) t_e = ev_time[i] < t_e ? ev_time[i] : t_e;
    const bool found_e = finite(t_e);
    if (found_e) {
      for (int i = 0; i < E; ++i)
        if (ev_time[i] == t_e && ev_prio[i] > p_e) p_e = ev_prio[i];
      for (int i = 0; i < E; ++i)
        if (ev_time[i] == t_e && ev_prio[i] == p_e && ev_seq[i] < s_e)
          s_e = ev_seq[i];
      for (int i = 0; i < E; ++i)
        if (ev_time[i] == t_e && ev_prio[i] == p_e && ev_seq[i] == s_e) {
          slot_e = i;
          break;
        }
    }
    const bool found_w = finite(t_w);
    const R nxt = t_w < t_e ? t_w : t_e;
    bool live = !done && err == 0 && !pending && (found_e || found_w);
    if (has_t_end) live = live && nxt <= t_hor;
    if (!live) return false;

    const bool wake_first =
        found_w &&
        (!found_e || t_w < t_e ||
         (t_w == t_e && (p_w > p_e || (p_w == p_e && s_w < s_e))));
    const int32_t subj = wake_first ? pid_w : ev_subj[slot_e];
    const int32_t kind = wake_first ? K_PROC : ev_kind[slot_e];
    const int32_t arg = wake_first ? wsig[pid_w] : ev_arg[slot_e];
    // the boundary defer: peek, do not consume
    const int sc = subj < 0 ? 0 : (subj > P - 1 ? P - 1 : subj);
    if (kind <= K_TIMER && pc[sc] == SENSOR_DWELL) {
      pending = true;
      return true;
    }
    if (wake_first) {
      clock = t_w;
      wt[pid_w] = inf_of<R>();
    } else {
      clock = t_e;
      ev_time[slot_e] = inf_of<R>();
      ev_gen[slot_e] += 1;
    }
    n_events += 1;
    // K_PROC and K_TIMER both resume; the model has no user handlers
    if (subj >= 0 && subj < P && status[subj] == RUNNING) resume(subj, arg);
    return true;
  }
};

template <typename R, typename C>
__device__ void run_lane(const Ptrs& ps, int l, int E, int P,
                         int chunk_steps, bool has_t_end, R t_hor) {
  const int t = threadIdx.x % kWarp;
  const size_t rowP = size_t(l) * P;
  const size_t rowX = size_t(l) * (P - 1);
  const size_t rowE = size_t(l) * E;
  const R* wt = leaf<R>(ps, WK_TIME) + rowP;
  const int32_t* prio = leaf<int32_t>(ps, PRIO) + rowP;
  const int32_t* wseq = leaf<int32_t>(ps, WK_SEQ) + rowP;

  Lane<R, C> s;
  if (t == 0) {
    s.E = E;
    s.P = P;
    s.clock = leaf<R>(ps, CLOCK)[l];
    s.k0 = uint32_t(leaf<int64_t>(ps, KEY0)[l]);
    s.k1 = uint32_t(leaf<int64_t>(ps, KEY1)[l]);
    s.lo = uint32_t(leaf<int64_t>(ps, CTR_LO)[l]);
    s.hi = uint32_t(leaf<int64_t>(ps, CTR_HI)[l]);
    s.ev_time = leaf<R>(ps, EV_TIME) + rowE;
    s.ev_prio = leaf<int32_t>(ps, EV_PRIO) + rowE;
    s.ev_seq = leaf<int32_t>(ps, EV_SEQ) + rowE;
    s.ev_kind = leaf<int32_t>(ps, EV_KIND) + rowE;
    s.ev_subj = leaf<int32_t>(ps, EV_SUBJ) + rowE;
    s.ev_arg = leaf<int32_t>(ps, EV_ARG) + rowE;
    s.ev_gen = leaf<int32_t>(ps, EV_GEN) + rowE;
    s.next_seq = leaf<int32_t>(ps, EV_NEXT_SEQ)[l];
    s.wt = leaf<R>(ps, WK_TIME) + rowP;
    s.wsig = leaf<int32_t>(ps, WK_SIG) + rowP;
    s.wseq = leaf<int32_t>(ps, WK_SEQ) + rowP;
    s.pc = leaf<int32_t>(ps, PC) + rowP;
    s.status = leaf<int32_t>(ps, STATUS) + rowP;
    s.prio = leaf<int32_t>(ps, PRIO) + rowP;
    s.pend_tag = leaf<int32_t>(ps, PEND_TAG) + rowP;
    s.pend_f = leaf<R>(ps, PEND_F) + rowP;
    s.pend_f2 = leaf<R>(ps, PEND_F2) + rowP;
    s.pend_f3 = leaf<R>(ps, PEND_F3) + rowP;
    s.pend_i = leaf<int32_t>(ps, PEND_I) + rowP;
    s.pend_pc = leaf<int32_t>(ps, PEND_PC) + rowP;
    s.pend_guard = leaf<int32_t>(ps, PEND_GUARD) + rowP;
    s.exit_sig = leaf<int32_t>(ps, EXIT_SIG) + rowP;
    s.pos_x = leaf<R>(ps, U_POS_X) + rowX;
    s.pos_y = leaf<R>(ps, U_POS_Y) + rowX;
    s.vel_x = leaf<R>(ps, U_VEL_X) + rowX;
    s.vel_y = leaf<R>(ps, U_VEL_Y) + rowX;
    s.t_mark = leaf<R>(ps, U_T_MARK) + rowX;
    s.t_end = leaf<R>(ps, U_T_END)[l];
    s.done = leaf<bool>(ps, DONE)[l];
    s.pending = leaf<bool>(ps, BOUNDARY_PENDING)[l];
    s.err = leaf<int32_t>(ps, ERR)[l];
    s.n_events = leaf<C>(ps, N_EVENTS)[l];
  }

  for (int k = 0; k < chunk_steps; ++k) {
    // the wake pick: a strided scan, then a butterfly of shuffles
    R bt = inf_of<R>();
    int32_t bp = I32_MIN, bs = I32_MAX, bi = I32_MAX;
    for (int q = t; q < P; q += kWarp) {
      const R tq = wt[q];
      if (tq <= bt) {
        const int32_t pq = prio[q], sq = wseq[q];
        if (before(tq, pq, sq, q, bt, bp, bs, bi)) {
          bt = tq;
          bp = pq;
          bs = sq;
          bi = q;
        }
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      const R ot = __shfl_xor_sync(kFull, bt, off);
      const int32_t op = __shfl_xor_sync(kFull, bp, off);
      const int32_t os = __shfl_xor_sync(kFull, bs, off);
      const int32_t oi = __shfl_xor_sync(kFull, bi, off);
      if (before(ot, op, os, oi, bt, bp, bs, bi)) {
        bt = ot;
        bp = op;
        bs = os;
        bi = oi;
      }
    }
    int go = 0;
    if (t == 0) go = s.step(bt, bp, bs, bi, has_t_end, t_hor) ? 1 : 0;
    go = __shfl_sync(kFull, go, 0);
    // thread 0's writes are seen by the next scan
    __syncwarp();
    if (!go) break;
  }

  if (t == 0) {
    leaf<R>(ps, CLOCK)[l] = s.clock;
    leaf<int64_t>(ps, CTR_LO)[l] = int64_t(s.lo);
    leaf<int64_t>(ps, CTR_HI)[l] = int64_t(s.hi);
    leaf<int32_t>(ps, EV_NEXT_SEQ)[l] = s.next_seq;
    leaf<bool>(ps, DONE)[l] = s.done;
    leaf<bool>(ps, BOUNDARY_PENDING)[l] = s.pending;
    leaf<int32_t>(ps, ERR)[l] = s.err;
    leaf<C>(ps, N_EVENTS)[l] = s.n_events;
  }
}

constexpr int kThreads = 128;  // four lanes a block

template <typename R, typename C>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(Ptrs ps, int lanes, int E, int P, int chunk_steps,
             bool has_t_end, R t_hor) {
  const int l = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  if (l < lanes)
    run_lane<R, C>(ps, l, E, P, chunk_steps, has_t_end, t_hor);
}

template <typename R, typename C>
int launch(void* const* leaves, int n_leaves, int lanes, int event_cap,
           int n_procs, int chunk_steps, int has_t_end, double t_end,
           void* stream) {
  if (n_leaves != N_LEAVES) return -1;
  if (lanes <= 0 || chunk_steps <= 0 || n_procs < 2) return -2;
  Ptrs ps;
  for (int i = 0; i < N_LEAVES; ++i) ps.p[i] = leaves[i];
  constexpr int per_block = kThreads / kWarp;
  const int blocks = (lanes + per_block - 1) / per_block;
  chunk_kernel<R, C><<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      ps, lanes, event_cap, n_procs, chunk_steps, has_t_end != 0, R(t_end));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace awacs
}  // namespace cimba

// Plain C interface (loaded with ctypes).  leaves: the Sim's device
// pointers in cimba::awacs::Leaf order; n_procs = targets + 1.  Launches
// on ``stream`` without synchronising; returns cudaGetLastError() after
// the launch (0 = ok), or -1 / -2 for a wrong leaf count / bad shape.
extern "C" int cimba_awacs_chunk_f32(void* const* leaves, int n_leaves,
                                     int lanes, int event_cap, int n_procs,
                                     int chunk_steps, int has_t_end,
                                     double t_end, void* stream) {
  return cimba::awacs::launch<float, int32_t>(leaves, n_leaves, lanes,
                                              event_cap, n_procs, chunk_steps,
                                              has_t_end, t_end, stream);
}

extern "C" int cimba_awacs_chunk_f64(void* const* leaves, int n_leaves,
                                     int lanes, int event_cap, int n_procs,
                                     int chunk_steps, int has_t_end,
                                     double t_end, void* stream) {
  return cimba::awacs::launch<double, int64_t>(leaves, n_leaves, lanes,
                                               event_cap, n_procs,
                                               chunk_steps, has_t_end, t_end,
                                               stream);
}
