// The single-queue event-loop chunk kernel for Hopper (sm_90a): the M/M/1
// and M/M/c instances of K1.
//
// Replaces the Pallas chunk mega-kernel of the JAX package
// (cimba_tpu/core/pallas_run.py: make_kernel_run -> build_chunk_call,
// body _kernel_body), which advances every live lane by up to
// chunk_steps engine steps with the whole Sim resident on the chip.
//
// Design: one thread per replication lane.  The thread loads its lane's
// Sim into registers (clock, RNG words, the wake table of its NP = 1 + NS
// processes, process rows, pend fields, guard counters, queue head and
// size, the queue-length accumulator, the wait summary, done/err/
// n_events), runs up to chunk_steps events while its own lane is live
// (make_cond), and writes the state back in place.  No lockstep masking:
// each thread stops on its own.  The queue ring and the general event
// table stay in device memory.
//
// Specialised to the fused-verb single-queue cycle that
// cimba_tpu_torch.models.mm1 and cimba_tpu_torch.models.mmc share (one
// arrival process, NS server processes, one FIFO), with two compile-time
// parameters: the server count NS and RECORD, the queue's length
// recording (stats.timeseries.step_record on every successful put or
// get).  Instances: (1, false) is mm1.build(record=False), (1, true)
// mm1.build() and mmc.build(1), (c, true) mmc.build(c) for c = 2..4.  The
// TPU kernel re-evaluates any model's traced step; this one hard-codes
// the blocks (struct Lane below), and its host loop
// (cimba_tpu_torch/core/kernel_run.py) refuses any other spec.  A kernel
// generated per model from its blocks is an open item (ROADMAP.md).
//
// What bounds it on this card: per-event dependent latency — each event
// is one serial chain of ~400 dependent integer and float operations
// (a 20-round Threefry block, a log1p, the Pébay merge, the table
// scans) that no other lane's work can shorten — plus ring traffic of
// about one 4- or 8-byte read or write per queue verb.  The lane-first
// ring row of 128 slots is uncoalesced across a warp; coalesced
// lane-last rings, the ring in shared memory and persistent blocks are
// later work.
//
// Built with --fmad=false so float results follow the plain PyTorch
// engine's separately rounded multiplies and adds.
//
// What one lane computes (struct Lane, run as a sequential state
// machine): exactly what cimba_tpu.core.loop.make_step computes for
// the specs of cimba_tpu.models.mm1.build and cimba_tpu.models.mmc.build
// (and their ports): the (time, prio desc, seq) pick over the dense wake
// table and the general event table with the lowest index winning ties;
// the blocks a_start, a_cycle, a_exit, s_start, s_cycle with one counter
// tick per draw; the fused put_hold/get_hold verbs; the guard pend on a
// full or empty queue (the pended command keeps its pre-drawn duration
// in pend_f3), the best waiter by (prio desc, pend_seq asc, pid asc) and
// the SUCCESS-wake retry; the queue-length record at (clock, size after
// the verb); the error codes; api.stop; and the n_events count.  The
// order of every state write follows the reference, because wake seqs
// are assigned in that order and decide ties: a successful get signals
// the rear guard, then the front guard (the cascade to the next waiting
// server), and only then arms its own fused hold.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "threefry.cuh"

namespace cimba {
namespace queue {

// the spec's shape (checked in cimba_tpu_torch/core/kernel_run.py): pid 0
// is the arrival, pids 1..NS the servers (template parameter NS)
constexpr int NG = 2;  // the queue's front (getters) and rear (putters)
constexpr int MAX_CHAIN = 1024;

// command tags, statuses, signals, kinds, error codes: the reference's
constexpr int C_HOLD = 0, C_EXIT = 1, C_JUMP = 2, C_PUT = 3, C_GET = 4;
constexpr int C_PUT_HOLD = 18, C_GET_HOLD = 19, N_COMMANDS = 28;
constexpr int NO_PEND = -1, SUCCESS = 0, RUNNING = 1, FINISHED = 2;
constexpr int K_PROC = 0, K_TIMER = 1;
constexpr int ERR_EVENT_OVERFLOW = 1, ERR_CHAIN_RUNAWAY = 3, ERR_USER = 4;
constexpr int32_t I32_MIN = INT32_MIN, I32_MAX = INT32_MAX;

// block pcs in registration order (mm1.BLOCK_NAMES)
constexpr int A_START = 0, A_CYCLE = 1, A_EXIT = 2, S_START = 3,
              S_CYCLE = 4, N_BLOCKS = 5;

// Sim leaves in the reference's jax.tree.leaves order; the eleven
// queues.acc leaves (A_N..A_STARTED) exist only in a recording Sim
enum Leaf {
  CLOCK, REP, KEY0, KEY1, CTR_LO, CTR_HI,
  EV_TIME, EV_PRIO, EV_SEQ, EV_KIND, EV_SUBJ, EV_ARG, EV_GEN, EV_NEXT_SEQ,
  EV_OVERFLOW,
  WK_TIME, WK_SIG, WK_SEQ,
  PC, STATUS, PRIO, PEND_TAG, PEND_F, PEND_F2, PEND_F3, PEND_I, PEND_PC,
  PEND_GUARD, PEND_SEQ, AWAIT_PID, AWAIT_EVT, EXIT_SIG, GOT, LOCALS_F,
  LOCALS_I,
  GUARD_NEXT_SEQ,
  Q_ITEMS, Q_HEAD, Q_SIZE,
  A_N, A_W, A_MN, A_MX, A_M1, A_M2, A_M3, A_M4, A_LAST_T, A_LAST_V,
  A_STARTED,
  U_ARR_MEAN, U_N_OBJECTS, U_SRV_MEAN,
  W_N, W_W, W_MN, W_MX, W_M1, W_M2, W_M3, W_M4,
  DONE, ERR, N_EVENTS, BOUNDARY_PENDING,
  N_LEAVES_RECORD
};
constexpr int N_ACC = A_STARTED - A_N + 1;

// a leaf's position in the pointer array of a (non-)recording Sim
template <bool RECORD>
__host__ __device__ constexpr int at(Leaf k) {
  return (!RECORD && k > A_STARTED) ? int(k) - N_ACC : int(k);
}

template <bool RECORD>
constexpr int leaf_count() {
  return RECORD ? N_LEAVES_RECORD : N_LEAVES_RECORD - N_ACC;
}

struct Ptrs {
  void* p[N_LEAVES_RECORD];
};

template <int NS, bool RECORD>
struct Inst {
  static constexpr int ns = NS;
  static constexpr bool rec = RECORD;
};

// static layout of one lane's tables
struct Shape {
  int event_cap;   // general event table slots
  int ring_width;  // queue ring slots per lane (queue_cap_max)
  int queue_cap;   // the queue's capacity
  int front;       // guard ids
  int rear;
  int n_ilocals;
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

// uniform01_53: f32 takes 24 bits of the high word, f64 a 53-bit
// significand from both words
__device__ float u53_of(uint32_t, uint32_t b1, float) {
  return float(int32_t(b1 >> 8)) * 0x1p-24f;
}
__device__ double u53_of(uint32_t b0, uint32_t b1, double) {
  return double(b1) * 0x1p-32 + double(b0 >> 11) * 0x1p-53;
}

// jnp.maximum(x, 0): NaN propagates
template <typename R>
__device__ R nanmax0(R x) {
  return (x != x || x > R(0)) ? x : R(0);
}

// a stats.summary.Summary of one lane
template <typename R>
struct Sum {
  R n, w, mn, mx, m1, m2, m3, m4;
};

// summary.add(a, x, bw): the Pébay merge of a with the singleton
// (1, bw, x, x, x, 0, 0, 0), in the reference's operation order (x**3 =
// x*(x*x), x**4 = (x*x)*(x*x) as XLA evaluates integer powers)
template <typename R>
__device__ Sum<R> add(const Sum<R>& a, R x, R bw) {
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

// the queue-length accumulator (stats.timeseries.StepAccum) of a
// recording instance; an instance that does not record carries none, so
// that its lane state is what it was before recording existed
template <typename R, bool RECORD>
struct Acc {};

template <typename R>
struct Acc<R, true> {
  Sum<R> acc;
  R acc_last_t, acc_last_v;
  bool acc_started;
};

template <typename R, typename C, int NS, bool RECORD>
struct Lane : Acc<R, RECORD> {
  static constexpr int NP = 1 + NS;

  Shape sh;
  R clock;
  uint32_t k0, k1, lo, hi;
  // general event table: read and written in place
  R* ev_time;
  int32_t *ev_prio, *ev_seq, *ev_kind, *ev_subj, *ev_arg, *ev_gen;
  int32_t next_seq;
  // dense wakes and process rows
  R wt[NP];
  int32_t wsig[NP], wseq[NP];
  int32_t pc[NP], status[NP], prio[NP], pend_tag[NP], pend_i[NP];
  int32_t pend_pc[NP], pend_guard[NP], pend_seq[NP], exit_sig[NP];
  R pend_f[NP], pend_f2[NP], pend_f3[NP], got[NP];
  int32_t produced[NP];  // ilocal L_PRODUCED
  int32_t gseq[NG];
  // the queue: ring in place, head and size here
  R* ring;
  int32_t head, size;
  // user state
  // user state
  R arr_mean, srv_mean;
  int32_t n_objects;
  Sum<R> wait;
  bool done;
  int32_t err;
  C n_events;

  __device__ void set_err(int32_t code) {
    if (err == 0) err = code;
  }

  __device__ R draw_exponential(R mean) {
    uint32_t b0, b1;
    threefry2x32(k0, k1, lo, hi, b0, b1);
    lo += 1u;
    if (lo == 0u) hi += 1u;
    const R u = u53_of(b0, b1, R(0));
    const R x = -log1p_of(-u);
    return mean * x;
  }

  // timeseries.step_record(acc, clock, v): the previous length is
  // credited with the time since the last record; a zero-length segment
  // leaves the summary as it was
  __device__ void record(R v) {
    const R dur = nanmax0(clock - this->acc_last_t);
    const Sum<R> upd = add(this->acc, this->acc_last_v, dur);
    if (dur > R(0)) this->acc = upd;
    this->acc_last_t = clock;
    this->acc_last_v = v;
    this->acc_started = true;
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

  // wake the best waiter of guard gid: highest live prio, then lowest
  // pend_seq, then lowest pid
  __device__ void guard_signal(int gid) {
    bool found = false;
    int32_t pmax = I32_MIN;
    for (int q = 0; q < NP; ++q)
      if (pend_guard[q] == gid) {
        found = true;
        pmax = prio[q] > pmax ? prio[q] : pmax;
      }
    if (!found) return;
    int32_t smin = I32_MAX;
    for (int q = 0; q < NP; ++q)
      if (pend_guard[q] == gid && prio[q] == pmax && pend_seq[q] < smin)
        smin = pend_seq[q];
    int pid = 0;
    for (int q = 0; q < NP; ++q)
      if (pend_guard[q] == gid && prio[q] == pmax && pend_seq[q] == smin) {
        pid = q;
        break;
      }
    pend_guard[pid] = -1;
    schedule_wake(pid, SUCCESS, clock);
  }

  __device__ void guard_wait(int p, int gid, const Cmd<R>& c, bool is_retry) {
    const int32_t so = is_retry ? pend_seq[p] : -1;
    const int32_t fresh = gseq[gid];
    const int32_t seq = so >= 0 ? so : fresh;
    if (seq == fresh) gseq[gid] += 1;
    pend_tag[p] = c.tag;
    pend_f[p] = c.f;
    pend_f2[p] = c.f2;
    pend_f3[p] = c.f3;
    pend_i[p] = c.i;
    pend_pc[p] = c.next_pc;
    pend_guard[p] = gid;
    pend_seq[p] = seq;
    pc[p] = c.next_pc;
  }

  __device__ bool any_waiting(int gid) const {
    for (int q = 0; q < NP; ++q)
      if (pend_guard[q] == gid) return true;
    return false;
  }

  // put/get and their fused *_hold twins, in the reference's order
  __device__ bool h_queue(int p, const Cmd<R>& c, int tag, bool is_retry) {
    const bool is_put = tag == C_PUT || tag == C_PUT_HOLD;
    const bool fused = tag == C_PUT_HOLD || tag == C_GET_HOLD;
    const int cap = sh.queue_cap;
    const int own = is_put ? sh.rear : sh.front;
    const bool may = is_retry || !any_waiting(own);
    const bool blocked = (is_put ? size >= cap : size <= 0) || !may;
    const bool ok = !blocked;
    if (ok) {
      if (is_put) {
        ring[(head + size) % cap] = c.f;
        size += 1;
      } else {
        got[p] = ring[head];
        head = (head + 1) % cap;
        size -= 1;
      }
      if constexpr (RECORD) record(R(size));
      if (!is_put) guard_signal(sh.rear);
      guard_signal(sh.front);
      if (fused) schedule_wake(p, SUCCESS, clock + nanmax0(c.f3));
    }
    pc[p] = c.next_pc;
    if (blocked) guard_wait(p, own, c, is_retry);
    return blocked || fused;
  }

  __device__ void finish(int p) {
    pend_tag[p] = NO_PEND;
    pend_guard[p] = -1;
    wt[p] = inf_of<R>();
    for (int i = 0; i < sh.event_cap; ++i)
      if (finite(ev_time[i]) && ev_kind[i] == K_TIMER && ev_subj[i] == p) {
        ev_time[i] = inf_of<R>();
        ev_gen[i] += 1;
      }
    status[p] = FINISHED;
    exit_sig[p] = SUCCESS;
  }

  // returns "yielded"
  __device__ bool apply(int p, const Cmd<R>& c, bool is_retry) {
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
      case C_PUT:
      case C_GET:
      case C_PUT_HOLD:
      case C_GET_HOLD:
        return h_queue(p, c, tag, is_retry);
      default:
        set_err(ERR_USER);
        return true;
    }
  }

  __device__ Cmd<R> run_block(int p) {
    int b = pc[p];
    b = b < 0 ? 0 : (b > N_BLOCKS - 1 ? N_BLOCKS - 1 : b);
    switch (b) {
      case A_START: {
        const R t = draw_exponential(arr_mean);
        return Cmd<R>{C_HOLD, t, R(0), R(0), 0, A_CYCLE};
      }
      case A_CYCLE: {
        produced[p] += 1;
        const bool finished = produced[p] >= n_objects;
        const R t = draw_exponential(arr_mean);
        if (finished) return Cmd<R>{C_PUT, clock, R(0), R(0), 0, A_EXIT};
        return Cmd<R>{C_PUT_HOLD, clock, R(0), t, 0, A_CYCLE};
      }
      case A_EXIT:
        return Cmd<R>{C_EXIT, R(0), R(0), R(0), 0, 0};
      case S_START: {
        const R t = draw_exponential(srv_mean);
        return Cmd<R>{C_GET_HOLD, R(0), R(0), t, 0, S_CYCLE};
      }
      default: {  // S_CYCLE
        wait = add(wait, clock - got[p], R(1));
        if (wait.n >= R(n_objects)) done = true;
        const R t = draw_exponential(srv_mean);
        return Cmd<R>{C_GET_HOLD, R(0), R(0), t, 0, S_CYCLE};
      }
    }
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
        yielded = apply(p, pend, true);
      } else {
        const Cmd<R> c = run_block(p);
        yielded = apply(p, c, false);
      }
      use_pend = false;
      ++n;
    }
    if (n >= MAX_CHAIN) set_err(ERR_CHAIN_RUNAWAY);
  }

  __device__ bool live(bool has_t_end, R t_end) const {
    bool empty = true;
    R nxt = inf_of<R>();
    for (int i = 0; i < sh.event_cap; ++i) {
      if (finite(ev_time[i])) empty = false;
      nxt = ev_time[i] < nxt ? ev_time[i] : nxt;
    }
    for (int q = 0; q < NP; ++q) {
      if (finite(wt[q])) empty = false;
      nxt = wt[q] < nxt ? wt[q] : nxt;
    }
    bool l = !done && err == 0 && !empty;
    if (has_t_end) l = l && nxt <= t_end;
    return l;
  }

  __device__ void step() {
    // general table: (time asc, prio desc, seq asc), lowest slot wins
    R t_e = inf_of<R>();
    for (int i = 0; i < sh.event_cap; ++i) t_e = ev_time[i] < t_e ? ev_time[i] : t_e;
    const bool found_e = finite(t_e);
    int32_t p_e = I32_MIN, s_e = I32_MAX;
    int slot_e = 0;
    int32_t kind_e = 0, subj_e = 0, arg_e = 0;
    if (found_e) {
      for (int i = 0; i < sh.event_cap; ++i)
        if (ev_time[i] == t_e && ev_prio[i] > p_e) p_e = ev_prio[i];
      for (int i = 0; i < sh.event_cap; ++i)
        if (ev_time[i] == t_e && ev_prio[i] == p_e && ev_seq[i] < s_e)
          s_e = ev_seq[i];
      for (int i = 0; i < sh.event_cap; ++i)
        if (ev_time[i] == t_e && ev_prio[i] == p_e && ev_seq[i] == s_e) {
          slot_e = i;
          break;
        }
      kind_e = ev_kind[slot_e];
      subj_e = ev_subj[slot_e];
      arg_e = ev_arg[slot_e];
    }
    // dense wakes: the same order, priority read live from procs.prio
    R t_w = inf_of<R>();
    for (int q = 0; q < NP; ++q) t_w = wt[q] < t_w ? wt[q] : t_w;
    const bool found_w = finite(t_w);
    int32_t p_w = I32_MIN, s_w = I32_MAX;
    int pid_w = 0;
    if (found_w) {
      for (int q = 0; q < NP; ++q)
        if (wt[q] == t_w && prio[q] > p_w) p_w = prio[q];
      for (int q = 0; q < NP; ++q)
        if (wt[q] == t_w && prio[q] == p_w && wseq[q] < s_w) s_w = wseq[q];
      for (int q = 0; q < NP; ++q)
        if (wt[q] == t_w && prio[q] == p_w && wseq[q] == s_w) {
          pid_w = q;
          break;
        }
    }
    const bool wake_first =
        found_w &&
        (!found_e || t_w < t_e ||
         (t_w == t_e && (p_w > p_e || (p_w == p_e && s_w < s_e))));
    if (!(found_e || found_w)) {
      done = true;
      return;
    }
    int32_t subj, arg;
    if (wake_first) {
      clock = t_w;
      subj = pid_w;
      arg = wsig[pid_w];
      wt[pid_w] = inf_of<R>();
    } else {
      clock = t_e;
      subj = subj_e;
      arg = arg_e;
      ev_time[slot_e] = inf_of<R>();
      ev_gen[slot_e] += 1;
    }
    (void)kind_e;  // K_PROC and K_TIMER both resume; mm1 has no handlers
    n_events += 1;
    if (subj >= 0 && subj < NP && status[subj] == RUNNING) resume(subj, arg);
  }
};


template <typename T, bool RECORD>
__device__ T* leaf(const Ptrs& ps, Leaf k) {
  return static_cast<T*>(ps.p[at<RECORD>(k)]);
}

template <typename R, bool RECORD>
__device__ Sum<R> load_sum(const Ptrs& ps, Leaf first, int l) {
  Sum<R> s;
  s.n = leaf<R, RECORD>(ps, Leaf(first + 0))[l];
  s.w = leaf<R, RECORD>(ps, Leaf(first + 1))[l];
  s.mn = leaf<R, RECORD>(ps, Leaf(first + 2))[l];
  s.mx = leaf<R, RECORD>(ps, Leaf(first + 3))[l];
  s.m1 = leaf<R, RECORD>(ps, Leaf(first + 4))[l];
  s.m2 = leaf<R, RECORD>(ps, Leaf(first + 5))[l];
  s.m3 = leaf<R, RECORD>(ps, Leaf(first + 6))[l];
  s.m4 = leaf<R, RECORD>(ps, Leaf(first + 7))[l];
  return s;
}

template <typename R, bool RECORD>
__device__ void store_sum(const Ptrs& ps, Leaf first, int l, const Sum<R>& s) {
  leaf<R, RECORD>(ps, Leaf(first + 0))[l] = s.n;
  leaf<R, RECORD>(ps, Leaf(first + 1))[l] = s.w;
  leaf<R, RECORD>(ps, Leaf(first + 2))[l] = s.mn;
  leaf<R, RECORD>(ps, Leaf(first + 3))[l] = s.mx;
  leaf<R, RECORD>(ps, Leaf(first + 4))[l] = s.m1;
  leaf<R, RECORD>(ps, Leaf(first + 5))[l] = s.m2;
  leaf<R, RECORD>(ps, Leaf(first + 6))[l] = s.m3;
  leaf<R, RECORD>(ps, Leaf(first + 7))[l] = s.m4;
}

// Load lane l's state, run up to chunk_steps events while the lane is
// live (make_cond), and store it back.  Leaves are lane-first; the
// queue's accumulator rows are [L, 1].
template <typename R, typename C, int NS, bool RECORD>
__device__ void run_lane(const Ptrs& ps, int l, const Shape& sh,
                       int chunk_steps, bool has_t_end, R t_end) {
  constexpr int NP = 1 + NS;
  const int E = sh.event_cap;
  const int NI = sh.n_ilocals;

  Lane<R, C, NS, RECORD> s;
  s.sh = sh;
  s.clock = leaf<R, RECORD>(ps, CLOCK)[l];
  s.k0 = uint32_t(leaf<int64_t, RECORD>(ps, KEY0)[l]);
  s.k1 = uint32_t(leaf<int64_t, RECORD>(ps, KEY1)[l]);
  s.lo = uint32_t(leaf<int64_t, RECORD>(ps, CTR_LO)[l]);
  s.hi = uint32_t(leaf<int64_t, RECORD>(ps, CTR_HI)[l]);
  s.ev_time = leaf<R, RECORD>(ps, EV_TIME) + size_t(l) * E;
  s.ev_prio = leaf<int32_t, RECORD>(ps, EV_PRIO) + size_t(l) * E;
  s.ev_seq = leaf<int32_t, RECORD>(ps, EV_SEQ) + size_t(l) * E;
  s.ev_kind = leaf<int32_t, RECORD>(ps, EV_KIND) + size_t(l) * E;
  s.ev_subj = leaf<int32_t, RECORD>(ps, EV_SUBJ) + size_t(l) * E;
  s.ev_arg = leaf<int32_t, RECORD>(ps, EV_ARG) + size_t(l) * E;
  s.ev_gen = leaf<int32_t, RECORD>(ps, EV_GEN) + size_t(l) * E;
  s.next_seq = leaf<int32_t, RECORD>(ps, EV_NEXT_SEQ)[l];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const size_t i = size_t(l) * NP + q;
    s.wt[q] = leaf<R, RECORD>(ps, WK_TIME)[i];
    s.wsig[q] = leaf<int32_t, RECORD>(ps, WK_SIG)[i];
    s.wseq[q] = leaf<int32_t, RECORD>(ps, WK_SEQ)[i];
    s.pc[q] = leaf<int32_t, RECORD>(ps, PC)[i];
    s.status[q] = leaf<int32_t, RECORD>(ps, STATUS)[i];
    s.prio[q] = leaf<int32_t, RECORD>(ps, PRIO)[i];
    s.pend_tag[q] = leaf<int32_t, RECORD>(ps, PEND_TAG)[i];
    s.pend_f[q] = leaf<R, RECORD>(ps, PEND_F)[i];
    s.pend_f2[q] = leaf<R, RECORD>(ps, PEND_F2)[i];
    s.pend_f3[q] = leaf<R, RECORD>(ps, PEND_F3)[i];
    s.pend_i[q] = leaf<int32_t, RECORD>(ps, PEND_I)[i];
    s.pend_pc[q] = leaf<int32_t, RECORD>(ps, PEND_PC)[i];
    s.pend_guard[q] = leaf<int32_t, RECORD>(ps, PEND_GUARD)[i];
    s.pend_seq[q] = leaf<int32_t, RECORD>(ps, PEND_SEQ)[i];
    s.exit_sig[q] = leaf<int32_t, RECORD>(ps, EXIT_SIG)[i];
    s.got[q] = leaf<R, RECORD>(ps, GOT)[i];
    s.produced[q] = leaf<int32_t, RECORD>(ps, LOCALS_I)[i * NI];
  }
#pragma unroll
  for (int g = 0; g < NG; ++g)
    s.gseq[g] = leaf<int32_t, RECORD>(ps, GUARD_NEXT_SEQ)[size_t(l) * NG + g];
  s.ring = leaf<R, RECORD>(ps, Q_ITEMS) + size_t(l) * sh.ring_width;
  s.head = leaf<int32_t, RECORD>(ps, Q_HEAD)[l];
  s.size = leaf<int32_t, RECORD>(ps, Q_SIZE)[l];
  s.arr_mean = leaf<R, RECORD>(ps, U_ARR_MEAN)[l];
  s.srv_mean = leaf<R, RECORD>(ps, U_SRV_MEAN)[l];
  s.n_objects = leaf<int32_t, RECORD>(ps, U_N_OBJECTS)[l];
  s.wait = load_sum<R, RECORD>(ps, W_N, l);
  if constexpr (RECORD) {
    s.acc = load_sum<R, RECORD>(ps, A_N, l);
    s.acc_last_t = leaf<R, RECORD>(ps, A_LAST_T)[l];
    s.acc_last_v = leaf<R, RECORD>(ps, A_LAST_V)[l];
    s.acc_started = leaf<bool, RECORD>(ps, A_STARTED)[l];
  }
  s.done = leaf<bool, RECORD>(ps, DONE)[l];
  s.err = leaf<int32_t, RECORD>(ps, ERR)[l];
  s.n_events = leaf<C, RECORD>(ps, N_EVENTS)[l];

  for (int k = 0; k < chunk_steps && s.live(has_t_end, t_end); ++k) s.step();

  leaf<R, RECORD>(ps, CLOCK)[l] = s.clock;
  leaf<int64_t, RECORD>(ps, CTR_LO)[l] = int64_t(s.lo);
  leaf<int64_t, RECORD>(ps, CTR_HI)[l] = int64_t(s.hi);
  leaf<int32_t, RECORD>(ps, EV_NEXT_SEQ)[l] = s.next_seq;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const size_t i = size_t(l) * NP + q;
    leaf<R, RECORD>(ps, WK_TIME)[i] = s.wt[q];
    leaf<int32_t, RECORD>(ps, WK_SIG)[i] = s.wsig[q];
    leaf<int32_t, RECORD>(ps, WK_SEQ)[i] = s.wseq[q];
    leaf<int32_t, RECORD>(ps, PC)[i] = s.pc[q];
    leaf<int32_t, RECORD>(ps, STATUS)[i] = s.status[q];
    leaf<int32_t, RECORD>(ps, PEND_TAG)[i] = s.pend_tag[q];
    leaf<R, RECORD>(ps, PEND_F)[i] = s.pend_f[q];
    leaf<R, RECORD>(ps, PEND_F2)[i] = s.pend_f2[q];
    leaf<R, RECORD>(ps, PEND_F3)[i] = s.pend_f3[q];
    leaf<int32_t, RECORD>(ps, PEND_I)[i] = s.pend_i[q];
    leaf<int32_t, RECORD>(ps, PEND_PC)[i] = s.pend_pc[q];
    leaf<int32_t, RECORD>(ps, PEND_GUARD)[i] = s.pend_guard[q];
    leaf<int32_t, RECORD>(ps, PEND_SEQ)[i] = s.pend_seq[q];
    leaf<int32_t, RECORD>(ps, EXIT_SIG)[i] = s.exit_sig[q];
    leaf<R, RECORD>(ps, GOT)[i] = s.got[q];
    leaf<int32_t, RECORD>(ps, LOCALS_I)[i * NI] = s.produced[q];
  }
#pragma unroll
  for (int g = 0; g < NG; ++g)
    leaf<int32_t, RECORD>(ps, GUARD_NEXT_SEQ)[size_t(l) * NG + g] = s.gseq[g];
  leaf<int32_t, RECORD>(ps, Q_HEAD)[l] = s.head;
  leaf<int32_t, RECORD>(ps, Q_SIZE)[l] = s.size;
  store_sum<R, RECORD>(ps, W_N, l, s.wait);
  if constexpr (RECORD) {
    store_sum<R, RECORD>(ps, A_N, l, s.acc);
    leaf<R, RECORD>(ps, A_LAST_T)[l] = s.acc_last_t;
    leaf<R, RECORD>(ps, A_LAST_V)[l] = s.acc_last_v;
    leaf<bool, RECORD>(ps, A_STARTED)[l] = s.acc_started;
  }
  leaf<bool, RECORD>(ps, DONE)[l] = s.done;
  leaf<int32_t, RECORD>(ps, ERR)[l] = s.err;
  leaf<C, RECORD>(ps, N_EVENTS)[l] = s.n_events;
}

template <typename R, typename C, int NS, bool RECORD>
__global__ void __launch_bounds__(128)
chunk_kernel(Ptrs ps, int lanes, Shape sh, int chunk_steps, bool has_t_end,
             R t_end) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l < lanes)
    run_lane<R, C, NS, RECORD>(ps, l, sh, chunk_steps, has_t_end, t_end);
}

template <typename R, typename C, int NS, bool RECORD>
int launch(void* const* leaves, int n_leaves, int lanes, const Shape& sh,
           int chunk_steps, int has_t_end, double t_end, void* stream) {
  if (n_leaves != leaf_count<RECORD>()) return -1;
  if (lanes <= 0 || chunk_steps <= 0) return -2;
  Ptrs ps{};
  for (int i = 0; i < n_leaves; ++i) ps.p[i] = leaves[i];
  constexpr int kThreads = 128;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  chunk_kernel<R, C, NS, RECORD><<<blocks, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      ps, lanes, sh, chunk_steps, has_t_end != 0, R(t_end));
  return static_cast<int>(cudaGetLastError());
}

// the instances: (1, false) mm1.build(record=False); (1, true) mm1.build()
// and mmc.build(1); (2..4, true) mmc.build(c)
template <typename R, typename C>
int dispatch(void* const* leaves, int n_leaves, int lanes, int n_servers,
             int record, const Shape& sh, int chunk_steps, int has_t_end,
             double t_end, void* stream) {
  const auto go = [&](auto inst) {
    return launch<R, C, decltype(inst)::ns, decltype(inst)::rec>(
        leaves, n_leaves, lanes, sh, chunk_steps, has_t_end, t_end, stream);
  };
  if (!record) return n_servers == 1 ? go(Inst<1, false>{}) : -3;
  switch (n_servers) {
    case 1: return go(Inst<1, true>{});
    case 2: return go(Inst<2, true>{});
    case 3: return go(Inst<3, true>{});
    case 4: return go(Inst<4, true>{});
    default: return -3;
  }
}

}  // namespace queue
}  // namespace cimba

// Plain C interface (loaded with ctypes).  leaves: the Sim's device
// pointers in cimba::queue::Leaf order (without the queues.acc leaves
// when record is 0).  Launches on ``stream`` without synchronising;
// returns cudaGetLastError() after the launch (0 = ok), or -1 / -2 / -3
// for a wrong leaf count / an empty launch / no instance for
// (n_servers, record).
#define CIMBA_QUEUE_CHUNK(SUFFIX, R, C)                                      \
  extern "C" int cimba_queue_chunk_##SUFFIX(                                 \
      void* const* leaves, int n_leaves, int lanes, int n_servers,          \
      int record, int event_cap, int ring_width, int queue_cap, int front,  \
      int rear, int n_ilocals, int chunk_steps, int has_t_end, double t_end, \
      void* stream) {                                                        \
    const cimba::queue::Shape sh{event_cap, ring_width, queue_cap,          \
                                 front,     rear,       n_ilocals};         \
    return cimba::queue::dispatch<R, C>(leaves, n_leaves, lanes, n_servers, \
                                        record, sh, chunk_steps, has_t_end, \
                                        t_end, stream);                     \
  }                                                                          \
  /* the M/M/1 instance under its first name, (1 server, no recording) */   \
  extern "C" int cimba_mm1_chunk_##SUFFIX(                                   \
      void* const* leaves, int n_leaves, int lanes, int event_cap,          \
      int ring_width, int queue_cap, int front, int rear, int n_ilocals,    \
      int chunk_steps, int has_t_end, double t_end, void* stream) {         \
    return cimba_queue_chunk_##SUFFIX(leaves, n_leaves, lanes, 1, 0,        \
                                      event_cap, ring_width, queue_cap,     \
                                      front, rear, n_ilocals, chunk_steps,  \
                                      has_t_end, t_end, stream);            \
  }

CIMBA_QUEUE_CHUNK(f32, float, int32_t)
CIMBA_QUEUE_CHUNK(f64, double, int64_t)
