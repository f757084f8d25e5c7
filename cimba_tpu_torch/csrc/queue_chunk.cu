// The single-queue event-loop chunk kernel for Hopper (sm_90a): the M/M/1,
// M/M/c, M/G/1, tandem-network and job-shop instances of K1, and the
// generated instances of user specs.
//
// Replaces the Pallas chunk mega-kernel of the JAX package
// (cimba_tpu/core/pallas_run.py: make_kernel_run -> build_chunk_call,
// body _kernel_body), which advances every live lane by up to
// chunk_steps engine steps with the whole Sim resident on the chip.
//
// One thread per replication lane: the thread loads its lane's state,
// runs up to chunk_steps events while its lane is live (make_cond) and
// stores the state back in place.  Each thread stops on its own.
//
// One engine, specialised at compile time to a model family (a struct
// below that restates the model's blocks, its user state's leaves and
// its draws) and, within a family, to the server count NS and RECORD,
// the queues' length recording (stats.timeseries.step_record on every
// successful put or get):
//   MM      the fused-verb single-queue cycle that
//           cimba_tpu_torch.models.mm1 and models.mmc share (one arrival
//           process, NS server processes, one FIFO): (1, false) is
//           mm1.build(record=False), (1, true) mm1.build() and
//           mmc.build(1), (c, true) mmc.build(c) for c = 2..4;
//   MG1     models.mg1.build(): mm1's cycle with a lognormal service
//           time (1 server, recording);
//   TANDEM  models.tandem.build(): three processes, two recording
//           queues, four guards, three summaries (wait, w1, w2), and
//           feedback routing at station 2;
//   SHOP    models.jobshop.build(): four processes (stage A, two of
//           stage B, maintenance), no object queue, a resource pool (the
//           crew), a buffer (the WIP between the stages) and a condition
//           observing the buffer (the backlog), both recording; the
//           toolkit's verbs (pool acquire and release, buffer get and
//           put, condition wait and signal) are compiled in for the
//           families that have them (`if constexpr`), templates on a
//           compile-time pool, buffer and condition, so the other
//           instances keep their code and registers;
//   GEN     any other spec over the ported toolkit: a family generated
//           from the spec's traced blocks (cimba_tpu_torch/core/emit.py
//           writes Gen<R>, included with -DCIMBA_GEN_HEADER; its blocks
//           draw inline through samplers.cuh, with no converged draw).
//           Its own rules, compiled in for it alone: the priority queues
//           (h_pq_put<Q>, h_pq_get<Q> and the readers pq_length<Q>,
//           pq_position<Q>, their slots in device memory, searched
//           through live-slot masks, M::PMASK), a block's
//           timer_add (an insert into the general event table) and
//           timers_clear (a pattern cancel), interrupt (the target's
//           abort, then a wake with the signal), the abort's cleanup on
//           a non-SUCCESS wake of a pended process (ABORT: the pool
//           rollback and the buffer's partial report) and the wakes'
//           full signals (WSIG: a column, not the packed word's bit);
//           binary resources (NR: h_acquire<RID, FUSED>,
//           h_preempt<RID, FUSED>, release_resource<RID>, their drop at
//           an end), the pool preempt's mug (MUG: h_pool<K, true,
//           FUSED>, its victims kicked through at_pid), a block's
//           stop_process (stop_at<T>), a block's schedule of a user
//           event (schedule_event), the dispatch of user events to
//           the family's handlers (NH: handler<K>) and a block's spawn
//           of a pool type (spawn_pool<T>, the pool's pids compile-time);
//           the waits on a process and on an event (M::WAITP, M::WAITE,
//           which the emitter sets where a block may return the wait:
//           h_wait_proc, h_wait_evt, each process's awaited pid and
//           handle in registers or, past the register limit, shared
//           columns; the exit's wake of its waiters in pid order; the
//           dispatch's scan of the event waiters before the action, its
//           stale arm, and the liveness term of a waiter stranded by a
//           cancel that drained the tables) and the event-handle API on
//           the general table (event_cancel<EAGER>, event_reschedule,
//           event_reprioritize, pattern_cancel and the readers ev_valid,
//           ev_time, ev_prio, pattern_count, pattern_find), priority_set,
//           the priority queue's pq_cancel<Q> and pq_reprioritize<Q> and
//           the object queue's queue_position<Q>.
//           Past the register limits (M::BIG, M::GBIG, which the
//           emitter decides) a generated family keeps each
//           process's wake and packed word in shared-memory columns
//           (Col), stores every packed field back, reaches a kick's,
//           stop's or spawn's target by its run-time pid, and takes its
//           columns in dynamic shared memory (Smem, M::DYN); past the
//           guards' limit their seq counters are a column too.
// The TPU kernel re-evaluates any model's traced step; here the
// hand-written families restate their blocks and every other spec's are
// emitted from its trace by the host loop (core/kernel_run.py).
//
// What bounds it on this card.  Each event is one serial chain of
// dependent operations (the pick, a 20-round Threefry block, a log1p,
// the command, a Pébay merge for a service or a record), and the lanes
// of a warp sit in different blocks, so the warp issues each block's
// code once for each branch it takes.  With ~1,000 lanes on each SM the
// SM's issue slots, not the lane's latency, set the pace: the time is
// the instructions a warp issues per event.  That holds for the
// hand-written families.  A generated instance holds 4-16 warps on an
// SM (PERF.md: 128-255 registers a thread, or 26-55 KB of shared
// columns a block of 32 lanes), too few to hide a lane's serial chain:
// its loads from the lane's rows of device memory (a warp's 32 lanes
// read 32 rows E x 4-8 B apart, 32 sectors a load), its Threefry rounds
// and log1p; there the latency of that chain sets the pace, and a
// search that walks a table's slots one load after another is the
// longest link (design points 4 and 6).  What the design does:
//
// 1. The lane's hot state lives in registers, with no local-memory
//    frame: the clock, the counter, the dense wakes and the processes'
//    small fields, the queues' heads and sizes, the model's parameters.
//    Every per-process register field is an array [NP] indexed only by
//    compile-time constants: a read by a run-time pid is an unrolled
//    select (pick), a write an unrolled predicated move (put); the same
//    holds for the per-queue fields [NQ].  The state is a plain struct
//    handled by inlined free functions, so nothing takes its address.
//    What the blocks only compare or clamp is packed in one word a
//    process (pc, status, pend_tag, pend_guard, wakes.sig), mapped on
//    load to a value that reads the same, and stored back only where it
//    was written (a bit a field and process in one mask).  The cold part
//    (the summaries, the queue-length accumulators, a pended command's
//    payload, got, ilocal 0, pend_seq, prio) lives in shared-memory
//    columns of the block, one a thread, where a run-time pid costs one
//    access.  pend_f2 is written only with 0, by a block's command that
//    pends, which a bit of the mask records; so is pend_i (the queue id)
//    where the model has one queue or none, and where it has two it is a
//    cold column; the job shop keeps pend_f2 (a pended claim's holding
//    before the call, a transfer's total) and its processes' pool
//    holdings in cold columns of their own; exit_sig is written through
//    to memory by the exit.  The row
//    addresses are computed where they are used from a lane index the
//    compiler cannot see through (opaque), not kept live across the event
//    loop.  The launch bounds (Model::minb) give each instance the least
//    register cap under which it does not spill.
// 2. The general event table's minimum is cached.  These models start
//    with the table empty (loop.init_sim puts the process starts in the
//    dense wakes) and never schedule into it, yet the pick and the
//    liveness check scanned all its E slots every event.  Now each lane
//    scans its slots once at chunk start and keeps the minimum's time and
//    slot and whether any slot is finite (the slot's prio and seq are
//    read on a tie with a wake, its subject and argument on a pop); it
//    scans again only after the kernel writes the table (a pop of a
//    general-table event, or an exit that cancels a timer).
//    E stays a run-time value: mm1.build() (E = 1) and mmc.build(1)
//    (E = 10) share an instance.
// 3. One warp-converged draw per event.  Right after the pick the lane
//    computes the Threefry block at its current counter and the variate
//    the event's first drawing block will take, in code all lanes of the
//    warp run together (pinned there, so the compiler cannot sink it into
//    the branches).  The variate's kind follows the event's subject (and,
//    in tandem, the subject's pc): the standard exponential
//    -log1p(-u) (times the block's mean), the lognormal exp(mu + sigma
//    sqrt2 erf_inv(clip(2u - 1))) of mg1's server, or tandem's routing
//    uniform.  mg1's two kinds share one log1p (its argument is -u or
//    -x^2), so a warp of arrivals and services issues it once.  A block
//    that draws advances the counter; one that does not leaves it alone.
//    Threefry is counter-based, so this is exact; a later draw of the same
//    event (tandem's s2_take after s2_cycle's uniform; no other reachable
//    state of these models makes one, tests/test_torch_queue_invariants.py
//    and tests/test_torch_network_invariants.py) takes a fresh block
//    inline.  One apply serves the retried command and a block's, so the
//    handlers (and the record's merge) are issued once for both kinds of
//    lane.
// 4. A generated family's searches visit only the live slots.  At chunk
//    start each lane derives a mask of its general table's slots whose
//    time is not +inf (M::EMASK, where a block inserts into the table)
//    and of each priority queue's live slots (M::PMASK); every write
//    keeps them current.  A first free slot is the lowest clear bit, a
//    count the bits set, and the minimum, best and position searches
//    one pass over the set bits, ascending, on the lexicographic key
//    the linear scans used (time, prio desc, seq, slot; priority desc
//    with the amax's NaN, seq, slot), so every result is the same.  The
//    masks are shared columns (ColdMask: register words kept a stack
//    frame where a mask took two or more).  The table's size is the
//    header's (M::ECAP); a table past 128 slots keeps the walk.  No
//    writer stores a time that is -inf or NaN (an insert or a
//    reschedule refuses a time that is not finite, a pop or a cancel
//    writes +inf), so the set slots are those with a finite time and a
//    clear one is free.
// 5. The launch shape is the emitter's (core/emit.py launch_plan): a
//    small family asks for 16 warps an SM (128 registers), the others 8
//    (255), which the measured cells justify.
//
// What is left: the ring stays lane-first in device memory (a lane-last
// ring would not coalesce either, since each lane's head differs; the
// few slots near the head stay in L2); the Pébay merge's divisions are
// kept as they are, since the result must equal the plain engine's bit
// for bit; and lanes that finish early leave their warp's slots idle
// until the chunk's longest lane ends.
//
// Built with --fmad=false so float results follow the plain PyTorch
// engine's separately rounded multiplies and adds.
//
// What one lane computes: exactly what cimba_tpu.core.loop.make_step
// computes for the specs of cimba_tpu.models.mm1.build,
// cimba_tpu.models.mmc.build, cimba_tpu.models.mg1.build and
// cimba_tpu.models.tandem.build (and their ports): the (time, prio desc,
// seq) pick over the dense wake table and the general event table with
// the lowest index winning ties; the model's blocks with one counter tick
// per draw; the fused put_hold/get_hold verbs; the guard pend on a full
// or empty queue (the pended command keeps its pre-drawn duration in
// pend_f3), the best waiter by (prio desc, pend_seq asc, pid asc) and the
// SUCCESS-wake retry; the queue-length record at (clock, size after the
// verb); the error codes; api.stop; and the n_events count.  The order of
// every state write follows the reference, because wake seqs are assigned
// in that order and decide ties: a successful get signals its queue's
// rear guard, then its front guard (the cascade to the next waiting
// server), and only then arms its own fused hold; a put signals its
// queue's front guard (in tandem, server 1's put into q2 wakes server 2,
// server 2's feedback put into q1 wakes server 1).  In the job shop a
// buffer transfer signals the other side's guard on any progress, then its
// own side's on completion only, then arms its fused hold; a pool acquire
// signals the pool's guard only on success, then arms its hold; a signal
// of a buffer guard also signals the condition (observer forwarding),
// which wakes its satisfied waiters in pid order after the guard's own.
// A resume's chain is bounded at MAX_CHAIN = 1024 commands, the
// reference's XLA-path rule (cimba_tpu/core/loop.py), not its kernel
// mode's spec.max_chain (16): the parity tests hold the port against
// make_run, and no chain of these models is longer than two commands
// (tests/test_torch_network_invariants.py,
// tests/test_torch_jobshop_invariants.py), so the two rules agree here.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "erfinv.cuh"
#include "horizon.cuh"
#include "samplers.cuh"
#include "summary.cuh"
#include "threefry.cuh"
#include "trig.cuh"

namespace cimba {
namespace queue {

constexpr int MAX_CHAIN = 1024;

// command tags, statuses, signals, kinds, error codes: the reference's
constexpr int C_HOLD = 0, C_EXIT = 1, C_JUMP = 2, C_PUT = 3, C_GET = 4;
constexpr int C_ACQUIRE = 5, C_RELEASE = 6, C_PREEMPT = 7;
constexpr int C_POOL_ACQ = 8, C_POOL_REL = 9, C_BUF_GET = 10,
              C_BUF_PUT = 11, C_PQ_PUT = 12, C_PQ_GET = 13, C_COND_WAIT = 14;
constexpr int C_WAIT_PROC = 15, C_POOL_PRE = 16, C_WAIT_EVT = 17;
constexpr int C_PUT_HOLD = 18, C_GET_HOLD = 19, C_ACQ_HOLD = 20,
              C_PRE_HOLD = 21, C_POOL_ACQ_HOLD = 22, C_POOL_PRE_HOLD = 23,
              C_BUF_GET_HOLD = 24, C_BUF_PUT_HOLD = 25, C_PQ_PUT_HOLD = 26,
              C_PQ_GET_HOLD = 27, N_COMMANDS = 28;
constexpr int NO_PEND = -1, SUCCESS = 0, PREEMPTED = -1, STOPPED = -3,
              CANCELLED = -4, RUNNING = 1, FINISHED = 2;
constexpr int K_TIMER = 1, N_KINDS = 2;
constexpr int ERR_EVENT_OVERFLOW = 1, ERR_CHAIN_RUNAWAY = 3, ERR_USER = 4,
              ERR_BAD_RELEASE = 5;
constexpr int32_t I32_MIN = INT32_MIN, I32_MAX = INT32_MAX;

// model families (the kernel's template argument; each has its C entry
// below)
constexpr int F_MM = 0, F_MG1 = 1, F_TANDEM = 2, F_SHOP = 3, F_GEN = 4;

// Sim leaves in the reference's jax.tree.leaves order, up to the queues;
// the eleven queues.acc leaves (A_N..A_STARTED) exist only in a recording
// Sim.  The user leaves follow from U0 (the model's, in sorted key
// order), then the four tail leaves (DONE, ERR, N_EVENTS,
// BOUNDARY_PENDING).
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
  U0
};
constexpr int N_ACC = A_STARTED - A_N + 1;
constexpr int DONE = 0, ERR = 1, N_EVENTS = 2, N_TAIL = 4;  // after the user
// the pointer array's room: a generated family's Sim (tandem's, the
// widest hand-written one, has U0 + 29 + N_TAIL = 83 leaves), its t_stop
// leaf counted where it carries one (core/emit.py refuses a Sim past it,
// core/kernel_run.py a launch whose t_stop leaf would pass it)
constexpr int MAX_LEAVES = 128;

// The job shop's Sim has no queue leaves: from Q_ITEMS on come the
// pool's (level, held [NP], held_seq [NP], next_seq, and its StepAccum's
// eleven), then the buffer's (level and its StepAccum's eleven), then the
// user leaves from SHOP_U0.
enum ShopLeaf {
  P_LEVEL = Q_ITEMS, P_HELD, P_HELD_SEQ, P_NEXT_SEQ, P_ACC,
  B_LEVEL = P_ACC + N_ACC, B_ACC,
  SHOP_U0 = B_ACC + N_ACC
};

// a leaf's position in the pointer array of the model's Sim: a
// non-recording queue model's has no queues.acc leaves; the job shop's
// positions are its own (ShopLeaf)
template <class M>
__host__ __device__ constexpr int at(int k) {
  if constexpr (M::GEN) return k;  // a generated family's own positions
  return (!M::RECORD && !M::SHOP && k > A_STARTED) ? k - N_ACC : k;
}

// one slot past the leaves: run_lane reads the t_stop slot, n_base_leaves,
// whatever the horizon mode, and a Sim of MAX_LEAVES leaves without one
// finds it null there
struct Ptrs {
  void* p[MAX_LEAVES + 1];
};

// static layout of one lane's tables; per queue its capacity and guards;
// the job shop's pool and buffer capacities and its blocks' build
// constants
struct Shape {
  int event_cap;   // general event table slots
  int ring_width;  // queue ring slots per lane and queue (queue_cap_max)
  int queue_cap[2];
  int front[2];    // guard ids
  int rear[2];
  int n_ilocals;
  double pool_cap = 0.0, buf_cap = 0.0, backlog = 0.0, b_slow = 0.0;
};

// the kinds of variate a block draws: the standard exponential (the block
// multiplies by its mean), the lognormal of the lane's (ln_mu, ln_sigma),
// and uniform01
constexpr int K_EXP = 0, K_LOGN = 1, K_UNIF = 2;

// a command as the blocks issue it; q is the queue id (pend_i).  pend_f2
// is 0 in every command of the queue models and no handler of theirs
// reads it; the job shop's pended pool claim keeps the holding before
// the call there, a pended buffer transfer its total
template <typename R>
struct Cmd {
  int32_t tag;
  R f, f3;
  int32_t next_pc;
  int32_t q;
  R f2 = R(0);
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

// keep a value's computation where it stands: the converged draw must
// not be sunk into the blocks that use it
__device__ __forceinline__ void pin(float& x) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+f"(x));
#endif
}
__device__ __forceinline__ void pin(double& x) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+d"(x));
#endif
}

// jnp.maximum(x, 0): NaN propagates
template <typename R>
__device__ __forceinline__ R nanmax0(R x) {
  return (x != x || x > R(0)) ? x : R(0);
}

// torch.minimum(x, y): NaN propagates
template <typename R>
__device__ __forceinline__ R nanmin(R x, R y) {
  return (x != x || x < y) ? x : y;
}

// f(q) for q = 0 .. N - 1: unrolled (a register array's compile-time
// indices), or, where ROLL (the shared columns of M::BIG or M::GBIG), a
// loop: a chunk's load and store unrolled over 32
// processes' columns kept their addresses in registers, and a 32-process
// f64 family spilled.  An event's scans keep their own unrolled loops
// (through a lambda one small family's registers moved)
template <bool ROLL, int N, class F>
__device__ __forceinline__ void each(F&& f) {
  if constexpr (ROLL) {
#pragma unroll 1
    for (int q = 0; q < N; ++q) f(q);
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) f(q);
  }
}

// a register array read and written by a run-time index: unrolled over
// the compile-time indices, so the array never needs an address
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&a)[N], int i) {
  T v = a[0];
#pragma unroll
  for (int q = 1; q < N; ++q) v = i == q ? a[q] : v;
  return v;
}

template <int N, typename T>
__device__ __forceinline__ void put(T (&a)[N], int i, T v) {
#pragma unroll
  for (int q = 0; q < N; ++q)
    if (i == q) a[q] = v;
}

// In a family of M::BIG (M::GBIG) a lane's wakes and words (its guards'
// seq counters) live in the block's shared memory instead: a column a
// process ([NP][THREADS], as Cold's), reached through Col, read and
// written like the register array it replaces (a[q], pick, put), by any
// index with one access.  The emitter sets BIG past 10 processes and
// GBIG past 8 guards (core/emit.py REG_NP, REG_NG); below them the
// registers and their code are as they were.

template <typename T, int THREADS>
struct Col {
  T* base;  // this thread's element of row 0
  __device__ __forceinline__ T& operator[](int q) const {
    return base[q * THREADS];
  }
};

template <typename T, int TH>
__device__ __forceinline__ T pick(const Col<T, TH>& a, int i) {
  return a[i];
}

template <typename T, int TH>
__device__ __forceinline__ void put(Col<T, TH>& a, int i, T v) {
  a[i] = v;
}

// the small per-process fields, packed in a process's word (pc 8 bits,
// status 4, pend_tag 8, pend_guard 8, wakes.sig 4: offset and width in
// bits, each read sign-extended, so a guard id is at most 126), and the
// bits of the lane's `dirty` mask: bit f * NP + q when field f of
// process q was written here (F_BLOCK: q pended a block's command, which
// writes pend_f2 = 0, and pend_i = 0 where the model has one queue)
enum Field { F_PC, F_STATUS, F_TAG, F_GUARD, F_SIG, F_BLOCK };

__host__ __device__ constexpr int f_off(int f) {
  return f == F_PC ? 0 : f == F_STATUS ? 8 : f == F_TAG ? 12
         : f == F_GUARD ? 20 : 28;
}
__host__ __device__ constexpr int f_width(int f) {
  return f == F_STATUS || f == F_SIG ? 4 : 8;
}

__device__ __forceinline__ int32_t field(uint32_t word, int f) {
  return int32_t(word << (32 - f_off(f) - f_width(f))) >> (32 - f_width(f));
}

__device__ __forceinline__ uint32_t with(uint32_t word, int f, int32_t v) {
  const uint32_t m = ((1u << f_width(f)) - 1u) << f_off(f);
  return (word & ~m) | ((uint32_t(v) << f_off(f)) & m);
}

// a loaded process's fields in its word: a value outside its field reads
// the same in every use the blocks make of it (pc is clamped to a block,
// status and the wake's signal only compared with RUNNING and SUCCESS,
// pend_tag clamped to a command or NO_PEND, pend_guard compared with the
// queues' guards 0..NG-1), and a field is stored back only where it was
// written
template <int N_BLOCKS, int NG>
__device__ __forceinline__ uint32_t pack(int32_t pc, int32_t status,
                                         int32_t tag, int32_t guard,
                                         int32_t sig) {
  pc = pc < 0 ? 0 : (pc > N_BLOCKS - 1 ? N_BLOCKS - 1 : pc);
  status = status == RUNNING ? RUNNING : (status == FINISHED ? FINISHED : 0);
  tag = tag < NO_PEND ? 0 : (tag > N_COMMANDS - 1 ? N_COMMANDS - 1 : tag);
  guard = guard >= 0 && guard < NG ? guard : -1;
  sig = sig == SUCCESS ? SUCCESS : -1;
  uint32_t w = 0u;
  w = with(w, F_PC, pc);
  w = with(w, F_STATUS, status);
  w = with(w, F_TAG, tag);
  w = with(w, F_GUARD, guard);
  return with(w, F_SIG, sig);
}

// The cold part of a lane's state, in the block's shared memory: per
// field a column a thread ([field][thread], so a warp's accesses fall in
// distinct banks), read and written by a run-time pid with one access.
// The summaries are touched once a service, the pending command's
// payload on a pend or a retry, prio and pend_seq only for the
// candidates of a pick or a guard's wake.
template <typename R, class M>
struct Cold {
  static constexpr int NP = M::NP, T = M::THREADS;
  R sums[8 * M::NSUM][T];
  R pend_f[NP][T], pend_f3[NP][T], got[NP][T];
  int32_t pend_pc[NP][T], pend_seq[NP][T];
  int32_t prio[NP][T], produced[NP][T];
};

// the StepAccum rows (stats.timeseries) of a recording instance: a
// recording queue's length, touched once a put or get (row q), or the job
// shop's crew in use (row 0) and buffer level (row 1), touched once a
// verb of theirs: per row the summary's eight moments, last_t, last_v,
// and started (0 or 1)
template <typename R, class M, bool RECORD = (M::NACC > 0)>
struct ColdAcc {
  R acc[10 * M::NACC][M::THREADS];
  bool started[M::NACC][M::THREADS];
};

template <typename R, class M>
struct ColdAcc<R, M, false> {};

// a pended command's component id, where the model has more than one
// queue (or, in a generated family, any component)
template <class M, bool MANY = M::PEND_I>
struct ColdQ {
  int32_t pend_i[M::NP][M::THREADS];
};

template <class M>
struct ColdQ<M, false> {};

// the toolkit's columns: each process's holding of each pool (row k NP +
// p: held, held_seq) and pend_f2
template <typename R, class M, bool TOOLKIT = M::TOOLKIT>
struct ColdShop {
  static constexpr int NKA = M::NK > 0 ? M::NK : 1;
  R held[NKA * M::NP][M::THREADS], pend_f2[M::NP][M::THREADS];
  int32_t held_seq[NKA * M::NP][M::THREADS];
};

template <typename R, class M>
struct ColdShop<R, M, false> {};

// a generated family's columns: each process's wake signal in full (an
// interrupt's or a timer's reaches a block) and each priority queue's
// next seq
template <class M, bool WSIG = M::WSIG>
struct ColdSig {
  int32_t wsig[M::NP][M::THREADS];
  int32_t pq_next_seq[M::NPQ > 0 ? M::NPQ : 1][M::THREADS];
};

template <class M>
struct ColdSig<M, false> {};

// the columns of a family past the register limits: each process's wake
// time, wake seq and packed word (M::BIG), each guard's seq counter
// (M::GBIG)
template <typename R, class M, bool BIG = M::BIG>
struct ColdWake {
  R wt[M::NP][M::THREADS];
  int32_t wseq[M::NP][M::THREADS];
  uint32_t word[M::NP][M::THREADS];
};

template <typename R, class M>
struct ColdWake<R, M, false> {};

template <class M, bool GBIG = M::GBIG>
struct ColdG {
  int32_t gseq[M::NG][M::THREADS];
};

template <class M>
struct ColdG<M, false> {};

// each process's awaited pid and event handle (-1: none), in a family of
// M::BIG that waits (M::WAITP, M::WAITE)
template <class M, bool ON = M::BIG && (M::WAITP || M::WAITE)>
struct ColdAwait {
  int32_t apid[M::NP][M::THREADS], aevt[M::NP][M::THREADS];
};

template <class M>
struct ColdAwait<M, false> {};

// each process's awaited pid (P) and event handle (E) of a lane, where
// the family waits: a base of State, empty (and so no room in it) where
// the family has neither wait
template <class Wa, bool P, bool E>
struct Awaits {};
template <class Wa>
struct Awaits<Wa, true, false> {
  Wa apid;
};
template <class Wa>
struct Awaits<Wa, false, true> {
  Wa aevt;
};
template <class Wa>
struct Awaits<Wa, true, true> {
  Wa apid, aevt;
};

// A table's live-slot mask (a generated family's EMASK, PMASK): bit i of
// word i / 32 is set where slot i is live, so a search visits only the
// live slots, a free slot is the lowest clear bit (__ffs of the
// complement) and a count is __popc of the words.  N slots take W words;
// a table past 128 slots keeps the linear scan (the emitter's choice).
template <int N>
struct Bits {
  static constexpr int W = N > 0 ? (N + 31) / 32 : 1;
  // the valid bits of word k
  __host__ __device__ static constexpr uint32_t valid(int k) {
    return (k < W - 1 || N % 32 == 0) ? ~0u : (1u << (N % 32)) - 1u;
  }
};

// f(i) for every set bit i of the W words a[OFF .. OFF + W), ascending:
// word K a compile-time index by recursion (an unrolled loop around the
// visits is not always unrolled)
template <int W, int OFF, int K = 0, class A, class F>
__device__ __forceinline__ void each_bit(const A& a, F&& f) {
  if constexpr (K < W) {
    uint32_t m = a[OFF + K];
    while (m != 0u) {
      const int b = __ffs(int(m)) - 1;
      m &= m - 1u;
      f(32 * K + b);
    }
    each_bit<W, OFF, K + 1>(a, f);
  }
}

// the lowest clear bit of an N-slot mask, N where every bit is set
template <int N, class A>
__device__ __forceinline__ int first_clear(const A& a, int off) {
  int slot = N;
#pragma unroll
  for (int k = Bits<N>::W - 1; k >= 0; --k) {
    const uint32_t z = ~a[off + k] & Bits<N>::valid(k);
    if (z != 0u) slot = 32 * k + __ffs(int(z)) - 1;
  }
  return slot;
}

template <int N, class A>
__device__ __forceinline__ int32_t popc(const A& a, int off) {
  int32_t n = 0;
#pragma unroll
  for (int k = 0; k < Bits<N>::W; ++k) n += __popc(a[off + k]);
  return n;
}

// bit i (a run-time slot) of the mask at word off set (on) or cleared
template <class A>
__device__ __forceinline__ void set_bit(A& a, int off, int i, bool on) {
  const uint32_t b = 1u << (i & 31);
  const int k = off + (i >> 5);
  a[k] = on ? (a[k] | b) : (a[k] & ~b);
}

// the masks' shared columns (M::EMASK, M::PMASK): the general table's
// words, then each priority queue's
template <class M, bool ON = M::EMASK || M::PMASK>
struct ColdMask {
  static constexpr int EW = M::EMASK ? Bits<M::ECAP>::W : 0;
  static constexpr int PW = M::PMASK ? M::NPQ * Bits<M::PQW>::W : 0;
  uint32_t words[EW + PW > 0 ? EW + PW : 1][M::THREADS];
};

template <class M>
struct ColdMask<M, false> {};

// every column of a family whose shared memory is dynamic (M::DYN): one
// block-wide struct carved from the launch's dynamic shared memory
template <typename R, class M>
struct Smem {
  Cold<R, M> cold;
  ColdAcc<R, M> cold_acc;
  ColdQ<M> cold_q;
  ColdShop<R, M> cold_shop;
  ColdSig<M> cold_sig;
  typename M::UCold ucold;
  ColdWake<R, M> wake;
  ColdG<M> g;
  ColdAwait<M> await_;
  ColdMask<M> mask;
};

// a lane's masks (a base of State, empty where the family has none),
// each a view of its ColdMask column: the general table's words
// em[0 .. EW), each priority queue q's words pm[q PW .. (q + 1) PW)
template <class Wm, bool E, bool P>
struct Masks {};
template <class Wm>
struct Masks<Wm, true, false> {
  Wm em;
};
template <class Wm>
struct Masks<Wm, false, true> {
  Wm pm;
};
template <class Wm>
struct Masks<Wm, true, true> {
  Wm em, pm;
};

// One lane's working state: the hot part in registers, the cold part in
// the block's shared memory.
template <typename R_, typename C_, class M_>
struct State
    : Awaits<std::conditional_t<M_::BIG, Col<int32_t, M_::THREADS>,
                                int32_t[M_::NP]>,
             M_::WAITP, M_::WAITE>,
      Masks<Col<uint32_t, M_::THREADS>, M_::EMASK, M_::PMASK> {
  using R = R_;
  using C = C_;
  using M = M_;
  static constexpr int NP = M::NP, NQ = M::NQ, NG = M::NG;
  static constexpr int NQA = NQ > 0 ? NQ : 1;  // register arrays' length
  static constexpr int NKA = M::NK > 0 ? M::NK : 1;
  static constexpr int NVA = M::NV > 0 ? M::NV : 1;
  static constexpr int NRA = M::NR > 0 ? M::NR : 1;
  static constexpr bool RECORD = M::RECORD;
  // past the register limits: the wakes and words, the guards' seqs in
  // shared columns (ColdWake, ColdG); no dirty mask, every packed field
  // stored back; pend_f2 and pend_i are columns (the emitter's TOOLKIT)
  static constexpr bool BIG = M::BIG, GBIG = M::GBIG;
  static_assert(!BIG || (M::TOOLKIT && M::PEND_I),
                "a family of BIG keeps pend_f2 and pend_i in columns");
  // the `dirty` mask: a bit a field and process
  using Dirty =
      std::conditional_t<(6 * NP <= 32), uint32_t, unsigned long long>;
  using Wt = std::conditional_t<BIG, Col<R, M::THREADS>, R[NP]>;
  using Wi = std::conditional_t<BIG, Col<int32_t, M::THREADS>, int32_t[NP]>;
  using Ww = std::conditional_t<BIG, Col<uint32_t, M::THREADS>, uint32_t[NP]>;
  using Gs = std::conditional_t<GBIG, Col<int32_t, M::THREADS>, int32_t[NG]>;

  Cold<R, M>* cold;  // the block's
  ColdAcc<R, M>* cold_acc;
  ColdQ<M>* cold_q;
  ColdShop<R, M>* cold_shop;
  ColdSig<M>* cold_sig;
  typename M::UCold* ucold;  // a generated family's user and local columns
  int t;             // this thread's column
  R clock;
  uint32_t k0, k1, lo, hi;
  int32_t next_seq;
  // dense wakes and the processes' small fields
  Wt wt;
  Wi wseq;
  Ww word;  // pc, status, pend_tag, pend_guard, wakes.sig
  Dirty dirty;
  Gs gseq;
  // the queues: heads and sizes here, the rings in device memory
  int32_t head[NQA], size[NQA];
  // the pools (their levels and grab counters) and the buffers' levels;
  // the job shop's maintenance_runs and stage B's mean work (work_mean *
  // b_slow)
  R pool_level[NKA], buf_level[NVA], b_mean;
  int32_t pool_next_seq[NKA], runs;
  // a generated family's binary resources: each one's holder (-1 free)
  int32_t holder[NRA];
  // user state: the model's real parameters, n_objects
  R par[M::NPAR];
  int32_t n_objects;
  bool done;
  int32_t err;
  C n_events;
  // the general event table's minimum (time asc, prio desc, seq asc,
  // lowest slot: its time and slot), and whether any slot holds a finite
  // time; the slot's other fields are read when needed
  R t_e;
  bool any_e;
  int32_t slot_e;
};

// a cold field of process p (or summary moment p) of this lane
#define COLD(s, f, p) ((s).cold->f[p][(s).t])
#define SCOL(s, f, p) ((s).cold_shop->f[p][(s).t])
#define UCOL(s, f, i) ((s).ucold->f[i][(s).t])
#define GCOL(s, f, i) ((s).cold_sig->f[i][(s).t])

// where a lane's rows live: the kernel's parameters and the lane
struct Where {
  const Ptrs& ps;
  const Shape& sh;
  int l;
};

// the lane index as a value the compiler cannot see through: a row
// address computed from it is computed where it is used, not kept in
// registers across the event loop
__device__ __forceinline__ int opaque(int x) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+r"(x));
#endif
  return x;
}

// a lane's row of a [L, n] leaf
template <typename T, class S>
__device__ __forceinline__ T* row(const Where& at_, int k, int n) {
  return static_cast<T*>(at_.ps.p[at<typename S::M>(k)]) +
         size_t(at_.l) * n;
}

// the model's user leaf at offset u, and tail leaf j
template <class M>
__device__ __forceinline__ constexpr int user(int u) { return M::U0 + u; }
template <class S>
__device__ __forceinline__ constexpr int tail(int j) {
  return S::M::U0 + S::M::N_USER + j;
}

template <class S>
__device__ __forceinline__ int32_t get(const S& s, int f, int p) {
  return field(pick(s.word, p), f);
}

// field f of process p written: its dirty bit (a family of BIG stores
// every packed field back)
template <class S>
__device__ __forceinline__ void mark(S& s, int f, int p) {
  if constexpr (!S::BIG) s.dirty |= typename S::Dirty(1) << (f * S::NP + p);
}

template <class S>
__device__ __forceinline__ void set(S& s, int f, int p, int32_t v) {
  if constexpr (S::BIG) {
    s.word[p] = with(s.word[p], f, v);
  } else {
#pragma unroll
    for (int q = 0; q < S::NP; ++q)
      if (p == q) s.word[q] = with(s.word[q], f, v);
  }
  mark(s, f, p);
}

template <class S>
__device__ __forceinline__ void set_err(S& s, int32_t code) {
  if (s.err == 0) s.err = code;
}

// summary j of the model's user state (stats.summary.add of one sample
// of weight 1); returns the new summary
template <class S>
__device__ __forceinline__ Sum<typename S::R> sum_add(S& s, int j,
                                                      typename S::R x) {
  using R = typename S::R;
  const Sum<R> a{COLD(s, sums, 8 * j), COLD(s, sums, 8 * j + 1),
                 COLD(s, sums, 8 * j + 2), COLD(s, sums, 8 * j + 3),
                 COLD(s, sums, 8 * j + 4), COLD(s, sums, 8 * j + 5),
                 COLD(s, sums, 8 * j + 6), COLD(s, sums, 8 * j + 7)};
  const Sum<R> m = add(a, x, R(1));
  COLD(s, sums, 8 * j) = m.n;
  COLD(s, sums, 8 * j + 1) = m.w;
  COLD(s, sums, 8 * j + 2) = m.mn;
  COLD(s, sums, 8 * j + 3) = m.mx;
  COLD(s, sums, 8 * j + 4) = m.m1;
  COLD(s, sums, 8 * j + 5) = m.m2;
  COLD(s, sums, 8 * j + 6) = m.m3;
  COLD(s, sums, 8 * j + 7) = m.m4;
  return m;
}

// The variate of the Threefry block (b0, b1) of kind `kind`
// (cimba_tpu_torch/random/distributions.py): std_exponential
// -log1p(-u53); lognormal exp(mu + sigma * (sqrt2 * erf_inv(clip(2 u53 -
// 1)))) with the lane's (ln_mu, ln_sigma); uniform01.  The exponential and
// erf_inv's w = -log1p(x * -x) share one log1p.  Only the kinds a model
// draws are compiled in.
template <class S>
__device__ __forceinline__ typename S::R variate(const S& s, int kind,
                                                 uint32_t b0, uint32_t b1) {
  using R = typename S::R;
  using M = typename S::M;
  const R u = u53_of(b0, b1, R(0));
  R arg = -u;
  R xc = R(0);
  if constexpr (M::LOGN) {
    // the clip one step of the dtype inside (-1, 1)
    constexpr double tiny = (sizeof(R) == 4 ? 0x1p-23 : 0x1p-52) / 2.0;
    const R lo = R(-1.0 + tiny), hi = R(1.0 - tiny);
    xc = R(2) * u - R(1);
    xc = xc < lo ? lo : (xc > hi ? hi : xc);
    if (kind == K_LOGN) arg = xc * -xc;
  }
  const R l = log1p_of(arg);
  R v = -l;
  if constexpr (M::UNIF) {
    if (kind == K_UNIF) v = u01_of(b1, R(0));
  }
  if constexpr (M::LOGN) {
    if (kind == K_LOGN) {
      const R z = R(1.4142135623730951) * erf_inv_w(xc, v);
      v = exp_of(s.par[M::LN_MU] + s.par[M::LN_SIGMA] * z);
    }
  }
  return v;
}

// the general table's slots: the header's count where its mask is
// compiled in (M::EMASK), else the run-time shape (mm1.build() and
// mmc.build(1) share an instance; a generated family's walks over a
// compile-time count were unrolled into 16-64 copies, up to 255
// registers and 5 % slower, PERF.md)
template <class S>
__device__ __forceinline__ int ecap(const Where& w) {
  if constexpr (S::M::EMASK) {
    return S::M::ECAP;
  } else {
    return w.sh.event_cap;
  }
}

// the general table's minimum, read from device memory (chunk start,
// and after the kernel wrote the table).  With the table's mask
// (M::EMASK) one pass over the slots whose time is not +inf, ascending,
// keeps the lexicographic best (time asc, then prio desc and seq asc,
// read only on a tie of times, then the lowest slot): the same slot and
// flags as the four passes over every slot
template <class S>
__device__ __forceinline__ void scan_table(S& s, const Where& w) {
  using R = typename S::R;
  const int E = ecap<S>(w);
  const R* time = row<R, S>(w, EV_TIME, E);
  const int32_t* prio = row<int32_t, S>(w, EV_PRIO, E);
  const int32_t* seq = row<int32_t, S>(w, EV_SEQ, E);
  if constexpr (S::M::EMASK) {
    R t = inf_of<R>();
    bool any = false, have = false;
    int32_t slot = 0, bp = 0, bs = 0;
    each_bit<Bits<S::M::ECAP>::W, 0>(s.em, [&](int i) {
      const R x = time[i];
      any = any || finite(x);
      if (x < t) {
        t = x;
        slot = i;
        have = false;
      } else if (x == t) {
        if (!have) {
          bp = prio[slot];
          bs = seq[slot];
          have = true;
        }
        const int32_t pi = prio[i], si = seq[i];
        if (pi > bp || (pi == bp && si < bs)) {
          bp = pi;
          bs = si;
          slot = i;
        }
      }
    });
    s.t_e = t;
    s.any_e = any;
    s.slot_e = finite(t) ? slot : 0;
    return;
  }
  R t = inf_of<R>();
  bool any = false;
  for (int i = 0; i < E; ++i) {
    const R x = time[i];
    any = any || finite(x);
    t = x < t ? x : t;
  }
  int32_t slot = 0;
  if (finite(t)) {
    int32_t p = I32_MIN, sq = I32_MAX;
    for (int i = 0; i < E; ++i)
      if (time[i] == t && prio[i] > p) p = prio[i];
    for (int i = 0; i < E; ++i)
      if (time[i] == t && prio[i] == p && seq[i] < sq) sq = seq[i];
    for (int i = 0; i < E; ++i)
      if (time[i] == t && prio[i] == p && seq[i] == sq) {
        slot = i;
        break;
      }
  }
  s.t_e = t;
  s.any_e = any;
  s.slot_e = slot;
}

// general-table slot i's mask bit: set where the kernel writes a finite
// time, cleared where it writes +inf (M::EMASK; nothing else)
template <class S>
__device__ __forceinline__ void ev_mark(S& s, int i, bool on) {
  if constexpr (S::M::EMASK) set_bit(s.em, 0, i, on);
}

// f(i) for each slot i of the general table that may hold a finite time,
// ascending: the slots of the mask (M::EMASK), else every slot
template <class S, class F>
__device__ __forceinline__ void each_slot(const S& s, const Where& w,
                                          F&& f) {
  if constexpr (S::M::EMASK) {
    each_bit<Bits<S::M::ECAP>::W, 0>(s.em, f);
  } else {
    const int E = ecap<S>(w);
    for (int i = 0; i < E; ++i) f(i);
  }
}

// the first free slot of the general table (a free slot holds +inf or
// -inf), E where none: the mask's lowest clear bit (M::EMASK), else a
// walk
template <class S>
__device__ __forceinline__ int free_slot(const S& s, const Where& w) {
  using R = typename S::R;
  if constexpr (S::M::EMASK) {
    return first_clear<S::M::ECAP>(s.em, 0);
  } else {
    const int E = ecap<S>(w);
    const R* time = row<R, S>(w, EV_TIME, E);
    for (int i = 0; i < E; ++i)
      if (time[i] == inf_of<R>() || time[i] == -inf_of<R>()) return i;
    return E;
  }
}

// queue Q's slot rows in device memory (each [PQW], lane-first)
template <typename T, class S>
__device__ __forceinline__ T* pq_row(const Where& w, int leaf, int q) {
  using M = typename S::M;
  return row<T, S>(w, leaf, M::NPQ * M::PQW) + q * M::PQW;
}

// the words of an N-slot mask from live(i) (word K a compile-time index,
// as in each_bit)
template <int N, int OFF, int K = 0, class A, class G>
__device__ __forceinline__ void fill_bits(A& a, G&& live) {
  if constexpr (K < Bits<N>::W) {
    uint32_t m = 0u;
    for (int b = 0; b < 32 && 32 * K + b < N; ++b)
      m |= live(32 * K + b) ? 1u << b : 0u;
    a[OFF + K] = m;
    fill_bits<N, OFF, K + 1>(a, live);
  }
}

// the masks from the lane's leaves at chunk start: a general-table slot
// is set where its time is not +inf (the same as finite on every state
// the kernel or the engine writes; this test leaves park2 f64 at 255
// registers with no spill, where finite() spilled 28 B), a
// priority-queue slot where its live flag is
template <class S, int Q = 0>
__device__ __forceinline__ void load_masks(S& s, const Where& w) {
  using R = typename S::R;
  using M = typename S::M;
  if constexpr (M::EMASK && Q == 0) {
    const R* time = row<R, S>(w, EV_TIME, M::ECAP);
    fill_bits<M::ECAP, 0>(s.em,
                          [&](int i) { return time[i] != inf_of<R>(); });
  }
  if constexpr (M::PMASK && Q < M::NPQ) {
    const bool* live = pq_row<bool, S>(w, M::L_PQ_LIVE, Q);
    fill_bits<M::PQW, Q * Bits<M::PQW>::W>(s.pm,
                                            [&](int j) { return live[j]; });
    load_masks<S, Q + 1>(s, w);
  }
}

// timeseries.step_record(acc, clock, v) on queue q's accumulator: the
// previous length is credited with the time since the last record; a
// zero-length segment leaves the summary as it was
#define ACC(s, q, i) ((s).cold_acc->acc[10 * (q) + (i)][(s).t])

template <class S>
__device__ __forceinline__ void record(S& s, int q, typename S::R v) {
  using R = typename S::R;
  const R dur = nanmax0(s.clock - ACC(s, q, 8));
  const Sum<R> a{ACC(s, q, 0), ACC(s, q, 1), ACC(s, q, 2), ACC(s, q, 3),
                 ACC(s, q, 4), ACC(s, q, 5), ACC(s, q, 6), ACC(s, q, 7)};
  const Sum<R> upd = add(a, ACC(s, q, 9), dur);
  if (dur > R(0)) {
    ACC(s, q, 0) = upd.n;
    ACC(s, q, 1) = upd.w;
    ACC(s, q, 2) = upd.mn;
    ACC(s, q, 3) = upd.mx;
    ACC(s, q, 4) = upd.m1;
    ACC(s, q, 5) = upd.m2;
    ACC(s, q, 6) = upd.m3;
    ACC(s, q, 7) = upd.m4;
  }
  ACC(s, q, 8) = s.clock;
  ACC(s, q, 9) = v;
  s.cold_acc->started[q][s.t] = true;
}

// torch.sin (SIN) or torch.cos of a generated block: trig.cuh's
// frame-free sincos_of with the library's slow path for |x| >= 105615 in
// f32 (2^31 in f64) in registers, bit for bit CUDA's own for every
// argument
template <bool SIN, typename R>
__device__ __forceinline__ R trig_of(R x) {
  R c, sn;
  sincos_of<true>(x, c, sn);
  return SIN ? sn : c;
}

// one Threefry block at the lane's counter, which then advances (a draw
// of a generated block: random.bits.next_bits64)
template <class S>
__device__ __forceinline__ void draw_bits(S& s, uint32_t& b0, uint32_t& b1) {
  threefry2x32(s.k0, s.k1, s.lo, s.hi, b0, b1);
  s.lo += 1u;
  if (s.lo == 0u) s.hi += 1u;
}

// arm a SUCCESS wake of process p at t (every wake these blocks arm)
template <class S>
__device__ __forceinline__ void schedule_wake(S& s, int p, typename S::R t) {
  if (finite(t)) {
    put(s.wt, p, t);
    if constexpr (S::M::WSIG) {
      GCOL(s, wsig, p) = SUCCESS;
    } else {
      set(s, F_SIG, p, SUCCESS);
    }
    put(s.wseq, p, s.next_seq);
    s.next_seq += 1;
  } else {
    set_err(s, ERR_EVENT_OVERFLOW);
  }
}

// a wake of process p now with signal sig, the next seq (a kick's, a
// waiter's: a generated family's, whose wake signals are a column)
template <class S>
__device__ __forceinline__ void wake_sig(S& s, int p, int32_t sig) {
  if (finite(s.clock)) {
    put(s.wt, p, s.clock);
    GCOL(s, wsig, p) = sig;
    put(s.wseq, p, s.next_seq);
    s.next_seq += 1;
  } else {
    set_err(s, ERR_EVENT_OVERFLOW);
  }
}

// wake the best waiter of guard gid: highest live prio, then lowest
// pend_seq, then lowest pid
template <class S>
__device__ __forceinline__ void guard_signal(S& s, int gid) {
  bool found = false;
  int32_t bp = I32_MIN, bs = I32_MAX;
  int pid = 0;
#pragma unroll
  for (int q = 0; q < S::NP; ++q)
      if (field(s.word[q], F_GUARD) == gid) {
        const int32_t pq = COLD(s, prio, q), sq = COLD(s, pend_seq, q);
        if (!found || pq > bp || (pq == bp && sq < bs)) {
          found = true;
          bp = pq;
          bs = sq;
          pid = q;
        }
      }
  if (!found) return;
  set(s, F_GUARD, pid, -1);
  schedule_wake(s, pid, s.clock);
}

template <class S>
__device__ __forceinline__ void guard_wait(S& s, int p, int gid,
                                           const Cmd<typename S::R>& c,
                                           bool is_retry) {
  const int32_t so = is_retry ? COLD(s, pend_seq, p) : -1;
  const int32_t fresh = pick(s.gseq, gid);
  const int32_t seq = so >= 0 ? so : fresh;
  if (seq == fresh) put(s.gseq, gid, fresh + 1);
  set(s, F_TAG, p, c.tag);
  COLD(s, pend_f, p) = c.f;
  COLD(s, pend_f3, p) = c.f3;
  if constexpr (S::M::TOOLKIT) SCOL(s, pend_f2, p) = c.f2;
  if constexpr (S::M::PEND_I) s.cold_q->pend_i[p][s.t] = c.q;
  COLD(s, pend_pc, p) = c.next_pc;
  set(s, F_GUARD, p, gid);
  COLD(s, pend_seq, p) = seq;
  set(s, F_PC, p, c.next_pc);
  // a retry re-pends the pended command as it was: its pend_f2 (and
  // pend_i) stay; a block's command writes its 0s (the job shop's
  // pend_f2 is the column written above)
  if (!is_retry) mark(s, F_BLOCK, p);
}

template <class S>
__device__ __forceinline__ bool any_waiting(const S& s, int gid) {
  bool any = false;
#pragma unroll
  for (int q = 0; q < S::NP; ++q)
      any = any || field(s.word[q], F_GUARD) == gid;
  return any;
}

// A component id a command names at run time, dispatched to the verb's
// instance for that id (a compile-time constant: a run-time index into
// a per-component register array once went wrong on the card, the
// tandem network's queue), clamped into [0, N) as the plain engine's
// gather clamps it.
template <int J, int N, class F>
__device__ __forceinline__ auto by_id(int i, F&& f) {
  if constexpr (J + 1 >= N) {
    return f(std::integral_constant<int, J>{});
  } else {
    if (i <= J) return f(std::integral_constant<int, J>{});
    return by_id<J + 1, N>(i, f);
  }
}

// f(q) for process p of [LO, HI): q a compile-time pid through by_id
// where the processes' wakes and words are registers, p itself where
// they are shared columns (S::BIG), which any index reaches in one access
template <class S, int LO = 0, int HI = S::NP, class F>
__device__ __forceinline__ void at_pid(int p, F&& f) {
  if constexpr (S::BIG) {
    f(p);
  } else {
    by_id<LO, HI>(p, [&](auto q) {
      f(decltype(q)::value);
      return 0;
    });
  }
}

// (head + size) % cap and (head + 1) % cap, without a division in range
__device__ __forceinline__ int32_t wrap(int32_t x, int32_t cap) {
  return uint32_t(x) < uint32_t(cap) ? x
         : (x >= cap && x - cap < cap) ? x - cap
                                      : x % cap;
}

// put/get and their fused *_hold twins on queue Q (a compile-time index,
// so the queue's registers and shape are read without a run-time
// index), in the reference's order; returns "yielded"
template <int Q, class S>
__device__ __forceinline__ bool h_queue_at(S& s, const Where& w, int p,
                                           const Cmd<typename S::R>& c,
                                           int tag, bool is_retry) {
  using R = typename S::R;
  const bool is_put = tag == C_PUT || tag == C_PUT_HOLD;
  const bool fused = tag == C_PUT_HOLD || tag == C_GET_HOLD;
  using M = typename S::M;
  int cap, front, rear;
  if constexpr (M::GEN) {
    cap = M::q_cap(Q), front = M::q_front(Q), rear = M::q_rear(Q);
  } else {
    cap = w.sh.queue_cap[Q], front = w.sh.front[Q], rear = w.sh.rear[Q];
  }
  const int own = is_put ? rear : front;
  const bool may = is_retry || !any_waiting(s, own);
  const bool blocked =
      (is_put ? s.size[Q] >= cap : s.size[Q] <= 0) || !may;
  if (!blocked) {
    R* ring = row<R, S>(w, Q_ITEMS, S::NQ * w.sh.ring_width) +
              Q * w.sh.ring_width;
    if (is_put) {
      ring[wrap(s.head[Q] + s.size[Q], cap)] = c.f;
      s.size[Q] += 1;
    } else {
      COLD(s, got, p) = ring[s.head[Q]];
      s.head[Q] = wrap(s.head[Q] + 1, cap);
      s.size[Q] -= 1;
    }
    if constexpr (M::GEN) {
      if constexpr (M::q_rec(Q)) record(s, M::acc_q(Q), R(s.size[Q]));
    } else if constexpr (S::RECORD) {
      record(s, Q, R(s.size[Q]));
    }
    if (!is_put) guard_signal(s, rear);
    guard_signal(s, front);
    if (fused) schedule_wake(s, p, s.clock + nanmax0(c.f3));
  }
  set(s, F_PC, p, c.next_pc);
  if (blocked) guard_wait(s, p, own, c, is_retry);
  return blocked || fused;
}

// the verb on the command's queue, its id clamped into range as the
// plain engine's gather clamps it
template <class S>
__device__ __forceinline__ bool h_queue(S& s, const Where& w, int p,
                                        const Cmd<typename S::R>& c, int tag,
                                        bool is_retry) {
  if constexpr (S::M::GEN) {
    return by_id<0, S::NQ>(c.q, [&](auto q) {
      return h_queue_at<decltype(q)::value>(s, w, p, c, tag, is_retry);
    });
  } else if constexpr (S::NQ == 1) {
    return h_queue_at<0>(s, w, p, c, tag, is_retry);
  } else {
    if (c.q <= 0) return h_queue_at<0>(s, w, p, c, tag, is_retry);
    return h_queue_at<1>(s, w, p, c, tag, is_retry);
  }
}

// ---------------------------------------------------------------------------
// The toolkit's verbs, compiled in for the families with pools, buffers or
// conditions (the job shop, and a generated family): pool K, buffer B and
// condition C are compile-time indices, as h_queue_at<Q> takes its queue,
// and so are their guards (M::g_pool(K), g_front(B), g_rear(B),
// g_cond(C)) and whether a condition observes a guard (M::observes(C,
// G)).

// condition C's signal (loop.cond_signal): every waiter whose predicate
// holds wakes, in pid order; where no predicate reads its waiter
// (M::PRED_BY_PID false: the job shop's backlog) it is evaluated once
template <int C, class S>
__device__ __forceinline__ void cond_signal(S& s, const Where& w) {
  using M = typename S::M;
  if constexpr (!M::PRED_BY_PID) {
    if (!M::template cond_holds<C>(s, w, 0)) return;
#pragma unroll
    for (int q = 0; q < S::NP; ++q)
        if (field(s.word[q], F_GUARD) == M::g_cond(C)) {
          set(s, F_GUARD, q, -1);
          schedule_wake(s, q, s.clock);
        }
  } else {
#pragma unroll
    for (int q = 0; q < S::NP; ++q)
        if (field(s.word[q], F_GUARD) == M::g_cond(C) &&
            M::template cond_holds<C>(s, w, q)) {
          set(s, F_GUARD, q, -1);
          schedule_wake(s, q, s.clock);
        }
  }
}

// the signals of the conditions from C on that observe guard G, in id
// order
template <int G, int C, class S>
__device__ __forceinline__ void forward(S& s, const Where& w) {
  using M = typename S::M;
  if constexpr (C < M::NC) {
    if constexpr (M::observes(C, G)) cond_signal<C>(s, w);
    forward<G, C + 1>(s, w);
  }
}

// guard G's signal with the observer forwarding of loop._guard_signal:
// the best waiter's wake, then the signals of the conditions observing G
template <int G, class S>
__device__ __forceinline__ void signal_at(S& s, const Where& w) {
  guard_signal(s, G);
  forward<G, 0>(s, w);
}

// loop.release_pool: amount units of pool K back from process p, inline
// from a block or as the C_POOL_REL command; the ownership tolerance
// max(64 eps max(1, |amount|), 1e-12) at REAL's eps
template <int K, class S>
__device__ __forceinline__ void release_pool(S& s, const Where& w, int p,
                                             typename S::R amount) {
  using R = typename S::R;
  using M = typename S::M;
  const R held = SCOL(s, held, K * S::NP + p);
  const R amt = nanmin(amount, held);
  const R a = amount < R(0) ? -amount : amount;
  const R big = (a != a || a > R(1)) ? a : R(1);
  R tol = R(sizeof(R) == 4 ? 0x1p-17 : 0x1p-46) * big;
  tol = (tol != tol || tol > R(1e-12)) ? tol : R(1e-12);
  const bool owner_ok = held >= amount - tol;
  const R in_use = M::template pool_cap<R>(w, K) - (s.pool_level[K] + amt);
  s.pool_level[K] = s.pool_level[K] + amt;
  SCOL(s, held, K * S::NP + p) = held + -amt;
  if constexpr (M::pool_rec(K)) record(s, M::acc_pool(K), in_use);
  signal_at<M::g_pool(K)>(s, w);
  if (!owner_ok) set_err(s, ERR_BAD_RELEASE);
}

// the kick of process p: its wait aborted with sig, then a wake now with
// sig (defined with the generated family's rules below)
template <class S>
__device__ __forceinline__ void kick(S& s, const Where& w, int p,
                                     int32_t sig);

// pool_acquire (MUG false) or pool_preempt (MUG true) and their fused
// twins (FUSED; loop's h_pool_acquire and h_pool_preempt) on pool K: take
// what is available now; a preempt then mugs (below); pend for the rest
// (pend_f the remainder, pend_f2 the holding before the call); the
// guard's signal only on success, then the fused hold.  The twin and the
// mug are compile-time choices (a twin read from the tag at run time
// once came out wrong on the card, the priority queue's get).
//
// The mug (loop's _mug), while the claim is short: the victim v among
// the processes holding units of K with a priority strictly below p's,
// the lowest priority, then the latest grab (held_seq), then the lowest
// pid, scanned over compile-time pids; v's whole holding is taken and
// what the claim does not use goes back to the pool, before the kick
// (kick through at_pid: v's wait aborted with PREEMPTED, a PREEMPTED
// wake now).  At most NP victims.
template <int K, bool MUG, bool FUSED, class S>
__device__ __forceinline__ bool h_pool(S& s, const Where& w, int p,
                                       const Cmd<typename S::R>& c,
                                       bool is_retry) {
  using R = typename S::R;
  using M = typename S::M;
  const int h = K * S::NP + p;
  const R held = SCOL(s, held, h);
  const R init_held = is_retry ? SCOL(s, pend_f2, p) : held;
  const R take = nanmin(nanmax0(c.f), s.pool_level[K]);
  if (held <= R(0)) {  // the grab order, stamped on the first units
    SCOL(s, held_seq, h) = s.pool_next_seq[K];
    s.pool_next_seq[K] += 1;
  }
  s.pool_level[K] = s.pool_level[K] + -take;
  SCOL(s, held, h) = held + take;
  R rem = c.f - take;
  if constexpr (MUG) {
    const int32_t mine = COLD(s, prio, p);
    for (int it = 0; it < S::NP; ++it) {
      bool any = false;
      int32_t vp = I32_MAX, vs = -1;
      int v = 0;
#pragma unroll
      for (int q = 0; q < S::NP; ++q) {
        const int32_t pq = COLD(s, prio, q);
        if (SCOL(s, held, K * S::NP + q) > R(0) && pq < mine && q != p) {
          const int32_t sq = SCOL(s, held_seq, K * S::NP + q);
          if (!any || pq < vp || (pq == vp && sq > vs)) {
            any = true;
            vp = pq;
            vs = sq;
            v = q;
          }
        }
      }
      if (!(rem > R(0) && any)) break;
      const R loot = SCOL(s, held, K * S::NP + v);
      const R used = nanmin(loot, rem);
      SCOL(s, held, K * S::NP + v) = R(0);
      SCOL(s, held, h) = SCOL(s, held, h) + used;
      s.pool_level[K] = s.pool_level[K] + (loot - used);
      at_pid<S>(v, [&](int q) { kick(s, w, q, PREEMPTED); });
      rem = rem - used;
    }
  }
  const bool done = rem <= R(0);
  if constexpr (M::pool_rec(K))
    record(s, M::acc_pool(K), M::template pool_cap<R>(w, K) - s.pool_level[K]);
  if (done) signal_at<M::g_pool(K)>(s, w);
  if (FUSED && done) schedule_wake(s, p, s.clock + nanmax0(c.f3));
  if (done) {
    set(s, F_PC, p, c.next_pc);
  } else {
    Cmd<R> pc = c;
    pc.f = rem;
    pc.f2 = init_held;
    guard_wait(s, p, M::g_pool(K), pc, is_retry);
  }
  return !done || FUSED;
}

// buffer B's get (GET) or put and their fused twins (loop's h_buffer):
// move what fits now, pend for the rest (pend_f the remainder, pend_f2
// the total); the other side's guard on any progress, this side's on
// completion only, then the fused hold
template <bool GET, int B, class S>
__device__ __forceinline__ bool h_buffer(S& s, const Where& w, int p,
                                         const Cmd<typename S::R>& c, int tag,
                                         bool is_retry) {
  using R = typename S::R;
  using M = typename S::M;
  constexpr int MY = GET ? M::g_front(B) : M::g_rear(B);
  constexpr int OTHER = GET ? M::g_rear(B) : M::g_front(B);
  const R total = is_retry ? SCOL(s, pend_f2, p) : c.f;
  const R level = s.buf_level[B];
  const R room = GET ? level : M::template buf_cap<R>(w, B) - level;
  const R moved = nanmin(nanmax0(c.f), room);
  const R level2 = level + (GET ? -moved : moved);
  const R rem = c.f - moved;
  const bool done = rem <= R(0);
  s.buf_level[B] = level2;
  if constexpr (M::buf_rec(B)) record(s, M::acc_buf(B), level2);
  if (moved > R(0)) signal_at<OTHER>(s, w);
  if (done) signal_at<MY>(s, w);
  if (done) COLD(s, got, p) = total;
  const bool fused = tag == C_BUF_GET_HOLD || tag == C_BUF_PUT_HOLD;
  if (fused && done) schedule_wake(s, p, s.clock + nanmax0(c.f3));
  set(s, F_PC, p, c.next_pc);
  if (!done) {
    Cmd<R> pc = c;
    pc.f = rem;
    pc.f2 = total;
    guard_wait(s, p, MY, pc, is_retry);
  }
  return !done || fused;
}

// cond_wait on condition C (loop's h_cond_wait): a first issue always
// waits; a signalled retry goes on where the predicate holds and waits
// again, keeping its place, where not
template <int C, class S>
__device__ __forceinline__ bool h_cond_wait(S& s, const Where& w, int p,
                                            const Cmd<typename S::R>& c,
                                            bool is_retry) {
  using M = typename S::M;
  const bool proceed = is_retry && M::template cond_holds<C>(s, w, p);
  set(s, F_PC, p, c.next_pc);
  if (!proceed) guard_wait(s, p, M::g_cond(C), c, is_retry);
  return !proceed;
}

// the units of pool K that p holds go back (an exit)
template <int K, class S>
__device__ __forceinline__ void drop_pool(S& s, const Where& w, int p) {
  using R = typename S::R;
  using M = typename S::M;
  if constexpr (K < M::NK) {
    const R amt = SCOL(s, held, K * S::NP + p);
    if (amt > R(0)) {
      const R in_use =
          M::template pool_cap<R>(w, K) - (s.pool_level[K] + amt);
      s.pool_level[K] = s.pool_level[K] + amt;
      SCOL(s, held, K * S::NP + p) = R(0);
      if constexpr (M::pool_rec(K)) record(s, M::acc_pool(K), in_use);
      signal_at<M::g_pool(K)>(s, w);
    }
    drop_pool<K + 1>(s, w, p);
  }
}

// binary resource RID (and those after it) freed where p holds it (an
// end), its utilization recorded and its guard signalled
template <int RID, class S>
__device__ __forceinline__ void drop_res(S& s, const Where& w, int p) {
  using R = typename S::R;
  using M = typename S::M;
  if constexpr (RID < M::NR) {
    if (s.holder[RID] == p) {
      s.holder[RID] = -1;
      if constexpr (M::res_rec(RID)) record(s, M::acc_res(RID), R(0));
      signal_at<M::g_res(RID)>(s, w);
    }
    drop_res<RID + 1>(s, w, p);
  }
}

// the end of process p once its wait is gone (loop.finish_process): its
// timers cancelled, FINISHED with exit_sig, its resources freed and its
// pool units back
template <class S>
__device__ __forceinline__ void end_process(S& s, const Where& w, int p,
                                            int32_t exit_sig) {
  using R = typename S::R;
  if (s.any_e) {  // cancel p's timers
    const int E = ecap<S>(w);
    R* time = row<R, S>(w, EV_TIME, E);
    const int32_t* kind = row<int32_t, S>(w, EV_KIND, E);
    const int32_t* subj = row<int32_t, S>(w, EV_SUBJ, E);
    int32_t* gen = row<int32_t, S>(w, EV_GEN, E);
    if constexpr (S::M::EMASK) {
      each_slot(s, w, [&](int i) {
        if (finite(time[i]) && kind[i] == K_TIMER && subj[i] == p) {
          time[i] = inf_of<R>();
          gen[i] += 1;
          ev_mark(s, i, false);
        }
      });
    } else {
      for (int i = 0; i < E; ++i)
        if (finite(time[i]) && kind[i] == K_TIMER && subj[i] == p) {
          time[i] = inf_of<R>();
          gen[i] += 1;
        }
    }
    scan_table(s, w);
  }
  set(s, F_STATUS, p, FINISHED);
  row<int32_t, S>(w, EXIT_SIG, S::NP)[p] = exit_sig;
  if constexpr (S::M::WAITP) {
    // its waiters wake with its exit signal, their seqs in pid order
    // (loop._wake_waiters)
#pragma unroll
    for (int q = 0; q < S::NP; ++q)
      if (s.apid[q] == p && get(s, F_STATUS, q) == RUNNING) {
        wake_sig(s, q, exit_sig);
        s.apid[q] = -1;
      }
  }
  if constexpr (S::M::NR > 0) drop_res<0>(s, w, p);
  if constexpr (S::M::TOOLKIT) drop_pool<0>(s, w, p);
}

// the exit of the running process p: no wait to abort
template <class S>
__device__ __forceinline__ void finish(S& s, const Where& w, int p) {
  using R = typename S::R;
  set(s, F_TAG, p, NO_PEND);
  set(s, F_GUARD, p, -1);
  put(s.wt, p, inf_of<R>());
  end_process(s, w, p, SUCCESS);
}

// ---------------------------------------------------------------------------
// A generated family's own rules: the priority queues, the general event
// table written from a block, interrupts and the abort's cleanup.  Only a
// family that has them instantiates them (the hand-written families and
// a generated one without priority queues, timers or interrupts keep
// their code).

// priority queue Q's first mask word (M::PMASK)
template <int Q, class S>
__device__ __forceinline__ constexpr int pq_off() {
  return Q * Bits<S::M::PQW>::W;
}

// Priority queue Q's best live slot among those holding item (ITEM) or
// among all: the greatest priority (the reference's amax, NaN
// propagating: then no slot matches), then the least seq, then the
// lowest slot.  One pass over the mask's live slots, ascending, the
// candidates dropped whenever the maximum rises; returns whether a slot
// of priority pb was found, with pb, its seq sb and its slot col
template <int Q, bool ITEM, class S>
__device__ __forceinline__ bool pq_best(const S& s, const Where& w,
                                        typename S::R item,
                                        typename S::R& pb, int32_t& sb,
                                        int& col) {
  using R = typename S::R;
  using M = typename S::M;
  const R* items = pq_row<R, S>(w, M::L_PQ_ITEMS, Q);
  const R* prio = pq_row<R, S>(w, M::L_PQ_PRIO, Q);
  const int32_t* seq = pq_row<int32_t, S>(w, M::L_PQ_SEQ, Q);
  bool found = false;
  pb = -inf_of<R>();
  sb = I32_MAX;
  col = 0;
  each_bit<Bits<M::PQW>::W, pq_off<Q, S>()>(s.pm, [&](int j) {
    if (ITEM && !(items[j] == item)) return;
    const R x = prio[j];
    if (x != x || x > pb) {
      pb = x;
      found = false;
    }
    if (x == pb) {
      const int32_t sj = seq[j];
      if (!found || sj < sb) {
        sb = sj;
        col = j;
        found = true;
      }
    }
  });
  if (!found) {  // none (an empty queue, or a NaN maximum): column 0
    sb = I32_MAX;
    col = 0;
  }
  return found;
}

// api.pqueue_length: the live slots of queue Q
template <int Q, class S>
__device__ __forceinline__ int32_t pq_length(const S& s, const Where& w) {
  using M = typename S::M;
  if constexpr (M::PMASK) return popc<M::PQW>(s.pm, pq_off<Q, S>());
  const bool* live = pq_row<bool, S>(w, M::L_PQ_LIVE, Q);
  int32_t n = 0;
  for (int j = 0; j < M::PQW; ++j) n += live[j] ? 1 : 0;
  return n;
}

// api.pqueue_position: the 1-based place in dequeue order (priority
// descending, then seq) of the earliest-dequeuing live item equal to
// item, 0 if none
template <int Q, class S>
__device__ __forceinline__ int32_t pq_position(const S& s, const Where& w,
                                               typename S::R item) {
  using R = typename S::R;
  using M = typename S::M;
  if constexpr (M::PMASK) {
    // the best match, then the live slots that dequeue before it
    R pb;
    int32_t sb;
    int col;
    bool any = false;
    const R* items = pq_row<R, S>(w, M::L_PQ_ITEMS, Q);
    each_bit<Bits<M::PQW>::W, pq_off<Q, S>()>(s.pm, [&](int j) {
      any = any || items[j] == item;
    });
    if (!any) return 0;
    pq_best<Q, true>(s, w, item, pb, sb, col);
    const R* prio = pq_row<R, S>(w, M::L_PQ_PRIO, Q);
    const int32_t* seq = pq_row<int32_t, S>(w, M::L_PQ_SEQ, Q);
    int32_t ahead = 0;
    each_bit<Bits<M::PQW>::W, pq_off<Q, S>()>(s.pm, [&](int j) {
      const R x = prio[j];
      ahead += (x > pb || (x == pb && seq[j] < sb)) ? 1 : 0;
    });
    return ahead + 1;
  }
  const bool* live = pq_row<bool, S>(w, M::L_PQ_LIVE, Q);
  const R* items = pq_row<R, S>(w, M::L_PQ_ITEMS, Q);
  const R* prio = pq_row<R, S>(w, M::L_PQ_PRIO, Q);
  const int32_t* seq = pq_row<int32_t, S>(w, M::L_PQ_SEQ, Q);
  bool any = false;
  R pb = -inf_of<R>();
  for (int j = 0; j < M::PQW; ++j)
    if (live[j] && items[j] == item) {
      any = true;
      const R x = prio[j];
      pb = (x != x || x > pb) ? x : pb;  // amax: NaN propagates
    }
  int32_t sb = I32_MAX;
  for (int j = 0; j < M::PQW; ++j)
    if (live[j] && items[j] == item && prio[j] == pb && seq[j] < sb)
      sb = seq[j];
  int32_t ahead = 0;
  for (int j = 0; j < M::PQW; ++j)
    if (live[j] && (prio[j] > pb || (prio[j] == pb && seq[j] < sb)))
      ahead += 1;
  return any ? ahead + 1 : 0;
}

// pq_put and its fused twin (FUSED) on queue Q (loop's h_pq_put): the
// item into the lowest free slot with the queue's next seq, the front
// guard's signal, the fused hold; a full queue pends on the rear guard.
// The twin is a compile-time choice: a run-time one once came out wrong
// on the card (a plain get yielded as if fused)
template <int Q, bool FUSED, class S>
__device__ __forceinline__ bool h_pq_put(S& s, const Where& w, int p,
                                         const Cmd<typename S::R>& c,
                                         bool is_retry) {
  using R = typename S::R;
  using M = typename S::M;
  bool* live = pq_row<bool, S>(w, M::L_PQ_LIVE, Q);
  int32_t n = 0;
  int col = M::PQW - 1;
  if constexpr (M::PMASK) {
    n = popc<M::PQW>(s.pm, pq_off<Q, S>());
    const int j = first_clear<M::PQW>(s.pm, pq_off<Q, S>());
    col = j < M::PQW ? j : col;
  } else {
    bool free_found = false;
    for (int j = 0; j < M::PQW; ++j) {
      if (live[j]) {
        n += 1;
      } else if (!free_found) {
        free_found = true;
        col = j;
      }
    }
  }
  const bool may = is_retry || !any_waiting(s, M::pq_rear(Q));
  const bool full = n >= M::pq_cap(Q) || !may;
  if (!full) {
    pq_row<R, S>(w, M::L_PQ_ITEMS, Q)[col] = c.f;
    pq_row<R, S>(w, M::L_PQ_PRIO, Q)[col] = c.f2;
    pq_row<int32_t, S>(w, M::L_PQ_SEQ, Q)[col] = GCOL(s, pq_next_seq, Q);
    live[col] = true;
    if constexpr (M::PMASK)
      set_bit(s.pm, pq_off<Q, S>(), col, true);
    GCOL(s, pq_next_seq, Q) += 1;
    if constexpr (M::pq_rec(Q)) record(s, M::acc_pq(Q), R(n + 1));
    signal_at<M::pq_front(Q)>(s, w);
    if constexpr (FUSED) schedule_wake(s, p, s.clock + nanmax0(c.f3));
  }
  set(s, F_PC, p, c.next_pc);
  if (full) guard_wait(s, p, M::pq_rear(Q), c, is_retry);
  return FUSED || full;
}

// pq_get and its fused twin (FUSED) on queue Q (loop's h_pq_get): the
// highest priority, then the lowest seq, then the lowest slot; the rear
// guard's signal, then the front guard's, then the fused hold; an empty
// queue pends on the front guard
template <int Q, bool FUSED, class S>
__device__ __forceinline__ bool h_pq_get(S& s, const Where& w, int p,
                                         const Cmd<typename S::R>& c,
                                         bool is_retry) {
  using R = typename S::R;
  using M = typename S::M;
  bool* live = pq_row<bool, S>(w, M::L_PQ_LIVE, Q);
  int32_t n = 0;
  int col = 0;
  if constexpr (M::PMASK) {
    n = popc<M::PQW>(s.pm, pq_off<Q, S>());
    R pb;
    int32_t sb;
    pq_best<Q, false>(s, w, R(0), pb, sb, col);
  } else {
    const R* prio = pq_row<R, S>(w, M::L_PQ_PRIO, Q);
    const int32_t* seq = pq_row<int32_t, S>(w, M::L_PQ_SEQ, Q);
    R pb = -inf_of<R>();
    for (int j = 0; j < M::PQW; ++j)
      if (live[j]) {
        n += 1;
        const R x = prio[j];
        pb = (x != x || x > pb) ? x : pb;  // amax: NaN propagates
      }
    int32_t sm = I32_MAX;
    for (int j = 0; j < M::PQW; ++j)
      if (live[j] && prio[j] == pb && seq[j] < sm) sm = seq[j];
    for (int j = 0; j < M::PQW; ++j)
      if (live[j] && prio[j] == pb && seq[j] == sm) {
        col = j;
        break;
      }
  }
  const bool may = is_retry || !any_waiting(s, M::pq_front(Q));
  const bool empty = n == 0 || !may;
  if (!empty) {
    COLD(s, got, p) = pq_row<R, S>(w, M::L_PQ_ITEMS, Q)[col];
    live[col] = false;
    if constexpr (M::PMASK)
      set_bit(s.pm, pq_off<Q, S>(), col, false);
    if constexpr (M::pq_rec(Q)) record(s, M::acc_pq(Q), R(n - 1));
    signal_at<M::pq_rear(Q)>(s, w);
    signal_at<M::pq_front(Q)>(s, w);
    if constexpr (FUSED) schedule_wake(s, p, s.clock + nanmax0(c.f3));
  }
  set(s, F_PC, p, c.next_pc);
  if (empty) guard_wait(s, p, M::pq_front(Q), c, is_retry);
  return FUSED || empty;
}

// api.timer_add (loop.timer_add): a K_TIMER event for p at clock +
// max(dur, 0) with p's priority and the next seq, in the first free slot
// of the general table (a free slot holds an infinite time), the cached
// minimum kept; a full table or a non-finite time sets the table's
// overflow flag, which fails the lane.  Returns the handle (the slot's
// generation above bit 16, the slot below), -1 where nothing was put.
template <class S>
__device__ __forceinline__ int32_t timer_add(S& s, const Where& w, int p,
                                             typename S::R dur,
                                             int32_t sig) {
  using R = typename S::R;
  const int E = ecap<S>(w);
  R* time = row<R, S>(w, EV_TIME, E);
  int32_t* prio = row<int32_t, S>(w, EV_PRIO, E);
  int32_t* seq = row<int32_t, S>(w, EV_SEQ, E);
  const R t = s.clock + nanmax0(dur);
  const int slot = free_slot(s, w);
  const bool ok = slot < E && finite(t);
  bool* overflow = row<bool, S>(w, EV_OVERFLOW, 1);
  int32_t h = -1;
  if (ok) {
    const int32_t pr = COLD(s, prio, p);
    time[slot] = t;
    ev_mark(s, slot, true);
    prio[slot] = pr;
    seq[slot] = s.next_seq;
    row<int32_t, S>(w, EV_KIND, E)[slot] = K_TIMER;
    row<int32_t, S>(w, EV_SUBJ, E)[slot] = p;
    row<int32_t, S>(w, EV_ARG, E)[slot] = sig;
    h = int32_t(uint32_t(row<int32_t, S>(w, EV_GEN, E)[slot]) << 16) | slot;
    // the minimum (time asc, prio desc, seq asc, lowest slot)
    bool take = !s.any_e || t < s.t_e;
    if (!take && t == s.t_e) {
      const int32_t pe = prio[s.slot_e], se = seq[s.slot_e];
      take = pr > pe ||
             (pr == pe && (s.next_seq < se ||
                           (s.next_seq == se && slot < s.slot_e)));
    }
    if (take) {
      s.t_e = t;
      s.slot_e = slot;
    }
    s.any_e = true;
    s.next_seq += 1;
  } else {
    *overflow = true;
  }
  if (*overflow) set_err(s, ERR_EVENT_OVERFLOW);
  return h;
}

// api.timers_clear (loop.timers_clear): every live K_TIMER event aimed at
// p cancelled (its slot freed, its generation bumped), the minimum
// scanned again where one was
template <class S>
__device__ __forceinline__ void timers_clear(S& s, const Where& w, int p) {
  using R = typename S::R;
  if (!s.any_e) return;
  const int E = ecap<S>(w);
  R* time = row<R, S>(w, EV_TIME, E);
  const int32_t* kind = row<int32_t, S>(w, EV_KIND, E);
  const int32_t* subj = row<int32_t, S>(w, EV_SUBJ, E);
  int32_t* gen = row<int32_t, S>(w, EV_GEN, E);
  bool hit = false;
  each_slot(s, w, [&](int i) {
    if (finite(time[i]) && kind[i] == K_TIMER && subj[i] == p) {
      time[i] = inf_of<R>();
      gen[i] += 1;
      ev_mark(s, i, false);
      hit = true;
    }
  });
  if (hit) scan_table(s, w);
}

// pool K's rollback of an aborted acquire (loop._abort_cleanup): p's
// holding back to what it held before the call (f2), the excess to the
// pool, its record and its guard's signal
template <int K, class S>
__device__ __forceinline__ void rollback(S& s, const Where& w, int p,
                                         typename S::R f2) {
  using R = typename S::R;
  using M = typename S::M;
  const R held = SCOL(s, held, K * S::NP + p);
  const R excess = nanmax0(held - f2);
  const R in_use =
      M::template pool_cap<R>(w, K) - (s.pool_level[K] + excess);
  s.pool_level[K] = s.pool_level[K] + excess;
  SCOL(s, held, K * S::NP + p) = held + -excess;
  if constexpr (M::pool_rec(K)) record(s, M::acc_pool(K), in_use);
  signal_at<M::g_pool(K)>(s, w);
}

// the cleanup of p's aborted wait on pend (loop._abort_cleanup): a pended
// pool acquire or preempt rolls back (not on PREEMPTED), a pended buffer
// transfer reports what it moved; the reference reads the plain tags only
template <class S>
__device__ __forceinline__ void abort_cleanup(S& s, const Where& w, int p,
                                              const Cmd<typename S::R>& pend,
                                              int32_t sig) {
  using M = typename S::M;
  if constexpr (M::ABORT) {
    if constexpr (M::NK > 0) {
      if ((pend.tag == C_POOL_ACQ || pend.tag == C_POOL_PRE) &&
          sig != PREEMPTED)
        by_id<0, M::NK>(pend.q, [&](auto k) {
          rollback<decltype(k)::value>(s, w, p, pend.f2);
          return 0;
        });
    }
    if constexpr (M::NV > 0) {
      if (pend.tag == C_BUF_GET || pend.tag == C_BUF_PUT)
        COLD(s, got, p) = pend.f2 - pend.f;
    }
  }
}

// process T's pended command (its payload where the cleanup reads it)
template <class S>
__device__ __forceinline__ Cmd<typename S::R> pend_of(const S& s, int p) {
  using R = typename S::R;
  Cmd<R> c{get(s, F_TAG, p), COLD(s, pend_f, p), COLD(s, pend_f3, p),
           COLD(s, pend_pc, p), 0};
  if constexpr (S::M::PEND_I) c.q = s.cold_q->pend_i[p][s.t];
  if constexpr (S::M::TOOLKIT) c.f2 = SCOL(s, pend_f2, p);
  return c;
}

// what process p (a compile-time pid where the words are registers, see
// at_pid) waits on, aborted with sig (loop._abort_wait): the unwait (its
// pend, guard and wake cleared), then the cleanup
template <class S>
__device__ __forceinline__ void abort_wait(S& s, const Where& w, int p,
                                           int32_t sig) {
  using R = typename S::R;
  const Cmd<R> pend = pend_of(s, p);
  set(s, F_TAG, p, NO_PEND);
  set(s, F_GUARD, p, -1);
  put(s.wt, p, inf_of<R>());
  if constexpr (S::M::WAITP) put(s.apid, p, -1);
  if constexpr (S::M::WAITE) put(s.aevt, p, -1);
  abort_cleanup(s, w, p, pend, sig);
}

// the kick of process p: its wait aborted, then a wake now with sig; an
// interrupt's, a resource preempt's and a mug's
template <class S>
__device__ __forceinline__ void kick(S& s, const Where& w, int p,
                                     int32_t sig) {
  abort_wait(s, w, p, sig);
  wake_sig(s, p, sig);
}

// api.interrupt of a pid a block computes (loop.interrupt): the kick,
// where the target runs, reached through at_pid; a pid out of range is
// no process
template <class S>
__device__ __forceinline__ void interrupt(S& s, const Where& w, int target,
                                          int32_t sig) {
  if (target < 0 || target >= S::NP) return;
  at_pid<S>(target, [&](int q) {
    if (get(s, F_STATUS, q) == RUNNING) kick(s, w, q, sig);
  });
}

// api.stop_process of process T (a compile-time pid; loop.stop_process):
// where T runs, its wait aborted with STOPPED (unwait, then the cleanup;
// its wake cleared, so a process stopped in a hold never wakes), then its
// end with exit signal STOPPED
template <class S>
__device__ __forceinline__ void stop_one(S& s, const Where& w, int p) {
  if (get(s, F_STATUS, p) != RUNNING) return;
  abort_wait(s, w, p, STOPPED);
  end_process(s, w, p, STOPPED);
}

template <int T, class S>
__device__ __forceinline__ void stop_at(S& s, const Where& w) {
  stop_one(s, w, T);
}

// api.stop_process of a pid a block computes: reached through at_pid; a
// pid out of range is no process
template <class S>
__device__ __forceinline__ void stop_process(S& s, const Where& w,
                                             int target) {
  if (target < 0 || target >= S::NP) return;
  at_pid<S>(target, [&](int q) { stop_one(s, w, q); });
}

// process p's row reset by a spawn of pool type T (loop.spawn_process):
// RUNNING at the type's entry with priority prio, no pend, got, exit
// signal and locals 0, no waits; its SUCCESS wake at t with the next seq
// (a non-finite t fails the lane).  prio, exit_sig and the waits are
// written through to device memory (a chunk stores none of them back).
// A finished row's timers were cancelled and its holdings dropped at its
// end, and its wake is NEVER, so nothing of its last life is read again.
template <int T, class S>
__device__ __forceinline__ void spawn_reset(S& s, const Where& w, int p,
                                            typename S::R t, int32_t prio) {
  using R = typename S::R;
  using M = typename S::M;
  constexpr int NP = S::NP;
  set(s, F_STATUS, p, RUNNING);
  set(s, F_PC, p, M::spawn_entry(T));
  set(s, F_TAG, p, NO_PEND);
  set(s, F_GUARD, p, -1);
  COLD(s, prio, p) = prio;
  row<int32_t, S>(w, PRIO, NP)[p] = prio;
  COLD(s, got, p) = R(0);
  row<int32_t, S>(w, EXIT_SIG, NP)[p] = SUCCESS;
  if constexpr (M::WAITP) {
    put(s.apid, p, -1);
  } else {
    row<int32_t, S>(w, AWAIT_PID, NP)[p] = -1;
  }
  if constexpr (M::WAITE) {
    put(s.aevt, p, -1);
  } else {
    row<int32_t, S>(w, AWAIT_EVT, NP)[p] = -1;
  }
#pragma unroll
  for (int i = 0; i < M::NF; ++i) UCOL(s, lf, p * M::NF + i) = R(0);
#pragma unroll
  for (int i = 0; i < M::NI; ++i) UCOL(s, li, p * M::NI + i) = 0;
  schedule_wake(s, p, t);
}

// api.spawn of pool type T (a compile-time id: its rows are the pids
// [spawn_first(T), spawn_first(T) + spawn_count(T))): the lowest row that
// is not RUNNING (CREATED or FINISHED) reset by spawn_reset, reached
// through at_pid over the pool's pids only; returns its pid, or -1 where
// every row runs
template <int T, class S>
__device__ __forceinline__ int32_t spawn_pool(S& s, const Where& w,
                                              typename S::R t,
                                              int32_t prio) {
  using M = typename S::M;
  constexpr int LO = M::spawn_first(T), HI = LO + M::spawn_count(T);
  int p = -1;
  each<S::BIG, HI - LO>([&](int j) {
    if (p < 0 && get(s, F_STATUS, LO + j) != RUNNING) p = LO + j;
  });
  if (p < 0) return -1;
  at_pid<S, LO, HI>(p, [&](int q) { spawn_reset<T>(s, w, q, t, prio); });
  return p;
}

// binary resource RID's release by p (loop.release_resource), inline from
// a block or as the C_RELEASE command: freed, its utilization recorded,
// its guard signalled; a release by another than the holder fails the
// lane
template <int RID, class S>
__device__ __forceinline__ void release_resource(S& s, const Where& w,
                                                 int p) {
  using R = typename S::R;
  using M = typename S::M;
  const bool owner_ok = s.holder[RID] == p;
  s.holder[RID] = -1;
  if constexpr (M::res_rec(RID)) record(s, M::acc_res(RID), R(0));
  signal_at<M::g_res(RID)>(s, w);
  if (!owner_ok) set_err(s, ERR_BAD_RELEASE);
}

// acquire of binary resource RID and its fused twin (FUSED; loop's
// h_acquire): grab it where it is free and no one waits for it (a retry
// may), else pend on its guard
template <int RID, bool FUSED, class S>
__device__ __forceinline__ bool h_acquire(S& s, const Where& w, int p,
                                          const Cmd<typename S::R>& c,
                                          bool is_retry) {
  using R = typename S::R;
  using M = typename S::M;
  constexpr int G = M::g_res(RID);
  const bool ok = s.holder[RID] < 0 && (is_retry || !any_waiting(s, G));
  if (ok) {
    s.holder[RID] = p;
    if constexpr (M::res_rec(RID)) record(s, M::acc_res(RID), R(1));
  }
  if (FUSED && ok) schedule_wake(s, p, s.clock + nanmax0(c.f3));
  set(s, F_PC, p, c.next_pc);
  if (!ok) guard_wait(s, p, G, c, is_retry);
  return !ok || FUSED;
}

// preempt of binary resource RID and its fused twin (FUSED; loop's
// h_preempt): grab it where it is free; where its holder's priority is at
// most p's, kick the holder (kick through at_pid: its wait aborted
// with PREEMPTED, a PREEMPTED wake now) and take it over, recording
// nothing; else pend as an acquire
template <int RID, bool FUSED, class S>
__device__ __forceinline__ bool h_preempt(S& s, const Where& w, int p,
                                          const Cmd<typename S::R>& c,
                                          bool is_retry) {
  using R = typename S::R;
  using M = typename S::M;
  const int32_t holder = s.holder[RID];
  const bool free = holder < 0;
  const int victim = free ? 0 : holder;
  const bool kick_ =
      !free && COLD(s, prio, p) >= COLD(s, prio, victim);
  if (kick_) {
    at_pid<S>(victim, [&](int q) { kick(s, w, q, PREEMPTED); });
    s.holder[RID] = p;
  } else if (free) {
    s.holder[RID] = p;
    if constexpr (M::res_rec(RID)) record(s, M::acc_res(RID), R(1));
  }
  const bool blocked = !free && !kick_;
  if (FUSED && !blocked) schedule_wake(s, p, s.clock + nanmax0(c.f3));
  set(s, F_PC, p, c.next_pc);
  if (blocked) guard_wait(s, p, M::g_res(RID), c, is_retry);
  return blocked || FUSED;
}

// api.schedule (loop.schedule): an event of kind N_KINDS + k (user
// handler k) at absolute time t with priority prio, subject subj and
// argument arg in the first free slot of the general table, as timer_add
// puts its K_TIMER event, the cached minimum kept; a full table or a
// non-finite time sets the overflow flag, which fails the lane.  Returns
// the handle, -1 where nothing was put.
template <class S>
__device__ __forceinline__ int32_t schedule_event(S& s, const Where& w,
                                                  typename S::R t,
                                                  int32_t prio, int32_t kind,
                                                  int32_t subj, int32_t arg) {
  using R = typename S::R;
  const int E = ecap<S>(w);
  R* time = row<R, S>(w, EV_TIME, E);
  int32_t* prio_e = row<int32_t, S>(w, EV_PRIO, E);
  int32_t* seq = row<int32_t, S>(w, EV_SEQ, E);
  const int slot = free_slot(s, w);
  const bool ok = slot < E && finite(t);
  bool* overflow = row<bool, S>(w, EV_OVERFLOW, 1);
  int32_t h = -1;
  if (ok) {
    time[slot] = t;
    ev_mark(s, slot, true);
    prio_e[slot] = prio;
    seq[slot] = s.next_seq;
    row<int32_t, S>(w, EV_KIND, E)[slot] = kind;
    row<int32_t, S>(w, EV_SUBJ, E)[slot] = subj;
    row<int32_t, S>(w, EV_ARG, E)[slot] = arg;
    h = int32_t(uint32_t(row<int32_t, S>(w, EV_GEN, E)[slot]) << 16) | slot;
    bool take = !s.any_e || t < s.t_e;
    if (!take && t == s.t_e) {
      const int32_t pe = prio_e[s.slot_e], se = seq[s.slot_e];
      take = prio > pe ||
             (prio == pe && (s.next_seq < se ||
                             (s.next_seq == se && slot < s.slot_e)));
    }
    if (take) {
      s.t_e = t;
      s.slot_e = slot;
    }
    s.any_e = true;
    s.next_seq += 1;
  } else {
    *overflow = true;
  }
  if (*overflow) set_err(s, ERR_EVENT_OVERFLOW);
  return h;
}

// --- the event-handle API on the general table ----------------------------
// A handle is the slot's generation above bit 16 and the slot below; it
// names a live event where the slot holds a finite time and the slot's
// generation is the handle's (eventset._valid: a slot past the table
// reads time 0 and generation 0, as the reference's one-hot read of no
// slot does).

__device__ __forceinline__ int ev_slot(int32_t h) {
  return (h < 0 ? 0 : h) & 0xFFFF;
}

template <class S>
__device__ __forceinline__ bool ev_valid(const S&, const Where& w,
                                         int32_t h) {
  using R = typename S::R;
  const int E = ecap<S>(w), slot = ev_slot(h);
  if (h < 0) return false;
  if (slot >= E) return (h >> 16) == 0;
  return finite(row<R, S>(w, EV_TIME, E)[slot]) &&
         row<int32_t, S>(w, EV_GEN, E)[slot] == (h >> 16);
}

// api.event_time: a live event's time, +inf for a dead handle
template <class S>
__device__ __forceinline__ typename S::R ev_time(const S& s, const Where& w,
                                                 int32_t h) {
  using R = typename S::R;
  const int E = ecap<S>(w), slot = ev_slot(h);
  if (!ev_valid(s, w, h)) return inf_of<R>();
  return slot < E ? row<R, S>(w, EV_TIME, E)[slot] : R(0);
}

// api.event_priority: a live event's priority, 0 for a dead handle
template <class S>
__device__ __forceinline__ int32_t ev_prio(const S& s, const Where& w,
                                           int32_t h) {
  const int E = ecap<S>(w), slot = ev_slot(h);
  if (!ev_valid(s, w, h) || slot >= E) return 0;
  return row<int32_t, S>(w, EV_PRIO, E)[slot];
}

// the waiters of handle h (every RUNNING process awaiting it) woken with
// CANCELLED in pid order, their waits cleared: the eager arm of a cancel
template <class S>
__device__ __forceinline__ void cancel_waiters(S& s, int32_t h) {
#pragma unroll
  for (int q = 0; q < S::NP; ++q)
    if (s.aevt[q] == h && get(s, F_STATUS, q) == RUNNING) {
      wake_sig(s, q, CANCELLED);
      s.aevt[q] = -1;
    }
}

// api.event_cancel / timer_cancel (loop.timer_cancel): the event of a live
// handle removed (its slot freed, its generation bumped, the cached
// minimum scanned again); with the spec (EAGER) its waiters wake now with
// CANCELLED, without it at the next dispatch's stale scan.  Returns
// whether the handle was live
template <bool EAGER, class S>
__device__ __forceinline__ bool event_cancel(S& s, const Where& w,
                                             int32_t h) {
  using R = typename S::R;
  const int E = ecap<S>(w), slot = ev_slot(h);
  const bool ok = ev_valid(s, w, h);
  if (ok && slot < E) {
    row<R, S>(w, EV_TIME, E)[slot] = inf_of<R>();
    row<int32_t, S>(w, EV_GEN, E)[slot] += 1;
    ev_mark(s, slot, false);
    scan_table(s, w);
  }
  if constexpr (EAGER && S::M::WAITE) {
    if (ok) cancel_waiters(s, h);
  }
  return ok;
}

// api.event_reschedule: a live event moved to t, its seq kept; a
// non-finite t moves nothing and gives false
template <class S>
__device__ __forceinline__ bool event_reschedule(S& s, const Where& w,
                                                 int32_t h,
                                                 typename S::R t) {
  using R = typename S::R;
  const int E = ecap<S>(w), slot = ev_slot(h);
  const bool ok = ev_valid(s, w, h) && finite(t);
  if (ok && slot < E) {
    row<R, S>(w, EV_TIME, E)[slot] = t;
    scan_table(s, w);
  }
  return ok;
}

// api.event_reprioritize: a live event's priority changed in place
template <class S>
__device__ __forceinline__ bool event_reprioritize(S& s, const Where& w,
                                                   int32_t h, int32_t prio) {
  const int E = ecap<S>(w), slot = ev_slot(h);
  const bool ok = ev_valid(s, w, h);
  if (ok && slot < E) {
    row<int32_t, S>(w, EV_PRIO, E)[slot] = prio;
    scan_table(s, w);
  }
  return ok;
}

// slot i of the general table matches the pattern (kind, subj), either -1
// a wildcard (eventset._match)
template <class S>
__device__ __forceinline__ bool ev_match(const Where& w, int i,
                                         int32_t kind, int32_t subj) {
  using R = typename S::R;
  const int E = ecap<S>(w);
  return finite(row<R, S>(w, EV_TIME, E)[i]) &&
         (kind == -1 || row<int32_t, S>(w, EV_KIND, E)[i] == kind) &&
         (subj == -1 || row<int32_t, S>(w, EV_SUBJ, E)[i] == subj);
}

// api.event_pattern_count
template <class S>
__device__ __forceinline__ int32_t pattern_count(const S& s, const Where& w,
                                                 int32_t kind, int32_t subj) {
  int32_t n = 0;
  each_slot(s, w, [&](int i) { n += ev_match<S>(w, i, kind, subj) ? 1 : 0; });
  return n;
}

// api.event_pattern_find: the soonest match's handle, the lowest slot
// among equal times; -1 where none
template <class S>
__device__ __forceinline__ int32_t pattern_find(const S& s, const Where& w,
                                                int32_t kind, int32_t subj) {
  using R = typename S::R;
  const int E = ecap<S>(w);
  const R* time = row<R, S>(w, EV_TIME, E);
  int slot = -1;
  R t = inf_of<R>();
  each_slot(s, w, [&](int i) {
    if (ev_match<S>(w, i, kind, subj) && (slot < 0 || time[i] < t)) {
      slot = i;
      t = time[i];
    }
  });
  if (slot < 0) return -1;
  return int32_t(uint32_t(row<int32_t, S>(w, EV_GEN, E)[slot]) << 16) | slot;
}

// api.event_pattern_cancel: every match removed, the minimum scanned
// again where one was; returns their count
template <class S>
__device__ __forceinline__ int32_t pattern_cancel(S& s, const Where& w,
                                                  int32_t kind,
                                                  int32_t subj) {
  using R = typename S::R;
  const int E = ecap<S>(w);
  int32_t n = 0;
  each_slot(s, w, [&](int i) {
    if (ev_match<S>(w, i, kind, subj)) {
      row<R, S>(w, EV_TIME, E)[i] = inf_of<R>();
      row<int32_t, S>(w, EV_GEN, E)[i] += 1;
      ev_mark(s, i, false);
      n += 1;
    }
  });
  if (n > 0) scan_table(s, w);
  return n;
}

// api.priority_set (loop.priority_set): the pick and the guards read the
// priority live; written through, since a chunk stores no prio back.  A
// pid out of range changes nothing
template <class S>
__device__ __forceinline__ void priority_set(S& s, const Where& w, int p,
                                             int32_t prio) {
  if (p < 0 || p >= S::NP) return;
  COLD(s, prio, p) = prio;
  row<int32_t, S>(w, PRIO, S::NP)[p] = prio;
}

// wait_process (loop's h_wait_proc): a target finished already wakes p
// now with its exit signal; else p awaits it (a pid out of range reads as
// no process that finishes); p yields either way
template <class S>
__device__ __forceinline__ bool h_wait_proc(S& s, const Where& w, int p,
                                            const Cmd<typename S::R>& c) {
  const int32_t tgt = c.q;
  const bool in = tgt >= 0 && tgt < S::NP;
  if (in && get(s, F_STATUS, tgt) == FINISHED) {
    wake_sig(s, p, row<int32_t, S>(w, EXIT_SIG, S::NP)[tgt]);
  } else {
    put(s.apid, p, tgt);
  }
  set(s, F_PC, p, c.next_pc);
  return true;
}

// wait_event (loop's h_wait_evt): a dead handle wakes p now with
// CANCELLED; else p awaits it; p yields either way
template <class S>
__device__ __forceinline__ bool h_wait_evt(S& s, const Where& w, int p,
                                           const Cmd<typename S::R>& c) {
  if (ev_valid(s, w, c.q)) {
    put(s.aevt, p, c.q);
  } else {
    wake_sig(s, p, CANCELLED);
  }
  set(s, F_PC, p, c.next_pc);
  return true;
}

// the dispatch's scan of the event waiters (loop._dispatch_evt_wakes),
// before the event's action: a RUNNING waiter of the handle just popped
// (h_pop, -1 for a wake or an empty pop) wakes with SUCCESS, one whose
// handle has died (the lazy arm of a cancel) with CANCELLED; their seqs
// in pid order, their waits cleared
template <class S>
__device__ __forceinline__ void evt_scan(S& s, const Where& w,
                                         int32_t h_pop) {
#pragma unroll
  for (int q = 0; q < S::NP; ++q) {
    const int32_t h = s.aevt[q];
    if (h >= 0 && get(s, F_STATUS, q) == RUNNING) {
      const bool fired = h == h_pop;
      if (fired || !ev_valid(s, w, h)) {
        wake_sig(s, q, fired ? SUCCESS : CANCELLED);
        s.aevt[q] = -1;
      }
    }
  }
}

// a RUNNING process awaits an event: with the tables empty the lane stays
// live, the next step's scan wakes it with CANCELLED (make_cond)
template <class S>
__device__ __forceinline__ bool stranded(const S& s) {
  bool any = false;
#pragma unroll
  for (int q = 0; q < S::NP; ++q)
    any = any || (s.aevt[q] >= 0 && get(s, F_STATUS, q) == RUNNING);
  return any;
}

// --- the queues' readers and the priority queue's item verbs --------------

// api.queue_position: the 1-based place from the front of the first item
// of object queue Q equal to item, 0 if none; a ring slot's place is
// (slot - head) mod the ring's width, as the reference counts it
template <int Q, class S>
__device__ __forceinline__ int32_t queue_position(const S& s, const Where& w,
                                                  typename S::R item) {
  using R = typename S::R;
  const int W = w.sh.ring_width;
  const R* ring = row<R, S>(w, Q_ITEMS, S::NQ * W) + Q * W;
  int32_t best = W;
  for (int c = 0; c < W; ++c) {
    const int32_t pos = ((c - s.head[Q]) % W + W) % W;
    if (pos < s.size[Q] && ring[c] == item && pos < best) best = pos;
  }
  return best < W ? best + 1 : 0;
}

// the earliest-dequeuing live item of priority queue Q equal to item (the
// reference's _pq_match: the greatest priority, then the least seq), its
// slot, or -1
template <int Q, class S>
__device__ __forceinline__ int pq_match(const S& s, const Where& w,
                                        typename S::R item) {
  using R = typename S::R;
  using M = typename S::M;
  if constexpr (M::PMASK) {
    R pb;
    int32_t sb;
    int col;
    return pq_best<Q, true>(s, w, item, pb, sb, col) ? col : -1;
  }
  const bool* live = pq_row<bool, S>(w, M::L_PQ_LIVE, Q);
  const R* items = pq_row<R, S>(w, M::L_PQ_ITEMS, Q);
  const R* prio = pq_row<R, S>(w, M::L_PQ_PRIO, Q);
  const int32_t* seq = pq_row<int32_t, S>(w, M::L_PQ_SEQ, Q);
  R pb = -inf_of<R>();
  for (int j = 0; j < M::PQW; ++j)
    if (live[j] && items[j] == item) {
      const R x = prio[j];
      pb = (x != x || x > pb) ? x : pb;  // amax: NaN propagates
    }
  int32_t sb = I32_MAX;
  for (int j = 0; j < M::PQW; ++j)
    if (live[j] && items[j] == item && prio[j] == pb && seq[j] < sb)
      sb = seq[j];
  for (int j = 0; j < M::PQW; ++j)
    if (live[j] && items[j] == item && prio[j] == pb && seq[j] == sb)
      return j;
  return -1;
}

// api.pqueue_cancel: the matching item removed, the length recorded where
// the queue records, the rear guard signalled (no observer forwarding, as
// the reference signals it); returns whether one matched
template <int Q, class S>
__device__ __forceinline__ bool pq_cancel(S& s, const Where& w,
                                          typename S::R item) {
  using R = typename S::R;
  using M = typename S::M;
  const int j = pq_match<Q, S>(s, w, item);
  if (j < 0) return false;
  bool* live = pq_row<bool, S>(w, M::L_PQ_LIVE, Q);
  live[j] = false;
  if constexpr (M::PMASK)
    set_bit(s.pm, pq_off<Q, S>(), j, false);
  if constexpr (M::pq_rec(Q)) record(s, M::acc_pq(Q), R(pq_length<Q>(s, w)));
  guard_signal(s, M::pq_rear(Q));
  return true;
}

// api.pqueue_reprioritize: the matching item's priority changed, its seq
// kept; returns whether one matched
template <int Q, class S>
__device__ __forceinline__ bool pq_reprioritize(S& s, const Where& w,
                                                typename S::R item,
                                                typename S::R prio) {
  using M = typename S::M;
  const int j = pq_match<Q, S>(s, w, item);
  if (j < 0) return false;
  pq_row<typename S::R, S>(w, M::L_PQ_PRIO, Q)[j] = prio;
  return true;
}

// the draws of a sampler that loops (samplers.cuh: gamma, beta, pert):
// one Threefry block at the lane's counter a call
template <class S>
struct Draws {
  S& s;
  __device__ __forceinline__ void operator()(uint32_t& b0,
                                             uint32_t& b1) const {
    draw_bits(s, b0, b1);
  }
};

// returns "yielded"
template <class S>
__device__ __forceinline__ bool apply(S& s, const Where& w, int p,
                                      const Cmd<typename S::R>& c,
                                      bool is_retry) {
  using M = typename S::M;
  const int tag = c.tag < 0 ? 0 : (c.tag > N_COMMANDS - 1 ? N_COMMANDS - 1
                                                          : c.tag);
  // the waits, where the family has them (a family without them keeps
  // the switches below as they were)
  if constexpr (M::WAITP) {
    if (tag == C_WAIT_PROC) return h_wait_proc(s, w, p, c);
  }
  if constexpr (M::WAITE) {
    if (tag == C_WAIT_EVT) return h_wait_evt(s, w, p, c);
  }
  if constexpr (M::TOOLKIT) {
    switch (tag) {
      case C_POOL_ACQ:
        if constexpr (M::NK > 0)
          return by_id<0, M::NK>(c.q, [&](auto k) {
            return h_pool<decltype(k)::value, false, false>(s, w, p, c,
                                                            is_retry);
          });
        break;
      case C_POOL_ACQ_HOLD:
        if constexpr (M::NK > 0)
          return by_id<0, M::NK>(c.q, [&](auto k) {
            return h_pool<decltype(k)::value, false, true>(s, w, p, c,
                                                           is_retry);
          });
        break;
      case C_POOL_PRE:
        if constexpr (M::NK > 0 && M::MUG)
          return by_id<0, M::NK>(c.q, [&](auto k) {
            return h_pool<decltype(k)::value, true, false>(s, w, p, c,
                                                           is_retry);
          });
        break;
      case C_POOL_PRE_HOLD:
        if constexpr (M::NK > 0 && M::MUG)
          return by_id<0, M::NK>(c.q, [&](auto k) {
            return h_pool<decltype(k)::value, true, true>(s, w, p, c,
                                                          is_retry);
          });
        break;
      case C_ACQUIRE:
        if constexpr (M::NR > 0)
          return by_id<0, M::NR>(c.q, [&](auto r) {
            return h_acquire<decltype(r)::value, false>(s, w, p, c,
                                                        is_retry);
          });
        break;
      case C_ACQ_HOLD:
        if constexpr (M::NR > 0)
          return by_id<0, M::NR>(c.q, [&](auto r) {
            return h_acquire<decltype(r)::value, true>(s, w, p, c, is_retry);
          });
        break;
      case C_PREEMPT:
        if constexpr (M::NR > 0)
          return by_id<0, M::NR>(c.q, [&](auto r) {
            return h_preempt<decltype(r)::value, false>(s, w, p, c,
                                                        is_retry);
          });
        break;
      case C_PRE_HOLD:
        if constexpr (M::NR > 0)
          return by_id<0, M::NR>(c.q, [&](auto r) {
            return h_preempt<decltype(r)::value, true>(s, w, p, c, is_retry);
          });
        break;
      case C_RELEASE:
        if constexpr (M::NR > 0) {
          by_id<0, M::NR>(c.q, [&](auto r) {
            release_resource<decltype(r)::value>(s, w, p);
            return 0;
          });
          set(s, F_PC, p, c.next_pc);
          return false;
        }
        break;
      case C_POOL_REL:
        if constexpr (M::NK > 0) {
          by_id<0, M::NK>(c.q, [&](auto k) {
            release_pool<decltype(k)::value>(s, w, p, c.f);
            return 0;
          });
          set(s, F_PC, p, c.next_pc);
          return false;
        }
        break;
      case C_BUF_GET:
      case C_BUF_GET_HOLD:
        if constexpr (M::NV > 0)
          return by_id<0, M::NV>(c.q, [&](auto b) {
            return h_buffer<true, decltype(b)::value>(s, w, p, c, tag,
                                                      is_retry);
          });
        break;
      case C_BUF_PUT:
      case C_BUF_PUT_HOLD:
        if constexpr (M::NV > 0)
          return by_id<0, M::NV>(c.q, [&](auto b) {
            return h_buffer<false, decltype(b)::value>(s, w, p, c, tag,
                                                       is_retry);
          });
        break;
      case C_COND_WAIT:
        if constexpr (M::NC > 0)
          return by_id<0, M::NC>(c.q, [&](auto k) {
            return h_cond_wait<decltype(k)::value>(s, w, p, c, is_retry);
          });
        break;
      case C_PQ_PUT:
        if constexpr (M::NPQ > 0)
          return by_id<0, M::NPQ>(c.q, [&](auto q) {
            return h_pq_put<decltype(q)::value, false>(s, w, p, c, is_retry);
          });
        break;
      case C_PQ_PUT_HOLD:
        if constexpr (M::NPQ > 0)
          return by_id<0, M::NPQ>(c.q, [&](auto q) {
            return h_pq_put<decltype(q)::value, true>(s, w, p, c, is_retry);
          });
        break;
      case C_PQ_GET:
        if constexpr (M::NPQ > 0)
          return by_id<0, M::NPQ>(c.q, [&](auto q) {
            return h_pq_get<decltype(q)::value, false>(s, w, p, c, is_retry);
          });
        break;
      case C_PQ_GET_HOLD:
        if constexpr (M::NPQ > 0)
          return by_id<0, M::NPQ>(c.q, [&](auto q) {
            return h_pq_get<decltype(q)::value, true>(s, w, p, c, is_retry);
          });
        break;
      default:
        break;
    }
  }
  switch (tag) {
    case C_HOLD:
      schedule_wake(s, p, s.clock + nanmax0(c.f));
      set(s, F_PC, p, c.next_pc);
      return true;
    case C_EXIT:
      finish(s, w, p);
      return true;
    case C_JUMP:
      set(s, F_PC, p, c.next_pc);
      return false;
    case C_PUT:
    case C_GET:
    case C_PUT_HOLD:
    case C_GET_HOLD:
      if constexpr (S::NQ > 0) return h_queue(s, w, p, c, tag, is_retry);
      set_err(s, ERR_USER);
      return true;
    default:
      set_err(s, ERR_USER);
      return true;
  }
}

// ---------------------------------------------------------------------------
// The model families: each restates its model's blocks (in pc order, as
// BLOCK_NAMES in its Python module), its user leaves (offsets from U0 in
// sorted key order), which blocks draw and of what kind, and the kind the
// event's first draw takes (the converged draw of design point 3).

// what a family has unless it says otherwise: no toolkit component, no
// generated code
struct NoUCold {};
struct Family {
  static constexpr bool GEN = false, TOOLKIT = false, PEND_I = false;
  static constexpr bool PRED_BY_PID = false, ABORT = false, WSIG = false;
  static constexpr bool MUG = false;  // a pool preempt's rule
  // the waits on a process and on an event (a generated family's, where a
  // block may return them)
  static constexpr bool WAITP = false, WAITE = false;
  // the columns in dynamic shared memory (Smem), a generated family's
  // choice where they pass the static 48 KB or the register limits
  static constexpr bool DYN = false;
  // the wakes and words, the guards' seqs in shared columns (Col)
  static constexpr bool BIG = false, GBIG = false;
  // a generated family's live-slot masks (shared columns) of the
  // general table (EMASK, its ECAP slots compile-time) and of the
  // priority queues (PMASK)
  static constexpr bool EMASK = false, PMASK = false;
  static constexpr int ECAP = 0;
  static constexpr int NK = 0, NV = 0, NC = 0, NPQ = 0, PQW = 1;
  static constexpr int NR = 0, NH = 0;  // resources, user handlers
  using UCold = NoUCold;
};

// mm1.build(record=RECORD) (NS = 1) and mmc.build(NS): blocks a_start,
// a_cycle, a_exit, s_start, s_cycle; user leaves arr_mean, n_objects,
// srv_mean, wait.*
template <int NS, bool RECORD_>
struct MM : Family {
  static constexpr int NP = 1 + NS, NQ = 1, NG = 2, NSUM = 1, N_BLOCKS = 5;
  static constexpr int NPAR = 2, N_USER = 11, N_OBJ = 1, THREADS = 128;
  static constexpr int NACC = RECORD_ ? 1 : 0, U0 = cimba::queue::U0;
  static constexpr int LN_MU = 0, LN_SIGMA = 0;  // no lognormal
  static constexpr bool RECORD = RECORD_, LOGN = false, UNIF = false;
  static constexpr bool SHOP = false;
  static constexpr int A_START = 0, A_CYCLE = 1, A_EXIT = 2, S_START = 3;
  __host__ __device__ static constexpr int par_off(int i) {
    return i == 0 ? 0 : 2;  // arr_mean, srv_mean
  }
  __host__ __device__ static constexpr int sum_off(int) { return 3; }
  // blocks of 128 threads an SM that an instance's register cap allows
  // (the second __launch_bounds__ argument; ptxas caps a thread at the
  // multiple of 8 registers at most 65536 / (128 x minb)): the least cap
  // under which the instance does not spill.  ptxas takes 80 and 96
  // registers for the f32 single-server instances (96 cap), 94-124 for
  // the f32 multi-server ones and 118 for f64 mm1 (128 cap), 133-160 for
  // the other f64 instances (168 cap); a 64-register cap spills in every
  // single-server instance, a 96-register cap in the f64 ones (PERF.md)
  template <typename R>
  __host__ __device__ static constexpr int minb() {
    return sizeof(R) == 4 ? (NS == 1 ? 5 : 4) : (NS == 1 && !RECORD ? 4 : 3);
  }
  template <class S>
  __device__ static int conv_kind(const S&, int) {
    return K_EXP;
  }
  __device__ static bool draws(int b) { return b != A_EXIT; }
  __device__ static int kind(int) { return K_EXP; }
  template <class S>
  __device__ static typename S::R mean(const S& s, int b) {
    return b < A_EXIT ? s.par[0] : s.par[1];
  }
  // block b of process p; t is its draw (times its mean)
  template <class S>
  __device__ static Cmd<typename S::R> block(S& s, const Where&, int p, int b,
                                             typename S::R t) {
    using R = typename S::R;
    switch (b) {
      case A_START:
        return Cmd<R>{C_HOLD, t, R(0), A_CYCLE, 0};
      case A_CYCLE: {
        const int32_t n = COLD(s, produced, p) += 1;
        if (n >= s.n_objects) return Cmd<R>{C_PUT, s.clock, R(0), A_EXIT, 0};
        return Cmd<R>{C_PUT_HOLD, s.clock, t, A_CYCLE, 0};
      }
      case A_EXIT:
        return Cmd<R>{C_EXIT, R(0), R(0), 0, 0};
      case S_START:
        return Cmd<R>{C_GET_HOLD, R(0), t, S_START + 1, 0};
      default: {  // s_cycle
        const Sum<R> wait = sum_add(s, 0, s.clock - COLD(s, got, p));
        if (wait.n >= R(s.n_objects)) s.done = true;
        return Cmd<R>{C_GET_HOLD, R(0), t, S_START + 1, 0};
      }
    }
  }
};

// mg1.build(): mm1's blocks with a lognormal service draw; user leaves
// arr_mean, ln_mu, ln_sigma, n_objects, wait.*
struct MG1 : MM<1, true> {
  static constexpr int NPAR = 3, N_USER = 12, N_OBJ = 3;
  static constexpr int LN_MU = 1, LN_SIGMA = 2;
  static constexpr bool LOGN = true;
  __host__ __device__ static constexpr int par_off(int i) {
    return i;  // arr_mean, ln_mu, ln_sigma
  }
  __host__ __device__ static constexpr int sum_off(int) { return 4; }
  // the f32 instance at a 128-register cap, the f64 one at 168
  template <typename R>
  __host__ __device__ static constexpr int minb() {
    return sizeof(R) == 4 ? 4 : 3;
  }
  // the server (pid 1) draws the lognormal, the arrival the exponential
  template <class S>
  __device__ static int conv_kind(const S&, int subj) {
    return subj == 1 ? K_LOGN : K_EXP;
  }
  __device__ static int kind(int b) { return b < A_EXIT ? K_EXP : K_LOGN; }
  template <class S>
  __device__ static typename S::R mean(const S& s, int) {
    return s.par[0];  // the arrival's; a lognormal is taken as drawn
  }
};

// tandem.build(): blocks a_start, a_cycle, a_exit, s1_start, s1_cycle,
// s1_take, s2_start, s2_cycle, s2_take; pids 0 arrival, 1 server 1, 2
// server 2; queues 0 (station 1) and 1 (station 2); user leaves
// arr_mean, n_objects, p_back, s1_mean, s2_mean, w1.*, w2.*, wait.*
// (summaries: 0 wait, 1 w1, 2 w2)
struct Tandem : Family {
  static constexpr int NP = 3, NQ = 2, NG = 4, NSUM = 3, N_BLOCKS = 9;
  static constexpr int NPAR = 4, N_USER = 29, N_OBJ = 1, THREADS = 64;
  static constexpr int NACC = 2, U0 = cimba::queue::U0;
  static constexpr int LN_MU = 0, LN_SIGMA = 0;  // no lognormal
  static constexpr bool RECORD = true, LOGN = false, UNIF = true;
  static constexpr bool SHOP = false, PEND_I = true;
  static constexpr int A_START = 0, A_CYCLE = 1, A_EXIT = 2, S1_START = 3,
                       S1_CYCLE = 4, S1_TAKE = 5, S2_START = 6, S2_CYCLE = 7,
                       S2_TAKE = 8;
  static constexpr int P_ARR = 0, P_BACK = 1, P_S1 = 2, P_S2 = 3;
  __host__ __device__ static constexpr int par_off(int i) {
    // arr_mean, p_back, s1_mean, s2_mean
    return i == 0 ? 0 : i + 1;
  }
  __host__ __device__ static constexpr int sum_off(int j) {
    return j == 0 ? 21 : (j == 1 ? 5 : 13);  // wait, w1, w2
  }
  // 64 threads a block (the f64 cold state of 128 would pass the 48 KB
  // of static shared memory): 8 blocks an SM at f32's 128-register cap, 6
  // at f64's 168
  template <typename R>
  __host__ __device__ static constexpr int minb() {
    return sizeof(R) == 4 ? 8 : 6;
  }
  // server 2's first draw at s2_cycle is the routing uniform; every
  // other event's first draw an exponential
  template <class S>
  __device__ static int conv_kind(const S& s, int subj) {
    return subj == 2 && get(s, F_PC, 2) == S2_CYCLE ? K_UNIF : K_EXP;
  }
  __device__ static bool draws(int b) {
    return b != A_EXIT && b != S1_CYCLE;
  }
  __device__ static int kind(int b) { return b == S2_CYCLE ? K_UNIF : K_EXP; }
  template <class S>
  __device__ static typename S::R mean(const S& s, int b) {
    return b < A_EXIT ? s.par[P_ARR]
                      : (b < S2_START ? s.par[P_S1] : s.par[P_S2]);
  }
  template <class S>
  __device__ static Cmd<typename S::R> block(S& s, const Where&, int p, int b,
                                             typename S::R t) {
    using R = typename S::R;
    switch (b) {
      case A_START:
        return Cmd<R>{C_HOLD, t, R(0), A_CYCLE, 0};
      case A_CYCLE: {
        const int32_t n = COLD(s, produced, p) += 1;
        if (n >= s.n_objects) return Cmd<R>{C_PUT, s.clock, R(0), A_EXIT, 0};
        return Cmd<R>{C_PUT_HOLD, s.clock, t, A_CYCLE, 0};
      }
      case A_EXIT:
        return Cmd<R>{C_EXIT, R(0), R(0), 0, 0};
      case S1_START:
      case S1_TAKE:
        return Cmd<R>{C_GET_HOLD, R(0), t, S1_CYCLE, 0};
      case S1_CYCLE: {
        // the item's q1-entry timestamp gives the per-visit sojourn; it
        // goes on to q2 stamped with its q2 entry
        const R v = s.clock - COLD(s, got, p);
        sum_add(s, 0, v);
        sum_add(s, 1, v);
        return Cmd<R>{C_PUT, s.clock, R(0), S1_TAKE, 1};
      }
      case S2_CYCLE: {
        const R v = s.clock - COLD(s, got, p);
        sum_add(s, 0, v);
        sum_add(s, 2, v);
        // t is the routing uniform: feedback to q1, or a departure
        const bool feedback = t < s.par[P_BACK];
        const int32_t departed = COLD(s, produced, p) += feedback ? 0 : 1;
        if (departed >= s.n_objects) s.done = true;
        if (feedback) return Cmd<R>{C_PUT, s.clock, R(0), S2_TAKE, 0};
        return Cmd<R>{C_JUMP, R(0), R(0), S2_TAKE, 0};
      }
      default:  // s2_start, s2_take
        return Cmd<R>{C_GET_HOLD, R(0), t, S2_CYCLE, 1};
    }
  }
};

// jobshop.build(): blocks a_start, a_entry, a_store, a_exit, b_take, b_svc,
// b_fin, mt_wait, mt_act, mt_rel; pids 0 stage A, 1 and 2 stage B, 3
// maintenance; guards 0 the buffer's front, 1 its rear, 2 the pool's, 3
// the condition's; user leaves arr_mean, done.*, maintenance_runs,
// n_jobs, work_mean.  Every draw is an exponential: arr_mean's (a_start,
// a_store), work_mean's (a_entry) or work_mean * b_slow's (b_svc).
struct Shop : Family {
  static constexpr int NP = 4, NQ = 0, NG = 4, NSUM = 1, N_BLOCKS = 10;
  static constexpr int NPAR = 2, N_USER = 12, N_OBJ = 10, THREADS = 64;
  static constexpr int NACC = 2, U0 = SHOP_U0, MRUNS = 9;
  static constexpr int LN_MU = 0, LN_SIGMA = 0;  // no lognormal
  static constexpr bool RECORD = false, LOGN = false, UNIF = false;
  static constexpr bool SHOP = true, TOOLKIT = true;
  // one pool, one buffer, one condition observing the buffer's guards;
  // the pool's StepAccum row 0, the buffer's row 1
  static constexpr int NK = 1, NV = 1, NC = 1;
  static constexpr int G_FRONT = 0, G_REAR = 1, G_POOL = 2, G_COND = 3;
  __host__ __device__ static constexpr int g_pool(int) { return G_POOL; }
  __host__ __device__ static constexpr int g_front(int) { return G_FRONT; }
  __host__ __device__ static constexpr int g_rear(int) { return G_REAR; }
  __host__ __device__ static constexpr int g_cond(int) { return G_COND; }
  __host__ __device__ static constexpr bool observes(int, int g) {
    return g == G_FRONT || g == G_REAR;
  }
  __host__ __device__ static constexpr bool pool_rec(int) { return true; }
  __host__ __device__ static constexpr bool buf_rec(int) { return true; }
  __host__ __device__ static constexpr int acc_pool(int) { return 0; }
  __host__ __device__ static constexpr int acc_buf(int) { return 1; }
  template <typename R>
  __device__ static R pool_cap(const Where& w, int) {
    return R(w.sh.pool_cap);
  }
  template <typename R>
  __device__ static R buf_cap(const Where& w, int) {
    return R(w.sh.buf_cap);
  }
  static constexpr int A_START = 0, A_ENTRY = 1, A_STORE = 2, A_EXIT = 3,
                       B_TAKE = 4, B_SVC = 5, B_FIN = 6, MT_WAIT = 7,
                       MT_ACT = 8, MT_REL = 9;
  __host__ __device__ static constexpr int par_off(int i) {
    return i == 0 ? 0 : 11;  // arr_mean, work_mean
  }
  __host__ __device__ static constexpr int sum_off(int) { return 1; }
  // 64 threads a block (the f64 cold state of 128 would pass the 48 KB
  // of static shared memory)
  template <typename R>
  __host__ __device__ static constexpr int minb() {
    return sizeof(R) == 4 ? 8 : 6;
  }
  template <class S>
  __device__ static int conv_kind(const S&, int) {
    return K_EXP;
  }
  __device__ static bool draws(int b) {
    return b == A_START || b == A_ENTRY || b == A_STORE || b == B_SVC;
  }
  __device__ static int kind(int) { return K_EXP; }
  template <class S>
  __device__ static typename S::R mean(const S& s, int b) {
    return b == A_ENTRY ? s.par[1] : (b == B_SVC ? s.b_mean : s.par[0]);
  }
  // the backlog condition: the buffer's level at or above the backlog
  template <int C, class S>
  __device__ static bool cond_holds(const S& s, const Where& w, int) {
    return s.buf_level[0] >= typename S::R(w.sh.backlog);
  }
  template <class S>
  __device__ static Cmd<typename S::R> block(S& s, const Where& w, int p,
                                             int b, typename S::R t) {
    using R = typename S::R;
    switch (b) {
      case A_START:
        return Cmd<R>{C_HOLD, t, R(0), A_ENTRY, 0};
      case A_ENTRY:
        return Cmd<R>{C_POOL_ACQ_HOLD, R(1), t, A_STORE, 0};
      case A_STORE: {
        const int32_t n = COLD(s, produced, p) += 1;
        release_pool<0>(s, w, p, R(1));
        if (n >= s.n_objects) return Cmd<R>{C_BUF_PUT, R(1), R(0), A_EXIT, 0};
        return Cmd<R>{C_BUF_PUT_HOLD, R(1), t, A_ENTRY, 0};
      }
      case A_EXIT:
        return Cmd<R>{C_EXIT, R(0), R(0), 0, 0};
      case B_TAKE:
        return Cmd<R>{C_BUF_GET, R(1), R(0), B_SVC, 0};
      case B_SVC:
        return Cmd<R>{C_POOL_ACQ_HOLD, R(1), t, B_FIN, 0};
      case B_FIN: {
        const Sum<R> d = sum_add(s, 0, s.clock);
        if (d.n >= R(s.n_objects)) s.done = true;
        release_pool<0>(s, w, p, R(1));
        return Cmd<R>{C_BUF_GET, R(1), R(0), B_SVC, 0};
      }
      case MT_WAIT:
        return Cmd<R>{C_COND_WAIT, R(0), R(0), MT_ACT, 0};
      case MT_ACT:
        s.runs += 1;
        return Cmd<R>{C_POOL_ACQ_HOLD, R(1), R(2), MT_REL, 0};
      default:  // mt_rel
        release_pool<0>(s, w, p, R(1));
        return Cmd<R>{C_COND_WAIT, R(0), R(0), MT_ACT, 0};
    }
  }
};

template <int FAMILY, int NS, bool RECORD, typename R>
struct ModelOf {
  using type = MM<NS, RECORD>;
};
template <typename R>
struct ModelOf<F_MG1, 1, true, R> {
  using type = MG1;
};
template <typename R>
struct ModelOf<F_TANDEM, 2, true, R> {
  using type = Tandem;
};
template <typename R>
struct ModelOf<F_SHOP, 2, true, R> {
  using type = Shop;
};


// ---------------------------------------------------------------------------

// one block of process p; x is the event's converged variate, of kind
// xkind, while `fresh` (no block of this event has drawn yet)
template <class S>
__device__ __forceinline__ Cmd<typename S::R> run_block(
    S& s, const Where& w, int p, typename S::R x, int xkind, bool& fresh,
    int32_t sig) {
  using R = typename S::R;
  using M = typename S::M;
  const int b = get(s, F_PC, p);  // clamped to a block when loaded
  if constexpr (M::GEN) {
    return M::block(s, w, p, b, sig);
  } else {
    R t = R(0);
    if (M::draws(b)) {
      const int kind = M::kind(b);
      if (!fresh || kind != xkind) {
        uint32_t b0, b1;
        threefry2x32(s.k0, s.k1, s.lo, s.hi, b0, b1);
        x = variate(s, kind, b0, b1);
      }
      fresh = false;
      s.lo += 1u;
      if (s.lo == 0u) s.hi += 1u;
      t = kind == K_EXP ? M::mean(s, b) * x : x;
    }
    return M::block(s, w, p, b, t);
  }
}

template <class S>
__device__ __forceinline__ void resume(S& s, const Where& w, int p,
                                       int32_t sig, typename S::R x,
                                       int xkind) {
  using R = typename S::R;
  put(s.wt, p, inf_of<R>());
  // any delivery ends a wait on a process or an event (loop's resume)
  if constexpr (S::M::WAITP) put(s.apid, p, -1);
  if constexpr (S::M::WAITE) put(s.aevt, p, -1);
  const int32_t tag = get(s, F_TAG, p);
  const bool has_pend = tag != NO_PEND;
  bool use_pend = has_pend && sig == SUCCESS;
  Cmd<R> pend{tag, R(0), R(0), 0, 0};
  if (S::M::ABORT ? has_pend : use_pend) {
    pend.f = COLD(s, pend_f, p);
    pend.f3 = COLD(s, pend_f3, p);
    pend.next_pc = COLD(s, pend_pc, p);
    if constexpr (S::M::PEND_I) pend.q = s.cold_q->pend_i[p][s.t];
    if constexpr (S::M::TOOLKIT) pend.f2 = SCOL(s, pend_f2, p);
  }
  set(s, F_TAG, p, NO_PEND);
  set(s, F_GUARD, p, -1);
  // a non-SUCCESS wake of a pended process (a timer or an interrupt)
  // aborts its wait, after the unwait above (loop's resume)
  if constexpr (S::M::ABORT) {
    if (has_pend && sig != SUCCESS) abort_cleanup(s, w, p, pend, sig);
  }
  bool yielded = false, fresh = true;
  int n = 0;
  while (!yielded && get(s, F_STATUS, p) == RUNNING && s.err == 0 &&
         n < MAX_CHAIN) {
    // one apply for the retried command and a block's: the lanes of a
    // warp that take either run the handlers together
    const Cmd<R> c =
        use_pend ? pend : run_block(s, w, p, x, xkind, fresh, sig);
    yielded = apply(s, w, p, c, use_pend);
    use_pend = false;
    sig = SUCCESS;  // a chained block resumes with SUCCESS
    ++n;
  }
  if (n >= MAX_CHAIN) set_err(s, ERR_CHAIN_RUNAWAY);
}

// one event: the pick over the cached general-table minimum and the
// dense wakes (whose minimum t_w the liveness check computed), the
// converged draw, the resume
template <class S>
__device__ __forceinline__ void step(S& s, const Where& w,
                                     typename S::R t_w) {
  using R = typename S::R;
  const bool found_e = finite(s.t_e);
  const bool found_w = finite(t_w);
  if (!(found_e || found_w)) {
    if constexpr (S::M::WAITE) {
      // a stale waiter's CANCELLED wake may come of an empty pop: out of
      // events only where none was armed
      evt_scan(s, w, -1);
      bool any_w = false;
#pragma unroll
      for (int q = 0; q < S::NP; ++q) any_w = any_w || finite(s.wt[q]);
      s.done = !any_w;
    } else {
      s.done = true;
    }
    return;
  }
  // dense wakes at t_w: prio desc (read live from procs.prio), seq asc,
  // lowest pid
  bool g = false;
  int32_t p_w = I32_MIN, s_w = I32_MAX;
  int pid_w = 0;
#pragma unroll
  for (int q = 0; q < S::NP; ++q)
    if (s.wt[q] == t_w) {
      const int32_t pq = COLD(s, prio, q);
      if (!g || pq > p_w || (pq == p_w && s.wseq[q] < s_w)) {
        g = true;
        p_w = pq;
        s_w = s.wseq[q];
        pid_w = q;
      }
    }
  const int E = ecap<S>(w);
  bool wake_first = found_w && (!found_e || t_w < s.t_e);
  if (found_w && found_e && t_w == s.t_e) {  // a tie: the slot's prio, seq
    const int32_t p_e = row<int32_t, S>(w, EV_PRIO, E)[s.slot_e];
    const int32_t s_e = row<int32_t, S>(w, EV_SEQ, E)[s.slot_e];
    wake_first = p_w > p_e || (p_w == p_e && s_w < s_e);
  }
  int32_t subj, arg;
  int32_t kind = 0;  // K_PROC; a table event's own where handlers exist
  int32_t h_pop = -1;  // the popped table event's handle (M::WAITE)
  if (wake_first) {
    s.clock = t_w;
    subj = pid_w;
    if constexpr (S::M::WSIG) {
      arg = GCOL(s, wsig, pid_w);
    } else {
      arg = get(s, F_SIG, pid_w);
    }
    put(s.wt, pid_w, inf_of<R>());
  } else {
    s.clock = s.t_e;
    subj = row<int32_t, S>(w, EV_SUBJ, E)[s.slot_e];
    arg = row<int32_t, S>(w, EV_ARG, E)[s.slot_e];
    if constexpr (S::M::NH > 0)
      kind = row<int32_t, S>(w, EV_KIND, E)[s.slot_e];
    row<R, S>(w, EV_TIME, E)[s.slot_e] = inf_of<R>();
    ev_mark(s, s.slot_e, false);
    if constexpr (S::M::WAITE)
      h_pop = int32_t(uint32_t(row<int32_t, S>(w, EV_GEN, E)[s.slot_e])
                      << 16) | s.slot_e;
    row<int32_t, S>(w, EV_GEN, E)[s.slot_e] += 1;
    scan_table(s, w);
  }
  s.n_events += 1;  // K_PROC and K_TIMER both resume
  // the event's waiters wake before its action runs
  if constexpr (S::M::WAITE) evt_scan(s, w, h_pop);
  if constexpr (S::M::GEN) {  // its blocks draw where they draw
    if constexpr (S::M::NH > 0) {
      // kind N_KINDS + k calls user handler k (a compile-time id), a kind
      // past the table the last handler (loop's clip)
      if (kind >= N_KINDS) {
        by_id<0, S::M::NH>(kind - N_KINDS, [&](auto k) {
          S::M::template handler<decltype(k)::value>(s, w, subj, arg);
          return 0;
        });
        return;
      }
    }
    if (subj >= 0 && subj < S::NP && get(s, F_STATUS, subj) == RUNNING)
      resume(s, w, subj, arg, R(0), 0);
  } else {
    // the converged draw, at the counter as the event found it
    const int xkind = S::M::conv_kind(s, subj);
    uint32_t b0, b1;
    threefry2x32(s.k0, s.k1, s.lo, s.hi, b0, b1);
    R x = variate(s, xkind, b0, b1);
    pin(x);
    if (subj >= 0 && subj < S::NP && get(s, F_STATUS, subj) == RUNNING)
      resume(s, w, subj, arg, x, xkind);
  }
}

// a lane's value of a leaf, loaded into a register or column (LOAD) or
// stored back from it
template <bool LOAD, typename T, typename V>
__device__ __forceinline__ void xfer(T* mem, V& v) {
  if constexpr (LOAD) {
    v = *mem;
  } else {
    *mem = v;
  }
}

// A generated family's part of the state, loaded (LOAD) or stored: the
// queues' StepAccum rows, the pools (level, grab counter, each process's
// holding and grab order, StepAccum rows), the buffers (level, StepAccum
// rows), the toolkit's pend_f2, the locals and the user leaves (their
// columns, M::xfer_user); positions M::L_* in the Sim's leaf list (-1:
// absent)
template <bool LOAD, int LACC, int N, class S>
__device__ __forceinline__ void acc_rows(S& s, const Where& w, int row0) {
  using R = typename S::R;
  if constexpr (LACC >= 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
#pragma unroll
      for (int i = 0; i < 10; ++i)
        xfer<LOAD>(row<R, S>(w, LACC + i, N) + k, ACC(s, row0 + k, i));
      xfer<LOAD>(row<bool, S>(w, LACC + 10, N) + k,
                 s.cold_acc->started[row0 + k][s.t]);
    }
  }
}

template <bool LOAD, class S>
__device__ __forceinline__ void gen_state(S& s, const Where& w) {
  using R = typename S::R;
  using M = typename S::M;
  constexpr int NP = S::NP, NK = M::NK, NV = M::NV;
  acc_rows<LOAD, M::L_QACC, S::NQ>(s, w, M::acc_q(0));
  if constexpr (NK > 0) {
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      xfer<LOAD>(row<R, S>(w, M::L_P_LEVEL, NK) + k, s.pool_level[k]);
      xfer<LOAD>(row<int32_t, S>(w, M::L_P_NEXT_SEQ, NK) + k,
                 s.pool_next_seq[k]);
      each<S::BIG, NP>([&](int q) {
        xfer<LOAD>(row<R, S>(w, M::L_P_HELD, NK * NP) + k * NP + q,
                   SCOL(s, held, k * NP + q));
        xfer<LOAD>(row<int32_t, S>(w, M::L_P_HELD_SEQ, NK * NP) + k * NP + q,
                   SCOL(s, held_seq, k * NP + q));
      });
    }
    acc_rows<LOAD, M::L_PACC, NK>(s, w, M::acc_pool(0));
  }
  if constexpr (NV > 0) {
#pragma unroll
    for (int b = 0; b < NV; ++b)
      xfer<LOAD>(row<R, S>(w, M::L_B_LEVEL, NV) + b, s.buf_level[b]);
    acc_rows<LOAD, M::L_BACC, NV>(s, w, M::acc_buf(0));
  }
  if constexpr (M::NR > 0) {
#pragma unroll
    for (int r = 0; r < M::NR; ++r)
      xfer<LOAD>(row<int32_t, S>(w, M::L_R_HOLDER, M::NR) + r, s.holder[r]);
    acc_rows<LOAD, M::L_RACC, M::NR>(s, w, M::acc_res(0));
  }
  if constexpr (M::TOOLKIT) {
    each<S::BIG, NP>([&](int q) {
      xfer<LOAD>(row<R, S>(w, PEND_F2, NP) + q, SCOL(s, pend_f2, q));
    });
  }
  if constexpr (M::WSIG) {
    each<S::BIG, NP>([&](int q) {
      xfer<LOAD>(row<int32_t, S>(w, WK_SIG, NP) + q, GCOL(s, wsig, q));
    });
  }
  if constexpr (M::NPQ > 0) {
#pragma unroll
    for (int k = 0; k < M::NPQ; ++k)
      xfer<LOAD>(row<int32_t, S>(w, M::L_PQ_NEXT_SEQ, M::NPQ) + k,
                 GCOL(s, pq_next_seq, k));
    acc_rows<LOAD, M::L_PQACC, M::NPQ>(s, w, M::acc_pq(0));
  }
  each<S::BIG, NP * M::NF>([&](int i) {
    xfer<LOAD>(row<R, S>(w, LOCALS_F, NP * M::NF) + i, UCOL(s, lf, i));
  });
  each<S::BIG, NP * M::NI>([&](int i) {
    xfer<LOAD>(row<int32_t, S>(w, LOCALS_I, NP * M::NI) + i, UCOL(s, li, i));
  });
  M::template xfer_user<LOAD>(s, w);
}

template <class S>
__device__ __forceinline__ void load(S& s, const Where& w) {
  using R = typename S::R;
  using C = typename S::C;
  using M = typename S::M;
  constexpr int NP = S::NP, NQ = S::NQ, NG = S::NG;
  s.clock = row<R, S>(w, CLOCK, 1)[0];
  s.k0 = uint32_t(row<int64_t, S>(w, KEY0, 1)[0]);
  s.k1 = uint32_t(row<int64_t, S>(w, KEY1, 1)[0]);
  s.lo = uint32_t(row<int64_t, S>(w, CTR_LO, 1)[0]);
  s.hi = uint32_t(row<int64_t, S>(w, CTR_HI, 1)[0]);
  s.next_seq = row<int32_t, S>(w, EV_NEXT_SEQ, 1)[0];
  each<S::BIG, NP>([&](int q) {
    s.wt[q] = row<R, S>(w, WK_TIME, NP)[q];
    s.wseq[q] = row<int32_t, S>(w, WK_SEQ, NP)[q];
    s.word[q] = pack<M::N_BLOCKS, NG>(row<int32_t, S>(w, PC, NP)[q],
                                      row<int32_t, S>(w, STATUS, NP)[q],
                                      row<int32_t, S>(w, PEND_TAG, NP)[q],
                                      row<int32_t, S>(w, PEND_GUARD, NP)[q],
                                      row<int32_t, S>(w, WK_SIG, NP)[q]);
    COLD(s, prio, q) = row<int32_t, S>(w, PRIO, NP)[q];
    COLD(s, pend_pc, q) = row<int32_t, S>(w, PEND_PC, NP)[q];
    COLD(s, pend_seq, q) = row<int32_t, S>(w, PEND_SEQ, NP)[q];
    COLD(s, pend_f, q) = row<R, S>(w, PEND_F, NP)[q];
    COLD(s, pend_f3, q) = row<R, S>(w, PEND_F3, NP)[q];
    COLD(s, got, q) = row<R, S>(w, GOT, NP)[q];
    if constexpr (!M::GEN)
      COLD(s, produced, q) = row<int32_t, S>(
          w, LOCALS_I, NP * w.sh.n_ilocals)[q * w.sh.n_ilocals];
    if constexpr (M::PEND_I)
      s.cold_q->pend_i[q][s.t] = row<int32_t, S>(w, PEND_I, NP)[q];
  });
  s.dirty = 0u;
  each<S::GBIG, NG>([&](int g) {
    s.gseq[g] = row<int32_t, S>(w, GUARD_NEXT_SEQ, NG)[g];
  });
  if constexpr (M::WAITP)
    each<S::BIG, NP>([&](int q) {
      s.apid[q] = row<int32_t, S>(w, AWAIT_PID, NP)[q];
    });
  if constexpr (M::WAITE)
    each<S::BIG, NP>([&](int q) {
      s.aevt[q] = row<int32_t, S>(w, AWAIT_EVT, NP)[q];
    });
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    s.head[q] = row<int32_t, S>(w, Q_HEAD, NQ)[q];
    s.size[q] = row<int32_t, S>(w, Q_SIZE, NQ)[q];
  }
  if constexpr (M::GEN) {
    gen_state<true>(s, w);
  } else {
#pragma unroll
    for (int i = 0; i < M::NPAR; ++i)
      s.par[i] = row<R, S>(w, user<M>(M::par_off(i)), 1)[0];
    s.n_objects = row<int32_t, S>(w, user<M>(M::N_OBJ), 1)[0];
#pragma unroll
    for (int j = 0; j < M::NSUM; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        COLD(s, sums, 8 * j + i) =
            row<R, S>(w, user<M>(M::sum_off(j) + i), 1)[0];
  }
  if constexpr (M::SHOP) {
    // the pool (one: its [L, 1] and [L, 1, NP] rows) and the buffer
    s.pool_level[0] = row<R, S>(w, P_LEVEL, 1)[0];
    s.pool_next_seq[0] = row<int32_t, S>(w, P_NEXT_SEQ, 1)[0];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      SCOL(s, held, q) = row<R, S>(w, P_HELD, NP)[q];
      SCOL(s, held_seq, q) = row<int32_t, S>(w, P_HELD_SEQ, NP)[q];
      SCOL(s, pend_f2, q) = row<R, S>(w, PEND_F2, NP)[q];
    }
    s.buf_level[0] = row<R, S>(w, B_LEVEL, 1)[0];
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      ACC(s, 0, i) = row<R, S>(w, P_ACC + i, 1)[0];
      ACC(s, 1, i) = row<R, S>(w, B_ACC + i, 1)[0];
    }
    s.cold_acc->started[0][s.t] = row<bool, S>(w, P_ACC + 10, 1)[0];
    s.cold_acc->started[1][s.t] = row<bool, S>(w, B_ACC + 10, 1)[0];
    s.runs = row<int32_t, S>(w, user<M>(M::MRUNS), 1)[0];
    // the b_svc block's mean, work_mean * b_slow, as the blocks compute it
    s.b_mean = s.par[1] * R(w.sh.b_slow);
  }
  if constexpr (S::RECORD) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int i = 0; i < 10; ++i)
        ACC(s, q, i) = row<R, S>(w, A_N + i, NQ)[q];
      s.cold_acc->started[q][s.t] = row<bool, S>(w, A_STARTED, NQ)[q];
    }
  }
  s.done = row<bool, S>(w, tail<S>(DONE), 1)[0];
  s.err = row<int32_t, S>(w, tail<S>(ERR), 1)[0];
  s.n_events = row<C, S>(w, tail<S>(N_EVENTS), 1)[0];
}

// the fields a chunk can change (the packed ones where they were
// written, or all of them in a family of BIG, which read the same as
// they were loaded where not written); prio, the keys, the parameters
// and the general table's other columns are only read (a spawn writes
// the prio, exit signal and waits of the row it resets through)
template <class S>
__device__ __forceinline__ void store(const S& s, const Where& w) {
  using R = typename S::R;
  using C = typename S::C;
  using M = typename S::M;
  constexpr int NP = S::NP, NQ = S::NQ, NG = S::NG;
  row<R, S>(w, CLOCK, 1)[0] = s.clock;
  row<int64_t, S>(w, CTR_LO, 1)[0] = int64_t(s.lo);
  row<int64_t, S>(w, CTR_HI, 1)[0] = int64_t(s.hi);
  row<int32_t, S>(w, EV_NEXT_SEQ, 1)[0] = s.next_seq;
  constexpr Leaf packed[5] = {PC, STATUS, PEND_TAG, PEND_GUARD, WK_SIG};
  each<S::BIG, NP>([&](int q) {
    row<R, S>(w, WK_TIME, NP)[q] = s.wt[q];
    row<int32_t, S>(w, WK_SEQ, NP)[q] = s.wseq[q];
#pragma unroll
    for (int f = 0; f < 5; ++f) {
      if constexpr (S::BIG) {  // every field but the wake's signal column
        if (f != F_SIG || !M::WSIG)
          row<int32_t, S>(w, packed[f], NP)[q] = field(s.word[q], f);
      } else if (s.dirty & (typename S::Dirty(1) << (f * NP + q))) {
        row<int32_t, S>(w, packed[f], NP)[q] = field(s.word[q], f);
      }
    }
    row<int32_t, S>(w, PEND_PC, NP)[q] = COLD(s, pend_pc, q);
    row<int32_t, S>(w, PEND_SEQ, NP)[q] = COLD(s, pend_seq, q);
    row<R, S>(w, PEND_F, NP)[q] = COLD(s, pend_f, q);
    row<R, S>(w, PEND_F3, NP)[q] = COLD(s, pend_f3, q);
    row<R, S>(w, GOT, NP)[q] = COLD(s, got, q);
    if constexpr (!M::GEN)
      row<int32_t, S>(w, LOCALS_I, NP * w.sh.n_ilocals)[q * w.sh.n_ilocals] =
          COLD(s, produced, q);
    if constexpr (M::PEND_I)
      row<int32_t, S>(w, PEND_I, NP)[q] = s.cold_q->pend_i[q][s.t];
    if constexpr (M::SHOP) {
      row<R, S>(w, P_HELD, NP)[q] = SCOL(s, held, q);
      row<int32_t, S>(w, P_HELD_SEQ, NP)[q] = SCOL(s, held_seq, q);
      row<R, S>(w, PEND_F2, NP)[q] = SCOL(s, pend_f2, q);
    }
    if constexpr (!S::BIG) {
      if (s.dirty & (typename S::Dirty(1) << (F_BLOCK * NP + q))) {
        if constexpr (!M::TOOLKIT) row<R, S>(w, PEND_F2, NP)[q] = R(0);
        if constexpr (!M::PEND_I) row<int32_t, S>(w, PEND_I, NP)[q] = 0;
      }
    }
  });
  each<S::GBIG, NG>([&](int g) {
    row<int32_t, S>(w, GUARD_NEXT_SEQ, NG)[g] = s.gseq[g];
  });
  if constexpr (M::WAITP)
    each<S::BIG, NP>([&](int q) {
      row<int32_t, S>(w, AWAIT_PID, NP)[q] = s.apid[q];
    });
  if constexpr (M::WAITE)
    each<S::BIG, NP>([&](int q) {
      row<int32_t, S>(w, AWAIT_EVT, NP)[q] = s.aevt[q];
    });
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    row<int32_t, S>(w, Q_HEAD, NQ)[q] = s.head[q];
    row<int32_t, S>(w, Q_SIZE, NQ)[q] = s.size[q];
  }
  if constexpr (M::GEN) {
    gen_state<false>(s, w);
  } else {
#pragma unroll
    for (int j = 0; j < M::NSUM; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        row<R, S>(w, user<M>(M::sum_off(j) + i), 1)[0] =
            COLD(s, sums, 8 * j + i);
  }
  if constexpr (M::SHOP) {
    row<R, S>(w, P_LEVEL, 1)[0] = s.pool_level[0];
    row<int32_t, S>(w, P_NEXT_SEQ, 1)[0] = s.pool_next_seq[0];
    row<R, S>(w, B_LEVEL, 1)[0] = s.buf_level[0];
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      row<R, S>(w, P_ACC + i, 1)[0] = ACC(s, 0, i);
      row<R, S>(w, B_ACC + i, 1)[0] = ACC(s, 1, i);
    }
    row<bool, S>(w, P_ACC + 10, 1)[0] = s.cold_acc->started[0][s.t];
    row<bool, S>(w, B_ACC + 10, 1)[0] = s.cold_acc->started[1][s.t];
    row<int32_t, S>(w, user<M>(M::MRUNS), 1)[0] = s.runs;
  }
  if constexpr (S::RECORD) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int i = 0; i < 10; ++i)
        row<R, S>(w, A_N + i, NQ)[q] = ACC(s, q, i);
      row<bool, S>(w, A_STARTED, NQ)[q] = s.cold_acc->started[q][s.t];
    }
  }
  row<bool, S>(w, tail<S>(DONE), 1)[0] = s.done;
  row<int32_t, S>(w, tail<S>(ERR), 1)[0] = s.err;
  row<C, S>(w, tail<S>(N_EVENTS), 1)[0] = s.n_events;
}

// the pointer array's leaves of the model's Sim, without its t_stop
template <class M>
__host__ __device__ constexpr int n_base_leaves() {
  return at<M>(M::U0 + M::N_USER + N_TAIL);
}

// Load lane l's state, run up to chunk_steps events while the lane is
// live (make_cond), and store it back.  Leaves are lane-first; the
// queues' accumulator rows are [L, NQ].  The horizon is H_NONE, the
// scalar t_end (H_SCALAR) or the lane's t_stop leaf (H_LANE), compared
// as make_cond compares it: nxt <= lim in the TIME type.  A lane dead at
// the start stores back what it loaded, so a chunk past the end of a run
// changes no leaf.
template <typename R, typename C, class M>
__device__ __forceinline__ void run_lane(const Ptrs& ps, int l,
                                         const Shape& sh, int chunk_steps,
                                         int horizon, R t_end,
                                         Cold<R, M>& cold,
                                         ColdAcc<R, M>& cold_acc,
                                         ColdQ<M>& cold_q,
                                         ColdShop<R, M>& cold_shop,
                                         ColdSig<M>& cold_sig,
                                         typename M::UCold& ucold,
                                         ColdWake<R, M>* wake = nullptr,
                                         ColdG<M>* g = nullptr,
                                         ColdAwait<M>* aw = nullptr,
                                         ColdMask<M>* mk = nullptr) {
  using S = State<R, C, M>;
  S s;
  s.cold = &cold;
  s.cold_acc = &cold_acc;
  s.cold_q = &cold_q;
  s.cold_shop = &cold_shop;
  s.cold_sig = &cold_sig;
  s.ucold = &ucold;
  s.t = threadIdx.x;
  if constexpr (S::BIG) {
    s.wt.base = &wake->wt[0][s.t];
    s.wseq.base = &wake->wseq[0][s.t];
    s.word.base = &wake->word[0][s.t];
  }
  if constexpr (S::GBIG) s.gseq.base = &g->gseq[0][s.t];
  if constexpr (S::BIG && M::WAITP) s.apid.base = &aw->apid[0][s.t];
  if constexpr (S::BIG && M::WAITE) s.aevt.base = &aw->aevt[0][s.t];
  if constexpr (M::EMASK) s.em.base = &mk->words[0][s.t];
  if constexpr (M::PMASK) s.pm.base = &mk->words[ColdMask<M>::EW][s.t];
  load(s, Where{ps, sh, l});
  load_masks(s, Where{ps, sh, l});
  scan_table(s, Where{ps, sh, l});
  for (int k = 0; k < chunk_steps; ++k) {
    // liveness: a finite time in either table, not done, no error,
    // and the next time within the horizon
    R t_w = inf_of<R>();
    bool any_w = false;
#pragma unroll
    for (int q = 0; q < S::NP; ++q) {
      any_w = any_w || finite(s.wt[q]);
      t_w = s.wt[q] < t_w ? s.wt[q] : t_w;
    }
    const R nxt = t_w < s.t_e ? t_w : s.t_e;
    bool live = !s.done && s.err == 0 && (s.any_e || any_w) &&
                within_horizon(nxt, horizon, t_end,
                               ps.p[n_base_leaves<M>()], l);
    if constexpr (M::WAITE) {
      // a waiter stranded by a cancel that drained the tables keeps the
      // lane live, the horizon aside (make_cond)
      if (!s.done && s.err == 0 && !(s.any_e || any_w)) live = stranded(s);
    }
    if (!live) break;
    step(s, Where{ps, sh, opaque(l)}, t_w);
  }
  store(s, Where{ps, sh, opaque(l)});
}

// A generated family (core/emit.py): the header the build names defines
// Gen<float> or Gen<double>, a spec's blocks, predicates, components and
// leaf positions in the profile it was traced in, with CIMBA_GEN_F32 or
// CIMBA_GEN_F64.  A resume's chain is bounded at MAX_CHAIN here too, the
// rule the plain engine (make_run) keeps; user specs can now reach it,
// where the reference's kernel mode bounds a chain at spec.max_chain.
#ifdef CIMBA_GEN_HEADER
#include CIMBA_GEN_HEADER
template <typename R>
struct ModelOf<F_GEN, 0, false, R> {
  using type = Gen<R>;
};
#endif

template <typename R, typename C, int FAMILY, int NS, bool RECORD>
__global__ void __launch_bounds__(
    ModelOf<FAMILY, NS, RECORD, R>::type::THREADS,
    ModelOf<FAMILY, NS, RECORD, R>::type::template minb<R>())
chunk_kernel(const __grid_constant__ Ptrs ps, int lanes,
             const __grid_constant__ Shape sh, int chunk_steps,
             int horizon, R t_end) {
  using M = typename ModelOf<FAMILY, NS, RECORD, R>::type;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (M::DYN) {
    // the launch's dynamic shared memory (launch sets its size)
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    auto& m = *reinterpret_cast<Smem<R, M>*>(dyn_smem);
    if (l < lanes)
      run_lane<R, C, M>(ps, l, sh, chunk_steps, horizon, t_end, m.cold,
                        m.cold_acc, m.cold_q, m.cold_shop, m.cold_sig,
                        m.ucold, &m.wake, &m.g, &m.await_, &m.mask);
  } else {
    __shared__ Cold<R, M> cold;
    __shared__ ColdAcc<R, M> cold_acc;
    __shared__ ColdQ<M> cold_q;
    __shared__ ColdShop<R, M> cold_shop;
    __shared__ ColdSig<M> cold_sig;
    __shared__ typename M::UCold ucold;
    ColdMask<M>* mk = nullptr;
    if constexpr (M::EMASK || M::PMASK) {
      __shared__ ColdMask<M> mask;
      mk = &mask;
    }
    if (l < lanes)
      run_lane<R, C, M>(ps, l, sh, chunk_steps, horizon, t_end, cold,
                        cold_acc, cold_q, cold_shop, cold_sig, ucold,
                        nullptr, nullptr, nullptr, mk);
  }
}

// the dynamic shared memory a launch of the family takes (0: static)
template <class M, typename R>
constexpr int dyn_bytes() {
  if constexpr (M::DYN) {
    return int(sizeof(Smem<R, M>));
  } else {
    return 0;
  }
}

template <typename R, typename C, int FAMILY, int NS, bool RECORD>
int launch(void* const* leaves, int n_leaves, int lanes, const Shape& sh,
           int chunk_steps, int horizon, double t_end, void* stream) {
  using M = typename ModelOf<FAMILY, NS, RECORD, R>::type;
  if (horizon < H_NONE || horizon > H_LANE) return -5;
  if (n_leaves != n_base_leaves<M>() + (horizon == H_LANE ? 1 : 0) ||
      n_leaves > MAX_LEAVES)
    return -1;
  if (lanes <= 0 || chunk_steps <= 0) return -2;
  // a generated family's general table has its header's slots
  if constexpr (M::GEN) {
    if (sh.event_cap != M::ECAP) return -4;
  }
  Ptrs ps{};
  for (int i = 0; i < n_leaves; ++i) ps.p[i] = leaves[i];
  const int blocks = (lanes + M::THREADS - 1) / M::THREADS;
  const auto st = static_cast<cudaStream_t>(stream);
  constexpr int smem = dyn_bytes<M, R>();
  if constexpr (smem > 0) {
    // above 48 KB a block takes dynamic shared memory only once allowed;
    // a launch refused for it never runs, so the error is returned here
    const cudaError_t e = cudaFuncSetAttribute(
        chunk_kernel<R, C, FAMILY, NS, RECORD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  chunk_kernel<R, C, FAMILY, NS, RECORD><<<blocks, M::THREADS, smem, st>>>(
      ps, lanes, sh, chunk_steps, horizon, R(t_end));
  return static_cast<int>(cudaGetLastError());
}

// the instance's resident blocks on an SM (cudaOccupancyMaxActiveBlocks
// PerMultiprocessor at its lanes a block and dynamic shared memory, once
// the launch's attribute allows that memory), its lanes a block in
// *threads; a negative CUDA error where the query fails
template <typename R, typename C, int FAMILY, int NS, bool RECORD>
int occupancy(int* threads) {
  using M = typename ModelOf<FAMILY, NS, RECORD, R>::type;
  constexpr int smem = dyn_bytes<M, R>();
  if constexpr (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        chunk_kernel<R, C, FAMILY, NS, RECORD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, chunk_kernel<R, C, FAMILY, NS, RECORD>, M::THREADS, smem);
  *threads = M::THREADS;
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// the MM instances: (1, false) mm1.build(record=False); (1, true)
// mm1.build() and mmc.build(1); (2..4, true) mmc.build(c)
template <typename R, typename C>
int dispatch(void* const* leaves, int n_leaves, int lanes, int n_servers,
             int record, const Shape& sh, int chunk_steps, int horizon,
             double t_end, void* stream) {
  const auto go = [&](auto ns, auto rec) {
    return launch<R, C, F_MM, decltype(ns)::value, decltype(rec)::value>(
        leaves, n_leaves, lanes, sh, chunk_steps, horizon, t_end, stream);
  };
  using T = std::true_type;
  if (!record)
    return n_servers == 1
               ? go(std::integral_constant<int, 1>{}, std::false_type{})
               : -3;
  switch (n_servers) {
    case 1: return go(std::integral_constant<int, 1>{}, T{});
    case 2: return go(std::integral_constant<int, 2>{}, T{});
    case 3: return go(std::integral_constant<int, 3>{}, T{});
    case 4: return go(std::integral_constant<int, 4>{}, T{});
    default: return -3;
  }
}

}  // namespace queue
}  // namespace cimba

// Plain C interface (loaded with ctypes).  leaves: the Sim's device
// pointers in jax.tree.leaves order (without the queues.acc leaves when
// record is 0).  Launches on ``stream`` without synchronising; returns
// cudaGetLastError() after the launch (0 = ok), or -1 / -2 / -3 / -5 for
// a wrong leaf count / an empty launch / no instance for (n_servers,
// record) / no such horizon.  horizon (cimba::Horizon): 0 none, 1 t_end,
// 2 each lane's t_stop, one more leaf after the Sim's others.
#define CIMBA_QUEUE_CHUNK(SUFFIX, R, C)                                      \
  extern "C" int cimba_queue_chunk_##SUFFIX(                                 \
      void* const* leaves, int n_leaves, int lanes, int n_servers,          \
      int record, int event_cap, int ring_width, int queue_cap, int front,  \
      int rear, int n_ilocals, int chunk_steps, int horizon, double t_end,  \
      void* stream) {                                                        \
    const cimba::queue::Shape sh{event_cap,   ring_width, {queue_cap, 0},   \
                                 {front, 0},  {rear, 0},  n_ilocals};       \
    return cimba::queue::dispatch<R, C>(leaves, n_leaves, lanes, n_servers, \
                                        record, sh, chunk_steps, horizon,   \
                                        t_end, stream);                     \
  }                                                                          \
  /* the M/M/1 instance under its first name, (1 server, no recording) */   \
  extern "C" int cimba_mm1_chunk_##SUFFIX(                                   \
      void* const* leaves, int n_leaves, int lanes, int event_cap,          \
      int ring_width, int queue_cap, int front, int rear, int n_ilocals,    \
      int chunk_steps, int horizon, double t_end, void* stream) {           \
    return cimba_queue_chunk_##SUFFIX(leaves, n_leaves, lanes, 1, 0,        \
                                      event_cap, ring_width, queue_cap,     \
                                      front, rear, n_ilocals, chunk_steps,  \
                                      horizon, t_end, stream);              \
  }                                                                          \
  /* mg1.build(): 1 server, recording, lognormal service */                 \
  extern "C" int cimba_mg1_chunk_##SUFFIX(                                   \
      void* const* leaves, int n_leaves, int lanes, int event_cap,          \
      int ring_width, int queue_cap, int front, int rear, int n_ilocals,    \
      int chunk_steps, int horizon, double t_end, void* stream) {           \
    const cimba::queue::Shape sh{event_cap,   ring_width, {queue_cap, 0},   \
                                 {front, 0},  {rear, 0},  n_ilocals};       \
    return cimba::queue::launch<R, C, cimba::queue::F_MG1, 1, true>(        \
        leaves, n_leaves, lanes, sh, chunk_steps, horizon, t_end,           \
        stream);                                                             \
  }                                                                          \
  /* tandem.build(): two recording queues, their caps and guards */         \
  extern "C" int cimba_tandem_chunk_##SUFFIX(                                \
      void* const* leaves, int n_leaves, int lanes, int event_cap,          \
      int ring_width, int cap1, int front1, int rear1, int cap2,            \
      int front2, int rear2, int n_ilocals, int chunk_steps, int horizon,   \
      double t_end, void* stream) {                                          \
    const cimba::queue::Shape sh{event_cap,        ring_width,              \
                                 {cap1, cap2},     {front1, front2},        \
                                 {rear1, rear2},   n_ilocals};              \
    return cimba::queue::launch<R, C, cimba::queue::F_TANDEM, 2, true>(     \
        leaves, n_leaves, lanes, sh, chunk_steps, horizon, t_end,           \
        stream);                                                             \
  }                                                                          \
  /* jobshop.build(): the pool's and buffer's capacities, backlog, b_slow */ \
  extern "C" int cimba_shop_chunk_##SUFFIX(                                  \
      void* const* leaves, int n_leaves, int lanes, int event_cap,          \
      int n_ilocals, double pool_cap, double buf_cap, double backlog,       \
      double b_slow, int chunk_steps, int horizon, double t_end,            \
      void* stream) {                                                        \
    const cimba::queue::Shape sh{event_cap, 1,         {0, 0},   {0, 0},    \
                                 {0, 0},    n_ilocals, pool_cap, buf_cap,   \
                                 backlog,   b_slow};                         \
    return cimba::queue::launch<R, C, cimba::queue::F_SHOP, 2, true>(       \
        leaves, n_leaves, lanes, sh, chunk_steps, horizon, t_end,           \
        stream);                                                             \
  }                                                                          \
  /* an instance's resident blocks an SM (its lanes a block in *threads): */ \
  /* family 0 the mm instances (n_servers, record), 1 mg1, 2 tandem, 3    */ \
  /* the job shop; -3 for no instance                                     */ \
  extern "C" int cimba_queue_occupancy_##SUFFIX(int family, int n_servers,  \
                                                int record, int* threads) { \
    using namespace cimba::queue;                                            \
    switch (family) {                                                        \
      case F_MG1: return occupancy<R, C, F_MG1, 1, true>(threads);           \
      case F_TANDEM: return occupancy<R, C, F_TANDEM, 2, true>(threads);     \
      case F_SHOP: return occupancy<R, C, F_SHOP, 2, true>(threads);         \
      default: break;                                                        \
    }                                                                        \
    if (!record)                                                             \
      return n_servers == 1 ? occupancy<R, C, F_MM, 1, false>(threads) : -3; \
    switch (n_servers) {                                                     \
      case 1: return occupancy<R, C, F_MM, 1, true>(threads);                \
      case 2: return occupancy<R, C, F_MM, 2, true>(threads);                \
      case 3: return occupancy<R, C, F_MM, 3, true>(threads);                \
      case 4: return occupancy<R, C, F_MM, 4, true>(threads);                \
      default: return -3;                                                    \
    }                                                                        \
  }

// A generated instance (CIMBA_GEN_HEADER): its shape is compiled in, so
// it takes the general event table's slots and the rings' width only.
#define CIMBA_GEN_CHUNK(SUFFIX, R, C)                                        \
  extern "C" int cimba_gen_chunk_##SUFFIX(                                   \
      void* const* leaves, int n_leaves, int lanes, int event_cap,          \
      int ring_width, int chunk_steps, int horizon, double t_end,           \
      void* stream) {                                                        \
    const cimba::queue::Shape sh{event_cap, ring_width, {0, 0}, {0, 0},     \
                                 {0, 0},    1};                              \
    return cimba::queue::launch<R, C, cimba::queue::F_GEN, 0, false>(       \
        leaves, n_leaves, lanes, sh, chunk_steps, horizon, t_end,           \
        stream);                                                             \
  }                                                                          \
  /* the dynamic shared memory a block of the instance takes (0: static) */ \
  extern "C" int cimba_gen_smem_##SUFFIX() {                                 \
    return cimba::queue::dyn_bytes<cimba::queue::Gen<R>, R>();              \
  }                                                                          \
  /* its resident blocks an SM, its lanes a block in *threads */            \
  extern "C" int cimba_gen_occupancy_##SUFFIX(int* threads) {                \
    return cimba::queue::occupancy<R, C, cimba::queue::F_GEN, 0, false>(    \
        threads);                                                            \
  }

#ifdef CIMBA_GEN_F32
CIMBA_GEN_CHUNK(f32, float, int32_t)
#endif
#ifdef CIMBA_GEN_F64
CIMBA_GEN_CHUNK(f64, double, int64_t)
#endif
// CIMBA_GEN_ONLY: a generated instance's own library, without the
// hand-written ones
#ifndef CIMBA_GEN_ONLY
CIMBA_QUEUE_CHUNK(f32, float, int32_t)
CIMBA_QUEUE_CHUNK(f64, double, int64_t)
#endif
