"""The event loop, lane-batched (torch port of :mod:`cimba_tpu.core.loop`).

Every Sim leaf carries the replication lane as its leading dimension —
the layout ``jax.vmap(init_sim)`` gives the reference — and every
function here advances all lanes at once, in eager PyTorch:

* ``step`` pops each lane's next event (``eventset.peek_merged``),
  advances its clock and resumes the subject process;
* ``resume`` retries or abandons a pended command, then chains blocks
  until the process yields — the batched ``while`` runs the body on every
  lane and keeps the new state only where the lane's condition held, as a
  vmapped ``lax.while_loop`` does;
* blocks are evaluated for the lanes whose pc selects them and merged
  per leaf; command handlers are composed in sequence, each gating its own
  writes with ``torch.where`` (the reference's ``_gated`` handlers).

This engine is the plain version of the CUDA chunk kernels
(:mod:`cimba_tpu_torch.core.kernel_run`): ``make_run(spec,
max_steps=k, defer_boundary=...)`` is exactly one kernel chunk of ``k``
events per lane.  ``defer_boundary=True`` is the boundary protocol of
the reference's kernel mode: a lane whose next dispatch targets a
boundary block (``Model.boundary_block``) freezes with
``boundary_pending`` set and the event left in its table, for the host
loop to step between chunks.  Off (the default), the engine is the
reference's XLA path and ignores the marker.

Ported subset: hold, exit, jump; the object-queue put/get with their
fused ``*_hold`` verbs and queue-length recording; the priority queue's
put/get (highest priority first, FIFO among equals) with theirs; the
binary resource's acquire, preempt (the holder of equal or lower
priority is kicked with PREEMPTED) and release, inline from a block too
(:func:`release_resource`), with its utilization recording; the resource
pool's acquire (greedy, FIFO waiters), preempt (the mug of holders of
lower priority) and release, inline from a block too
(:func:`release_pool`); the buffer's get and put with partial
fulfilment; the waits on a process (its waiters woken in pid order at
its end) and on an event (woken at its dispatch, before its action, or
with CANCELLED at its cancel or once its handle is dead); the condition
wait, :func:`cond_signal` and observer forwarding (a guard signal also
signals every condition that observes the guard); the pools', buffers'
and priority queues' time-weighted recording; timers (:func:`timer_add`,
:func:`timers_clear`), :func:`interrupt` and :func:`stop_process`, with
the abort of a pended command on a non-SUCCESS wake (the pool rollback
and the buffer's partial-fulfilment report, :func:`_abort_cleanup`);
user event handlers (events of kind ``N_KINDS + k`` scheduled by
``api.schedule``); spawn pools (rows CREATED at init, activated and
recycled by :func:`spawn_process`); the guard pend/retry protocol,
boundary blocks, failure codes and ``api.stop``. Other commands fail the
replication with ERR_USER, as the reference's unknown-tag handler does.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.overrides

from cimba_tpu_torch import config, tree
from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import eventset as ev
from cimba_tpu_torch.core import guard as gd
from cimba_tpu_torch.core import ix
from cimba_tpu_torch.core import process as pr
from cimba_tpu_torch.core import trace as _trace
from cimba_tpu_torch.core.model import ModelSpec
from cimba_tpu_torch.obs import metrics as obs_metrics
from cimba_tpu_torch.obs import trace as obs_trace
from cimba_tpu_torch.random import bits as rb
from cimba_tpu_torch.stats import timeseries as ts
from cimba_tpu_torch.utils import logger as _logger

K_PROC = 0
K_TIMER = 1
N_KINDS = 2

#: a process may not execute more blocks than this without yielding
MAX_CHAIN = 1024

_I32_MAX = 2**31 - 1

ERR_NONE = 0
ERR_EVENT_OVERFLOW = 1
ERR_GUARD_OVERFLOW = 2
ERR_CHAIN_RUNAWAY = 3
ERR_USER = 4
ERR_BAD_RELEASE = 5
ERR_BOUNDARY = 6


class Queues(NamedTuple):
    items: torch.Tensor  # [L, NQ, QCAP] REAL ring buffers
    head: torch.Tensor   # [L, NQ] i32
    size: torch.Tensor   # [L, NQ] i32
    acc: Any = None      # StepAccum, leaves [L, NQ]: queue-length
                         # recording (None unless some queue records)


class Resources(NamedTuple):
    holder: torch.Tensor  # [L, NR] i32, -1 = free
    acc: Any = None       # StepAccum, leaves [L, NR]: utilization


class Pools(NamedTuple):
    level: torch.Tensor     # [L, NP] REAL units available
    held: torch.Tensor      # [L, NP, P] REAL units each process holds
    held_seq: torch.Tensor  # [L, NP, P] i32 grab order
    next_seq: torch.Tensor  # [L, NP] i32
    acc: Any = None         # StepAccum, leaves [L, NP]: units in use


class Buffers(NamedTuple):
    level: torch.Tensor  # [L, NB] REAL stored amount
    acc: Any = None      # StepAccum, leaves [L, NB]: the level


class PQueues(NamedTuple):
    items: torch.Tensor     # [L, NPQ, CAP] REAL payloads
    prio: torch.Tensor      # [L, NPQ, CAP] REAL item priorities (higher
                            # first)
    seq: torch.Tensor       # [L, NPQ, CAP] i32 insertion order (FIFO
                            # among equal priorities)
    live: torch.Tensor      # [L, NPQ, CAP] bool slot occupancy
    next_seq: torch.Tensor  # [L, NPQ] i32
    acc: Any = None         # StepAccum, leaves [L, NPQ]: the length


class Sim(NamedTuple):
    """Every replication lane's full state (leaves ``[L, ...]``); the
    field order is the reference's, so leaf lists line up."""

    clock: torch.Tensor
    rep: torch.Tensor
    rng: rb.RandomState
    events: ev.EventSet
    wakes: ev.Wakes
    procs: pr.Procs
    guards: gd.Guards
    queues: Any
    resources: Any
    pools: Any
    buffers: Any
    pqueues: Any
    user: Any
    done: torch.Tensor
    err: torch.Tensor
    n_events: torch.Tensor
    boundary_pending: torch.Tensor
    trace: Any = None
    metrics: Any = None
    t_stop: Any = None


def _broadcast_params(params, lanes: int, device):
    """Scalar params broadcast to ``[lanes]``; leaves already ``[lanes,
    ...]`` pass through."""
    def bc(x):
        # Python floats stay f64 until the model casts them (torch's
        # default float dtype would round them to f32 first)
        t = torch.as_tensor(
            x, dtype=torch.float64 if isinstance(x, float) else None,
            device=device)
        if t.dim() > 0 and t.shape[0] == lanes:
            return t
        return t.expand((lanes,) + tuple(t.shape)).contiguous()

    if params is None:
        return None
    if isinstance(params, (tuple, list)):
        return type(params)(bc(x) for x in params)
    if isinstance(params, dict):
        return {k: bc(v) for k, v in params.items()}
    return bc(params)


def _lane_column(x, lanes: int, dtype, dev, what: str):
    """A scalar or a per-lane ``[lanes]`` column as a ``[lanes]`` tensor
    of ``dtype`` on ``dev`` (a scalar broadcast)."""
    t = torch.as_tensor(x, device=dev)
    if t.dim() == 0:
        t = t.expand(lanes)
    if tuple(t.shape) != (lanes,):
        raise ValueError(f"{what} must be a scalar or a [{lanes}] column, "
                         f"got shape {tuple(t.shape)}")
    return t.to(dtype).contiguous()


def seed_column(seed, lanes: int, device="cuda"):
    """A seed as ``random.bits.initialize`` takes it: a Python int as
    given, or each lane's seed (an integer column, numpy ``uint64``
    included) as an int64 tensor holding the same 64 bits."""
    if isinstance(seed, int):
        return seed
    dev = config.resolve_device(device)
    if not isinstance(seed, torch.Tensor):
        a = np.asarray(seed)
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        seed = torch.from_numpy(np.array(a, dtype=np.int64, copy=True))
    if seed.is_floating_point():
        raise ValueError("a seed column must hold integers")
    return _lane_column(seed, lanes, torch.int64, dev, "seed")


def init_sim(spec: ModelSpec, seed, replications, params=None, t0=0.0, *,
             t_stop=None, device="cuda") -> Sim:
    """Initial state of the replications ``replications`` (a 1-D integer
    array) under the active dtype profile, every process started at
    ``t0`` but a spawn pool's rows, which stay CREATED (parity:
    ``jax.vmap(cimba_tpu.core.loop.init_sim)``).

    ``seed`` is an int or a per-lane integer column: lane l's stream key
    is ``fmix64(seed[l] + c * replications[l])``, so a column of one
    value gives the streams of that scalar seed.  ``t_stop`` (a scalar
    or a per-lane column) gives every lane a horizon, the ``Sim.t_stop``
    leaf in the TIME dtype, which :func:`make_cond` reads in place of
    its ``t_end``: ``+inf`` runs to the end, ``-inf`` leaves the lane
    dead from the start.  ``None`` carries no leaf.  With the flight
    recorder or the metrics registry on (``obs.trace.enable``,
    ``obs.metrics.enable``) the Sim carries a ring or a registry a lane
    (``Sim.trace``, ``Sim.metrics``), in the reference's field order."""
    dev = config.resolve_device(device)
    real, tdt = config.real(), config.time()
    reps = torch.as_tensor(replications, device=dev).to(torch.int64)
    if reps.dim() != 1:
        raise ValueError("replications must be a 1-D array of indices")
    lanes = reps.shape[0]
    seed = seed_column(seed, lanes, dev)
    if t_stop is not None:
        t_stop = _lane_column(t_stop, lanes, tdt, dev, "t_stop")
    n = spec.n_procs
    # process starts are dense wakes at t0, their seqs the started
    # processes' ranks in pid order (0..P-1 where every process starts);
    # a spawn pool's rows stay CREATED with no wake until api.spawn
    started = torch.as_tensor(spec.proc_start, dtype=torch.bool,
                              device=dev)
    rank = torch.cumsum(started.to(INDEX), 0, dtype=INDEX) - started.to(
        INDEX)
    wakes = ev.wakes_create(n, lanes, dev, tdt)._replace(
        time=torch.full((n,), float(t0), dtype=tdt, device=dev)
        .masked_fill(~started, ev.NEVER).expand(lanes, n).contiguous(),
        seq=rank.expand(lanes, n).contiguous(),
    )
    events = ev.create(spec.event_cap, lanes, dev, tdt)
    events = events._replace(next_seq=torch.full(
        (lanes,), int(spec.proc_start.sum()), dtype=INDEX, device=dev))
    procs = pr.create(spec.proc_entry, spec.proc_prio, spec.n_flocals,
                      spec.n_ilocals, lanes, dev, real)
    procs = procs._replace(status=torch.where(
        started, pr.RUNNING, pr.CREATED).to(INDEX).expand(lanes, n)
        .contiguous())
    nq = max(len(spec.queues), 1)
    # no user state: the reference's float64 zero (jnp.zeros(()) under
    # x64), in either profile
    user = (spec.user_init(_broadcast_params(params, lanes, dev))
            if spec.user_init else torch.zeros((lanes,), dtype=torch.float64,
                                               device=dev))
    # a user state written one lane at a time, as the reference's is
    # (0-dim leaves), holds the same values in every lane
    user = tree.map(lambda x: x.to(dev).expand(lanes).contiguous()
                    if x.dim() == 0 else x, user)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    np_, nb, npq = len(spec.pools), len(spec.buffers), len(spec.pqueues)
    pqw = spec.pqueue_cap_max
    buf_init = torch.tensor([b.initial for b in spec.buffers] or [0.0],
                            dtype=real, device=dev).expand(
                                lanes, max(nb, 1)).contiguous()

    return Sim(
        clock=torch.full((lanes,), float(t0), dtype=tdt, device=dev),
        rep=reps.to(INDEX),
        rng=rb.initialize(seed, reps, device=dev),
        events=events,
        wakes=wakes,
        procs=procs,
        guards=gd.create(spec.n_guards, lanes, dev),
        queues=Queues(
            items=zeros((lanes, nq, spec.queue_cap_max), real),
            head=zeros((lanes, nq), INDEX),
            size=zeros((lanes, nq), INDEX),
            acc=ts.step_create(t0, 0.0, (lanes, nq), dev, real)
            if any(q.record for q in spec.queues) else None,
        ) if spec.queues else None,
        resources=Resources(
            holder=torch.full((lanes, len(spec.resources)), -1, dtype=INDEX,
                              device=dev),
            acc=ts.step_create(t0, 0.0, (lanes, len(spec.resources)), dev,
                               real)
            if any(r.record for r in spec.resources) else None,
        ) if spec.resources else None,
        pools=Pools(
            level=torch.tensor([pl.capacity for pl in spec.pools],
                               dtype=real, device=dev)
            .expand(lanes, np_).contiguous(),
            held=zeros((lanes, np_, n), real),
            held_seq=zeros((lanes, np_, n), INDEX),
            next_seq=zeros((lanes, np_), INDEX),
            acc=ts.step_create(t0, 0.0, (lanes, np_), dev, real)
            if any(pl.record for pl in spec.pools) else None,
        ) if spec.pools else None,
        buffers=Buffers(
            level=buf_init,
            # the recorded level starts at each buffer's initial level
            acc=ts.step_create(t0, 0.0, (lanes, nb), dev, real)._replace(
                last_v=buf_init.clone())
            if any(b.record for b in spec.buffers) else None,
        ) if spec.buffers else None,
        pqueues=PQueues(
            items=zeros((lanes, npq, pqw), real),
            prio=zeros((lanes, npq, pqw), real),
            seq=zeros((lanes, npq, pqw), INDEX),
            live=zeros((lanes, npq, pqw), torch.bool),
            next_seq=zeros((lanes, npq), INDEX),
            acc=ts.step_create(t0, 0.0, (lanes, npq), dev, real)
            if any(q.record for q in spec.pqueues) else None,
        ) if spec.pqueues else None,
        user=user,
        done=zeros((lanes,), torch.bool),
        err=zeros((lanes,), INDEX),
        n_events=zeros((lanes,), config.count()),
        boundary_pending=zeros((lanes,), torch.bool),
        # observability state: off (the default) carries no tensors
        trace=(obs_trace.create(lanes, dev, tdt) if obs_trace.enabled()
               else None),
        metrics=(obs_metrics.create(N_KINDS + len(spec.user_handlers),
                                    len(spec.queues), (lanes,), dev)
                 if obs_metrics.enabled() else None),
        t_stop=t_stop,
    )


# --- lane-batched control flow -------------------------------------------


def _where(pred, a, b):
    """Leafwise lane select; leaves shared by both trees pass through."""
    def sel(x, y):
        if x is y:
            return x
        return torch.where(pred.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)

    return tree.map(sel, a, b)


def _while(cond, body, carry):
    """Batched ``lax.while_loop``: ``body(carry, active)`` runs while any
    lane's ``cond`` holds, and only those lanes keep its result."""
    active = cond(carry)
    while bool(active.any()):
        carry = _where(active, body(carry, active), carry)
        active = cond(carry)
    return carry


def _merge(sel_masks, outs, base):
    """Per-leaf merge of branch outputs: ``outs[j]`` where
    ``sel_masks[j]``, ``base`` elsewhere; a leaf a branch left untouched
    costs nothing."""
    base_leaves = tree.leaves(base)
    out_leaves = [tree.leaves(o) for o in outs]
    merged = []
    for pos, b in enumerate(base_leaves):
        res = b
        for m, ol in zip(sel_masks, out_leaves):
            if ol[pos] is not b:
                res = torch.where(
                    m.reshape((-1,) + (1,) * (b.dim() - 1)), ol[pos], res
                )
        merged.append(res)
    return tree.unflatten(base, merged)


def _set_err(sim: Sim, pred, code) -> Sim:
    return sim._replace(
        err=torch.where((sim.err == 0) & pred, code, sim.err).to(INDEX)
    )


def _schedule_wake(sim: Sim, pred, p, sig, t=None) -> Sim:
    """Arm a resume for process p at ``t`` (default: now); a non-finite
    time fails the replication."""
    t = sim.clock if t is None else t
    wk2, ok = ev.wake_set(sim.wakes, p, t, sig, sim.events.next_seq, pred)
    sim = sim._replace(
        wakes=wk2,
        events=sim.events._replace(
            next_seq=sim.events.next_seq + ok.to(INDEX)),
    )
    armed = torch.ones_like(ok) if pred is True else pred
    return _set_err(sim, armed & ~ok, ERR_EVENT_OVERFLOW)


def _guard_signal(sim: Sim, gid, pred=True, spec=None) -> Sim:
    """Wake the best waiter of guard ``gid`` (if any) with SUCCESS at the
    current time; ``pred`` gates the whole signal.  With ``spec``, every
    condition that observes ``gid`` is then signalled too, under the
    same ``pred`` (parity: the reference's observer forwarding,
    cmb_resourceguard_register)."""
    pid, found = gd.best_waiter(
        sim.procs.pend_guard, sim.procs.pend_seq, sim.procs.prio, gid
    )
    woke = found if pred is True else (found & pred)
    p = pid.clamp(min=0)
    sim = sim._replace(procs=sim.procs._replace(
        pend_guard=ix.put(sim.procs.pend_guard, p, -1, woke)))
    sim = _schedule_wake(sim, woke, p, pr.SUCCESS)
    if spec is not None:
        for c in spec.conditions:
            if not c.observes:
                continue
            if isinstance(gid, int):
                if gid not in c.observes:
                    continue
                fire = pred
            else:
                fire = torch.isin(gid, torch.tensor(c.observes, dtype=INDEX,
                                                    device=gid.device))
                if pred is not True:
                    fire = fire & pred
            sim = cond_signal(spec, sim, c.id, pred=fire)
    return sim


def _cond_satisfied(spec: ModelSpec, sim: Sim, cid, p):
    """Condition ``cid``'s predicate for the ``[L]`` pids ``p``, as an
    ``[L]`` bool; a tensor ``cid`` selects each lane's condition."""
    lanes = sim.clock.shape[0]

    def one(c):
        return torch.as_tensor(c.predicate(sim, p),
                               device=sim.clock.device).expand(lanes)

    if isinstance(cid, int):
        return one(spec.conditions[cid])
    cid = cid.clamp(0, len(spec.conditions) - 1)
    out = torch.zeros((lanes,), dtype=torch.bool, device=sim.clock.device)
    for c in spec.conditions:
        out = torch.where(cid == c.id, one(c), out)
    return out


def cond_signal(spec: ModelSpec, sim: Sim, cid: int, pred=True) -> Sim:
    """Signal condition ``cid``: every waiter whose predicate holds wakes
    with SUCCESS, in pid order (parity: cmb_condition_signal's wake-all;
    the woken retry checks the predicate again).  ``pred`` gates the
    whole signal."""
    c = spec.conditions[cid]
    lanes, dev = sim.clock.shape[0], sim.clock.device
    for q in range(spec.n_procs):
        qv = torch.full((lanes,), q, dtype=INDEX, device=dev)
        wake = (sim.procs.pend_guard[:, q] == c.guard) & \
            _cond_satisfied(spec, sim, cid, qv)
        if pred is not True:
            wake = wake & pred
        sim = sim._replace(procs=sim.procs._replace(
            pend_guard=ix.put(sim.procs.pend_guard, qv, -1, wake)))
        sim = _schedule_wake(sim, wake, qv, pr.SUCCESS)
    return sim


def _guard_wait(sim: Sim, p, gid, cmd: pr.Command, is_retry, pred) -> Sim:
    """Pend the blocked command on guard ``gid`` and advance pc to the
    continuation; a retry keeps its FIFO sequence."""
    seq_override = torch.where(is_retry, ix.get(sim.procs.pend_seq, p), -1)
    g2, seq = gd.alloc_seq(sim.guards, gid, seq_override, pred)
    pc = sim.procs
    return sim._replace(
        procs=pc._replace(
            pend_tag=ix.put(pc.pend_tag, p, cmd.tag, pred),
            pend_f=ix.put(pc.pend_f, p, cmd.f, pred),
            pend_f2=ix.put(pc.pend_f2, p, cmd.f2, pred),
            pend_f3=ix.put(pc.pend_f3, p, cmd.f3, pred),
            pend_i=ix.put(pc.pend_i, p, cmd.i, pred),
            pend_pc=ix.put(pc.pend_pc, p, cmd.next_pc, pred),
            pend_guard=ix.put(pc.pend_guard, p, gid, pred),
            pend_seq=ix.put(pc.pend_seq, p, seq, pred),
            pc=ix.put(pc.pc, p, cmd.next_pc, pred),
        ),
        guards=g2,
    )


def _clear_pend(sim: Sim, p, pred=True) -> Sim:
    return sim._replace(procs=sim.procs._replace(
        pend_tag=ix.put(sim.procs.pend_tag, p, pr.NO_PEND, pred),
        pend_guard=ix.put(sim.procs.pend_guard, p, -1, pred),
    ))


def _cancel_wake(sim: Sim, p, pred=True) -> Sim:
    return sim._replace(wakes=ev.wake_clear(sim.wakes, p, pred))


def _clear_awaits(spec: ModelSpec, sim: Sim, p, pred=True) -> Sim:
    """p waits on no process and no event any more (each only where the
    spec can return the wait)."""
    procs = sim.procs
    if _may_wait_procs(spec, sim):
        procs = procs._replace(await_pid=ix.put(procs.await_pid, p, -1, pred))
    if _may_wait_events(spec, sim):
        procs = procs._replace(await_evt=ix.put(procs.await_evt, p, -1, pred))
    return sim._replace(procs=procs)


def _unwait(spec: ModelSpec, sim: Sim, p, pred=True) -> Sim:
    """Detach p from what it waits on: its pend (and with it its guard
    membership), its wake and its waits on a process or an event (parity:
    the reference's ``_unwait``)."""
    sim = _cancel_wake(_clear_pend(sim, p, pred), p, pred)
    return _clear_awaits(spec, sim, p, pred)


# --- waits on processes and events ----------------------------------------


class _NoHostBranch(torch.overrides.TorchFunctionMode):
    """Refuses a Python branch on a tensor: the tag inference below must
    see every command a block can build, not the one this lane's data
    picks."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in _trace.HOST_BRANCH:
            raise TypeError("a block branches in Python on a tensor")
        return func(*args, **(kwargs or {}))


def _used_tags(spec: ModelSpec, sim: Sim):
    """The command tags the spec's blocks can build, collected by running
    each block once on lane 0 of ``sim`` (moved to the CPU) with the
    constructors registering their tags (parity: the reference's
    ``_infer_used_tags``, which traces each block abstractly); None (any
    tag) where a block branches in Python on a tensor or raises, or
    inside another inference.  Memoized on the spec object."""
    memo = getattr(spec, "_used_tags_memo", False)
    if memo is not False:
        return memo
    if pr._tag_collector is not None:
        return None
    tags: set = set()
    one = tree.map(lambda x: x[:1].detach().to("cpu"), sim)
    zero = torch.zeros((1,), dtype=INDEX)
    pr._tag_collector = tags
    try:
        with _NoHostBranch():
            for blk in spec.blocks:
                blk(one, zero, zero)
        out = frozenset(tags)
    except Exception:
        out = None
    finally:
        pr._tag_collector = None
    spec._used_tags_memo = out
    return out


def _may_wait_events(spec: ModelSpec, sim: Sim) -> bool:
    """Static: can this spec return C_WAIT_EVT?  Gates the dispatch's
    waiter scan, the eager cancel arm and the stranding term out of
    specs that never wait on an event."""
    used = _used_tags(spec, sim)
    return used is None or pr.C_WAIT_EVT in used


def _may_wait_procs(spec: ModelSpec, sim: Sim) -> bool:
    """Static: can this spec return C_WAIT_PROC?  Gates the exit's mass
    wake out of specs that never wait on a process."""
    used = _used_tags(spec, sim)
    return used is None or pr.C_WAIT_PROC in used


def _exclusive_rank(mask):
    """``[L, P]`` bool -> i32: how many true elements precede each one
    in its row (pid order)."""
    x = mask.to(INDEX)
    return torch.cumsum(x, dim=1, dtype=INDEX) - x


def _mass_wake(sim: Sim, mask, sig) -> Sim:
    """Arm a wake now for every process in ``mask`` (``[L, P]``), their
    seqs drawn in pid order from ``events.next_seq`` (parity: the
    reference's ``_mass_wake``, which both waits share)."""
    base = sim.events.next_seq
    wk = sim.wakes
    sig = torch.as_tensor(sig, dtype=INDEX, device=mask.device)
    sig = sig[:, None] if sig.dim() == 1 else sig
    wk2 = ev.Wakes(
        time=torch.where(mask, sim.clock[:, None], wk.time),
        sig=torch.where(mask, sig, wk.sig),
        seq=torch.where(mask, base[:, None] + _exclusive_rank(mask),
                        wk.seq),
    )
    n = mask.to(INDEX).sum(dim=1, dtype=INDEX)
    return sim._replace(wakes=wk2, events=sim.events._replace(
        next_seq=base + n))


def _wake_waiters(spec: ModelSpec, sim: Sim, target, sig, pred=True) -> Sim:
    """Wake every RUNNING process waiting on ``target`` finishing, with
    ``sig`` (parity: the reference's ``_wake_waiters``), their waits on a
    process cleared."""
    if not _may_wait_procs(spec, sim):
        return sim
    pc = sim.procs
    t = torch.as_tensor(target, dtype=INDEX, device=pc.status.device)
    t = t.reshape(-1, 1) if t.dim() else t
    waiting = (pc.await_pid == t) & (pc.status == pr.RUNNING)
    if pred is not True:
        waiting = waiting & pred.reshape(-1, 1)
    sig = torch.as_tensor(sig, dtype=INDEX, device=pc.status.device)
    sim = _mass_wake(sim, waiting, sig)
    return sim._replace(procs=sim.procs._replace(
        await_pid=torch.where(waiting, -1, pc.await_pid).to(INDEX)))


def _scan_evt_waiters(sim: Sim, decide) -> Sim:
    """The event waiters' scan: ``decide(sim, h) -> (wake, sig)`` over
    every process's awaited handle ``h`` (``[L, P]``); the RUNNING
    waiters it wakes get their wakes in pid order (:func:`_mass_wake`)
    and their waits cleared."""
    h = sim.procs.await_evt
    awaiting = (h >= 0) & (sim.procs.status == pr.RUNNING)
    wake, sig = decide(sim, h)
    wake = wake & awaiting
    sim = _mass_wake(sim, wake, sig)
    return sim._replace(procs=sim.procs._replace(
        await_evt=torch.where(wake, -1, h).to(INDEX)))


def _dispatch_evt_wakes(sim: Sim, handle, found, pred=None) -> Sim:
    """Wake the waiters of the event just popped with SUCCESS, before
    its action runs, and (the lazy arm of a cancel) every waiter whose
    handle has died with CANCELLED (parity: the reference's
    ``_dispatch_evt_wakes``).  ``pred`` (``[L]``) suppresses both arms on
    a lane whose dispatch is deferred to a boundary step: its wakes would
    come before the deferred event."""

    def decide(sim, h):
        fired = found[:, None] & (h == handle[:, None])
        stale = ~fired & ~ev._valid(sim.events, h)
        wake = fired | stale
        if pred is not None:
            wake = wake & pred[:, None]
        return wake, torch.where(fired, pr.SUCCESS, pr.CANCELLED).to(INDEX)

    return _scan_evt_waiters(sim, decide)


def _cancel_evt_wakes(sim: Sim, handle, pred) -> Sim:
    """The eager arm of a cancel: the waiters of the cancelled event
    wake now with CANCELLED."""
    hd = torch.as_tensor(handle, dtype=INDEX, device=sim.clock.device)
    hd = hd.reshape(-1, 1) if hd.dim() else hd

    def decide(sim, h):
        return pred.reshape(-1, 1) & (h == hd), pr.CANCELLED

    return _scan_evt_waiters(sim, decide)


def _abort_cleanup(spec: ModelSpec, sim: Sim, p, pend: pr.Command, sig,
                   pred=True) -> Sim:
    """The command-specific cleanup of an aborted wait (parity: the
    reference's ``_abort_cleanup``): a pended pool acquire or preempt
    rolls p's holding back to what it held before the call and signals
    the pool's guard (except on PREEMPTED); a pended buffer get or put
    keeps what it moved and reports it in ``got``.  As the reference's,
    it reads the plain tags only (a pended ``*_hold`` twin is released
    as it is)."""
    lanes, dev = sim.clock.shape[0], sim.clock.device
    sig = torch.as_tensor(sig, dtype=INDEX, device=dev).expand(lanes)
    if spec.pools:
        po = sim.pools
        dt = po.level.dtype
        k = pend.i.clamp(0, len(spec.pools) - 1)
        is_pool = (pend.tag == pr.C_POOL_ACQ) | (pend.tag == pr.C_POOL_PRE)
        do_rb = is_pool & (sig != pr.PREEMPTED)
        if pred is not True:
            do_rb = do_rb & pred
        excess = _nanmax0(ix.get2(po.held, k, p) - pend.f2)
        in_use = (_table(spec.pools, "capacity", dev, dt)[k.long()]
                  - (ix.get(po.level, k) + excess))
        sim = sim._replace(pools=po._replace(
            level=ix.add(po.level, k, excess, do_rb),
            held=ix.add2(po.held, k, p, -excess, do_rb),
            acc=_record_if([pl.record for pl in spec.pools], po.acc, k,
                           sim.clock, in_use, do_rb),
        ))
        sim = _guard_signal(sim, _table(spec.pools, "guard", dev)[k.long()],
                            pred=do_rb, spec=spec)
    if spec.buffers:
        is_buf = (pend.tag == pr.C_BUF_GET) | (pend.tag == pr.C_BUF_PUT)
        if pred is not True:
            is_buf = is_buf & pred
        sim = sim._replace(procs=sim.procs._replace(
            got=ix.put(sim.procs.got, p, pend.f2 - pend.f, is_buf)))
    return sim


def _pend_of(sim: Sim, p) -> pr.Command:
    pc = sim.procs
    return pr.Command(*ix.get_tree(
        (pc.pend_tag, pc.pend_f, pc.pend_f2, pc.pend_f3, pc.pend_i,
         pc.pend_pc), p))


def _abort_wait(spec: ModelSpec, sim: Sim, p, sig, pred=True) -> Sim:
    """Abort what p waits on and run the abort's cleanup, unwait first
    (parity: the reference's ``_abort_wait``): the path of every delivery
    that ends a wait from outside, an interrupt or an exit."""
    pend = _pend_of(sim, p)
    return _abort_cleanup(spec, _unwait(spec, sim, p, pred), p, pend, sig,
                          pred)


def finish_process(spec: ModelSpec, sim: Sim, p, exit_sig, pred) -> Sim:
    """Terminate process p: abort its wait, cancel its timers, mark it
    FINISHED, wake its waiters with its exit signal, free the resources
    it holds and return its pool units (parity: the reference's kill
    semantics)."""
    sim = _abort_wait(spec, sim, p, exit_sig, pred)
    es2, _ = ev.pattern_cancel(sim.events, K_TIMER, p, pred)
    sim = sim._replace(events=es2)
    sim = sim._replace(procs=sim.procs._replace(
        status=ix.put(sim.procs.status, p, pr.FINISHED, pred),
        exit_sig=ix.put(sim.procs.exit_sig, p, exit_sig, pred),
    ))
    # its waiters wake, in pid order
    sim = _wake_waiters(spec, sim, p, exit_sig, pred)
    # binary resources p holds are freed
    r_rec = [r.record for r in spec.resources]
    for rid, r in enumerate(spec.resources):
        re = sim.resources
        held = (re.holder[:, rid] == p) & pred
        sim = sim._replace(resources=re._replace(
            holder=ix.put(re.holder, rid, -1, held),
            acc=_record_if(r_rec, re.acc, rid, sim.clock, 0.0, held),
        ))
        sim = _guard_signal(sim, r.guard, pred=held, spec=spec)
    # pool units p still holds return to their pools
    p_rec = [pl.record for pl in spec.pools]
    for k, pl in enumerate(spec.pools):
        po = sim.pools
        amt = ix.get2(po.held, k, p)
        has = (amt > 0.0) & pred
        in_use = (torch.tensor(pl.capacity, dtype=po.level.dtype,
                               device=po.level.device)
                  - (po.level[:, k] + amt))
        sim = sim._replace(pools=po._replace(
            level=ix.add(po.level, k, amt, has),
            held=ix.put2(po.held, k, p, 0.0, has),
            acc=_record_if(p_rec, po.acc, k, sim.clock, in_use, has),
        ))
        sim = _guard_signal(sim, pl.guard, pred=has, spec=spec)
    return sim


def _running(spec: ModelSpec, sim: Sim, target):
    """(pid clamped into range, whether it names a RUNNING process) of a
    verb's target, per lane."""
    t = torch.as_tensor(target, dtype=INDEX, device=sim.clock.device)
    t = t.expand(sim.clock.shape[0])
    tc = t.clamp(0, spec.n_procs - 1)
    ok = (t >= 0) & (t < spec.n_procs)
    return tc, ok & (ix.get(sim.procs.status, tc) == pr.RUNNING)


def interrupt(spec: ModelSpec, sim: Sim, target, sig) -> Sim:
    """Deliver ``sig`` to process ``target`` now, aborting what it waits
    on (parity: cmb_process_interrupt); a target that is not RUNNING (or
    not a process) is left alone."""
    tc, alive = _running(spec, sim, target)
    sig = torch.as_tensor(sig, dtype=INDEX, device=sim.clock.device)
    sig = sig.expand(sim.clock.shape[0])
    sim = _abort_wait(spec, sim, tc, sig, pred=alive)
    return _schedule_wake(sim, alive, tc, sig)


def stop_process(spec: ModelSpec, sim: Sim, target) -> Sim:
    """Kill process ``target`` (parity: cmb_process_stop): its wait
    aborted with STOPPED, its timers cancelled, its resources and pool
    units given back; a target that is not RUNNING (or not a process) is
    left alone."""
    tc, alive = _running(spec, sim, target)
    return finish_process(spec, sim, tc, pr.STOPPED, alive)


def spawn_process(sim: Sim, pt, at=None, prio=None):
    """Activate one row of a spawn pool (a process type declared with
    ``start=False``); returns ``(sim, pid)``, pid -1 where every row of
    the pool is RUNNING (parity: the reference's ``spawn_process``).  The
    lowest CREATED or FINISHED pid of ``[first_pid, first_pid + count)``
    gets its status, pc, priority (the type's, or ``prio``), got, exit
    signal, waits, pend tag and guard and locals reset, and its SUCCESS
    wake at ``at`` (default: now); a finished row's timers were cancelled
    at its exit, so it is recycled clean."""
    lo, n = pt.first_pid, pt.count
    if lo < 0:
        raise ValueError("spawn_process needs a built model's ProcessType")
    pc = sim.procs
    lanes, n_procs = pc.status.shape
    dev = pc.status.device
    pids = torch.arange(n_procs, device=dev)
    free = ((pids >= lo) & (pids < lo + n))[None, :] & (
        (pc.status == pr.CREATED) | (pc.status == pr.FINISHED))
    found = free.any(dim=1)
    slot = ix.first_true(free).to(INDEX)
    p = torch.where(found, slot, 0)
    new_prio = torch.as_tensor(pt.prio if prio is None else prio,
                               dtype=INDEX, device=dev)
    (status, pc_, prio_, got, exit_sig, await_pid, await_evt, pend_tag,
     pend_guard) = ix.put_tree(
        (pc.status, pc.pc, pc.prio, pc.got, pc.exit_sig, pc.await_pid,
         pc.await_evt, pc.pend_tag, pc.pend_guard), p,
        (pr.RUNNING, pt.entry_pc, new_prio, 0.0, pr.SUCCESS, -1, -1,
         pr.NO_PEND, -1), found)
    row = (found[:, None] & (pids[None, :] == p[:, None]))[:, :, None]
    procs = pc._replace(
        status=status, pc=pc_, prio=prio_, got=got, exit_sig=exit_sig,
        await_pid=await_pid, await_evt=await_evt, pend_tag=pend_tag,
        pend_guard=pend_guard,
        locals_f=pc.locals_f.masked_fill(row, 0.0),
        locals_i=pc.locals_i.masked_fill(row, 0))
    sim = sim._replace(procs=procs)
    t = sim.clock if at is None else torch.as_tensor(
        at, dtype=sim.clock.dtype, device=dev)
    sim = _schedule_wake(sim, found, p, pr.SUCCESS, t=t)
    return sim, torch.where(found, slot, -1).to(INDEX)


def release_resource(spec: ModelSpec, sim: Sim, p, rid, pred=True) -> Sim:
    """Release binary resource ``rid`` held by ``p`` (parity:
    cmb_resource_release): the body of the C_RELEASE handler, also
    called inline from a block (``api.release``: a release never
    blocks).  A release by a process that does not hold the resource
    fails the replication with ERR_BAD_RELEASE."""
    re = sim.resources
    dev = re.holder.device
    lanes, nr = re.holder.shape
    rid = torch.as_tensor(rid, dtype=INDEX, device=dev).clamp(0, nr - 1)
    rid = rid.expand(lanes) if rid.dim() == 0 else rid
    owner_ok = ix.get(re.holder, rid) == p
    sim = sim._replace(resources=re._replace(
        holder=ix.put(re.holder, rid, -1, pred),
        acc=_record_if([r.record for r in spec.resources], re.acc, rid,
                       sim.clock, 0.0, pred),
    ))
    guard = _table(spec.resources, "guard", dev)[rid.long()]
    sim = _guard_signal(sim, guard, pred=pred, spec=spec)
    bad = ~owner_ok if pred is True else ~owner_ok & pred
    return _set_err(sim, bad, ERR_BAD_RELEASE)


def timer_add(sim: Sim, p, dur, sig):
    """A timer delivering ``sig`` to p after ``dur`` (parity:
    cmb_process_timer_add): a K_TIMER event at p's priority in the
    general table; returns (sim, handle).  A full table fails the
    replication with ERR_EVENT_OVERFLOW."""
    dev = sim.clock.device
    dur = torch.as_tensor(dur, dtype=sim.clock.dtype, device=dev)
    prio = ix.get(sim.procs.prio, p)
    es2, handle = ev.schedule(sim.events, sim.clock + _nanmax0(dur), prio,
                              K_TIMER, p, sig)
    sim = sim._replace(events=es2)
    return _set_err(sim, es2.overflow, ERR_EVENT_OVERFLOW), handle


def schedule(sim: Sim, t, prio, kind, subj=0, arg=0):
    """A user event of ``kind`` at absolute time ``t`` in the general
    table (parity: ``api.schedule``): returns (sim, handle); a full
    table or a non-finite time gives NULL_HANDLE and fails the
    replication with ERR_EVENT_OVERFLOW."""
    es2, handle = ev.schedule(sim.events, t, prio, kind, subj, arg)
    sim = sim._replace(events=es2)
    return _set_err(sim, es2.overflow, ERR_EVENT_OVERFLOW), handle


def timers_clear(sim: Sim, p) -> Sim:
    """Cancel every timer aimed at p (parity: cmb_process_timers_clear)."""
    es2, _ = ev.pattern_cancel(sim.events, K_TIMER, p)
    return sim._replace(events=es2)


def timer_cancel(sim: Sim, handle, spec: Optional[ModelSpec] = None):
    """Cancel a timer, or any event, by handle (parity:
    cmb_process_timer_cancel, cmb_event_cancel); returns (sim, existed).
    With ``spec`` (and a spec that can wait on events) the event's waiters
    wake now with CANCELLED; without it they wake at the next dispatch
    (:func:`_dispatch_evt_wakes`)."""
    es2, ok = ev.cancel(sim.events, handle)
    sim = sim._replace(events=es2)
    if spec is not None and _may_wait_events(spec, sim):
        sim = _cancel_evt_wakes(sim, handle, ok)
    return sim, ok


def priority_set(sim: Sim, p, new_prio) -> Sim:
    """Change a process's priority (parity: cmb_process_priority_set):
    the wakes' pick and the guards' best waiter read ``procs.prio`` live,
    which is the reference's reshuffle of its wake and guard entry.  A pid
    out of range changes nothing."""
    lanes, n = sim.procs.prio.shape
    t = torch.as_tensor(p, dtype=INDEX, device=sim.clock.device)
    t = t.expand(lanes) if t.dim() == 0 else t
    ok = (t >= 0) & (t < n)
    return sim._replace(procs=sim.procs._replace(prio=ix.put(
        sim.procs.prio, t.clamp(0, n - 1), new_prio, ok)))


def _pq_match(sim: Sim, qid: int, item):
    """The earliest-dequeuing live item equal to ``item`` (parity: the
    reference's ``_pq_match``): ``(one_hot, match, p_best, s_best)``,
    the greatest priority among the matches, then the least seq."""
    pq = sim.pqueues
    live, prio, seq = pq.live[:, qid], pq.prio[:, qid], pq.seq[:, qid]
    item = torch.as_tensor(item, device=prio.device).to(prio.dtype)
    item = item.reshape(-1, 1) if item.dim() else item
    match = live & (pq.items[:, qid] == item)
    p_best = torch.where(match, prio, -torch.inf).amax(dim=1)
    m2 = match & (prio == p_best[:, None])
    s_best = torch.where(m2, seq, _I32_MAX).amin(dim=1)
    return m2 & (seq == s_best[:, None]), match, p_best, s_best


def pqueue_cancel(sim: Sim, q, item):
    """``(sim, existed)``: the earliest-dequeuing item of priority queue
    ``q`` (its PQueueRef) equal to ``item`` removed (parity: the
    reference's ``api.pqueue_cancel``): a recording queue records its
    length where one was, and the rear guard is signalled (without
    observer forwarding, as the reference signals it)."""
    m, _, _, _ = _pq_match(sim, q.id, item)
    existed = m.any(dim=1)
    pq = sim.pqueues
    live = pq.live.clone()
    live[:, q.id] = pq.live[:, q.id] & ~m
    pq2 = pq._replace(live=live)
    if q.record and pq.acc is not None:
        n = live[:, q.id].to(INDEX).sum(dim=1).to(pq.items.dtype)
        pq2 = pq2._replace(acc=_record_row(pq.acc, q.id, sim.clock, n,
                                           existed))
    sim = sim._replace(pqueues=pq2)
    return _guard_signal(sim, q.rear_guard, pred=existed), existed


def pqueue_reprioritize(sim: Sim, qid: int, item, new_prio):
    """``(sim, existed)``: the earliest-dequeuing item of priority queue
    ``qid`` equal to ``item`` takes priority ``new_prio``, its FIFO seq
    kept (parity: the reference's ``api.pqueue_reprioritize``)."""
    m, _, _, _ = _pq_match(sim, qid, item)
    pq = sim.pqueues
    pr_ = torch.as_tensor(new_prio, device=pq.prio.device).to(pq.prio.dtype)
    pr_ = pr_.reshape(-1, 1) if pr_.dim() else pr_
    prio = pq.prio.clone()
    prio[:, qid] = torch.where(m, pr_, pq.prio[:, qid])
    return sim._replace(pqueues=pq._replace(prio=prio)), m.any(dim=1)


def release_pool(spec: ModelSpec, sim: Sim, p, k, amount, pred=True) -> Sim:
    """Release ``amount`` units of pool ``k`` held by ``p`` (partial
    release allowed; parity: cmb_resourcepool_release): the body of the
    C_POOL_REL handler, also called inline from a block
    (``api.pool_release``: a release never blocks, so it takes no chain
    iteration).  Releasing more than ``p`` holds, beyond a tolerance at
    the profile's resolution, fails the replication with
    ERR_BAD_RELEASE."""
    po = sim.pools
    dt, dev = po.level.dtype, po.level.device
    lanes, npool = po.level.shape
    k = torch.as_tensor(k, dtype=INDEX, device=dev).clamp(0, npool - 1)
    k = k.expand(lanes) if k.dim() == 0 else k
    amount = torch.as_tensor(amount, dtype=dt, device=dev).expand(lanes)
    held = ix.get2(po.held, k, p)
    amt = torch.minimum(amount, held)
    # held amounts accumulate in REAL, so ownership is checked with a
    # tolerance at REAL's resolution, floored at 1e-12
    tol = torch.maximum(
        64.0 * float(torch.finfo(dt).eps)
        * torch.maximum(torch.ones_like(amount), amount.abs()),
        torch.tensor(1e-12, dtype=dt, device=dev))
    owner_ok = held >= amount - tol
    cap = _table(spec.pools, "capacity", dev, dt)[k.long()]
    in_use = cap - (ix.get(po.level, k) + amt)
    sim = sim._replace(pools=po._replace(
        level=ix.add(po.level, k, amt, pred),
        held=ix.add2(po.held, k, p, -amt, pred),
        acc=_record_if([pl.record for pl in spec.pools], po.acc, k,
                       sim.clock, in_use, pred),
    ))
    guard = _table(spec.pools, "guard", dev)[k.long()]
    sim = _guard_signal(sim, guard, pred=pred, spec=spec)
    bad = ~owner_ok if pred is True else ~owner_ok & pred
    return _set_err(sim, bad, ERR_BAD_RELEASE)


def _table(refs, attr, dev, dt=INDEX):
    """A component attribute (``capacity``, ``guard``, ...) of each of
    ``refs`` as a tensor, to index by a lane's component id."""
    return torch.tensor([getattr(r, attr) for r in refs] or [0], dtype=dt,
                        device=dev)


def _record_if(flags, acc, row, t, v, pred):
    """:func:`_record_row` on the accumulator rows whose component
    records (``flags``, one a row); nothing when none does."""
    if acc is None or not any(flags):
        return acc
    if not all(flags):
        on = torch.tensor(flags, device=t.device)
        gate = on[row] if isinstance(row, int) else on[row.long()]
        pred = gate if pred is True else gate & pred
    return _record_row(acc, row, t, v, pred)


def _record_row(acc: ts.StepAccum, row, t, v, pred) -> ts.StepAccum:
    """``step_record`` on row ``row`` of a batched StepAccum, gated by
    ``pred`` (parity: the reference's ``_record_row``)."""
    one = tree.map(lambda x: ix.get(x, row), acc)
    upd = ts.step_record(one, t, v)
    return tree.map(lambda x, u: ix.put(x, row, u, pred), acc, upd)


def _nanmax0(x):
    # jnp.maximum(x, 0.0): NaN propagates
    return torch.where(torch.isnan(x) | (x > 0), x, torch.zeros_like(x))


def _make_apply(spec: ModelSpec):
    q_cap = [q.capacity for q in spec.queues] or [1]
    q_front = [q.front_guard for q in spec.queues] or [0]
    q_rear = [q.rear_guard for q in spec.queues] or [0]
    q_rec = [q.record for q in spec.queues] or [False]
    p_rec = [pl.record for pl in spec.pools]
    b_rec = [b.record for b in spec.buffers]
    pq_rec = [q.record for q in spec.pqueues]

    def set_pc(sim, p, pc, pred):
        return sim._replace(procs=sim.procs._replace(
            pc=ix.put(sim.procs.pc, p, pc, pred)))

    def h_hold(sim, p, cmd, is_retry, gate):
        sim = _schedule_wake(sim, gate, p, pr.SUCCESS,
                             t=sim.clock + _nanmax0(cmd.f))
        return set_pc(sim, p, cmd.next_pc, gate), torch.ones_like(gate)

    def h_exit(sim, p, cmd, is_retry, gate):
        return (finish_process(spec, sim, p, pr.SUCCESS, gate),
                torch.ones_like(gate))

    def h_jump(sim, p, cmd, is_retry, gate):
        return set_pc(sim, p, cmd.next_pc, gate), torch.zeros_like(gate)

    def h_queue(sim, p, cmd, is_retry, gate):
        """PUT and GET (and their fused ``*_hold`` twins) as one handler,
        in the reference's order: ring op, rear then front signal, the
        fused hold, the pc write, and the pend of a blocked verb."""
        dev = gate.device
        nq = len(q_cap)
        qid = cmd.i.clamp(0, nq - 1).to(torch.int64) if nq > 1 else \
            torch.zeros_like(cmd.i, dtype=torch.int64)
        is_put = (cmd.tag == pr.C_PUT) | (cmd.tag == pr.C_PUT_HOLD)
        fused = (cmd.tag == pr.C_PUT_HOLD) | (cmd.tag == pr.C_GET_HOLD)
        q = sim.queues
        size = ix.get(q.size, qid)
        head = ix.get(q.head, qid)
        cap = torch.tensor(q_cap, dtype=INDEX, device=dev)[qid]
        rear = torch.tensor(q_rear, dtype=INDEX, device=dev)[qid]
        front = torch.tensor(q_front, dtype=INDEX, device=dev)[qid]
        own_gid = torch.where(is_put, rear, front)
        may = is_retry | gd.is_empty(sim.procs.pend_guard, own_gid)
        blocked = torch.where(is_put, size >= cap, size <= 0) | ~may
        ok = ~blocked & gate
        ok_get = ok & ~is_put

        width = q.items.shape[2]
        flat = q.items.reshape(q.items.shape[0], -1)
        slot = qid * width + torch.where(is_put, (head + size) % cap, head)
        item = torch.where(ok, ix.get(flat, slot),
                           torch.zeros((), dtype=flat.dtype, device=dev))
        flat2 = ix.put(flat, slot, cmd.f, ok & is_put)
        dsz = torch.where(is_put, 1, -1).to(INDEX)
        # the length after the verb, from the clock on, gated by the same
        # ok as the size write (and by the queue's own flag)
        acc = _record_if(q_rec, q.acc, qid, sim.clock,
                         (size + dsz).to(flat.dtype), ok)
        sim = sim._replace(
            queues=q._replace(
                items=flat2.reshape(q.items.shape),
                head=ix.put(q.head, qid, (head + 1) % cap, ok_get),
                size=ix.add(q.size, qid, dsz, ok),
                acc=acc,
            ),
            procs=sim.procs._replace(
                got=ix.put(sim.procs.got, p, item, ok_get)),
        )
        # the queue-length high-water mark, gated by the same ok as the
        # size write
        sim = obs_metrics.on_queue_len(sim, qid, size + dsz, ok)
        sim = _guard_signal(sim, rear, pred=ok_get, spec=spec)
        sim = _guard_signal(sim, front, pred=ok, spec=spec)
        sim = _schedule_wake(sim, fused & ok, p, pr.SUCCESS,
                             t=sim.clock + _nanmax0(cmd.f3))
        sim = set_pc(sim, p, cmd.next_pc, gate)
        sim = _guard_wait(sim, p, own_gid, cmd, is_retry,
                          pred=blocked & gate)
        return sim, blocked | fused

    r_rec = [r.record for r in spec.resources]

    def _grab(sim, p, rid, pred):
        re = sim.resources
        return sim._replace(resources=re._replace(
            holder=ix.put(re.holder, rid, p, pred),
            acc=_record_if(r_rec, re.acc, rid, sim.clock, 1.0, pred)))

    def _res(cmd, gate):
        rid = cmd.i.clamp(0, len(spec.resources) - 1)
        return rid, _table(spec.resources, "guard", gate.device)[rid.long()]

    def h_acquire(sim, p, cmd, is_retry, gate):
        """acquire and its fused twin (parity: the reference's
        ``h_acquire``): grab a free resource unless others wait for it
        (a retry may), else pend on its guard."""
        rid, guard = _res(cmd, gate)
        free = ix.get(sim.resources.holder, rid) < 0
        may = is_retry | gd.is_empty(sim.procs.pend_guard, guard)
        ok = free & may
        fused = cmd.tag == pr.C_ACQ_HOLD
        sim = _grab(sim, p, rid, ok & gate)
        sim = _schedule_wake(sim, fused & ok & gate, p, pr.SUCCESS,
                             t=sim.clock + _nanmax0(cmd.f3))
        sim = set_pc(sim, p, cmd.next_pc, gate)
        sim = _guard_wait(sim, p, guard, cmd, is_retry, pred=~ok & gate)
        return sim, ~ok | fused

    def h_preempt(sim, p, cmd, is_retry, gate):
        """preempt and its fused twin (parity: the reference's
        ``h_preempt``): grab a free resource; kick a holder of equal or
        lower priority (its wait aborted, a PREEMPTED wake now) and take
        it over; else pend as an acquire."""
        rid, guard = _res(cmd, gate)
        holder = ix.get(sim.resources.holder, rid)
        free = holder < 0
        victim = holder.clamp(min=0)
        can_kick = ~free & (ix.get(sim.procs.prio, p)
                            >= ix.get(sim.procs.prio, victim))
        g_free, g_kick = free & gate, can_kick & gate
        blocked = ~free & ~can_kick
        fused = cmd.tag == pr.C_PRE_HOLD
        sim = _abort_wait(spec, sim, victim, pr.PREEMPTED, pred=g_kick)
        sim = _schedule_wake(sim, g_kick, victim, pr.PREEMPTED)
        # a holder switch records nothing (the resource stays in use)
        sim = sim._replace(resources=sim.resources._replace(
            holder=ix.put(sim.resources.holder, rid, p, g_kick)))
        sim = _grab(sim, p, rid, g_free)
        sim = _schedule_wake(sim, fused & ~blocked & gate, p, pr.SUCCESS,
                             t=sim.clock + _nanmax0(cmd.f3))
        sim = set_pc(sim, p, cmd.next_pc, (free | can_kick) & gate)
        sim = _guard_wait(sim, p, guard, cmd, is_retry, pred=blocked & gate)
        return sim, blocked | fused

    def h_release(sim, p, cmd, is_retry, gate):
        sim = release_resource(spec, sim, p, cmd.i, pred=gate)
        return set_pc(sim, p, cmd.next_pc, gate), torch.zeros_like(gate)

    def _mug(sim, p, k, rem, gate):
        """The pool preempt's mug (parity: the reference's
        ``_pool_acquire_impl`` with ``mug``): while the claim is short,
        take the whole holding of a holder of strictly lower priority
        than p, the lowest priority first, then the latest grab, then
        the lowest pid; the victim's wait is aborted and it wakes now
        with PREEMPTED; what the claim does not use goes back to the
        pool.  At most ``n_procs`` passes, the reference's bound."""
        n = spec.n_procs
        dev = gate.device
        pids = torch.arange(n, dtype=INDEX, device=dev)
        my_prio = ix.get(sim.procs.prio, p)
        for _ in range(n):
            held = ix.get(sim.pools.held, k)          # [L, P]
            seq = ix.get(sim.pools.held_seq, k)
            prio = sim.procs.prio
            vmask = ((held > 0.0) & (prio < my_prio[:, None])
                     & (pids[None, :] != p.reshape(-1, 1)))
            active = (rem > 0.0) & vmask.any(dim=1) & gate
            if not bool(active.any()):
                break
            vprio = torch.where(vmask, prio, _I32_MAX).amin(dim=1)
            m2 = vmask & (prio == vprio[:, None])
            vseq = torch.where(m2, seq, -1).amax(dim=1)
            v = ix.first_true(m2 & (seq == vseq[:, None])).clamp(
                max=n - 1).to(INDEX)
            loot = ix.get2(sim.pools.held, k, v)
            used = torch.minimum(loot, rem)
            surplus = loot - used
            po = sim.pools
            held2 = ix.put2(po.held, k, v, 0.0, active)
            sim = sim._replace(pools=po._replace(
                held=ix.add2(held2, k, p, used, active),
                level=ix.add(po.level, k, surplus, active)))
            sim = _abort_wait(spec, sim, v, pr.PREEMPTED, pred=active)
            sim = _schedule_wake(sim, active, v, pr.PREEMPTED)
            rem = torch.where(active, rem - used, rem)
        return sim, rem

    def h_pool_acquire(sim, p, cmd, is_retry, gate, mug=False):
        """Greedy acquire and, with ``mug``, the pool preempt (parity:
        the reference's ``_pool_acquire_impl``): take what is available
        now, then mug (:func:`_mug`), then pend for the rest; the pended
        claim is the remainder (pend_f) and the holding before the call
        (pend_f2).  Signals the pool's guard only on success, then arms
        the fused hold."""
        po = sim.pools
        dev, dt = gate.device, po.level.dtype
        k = cmd.i.clamp(0, len(spec.pools) - 1)
        kl = k.long()
        rem = cmd.f
        init_held = torch.where(is_retry, ix.get(sim.procs.pend_f2, p),
                                ix.get2(po.held, k, p))
        level = ix.get(po.level, k)
        take = torch.minimum(torch.maximum(rem, torch.zeros_like(rem)),
                             level)
        # the grab order is stamped on a holder's first units
        fresh = (ix.get2(po.held, k, p) <= 0.0) & gate
        po = po._replace(
            held_seq=ix.put2(po.held_seq, k, p, ix.get(po.next_seq, k),
                             fresh),
            next_seq=ix.add(po.next_seq, k, 1, fresh),
        )
        po = po._replace(level=ix.add(po.level, k, -take, gate),
                         held=ix.add2(po.held, k, p, take, gate))
        rem = rem - take
        if mug:
            sim, rem = _mug(sim._replace(pools=po), p, k, rem, gate)
            po = sim.pools
        done = rem <= 0.0
        fused = ((cmd.tag == pr.C_POOL_ACQ_HOLD)
                 | (cmd.tag == pr.C_POOL_PRE_HOLD))
        in_use = _table(spec.pools, "capacity", dev, dt)[kl] - ix.get(
            po.level, k)
        po = po._replace(acc=_record_if(p_rec, po.acc, k, sim.clock, in_use,
                                        gate))
        sim = sim._replace(pools=po)
        guard = _table(spec.pools, "guard", dev)[kl]
        sim = _guard_signal(sim, guard, pred=done & gate, spec=spec)
        sim = _schedule_wake(sim, fused & done & gate, p, pr.SUCCESS,
                             t=sim.clock + _nanmax0(cmd.f3))
        sim = set_pc(sim, p, cmd.next_pc, done & gate)
        sim = _guard_wait(sim, p, guard, cmd._replace(f=rem, f2=init_held),
                          is_retry, pred=~done & gate)
        return sim, ~done | fused

    def h_pool_preempt(sim, p, cmd, is_retry, gate):
        return h_pool_acquire(sim, p, cmd, is_retry, gate, mug=True)

    def h_pool_release(sim, p, cmd, is_retry, gate):
        sim = release_pool(spec, sim, p, cmd.i, cmd.f, pred=gate)
        return set_pc(sim, p, cmd.next_pc, gate), torch.zeros_like(gate)

    def h_buffer(sim, p, cmd, is_retry, gate):
        """Get and put (and their fused twins) as one handler (parity:
        the reference's ``_buffer_xfer_impl``): move what fits now and
        wait for the rest (pend_f the remainder, pend_f2 the total).
        Signals the other side's guard on any progress, then its own
        side's on completion only, then arms the fused hold."""
        bu = sim.buffers
        dev, dt = gate.device, bu.level.dtype
        b = cmd.i.clamp(0, len(spec.buffers) - 1)
        bl = b.long()
        getting = (cmd.tag == pr.C_BUF_GET) | (cmd.tag == pr.C_BUF_GET_HOLD)
        rem = cmd.f
        total = torch.where(is_retry, ix.get(sim.procs.pend_f2, p), cmd.f)
        level = ix.get(bu.level, b)
        cap = _table(spec.buffers, "capacity", dev, dt)[bl]
        room = torch.where(getting, level, cap - level)
        moved = torch.minimum(torch.maximum(rem, torch.zeros_like(rem)),
                              room)
        level2 = level + torch.where(getting, -moved, moved)
        rem2 = rem - moved
        done = rem2 <= 0.0
        front = _table(spec.buffers, "front_guard", dev)[bl]
        rear = _table(spec.buffers, "rear_guard", dev)[bl]
        my_guard = torch.where(getting, front, rear)
        other_guard = torch.where(getting, rear, front)
        sim = sim._replace(buffers=bu._replace(
            level=ix.put(bu.level, b, level2, gate),
            acc=_record_if(b_rec, bu.acc, b, sim.clock, level2, gate),
        ))
        sim = _guard_signal(sim, other_guard, pred=(moved > 0.0) & gate,
                            spec=spec)
        sim = _guard_signal(sim, my_guard, pred=done & gate, spec=spec)
        sim = sim._replace(procs=sim.procs._replace(
            got=ix.put(sim.procs.got, p, total, done & gate)))
        fused = (cmd.tag == pr.C_BUF_GET_HOLD) | (cmd.tag == pr.C_BUF_PUT_HOLD)
        sim = _schedule_wake(sim, fused & done & gate, p, pr.SUCCESS,
                             t=sim.clock + _nanmax0(cmd.f3))
        sim = set_pc(sim, p, cmd.next_pc, gate)
        sim = _guard_wait(sim, p, my_guard, cmd._replace(f=rem2, f2=total),
                          is_retry, pred=~done & gate)
        return sim, ~done | fused

    def h_cond_wait(sim, p, cmd, is_retry, gate):
        """A first issue always waits for a signal; a signalled retry
        proceeds if the predicate holds and waits again (keeping its
        place) if not."""
        cid = cmd.i.clamp(0, len(spec.conditions) - 1)
        proceed = is_retry & _cond_satisfied(spec, sim, cid, p)
        guard = _table(spec.conditions, "guard", gate.device)[cid.long()]
        sim = set_pc(sim, p, cmd.next_pc, gate)
        sim = _guard_wait(sim, p, guard, cmd, is_retry, pred=~proceed & gate)
        return sim, ~proceed

    def _pq(sim, cmd, gate):
        dev = gate.device
        qid = cmd.i.clamp(0, len(spec.pqueues) - 1)
        ql = qid.long()
        return (qid, _table(spec.pqueues, "capacity", dev)[ql],
                _table(spec.pqueues, "front_guard", dev)[ql],
                _table(spec.pqueues, "rear_guard", dev)[ql])

    def h_pq_put(sim, p, cmd, is_retry, gate):
        """pq_put and its fused twin (parity: the reference's
        ``h_pq_put``): the item into the lowest free column, stamped with
        the queue's next seq; a put frees no slot, so only the front
        guard is signalled; a full queue pends on the rear guard."""
        pq = sim.pqueues
        qid, cap, front, rear = _pq(sim, cmd, gate)
        live = ix.get(pq.live, qid)
        n_live = live.to(INDEX).sum(dim=1, dtype=INDEX)
        may = is_retry | gd.is_empty(sim.procs.pend_guard, rear)
        full = (n_live >= cap) | ~may
        ok = ~full & gate
        col = ix.first_true(~live).clamp(max=live.shape[1] - 1)
        sim = sim._replace(pqueues=pq._replace(
            items=ix.put2(pq.items, qid, col, cmd.f, ok),
            prio=ix.put2(pq.prio, qid, col, cmd.f2, ok),
            seq=ix.put2(pq.seq, qid, col, ix.get(pq.next_seq, qid), ok),
            live=ix.put2(pq.live, qid, col, True, ok),
            next_seq=ix.add(pq.next_seq, qid, 1, ok),
            acc=_record_if(pq_rec, pq.acc, qid, sim.clock,
                           (n_live + 1).to(pq.items.dtype), ok),
        ))
        sim = _guard_signal(sim, front, pred=ok, spec=spec)
        fused = cmd.tag == pr.C_PQ_PUT_HOLD
        sim = _schedule_wake(sim, fused & ok, p, pr.SUCCESS,
                             t=sim.clock + _nanmax0(cmd.f3))
        sim = set_pc(sim, p, cmd.next_pc, gate)
        sim = _guard_wait(sim, p, rear, cmd, is_retry, pred=full & gate)
        return sim, full | fused

    def h_pq_get(sim, p, cmd, is_retry, gate):
        """pq_get and its fused twin (parity: the reference's
        ``h_pq_get``): the highest priority, then the lowest seq, then
        the lowest column; signals the rear guard, then the front guard;
        an empty queue pends on the front guard."""
        pq = sim.pqueues
        qid, cap, front, rear = _pq(sim, cmd, gate)
        live = ix.get(pq.live, qid)
        may = is_retry | gd.is_empty(sim.procs.pend_guard, front)
        empty = ~live.any(dim=1) | ~may
        n_live = live.to(INDEX).sum(dim=1, dtype=INDEX)
        prio = ix.get(pq.prio, qid)
        seq = ix.get(pq.seq, qid)
        p_best = torch.where(live, prio, -torch.inf).amax(dim=1)
        m = live & (prio == p_best[:, None])
        s_min = torch.where(m, seq, _I32_MAX).amin(dim=1)
        hit = m & (seq == s_min[:, None])
        col = torch.where(hit.any(dim=1), ix.first_true(hit), 0)
        item = ix.get2(pq.items, qid, col)
        ok = ~empty & gate
        sim = sim._replace(
            pqueues=pq._replace(
                live=ix.put2(pq.live, qid, col, False, ok),
                acc=_record_if(pq_rec, pq.acc, qid, sim.clock,
                               (n_live - 1).to(pq.items.dtype), ok),
            ),
            procs=sim.procs._replace(
                got=ix.put(sim.procs.got, p, item, ok)),
        )
        sim = _guard_signal(sim, rear, pred=ok, spec=spec)
        sim = _guard_signal(sim, front, pred=ok, spec=spec)
        fused = cmd.tag == pr.C_PQ_GET_HOLD
        sim = _schedule_wake(sim, fused & ok, p, pr.SUCCESS,
                             t=sim.clock + _nanmax0(cmd.f3))
        sim = set_pc(sim, p, cmd.next_pc, gate)
        sim = _guard_wait(sim, p, front, cmd, is_retry, pred=empty & gate)
        return sim, empty | fused

    def _target(sim, i, col, empty):
        """Column ``col`` of process ``i`` per lane; ``empty`` where
        ``i`` is no process (the reference's one-hot read of no row)."""
        n = spec.n_procs
        ok = (i >= 0) & (i < n)
        return torch.where(ok, ix.get(col, i.clamp(0, n - 1)), empty)

    def h_wait_proc(sim, p, cmd, is_retry, gate):
        """Wait for process cmd.i to finish (parity: the reference's
        ``h_wait_proc``): a target finished already wakes p now with its
        exit signal, else p waits on it; either way p yields."""
        tgt = cmd.i
        finished = _target(sim, tgt, sim.procs.status, 0) == pr.FINISHED
        sig = _target(sim, tgt, sim.procs.exit_sig, 0)
        sim = _schedule_wake(sim, finished & gate, p, sig)
        sim = sim._replace(procs=sim.procs._replace(await_pid=ix.put(
            sim.procs.await_pid, p, tgt, ~finished & gate)))
        return set_pc(sim, p, cmd.next_pc, gate), torch.ones_like(gate)

    def h_wait_evt(sim, p, cmd, is_retry, gate):
        """Wait for event handle cmd.i to be dispatched (parity: the
        reference's ``h_wait_evt``): a dead handle wakes p now with
        CANCELLED, else p waits on it; either way p yields."""
        h = cmd.i
        valid = ev._valid(sim.events, h)
        sim = _schedule_wake(sim, ~valid & gate, p, pr.CANCELLED)
        sim = sim._replace(procs=sim.procs._replace(await_evt=ix.put(
            sim.procs.await_evt, p, h, valid & gate)))
        return set_pc(sim, p, cmd.next_pc, gate), torch.ones_like(gate)

    def h_invalid(sim, p, cmd, is_retry, gate):
        return _set_err(sim, gate, ERR_USER), torch.ones_like(gate)

    queue = h_queue if spec.queues else h_invalid
    table = [
        (h_hold, (pr.C_HOLD,)),
        (h_exit, (pr.C_EXIT,)),
        (h_jump, (pr.C_JUMP,)),
        (queue, (pr.C_PUT, pr.C_GET, pr.C_PUT_HOLD, pr.C_GET_HOLD)),
    ]
    if spec.resources:
        table += [(h_acquire, (pr.C_ACQUIRE, pr.C_ACQ_HOLD)),
                  (h_release, (pr.C_RELEASE,)),
                  (h_preempt, (pr.C_PREEMPT, pr.C_PRE_HOLD))]
    if spec.pools:
        table += [(h_pool_acquire, (pr.C_POOL_ACQ, pr.C_POOL_ACQ_HOLD)),
                  (h_pool_release, (pr.C_POOL_REL,)),
                  (h_pool_preempt, (pr.C_POOL_PRE, pr.C_POOL_PRE_HOLD))]
    if spec.buffers:
        table.append((h_buffer, (pr.C_BUF_GET, pr.C_BUF_PUT,
                                 pr.C_BUF_GET_HOLD, pr.C_BUF_PUT_HOLD)))
    if spec.pqueues:
        table += [(h_pq_put, (pr.C_PQ_PUT, pr.C_PQ_PUT_HOLD)),
                  (h_pq_get, (pr.C_PQ_GET, pr.C_PQ_GET_HOLD))]
    if spec.conditions:
        table.append((h_cond_wait, (pr.C_COND_WAIT,)))
    table += [(h_wait_proc, (pr.C_WAIT_PROC,)),
              (h_wait_evt, (pr.C_WAIT_EVT,))]
    handled = [t for _, tags in table for t in tags]

    def apply_command(sim, p, cmd, is_retry, active):
        tag = cmd.tag.clamp(0, pr.N_COMMANDS - 1)
        yielded = torch.zeros_like(active)
        sels = [(h, torch.isin(tag, torch.tensor(tags, device=tag.device)))
                for h, tags in table]
        sels.append((h_invalid, ~torch.isin(
            tag, torch.tensor(handled, device=tag.device))))
        for h, sel in sels:
            gate = sel & active
            if not bool(gate.any()):
                continue  # every write of h is gated off on every lane
            sim, y = h(sim, p, cmd, is_retry, gate)
            yielded = torch.where(gate, y, yielded)
        return sim, yielded

    return apply_command


def _boundary_stub(sim, p, sig):
    # a boundary block under defer_boundary: never dispatched (the step
    # defers it), and a mid-chain entry has failed the lane already
    return sim, pr.exit_()


def make_step(spec: ModelSpec, defer_boundary: bool = False):
    """Build ``step(sim) -> sim`` dispatching exactly one event per lane.
    With ``defer_boundary`` (and a spec that has boundary blocks) an
    event whose subject sits at a boundary pc is peeked, not consumed:
    the lane's ``boundary_pending`` is set instead (parity: the
    reference's step in kernel mode)."""
    defer = defer_boundary and bool(spec.boundary_pcs)
    blocks = [_boundary_stub if defer and pc in spec.boundary_pcs else b
              for pc, b in enumerate(spec.blocks)]
    apply_command = _make_apply(spec)
    n_procs = spec.n_procs
    handlers = list(spec.user_handlers)

    def at_boundary(pc):
        return torch.isin(pc, torch.tensor(spec.boundary_pcs, dtype=INDEX,
                                           device=pc.device))

    def run_block(sim, p, sig, need):
        pc = ix.get(sim.procs.pc, p).clamp(0, len(blocks) - 1)
        lanes = pc.shape[0]
        real = sim.clock.dtype
        masks, outs = [], []
        cmd = None
        for j, blk in enumerate(blocks):
            m = (pc == j) & need
            if not bool(m.any()):
                continue
            with _logger.lanes(m):  # a log line a lane the block ran for
                s_j, c_j = blk(sim, p, sig)
            c_j = pr.normalize(c_j, lanes, pc.device, real)
            masks.append(m)
            outs.append(s_j)
            cmd = c_j if cmd is None else pr.select(m, c_j, cmd)
        if cmd is None:
            cmd = pr.normalize(pr.exit_(), lanes, pc.device, real)
        return _merge(masks, outs, sim), cmd

    def resume(sim, p, sig, gate):
        """Resume process p (per lane) with signal sig where ``gate``:
        retry a pended command on a SUCCESS wake, then chain blocks until
        the process yields."""
        sim = _cancel_wake(sim, p, gate)
        # any delivery ends a wait on a process or an event (the
        # reference's resume: a timer's wake bypasses the abort)
        sim = _clear_awaits(spec, sim, p, gate)
        pend = _pend_of(sim, p)
        has_pend = pend.tag != pr.NO_PEND
        # unwait before the cleanup (the reference's order): the pend's
        # clear takes p off its guard, so a pool rollback's signal cannot
        # wake p itself
        sim = _clear_pend(sim, p, gate)
        # a non-SUCCESS wake of a pended process (a timer or an
        # interrupt) aborts its wait: the signal goes to the continuation
        abort = gate & has_pend & (sig != pr.SUCCESS)
        if (spec.pools or spec.buffers) and bool(abort.any()):
            sim = _abort_cleanup(spec, sim, p, pend, sig, pred=abort)
        use_pend0 = has_pend & (sig == pr.SUCCESS)

        def cond(c):
            s, _, yielded, n, _ = c
            alive = (ix.get(s.procs.status, p) == pr.RUNNING) & (s.err == 0)
            return ~yielded & alive & (n < MAX_CHAIN)

        def body(c, active):
            s, sg, _, n, use_pend = c
            if defer:
                # boundary blocks are entered by dispatch only: reaching
                # one mid-chain fails the lane (its stub then exits)
                s = _set_err(s, active & ~use_pend
                             & at_boundary(ix.get(s.procs.pc, p)),
                             ERR_BOUNDARY)
            s_blk, c_blk = run_block(s, p, sg, active & ~use_pend)
            s2 = _where(use_pend, s, s_blk)
            cmd = pr.Command(*[torch.where(use_pend, a, b)
                               for a, b in zip(pend, c_blk)])
            s2, yielded = apply_command(s2, p, cmd, use_pend, active)
            return (s2, torch.full_like(sg, pr.SUCCESS), yielded, n + 1,
                    torch.zeros_like(use_pend))

        carry = (sim, sig.to(INDEX), ~gate,
                 torch.zeros_like(sig, dtype=INDEX), use_pend0)
        sim, _, _, n, _ = _while(cond, body, carry)
        sim = _set_err(sim, n >= MAX_CHAIN, ERR_CHAIN_RUNAWAY)
        # n == 0 exactly where the resume was gated off: not counted
        return obs_metrics.on_resume(sim, n, use_pend0)

    def step(sim: Sim) -> Sim:
        event, take_e, take_w = ev.peek_merged(
            sim.events, sim.wakes, sim.procs.prio, K_PROC)
        proceed = event.found
        if defer:
            pc_t = ix.get(sim.procs.pc, event.subj.clamp(0, n_procs - 1))
            boundary = proceed & (event.kind <= K_TIMER) & at_boundary(pc_t)
            proceed = proceed & ~boundary
            sim = sim._replace(boundary_pending=boundary)
        if sim.metrics is not None:
            # the event set's occupancy before the pop: the high-water
            # gauge of how close the lane came to an overflow
            occupancy = (torch.isfinite(sim.events.time).sum(dim=1)
                         + torch.isfinite(sim.wakes.time).sum(dim=1))
        es2, wk2 = ev.consume_merged(sim.events, sim.wakes, take_e, take_w,
                                     proceed)
        sim = sim._replace(
            events=es2,
            wakes=wk2,
            clock=torch.where(proceed, event.time, sim.clock),
            n_events=sim.n_events + proceed.to(sim.n_events.dtype),
        )
        # the dispatch site of the flight recorder and the registry (each
        # returns sim itself where the Sim carries none)
        sim = obs_trace.emit(sim, event.time, event.subj, event.kind,
                             event.arg, proceed)
        if sim.metrics is not None:
            sim = obs_metrics.on_dispatch(sim, event.kind, occupancy,
                                          proceed)
        if _may_wait_events(spec, sim):
            # the event's waiters wake before its action runs; the stale
            # arm may arm wakes on an empty pop, so "out of events" is
            # judged after the scan (a cancel that drains the set must
            # still wake its waiter).  A deferred boundary lane scans
            # nothing: its wakes would come before the deferred event
            sim = _dispatch_evt_wakes(sim, event.handle, proceed,
                                      ~sim.boundary_pending if defer
                                      else None)
            sim = sim._replace(done=sim.done | (
                ~event.found & ev.is_empty(sim.events)
                & ev.wakes_empty(sim.wakes)))
        else:
            sim = sim._replace(done=sim.done | ~event.found)
        # kinds K_PROC and K_TIMER resume the subject (an out-of-range
        # subject reads as not RUNNING); kind N_KINDS + k calls user
        # handler k, its Sim kept where the event was found; a kind out
        # of range clips into the table (the reference's _vswitch)
        kind = event.kind.clamp(0, N_KINDS + len(handlers) - 1)
        subj = event.subj
        in_range = (subj >= 0) & (subj < n_procs)
        p = subj.clamp(0, n_procs - 1)
        alive = in_range & (ix.get(sim.procs.status, p) == pr.RUNNING)
        sim = resume(sim, p, event.arg, alive & proceed & (kind < N_KINDS))
        for k, fn in enumerate(handlers):
            gate = proceed & (kind == N_KINDS + k)
            if bool(gate.any()):
                with _logger.lanes(gate):
                    sim = _where(gate, fn(sim, subj, event.arg), sim)
        return sim

    return step


def make_cond(spec: ModelSpec, t_end: Optional[float] = None,
              defer_boundary: bool = False):
    """Per-lane liveness ``cond(sim) -> [L] bool`` (parity:
    ``cimba_tpu.core.loop.make_cond``).  A lane whose tables are empty
    stays live while a RUNNING process waits on an event (its handle died
    with the set: the next step's scan wakes it with CANCELLED).  With
    ``defer_boundary`` a lane waiting on a boundary step is not live.  A
    Sim's ``t_stop`` leaf, where it has one, is each lane's horizon in
    place of ``t_end``."""
    defer = defer_boundary and bool(spec.boundary_pcs)

    def cond(sim: Sim):
        empty = ev.is_empty(sim.events) & ev.wakes_empty(sim.wakes)
        if _may_wait_events(spec, sim):
            stranded = ((sim.procs.await_evt >= 0)
                        & (sim.procs.status == pr.RUNNING)).any(dim=1)
            out_of_work = empty & ~stranded
        else:
            out_of_work = empty
        live = ~sim.done & (sim.err == 0) & ~out_of_work
        if defer:
            live = live & ~sim.boundary_pending
        # a Sim's per-lane horizon stands in for the static t_end: the
        # same compare on the same TIME values (t_stop = t_end gives the
        # static run's decisions, +inf no horizon's, -inf a dead lane)
        lim = sim.t_stop if sim.t_stop is not None else t_end
        if lim is not None:
            nxt = torch.minimum(ev.min_time(sim.events),
                                sim.wakes.time.amin(dim=1))
            live = live & ((nxt <= lim) | (empty & ~out_of_work))
        return live

    return cond


def make_run(spec: ModelSpec, t_end: Optional[float] = None,
             max_steps: Optional[int] = None, defer_boundary: bool = False):
    """Build ``run(sim) -> sim``: dispatch events until every lane stops,
    fails, runs out of events or passes ``t_end``.  ``max_steps`` bounds
    one call to that many dispatches per lane; truncation is exact, so a
    host loop that calls again until :func:`make_cond` reports every lane
    done reproduces the unbounded run bit for bit.  ``defer_boundary``
    also stops a lane at its next boundary dispatch (the chunk of the
    boundary protocol, see :mod:`cimba_tpu_torch.core.kernel_run`)."""
    step = make_step(spec, defer_boundary)
    cond = make_cond(spec, t_end, defer_boundary)
    if max_steps is not None and max_steps <= 0:
        raise ValueError(f"max_steps must be positive, got {max_steps}")
    bound = max_steps if max_steps is not None else float("inf")

    def run(sim: Sim) -> Sim:
        k = torch.zeros_like(sim.err)

        def kcond(c):
            return cond(c[1]) & (c[0] < bound)

        def kbody(c, active):
            return c[0] + 1, step(c[1])

        return _while(kcond, kbody, (k, sim))[1]

    return run


# --- chunked dispatch: runs of any length, refill -----------------------


def make_chunk(spec: ModelSpec, t_end: Optional[float] = None,
               max_steps: int = 512, donate: bool = True,
               audit: bool = False):
    """Build ``chunk(sims) -> (sims, any_live)`` over a lane-first Sim
    (parity: ``cimba_tpu.core.loop.make_chunk``): every lane advances by
    at most ``max_steps`` events, and ``any_live`` is a bool tensor on the
    Sim's device, read by the host only when it wants to
    (:func:`drive_chunks`).

    On the card a chunk is one launch of the spec's CUDA chunk kernel
    (``core.kernel_run.kernel_for``), which reads each lane's horizon
    from the Sim's ``t_stop`` leaf where it has one; for a spec with
    boundary blocks (AWACS) it is followed by one launch of the boundary
    round, which steps the lanes the chunk froze at the boundary and
    leaves the others as they are.  The kernel works in place: with
    ``donate`` the Sim passed in is the one returned, else a copy is
    advanced.  On CPU tensors a chunk is the plain engine,
    ``make_run(spec, t_end, max_steps=max_steps)``, which returns new
    tensors.  A chunk of a Sim whose lanes are all done changes no
    leaf, so chunks dispatched past the end are harmless.

    ``audit=True`` (the determinism audit) returns a third output, the
    carry-class digest vector of the Sim after the chunk
    (:func:`cimba_tpu_torch.obs.audit.sim_digest`, computed on the Sim's
    device), which :func:`drive_chunks` hands to ``on_digest``.  Off (the
    default), the chunk computes no digest."""
    if max_steps <= 0:
        raise ValueError(f"max_steps must be positive, got {max_steps}")
    plain = make_run(spec, t_end=t_end, max_steps=max_steps)
    cond = make_cond(spec, t_end)
    card = {}

    def chunk(sims: Sim):
        if not sims.clock.is_cuda:
            sims = plain(sims)
            return sims, cond(sims).any()
        from cimba_tpu_torch.core import kernel_run

        if not card:
            lay, kernel, _ = kernel_run.kernel_for(spec, sims)
            card.update(lay=lay, kernel=kernel, boundary=(
                kernel_run.make_boundary_step(spec) if spec.boundary_pcs
                else None))
        if not donate:
            sims = tree.map(
                lambda x: x.clone(memory_format=torch.contiguous_format),
                sims)
        sims = card["kernel"](sims, card["lay"], max_steps, t_end)
        if card["boundary"] is not None:
            sims = card["boundary"](sims)
        return sims, cond(sims).any()

    if not audit:
        return chunk
    from cimba_tpu_torch.obs import audit as obs_audit

    def audited(sims: Sim):
        sims, any_live = chunk(sims)
        return sims, any_live, obs_audit.sim_digest(sims)

    return audited


def make_refill(spec: ModelSpec):
    """Build ``refill(sims, mask, reps, seeds, t_stops, params) -> sims``
    (parity: ``cimba_tpu.core.loop.make_refill``): the lanes where the
    bool ``[L]`` ``mask`` holds start afresh, as :func:`init_sim` starts
    replication ``reps[l]`` under ``seeds[l]`` with horizon
    ``t_stops[l]`` and parameters ``params`` (scalars, or rows with
    leading axis L); every other lane keeps every leaf bit for bit.  A
    refilled lane therefore runs as its solo run would.  The Sim must
    carry the ``t_stop`` leaf (``-inf`` retires a lane); one without it
    raises.  Returns new tensors on the Sim's device."""

    def refill(sims: Sim, mask, reps, seeds, t_stops, params):
        if sims.t_stop is None:
            raise ValueError(
                "make_refill: the wave carries no per-lane t_stop leaf; "
                "refill needs a wave built with init_sim(..., t_stop=...)")
        dev = sims.clock.device
        fresh = init_sim(spec, seeds, reps, params, t_stop=t_stops,
                         device=dev)
        m = torch.as_tensor(mask, dtype=torch.bool, device=dev)

        def sel(a, b):
            return torch.where(m.reshape((-1,) + (1,) * (a.dim() - 1)),
                               a, b)

        return tree.map(sel, fresh, sims)

    return refill


def make_lanes_live(spec: ModelSpec, t_end: Optional[float] = None):
    """Build ``live(sims) -> bool [L]``: each lane's :func:`make_cond`
    liveness, the per-lane readback a refill loop polls between
    chunks (parity: ``cimba_tpu.core.loop.make_lanes_live``)."""
    return make_cond(spec, t_end)


def drive_chunks(chunk, sims: Sim, *, poll_every: int = 4, on_chunk=None,
                 on_state=None, on_state_every: int = 0,
                 max_chunks: Optional[int] = None, n0: int = 0,
                 on_digest=None, on_boundary=None) -> Sim:
    """Call ``chunk(sims) -> (sims, any_live)`` until no lane is live
    (parity: ``cimba_tpu.core.loop.drive_chunks``).

    The ``any_live`` flags stay device tensors in a queue, and the host
    reads the oldest one only once ``poll_every`` are queued, so chunks
    keep being queued on the card while earlier ones run.  A flag read
    late lets up to ``poll_every - 1`` chunks run after every lane is
    done, which change nothing.  ``on_chunk(n)`` is called after each
    chunk; ``on_state(sims, n)`` every ``on_state_every`` chunks, before
    the Sim goes into the next chunk (the checkpoint hook); ``n0``
    offsets the chunk counter (a resumed run counts on);
    ``max_chunks`` stops after that many chunks, finished or not.
    ``on_digest(n, vec)`` is called after each chunk of an audited chunk
    (``make_chunk(..., audit=True)``) with its digest vector, still a
    tensor on the Sim's device; chunks past the end append too (their
    digests repeat the settled state).
    ``on_boundary(n, sims)`` may return a replacement Sim (a refill),
    after which the queued flags, which describe the Sim before it, are
    dropped."""
    from collections import deque

    poll_every = max(int(poll_every), 1)
    pending = deque()
    n = n0
    while max_chunks is None or n - n0 < max_chunks:
        out = chunk(sims)
        sims, any_live = out[0], out[1]
        n += 1
        if on_digest is not None and len(out) > 2:
            on_digest(n, out[2])
        if on_chunk is not None:
            on_chunk(n)
        if on_boundary is not None:
            respliced = on_boundary(n, sims)
            if respliced is not None:
                sims = respliced
                pending.clear()
                continue
        if on_state is not None and on_state_every > 0 \
                and n % on_state_every == 0:
            on_state(sims, n)
        pending.append(any_live)
        if len(pending) >= poll_every and not bool(pending.popleft()):
            break
    return sims


def make_chunked_run(spec: ModelSpec, t_end: Optional[float] = None,
                     chunk_steps: int = 512, poll_every: int = 4,
                     donate: bool = True, on_chunk=None,
                     max_chunks: Optional[int] = None):
    """Build ``run(sims) -> sims``: :func:`make_chunk` driven by
    :func:`drive_chunks` until every lane is done (parity:
    ``cimba_tpu.core.loop.make_chunked_run``).  The result is the
    monolithic ``make_run(spec, t_end)``'s, leaf for leaf: a chunk only
    splits the event loop.  On the card each chunk is one kernel launch
    in place, on the Sim passed in with ``donate``, else on one copy of
    it; the chunk is ``run.chunk``."""
    chunk = make_chunk(spec, t_end=t_end, max_steps=chunk_steps)

    def run(sims: Sim) -> Sim:
        if not donate and sims.clock.is_cuda:
            # one copy for the whole run: the chunks work on it in place
            sims = tree.map(
                lambda x: x.clone(memory_format=torch.contiguous_format),
                sims)
        return drive_chunks(chunk, sims, poll_every=poll_every,
                            on_chunk=on_chunk, max_chunks=max_chunks)

    run.chunk = chunk
    return run
