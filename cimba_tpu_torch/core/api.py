"""Block-author helpers (torch port of :mod:`cimba_tpu.core.api`): the
readers of a lane's state and the calls a block makes between yields.
``p`` is the ``[L]`` pid tensor a block receives; every helper acts on
all replication lanes at once.

Under :mod:`cimba_tpu_torch.core.trace` a block runs on a symbolic
one-lane Sim: :func:`draw` then records one draw node naming its
sampler; :func:`pool_release`, :func:`release`, :func:`cond_signal`,
:func:`interrupt`, :func:`stop_process`, :func:`timer_add`,
:func:`timers_clear`, :func:`schedule`, :func:`spawn`,
:func:`timer_cancel`, :func:`event_cancel`, :func:`event_reschedule`,
:func:`event_reprioritize`, :func:`event_pattern_cancel`,
:func:`priority_set`, :func:`pqueue_cancel` and
:func:`pqueue_reprioritize` one engine call each; :func:`pqueue_length`,
:func:`pqueue_position`, :func:`queue_position`,
:func:`event_is_scheduled`, :func:`event_time`, :func:`event_priority`,
:func:`event_pattern_count` and :func:`event_pattern_find` one reader
node each (they scan a queue's slots or the event table); every other
helper is traced through as torch ops."""

from __future__ import annotations

import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import eventset as _ev
from cimba_tpu_torch.core import ix
from cimba_tpu_torch.core import loop as _loop
from cimba_tpu_torch.core import trace as _trace
from cimba_tpu_torch.core.loop import ERR_USER, Sim


def clock(sim: Sim):
    """Current simulation time (parity: ``cmb_time``)."""
    return sim.clock


def draw(sim: Sim, dist, *params):
    """Draw from a distribution, threading each lane's RNG stream:
    ``sim, x = api.draw(sim, random.exponential, mean)``.  The sample
    takes the Sim's own dtype profile."""
    if _trace.is_symbolic(sim):
        return _trace.draw(sim, dist, params)
    prof = "f32" if sim.clock.dtype == torch.float32 else "f64"
    with config.profile(prof):
        rng, x = dist(sim.rng, *params)
    return sim._replace(rng=rng), x


def got(sim: Sim, p):
    """Result register: the item produced by this process's last GET."""
    return ix.get(sim.procs.got, p)


def local_f(sim: Sim, p, k: int):
    """Float local ``k`` of process ``p``."""
    return ix.get(sim.procs.locals_f[:, :, k], p)


def local_i(sim: Sim, p, k: int):
    """Integer local ``k`` of process ``p``."""
    return ix.get(sim.procs.locals_i[:, :, k], p)


def set_local_i(sim: Sim, p, k: int, v) -> Sim:
    li = sim.procs.locals_i
    col = ix.put(li[:, :, k], p, torch.as_tensor(v, dtype=INDEX))
    return sim._replace(procs=sim.procs._replace(
        locals_i=torch.cat([li[:, :, :k], col[:, :, None], li[:, :, k + 1:]],
                           dim=2)))


def set_local_f(sim: Sim, p, k: int, v) -> Sim:
    lf = sim.procs.locals_f
    col = ix.put(lf[:, :, k], p, torch.as_tensor(v, dtype=lf.dtype))
    return sim._replace(procs=sim.procs._replace(
        locals_f=torch.cat([lf[:, :, :k], col[:, :, None], lf[:, :, k + 1:]],
                           dim=2)))


def add_local_i(sim: Sim, p, k: int, dv=1) -> Sim:
    li = sim.procs.locals_i
    col = ix.add(li[:, :, k], p, torch.as_tensor(dv, dtype=INDEX))
    return sim._replace(procs=sim.procs._replace(
        locals_i=torch.cat([li[:, :, :k], col[:, :, None], li[:, :, k + 1:]],
                           dim=2)))


def user(sim: Sim):
    return sim.user


def set_user(sim: Sim, new_user) -> Sim:
    return sim._replace(user=new_user)


def stop(sim: Sim, pred=True) -> Sim:
    """End the replication after the current event."""
    return sim._replace(done=sim.done | pred)


def fail(sim: Sim, pred=True) -> Sim:
    """Mark the replication failed with ERR_USER (parity: the
    reference's ``api.fail``); an earlier error code stays."""
    err = torch.where((sim.err == 0) & pred,
                      torch.tensor(ERR_USER, dtype=INDEX,
                                   device=sim.err.device), sim.err)
    return sim._replace(err=err)


def _id(ref):
    return ref.id if hasattr(ref, "id") else ref


def buffer_level(sim: Sim, b):
    """Amount stored in a buffer (parity: cmb_buffer_level)."""
    return sim.buffers.level[:, _id(b)]


def buffer_space(sim: Sim, b):
    """Room left in a buffer (parity: cmb_buffer_space); takes the
    BufferRef, which holds the capacity."""
    if not hasattr(b, "capacity"):
        raise TypeError("buffer_space needs the BufferRef, not a bare id")
    lv = sim.buffers.level[:, b.id]
    return torch.tensor(b.capacity, dtype=lv.dtype, device=lv.device) - lv


def queue_length(sim: Sim, q):
    """Items in an object queue (parity: cmb_objectqueue_length)."""
    return sim.queues.size[:, _id(q)]


def queue_space(sim: Sim, q):
    """Free slots in an object queue (parity: cmb_objectqueue_space);
    takes the QueueRef, which holds the capacity."""
    if not hasattr(q, "capacity"):
        raise TypeError("queue_space needs the QueueRef, not a bare id")
    size = sim.queues.size[:, q.id]
    return (torch.tensor(q.capacity, dtype=INDEX, device=size.device)
            - size).to(INDEX)


def queue_position(sim: Sim, q, item):
    """1-based position of the first item equal to ``item`` from the
    front of an object queue, 0 if absent (parity:
    cmb_objectqueue_position; the payload is the key): each ring slot's
    place is (slot - head) mod the ring's width, as the reference counts
    it."""
    qid = _id(q)
    if _trace.is_symbolic(sim):
        item = torch.as_tensor(item).to(sim.queues.items.dtype)
        return _trace.read(sim, "q_position", qid, item)
    qu = sim.queues
    items = qu.items[:, qid]
    cap = items.shape[1]
    item = torch.as_tensor(item, device=items.device).to(items.dtype)
    item = item.reshape(-1, 1) if item.dim() else item
    c = torch.arange(cap, device=items.device)
    pos = (c[None, :] - qu.head[:, qid, None]) % cap
    hit = (pos < qu.size[:, qid, None]) & (items == item)
    best = torch.where(hit, pos, cap).amin(dim=1)
    return torch.where(hit.any(dim=1), best + 1, 0).to(INDEX)


def pqueue_length(sim: Sim, q):
    """Items in a priority queue (parity: cmb_priorityqueue_length), as
    an int64 count: the reference's sum of int32 flags promotes to it."""
    qid = _id(q)
    if _trace.is_symbolic(sim):
        return _trace.read(sim, "pq_length", qid)
    return sim.pqueues.live[:, qid].to(INDEX).sum(dim=1)


def pqueue_position(sim: Sim, q, item):
    """1-based place in dequeue order (priority descending, FIFO among
    equal priorities) of the first item equal to ``item``, 0 if absent
    (parity: cmb_priorityqueue_position; the payload is the key, as in
    the reference's restatement)."""
    qid = _id(q)
    if _trace.is_symbolic(sim):
        item = torch.as_tensor(item).to(sim.pqueues.prio.dtype)
        return _trace.read(sim, "pq_position", qid, item)
    _, match, p_best, s_best = _loop._pq_match(sim, qid, item)
    pq = sim.pqueues
    live, prio, seq = pq.live[:, qid], pq.prio[:, qid], pq.seq[:, qid]
    ahead = live & ((prio > p_best[:, None])
                    | ((prio == p_best[:, None]) & (seq < s_best[:, None])))
    pos = ahead.to(INDEX).sum(dim=1, dtype=INDEX) + 1
    return torch.where(match.any(dim=1), pos, 0).to(INDEX)


def pqueue_cancel(sim: Sim, q, item):
    """``(sim, existed)``: remove the earliest-dequeuing item equal to
    ``item`` from a priority queue (parity: cmb_priorityqueue_cancel; the
    payload is the key, as in :func:`pqueue_position`).  It takes the
    PQueueRef: the freed slot signals the rear guard, so a blocked putter
    wakes, and a recording queue records its length."""
    if not hasattr(q, "rear_guard"):
        raise TypeError("pqueue_cancel needs the PQueueRef, not a bare id")
    if _trace.is_symbolic(sim):
        item = torch.as_tensor(item).to(sim.pqueues.prio.dtype)
        return _trace.engine_call(sim, "pqueue_cancel", q.id, item)
    return _loop.pqueue_cancel(sim, q, item)


def pqueue_reprioritize(sim: Sim, q, item, new_prio):
    """``(sim, existed)``: give the earliest-dequeuing item equal to
    ``item`` the priority ``new_prio``, keeping its FIFO seq (parity:
    cmb_priorityqueue_reprioritize; the payload is the key)."""
    qid = _id(q)
    if _trace.is_symbolic(sim):
        dt = sim.pqueues.prio.dtype
        return _trace.engine_call(sim, "pqueue_reprioritize", qid,
                                  torch.as_tensor(item).to(dt),
                                  torch.as_tensor(new_prio).to(dt))
    return _loop.pqueue_reprioritize(sim, qid, item, new_prio)


def resource_holder(sim: Sim, r):
    """Pid holding a binary resource, -1 if free (parity:
    cmb_resource_holder)."""
    return sim.resources.holder[:, _id(r)]


def pool_level(sim: Sim, pool):
    """Units available in a resource pool (parity:
    cmb_resourcepool_level)."""
    return sim.pools.level[:, _id(pool)]


def pool_in_use(sim: Sim, pool):
    """Units held out of a resource pool (parity:
    cmb_resourcepool_in_use); takes the PoolRef, which holds the
    capacity."""
    if not hasattr(pool, "capacity"):
        raise TypeError("pool_in_use needs the PoolRef, not a bare id")
    lv = sim.pools.level[:, pool.id]
    return torch.tensor(pool.capacity, dtype=lv.dtype, device=lv.device) - lv


def pool_held(sim: Sim, pool, p):
    """Units process ``p`` holds from a pool (parity:
    cmb_resourcepool_held_by_process)."""
    return ix.get(sim.pools.held[:, _id(pool)], p)


def proc_priority(sim: Sim, p):
    """Current priority of process ``p`` (parity: cmb_process_priority)."""
    return ix.get(sim.procs.prio, p)


def proc_status(sim: Sim, p):
    """CREATED, RUNNING or FINISHED (parity: cmb_process_status)."""
    return ix.get(sim.procs.status, p)


def pool_release(sim: Sim, spec, pool, p, amount) -> Sim:
    """Release pool units inline from a block (partial release allowed;
    parity: cmb_resourcepool_release): it never blocks, so it takes no
    chain iteration.  ``cmd.pool_release`` is the command form."""
    if _trace.is_symbolic(sim):
        return _trace.engine_call(sim, "pool_release", _id(pool), p, amount)
    return _loop.release_pool(spec, sim, p, _id(pool), amount)


def cond_signal(sim: Sim, spec, condition) -> Sim:
    """Signal a condition: wake every waiter whose predicate holds
    (parity: cmb_condition_signal)."""
    if _trace.is_symbolic(sim):
        return _trace.engine_call(sim, "cond_signal", _id(condition))
    return _loop.cond_signal(spec, sim, _id(condition))


def interrupt(sim: Sim, spec, target, sig) -> Sim:
    """Deliver ``sig`` to process ``target`` now, aborting what it waits
    on (parity: cmb_process_interrupt)."""
    if _trace.is_symbolic(sim):
        return _trace.engine_call(sim, "interrupt", target, sig)
    return _loop.interrupt(spec, sim, target, sig)


def timer_add(sim: Sim, p, dur, sig):
    """``(sim, handle)``: deliver ``sig`` to p after ``dur`` unless
    cancelled (parity: cmb_process_timer_add)."""
    if _trace.is_symbolic(sim):
        return _trace.engine_call(sim, "timer_add", p, dur, sig)
    return _loop.timer_add(sim, p, dur, sig)


def timers_clear(sim: Sim, p) -> Sim:
    """Cancel every timer aimed at p (parity: cmb_process_timers_clear)."""
    if _trace.is_symbolic(sim):
        return _trace.engine_call(sim, "timers_clear", p)
    return _loop.timers_clear(sim, p)


def release(sim: Sim, spec, resource, p) -> Sim:
    """Release a binary resource inline from a block (parity:
    cmb_resource_release): it never blocks, so it takes no chain
    iteration.  ``cmd.release`` is the command form."""
    if _trace.is_symbolic(sim):
        return _trace.engine_call(sim, "release", _id(resource), p)
    return _loop.release_resource(spec, sim, p, _id(resource))


def stop_process(sim: Sim, spec, target) -> Sim:
    """Kill process ``target``: its wait aborted, its timers cancelled,
    its resources and pool units given back, its exit signal STOPPED
    (parity: cmb_process_stop)."""
    if _trace.is_symbolic(sim):
        return _trace.engine_call(sim, "stop_process", target)
    return _loop.stop_process(spec, sim, target)


def spawn(sim: Sim, ptype, at=None, prio=None):
    """``(sim, pid)``: activate one row of a spawn pool, a process type
    declared ``m.process(name, entry, count=N, start=False)``: the
    lowest-pid CREATED or FINISHED row, its state reset, its entry wake
    at ``at`` (default now); pid -1 when all N rows are RUNNING (parity:
    the reference's runtime ``cmb_process_create``/``start``)."""
    if _trace.is_symbolic(sim):
        return _trace.engine_call(sim, "spawn", ptype.first_pid,
                                  ptype.count, ptype.entry_pc, ptype.prio,
                                  at, prio)
    return _loop.spawn_process(sim, ptype, at=at, prio=prio)


def schedule(sim: Sim, t, prio, handler, subj=0, arg=0):
    """``(sim, handle)``: an event at absolute time ``t`` whose dispatch
    calls ``handler`` (registered with ``Model.handler``) as
    ``handler(sim, subj, arg)`` (parity: cmb_event_schedule with an
    arbitrary action).  A full event table gives NULL_HANDLE (-1) and
    fails the replication with ERR_EVENT_OVERFLOW."""
    kind = handler.kind if hasattr(handler, "kind") else handler
    if _trace.is_symbolic(sim):
        return _trace.engine_call(sim, "schedule", t, prio, kind, subj, arg)
    return _loop.schedule(sim, t, prio, kind, subj, arg)


def timer_cancel(sim: Sim, handle, spec=None):
    """``(sim, existed)``: cancel a timer by handle (parity:
    cmb_process_timer_cancel).  With the model's ``spec`` the processes
    waiting on the handle (``cmd.wait_event``) wake with CANCELLED now,
    without it at the next dispatch."""
    if _trace.is_symbolic(sim):
        return _trace.engine_call(sim, "event_cancel", handle,
                                  spec is not None)
    return _loop.timer_cancel(sim, handle, spec)


def event_cancel(sim: Sim, handle, spec=None):
    """``(sim, existed)``: cancel any scheduled event by handle (parity:
    cmb_event_cancel); its waiters wake with CANCELLED, now with
    ``spec``, else at the next dispatch."""
    return timer_cancel(sim, handle, spec)


def priority_set(sim: Sim, p, new_prio) -> Sim:
    """Change process ``p``'s priority (parity: cmb_process_priority_set):
    its wake and its place among a guard's waiters follow."""
    if _trace.is_symbolic(sim):
        return _trace.engine_call(sim, "priority_set", p, new_prio)
    return _loop.priority_set(sim, p, new_prio)


def event_is_scheduled(sim: Sim, handle):
    """Whether ``handle`` names a live scheduled event (parity:
    cmb_event_is_scheduled: a fired, cancelled or reused slot does not)."""
    if _trace.is_symbolic(sim):
        return _trace.read(sim, "ev_scheduled", None, handle)
    return _ev._valid(sim.events, handle)


def _at_handle(sim: Sim, column, handle, dead):
    """``column`` of the event table at a live handle's slot, ``dead``
    for a dead handle."""
    h = _ev._handles(sim.events, handle)
    (x,) = _ev._at_slots(h, column)
    return torch.where(_ev._valid(sim.events, h), x,
                       torch.as_tensor(dead, dtype=column.dtype,
                                       device=column.device))


def event_time(sim: Sim, handle):
    """The time a live event is scheduled at, ``+inf`` for a dead handle
    (parity: cmb_event_time, the reference's sentinel)."""
    if _trace.is_symbolic(sim):
        return _trace.read(sim, "ev_time", None, handle)
    return _at_handle(sim, sim.events.time, handle, float("inf"))


def event_priority(sim: Sim, handle):
    """The dispatch priority of a live event, 0 for a dead handle
    (parity: cmb_event_priority)."""
    if _trace.is_symbolic(sim):
        return _trace.read(sim, "ev_prio", None, handle)
    return _at_handle(sim, sim.events.prio, handle, 0)


def event_reschedule(sim: Sim, handle, new_t):
    """``(sim, existed)``: move a scheduled event to ``new_t`` keeping its
    FIFO seq (parity: cmb_event_reschedule); a non-finite ``new_t`` moves
    nothing and gives existed false."""
    if _trace.is_symbolic(sim):
        return _trace.engine_call(sim, "event_reschedule", handle, new_t)
    es2, ok = _ev.reschedule(sim.events, handle, new_t)
    return sim._replace(events=es2), ok


def event_reprioritize(sim: Sim, handle, new_prio):
    """``(sim, existed)``: change a scheduled event's priority in place
    (parity: cmb_event_reprioritize)."""
    if _trace.is_symbolic(sim):
        return _trace.engine_call(sim, "event_reprioritize", handle,
                                  new_prio)
    es2, ok = _ev.reprioritize(sim.events, handle, new_prio)
    return sim._replace(events=es2), ok


def _pattern(kind, subj):
    """(kind, subj) of a pattern: None a wildcard, ``kind`` a handler
    registered with ``Model.handler`` or its kind."""
    k = _ev.WILDCARD if kind is None else getattr(kind, "kind", kind)
    return k, _ev.WILDCARD if subj is None else subj


def event_pattern_count(sim: Sim, kind=None, subj=None):
    """The scheduled events matching (kind, subj) (parity:
    cmb_event_pattern_count)."""
    k, sj = _pattern(kind, subj)
    if _trace.is_symbolic(sim):
        return _trace.read(sim, "ev_pcount", None, k, sj)
    return _ev.pattern_count(sim.events, k, sj)


def event_pattern_find(sim: Sim, kind=None, subj=None):
    """Handle of the soonest scheduled event matching (kind, subj), -1
    where none does (parity: cmb_event_pattern_find)."""
    k, sj = _pattern(kind, subj)
    if _trace.is_symbolic(sim):
        return _trace.read(sim, "ev_pfind", None, k, sj)
    return _ev.pattern_find(sim.events, k, sj)


def event_pattern_cancel(sim: Sim, kind=None, subj=None):
    """``(sim, n)``: cancel every scheduled event matching (kind, subj)
    (parity: cmb_event_pattern_cancel)."""
    k, sj = _pattern(kind, subj)
    if _trace.is_symbolic(sim):
        return _trace.engine_call(sim, "event_pattern_cancel", k, sj)
    es2, n = _ev.pattern_cancel(sim.events, k, sj)
    return sim._replace(events=es2), n
