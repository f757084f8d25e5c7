"""Processes as state machines: commands and process rows (torch port).

Counterpart of :mod:`cimba_tpu.core.process`.  Signal codes, statuses and
command tags keep the reference's values (the CUDA kernel and the state
carried across by :mod:`cimba_tpu_torch.interop` rely on them).  A
command's fields are tensors over the replication lanes or plain Python
numbers; the engine broadcasts them.  The port implements hold, exit,
jump, the object-queue verbs, the binary resource's acquire, preempt and
release, the resource pool's acquire, preempt (the mug) and release, the
buffer get and put, the priority queue's put and get (each blocking verb
with its fused ``*_hold`` twin), the condition wait and the waits on a
process and on an event.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.config import INDEX

# --- signal protocol (parity: include/cmb_process.h:59-99) ----------------
SUCCESS = 0
PREEMPTED = -1
INTERRUPTED = -2
STOPPED = -3
CANCELLED = -4
TIMEOUT = -5

# --- process status ---------------------------------------------------------
CREATED = 0
RUNNING = 1
FINISHED = 2

# --- command tags (values shared with cimba_tpu.core.process) --------------
C_HOLD = 0
C_EXIT = 1
C_JUMP = 2
C_PUT = 3
C_GET = 4
C_ACQUIRE = 5
C_RELEASE = 6
C_PREEMPT = 7
C_POOL_ACQ = 8
C_POOL_REL = 9
C_BUF_GET = 10
C_BUF_PUT = 11
C_PQ_PUT = 12
C_PQ_GET = 13
C_COND_WAIT = 14
C_WAIT_PROC = 15
C_POOL_PRE = 16
C_WAIT_EVT = 17
C_PUT_HOLD = 18
C_GET_HOLD = 19
C_ACQ_HOLD = 20
C_PRE_HOLD = 21
C_POOL_ACQ_HOLD = 22
C_POOL_PRE_HOLD = 23
C_BUF_GET_HOLD = 24
C_BUF_PUT_HOLD = 25
C_PQ_PUT_HOLD = 26
C_PQ_GET_HOLD = 27
N_COMMANDS = 28

#: no pending command
NO_PEND = -1


class Command(NamedTuple):
    """Uniform command (every block returns one)."""

    tag: object      # i32
    f: object        # REAL payload (duration, item)
    f2: object       # REAL second payload
    f3: object       # REAL fused hold duration (``*_hold`` verbs)
    i: object        # i32 payload (queue id)
    next_pc: object  # i32 block to continue at


#: where set (by core.loop's used-tag inference), every command built
#: registers its tag here (parity: the reference's ``_tag_collector``)
_tag_collector = None


def _cmd(tag, f=0.0, f2=0.0, f3=0.0, i=0, next_pc=0) -> Command:
    if _tag_collector is not None:
        _tag_collector.add(tag)
    return Command(tag, f, f2, f3, i, next_pc)


def hold(duration, next_pc) -> Command:
    """Yield for ``duration`` sim time (parity: cmb_process_hold)."""
    return _cmd(C_HOLD, f=duration, next_pc=next_pc)


def exit_() -> Command:
    """Terminate the process."""
    return _cmd(C_EXIT)


def jump(next_pc) -> Command:
    """Continue at another block without yielding."""
    return _cmd(C_JUMP, next_pc=next_pc)


def put(queue, item, next_pc) -> Command:
    """Blocking put into an object queue."""
    return _cmd(C_PUT, f=item, i=queue, next_pc=next_pc)


def get(queue, next_pc) -> Command:
    """Blocking get; the item lands in the result register (api.got)."""
    return _cmd(C_GET, i=queue, next_pc=next_pc)


def put_hold(queue, item, duration, next_pc) -> Command:
    """Fused ``put; hold(duration)``: one chain iteration per event."""
    return _cmd(C_PUT_HOLD, f=item, f3=duration, i=queue, next_pc=next_pc)


def get_hold(queue, duration, next_pc) -> Command:
    """Fused ``get; hold(duration)``: the M/M/1 service cycle."""
    return _cmd(C_GET_HOLD, f3=duration, i=queue, next_pc=next_pc)


def acquire(resource, next_pc) -> Command:
    """Blocking acquire of a binary resource (parity:
    cmb_resource_acquire)."""
    return _cmd(C_ACQUIRE, i=resource, next_pc=next_pc)


def release(resource, next_pc) -> Command:
    """Release a binary resource; continues without yielding
    (``api.release`` does it inline from a block)."""
    return _cmd(C_RELEASE, i=resource, next_pc=next_pc)


def preempt(resource, next_pc) -> Command:
    """Priority acquire (parity: cmb_resource_preempt): takes the
    resource from a holder of equal or lower priority, which resumes
    with PREEMPTED; waits as an acquire otherwise."""
    return _cmd(C_PREEMPT, i=resource, next_pc=next_pc)


def acquire_hold(resource, duration, next_pc) -> Command:
    """Fused ``acquire; hold(duration)``: the hold starts when the
    resource is granted."""
    return _cmd(C_ACQ_HOLD, f3=duration, i=resource, next_pc=next_pc)


def preempt_hold(resource, duration, next_pc) -> Command:
    """Fused ``preempt; hold(duration)`` (see :func:`preempt`)."""
    return _cmd(C_PRE_HOLD, f3=duration, i=resource, next_pc=next_pc)


def pool_acquire(pool, amount, next_pc) -> Command:
    """Blocking acquire of ``amount`` units of a resource pool (parity:
    cmb_resourcepool_acquire): greedily takes what is available now and
    waits for the rest."""
    return _cmd(C_POOL_ACQ, f=amount, i=pool, next_pc=next_pc)


def pool_acquire_hold(pool, amount, duration, next_pc) -> Command:
    """Fused ``pool_acquire; hold(duration)``: the hold starts when the
    whole claim is granted (the pended claim rides f and f2, the
    duration f3)."""
    return _cmd(C_POOL_ACQ_HOLD, f=amount, f3=duration, i=pool,
                next_pc=next_pc)


def pool_preempt(pool, amount, next_pc) -> Command:
    """Greedy pool acquire that may also mug holders of strictly lower
    priority (parity: cmb_resourcepool_preempt): the lowest priority
    first, the latest grab first among equals; each victim loses its
    whole holding and resumes with PREEMPTED, and what the claim does
    not use goes back to the pool."""
    return _cmd(C_POOL_PRE, f=amount, i=pool, next_pc=next_pc)


def pool_preempt_hold(pool, amount, duration, next_pc) -> Command:
    """Fused ``pool_preempt; hold(duration)`` (see
    :func:`pool_acquire_hold`)."""
    return _cmd(C_POOL_PRE_HOLD, f=amount, f3=duration, i=pool,
                next_pc=next_pc)


def pool_release(pool, amount, next_pc) -> Command:
    """Release units back to a pool (partial release allowed); never
    blocks (``api.pool_release`` does it inline from a block)."""
    return _cmd(C_POOL_REL, f=amount, i=pool, next_pc=next_pc)


def buffer_get(buffer, amount, next_pc) -> Command:
    """Take ``amount`` from a fungible store (parity: cmb_buffer_get)."""
    return _cmd(C_BUF_GET, f=amount, i=buffer, next_pc=next_pc)


def buffer_put(buffer, amount, next_pc) -> Command:
    """Add ``amount`` into a fungible store (parity: cmb_buffer_put)."""
    return _cmd(C_BUF_PUT, f=amount, i=buffer, next_pc=next_pc)


def buffer_get_hold(buffer, amount, duration, next_pc) -> Command:
    """Fused ``buffer_get; hold(duration)``: the hold starts when the
    transfer is complete."""
    return _cmd(C_BUF_GET_HOLD, f=amount, f3=duration, i=buffer,
                next_pc=next_pc)


def buffer_put_hold(buffer, amount, duration, next_pc) -> Command:
    """Fused ``buffer_put; hold(duration)`` (see :func:`buffer_get_hold`)."""
    return _cmd(C_BUF_PUT_HOLD, f=amount, f3=duration, i=buffer,
                next_pc=next_pc)


def pq_put(pqueue, item, prio, next_pc) -> Command:
    """Blocking put with a per-item priority (parity:
    cmb_priorityqueue_put): higher priorities leave first, FIFO among
    equal ones."""
    return _cmd(C_PQ_PUT, f=item, f2=prio, i=pqueue, next_pc=next_pc)


def pq_get(pqueue, next_pc) -> Command:
    """Blocking get of the highest-priority item (parity:
    cmb_priorityqueue_get); the item lands in api.got."""
    return _cmd(C_PQ_GET, i=pqueue, next_pc=next_pc)


def pq_put_hold(pqueue, item, prio, duration, next_pc) -> Command:
    """Fused ``pq_put; hold(duration)`` (the item's priority stays on
    f2)."""
    return _cmd(C_PQ_PUT_HOLD, f=item, f2=prio, f3=duration, i=pqueue,
                next_pc=next_pc)


def pq_get_hold(pqueue, duration, next_pc) -> Command:
    """Fused ``pq_get; hold(duration)``: the item lands in api.got."""
    return _cmd(C_PQ_GET_HOLD, f3=duration, i=pqueue, next_pc=next_pc)


def cond_wait(condition, next_pc) -> Command:
    """Wait until the condition is signalled and its predicate holds
    (parity: cmb_condition_wait; a woken waiter whose predicate no longer
    holds waits again)."""
    return _cmd(C_COND_WAIT, i=condition, next_pc=next_pc)


def wait_process(pid, next_pc) -> Command:
    """Wait for process ``pid`` to finish (parity:
    cmb_process_wait_process): the continuation receives SUCCESS if it
    exited, STOPPED if it was stopped (at once, where it has finished
    already)."""
    return _cmd(C_WAIT_PROC, i=pid, next_pc=next_pc)


def wait_event(handle, next_pc) -> Command:
    """Wait for the scheduled event ``handle`` (parity:
    cmb_process_wait_event): SUCCESS when it is dispatched (waiters wake
    before its action runs), CANCELLED if it is cancelled or the handle
    is already dead, or the signal of an interrupt or timer that ends the
    wait first."""
    return _cmd(C_WAIT_EVT, i=handle, next_pc=next_pc)


_REAL_FIELDS = (1, 2, 3)


def _as_field(v, k, like, device):
    if isinstance(v, torch.Tensor):
        return v
    if k in _REAL_FIELDS:
        dt = like.dtype if isinstance(like, torch.Tensor) else config.real()
    else:
        dt = INDEX
    return torch.tensor(v, dtype=dt, device=device)


def select(pred, a: Command, b: Command) -> Command:
    """Lane-wise ``pred ? a : b``.  Fields that are the same object on
    both sides pass through unselected."""
    out = []
    for k, (x, y) in enumerate(zip(a, b)):
        if x is y:
            out.append(x)
            continue
        xt = _as_field(x, k, y, pred.device)
        yt = _as_field(y, k, xt, pred.device)
        out.append(torch.where(pred, xt, yt))
    return Command(*out)


def normalize(cmd: Command, lanes: int, device, real) -> Command:
    """Every field as a ``[lanes]`` tensor of its dtype."""
    out = []
    for k, v in enumerate(cmd):
        dt = real if k in _REAL_FIELDS else INDEX
        t = torch.as_tensor(v, dtype=dt, device=device)
        out.append(t.expand(lanes) if t.dim() == 0 else t)
    return Command(*out)


class Procs(NamedTuple):
    """All processes of every lane, struct-of-arrays ``[L, P]``."""

    pc: torch.Tensor
    status: torch.Tensor
    prio: torch.Tensor
    pend_tag: torch.Tensor
    pend_f: torch.Tensor
    pend_f2: torch.Tensor
    pend_f3: torch.Tensor
    pend_i: torch.Tensor
    pend_pc: torch.Tensor
    pend_guard: torch.Tensor
    pend_seq: torch.Tensor
    await_pid: torch.Tensor
    await_evt: torch.Tensor
    exit_sig: torch.Tensor
    got: torch.Tensor
    locals_f: torch.Tensor  # [L, P, NF]
    locals_i: torch.Tensor  # [L, P, NI]


def create(entry_pcs, prios, n_flocals: int, n_ilocals: int, lanes: int,
           device, real) -> Procs:
    entry = torch.as_tensor(entry_pcs, dtype=INDEX, device=device)
    p = entry.shape[0]

    def full(v, dt=INDEX):
        return torch.full((lanes, p), v, dtype=dt, device=device)

    return Procs(
        pc=entry.expand(lanes, p).contiguous(),
        status=full(CREATED),
        prio=torch.as_tensor(prios, dtype=INDEX, device=device)
        .expand(lanes, p).contiguous(),
        pend_tag=full(NO_PEND),
        pend_f=full(0.0, real),
        pend_f2=full(0.0, real),
        pend_f3=full(0.0, real),
        pend_i=full(0),
        pend_pc=full(0),
        pend_guard=full(-1),
        pend_seq=full(-1),
        await_pid=full(-1),
        await_evt=full(-1),
        exit_sig=full(SUCCESS),
        got=full(0.0, real),
        locals_f=torch.zeros((lanes, p, max(n_flocals, 1)), dtype=real,
                             device=device),
        locals_i=torch.zeros((lanes, p, max(n_ilocals, 1)), dtype=INDEX,
                             device=device),
    )
