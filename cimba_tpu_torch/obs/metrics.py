"""The metrics registry: named counters, gauges and histograms as Sim
leaves (torch port of :mod:`cimba_tpu.obs.metrics`).

Parity: the dispatcher's health signals, carried as arrays of the Sim
and pooled like the model's statistics.  A registry a lane (leaves
``[L, ...]``, fixed per spec, sized at ``init_sim``):

* ``dispatch_by_kind`` [NK] — events dispatched by kind (process, timer,
  user handlers); their sum is the lane's ``n_events``;
* ``guard_retries`` — pended commands tried again on a SUCCESS wake;
* ``queue_hwm`` [NQ] — each object queue's length high-water mark;
* ``event_hwm`` — the event set's occupancy high-water mark (general
  table and armed wakes), how close the lane came to an overflow;
* ``chain_hist`` [CHAIN_BINS] — blocks chained a resume (bin i = i + 1
  blocks, the last bin longer chains).

The hooks sit where the reference's do: :func:`on_dispatch` at the
dispatch, :func:`on_resume` after a resume's chain and
:func:`on_queue_len` in the object-queue verb.  With the registry off
``Sim.metrics`` is ``None`` and every hook returns its Sim.

Kernel-path contract (the reference's): the CUDA chunk kernels carry no
registry; a Sim with one that reaches a kernel build raises there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.config import INDEX

#: chain-length histogram bins: lengths 1..CHAIN_BINS-1, last bin = longer
CHAIN_BINS = 8

_enabled = False

#: the refusal a kernel build raises for a Sim carrying a registry
KERNEL_REFUSAL = (
    "obs.metrics: metrics registry updates inside the CUDA chunk kernel "
    "path — carrying the registry through the chunk kernel must be a "
    "deliberate choice, not a leftover global flag.  Disable metrics for "
    "kernel runs (obs.metrics.disable()) or run on the plain engine "
    "(core.loop.make_run on device='cuda').")


class Metrics(NamedTuple):
    """Each lane's registry (a pooled one has the same fields, no lane
    axis)."""

    dispatch_by_kind: torch.Tensor  # [L, NK] COUNT
    guard_retries: torch.Tensor     # [L] COUNT
    queue_hwm: torch.Tensor         # [L, NQ] i32
    event_hwm: torch.Tensor         # [L] i32
    chain_hist: torch.Tensor        # [L, CHAIN_BINS] COUNT


def enable() -> None:
    """Enable the registry for Sims made afterwards (``init_sim``)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def create(n_kinds: int, n_queues: int, shape=(), device="cuda",
           count=None) -> Metrics:
    """A zeroed registry of batch ``shape`` (``(L,)`` for ``init_sim``'s
    lanes, ``()`` for a pooled accumulator) on ``device`` (the card
    unless the caller asks for the CPU), counters in the profile's COUNT
    dtype (or ``count``)."""
    c = config.count() if count is None else count
    shape = tuple(shape)
    device = config.resolve_device(device)

    def z(tail, dt):
        return torch.zeros(shape + tail, dtype=dt, device=device)

    return Metrics(
        dispatch_by_kind=z((max(n_kinds, 1),), c), guard_retries=z((), c),
        queue_hwm=z((max(n_queues, 1),), INDEX), event_hwm=z((), INDEX),
        chain_hist=z((CHAIN_BINS,), c))


# --- update hooks (called from core/loop.py; no-ops when disabled) -------


def on_dispatch(sim, kind, occupancy, pred):
    """A dispatched event a lane: count its kind, ratchet the event set's
    occupancy high-water mark (``occupancy``: the general table's live
    slots and the armed wakes, before the pop)."""
    m = sim.metrics
    if m is None:
        return sim
    from cimba_tpu_torch.core import ix

    nk = m.dispatch_by_kind.shape[1]
    k = kind.to(INDEX).clamp(0, nk - 1)
    occ = torch.where(pred, occupancy.to(INDEX), m.event_hwm)
    return sim._replace(metrics=m._replace(
        dispatch_by_kind=ix.add(m.dispatch_by_kind, k, 1, pred),
        event_hwm=torch.maximum(m.event_hwm, occ)))


def on_resume(sim, n_chain, retried):
    """A resume a lane: the chain-length histogram and the guard-retry
    counter.  ``n_chain`` is the chain's iteration count (0 where the
    resume was gated off, which is not counted)."""
    m = sim.metrics
    if m is None:
        return sim
    from cimba_tpu_torch.core import ix

    n = n_chain.to(INDEX)
    ran = n > 0
    bin_ = (n - 1).clamp(0, CHAIN_BINS - 1)
    return sim._replace(metrics=m._replace(
        chain_hist=ix.add(m.chain_hist, bin_, 1, ran),
        guard_retries=m.guard_retries + (retried & ran).to(
            m.guard_retries.dtype)))


def on_queue_len(sim, qid, length, pred):
    """A queue verb a lane: ratchet the queue's high-water mark where
    ``pred`` (the verb's ok)."""
    m = sim.metrics
    if m is None:
        return sim
    from cimba_tpu_torch.core import ix

    length = length.to(INDEX)
    cur = ix.get(m.queue_hwm, qid)
    return sim._replace(metrics=m._replace(
        queue_hwm=ix.put(m.queue_hwm, qid, torch.maximum(cur, length),
                         pred)))


# --- pooling ---------------------------------------------------------------


def events_dispatched(m: Metrics):
    """Total events across kinds (a lane's ``n_events``, or their sum
    after pooling)."""
    return m.dispatch_by_kind.sum(dim=-1)


def pool(m: Metrics) -> Metrics:
    """Pool a lane-first registry into one: counters and histogram bins
    sum (associative and commutative: the order does not matter) and the
    high-water gauges take the max."""
    return Metrics(
        dispatch_by_kind=m.dispatch_by_kind.sum(dim=0, dtype=(
            m.dispatch_by_kind.dtype)),
        guard_retries=m.guard_retries.sum(dim=0,
                                          dtype=m.guard_retries.dtype),
        queue_hwm=m.queue_hwm.amax(dim=0),
        event_hwm=m.event_hwm.amax(dim=0),
        chain_hist=m.chain_hist.sum(dim=0, dtype=m.chain_hist.dtype))


def merge(a: Metrics, b: Metrics) -> Metrics:
    """Merge two pooled registries: counters and bins add, gauges max —
    the algebra of :func:`pool`, so folding waves one at a time equals
    pooling all lanes at once (the stream runner's wave fold)."""
    return Metrics(
        dispatch_by_kind=a.dispatch_by_kind + b.dispatch_by_kind,
        guard_retries=a.guard_retries + b.guard_retries,
        queue_hwm=torch.maximum(a.queue_hwm, b.queue_hwm),
        event_hwm=torch.maximum(a.event_hwm, b.event_hwm),
        chain_hist=a.chain_hist + b.chain_hist)


def pool_across(shards, axis_name: str = "rep") -> Metrics:
    """Pool the shards' lane-pooled registries across the mesh's
    ``axis_name`` (parity: the reference's ``psum``/``pmax`` leg inside
    ``shard_map``): each moved to the first shard's device, counters and
    histogram bins summed, the high-water gauges maxed, in shard order
    (``runner.experiment.make_sharded_experiment``)."""
    shards = list(shards)
    if not shards:
        raise ValueError(f"pool_across({axis_name!r}): no shards to pool")
    dev = shards[0].dispatch_by_kind.device
    out = Metrics(*[x.to(dev) for x in shards[0]])
    for m in shards[1:]:
        out = merge(out, Metrics(*[x.to(dev) for x in m]))
    return out


def snapshot(m: Metrics, spec=None, regrows: Optional[int] = None) -> dict:
    """Host-side: a pooled registry as a JSON-able dict, names resolved
    from the spec where one is given (the kind and queue name tables
    ``utils.debug`` renders with)."""
    import numpy as np

    from cimba_tpu_torch.utils.debug import kind_name

    by_kind = np.asarray(m.dispatch_by_kind.detach().cpu())
    dispatch = {}
    for k in range(by_kind.shape[0]):
        name = kind_name(k, spec)
        if name in dispatch:  # duplicate handler names must not collide
            name = f"{name}#{k}"
        dispatch[name] = int(by_kind[k])
    q_names = [q.name for q in spec.queues] if spec and spec.queues else None
    hwm = np.asarray(m.queue_hwm.detach().cpu())
    queue_hwm = {
        (q_names[i] if q_names and i < len(q_names) else f"q{i}"): int(hwm[i])
        for i in range(hwm.shape[0])}
    out = {
        "events_dispatched": int(by_kind.sum()),
        "dispatch_by_kind": dispatch,
        "guard_retries": int(m.guard_retries),
        "queue_hwm": queue_hwm,
        "event_hwm": int(m.event_hwm),
        "chain_hist": [int(c) for c in np.asarray(m.chain_hist.cpu())],
    }
    if regrows is not None:
        out["regrows"] = int(regrows)
    return out
