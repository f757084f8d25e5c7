"""The flight recorder: a dispatch-event ring a lane (torch port of
:mod:`cimba_tpu.obs.trace`).

Parity: the reference keeps the last ``capacity`` events the dispatcher
executed, ``(t, pid, kind, arg, seq)`` slots and a monotone ``count``,
as arrays of the Sim; slot ``count % capacity`` is overwritten, so the
ring holds the last ``min(count, capacity)`` dispatches and ``seq`` (the
global dispatch index) tells which.  Here the ring is a Sim leaf like
any other, lane-first (``[L, CAP]`` slots, ``[L]`` count), written at
the dispatch site of ``core.loop``'s step.

:func:`enable` and :func:`disable` switch a module flag read by
``init_sim``: with the recorder off ``Sim.trace`` is ``None`` and
:func:`emit` returns the Sim it was given.

Kernel-path contract (the reference's): the CUDA chunk kernels carry no
ring.  A Sim with one that reaches a kernel build
(``core.kernel_run.kernel_for``) raises there, loudly; the ring runs on
the plain engine, on the card or the CPU (``core.loop.make_run``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cimba_tpu_torch.config import INDEX

#: default ring capacity (events kept a replication)
DEFAULT_CAPACITY = 256

_enabled = False
_capacity = DEFAULT_CAPACITY

#: the refusal a kernel build raises for a Sim carrying a ring
KERNEL_REFUSAL = (
    "obs.trace: flight-recorder emission inside the CUDA chunk kernel "
    "path — the ring's contents are host-export state and hauling them "
    "through the chunk kernel must be a deliberate choice, not a leftover "
    "global flag.  Disable the recorder for kernel runs "
    "(obs.trace.disable(), the logger.flags_off analog) or run this model "
    "on the plain engine (core.loop.make_run on device='cuda').")


class TraceRing(NamedTuple):
    """Each lane's last ``capacity`` dispatched events."""

    t: torch.Tensor      # [L, CAP] TIME — dispatch clock
    pid: torch.Tensor    # [L, CAP] i32 — event subject
    kind: torch.Tensor   # [L, CAP] i32 — dispatch kind
    arg: torch.Tensor    # [L, CAP] i32 — event payload
    seq: torch.Tensor    # [L, CAP] i32 — dispatch index; -1 = never written
    count: torch.Tensor  # [L] i32 — total dispatches recorded


def enable(capacity: int = DEFAULT_CAPACITY) -> None:
    """Enable the recorder for Sims made afterwards (``init_sim``).
    ``capacity`` bounds memory: 5 arrays x capacity a lane."""
    global _enabled, _capacity
    if capacity <= 0:
        raise ValueError(f"trace capacity must be positive, got {capacity}")
    _enabled = True
    _capacity = int(capacity)


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def capacity() -> int:
    return _capacity


def create(lanes: int, device, time_dtype, cap: int | None = None
           ) -> TraceRing:
    """An empty ring of ``lanes`` lanes; ``init_sim`` calls it when the
    recorder is on."""
    cap = _capacity if cap is None else int(cap)

    def z(dt):
        return torch.zeros((lanes, cap), dtype=dt, device=device)

    return TraceRing(
        t=z(time_dtype), pid=z(INDEX), kind=z(INDEX), arg=z(INDEX),
        seq=torch.full((lanes, cap), -1, dtype=INDEX, device=device),
        count=torch.zeros((lanes,), dtype=INDEX, device=device))


def emit(sim, t, pid, kind, arg, pred):
    """Record one dispatched event a lane where ``pred`` (the dispatch's
    event-found predicate).  Returns ``sim`` itself when it carries no
    ring."""
    ring = sim.trace
    if ring is None:
        return sim
    from cimba_tpu_torch.core import ix

    cap = ring.t.shape[1]
    slot = torch.remainder(ring.count, cap)
    return sim._replace(trace=TraceRing(
        t=ix.put(ring.t, slot, t.to(ring.t.dtype), pred),
        pid=ix.put(ring.pid, slot, pid.to(INDEX), pred),
        kind=ix.put(ring.kind, slot, kind.to(INDEX), pred),
        arg=ix.put(ring.arg, slot, arg.to(INDEX), pred),
        seq=ix.put(ring.seq, slot, ring.count, pred),
        count=ring.count + pred.to(INDEX)))


def unwrap(ring: TraceRing):
    """Host-side: one lane's ring (its leaves indexed by the lane, e.g.
    ``utils.debug.lane(sims, r).trace``) as its valid entries in dispatch
    order: numpy arrays ``{t, pid, kind, arg, seq}`` sorted by ``seq``,
    with ``count`` and ``capacity``."""
    import numpy as np

    seq = np.asarray(ring.seq.detach().cpu())
    valid = seq >= 0
    order = np.argsort(seq[valid], kind="stable")
    out = {}
    for name in ("t", "pid", "kind", "arg", "seq"):
        out[name] = np.asarray(getattr(ring, name).detach().cpu()
                               )[valid][order]
    out["count"] = int(ring.count)
    out["capacity"] = int(seq.shape[0])
    return out
