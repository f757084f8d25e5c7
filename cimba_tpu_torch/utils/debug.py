"""Host-side state dumps for debugging models (torch port of
:mod:`cimba_tpu.utils.debug`).

Parity: ``cmb_event_queue_print``, ``cmi_hashheap_print`` and the
golden-file event dumps.  These render one replication's Sim: take lane
``r`` of a lane-first Sim with :func:`lane` first, as the reference's
callers take ``jax.tree.map(lambda x: x[r], sims)``.
"""

from __future__ import annotations

import numpy as np

from cimba_tpu_torch.core import process as pr

_KIND_NAMES = {0: "PROC", 1: "TIMER"}
_STATUS = {0: "CREATED", 1: "RUNNING", 2: "FINISHED"}


def lane(sims, r: int):
    """Lane ``r`` of a lane-first Sim: every leaf indexed by ``r``."""
    from cimba_tpu_torch import tree

    return tree.map(lambda x: x[r], sims)


def _np(x):
    return np.asarray(x.detach().cpu()) if hasattr(x, "detach") else \
        np.asarray(x)


def kind_name(kind: int, spec=None) -> str:
    """Dispatch-kind label: framework kinds by name, user kinds by their
    handler's ``__name__`` when a spec is given (the one name table the
    dumps and the Chrome-trace exporter render with)."""
    if kind in _KIND_NAMES:
        return _KIND_NAMES[kind]
    if spec is not None:
        u = kind - 2
        if 0 <= u < len(spec.user_handlers):
            return getattr(spec.user_handlers[u], "__name__", f"user{kind}")
    return f"user{kind}"


def subj_name(subj: int, kind: int, spec=None) -> str:
    """Event-subject label: the process name for process and timer kinds,
    the raw id otherwise (user kinds address any subject)."""
    if spec is not None and kind <= 1 and 0 <= subj < len(spec.proc_names):
        return spec.proc_names[subj]
    return str(subj)


def eventset_str(sim, spec=None) -> str:
    """Pending events in firing order (parity: cmb_event_queue_print)."""
    es = sim.events
    t = _np(es.time)
    prio, seq, kind, subj, arg = (_np(x) for x in (
        es.prio, es.seq, es.kind, es.subj, es.arg))
    live = np.isfinite(t)
    rows = []
    order = sorted(np.nonzero(live)[0],
                   key=lambda i: (t[i], -int(prio[i]), int(seq[i])))
    for i in order:
        k = int(kind[i])
        kname = _KIND_NAMES.get(k, f"user{k}")
        s = int(subj[i])
        name = (spec.proc_names[s]
                if spec and k <= 1 and s < len(spec.proc_names) else str(s))
        rows.append(
            f"  t={t[i]:<14.6f} prio={int(prio[i]):<4d} "
            f"seq={int(seq[i]):<6d} {kname:<6s} subj={name} "
            f"arg={int(arg[i])}")
    head = (f"event set: {len(rows)} pending, "
            f"next_seq={int(_np(es.next_seq))}")
    return "\n".join([head] + rows)


def procs_str(sim, spec=None) -> str:
    """Process table (parity: the per-process state the logger prints)."""
    ps = sim.procs
    pc, status, prio, pend, guard, await_pid = (_np(x) for x in (
        ps.pc, ps.status, ps.prio, ps.pend_tag, ps.pend_guard,
        ps.await_pid))
    rows = ["pid name            status    pc   prio pend  guard await"]
    for p in range(pc.shape[0]):
        name = spec.proc_names[p] if spec else f"p{p}"
        tag = int(pend[p])
        rows.append(
            f"{p:<3d} {name:<15s} {_STATUS.get(int(status[p]), '?'):<9s} "
            f"{int(pc[p]):<4d} {int(prio[p]):<4d} "
            f"{tag if tag != int(pr.NO_PEND) else '-':<5} "
            f"{int(guard[p]):<5d} {int(await_pid[p])}")
    return "\n".join(rows)


def trace_str(sim, spec=None) -> str:
    """The flight recorder's ring in dispatch order, in the format of
    :func:`eventset_str`; a one-line notice where the Sim carries no ring
    (the recorder was off at ``init_sim``)."""
    ring = getattr(sim, "trace", None)
    if ring is None:
        return "flight recorder: disabled"
    from cimba_tpu_torch.obs import trace as _trace

    r = _trace.unwrap(ring)
    rows = []
    for t, pid, kind, arg, seq in zip(r["t"], r["pid"], r["kind"], r["arg"],
                                      r["seq"]):
        kind = int(kind)
        rows.append(
            f"  t={float(t):<14.6f} seq={int(seq):<6d} "
            f"{kind_name(kind, spec):<6s} "
            f"subj={subj_name(int(pid), kind, spec)} arg={int(arg)}")
    head = (f"flight recorder: {len(rows)} recorded of "
            f"{r['count']} dispatched (cap {r['capacity']})")
    return "\n".join([head] + rows)


def sim_str(sim, spec=None) -> str:
    """One replication's overview (with the flight recorder's ring where
    the Sim carries one)."""
    out = (f"clock={float(sim.clock):.6f} err={int(sim.err)} "
           f"done={bool(sim.done)} events_dispatched={int(sim.n_events)}\n"
           + eventset_str(sim, spec) + "\n" + procs_str(sim, spec))
    if getattr(sim, "trace", None) is not None:
        out += "\n" + trace_str(sim, spec)
    return out
