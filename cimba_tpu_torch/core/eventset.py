"""The future-event set, flat table only (torch port).

Counterpart of :mod:`cimba_tpu.core.eventset` without the hierarchical
``BlockMin`` minima (``blk`` is always ``None``, as it is in the
reference for every capacity below two blocks).  Two tables:

* the general table (``EventSet``, ``[L, CAP]``): timers and user events;
* the dense wakes (``Wakes``, ``[L, P]``): at most one pending resume per
  process, priority read live from ``procs.prio``.

Both order events by (time asc, prio DESC, seq asc) with the lowest
index winning a tie, and both draw seqs from ``EventSet.next_seq``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import ix

NEVER = float("inf")
NULL_HANDLE = -1
_GEN_SHIFT = 16
_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


class EventSet(NamedTuple):
    time: torch.Tensor      # [L, CAP] TIME, +inf = free
    prio: torch.Tensor      # [L, CAP] i32
    seq: torch.Tensor       # [L, CAP] i32
    kind: torch.Tensor      # [L, CAP] i32
    subj: torch.Tensor      # [L, CAP] i32
    arg: torch.Tensor       # [L, CAP] i32
    gen: torch.Tensor       # [L, CAP] i32 slot generation
    next_seq: torch.Tensor  # [L] i32
    overflow: torch.Tensor  # [L] bool
    blk: Any = None         # hierarchical minima: not ported


class Event(NamedTuple):
    time: torch.Tensor
    prio: torch.Tensor
    kind: torch.Tensor
    subj: torch.Tensor
    arg: torch.Tensor
    found: torch.Tensor
    handle: torch.Tensor


class Wakes(NamedTuple):
    time: torch.Tensor  # [L, P] TIME
    sig: torch.Tensor   # [L, P] i32
    seq: torch.Tensor   # [L, P] i32


def create(capacity: int, lanes: int, device, time_dtype) -> EventSet:
    if capacity > 1 << _GEN_SHIFT:
        raise ValueError(f"event capacity {capacity} exceeds {1 << _GEN_SHIFT}")

    def z():
        return torch.zeros((lanes, capacity), dtype=INDEX, device=device)

    return EventSet(
        time=torch.full((lanes, capacity), NEVER, dtype=time_dtype,
                        device=device),
        prio=z(), seq=z(), kind=z(), subj=z(), arg=z(), gen=z(),
        next_seq=torch.zeros((lanes,), dtype=INDEX, device=device),
        overflow=torch.zeros((lanes,), dtype=torch.bool, device=device),
    )


def schedule(es: EventSet, t, prio, kind, subj, arg):
    """Insert an event into the first free slot; returns (es, handle).
    A non-finite time or a full table sets ``overflow`` and returns
    NULL_HANDLE (the caller fails the replication)."""
    lanes = es.time.shape[0]
    t = torch.as_tensor(t, dtype=es.time.dtype, device=es.time.device)
    free = torch.isinf(es.time)
    slot = ix.first_true(free)
    ok = free.any(dim=1) & torch.isfinite(t).expand(lanes)
    s = slot.clamp(max=es.time.shape[1] - 1)
    gen_at = ix.get(es.gen, s)
    es2 = es._replace(
        time=ix.put(es.time, s, t, ok),
        prio=ix.put(es.prio, s, prio, ok),
        seq=ix.put(es.seq, s, es.next_seq, ok),
        kind=ix.put(es.kind, s, kind, ok),
        subj=ix.put(es.subj, s, subj, ok),
        arg=ix.put(es.arg, s, arg, ok),
        next_seq=es.next_seq + ok.to(INDEX),
        overflow=es.overflow | ~ok,
    )
    handle = torch.where(ok, (gen_at << _GEN_SHIFT) | s, NULL_HANDLE)
    return es2, handle.to(INDEX)


def _slot_of(handle):
    return handle & ((1 << _GEN_SHIFT) - 1)


def _at_slots(handles, *columns):
    """Each ``[L, CAP]`` column at the slot each handle names
    (``handles`` ``[L]`` or ``[L, k]``); a slot past the table reads 0,
    as the reference's one-hot pick of no slot does."""
    cap = columns[0].shape[1]
    flat = handles.dim() == 1
    slot = _slot_of(handles.clamp(min=0))
    slot = slot.reshape(-1, 1) if flat else slot
    inr = slot < cap
    sc = slot.clamp(max=cap - 1).to(torch.int64)
    out = [torch.where(inr, c.gather(1, sc),
                       torch.zeros((), dtype=c.dtype, device=c.device))
           for c in columns]
    return [x.squeeze(1) for x in out] if flat else out


def _handles(es: EventSet, handle):
    h = torch.as_tensor(handle, dtype=INDEX, device=es.time.device)
    return h.expand(es.time.shape[0]) if h.dim() == 0 else h


def _valid(es: EventSet, handle):
    """Whether each lane's handle (``[L]``, or ``[L, k]`` handles a lane:
    the reference's ``_valid_vec``) names a live event: its slot holds a
    finite time and the slot's generation is the handle's (a fired,
    cancelled or reused slot names nothing)."""
    h = _handles(es, handle)
    t_at, g_at = _at_slots(h, es.time, es.gen)
    return (h >= 0) & torch.isfinite(t_at) & (g_at == (h >> _GEN_SHIFT))


def _handle_mask(es: EventSet, handle):
    """(``[L, CAP]`` mask of the slot a live handle names, ok): the slot
    each handle-addressed op writes."""
    h = _handles(es, handle)
    ok = _valid(es, h)
    ramp = torch.arange(es.time.shape[1], device=h.device)
    m = (ramp[None, :] == _slot_of(h.clamp(min=0))[:, None]) & ok[:, None]
    return m, ok


def cancel(es: EventSet, handle):
    """Remove an event by handle; returns (es, existed): a handle whose
    slot is free or whose generation has moved on names nothing."""
    m, ok = _handle_mask(es, handle)
    es2 = es._replace(
        time=torch.where(m, NEVER, es.time),
        gen=es.gen + m.to(INDEX),
    )
    return es2, ok


def reschedule(es: EventSet, handle, new_t):
    """Move an event to ``new_t`` keeping its FIFO seq (parity:
    cmb_event_reschedule); returns (es, existed), existed false and
    nothing moved for a non-finite ``new_t``."""
    m, ok = _handle_mask(es, handle)
    t = torch.as_tensor(new_t, dtype=es.time.dtype, device=es.time.device)
    t = t.expand(es.time.shape[0]) if t.dim() == 0 else t
    fin = torch.isfinite(t)
    es2 = es._replace(time=torch.where(m & fin[:, None], t[:, None],
                                       es.time))
    return es2, ok & fin


def reprioritize(es: EventSet, handle, new_prio):
    """Change an event's dispatch priority in place (parity:
    cmb_event_reprioritize); returns (es, existed)."""
    m, ok = _handle_mask(es, handle)
    pr = torch.as_tensor(new_prio, dtype=INDEX, device=es.time.device)
    pr = pr.expand(es.time.shape[0]) if pr.dim() == 0 else pr
    return es._replace(prio=torch.where(m, pr[:, None], es.prio)), ok


#: a pattern's "any kind" / "any subject"
WILDCARD = -1


def _match(es: EventSet, kind, subj):
    """The live events of kind ``kind`` aimed at ``subj`` (either may be
    WILDCARD, or a ``[L]`` tensor), ``[L, CAP]``."""
    live = torch.isfinite(es.time)
    k = torch.as_tensor(kind, dtype=INDEX, device=es.time.device)
    s = torch.as_tensor(subj, dtype=INDEX, device=es.time.device)
    k = k.reshape(-1, 1) if k.dim() else k
    s = s.reshape(-1, 1) if s.dim() else s
    mk = (k == WILDCARD) | (es.kind == k)
    ms = (s == WILDCARD) | (es.subj == s)
    return live & mk & ms


def pattern_cancel(es: EventSet, kind=WILDCARD, subj=WILDCARD, pred=True):
    """Cancel every matching event (parity: cmb_event_pattern_cancel);
    returns (es, n_cancelled).  ``pred`` (``[L]`` bool) gates the
    cancellation; the count is the match count either way."""
    m = _match(es, kind, subj)
    mw = m if pred is True else m & pred.reshape(-1, 1)
    es2 = es._replace(
        time=torch.where(mw, NEVER, es.time),
        gen=es.gen + mw.to(INDEX),
    )
    return es2, m.to(INDEX).sum(dim=1, dtype=INDEX)


def pattern_count(es: EventSet, kind=WILDCARD, subj=WILDCARD):
    """The live events matching (kind, subj) (parity:
    cmb_event_pattern_count)."""
    return _match(es, kind, subj).to(INDEX).sum(dim=1, dtype=INDEX)


def pattern_find(es: EventSet, kind=WILDCARD, subj=WILDCARD):
    """Handle of the soonest matching event, the lowest slot among equal
    times, else NULL_HANDLE (parity: cmb_event_pattern_find)."""
    m = _match(es, kind, subj)
    t = torch.where(m, es.time, NEVER)
    t_min = t.amin(dim=1)
    found = torch.isfinite(t_min)
    slot = ix.first_true(m & (t == t_min[:, None])).clamp(
        max=es.time.shape[1] - 1)
    gen = ix.get(es.gen, slot)
    return torch.where(found, (gen << _GEN_SHIFT) | slot.to(INDEX),
                       NULL_HANDLE).to(INDEX)


def _lexmin(time, prio, seq):
    """Row-wise (time asc, prio desc, seq asc) argnext: (one-hot mask,
    found, t_min, p_max, s_min) with the reference's fold identities for
    an empty row (+inf, int32 min, int32 max)."""
    t_min = time.amin(dim=1)
    found = torch.isfinite(t_min)
    m1 = (time == t_min[:, None]) & found[:, None]
    p_max = torch.where(m1, prio, _I32_MIN).amax(dim=1)
    m2 = m1 & (prio == p_max[:, None])
    s_min = torch.where(m2, seq, _I32_MAX).amin(dim=1)
    m3 = m2 & (seq == s_min[:, None])
    return m3, found, t_min, p_max, s_min


def _pick(mask, arr):
    """Value at the (one-hot) mask; 0 where the row has no hit."""
    return torch.where(mask, arr, torch.zeros((), dtype=arr.dtype,
                                              device=arr.device)).sum(
        dim=1, dtype=arr.dtype)


def wakes_create(n: int, lanes: int, device, time_dtype) -> Wakes:
    return Wakes(
        time=torch.full((lanes, n), NEVER, dtype=time_dtype, device=device),
        sig=torch.zeros((lanes, n), dtype=INDEX, device=device),
        seq=torch.zeros((lanes, n), dtype=INDEX, device=device),
    )


def wake_set(wk: Wakes, p, t, sig, seq, pred=True):
    """Arm process p's resume; returns (wk, ok).  Nothing is written, and
    ok is false, for a non-finite time."""
    t = torch.as_tensor(t, dtype=wk.time.dtype, device=wk.time.device)
    ok = torch.isfinite(t).expand(wk.time.shape[0])
    if pred is not True:
        ok = ok & pred
    return (
        Wakes(
            time=ix.put(wk.time, p, t, ok),
            sig=ix.put(wk.sig, p, sig, ok),
            seq=ix.put(wk.seq, p, seq, ok),
        ),
        ok,
    )


def wake_clear(wk: Wakes, p, pred=True) -> Wakes:
    return wk._replace(time=ix.put(wk.time, p, NEVER, pred))


def is_empty(es: EventSet):
    return ~torch.isfinite(es.time).any(dim=1)


def wakes_empty(wk: Wakes):
    return ~torch.isfinite(wk.time).any(dim=1)


def min_time(es: EventSet):
    return es.time.amin(dim=1)


def peek_merged(es: EventSet, wk: Wakes, prio, wake_kind):
    """Next event across the general table and the dense wakes, not yet
    consumed.  Returns (Event, take_e, take_w): one-hot consume masks for
    :func:`consume_merged`."""
    m_e, found_e, t_e, p_e, s_e = _lexmin(es.time, es.prio, es.seq)
    slot_e = ix.first_true(m_e).clamp(max=es.time.shape[1] - 1)
    kind_e = _pick(m_e, es.kind)
    subj_e = _pick(m_e, es.subj)
    arg_e = _pick(m_e, es.arg)
    gen_e = _pick(m_e, es.gen)
    m_w, found_w, t_w, p_w, s_w = _lexmin(wk.time, prio, wk.seq)
    wake_first = found_w & (
        ~found_e
        | (t_w < t_e)
        | ((t_w == t_e) & ((p_w > p_e) | ((p_w == p_e) & (s_w < s_e))))
    )
    found = found_e | found_w
    pid_w = ix.first_true(m_w).clamp(max=wk.time.shape[1] - 1).to(INDEX)
    event = Event(
        time=torch.where(wake_first, t_w, t_e),
        prio=torch.where(wake_first, p_w, p_e),
        kind=torch.where(wake_first, wake_kind, kind_e),
        subj=torch.where(wake_first, pid_w, subj_e),
        arg=torch.where(wake_first, _pick(m_w, wk.sig), arg_e),
        found=found,
        handle=torch.where(
            found & ~wake_first, (gen_e << _GEN_SHIFT) | slot_e.to(INDEX),
            NULL_HANDLE,
        ).to(INDEX),
    )
    return event, m_e & ~wake_first[:, None], m_w & wake_first[:, None]


def consume_merged(es: EventSet, wk: Wakes, take_e, take_w, pred=True):
    """Remove the peeked event (``pred`` gates the removal)."""
    if pred is not True:
        take_e = take_e & pred[:, None]
        take_w = take_w & pred[:, None]
    es2 = es._replace(
        time=torch.where(take_e, NEVER, es.time),
        gen=es.gen + take_e.to(INDEX),
    )
    wk2 = wk._replace(time=torch.where(take_w, NEVER, wk.time))
    return es2, wk2
