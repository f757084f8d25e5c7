"""Resource guards: dense derived wait queues (torch port).

Counterpart of :mod:`cimba_tpu.core.guard`.  A process waits on at most
one guard; membership is ``procs.pend_guard == gid`` and the order is
(live ``procs.prio`` DESC, ``procs.pend_seq`` ASC, lowest pid), so the
only state a guard owns is its FIFO sequence counter.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import ix

NO_PID = -1
_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


class Guards(NamedTuple):
    next_seq: torch.Tensor  # [L, NG] i32


def create(n_guards: int, lanes: int, device) -> Guards:
    return Guards(next_seq=torch.zeros((lanes, n_guards), dtype=INDEX,
                                       device=device))


def alloc_seq(g: Guards, gid, seq_override=None, pred=True):
    """FIFO sequence for a process entering guard ``gid``; returns
    ``(g2, seq)``.  ``seq_override >= 0`` re-enters with a kept sequence
    (a woken waiter whose retry failed keeps its place); the counter
    bumps only when the fresh sequence was taken."""
    fresh = ix.get(g.next_seq, gid)
    if seq_override is None:
        seq = fresh
    else:
        seq = torch.where(seq_override >= 0, seq_override, fresh)
    bump = seq == fresh
    if pred is not True:
        bump = bump & pred
    return g._replace(next_seq=ix.add(g.next_seq, gid, 1, bump)), seq


def best_waiter(wait_gid, wait_seq, prio, gid):
    """Best waiter of guard ``gid`` per lane: returns ``(pid, found)``,
    pid = -1 where the guard has no waiter."""
    gid = torch.as_tensor(gid, dtype=INDEX, device=wait_gid.device)
    live = wait_gid == gid.reshape(-1, 1)
    p_max = torch.where(live, prio, _I32_MIN).amax(dim=1)
    m = live & (prio == p_max[:, None])
    s_min = torch.where(m, wait_seq, _I32_MAX).amin(dim=1)
    m2 = m & (wait_seq == s_min[:, None])
    found = live.any(dim=1)
    pid = torch.where(found, ix.first_true(m2), NO_PID)
    return pid.to(INDEX), found


def is_empty(wait_gid, gid):
    gid = torch.as_tensor(gid, dtype=INDEX, device=wait_gid.device)
    return ~(wait_gid == gid.reshape(-1, 1)).any(dim=1)
