"""Block-author helpers (torch port of :mod:`cimba_tpu.core.api`, the
calls mm1's blocks make).  ``p`` is the ``[L]`` pid tensor a block
receives; every helper acts on all replication lanes at once."""

from __future__ import annotations

import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import ix
from cimba_tpu_torch.core.loop import Sim


def clock(sim: Sim):
    """Current simulation time (parity: ``cmb_time``)."""
    return sim.clock


def draw(sim: Sim, dist, *params):
    """Draw from a distribution, threading each lane's RNG stream:
    ``sim, x = api.draw(sim, random.exponential, mean)``.  The sample
    takes the Sim's own dtype profile."""
    prof = "f32" if sim.clock.dtype == torch.float32 else "f64"
    with config.profile(prof):
        rng, x = dist(sim.rng, *params)
    return sim._replace(rng=rng), x


def got(sim: Sim, p):
    """Result register: the item produced by this process's last GET."""
    return ix.get(sim.procs.got, p)


def local_i(sim: Sim, p, k: int):
    return ix.get(sim.procs.locals_i[:, :, k], p)


def add_local_i(sim: Sim, p, k: int, dv=1) -> Sim:
    li = sim.procs.locals_i
    col = ix.add(li[:, :, k], p, torch.as_tensor(dv, dtype=INDEX))
    return sim._replace(procs=sim.procs._replace(
        locals_i=torch.cat([li[:, :, :k], col[:, :, None], li[:, :, k + 1:]],
                           dim=2)))


def set_user(sim: Sim, new_user) -> Sim:
    return sim._replace(user=new_user)


def stop(sim: Sim, pred=True) -> Sim:
    """End the replication after the current event."""
    return sim._replace(done=sim.done | pred)
