"""Block-author helpers (torch port of :mod:`cimba_tpu.core.api`, the
calls the ported models' blocks make).  ``p`` is the ``[L]`` pid tensor a block
receives; every helper acts on all replication lanes at once."""

from __future__ import annotations

import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import ix
from cimba_tpu_torch.core import loop as _loop
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


def set_user(sim: Sim, new_user) -> Sim:
    return sim._replace(user=new_user)


def stop(sim: Sim, pred=True) -> Sim:
    """End the replication after the current event."""
    return sim._replace(done=sim.done | pred)


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


def pool_release(sim: Sim, spec, pool, p, amount) -> Sim:
    """Release pool units inline from a block (partial release allowed;
    parity: cmb_resourcepool_release): it never blocks, so it takes no
    chain iteration.  ``cmd.pool_release`` is the command form."""
    return _loop.release_pool(spec, sim, p, _id(pool), amount)


def cond_signal(sim: Sim, spec, condition) -> Sim:
    """Signal a condition: wake every waiter whose predicate holds
    (parity: cmb_condition_signal)."""
    return _loop.cond_signal(spec, sim, _id(condition))
