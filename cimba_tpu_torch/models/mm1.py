"""M/M/1 queue — the flagship model (torch port of
:mod:`cimba_tpu.models.mm1`, same blocks, same draws, same commands).

An arrival process holds exp(arr_mean) and puts its arrival timestamp
into a FIFO with the fused ``put_hold``; a service process takes items
with the fused ``get_hold`` and records each sojourn.  A replication
ends after ``n_objects`` served items.  Theory: mean sojourn =
1 / (mu - lambda).

``record=True`` (queue-length recording) is not ported yet, so only
``build(record=False)`` — the benchmark configuration — builds; it is
also the spec the CUDA chunk kernel implements.
"""

from __future__ import annotations

import cimba_tpu_torch.random as cr
from cimba_tpu_torch import config
from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import api
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.stats import summary as sm

#: ilocal 0 of the arrival process: number of objects produced
L_PRODUCED = 0


def build(queue_cap: int = 128, event_cap: int = 1, guard_cap: int = 4,
          record: bool = True):
    """Construct the M/M/1 model; returns (spec, refs dict)."""
    m = Model("mm1", n_ilocals=1, event_cap=event_cap, guard_cap=guard_cap)
    q = m.objectqueue("buffer", capacity=queue_cap, record=record)

    @m.user_state
    def user_init(params):
        arr_mean, srv_mean, n_objects = params
        real = config.real()
        return {
            "arr_mean": arr_mean.to(real),
            "srv_mean": srv_mean.to(real),
            "n_objects": n_objects.to(INDEX),
            "wait": sm.empty(arr_mean.shape, arr_mean.device, real),
        }

    @m.block
    def a_start(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, sim.user["arr_mean"])
        return sim, cmd.hold(t, next_pc=a_cycle.pc)

    @m.block
    def a_cycle(sim, p, sig):
        # at each arrival: put the timestamp and hold the next pre-drawn
        # inter-arrival; the last put continues inline to the exit
        sim = api.add_local_i(sim, p, L_PRODUCED, 1)
        produced = api.local_i(sim, p, L_PRODUCED)
        finished = produced >= sim.user["n_objects"]
        sim, t = api.draw(sim, cr.exponential, sim.user["arr_mean"])
        now = api.clock(sim)
        return sim, cmd.select(
            finished,
            cmd.put(q.id, now, next_pc=a_exit.pc),
            cmd.put_hold(q.id, now, t, next_pc=a_cycle.pc),
        )

    @m.block
    def a_exit(sim, p, sig):
        return sim, cmd.exit_()

    @m.block
    def s_start(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, sim.user["srv_mean"])
        return sim, cmd.get_hold(q.id, t, next_pc=s_cycle.pc)

    @m.block
    def s_cycle(sim, p, sig):
        # at each service completion: record the finished item's sojourn
        # (got = its arrival timestamp), then get the next item with a
        # pre-drawn service time
        t_sys = api.clock(sim) - api.got(sim, p)
        wait = sm.add(sim.user["wait"], t_sys)
        sim = api.set_user(sim, {**sim.user, "wait": wait})
        sim = api.stop(sim, wait.n >= sim.user["n_objects"].to(wait.n.dtype))
        sim, t = api.draw(sim, cr.exponential, sim.user["srv_mean"])
        return sim, cmd.get_hold(q.id, t, next_pc=s_cycle.pc)

    m.process("arrival", entry=a_start, prio=0)
    m.process("service", entry=s_start, prio=0)
    return m.build(), {"queue": q}


def params(n_objects: int, arr_rate: float = 0.9, srv_rate: float = 1.0):
    """Per-replication parameter tuple (the reference's constants)."""
    return (1.0 / arr_rate, 1.0 / srv_rate, n_objects)


#: names of the blocks above, in pc order — the CUDA chunk kernel
#: (csrc/mm1_chunk.cu) hard-codes this cycle and checks a spec against it
BLOCK_NAMES = ("a_start", "a_cycle", "a_exit", "s_start", "s_cycle")
