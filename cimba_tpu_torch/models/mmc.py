"""M/M/c queue — c parallel servers fed by one FIFO (torch port of
:mod:`cimba_tpu.models.mmc`, same blocks, same draws, same commands).

The c servers are ``count=c`` instances of one service process type
sharing the arrival queue; the blocks are mm1's.  The queue records its
length (``Sim.queues.acc``), as the reference's does.  The CUDA chunk
kernel (``csrc/queue_chunk.cu``) has recording instances for c in 1..4.

Theory: Erlang-C.  With a = lambda/mu and rho = a/c,
P_wait = ErlangC(c, a), mean wait in queue Wq = P_wait / (c*mu - lambda),
mean sojourn W = Wq + 1/mu.
"""

from __future__ import annotations

import math

import cimba_tpu_torch.random as cr
from cimba_tpu_torch import config
from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import api
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.stats import summary as sm

#: ilocal 0 of the arrival process: number of objects produced
L_PRODUCED = 0


def build(c: int, queue_cap: int = 128):
    """M/M/c with ``c`` server-process instances; returns (spec, refs)."""
    m = Model("mmc", n_ilocals=1, event_cap=8 + 2 * c,
              guard_cap=max(4, c + 2))
    q = m.objectqueue("buffer", capacity=queue_cap)

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
        t_sys = api.clock(sim) - api.got(sim, p)
        wait = sm.add(sim.user["wait"], t_sys)
        sim = api.set_user(sim, {**sim.user, "wait": wait})
        sim = api.stop(sim, wait.n >= sim.user["n_objects"].to(wait.n.dtype))
        sim, t = api.draw(sim, cr.exponential, sim.user["srv_mean"])
        return sim, cmd.get_hold(q.id, t, next_pc=s_cycle.pc)

    m.process("arrival", entry=a_start, prio=0)
    m.process("server", entry=s_start, prio=0, count=c)
    return m.build(), {"queue": q}


def params(n_objects: int, arr_rate: float, srv_rate: float):
    """Per-replication parameter tuple (the reference's)."""
    return (1.0 / arr_rate, 1.0 / srv_rate, n_objects)


def erlang_c_sojourn(c: int, arr_rate: float, srv_rate: float) -> float:
    """Closed-form mean sojourn time for M/M/c (Erlang-C)."""
    a = arr_rate / srv_rate
    rho = a / c
    if rho >= 1.0:
        raise ValueError(f"unstable M/M/c: rho = {rho} >= 1")
    inv_b = sum(a**k / math.factorial(k) for k in range(c))
    last = a**c / (math.factorial(c) * (1.0 - rho))
    p_wait = last / (inv_b + last)
    wq = p_wait / (c * srv_rate - arr_rate)
    return wq + 1.0 / srv_rate


#: names of the blocks above, in pc order (mm1's): the CUDA chunk kernel
#: (csrc/queue_chunk.cu) hard-codes this cycle and checks a spec against it
BLOCK_NAMES = ("a_start", "a_cycle", "a_exit", "s_start", "s_cycle")
