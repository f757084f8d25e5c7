"""Two-station tandem Jackson network with probabilistic feedback (torch
port of :mod:`cimba_tpu.models.tandem`, same blocks, same draws, same
commands).

    arrivals --> [q1 -> server 1] --> [q2 -> server 2] --> depart
                       ^                                |
                       +----------- p_back -------------+

External Poisson arrivals (rate lambda) join station 1; service at
station i is exponential (rate mu_i); a customer finishing station 2
routes back to station 1 with probability ``p_back``, else departs.
Both queues record their length (the ``objectqueue`` default).

Theory (Jackson): every station sees ``lambda_i = lambda / (1 -
p_back)`` and is an M/M/1 marginal, so the mean sojourn per visit is
``W_i = 1 / (mu_i - lambda_i)`` and the mean time in the network
``(W_1 + W_2) / (1 - p_back)``.

Statistics per replication: ``w1`` / ``w2``, the per-visit sojourn at
each station; ``wait``, both stations' per-visit sojourns in one summary.
The CUDA chunk kernel (``csrc/queue_chunk.cu``) has one instance for it:
three processes, two recording queues.
"""

from __future__ import annotations

import numpy as np
import torch

import cimba_tpu_torch.random as cr
from cimba_tpu_torch import config
from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import api
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.stats import summary as sm
from cimba_tpu_torch.sweep import SweepGrid

#: ilocal 0 of the arrival process: external customers produced;
#: ilocal 0 of server 2: customers departed the network
L_COUNT = 0


def build(queue_cap: int = 256):
    """Construct the tandem network; returns (spec, refs dict).
    ``queue_cap`` serves both stations."""
    m = Model("tandem", n_ilocals=1, event_cap=1, guard_cap=4)
    q1 = m.objectqueue("station1", capacity=queue_cap)
    q2 = m.objectqueue("station2", capacity=queue_cap)

    @m.user_state
    def user_init(params):
        arr_mean, s1_mean, s2_mean, p_back, n_objects = params
        real = config.real()

        def empty():
            return sm.empty(arr_mean.shape, arr_mean.device, real)

        return {
            "arr_mean": arr_mean.to(real),
            "s1_mean": s1_mean.to(real),
            "s2_mean": s2_mean.to(real),
            "p_back": p_back.to(real),
            "n_objects": n_objects.to(INDEX),
            "wait": empty(),   # combined per-visit sojourn
            "w1": empty(),     # station-1 per-visit sojourn
            "w2": empty(),     # station-2 per-visit sojourn
        }

    # --- external arrivals (the mm1 fused put_hold cycle) ------------------
    @m.block
    def a_start(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, sim.user["arr_mean"])
        return sim, cmd.hold(t, next_pc=a_cycle.pc)

    @m.block
    def a_cycle(sim, p, sig):
        sim = api.add_local_i(sim, p, L_COUNT, 1)
        produced = api.local_i(sim, p, L_COUNT)
        finished = produced >= sim.user["n_objects"]
        sim, t = api.draw(sim, cr.exponential, sim.user["arr_mean"])
        now = api.clock(sim)
        return sim, cmd.select(
            finished,
            cmd.put(q1.id, now, next_pc=a_exit.pc),
            cmd.put_hold(q1.id, now, t, next_pc=a_cycle.pc),
        )

    @m.block
    def a_exit(sim, p, sig):
        return sim, cmd.exit_()

    # --- station 1: record w1, forward to station 2 ------------------------
    @m.block
    def s1_start(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, sim.user["s1_mean"])
        return sim, cmd.get_hold(q1.id, t, next_pc=s1_cycle.pc)

    @m.block
    def s1_cycle(sim, p, sig):
        # got = the item's q1-entry timestamp: per-visit station sojourn
        w = api.clock(sim) - api.got(sim, p)
        sim = api.set_user(sim, {
            **sim.user,
            "wait": sm.add(sim.user["wait"], w),
            "w1": sm.add(sim.user["w1"], w),
        })
        # forward with the q2-entry timestamp, then take the next q1 item
        now = api.clock(sim)
        return sim, cmd.put(q2.id, now, next_pc=s1_take.pc)

    @m.block
    def s1_take(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, sim.user["s1_mean"])
        return sim, cmd.get_hold(q1.id, t, next_pc=s1_cycle.pc)

    # --- station 2: record w2, route (feedback or depart) ------------------
    @m.block
    def s2_start(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, sim.user["s2_mean"])
        return sim, cmd.get_hold(q2.id, t, next_pc=s2_cycle.pc)

    @m.block
    def s2_cycle(sim, p, sig):
        w = api.clock(sim) - api.got(sim, p)
        sim = api.set_user(sim, {
            **sim.user,
            "wait": sm.add(sim.user["wait"], w),
            "w2": sm.add(sim.user["w2"], w),
        })
        sim, u = api.draw(sim, cr.uniform01)
        feedback = u < sim.user["p_back"]
        # departures count in server 2's ilocal; the replication stops
        # when every external customer has left the network
        sim = api.add_local_i(
            sim, p, L_COUNT,
            torch.where(feedback, 0, 1).to(INDEX))
        departed = api.local_i(sim, p, L_COUNT)
        sim = api.stop(sim, departed >= sim.user["n_objects"])
        now = api.clock(sim)
        return sim, cmd.select(
            feedback,
            cmd.put(q1.id, now, next_pc=s2_take.pc),
            cmd.jump(next_pc=s2_take.pc),
        )

    @m.block
    def s2_take(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, sim.user["s2_mean"])
        return sim, cmd.get_hold(q2.id, t, next_pc=s2_cycle.pc)

    m.process("arrival", entry=a_start)
    m.process("server1", entry=s1_start)
    m.process("server2", entry=s2_start)
    return m.build(), {"q1": q1, "q2": q2}


def params(n_objects: int, arr_rate: float = 0.5, s1_rate: float = 1.0,
           s2_rate: float = 1.25, p_back: float = 0.25):
    """Per-replication parameter tuple (the reference's defaults)."""
    return (1.0 / arr_rate, 1.0 / s1_rate, 1.0 / s2_rate, p_back, n_objects)


def internal_rate(arr_rate: float, p_back: float) -> float:
    """Jackson's traffic equation: both stations see
    ``lambda / (1 - p_back)``."""
    if not 0.0 <= p_back < 1.0:
        raise ValueError(f"p_back must be in [0, 1), got {p_back}")
    return arr_rate / (1.0 - p_back)


def visit_sojourn(arr_rate: float, srv_rate: float, p_back: float) -> float:
    """Mean per-visit sojourn at one station, ``1 / (mu - lambda_i)``."""
    lam = internal_rate(arr_rate, p_back)
    if lam >= srv_rate:
        raise ValueError(
            f"unstable station: lambda_i={lam:.4f} >= mu={srv_rate}")
    return 1.0 / (srv_rate - lam)


def mean_visit_sojourn(arr_rate: float, s1_rate: float, s2_rate: float,
                       p_back: float) -> float:
    """What the combined ``wait`` summary converges to, ``(W_1 + W_2) /
    2`` (both stations record at the same visit rate)."""
    return 0.5 * (visit_sojourn(arr_rate, s1_rate, p_back)
                  + visit_sojourn(arr_rate, s2_rate, p_back))


def network_sojourn(arr_rate: float, s1_rate: float, s2_rate: float,
                    p_back: float) -> float:
    """Mean total time in the network per external customer,
    ``(W_1 + W_2) / (1 - p_back)``."""
    return (visit_sojourn(arr_rate, s1_rate, p_back)
            + visit_sojourn(arr_rate, s2_rate, p_back)) / (1.0 - p_back)


def sweep_grid(n_objects: int, arr_rates=(0.4, 0.5, 0.6),
               p_backs=(0.1, 0.25), s1_rate: float = 1.0,
               s2_rate: float = 1.25) -> SweepGrid:
    """The network as a sweep grid over the external arrival rate and the
    feedback probability; every cell is checked stable here."""
    for a in arr_rates:
        for p in p_backs:
            visit_sojourn(a, s1_rate, p)   # raises if unstable
            visit_sojourn(a, s2_rate, p)

    def row(arr_rate, p_back):
        return (np.float64(1.0 / arr_rate), np.float64(1.0 / s1_rate),
                np.float64(1.0 / s2_rate), np.float64(p_back),
                np.int32(n_objects))

    return SweepGrid({"arr_rate": arr_rates, "p_back": p_backs}, row,
                     name="tandem")


#: names of the blocks above, in pc order: the CUDA chunk kernel
#: (csrc/queue_chunk.cu) hard-codes this network and checks a spec
#: against it
BLOCK_NAMES = ("a_start", "a_cycle", "a_exit", "s1_start", "s1_cycle",
               "s1_take", "s2_start", "s2_cycle", "s2_take")
