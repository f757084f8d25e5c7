"""M/G/1 queue with lognormal service — the parameter-sweep model (torch
port of :mod:`cimba_tpu.models.mg1`, same blocks, same draws, same
commands).

mm1's fused-verb cycles with a lognormal service time of given mean and
coefficient of variation; the queue records its length, as the
reference's does.  The sweep (BASELINE.json configs[2]) is a params
tree with leading axis R: 4 service CVs x 5 utilisations, each cell's
replications in a contiguous block of lanes (:func:`sweep_params`).
The CUDA chunk kernel (``csrc/queue_chunk.cu``) has one instance for it:
1 server, recording, lognormal service.

Theory (Pollaczek-Khinchine): with utilisation rho = lambda E[S] and
service SCV cs2 = Var[S] / E[S]^2,
Wq = rho E[S] (1 + cs2) / (2 (1 - rho)), W = Wq + E[S].
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

#: ilocal 0 of the arrival process: number of objects produced
L_PRODUCED = 0


def build(queue_cap: int = 512):
    """M/G/1: exponential arrivals, lognormal service of given mean and
    CV; returns (spec, refs).  ``queue_cap`` 512: the sweep's heaviest
    cell (rho = 0.9, CV = 2) queues ~20 on average with a long tail."""
    m = Model("mg1", n_ilocals=1, event_cap=1, guard_cap=4)
    q = m.objectqueue("buffer", capacity=queue_cap)

    @m.user_state
    def user_init(params):
        arr_mean, srv_mean, srv_cv, n_objects = params
        real = config.real()
        # lognormal parameters from the mean m_s and the CV
        cv = srv_cv.to(real)
        sigma2 = torch.log1p(cv * cv)
        mu = torch.log(srv_mean.to(real)) - 0.5 * sigma2
        return {
            "arr_mean": arr_mean.to(real),
            "ln_mu": mu,
            "ln_sigma": torch.sqrt(sigma2),
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
        sim, t = api.draw(sim, cr.lognormal, sim.user["ln_mu"],
                          sim.user["ln_sigma"])
        return sim, cmd.get_hold(q.id, t, next_pc=s_cycle.pc)

    @m.block
    def s_cycle(sim, p, sig):
        t_sys = api.clock(sim) - api.got(sim, p)
        wait = sm.add(sim.user["wait"], t_sys)
        sim = api.set_user(sim, {**sim.user, "wait": wait})
        sim = api.stop(sim, wait.n >= sim.user["n_objects"].to(wait.n.dtype))
        sim, t = api.draw(sim, cr.lognormal, sim.user["ln_mu"],
                          sim.user["ln_sigma"])
        return sim, cmd.get_hold(q.id, t, next_pc=s_cycle.pc)

    m.process("arrival", entry=a_start)
    m.process("service", entry=s_start)
    return m.build(), {"queue": q}


def sweep_grid(n_objects: int, cvs=(0.25, 0.5, 1.0, 2.0),
               utilizations=(0.5, 0.6, 0.7, 0.8, 0.9),
               srv_mean: float = 1.0) -> SweepGrid:
    """The reference's 4x5 cell table: axes over service CV and
    utilisation, each cell's row ``(arr_mean, srv_mean, srv_cv,
    n_objects)`` as ``build``'s ``user_init`` unpacks it."""

    def row(cv, rho):
        return (np.float64(srv_mean / rho),  # lambda = rho / E[S]
                np.float64(srv_mean), np.float64(cv), np.int32(n_objects))

    return SweepGrid({"cv": cvs, "rho": utilizations}, row, name="mg1")


def sweep_params(n_objects: int, cvs=(0.25, 0.5, 1.0, 2.0),
                 utilizations=(0.5, 0.6, 0.7, 0.8, 0.9),
                 reps_per_cell: int = 10, srv_mean: float = 1.0):
    """The experiment array, one row per replication: (params tuple of
    [R] tensors, cells) where ``cells[i] = (cv, rho)`` of replication i."""
    grid = sweep_grid(n_objects, cvs=cvs, utilizations=utilizations,
                      srv_mean=srv_mean)
    params, _ = grid.rows(reps_per_cell)
    cells = [(c["cv"], c["rho"]) for c in grid.cells()
             for _ in range(reps_per_cell)]
    return params, cells


def pk_sojourn(rho: float, cv: float, srv_mean: float = 1.0) -> float:
    """Pollaczek-Khinchine mean sojourn time."""
    wq = rho * srv_mean * (1.0 + cv * cv) / (2.0 * (1.0 - rho))
    return wq + srv_mean


#: names of the blocks above, in pc order (mm1's): the CUDA chunk kernel
#: (csrc/queue_chunk.cu) hard-codes this cycle and checks a spec against it
BLOCK_NAMES = ("a_start", "a_cycle", "a_exit", "s_start", "s_cycle")
