"""Job-shop network: a two-stage flow line with a buffer between the
stages, a crew pool both stages share, and a maintenance process gated
by a condition (torch port of :mod:`cimba_tpu.models.jobshop`, same
blocks, same draws, same commands).

    source --[stage A: crew + machine time]--> WIP buffer
           --[stage B (x2): crew + machine time]--> done

The condition "WIP backlog >= threshold" observes the buffer, so every
transfer into or out of it signals the condition without the model
calling ``api.cond_signal``; maintenance then holds one crew member for
a while.  The cycles ride the fused verbs (``pool_acquire_hold``,
``buffer_put_hold``) and the releases are inline (``api.pool_release``),
as in the reference.

Statistics per replication: ``done``, the completion times of stage B;
``maintenance_runs``; and the engine's time-weighted records of the crew
in use and the buffer's level.  The CUDA chunk kernel
(``csrc/queue_chunk.cu``) has one instance for it.
"""

from __future__ import annotations

import torch

import cimba_tpu_torch.random as cr
from cimba_tpu_torch import config
from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import api
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.stats import summary as sm


def build(wip_cap: float = 20.0, crew_size: float = 3.0,
          backlog: float = 8.0, b_slow: float = 5.0):
    """Construct the job shop; returns (spec, refs dict).  ``b_slow``
    scales stage B's work against stage A's, so that WIP accumulates.
    ``backlog`` and ``b_slow`` are recorded in ``spec.constants``."""
    # event_cap=1: every wake rides the dense per-process table
    m = Model("jobshop", n_ilocals=1, event_cap=1, guard_cap=8)
    wip = m.buffer("wip", capacity=wip_cap, initial=0.0)
    crew = m.resourcepool("crew", capacity=crew_size)
    cv = m.condition(
        "backlog",
        lambda sim, p: sim.buffers.level[:, wip.id] >= backlog,
        observes=[wip],
    )
    m.constants.update(backlog=backlog, b_slow=b_slow)

    @m.user_state
    def user_init(params):
        arr_mean, work_mean, n_jobs = params
        real = config.real()
        return {
            "arr_mean": arr_mean.to(real),
            "work_mean": work_mean.to(real),
            "n_jobs": n_jobs.to(INDEX),
            "done": sm.empty(arr_mean.shape, arr_mean.device, real),
            "maintenance_runs": torch.zeros(arr_mean.shape, dtype=INDEX,
                                            device=arr_mean.device),
        }

    # --- stage A: one WIP unit per job ------------------------------------
    @m.block
    def a_start(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, sim.user["arr_mean"])
        return sim, cmd.hold(t, next_pc=a_entry.pc)

    @m.block
    def a_entry(sim, p, sig):
        sim, tw = api.draw(sim, cr.exponential, sim.user["work_mean"])
        return sim, cmd.pool_acquire_hold(crew.id, 1.0, tw,
                                          next_pc=a_store.pc)

    @m.block
    def a_store(sim, p, sig):
        sim = api.add_local_i(sim, p, 0, 1)
        sim = api.pool_release(sim, spec_box["spec"], crew, p, 1.0)
        finished = api.local_i(sim, p, 0) >= sim.user["n_jobs"]
        sim, ta = api.draw(sim, cr.exponential, sim.user["arr_mean"])
        return sim, cmd.select(
            finished,
            cmd.buffer_put(wip.id, 1.0, next_pc=a_exit.pc),
            cmd.buffer_put_hold(wip.id, 1.0, ta, next_pc=a_entry.pc),
        )

    @m.block
    def a_exit(sim, p, sig):
        return sim, cmd.exit_()

    # --- stage B: consume WIP ---------------------------------------------
    @m.block
    def b_take(sim, p, sig):
        return sim, cmd.buffer_get(wip.id, 1.0, next_pc=b_svc.pc)

    @m.block
    def b_svc(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential,
                          sim.user["work_mean"] * b_slow)
        return sim, cmd.pool_acquire_hold(crew.id, 1.0, t, next_pc=b_fin.pc)

    @m.block
    def b_fin(sim, p, sig):
        done = sm.add(sim.user["done"], api.clock(sim))
        sim = api.set_user(sim, {**sim.user, "done": done})
        sim = api.stop(sim, done.n >= sim.user["n_jobs"].to(done.n.dtype))
        sim = api.pool_release(sim, spec_box["spec"], crew, p, 1.0)
        return sim, cmd.buffer_get(wip.id, 1.0, next_pc=b_svc.pc)

    # --- maintenance: condition-gated -------------------------------------
    @m.block
    def mt_wait(sim, p, sig):
        return sim, cmd.cond_wait(cv.id, next_pc=mt_act.pc)

    @m.block
    def mt_act(sim, p, sig):
        sim = api.set_user(sim, {
            **sim.user,
            "maintenance_runs": sim.user["maintenance_runs"] + 1,
        })
        # a crew member for a while (slows the shop down)
        return sim, cmd.pool_acquire_hold(crew.id, 1.0, 2.0,
                                          next_pc=mt_rel.pc)

    @m.block
    def mt_rel(sim, p, sig):
        sim = api.pool_release(sim, spec_box["spec"], crew, p, 1.0)
        return sim, cmd.cond_wait(cv.id, next_pc=mt_act.pc)

    m.process("stageA", entry=a_start)
    m.process("stageB", entry=b_take, count=2)
    m.process("maintenance", entry=mt_wait)

    spec_box = {}
    spec = m.build()
    spec_box["spec"] = spec
    return spec, {"wip": wip, "crew": crew, "cond": cv}


def params(n_jobs: int, arr_mean: float = 1.0, work_mean: float = 0.4):
    return (arr_mean, work_mean, n_jobs)


def summary_path(sims):
    """The model's pooled statistic: the per-replication completion-time
    summary (the job shop records no ``wait``)."""
    return sims.user["done"]


#: names of the blocks above, in pc order: the CUDA chunk kernel
#: (csrc/queue_chunk.cu) hard-codes this model and checks a spec against
#: it
BLOCK_NAMES = ("a_start", "a_entry", "a_store", "a_exit", "b_take", "b_svc",
               "b_fin", "mt_wait", "mt_act", "mt_rel")
