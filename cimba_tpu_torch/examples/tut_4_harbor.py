"""Tutorial 4, the LNG harbor (torch restatement of
``examples/tut_4_harbor.py``): a tide process drives the water depth, a
harbormaster condition gates docking on depth, tugs and berths, and
ships grab tugs (a pool) and a berth (a pool), unload, and leave through
the same tug dance.

The blocks, draws, constants and dtypes are the reference's, line for
line (``depth`` and ``phase`` are float64 in both profiles); the blocks
act on every replication lane at once, so the predicates read the
waiter's draft with ``api.local_f``.  ``params()`` is empty, as the
reference's harbor takes none.
"""

from __future__ import annotations

import math

import torch

import cimba_tpu_torch.random as cr
from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import api
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.stats import summary as sm

N_SHIPS = 6
N_TUGS = 3.0
N_BERTHS = 2.0
TUGS_NEEDED = 2.0
T_END = 500.0

L_DRAFT = 0    # flocal: this ship's draft
L_ARRIVED = 1  # flocal: arrival time


def build():
    m = Model("harbor", n_flocals=2, event_cap=64, guard_cap=32)
    tugs = m.resourcepool("tugs", capacity=N_TUGS, record=False)
    berths = m.resourcepool("berths", capacity=N_BERTHS, record=False)

    # is_ready_to_dock: deep enough water for MY draft, enough idle tugs,
    # a free berth
    def ready_to_dock(sim, pid):
        return (
            (sim.user["depth"] > api.local_f(sim, pid, L_DRAFT))
            & (api.pool_level(sim, tugs) >= TUGS_NEEDED)
            & (api.pool_level(sim, berths) >= 1.0)
        )

    # departures need depth and tugs, the berth is already ours
    def ready_to_sail(sim, pid):
        return (
            (sim.user["depth"] > api.local_f(sim, pid, L_DRAFT))
            & (api.pool_level(sim, tugs) >= TUGS_NEEDED)
        )

    harbormaster = m.condition(
        "harbormaster", ready_to_dock, observes=[tugs, berths]
    )
    davyjones = m.condition("davyjones", ready_to_sail, observes=[tugs])
    spec_box = []

    @m.user_state
    def init(params):
        # one lane's values: init_sim broadcasts them over the lanes
        return {
            "depth": torch.tensor(12.0, dtype=torch.float64),
            "phase": torch.zeros((), dtype=torch.float64),
            "time_in_system": sm.empty((), "cpu"),
            "sailed": torch.zeros((), dtype=INDEX),
        }

    # ---- the tide (weather_proc + tide_proc folded together) ---------
    @m.block
    def tide(sim, p, sig):
        phase = sim.user["phase"] + 2.0 * math.pi / 12.42  # M2 tide, hourly
        sim, gust = api.draw(sim, cr.normal, 0.0, 0.3)
        depth = 12.0 + 2.5 * torch.sin(phase) + gust
        sim = api.set_user(
            sim, {**sim.user, "depth": depth, "phase": phase}
        )
        sim = api.cond_signal(sim, spec_box[0], harbormaster)
        sim = api.cond_signal(sim, spec_box[0], davyjones)
        return sim, cmd.hold(1.0, next_pc=tide.pc)

    # ---- a ship's life -----------------------------------------------
    @m.block
    def arrive(sim, p, sig):
        sim, stagger = api.draw(sim, cr.exponential, 10.0)
        return sim, cmd.hold(stagger, next_pc=at_anchor.pc)

    @m.block
    def at_anchor(sim, p, sig):
        sim, draft = api.draw(sim, cr.uniform, 9.5, 11.5)
        sim = api.set_local_f(sim, p, L_DRAFT, draft)
        sim = api.set_local_f(sim, p, L_ARRIVED, api.clock(sim))
        return sim, cmd.cond_wait(harbormaster.id, next_pc=cleared.pc)

    @m.block
    def cleared(sim, p, sig):
        return sim, cmd.pool_acquire(tugs.id, TUGS_NEEDED,
                                     next_pc=take_berth.pc)

    @m.block
    def take_berth(sim, p, sig):
        return sim, cmd.pool_acquire(berths.id, 1.0, next_pc=dock.pc)

    @m.block
    def dock(sim, p, sig):
        sim, dt = api.draw(sim, cr.triangular, 0.5, 1.0, 2.0)
        return sim, cmd.hold(dt, next_pc=release_tugs.pc)

    @m.block
    def release_tugs(sim, p, sig):
        return sim, cmd.pool_release(tugs.id, TUGS_NEEDED,
                                     next_pc=unload.pc)

    @m.block
    def unload(sim, p, sig):
        sim, dt = api.draw(sim, cr.lognormal, 2.0, 0.25)
        return sim, cmd.hold(dt, next_pc=want_out.pc)

    @m.block
    def want_out(sim, p, sig):
        return sim, cmd.cond_wait(davyjones.id, next_pc=tug_out.pc)

    @m.block
    def tug_out(sim, p, sig):
        return sim, cmd.pool_acquire(tugs.id, TUGS_NEEDED,
                                     next_pc=undock.pc)

    @m.block
    def undock(sim, p, sig):
        sim = api.set_user(
            sim,
            {
                **sim.user,
                "time_in_system": sm.add(
                    sim.user["time_in_system"],
                    api.clock(sim) - api.local_f(sim, p, L_ARRIVED),
                ),
                "sailed": sim.user["sailed"] + 1,
            },
        )
        sim, dt = api.draw(sim, cr.triangular, 0.5, 1.0, 2.0)
        return sim, cmd.hold(dt, next_pc=sail.pc)

    @m.block
    def sail(sim, p, sig):
        # leaving: berth + tugs go back; each release's guard signal
        # forwards into the observing conditions on its own
        return sim, cmd.pool_release(berths.id, 1.0, next_pc=free_tugs.pc)

    @m.block
    def free_tugs(sim, p, sig):
        return sim, cmd.pool_release(tugs.id, TUGS_NEEDED, next_pc=gone.pc)

    @m.block
    def gone(sim, p, sig):
        return sim, cmd.exit_()

    m.process("tide", entry=tide, prio=10)
    m.process("ship", entry=arrive, prio=0, count=N_SHIPS)
    spec = m.build()
    spec_box.append(spec)
    return spec


def params():
    """The harbor takes no parameters."""
    return None


def summary_path(sims):
    """The pooled statistic: each departed ship's time in port."""
    return sims.user["time_in_system"]
