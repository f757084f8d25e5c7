"""Tutorial 2, the cheese park (torch restatement of
``examples/tut_2_park.py``, itself the reference's ``tutorial/tut_2_1.c``).

Five mice and two rats fight over a pool of 20 units of cheese.  A mouse
draws how much it wants (``dice(1, 3)``), acquires it politely, holds,
and drops one unit at a time; a rat takes its share with a
``pool_preempt`` that mugs holders of lower priority (each victim loses
its whole holding and resumes with PREEMPTED).  Every animal keeps its
belief of what it holds and reconciles it with every signal it gets.  A
god process schedules the end event, a user handler that stops every
animal at ``T_END``; the stops give the cheese back, so the event set
drains and every lane ends.

The blocks, draws, constants and dtypes are the reference's, line for
line; the blocks act on every replication lane at once.  :func:`main`
checks the tutorial's own gates.
"""

from __future__ import annotations

import torch

import cimba_tpu_torch.random as cr
from cimba_tpu_torch.core import api
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core import process as pr
from cimba_tpu_torch.core.model import Model

N_MICE = 5
N_RATS = 2
CHEESE = 20.0
T_END = 50.0
SEED = 7

L_HELD = 0        # flocal: how much cheese this animal believes it holds
LI_PREEMPTED = 0  # ilocal: times this animal was mugged


def build():
    """``(spec, cheese)``: the park and its cheese pool."""
    m = Model("park", n_flocals=1, n_ilocals=1, event_cap=64, guard_cap=16)
    cheese = m.resourcepool("cheese", capacity=CHEESE, record=False)
    spec_box = []

    # ---- the end-of-game event stops everyone (end_sim_evt) ----------
    @m.handler
    def end_sim(sim, subj, arg):
        for pid in range(N_MICE + N_RATS):
            sim = api.stop_process(sim, spec_box[0], pid)
        return sim

    def want_amount(sim, p):
        sim, u = api.draw(sim, cr.dice, 1, 3)
        return sim, u.to(torch.float64)

    # ---- mice: polite acquires ---------------------------------------
    @m.block
    def mouse_acquire(sim, p, sig):
        sim, amt = want_amount(sim, p)
        sim = api.set_local_f(sim, p, L_HELD,
                              api.local_f(sim, p, L_HELD) + amt)
        return sim, cmd.pool_acquire(cheese.id, amt, next_pc=mouse_hold.pc)

    @m.block
    def mouse_hold(sim, p, sig):
        # reconcile belief with what the signal says actually happened
        mugged = sig == pr.PREEMPTED
        sim = api.set_local_f(
            sim, p, L_HELD,
            torch.where(mugged, 0.0, api.local_f(sim, p, L_HELD)),
        )
        sim = api.add_local_i(sim, p, LI_PREEMPTED,
                              torch.where(mugged, 1, 0))
        sim, dt = api.draw(sim, cr.exponential, 1.0)
        return sim, cmd.hold(dt, next_pc=mouse_drop.pc)

    @m.block
    def mouse_drop(sim, p, sig):
        mugged = sig == pr.PREEMPTED
        held = torch.where(mugged, 0.0, api.local_f(sim, p, L_HELD))
        sim = api.add_local_i(sim, p, LI_PREEMPTED,
                              torch.where(mugged, 1, 0))
        give = torch.clamp(held, max=1.0)  # drop one unit if it has any
        sim = api.set_local_f(sim, p, L_HELD, held - give)
        return sim, cmd.pool_release(cheese.id, give,
                                     next_pc=mouse_acquire.pc)

    # ---- rats: preempting acquires (muggers) -------------------------
    @m.block
    def rat_grab(sim, p, sig):
        sim, amt = want_amount(sim, p)
        sim = api.set_local_f(sim, p, L_HELD,
                              api.local_f(sim, p, L_HELD) + amt)
        return sim, cmd.pool_preempt(cheese.id, amt, next_pc=rat_hold.pc)

    @m.block
    def rat_hold(sim, p, sig):
        mugged = sig == pr.PREEMPTED  # a higher-priority rat can mug a rat
        sim = api.set_local_f(
            sim, p, L_HELD,
            torch.where(mugged, 0.0, api.local_f(sim, p, L_HELD)),
        )
        sim = api.add_local_i(sim, p, LI_PREEMPTED,
                              torch.where(mugged, 1, 0))
        sim, dt = api.draw(sim, cr.exponential, 2.0)
        return sim, cmd.hold(dt, next_pc=rat_drop.pc)

    @m.block
    def rat_drop(sim, p, sig):
        mugged = sig == pr.PREEMPTED
        held = torch.where(mugged, 0.0, api.local_f(sim, p, L_HELD))
        sim = api.add_local_i(sim, p, LI_PREEMPTED,
                              torch.where(mugged, 1, 0))
        sim = api.set_local_f(sim, p, L_HELD, 0.0)
        return sim, cmd.pool_release(cheese.id, held, next_pc=rat_grab.pc)

    # ---- a starter process schedules the end event -------------------
    @m.block
    def god_start(sim, p, sig):
        sim, _h = api.schedule(sim, T_END, 10, end_sim)
        return sim, cmd.exit_()

    m.process("mouse", entry=mouse_acquire, prio=0, count=N_MICE)
    m.process("rat", entry=rat_grab, prio=5, count=N_RATS)
    m.process("god", entry=god_start, prio=10)
    spec = m.build()
    spec_box.append(spec)
    return spec, cheese


def params():
    """The tutorial takes no parameters."""
    return None


def run(R: int, device="cuda", seed: int = SEED):
    """``R`` replications to the end (the end event stops every animal,
    so the event set drains) through ``runner.experiment.run_experiment``
    (the card unless ``device="cpu"``)."""
    from cimba_tpu_torch.runner import experiment

    return experiment.run_experiment(build()[0], params(), R, seed=seed,
                                     device=device)


def muggings(sims) -> torch.Tensor:
    """Each lane's preemptions survived: the animals' LI_PREEMPTED."""
    return sims.procs.locals_i[:, :N_MICE + N_RATS, LI_PREEMPTED].sum(dim=1)


def check_gates(sims) -> int:
    """The tutorial's gates: no failed lane; every animal's holding 0
    and the pool back at CHEESE after the stops; some mugging.  Returns
    the muggings of all lanes."""
    assert int((sims.err != 0).sum()) == 0, "replications failed"
    assert float(sims.pools.held.abs().max()) == 0.0
    assert float((sims.pools.level - CHEESE).abs().max()) < 1e-9
    n = int(muggings(sims).sum())
    assert n > 0, "rats never mugged anyone: the preempt path untested"
    return n


def main(R: int = 16, device="cuda"):
    sims = run(R, device=device).sims
    n = check_gates(sims)
    print(f"{R} replications x {T_END:.0f}h in the park")
    print(f"preemptions survived (belief reconciled): {n}")
    return n


if __name__ == "__main__":
    main()
