"""The spawn shop (torch restatement of ``examples/spawn_shop.py``): one
process per customer, the reference's runtime ``cmb_process_create`` /
``cmb_process_start`` style.

A door process spawns a shopper process per arrival from a pool of 16
rows declared ``start=False``; shoppers contend for one clerk (a binary
resource), pay and leave, and a finished row is recycled by a later
spawn.  ``count`` bounds the shoppers in the shop at once, not the
arrivals: an arrival that finds every row RUNNING is counted as a miss.
The lane stops (``api.stop``) once ``N_SERVED`` shoppers are served.

The blocks, draws, constants and dtypes are the reference's, line for
line; the blocks act on every replication lane at once.  :func:`main`
checks the example's own gates.
"""

from __future__ import annotations

import torch

import cimba_tpu_torch.random as cr
from cimba_tpu_torch.core import api
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model

N_SERVED = 200
N_SHOPPERS = 16
SEED = 42


def build():
    m = Model("spawn_shop", n_flocals=1, event_cap=16)
    clerk = m.resource("clerk", record=False)

    @m.user_state
    def init(params):
        return {
            "served": torch.tensor(0, dtype=torch.int32),
            "missed": torch.tensor(0, dtype=torch.int32),
            "sum_wait": torch.tensor(0.0, dtype=torch.float64),
        }

    @m.block
    def door(sim, p, sig):
        sim, pid = api.spawn(sim, shoppers)  # -1 if all rows are live
        u = sim.user
        sim = api.set_user(
            sim, {**u, "missed": u["missed"] + (pid < 0).to(torch.int32)})
        sim, t = api.draw(sim, cr.exponential, 1.0)
        done = sim.user["served"] >= N_SERVED
        return sim, cmd.select(done, cmd.exit_(),
                               cmd.hold(t, next_pc=door.pc))

    @m.block
    def shop(sim, p, sig):
        sim = api.set_local_f(sim, p, 0, api.clock(sim))  # birth time
        return sim, cmd.acquire(clerk.id, next_pc=pay.pc)

    @m.block
    def pay(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, 0.6)
        return sim, cmd.hold(t, next_pc=leave.pc)

    @m.block
    def leave(sim, p, sig):
        u = sim.user
        wait = api.clock(sim) - api.local_f(sim, p, 0)
        sim = api.set_user(sim, {
            **u,
            "served": u["served"] + 1,
            "sum_wait": u["sum_wait"] + wait,
        })
        sim = api.stop(sim, sim.user["served"] >= N_SERVED)
        return sim, cmd.release(clerk.id, next_pc=gone.pc)

    @m.block
    def gone(sim, p, sig):
        return sim, cmd.exit_()

    m.process("door", entry=door)
    shoppers = m.process("shopper", entry=shop, count=N_SHOPPERS,
                         start=False)
    return m.build()


def params():
    """The shop takes no parameters."""
    return None


def run(R: int, device="cuda", seed: int = SEED):
    """``R`` replications to the end (each lane stops once N_SERVED
    shoppers are served) through ``runner.experiment.run_experiment``
    (the card unless ``device="cpu"``)."""
    from cimba_tpu_torch.runner import experiment

    return experiment.run_experiment(build(), params(), R, seed=seed,
                                     device=device)


def mean_wait(sims) -> torch.Tensor:
    """Each lane's mean time in the shop of its served shoppers."""
    return sims.user["sum_wait"] / sims.user["served"].clamp(min=1)


def check_gates(sims) -> None:
    """The example's gates: no failed lane, at least N_SERVED shoppers
    served in every lane."""
    assert int((sims.err != 0).sum()) == 0, "replications failed"
    assert bool((sims.user["served"] >= N_SERVED).all()), "too few served"


def main(R: int = 1, device="cuda"):
    sims = run(R, device=device).sims
    check_gates(sims)
    served = int(sims.user["served"][0])
    missed = int(sims.user["missed"][0])
    wait = float(mean_wait(sims)[0])
    print(f"served {served} shoppers (pool misses: {missed}), mean time in "
          f"shop {wait:.2f}")
    return served, missed, wait


if __name__ == "__main__":
    main()
