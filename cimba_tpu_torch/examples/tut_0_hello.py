"""Tutorial 0, hello (torch restatement of ``examples/tut_0_hello.py``,
itself the reference's ``tutorial/hello.c``): one greeter that holds one
time unit and greets again until the clock passes 3, counting its
wakeups in a user counter.  The smallest model: one block, one process.
"""

from __future__ import annotations

import torch

from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import api
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model


def build():
    m = Model("hello", event_cap=4, guard_cap=1)

    @m.user_state
    def user_init(params):
        return {"wakeups": torch.zeros((), dtype=INDEX)}

    @m.block
    def greet(sim, p, sig):
        sim = api.set_user(sim, {"wakeups": sim.user["wakeups"] + 1})
        done = sim.clock >= 3.0
        return sim, cmd.select(done, cmd.exit_(),
                               cmd.hold(1.0, next_pc=greet.pc))

    m.process("greeter", entry=greet)
    return m.build()


def params():
    """Hello takes no parameters."""
    return None


def main(R: int = 1, device="cuda"):
    from cimba_tpu_torch.runner import experiment

    sims = experiment.run_experiment(build(), params(), R, seed=1,
                                     device=device).sims
    assert int((sims.err != 0).sum()) == 0
    # wakes at t = 0, 1, 2, 3: four greetings, the exit at clock 3
    assert bool((sims.user["wakeups"] == 4).all()), sims.user["wakeups"]
    assert bool((sims.clock == 3.0).all()), sims.clock
    print(f"hello, simulation: {int(sims.user['wakeups'][0])} wakeups, "
          f"clock {float(sims.clock[0])}")
    return int(sims.user["wakeups"][0])


if __name__ == "__main__":
    main()
