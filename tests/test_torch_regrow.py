"""``run_experiment_regrow`` in the port against the reference's.

The spec is the reference's burst model (``tests/test_regrow.py:21-40``):
one process keeping 12 live timers at ``event_cap=4``, built from the
same code in either package.  At 8 lanes every lane first dies of
``ERR_EVENT_OVERFLOW``; the regrow doubles the cap and runs again until
none does.  ``n_regrows``, the final ``event_cap`` and the Sims must
equal the reference's (integers exact, floats within 1e-9 of each leaf's
scale), and the regrown run equals the run started at the final cap bit
for bit.  A model whose timers grow without bound raises RuntimeError
after ``max_regrows`` doublings.  One reference run is shared across the
file.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch

import cimba_tpu.random as jcr
from cimba_tpu.core import api as japi
from cimba_tpu.core import cmd as jcmd
from cimba_tpu.core.model import Model as JModel
from cimba_tpu.runner import experiment as jex
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.runner import experiment as tex
from cimba_tpu_torch.tools import usergen

torch.set_num_threads(1)

LANES, SEED = 8, 3
JLIB = types.SimpleNamespace(Model=JModel, api=japi, cmd=jcmd, cr=jcr)


def burst_spec(lib, n_timers=12, event_cap=4):
    """One process keeping ``n_timers`` live timers (holds live in the
    dense wake table; timers take general event slots)."""
    m = lib.Model("burst", event_cap=event_cap, guard_cap=2)
    api, cmd, cr = lib.api, lib.cmd, lib.cr

    @m.block
    def work(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, 1.0)
        for k in range(n_timers):
            sim, _ = api.timer_add(sim, p, 10.0 + k, 100 + k)
        sim = api.timers_clear(sim, p)
        done = api.clock(sim) > 3.0
        return sim, cmd.select(done, cmd.exit_(),
                               cmd.hold(t, next_pc=work.pc))

    m.process("w", entry=work)
    return m.build()


@functools.lru_cache(maxsize=None)
def ref_regrow():
    res, final, n = jex.run_experiment_regrow(burst_spec(JLIB), (), LANES,
                                              seed=SEED)
    return ([np.asarray(x) for x in jax.tree.leaves(res.sims)],
            final.event_cap, n)


def test_regrow_matches_reference():
    spec = burst_spec(usergen.torch_lib())
    first = tex.run_experiment(spec, (), LANES, seed=SEED, device="cpu")
    assert int(first.n_failed) == LANES
    assert bool((first.sims.err == tloop.ERR_EVENT_OVERFLOW).all())
    res, final, n = tex.run_experiment_regrow(spec, (), LANES, seed=SEED,
                                              device="cpu")
    ref_leaves, ref_cap, ref_n = ref_regrow()
    assert (n, final.event_cap) == (ref_n, ref_cap)
    assert n >= 1 and final.event_cap > spec.event_cap
    assert int(res.n_failed) == 0 and int(res.total_events) > 0
    assert interop.diff_leaves(ref_leaves, interop.sim_to_numpy(res.sims),
                               1e-9) == []
    direct = tex.run_experiment(final, (), LANES, seed=SEED, device="cpu")
    assert interop.diff_leaves(interop.sim_to_numpy(direct.sims),
                               interop.sim_to_numpy(res.sims), 0.0) == []


def test_regrow_noop_when_capacity_suffices():
    spec = burst_spec(usergen.torch_lib(), n_timers=4, event_cap=16)
    res, final, n = tex.run_experiment_regrow(spec, (), 4, seed=1,
                                              device="cpu")
    assert n == 0 and final is spec and int(res.n_failed) == 0


def runaway_spec(lib):
    """A process that adds one more timer every step and never clears
    them: no capacity suffices."""
    m = lib.Model("runaway", event_cap=2, guard_cap=2)
    api, cmd = lib.api, lib.cmd

    @m.block
    def work(sim, p, sig):
        sim, _ = api.timer_add(sim, p, 1e9, 100)
        return sim, cmd.hold(1.0, next_pc=work.pc)

    m.process("w", entry=work)
    return m.build()


def test_runaway_model_raises():
    spec = runaway_spec(usergen.torch_lib())
    with pytest.raises(RuntimeError, match="overflow persists after 2"):
        tex.run_experiment_regrow(spec, (), 2, seed=1, t_end=20.0,
                                  max_regrows=2, device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        tex.run_experiment_regrow(spec, (), 2, mesh=object(), device="cpu")
