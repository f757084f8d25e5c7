"""Binary resources, preemption and stops: the port against cimba_tpu on
the reference's scripted scenarios.

The scenarios of ``tests/test_toolkit.py`` that take a binary resource
or mug a pool (a pool preempt's victims, lowest priority first and
latest grab first; a resource preempt kicking its holder; an acquire of
a resource under a timeout; a stop that frees a resource and a pool's
units) and a pool-preempt twin of its rollback on a timeout are built
once per package from the same code, run through ``jax.jit(jax.vmap(
make_run))`` and the port's ``make_run`` on the CPU (2 lanes, f64), and
compared leaf for leaf with ``interop.diff_leaves`` (integers and bools
equal, floats within 1e-12 of each leaf's scale); the reference's own
expected values are checked on the port's result.  Each scenario also
runs through a traced replay of its blocks (``core.trace``), so the
engine calls (``api.stop_process``, ``api.release``) are held too.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import api as japi
from cimba_tpu.core import loop as jloop
from cimba_tpu.core import process as jcmd
from cimba_tpu.core.model import Model as JModel
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import api as tapi
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.core import process as tcmd
from cimba_tpu_torch.core.model import Model as TModel
from test_torch_interrupts import _replayed

torch.set_num_threads(1)

RTOL = 1e-12
LANES = 2
SUCCESS, PREEMPTED, TIMEOUT, FINISHED = 0, -1, -5, 2

JAX = types.SimpleNamespace(
    Model=JModel, cmd=jcmd, api=japi,
    f64=lambda x: jnp.asarray(x).astype(jnp.float64),
    held=lambda sim, pool, p: sim.pools.held[pool.id, p],
    level=lambda sim, pool: sim.pools.level[pool.id])
TORCH = types.SimpleNamespace(
    Model=TModel, cmd=tcmd, api=tapi,
    f64=lambda x: x.to(torch.float64),
    held=lambda sim, pool, p: tapi.pool_held(sim, pool, p),
    level=lambda sim, pool: tapi.pool_level(sim, pool))


def _verdict(k, m, name="verdict"):
    """A block recording (clock, signal) in flocals 0 and 1, then
    exiting."""
    def verdict(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        sim = k.api.set_local_f(sim, p, 1, k.f64(sig))
        return sim, k.cmd.exit_()

    verdict.__name__ = name
    return m.block(verdict)


def pool_preempt_mugs(k):
    """Two holders of 4 units each at t=0; a boss of higher priority
    wants 5 at t=1: the 2 left plus ONE victim, the latest grab (pid 1),
    which loses all 4 and wakes with PREEMPTED; 1 unit of surplus goes
    back to the pool."""
    m = k.Model("mug", n_flocals=2, event_cap=32, guard_cap=4)
    pool = m.resourcepool("units", capacity=10.0)
    after = _verdict(k, m, "after")

    @m.block
    def grab(sim, p, sig):
        return sim, k.cmd.pool_acquire(pool.id, 4.0, next_pc=sit.pc)

    @m.block
    def sit(sim, p, sig):
        return sim, k.cmd.hold(100.0, next_pc=after.pc)

    @m.block
    def boss(sim, p, sig):
        return sim, k.cmd.hold(1.0, next_pc=boss_take.pc)

    @m.block
    def boss_take(sim, p, sig):
        return sim, k.cmd.pool_preempt(pool.id, 5.0, next_pc=boss_got.pc)

    @m.block
    def boss_got(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        sim = k.api.set_local_f(sim, p, 1, k.held(sim, pool, p))
        return sim, k.cmd.exit_()

    m.process("low", entry=grab, prio=0, count=2)  # pids 0, 1
    m.process("boss", entry=boss, prio=5)          # pid 2
    return m.build()


def check_pool_preempt_mugs(out):
    lf = out.procs.locals_f
    assert bool((lf[:, 2, 0] == 1.0).all())        # the boss at t=1
    assert bool((lf[:, 1, 0] == 1.0).all())        # pid 1 mugged at t=1
    assert bool((lf[:, 1, 1] == PREEMPTED).all())
    assert bool((lf[:, 0, 0] == 100.0).all())      # pid 0 kept its units
    assert bool((lf[:, 0, 1] == SUCCESS).all())
    assert bool((lf[:, 2, 1] == 5.0).all())        # 2 free + 3 of pid 1's
    assert bool((out.pools.level[:, 0] == 10.0).all())


def preempt_kicks_holder(k):
    """A low holder of a resource is kicked at t=2 by a high one's
    preempt: PREEMPTED, its 10-unit hold cancelled; the high one
    releases at t=3."""
    m = k.Model("preempt", n_flocals=2, event_cap=16, guard_cap=4)
    res = m.resource("gun")
    low_after = _verdict(k, m, "low_after")

    @m.block
    def low(sim, p, sig):
        return sim, k.cmd.acquire(res.id, next_pc=low_hold.pc)

    @m.block
    def low_hold(sim, p, sig):
        return sim, k.cmd.hold(10.0, next_pc=low_after.pc)

    @m.block
    def high(sim, p, sig):
        return sim, k.cmd.hold(2.0, next_pc=high_preempt.pc)

    @m.block
    def high_preempt(sim, p, sig):
        return sim, k.cmd.preempt(res.id, next_pc=high_hold.pc)

    @m.block
    def high_hold(sim, p, sig):
        return sim, k.cmd.hold(1.0, next_pc=high_rel.pc)

    @m.block
    def high_rel(sim, p, sig):
        return sim, k.cmd.release(res.id, next_pc=high_done.pc)

    @m.block
    def high_done(sim, p, sig):
        return sim, k.cmd.exit_()

    m.process("low", entry=low, prio=0)    # pid 0
    m.process("high", entry=high, prio=5)  # pid 1
    return m.build()


def check_preempt_kicks_holder(out):
    lf = out.procs.locals_f
    assert bool((lf[:, 0, 0] == 2.0).all())
    assert bool((lf[:, 0, 1] == PREEMPTED).all())
    assert bool((tapi.resource_holder(out, 0) == -1).all())
    assert bool((out.clock == 3.0).all())


def acquire_with_timeout(k):
    """A hog holds a resource 50 units; an impatient process's acquire
    under a 5-unit timer times out at t=5 and leaves the guard clean."""
    m = k.Model("timeout", n_flocals=2, event_cap=16, guard_cap=4)
    res = m.resource("server")
    verdict = _verdict(k, m)

    @m.block
    def hog(sim, p, sig):
        return sim, k.cmd.acquire(res.id, next_pc=hog_hold.pc)

    @m.block
    def hog_hold(sim, p, sig):
        return sim, k.cmd.hold(50.0, next_pc=hog_rel.pc)

    @m.block
    def hog_rel(sim, p, sig):
        return sim, k.cmd.release(res.id, next_pc=hog_done.pc)

    @m.block
    def hog_done(sim, p, sig):
        return sim, k.cmd.exit_()

    @m.block
    def impatient(sim, p, sig):
        sim, _ = k.api.timer_add(sim, p, 5.0, TIMEOUT)
        return sim, k.cmd.acquire(res.id, next_pc=verdict.pc)

    m.process("hog", entry=hog)              # pid 0
    m.process("impatient", entry=impatient)  # pid 1
    return m.build()


def check_acquire_with_timeout(out):
    lf = out.procs.locals_f
    assert bool((lf[:, 1, 0] == 5.0).all())
    assert bool((lf[:, 1, 1] == TIMEOUT).all())
    assert bool((out.clock == 50.0).all())
    assert bool((out.resources.holder[:, 0] == -1).all())


def stop_releases_held(k):
    """A holder of a resource and of 2 pool units is stopped at t=3:
    the resource goes to the process waiting for it at t=3, the units
    back to the pool, and the holder is FINISHED."""
    m = k.Model("stoprel", n_flocals=1, event_cap=16, guard_cap=4)
    res = m.resource("tool")
    pool = m.resourcepool("crew", capacity=3.0)
    box = []

    @m.block
    def holder(sim, p, sig):
        return sim, k.cmd.acquire(res.id, next_pc=holder_pool.pc)

    @m.block
    def holder_pool(sim, p, sig):
        return sim, k.cmd.pool_acquire(pool.id, 2.0, next_pc=holder_hold.pc)

    @m.block
    def holder_hold(sim, p, sig):
        return sim, k.cmd.hold(100.0, next_pc=holder_exit.pc)

    @m.block
    def holder_exit(sim, p, sig):
        return sim, k.cmd.exit_()

    @m.block
    def second(sim, p, sig):
        return sim, k.cmd.acquire(res.id, next_pc=second_got.pc)

    @m.block
    def second_got(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        return sim, k.cmd.release(res.id, next_pc=holder_exit.pc)

    @m.block
    def killer(sim, p, sig):
        return sim, k.cmd.hold(3.0, next_pc=kill.pc)

    @m.block
    def kill(sim, p, sig):
        sim = k.api.stop_process(sim, box[0], 0)
        return sim, k.cmd.exit_()

    m.process("holder", entry=holder)  # pid 0
    m.process("second", entry=second)  # pid 1, waits for the tool
    m.process("killer", entry=killer)  # pid 2
    box.append(m.build())
    return box[0]


def check_stop_releases_held(out):
    assert bool((out.procs.locals_f[:, 1, 0] == 3.0).all())
    assert bool((out.pools.level[:, 0] == 3.0).all())
    assert bool((out.procs.status[:, 0] == FINISHED).all())
    assert bool((out.procs.exit_sig[:, 0] == -3).all())   # STOPPED


def pool_preempt_rollback_on_timeout(k):
    """The pool-preempt twin of the reference's rollback on a timeout: a
    hog of the same priority takes 7 of 10 units (no one to mug), a
    preempting process wants 6, grabs the 3 left and pends for the rest
    under a 5-unit timer; the timeout rolls its pended C_POOL_PRE back
    (nothing held, 3 back in the pool), checked inside the run."""
    m = k.Model("prerollback", n_flocals=2, event_cap=32, guard_cap=4)
    pool = m.resourcepool("units", capacity=10.0)

    @m.block
    def hog(sim, p, sig):
        return sim, k.cmd.pool_acquire(pool.id, 7.0, next_pc=hold_it.pc)

    @m.block
    def hold_it(sim, p, sig):
        return sim, k.cmd.hold(100.0, next_pc=fin.pc)

    @m.block
    def fin(sim, p, sig):
        return sim, k.cmd.exit_()

    @m.block
    def greedy(sim, p, sig):
        sim, _ = k.api.timer_add(sim, p, 5.0, TIMEOUT)
        return sim, k.cmd.pool_preempt(pool.id, 6.0, next_pc=verdict.pc)

    @m.block
    def verdict(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        sim = k.api.set_local_f(sim, p, 1, k.f64(sig))
        sim = k.api.fail(sim, (k.held(sim, pool, p) != 0.0)
                         | (k.level(sim, pool) != 3.0))
        return sim, k.cmd.exit_()

    m.process("hog", entry=hog, prio=1)        # pid 0
    m.process("greedy", entry=greedy, prio=1)  # pid 1
    return m.build()


def check_pool_preempt_rollback_on_timeout(out):
    lf = out.procs.locals_f
    assert bool((lf[:, 1, 0] == 5.0).all())
    assert bool((lf[:, 1, 1] == TIMEOUT).all())
    assert bool((out.pools.level[:, 0] == 10.0).all())


SCENARIOS = {
    "pool_preempt_mugs": (pool_preempt_mugs, check_pool_preempt_mugs),
    "preempt_kicks_holder": (preempt_kicks_holder,
                             check_preempt_kicks_holder),
    "acquire_with_timeout": (acquire_with_timeout,
                             check_acquire_with_timeout),
    "stop_releases_held": (stop_releases_held, check_stop_releases_held),
    "pool_preempt_rollback_on_timeout": (
        pool_preempt_rollback_on_timeout,
        check_pool_preempt_rollback_on_timeout),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name):
    build, check = SCENARIOS[name]
    with jconfig.profile("f64"):
        jspec = build(JAX)
        js = jax.vmap(lambda r: jloop.init_sim(jspec, 0, r))(
            jnp.arange(LANES))
        jout = jax.jit(jax.vmap(jloop.make_run(jspec)))(js)
    with tconfig.profile("f64"):
        tspec = build(TORCH)
        ts = tloop.init_sim(tspec, 0, torch.arange(LANES), device="cpu")
        tout = tloop.make_run(tspec)(ts)
        rout = tloop.make_run(_replayed(tspec))(ts)
    assert int(np.abs(np.asarray(jout.err)).sum()) == 0
    assert int(tout.err.abs().sum()) == 0
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL) == []
    assert interop.diff_leaves(interop.sim_to_numpy(tout),
                               interop.sim_to_numpy(rout), 0.0) == []
    check(tout)


def test_abort_cleanup_rolls_back_a_pended_pool_preempt():
    """``loop._abort_cleanup`` on a pended C_POOL_PRE (the reference's
    ``is_pool`` reads both tags): the holding beyond the pend's pre-call
    amount goes back to the pool and the pool's guard is signalled, as
    for a pended C_POOL_ACQ; PREEMPTED rolls nothing back."""
    with tconfig.profile("f64"):
        spec = pool_preempt_rollback_on_timeout(TORCH)
        s = tloop.init_sim(spec, 0, torch.arange(3), device="cpu")
        s = tloop.make_run(spec, t_end=1.0)(s)   # greedy pended, 3 held
        assert bool((s.procs.pend_tag[:, 1] == tcmd.C_POOL_PRE).all())
        assert bool((s.pools.held[:, 0, 1] == 3.0).all())
        p = torch.ones(3, dtype=torch.int32)
        pend = tloop._pend_of(s, p)
        sig = torch.tensor([TIMEOUT, -2, PREEMPTED], dtype=torch.int32)
        out = tloop._abort_cleanup(spec, tloop._unwait(spec, s, p), p, pend,
                                   sig)
    assert out.pools.held[:, 0, 1].tolist() == [0.0, 0.0, 3.0]
    assert out.pools.level[:, 0].tolist() == [3.0, 3.0, 0.0]
