"""The toolkit's pools, buffers and conditions: the port against
cimba_tpu on the reference's scripted scenarios.

Each scenario of ``tests/test_toolkit.py`` that uses only resource
pools, buffers and conditions (the contention timeline, a buffer that
blocks until the amount is there, a condition's predicate gating its
waiter, a release that cascades to every satisfiable waiter, a
big-demand waiter that keeps its place, a put cascade) is built once
per package from the same code, run through ``jax.jit(jax.vmap(
make_run))`` and the port's ``make_run`` on the CPU (2 lanes, both
profiles), and compared leaf for leaf with ``interop.diff_leaves``
(integers and bools equal, floats within the profile's tolerance); the
scenario's own expected timeline is checked on the port's result.  The
scenarios that need interrupts, timeouts or preempt wait for those.
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

torch.set_num_threads(1)

RTOL = {"f64": 1e-12, "f32": 1e-6}
LANES = 2

JAX = types.SimpleNamespace(
    Model=JModel, cmd=jcmd, api=japi,
    real=lambda x: jnp.asarray(x, jconfig.REAL),
    zeros=lambda params: jnp.zeros((), jconfig.REAL))
TORCH = types.SimpleNamespace(
    Model=TModel, cmd=tcmd, api=tapi,
    real=lambda x: x.to(tconfig.real()),
    zeros=lambda params: torch.zeros_like(params[0], dtype=tconfig.real()))


def pool_contention(k):
    """3 machines, 2 repairmen: the third acquire waits for the first
    release (grant times 1, 2, 11; the clock ends at 21)."""
    m = k.Model("repair", n_flocals=1, event_cap=16, guard_cap=4)
    pool = m.resourcepool("repair", capacity=2.0)

    @m.block
    def fail(sim, p, sig):
        return sim, k.cmd.hold(k.real(p + 1), next_pc=acq.pc)

    @m.block
    def acq(sim, p, sig):
        return sim, k.cmd.pool_acquire(pool.id, 1.0, next_pc=repair.pc)

    @m.block
    def repair(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        return sim, k.cmd.hold(10.0, next_pc=rel.pc)

    @m.block
    def rel(sim, p, sig):
        return sim, k.cmd.pool_release(pool.id, 1.0, next_pc=done.pc)

    @m.block
    def done(sim, p, sig):
        return sim, k.cmd.exit_()

    m.process("machine", entry=fail, count=3)
    return m.build()


def check_pool_contention(out):
    np.testing.assert_array_equal(out.procs.locals_f[:, :, 0].numpy(),
                                  [[1.0, 2.0, 11.0]] * LANES)
    assert bool((out.pools.level[:, 0] == 2.0).all())
    assert bool((out.clock == 21.0).all())


def buffer_blocks(k):
    """A get of 8 from an empty tank: the first put of 5 wakes it, it
    waits again; the second put at t=2 completes it."""
    m = k.Model("buf", n_flocals=2, event_cap=16, guard_cap=4)
    buf = m.buffer("tank", capacity=10.0, initial=0.0)

    @m.block
    def want(sim, p, sig):
        return sim, k.cmd.buffer_get(buf.id, 8.0, next_pc=got_it.pc)

    @m.block
    def got_it(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        sim = k.api.set_local_f(sim, p, 1, k.api.buffer_level(sim, buf))
        return sim, k.cmd.exit_()

    @m.block
    def fill1(sim, p, sig):
        return sim, k.cmd.hold(1.0, next_pc=put1.pc)

    @m.block
    def put1(sim, p, sig):
        return sim, k.cmd.buffer_put(buf.id, 5.0, next_pc=fill2.pc)

    @m.block
    def fill2(sim, p, sig):
        return sim, k.cmd.hold(1.0, next_pc=put2.pc)

    @m.block
    def put2(sim, p, sig):
        return sim, k.cmd.buffer_put(buf.id, 5.0, next_pc=pdone.pc)

    @m.block
    def pdone(sim, p, sig):
        return sim, k.cmd.exit_()

    m.process("consumer", entry=want)
    m.process("producer", entry=fill1)
    return m.build()


def check_buffer_blocks(out):
    assert bool((out.procs.locals_f[:, 0, 0] == 2.0).all())
    assert bool((out.procs.locals_f[:, 0, 1] == 2.0).all())


def condition_gating(k):
    """A waiter on "count >= 2", signalled at t=1 (count 1: it waits
    again) and t=2 (count 2: it proceeds)."""
    m = k.Model("cond", n_flocals=1, event_cap=16, guard_cap=4)

    @m.user_state
    def user_init(params):
        return {"count": k.zeros(params)}

    cv = m.condition("enough", lambda sim, p: sim.user["count"] >= 2.0)
    spec_holder = []

    @m.block
    def waiter(sim, p, sig):
        return sim, k.cmd.cond_wait(cv.id, next_pc=granted.pc)

    @m.block
    def granted(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        return sim, k.cmd.exit_()

    @m.block
    def tick(sim, p, sig):
        return sim, k.cmd.hold(1.0, next_pc=bump.pc)

    @m.block
    def bump(sim, p, sig):
        sim = k.api.set_user(sim, {"count": sim.user["count"] + 1.0})
        sim = k.api.cond_signal(sim, spec_holder[0], cv)
        return sim, k.cmd.select(sim.user["count"] >= 2.0, k.cmd.exit_(),
                                 k.cmd.jump(tick.pc))

    m.process("waiter", entry=waiter)
    m.process("incrementer", entry=tick)
    spec_holder.append(m.build())
    return spec_holder[0]


def check_condition_gating(out):
    assert bool((out.procs.locals_f[:, 0, 0] == 2.0).all())


def pool_cascade(k):
    """One release of 10 units at t=5 wakes both waiters of 2 units."""
    m = k.Model("cascade", n_flocals=1, event_cap=16, guard_cap=4)
    pool = m.resourcepool("units", capacity=10.0)

    @m.block
    def grab_all(sim, p, sig):
        return sim, k.cmd.pool_acquire(pool.id, 10.0, next_pc=keep.pc)

    @m.block
    def keep(sim, p, sig):
        return sim, k.cmd.hold(5.0, next_pc=free_all.pc)

    @m.block
    def free_all(sim, p, sig):
        return sim, k.cmd.pool_release(pool.id, 10.0, next_pc=fin.pc)

    @m.block
    def fin(sim, p, sig):
        return sim, k.cmd.exit_()

    @m.block
    def want2(sim, p, sig):
        return sim, k.cmd.hold(1.0, next_pc=take2.pc)

    @m.block
    def take2(sim, p, sig):
        return sim, k.cmd.pool_acquire(pool.id, 2.0, next_pc=got2.pc)

    @m.block
    def got2(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        return sim, k.cmd.hold(100.0, next_pc=rel2.pc)

    @m.block
    def rel2(sim, p, sig):
        return sim, k.cmd.pool_release(pool.id, 2.0, next_pc=fin.pc)

    m.process("hoarder", entry=grab_all)
    m.process("small", entry=want2, count=2)
    return m.build()


def check_pool_cascade(out):
    np.testing.assert_array_equal(out.procs.locals_f[:, 1:3, 0].numpy(),
                                  [[5.0, 5.0]] * LANES)


def big_demand_keeps_front(k):
    """At t=1 only 2 units are free: the big waiter (8, queued first)
    retries, fails and keeps its place; the small one (2) may not pass
    it; at t=2 both are granted, big first."""
    m = k.Model("starve", n_flocals=1, event_cap=16, guard_cap=4)
    pool = m.resourcepool("units", capacity=10.0)

    @m.block
    def hog(sim, p, sig):
        return sim, k.cmd.pool_acquire(pool.id, 10.0, next_pc=hog_keep.pc)

    @m.block
    def hog_keep(sim, p, sig):
        return sim, k.cmd.hold(1.0, next_pc=hog_dribble.pc)

    @m.block
    def hog_dribble(sim, p, sig):
        return sim, k.cmd.pool_release(pool.id, 2.0, next_pc=hog_wait2.pc)

    @m.block
    def hog_wait2(sim, p, sig):
        return sim, k.cmd.hold(1.0, next_pc=hog_rest.pc)

    @m.block
    def hog_rest(sim, p, sig):
        return sim, k.cmd.pool_release(pool.id, 8.0, next_pc=fin2.pc)

    @m.block
    def fin2(sim, p, sig):
        return sim, k.cmd.exit_()

    @m.block
    def big(sim, p, sig):
        return sim, k.cmd.hold(0.1, next_pc=big_acq.pc)

    @m.block
    def big_acq(sim, p, sig):
        return sim, k.cmd.pool_acquire(pool.id, 8.0, next_pc=big_got.pc)

    @m.block
    def big_got(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        return sim, k.cmd.pool_release(pool.id, 8.0, next_pc=fin2.pc)

    @m.block
    def small(sim, p, sig):
        return sim, k.cmd.hold(0.2, next_pc=small_acq.pc)

    @m.block
    def small_acq(sim, p, sig):
        return sim, k.cmd.pool_acquire(pool.id, 2.0, next_pc=small_got.pc)

    @m.block
    def small_got(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        return sim, k.cmd.pool_release(pool.id, 2.0, next_pc=fin2.pc)

    m.process("hog", entry=hog)
    m.process("big", entry=big)
    m.process("small", entry=small)
    return m.build()


def check_big_demand_keeps_front(out):
    assert bool((out.procs.locals_f[:, 1, 0] == 2.0).all())
    assert bool((out.procs.locals_f[:, 2, 0] == 2.0).all())


def buffer_put_cascade(k):
    """A get of 8 from a full tank at t=2 frees room for both blocked
    putters of 1 unit; the level ends at 4."""
    m = k.Model("bufcascade", n_flocals=1, event_cap=16, guard_cap=4)
    buf = m.buffer("tank", capacity=10.0, initial=10.0)

    @m.block
    def putter(sim, p, sig):
        return sim, k.cmd.hold(1.0, next_pc=do_put.pc)

    @m.block
    def do_put(sim, p, sig):
        return sim, k.cmd.buffer_put(buf.id, 1.0, next_pc=put_done.pc)

    @m.block
    def put_done(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        return sim, k.cmd.exit_()

    @m.block
    def taker(sim, p, sig):
        return sim, k.cmd.hold(2.0, next_pc=take.pc)

    @m.block
    def take(sim, p, sig):
        return sim, k.cmd.buffer_get(buf.id, 8.0, next_pc=fin3.pc)

    @m.block
    def fin3(sim, p, sig):
        return sim, k.cmd.exit_()

    m.process("putter", entry=putter, count=2)
    m.process("taker", entry=taker)
    return m.build()


def check_buffer_put_cascade(out):
    np.testing.assert_array_equal(out.procs.locals_f[:, 0:2, 0].numpy(),
                                  [[2.0, 2.0]] * LANES)
    assert bool((out.buffers.level[:, 0] == 4.0).all())


SCENARIOS = {
    "pool_contention": (pool_contention, check_pool_contention),
    "buffer_blocks": (buffer_blocks, check_buffer_blocks),
    "condition_gating": (condition_gating, check_condition_gating),
    "pool_cascade": (pool_cascade, check_pool_cascade),
    "big_demand_keeps_front": (big_demand_keeps_front,
                               check_big_demand_keeps_front),
    "buffer_put_cascade": (buffer_put_cascade, check_buffer_put_cascade),
}


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name, prof):
    build, check = SCENARIOS[name]
    params = (0.0,)
    with jconfig.profile(prof):
        jspec = build(JAX)
        js = jax.vmap(lambda r: jloop.init_sim(jspec, 0, r, params))(
            jnp.arange(LANES))
        jout = jax.jit(jax.vmap(jloop.make_run(jspec)))(js)
    with tconfig.profile(prof):
        tspec = build(TORCH)
        ts = tloop.init_sim(tspec, 0, torch.arange(LANES), params,
                            device="cpu")
        tout = tloop.make_run(tspec)(ts)
    assert int(tout.err.abs().sum()) == 0
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    check(tout)
