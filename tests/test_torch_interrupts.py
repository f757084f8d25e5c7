"""Interrupts, timers and the abort's cleanup: the port against cimba_tpu
on the reference's scripted scenarios.

The scenarios of ``tests/test_toolkit.py`` that deliver a signal from
outside a wait (an interrupt of a holding process, a timeout of a pended
acquire, a pool acquire rolled back on a timeout and on an interrupt, a
buffer get's partial report on a timeout and on an interrupt) are built
once per package from the same code, run through ``jax.jit(jax.vmap(
make_run))`` and the port's ``make_run`` on the CPU (2 lanes, f64), and
compared leaf for leaf with ``interop.diff_leaves`` (integers and bools
equal, floats within 1e-12 of each leaf's scale); the scenario's own
expected timeline is checked on the port's result.  The reference's
timeout scenario waits on a binary resource: here it waits on a
resource pool of one unit, the same timeline (``test_torch_preempt.py``
holds the binary resource's own form).
Each scenario also runs through a traced replay of its blocks
(``core.trace``), so the engine calls and their gates are held too.
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
from cimba_tpu_torch.core import trace
from cimba_tpu_torch.core.model import Model as TModel

torch.set_num_threads(1)

RTOL = 1e-12
LANES = 2
TIMEOUT, INTERRUPTED = -5, -2

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


def interrupt_holder(k):
    """A sleeper holding 100 is interrupted at t=2 with an app signal:
    its continuation sees the signal, and the stale hold's wake is gone
    (the clock ends at 2)."""
    m = k.Model("intr", n_flocals=2, event_cap=16, guard_cap=4)
    box = []

    @m.block
    def sleeper(sim, p, sig):
        return sim, k.cmd.hold(100.0, next_pc=woke.pc)

    @m.block
    def woke(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        sim = k.api.set_local_f(sim, p, 1, k.f64(sig))
        return sim, k.cmd.exit_()

    @m.block
    def rude(sim, p, sig):
        return sim, k.cmd.hold(2.0, next_pc=poke.pc)

    @m.block
    def poke(sim, p, sig):
        sim = k.api.interrupt(sim, box[0], 0, -7)
        return sim, k.cmd.exit_()

    m.process("sleeper", entry=sleeper)
    m.process("rude", entry=rude)
    box.append(m.build())
    return box[0]


def check_interrupt_holder(out):
    assert bool((out.procs.locals_f[:, 0, 0] == 2.0).all())
    assert bool((out.procs.locals_f[:, 0, 1] == -7.0).all())
    assert bool((out.clock == 2.0).all())


def acquire_with_timeout(k):
    """A hog holds the single unit for 50; an impatient acquirer with a
    timer of 5 times out at 5 and is off the guard (the hog finishes at
    50, the unit back)."""
    m = k.Model("timeout", n_flocals=2, event_cap=16, guard_cap=4)
    res = m.resourcepool("server", capacity=1.0)

    @m.block
    def hog(sim, p, sig):
        return sim, k.cmd.pool_acquire(res.id, 1.0, next_pc=hog_hold.pc)

    @m.block
    def hog_hold(sim, p, sig):
        return sim, k.cmd.hold(50.0, next_pc=hog_rel.pc)

    @m.block
    def hog_rel(sim, p, sig):
        return sim, k.cmd.pool_release(res.id, 1.0, next_pc=hog_done.pc)

    @m.block
    def hog_done(sim, p, sig):
        return sim, k.cmd.exit_()

    @m.block
    def impatient(sim, p, sig):
        sim, _ = k.api.timer_add(sim, p, 5.0, TIMEOUT)
        return sim, k.cmd.pool_acquire(res.id, 1.0, next_pc=verdict.pc)

    @m.block
    def verdict(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        sim = k.api.set_local_f(sim, p, 1, k.f64(sig))
        return sim, k.cmd.exit_()

    m.process("hog", entry=hog)
    m.process("impatient", entry=impatient)
    return m.build()


def check_acquire_with_timeout(out):
    assert bool((out.procs.locals_f[:, 1, 0] == 5.0).all())
    assert bool((out.procs.locals_f[:, 1, 1] == TIMEOUT).all())
    assert bool((out.clock == 50.0).all())
    assert bool((out.pools.level[:, 0] == 1.0).all())


def _hog(k, m, pool):
    """The hog: takes 7 units at once, holds them 100, exits."""
    @m.block
    def hog(sim, p, sig):
        return sim, k.cmd.pool_acquire(pool.id, 7.0, next_pc=hold_it.pc)

    @m.block
    def hold_it(sim, p, sig):
        return sim, k.cmd.hold(100.0, next_pc=fin.pc)

    @m.block
    def fin(sim, p, sig):
        return sim, k.cmd.exit_()

    return hog


def pool_rollback_on_timeout(k):
    """A greedy acquire of 6 grabs the 3 available and waits with a
    timer of 5: at the timeout its 3 go back (nothing held, 3 in the
    pool, checked inside the run with api.fail)."""
    m = k.Model("rollback", n_flocals=2, event_cap=32, guard_cap=4)
    pool = m.resourcepool("units", capacity=10.0)
    hog = _hog(k, m, pool)

    @m.block
    def greedy(sim, p, sig):
        sim, _ = k.api.timer_add(sim, p, 5.0, TIMEOUT)
        return sim, k.cmd.pool_acquire(pool.id, 6.0, next_pc=verdict2.pc)

    @m.block
    def verdict2(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        sim = k.api.set_local_f(sim, p, 1, k.f64(sig))
        sim = k.api.fail(sim, (k.held(sim, pool, p) != 0.0)
                         | (k.level(sim, pool) != 3.0))
        return sim, k.cmd.exit_()

    m.process("hog", entry=hog)
    m.process("greedy", entry=greedy)
    return m.build()


def check_pool_rollback_on_timeout(out):
    assert bool((out.procs.locals_f[:, 1, 0] == 5.0).all())
    assert bool((out.procs.locals_f[:, 1, 1] == TIMEOUT).all())
    assert bool((out.pools.level[:, 0] == 10.0).all())


def buffer_partial_on_timeout(k):
    """A get of 6 from a tank of 3 with a timer of 5: it keeps the 3 it
    drained, and api.got reports them."""
    m = k.Model("partial", n_flocals=3, event_cap=32, guard_cap=4)
    buf = m.buffer("tank", capacity=10.0, initial=3.0)

    @m.block
    def want6(sim, p, sig):
        sim, _ = k.api.timer_add(sim, p, 5.0, TIMEOUT)
        return sim, k.cmd.buffer_get(buf.id, 6.0, next_pc=check.pc)

    @m.block
    def check(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        sim = k.api.set_local_f(sim, p, 1, k.f64(sig))
        sim = k.api.set_local_f(sim, p, 2, k.api.got(sim, p))
        return sim, k.cmd.exit_()

    m.process("consumer", entry=want6)
    return m.build()


def check_buffer_partial_on_timeout(out):
    assert bool((out.procs.locals_f[:, 0, 0] == 5.0).all())
    assert bool((out.procs.locals_f[:, 0, 1] == TIMEOUT).all())
    assert bool((out.procs.locals_f[:, 0, 2] == 3.0).all())
    assert bool((out.buffers.level[:, 0] == 0.0).all())


def pool_rollback_on_interrupt(k):
    """The greedy acquire of 6 (3 grabbed) interrupted at 5: its 3 go
    back at the delivery, it holds nothing."""
    m = k.Model("rbintr", n_flocals=3, event_cap=32, guard_cap=4)
    pool = m.resourcepool("units", capacity=10.0)
    box = []
    hog = _hog(k, m, pool)

    @m.block
    def greedy(sim, p, sig):
        return sim, k.cmd.pool_acquire(pool.id, 6.0, next_pc=verdict3.pc)

    @m.block
    def verdict3(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        sim = k.api.set_local_f(sim, p, 1, k.f64(sig))
        sim = k.api.set_local_f(sim, p, 2, k.held(sim, pool, p))
        return sim, k.cmd.exit_()

    @m.block
    def rude2(sim, p, sig):
        return sim, k.cmd.hold(5.0, next_pc=poke2.pc)

    @m.block
    def poke2(sim, p, sig):
        sim = k.api.interrupt(sim, box[0], 1, INTERRUPTED)
        return sim, k.cmd.exit_()

    m.process("hog", entry=hog)
    m.process("greedy", entry=greedy)
    m.process("rude", entry=rude2)
    box.append(m.build())
    return box[0]


def check_pool_rollback_on_interrupt(out):
    assert bool((out.procs.locals_f[:, 1, 0] == 5.0).all())
    assert bool((out.procs.locals_f[:, 1, 1] == INTERRUPTED).all())
    assert bool((out.procs.locals_f[:, 1, 2] == 0.0).all())


def buffer_partial_on_interrupt(k):
    """The get of 6 (3 drained) interrupted at 4: api.got holds the 3."""
    m = k.Model("bufintr", n_flocals=3, event_cap=32, guard_cap=4)
    buf = m.buffer("tank", capacity=10.0, initial=3.0)
    box = []

    @m.block
    def want6(sim, p, sig):
        return sim, k.cmd.buffer_get(buf.id, 6.0, next_pc=check2.pc)

    @m.block
    def check2(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        sim = k.api.set_local_f(sim, p, 1, k.f64(sig))
        sim = k.api.set_local_f(sim, p, 2, k.api.got(sim, p))
        return sim, k.cmd.exit_()

    @m.block
    def rude3(sim, p, sig):
        return sim, k.cmd.hold(4.0, next_pc=poke3.pc)

    @m.block
    def poke3(sim, p, sig):
        sim = k.api.interrupt(sim, box[0], 0, INTERRUPTED)
        return sim, k.cmd.exit_()

    m.process("consumer", entry=want6)
    m.process("rude", entry=rude3)
    box.append(m.build())
    return box[0]


def check_buffer_partial_on_interrupt(out):
    assert bool((out.procs.locals_f[:, 0, 0] == 4.0).all())
    assert bool((out.procs.locals_f[:, 0, 1] == INTERRUPTED).all())
    assert bool((out.procs.locals_f[:, 0, 2] == 3.0).all())


SCENARIOS = {
    "interrupt_holder": (interrupt_holder, check_interrupt_holder),
    "acquire_with_timeout": (acquire_with_timeout,
                             check_acquire_with_timeout),
    "pool_rollback_on_timeout": (pool_rollback_on_timeout,
                                 check_pool_rollback_on_timeout),
    "buffer_partial_on_timeout": (buffer_partial_on_timeout,
                                  check_buffer_partial_on_timeout),
    "pool_rollback_on_interrupt": (pool_rollback_on_interrupt,
                                   check_pool_rollback_on_interrupt),
    "buffer_partial_on_interrupt": (buffer_partial_on_interrupt,
                                    check_buffer_partial_on_interrupt),
}


def _replayed(spec):
    """``spec`` with each block replaced by the replay of its trace on
    the state it is given (the tracer's view of the block, run)."""
    import dataclasses

    def wrap(pc):
        def blk(sim, p, sig):
            ir = trace.trace_block(spec, pc, sim)
            return trace.replay(spec, ir, sim, p, sig)
        return blk

    return dataclasses.replace(
        spec, blocks=[wrap(pc) for pc in range(len(spec.blocks))])


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


def test_eventset_cancels_match_reference():
    """``eventset.cancel`` (by handle: a live slot of the handle's
    generation only) and ``pattern_cancel`` (by kind and subject, either
    a wildcard, gated) on fuzzed tables, against the reference's, lane
    by lane: the tables and the results equal."""
    from cimba_tpu.core import eventset as jev
    from cimba_tpu_torch.core import eventset as tev

    rng = np.random.default_rng(10)
    lanes, cap = 16, 12
    with jconfig.profile("f64"):
        for _ in range(4):
            live = rng.random((lanes, cap)) < 0.6
            t = tev.EventSet(
                time=torch.tensor(np.where(live, rng.random((lanes, cap)),
                                           np.inf)),
                prio=torch.zeros((lanes, cap), dtype=torch.int32),
                seq=torch.tensor(rng.integers(0, 99, (lanes, cap)),
                                 dtype=torch.int32),
                kind=torch.tensor(rng.integers(0, 3, (lanes, cap)),
                                  dtype=torch.int32),
                subj=torch.tensor(rng.integers(0, 3, (lanes, cap)),
                                  dtype=torch.int32),
                arg=torch.zeros((lanes, cap), dtype=torch.int32),
                gen=torch.tensor(rng.integers(0, 3, (lanes, cap)),
                                 dtype=torch.int32),
                next_seq=torch.zeros(lanes, dtype=torch.int32),
                overflow=torch.zeros(lanes, dtype=torch.bool))
            handle = torch.tensor(
                (rng.integers(0, 3, lanes) << 16) | rng.integers(0, cap,
                                                                 lanes),
                dtype=torch.int32)
            handle[0] = -1
            kind = torch.tensor(rng.integers(-1, 3, lanes), dtype=torch.int32)
            subj = torch.tensor(rng.integers(-1, 3, lanes), dtype=torch.int32)
            pred = torch.tensor(rng.random(lanes) < 0.7)
            tc, tok = tev.cancel(t, handle)
            tp, tn = tev.pattern_cancel(t, kind, subj, pred)
            for ln in range(lanes):
                je = jev.create(cap)._replace(**{
                    f: jnp.asarray(getattr(t, f)[ln].numpy())
                    for f in ("time", "prio", "seq", "kind", "subj", "arg",
                              "gen")})
                jc, jok = jev.cancel(je, jnp.int32(int(handle[ln])))
                jp, jn = jev.pattern_cancel(je, int(kind[ln]), int(subj[ln]),
                                            bool(pred[ln]))
                for f in ("time", "gen"):
                    np.testing.assert_array_equal(
                        np.asarray(getattr(jc, f)), getattr(tc, f)[ln].numpy())
                    np.testing.assert_array_equal(
                        np.asarray(getattr(jp, f)), getattr(tp, f)[ln].numpy())
                assert bool(jok) == bool(tok[ln])
                assert int(jn) == int(tn[ln])
