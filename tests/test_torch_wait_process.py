"""``cmd.wait_process`` and ``api.priority_set``: the port against
cimba_tpu on the reference's scenarios.

``usergen.wait_process_spec`` restates ``tests/test_toolkit.py``'s
``test_wait_process_mass_wake_preserves_pid_order`` (each waiter's place
in the wake order in its local, where the reference writes an array of
4) and, with ``joins``, ``test_wait_process_success_and_stopped``; this
file restates ``test_priority_set_reorders_guard``,
``test_aborted_wait_leaves_no_zombie_guard_entry`` and
``tests/test_abort_order.py`` (a pool waiter timed out, then joined to
the hog's exit).  Each runs through ``jax.jit(jax.vmap(make_run))`` and
the port's ``make_run`` on the CPU (2 lanes, f64, and f32 for the two
usergen specs) leaf for leaf (integers exact, floats within 1e-9 / 2e-5
of each leaf's scale) and through a traced replay of its blocks, bit for
bit; the reference's expected timeline is checked on the port's result.
"""

import types

import jax
import jax.numpy as jnp
import pytest
import torch

import cimba_tpu.random as jcr
from cimba_tpu import config as jconfig
from cimba_tpu.core import api as japi
from cimba_tpu.core import cmd as jcmd
from cimba_tpu.core import loop as jloop
from cimba_tpu.core.model import Model as JModel
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.core import process as pr
from cimba_tpu_torch.tools import usergen

from test_torch_wait_event import replayed

torch.set_num_threads(1)

LANES = 2
RTOL = {"f64": 1e-9, "f32": 2e-5}

JAX = types.SimpleNamespace(
    Model=JModel, cmd=jcmd, api=japi, cr=jcr,
    zeros_i=lambda: jnp.zeros((), jnp.int32),
    real_of=lambda x: jnp.asarray(x).astype(jconfig.REAL),
    f64=lambda x: jnp.asarray(x).astype(jnp.float64))
TORCH = types.SimpleNamespace(
    **{**vars(usergen.torch_lib()), "f64": lambda x: x.to(torch.float64)})


def priority_set_guard(k):
    """pid 0 holds the desk to t=10; claimants 1 and 2 wait on it (1
    first); the booster raises pid 2's priority at t=5, so 2 takes the
    desk at 10, then 1."""
    m = k.Model("prioset", n_flocals=1, event_cap=16, guard_cap=4)
    res = m.resource("desk")

    @m.block
    def first(sim, p, sig):
        return sim, k.cmd.acquire(res.id, next_pc=first_hold.pc)

    @m.block
    def first_hold(sim, p, sig):
        return sim, k.cmd.hold(10.0, next_pc=first_rel.pc)

    @m.block
    def first_rel(sim, p, sig):
        return sim, k.cmd.release(res.id, next_pc=fin.pc)

    @m.block
    def fin(sim, p, sig):
        return sim, k.cmd.exit_()

    @m.block
    def want(sim, p, sig):
        return sim, k.cmd.hold(k.f64(p) * 0.5, next_pc=claim.pc)

    @m.block
    def claim(sim, p, sig):
        return sim, k.cmd.acquire(res.id, next_pc=got.pc)

    @m.block
    def got(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        return sim, k.cmd.release(res.id, next_pc=fin.pc)

    @m.block
    def booster(sim, p, sig):
        return sim, k.cmd.hold(5.0, next_pc=boost.pc)

    @m.block
    def boost(sim, p, sig):
        sim = k.api.priority_set(sim, 2, 9)
        return sim, k.cmd.exit_()

    m.process("first", entry=first)
    m.process("claimant", entry=want, count=2)
    m.process("booster", entry=booster)
    return m.build()


def check_priority_set_guard(out):
    assert bool((out.procs.locals_f[:, 2, 0] == 10.0).all())
    assert bool((out.procs.locals_f[:, 1, 0] == 10.0).all())
    assert bool((out.procs.prio[:, 2] == 9).all())


def zombie_guard(k):
    """A waiter timed out at 5 leaves the guard: the patient one takes
    the tool at 50."""
    m = k.Model("zombie", n_flocals=2, event_cap=16, guard_cap=4)
    res = m.resource("tool")

    @m.block
    def hog(sim, p, sig):
        return sim, k.cmd.acquire(res.id, next_pc=hog_hold.pc)

    @m.block
    def hog_hold(sim, p, sig):
        return sim, k.cmd.hold(50.0, next_pc=hog_rel.pc)

    @m.block
    def hog_rel(sim, p, sig):
        return sim, k.cmd.release(res.id, next_pc=fin.pc)

    @m.block
    def fin(sim, p, sig):
        return sim, k.cmd.exit_()

    @m.block
    def impatient(sim, p, sig):
        sim, _ = k.api.timer_add(sim, p, 5.0, pr.TIMEOUT)
        return sim, k.cmd.acquire(res.id, next_pc=gave_up.pc)

    @m.block
    def gave_up(sim, p, sig):
        return sim, k.cmd.exit_()

    @m.block
    def patient(sim, p, sig):
        return sim, k.cmd.hold(1.0, next_pc=pat_acq.pc)

    @m.block
    def pat_acq(sim, p, sig):
        return sim, k.cmd.acquire(res.id, next_pc=pat_got.pc)

    @m.block
    def pat_got(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        return sim, k.cmd.release(res.id, next_pc=fin.pc)

    m.process("hog", entry=hog)
    m.process("impatient", entry=impatient)
    m.process("patient", entry=patient)
    return m.build()


def check_zombie_guard(out):
    assert bool((out.procs.locals_f[:, 2, 0] == 50.0).all())
    assert bool((out.procs.status[:, 2] == pr.FINISHED).all())
    assert bool((out.resources.holder[:, 0] == -1).all())


def abort_order(k):
    """``tests/test_abort_order.py``: a greedy pool waiter times out at
    5, then joins the hog's exit at 100 (not a stolen rollback wake)."""
    m = k.Model("stale", n_flocals=2, event_cap=32)
    pool = m.resourcepool("units", capacity=3.0)

    @m.block
    def hog(sim, p, sig):
        return sim, k.cmd.pool_acquire(pool.id, 3.0, next_pc=hold_it.pc)

    @m.block
    def hold_it(sim, p, sig):
        return sim, k.cmd.hold(100.0, next_pc=fin.pc)

    @m.block
    def fin(sim, p, sig):
        return sim, k.cmd.exit_()

    @m.block
    def greedy(sim, p, sig):
        sim, _ = k.api.timer_add(sim, p, 5.0, pr.TIMEOUT)
        return sim, k.cmd.pool_acquire(pool.id, 2.0, next_pc=after_to.pc)

    @m.block
    def after_to(sim, p, sig):
        return sim, k.cmd.wait_process(0, next_pc=verdict.pc)

    @m.block
    def verdict(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        sim = k.api.set_local_f(sim, p, 1, k.f64(sig))
        return sim, k.cmd.exit_()

    m.process("hog", entry=hog)
    m.process("greedy", entry=greedy)
    return m.build()


def check_abort_order(out):
    assert bool((out.procs.locals_f[:, 1, 0] == 100.0).all())
    assert bool((out.procs.locals_f[:, 1, 1] == pr.SUCCESS).all())


def check_joins(out):
    lf = out.procs.locals_f
    assert bool((lf[:, 2, 0] == 5.0).all())
    assert bool((lf[:, 2, 1] == pr.SUCCESS).all())
    assert bool((lf[:, 3, 0] == 3.0).all())
    assert bool((lf[:, 3, 1] == pr.STOPPED).all())
    assert bool((out.procs.exit_sig[:, 1] == pr.STOPPED).all())


def check_mass_wake(out):
    # the waiters (pids 1-3) woke in pid order
    assert out.procs.locals_i[:, 1:, 0].tolist() == [[0, 1, 2]] * LANES
    assert bool((out.user["k"] == 3).all())
    assert bool((out.procs.await_pid == -1).all())


SCENARIOS = {
    "joins": (lambda k: usergen.wait_process_spec(k, joins=True),
              check_joins),
    "mass_wake": (usergen.wait_process_spec, check_mass_wake),
    "priority_set_guard": (priority_set_guard, check_priority_set_guard),
    "zombie_guard": (zombie_guard, check_zombie_guard),
    "abort_order": (abort_order, check_abort_order),
}


def run_both(build, prof, seed=1):
    with jconfig.profile(prof):
        jspec = build(JAX)
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(jspec, seed, r)))(
            jnp.arange(LANES))
        jout = jax.jit(jax.vmap(jloop.make_run(jspec)))(js)
    with tconfig.profile(prof):
        tspec = build(TORCH)
        ts = tloop.init_sim(tspec, seed, torch.arange(LANES), device="cpu")
        tout = tloop.make_run(tspec)(ts)
        rout = tloop.make_run(replayed(tspec))(ts)
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    assert interop.diff_leaves(interop.sim_to_numpy(tout),
                               interop.sim_to_numpy(rout), 0.0) == []
    assert int(tout.err.abs().sum()) == 0
    return tout


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name):
    build, check = SCENARIOS[name]
    check(run_both(build, "f64"))


@pytest.mark.parametrize("name", ["joins", "mass_wake"])
def test_usergen_wait_specs_f32(name):
    build, check = SCENARIOS[name]
    check(run_both(build, "f32"))


def test_wait_on_a_process_out_of_range_waits_forever():
    """A wait on a pid past the processes never wakes (the reference's
    read of no row is CREATED): the waiter stays RUNNING with its
    await_pid set once the lane runs out of events."""
    def build(k):
        m = k.Model("nowhere", n_flocals=1, event_cap=4)

        @m.block
        def w(sim, p, sig):
            return sim, k.cmd.wait_process(7, next_pc=never.pc)

        @m.block
        def never(sim, p, sig):
            return sim, k.cmd.exit_()

        m.process("w", entry=w)
        return m.build()

    out = run_both(build, "f64")
    assert bool((out.procs.await_pid[:, 0] == 7).all())
    assert bool((out.procs.status[:, 0] == pr.RUNNING).all())
