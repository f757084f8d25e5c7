"""``cmd.wait_event``: the port against cimba_tpu on the reference's
scenarios (``tests/test_wait_event.py``).

Each scenario of the reference's file is built in both packages from the
same code (its user arrays as scalar leaves, which the generated kernel
takes), run through ``jax.jit(jax.vmap(make_run))`` and the port's
``make_run`` on the CPU (2 lanes, f64) and compared leaf for leaf with
``interop.diff_leaves`` (integers and bools equal, floats within 1e-9 of
each leaf's scale); the reference's own expected timeline is checked on
the port's result, and each scenario also runs through a traced replay of
its blocks (``core.trace``), bit for bit.  The reference's kernel-path
model (``usergen.wait_event_spec``, the cell waitev's) runs at 16 lanes,
seed 17, in f32 and f64, against ``make_run`` (the reference's oracle of
its kernel-path case): every leaf, and ``n_events == 3 x fires`` in every
lane.
"""

import functools
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
from cimba_tpu_torch.core import trace
from cimba_tpu_torch.tools import usergen

torch.set_num_threads(1)

LANES = 2
RTOL = {"f64": 1e-9, "f32": 2e-5}

JAX = types.SimpleNamespace(
    Model=JModel, cmd=jcmd, api=japi, cr=jcr,
    i32=lambda v: jnp.asarray(v, jnp.int32),
    f64=lambda v: jnp.asarray(v, jnp.float64), isinf=jnp.isinf,
    zeros_i=lambda: jnp.zeros((), jnp.int32),
    real_of=lambda x: jnp.asarray(x).astype(jconfig.REAL))
TORCH = types.SimpleNamespace(
    Model=usergen.torch_lib().Model, cmd=pr, api=usergen.torch_lib().api,
    cr=usergen.torch_lib().cr,
    i32=lambda v: torch.tensor(v, dtype=torch.int32),
    f64=lambda v: torch.tensor(v, dtype=torch.float64), isinf=torch.isinf,
    zeros_i=lambda: torch.zeros((), dtype=torch.int32),
    real_of=lambda x: x.to(tconfig.real()))


def _waiter_blocks(k, m, get_handle):
    """The reference's standard waiter: wait on ``get_handle(sim)``,
    record (clock, sig)."""

    @m.block
    def w_wait(sim, p, sig):
        return sim, k.cmd.wait_event(get_handle(sim), next_pc=w_done.pc)

    @m.block
    def w_done(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        sim = k.api.set_local_i(sim, p, 0, sig)
        return sim, k.cmd.exit_()

    return w_wait


def _fired_state(k, m):
    @m.user_state
    def init(params):
        return {"h": k.i32(-1), "fired_t": k.f64(-1.0)}

    @m.handler
    def on_fire(sim, subj, arg):
        return k.api.set_user(sim, {**sim.user,
                                    "fired_t": k.api.clock(sim)})

    return on_fire


def wakes_at_dispatch(k):
    m = k.Model("wev", n_flocals=1, n_ilocals=1, event_cap=16)
    on_fire = _fired_state(k, m)

    @m.block
    def s_sched(sim, p, sig):
        sim, h = k.api.schedule(sim, 5.0, 0, on_fire)
        sim = k.api.set_user(sim, {**sim.user, "h": h})
        return sim, k.cmd.exit_()

    w_wait = _waiter_blocks(k, m, lambda sim: sim.user["h"])
    m.process("scheduler", entry=s_sched, prio=1)
    m.process("waiter", entry=w_wait, prio=0)
    return m.build()


def check_wakes_at_dispatch(out):
    assert bool((out.procs.locals_f[:, 1, 0] == 5.0).all())
    assert bool((out.procs.locals_i[:, 1, 0] == pr.SUCCESS).all())
    assert bool((out.user["fired_t"] == 5.0).all())


def on_timer(k):
    m = k.Model("wtimer", n_flocals=1, n_ilocals=1, event_cap=16)

    @m.user_state
    def init(params):
        return {"h": k.i32(-1)}

    @m.block
    def t_arm(sim, p, sig):
        sim, h = k.api.timer_add(sim, p, 3.0, 7)
        sim = k.api.set_user(sim, {**sim.user, "h": h})
        return sim, k.cmd.hold(100.0, next_pc=t_got.pc)

    @m.block
    def t_got(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        sim = k.api.set_local_i(sim, p, 0, sig)
        return sim, k.cmd.exit_()

    w_wait = _waiter_blocks(k, m, lambda sim: sim.user["h"])
    m.process("subject", entry=t_arm, prio=1)
    m.process("waiter", entry=w_wait, prio=0)
    return m.build()


def check_on_timer(out):
    assert bool((out.procs.locals_f[:, 0, 0] == 3.0).all())
    assert bool((out.procs.locals_i[:, 0, 0] == 7).all())
    assert bool((out.procs.locals_f[:, 1, 0] == 3.0).all())
    assert bool((out.procs.locals_i[:, 1, 0] == pr.SUCCESS).all())


def _never(k, m):
    @m.user_state
    def init(params):
        return {"h": k.i32(-1)}

    @m.handler
    def never(sim, subj, arg):
        return k.api.fail(sim)

    return never


def cancel_eager(k):
    m = k.Model("wcancel", n_flocals=1, n_ilocals=1, event_cap=16)
    box = []
    never = _never(k, m)

    @m.block
    def c_sched(sim, p, sig):
        sim, h = k.api.schedule(sim, 50.0, 0, never)
        sim = k.api.set_user(sim, {**sim.user, "h": h})
        return sim, k.cmd.hold(2.0, next_pc=c_cancel.pc)

    @m.block
    def c_cancel(sim, p, sig):
        sim, _ = k.api.event_cancel(sim, sim.user["h"], box[0])
        return sim, k.cmd.exit_()

    w_wait = _waiter_blocks(k, m, lambda sim: sim.user["h"])
    m.process("canceller", entry=c_sched, prio=1)
    m.process("waiter", entry=w_wait, prio=0)
    box.append(m.build())
    return box[0]


def check_cancel_eager(out):
    assert bool((out.procs.locals_f[:, 1, 0] == 2.0).all())
    assert bool((out.procs.locals_i[:, 1, 0] == pr.CANCELLED).all())
    assert bool((out.clock == 2.0).all())


def cancel_lazy(k):
    m = k.Model("wlazy", n_flocals=1, n_ilocals=1, event_cap=16)
    never = _never(k, m)

    @m.block
    def c_sched(sim, p, sig):
        sim, h = k.api.schedule(sim, 50.0, 0, never)
        sim = k.api.set_user(sim, {**sim.user, "h": h})
        return sim, k.cmd.hold(2.0, next_pc=c_cancel.pc)

    @m.block
    def c_cancel(sim, p, sig):
        sim, _ = k.api.event_cancel(sim, sim.user["h"])
        return sim, k.cmd.hold(1.0, next_pc=c_exit.pc)

    @m.block
    def c_exit(sim, p, sig):
        return sim, k.cmd.exit_()

    w_wait = _waiter_blocks(k, m, lambda sim: sim.user["h"])
    m.process("canceller", entry=c_sched, prio=1)
    m.process("waiter", entry=w_wait, prio=0)
    return m.build()


def check_cancel_lazy(out):
    assert bool((out.procs.locals_f[:, 1, 0] == 3.0).all())
    assert bool((out.procs.locals_i[:, 1, 0] == pr.CANCELLED).all())


def dead_handle(k):
    m = k.Model("wdead", n_flocals=1, n_ilocals=1, event_cap=16)
    w_wait = _waiter_blocks(k, m, lambda sim: -1)
    m.process("waiter", entry=w_wait)
    return m.build()


def check_dead_handle(out):
    assert bool((out.procs.locals_f[:, 0, 0] == 0.0).all())
    assert bool((out.procs.locals_i[:, 0, 0] == pr.CANCELLED).all())


def timer_wake_clears_await(k):
    m = k.Model("wtwake", n_flocals=2, n_ilocals=2, event_cap=16)
    on_fire = _fired_state(k, m)

    @m.block
    def s_sched(sim, p, sig):
        sim, h = k.api.schedule(sim, 5.0, 0, on_fire)
        sim = k.api.set_user(sim, {**sim.user, "h": h})
        return sim, k.cmd.exit_()

    @m.block
    def w_arm(sim, p, sig):
        sim, _ = k.api.timer_add(sim, p, 2.0, 9)
        return sim, k.cmd.wait_event(sim.user["h"], next_pc=w_first.pc)

    @m.block
    def w_first(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        sim = k.api.set_local_i(sim, p, 0, sig)
        return sim, k.cmd.hold(10.0, next_pc=w_second.pc)

    @m.block
    def w_second(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 1, k.api.clock(sim))
        sim = k.api.set_local_i(sim, p, 1, sig)
        return sim, k.cmd.exit_()

    m.process("scheduler", entry=s_sched, prio=1)
    m.process("waiter", entry=w_arm, prio=0)
    return m.build()


def check_timer_wake_clears_await(out):
    assert bool((out.procs.locals_f[:, 1, 0] == 2.0).all())
    assert bool((out.procs.locals_i[:, 1, 0] == 9).all())
    assert bool((out.procs.locals_f[:, 1, 1] == 12.0).all())
    assert bool((out.procs.locals_i[:, 1, 1] == pr.SUCCESS).all())
    assert bool((out.user["fired_t"] == 5.0).all())


def cancel_drains_set(k):
    m = k.Model("wdrain", n_flocals=1, n_ilocals=1, event_cap=16)
    never = _never(k, m)

    @m.block
    def c_sched(sim, p, sig):
        sim, h = k.api.schedule(sim, 50.0, 0, never)
        sim = k.api.set_user(sim, {**sim.user, "h": h})
        return sim, k.cmd.hold(2.0, next_pc=c_last.pc)

    @m.block
    def c_last(sim, p, sig):
        sim, _ = k.api.event_cancel(sim, sim.user["h"])
        return sim, k.cmd.exit_()

    w_wait = _waiter_blocks(k, m, lambda sim: sim.user["h"])
    m.process("canceller", entry=c_sched, prio=1)
    m.process("waiter", entry=w_wait, prio=0)
    return m.build()


def check_cancel_drains_set(out):
    assert bool((out.procs.locals_f[:, 1, 0] == 2.0).all())
    assert bool((out.procs.locals_i[:, 1, 0] == pr.CANCELLED).all())


def interrupt_during_wait(k):
    m = k.Model("wintr", n_flocals=1, n_ilocals=1, event_cap=16)
    box = []
    on_fire = _fired_state(k, m)

    @m.block
    def i_sched(sim, p, sig):
        sim, h = k.api.schedule(sim, 5.0, 0, on_fire)
        sim = k.api.set_user(sim, {**sim.user, "h": h})
        return sim, k.cmd.hold(2.0, next_pc=i_intr.pc)

    @m.block
    def i_intr(sim, p, sig):
        sim = k.api.interrupt(sim, box[0], 1, 42)
        return sim, k.cmd.exit_()

    w_wait = _waiter_blocks(k, m, lambda sim: sim.user["h"])
    m.process("interrupter", entry=i_sched, prio=1)
    m.process("waiter", entry=w_wait, prio=0)
    box.append(m.build())
    return box[0]


def check_interrupt_during_wait(out):
    assert bool((out.procs.locals_f[:, 1, 0] == 2.0).all())
    assert bool((out.procs.locals_i[:, 1, 0] == 42).all())
    assert bool((out.user["fired_t"] == 5.0).all())
    assert bool((out.procs.await_evt[:, 1] == -1).all())


SCENARIOS = {
    "wakes_at_dispatch": (wakes_at_dispatch, check_wakes_at_dispatch),
    "on_timer": (on_timer, check_on_timer),
    "cancel_eager": (cancel_eager, check_cancel_eager),
    "cancel_lazy": (cancel_lazy, check_cancel_lazy),
    "dead_handle": (dead_handle, check_dead_handle),
    "timer_wake_clears_await": (timer_wake_clears_await,
                                check_timer_wake_clears_await),
    "cancel_drains_set": (cancel_drains_set, check_cancel_drains_set),
    "interrupt_during_wait": (interrupt_during_wait,
                              check_interrupt_during_wait),
}


def replayed(spec):
    """``spec`` with each block and handler replaced by the replay of
    its trace on the state it is given."""
    import dataclasses

    def wrap(pc):
        def blk(sim, p, sig):
            ir = trace.trace_block(spec, pc, sim)
            return trace.replay(spec, ir, sim, p, sig)
        return blk

    def hwrap(k, fn):
        def h(sim, subj, arg):
            ir = trace.trace_handler(spec, k, sim)
            return trace.replay(spec, ir, sim, subj, arg)
        h.kind = fn.kind
        return h

    out = dataclasses.replace(
        spec, blocks=[wrap(pc) for pc in range(len(spec.blocks))],
        user_handlers=[hwrap(k, h) for k, h in
                       enumerate(spec.user_handlers)])
    return out


def run_both(build, lanes, prof, seed=0, replay=True):
    """(reference init, reference end, port init, port end, the port's
    run of the traced replay or None), checked leaf for leaf."""
    with jconfig.profile(prof):
        jspec = build(JAX)
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(jspec, seed, r)))(
            jnp.arange(lanes))
        jout = jax.jit(jax.vmap(jloop.make_run(jspec)))(js)
    with tconfig.profile(prof):
        tspec = build(TORCH)
        ts = tloop.init_sim(tspec, seed, torch.arange(lanes), device="cpu")
        tout = tloop.make_run(tspec)(ts)
        rout = tloop.make_run(replayed(tspec))(ts) if replay else None
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    if rout is not None:
        assert interop.diff_leaves(interop.sim_to_numpy(tout),
                                   interop.sim_to_numpy(rout), 0.0) == []
    assert int(tout.err.abs().sum()) == 0
    return tout


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name):
    build, check = SCENARIOS[name]
    check(run_both(build, LANES, "f64"))


@functools.lru_cache(maxsize=None)
def cell_run(prof):
    return run_both(usergen.wait_event_spec, 16, prof, seed=17,
                    replay=False)


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_cell_model_matches_reference(prof):
    """The cell waitev's model (the reference's kernel-path case) at 16
    lanes: every leaf, every process finished with its last wake's
    SUCCESS past t=6, and three events a fire in every lane."""
    out = cell_run(prof)
    assert bool((out.procs.status == pr.FINISHED).all())
    assert bool((out.procs.locals_i[:, :, 0] == pr.SUCCESS).all())
    assert bool((out.procs.locals_f[:, :, 0] > usergen.WAITEV_T_DONE).all())
    fires = out.user["fires"].to(out.n_events.dtype)
    assert bool((out.n_events == 3 * fires).all())
    assert int(fires.min()) > 0


def test_cell_model_replays_bit_for_bit():
    """The cell's blocks and handler through their traces, 16 lanes f32
    to the end, equal to the blocks themselves."""
    with tconfig.profile("f32"):
        spec = usergen.wait_event_spec(usergen.torch_lib())
        s = tloop.init_sim(spec, 17, torch.arange(16), device="cpu")
        a = tloop.make_run(spec)(s)
        b = tloop.make_run(replayed(spec))(s)
    assert interop.diff_leaves(interop.sim_to_numpy(a),
                               interop.sim_to_numpy(b), 0.0) == []
