"""User event handlers and ``api.schedule``: the port against cimba_tpu.

Scripted models built once per package from the same code, run through
``jax.jit(jax.vmap(make_run))`` and the port's ``make_run`` on the CPU
(2 lanes, f64) and compared leaf for leaf (integers exact, floats within
1e-12 of each leaf's scale), then through a traced replay of every block
and handler (``trace.replay`` of ``trace.trace_block`` and
``trace.trace_handler``), bit for bit:

* a handler that stops a process by the event's subject; the stopped
  process's pending wake (a hold of 100) never fires;
* two handlers scheduled at one time, broken by the events' priority
  (the higher first), each writing the user state with its argument;
* a handler that writes the clock into the user state;
* a table too small for the events a block schedules: the last
  ``api.schedule`` gives NULL_HANDLE and the replication fails with
  ERR_EVENT_OVERFLOW.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
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

JAX = types.SimpleNamespace(
    Model=JModel, cmd=jcmd, api=japi,
    zi=lambda: jnp.zeros((), jnp.int32), zf=lambda: jnp.zeros((), jnp.float64))
TORCH = types.SimpleNamespace(
    Model=TModel, cmd=tcmd, api=tapi,
    zi=lambda: torch.zeros((), dtype=torch.int32),
    zf=lambda: torch.zeros((), dtype=torch.float64))


def handlers_model(k):
    """A sleeper holds 100 (pid 0); a starter (pid 1) schedules, at t=0:
    a stop of pid 0 at t=2 (the event's subject), two writers of the log
    at t=5 with priorities 1 and 7 (arguments 3 and 4), and a writer of
    the clock at t=6."""
    m = k.Model("events", n_flocals=1, event_cap=8, guard_cap=2)
    box = []

    @m.user_state
    def init(params):
        return {"log": k.zi(), "t": k.zf(), "n": k.zi()}

    @m.handler
    def stopper(sim, subj, arg):
        sim = k.api.stop_process(sim, box[0], subj)
        return k.api.set_user(sim, {**sim.user, "n": sim.user["n"] + 1})

    @m.handler
    def logger(sim, subj, arg):
        return k.api.set_user(sim, {**sim.user,
                                    "log": sim.user["log"] * 10 + arg})

    @m.handler
    def stamp(sim, subj, arg):
        return k.api.set_user(sim, {**sim.user, "t": k.api.clock(sim)})

    @m.block
    def sleep(sim, p, sig):
        return sim, k.cmd.hold(100.0, next_pc=woke.pc)

    @m.block
    def woke(sim, p, sig):  # never reached: pid 0 is stopped at t=2
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim))
        return sim, k.cmd.exit_()

    @m.block
    def start(sim, p, sig):
        sim, h0 = k.api.schedule(sim, 2.0, 0, stopper, 0)
        sim, h1 = k.api.schedule(sim, 5.0, 1, logger, 0, 3)
        sim, h2 = k.api.schedule(sim, 5.0, 7, logger, 0, 4)
        sim, h3 = k.api.schedule(sim, 6.0, 0, stamp)
        sim = k.api.set_local_f(sim, p, 0, k.api.clock(sim) + 1.0)
        return sim, k.cmd.exit_()

    m.process("sleeper", entry=sleep)  # pid 0
    m.process("starter", entry=start, prio=3)  # pid 1
    box.append(m.build())
    return box[0]


def overflow_model(k):
    """A table of 2 slots and a block that schedules 3 events: the
    handles 0 and 1 (slot, generation 0), then NULL_HANDLE, kept in the
    starter's ilocals; the replication fails with ERR_EVENT_OVERFLOW."""
    m = k.Model("full", n_ilocals=3, event_cap=2, guard_cap=1)

    @m.handler
    def nothing(sim, subj, arg):
        return sim

    @m.block
    def start(sim, p, sig):
        for i in range(3):
            sim, h = k.api.schedule(sim, 1.0 + i, 0, nothing)
            sim = k.api.set_local_i(sim, p, i, h)
        return sim, k.cmd.exit_()

    m.process("starter", entry=start)
    return m.build()


def _replayed(spec):
    """``spec`` with each block and handler replaced by the replay of its
    trace on the state it is given."""
    def blk(pc):
        def run(sim, p, sig):
            return trace.replay(spec, trace.trace_block(spec, pc, sim), sim,
                                p, sig)
        return run

    def hdl(k_):
        def run(sim, subj, arg):
            return trace.replay(spec, trace.trace_handler(spec, k_, sim),
                                sim, subj, arg)
        return run

    return dataclasses.replace(
        spec, blocks=[blk(pc) for pc in range(len(spec.blocks))],
        user_handlers=[hdl(k_) for k_ in range(len(spec.user_handlers))])


def _run_both(build):
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
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL) == []
    assert interop.diff_leaves(interop.sim_to_numpy(tout),
                               interop.sim_to_numpy(rout), 0.0) == []
    assert np.array_equal(np.asarray(jout.err), tout.err.numpy())
    return tout


def test_handlers_match_reference():
    out = _run_both(handlers_model)
    assert int(out.err.abs().sum()) == 0
    # pid 0 stopped at t=2 (STOPPED), its hold's wake gone: it never
    # reached `woke`, and the last event is the stamp at t=6
    assert bool((out.procs.exit_sig[:, 0] == -3).all())
    assert bool((out.procs.locals_f[:, 0, 0] == 0.0).all())
    assert bool(torch.isinf(out.wakes.time).all())
    assert bool((out.clock == 6.0).all())
    assert out.user["n"].tolist() == [1, 1]
    # priority 7 (argument 4) before priority 1 (argument 3)
    assert out.user["log"].tolist() == [43, 43]
    assert out.user["t"].tolist() == [6.0, 6.0]
    # events: 2 process starts, 4 user events
    assert out.n_events.tolist() == [6, 6]


def test_full_table_gives_null_handle_and_fails():
    out = _run_both(overflow_model)
    assert out.err.tolist() == [tloop.ERR_EVENT_OVERFLOW] * LANES
    assert out.procs.locals_i[:, 0].tolist() == [[0, 1, -1]] * LANES
    assert bool(out.events.overflow.all())
