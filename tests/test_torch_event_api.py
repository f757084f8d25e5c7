"""The event-handle API, the priority queue's cancels and the queues'
positions: the port against cimba_tpu on the reference's scenarios.

Restates ``tests/test_event_api.py`` (``event_reschedule`` keeps the FIFO
seq, a dead handle's reschedule, ``event_reprioritize``, the handle's
getters beside the components' space readers, ``event_pattern_count``,
``_find`` and ``_cancel``, ``pqueue_cancel`` and ``pqueue_reprioritize``
by payload, a cancel freeing a blocked putter) and the queue cases of
``tests/test_positions.py`` (``queue_position`` from the front and
through a wrapped ring, ``pqueue_position`` in dequeue order).  The
reference's user arrays are scalar leaves here.  Each model runs through
``jax.jit(jax.vmap(make_run))`` and the port's ``make_run`` on the CPU
(2 lanes, f64) leaf for leaf (integers exact, floats within 1e-9 of each
leaf's scale) and through a traced replay of its blocks, bit for bit;
the positions are read from both final states, and in a block too.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
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
from cimba_tpu_torch.core import api as tapi
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.tools import usergen

from test_torch_wait_event import replayed

torch.set_num_threads(1)

LANES = 2

JAX = types.SimpleNamespace(
    Model=JModel, cmd=jcmd, api=japi, cr=jcr, where=jnp.where,
    i32=lambda v: jnp.asarray(v, jnp.int32),
    f64=lambda v: jnp.asarray(v, jnp.float64), isinf=jnp.isinf,
    to_f64=lambda x: jnp.asarray(x).astype(jnp.float64))
TORCH = types.SimpleNamespace(
    Model=usergen.torch_lib().Model, cmd=usergen.torch_lib().cmd,
    api=tapi, cr=usergen.torch_lib().cr, where=torch.where,
    i32=lambda v: torch.tensor(v, dtype=torch.int32),
    f64=lambda v: torch.tensor(v, dtype=torch.float64), isinf=torch.isinf,
    to_f64=lambda x: x.to(torch.float64))


def _order_model(k, name="evapi"):
    """Two user events recording their dispatch order and times."""
    m = k.Model(name, event_cap=16)

    @m.user_state
    def init(params):
        return {"h1": k.i32(-1), "h2": k.i32(-1), "o0": k.i32(0),
                "o1": k.i32(0), "t0": k.f64(0.0), "t1": k.f64(0.0),
                "n": k.i32(0)}

    @m.handler
    def mark(sim, subj, arg):
        u = sim.user
        first = u["n"] == 0
        return k.api.set_user(sim, {
            **u,
            "o0": k.where(first, arg, u["o0"]),
            "o1": k.where(first, u["o1"], arg),
            "t0": k.where(first, k.api.clock(sim), u["t0"]),
            "t1": k.where(first, u["t1"], k.api.clock(sim)),
            "n": u["n"] + 1})

    return m, mark


def reschedule_keeps_fifo(k):
    m, mark = _order_model(k)

    @m.block
    def director(sim, p, sig):
        sim, h1 = k.api.schedule(sim, 20.0, 0, mark, arg=1)
        sim, h2 = k.api.schedule(sim, 30.0, 0, mark, arg=2)
        sim, ok = k.api.event_reschedule(sim, h1, 30.0)
        sim = k.api.set_user(sim, {**sim.user, "h1": h1, "h2": h2})
        sim = k.api.fail(sim, ~ok)
        return sim, k.cmd.exit_()

    m.process("director", entry=director, prio=0)
    return m.build()


def check_reschedule_keeps_fifo(out):
    assert out.user["o0"].tolist() == [1] * LANES
    assert out.user["o1"].tolist() == [2] * LANES
    assert out.user["t0"].tolist() == [30.0] * LANES
    assert out.user["t1"].tolist() == [30.0] * LANES


def reschedule_dead_handle(k):
    m, mark = _order_model(k)

    @m.block
    def director(sim, p, sig):
        sim, h1 = k.api.schedule(sim, 20.0, 0, mark, arg=1)
        sim, _ = k.api.event_cancel(sim, h1)
        sim, ok = k.api.event_reschedule(sim, h1, 10.0)
        sim = k.api.fail(sim, ok)
        return sim, k.cmd.exit_()

    m.process("director", entry=director, prio=0)
    return m.build()


def check_reschedule_dead_handle(out):
    assert out.user["n"].tolist() == [0] * LANES


def reprioritize_reorders(k):
    m, mark = _order_model(k)

    @m.block
    def director(sim, p, sig):
        sim, h1 = k.api.schedule(sim, 20.0, 0, mark, arg=1)
        sim, h2 = k.api.schedule(sim, 20.0, 0, mark, arg=2)
        sim, ok = k.api.event_reprioritize(sim, h2, 5)
        sim = k.api.fail(sim, ~ok)
        return sim, k.cmd.exit_()

    m.process("director", entry=director, prio=0)
    return m.build()


def check_reprioritize_reorders(out):
    assert out.user["o0"].tolist() == [2] * LANES
    assert out.user["o1"].tolist() == [1] * LANES


def handle_getters(k):
    m = k.Model("getters", event_cap=16)
    q = m.objectqueue("q", capacity=8, record=False)
    b = m.buffer("b", capacity=20.0, initial=5.0)
    pl = m.resourcepool("pool", capacity=6.0)

    @m.handler
    def noop(sim, subj, arg):
        return sim

    @m.block
    def director(sim, p, sig):
        sim, h = k.api.schedule(sim, 25.0, 3, noop)
        ok = k.api.event_is_scheduled(sim, h)
        ok = ok & (k.api.event_time(sim, h) == 25.0)
        ok = ok & (k.api.event_priority(sim, h) == 3)
        sim, _ = k.api.event_cancel(sim, h)
        ok = ok & ~k.api.event_is_scheduled(sim, h)
        ok = ok & k.isinf(k.api.event_time(sim, h))
        ok = ok & (k.api.queue_space(sim, q) == 8)
        ok = ok & (k.api.buffer_space(sim, b) == 15.0)
        ok = ok & (k.api.pool_in_use(sim, pl) == 0.0)
        ok = ok & (k.api.proc_priority(sim, p) == 2)
        sim = k.api.fail(sim, ~ok)
        return sim, k.cmd.put(q.id, 1.5, next_pc=d2.pc)

    @m.block
    def d2(sim, p, sig):
        ok = k.api.queue_space(sim, q) == 7
        sim = k.api.fail(sim, ~ok)
        return sim, k.cmd.pool_acquire(pl.id, 2.5, next_pc=d3.pc)

    @m.block
    def d3(sim, p, sig):
        ok = (k.api.pool_held(sim, pl, p) == 2.5) & (
            k.api.pool_in_use(sim, pl) == 2.5)
        sim = k.api.fail(sim, ~ok)
        return sim, k.cmd.exit_()

    m.process("director", entry=director, prio=2)
    return m.build()


def pattern_ops(k):
    m, mark = _order_model(k)

    @m.handler
    def other(sim, subj, arg):
        return sim

    @m.block
    def director(sim, p, sig):
        sim, h1 = k.api.schedule(sim, 20.0, 0, mark, subj=3, arg=1)
        sim, h2 = k.api.schedule(sim, 10.0, 0, mark, subj=4, arg=2)
        sim, h3 = k.api.schedule(sim, 5.0, 0, other, subj=3)
        n_mark = k.api.event_pattern_count(sim, kind=mark)
        n_s3 = k.api.event_pattern_count(sim, subj=3)
        n_all = k.api.event_pattern_count(sim)
        ok = (n_mark == 2) & (n_s3 == 2) & (n_all == 3)
        h = k.api.event_pattern_find(sim, kind=mark)
        ok = ok & (h == h2)
        sim, ok2 = k.api.event_reschedule(sim, h, 40.0)
        sim, n_cancelled = k.api.event_pattern_cancel(sim, kind=other)
        ok = ok & ok2 & (n_cancelled == 1) & (
            k.api.event_pattern_count(sim) == 2)
        sim = k.api.fail(sim, ~ok)
        return sim, k.cmd.exit_()

    m.process("director", entry=director, prio=0)
    return m.build()


def check_pattern_ops(out):
    assert out.user["o0"].tolist() == [1] * LANES
    assert out.user["o1"].tolist() == [2] * LANES
    assert out.user["t0"].tolist() == [20.0] * LANES
    assert out.user["t1"].tolist() == [40.0] * LANES


def pq_cancel_reprioritize(k):
    m = k.Model("pqv", event_cap=16)
    pq = m.priorityqueue("pq", capacity=8, record=True)

    @m.user_state
    def init(params):
        return {"g0": k.f64(0.0), "g1": k.f64(0.0), "n": k.i32(0)}

    @m.block
    def director(sim, p, sig):
        return sim, k.cmd.pq_put(pq.id, 10.0, 1.0, next_pc=d2.pc)

    @m.block
    def d2(sim, p, sig):
        return sim, k.cmd.pq_put(pq.id, 20.0, 2.0, next_pc=d3.pc)

    @m.block
    def d3(sim, p, sig):
        return sim, k.cmd.pq_put(pq.id, 30.0, 3.0, next_pc=d4.pc)

    @m.block
    def d4(sim, p, sig):
        sim, existed = k.api.pqueue_cancel(sim, pq, 20.0)
        sim = k.api.fail(sim, ~existed)
        sim, _ = k.api.pqueue_cancel(sim, pq, 99.0)
        sim, ok2 = k.api.pqueue_reprioritize(sim, pq, 10.0, 9.0)
        sim = k.api.fail(sim, ~ok2)
        sim = k.api.fail(sim, k.api.pqueue_length(sim, pq) != 2)
        return sim, k.cmd.pq_get(pq.id, next_pc=take.pc)

    @m.block
    def take(sim, p, sig):
        u = sim.user
        first = u["n"] == 0
        g = k.api.got(sim, p)
        sim = k.api.set_user(sim, {
            "g0": k.where(first, g, u["g0"]),
            "g1": k.where(first, u["g1"], g), "n": u["n"] + 1})
        return sim, k.cmd.select(u["n"] + 1 >= 2, k.cmd.exit_(),
                                 k.cmd.pq_get(pq.id, next_pc=take.pc))

    m.process("director", entry=director, prio=0)
    return m.build()


def check_pq_cancel_reprioritize(out):
    assert out.user["g0"].tolist() == [10.0] * LANES
    assert out.user["g1"].tolist() == [30.0] * LANES


def pq_cancel_frees_putter(k):
    m = k.Model("pqw", n_ilocals=1, event_cap=16)
    pq = m.priorityqueue("pq", capacity=2, record=False)

    @m.block
    def filler(sim, p, sig):
        return sim, k.cmd.pq_put(pq.id, 1.0, 0.0, next_pc=f2.pc)

    @m.block
    def f2(sim, p, sig):
        return sim, k.cmd.pq_put(pq.id, 2.0, 0.0, next_pc=f3.pc)

    @m.block
    def f3(sim, p, sig):
        return sim, k.cmd.pq_put(pq.id, 3.0, 0.0, next_pc=f_done.pc)

    @m.block
    def f_done(sim, p, sig):
        sim = k.api.set_local_i(sim, p, 0, 1)
        return sim, k.cmd.exit_()

    @m.block
    def canceller(sim, p, sig):
        return sim, k.cmd.hold(5.0, next_pc=c2.pc)

    @m.block
    def c2(sim, p, sig):
        sim, existed = k.api.pqueue_cancel(sim, pq, 1.0)
        sim = k.api.fail(sim, ~existed)
        return sim, k.cmd.exit_()

    m.process("filler", entry=filler, prio=1)
    m.process("canceller", entry=canceller, prio=0)
    return m.build()


def check_pq_cancel_frees_putter(out):
    assert out.procs.locals_i[:, 0, 0].tolist() == [1] * LANES
    assert out.clock.tolist() == [5.0] * LANES


def _producer(k, name, items, n_ilocals=2, pq=False):
    """A producer putting ``items`` into its queue, then reading each
    item's position in a block into its integer local 1 (the reader in
    a block: its trace's node)."""
    m = k.Model(name, n_ilocals=n_ilocals, event_cap=16)
    q = (m.priorityqueue("pq", capacity=8, record=False) if pq
         else m.objectqueue("q", capacity=8, record=False))

    @m.block
    def produce(sim, p, sig):
        kk = k.api.local_i(sim, p, 0)
        done = kk >= len(items)
        sim = k.api.add_local_i(sim, p, 0, 1)
        def pick(vals):
            out = k.f64(vals[-1])
            for j in reversed(range(len(vals) - 1)):
                out = k.where(kk == j, vals[j], out)
            return out

        if pq:
            put = k.cmd.pq_put(q.id, pick([x for x, _ in items]),
                               pick([y for _, y in items]),
                               next_pc=produce.pc)
            look = k.api.pqueue_position(sim, q, 30.0)
        else:
            put = k.cmd.put(q.id, pick(items), next_pc=produce.pc)
            look = k.api.queue_position(sim, q, 5.0)
        sim = k.api.set_local_i(sim, p, 1, look)
        return sim, k.cmd.select(done, k.cmd.exit_(), put)

    m.process("producer", entry=produce)
    return m.build(), q


def objectqueue_positions(k):
    return _producer(k, "posq", [5.0, 7.0, 5.0, 9.0])[0]


def pqueue_positions(k):
    return _producer(k, "pospq", [(10.0, 1.0), (20.0, 5.0), (30.0, 5.0),
                                  (40.0, 0.0)], pq=True)[0]


def wrapped_ring(k):
    """fill 4, drain 2, add 2: the ring's head has wrapped; the block
    reads the position of 5.0 into its local 1 on the way."""
    m = k.Model("wrapq", n_ilocals=2, event_cap=16)
    q = m.objectqueue("q", capacity=4, record=False)

    @m.block
    def drive(sim, p, sig):
        kk = k.api.local_i(sim, p, 0)
        sim = k.api.add_local_i(sim, p, 0, 1)
        sim = k.api.set_local_i(sim, p, 1, k.api.queue_position(sim, q,
                                                                 5.0))
        return sim, k.cmd.select(
            kk < 4,
            k.cmd.put(q.id, k.to_f64(kk + 1), next_pc=drive.pc),
            k.cmd.select(
                kk < 6, k.cmd.get(q.id, next_pc=drive.pc),
                k.cmd.select(kk < 8, k.cmd.put(q.id, k.to_f64(kk - 1),
                                               next_pc=drive.pc),
                             k.cmd.exit_())))

    m.process("drive", entry=drive)
    return m.build()


SCENARIOS = {
    "reschedule_keeps_fifo": (reschedule_keeps_fifo,
                              check_reschedule_keeps_fifo),
    "reschedule_dead_handle": (reschedule_dead_handle,
                               check_reschedule_dead_handle),
    "reprioritize_reorders": (reprioritize_reorders,
                              check_reprioritize_reorders),
    "handle_getters": (handle_getters, lambda out: None),
    "pattern_ops": (pattern_ops, check_pattern_ops),
    "pq_cancel_reprioritize": (pq_cancel_reprioritize,
                               check_pq_cancel_reprioritize),
    "pq_cancel_frees_putter": (pq_cancel_frees_putter,
                               check_pq_cancel_frees_putter),
}


def run_both(build, seed=0):
    with jconfig.profile("f64"):
        jspec = build(JAX)
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(jspec, seed, r)))(
            jnp.arange(LANES))
        jout = jax.jit(jax.vmap(jloop.make_run(jspec)))(js)
    with tconfig.profile("f64"):
        tspec = build(TORCH)
        ts = tloop.init_sim(tspec, seed, torch.arange(LANES), device="cpu")
        tout = tloop.make_run(tspec)(ts)
        rout = tloop.make_run(replayed(tspec))(ts)
    assert int(np.abs(np.asarray(jout.err)).sum()) == 0
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), 1e-9) == []
    assert interop.diff_leaves(interop.sim_to_numpy(tout),
                               interop.sim_to_numpy(rout), 0.0) == []
    assert int(tout.err.abs().sum()) == 0
    return jout, tout


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name):
    build, check = SCENARIOS[name]
    check(run_both(build)[1])


@pytest.mark.parametrize("name,want", [
    ("objectqueue", [(5.0, 1), (7.0, 2), (9.0, 4), (42.0, 0)]),
    ("wrapped", [(3.0, 1), (4.0, 2), (5.0, 3), (6.0, 4), (1.0, 0)]),
    ("pqueue", [(20.0, 1), (30.0, 2), (10.0, 3), (40.0, 4), (77.0, 0)]),
])
def test_positions_match_reference(name, want):
    """Each item's position in both final states equal to the
    reference's documented one (positions.py's cases), and the
    position a block read on the way, leaf for leaf."""
    build = {"objectqueue": objectqueue_positions, "wrapped": wrapped_ring,
             "pqueue": pqueue_positions}[name]
    jout, tout = run_both(build)
    read = {"pqueue": (japi.pqueue_position, tapi.pqueue_position)}.get(
        name, (japi.queue_position, tapi.queue_position))
    for item, pos in want:
        jp = [int(read[0](jax.tree.map(lambda x: x[i], jout), 0, item))
              for i in range(LANES)]
        tp = read[1](tout, 0, item).tolist()
        assert jp == tp == [pos] * LANES, (item, jp, tp)
