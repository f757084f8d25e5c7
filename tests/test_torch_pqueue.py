"""The priority queue: the port against cimba_tpu.

* The reference's ``test_toolkit.py::test_priorityqueue_order`` scenario
  (three puts at priorities 1, 5, 5, then three gets: the highest
  priority first, FIFO within a priority) built once per package from
  the same code and run through ``jax.jit(jax.vmap(make_run))`` and the
  port's ``make_run`` (2 lanes), leaf for leaf with
  ``interop.diff_leaves``.
* A producer/consumer model over a recording priority queue of four
  slots (random priorities, puts that block on a full queue and retry,
  the fused ``pq_get_hold``) whose watcher keeps ``pqueue_length`` and
  ``pqueue_position`` of a fixed item in user leaves: leaf for leaf in
  both profiles (integers exact, floats within 1e-12 in f64 and 2e-5 in
  f32).
* ``api.pqueue_length`` and ``api.pqueue_position`` on fuzzed queue
  states (duplicate payloads, tied priorities, NaN-free) against the
  reference's functions, lane by lane.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cimba_tpu.random as jcr
import cimba_tpu_torch.random as tcr
from cimba_tpu import config as jconfig
from cimba_tpu.core import api as japi
from cimba_tpu.core import loop as jloop
from cimba_tpu.core import process as jcmd
from cimba_tpu.core.model import Model as JModel
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import api as tapi
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.core import process as tcmd
from cimba_tpu_torch.core.model import Model as TModel

torch.set_num_threads(1)

RTOL = {"f64": 1e-12, "f32": 2e-5}
LANES = 2

JAX = types.SimpleNamespace(
    Model=JModel, cmd=jcmd, api=japi, cr=jcr,
    zeros_i=lambda: jnp.zeros((), jnp.int32),
    real=lambda x: jnp.asarray(x, jconfig.REAL), floor=jnp.floor,
    i32=lambda x: jnp.asarray(x).astype(jnp.int32))
TORCH = types.SimpleNamespace(
    Model=TModel, cmd=tcmd, api=tapi, cr=tcr,
    zeros_i=lambda: torch.zeros((), dtype=INDEX),
    real=lambda x: x.to(tconfig.real()), floor=torch.floor,
    i32=lambda x: x.to(INDEX))


def order(k):
    """Puts of 10 (prio 1), 20 (prio 5), 30 (prio 5); a consumer that
    starts at t=1 gets 20, 30, 10."""
    m = k.Model("pq", n_flocals=3, event_cap=16, guard_cap=4)
    pq = m.priorityqueue("jobs", capacity=8)

    @m.block
    def put_a(sim, p, sig):
        return sim, k.cmd.pq_put(pq.id, 10.0, 1.0, next_pc=put_b.pc)

    @m.block
    def put_b(sim, p, sig):
        return sim, k.cmd.pq_put(pq.id, 20.0, 5.0, next_pc=put_c.pc)

    @m.block
    def put_c(sim, p, sig):
        return sim, k.cmd.pq_put(pq.id, 30.0, 5.0, next_pc=pdone.pc)

    @m.block
    def pdone(sim, p, sig):
        return sim, k.cmd.exit_()

    @m.block
    def delay(sim, p, sig):
        return sim, k.cmd.hold(1.0, next_pc=take0.pc)

    @m.block
    def store0(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 0, k.api.got(sim, p))
        return sim, k.cmd.pq_get(pq.id, next_pc=store1.pc)

    @m.block
    def store1(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 1, k.api.got(sim, p))
        return sim, k.cmd.pq_get(pq.id, next_pc=store2.pc)

    @m.block
    def store2(sim, p, sig):
        sim = k.api.set_local_f(sim, p, 2, k.api.got(sim, p))
        return sim, k.cmd.exit_()

    @m.block
    def take0(sim, p, sig):
        return sim, k.cmd.pq_get(pq.id, next_pc=store0.pc)

    m.process("producer", entry=put_a)
    m.process("consumer", entry=delay)
    return m.build()


def readers(k):
    """Two producers put 12 items each, payload = their item count, at a
    random priority in {0, 1, 2} into four slots (a full queue blocks
    them); a consumer takes with a fused hold; a watcher keeps the
    queue's length and the place of payload 3.0 at every event of its."""
    m = k.Model("pqread", n_ilocals=1, event_cap=8, guard_cap=4)
    pq = m.priorityqueue("line", capacity=4, record=True)

    @m.user_state
    def init(params):
        return {"len": k.zeros_i(), "pos": k.zeros_i(),
                "len_sum": k.zeros_i(), "pos_sum": k.zeros_i()}

    @m.block
    def produce(sim, p, sig):
        n = k.api.local_i(sim, p, 0)
        sim = k.api.add_local_i(sim, p, 0, 1)
        sim, u = k.api.draw(sim, k.cr.uniform01)
        put = k.cmd.pq_put(pq.id, k.real(n), k.floor(u * 3.0),
                           next_pc=p_wait.pc)
        return sim, k.cmd.select(n >= 12, k.cmd.exit_(), put)

    @m.block
    def p_wait(sim, p, sig):
        sim, t = k.api.draw(sim, k.cr.exponential, 0.6)
        return sim, k.cmd.hold(t, next_pc=produce.pc)

    @m.block
    def consume(sim, p, sig):
        sim, t = k.api.draw(sim, k.cr.exponential, 1.0)
        return sim, k.cmd.pq_get_hold(pq.id, t, next_pc=consume.pc)

    @m.block
    def watch(sim, p, sig):
        ln = k.i32(k.api.pqueue_length(sim, pq))
        pos = k.api.pqueue_position(sim, pq, 3.0)
        u = sim.user
        sim = k.api.set_user(sim, {
            "len": ln, "pos": pos, "len_sum": u["len_sum"] + ln,
            "pos_sum": u["pos_sum"] + pos})
        done = k.api.clock(sim) > 30.0
        return sim, k.cmd.select(done, k.cmd.exit_(),
                                 k.cmd.hold(0.5, next_pc=watch.pc))

    m.process("producer", entry=produce, count=2)
    m.process("consumer", entry=consume)
    m.process("watcher", entry=watch, prio=1)
    return m.build()


def _run_both(build, prof, t_end=None):
    with jconfig.profile(prof):
        jspec = build(JAX)
        js = jax.vmap(lambda r: jloop.init_sim(jspec, 3, r))(
            jnp.arange(LANES))
        jout = jax.jit(jax.vmap(jloop.make_run(jspec, t_end=t_end)))(js)
    with tconfig.profile(prof):
        tspec = build(TORCH)
        ts = tloop.init_sim(tspec, 3, torch.arange(LANES), device="cpu")
        tout = tloop.make_run(tspec, t_end=t_end)(ts)
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    assert int(tout.err.abs().sum()) == 0
    return tout


def test_priorityqueue_order_matches_reference():
    out = _run_both(order, "f64")
    np.testing.assert_array_equal(out.procs.locals_f[:, 1, :].numpy(),
                                  [[20.0, 30.0, 10.0]] * LANES)


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_readers_model_matches_reference(prof):
    out = _run_both(readers, prof, t_end=40.0)
    # the queue filled (its puts blocked), and payload 3.0 was seen queued
    assert int(out.user["len_sum"].sum()) > 0
    assert int(out.user["pos_sum"].sum()) > 0
    assert bool((out.pqueues.acc.summary.n > 0).all())


def _fuzzed_queue(rng, width):
    live = rng.random(width) < 0.7
    items = rng.integers(0, 4, width).astype(np.float64)
    prio = rng.integers(0, 3, width).astype(np.float64)
    seq = rng.permutation(width).astype(np.int32)
    return live, items, prio, seq


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_readers_on_fuzzed_queues(prof):
    rng = np.random.default_rng(2026)
    lanes, width = 64, 9
    qs = [_fuzzed_queue(rng, width) for _ in range(lanes)]
    real = {"f64": torch.float64, "f32": torch.float32}[prof]
    t = tloop.PQueues(
        items=torch.tensor(np.stack([q[1] for q in qs]))[:, None].to(real),
        prio=torch.tensor(np.stack([q[2] for q in qs]))[:, None].to(real),
        seq=torch.tensor(np.stack([q[3] for q in qs]))[:, None],
        live=torch.tensor(np.stack([q[0] for q in qs]))[:, None],
        next_seq=torch.zeros((lanes, 1), dtype=INDEX))
    tsim = types.SimpleNamespace(pqueues=t)
    for item in (0.0, 1.0, 2.0, 3.0, 7.0):
        tl = tapi.pqueue_length(tsim, 0)
        tp = tapi.pqueue_position(tsim, 0, item)
        with jconfig.profile(prof):
            for ln in range(lanes):
                live, items, prio, seq = qs[ln]
                jq = jloop.PQueues(
                    items=jnp.asarray(items, jconfig.REAL)[None],
                    prio=jnp.asarray(prio, jconfig.REAL)[None],
                    seq=jnp.asarray(seq)[None], live=jnp.asarray(live)[None],
                    next_seq=jnp.zeros((1,), jnp.int32), acc=None)
                jsim = types.SimpleNamespace(pqueues=jq)
                jl = japi.pqueue_length(jsim, 0)
                assert np.dtype(jl.dtype) == tl.numpy().dtype
                assert int(jl) == int(tl[ln])
                assert int(japi.pqueue_position(jsim, 0, item)) == int(
                    tp[ln]), (ln, item)
