"""The job shop: the port against cimba_tpu.

``jobshop.build()`` (and, in the files beside this one,
``jobshop.build(backlog=4.0)`` and the f32 profile) through
``jax.jit(jax.vmap(make_run))`` and the port's ``make_run`` on the CPU
(10 lanes, 40 jobs), leaf for leaf with ``interop.diff_leaves``, the
pool's and the buffer's leaves and recording accumulators included:
every integer and bool leaf equal, so the event order is the
reference's; floats within 1e-9 of each leaf's scale in f64 (the
samplers' log1p) and 2e-5 in f32 (XLA fuses some multiply-adds).  One
compiled reference chunk of K events serves the truncated run and, called
until no lane is live, the whole run.  Here also: the reference's golden
run (tests/test_golden.py) on the port's plain engine, a reference state
carried in through ``interop``, ``run_experiment`` on the CPU, and the
kernel layout of the job-shop family.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import loop as jloop
from cimba_tpu.models import jobshop as jjobshop
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import api, kernel_run
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.models import jobshop as tjobshop
from cimba_tpu_torch.runner import experiment

torch.set_num_threads(1)

K = 97  # events a chunk; the truncated run is one chunk
RTOL = {"f64": 1e-9, "f32": 2e-5}
LANES, N = 10, 40


@functools.lru_cache(maxsize=None)
def ref_run(prof, backlog):
    """The reference's initial state, its first chunk of K events and its
    run to the end, from one compiled chunk."""
    with jconfig.profile(prof):
        spec, _ = jjobshop.build(backlog=backlog)
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(
            spec, 2026, r, jjobshop.params(N))))(jnp.arange(LANES))
        chunk = jax.jit(jax.vmap(jloop.make_run(spec, max_steps=K)))
        cond = jax.jit(jax.vmap(jloop.make_cond(spec)))
        first = out = chunk(js)
        while bool(cond(out).any()):
            out = chunk(out)
    return js, first, out


def port_run(prof, backlog, max_steps=None):
    with tconfig.profile(prof):
        spec, _ = tjobshop.build(backlog=backlog)
        ts = tloop.init_sim(spec, 2026, torch.arange(LANES),
                            tjobshop.params(N), device="cpu")
        return ts, tloop.make_run(spec, max_steps=max_steps)(ts)


def check_matches_reference(prof, backlog):
    js, _, jout = ref_run(prof, backlog)
    ts, tout = port_run(prof, backlog)
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    assert int(tout.err.abs().sum()) == 0 and bool(tout.done.all())
    assert bool((tout.user["done"].n == N).all())
    assert bool((tout.pools.level == 3.0).all())
    assert bool(tout.pools.acc.started.all())
    assert bool(tout.buffers.acc.started.all())
    return tout


def check_truncated_run(prof, backlog):
    _, jfirst, _ = ref_run(prof, backlog)
    _, tout = port_run(prof, backlog, max_steps=K)
    assert interop.diff_leaves(jax.tree.leaves(jfirst),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    assert not bool(tout.done.any())


def test_matches_reference():
    check_matches_reference("f64", 8.0)


def test_truncated_run_matches_reference():
    check_truncated_run("f64", 8.0)


def test_carried_state_finishes_as_reference():
    """The reference's state after one chunk of K events (lanes pending
    on the pool, the buffer and the condition among them), carried into
    the port by ``interop.sim_from_numpy``, run to the end by the port:
    the reference's end state."""
    _, first, jout = ref_run("f64", 8.0)
    with tconfig.profile("f64"):
        spec, _ = tjobshop.build()
        ts = interop.sim_from_numpy(
            [np.asarray(x) for x in jax.tree.leaves(first)], spec,
            tjobshop.params(N), device="cpu")
        assert bool((ts.procs.pend_tag >= 0).any())
        tout = tloop.make_run(spec)(ts)
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL["f64"]) == []


def test_golden_run():
    """tests/test_golden.py's job shop (seed 777, replication 11,
    params(120)) on the port's plain engine, within that test's
    tolerances."""
    with tconfig.profile("f64"):
        spec, _ = tjobshop.build()
        s = tloop.init_sim(spec, 777, torch.tensor([11]),
                           tjobshop.params(120), device="cpu")
        out = tloop.make_run(spec)(s)
    assert int(out.err[0]) == 0
    np.testing.assert_allclose(float(out.clock[0]), 186.45856514611054,
                               rtol=1e-12)
    assert int(out.n_events[0]) == 473
    w = tjobshop.summary_path(out)
    np.testing.assert_allclose(float(w.m1[0]), 97.12698622241122, rtol=1e-12)
    np.testing.assert_allclose(float(w.m2[0]), 328903.1741311248, rtol=1e-9)
    np.testing.assert_allclose(float(w.mn[0]), 1.391091807326474,
                               rtol=1e-12)
    np.testing.assert_allclose(float(w.mx[0]), 186.45856514611054,
                               rtol=1e-12)


def test_run_experiment_on_cpu_pools_done():
    """``run_experiment(..., device="cpu")`` runs the job shop on the
    plain engine; its pooled statistic is ``jobshop.summary_path``; the
    buffer's level and space read from the result."""
    spec, refs = tjobshop.build()
    res = experiment.run_experiment(spec, tjobshop.params(20), 4, seed=3,
                                    device="cpu")
    assert int(res.n_failed) == 0 and res.launches == 0
    pooled = experiment.pooled_summary(tjobshop.summary_path(res.sims))
    assert float(pooled.n) == 4 * 20
    level = api.buffer_level(res.sims, refs["wip"])
    assert torch.equal(api.buffer_space(res.sims, refs["wip"]), 20.0 - level)
    with pytest.raises(TypeError):
        api.buffer_space(res.sims, refs["wip"].id)
    assert experiment.default_summary_path is not tjobshop.summary_path
    assert tjobshop.params(400) == jjobshop.params(400)


def test_no_card_no_fallback(monkeypatch):
    """Without a card a job-shop run that does not ask for the CPU
    raises; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, _ = tjobshop.build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        experiment.run_experiment(spec, tjobshop.params(5), 2, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.init_sim(spec, 1, torch.arange(2), tjobshop.params(5))


def test_kernel_layout_and_refusals():
    """``kernel_for`` gives the job shop's layout and leaf table; a job
    shop of another structure is refused by the hand-written families
    (its kernel is the generated one)."""
    from cimba_tpu_torch import tree
    from cimba_tpu_torch.core import process as cmd
    from cimba_tpu_torch.core.model import Model

    spec, _ = tjobshop.build(backlog=4.0, b_slow=2.0)
    lay, kernel, table = kernel_run.kernel_for(spec)
    assert kernel is kernel_run.queue_chunk
    assert (lay["family"], lay["P"], lay["G"], lay["Q"], lay["K"],
            lay["V"]) == ("shop", 4, 4, 0, 1, 1)
    assert (lay["pool_cap"], lay["buf_cap"], lay["backlog"],
            lay["b_slow"]) == (3.0, 20.0, 4.0, 2.0)
    entry, shape = kernel_run.queue_entry(lay)
    assert entry == "shop_chunk" and shape[2:] == (3.0, 20.0, 4.0, 2.0)
    s = tloop.init_sim(spec, 1, torch.arange(3), tjobshop.params(5),
                       device="cpu")
    assert len(table) == len(tree.leaves(s)) == 79
    assert kernel_run._check_leaves(tree.leaves(s), table, lay,
                                    s.clock.dtype, s.n_events.dtype) == 3
    assert tjobshop.BLOCK_NAMES == tuple(b.__name__ for b in spec.blocks)
    # the job shop's blocks with a recording-off buffer: no instance
    m = Model("jobshop", n_ilocals=1, event_cap=1)
    m.buffer("wip", capacity=20.0, record=False)
    m.resourcepool("crew", capacity=3.0)
    m.condition("backlog", lambda sim, p: sim.buffers.level[:, 0] >= 8.0)
    blocks = []
    for name in tjobshop.BLOCK_NAMES:
        def blk(sim, p, sig):
            return sim, cmd.exit_()
        blk.__name__, blk.__module__ = name, tjobshop.__name__
        blocks.append(m.block(blk))
    m.process("stageA", entry=blocks[0])
    fake = m.build()
    assert kernel_run._queue_family(fake) is None
    with pytest.raises(NotImplementedError, match="hand-written families"):
        kernel_run.queue_layout(fake)
