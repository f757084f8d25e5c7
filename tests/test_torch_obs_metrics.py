"""The metrics registry (``cimba_tpu_torch.obs.metrics``) against the
reference's (``tests/test_metrics.py``'s cases).

Tutorial 1's M/M/1 (2 lanes, seed 2026, to t=40) and mm1 (3 lanes of 20
objects, whose object queue gives ``queue_hwm`` and guard retries), f64:
the port's plain engine against ``jax.jit(jax.vmap(make_run))``, every
registry leaf equal, and the pooled snapshots equal.  Then the algebra:
pooled counters equal the per-lane sums and the gauges the per-lane
maxima, ``events_dispatched`` equals ``n_events``, ``merge`` does not
depend on order, and a stream's wave-by-wave fold
(``run_experiment_stream(...).metrics``) equals the pool of the
monolithic run's lanes.  ``pool_across`` pools the shards' registries
as their lanes pool; a Sim with a registry is refused by a kernel build.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu.core import loop as jloop
from cimba_tpu.models import mm1 as jmm1
from cimba_tpu.obs import metrics as jmetrics
from cimba_tpu_torch import tree
from cimba_tpu_torch.core import kernel_run, loop
from cimba_tpu_torch.examples import tut_1_mm1
from cimba_tpu_torch.models import mm1
from cimba_tpu_torch.obs import metrics as om
from cimba_tpu_torch.runner import experiment as ex
from examples import tut_1_mm1 as jtut1

torch.set_num_threads(1)


@pytest.fixture
def obs_off():
    yield
    om.disable()
    jmetrics.disable()


CASES = {
    "tut1": (lambda: jtut1.build()[0], lambda: tut_1_mm1.build()[0], None,
             2026, 2, 40.0),
    "mm1": (lambda: jmm1.build(record=False)[0],
            lambda: mm1.build(record=False)[0], 20, 9, 3, None),
}


@functools.lru_cache(maxsize=None)
def ref_run(name):
    build, _, n, seed, lanes, t_end = CASES[name]
    jmetrics.enable()
    try:
        spec = build()
        params = None if n is None else jmm1.params(n)
        run = jloop.make_run(spec, t_end=t_end)
        sims = jax.jit(jax.vmap(lambda r: run(
            jloop.init_sim(spec, seed, r, params))))(jnp.arange(lanes))
        snap = jmetrics.snapshot(jax.jit(jmetrics.pool)(sims.metrics), spec)
        return ({f: np.asarray(getattr(sims.metrics, f))
                 for f in sims.metrics._fields}, snap,
                np.asarray(sims.n_events))
    finally:
        jmetrics.disable()


def port_run(name):
    _, build, n, seed, lanes, t_end = CASES[name]
    om.enable()
    try:
        spec = build()
        params = None if n is None else mm1.params(n)
        sims = loop.make_run(spec, t_end=t_end)(loop.init_sim(
            spec, seed, torch.arange(lanes), params, device="cpu"))
    finally:
        om.disable()
    return spec, sims


@pytest.mark.parametrize("name", ["tut1", "mm1"])
def test_registry_equals_reference(obs_off, name):
    want, want_snap, n_events = ref_run(name)
    spec, sims = port_run(name)
    m = sims.metrics
    for f in m._fields:
        got = getattr(m, f).numpy()
        assert got.dtype == want[f].dtype and np.array_equal(got, want[f]), f
    assert np.array_equal(sims.n_events.numpy(), n_events)
    pooled = om.pool(m)
    assert om.snapshot(pooled, spec) == want_snap
    # pooled counters are the per-lane sums, gauges the per-lane maxima
    assert torch.equal(pooled.dispatch_by_kind, m.dispatch_by_kind.sum(0))
    assert int(pooled.guard_retries) == int(m.guard_retries.sum())
    assert torch.equal(pooled.queue_hwm, m.queue_hwm.amax(0))
    assert int(pooled.event_hwm) == int(m.event_hwm.max())
    assert torch.equal(pooled.chain_hist, m.chain_hist.sum(0))
    assert int(om.events_dispatched(pooled)) == int(sims.n_events.sum())
    assert pooled.dispatch_by_kind.dtype == m.dispatch_by_kind.dtype
    if name == "mm1":
        assert int(pooled.queue_hwm.max()) > 0
        assert int(pooled.guard_retries) > 0


def test_merge_order_independent(obs_off):
    _, sims = port_run("mm1")
    lanes = [om.pool(tree.map(lambda x: x[i:i + 1], sims.metrics))
             for i in range(3)]
    fwd = om.merge(om.merge(lanes[0], lanes[1]), lanes[2])
    back = om.merge(lanes[2], om.merge(lanes[1], lanes[0]))
    whole = om.pool(sims.metrics)
    for a, b, c in zip(fwd, back, whole):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_stream_folds_the_registry(obs_off):
    spec = mm1.build(record=False)[0]
    om.enable()
    try:
        st = ex.run_experiment_stream(spec, mm1.params(15), 8, wave_size=3,
                                      seed=4, chunk_steps=16, device="cpu")
        mono = ex.run_experiment(spec, mm1.params(15), 8, seed=4,
                                 device="cpu").sims
        res, report = ex.run_experiment(spec, mm1.params(15), 8, seed=4,
                                        device="cpu", with_report=True)
    finally:
        om.disable()
    for a, b in zip(st.metrics, om.pool(mono.metrics)):
        assert torch.equal(a, b)
    assert report.metrics == om.snapshot(om.pool(mono.metrics), spec)
    # the folded registry counts every event of the stream
    assert st.metrics.dispatch_by_kind.sum() == st.total_events


def test_pool_across_and_kernel_refusal(obs_off):
    # pool_across is ported with the mesh: the shards' registries pool
    # as their lanes would (sums and maxima)
    with pytest.raises(ValueError, match="no shards"):
        om.pool_across([], "rep")
    a = om.create(3, 2, (4,), "cpu")
    a = a._replace(dispatch_by_kind=torch.arange(12).reshape(4, 3).to(
        a.dispatch_by_kind.dtype), queue_hwm=torch.tensor(
        [[1, 5], [2, 0], [7, 1], [0, 3]], dtype=a.queue_hwm.dtype))
    whole = om.pool(a)
    parts = [om.pool(om.Metrics(*[x[i:i + 2] for x in a])) for i in (0, 2)]
    for x, y in zip(om.pool_across(parts, "rep"), whole):
        assert torch.equal(x, y)
    om.enable()
    spec = mm1.build(record=False)[0]
    s = loop.init_sim(spec, 1, torch.arange(2), mm1.params(5), device="cpu")
    with pytest.raises(RuntimeError, match="metrics registry"):
        kernel_run.kernel_for(spec, s)
    with pytest.raises(RuntimeError, match="run_experiment_chunked on the"):
        ex._refuse_observed(torch.device("cuda"), "run_experiment_chunked")
