"""The port's lane-batched engine against cimba_tpu's, on mm1.

Same spec, seed and parameters through ``jax.jit(jax.vmap(make_run))``
and the port's ``make_run`` on the CPU, in both profiles.  Every integer
and bool leaf (n_events, err, pcs, queue sizes and heads, RNG counters,
wake seqs, ...) must be equal — event order included.  Float leaves
carry the samplers' log1p differences (test_torch_random.py): f64 within
1e-9 of each leaf's scale (the bound tests/test_native.py puts on the C++
oracle's clock), f32 within 64 ulp of it (the wait moments are sums over
~100 samples of values that already differ by an ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import loop as jloop
from cimba_tpu.models import mm1 as jmm1
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.models import mm1 as tmm1

RTOL = {"f64": 1e-9, "f32": 64 * 2.0**-23}


def _both(prof, lanes, n_objects, queue_cap, max_steps=None, seed=2026):
    with jconfig.profile(prof), tconfig.profile(prof):
        jspec, _ = jmm1.build(record=False, queue_cap=queue_cap)
        tspec, _ = tmm1.build(record=False, queue_cap=queue_cap)
        js = jax.jit(jax.vmap(
            lambda r: jloop.init_sim(jspec, seed, r, jmm1.params(n_objects))
        ))(jnp.arange(lanes))
        jout = jax.jit(jax.vmap(jloop.make_run(jspec, max_steps=max_steps)))(js)
        ts = tloop.init_sim(tspec, seed, torch.arange(lanes),
                            tmm1.params(n_objects), device="cpu")
        tout = tloop.make_run(tspec, max_steps=max_steps)(ts)
    return js, ts, jout, tout


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_mm1_matches_reference(prof):
    js, ts, jout, tout = _both(prof, 64, 100, 128)
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    bad = interop.diff_leaves(jax.tree.leaves(jout),
                              interop.sim_to_numpy(tout), RTOL[prof])
    assert bad == []
    assert int(tout.err.abs().sum()) == 0
    assert int(tout.n_events.sum()) == int(np.asarray(jout.n_events).sum())
    assert tout.n_events.dtype == (torch.int64 if prof == "f64"
                                   else torch.int32)
    assert bool(tout.done.all())


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_blocking_puts_and_chunk_bound_match(prof):
    """A 3-slot queue makes the arrival pend on the rear guard and retry;
    max_steps cuts the run mid-flight, where pends are live."""
    _, _, jout, tout = _both(prof, 32, 60, 3, max_steps=70)
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    assert int((tout.procs.pend_tag[:, 0] >= 0).sum()) > 0  # live put pends
    _, _, jout, tout = _both(prof, 32, 60, 3)
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []


def test_horizon_matches():
    """A finite t_end stops every lane at the same event in both."""
    with jconfig.profile("f64"), tconfig.profile("f64"):
        jspec, _ = jmm1.build(record=False)
        tspec, _ = tmm1.build(record=False)
        js = jax.jit(jax.vmap(
            lambda r: jloop.init_sim(jspec, 5, r, jmm1.params(500))
        ))(jnp.arange(16))
        jout = jax.jit(jax.vmap(jloop.make_run(jspec, t_end=40.0)))(js)
        ts = tloop.init_sim(tspec, 5, torch.arange(16), tmm1.params(500),
                            device="cpu")
        tout = tloop.make_run(tspec, t_end=40.0)(ts)
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), 1e-9) == []
    assert float(tout.clock.max()) <= 40.0


def test_unported_features_raise():
    from cimba_tpu_torch.core.model import Model

    tmm1.build()  # record=True: queue-length recording is ported
    m = Model("x")
    # pools, buffers and conditions are ported (the job shop's toolkit),
    # priority queues, binary resources and user event handlers too
    m.resourcepool("p", 2.0)
    m.buffer("b", 1.0)
    m.condition("c", lambda sim, p: True)
    assert m.priorityqueue("q", 4).capacity == 4
    assert m.resource("r").guard == 6  # after the pq's two

    def blk(sim, p, sig):
        return sim, None

    assert m.handler(blk).kind == 2
    # spawn pools too: their rows are declared, CREATED until api.spawn
    pt = m.process("s", entry=m.block(blk), count=3, start=False)
    assert not pt.start and pt.count == 3
    # per-lane horizons (Sim.t_stop) too: make_cond reads the leaf in
    # place of t_end (tests/test_torch_horizon.py holds them)
    m.build()
    spec, _ = tmm1.build()
    s = tloop.init_sim(spec, 1, torch.arange(2), tmm1.params(5),
                       t_stop=torch.tensor([5.0, -float("inf")]),
                       device="cpu")
    assert tloop.make_cond(spec)(s).tolist() == [True, False]
