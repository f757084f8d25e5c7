"""The tandem Jackson network: the port against cimba_tpu.

``tandem.build()`` with the sweep grid's per-lane parameters (every
cell of ``tandem.sweep_grid``, lanes cell-major) through
``jax.jit(jax.vmap(make_run))`` and the port's ``make_run`` on the CPU
(12 lanes, 60 external customers, both profiles), leaf for leaf with
``interop.diff_leaves``, both queues' length accumulators included:
every integer and bool leaf equal, so the event order is the
reference's; floats within 1e-9 of each leaf's scale in f64 (the
samplers' log1p) and 2e-5 in f32 (XLA fuses some multiply-adds).  Also
a run truncated at ``max_steps``, the conservation of visits on the
port's result (``wait.n == w1.n + w2.n``, ``w2.n >= N``), and the
Jackson formulas against the reference's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import loop as jloop
from cimba_tpu.models import tandem as jtandem
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.models import tandem as ttandem

torch.set_num_threads(1)

K = 41  # events a chunk; the truncated run is one chunk

RTOL = {"f64": 1e-9, "f32": 2e-5}
REPS, N = 2, 60  # 6 cells x 2 replications = 12 lanes
LANES = 6 * REPS


@functools.lru_cache(maxsize=None)
def _ref(prof):
    """The reference's initial state, its first chunk of K events and
    its run to the end: one compiled chunk, called until no lane is live
    (exact: a chunk's truncation does not change the run)."""
    with jconfig.profile(prof):
        spec, _ = jtandem.build()
        p, _ = jtandem.sweep_grid(N).rows(REPS)
        js = jax.jit(jax.vmap(lambda r, q: jloop.init_sim(spec, 2026, r, q)))(
            jnp.arange(LANES), p)
        chunk = jax.jit(jax.vmap(jloop.make_run(spec, max_steps=K)))
        cond = jax.jit(jax.vmap(jloop.make_cond(spec)))
        first = out = chunk(js)
        while bool(cond(out).any()):
            out = chunk(out)
    return js, first, out


def _port(prof, max_steps=None):
    with tconfig.profile(prof):
        spec, _ = ttandem.build()
        p, _ = ttandem.sweep_grid(N).rows(REPS)
        ts = tloop.init_sim(spec, 2026, torch.arange(LANES), p, device="cpu")
        return ts, tloop.make_run(spec, max_steps=max_steps)(ts)


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_matches_reference(prof):
    js, _, jout = _ref(prof)
    ts, tout = _port(prof)
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    assert int(tout.err.abs().sum()) == 0 and bool(tout.done.all())
    u = tout.user
    assert bool((u["wait"].n == u["w1"].n + u["w2"].n).all())
    assert bool((u["w2"].n >= N).all())
    # feedback happened: some customer visited a station twice
    assert bool((u["w2"].n > N).any())
    assert bool(tout.queues.acc.started.all())


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_truncated_run_matches_reference(prof):
    _, jout, _ = _ref(prof)
    _, tout = _port(prof, max_steps=K)
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    assert not bool(tout.done.any())


def test_grid_and_theory_match_reference():
    for a in (0.4, 0.5, 0.6):
        for pb in (0.1, 0.25):
            for f in ("visit_sojourn",):
                assert getattr(ttandem, f)(a, 1.0, pb) == getattr(
                    jtandem, f)(a, 1.0, pb)
            args = (a, 1.0, 1.25, pb)
            for f in ("mean_visit_sojourn", "network_sojourn"):
                assert getattr(ttandem, f)(*args) == getattr(jtandem, f)(*args)
            assert ttandem.internal_rate(a, pb) == jtandem.internal_rate(a, pb)
    assert ttandem.params(100) == jtandem.params(100)
    with pytest.raises(ValueError):
        ttandem.sweep_grid(10, arr_rates=(0.9,))
    with pytest.raises(ValueError):
        ttandem.internal_rate(0.5, 1.0)
    jp, _ = jtandem.sweep_grid(400).rows(3)
    tp, ids = ttandem.sweep_grid(400).rows(3)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert list(ids) == [i // 3 for i in range(18)]
    assert ttandem.BLOCK_NAMES == tuple(
        b.__name__ for b in ttandem.build()[0].blocks)


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_carried_state_finishes_as_reference(prof):
    """The reference's state after one chunk of K events, carried into
    the port by ``interop.sim_from_numpy`` (the recording accumulators
    included), run to the end by the port: the reference's end state."""
    _, first, jout = _ref(prof)
    with tconfig.profile(prof):
        spec, _ = ttandem.build()
        ts = interop.sim_from_numpy(
            [np.asarray(x) for x in jax.tree.leaves(first)], spec,
            ttandem.sweep_grid(N).rows(REPS)[0], device="cpu")
        tout = tloop.make_run(spec)(ts)
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
