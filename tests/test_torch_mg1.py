"""The M/G/1 sweep model: the port against cimba_tpu.

``mg1.build()`` with the sweep's per-lane parameters (several cells of
``mg1.sweep_params`` among the lanes) through ``jax.jit(jax.vmap(
make_run))`` and the port's ``make_run`` on the CPU (8 lanes, 100
objects, both profiles), leaf for leaf with ``interop.diff_leaves``, the
queue's length accumulator included: every integer and bool leaf equal,
so the event order is the reference's; floats within 1e-9 of each
leaf's scale in f64 (the samplers' log1p and erf_inv, the lognormal's
log1p and exp: XLA's and torch's libm differ by a few ulp) and 2e-5 in
f32 (XLA fuses some multiply-adds).  Also a run truncated at
``max_steps``, and the sweep's cell layout and Pollaczek-Khinchine
formula against the reference's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import loop as jloop
from cimba_tpu.models import mg1 as jmg1
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.models import mg1 as tmg1

torch.set_num_threads(1)

K = 37  # events a chunk; the truncated run is one chunk

RTOL = {"f64": 1e-9, "f32": 2e-5}
LANES, N = 8, 100
# four cells among the eight lanes, heavy ones included: cv 0.25 and 2.0
# at rho 0.5 and 0.9, two lanes each
CVS, RHOS = (0.25, 2.0), (0.5, 0.9)


def _params(mod):
    return mod.sweep_params(N, cvs=CVS, utilizations=RHOS, reps_per_cell=2)


@functools.lru_cache(maxsize=None)
def _ref(prof):
    """The reference's initial state, its first chunk of K events and
    its run to the end: one compiled chunk, called until no lane is live
    (exact: a chunk's truncation does not change the run)."""
    with jconfig.profile(prof):
        spec, _ = jmg1.build()
        p, _ = _params(jmg1)
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
        spec, _ = tmg1.build()
        p, cells = _params(tmg1)
        ts = tloop.init_sim(spec, 2026, torch.arange(LANES), p, device="cpu")
        return ts, tloop.make_run(spec, max_steps=max_steps)(ts), cells


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_matches_reference(prof):
    js, _, jout = _ref(prof)
    ts, tout, cells = _port(prof)
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               RTOL[prof]) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    assert int(tout.err.abs().sum()) == 0 and bool(tout.done.all())
    assert bool((tout.user["wait"].n == N).all())
    assert tout.queues.acc is not None and bool(tout.queues.acc.started.all())
    assert cells == [(c, r) for c in CVS for r in RHOS for _ in range(2)]


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_truncated_run_matches_reference(prof):
    _, jout, _ = _ref(prof)
    _, tout, _ = _port(prof, max_steps=K)
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    assert not bool(tout.done.any())
    assert bool((tout.n_events == K).all())


def test_sweep_and_theory_match_reference():
    jp, jcells = jmg1.sweep_params(50, reps_per_cell=3)
    tp, tcells = tmg1.sweep_params(50, reps_per_cell=3)
    assert jcells == tcells and len(tcells) == 60
    for a, b in zip(jp, tp):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())
    for cv in (0.25, 0.5, 1.0, 2.0):
        for rho in (0.5, 0.7, 0.9):
            assert tmg1.pk_sojourn(rho, cv) == jmg1.pk_sojourn(rho, cv)
    assert tmg1.BLOCK_NAMES == tuple(
        b.__name__ for b in tmg1.build()[0].blocks)


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_carried_state_finishes_as_reference(prof):
    """The reference's state after one chunk of K events, carried into
    the port by ``interop.sim_from_numpy`` (the recording accumulators
    included), run to the end by the port: the reference's end state."""
    _, first, jout = _ref(prof)
    with tconfig.profile(prof):
        spec, _ = tmg1.build()
        ts = interop.sim_from_numpy(
            [np.asarray(x) for x in jax.tree.leaves(first)], spec,
            _params(tmg1)[0], device="cpu")
        tout = tloop.make_run(spec)(ts)
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
