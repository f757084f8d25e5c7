"""The port's Pébay summaries against cimba_tpu.stats.summary.

Same inputs (numpy, from a seed), same operation order.  Counts, weights,
minima and maxima must be equal; the moments may differ in their last
bits, because XLA compiles the merge into one fused CPU loop whose float
evaluation is not eager PyTorch's one-rounding-per-operation: the bound
is 16 ulp of the field's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.stats import summary as jsm
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch.stats import summary as tsm

EXACT = ("n", "w", "mn", "mx")


def _check(want, got, dt):
    eps = np.finfo(dt).eps
    for f, w, g in zip(tsm.Summary._fields, want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.dtype == g.dtype == dt, f
        if f in EXACT:
            np.testing.assert_array_equal(w, g, err_msg=f)
        else:
            tol = 16 * eps * max(float(np.abs(w).max()), 1e-300)
            assert float(np.abs(w - g).max()) <= tol, f


def _jax_adds(x):
    def run(xs):
        s = jax.vmap(lambda _: jsm.empty())(jnp.arange(xs.shape[0]))

        def body(s, col):
            return jax.vmap(jsm.add)(s, col), None

        return jax.lax.scan(body, s, xs.T)[0]

    return jax.jit(run)(x)


def _torch_adds(x):
    s = tsm.empty((x.shape[0],), device="cpu")
    for j in range(x.shape[1]):
        s = tsm.add(s, torch.from_numpy(x[:, j]))
    return s


@pytest.mark.parametrize("prof,dt", [("f64", np.float64), ("f32", np.float32)])
def test_add_merge_tree(prof, dt):
    rng = np.random.default_rng(7)
    x = rng.exponential(10.0, size=(37, 120)).astype(dt)
    with jconfig.profile(prof), tconfig.profile(prof):
        a = _jax_adds(x)
        b = _torch_adds(x)
        _check(a, b, dt)
        # merge_tree over an odd lane count folds the tail into lane 0
        _check(jsm.merge_tree(a), tsm.merge_tree(b), dt)
        # a pairwise merge of two independent batches, and empty sides
        half = x.shape[1] // 2
        ma = jax.vmap(jsm.merge)(_jax_adds(x[:, :half]), _jax_adds(x[:, half:]))
        mb = tsm.merge(_torch_adds(x[:, :half]), _torch_adds(x[:, half:]))
        _check(ma, mb, dt)
        e = tsm.empty((37,), device="cpu")
        _check(ma, tsm.merge(e, mb), dt)
        _check(ma, tsm.merge(mb, e), dt)
        np.testing.assert_allclose(
            float(jsm.variance(jsm.merge_tree(a))),
            float(tsm.variance(tsm.merge_tree(b))), rtol=64 * np.finfo(dt).eps)
        assert float(jsm.mean(jsm.merge_tree(a))) == pytest.approx(
            float(tsm.mean(tsm.merge_tree(b))), rel=16 * np.finfo(dt).eps)


def test_empty_matches():
    for f, w, g in zip(tsm.Summary._fields, jsm.empty(), tsm.empty(device="cpu")):
        assert float(w) == float(g), f


# --- the derived statistics: pop_variance ... halfwidth ---------------------
# Same formulas, same operation order: the moments' ratios and roots
# within 64 ulp (the inputs' own 16-ulp bound, divided and raised to
# 1.5 or 2); ndtri and t_quantile within 1e-12 relative in f64 and 1e-6
# in f32 (XLA evaluates Cephes' rational functions with its own log and
# sqrt).

P_GRID = (0.9, 0.95, 0.975, 0.995)
DOF_GRID = (1.0, 2.0, 3.0, 4.0, 9.0, 30.0, 1e3, 1e6)
Q_TOL = {"f64": 1e-12, "f32": 1e-6}


@pytest.mark.parametrize("prof,dt", [("f64", np.float64), ("f32", np.float32)])
def test_derived_statistics(prof, dt):
    rng = np.random.default_rng(11)
    x = rng.lognormal(0.0, 0.8, size=(29, 90)).astype(dt)
    tol = 64 * np.finfo(dt).eps
    with jconfig.profile(prof), tconfig.profile(prof):
        a, b = _jax_adds(x), _torch_adds(x)
        for f in ("variance", "pop_variance", "stddev", "skewness",
                  "kurtosis", "halfwidth"):
            want = np.asarray(getattr(jsm, f)(a))
            got = getattr(tsm, f)(b).numpy()
            assert got.dtype == want.dtype == dt, f
            np.testing.assert_allclose(got, want, rtol=tol, err_msg=f)
        for c in (0.9, 0.99):
            np.testing.assert_allclose(
                tsm.halfwidth(b, c).numpy(), np.asarray(jsm.halfwidth(a, c)),
                rtol=max(tol, Q_TOL[prof]))


@pytest.mark.parametrize("prof,dt", [("f64", np.float64), ("f32", np.float32)])
def test_t_quantile_over_the_grid(prof, dt):
    with jconfig.profile(prof), tconfig.profile(prof):
        for p in P_GRID:
            for v in DOF_GRID:
                want = float(jsm.t_quantile(p, v))
                got = tsm.t_quantile(p, v)
                assert got.dtype == torch.from_numpy(np.zeros(1, dt)).dtype
                assert abs(float(got) - want) <= Q_TOL[prof] * abs(want), (
                    p, v)
        # ndtri itself over the whole p-grid, tails and edges included
        # (the smallest p a normal number of the dtype: XLA flushes
        # subnormal inputs to zero on the CPU)
        ps = np.concatenate([np.array([0.0, 1e-300 if dt == np.float64
                                       else 1e-37, 1e-20, 1e-8, 0.1,
                                       0.5, 0.8646, 0.9, 1 - 1e-7, 1.0]),
                             np.linspace(0.001, 0.999, 97)]).astype(dt)
        from jax.scipy.special import ndtri

        want = np.asarray(ndtri(jnp.asarray(ps)))
        got = tsm.ndtri(torch.from_numpy(ps)).numpy()
        fin = np.isfinite(want)
        assert np.array_equal(fin, np.isfinite(got))
        assert np.array_equal(want[~fin], got[~fin])
        np.testing.assert_allclose(got[fin], want[fin], rtol=Q_TOL[prof],
                                   atol=Q_TOL[prof])


def test_halfwidth_edges():
    with tconfig.profile("f64"):
        one = tsm.add(tsm.empty((3,), device="cpu"), torch.tensor(
            [1.0, 2.0, 3.0], dtype=torch.float64))
        assert bool(torch.isinf(tsm.halfwidth(one)).all())
        assert bool(torch.isinf(tsm.halfwidth(tsm.empty((), device="cpu"))))
        two = tsm.add(one, torch.tensor([2.0, 2.0, 5.0], dtype=torch.float64))
        hw = tsm.halfwidth(two)
        assert bool(torch.isfinite(hw).all()) and float(hw[1]) == 0.0
        for bad in (0.0, 1.0, -0.5, 1.5):
            with pytest.raises(ValueError, match="confidence"):
                tsm.halfwidth(two, bad)
