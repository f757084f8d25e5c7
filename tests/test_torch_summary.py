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
