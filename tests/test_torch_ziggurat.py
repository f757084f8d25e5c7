"""The port's ziggurat samplers against cimba_tpu.random.ziggurat (CPU).

States must be equal; values within k eps of max(|x|, 1): the measured
worst case on these streams is 0 for the exponential (its tail adds
XLA's log1p, off by up to 128 ulp, to r = 7.7, which absorbs it) and
0.93 for the normal (the logs of Marsaglia's tail) in both profiles;
the bounds are 1 and 2.  exp in the y-test may differ by an ulp but
flips no accept decision on these streams, as the equal states show.
Then the reference's moment and tail checks (tests/test_ziggurat.py)
on the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cimba_tpu.random as cr
from cimba_tpu import config as jconfig
from cimba_tpu.random import ziggurat as jzig
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch.random import _ziggurat_tables as tables
from cimba_tpu_torch.random import bits as tbits
from cimba_tpu_torch.random import distributions as tdist
from cimba_tpu_torch.random import ziggurat as tzig

# (name, k in f64, k in f32)
CASES = [("std_exponential_zig", 1, 1), ("std_normal_zig", 2, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    at once, and torch's thread pools in each of them would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("name,k64,k32", CASES)
def test_ziggurat_matches_reference(name, k64, k32, prof):
    n = 20000
    with jconfig.profile(prof), tconfig.profile(prof):
        js = jax.vmap(lambda r: cr.initialize(404, r))(jnp.arange(n))
        ts = tbits.initialize(404, torch.arange(n), device="cpu")
        js2, x = jax.jit(jax.vmap(getattr(jzig, name)))(js)
        ts2, y = getattr(tzig, name)(ts)
    for w, g in zip(js2, ts2):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      g.numpy())
    x, y = np.asarray(x), y.numpy()
    assert x.dtype == y.dtype and np.isfinite(y).all()
    err = np.abs(x - y) / np.maximum(np.abs(x), 1.0) / np.finfo(x.dtype).eps
    assert err.max() <= (k64 if prof == "f64" else k32)


def draw(fn, n=200_000, seed=404):
    _, xs = fn(tbits.initialize(seed, torch.arange(n), device="cpu"))
    return xs.numpy()


def test_ziggurat_exponential_moments():
    xs = draw(tzig.std_exponential_zig)
    assert xs.min() >= 0.0
    assert abs(xs.mean() - 1.0) < 0.02
    assert abs(xs.var() - 1.0) < 0.05
    assert abs(((xs - xs.mean()) ** 3).mean() / xs.std() ** 3 - 2.0) < 0.2


def test_ziggurat_normal_moments():
    xs = draw(tzig.std_normal_zig)
    assert abs(xs.mean()) < 0.02
    assert abs(xs.var() - 1.0) < 0.05
    assert abs(((xs - xs.mean()) ** 3).mean() / xs.std() ** 3) < 0.05
    assert abs(((xs - xs.mean()) ** 4).mean() / xs.var() ** 2 - 3.0) < 0.15


def _ks_distance(a, b):
    a, b = np.sort(a), np.sort(b)
    v = np.concatenate([a, b])
    return np.abs(np.searchsorted(a, v, side="right") / len(a)
                  - np.searchsorted(b, v, side="right") / len(b)).max()


def test_ziggurat_vs_inversion_agreement():
    """Independent methods, same distribution: KS distance ~ 1/sqrt(N)."""
    assert _ks_distance(draw(tzig.std_exponential_zig, seed=1),
                        draw(tdist.std_exponential, seed=2)) < 0.008
    assert _ks_distance(draw(tzig.std_normal_zig, seed=3),
                        draw(tdist.std_normal, seed=4)) < 0.008


def test_ziggurat_tail_reachable():
    """Layer-0 misses produce values beyond r."""
    assert draw(tzig.std_exponential_zig, n=500_000).max() > tables.R_EXP
    assert np.abs(draw(tzig.std_normal_zig, n=500_000)).max() > tables.R_NOR
