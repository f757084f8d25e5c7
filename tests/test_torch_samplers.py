"""The port's sampler catalogue against cimba_tpu.random, on the CPU.

One parametrised test covers every name of the reference's
``cimba_tpu.random.__all__`` in both profiles, on 20000 streams of seed
99.  Counter states and integer samples must be equal.  Float samples
must satisfy ``|x - y| <= k * eps * max(|x|, 1)`` with ``k`` per sampler
and profile in ``SAMPLERS`` below: the measured worst case on these
streams, rounded up to a power of two with a factor 2 of headroom.  The
differences come from the libraries, not the algorithms: XLA's f64
log1p is off by up to 128 ulp (so every exponential-based sampler),
XLA fuses ``a + b * c`` into one FMA on the CPU where torch rounds
twice (``uniform``, ``normal``, ``t_dist`` in f32), and lgamma, pow,
tan and exp differ by an ulp or two.  No accept decision of a rejection
sampler flips on these streams: the counter states are equal.

The moment checks, on the port alone, are in test_torch_sampler_moments.py.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cimba_tpu.random as cr
from cimba_tpu import config as jconfig
import cimba_tpu_torch.random as tr
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch.random import distributions as tdist

LANES = 20000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    at once, and torch's thread pools in each of them would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# name -> (params, k in f64, k in f32); k None: integer samples, equal
SAMPLERS = {
    "uniform01": ((), 0, 0),
    "uniform01_53": ((), 0, 0),
    "uniform": ((-2.0, 3.0), 0, 2),
    "triangular": ((1.0, 3.0, 7.0), 2, 2),
    "std_exponential": ((), 128, 2),
    "exponential": ((2.5,), 256, 4),
    "std_normal": ((), 32, 4),
    "normal": ((-1.5, 2.0), 64, 8),
    "lognormal": ((0.5, 0.4), 16, 8),
    "logistic": ((2.0, 0.5), 0, 4),
    "cauchy": ((3.0, 1.0), 4, 4),
    "erlang": ((4, 0.5), 128, 4),
    "hypoexponential": (([1.0, 2.0, 0.5],), 256, 4),
    "hyperexponential": (([0.3, 0.7], [1.0, 4.0]), 256, 2),
    "std_gamma": ((2.5,), 32, 16),
    "gamma": ((0.5, 1.5), 32, 8),
    "std_beta": ((2.0, 5.0), 8, 4),
    "beta": ((2.0, 5.0, 1.0, 3.0), 8, 4),
    "pert_mod": ((0.0, 3.0, 12.0, 6.0), 32, 16),
    "pert": ((0.0, 3.0, 12.0), 32, 16),
    "weibull": ((1.5, 2.0), 256, 2),
    "pareto": ((3.0, 2.0), 2, 2),
    "chisquared": ((5.0,), 32, 16),
    "f_dist": ((4.0, 10.0), 32, 16),
    "std_t_dist": ((8.0,), 32, 8),
    "t_dist": ((1.0, 2.0, 8.0), 64, 16),
    "rayleigh": ((2.0,), 128, 2),
    "flip": ((), None, None),
    "bernoulli": ((0.3,), None, None),
    "geometric": ((0.25,), None, None),
    "binomial": ((20, 0.3), None, None),
    "negative_binomial": ((3, 0.4), None, None),
    "pascal": ((3, 0.4), None, None),
    "poisson": ((4.0,), None, None),
    "discrete_uniform": ((10,), None, None),
    "dice": ((1, 6), None, None),
    "discrete_nonuniform": (([0.1, 0.2, 0.3, 0.4],), None, None),
    "loaded_dice": ((10, 12, [0.5, 0.25, 0.25]), None, None),
}
WEIGHTS = [1.0, 2.0, 3.0, 4.0, 0.0, 6.0]


def _words(a):
    return np.asarray(a).astype(np.int64)


def _streams(seed=99, n=LANES):
    js = jax.vmap(lambda r: cr.initialize(seed, r))(jnp.arange(n))
    return js, tr.initialize(seed, torch.arange(n), device="cpu")


def _same_states(js, ts):
    for w, g in zip(js, ts):
        np.testing.assert_array_equal(_words(w), g.numpy())


def _close(x, y, k):
    """Float samples: the same non-finite entries, the finite ones
    within k eps of max(|x|, 1)."""
    x, y = np.asarray(x), y.numpy()
    assert x.dtype == y.dtype
    fin = np.isfinite(x)
    np.testing.assert_array_equal(fin, np.isfinite(y))
    np.testing.assert_array_equal(x[~fin], y[~fin])
    eps = np.finfo(x.dtype).eps
    err = np.abs(x[fin] - y[fin]) / np.maximum(np.abs(x[fin]), 1.0) / eps
    assert (err.max() if err.size else 0.0) <= k


def _run_both(name, jargs, targs, js, ts):
    fn_j, fn_t = getattr(cr, name), getattr(tr, name)
    js2, x = jax.jit(jax.vmap(lambda s: fn_j(s, *jargs)))(js)
    ts2, y = fn_t(ts, *targs)
    _same_states(js2, ts2)
    return x, y


def _check_other(name):
    """Names of __all__ that are not samplers."""
    port = getattr(tr, name)
    if name in ("alias", "bits", "distributions"):
        assert inspect.ismodule(port)
        assert port.__name__ == f"cimba_tpu_torch.random.{name}"
    elif name in ("RandomState", "AliasTable"):
        assert port._fields == getattr(cr, name)._fields
    elif name == "threefry2x32":
        k = np.random.default_rng(1).integers(0, 2**32, size=(4, 4096))
        want = cr.threefry2x32(*[jnp.asarray(x, jnp.uint32) for x in k])
        got = tr.threefry2x32(*[torch.from_numpy(x) for x in k])
        _same_states(want, got)
    elif name == "fmix64":
        h = np.random.default_rng(2).integers(0, 2**64, size=4096,
                                              dtype=np.uint64)
        want = np.asarray(cr.fmix64(jnp.asarray(h))).view(np.int64)
        got = tr.fmix64(torch.from_numpy(h.view(np.int64)))
        np.testing.assert_array_equal(want, got.numpy())
    elif name == "initialize":
        js, ts = _streams(seed=2**64 - 3, n=4096)
        _same_states(js, ts)
    elif name == "next_bits64":
        js, ts = _streams(n=4096)
        lo = np.full(4096, 0xFFFFFFFF, np.uint32)
        js = js._replace(ctr_lo=jnp.asarray(lo))
        ts = ts._replace(ctr_lo=torch.from_numpy(lo.astype(np.int64)))
        for _ in range(2):
            js, a0, a1 = jax.vmap(cr.next_bits64)(js)
            ts, b0, b1 = tr.next_bits64(ts)
            _same_states((a0, a1), (b0, b1))
            _same_states(js, ts)
    elif name == "alias_create":
        want = cr.alias_create(WEIGHTS)
        got = tr.alias_create(WEIGHTS, device="cpu")
        np.testing.assert_array_equal(np.asarray(want.prob), got.prob.numpy())
        np.testing.assert_array_equal(np.asarray(want.alias),
                                      got.alias.numpy())
    else:
        raise AssertionError(f"{name} is in the reference's __all__ but has "
                             "no case here")


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("name", sorted(cr.__all__))
def test_catalogue_matches_reference(name, prof):
    assert name in tr.__all__
    with jconfig.profile(prof), tconfig.profile(prof):
        if name == "alias_sample":
            js, ts = _streams()
            x, y = _run_both(name, (cr.alias_create(WEIGHTS),),
                             (tr.alias_create(WEIGHTS, device="cpu"),),
                             js, ts)
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
            assert str(y.dtype).endswith("int64" if prof == "f64" else
                                         "int32")
            return
        if name not in SAMPLERS:
            return _check_other(name)
        args, k64, k32 = SAMPLERS[name]
        jargs = tuple(jnp.asarray(a) if isinstance(a, list) else a
                      for a in args)
        js, ts = _streams()
        x, y = _run_both(name, jargs, args, js, ts)
        k = k64 if prof == "f64" else k32
        if k is None:
            assert np.asarray(x).dtype == y.numpy().dtype
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
        else:
            _close(x, y, k)


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_per_lane_parameters(prof):
    """Per-lane rates on both sides of poisson's switch at 10 (the
    reference's lax.cond under vmap runs both branches and selects the
    state and value per lane), and u64 moduli past 2**32."""
    n = 4096
    rates = np.resize([0.5, 3.0, 9.99, 10.0, 15.0, 80.0], n)
    mods = np.resize([3, 10, 2**32 - 1, 2**32 + 5, 2**40 + 3, 2**46 + 7], n)
    with jconfig.profile(prof), tconfig.profile(prof):
        js, ts = _streams(seed=11, n=n)
        js2, x = jax.jit(jax.vmap(cr.poisson))(js, jnp.asarray(rates))
        ts2, y = tr.poisson(ts, torch.from_numpy(rates))
        _same_states(js2, ts2)
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
        js2, x = jax.jit(jax.vmap(cr.discrete_uniform))(
            js, jnp.asarray(mods, jnp.uint64))
        ts2, y = tr.discrete_uniform(ts, torch.from_numpy(mods))
        _same_states(js2, ts2)
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("dtype,k", [(np.float64, 32), (np.float32, 2)])
def test_erf_inv_is_xla_polynomial(dtype, k):
    """The port's _erf_inv against lax.erf_inv over (-1, 1), the branch
    ends and +-1 (+-inf).  The bound is XLA's log1p inside w (k eps of
    max(|x|, 1), as the samplers)."""
    x = np.concatenate([
        np.linspace(-1.0, 1.0, 200001),
        1.0 - np.logspace(-16, -1, 2001), -1.0 + np.logspace(-16, -1, 2001),
        [0.0, -0.0, 1.0, -1.0, np.nextafter(1.0, 0.0)],
    ]).astype(dtype)
    want = jax.lax.erf_inv(jnp.asarray(x))
    got = tdist._erf_inv(torch.from_numpy(x))
    _close(want, got, k)
    assert np.isposinf(got[-3].item()) and np.isneginf(got[-2].item())
