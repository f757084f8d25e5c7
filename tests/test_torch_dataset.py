"""``cimba_tpu_torch.stats.dataset`` against the reference's
(``tests/test_stats.py``'s dataset cases, and the same statistics of
the reference on the same samples).

Order statistics, the quantile and the sort are exact; sums (the mean,
summarize's moments, ACF and PACF) may be taken in another order than
XLA's and agree to 1e-12 relative; the text renderings are equal where
the numbers they print are.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu.stats import dataset as jds
from cimba_tpu_torch.stats import dataset as cds

torch.set_num_threads(1)


def _filled(xs, cap):
    ds = cds.create(cap, device="cpu", dtype=torch.float64)
    for x in xs:
        ds = cds.add(ds, float(x))
    return ds


def _ref(xs, cap):
    """The reference's dataset holding ``xs`` (its ``add`` loop's
    result, built directly)."""
    v = np.full(cap, np.inf)
    v[:len(xs)] = xs
    return jds.Dataset(values=jnp.asarray(v), n=jnp.asarray(len(xs),
                                                            jnp.int32),
                       dropped=jnp.zeros((), jnp.int32))


def test_dataset_order_stats():
    rng = np.random.default_rng(3)
    xs = rng.uniform(0, 100, size=371)
    ds = _filled(xs, 512)
    assert int(ds.n) == 371 and int(ds.dropped) == 0
    assert np.isclose(float(cds.mean(ds)), xs.mean())
    assert np.isclose(float(cds.median(ds)), np.median(xs))
    mn, q1, md, q3, mx = (float(v) for v in cds.fivenum(ds))
    assert np.isclose(q1, np.quantile(xs, 0.25))
    assert np.isclose(q3, np.quantile(xs, 0.75))
    assert mn == xs.min() and mx == xs.max()
    ref = _ref(xs, 512)
    assert [float(v) for v in cds.fivenum(ds)] == [
        float(v) for v in jds.fivenum(ref)]
    for q in (0.0, 0.1, 0.5, 0.9, 1.0):
        assert float(cds.quantile(ds, q)) == float(jds.quantile(ref, q))
    assert np.array_equal(cds.sort(ds).values.numpy(),
                          np.asarray(jds.sort(ref).values))
    assert np.isclose(float(cds.mean(ds)), float(jds.mean(ref)),
                      rtol=1e-12, atol=0)


def test_dataset_overflow_counts_drops():
    ds = cds.create(4, device="cpu")
    for x in range(7):
        ds = cds.add(ds, float(x))
    assert int(ds.n) == 4 and int(ds.dropped) == 3
    assert ds.values.tolist() == [0.0, 1.0, 2.0, 3.0]


def test_dataset_merge():
    a = _filled([1.0, 2.0], 8)
    b = _filled([3.0, 4.0, 5.0], 8)
    m = cds.merge(a, b)
    assert int(m.n) == 5
    assert np.isclose(float(cds.mean(m)), 3.0)
    small = cds.merge(_filled([1.0, 2.0, 3.0], 4), b)  # capacity 4
    assert (int(small.n), int(small.dropped)) == (4, 2)
    assert small.values.tolist() == [1.0, 2.0, 3.0, 3.0]
    # a reference fault the port does not copy: its merge clamps the
    # destinations of the samples that do not fit onto the last slot, and
    # their no-op writes land on the one sample that does (duplicate
    # scatter indices), so it counts 4 samples and holds +inf in slot 3
    ref = jds.merge(_ref([1.0, 2.0, 3.0], 4), _ref([3.0, 4.0, 5.0], 8))
    assert (int(ref.n), int(ref.dropped)) == (4, 2)
    assert np.asarray(ref.values).tolist() == [1.0, 2.0, 3.0, np.inf]
    roomy = jds.merge(_ref([1.0, 2.0], 8), _ref([3.0, 4.0, 5.0], 8))
    assert m.values.tolist() == np.asarray(roomy.values).tolist()


def np_moments(xs):
    mu = xs.mean()
    c = xs - mu
    return mu, (c**2).sum(), (c**3).sum(), (c**4).sum()


def test_dataset_summarize_matches_fold():
    rng = np.random.default_rng(4)
    xs = rng.normal(size=100)
    ds = _filled(xs, 128)
    s = cds.summarize(ds)
    mu, m2, m3, m4 = np_moments(xs)
    assert np.isclose(float(s.m1), mu)
    assert np.isclose(float(s.m2), m2)
    assert np.isclose(float(s.m4), m4)
    r = jds.summarize(_ref(xs, 128))
    for a, b in zip(s, r):
        assert np.isclose(float(a), float(b), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("phi", [0.7, -0.4])
def test_acf_pacf_of_ar1(phi):
    """AR(1): ACF(k) ~ phi^k, PACF cuts off after lag 1; equal to the
    reference's on the same series."""
    rng = np.random.default_rng(5)
    n = 4000
    xs = np.zeros(n)
    for i in range(1, n):
        xs[i] = phi * xs[i - 1] + rng.normal()
    ds = cds.Dataset(values=torch.from_numpy(np.concatenate(
        [xs, np.full(96, np.inf)])), n=torch.tensor(n, dtype=torch.int32),
        dropped=torch.tensor(0, dtype=torch.int32))
    rho = cds.acf(ds, 5).numpy()
    assert np.isclose(rho[0], 1.0)
    assert abs(rho[1] - phi) < 0.06
    assert abs(rho[2] - phi**2) < 0.08
    pr = cds.pacf(ds, 4).numpy()
    assert abs(pr[0] - phi) < 0.06
    assert all(abs(pr[k]) < 0.08 for k in range(1, 4))
    ref = _ref(xs, 4096)
    np.testing.assert_allclose(rho, np.asarray(jds.acf(ref, 5)), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(pr, np.asarray(jds.pacf(ref, 4)), rtol=1e-11,
                               atol=1e-13)


def test_prints_render_as_reference():
    rng = np.random.default_rng(6)
    xs = rng.exponential(size=200)
    ds, ref = _filled(xs, 256), _ref(xs, 256)
    assert cds.histogram_str(ds, bins=10) == jds.histogram_str(ref, bins=10)
    assert cds.fivenum_str(ds) == jds.fivenum_str(ref)
    assert "median" in cds.fivenum_str(ds)
    lines = cds.correlogram_str(ds, max_lag=5).splitlines()
    assert len(lines) == 6 and lines[0].startswith("lag   0 +1.0000")
    assert lines == jds.correlogram_str(ref, max_lag=5).splitlines()
    assert cds.histogram_str(cds.create(4, device="cpu")) == "(empty dataset)"
