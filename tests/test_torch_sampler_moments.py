"""Moments, ranges and frequencies of the port's samplers, on the CPU.

Mirrors the moment checks of tests/test_random.py on the port alone
(cimba_tpu_torch.random, f64 profile): large-sample moments against
closed forms, one sample per independent stream.
"""

import math

import numpy as np
import pytest
import torch

import cimba_tpu_torch.random as tr

WEIGHTS = [1.0, 2.0, 3.0, 4.0, 0.0, 6.0]
N = 200_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    at once, and torch's thread pools in each of them would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def draw(fn, n=N, seed=2026):
    """n iid samples: one per independent stream."""
    _, xs = fn(tr.initialize(seed, torch.arange(n), device="cpu"))
    return xs.numpy().astype(np.float64)


def check_moments(xs, mean, var, rtol=0.05, atol=0.02):
    scale = max(abs(mean), np.sqrt(var), 1e-9)
    assert abs(xs.mean() - mean) < rtol * scale + atol
    assert abs(xs.var() - var) < 3.0 * rtol * max(var, atol)


def _weibull():
    k, lam = 1.5, 2.0
    return (lam * math.gamma(1 + 1 / k),
            lam**2 * (math.gamma(1 + 2 / k) - math.gamma(1 + 1 / k) ** 2))


MOMENTS = [
    # (name, params, n, mean, var, rtol)
    ("uniform01", (), N, 0.5, 1 / 12, 0.05),
    ("uniform", (-2.0, 3.0), N, 0.5, 25 / 12, 0.05),
    ("triangular", (1.0, 3.0, 7.0), N, 11 / 3, (1 + 9 + 49 - 3 - 7 - 21) / 18,
     0.05),
    ("exponential", (2.5,), N, 2.5, 6.25, 0.05),
    ("normal", (-1.5, 2.0), N, -1.5, 4.0, 0.05),
    ("lognormal", (0.5, 0.4), N, np.exp(0.5 + 0.08),
     (np.exp(0.16) - 1) * np.exp(1.0 + 0.16), 0.05),
    ("logistic", (2.0, 0.5), N, 2.0, np.pi**2 / 3 * 0.25, 0.05),
    ("erlang", (4, 0.5), 100_000, 2.0, 1.0, 0.05),
    ("hypoexponential", ([1.0, 2.0, 0.5],), 100_000, 3.5, 5.25, 0.05),
    ("hyperexponential", ([0.3, 0.7], [1.0, 4.0]), 100_000, 3.1,
     2 * (0.3 + 0.7 * 16) - 3.1**2, 0.05),
    ("gamma", (0.5, 1.5), 100_000, 0.75, 1.125, 0.05),
    ("gamma", (1.0, 1.5), 100_000, 1.5, 2.25, 0.05),
    ("gamma", (2.5, 1.5), 100_000, 3.75, 5.625, 0.05),
    ("gamma", (9.0, 1.5), 100_000, 13.5, 20.25, 0.05),
    ("std_beta", (2.0, 5.0), 100_000, 2 / 7, 10 / (49 * 8), 0.05),
    ("pert", (0.0, 3.0, 12.0), 100_000, 4.0, 4.0 * 8.0 / 7.0, 0.08),
    ("weibull", (1.5, 2.0), N, *_weibull(), 0.05),
    ("pareto", (3.0, 2.0), N, 3.0, 3.0, 0.1),
    ("chisquared", (5.0,), 100_000, 5.0, 10.0, 0.05),
    ("std_t_dist", (8.0,), 100_000, 0.0, 8 / 6, 0.1),
    ("rayleigh", (2.0,), N, 2.0 * np.sqrt(np.pi / 2), (2 - np.pi / 2) * 4,
     0.05),
    ("geometric", (0.25,), N, 4.0, 12.0, 0.05),
    ("binomial", (20, 0.3), 50_000, 6.0, 4.2, 0.05),
    ("negative_binomial", (3, 0.4), 50_000, 4.5, 11.25, 0.05),
    ("pascal", (3, 0.4), 50_000, 7.5, 11.25, 0.05),
    ("poisson", (0.5,), 50_000, 0.5, 0.5, 0.08),
    ("poisson", (4.0,), 50_000, 4.0, 4.0, 0.08),
    ("poisson", (40.0,), 50_000, 40.0, 40.0, 0.08),
    ("discrete_uniform", (10,), N, 4.5, 99 / 12, 0.05),
    ("dice", (1, 6), N, 3.5, 35 / 12, 0.05),
]


@pytest.mark.parametrize("name,args,n,mean,var,rtol", MOMENTS,
                         ids=[f"{m[0]}{m[1]}" for m in MOMENTS])
def test_moments(name, args, n, mean, var, rtol):
    xs = draw(lambda st: getattr(tr, name)(st, *args), n=n)
    check_moments(xs, mean, var, rtol=rtol)


def test_shapes_ranges_and_frequencies():
    xs = draw(tr.uniform01)
    assert xs.min() >= 0.0 and xs.max() < 1.0
    xs = draw(lambda st: tr.triangular(st, 1.0, 3.0, 7.0))
    assert xs.min() >= 1.0 and xs.max() <= 7.0
    xs = draw(lambda st: tr.exponential(st, 2.5))
    assert abs(((xs - xs.mean()) ** 3).mean() / xs.std() ** 3 - 2.0) < 0.2
    xs = draw(lambda st: tr.normal(st, -1.5, 2.0))
    assert abs(((xs - xs.mean()) ** 3).mean() / xs.std() ** 3) < 0.05
    assert abs(((xs - xs.mean()) ** 4).mean() / xs.var() ** 2 - 3.0) < 0.15
    assert abs(np.median(draw(lambda st: tr.cauchy(st, 3.0, 1.0))) - 3.0) < 0.05
    xs = draw(lambda st: tr.pert(st, 0.0, 3.0, 12.0), n=100_000)
    assert xs.min() >= 0.0 and xs.max() <= 12.0
    assert draw(lambda st: tr.pareto(st, 3.0, 2.0)).min() >= 2.0
    assert draw(lambda st: tr.geometric(st, 0.25)).min() >= 1
    assert abs(draw(lambda st: tr.f_dist(st, 4.0, 10.0),
                    n=100_000).mean() - 1.25) < 0.1
    assert abs(draw(tr.flip).mean() - 0.5) < 0.01
    assert abs(draw(lambda st: tr.bernoulli(st, 0.3)).mean() - 0.3) < 0.01
    xs = draw(lambda st: tr.discrete_uniform(st, 10))
    assert xs.min() == 0 and xs.max() == 9
    ys = draw(lambda st: tr.dice(st, 1, 6))
    assert ys.min() == 1 and ys.max() == 6
    probs = [0.1, 0.2, 0.3, 0.4]
    xs = draw(lambda st: tr.discrete_nonuniform(st, probs))
    np.testing.assert_allclose(np.bincount(xs.astype(int), minlength=4)
                               / len(xs), probs, atol=0.01)
    xs = draw(lambda st: tr.loaded_dice(st, 10, 12, [0.5, 0.25, 0.25]))
    assert xs.min() == 10 and xs.max() == 12
    table = tr.alias_create(WEIGHTS, device="cpu")
    xs = draw(lambda st: tr.alias_sample(st, table))
    np.testing.assert_allclose(np.bincount(xs.astype(int), minlength=6)
                               / len(xs), np.asarray(WEIGHTS) / 16.0,
                               atol=0.01)


def test_normal_tail_support_and_bad_inputs():
    # 53-bit uniforms reach past the 32-bit cap: P(|z| > 4.5) ~ 6.8e-6
    assert np.abs(draw(tr.std_normal, n=2_000_000, seed=17)).max() > 4.4
    for bad in ([], [-1.0, 2.0], [0.0, 0.0]):
        with pytest.raises(ValueError):
            tr.alias_create(bad, device="cpu")
    st = tr.initialize(1, torch.arange(4), device="cpu")
    with pytest.raises(ValueError):
        tr.loaded_dice(st, 1, 3, [0.5, 0.5])
    with pytest.raises(ValueError):
        tr.discrete_uniform(st, 0)
