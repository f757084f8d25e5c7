"""Streaming moment summaries with Pébay's pairwise merge (torch port).

Counterpart of :mod:`cimba_tpu.stats.summary`.  Fields are tensors of
any batch shape (the engine keeps one summary per replication lane).
``merge`` follows the reference's operation order exactly — including
how XLA evaluates ``x**3`` (``x * (x * x)``) and ``x**4``
(``(x*x) * (x*x)``) — so the two packages agree bit for bit wherever
their elementary float operations do.  ``add`` is a merge with a
singleton ``(1, w, x, x, x, 0, 0, 0)``, as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from cimba_tpu_torch import config


class Summary(NamedTuple):
    n: torch.Tensor   # sample count (REAL)
    w: torch.Tensor   # total weight (== n for unweighted use)
    mn: torch.Tensor  # min sample value
    mx: torch.Tensor  # max sample value
    m1: torch.Tensor  # weighted mean
    m2: torch.Tensor  # sum of w * (x - m1)^2
    m3: torch.Tensor  # sum of w * (x - m1)^3
    m4: torch.Tensor  # sum of w * (x - m1)^4


def empty(shape=(), device="cuda", dtype=None) -> Summary:
    """An empty summary of batch ``shape`` on ``device`` (the card
    unless the caller asks for ``"cpu"``; raises without one)."""
    device = config.resolve_device(device)
    dt = config.real() if dtype is None else dtype
    z = torch.zeros(shape, dtype=dt, device=device)
    inf = torch.full(shape, float("inf"), dtype=dt, device=device)
    return Summary(z, z.clone(), inf, -inf, z.clone(), z.clone(), z.clone(),
                   z.clone())


def _pow2(x):
    return x * x


def _pow3(x):
    return x * (x * x)


def _pow4(x):
    x2 = x * x
    return x2 * x2


def merge(a: Summary, b: Summary) -> Summary:
    """Pébay pairwise merge; exact for empty operands."""
    w = a.w + b.w
    safe_w = torch.where(w > 0.0, w, torch.ones_like(w))
    d = b.m1 - a.m1
    frac_b = b.w / safe_w
    m1 = a.m1 + d * frac_b
    wa_wb = a.w * b.w
    m2 = a.m2 + b.m2 + d * d * wa_wb / safe_w
    m3 = (
        a.m3
        + b.m3
        + _pow3(d) * wa_wb * (a.w - b.w) / _pow2(safe_w)
        + 3.0 * d * (a.w * b.m2 - b.w * a.m2) / safe_w
    )
    m4 = (
        a.m4
        + b.m4
        + _pow4(d) * wa_wb * (a.w * a.w - wa_wb + b.w * b.w) / _pow3(safe_w)
        + 6.0 * d * d * (a.w * a.w * b.m2 + b.w * b.w * a.m2) / _pow2(safe_w)
        + 4.0 * d * (a.w * b.m3 - b.w * a.m3) / safe_w
    )
    take_a = b.w == 0.0
    take_b = a.w == 0.0

    def pick(ma, mb, mm):
        return torch.where(take_a, ma, torch.where(take_b, mb, mm))

    return Summary(
        n=a.n + b.n,
        w=w,
        mn=torch.minimum(a.mn, b.mn),
        mx=torch.maximum(a.mx, b.mx),
        m1=pick(a.m1, b.m1, m1),
        m2=pick(a.m2, b.m2, m2),
        m3=pick(a.m3, b.m3, m3),
        m4=pick(a.m4, b.m4, m4),
    )


def add(s: Summary, x, weight=1.0) -> Summary:
    """Add one (weighted) sample: merge with a singleton summary."""
    x = torch.as_tensor(x, dtype=s.m1.dtype, device=s.m1.device)
    x = x.expand(torch.broadcast_shapes(x.shape, s.m1.shape))
    one = torch.ones_like(x)
    z = torch.zeros_like(x)
    w = one * weight
    return merge(s, Summary(one, w, x, x, x, z, z, z))


def merge_tree(summaries: Summary) -> Summary:
    """Reduce a batched Summary (leading axis R) to one by the
    reference's binary tree: halves merged pairwise, an odd tail folded
    into element 0, log2(R) rounds."""
    s = summaries
    r = s.n.shape[0]
    while r > 1:
        half = r // 2
        lo = Summary(*[x[:half] for x in s])
        hi = Summary(*[x[half : 2 * half] for x in s])
        merged = merge(lo, hi)
        if r % 2:
            folded = merge(
                Summary(*[x[0] for x in merged]),
                Summary(*[x[r - 1] for x in s]),
            )
            merged = Summary(
                *[torch.cat([f.reshape(1), m[1:]]) for f, m in
                  zip(folded, merged)]
            )
        s = merged
        r = half
    return Summary(*[x[0] for x in s])


def mean(s: Summary):
    return s.m1


def variance(s: Summary):
    """Sample variance with frequency weights: m2 / (w - 1)."""
    return s.m2 / torch.clamp(s.w - 1.0, min=1e-300)


def pop_variance(s: Summary):
    return s.m2 / torch.clamp(s.w, min=1e-300)


def stddev(s: Summary):
    return torch.sqrt(variance(s))


def skewness(s: Summary):
    """Population skewness g1 = (m3/w) / (m2/w)^1.5."""
    w = torch.clamp(s.w, min=1e-300)
    return (s.m3 / w) / torch.clamp((s.m2 / w) ** 1.5, min=1e-300)


def kurtosis(s: Summary):
    """Population kurtosis g2 = (m4/w) / (m2/w)^2 (3.0 for a normal)."""
    w = torch.clamp(s.w, min=1e-300)
    return (s.m4 / w) / torch.clamp((s.m2 / w) ** 2, min=1e-300)


# Cephes' rational approximations of the normal quantile, as
# jax.scipy.special.ndtri evaluates them (leading coefficient first,
# Horner from 0, rounded to the working dtype)
_NDTRI_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1,
             -5.66762857469070293439E1, 1.39312609387279679503E1,
             -1.23916583867381258016E0)
_NDTRI_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0,
             8.63602421390890590575E1, -2.25462687854119370527E2,
             2.00260212380060660359E2, -8.20372256168333339912E1,
             1.59056225126211695515E1, -1.18331621121330003142E0)
_NDTRI_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1,
             5.71628192246421288162E1, 4.40805073893200834700E1,
             1.46849561928858024014E1, 2.18663306850790267539E0,
             -1.40256079171354495875E-1, -3.50424626827848203418E-2,
             -8.57456785154685413611E-4)
_NDTRI_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1,
             4.13172038254672030440E1, 1.50425385692907503408E1,
             2.50464946208309415979E0, -1.42182922854787788574E-1,
             -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_NDTRI_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0,
             3.93881025292474443415E0, 1.33303460815807542389E0,
             2.01485389549179081538E-1, 1.23716634817820021358E-2,
             3.01581553508235416007E-4, 2.65806974686737550832E-6,
             6.23974539184983293730E-9)
_NDTRI_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0,
             1.37702099489081330271E0, 2.16236993594496635890E-1,
             1.34204006088543189037E-2, 3.28014464682127739104E-4,
             2.89247864745380683936E-6, 6.79019408009981274425E-9)


def _polyval(coefs, x):
    """jnp.polyval: Horner's rule from 0, each coefficient in x's dtype."""
    y = torch.zeros_like(x)
    for c in coefs:
        y = y * x + torch.tensor(c, dtype=x.dtype, device=x.device)
    return y


def ndtri(p: torch.Tensor) -> torch.Tensor:
    """The normal quantile, term for term as jax.scipy.special.ndtri
    evaluates it in ``p``'s dtype (f32 or f64)."""
    dt = p.dtype
    np_dt = {torch.float32: np.float32, torch.float64: np.float64}[dt]

    def c(v):  # a constant rounded to the dtype, as dtype(v) there
        return torch.tensor(float(np_dt(v)), dtype=dt, device=p.device)

    mcp = torch.where(p > c(-math.expm1(-2.0)), c(1.0) - p, p)
    mcp = torch.where(mcp == c(0.0), c(0.5), mcp)
    w = mcp - c(0.5)
    ww = w * w
    big = w + w * ww * (_polyval(_NDTRI_P0, ww) / _polyval(_NDTRI_Q0, ww))
    big = big * -c(math.sqrt(2.0 * math.pi))
    z = torch.sqrt(c(-2.0) * torch.log(mcp))
    first = z - torch.log(z) / z
    inv = 1 / z
    small = _polyval(_NDTRI_P2, inv) / _polyval(_NDTRI_Q2, inv) / z
    other = _polyval(_NDTRI_P1, inv) / _polyval(_NDTRI_Q1, inv) / z
    x = torch.where(mcp > c(math.exp(-2.0)), big,
                    torch.where(z >= c(8.0), first - small, first - other))
    x = torch.where(p > c(1.0 - math.exp(-2.0)), x, -x)
    inf = torch.full_like(p, math.inf)
    return torch.where(p == c(0.0), -inf, torch.where(p == c(1.0), inf, x))


def t_quantile(p, dof):
    """Student-t quantile t_{p, dof} by the Cornish-Fisher expansion
    around the normal quantile (Abramowitz & Stegun 26.7.5, four
    correction terms), as the reference computes it: within ~1e-4 of
    the true quantile for ``dof >= 4``; ``dof`` is clamped to >= 1."""
    real = config.real()
    z = ndtri(torch.as_tensor(p, dtype=real))
    v = torch.clamp(torch.as_tensor(dof, dtype=real), min=1.0)
    z2 = z * z
    g1 = (z2 + 1.0) * z / 4.0
    g2 = ((5.0 * z2 + 16.0) * z2 + 3.0) * z / 96.0
    g3 = (((3.0 * z2 + 19.0) * z2 + 17.0) * z2 - 15.0) * z / 384.0
    g4 = ((((79.0 * z2 + 776.0) * z2 + 1482.0) * z2 - 1920.0) * z2
          - 945.0) * z / 92160.0
    return z + (g1 + (g2 + (g3 + g4 / v) / v) / v) / v


def halfwidth(s: Summary, confidence: float = 0.95):
    """Confidence-interval halfwidth of the mean,
    ``t_{q, w-1} * sqrt(variance(s) / w)`` with ``q = 1 - (1-c)/2``;
    ``+inf`` for a summary of fewer than two samples (no variance
    estimate).  Raises on a confidence outside (0, 1)."""
    if not 0.0 < confidence < 1.0:
        raise ValueError(f"confidence must be in (0, 1), got {confidence}")
    q = 1.0 - (1.0 - confidence) / 2.0
    hw = t_quantile(q, s.w - 1.0) * torch.sqrt(
        variance(s) / torch.clamp(s.w, min=1e-300))
    return torch.where(s.w >= 2.0, hw, torch.full_like(hw, float("inf")))
