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

from typing import NamedTuple

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
