"""Fixed-capacity sample datasets: order statistics, histograms, ACF/PACF
(torch port of :mod:`cimba_tpu.stats.dataset`).

Parity: ``cmb_dataset`` — an array of doubles with sort, median, the
five-number summary, a text histogram, the ACF/PACF correlogram, merge
and summarize.  As in the reference the array has a fixed capacity:
``n`` counts the filled slots, a sample past the capacity is dropped and
counted, and empty slots hold ``+inf`` so a sort keeps them at the
tail.  The statistics are torch operations on the dataset's device; the
``*_str`` renderings are host-side numpy, as the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.stats import summary as _sm


class Dataset(NamedTuple):
    values: torch.Tensor   # [CAP] REAL; slots >= n hold +inf
    n: torch.Tensor        # i32 fill count
    dropped: torch.Tensor  # i32 samples lost to overflow


def create(capacity: int, device="cuda", dtype=None) -> Dataset:
    """An empty dataset of ``capacity`` slots in the profile's REAL
    dtype (or ``dtype``) on ``device`` (the card unless the caller asks
    for the CPU)."""
    dev = config.resolve_device(device)
    dt = config.real() if dtype is None else dtype
    return Dataset(
        values=torch.full((capacity,), float("inf"), dtype=dt, device=dev),
        n=torch.zeros((), dtype=torch.int32, device=dev),
        dropped=torch.zeros((), dtype=torch.int32, device=dev))


def add(ds: Dataset, x) -> Dataset:
    cap = ds.values.shape[0]
    ok = ds.n < cap
    idx = torch.clamp(ds.n, max=cap - 1).to(torch.int64)
    x = torch.as_tensor(x, dtype=ds.values.dtype, device=ds.values.device)
    vals = ds.values.clone()
    vals[idx] = torch.where(ok, x, ds.values[idx])
    return Dataset(values=vals, n=ds.n + ok.to(torch.int32),
                   dropped=ds.dropped + (~ok).to(torch.int32))


def merge(a: Dataset, b: Dataset) -> Dataset:
    """Concatenate b's samples into a (capacity permitting)."""
    cap = a.values.shape[0]
    idx_b = torch.arange(b.values.shape[0], device=a.values.device)
    dest = a.n + idx_b
    takes = (idx_b < b.n) & (dest < cap)
    vals = a.values.clone()
    vals[dest[takes].to(torch.int64)] = b.values[takes]
    n_new = torch.clamp(a.n + b.n, max=cap)
    dropped = a.dropped + b.dropped + (a.n + b.n - n_new)
    return Dataset(vals, n_new.to(torch.int32), dropped.to(torch.int32))


def _mask(ds: Dataset):
    return torch.arange(ds.values.shape[0], device=ds.values.device) < ds.n


def sort(ds: Dataset) -> Dataset:
    """Ascending sort; empty slots are +inf so they stay at the tail."""
    return ds._replace(values=torch.sort(ds.values).values)


def mean(ds: Dataset):
    m = _mask(ds)
    return (torch.where(m, ds.values, 0.0).sum()
            / torch.clamp(ds.n, min=1))


def quantile(ds: Dataset, q):
    """Linear-interpolated quantile of the filled prefix (any order;
    sorts internally)."""
    v = torch.sort(ds.values).values
    real = ds.values.dtype
    pos = q * (ds.n.to(real) - 1.0)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0,
                     ds.values.shape[0] - 1)
    hi = torch.minimum(torch.clamp(lo + 1, min=0),
                       torch.clamp(ds.n.to(torch.int64) - 1, min=0))
    frac = pos - lo.to(real)
    return v[lo] * (1.0 - frac) + v[hi] * frac


def median(ds: Dataset):
    return quantile(ds, 0.5)


def fivenum(ds: Dataset):
    """(min, Q1, median, Q3, max) of the filled prefix."""
    v = torch.sort(ds.values).values
    mx = v[torch.clamp(ds.n.to(torch.int64) - 1, min=0)]
    return (v[0], quantile(ds, 0.25), quantile(ds, 0.5), quantile(ds, 0.75),
            mx)


def summarize(ds: Dataset) -> _sm.Summary:
    """Fold the dataset into a moment Summary (one vectorized pass)."""
    m = _mask(ds)
    real = ds.values.dtype
    v = torch.where(m, ds.values, 0.0)
    n = ds.n.to(real)
    mu = v.sum() / torch.clamp(n, min=1.0)
    c = torch.where(m, ds.values - mu, 0.0)
    inf = float("inf")
    return _sm.Summary(
        n=n, w=n,
        mn=torch.where(m, ds.values, inf).amin(),
        mx=torch.where(m, ds.values, -inf).amax(),
        m1=mu, m2=(c * c).sum(), m3=_sm._pow3(c).sum(),
        m4=_sm._pow4(c).sum())


def acf(ds: Dataset, max_lag: int):
    """Autocorrelation function for lags 0..max_lag (the biased
    estimator, standard for correlograms).  Parity:
    ``cmb_dataset_ACF``."""
    m = _mask(ds)
    real = ds.values.dtype
    n = torch.clamp(ds.n.to(real), min=1.0)
    mu = torch.where(m, ds.values, 0.0).sum() / n
    c = torch.where(m, ds.values - mu, 0.0)
    denom = torch.clamp((c * c).sum(), min=1e-300)
    idx = torch.arange(c.shape[0], device=c.device)

    def lag_corr(k):
        shifted = torch.roll(c, -k)
        valid = idx < (ds.n - k)  # the wrapped tail is not data
        return torch.where(valid, c * shifted, 0.0).sum() / denom

    return torch.stack([lag_corr(k) for k in range(max_lag + 1)])


def pacf(ds: Dataset, max_lag: int):
    """Partial autocorrelations for lags 1..max_lag by Durbin-Levinson.
    Parity: ``cmb_dataset_PACF``."""
    rho = acf(ds, max_lag)
    phi = {}  # phi[(k, j)]: AR(k) coefficient j
    pacfs = []
    for k in range(1, max_lag + 1):
        if k == 1:
            phi_kk = rho[1]
        else:
            num = rho[k] - sum(phi[(k - 1, j)] * rho[k - j]
                               for j in range(1, k))
            den = 1.0 - sum(phi[(k - 1, j)] * rho[j] for j in range(1, k))
            phi_kk = num / torch.where(den.abs() > 1e-300, den,
                                       torch.full_like(den, 1e-300))
        for j in range(1, k):
            phi[(k, j)] = phi[(k - 1, j)] - phi_kk * phi[(k - 1, k - j)]
        phi[(k, k)] = phi_kk
        pacfs.append(phi_kk)
    return torch.stack(pacfs)


# --- host-side text rendering (parity: cmb_dataset_*_print) -------------


def histogram_str(ds: Dataset, bins: int = 20, width: int = 50) -> str:
    v = ds.values.detach().cpu().numpy()[: int(ds.n)]
    if v.size == 0:
        return "(empty dataset)"
    counts, edges = np.histogram(v, bins=bins)
    peak = max(counts.max(), 1)
    lines = []
    for c, lo, hi in zip(counts, edges[:-1], edges[1:]):
        bar = "#" * int(round(width * c / peak))
        lines.append(f"[{lo:12.5g}, {hi:12.5g}) {c:8d} {bar}")
    return "\n".join(lines)


def fivenum_str(ds: Dataset) -> str:
    mn, q1, md, q3, mx = (float(x) for x in fivenum(ds))
    return (f"min {mn:.6g}  Q1 {q1:.6g}  median {md:.6g}  "
            f"Q3 {q3:.6g}  max {mx:.6g}")


def correlogram_str(ds: Dataset, max_lag: int = 20, width: int = 40) -> str:
    rho = acf(ds, max_lag).detach().cpu().numpy()
    lines = []
    half = width // 2
    for k, r in enumerate(rho):
        pos = int(round(half + r * half))
        line = [" "] * (width + 1)
        line[half] = "|"
        lo, hi = sorted((half, pos))
        for i in range(lo, hi + 1):
            line[i] = "*" if i != half else "|"
        lines.append(f"lag {k:3d} {r:+.4f} {''.join(line)}")
    return "\n".join(lines)
