"""Vose alias tables for O(1) discrete sampling (torch port).

Counterpart of :mod:`cimba_tpu.random.alias`: the table is built on the
host in NumPy (Vose '91), exactly as the reference builds it, and
sampling is one 64-bit draw and two gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.random.bits import RandomState, next_bits64
from cimba_tpu_torch.random.distributions import _u24


class AliasTable(NamedTuple):
    """Static sampling table."""

    prob: torch.Tensor   # [n] REAL: acceptance probability of column i
    alias: torch.Tensor  # [n] int32: fallback index of column i


def alias_create(weights, *, device="cuda") -> AliasTable:
    """Alias table of unnormalised weights, on ``device`` (the card
    unless the caller asks for the CPU)."""
    dev = config.resolve_device(device)
    w = np.asarray(weights, dtype=np.float64)
    n = w.shape[0]
    if n == 0:
        raise ValueError("alias table needs at least one weight")
    if np.any(w < 0.0) or not np.all(np.isfinite(w)) or w.sum() <= 0.0:
        raise ValueError("weights must be finite, non-negative, not all zero")
    p = w * (n / w.sum())
    prob = np.zeros(n, dtype=np.float64)
    alias = np.zeros(n, dtype=np.int32)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = (p[l] + p[s]) - 1.0
        (small if p[l] < 1.0 else large).append(l)
    for i in large + small:  # numerical leftovers are certain columns
        prob[i] = 1.0
        alias[i] = i
    return AliasTable(torch.tensor(prob, dtype=config.real(), device=dev),
                      torch.tensor(alias, dtype=torch.int32, device=dev))


def alias_sample(st: RandomState, table: AliasTable):
    """An index by ONE 64-bit draw: the low word picks the column (mod
    n), the high word is the acceptance coin (24 bits in f32)."""
    n = table.prob.shape[0]
    st, b0, b1 = next_bits64(st)
    col = b0 % n
    real = config.real()
    u = _u24(b1, real) if real == torch.float32 else b1.to(real) * 2.0**-32
    take_alias = u >= table.prob[col]
    return st, torch.where(take_alias, table.alias[col].to(torch.int64),
                           col).to(config.count())
