"""Time-weighted series recording of piecewise-constant signals (torch
port of :mod:`cimba_tpu.stats.timeseries`).

Each recorded value holds until the next record; ``step_finalize(t)``
closes the last interval and ``summarize`` gives the weighted summary.
Two forms, both lane-batched like :mod:`cimba_tpu_torch.stats.summary`
(every field a tensor of the same batch shape):

* :class:`StepAccum` — the hot-loop form the engine carries for a
  recording queue: segments stream into a weighted
  :class:`~cimba_tpu_torch.stats.summary.Summary` (O(1) state);
* :class:`Timeseries` — the full recorder with fixed-capacity (time,
  value) arrays (the last axis), for post-analysis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.stats import summary as _sm


class StepAccum(NamedTuple):
    """Streaming time-weighted accumulator for a piecewise-constant signal."""

    summary: _sm.Summary
    last_t: torch.Tensor
    last_v: torch.Tensor
    started: torch.Tensor  # bool: has any record happened


def _maximum0(x):
    # jnp.maximum(x, 0.0): NaN propagates
    return torch.where(torch.isnan(x) | (x > 0), x, torch.zeros_like(x))


def step_create(t0=0.0, v0=0.0, shape=(), device="cuda",
                dtype=None) -> StepAccum:
    """An accumulator of batch ``shape`` that starts at ``(t0, v0)``, on
    ``device`` (the card unless the caller asks for ``"cpu"``)."""
    device = config.resolve_device(device)
    dt = config.real() if dtype is None else dtype
    return StepAccum(
        summary=_sm.empty(shape, device, dt),
        last_t=torch.full(shape, float(t0), dtype=dt, device=device),
        last_v=torch.full(shape, float(v0), dtype=dt, device=device),
        started=torch.zeros(shape, dtype=torch.bool, device=device),
    )


def step_record(acc: StepAccum, t, v) -> StepAccum:
    """Record signal value ``v`` effective at time ``t``; the previous
    value is credited with weight ``t - last_t``."""
    dt, dev = acc.last_t.dtype, acc.last_t.device
    t = torch.as_tensor(t, dtype=dt, device=dev).expand_as(acc.last_t)
    v = torch.as_tensor(v, dtype=dt, device=dev).expand_as(acc.last_t)
    dur = _maximum0(t - acc.last_t)
    new_sum = _sm.add(acc.summary, acc.last_v, dur)
    # zero-duration segments contribute nothing but must not corrupt moments
    pos = dur > 0.0
    summary = _sm.Summary(*[torch.where(pos, a, b)
                            for a, b in zip(new_sum, acc.summary)])
    return StepAccum(summary=summary, last_t=t, last_v=v,
                     started=torch.ones_like(acc.started))


def step_finalize(acc: StepAccum, t_end) -> _sm.Summary:
    """Close the last interval at ``t_end`` and return the weighted
    summary."""
    t = torch.as_tensor(t_end, dtype=acc.last_t.dtype,
                        device=acc.last_t.device)
    return _sm.add(acc.summary, acc.last_v, _maximum0(t - acc.last_t))


class Timeseries(NamedTuple):
    times: torch.Tensor    # [..., CAP]
    values: torch.Tensor   # [..., CAP]
    n: torch.Tensor        # [...] i32
    dropped: torch.Tensor  # [...] i32


def create(capacity: int, t0=0.0, shape=(), device="cuda",
           dtype=None) -> Timeseries:
    device = config.resolve_device(device)
    dt = config.real() if dtype is None else dtype
    full = tuple(shape) + (capacity,)
    return Timeseries(
        times=torch.full(full, float(t0), dtype=dt, device=device),
        values=torch.zeros(full, dtype=dt, device=device),
        n=torch.zeros(shape, dtype=torch.int32, device=device),
        dropped=torch.zeros(shape, dtype=torch.int32, device=device),
    )


def add(ts: Timeseries, t, v) -> Timeseries:
    """Append ``(t, v)``; a full series counts the record as dropped."""
    cap = ts.times.shape[-1]
    ok = ts.n < cap
    idx = ts.n.clamp(max=cap - 1).to(torch.int64).unsqueeze(-1)
    dt, dev = ts.times.dtype, ts.times.device

    def put(arr, x):
        x = torch.as_tensor(x, dtype=dt, device=dev).expand(ts.n.shape)
        old = arr.gather(-1, idx).squeeze(-1)
        return arr.scatter(-1, idx, torch.where(ok, x, old).unsqueeze(-1))

    return Timeseries(
        times=put(ts.times, t),
        values=put(ts.values, v),
        n=ts.n + ok.to(torch.int32),
        dropped=ts.dropped + (~ok).to(torch.int32),
    )


def durations(ts: Timeseries, t_end):
    """Piecewise-constant durations: value i holds from times[i] to
    times[i+1] (the last until ``t_end``)."""
    cap = ts.times.shape[-1]
    idx = torch.arange(cap, device=ts.times.device)
    n = ts.n.unsqueeze(-1)
    t_end = torch.as_tensor(t_end, dtype=ts.times.dtype,
                            device=ts.times.device)
    nxt = torch.where(idx + 1 < n, torch.roll(ts.times, -1, dims=-1), t_end)
    dur = torch.where(idx < n, nxt - ts.times, torch.zeros_like(ts.times))
    return _maximum0(dur)


def summarize(ts: Timeseries, t_end) -> _sm.Summary:
    """Weighted summary of the recorded signal over [times[0], t_end]."""
    dur = durations(ts, t_end)
    mask = dur > 0.0
    w = dur.sum(dim=-1)
    # jnp.maximum(w, 1e-300) with the bound in the profile's dtype (0 in
    # f32, where 1e-300 underflows)
    floor = torch.tensor(1e-300, dtype=w.dtype, device=w.device)
    safe_w = torch.where(torch.isnan(w) | (w > floor), w, floor)
    mu = (ts.values * dur).sum(dim=-1) / safe_w
    c = torch.where(mask, ts.values - mu.unsqueeze(-1),
                    torch.zeros_like(ts.values))
    inf = torch.full_like(ts.values, float("inf"))
    return _sm.Summary(
        n=ts.n.to(ts.values.dtype),
        w=w,
        mn=torch.where(mask, ts.values, inf).amin(dim=-1),
        mx=torch.where(mask, ts.values, -inf).amax(dim=-1),
        m1=mu,
        m2=(dur * c * c).sum(dim=-1),
        m3=(dur * (c * (c * c))).sum(dim=-1),
        m4=(dur * ((c * c) * (c * c))).sum(dim=-1),
    )
