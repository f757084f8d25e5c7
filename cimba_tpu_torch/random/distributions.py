"""Random variates on Threefry streams (torch port, mm1 subset).

Counterpart of :mod:`cimba_tpu.random.distributions`: ``uniform01``,
``uniform01_53``, ``std_exponential`` and ``exponential``, with both
profile branches.  Every sampler is ``fn(state, *params) -> (state, x)``
on a batch of streams and consumes one counter tick per draw, exactly as
the reference does.  The profile is read from the active config; the
rest of the catalogue is still to port (ROADMAP queue A).
"""

from __future__ import annotations

import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.random.bits import RandomState, next_bits64


def _u24(b1, dtype):
    # f32 profile: 24 bits is the widest exact f32 significand (a full
    # u32->f32 convert rounds values near 2**32 up to 1.0)
    return (b1 >> 8).to(torch.int32).to(dtype) * (2.0**-24)


def uniform01(st: RandomState):
    """Uniform on [0, 1): 32-bit resolution in f64, 24 in f32 (1 draw)."""
    st, _, b1 = next_bits64(st)
    dt = config.real()
    if dt == torch.float32:
        return st, _u24(b1, dt)
    return st, b1.to(dt) * (2.0**-32)


def uniform01_53(st: RandomState):
    """Uniform on [0, 1) with 53-bit resolution in f64,
    ``b1 * 2**-32 + (b0 >> 11) * 2**-53``; 24 bits in f32 (1 draw)."""
    st, b0, b1 = next_bits64(st)
    dt = config.real()
    if dt == torch.float32:
        return st, _u24(b1, dt)
    hi = b1.to(dt) * (2.0**-32)
    lo = (b0 >> 11).to(dt) * (2.0**-53)
    return st, hi + lo


def std_exponential(st: RandomState):
    """Unit-mean exponential by inversion, ``-log1p(-u)`` (1 draw)."""
    st, u = uniform01_53(st)
    return st, -torch.log1p(-u)


def exponential(st: RandomState, mean):
    st, x = std_exponential(st)
    return st, mean * x
