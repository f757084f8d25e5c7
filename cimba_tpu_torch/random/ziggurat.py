"""Ziggurat samplers for the standard exponential and normal (torch port).

Counterpart of :mod:`cimba_tpu.random.ziggurat`: 256-layer ziggurats over
the tables of :mod:`cimba_tpu_torch.random._ziggurat_tables`.  Each round
computes every path — the hot accept, the y-test and the tail — and
selects, so a round consumes the draws of every path, exactly as the
reference's batched rounds do; rounds repeat per lane until accepted.

Layer geometry: X[j] increases with j, X[0] = 0, X[255] = r, Y[j] =
f(X[j]).  Layer j >= 1 is the rectangle of width X[j] spanning y in
[Y[j], Y[j-1]]; layer 0 is the base rectangle [0, r] x [0, f(r)] plus
the tail beyond r.
"""

from __future__ import annotations

import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.random import _ziggurat_tables as _t
from cimba_tpu_torch.random.bits import RandomState, next_bits64
from cimba_tpu_torch.random.distributions import (
    _max, _while, std_exponential, uniform01, uniform01_53)


def _table(values, st: RandomState) -> torch.Tensor:
    return torch.tensor(values, dtype=config.real(), device=st.key0.device)


def _zig_draw(st, xtab, ytab, r, v, f, tail_sample):
    """Ziggurat rounds until each lane accepts (3 or more draws a round:
    the layer word, the y-test uniform and the tail's)."""
    lanes, dev = st.key0.shape, st.key0.device
    real = config.real()
    base_w = torch.tensor(v, dtype=real, device=dev) / ytab[255]

    def body(carry):
        st, _, _ = carry
        st, b0, b1 = next_bits64(st)
        layer = b0 & 0xFF
        u1 = b1.to(real) * (2.0**-32)
        is0 = layer == 0
        # layer 0: the base rectangle and the tail, sampled by the width
        # trick: x uniform on [0, v / f(r)] is accepted iff x < r
        x = u1 * torch.where(is0, base_w, xtab[layer])
        hot = x < torch.where(is0, torch.full_like(x, r), xtab[layer - 1])
        st, u2 = uniform01(st)
        ylo = ytab[layer]
        yhi = torch.where(is0, ytab[255], ytab[layer - 1])
        y = ylo + u2 * (yhi - ylo)
        interior_ok = ~is0 & (y < f(x))
        st, xt = tail_sample(st)
        is_tail = is0 & ~hot
        return st, hot | interior_ok | is_tail, torch.where(is_tail, xt, x)

    st, _, x = _while(
        lambda c: ~c[1], body,
        (st, torch.zeros(lanes, dtype=torch.bool, device=dev),
         torch.zeros(lanes, dtype=real, device=dev)))
    return st, x


def std_exponential_zig(st: RandomState):
    """Unit-mean exponential by the 256-layer ziggurat."""

    def tail(st):
        # memoryless: the tail beyond r is r + Exp(1), exactly
        st, e = std_exponential(st)
        return st, _t.R_EXP + e

    return _zig_draw(st, _table(_t.X_EXP, st), _table(_t.Y_EXP, st),
                     _t.R_EXP, _t.V_EXP, lambda x: torch.exp(-x), tail)


def std_normal_zig(st: RandomState):
    """Standard normal by the 256-layer ziggurat (half-normal and a
    random sign, one more draw)."""
    r = _t.R_NOR

    def tail(st):
        # Marsaglia's tail: x = -ln(u1) / r, y = -ln(u2), accepted when
        # 2y > x^2; the value is r + x
        lanes, dev = st.key0.shape, st.key0.device

        def body(carry):
            st, _, _ = carry
            st, u1 = uniform01_53(st)
            st, u2 = uniform01_53(st)
            x = -torch.log(_max(u1, 1e-300)) / r
            y = -torch.log(_max(u2, 1e-300))
            return st, 2.0 * y > x * x, r + x

        st, _, x = _while(
            lambda c: ~c[1], body,
            (st, torch.zeros(lanes, dtype=torch.bool, device=dev),
             torch.zeros(lanes, dtype=config.real(), device=dev)))
        return st, x

    st, x = _zig_draw(st, _table(_t.X_NOR, st), _table(_t.Y_NOR, st), r,
                      _t.V_NOR, lambda x: torch.exp(-0.5 * x * x), tail)
    st, b0, _ = next_bits64(st)
    return st, torch.where((b0 & 1) == 0, x, -x)
