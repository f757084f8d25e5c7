"""Random variates on Threefry streams: the full catalogue (torch port).

Counterpart of :mod:`cimba_tpu.random.distributions`.  Every sampler is
``fn(state, *params) -> (state, x)`` on a batch of streams (the lanes are
the state tensors' shape; a parameter is a Python number or a tensor that
broadcasts over the lanes) and consumes exactly the counter ticks the
reference consumes, so the draw streams stay aligned with the JAX
package's.  The dtype profile is read from the active config.

* Python-number parameters keep the reference's weak typing: arithmetic
  between them is done in Python doubles and the result is rounded to
  the profile's dtype where it meets a tensor, as JAX does with weakly
  typed scalars.  Parameters the reference casts with ``jnp.asarray(x,
  REAL)`` are cast the same way here.
* The reference's rejection samplers are ``lax.while_loop``\\ s under
  ``vmap``.  :func:`_while` is that loop written out: the body runs on
  every lane while any lane is active, and a lane's carry (its counter
  included) changes only while the lane is active.
* ``std_normal`` evaluates XLA's ``erf_inv`` polynomial (:func:`_erf_inv`)
  and never ``torch.erfinv``, whose values differ from XLA's.
"""

from __future__ import annotations

import math

import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.random.bits import RandomState, next_bits64

_INV_2_53 = 1.0 / 9007199254740992.0  # 2**-53


def _lanes(st: RandomState):
    return st.key0.shape, st.key0.device


def _real_t(x, st: RandomState) -> torch.Tensor:
    """``jnp.asarray(x, REAL)`` on the stream's device."""
    return torch.as_tensor(x, dtype=config.real(), device=st.key0.device)


def _int_t(x, st: RandomState) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=st.key0.device)


def _select(mask, a, b):
    """``jnp.where(mask, a, b)`` leaf by leaf over tuples and states."""
    if isinstance(a, torch.Tensor):
        return torch.where(mask, a, b)
    leaves = [_select(mask, x, y) for x, y in zip(a, b)]
    return type(a)(*leaves) if isinstance(a, RandomState) else tuple(leaves)


def _while(cond, body, carry):
    """``lax.while_loop(cond, body, carry)`` batched over lanes, as
    ``vmap`` runs it: while any lane's ``cond`` holds, ``body`` runs on
    every lane and only the active lanes keep its result."""
    active = cond(carry)
    while bool(active.any()):
        carry = _select(active, body(carry), carry)
        active = cond(carry)
    return carry


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


def _u53(b0, b1, dt):
    """uniform01_53 of one pair of words in dtype ``dt``."""
    if dt == torch.float32:
        return _u24(b1, dt)
    hi = b1.to(dt) * (2.0**-32)
    lo = (b0 >> 11).to(dt) * (2.0**-53)
    return hi + lo


def uniform01_53(st: RandomState):
    """Uniform on [0, 1) with 53-bit resolution in f64,
    ``b1 * 2**-32 + (b0 >> 11) * 2**-53``; 24 bits in f32 (1 draw)."""
    st, b0, b1 = next_bits64(st)
    return st, _u53(b0, b1, config.real())


def uniform(st, lo, hi):
    st, u = uniform01(st)
    return st, lo + (hi - lo) * u


def triangular(st, lo, mode, hi):
    """Triangular on [lo, hi] with the given mode (inversion)."""
    st, u = uniform01(st)
    fc = (mode - lo) / (hi - lo)
    left = lo + torch.sqrt(u * (hi - lo) * (mode - lo))
    right = hi - torch.sqrt((1.0 - u) * (hi - lo) * (hi - mode))
    return st, torch.where(u < fc, left, right)


def std_exponential(st: RandomState):
    """Unit-mean exponential by inversion, ``-log1p(-u)`` (1 draw)."""
    st, u = uniform01_53(st)
    return st, -torch.log1p(-u)


def exponential(st: RandomState, mean):
    st, x = std_exponential(st)
    return st, mean * x


# XLA's erf_inv (chlo legalisation, as jax/_src/pallas/utils.py writes
# it): Giles' polynomials in w = -log1p(-x*x).  f32: two branches of 9
# terms, split at w = 5; f64: three branches of 23, 19 and 17 terms,
# split at w = 6.25 and w = 16.  Leading coefficient first.
_ERFINV32_LT5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV32_GE5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)
_ERFINV64_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356,
)
_ERFINV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635,
)
_ERFINV64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221,
)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """Inverse error function, evaluated as XLA evaluates it in the
    tensor's dtype (f32 or f64), including ``erf_inv(+-1) = +-inf``."""

    def pick(mask, a, b):
        return torch.where(mask, torch.full_like(x, a), b)

    w = -torch.log1p(x * -x)
    if x.dtype == torch.float32:
        lt5 = w < 5.0
        w = torch.where(lt5, w - 2.5, torch.sqrt(w) - 3.0)
        p = pick(lt5, _ERFINV32_LT5[0], _ERFINV32_GE5[0])
        for a, b in zip(_ERFINV32_LT5[1:], _ERFINV32_GE5[1:]):
            p = pick(lt5, a, b) + p * w
    else:
        lt625, lt16 = w < 6.25, w < 16.0

        def coef(i):
            c = torch.full_like(x, _ERFINV64_LT625[i])
            if i < 19:
                c = torch.where(lt625, c, _ERFINV64_LT16[i])
            if i < 17:
                c = torch.where(lt16, c, _ERFINV64_GE16[i])
            return c

        w = torch.where(lt625, w - 3.125,
                        torch.sqrt(w) - pick(lt16, 3.25, 5.0))
        p = coef(0)
        for i in range(1, 17):
            p = coef(i) + p * w
        for i in range(17, 19):
            p = torch.where(lt16, coef(i) + p * w, p)
        for i in range(19, 23):
            p = torch.where(lt625, coef(i) + p * w, p)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _normal_of(u: torch.Tensor) -> torch.Tensor:
    """sqrt(2) * erf_inv(2u - 1), clipped one step of the dtype inside
    (-1, 1) (a fixed 1e-16 would round to -1 in f32 and leak -inf)."""
    tiny = torch.finfo(u.dtype).eps / 2.0
    x = torch.clamp(2.0 * u - 1.0, -1.0 + tiny, 1.0 - tiny)
    return math.sqrt(2.0) * _erf_inv(x)


def std_normal(st: RandomState):
    """Standard normal by inversion, sqrt(2) * erf_inv(2u - 1) (1 draw)."""
    st, u = uniform01_53(st)
    return st, _normal_of(u)


def normal(st, mu, sigma):
    st, z = std_normal(st)
    return st, mu + sigma * z


def lognormal(st, m, s):
    """exp(N(m, s))."""
    st, z = normal(st, m, s)
    return st, torch.exp(z)


def logistic(st, m, s):
    st, u = uniform01(st)
    u = torch.clamp(u, 1e-300, 1.0 - 1e-16)
    return st, m + s * torch.log(u / (1.0 - u))


def cauchy(st, mode, scale):
    st, u = uniform01(st)
    return st, mode + scale * torch.tan(math.pi * (u - 0.5))


def erlang(st, k, mean):
    """Sum of k exponentials of mean ``mean`` (k draws; k per lane)."""
    shape, dev = _lanes(st)
    k = torch.as_tensor(k, dtype=torch.int32, device=dev).expand(shape)

    def body(c):
        st, i, acc = c
        st, x = std_exponential(st)
        return st, i + 1, acc + x

    st, _, total = _while(
        lambda c: c[1] < k, body,
        (st, torch.zeros(shape, dtype=torch.int32, device=dev),
         torch.zeros(shape, dtype=config.real(), device=dev)))
    return st, mean * total


def hypoexponential(st, means):
    """Series of exponential stages with per-stage means (len(means)
    draws)."""
    means = _real_t(means, st)
    total = torch.zeros(_lanes(st)[0], dtype=config.real(),
                        device=st.key0.device)
    for i in range(means.shape[0]):
        st, x = std_exponential(st)
        total = total + means[i] * x
    return st, total


def hyperexponential(st, probs, means):
    """Mixture of exponentials: stage i with probability probs[i], then
    an exponential of mean means[i] (2 draws)."""
    means = _real_t(means, st)
    st, i = discrete_nonuniform(st, probs)
    st, x = std_exponential(st)
    return st, means[i] * x


def _max(x, floor):
    """``jnp.maximum(x, floor)`` (NaN propagates)."""
    return torch.maximum(x, torch.full_like(x, floor))


def std_gamma(st, shape):
    """Gamma(shape, 1) by Marsaglia-Tsang; shapes < 1 boosted by
    U^(1/shape).  Rounds until accepted, per lane."""
    shape = _real_t(shape, st)
    boosted = shape < 1.0
    d_shape = torch.where(boosted, shape + 1.0, shape)
    d = d_shape - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    lanes, dev = _lanes(st)

    def body(carry):
        st, _, _ = carry
        st, z = std_normal(st)
        st, u = uniform01(st)
        y = 1.0 + c * z
        v = y * y * y
        ok_v = v > 0.0
        lhs = torch.log(_max(u, 1e-300))
        rhs = 0.5 * z * z + d - d * v + d * torch.log(_max(v, 1e-300))
        return st, ok_v & (lhs < rhs), d * v

    st, _, x = _while(
        lambda c: ~c[1], body,
        (st, torch.zeros(lanes, dtype=torch.bool, device=dev),
         torch.zeros(lanes, dtype=config.real(), device=dev)))
    st, u = uniform01(st)
    u = _max(u, 1e-300)
    boost = torch.where(boosted, u ** (1.0 / _max(shape, 1e-12)), 1.0)
    return st, x * boost


def gamma(st, shape, scale):
    st, x = std_gamma(st, shape)
    return st, scale * x


def std_beta(st, a, b):
    """Beta(a, b) from two gammas: X / (X + Y)."""
    st, x = std_gamma(st, a)
    st, y = std_gamma(st, b)
    return st, x / (x + y)


def beta(st, a, b, lo, hi):
    st, z = std_beta(st, a, b)
    return st, lo + (hi - lo) * z


def pert_mod(st, lo, mode, hi, lam):
    """Modified PERT: a beta on [lo, hi] with peakiness ``lam``."""
    span = hi - lo
    a = 1.0 + lam * (mode - lo) / span
    b = 1.0 + lam * (hi - mode) / span
    return beta(st, a, b, lo, hi)


def pert(st, lo, mode, hi):
    """Classic PERT: mean (lo + 4 mode + hi) / 6."""
    return pert_mod(st, lo, mode, hi, 4.0)


def weibull(st, shape, scale):
    st, x = std_exponential(st)
    return st, scale * x ** (1.0 / shape)


def pareto(st, shape, mode):
    """Pareto on [mode, inf): mode / U^(1/shape)."""
    st, u = uniform01(st)
    u = _max(1.0 - u, _INV_2_53)  # (0, 1]
    return st, mode / u ** (1.0 / shape)


def chisquared(st, k):
    """Chi-squared with k (possibly fractional) degrees of freedom."""
    st, x = std_gamma(st, k * 0.5)
    return st, 2.0 * x


def f_dist(st, a, b):
    st, x = chisquared(st, a)
    st, y = chisquared(st, b)
    return st, (x / a) / (y / b)


def std_t_dist(st, v):
    st, z = std_normal(st)
    st, x = chisquared(st, v)
    return st, z / torch.sqrt(x / v)


def t_dist(st, m, s, v):
    st, t = std_t_dist(st, v)
    return st, m + s * t


def rayleigh(st, s):
    st, x = std_exponential(st)
    return st, s * torch.sqrt(2.0 * x)


# --- discrete ---------------------------------------------------------------


def flip(st):
    """Fair coin in {0, 1} (1 draw)."""
    st, b0, _ = next_bits64(st)
    return st, (b0 & 1).to(torch.int32)


def bernoulli(st, p):
    st, u = uniform01(st)
    return st, (u < p).to(torch.int32)


def _log1p(p):
    # a Python number is a weakly typed f64 in the reference: its log1p
    # is taken in f64 before it meets the profile's dtype
    if isinstance(p, torch.Tensor):
        return torch.log1p(p)
    return math.log1p(p)


def geometric(st, p):
    """Trials up to and including the first success, by inversion:
    ceil(log1p(-u) / log1p(-p)), at least 1."""
    st, u = uniform01(st)
    ratio = torch.log1p(-u) / _log1p(-p)
    return st, _max(torch.ceil(ratio), 1.0).to(torch.int64)


def _count_loop(st, n, draw):
    """Sum of ``draw(st)`` over n rounds per lane (int64)."""
    shape, dev = _lanes(st)
    n = _int_t(n, st).expand(shape)

    def body(c):
        st, i, acc = c
        st, x = draw(st)
        return st, i + 1, acc + x.to(torch.int64)

    zero = torch.zeros(shape, dtype=torch.int64, device=dev)
    st, _, total = _while(lambda c: c[1] < n, body, (st, zero, zero))
    return st, total


def binomial(st, n, p):
    """Successes in n Bernoulli trials (n draws)."""
    return _count_loop(st, n, lambda s: bernoulli(s, p))


def negative_binomial(st, m, p):
    """Failures before the m-th success (m geometric draws)."""

    def failures(s):
        s, g = geometric(s, p)
        return s, g - 1

    return _count_loop(st, m, failures)


def pascal(st, m, p):
    """Trials to the m-th success: negative_binomial + m."""
    st, nb = negative_binomial(st, m, p)
    return st, nb + _int_t(m, st)


def poisson(st, rate):
    """Poisson(rate): Knuth's product of uniforms below rate 10, Hörmann's
    PTRS from 10 up.  Per lane, as the reference's ``lax.cond`` under
    ``vmap``: a branch runs on every lane if any lane needs it, and each
    lane keeps the state and value of its own branch."""
    rate = _real_t(rate, st)
    shape, dev = _lanes(st)
    small = (rate < 10.0).expand(shape)
    zeros = torch.zeros(shape, dtype=torch.int64, device=dev)

    def knuth(st):
        limit = torch.exp(-torch.clamp(rate, max=10.0))

        def body(c):
            st, prod, k = c
            st, u = uniform01(st)
            return st, prod * u, k + 1

        st, _, k = _while(
            lambda c: c[1] >= limit, body,
            (st, torch.ones(shape, dtype=config.real(), device=dev),
             zeros - 1))
        return st, k

    def ptrs(st):
        r = torch.clamp(rate, min=10.0)
        b = 0.931 + 2.53 * torch.sqrt(r)
        a = -0.059 + 0.02483 * b
        inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
        v_r = 0.9277 - 3.6224 / (b - 2.0)
        log_rate = torch.log(r)

        def body(carry):
            st, _, _ = carry
            st, u = uniform01(st)
            u = u - 0.5
            st, v = uniform01(st)
            us = 0.5 - torch.abs(u)
            k = torch.floor((2.0 * a / us + b) * u + r + 0.43)
            fast = (us >= 0.07) & (v <= v_r)
            bad = (k < 0.0) | ((us < 0.013) & (v > us))
            lhs = torch.log(v * inv_alpha / (a / (us * us) + b))
            rhs = -r + k * log_rate - torch.lgamma(k + 1.0)
            return st, fast | (~bad & (lhs <= rhs)), k

        st, _, k = _while(
            lambda c: ~c[1], body,
            (st, torch.zeros(shape, dtype=torch.bool, device=dev),
             torch.zeros(shape, dtype=config.real(), device=dev)))
        return st, k.to(torch.int64)

    if bool(small.all()):
        return knuth(st)
    if not bool(small.any()):
        return ptrs(st)
    return _select(small, knuth(st), ptrs(st))


def _mod_u64(b0, b1, n):
    """(b1 * 2**32 + b0) mod n for u32 words in int64 and 0 < n < 2**47:
    long division in 16-bit digits, so no step leaves int64 (torch has
    no unsigned 64-bit remainder)."""
    r = b1 % n
    r = ((r << 16) | (b0 >> 16)) % n
    return ((r << 16) | (b0 & 0xFFFF)) % n


def discrete_uniform(st, n):
    """Integer in [0, n) (1 draw; the 64-bit word mod n)."""
    n = _int_t(n, st)
    if bool((n <= 0).any()) or bool((n >= 2**47).any()):
        raise ValueError("discrete_uniform needs 0 < n < 2**47")
    st, b0, b1 = next_bits64(st)
    return st, _mod_u64(b0, b1, n)


def dice(st, a, b):
    """Integer in [a, b] inclusive."""
    st, i = discrete_uniform(st, b - a + 1)
    return st, a + i


def discrete_nonuniform(st, probs):
    """Index i with probability probs[i] / sum(probs) (1 draw)."""
    probs = _real_t(probs, st)
    cdf = torch.cumsum(probs, 0)
    st, u = uniform01(st)
    target = u * cdf[-1]
    idx = (cdf <= target[..., None]).sum(-1, dtype=torch.int64)
    return st, torch.clamp(idx, max=probs.shape[0] - 1)


def loaded_dice(st, a, b, probs):
    """Integer in [a, b] with per-face weights (len(probs) == b - a + 1)."""
    if isinstance(a, int) and isinstance(b, int) and len(probs) != b - a + 1:
        raise ValueError(f"loaded_dice needs {b - a + 1} weights for "
                         f"[{a}, {b}], got {len(probs)}")
    st, i = discrete_nonuniform(st, probs)
    return st, a + i
