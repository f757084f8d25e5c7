"""Bulk variate generation on the card: [R, n] blocks of Threefry draws.

Counterpart of :mod:`cimba_tpu.random.pallas_kernels`, whose three Pallas
kernels (``_run`` <- ``exponential_block``, ``normal_block``,
``exponential_block_zig``) become the hand-written CUDA kernels of
``csrc/bulk_samplers.cu``: each thread draws a run of consecutive samples
of one row (K2 and K3: 8 in f32, 8 and 4 in f64; K4: 8) on a grid sized
from the card, and K4's warps gather their rare round-1 misses and work
through them 32 at a time.

Counter contract: sample j of stream r consumes counter base_r + j, so
``exponential_block``/``normal_block`` equal n sequential
``std_exponential``/``std_normal`` draws per stream, in both profiles.
``exponential_block_zig`` runs ``_ZK`` = 2 ziggurat rounds and an exact
inversion fallback over counters strided by n (round k: the layer word
at base + 2kn + j, the tail word at base + (2k+1)n + j; the fallback at
base + 4n + j) and consumes 5n counters.

Profiles.  In f64 the kernels compute exactly what the JAX kernels
compute.  In f32 the uniform of every inversion (K2, K3, K4's tail and
fallback) is the profile's ``uniform01_53``, 24 bits of the high word,
and the normal's clip is one f32 step inside (-1, 1), so the f32 blocks
equal the sequential f32 samplers as the counter contract says; the JAX
f32 kernels convert the full 32-bit word (which rounds to 1.0 near
2**32) and clip at a fixed 1e-16 (which rounds to 1.0), and so return
``inf`` about once in 2**25 draws.  K4's layer, x and y tests are the
JAX kernel's in both profiles.

Each sampler takes a batch of streams (``RandomState`` of [R] words) and
returns ``(advanced states, [R, n] samples)``.  On CUDA states each call
is one launch of its kernel (``<sampler>.launches`` counts them), which
also writes the advanced counters; a failed build or launch raises.  On
CPU states the sampler runs its plain PyTorch version (``*_plain``),
which computes the block over an [R, n] counter grid and is what the
kernels are held against.
"""

from __future__ import annotations

import ctypes

import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.config import BITS, MASK32
from cimba_tpu_torch.random import _ziggurat_tables as _zt
from cimba_tpu_torch.random.bits import RandomState, threefry2x32
from cimba_tpu_torch.random.distributions import (
    _u53, std_exponential, std_normal)

_ZK = 2  # ziggurat rounds before the fallback; P(no accept) ~ 0.02**_ZK
#: the paths of a K4 sample, by the code ``_exp_zig_plain`` gives it:
#: round 1's hot test, wedge or layer-0 tail, the same in round 2 (a
#: rejected wedge goes on to it), then the fallback; the tails and the
#: fallback take a log1p (the codes in ``ZIG_INVERTED``)
ZIG_PATHS = ("hot", "wedge", "tail", "hot2", "wedge2", "tail2", "fallback")
ZIG_INVERTED = (2, 5, 6)


def _check(states: RandomState, n: int, per_sample: int) -> None:
    """A 1-D batch of streams, and n samples that consume fewer than
    2**32 counters (the u32 offsets of the kernels)."""
    if not isinstance(n, int) or n < 1 or per_sample * n >= 2**32:
        raise ValueError(f"n must be an int in [1, 2**32 / {per_sample}), "
                         f"got {n!r}")
    if states.key0.dim() != 1:
        raise ValueError("block samplers take a 1-D batch of streams")


def _advance(states: RandomState, n: int) -> RandomState:
    """The streams with n counters consumed (u32 carry into ctr_hi)."""
    lo = states.ctr_lo + n
    hi = (states.ctr_hi + (lo >> 32)) & MASK32
    return states._replace(ctr_lo=lo & MASK32, ctr_hi=hi)


def _grid(states: RandomState, n: int, offset: int = 0) -> RandomState:
    """[R, n] states whose (r, j) entry is stream r at counter
    base_r + offset + j, with the u32 carry of the JAX kernels."""
    j = torch.arange(offset, offset + n, dtype=BITS,
                     device=states.key0.device)
    lo = states.ctr_lo[:, None] + j
    hi = (states.ctr_hi[:, None] + (lo >> 32)) & MASK32
    return RandomState(states.key0[:, None].expand(-1, n),
                       states.key1[:, None].expand(-1, n), lo & MASK32, hi)


def exponential_block_plain(states: RandomState, n: int):
    """Plain version of K2: ``std_exponential`` over the counter grid."""
    _check(states, n, 1)
    _, out = std_exponential(_grid(states, n))
    return _advance(states, n), out


def normal_block_plain(states: RandomState, n: int):
    """Plain version of K3: ``std_normal`` over the counter grid."""
    _check(states, n, 1)
    _, out = std_normal(_grid(states, n))
    return _advance(states, n), out


def _exp_zig_plain(states: RandomState, n: int):
    """K4's block, with per sample the Threefry blocks its value needs
    (1 to 3) and the path it took (int8, an index of ``ZIG_PATHS``)."""
    real = config.real()
    dev = states.key0.device
    xt = torch.tensor(_zt.X_EXP, dtype=real, device=dev)
    yt = torch.tensor(_zt.Y_EXP, dtype=real, device=dev)
    r_const = _zt.R_EXP
    base_w = torch.tensor(_zt.V_EXP, dtype=real, device=dev) / yt[255]

    def bits(offset):
        g = _grid(states, n, offset)
        return threefry2x32(g.key0, g.key1, g.ctr_lo, g.ctr_hi)

    shape = (states.key0.shape[0], n)
    accepted = torch.zeros(shape, dtype=torch.bool, device=dev)
    path = torch.full(shape, len(ZIG_PATHS) - 1, dtype=torch.int8,
                      device=dev)
    blocks = torch.ones(shape, dtype=torch.int64, device=dev)
    out = torch.zeros(shape, dtype=real, device=dev)
    for k in range(_ZK):
        b0, b1 = bits(2 * k * n)
        layer = b0 & 0xFF
        is0 = layer == 0
        u1 = b1.to(real) * (2.0**-32)
        x = u1 * torch.where(is0, base_w, xt[layer])
        hot = x < torch.where(is0, torch.full_like(x, r_const),
                              xt[layer - 1])
        u2 = (b0 >> 8).to(real) * (2.0**-24)
        ylo = yt[layer]
        yhi = torch.where(is0, yt[255], yt[layer - 1])
        y = ylo + u2 * (yhi - ylo)
        ok = hot | (~is0 & (y < torch.exp(-x)))
        # a layer-0 miss is the exact memoryless tail: r + Exp(1)
        t0, t1 = bits((2 * k + 1) * n)
        tail = r_const - torch.log1p(-_u53(t0, t1, real))
        is_tail = is0 & ~hot
        take = ~accepted & (ok | is_tail)
        out = torch.where(take, torch.where(is_tail, tail, x), out)
        code = torch.where(is_tail, 2, torch.where(hot, 0, 1)) + 3 * k
        path = torch.where(take, code.to(torch.int8), path)
        blocks += (take & is_tail).to(torch.int64)
        if k + 1 < _ZK:
            blocks += (~accepted & ~take).to(torch.int64)
        accepted = accepted | ok | is_tail
    f0, f1 = bits(2 * _ZK * n)
    out = torch.where(accepted, out, -torch.log1p(-_u53(f0, f1, real)))
    blocks += (~accepted).to(torch.int64)
    return out, blocks, path


def exponential_block_zig_plain(states: RandomState, n: int):
    """Plain version of K4 (consumes (2 _ZK + 1) n counters)."""
    _check(states, n, 2 * _ZK + 1)
    out, _, _ = _exp_zig_plain(states, n)
    return _advance(states, (2 * _ZK + 1) * n), out


# --- the CUDA kernels --------------------------------------------------------

#: (name, dtype, library) -> bound C entry; (dtype, device) -> K4's tables
_FNS: dict = {}
_TABLES: dict = {}


def _launch(name: str, states: RandomState, n: int, per_sample: int,
            lib=None, out=None):
    """One launch of ``cimba_<name>_<f32|f64>`` on the current stream:
    the [R, n] samples and the advanced counters.  ``lib``: another build
    of a sampler source with the same C interface (``chip_smoke.py
    --ab`` times one against this checkout's, the default).  ``out``: a
    contiguous [R, n] tensor of the profile's dtype on the streams'
    device to write the samples into (a view at any offset), in place of
    a new one."""
    from cimba_tpu_torch import _build

    _check(states, n, per_sample)
    config.resolve_device(states.key0.device)
    words = [x.contiguous() for x in states]
    for w in words:
        if w.dtype != BITS or w.device != words[0].device or w.shape != \
                words[0].shape:
            raise ValueError("stream words must be int64 tensors of one "
                             "shape on one device")
    real = config.real()
    fn = _FNS.get((name, real, lib))
    if fn is None:
        tag = "f32" if real == torch.float32 else "f64"
        fn = getattr(lib or _build.load("bulk_samplers"),
                     f"cimba_{name}_{tag}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 2 + [
            ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
        _FNS[(name, real, lib)] = fn
    rows = words[0].shape[0]
    dev = words[0].device
    if out is None:
        out = torch.empty((rows, n), dtype=real, device=dev)
    elif (out.shape != (rows, n) or out.dtype != real or out.device != dev
          or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous [{rows}, {n}] {real} "
                         f"tensor on {dev}")
    lo = torch.empty_like(words[2])
    hi = torch.empty_like(words[3])
    if (real, dev) not in _TABLES:
        _TABLES[(real, dev)] = (
            torch.tensor(_zt.X_EXP, dtype=real, device=dev),
            torch.tensor(_zt.Y_EXP, dtype=real, device=dev))
    xt, yt = _TABLES[(real, dev)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*[w.data_ptr() for w in words], lo.data_ptr(),
                hi.data_ptr(), out.data_ptr(), xt.data_ptr(), yt.data_ptr(),
                rows, n, _zt.R_EXP, _zt.V_EXP, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (code {rc})")
    return states._replace(ctr_lo=lo, ctr_hi=hi), out


def exponential_block(states: RandomState, n: int):
    """[R, n] unit exponentials, -log1p(-u) (K2); n counters a stream."""
    if not states.key0.is_cuda:
        return exponential_block_plain(states, n)
    res = _launch("exponential_block", states, n, 1)
    exponential_block.launches += 1
    return res


def normal_block(states: RandomState, n: int):
    """[R, n] standard normals, sqrt(2) erf_inv(2u - 1) (K3)."""
    if not states.key0.is_cuda:
        return normal_block_plain(states, n)
    res = _launch("normal_block", states, n, 1)
    normal_block.launches += 1
    return res


def exponential_block_zig(states: RandomState, n: int):
    """[R, n] unit exponentials by the ziggurat (K4); 5n counters."""
    if not states.key0.is_cuda:
        return exponential_block_zig_plain(states, n)
    res = _launch("exponential_block_zig", states, n, 2 * _ZK + 1)
    exponential_block_zig.launches += 1
    return res


exponential_block.launches = 0
normal_block.launches = 0
exponential_block_zig.launches = 0
