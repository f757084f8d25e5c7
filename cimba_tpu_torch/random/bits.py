"""Counter-based random bits: Threefry-2x32 streams (torch port).

Counterpart of :mod:`cimba_tpu.random.bits`, word for word: replication
r's n-th 64-bit draw is ``threefry2x32(key(seed, r), n)``, so the port's
streams are bit-identical to the JAX package's.

torch has little unsigned arithmetic, so every u32 word is carried in an
int64 tensor holding a value in ``[0, 2**32)`` and masked with
``& 0xFFFFFFFF`` after each add and shift.  The 64-bit ``fmix64`` runs on
int64 with wrapping multiplies (two's complement gives the u64 product's
low 64 bits) and logical right shifts written as an arithmetic shift
followed by a mask of the bits a logical shift keeps.

The JAX package's draw-word stash (``bits.stash_arm``) only changes how
many Threefry blocks are *traced*; values and counter consumption are
those of :func:`next_bits64`, which is all an eager engine needs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.config import BITS, MASK32

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def _mix4(x0, x1, rots):
    for r in rots:
        x0 = (x0 + x1) & MASK32
        x1 = _rotl(x1, r)
        x1 = x1 ^ x0
    return x0, x1


def threefry2x32(k0, k1, c0, c1):
    """20-round Threefry-2x32 block on u32 words carried in int64."""
    ks2 = k0 ^ k1 ^ _PARITY
    x0 = (c0 + k0) & MASK32
    x1 = (c1 + k1) & MASK32
    x0, x1 = _mix4(x0, x1, _ROT_A)
    x0, x1 = (x0 + k1) & MASK32, (x1 + ks2 + 1) & MASK32
    x0, x1 = _mix4(x0, x1, _ROT_B)
    x0, x1 = (x0 + ks2) & MASK32, (x1 + k0 + 2) & MASK32
    x0, x1 = _mix4(x0, x1, _ROT_A)
    x0, x1 = (x0 + k0) & MASK32, (x1 + k1 + 3) & MASK32
    x0, x1 = _mix4(x0, x1, _ROT_B)
    x0, x1 = (x0 + k1) & MASK32, (x1 + ks2 + 4) & MASK32
    x0, x1 = _mix4(x0, x1, _ROT_A)
    x0, x1 = (x0 + ks2) & MASK32, (x1 + k0 + 5) & MASK32
    return x0, x1


def _as_i64(v: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def _srl33(h):
    # logical >> 33 on int64: the arithmetic shift copies the sign into
    # the top bits, the mask keeps the 31 bits a logical shift leaves
    return (h >> 33) & ((1 << 31) - 1)


def fmix64(h):
    """MurmurHash3 64-bit finalizer on an int64 tensor (u64 bits)."""
    h = h ^ _srl33(h)
    h = h * _as_i64(0xFF51AFD7ED558CCD)
    h = h ^ _srl33(h)
    h = h * _as_i64(0xC4CEB9FE1A85EC53)
    h = h ^ _srl33(h)
    return h


class RandomState(NamedTuple):
    """Per-replication stream state: key words and the 64-bit draw
    counter split into (lo, hi) words, each a u32 value in int64."""

    key0: torch.Tensor
    key1: torch.Tensor
    ctr_lo: torch.Tensor
    ctr_hi: torch.Tensor


def initialize(seed, replication, *, device="cuda") -> RandomState:
    """Stream of each replication: key = fmix64(seed + c * replication)
    in u64 arithmetic.  ``replication`` is an integer tensor (any shape);
    ``seed`` a Python int (taken mod 2**64) or an integer tensor.  The
    streams live on ``device`` (the card unless the caller asks for the
    CPU), whatever device ``replication`` came on."""
    dev = config.resolve_device(device)
    rep = torch.as_tensor(replication, device=dev).to(torch.int64)
    if isinstance(seed, torch.Tensor):
        seed = seed.to(dev)
    if isinstance(seed, int):
        seed = _as_i64(seed)
    mixed = fmix64(seed + _as_i64(0x9E3779B97F4A7C15) * rep)
    k0 = mixed & MASK32
    k1 = (mixed >> 32) & MASK32
    zero = torch.zeros_like(k0, dtype=BITS)
    return RandomState(k0, k1, zero, zero.clone())


def next_bits64(state: RandomState):
    """Draw one 64-bit word (two u32 words) and advance the counter."""
    b0, b1 = threefry2x32(state.key0, state.key1, state.ctr_lo, state.ctr_hi)
    lo = (state.ctr_lo + 1) & MASK32
    hi = (state.ctr_hi + (lo == 0).to(BITS)) & MASK32
    return RandomState(state.key0, state.key1, lo, hi), b0, b1
