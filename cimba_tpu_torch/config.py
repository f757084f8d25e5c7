"""Dtype profiles and device selection for the PyTorch port.

Counterpart of :mod:`cimba_tpu.config`, reduced to what the port needs:

* two dtype profiles, as in the JAX package: ``"f64"`` (f64 time and
  real values, i64 event counts; the exact profile, and the default) and
  ``"f32"`` (f32 time and real values, i32 counts).  The H100 has native
  FP64, so both are real targets of the CUDA kernel;
* the ``INDEX`` role (i32 pids, pcs, seqs, handles) and the ``BITS``
  carrier: Threefry words are u32 values carried in i64 tensors, because
  torch has little unsigned arithmetic;
* the device rule: every entry point takes ``device=`` and defaults to
  ``"cuda"``.  Without a card, only an explicit ``device="cpu"`` runs;
  nothing ever falls back to the CPU on its own.
"""

from __future__ import annotations

import contextlib

import torch

_PROFILES = {
    "f64": dict(TIME=torch.float64, REAL=torch.float64, COUNT=torch.int64),
    "f32": dict(TIME=torch.float32, REAL=torch.float32, COUNT=torch.int32),
}

#: index / handle / pc / seq dtype (both profiles)
INDEX = torch.int32
#: carrier of the u32 Threefry words (values in [0, 2**32))
BITS = torch.int64
#: mask of one 32-bit word
MASK32 = 0xFFFFFFFF

TIME_NEVER = float("inf")

_active = "f64"


def active_profile() -> str:
    return _active


def use_profile(name: str) -> None:
    """Switch the dtype profile ("f64" exact / "f32").  Affects tensors
    created afterwards; a Sim keeps the dtypes it was built with."""
    global _active
    if name not in _PROFILES:
        raise ValueError(f"unknown profile {name!r}; one of {sorted(_PROFILES)}")
    _active = name


@contextlib.contextmanager
def profile(name: str):
    """Scoped :func:`use_profile` (restores the previous profile on exit)."""
    prev = _active
    use_profile(name)
    try:
        yield
    finally:
        use_profile(prev)


def real() -> torch.dtype:
    return _PROFILES[_active]["REAL"]


def time() -> torch.dtype:
    return _PROFILES[_active]["TIME"]


def count() -> torch.dtype:
    return _PROFILES[_active]["COUNT"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  ``None`` means the default,
    ``"cuda"``; a CUDA request on a machine without a card raises — the
    port never drops to the CPU unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cimba_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch engine on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!r}: use 'cuda' or 'cpu'")
    return dev
