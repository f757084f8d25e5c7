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


# --- environment knobs ---------------------------------------------------

#: the ``CIMBA_*`` knobs the port reads, with their defaults (parity: the
#: reference's ``config.ENV_KNOBS``, the serve layer's part).  Every read
#: goes through :func:`env_raw`, so this table is what the package
#: consults.  ``CIMBA_DEVICE_SCHED`` and ``CIMBA_QOS`` are read so that
#: ``=1`` raises, naming the module the port does not have yet.
ENV_KNOBS = {
    "CIMBA_REFILL": dict(
        default="",
        doc="=1: Service(refill=None) recycles dead lanes at chunk "
            "boundaries (serve/service.py, continuous refill)"),
    "CIMBA_WAVE_FUSE": dict(
        default="",
        doc="=1: Service(fuse=None) packs shape-compatible distinct specs "
            "into one fused wave (core/fuse.py)"),
    "CIMBA_PROGRAM_CACHE_CAP": dict(
        default="64",
        doc="the bounded program cache's default capacity "
            "(serve/cache.py)"),
    "CIMBA_DEVICE_SCHED": dict(
        default="",
        doc="=1: the preemptive device scheduler (serve/device.py), not "
            "ported: raises"),
    "CIMBA_QOS": dict(
        default="",
        doc="=1: the multi-tenant QoS plane (qos/), not ported: raises"),
}


def env_raw(name: str, default=None) -> str:
    """One registered ``CIMBA_*`` environment knob's raw value (parity:
    ``cimba_tpu.config.env_raw``): ``default=None`` uses the registered
    default; an unregistered name raises KeyError."""
    import os

    knob = ENV_KNOBS.get(name)
    if knob is None:
        raise KeyError(f"{name} is not a registered CIMBA_* environment "
                       "knob of cimba_tpu_torch.config.ENV_KNOBS")
    return os.environ.get(name, knob["default"] if default is None
                          else default)
