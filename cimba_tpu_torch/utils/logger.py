"""Flag-mask logging from simulation blocks (torch port of
:mod:`cimba_tpu.utils.logger`).

Parity: ``cmb_logger`` — a 32-bit flag mask (4 reserved levels and 28
user bits), a line carrying the replication, the clock, the process and
the call site, ``error`` failing the replication.

A disabled level returns the Sim it was given and computes nothing.  An
enabled level on the plain engine prints the reference's line,
``[level] r= t= p= func(line) err= | msg``, with the replay key on
warning and above, once for each lane whose block ran (the engine runs
a block for every lane and keeps its result where the lane's pc selects
it; it tells the logger which lanes those are).  The engine runs
eagerly, so the line needs no host callback.

Kernel-path contract (the reference's, whose kernel cannot cross a
host callback): a block traced for the generated chunk kernel
(:mod:`cimba_tpu_torch.core.trace`) that reaches an enabled ``info``,
``warning`` or user level raises at build time; ``error`` and ``fatal``
keep the failure flag, drop the line and warn.  The hand-written
kernels' models log nothing.
"""

from __future__ import annotations

import sys

# reserved level bits (parity: CMB_LOGGER_* flag values)
FATAL = 1 << 0
ERROR = 1 << 1
WARNING = 1 << 2
INFO = 1 << 3
#: first free user bit (28 available, parity with the reference's layout)
USER = 1 << 4

_mask = FATAL | ERROR | WARNING  # INFO off by default, like release builds

# the time formatter (parity: cmb_logger_timeformatter_set): a host
# ``fn(float) -> str``; None = the default fixed-width rendering
_timeformatter = None

# process names by pid (parity: the reference line carries the process
# NAME); Model.build() registers them, the last built model wins
_proc_names = None

# the lanes whose block is running (a bool [L] tensor), set by the engine
# around each block and handler call; None = every lane
_lanes = None


def names_set(names) -> None:
    """Register per-pid process names for log rendering (called by
    ``Model.build``; the last built model wins, like the reference's one
    process context per thread)."""
    global _proc_names
    _proc_names = list(names) if names else None


def _pid_str(names, p) -> str:
    if names is not None and 0 <= int(p) < len(names):
        return f"{names[int(p)]}({int(p)})"
    return str(int(p))


def _caller_src() -> str:
    """Call-site tag ``func(line)`` of the block that logs (parity: the
    reference's __func__/__LINE__ in every line)."""
    f = sys._getframe(2)
    for _ in range(4):
        if f is None:
            break
        if f.f_code.co_filename != __file__:
            return f"{f.f_code.co_name}({f.f_lineno})"
        f = f.f_back
    return "?"


def flags_on(bits: int) -> None:
    """Enable levels (parity: cmb_logger_flags_on)."""
    global _mask
    _mask |= bits


def flags_off(bits: int) -> None:
    """Disable levels (parity: cmb_logger_flags_off)."""
    global _mask
    _mask &= ~bits


def flags() -> int:
    return _mask


def timeformatter_set(fn) -> None:
    """Replace the time rendering of later lines (parity:
    cmb_logger_timeformatter_set); ``fn(t: float) -> str``, None restores
    the default."""
    global _timeformatter
    _timeformatter = fn


class lanes:
    """``with logger.lanes(mask): ...``: the engine's note of which lanes
    the block it calls runs for (restored on exit)."""

    def __init__(self, mask):
        self.mask = mask

    def __enter__(self):
        global _lanes
        self.prev, _lanes = _lanes, self.mask
        return self

    def __exit__(self, *exc):
        global _lanes
        _lanes = self.prev
        return False


def _symbolic(sim) -> bool:
    from cimba_tpu_torch.core import trace as _trace

    return _trace.is_symbolic(sim)


def _probing() -> bool:
    """True while the engine runs each block once to collect its command
    tags (``loop._used_tags``): no line is printed for that run."""
    from cimba_tpu_torch.core import process as _pr

    return _pr._tag_collector is not None


def _at(x, lane: int, n: int):
    """Lane ``lane``'s value of a log argument, as the reference's host
    callback receives it (a 0-d numpy array); anything else as given."""
    import torch

    if isinstance(x, torch.Tensor):
        if x.dim() > 0 and x.shape[0] == n:
            x = x[lane]
        return x.detach().cpu().numpy()
    return x


def _stream_id(sim, lane: int):
    """The lane's replay key and draw count (parity: the seed printed on
    warning+ lines): ``(key1 << 32) | key0`` and ``(ctr_hi << 32) |
    ctr_lo``, which rebuild the stream exactly."""
    rng = sim.rng
    key = (int(rng.key1[lane]) << 32) | int(rng.key0[lane])
    ctr = (int(rng.ctr_hi[lane]) << 32) | int(rng.ctr_lo[lane])
    return key, ctr


def _emit(level_name, sim, p, fmt, args, kwargs, with_seed=False):
    """Print one line a running lane: ``[level] r t process func(line)
    err | msg`` (parity: the reference's ``_emit``), the replay key
    appended with ``with_seed`` (its ``_emit_with_seed``, warning and
    above).  Reached while a block is traced for the generated chunk
    kernel, it raises instead: a line cannot cross the kernel."""
    import torch

    if _symbolic(sim):
        raise RuntimeError(
            f"logger.{level_name}: log emission inside the CUDA chunk "
            "kernel path — a log line cannot cross the generated kernel.  "
            "Either disable the level for kernel runs (logger.flags_off, "
            "the reference's NLOGINFO analog), or run this model on the "
            "plain engine (core.loop.make_run), which logs fine.")
    if _probing():
        return
    src = _caller_src()
    n = sim.clock.shape[0]
    sel = (torch.ones(n, dtype=torch.bool) if _lanes is None
           else _lanes.detach().cpu())
    for lane in torch.nonzero(sel).flatten().tolist():
        a = [_at(x, lane, n) for x in args]
        kw = {k: _at(v, lane, n) for k, v in kwargs.items()}
        msg = fmt
        if with_seed:
            key, ctr = _stream_id(sim, lane)
            msg = fmt + "  [replay: key=0x{_key:016x} ctr={_ctr}]"
            kw.update(_key=key, _ctr=ctr)
        t = float(sim.clock[lane])
        ts = _timeformatter(t) if _timeformatter is not None else f"{t:.6f}"
        pid = p[lane] if isinstance(p, torch.Tensor) and p.dim() > 0 else p
        print(f"[{level_name}] r={int(sim.rep[lane])} t={ts} "
              f"p={_pid_str(_proc_names, pid)} {src} "
              f"err={int(sim.err[lane])} | " + msg.format(*a, **kw),
              flush=True)


def info(sim, p, fmt: str, *args, **kwargs):
    """Log at INFO if enabled; returns sim unchanged."""
    if _mask & INFO:
        _emit("info", sim, p, fmt, args, kwargs)
    return sim


def warning(sim, p, fmt: str, *args, **kwargs):
    if _mask & WARNING:
        _emit("warn", sim, p, fmt, args, kwargs, with_seed=True)
    return sim


def user(bit: int, sim, p, fmt: str, *args, **kwargs):
    """Log on a user-defined flag bit (parity: the 28 user bits)."""
    if _mask & bit:
        _emit(f"u{bit:x}", sim, p, fmt, args, kwargs)
    return sim


def _fail_level(level_name, bit, sim, p, fmt, args, kwargs):
    """Shared body of :func:`error` and :func:`fatal`: log with the
    replay key if the level is enabled, and fail the replication either
    way.  Traced for the generated chunk kernel, the failure flag stays
    and the line is dropped with a warning (not the hard raise of
    info/warning: a model's containment path must not make it
    unbuildable on the kernel)."""
    from cimba_tpu_torch.core import api

    if _mask & bit:
        if _symbolic(sim):
            import warnings

            warnings.warn(
                f"logger.{level_name} inside the CUDA chunk kernel path: "
                "the replication failure flag is preserved, but the log "
                "line is dropped (a log line cannot cross the generated "
                "kernel).  Inspect sim.err and the replay key host-side "
                "instead.", stacklevel=3)
        else:
            _emit(level_name, sim, p, fmt, args, kwargs, with_seed=True)
    return api.fail(sim)


def fatal(sim, p, fmt: str, *args, **kwargs):
    """Log at the reserved FATAL level AND mark the replication failed
    (parity: the reference's ``fatal``: contained like :func:`error`;
    silencing the level does not unfail the replication)."""
    return _fail_level("fatal", FATAL, sim, p, fmt, args, kwargs)


def error(sim, p, fmt: str, *args, **kwargs):
    """Log AND mark the replication failed (parity: cmb_logger_error's
    abandon-this-trial recovery: the runner counts it, the batch
    continues)."""
    return _fail_level("error", ERROR, sim, p, fmt, args, kwargs)
