"""Run profiling: the build-versus-execute split, device memory, the
RunReport (torch port of :mod:`cimba_tpu.obs.prof`).

An experiment's wall time on the card has three legs of different
kinds: building the chunk kernel's instance (for a generated spec,
tracing its blocks and emitting its header), compiling it with ``nvcc``
or loading the built library, and executing.  :func:`profiled_call`
times them apart and :class:`RunReport` packages the split with the
card's memory statistics and a metrics snapshot, which
``run_experiment(..., with_report=True)`` returns.  The report keeps the
reference's field names: ``trace_lower_s`` is the build or trace leg,
``compile_s`` the nvcc build or library load, ``execute_s`` the run.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Optional


@dataclasses.dataclass
class RunReport:
    """What one experiment run cost and did (host-side scalars)."""

    trace_lower_s: float          # kernel build: trace and emit, or layout
    compile_s: float              # nvcc build or library load
    execute_s: float              # the run, ended by a synchronize
    n_replications: int
    n_failed: int
    total_events: int
    events_per_sec: float
    backend: str                  # "cuda" or "cpu"
    device_memory: Optional[dict] = None   # torch.cuda.memory_stats()
    metrics: Optional[dict] = None         # obs.metrics.snapshot (pooled)
    profile_dir: Optional[str] = None      # torch.profiler trace output

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def device_memory_stats(device=None) -> Optional[dict]:
    """``torch.cuda.memory_stats`` of the card (ints only), None on the
    CPU."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    if not stats:
        return None
    return {k: int(v) for k, v in stats.items()
            if isinstance(v, (int, float))}


@contextmanager
def trace_ctx(profile_dir: Optional[str]):
    """``torch.profiler`` around the execute leg when a directory is
    given, writing a Chrome trace there (``trace.json``); a no-op
    otherwise."""
    if not profile_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as p:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    p.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def _sync(device) -> None:
    import torch

    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profiled_call(fn, *args, build=None, load=None, device=None,
                  profile_dir: Optional[str] = None):
    """Run ``fn(*args)`` with its legs timed apart: ``build()`` (the
    kernel's instance: trace and emit, or the hand-written layout),
    ``load()`` (nvcc or the library load), then ``fn(*args)`` ending in a
    synchronize of ``device``, inside :func:`trace_ctx` (the profiler's
    start, stop and export are not timed: on the card they take seconds
    beside a run of milliseconds).  Returns ``(out, timings)``, timings
    ``trace_lower_s``, ``compile_s``, ``execute_s``."""
    t0 = time.perf_counter()
    if build is not None:
        build()
    t1 = time.perf_counter()
    if load is not None:
        load()
    t2 = time.perf_counter()
    with trace_ctx(profile_dir):
        t3 = time.perf_counter()
        out = fn(*args)
        _sync(device)
        t4 = time.perf_counter()
    return out, {"trace_lower_s": t1 - t0, "compile_s": t2 - t1,
                 "execute_s": t4 - t3}


def build_report(timings: dict, *, n_replications: int, n_failed: int,
                 total_events: int, metrics: Optional[dict] = None,
                 profile_dir: Optional[str] = None,
                 device) -> RunReport:
    """The report of a run on ``device`` (its backend and memory
    statistics) from :func:`profiled_call`'s timings."""
    import torch

    ex = max(timings["execute_s"], 1e-12)
    return RunReport(
        trace_lower_s=timings["trace_lower_s"],
        compile_s=timings["compile_s"],
        execute_s=timings["execute_s"],
        n_replications=int(n_replications), n_failed=int(n_failed),
        total_events=int(total_events),
        events_per_sec=float(total_events) / ex,
        backend=torch.device(device).type,
        device_memory=device_memory_stats(device),
        metrics=metrics, profile_dir=profile_dir)
