"""The many-scenario sweep engine: cells x replications fanned across
waves of the chunked stream runner, folded per cell (torch port of
:mod:`cimba_tpu.sweep.engine`).

``run_experiment_stream`` pools one statistic for one scenario; a sweep
wants one statistic a cell of a scenario grid.  This engine drives the
same machinery (``make_chunk`` through ``drive_chunks``, on the card one
K1 launch a chunk; per-lane seed and horizon columns) but lays each wave
out as a sequence of per-cell slots and folds it slot by slot: each
slot's contiguous lanes are sliced off the wave and folded through the
stream's own fold (``runner.experiment._fold``) into that cell's
accumulator.  Torch runs the fold's operations one by one, so a slot
folds exactly as the same lanes folded as a wave of a direct stream
call.

Two dispatch modes, one schedule:

* **fixed-R** (``stop=None``): every cell runs ``reps_per_cell``
  replications.  Cell ``c``'s lanes are ``(seed=round_seed(seed, c, 0),
  rep=0..R)`` cut into ``cell_wave``-lane slots, the wave partition of a
  direct ``run_experiment_stream(spec, row_c, R, wave_size=cell_wave,
  seed=round_seed(seed, c, 0))`` call, folded in (cell, lo) order from
  the same zero accumulator: each cell's result is bitwise the direct
  call's while many cells share each physical wave.
* **adaptive-R** (``stop=HalfwidthTarget(...)``): rounds of
  ``reps_per_cell`` a live cell; after each round the cells whose CI
  halfwidth beats the target stop receiving lanes, and with
  ``redistribute`` the freed lanes go to the cells still running.  The
  (cell, round) seed schedule does not depend on the stopping pattern or
  the packing, so an adaptive run reproduces bit for bit.

* **serve-backed** (``service=``): each (cell, round) is submitted as a
  ``serve.Request`` with its own seed and horizon, so sweep traffic packs
  into the service's shared waves beside live requests, and each cell's
  result is bitwise the direct mode's fixed-R result.
  :func:`run_fused_sweeps` runs several sweeps of distinct specs through
  one fuse-enabled service, so their cells share fused waves.

Waves that cannot fill (``pad_waves=True``, or a mesh's shard count)
are padded with dead lanes (``t_stop=-inf``), which dispatch no event and
sit past the last slot, so they never join a fold.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from cimba_tpu_torch.sweep.adaptive import (HalfwidthTarget, halfwidths,
                                            round_seed)
from cimba_tpu_torch.sweep.grid import SweepGrid

__all__ = ["SweepResult", "run_sweep", "run_fused_sweeps"]

#: ``chunk_steps=None``: the reference's untuned default (its tuned
#: schedules, ``tune/``, are not ported)
DEFAULT_CHUNK_STEPS = 1024


@dataclass
class SweepResult:
    """Each cell's pooled statistics of one sweep run.

    ``summaries`` is a batched ``stats.summary.Summary`` with leading
    axis ``n_cells`` (on the run's device); the count arrays are numpy.
    ``stop_round[c]`` is the 0-based round after which cell ``c`` met the
    stopping target (-1: never, or a fixed-R run); ``met`` is None for a
    fixed-R run.  ``occupancy`` holds the wave and lane accounting
    (``waves``, ``lanes_live``, ``lanes_padded``, ``slots_by_cell``,
    ``padding_waste_frac``)."""

    grid: SweepGrid
    summaries: Any
    n_reps: np.ndarray
    n_failed: np.ndarray
    total_events: np.ndarray
    stop_round: np.ndarray
    halfwidth: np.ndarray
    met: Optional[np.ndarray]
    n_rounds: int
    seed: int
    confidence: float
    wall_s: float
    occupancy: dict = field(default_factory=dict)
    metrics: Any = None
    #: the run card, with ``audit=``: per-cell result digests and the
    #: seed schedule
    audit: Any = None
    #: CUDA chunk-kernel launches of the run (0 on the CPU)
    launches: int = 0

    @property
    def n_cells(self) -> int:
        return self.grid.n_cells

    def cell_summary(self, i: int):
        """Cell ``i``'s pooled Summary (0-dim leaves)."""
        from cimba_tpu_torch.stats import summary as sm

        return sm.Summary(*[x[i] for x in self.summaries])

    def rows(self) -> list:
        """One dict a cell: its axis values and pooled statistics.  A
        statistic whose name is also an axis's takes a ``stat_`` prefix,
        so the cell's coordinate is not overwritten."""
        from cimba_tpu_torch.stats import summary as sm

        s = self.summaries
        cols = {"n": s.n, "mean": sm.mean(s), "stddev": sm.stddev(s),
                "min": s.mn, "max": s.mx}
        cols = {k: v.detach().cpu().double().numpy()
                for k, v in cols.items()}
        axes = set(self.grid.axes)

        def key(k):
            return f"stat_{k}" if k in axes else k

        out = []
        for i, cell in enumerate(self.grid.cells()):
            row = dict(cell)
            row[key("reps")] = int(self.n_reps[i])
            row[key("n")] = float(cols["n"][i])
            row[key("mean")] = float(cols["mean"][i])
            row[key("stddev")] = float(cols["stddev"][i])
            row[key("halfwidth")] = float(self.halfwidth[i])
            row[key("min")] = float(cols["min"][i])
            row[key("max")] = float(cols["max"][i])
            row[key("n_failed")] = int(self.n_failed[i])
            row[key("total_events")] = int(self.total_events[i])
            row[key("stop_round")] = int(self.stop_round[i])
            if self.met is not None:
                row[key("met")] = bool(self.met[i])
            out.append(row)
        return out

    def to_csv(self, path) -> None:
        """Write :meth:`rows` as CSV (``path``: a filename, a Path or a
        file-like object)."""
        import csv
        import os

        rows = self.rows()
        own = isinstance(path, (str, os.PathLike))
        f = open(path, "w", newline="") if own else path
        try:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        finally:
            if own:
                f.close()


def _stack_summaries(accs):
    """The batched ``Summary[C]`` of the cells' accumulators (a stack:
    the cells' bits pass through untouched)."""
    import torch

    from cimba_tpu_torch.stats import summary as sm

    return sm.Summary(*[torch.stack(xs) for xs in
                        zip(*[a[0] for a in accs])])


def _serve_merge(acc, summary, n_failed, total_events, metrics=None):
    """One served (cell, round) result merged into the cell's accumulator
    (parity: the reference's ``_serve_merge``): ``merge(empty, s)`` is
    exact, so a fixed-R cell is bitwise what the service delivered, which
    is bitwise the direct stream call."""
    from cimba_tpu_torch.obs import metrics as obs_metrics
    from cimba_tpu_torch.stats import summary as sm

    out = (sm.merge(acc[0], summary), acc[1] + n_failed,
           acc[2] + total_events)
    if metrics is not None:
        out = out + (obs_metrics.merge(acc[3], metrics),)
    return out


def _wave_shape(total: int, unit: int, pad_waves: bool, max_wave: int):
    """The lanes one physical wave runs: a multiple of the mesh's shard
    count; with ``pad_waves`` also rounded up to the next power-of-two
    multiple of it (at most ``max_wave``), so mixed rounds cycle through
    a few wave shapes."""
    if total <= 0:
        return total
    up = total if total % unit == 0 else total + (unit - total % unit)
    if not pad_waves:
        return up
    q = unit
    while q < total:
        q *= 2
    q = min(q, max_wave)
    if q < up or q % unit:
        return up
    return q


def run_sweep(spec, grid: SweepGrid, *, reps_per_cell: int,
              stop: Optional[HalfwidthTarget] = None, max_rounds: int = 32,
              seed: int = 0, cell_wave: Optional[int] = None,
              max_wave: int = 4096, t_end: Optional[float] = None,
              chunk_steps: Optional[int] = None, poll_every: int = 4,
              mesh=None, summary_path=None, pad_waves: bool = False,
              redistribute: bool = True, program_cache=None, service=None,
              on_round: Optional[Callable] = None,
              on_chunk: Optional[Callable] = None, telemetry=None,
              audit=None, serve_timeout: float = 600.0,
              device="cuda") -> SweepResult:
    """Run a scenario grid: ``reps_per_cell`` replications a cell (a
    round, with ``stop``), folded into each cell's pooled summary
    (parity: ``cimba_tpu.sweep.run_sweep`` in direct mode).

    Fixed-R (``stop=None``): one round; cell ``c`` is bitwise the direct
    ``run_experiment_stream`` call at ``seed=round_seed(seed, c, 0)``,
    ``wave_size=cell_wave``; the engine packs the cells' slots greedily
    into physical waves of up to ``max_wave`` lanes.

    Adaptive (``stop=HalfwidthTarget(...)``): up to ``max_rounds`` rounds;
    after each, the cells whose CI halfwidth beats the target stop.  With
    ``redistribute`` a round gives each live cell
    ``min(max(R0, R0 * C // live), max(R0, max_wave))`` replications.

    ``pad_waves`` pads a wave to a power-of-two multiple of the mesh's
    shard count with dead ``t_stop=-inf`` lanes (inert); a ``mesh``
    (``runner.experiment.make_mesh``) shards every wave, rounded up to a
    multiple of its size, and ``cell_wave`` and ``max_wave`` must divide
    evenly over it.  ``on_round(round, n_live, reps_total)`` after each
    round, ``on_chunk(n)`` after each chunk.  ``chunk_steps=None`` is
    1024, the reference's untuned default.  With the metrics registry on
    (the plain engine, ``device="cpu"``) ``SweepResult.metrics`` pools it
    across every cell.  ``audit`` (``obs.audit.resolve``) gives the
    result a run card with each cell's seed schedule and
    ``result_digest``, equal to the ``stream_result_digest`` of the cell's
    direct stream call.

    ``device`` is the card unless the caller asks for the CPU; on the
    card every chunk is one launch of the spec's K1.  ``program_cache``
    (a ``serve.ProgramCache``) shares the waves' programs with other
    calls.  ``service=`` (a ``serve.Service``) submits each (cell, round)
    as a request there (``wave_size=min(cell_wave, reps)``, labelled
    ``grid:cell:r<round>``, each result awaited up to ``serve_timeout``
    seconds) and merges the results into the cells: its device and mesh
    are the service's (``mesh=`` and ``program_cache=`` with it raise),
    and ``occupancy["serve"]`` holds the service's counter deltas.
    ``telemetry`` (an ``obs.telemetry.Telemetry``) ticks ``sweep.chunk``
    and ``sweep.round``, and with its span recorder on one "sweep" trace
    holds a "round" span a round; the run card records its
    ``snapshot()``.  Host-side only: no result bit changes."""
    import torch

    from cimba_tpu_torch import config, tree
    from cimba_tpu_torch.obs import audit as obs_audit
    from cimba_tpu_torch.obs import metrics as obs_metrics
    from cimba_tpu_torch.runner import experiment as ex

    C = grid.n_cells
    R0 = int(reps_per_cell)
    if R0 <= 0:
        raise ValueError(f"reps_per_cell must be positive, got {R0}")
    if stop is not None and max_rounds <= 0:
        raise ValueError(f"max_rounds must be positive, got {max_rounds}")
    cell_wave = R0 if cell_wave is None else int(cell_wave)
    if cell_wave <= 0:
        raise ValueError(f"cell_wave must be positive, got {cell_wave}")
    if cell_wave > max_wave:
        raise ValueError(
            f"cell_wave={cell_wave} exceeds max_wave={max_wave} — a slot "
            "could never fit one physical wave")
    if service is not None:
        if mesh is not None or program_cache is not None:
            raise ValueError(
                "serve-backed sweeps dispatch through the service's own "
                "mesh and program cache — don't pass mesh=/program_cache=")
        shards_mesh, dev = service._mesh, service.device
    else:
        shards_mesh, dev = ex._run_mesh(mesh, device)
    unit = shards_mesh.size
    if unit > 1 and (cell_wave % unit or max_wave % unit):
        raise ValueError(
            f"cell_wave={cell_wave} and max_wave={max_wave} must divide "
            f"evenly over {unit} devices")
    ex._refuse_observed(dev, "run_sweep")
    chunk_steps = (DEFAULT_CHUNK_STEPS if chunk_steps is None
                   else int(chunk_steps))

    rows = grid.cell_rows()
    if summary_path is None:
        summary_path = ex.default_summary_path
    with_metrics = obs_metrics.enabled()
    ex.preflight_summary_path(spec, summary_path, rows[0], R0,
                              min(cell_wave, R0), dev)
    _, on_chunk = ex._tel_hooks(telemetry, "sweep", None, on_chunk)
    launches0 = _chunk_launches()
    serve_stats0 = service.stats() if service is not None else None
    if service is None:
        from cimba_tpu_torch.serve import cache as pcache

        programs = (program_cache if program_cache is not None
                    else pcache.ProgramCache())

    t0 = time.perf_counter()
    occ = {"waves": 0, "lanes_live": 0, "lanes_padded": 0,
           "slots_by_cell": np.zeros(C, np.int64)}
    # every cell starts from the zeros a direct stream call starts from
    acc0 = ex.stream_acc(spec, with_metrics, dev)
    accs = [acc0] * C

    def column(values):
        return torch.cat(values) if len(values) > 1 else values[0]

    def dispatch(jobs):
        # each cell's slots (the direct call's wave partition), packed
        # greedily into physical waves of up to max_wave lanes
        slots = []
        for ci, sd, reps in jobs:
            lo = 0
            while lo < reps:
                n = min(cell_wave, reps - lo)
                slots.append((ci, sd, lo, n))
                lo += n
        waves, cur, lanes = [], [], 0
        for s in slots:
            if cur and lanes + s[3] > max_wave:
                waves.append(cur)
                cur, lanes = [], 0
            cur.append(s)
            lanes += s[3]
        if cur:
            waves.append(cur)
        for wslots in waves:
            live = sum(n for _, _, _, n in wslots)
            pad = _wave_shape(live, unit, pad_waves, max_wave) - live
            reps_c = [torch.arange(lo, lo + n) for _, _, lo, n in wslots]
            seeds_c = [ex._seed_column(sd, n, dev) for _, sd, _, n in wslots]
            # no horizon and no pads: no t_stop leaf, as the direct stream
            ts_c = (None if t_end is None and pad == 0 else
                    [ex._horizon_column(t_end, n, dev)
                     for _, _, _, n in wslots])
            pws_c = [ex._slice_params(rows[ci], n, 0, n)
                     for ci, _, _, n in wslots]
            if pad:
                # dead lanes: no event, sliced off before every fold; the
                # lead cell's row, so user_init sees valid values
                reps_c.append(torch.zeros(pad, dtype=reps_c[0].dtype))
                seeds_c.append(ex._seed_column(0, pad, dev))
                ts_c.append(torch.full((pad,), float("-inf"),
                                       dtype=ts_c[0].dtype, device=dev))
                pws_c.append(ex._slice_params(rows[wslots[0][0]], pad, 0,
                                              pad))
            pw = (pws_c[0] if len(pws_c) == 1 else
                  tree.map(lambda *xs: torch.cat(xs), *pws_c))
            sims = ex._run_wave(spec, shards_mesh, dev, column(seeds_c),
                                column(reps_c), None if ts_c is None
                                else column(ts_c), pw, programs=programs,
                                with_metrics=with_metrics,
                                chunk_steps=chunk_steps,
                                poll_every=poll_every, on_chunk=on_chunk)
            # the slot-keyed fold, in (cell, lo) order: each cell's slot
            # sliced off the wave (data movement only) through the
            # stream's fold; pad lanes sit past the last slot
            off = 0
            for ci, _, _, n in wslots:
                sl = tree.map(lambda x, off=off, n=n: x[off:off + n], sims)
                accs[ci] = ex._fold(accs[ci], sl, summary_path,
                                    with_metrics)
                off += n
            sims = None  # one wave on the device at a time
            occ["waves"] += 1
            occ["lanes_live"] += live
            occ["lanes_padded"] += pad
            for ci, _, _, _ in wslots:
                occ["slots_by_cell"][ci] += 1

    def dispatch_serve(jobs, round_):
        from cimba_tpu_torch.serve.service import Request

        handles = [(ci, service.submit(Request(
            spec, rows[ci], reps, seed=sd, t_end=t_end,
            chunk_steps=chunk_steps, wave_size=min(cell_wave, reps),
            summary_path=summary_path,
            label=f"{grid.name}:{grid.cell_label(ci)}:r{round_}")))
            for ci, sd, reps in jobs]
        for ci, h in handles:
            res = h.result(serve_timeout)
            accs[ci] = _serve_merge(accs[ci], res.summary, res.n_failed,
                                    res.total_events,
                                    res.metrics if with_metrics else None)

    aud = obs_audit.resolve(audit)
    seed_log: list = [[] for _ in range(C)]
    live = np.ones(C, bool)
    n_reps = np.zeros(C, np.int64)
    stop_round = np.full(C, -1, np.int32)
    n_rounds = 0
    total_rounds = 1 if stop is None else int(max_rounds)
    rep_cap = max(R0, max_wave)
    rec = telemetry.spans if telemetry is not None else None
    trace = root = None
    if rec is not None:
        trace = rec.new_trace()
        root = rec.start(trace, "sweep", grid=grid.name, n_cells=C,
                         adaptive=stop is not None,
                         serve_backed=service is not None)
    try:
        while n_rounds < total_rounds and live.any():
            live_cells = np.flatnonzero(live)
            if stop is not None and redistribute:
                reps_r = min(max(R0, R0 * C // len(live_cells)), rep_cap)
            else:
                reps_r = R0
            jobs = [(int(c), round_seed(seed, int(c), n_rounds), reps_r)
                    for c in live_cells]
            for c, sd, _ in jobs:
                seed_log[c].append(int(sd))
            span_round = None
            if rec is not None:
                span_round = rec.start(trace, "round", parent=root,
                                       round=n_rounds,
                                       n_live=len(live_cells),
                                       reps_per_cell=reps_r)
            if service is None:
                dispatch(jobs)
            else:
                dispatch_serve(jobs, n_rounds)
            for c, _, n in jobs:
                n_reps[c] += n
            n_rounds += 1
            if stop is not None:
                met_now = stop.met(_stack_summaries(accs), n_reps)
                stop_round[np.flatnonzero(live & met_now)] = n_rounds - 1
                live &= ~met_now
            else:
                live[:] = False
            if span_round is not None:
                rec.end(span_round, outcome="ok", still_live=int(live.sum()))
            if telemetry is not None:
                telemetry.tick("sweep.round")
            if on_round is not None:
                on_round(n_rounds, int(live.sum()), int(n_reps.sum()))
    except BaseException:
        if rec is not None:
            rec.end_trace(trace, "error")
        raise
    if rec is not None:
        rec.end_trace(trace, "completed", rounds=n_rounds)

    confidence = 0.95 if stop is None else stop.confidence
    summaries = _stack_summaries(accs)
    hw = halfwidths(summaries, confidence).detach().cpu().double().numpy()
    met = None if stop is None else stop.met(summaries, n_reps)
    metrics = None
    if with_metrics:
        metrics = obs_metrics.pool_across([a[3] for a in accs])
    occ["slots_by_cell"] = occ["slots_by_cell"].tolist()
    lanes = occ["lanes_live"] + occ["lanes_padded"]
    occ["padding_waste_frac"] = (occ["lanes_padded"] / lanes if lanes
                                 else 0.0)
    if serve_stats0 is not None:
        s1 = service.stats()
        occ["serve"] = {k: s1[k] - serve_stats0[k] for k in (
            "batches", "waves", "lanes_dispatched", "lanes_padded")}
    audit_card = None
    if aud is not None:
        cells_blk = [
            {"cell": grid.cell_label(c), "seeds": seed_log[c],
             "reps": int(n_reps[c]), "stop_round": int(stop_round[c]),
             "result_digest": obs_audit.result_digest(accs[c])}
            for c in range(C)]
        audit_card = aud.finalize(
            "sweep", spec=spec,
            seed_schedule={"seed": int(seed),
                           "rule": "round_seed(seed, cell, round)"},
            geometry={"grid": grid.name, "n_cells": C, "reps_per_cell": R0,
                      "cell_wave": cell_wave, "max_wave": max_wave,
                      "chunk_steps": chunk_steps, "t_end": t_end,
                      "profile": config.active_profile(),
                      "with_metrics": with_metrics,
                      "adaptive": stop is not None,
                      "redistribute": bool(redistribute),
                      "n_rounds": n_rounds,
                      "serve_backed": service is not None,
                      "mesh": ex.mesh_descriptor(mesh)},
            cells=cells_blk, telemetry=(telemetry.snapshot() if telemetry
                                        is not None else None),
            device=dev)
    return SweepResult(
        grid=grid, summaries=summaries, n_reps=n_reps,
        n_failed=np.asarray([int(a[1]) for a in accs], np.int64),
        total_events=np.asarray([int(a[2]) for a in accs], np.int64),
        stop_round=stop_round, halfwidth=hw, met=met, n_rounds=n_rounds,
        seed=seed, confidence=confidence,
        wall_s=time.perf_counter() - t0, occupancy=occ, metrics=metrics,
        audit=audit_card, launches=_chunk_launches() - launches0)


def _chunk_launches() -> int:
    """Launches of every CUDA chunk wrapper so far (the hand-written
    single-queue and AWACS instances and the generated family)."""
    from cimba_tpu_torch.core import kernel_run as kr

    return (kr.queue_chunk.launches + kr.awacs_chunk.launches
            + kr.gen_chunk.launches)


def run_fused_sweeps(points, *, reps_per_cell: int, seed: int = 0,
                     service=None, fuse_max_specs: Optional[int] = None,
                     max_wave: int = 4096, serve_timeout: float = 600.0,
                     **kw) -> list:
    """Several sweeps of distinct models through one fuse-enabled service
    (parity: ``cimba_tpu.sweep.run_fused_sweeps``), so their cells pack
    into cross-spec fused waves.  ``points`` is a sequence of ``(spec,
    grid)``; each runs as a serve-backed :func:`run_sweep` with the same
    ``reps_per_cell``, ``seed`` and ``**kw``, in a thread of its own,
    against one ``serve.Service(fuse=True)`` (on ``kw``'s ``device``, the
    card by default).  Returns the SweepResults in ``points`` order, each
    cell bitwise its direct fixed-R twin's.  ``service=`` reuses a
    caller's service (its ``fuse`` setting governs)."""
    import threading

    points = list(points)
    if not points:
        return []
    owned = service is None
    if owned:
        from cimba_tpu_torch.serve.service import Service

        service = Service(max_wave=max_wave, fuse=True,
                          fuse_max_specs=fuse_max_specs,
                          device=kw.get("device", "cuda"))
    results: list = [None] * len(points)
    errors: list = [None] * len(points)

    def one(i, spec, grid):
        try:
            results[i] = run_sweep(spec, grid, reps_per_cell=reps_per_cell,
                                   seed=seed, service=service,
                                   serve_timeout=serve_timeout,
                                   max_wave=max_wave, **kw)
        except BaseException as e:  # raised again on the caller's thread
            errors[i] = e

    try:
        threads = [threading.Thread(target=one, args=(i, s, g), daemon=True,
                                    name=f"fused-sweep-{i}")
                   for i, (s, g) in enumerate(points)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        if owned:
            service.shutdown(wait=True)
    for e in errors:
        if e is not None:
            raise e
    return results
