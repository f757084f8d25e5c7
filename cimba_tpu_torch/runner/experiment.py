"""The experiment runner: replications as lanes (torch port of
:mod:`cimba_tpu.runner.experiment`, the ``run_experiment`` /
``pooled_summary`` pair).

Replication r is lane r of one batched Sim.  On the card the lanes go
through the spec's CUDA chunk kernel and the host loop of
:mod:`cimba_tpu_torch.core.kernel_run`: a hand-written instance for the
M/M/1 and M/M/c (with or without queue-length recording), the M/G/1
sweep, the tandem network, the job shop, and AWACS (whose radar dwells
run between chunks as one launch of the dwell kernel a boundary round),
and for any other spec over the ported toolkit an instance generated
from its blocks; on ``device="cpu"`` through the plain engine.  A sweep's parameters (leaves
with leading axis ``n_replications``, e.g. ``mg1.sweep_params`` or
``tandem.sweep_grid(n).rows(r)``) give each lane its own row.  A failed
replication freezes with ``sim.err`` set and is counted, as in the
reference.  The pooled statistic is a model's summary leaf:
:func:`default_summary_path` (``wait``) for the queueing models, the
model's own ``summary_path`` elsewhere (``models.jobshop.summary_path``:
``done``, as the job shop records no ``wait``).

The long-run paths (parity: the reference's ``run_experiment_chunked``,
``run_experiment_stream`` and ``run_experiment_regrow``) drive the same
chunks from the host without a sync a chunk (``core.loop.drive_chunks``):
a chunked run, checkpointed at chunk boundaries and resumable
(:mod:`cimba_tpu_torch.runner.checkpoint`); a streamed run over waves of
lanes, each folded into pooled statistics and freed before the next; and
a run that doubles ``event_cap`` after an event-table overflow.  Each
gives the monolithic run's trajectories bit for bit.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from cimba_tpu_torch import config, tree
from cimba_tpu_torch.core import kernel_run
from cimba_tpu_torch.core import loop as _loop
from cimba_tpu_torch.core.loop import (Sim, drive_chunks, init_sim,
                                       make_chunk, make_run)
from cimba_tpu_torch.core.model import ModelSpec
from cimba_tpu_torch.stats import summary as sm


def default_summary_path(sims):
    """The default pooled statistic: the per-replication ``wait``
    summary every queueing model records (parity:
    ``cimba_tpu.runner.experiment.default_summary_path``)."""
    return sims.user["wait"]


class ExperimentResult(NamedTuple):
    sims: Sim                    # batched: every leaf has leading axis [R]
    n_failed: torch.Tensor       # replications with err != 0
    total_events: torch.Tensor   # dispatched events across replications
    launches: int                # CUDA chunk-kernel launches (0 on CPU)
    boundary_rounds: int = 0     # host steps of boundary blocks, on the card


def _result(sims: Sim, launches: int = 0, rounds: int = 0):
    return ExperimentResult(sims=sims, n_failed=(sims.err != 0).sum(),
                            total_events=sims.n_events.sum(),
                            launches=launches, boundary_rounds=rounds)


def run_experiment(spec: ModelSpec, params: Any, n_replications: int, *,
                   seed: int = 0, t_end: Optional[float] = None,
                   device="cuda", chunk_steps: int = 512,
                   max_chunks: int = 10_000) -> ExperimentResult:
    """Run ``n_replications`` independent replications of ``spec``.

    ``params`` holds scalars (shared) or arrays with leading axis
    ``n_replications`` (a sweep).  ``device`` defaults to ``"cuda"``;
    without a card only ``device="cpu"`` runs, and it runs the plain
    PyTorch engine.  On the card every chunk of ``chunk_steps`` events
    per lane is one launch of the spec's CUDA kernel (hand-written for
    ``models.mm1.build(...)``, ``models.mmc.build(c)`` for c in 1..4,
    ``models.mg1.build()``, ``models.tandem.build()``,
    ``models.jobshop.build(...)`` and ``models.awacs.build(n)``,
    generated from the blocks for any other spec; a spec the generator
    cannot take raises there, naming what it uses)."""
    dev = config.resolve_device(device)
    sims = init_sim(spec, seed, torch.arange(n_replications), params,
                    device=dev)
    if dev.type != "cuda":
        return _result(make_run(spec, t_end=t_end)(sims))
    run = kernel_run.make_kernel_run(spec, t_end=t_end,
                                     chunk_steps=chunk_steps,
                                     max_chunks=max_chunks)
    return _result(run(sims), run.launches, run.boundary_rounds)


class StreamResult(NamedTuple):
    """What :func:`run_experiment_stream` returns: statistics pooled over
    every replication, without the Sims, which went through the device
    a wave at a time and were folded in (parity:
    ``cimba_tpu.runner.experiment.StreamResult``)."""

    summary: sm.Summary          # pooled over every replication
    n_failed: torch.Tensor       # replications with err != 0, all waves
    total_events: torch.Tensor   # i64 dispatched events, all waves
    n_waves: int
    n_regrows: int               # waves run again at a doubled event_cap
    metrics: Any = None          # the registry is not ported: always None
    audit: Any = None            # the audit plane is not ported: None


def _not_ported(**kw) -> None:
    """Refuse an argument whose module the port does not have yet, by
    name, rather than ignore it."""
    where = {"mesh": "multi-GPU runs (make_mesh, make_sharded_experiment)",
             "audit": "the audit plane (obs/audit.py)",
             "telemetry": "telemetry (obs/telemetry.py)",
             "schedule": "tuned schedules (tune/)",
             "program_cache": "the program cache of the serve layer "
                              "(serve/cache.py)"}
    for name, value in kw.items():
        if value is not None:
            raise NotImplementedError(
                f"{name}=: {where[name]} is not ported to cimba_tpu_torch "
                "yet")


def _seed_column(seed, n: int, device="cuda"):
    """A ``[n]`` column of the seed (an int64 tensor of its 64 bits): the
    seed as lane data, which ``init_sim`` turns into the same streams as
    the scalar seed (parity: ``cimba_tpu.runner.experiment._seed_column``)."""
    return _loop.seed_column(torch.full(
        (n,), int(seed) - (1 << 64) if int(seed) >= 1 << 63 else int(seed),
        dtype=torch.int64), n, device)


def _horizon_column(t_end, n: int, device="cuda"):
    """A ``[n]`` horizon column in the TIME dtype: ``t_end`` in every
    lane, ``None`` (no horizon) as ``+inf`` (parity:
    ``cimba_tpu.runner.experiment._horizon_column``)."""
    return torch.full((n,), float("inf") if t_end is None else float(t_end),
                      dtype=config.time(),
                      device=config.resolve_device(device))


def _slice_params(params: Any, n_total: int, lo: int, n: int):
    """A wave's parameters: a swept leaf (leading axis ``n_total``) cut
    to rows ``[lo, lo + n)``, any other leaf broadcast to ``n`` lanes as
    the whole run broadcasts it, so a wave's lanes get the rows the
    monolithic run's lanes ``lo .. lo + n - 1`` get (parity:
    ``cimba_tpu.runner.experiment._slice_params``)."""
    def sl(x):
        t = torch.as_tensor(
            x, dtype=torch.float64 if isinstance(x, float) else None)
        if t.dim() > 0 and t.shape[0] == n_total:
            return t[lo:lo + n]
        return t.expand((n,) + tuple(t.shape)).contiguous()

    if params is None:
        return None
    if isinstance(params, (tuple, list)):
        return type(params)(_slice_params(x, n_total, lo, n)
                            for x in params)
    if isinstance(params, dict):
        return {k: _slice_params(v, n_total, lo, n)
                for k, v in params.items()}
    return sl(params)


def run_experiment_regrow(spec: ModelSpec, params: Any, n_replications: int,
                          *, seed: int = 0, t_end: Optional[float] = None,
                          max_regrows: int = 4, device="cuda",
                          chunk_steps: int = 512, max_chunks: int = 10_000,
                          mesh=None):
    """:func:`run_experiment`, run again with ``event_cap`` doubled while
    a replication fails with ``ERR_EVENT_OVERFLOW``, at most
    ``max_regrows`` times (parity:
    ``cimba_tpu.runner.experiment.run_experiment_regrow``).  Every lane
    runs again: streams come from (seed, replication), so a healthy lane
    reproduces bit for bit at any capacity.  On the card a grown generated
    spec is emitted and built anew (a new header).  Returns ``(result,
    final_spec, n_regrows)``; raises RuntimeError when the overflow
    outlasts ``max_regrows`` doublings."""
    import dataclasses

    _not_ported(mesh=mesh)
    for n_regrows in range(max_regrows + 1):
        result = run_experiment(spec, params, n_replications, seed=seed,
                                t_end=t_end, device=device,
                                chunk_steps=chunk_steps,
                                max_chunks=max_chunks)
        if not bool((result.sims.err == _loop.ERR_EVENT_OVERFLOW).any()):
            return result, spec, n_regrows
        if n_regrows < max_regrows:
            spec = dataclasses.replace(spec, event_cap=2 * spec.event_cap)
    raise RuntimeError(
        f"run_experiment_regrow: capacity overflow persists after "
        f"{max_regrows} doublings (last run at event_cap={spec.event_cap})"
        " — the model schedules unboundedly or the cap estimate is "
        "pathologically low")


def _sim_shapes(spec: ModelSpec, seeds, params, n: int):
    """The Sim ``init_sim`` makes of ``n`` lanes, as tensors of the meta
    device (shapes and dtypes, no data) from a one-lane init on the CPU:
    a restore's template, which holds no second Sim (parity: the
    reference's ``jax.eval_shape`` of its init)."""
    one = init_sim(spec, seeds[:1].cpu(), torch.arange(1),
                   _slice_params(params, n, 0, 1), device="cpu")
    return tree.map(lambda x: torch.empty((n,) + tuple(x.shape[1:]),
                                          dtype=x.dtype, device="meta"), one)


def run_experiment_chunked(spec: ModelSpec, params: Any,
                           n_replications: int, *, seed: int = 0,
                           t_end: Optional[float] = None,
                           chunk_steps: int = 512, poll_every: int = 4,
                           on_chunk=None,
                           checkpoint_path: Optional[str] = None,
                           checkpoint_every: int = 0, resume: bool = False,
                           device="cuda", mesh=None, telemetry=None
                           ) -> ExperimentResult:
    """:func:`run_experiment` in chunks driven without a sync a chunk
    (parity: ``cimba_tpu.runner.experiment.run_experiment_chunked``):
    each chunk advances every lane by at most ``chunk_steps`` events (on
    the card one launch of the spec's chunk kernel, in place), and the
    host reads a liveness flag only every ``poll_every`` chunks
    (``core.loop.drive_chunks``).  The result is the monolithic run's,
    leaf for leaf, whatever ``chunk_steps``.

    ``checkpoint_path`` with ``checkpoint_every`` saves the Sim every
    that many chunks (``runner.checkpoint.save_resumable``, tagged with
    the spec, seed, horizon and parameters); ``resume`` starts from the
    checkpoint there when there is one, and the resumed run ends bit for
    bit as the uninterrupted one; a checkpoint of another run raises.
    ``launches`` counts chunk kernel launches (0 on the CPU)."""
    import os

    from cimba_tpu_torch.runner import checkpoint as ckpt

    _not_ported(mesh=mesh, telemetry=telemetry)
    dev = config.resolve_device(device)
    reps = torch.arange(n_replications)
    seeds = _seed_column(seed, n_replications, dev)
    tag = None
    if checkpoint_path:
        tag = ckpt.run_tag(spec, seed=seed, params=_slice_params(
            params, n_replications, 0, n_replications), t_end=t_end)
    sims, n0 = None, 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        sims, n0 = ckpt.restore_resumable(
            checkpoint_path, _sim_shapes(spec, seeds, params, n_replications),
            tag=tag, device=dev)
    if sims is None:
        sims = init_sim(spec, seeds, reps, params, device=dev)
    on_state = None
    if checkpoint_path and checkpoint_every:
        def on_state(s, n):
            ckpt.save_resumable(checkpoint_path, s, tag=tag, progress=n)

    # the wrapper whose count the chunks add to (none on the CPU)
    kernel = (kernel_run.kernel_for(spec, sims)[1] if sims.clock.is_cuda
              else None)
    before = kernel.launches if kernel is not None else 0
    # the Sim is the run's own: the chunks advance it in place
    sims = drive_chunks(make_chunk(spec, t_end=t_end, max_steps=chunk_steps),
                        sims, poll_every=poll_every, on_chunk=on_chunk,
                        on_state=on_state, on_state_every=checkpoint_every,
                        n0=n0)
    return _result(sims, kernel.launches - before if kernel is not None
                   else 0)


def run_experiment_stream(spec: ModelSpec, params: Any, n_replications: int,
                          *, wave_size: Optional[int] = None, seed: int = 0,
                          t_end: Optional[float] = None,
                          chunk_steps: Optional[int] = None,
                          poll_every: int = 4,
                          summary_path=default_summary_path,
                          max_regrows: int = 0, on_wave=None,
                          on_chunk=None, device="cuda", mesh=None,
                          telemetry=None, program_cache=None, audit=None,
                          schedule=None) -> StreamResult:
    """Pooled statistics of ``n_replications`` replications run in waves
    of ``wave_size`` lanes (parity:
    ``cimba_tpu.runner.experiment.run_experiment_stream``).  Lane r of
    wave w is replication ``w * wave_size + r``, with its seed and
    parameter row (:func:`_slice_params`), so every replication runs as
    in the monolithic run.  Each wave runs chunked
    (:func:`run_experiment_chunked`'s chunks; ``chunk_steps`` 512 unless
    given) and is folded into ``(Summary, n_failed, total_events)`` by
    ``sm.merge(acc, sm.merge_tree(summary_path(sims)))``, then freed
    before the next wave's init, so the device holds one wave at a time.
    ``t_end`` rides as each lane's ``t_stop`` (no leaf without one).
    With ``max_regrows`` a wave that overflows its event table runs again
    at a doubled ``event_cap``, which later waves keep.  ``on_wave(n,
    lanes_done)`` after each wave, ``on_chunk(n)`` after each chunk."""
    import dataclasses

    _not_ported(mesh=mesh, telemetry=telemetry, program_cache=program_cache,
                audit=audit, schedule=schedule)
    dev = config.resolve_device(device)
    R = int(n_replications)
    if R <= 0:
        raise ValueError(f"n_replications must be positive, got {R}")
    if wave_size is None or wave_size >= R:
        wave_size = R
    if wave_size <= 0:
        raise ValueError(f"wave_size must be positive, got {wave_size}")
    chunk_steps = 512 if chunk_steps is None else chunk_steps
    acc = None
    n_waves = n_regrows = 0
    lo = 0
    while lo < R:
        n = min(wave_size, R - lo)
        reps = torch.arange(lo, lo + n)
        pw = _slice_params(params, R, lo, n)
        seeds = _seed_column(seed, n, dev)
        t_stops = None if t_end is None else _horizon_column(t_end, n, dev)
        while True:
            sims = init_sim(spec, seeds, reps, pw, t_stop=t_stops,
                            device=dev)
            sims = drive_chunks(
                make_chunk(spec, max_steps=chunk_steps), sims,
                poll_every=poll_every, on_chunk=on_chunk)
            if n_regrows >= max_regrows or not bool(
                    (sims.err == _loop.ERR_EVENT_OVERFLOW).any()):
                break
            # the wave again at a doubled cap; the failed wave is freed
            # before the new init
            spec = dataclasses.replace(spec, event_cap=2 * spec.event_cap)
            n_regrows += 1
            sims = None
        acc = _fold(acc, sims, summary_path)
        sims = None
        n_waves += 1
        lo += n
        if on_wave is not None:
            on_wave(n_waves, lo)
    return StreamResult(summary=acc[0], n_failed=acc[1],
                        total_events=acc[2], n_waves=n_waves,
                        n_regrows=n_regrows)


def _fold(acc, sims: Sim, summary_path):
    """The wave fold: ``(merge(acc, merge_tree(summary_path(sims))),
    n_failed + ..., total_events + ...)``, counts in int64 (parity: the
    reference's ``serve.cache`` fold program)."""
    pooled = sm.merge_tree(summary_path(sims))
    if acc is None:
        acc = (sm.empty((), pooled.n.device, pooled.n.dtype),
               torch.zeros((), dtype=torch.int64, device=pooled.n.device),
               torch.zeros((), dtype=torch.int64, device=pooled.n.device))
    return (sm.merge(acc[0], pooled),
            acc[1] + (sims.err != 0).sum(dtype=torch.int64),
            acc[2] + sims.n_events.sum(dtype=torch.int64))


def pooled_summary(batched: sm.Summary) -> sm.Summary:
    """Merge per-replication summaries into one (the reference's binary
    tree order)."""
    return sm.merge_tree(batched)
