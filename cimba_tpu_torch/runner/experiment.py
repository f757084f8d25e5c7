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

Observability (parity: the reference's runner): ``run_experiment(...,
with_report=True)`` also returns an ``obs.prof.RunReport`` (the build,
load and execute legs timed apart, the card's memory statistics, the
pooled metrics snapshot), and ``profile_dir`` runs the execute leg under
``torch.profiler``; ``run_experiment_stream(..., audit=...)`` digests
the lane state after every chunk and returns a run card
(``obs.audit``).  The flight recorder and the metrics registry run on
the plain engine: on the card the runners go through the CUDA chunk
kernel, which refuses them (the reference's kernel-path contract).
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
from cimba_tpu_torch.obs import metrics as obs_metrics
from cimba_tpu_torch.obs import trace as obs_trace
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


def _refuse_observed(dev, route: str) -> None:
    """On the card a runner goes through the CUDA chunk kernel, which
    carries neither the flight recorder nor the metrics registry: with
    either enabled it raises, naming the route (the reference's
    kernel-path contract), rather than dropping them or running the
    plain engine in its place."""
    if dev.type != "cuda":
        return
    for mod in (obs_trace, obs_metrics):
        if mod.enabled():
            raise RuntimeError(f"{route} on the card runs the CUDA chunk "
                               f"kernel: {mod.KERNEL_REFUSAL}")


def run_experiment(spec: ModelSpec, params: Any, n_replications: int, *,
                   seed: int = 0, t_end: Optional[float] = None,
                   device="cuda", chunk_steps: int = 512,
                   max_chunks: int = 10_000, with_report: bool = False,
                   profile_dir: Optional[str] = None):
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
    cannot take raises there, naming what it uses).

    ``with_report=True`` returns ``(ExperimentResult, obs.prof.RunReport)``:
    the kernel's build (for a generated spec, its trace and emit), the
    library's nvcc build or load and the run timed apart, the card's
    ``torch.cuda.memory_stats`` and, where the metrics registry is on
    (the plain engine, ``device="cpu"``), its pooled snapshot.
    ``profile_dir`` runs the execute leg under ``torch.profiler`` and
    writes its Chrome trace there.  With the flight recorder or the
    registry on, a run on the card raises (:func:`_refuse_observed`)."""
    from cimba_tpu_torch.obs import prof

    dev = config.resolve_device(device)
    _refuse_observed(dev, "run_experiment")
    sims = init_sim(spec, seed, torch.arange(n_replications), params,
                    device=dev)
    build = load = None
    if dev.type != "cuda":
        run = make_run(spec, t_end=t_end)
    else:
        run = kernel_run.make_kernel_run(spec, t_end=t_end,
                                         chunk_steps=chunk_steps,
                                         max_chunks=max_chunks)
        got = {}

        def build():
            got["lay"], got["kernel"], _ = kernel_run.kernel_for(spec, sims)

        def load():
            kernel_run.load_library(got["kernel"], got["lay"])

    if with_report:
        out, timings = prof.profiled_call(run, sims, build=build,
                                          load=load, device=dev,
                                          profile_dir=profile_dir)
    else:
        out = run(sims)
    result = _result(out, getattr(run, "launches", 0),
                     getattr(run, "boundary_rounds", 0))
    if not with_report:
        return result
    snap = None
    if out.metrics is not None:
        snap = obs_metrics.snapshot(obs_metrics.pool(out.metrics), spec)
    return result, prof.build_report(
        timings, n_replications=n_replications,
        n_failed=int(result.n_failed), total_events=int(result.total_events),
        metrics=snap, profile_dir=profile_dir, device=dev)


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
    metrics: Any = None          # the pooled registry, where it is on
    audit: Any = None            # the run card, with audit on


def _not_ported(**kw) -> None:
    """Refuse an argument whose module the port does not have yet, by
    name, rather than ignore it."""
    where = {"mesh": "multi-GPU runs (make_mesh, make_sharded_experiment)",
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
    _refuse_observed(dev, "run_experiment_chunked")
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
    lanes_done)`` after each wave, ``on_chunk(n)`` after each chunk.
    With the metrics registry on (the plain engine, ``device="cpu"``)
    each wave's pooled registry folds into ``StreamResult.metrics``.

    ``audit`` (the determinism audit): ``None`` defers to the
    ``CIMBA_AUDIT`` environment knob (unset: off, and the chunks are the
    unaudited ones); ``True``, a directory or an ``obs.audit.Audit``
    digest the lane state after every chunk on its device (on the card,
    each K1 launch is followed by the digest), one trail row a chunk
    (wave, chunk, class digests; a regrown wave's first attempt's rows
    stay, then the regrown run's), and ``StreamResult.audit`` carries the
    run card: spec fingerprint, seed schedule, environment, geometry,
    trail and :func:`obs.audit.stream_result_digest`, written to the
    Audit's ``out_dir`` when it has one.  Auditing changes no result
    bit."""
    import dataclasses

    from cimba_tpu_torch.obs import audit as obs_audit

    _not_ported(mesh=mesh, telemetry=telemetry, program_cache=program_cache,
                schedule=schedule)
    dev = config.resolve_device(device)
    _refuse_observed(dev, "run_experiment_stream")
    aud = obs_audit.resolve(audit)
    spec0 = spec  # a regrow replaces spec; the card cites the original
    with_metrics = obs_metrics.enabled()
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
        on_digest = None
        if aud is not None:
            def on_digest(c, d, _w=n_waves):
                aud.on_chunk(_w, c, d)
        while True:
            sims = init_sim(spec, seeds, reps, pw, t_stop=t_stops,
                            device=dev)
            sims = drive_chunks(
                make_chunk(spec, max_steps=chunk_steps,
                           audit=aud is not None), sims,
                poll_every=poll_every, on_chunk=on_chunk,
                on_digest=on_digest)
            if n_regrows >= max_regrows or not bool(
                    (sims.err == _loop.ERR_EVENT_OVERFLOW).any()):
                break
            # the wave again at a doubled cap; the failed wave is freed
            # before the new init
            spec = dataclasses.replace(spec, event_cap=2 * spec.event_cap)
            n_regrows += 1
            sims = None
        acc = _fold(acc, sims, summary_path, with_metrics)
        sims = None
        n_waves += 1
        lo += n
        if on_wave is not None:
            on_wave(n_waves, lo)
    result = StreamResult(summary=acc[0], n_failed=acc[1],
                          total_events=acc[2], n_waves=n_waves,
                          n_regrows=n_regrows,
                          metrics=acc[3] if with_metrics else None)
    if aud is not None:
        card = aud.finalize(
            "stream", spec=spec0, seed_schedule={"seed": int(seed)},
            geometry={"R": R, "wave_size": wave_size,
                      "chunk_steps": chunk_steps, "poll_every": poll_every,
                      "t_end": t_end, "profile": config.active_profile(),
                      "with_metrics": with_metrics, "mesh": None,
                      "n_waves": n_waves, "n_regrows": n_regrows},
            result_digest=obs_audit.stream_result_digest(result),
            device=dev)
        result = result._replace(audit=card)
    return result


def _fold(acc, sims: Sim, summary_path, with_metrics: bool = False):
    """The wave fold: ``(merge(acc, merge_tree(summary_path(sims))),
    n_failed + ..., total_events + ...[, merge(metrics, pool(...))])``,
    counts in int64 (parity: the reference's ``serve.cache`` fold
    program)."""
    if (sims.metrics is None) == with_metrics:
        raise RuntimeError(
            "run_experiment_stream: obs.metrics was "
            f"{'enabled' if with_metrics else 'disabled'} when the stream "
            "started but flipped mid-stream — the flag binds for the whole "
            "stream")
    pooled = sm.merge_tree(summary_path(sims))
    dev = pooled.n.device
    if acc is None:
        acc = (sm.empty((), dev, pooled.n.dtype),
               torch.zeros((), dtype=torch.int64, device=dev),
               torch.zeros((), dtype=torch.int64, device=dev))
        if with_metrics:
            m = sims.metrics
            acc = acc + (obs_metrics.create(
                m.dispatch_by_kind.shape[1], m.queue_hwm.shape[1], (), dev,
                count=m.guard_retries.dtype),)
    out = (sm.merge(acc[0], pooled),
           acc[1] + (sims.err != 0).sum(dtype=torch.int64),
           acc[2] + sims.n_events.sum(dtype=torch.int64))
    if with_metrics:
        out = out + (obs_metrics.merge(acc[3],
                                       obs_metrics.pool(sims.metrics)),)
    return out


def pooled_summary(batched: sm.Summary) -> sm.Summary:
    """Merge per-replication summaries into one (the reference's binary
    tree order)."""
    return sm.merge_tree(batched)
