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
                   profile_dir: Optional[str] = None, mesh=None):
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
    registry on, a run on the card raises (:func:`_refuse_observed`).

    ``mesh`` (:func:`make_mesh`) shards the replications over its
    devices, shard k lanes ``[k * R / n, (k + 1) * R / n)``; every chunk
    of ``chunk_steps`` events is queued on every shard before a liveness
    flag is read, and the shards are gathered on the mesh's first device
    in lane order: every lane's leaves are the unsharded run's, bit for
    bit.  ``n_replications`` must divide evenly over the shards.  Under a
    mesh ``boundary_rounds`` counts the dwell launches on the card, and
    the report's execute leg holds the kernel's build and load."""
    from cimba_tpu_torch.obs import prof

    if mesh is not None:
        dev = _mesh_device(mesh, device)
        _refuse_observed(dev, "run_experiment(mesh=)")
        mesh.bounds(int(n_replications))
        dwell0 = kernel_run.awacs_dwell.launches

        def run_mesh():
            return _mesh_run(spec, params, n_replications, mesh, dev,
                             seed=seed, t_end=t_end, chunk_steps=chunk_steps,
                             max_chunks=max_chunks)

        if with_report:
            (shards, launches), timings = prof.profiled_call(
                run_mesh, device=dev, profile_dir=profile_dir)
        else:
            shards, launches = run_mesh()
        out = _gather(shards, dev)
        result = _result(out, launches,
                         kernel_run.awacs_dwell.launches - dwell0)
        return _with_report(result, out, spec, n_replications, timings,
                            profile_dir, dev) if with_report else result
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
    return _with_report(result, out, spec, n_replications, timings,
                        profile_dir, dev)


def _with_report(result, out: Sim, spec, n_replications, timings,
                 profile_dir, dev):
    """``(result, RunReport)`` of a run's timings, with the pooled
    metrics snapshot where the registry is on."""
    from cimba_tpu_torch.obs import prof

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
    where = {"telemetry": "telemetry (obs/telemetry.py)",
             "schedule": "tuned schedules (tune/)"}
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


# --- the replication mesh ------------------------------------------------

#: the mesh's one axis: replications
REP_AXIS = "rep"


class Mesh(NamedTuple):
    """A 1-D replication mesh (parity: the reference's ``Mesh`` over
    ``REP_AXIS``): ``devices[k]`` holds shard k, lanes ``[k * R / n, (k +
    1) * R / n)`` of an R-lane batch, with their seeds, replication ids,
    horizons and parameter rows.  One process drives every shard: each
    chunk is queued on every shard's device before any liveness flag is
    read, so several cards work at once.  A device may appear more than
    once (two shards on one card, or ``n`` virtual shards on the CPU)."""

    devices: tuple
    axis_names: tuple = (REP_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    def bounds(self, n: int, what: str = "n_replications") -> list:
        """Each shard's ``(lo, hi)`` lanes of an ``n``-lane batch; raises
        unless ``n`` divides evenly over the shards."""
        k = self.size
        if n % k:
            raise ValueError(f"{what}={n} must divide evenly over {k} "
                             "devices")
        m = n // k
        return [(i * m, (i + 1) * m) for i in range(k)]


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A 1-D replication mesh (parity:
    ``cimba_tpu.runner.experiment.make_mesh``).  On ``device="cuda"``
    the first ``n_devices`` cards (all of them by default), raising
    beyond ``torch.cuda.device_count()``; on ``device="cpu"`` ``n_devices``
    virtual shards on the CPU (1 by default), the counterpart of the
    reference's forced host-platform device count."""
    dev = config.resolve_device(device)
    if dev.type == "cuda":
        avail = torch.cuda.device_count()
        n = avail if n_devices is None else int(n_devices)
        if not 1 <= n <= avail:
            raise ValueError(f"make_mesh: {n} devices asked for, "
                             f"{avail} CUDA devices available")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"make_mesh: n_devices must be positive, got {n}")
    return Mesh((torch.device("cpu"),) * n)


def _mesh_device(mesh, device) -> torch.device:
    """The device type a run under ``mesh`` uses (the caller's
    ``device``, resolved: no card raises unless ``device="cpu"``), held
    against the mesh's devices; the mesh's first device, where the
    shards' results are gathered."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= expects a Mesh (runner.experiment.make_mesh),"
                        f" got {type(mesh).__name__}")
    dev = config.resolve_device(device)
    devs = [torch.device(d) for d in mesh.devices]
    if not devs or any(d.type != dev.type for d in devs):
        raise ValueError(f"mesh devices {[str(d) for d in devs]} are not "
                         f"all of the run's device type {dev.type!r}")
    return devs[0]


def _run_mesh(mesh, device):
    """``(mesh, dev)`` for a run: the caller's mesh and its first device
    (:func:`_mesh_device`), or without one a mesh of the one device
    ``device`` resolves to, so every runner drives its lanes one way."""
    if mesh is None:
        dev = config.resolve_device(device)
        return Mesh((dev,)), dev
    return mesh, _mesh_device(mesh, device)


def _shard_init(spec: ModelSpec, mesh: Mesh, seeds, reps, t_stops, params,
                n_total: int, n: int):
    """The shards of the ``n``-lane batch whose lanes take ``reps``,
    ``seeds`` and ``t_stops`` (columns of ``n``, or ``t_stops`` None)
    and rows ``[0, n)`` of ``params`` (leading axis ``n_total`` where
    swept): a tuple of Sims, shard k on ``mesh.devices[k]``."""
    out = []
    for d, (lo, hi) in zip(mesh.devices, mesh.bounds(n)):
        d = torch.device(d)
        out.append(init_sim(
            spec, seeds[lo:hi].to(d), reps[lo:hi],
            _slice_params(params, n_total, lo, hi - lo),
            t_stop=None if t_stops is None else t_stops[lo:hi].to(d),
            device=d))
    return tuple(out)


def _gather(shards, dev: torch.device):
    """The shards' Sims (or any trees of one structure) as one, lanes in
    shard order, on ``dev``; a lone shard is returned as it is."""
    if len(shards) == 1:
        return tree.map(lambda x: x.to(dev), shards[0])
    return tree.map(lambda *xs: torch.cat([x.to(dev) for x in xs]),
                    *shards)


def _split(sims, mesh: Mesh):
    """A whole Sim's lanes as the mesh's shards (copies: a chunk works on
    a shard in place); on a one-shard mesh the Sim itself, which is the
    run's own."""
    if mesh.size == 1:
        return (tree.map(lambda x: x.to(torch.device(mesh.devices[0])),
                         sims),)
    n = int(sims.clock.shape[0])
    return tuple(tree.map(lambda x, lo=lo, hi=hi, d=d: x[lo:hi].to(
        torch.device(d), copy=True), sims)
        for d, (lo, hi) in zip(mesh.devices, mesh.bounds(n)))


def _mesh_chunk(chunk, mesh: Mesh, dev: torch.device, audit: bool = False):
    """``chunk`` (``make_chunk``'s, unaudited) over the shards: every
    shard's chunk queued, then one ``any_live`` flag on ``dev`` (read
    later by ``drive_chunks``).  With ``audit`` a third output, the
    digest of the whole batch: each shard's ``sim_digest`` at its global
    lane offset, summed mod 2**64 (the digest of the gathered Sim)."""
    def run(shards):
        outs = [chunk(s) for s in shards]
        new = tuple(o[0] for o in outs)
        flag = (outs[0][1] if len(outs) == 1 else
                torch.stack([o[1].to(dev) for o in outs]).any())
        if not audit:
            return new, flag
        from cimba_tpu_torch.obs import audit as obs_audit

        off, vecs = 0, []
        for s in new:
            vecs.append(obs_audit.sim_digest(s, lane_offset=off).to(dev))
            off += int(s.clock.shape[0])
        return new, flag, obs_audit.combine_digests(vecs)

    return run


def _drive(spec: ModelSpec, mesh: Mesh, dev, seeds, reps, t_stops, params,
           n_total: int, *, sims=None, t_end=None, chunk_steps: int = 512,
           poll_every: int = 4, max_chunks: Optional[int] = None,
           on_chunk=None, on_state=None, on_state_every: int = 0,
           n0: int = 0):
    """The chunked drive of ``run_experiment(mesh=)`` and
    ``run_experiment_chunked``: the lanes (their ``seeds``, ``reps`` and
    ``t_stops`` columns and ``params`` rows, as :func:`_shard_init` takes
    them, or a whole Sim ``sims`` to resume) split over the mesh's shards
    and driven to their end through ``make_chunk`` (``drive_chunks``);
    ``on_state`` gets the gathered Sim.  Returns ``(shards, chunk
    launches)``, the launches on the card read off the chunk wrapper's
    counter.  The stream's and the sweep's waves run the same chunk
    through the program cache (:func:`_run_wave`)."""
    shards = (_split(sims, mesh) if sims is not None else _shard_init(
        spec, mesh, seeds, reps, t_stops, params, n_total,
        int(reps.shape[0])))
    kernel = (kernel_run.kernel_for(spec, shards[0])[1] if dev.type == "cuda"
              else None)
    before = kernel.launches if kernel is not None else 0
    chunk = _mesh_chunk(make_chunk(spec, t_end=t_end, max_steps=chunk_steps),
                        mesh, dev)
    state = None
    if on_state is not None:
        def state(s, n):
            on_state(_gather(s, dev), n)
    shards = drive_chunks(chunk, shards, poll_every=poll_every,
                          on_chunk=on_chunk, on_state=state,
                          on_state_every=on_state_every, n0=n0,
                          max_chunks=max_chunks)
    return shards, (kernel.launches - before if kernel is not None else 0)


def _mesh_run(spec: ModelSpec, params, n_replications: int, mesh: Mesh,
              dev, *, seed, t_end, chunk_steps: int, max_chunks: int):
    """Every shard of an ``n_replications``-lane run driven to its end;
    returns ``(shards, launches)``.  Raises where lanes are still live
    after ``max_chunks`` chunks (a partial run would corrupt
    statistics)."""
    R = int(n_replications)
    shards, launches = _drive(spec, mesh, dev, _seed_column(seed, R, dev),
                              torch.arange(R), None, params, R, t_end=t_end,
                              chunk_steps=chunk_steps, max_chunks=max_chunks)
    cond = _loop.make_cond(spec, t_end)
    if any(bool(cond(s).any()) for s in shards):
        raise RuntimeError(
            f"run_experiment(mesh=): lanes still live after {max_chunks} "
            f"chunks of {chunk_steps} events — raise chunk_steps/max_chunks")
    return shards, launches


def make_sharded_experiment(spec: ModelSpec, n_replications: int, mesh: Mesh,
                            *, summary_path=default_summary_path,
                            t_end: Optional[float] = None, device="cuda",
                            chunk_steps: int = 512, max_chunks: int = 10_000):
    """The multi-device experiment step (parity:
    ``cimba_tpu.runner.experiment.make_sharded_experiment``): run every
    shard's replications, then pool.  Returns ``fn(params, seed=0) ->
    (pooled Summary, n_failed, total_events)``, all on the mesh's first
    device.  Each shard's ``merge_tree(summary_path(lanes))`` is moved
    there, the partials are stacked in shard order and merged by
    ``merge_tree`` (the reference's ``all_gather`` and merge); the
    counters are sums (its ``psum``).

    With the metrics registry on (``obs.metrics.enable()``) when the
    experiment is built, the return gains a fourth element: the registry
    pooled over lanes and shards (:func:`obs.metrics.pool_across`).  The
    flag binds here; flipping it before a call raises.  The registry runs
    on the plain engine only: on the card it raises, naming the route."""
    dev = _mesh_device(mesh, device)
    R = int(n_replications)
    mesh.bounds(R)
    with_metrics = obs_metrics.enabled()
    _refuse_observed(dev, "make_sharded_experiment")

    def experiment(params, seed=0):
        if obs_metrics.enabled() != with_metrics:
            raise RuntimeError(
                "make_sharded_experiment: obs.metrics was "
                f"{'enabled' if with_metrics else 'disabled'} when this "
                "experiment was built but flipped before the first call — "
                "the flag binds at build time; rebuild the experiment after "
                "changing it")
        _refuse_observed(dev, "make_sharded_experiment")
        shards, _ = _mesh_run(spec, params, R, mesh, dev, seed=seed,
                              t_end=t_end, chunk_steps=chunk_steps,
                              max_chunks=max_chunks)
        parts = [sm.merge_tree(summary_path(s)) for s in shards]
        pooled = sm.merge_tree(tree.map(
            lambda *xs: torch.stack([x.to(dev) for x in xs]), *parts))
        n_failed = sum((s.err != 0).sum(dtype=torch.int32).to(dev)
                       for s in shards)
        events = sum(s.n_events.sum().to(dev) for s in shards)
        if with_metrics:
            return pooled, n_failed, events, obs_metrics.pool_across(
                [obs_metrics.pool(s.metrics) for s in shards], REP_AXIS)
        return pooled, n_failed, events

    return experiment


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
    spec is emitted and built anew (a new header).  ``mesh`` shards every
    run (:func:`run_experiment`).  Returns ``(result, final_spec,
    n_regrows)``; raises RuntimeError when the overflow outlasts
    ``max_regrows`` doublings."""
    import dataclasses

    for n_regrows in range(max_regrows + 1):
        result = run_experiment(spec, params, n_replications, seed=seed,
                                t_end=t_end, device=device,
                                chunk_steps=chunk_steps,
                                max_chunks=max_chunks, mesh=mesh)
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
    ``launches`` counts chunk kernel launches (0 on the CPU).  ``mesh``
    shards the lanes (:func:`run_experiment`); a checkpoint holds the
    gathered Sim, and a resume splits it over the mesh again."""
    import os

    from cimba_tpu_torch.runner import checkpoint as ckpt

    _not_ported(telemetry=telemetry)
    mesh, dev = _run_mesh(mesh, device)
    mesh.bounds(int(n_replications))
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
    on_state = None
    if checkpoint_path and checkpoint_every:
        def on_state(s, n):
            ckpt.save_resumable(checkpoint_path, s, tag=tag, progress=n)

    # the Sim is the run's own: the chunks advance it in place
    shards, launches = _drive(
        spec, mesh, dev, seeds, reps, None, params, n_replications,
        sims=sims, t_end=t_end, chunk_steps=chunk_steps,
        poll_every=poll_every, on_chunk=on_chunk, on_state=on_state,
        on_state_every=checkpoint_every, n0=n0)
    return _result(_gather(shards, dev), launches)


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
    bit.

    ``mesh`` shards each wave over its devices (:func:`run_experiment`):
    every wave's shards are gathered on the mesh's first device and
    folded there as one wave, so the stream is bitwise the unsharded
    stream; ``wave_size`` and ``n_replications`` must divide evenly over
    the shards.  An audited chunk's digest is the gathered wave's: each
    shard's at its lane offset, summed mod 2**64.

    ``summary_path`` is checked before any wave runs
    (:func:`preflight_summary_path`).

    ``program_cache`` (a ``serve.ProgramCache`` or a plain dict; a fresh
    ``ProgramCache`` when None): pass the same mapping to repeated calls,
    and to a ``serve.Service``, to share the wave's programs (the init,
    the chunk with its built K1, the fold), keyed by what they bake in
    (``serve.cache.program_key``).  Seed, ``t_end`` and parameter values
    are lane data: calls differing only in them build nothing new."""
    import dataclasses

    from cimba_tpu_torch.obs import audit as obs_audit

    from cimba_tpu_torch.serve import cache as pcache

    _not_ported(telemetry=telemetry, schedule=schedule)
    shards_mesh, dev = _run_mesh(mesh, device)
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
    shards_mesh.bounds(wave_size, "wave_size")
    shards_mesh.bounds(R)
    chunk_steps = 512 if chunk_steps is None else chunk_steps
    programs = (program_cache if program_cache is not None
                else pcache.ProgramCache())
    pcache.preflight(programs, spec, summary_path, params, R, wave_size,
                     with_metrics, dev)
    fold = pcache.get_fold(programs, with_metrics, summary_path)
    acc = stream_acc(spec, with_metrics, dev)
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
            # a regrow's spec has its own fingerprint, so its own programs
            sims = _run_wave(spec, shards_mesh, dev, seeds, reps, t_stops, pw,
                             programs=programs, with_metrics=with_metrics,
                             chunk_steps=chunk_steps, poll_every=poll_every,
                             on_chunk=on_chunk, on_digest=on_digest,
                             audit=aud is not None)
            if n_regrows >= max_regrows or not bool(
                    (sims.err == _loop.ERR_EVENT_OVERFLOW).any()):
                break
            # the wave again at a doubled cap; the failed wave is freed
            # before the new init
            spec = dataclasses.replace(spec, event_cap=2 * spec.event_cap)
            n_regrows += 1
            sims = None
        acc = fold(acc, sims)
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
                      "with_metrics": with_metrics,
                      "mesh": mesh_descriptor(mesh),
                      "n_waves": n_waves, "n_regrows": n_regrows},
            result_digest=obs_audit.stream_result_digest(result),
            device=dev)
        result = result._replace(audit=card)
    return result


def mesh_descriptor(mesh) -> Optional[dict]:
    """A run card's ``mesh`` geometry: the axis, the shard count and each
    shard's device, or None without a mesh."""
    if mesh is None:
        return None
    return {"axis": mesh.axis_names[0], "size": mesh.size,
            "devices": [str(d) for d in mesh.devices]}


def _run_wave(spec: ModelSpec, mesh: Mesh, dev, seeds, reps, t_stops,
              params, *, programs, with_metrics: bool, chunk_steps: int,
              poll_every: int, on_chunk=None, on_digest=None,
              audit: bool = False) -> Sim:
    """One wave (its ``seeds``, ``reps`` and ``t_stops`` columns,
    ``params`` rows or shared) driven to its end through the init and the
    chunk of ``programs`` (a ``serve.ProgramCache`` or a dict,
    ``serve.cache.get_programs``), sharded over ``mesh``
    (:func:`_run_mesh`'s) and gathered on ``dev`` in lane order."""
    from cimba_tpu_torch.serve import cache as pcache

    init, chunk = pcache.get_programs(programs, spec, mesh=mesh,
                                      chunk_steps=chunk_steps,
                                      with_metrics=with_metrics, audit=audit)
    shards = drive_chunks(chunk, init(reps, seeds, t_stops, params),
                          poll_every=poll_every, on_chunk=on_chunk,
                          on_digest=on_digest)
    return _gather(shards, dev)


# --- the wave programs a serve.ProgramCache holds -------------------------


def _init_program(spec: ModelSpec, mesh: Mesh):
    """``init(reps, seeds, t_stops, params) -> shards`` (parity: the
    reference's ``_init_program``): the lanes of the ``[n]`` ``reps``,
    ``seeds`` and ``t_stops`` columns (``t_stops`` None: no ``t_stop``
    leaf) and ``params`` rows of ``n`` (or shared), split over ``mesh``'s
    shards (:func:`_shard_init`).  Seeds and horizons are lane data, so
    one init serves every (seed, horizon) mix."""
    def init(reps, seeds, t_stops, params):
        n = int(reps.shape[0])
        return _shard_init(spec, mesh, seeds, reps, t_stops, params, n, n)

    return init


def _chunk_program(spec: ModelSpec, mesh: Mesh, dev, chunk_steps: int,
                   audit: bool = False):
    """``chunk(shards) -> (shards, any_live[, digest])``: ``make_chunk``
    with no static horizon (each lane's ``t_stop`` leaf is its own) over
    the mesh's shards (:func:`_mesh_chunk`); on the card one K1 launch a
    shard, in place, the K1 library built and loaded at its first
    call."""
    return _mesh_chunk(make_chunk(spec, max_steps=chunk_steps), mesh, dev,
                       audit)


def _live_program(spec: ModelSpec, mesh: Mesh):
    """``live(shards) -> bool [L]`` on the first shard's device: each
    lane's liveness (``core.loop.make_lanes_live``), in lane order (the
    reference's ``_live_program``).  It reads the wave and changes
    nothing."""
    cond = _loop.make_lanes_live(spec)
    dev = torch.device(mesh.devices[0])

    def live(shards):
        outs = [cond(s) for s in shards]
        return outs[0] if len(outs) == 1 else torch.cat(
            [o.to(dev) for o in outs])

    return live


def _split_columns(mesh: Mesh, shards, cols, params):
    """Each shard's slice of ``[L]`` lane columns and ``params`` rows of
    ``L``: ``[(shard, cols_k, params_k)]``, the columns on the shard's
    device."""
    L = int(cols[0].shape[0])
    out = []
    for s, (lo, hi) in zip(shards, mesh.bounds(L)):
        d = s.clock.device
        out.append((s, tuple(c[lo:hi].to(d) for c in cols),
                    _slice_params(params, L, lo, hi - lo)))
    return out


def _refill_program(spec: ModelSpec, mesh: Mesh):
    """``refill(shards, mask, reps, seeds, t_stops, params) -> shards``
    (the reference's ``_refill_program``): ``core.loop.make_refill`` on
    each shard's lanes, so the masked lanes start afresh as their rows
    say and every other lane keeps its leaves bit for bit."""
    refill = _loop.make_refill(spec)

    def run(shards, mask, reps, seeds, t_stops, params):
        return tuple(refill(s, m, r, sd, ts, p) for s, (m, r, sd, ts), p in
                     _split_columns(mesh, shards,
                                    (mask, reps, seeds, t_stops), params))

    return run


def _fused_init_program(fused, mesh: Mesh):
    """The fused twin of :func:`_init_program`: ``init(reps, seeds,
    t_stops, sids, params) -> shards``, each lane born as its member's
    (``core.fuse.make_fused_init``, selected by the ``sids`` spec-id
    column).  Fused waves always carry the horizon column."""
    from cimba_tpu_torch.core.fuse import make_fused_init

    finit = make_fused_init(fused)

    def init(reps, seeds, t_stops, sids, params):
        n = int(reps.shape[0])
        out = []
        for d, (lo, hi) in zip(mesh.devices, mesh.bounds(n)):
            d = torch.device(d)
            out.append(finit(reps[lo:hi], seeds[lo:hi].to(d),
                             t_stops[lo:hi].to(d), sids[lo:hi].to(d),
                             _slice_params(params, n, lo, hi - lo),
                             device=d))
        return tuple(out)

    return init


def _fused_refill_program(fused, mesh: Mesh):
    """The fused twin of :func:`_refill_program`: ``refill(shards, mask,
    reps, seeds, t_stops, sids, params) -> shards``
    (``core.fuse.make_fused_refill``): one splice serves every member of
    the wave's roster."""
    from cimba_tpu_torch.core.fuse import make_fused_refill

    refill = make_fused_refill(fused)

    def run(shards, mask, reps, seeds, t_stops, sids, params):
        return tuple(refill(s, m, r, sd, ts, si, p)
                     for s, (m, r, sd, ts, si), p in _split_columns(
                         mesh, shards, (mask, reps, seeds, t_stops, sids),
                         params))

    return run


def stream_acc(spec: ModelSpec, with_metrics: bool, device="cuda"):
    """A zeroed accumulator for :func:`_fold`: ``(Summary, n_failed i64,
    total_events i64[, Metrics])`` on ``device`` (parity: the
    reference's ``serve.cache.stream_acc``).  A stream and each cell of a
    sweep start from it."""
    dev = config.resolve_device(device)
    acc = (sm.empty((), dev),
           torch.zeros((), dtype=torch.int64, device=dev),
           torch.zeros((), dtype=torch.int64, device=dev))
    if with_metrics:
        acc = acc + (obs_metrics.create(
            _loop.N_KINDS + len(spec.user_handlers), len(spec.queues), (),
            dev),)
    return acc


def preflight_summary_path(spec: ModelSpec, summary_path, params,
                           n_total: int, n_first: int, device="cuda") -> None:
    """Fail before any wave runs when ``summary_path`` does not give one
    Summary a lane on this model's Sim (parity: the reference's
    ``serve.cache.preflight_summary_path``): the path is applied to a
    two-lane Sim of the first wave's rows on the CPU, and anything but a
    Summary of ``[2]`` leaves raises ValueError naming the knob, not a
    KeyError from inside the fold after a wave of work."""
    n = min(2, int(n_first))
    try:
        s = summary_path(init_sim(
            spec, _seed_column(0, n, "cpu"), torch.arange(n),
            _slice_params(params, n_total, 0, n), device="cpu"))
        if not isinstance(s, sm.Summary) or any(
                tuple(x.shape) != (n,) for x in s):
            raise TypeError(f"got {type(s).__name__} "
                            f"{[tuple(getattr(x, 'shape', ())) for x in s]}"
                            if isinstance(s, tuple) else
                            f"got {type(s).__name__}")
    except Exception as e:
        raise ValueError(
            "run_experiment_stream: summary_path failed on this model's Sim "
            f"structure ({e!r}) — pass summary_path= pointing at a "
            "statistic this model records, one Summary a lane") from e


def _fold(acc, sims: Sim, summary_path, with_metrics: bool = False):
    """The wave fold: ``(merge(acc, merge_tree(summary_path(sims))),
    n_failed + ..., total_events + ...[, merge(metrics, pool(...))])``,
    counts in int64 (parity: the reference's ``serve.cache`` fold
    program), ``acc`` from :func:`stream_acc`.  The stream and the sweep
    engine fold through this one function, so a sweep cell folds exactly
    as a direct stream call does."""
    if (sims.metrics is None) == with_metrics:
        raise RuntimeError(
            "run_experiment_stream: obs.metrics was "
            f"{'enabled' if with_metrics else 'disabled'} when the stream "
            "started but flipped mid-stream — the flag binds for the whole "
            "stream")
    pooled = sm.merge_tree(summary_path(sims))
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
