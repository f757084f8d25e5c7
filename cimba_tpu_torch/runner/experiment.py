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
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.core import kernel_run
from cimba_tpu_torch.core.loop import Sim, init_sim, make_run
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
        sims = make_run(spec, t_end=t_end)(sims)
        return ExperimentResult(sims=sims, n_failed=(sims.err != 0).sum(),
                                total_events=sims.n_events.sum(), launches=0)
    run = kernel_run.make_kernel_run(spec, t_end=t_end,
                                     chunk_steps=chunk_steps,
                                     max_chunks=max_chunks)
    sims = run(sims)
    return ExperimentResult(
        sims=sims,
        n_failed=(sims.err != 0).sum(),
        total_events=sims.n_events.sum(),
        launches=run.launches,
        boundary_rounds=run.boundary_rounds,
    )


def pooled_summary(batched: sm.Summary) -> sm.Summary:
    """Merge per-replication summaries into one (the reference's binary
    tree order)."""
    return sm.merge_tree(batched)
