"""The many-scenario sweep engine (torch port of :mod:`cimba_tpu.sweep`).

A :class:`SweepGrid` declares named axes over a model's param-tree
leaves; :func:`run_sweep` fans the grid's cells x replications across
waves of the chunked stream runner and folds each cell's pooled Pébay
summary slot by slot (bitwise the direct per-cell stream calls).
``stop=HalfwidthTarget(...)`` runs each cell only until its confidence
interval beats the target, on a deterministic seed schedule that
reproduces bit for bit::

    from cimba_tpu_torch import sweep
    grid = mg1.sweep_grid(n_objects=10_000)
    res = sweep.run_sweep(
        spec, grid, reps_per_cell=32,
        stop=sweep.HalfwidthTarget(target=0.05, relative=True))
    res.to_csv("mg1_sweep.csv")
"""

from cimba_tpu_torch.sweep.adaptive import (HalfwidthTarget,
                                            replication_means, round_seed)
from cimba_tpu_torch.sweep.engine import (SweepResult, run_fused_sweeps,
                                          run_sweep)
from cimba_tpu_torch.sweep.grid import SweepGrid

__all__ = [
    "SweepGrid", "SweepResult", "HalfwidthTarget",
    "replication_means", "round_seed", "run_sweep",
    "run_fused_sweeps",
]
