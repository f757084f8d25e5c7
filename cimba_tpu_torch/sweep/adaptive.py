"""Sequential stopping for sweeps: run each cell only until its
confidence interval is tight enough (torch port of
:mod:`cimba_tpu.sweep.adaptive`).

The adaptive engine runs the grid in rounds: after each round every
still-live cell's CI halfwidth (:func:`cimba_tpu_torch.stats.summary.
halfwidth`) is held against a target, converged cells stop receiving
lanes, and the freed lanes go to the cells still running.

Determinism: the replications of round ``r`` of cell ``c`` are
``(seed=round_seed(seed, c, r), rep=0..n)``, a pure function of the
experiment seed and the (cell, round) coordinates, independent of which
other cells are still live and of how the waves are packed.  Re-running
an adaptive sweep reproduces every cell's summary bit for bit even
though the stopping pattern reshapes every round's waves.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

_M64 = (1 << 64) - 1
#: the golden-ratio increment (the constant ``random.bits.initialize``
#: separates replication streams by)
_GOLDEN = 0x9E3779B97F4A7C15
_ROUND = 0xBF58476D1CE4E5B9  # splitmix64's multiplier: round separation


def _fmix64(h: int) -> int:
    """MurmurHash3's 64-bit finalizer on a Python int (host-side, exact
    on all 64 bits: scheduling touches no device)."""
    h &= _M64
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _M64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _M64
    h ^= h >> 33
    return h


def round_seed(seed: int, cell: int, round_: int = 0) -> int:
    """The u64 seed of (cell, round) under experiment ``seed``: two
    fmix64 passes, so distinct (cell, round) pairs get statistically
    independent Threefry keys after ``init_sim``'s own per-lane
    derivation.  ``round_=0`` is also a cell's fixed-R seed: a fixed-R
    cell is bitwise a direct ``run_experiment_stream`` call at
    ``seed=round_seed(seed, c, 0)``."""
    h = _fmix64((int(seed) + _GOLDEN * (int(cell) + 1)) & _M64)
    return _fmix64((h + _ROUND * (int(round_) + 1)) & _M64)


def halfwidths(summaries, confidence: float = 0.95):
    """Each cell's halfwidth of a batched Summary (leading axis = cells),
    on the Summary's device."""
    from cimba_tpu_torch.stats import summary as sm

    return sm.halfwidth(summaries, confidence)


def replication_means(base_path=None):
    """A ``summary_path`` whose samples are replication means: each
    lane's base summary collapses to the one sample ``mean(s)``, so the
    pooled cell summary is the batch-means estimator (``n`` =
    replications) and its halfwidth the replication-level CI.  Use it
    where the base statistic's samples within a replication are
    autocorrelated (queue sojourns at high utilisation are), which makes
    the pooled-sample CI read far too narrow.

    ``base_path=None`` wraps the runner's default (the model's ``wait``
    summary).  Calls are memoised on the base path, so repeated calls
    return the same function object."""
    return _replication_means_cached(base_path)


@functools.lru_cache(maxsize=None)
def _replication_means_cached(base_path):
    from cimba_tpu_torch.stats import summary as sm

    def path(sims):
        from cimba_tpu_torch.runner.experiment import default_summary_path

        base = base_path if base_path is not None else default_summary_path
        s = base(sims)
        m = sm.mean(s)
        return sm.add(sm.empty(m.shape, m.device, m.dtype), m)

    path.__name__ = "replication_means(%s)" % getattr(
        base_path, "__name__", "default_summary_path")
    return path


@dataclass(frozen=True)
class HalfwidthTarget:
    """Stop a cell when the CI halfwidth of its pooled mean beats a
    target (``run_sweep(..., stop=...)``).

    ``target`` is an absolute halfwidth or, with ``relative=True``, a
    fraction of the cell's |mean|.  ``confidence`` goes to
    ``stats.summary.halfwidth``.  ``min_reps``: a cell is never judged
    before it has that many replications, however narrow its early CI.

    The CI is computed over whatever samples the sweep's
    ``summary_path`` pools; where those are autocorrelated, run the sweep
    with ``summary_path=replication_means()`` for a calibrated one."""

    target: float
    relative: bool = False
    confidence: float = 0.95
    min_reps: int = 8

    def __post_init__(self):
        if not self.target > 0.0:
            raise ValueError(
                f"halfwidth target must be positive, got {self.target}")
        if not 0.0 < self.confidence < 1.0:
            raise ValueError(
                f"confidence must be in (0, 1), got {self.confidence}")

    def halfwidths(self, summaries):
        """Each cell's halfwidth of a batched Summary."""
        return halfwidths(summaries, self.confidence)

    def met(self, summaries, n_reps):
        """numpy bool ``[C]``: the cells whose CI beats the target and
        that have at least ``min_reps`` replications (``n_reps`` a
        cell)."""
        import numpy as np

        from cimba_tpu_torch.stats import summary as sm

        hw = self.halfwidths(summaries).detach().cpu().double().numpy()
        if self.relative:
            bound = self.target * np.abs(
                sm.mean(summaries).detach().cpu().double().numpy())
        else:
            bound = self.target
        return (hw <= bound) & (np.asarray(n_reps) >= self.min_reps)
