"""Declarative scenario grids: named axes over param-tree leaves (torch
port of :class:`cimba_tpu.sweep.grid.SweepGrid`).

Named axes (each a sequence of values) span a Cartesian cell table, the
last axis fastest, and a ``row`` function maps one cell's axis values
to one row of the model's param tree.  :meth:`SweepGrid.rows` stacks
the rows into the experiment-array layout ``run_experiment`` takes:
leading axis ``n_cells * reps_per_cell`` in cell-major order, each leaf
a CPU tensor of the dtype its row gave (``np.float64`` leaves stay f64,
``np.int32`` ones i32), equal value for value to the reference's.

Host-side bookkeeping; the sweep engine (``sweep/engine.py``) runs the
cells.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from cimba_tpu_torch import tree


def _structure(x):
    """A param tree's structure, leaves replaced by ``"*"``, in the
    order :mod:`cimba_tpu_torch.tree` walks it."""
    if x is None:
        return None
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x), tuple(_structure(v) for v in x))
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_structure(v) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _structure(x[k])) for k in sorted(x)))
    return "*"


class SweepGrid:
    """A Cartesian scenario grid over a model's parameter tree: ``axes``
    maps names to value sequences (insertion order kept, the last axis
    varies fastest); ``row(**cell)`` returns one cell's param tree of
    scalar leaves, every cell of one structure."""

    def __init__(self, axes: Mapping[str, Sequence],
                 row: Callable[..., Any], *, name: str = "sweep"):
        if not axes:
            raise ValueError("SweepGrid needs at least one axis")
        self.axes = {str(k): tuple(v) for k, v in axes.items()}
        for k, vals in self.axes.items():
            if not vals:
                raise ValueError(f"axis {k!r} has no values")
        self.row = row
        self.name = name
        self._cells = None

    @property
    def n_cells(self) -> int:
        n = 1
        for vals in self.axes.values():
            n *= len(vals)
        return n

    def cells(self) -> tuple:
        """All cells as ``{axis: value}`` dicts, last axis fastest."""
        if self._cells is None:
            names = list(self.axes)
            self._cells = tuple(
                dict(zip(names, combo))
                for combo in itertools.product(*self.axes.values()))
        return self._cells

    def cell(self, i: int) -> dict:
        return dict(self.cells()[i])

    def cell_label(self, i: int) -> str:
        """``"cv=0.25,rho=0.5"``: the cell's axis values."""
        return ",".join(f"{k}={v}" for k, v in self.cells()[i].items())

    def cell_row(self, i: int):
        """The param tree of cell ``i`` (scalar leaves)."""
        return self.row(**self.cells()[i])

    def cell_rows(self) -> list:
        """Every cell's row; raises, naming the cell, when one has
        another tree structure than cell 0."""
        rows = [self.cell_row(i) for i in range(self.n_cells)]
        first = _structure(rows[0])
        for i, r in enumerate(rows[1:], 1):
            if _structure(r) != first:
                raise ValueError(
                    f"SweepGrid {self.name!r}: cell {i} "
                    f"({self.cell_label(i)}) returned a different param "
                    "tree structure than cell 0 — every cell must share "
                    "one structure")
        return rows

    def rows(self, reps_per_cell: int):
        """The experiment array: every cell's row repeated
        ``reps_per_cell`` times along a new leading axis (cell-major),
        as CPU tensors, and the matching ``cell_ids`` (a numpy int
        array)."""
        if reps_per_cell <= 0:
            raise ValueError(
                f"reps_per_cell must be positive, got {reps_per_cell}")
        rows = self.cell_rows()
        flat = [tree.leaves(r) for r in rows]
        leaves = [
            torch.from_numpy(np.repeat(
                np.stack([np.asarray(x) for x in xs], axis=0),
                reps_per_cell, axis=0))
            for xs in zip(*flat)]
        params = tree.unflatten(rows[0], leaves)
        cell_ids = np.repeat(np.arange(self.n_cells), reps_per_cell)
        return params, cell_ids

    def __repr__(self):
        ax = ", ".join(f"{k}[{len(v)}]" for k, v in self.axes.items())
        return f"SweepGrid({self.name!r}: {ax} -> {self.n_cells} cells)"
