"""Scenario grids (torch port of :mod:`cimba_tpu.sweep`, the grid only)."""

from cimba_tpu_torch.sweep.grid import SweepGrid

__all__ = ["SweepGrid"]
