"""Utilities (torch port of :mod:`cimba_tpu.utils`): logging, contracts,
seeding, debug dumps."""

from cimba_tpu_torch.utils import dbc, debug, logger, seed

__all__ = ["dbc", "debug", "logger", "seed"]
