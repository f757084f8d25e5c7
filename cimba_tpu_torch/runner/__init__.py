"""Experiment runner (torch port of cimba_tpu.runner)."""
