"""Models (torch port of cimba_tpu.models): the M/M/1 flagship."""
