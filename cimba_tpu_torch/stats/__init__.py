"""Statistics (torch port of cimba_tpu.stats): Pébay summaries."""
