"""Engine (torch port of cimba_tpu.core): process commands, model DSL,
event set, guards, the lane-batched event loop and the CUDA chunk
kernel's host loop."""

from cimba_tpu_torch.core import process as cmd

__all__ = ["cmd"]
