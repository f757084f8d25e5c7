"""cimba-tpu ported to PyTorch and CUDA (one NVIDIA H100).

The JAX package :mod:`cimba_tpu` is the reference; this package mirrors
its module names and is held against it by ``tests/test_torch_*.py``.
It imports ``torch`` and numpy only — never ``jax`` and nothing of
``cimba_tpu``.

Ported so far: the M/M/1 slice (``models.mm1`` with ``record=False``) —
Threefry streams, the exponential sampler, Pébay summaries, the
process-interaction engine for the commands mm1 issues, the experiment
runner, and the hand-written CUDA chunk kernel (``core.kernel_run``,
``csrc/mm1_chunk.cu``) that replaces the Pallas chunk mega-kernel.
Entry points run on ``device="cuda"`` unless asked for the CPU.
"""

from cimba_tpu_torch import config

__all__ = ["config"]
