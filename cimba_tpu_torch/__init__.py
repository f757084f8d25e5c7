"""cimba-tpu ported to PyTorch and CUDA (one NVIDIA H100).

The JAX package :mod:`cimba_tpu` is the reference; this package mirrors
its module names and is held against it by ``tests/test_torch_*.py``.
It imports ``torch`` and numpy only — never ``jax`` and nothing of
``cimba_tpu``.

Ported so far: the M/M/1, M/M/c and AWACS models (``models.mm1``,
``models.mmc``, ``models.awacs``) — Threefry streams and the full
sampler catalogue, Pébay summaries and time-weighted recording, the
process-interaction engine for the commands those models issue, the
experiment runner, and the hand-written CUDA kernels that replace the
JAX package's Pallas kernels: the chunk kernels (``core.kernel_run``,
``csrc/queue_chunk.cu``, ``csrc/awacs_chunk.cu``), the bulk samplers,
the AWACS scorer, and the bisect kernels of the bring-up tools
(``tools``).  Entry points run on ``device="cuda"`` unless asked for the
CPU.
"""

from cimba_tpu_torch import config

__version__ = "0.1.0"

__all__ = ["config"]
