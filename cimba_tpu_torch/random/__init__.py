"""Counter-based streams and samplers (torch port of cimba_tpu.random)."""

from cimba_tpu_torch.random.bits import (
    RandomState,
    fmix64,
    initialize,
    next_bits64,
    threefry2x32,
)
from cimba_tpu_torch.random.distributions import (
    exponential,
    std_exponential,
    uniform01,
    uniform01_53,
)

__all__ = [
    "RandomState", "fmix64", "initialize", "next_bits64", "threefry2x32",
    "exponential", "std_exponential", "uniform01", "uniform01_53",
]
