"""Counter-based streams and the sampler catalogue (torch port of
cimba_tpu.random): the same public names.  The bulk [R, n] samplers on
the card are in :mod:`cimba_tpu_torch.random.block_kernels`, the
ziggurats in :mod:`cimba_tpu_torch.random.ziggurat`.
"""

from cimba_tpu_torch.random.bits import (
    RandomState,
    fmix64,
    initialize,
    next_bits64,
    threefry2x32,
)
from cimba_tpu_torch.random.alias import AliasTable, alias_create, alias_sample
from cimba_tpu_torch.random.distributions import (
    bernoulli,
    beta,
    binomial,
    cauchy,
    chisquared,
    dice,
    discrete_nonuniform,
    discrete_uniform,
    erlang,
    exponential,
    f_dist,
    flip,
    gamma,
    geometric,
    hyperexponential,
    hypoexponential,
    loaded_dice,
    logistic,
    lognormal,
    negative_binomial,
    normal,
    pareto,
    pascal,
    pert,
    pert_mod,
    poisson,
    rayleigh,
    std_beta,
    std_exponential,
    std_gamma,
    std_normal,
    std_t_dist,
    t_dist,
    triangular,
    uniform,
    uniform01,
    uniform01_53,
    weibull,
)

__all__ = [name for name in dir() if not name.startswith("_")]
