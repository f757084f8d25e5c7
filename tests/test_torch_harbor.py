"""Tutorial 4's LNG harbor: the port's restatement against cimba_tpu.

``cimba_tpu_torch.examples.tut_4_harbor`` and the reference's
``examples/tut_4_harbor.py`` (two resource pools, several ships waiting
on one pool with different amounts, two conditions whose predicates read
the waiter's own draft, one observing both pools, an explicit
``cond_signal``, ``sin`` and five samplers) through ``jax.jit(jax.vmap(
make_run))`` and the port's plain engine on the CPU (8 lanes, seed 4),
leaf for leaf with ``interop.diff_leaves``: integers exact, floats within
1e-9 of each leaf's scale in f64 and 2e-5 in f32.  The horizon is cut to
``T_CUT`` hours, while ships wait on the pools and on both conditions
(the run to 500 h is the chip's phase 12), because the reference's CPU
compile of a longer run would take this file past its budget.  The f32
profile is in ``test_torch_harbor_f32.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import loop as jloop
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.examples import tut_4_harbor as thb
from examples import tut_4_harbor as jhb

torch.set_num_threads(1)

RTOL = {"f64": 1e-9, "f32": 2e-5}
LANES, SEED, T_CUT = 8, 4, 20.0


@functools.lru_cache(maxsize=None)
def ref_run(prof):
    with jconfig.profile(prof):
        spec = jhb.build()
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(
            spec, SEED, r)))(jnp.arange(LANES))
        out = jax.jit(jax.vmap(jloop.make_run(spec, t_end=T_CUT)))(js)
    return js, out


def check_matches_reference(prof):
    js, jout = ref_run(prof)
    with tconfig.profile(prof):
        spec = thb.build()
        ts = tloop.init_sim(spec, SEED, torch.arange(LANES), thb.params(),
                            device="cpu")
        tout = tloop.make_run(spec, t_end=T_CUT)(ts)
    assert [x.dtype for x in jax.tree.leaves(js)] == [
        x.dtype for x in interop.sim_to_numpy(ts)]
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    assert int(tout.err.abs().sum()) == 0
    assert tout.user["depth"].dtype == torch.float64
    return tout


def test_matches_reference():
    tout = check_matches_reference("f64")
    assert bool((tout.procs.pend_guard >= 0).any())


def test_carried_state_finishes_as_reference():
    """The reference's state at T_CUT (ships pending on the pools and on
    both conditions), carried into the port by ``interop.sim_from_numpy``
    and run on by the port to 2 T_CUT: the reference's state there."""
    _, mid = ref_run("f64")
    with jconfig.profile("f64"):
        spec = jhb.build()
        jend = jax.jit(jax.vmap(jloop.make_run(spec, t_end=2 * T_CUT)))(mid)
    with tconfig.profile("f64"):
        tspec = thb.build()
        ts = interop.sim_from_numpy(
            [np.asarray(x) for x in jax.tree.leaves(mid)], tspec,
            thb.params(), device="cpu")
        assert bool((ts.procs.pend_guard >= 0).any())
        tout = tloop.make_run(tspec, t_end=2 * T_CUT)(ts)
    assert interop.diff_leaves(jax.tree.leaves(jend),
                               interop.sim_to_numpy(tout), RTOL["f64"]) == []
