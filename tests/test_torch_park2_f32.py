"""Tutorial 2's cheese park in the f32 profile (the drawn amounts are
int64, cast to float64 as the reference casts them, and to float32
where a command or a local holds them): the port against cimba_tpu as
in ``test_torch_park2.py``, and the tutorial's gates through
``run_experiment(..., device="cpu")``."""

import jax
import numpy as np
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import loop as jloop
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.examples import tut_2_park as t2
from examples import tut_2_park as j2
from test_torch_park2 import RTOL, T_MID, check_matches_reference, ref

torch.set_num_threads(1)


def test_matches_reference_f32():
    check_matches_reference("f32")


def test_main_on_cpu_checks_the_gates():
    """``main`` goes through ``runner.experiment.run_experiment`` on the
    CPU and checks the tutorial's gates; it returns the muggings."""
    with tconfig.profile("f32"):
        assert t2.main(R=4, device="cpu") > 0


def test_reference_state_carried_in_finishes_as_reference():
    """The reference's state at T_MID, carried into the port by
    ``interop.sim_from_numpy`` (leaf for leaf in ``jax.tree.leaves``
    order), run on by the port to the end: the reference's own end."""
    js, _, jout = ref("f32")
    with jconfig.profile("f32"):
        jspec, _ = j2.build()
        jmid = jax.jit(jax.vmap(jloop.make_run(jspec, t_end=T_MID)))(js)
    with tconfig.profile("f32"):
        spec, _ = t2.build()
        mid = interop.sim_from_numpy(
            [np.asarray(x) for x in jax.tree.leaves(jmid)], spec,
            device="cpu")
        assert bool((mid.pools.held > 0).any())
        end = tloop.make_run(spec)(mid)
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(end), RTOL["f32"]) == []
