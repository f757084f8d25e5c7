"""Tutorial 0, hello: the port's restatement against cimba_tpu, and its
four wakeups.  ``cimba_tpu_torch.examples.tut_0_hello`` and the
reference's ``examples/tut_0_hello.py`` (one greeter holding one time
unit until the clock passes 3) through ``jax.jit(make_run)`` of each
replication and the port's plain engine on the CPU, leaf for leaf
(integers exact, floats within 1e-12 of each leaf's scale), in both
profiles; then ``main`` through ``run_experiment(..., device="cpu")``
and the generated kernel's header, a one-process family."""

import jax
import jax.numpy as jnp
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import loop as jloop
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import kernel_run
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.examples import tut_0_hello as t0
from examples import tut_0_hello as j0

torch.set_num_threads(1)

LANES = 3


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_matches_reference(prof):
    with jconfig.profile(prof):
        spec = j0.build()
        js = jax.vmap(lambda r: jloop.init_sim(spec, 1, r))(
            jnp.arange(LANES))
        jout = jax.jit(jax.vmap(jloop.make_run(spec)))(js)
    with tconfig.profile(prof):
        tspec = t0.build()
        ts = tloop.init_sim(tspec, 1, torch.arange(LANES), device="cpu")
        tout = tloop.make_run(tspec)(ts)
    assert [x.dtype for x in jax.tree.leaves(js)] == [
        x.dtype for x in interop.sim_to_numpy(ts)]
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), 1e-12) == []
    assert tout.user["wakeups"].tolist() == [4] * LANES
    assert tout.clock.tolist() == [3.0] * LANES
    assert tout.n_events.tolist() == [4] * LANES


def test_main_and_header():
    assert t0.main(R=2, device="cpu") == 4
    with tconfig.profile("f32"):
        spec = t0.build()
        s = tloop.init_sim(spec, 1, torch.arange(1), device="cpu")
        lay, fn, _ = kernel_run.kernel_for(spec, s)
    assert fn is kernel_run.gen_chunk
    assert "NP = 1, NQ = 0" in lay["header"]
    assert "NR = 0, NH = 0" in lay["header"]
    assert "MUG = false" in lay["header"]
