"""M/M/c with two servers against cimba_tpu, and the plain version of
the bisect's peek kernel (the port's ``eventset.peek_merged``) against
the reference's ``peek_merged`` on mmc states.

Parity as in tests/test_torch_mmc.py.  The peek runs on the reference's
state after k steps, carried into the port with
``interop.sim_from_numpy``: every Event field must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import eventset as jev
from cimba_tpu.core import loop as jloop
from cimba_tpu.models import mmc as jmmc
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.tools import bisect_kernels
from test_torch_mmc import RTOL, _port, _ref_run

STEPS = (0, 5, 17, 40)


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("name", ["mmc2"])
def test_matches_reference(name, prof):
    lanes, n = 8, 100
    js, jout = _ref_run(prof, name, lanes, n)
    spec, params = _port(prof, name, n)
    with tconfig.profile(prof):
        ts = tloop.init_sim(spec, 2026, torch.arange(lanes), params,
                            device="cpu")
        tout = tloop.make_run(spec)(ts)
    assert tout.queues.acc is not None
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    assert int(tout.err.abs().sum()) == 0 and bool(tout.done.all())
    # the accumulator recorded every put and get: its time runs to the
    # last queue verb, and a queue that ever held items has weight
    assert bool(tout.queues.acc.started.all())
    assert bool((tout.queues.acc.summary.w > 0).all())




@pytest.fixture(scope="module")
def trajectory():
    """The reference's mmc (c=3) states after each k of STEPS, stepped
    by one compiled vmapped step."""
    with jconfig.profile("f64"):
        spec, _ = jmmc.build(3)
        p = jmmc.params(30, 2.5, 1.0)
        s = jax.jit(jax.vmap(lambda r: jloop.init_sim(spec, 2026, r, p)))(
            jnp.arange(8))
        step = jax.jit(jax.vmap(jloop.make_step(spec)))
        states = {}
        for k in range(max(STEPS) + 1):
            if k in STEPS:
                states[k] = s
            s = step(s)
    return states


@pytest.mark.parametrize("k", STEPS)
def test_peek_merged_matches_reference(trajectory, k):
    state = trajectory[k]
    want = jax.vmap(lambda s: jev.peek_merged(s.events, s.wakes,
                                              s.procs.prio, jloop.K_PROC)[0])(
        state)
    spec, params = _port("f64", "mmc3", 30)
    with tconfig.profile("f64"):
        ts = interop.sim_from_numpy(
            [np.asarray(x) for x in jax.tree.leaves(state)], spec, params,
            device="cpu")
    got = bisect_kernels.peek(ts, None, None)  # a CPU Sim: the plain peek
    assert bool(got.found.all())
    for field, a, b in zip(got._fields, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=field)
