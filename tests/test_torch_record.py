"""Queue-length recording through the engine: mm1.build() (its default,
``record=True``) in the port against cimba_tpu, and a recording Sim
carried between the packages.

Same spec, seed and parameters through ``jax.jit(jax.vmap(make_run))``
and the port's ``make_run`` on the CPU (8 lanes, 100 objects, both
profiles), leaf for leaf with ``interop.diff_leaves``, the queue's length
accumulator ``queues.acc`` included; tolerances as in
tests/test_torch_mmc.py.
"""

import jax
import numpy as np
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import loop as jloop
from cimba_tpu.models import mmc as jmmc
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop, tree
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.models import mmc as tmmc
from test_torch_mmc import RTOL, _port, _ref_run


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("name", ["mm1_record"])
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




@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_recording_sim_round_trips(prof):
    """A recording mmc Sim mid-run: the reference's leaves into the port
    (interop.sim_from_numpy) equal the port's own run to the same step,
    queues.acc included, and go back (sim_to_numpy) unchanged, dtypes
    and all."""
    lanes, n, k = 6, 40, 25
    with jconfig.profile(prof):
        spec, _ = jmmc.build(3)
        p = jmmc.params(n, 2.5, 1.0)
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(spec, 9, r, p)))(
            jax.numpy.arange(lanes))
        jmid = jax.jit(jax.vmap(jloop.make_run(spec, max_steps=k)))(js)
    ref = [np.asarray(x) for x in jax.tree.leaves(jmid)]
    with tconfig.profile(prof):
        tspec, _ = tmmc.build(3)
        tp = tmmc.params(n, 2.5, 1.0)
        carried = interop.sim_from_numpy(ref, tspec, tp, device="cpu")
        own = tloop.make_run(tspec, max_steps=k)(
            tloop.init_sim(tspec, 9, torch.arange(lanes), tp, device="cpu"))
    assert carried.queues.acc.summary.n.shape == (lanes, 1)
    assert len(tree.leaves(carried.queues.acc)) == 11
    assert bool(carried.queues.acc.started.all())
    assert interop.diff_leaves(interop.sim_to_numpy(own),
                               interop.sim_to_numpy(carried),
                               RTOL[prof]) == []
    back = interop.sim_to_numpy(carried)
    assert interop.diff_leaves(ref, back, 0.0) == []
    assert [a.dtype for a in back] == [a.dtype for a in ref]
