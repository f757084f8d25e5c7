"""State carried between cimba_tpu and the port, and the runner's
device rule.

``sim_from_numpy`` of the reference's init batch must equal the port's
own ``init_sim`` leaf for leaf; a reference Sim stopped mid-run and
carried across must finish in the port at the reference's end state
(integers equal, floats within the engine tolerances of
test_torch_engine.py).  ``run_experiment`` must refuse to run without a
card unless asked for the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import loop as jloop
from cimba_tpu.models import mm1 as jmm1
from cimba_tpu.runner import experiment as jexp
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.models import mm1 as tmm1
from cimba_tpu_torch.random import alias as talias
from cimba_tpu_torch.random import bits as tbits
from cimba_tpu_torch.random import block_kernels as tbk
from cimba_tpu_torch.runner import experiment as texp
from cimba_tpu_torch.stats import summary as tsm

RTOL = {"f64": 1e-9, "f32": 64 * 2.0**-23}


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_init_and_mid_run_carry(prof):
    lanes, n_objects = 16, 50
    with jconfig.profile(prof), tconfig.profile(prof):
        jspec, _ = jmm1.build(record=False)
        tspec, _ = tmm1.build(record=False)
        js = jax.jit(jax.vmap(
            lambda r: jloop.init_sim(jspec, 7, r, jmm1.params(n_objects))
        ))(jnp.arange(lanes))
        carried = interop.sim_from_numpy(
            [np.asarray(x) for x in jax.tree.leaves(js)], tspec,
            tmm1.params(n_objects), device="cpu")
        own = tloop.init_sim(tspec, 7, torch.arange(lanes),
                             tmm1.params(n_objects), device="cpu")
        assert interop.diff_leaves(interop.sim_to_numpy(own),
                                   interop.sim_to_numpy(carried), 0.0) == []

        mid = jax.jit(jax.vmap(jloop.make_run(jspec, max_steps=50)))(js)
        jend = jax.jit(jax.vmap(jloop.make_run(jspec)))(mid)
        t = interop.sim_from_numpy(
            [np.asarray(x) for x in jax.tree.leaves(mid)], tspec,
            tmm1.params(n_objects), device="cpu")
        tend = tloop.make_run(tspec)(t)
    back = interop.sim_to_numpy(tend)
    assert interop.diff_leaves(jax.tree.leaves(jend), back, RTOL[prof]) == []
    # the leaf list rebuilds the reference's pytree
    rebuilt = jax.tree.unflatten(jax.tree.structure(jend), back)
    assert int(rebuilt.n_events.sum()) == int(jend.n_events.sum())


def test_sim_from_numpy_rejects_wrong_leaves():
    tspec, _ = tmm1.build(record=False)
    with pytest.raises(ValueError):
        interop.sim_from_numpy([np.zeros(3)], tspec, tmm1.params(5),
                               device="cpu")


def test_run_experiment_cpu_matches_reference():
    spec_j, _ = jmm1.build(record=False)
    spec_t, _ = tmm1.build(record=False)
    rj = jexp.run_experiment(spec_j, jmm1.params(60), 24, seed=11)
    rt = texp.run_experiment(spec_t, tmm1.params(60), 24, seed=11,
                             device="cpu")
    assert int(rt.n_failed) == int(rj.n_failed) == 0
    assert int(rt.total_events) == int(rj.total_events)
    assert rt.launches == 0
    pj = jexp.pooled_summary(rj.sims.user["wait"])
    pt = texp.pooled_summary(rt.sims.user["wait"])
    assert float(pt.n) == float(pj.n) == 24 * 60
    np.testing.assert_allclose(float(pt.m1), float(pj.m1), rtol=1e-8)
    np.testing.assert_allclose(float(pt.m2), float(pj.m2), rtol=1e-8)


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, _ = tmm1.build(record=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texp.run_experiment(spec, tmm1.params(10), 4, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.init_sim(spec, 1, torch.arange(2), tmm1.params(10))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsm.empty((2,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbits.initialize(1, torch.arange(2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        talias.alias_create([1.0, 2.0])
    assert tconfig.resolve_device("cpu").type == "cpu"
    # the block samplers: the default streams never reach them without a
    # card, and CPU streams (asked for) run the plain version, no launch
    cpu = tbits.initialize(1, torch.arange(2), device="cpu")
    for block in (tbk.exponential_block, tbk.normal_block,
                  tbk.exponential_block_zig):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            block(tbits.initialize(1, torch.arange(2)), 4)
        before = block.launches
        st, x = block(cpu, 4)
        assert x.device.type == st.ctr_lo.device.type == "cpu"
        assert block.launches == before
