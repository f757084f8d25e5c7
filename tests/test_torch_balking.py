"""The cookbook's balking M/M/1: the port's restatement against cimba_tpu.

``cimba_tpu_torch.examples.cookbook_balking`` and the reference's
``examples/cookbook_balking.py`` through ``jax.jit(jax.vmap(make_run))``
and the port's plain engine on the CPU (8 lanes, 60 customers, seed 7),
leaf for leaf with ``interop.diff_leaves``: every integer and bool leaf
equal (so the event order is the reference's), floats within 1e-9 of
each leaf's scale in f64 and 2e-5 in f32 (XLA fuses some multiply-adds,
as in the job shop's tests).  One compiled reference chunk of K events
serves the truncated run and, called until no lane is live, the whole
run.  Here also the gates of the cookbook's own ``main`` on
``run_experiment(..., device="cpu")``.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import loop as jloop
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.examples import cookbook_balking as tcb
from cimba_tpu_torch.runner import experiment
from cimba_tpu_torch.stats import summary as sm
from examples import cookbook_balking as jcb

torch.set_num_threads(1)

K = 61
RTOL = {"f64": 1e-9, "f32": 2e-5}
LANES, N, SEED = 8, 60, 7


@functools.lru_cache(maxsize=None)
def ref_run(prof):
    with jconfig.profile(prof):
        spec, _ = jcb.build()
        params = (1 / 0.9, 1.0, 8.0, N)
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(
            spec, SEED, r, params)))(jnp.arange(LANES))
        chunk = jax.jit(jax.vmap(jloop.make_run(spec, max_steps=K)))
        cond = jax.jit(jax.vmap(jloop.make_cond(spec)))
        first = out = chunk(js)
        while bool(cond(out).any()):
            out = chunk(out)
    return js, first, out


def port_run(prof, max_steps=None):
    with tconfig.profile(prof):
        spec, _ = tcb.build()
        ts = tloop.init_sim(spec, SEED, torch.arange(LANES), tcb.params(N),
                            device="cpu")
        return ts, tloop.make_run(spec, max_steps=max_steps)(ts)


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_matches_reference(prof):
    js, _, jout = ref_run(prof)
    ts, tout = port_run(prof)
    assert interop.diff_leaves(jax.tree.leaves(js), interop.sim_to_numpy(ts),
                               0.0) == []
    assert [x.dtype for x in jax.tree.leaves(js)] == [
        x.dtype for x in interop.sim_to_numpy(ts)]
    assert interop.diff_leaves(jax.tree.leaves(jout),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []
    u = tout.user
    assert int(tout.err.abs().sum()) == 0
    assert torch.equal(u["wait"].n.to(torch.int64) + u["balked"]
                       + u["reneged"], torch.full((LANES,), N))


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_truncated_run_matches_reference(prof):
    _, jfirst, _ = ref_run(prof)
    _, tout = port_run(prof, max_steps=K)
    assert interop.diff_leaves(jax.tree.leaves(jfirst),
                               interop.sim_to_numpy(tout), RTOL[prof]) == []


def test_run_experiment_on_cpu_keeps_the_books():
    """The cookbook's gates: no failed lane, every customer served,
    balked or reneged, a mean sojourn in (0, 8), some balking."""
    spec, q = tcb.build()
    res = experiment.run_experiment(spec, tcb.params(40), 6, seed=SEED,
                                    device="cpu")
    assert int(res.n_failed) == 0 and res.launches == 0
    u = res.sims.user
    pooled = experiment.pooled_summary(tcb.summary_path(res.sims))
    assert float(pooled.n) + int(u["balked"].sum()) + int(
        u["reneged"].sum()) == 6 * 40
    assert 0.0 < float(sm.mean(pooled)) < 8.0
    assert int(u["balked"].sum()) > 0
