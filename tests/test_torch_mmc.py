"""The M/M/c model and queue-length recording: the port against
cimba_tpu and the sequential C++ oracle.

Same spec, seed and parameters through ``jax.jit(jax.vmap(make_run))``
and the port's ``make_run`` on the CPU (8 lanes, 100 objects, both
profiles), leaf for leaf with ``interop.diff_leaves``, the queue's
length accumulator ``queues.acc`` included: every integer and bool leaf
(n_events, pcs, pend seqs, wake seqs, queue sizes, RNG counters, ...)
equal, so the event order is the reference's; floats within 1e-9 of each
leaf's scale in f64 (the samplers' log1p, test_torch_random.py) and 2e-5
in f32 (XLA fuses some multiply-adds). The M/M/c run is also held
against ``cimba_tpu.native.oracle_mmc`` as tests/test_native.py holds
the reference: event counts exact, clock within 1e-9, mean sojourn
within 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu import native
from cimba_tpu.core import loop as jloop
from cimba_tpu.models import mm1 as jmm1
from cimba_tpu.models import mmc as jmmc
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.models import mm1 as tmm1
from cimba_tpu_torch.models import mmc as tmmc

RTOL = {"f64": 1e-9, "f32": 2e-5}
MODELS = {
    "mm1_record": (lambda m: m.build(), lambda m, n: m.params(n)),
    "mmc3": (lambda m: m.build(3), lambda m, n: m.params(n, 2.5, 1.0)),
    "mmc2": (lambda m: m.build(2), lambda m, n: m.params(n, 1.7, 1.0)),
    "mmc4": (lambda m: m.build(4), lambda m, n: m.params(n, 0.83 * 4, 1.0)),
}


def _ref_run(prof, name, lanes, n, max_steps=None, seed=2026):
    build, params = MODELS[name]
    mod = jmm1 if name.startswith("mm1") else jmmc
    with jconfig.profile(prof):
        spec, _ = build(mod)
        p = params(mod, n)
        js = jax.jit(jax.vmap(lambda r: jloop.init_sim(spec, seed, r, p)))(
            jnp.arange(lanes))
        out = jax.jit(jax.vmap(jloop.make_run(spec, max_steps=max_steps)))(js)
    return js, out


def _port(prof, name, n):
    build, params = MODELS[name]
    mod = tmm1 if name.startswith("mm1") else tmmc
    with tconfig.profile(prof):
        return build(mod)[0], params(mod, n)


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("name", ["mmc2", "mmc3", "mmc4"])
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


def test_mmc_matches_native_oracle():
    """c=3 and the degenerate c=1 (which equals the M/M/1 oracle)."""
    n, reps = 120, 3
    for c, rate in ((3, 2.5), (1, 0.9)):
        with tconfig.profile("f64"):
            spec, _ = tmmc.build(c)
            s = tloop.init_sim(spec, 1234, torch.arange(reps),
                               tmmc.params(n, rate, 1.0), device="cpu")
            out = tloop.make_run(spec)(s)
        for rep in range(reps):
            ora = native.oracle_mmc(1234, rep, n, 1.0 / rate, 1.0, c)
            assert int(out.n_events[rep]) == ora["events"]
            assert float(out.user["wait"].n[rep]) == n == ora["n"]
            np.testing.assert_allclose(float(out.clock[rep]), ora["clock"],
                                       rtol=1e-9)
            np.testing.assert_allclose(float(out.user["wait"].m1[rep]),
                                       ora["mean"], rtol=1e-8)
            if c == 1:
                assert ora == native.oracle_mm1(1234, rep, n, 1.0 / rate, 1.0)


def test_erlang_c_matches_reference():
    for c, lam in ((1, 0.9), (2, 1.7), (3, 2.5), (4, 3.5)):
        assert tmmc.erlang_c_sojourn(c, lam, 1.0) == jmmc.erlang_c_sojourn(
            c, lam, 1.0)
    assert abs(tmmc.erlang_c_sojourn(3, 2.5, 1.0) - 2.404) < 5e-4
    with pytest.raises(ValueError):
        tmmc.erlang_c_sojourn(2, 2.5, 1.0)
