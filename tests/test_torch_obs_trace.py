"""The flight recorder (``cimba_tpu_torch.obs.trace``) and the Chrome-trace
export (``obs.export``) against the reference's.

Tutorial 1's M/M/1 (``examples/tut_1_mm1.py``'s model in both packages),
2 lanes, seed 2026, to t=40, f64, with the recorder and the registry on:
the port's plain engine against ``jax.jit(jax.vmap(make_run))``, ring
leaf for leaf, with a capacity that wraps (16; each lane dispatches
~70 events) and one that does not (512).  The ring's integer fields and
count must be equal; its times within 1e-9 relative (the port's log1p
is not XLA's to the last place).  The Chrome-trace documents must be
equal but for ``ts`` (the times x 1e6, within the same tolerance).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu.core import loop as jloop
from cimba_tpu.obs import export as jexport
from cimba_tpu.obs import metrics as jmetrics
from cimba_tpu.obs import trace as jtrace
from cimba_tpu_torch.core import kernel_run, loop
from cimba_tpu_torch.examples import tut_1_mm1
from cimba_tpu_torch.obs import export, trace
from cimba_tpu_torch.obs import metrics as om
from cimba_tpu_torch.runner import experiment as ex
from cimba_tpu_torch.utils import debug
from examples import tut_1_mm1 as jtut1

torch.set_num_threads(1)

SEED, T_END, LANES = 2026, 40.0, 2


@pytest.fixture
def obs_off():
    yield
    for mod in (trace, om, jtrace, jmetrics):
        mod.disable()


@functools.lru_cache(maxsize=None)
def ref_run(cap):
    jtrace.enable(cap)
    jmetrics.enable()
    try:
        spec, _ = jtut1.build()
        run = jloop.make_run(spec, t_end=T_END)
        sims = jax.jit(jax.vmap(
            lambda r: run(jloop.init_sim(spec, SEED, r))))(jnp.arange(LANES))
        doc = jexport.chrome_trace(sims, spec)
        jexport.validate_chrome_trace(doc)
        ring = {f: np.asarray(getattr(sims.trace, f))
                for f in sims.trace._fields}
        reg = {f: np.asarray(getattr(sims.metrics, f))
               for f in sims.metrics._fields}
        return ring, reg, doc, np.asarray(sims.n_events)
    finally:
        jtrace.disable()
        jmetrics.disable()


def port_run(cap):
    trace.enable(cap)
    om.enable()
    try:
        spec, _ = tut_1_mm1.build()
        sims = loop.make_run(spec, t_end=T_END)(loop.init_sim(
            spec, SEED, torch.arange(LANES), device="cpu"))
    finally:
        trace.disable()
        om.disable()
    return spec, sims


def same_doc(a, b):
    assert a.keys() == b.keys()
    assert a["otherData"] == b["otherData"]
    assert len(a["traceEvents"]) == len(b["traceEvents"])
    for x, y in zip(a["traceEvents"], b["traceEvents"]):
        assert {k: v for k, v in x.items() if k != "ts"} == {
            k: v for k, v in y.items() if k != "ts"}
        if "ts" in y:
            assert np.isclose(x["ts"], y["ts"], rtol=1e-9, atol=0)


@pytest.mark.parametrize("cap", [16, 512])
def test_ring_equals_reference(obs_off, cap):
    want, _, want_doc, n_events = ref_run(cap)
    spec, sims = port_run(cap)
    ring = sims.trace
    assert ring.t.shape == (LANES, cap)
    for f in ("pid", "kind", "arg", "seq", "count"):
        got = getattr(ring, f).numpy()
        assert got.dtype == want[f].dtype and np.array_equal(got, want[f]), f
    assert ring.t.dtype == torch.float64
    np.testing.assert_allclose(ring.t.numpy(), want["t"], rtol=1e-9, atol=0)
    assert np.array_equal(sims.n_events.numpy(), n_events)
    wraps = bool((ring.count > cap).all())
    assert wraps == (cap == 16)
    # unwrap: the last min(count, cap) dispatches, in dispatch order
    r = trace.unwrap(debug.lane(sims, 1).trace)
    k = min(int(ring.count[1]), cap)
    assert r["seq"].tolist() == list(range(int(ring.count[1]) - k,
                                           int(ring.count[1])))
    assert (r["count"], r["capacity"]) == (int(ring.count[1]), cap)
    assert np.all(np.diff(r["t"]) >= 0)
    doc = export.chrome_trace(sims, spec)
    export.validate_chrome_trace(doc)
    same_doc(doc, want_doc)


def test_dump_and_validate(obs_off, tmp_path):
    sims, spec, doc = tut_1_mm1.traced_run(device="cpu",
                                           out_path=str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").exists()
    assert doc["otherData"]["recorded_events"] == int(sims.n_events.sum())
    bad = dict(doc, traceEvents=[e for e in doc["traceEvents"]
                                 if e["ph"] == "M"])
    with pytest.raises(ValueError, match="no events"):
        export.validate_chrome_trace(bad)
    with pytest.raises(ValueError, match="top-level"):
        export.validate_chrome_trace({"traceEvents": []})
    # a service's request-lifecycle trace (the serve layer): an
    # idle service's trace validates and carries its stats
    from cimba_tpu_torch import serve

    with serve.Service(device="cpu") as svc:
        sdoc = export.dump_service_trace(str(tmp_path / "s.json"), svc)
    assert (tmp_path / "s.json").exists()
    assert sdoc["otherData"]["service"]["submitted"] == 0


def test_disabled_recorder_carries_nothing(obs_off):
    spec, _ = tut_1_mm1.build()
    s = loop.init_sim(spec, 1, torch.arange(2), device="cpu")
    assert s.trace is None and s.metrics is None
    assert trace.emit(s, s.clock, s.rep, s.rep, s.rep,
                      torch.ones(2, dtype=torch.bool)) is s
    with pytest.raises(ValueError, match="no flight-recorder ring"):
        export.chrome_trace(s, spec)


def test_kernel_path_refuses_the_ring(obs_off):
    """The CUDA chunk kernel takes no ring: its build raises (checked
    before any card is needed), and so do the runners on the card."""
    trace.enable(8)
    spec, _ = tut_1_mm1.build()
    s = loop.init_sim(spec, 1, torch.arange(2), device="cpu")
    with pytest.raises(RuntimeError, match="flight-recorder"):
        kernel_run.kernel_for(spec, s)
    with pytest.raises(RuntimeError, match="flight-recorder"):
        kernel_run.generated_kernel_for(spec, s)
    for route in ("run_experiment", "run_experiment_stream"):
        with pytest.raises(RuntimeError, match=f"{route} on the card"):
            ex._refuse_observed(torch.device("cuda"), route)
    ex._refuse_observed(torch.device("cpu"), "run_experiment")
