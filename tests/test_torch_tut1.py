"""Tutorial 1 restated (``cimba_tpu_torch.examples.tut_1_mm1``) against
``examples/tut_1_mm1.py``.

The model in both packages, 6 replications to t=150, f64: the port's
``run_experiment(device="cpu")`` against the reference's
``jax.jit(jax.vmap(make_run))``: the same events a lane, the buffer's
time-average length within 1e-9 relative a lane (the port's log1p is
not XLA's to the last place).  ``main`` passes its statistical gate on
the CPU and, with ``CIMBA_TRACE`` set, runs the traced pass, whose
Chrome trace validates; without a card its default device raises.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu.core import loop as jloop
from cimba_tpu.stats import summary as jsm
from cimba_tpu.stats import timeseries as jts
from cimba_tpu_torch import tree
from cimba_tpu_torch.examples import tut_1_mm1
from cimba_tpu_torch.runner import experiment as ex
from cimba_tpu_torch.stats import summary as sm
from cimba_tpu_torch.stats import timeseries as ts
from examples import tut_1_mm1 as jtut1

torch.set_num_threads(1)

R, T_END = 6, 150.0


@functools.lru_cache(maxsize=None)
def ref_run():
    spec, queue = jtut1.build()
    run = jloop.make_run(spec, t_end=T_END)

    def one(rep):
        out = run(jloop.init_sim(spec, tut_1_mm1.SEED, rep))
        acc = jax.tree.map(lambda x: x[queue.id], out.buffers.acc)
        return jsm.mean(jts.step_finalize(acc, out.clock)), out.n_events

    lq, n = jax.jit(jax.vmap(one))(jnp.arange(R))
    return np.asarray(lq), np.asarray(n)


def test_queue_length_equals_reference():
    want_lq, want_n = ref_run()
    spec, queue = tut_1_mm1.build()
    res = ex.run_experiment(spec, None, R, seed=tut_1_mm1.SEED, t_end=T_END,
                            device="cpu")
    out = res.sims
    acc = tree.map(lambda x: x[:, queue.id], out.buffers.acc)
    lq = sm.mean(ts.step_finalize(acc, out.clock)).numpy()
    assert np.array_equal(out.n_events.numpy(), want_n)
    np.testing.assert_allclose(lq, want_lq, rtol=1e-9, atol=0)
    assert int(res.n_failed) == 0


def test_main_and_traced_pass(monkeypatch, tmp_path, capsys):
    path = tmp_path / "trace.json"
    monkeypatch.setenv("CIMBA_TRACE", "1")
    monkeypatch.setenv("CIMBA_TRACE_OUT", str(path))
    mean, half = tut_1_mm1.main(R=8, t_end=200.0, device="cpu")
    assert mean > 0 and half > 0
    doc = json.loads(path.read_text())
    assert doc["otherData"]["model"] == "tut1"
    assert doc["otherData"]["metrics"]["events_dispatched"] == doc[
        "otherData"]["recorded_events"]
    out = capsys.readouterr().out
    assert "flight recorder" in out and "M/M/1 theory" in out


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a card")
def test_default_device_needs_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tut_1_mm1.main(R=2, t_end=10.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tut_1_mm1.traced_run()
