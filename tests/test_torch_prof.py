"""Run profiling in the port (``cimba_tpu_torch.obs.prof``): the
``RunReport`` of ``run_experiment(..., with_report=True)`` and
``profiled_call``'s legs, on the CPU (the card's split — the kernel's
build, the library's nvcc build or load, the run — and its memory
statistics are held by ``chip_smoke.py``).
"""

import json
import time

import pytest
import torch

from cimba_tpu_torch import tree
from cimba_tpu_torch.models import mm1
from cimba_tpu_torch.obs import metrics as om
from cimba_tpu_torch.obs import prof
from cimba_tpu_torch.runner import experiment as ex

torch.set_num_threads(1)


def test_report_on_the_plain_engine(tmp_path):
    spec = mm1.build(record=False)[0]
    plain = ex.run_experiment(spec, mm1.params(10), 4, seed=3, device="cpu")
    res, rep = ex.run_experiment(spec, mm1.params(10), 4, seed=3,
                                 device="cpu", with_report=True,
                                 profile_dir=str(tmp_path))
    for a, b in zip(tree.leaves(plain.sims), tree.leaves(res.sims)):
        assert torch.equal(a, b)
    assert rep.backend == "cpu" and rep.device_memory is None
    assert rep.metrics is None  # the registry is off
    assert (rep.n_replications, rep.n_failed) == (4, 0)
    assert rep.total_events == int(res.total_events) > 0
    assert rep.execute_s > 0 and rep.events_per_sec > 0
    assert rep.trace_lower_s >= 0 and rep.compile_s >= 0
    assert rep.to_dict()["profile_dir"] == str(tmp_path)
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert doc["traceEvents"]


def test_report_carries_the_metrics_snapshot():
    om.enable()
    try:
        spec = mm1.build(record=False)[0]
        res, rep = ex.run_experiment(spec, mm1.params(10), 4, seed=3,
                                     device="cpu", with_report=True)
    finally:
        om.disable()
    assert rep.metrics["events_dispatched"] == int(res.total_events)
    assert set(rep.metrics) >= {"dispatch_by_kind", "queue_hwm",
                                "chain_hist", "guard_retries"}


def test_profiled_call_legs():
    order = []

    def build():
        order.append("build")
        time.sleep(0.02)

    def load():
        order.append("load")

    out, t = prof.profiled_call(lambda x: order.append("run") or x + 1, 1,
                                build=build, load=load, device="cpu")
    assert out == 2 and order == ["build", "load", "run"]
    assert t["trace_lower_s"] >= 0.02 and t["compile_s"] >= 0
    assert t["execute_s"] >= 0
    with prof.trace_ctx(None):
        pass
    rep = prof.build_report(t, n_replications=1, n_failed=0,
                            total_events=10, device="cpu")
    assert rep.backend == "cpu" and rep.events_per_sec > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a card")
def test_no_card_no_fallback():
    spec = mm1.build(record=False)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.run_experiment(spec, mm1.params(10), 4, with_report=True)
    assert prof.device_memory_stats() is None
