"""The port's host-side telemetry plane against the reference's contracts.

The reference's nine tests outside ``slow`` (``tests/test_telemetry.py``)
restated against ``cimba_tpu_torch`` on the CPU:

* **registry**: counters, gauges and log2-bucket histograms with labels
  render to Prometheus text that round-trips through the package's
  parser; the log2 edges land on powers of two; the history ring is
  bounded;
* **atomic snapshots**: ``AdmissionQueue.snapshot()`` is one lock's view;
* **exposition**: ``/metrics`` parses and carries the request counters,
  ``/healthz`` is 200 on a live service, ``/varz`` is JSON, over real
  HTTP on an ephemeral port, and ``tools/metrics_dump.py`` reads it;
* **span lifecycle**: each request (completed, cancelled, expired,
  retries exhausted; several waves; rejected) closes exactly one span
  tree, and ``chrome_trace()`` with spans passes the validator;
* **disabled == zero overhead**: ``telemetry=None`` starts no thread and
  allocates no span state, and results are bitwise the same with a plane
  attached; the stream and the sweep tick their counters.

Then parity with the reference's module: the same registry operations
render the same Prometheus text in both packages and parse the same;
the port's own runners (the chunked runner's ticks, the run card's
``telemetry`` block); ``/healthz`` answers 503 for a dead dispatcher;
and ``metrics_dump --demo`` on the CPU.  Torch runs on one thread.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from cimba_tpu.obs import expose as jxp
from cimba_tpu.obs import telemetry as jtm
from cimba_tpu_torch import serve, sweep, tree
from cimba_tpu_torch.core import api
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.obs import expose as xp
from cimba_tpu_torch.obs import telemetry as tm
from cimba_tpu_torch.runner import experiment as ex
from cimba_tpu_torch.serve import cache as pc
from cimba_tpu_torch.serve.sched import AdmissionQueue
from cimba_tpu_torch.stats import summary as sm
from cimba_tpu_torch.tools import metrics_dump, usergen

torch.set_num_threads(1)


def _tiny_spec(t_stop=12.0):
    """One process holding unit steps until its clock passes t_stop."""
    m = Model("tinytel", event_cap=1, guard_cap=2)

    @m.block
    def work(sim, p, sig):
        done = api.clock(sim) > t_stop
        return sim, cmd.select(done, cmd.exit_(),
                               cmd.hold(1.0, next_pc=work.pc))

    m.process("w", entry=work)
    return m.build()


def _clock_path(sims):
    """Module-level summary path (the fold key pins its identity)."""
    return sm.add(sm.empty(sims.clock.shape, sims.clock.device),
                  sims.clock)


@pytest.fixture(scope="module")
def tiny():
    return _tiny_spec()


@pytest.fixture(scope="module")
def shared_cache():
    return pc.ProgramCache(capacity=256)


def _req(spec, R=4, *, seed=1, **kw):
    return serve.Request(spec, (), R, seed=seed, chunk_steps=16,
                         summary_path=_clock_path, **kw)


def _wait(pred, timeout=30.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("condition not reached in time")
        time.sleep(0.005)


def _service(**kw):
    return serve.Service(device="cpu", **kw)


class _Gated(serve.Service):
    """Dispatch waits until the test opens the gate (queue states are
    built, not raced)."""

    def __init__(self, **kw):
        self.gate = threading.Event()
        super().__init__(device="cpu", **kw)

    def _run_batch(self, slots, fused=None):
        assert self.gate.wait(60), "test gate never opened"
        return super()._run_batch(slots, fused=fused)


def _bitwise(a, b):
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


# --- registry and the Prometheus round trip ---------------------------------


def test_registry_counter_gauge_histogram_roundtrip():
    reg = tm.Registry(history=8)
    c = reg.counter("cimba_test_ops_total", "ops", labels=("kind",))
    c.labels(kind="a").inc()
    c.labels(kind="a").inc(2)
    c.labels(kind="b").inc(5)
    g = reg.gauge("cimba_test_depth", "depth")
    g.set(3.5)
    h = reg.histogram("cimba_test_lat_seconds", "lat", labels=("o",))
    for v in (0.001, 0.5, 0.5, 3.0):
        h.labels(o="ok").observe(v)
    assert reg.counter("cimba_test_ops_total", labels=("kind",)) is c
    with pytest.raises(ValueError):
        reg.gauge("cimba_test_ops_total")
    with pytest.raises(ValueError):
        c.labels(kind="a").inc(-1)
    c.labels(kind="b").set_total(4)  # below the current 5: ignored
    assert c.get(kind="b") == 5.0
    c.labels(kind="b").set_total(9)
    assert c.get(kind="b") == 9.0
    parsed = xp.parse_prometheus_text(xp.render_prometheus(reg))
    assert parsed["types"]["cimba_test_ops_total"] == "counter"
    assert parsed["types"]["cimba_test_lat_seconds"] == "histogram"
    s = parsed["samples"]
    assert s["cimba_test_ops_total"][(("kind", "a"),)] == 3.0
    assert s["cimba_test_depth"][()] == 3.5
    assert s["cimba_test_lat_seconds_bucket"][
        (("le", "+Inf"), ("o", "ok"))] == 4.0
    assert s["cimba_test_lat_seconds_count"][(("o", "ok"),)] == 4.0
    assert s["cimba_test_lat_seconds_sum"][(("o", "ok"),)] == \
        pytest.approx(4.001)
    # label escaping, the adversarial cases too
    g2 = reg.gauge("cimba_test_esc", "esc", labels=("path",))
    values = ('a"b\\c\nd', "trail\\", "x\\n,y", "srv\\1")
    for v in values:
        g2.labels(path=v).set(1)
    parsed2 = xp.parse_prometheus_text(xp.render_prometheus(reg))
    for v in values:
        assert parsed2["samples"]["cimba_test_esc"][(("path", v),)] == 1.0


def test_histogram_log2_bucket_edges():
    reg = tm.Registry()
    h = reg.histogram("cimba_test_h", "h")
    for v in (1.0, 1.0001, 0.75, 4.0, 0.0, float("inf")):
        h.observe(v)
    s = reg.collect()[-1]["series"][0]
    assert s["buckets"][0] == 2          # le=2^0: 1.0 and 0.75
    assert s["buckets"][1] == 1          # le=2^1: 1.0001
    assert s["buckets"][2] == 1          # le=2^2: 4.0
    assert s["buckets"][tm._EXP_MIN] == 1
    assert s["buckets"][tm._EXP_MAX] == 1
    assert s["count"] == 6
    buckets = xp.parse_prometheus_text(
        xp.render_prometheus(reg))["samples"]["cimba_test_h_bucket"]
    vals = [v for _, v in sorted(
        buckets.items(),
        key=lambda kv: float(dict(kv[0])["le"].replace("+Inf", "inf")))]
    assert vals == sorted(vals) and vals[-1] == 6.0


def test_ring_history_bounded_and_sampled():
    reg = tm.Registry(history=4)
    g = reg.gauge("cimba_test_g", "g")
    for i in range(10):
        g.set(i)
        reg.tick_history(t=float(i))
    hist = reg.collect()[0]["series"][0]["history"]
    assert [v for _, v in hist] == [6.0, 7.0, 8.0, 9.0]
    assert [t for t, _ in hist] == [6.0, 7.0, 8.0, 9.0]


def test_admission_queue_snapshot_is_one_lock_view():
    class E:
        def __init__(self, seq, prio, cls):
            self.seq, self.priority, self.cls = seq, prio, cls
            self.label = f"e{seq}"

    q = AdmissionQueue(capacity=8)
    for i, cls in enumerate(["a", "a", "b", None]):
        q.put(E(i, 0, cls))
    q.requeue(E(9, 0, "b"), delay=30.0)     # delayed entries count too
    snap = q.snapshot()
    assert snap["depth"] == 5 == sum(snap["by_class"].values())
    assert snap["by_class"] == {"a": 2, "b": 2, None: 1}
    assert snap["capacity"] == 8
    assert snap["depth_hwm"] >= snap["depth"]


def _registry_ops(mod):
    """One fixed sequence of registry operations through ``mod``'s
    Registry (the reference's or the port's)."""
    reg = mod.Registry(history=4)
    c = reg.counter("cimba_p_total", "ops done", labels=("kind", "svc"))
    c.labels(kind="a", svc="x").inc(3)
    c.labels(kind="b", svc="x").set_total(7)
    g = reg.gauge("cimba_p_depth", "queue depth", labels=("svc",))
    g.labels(svc="x").set(2.5)
    g.labels(svc='y"\\').set(-1)
    h = reg.histogram("cimba_p_lat_seconds", "latency", labels=("o",))
    for v in (0.002, 0.25, 0.5, 1.5, 3e-12, 7e12):
        h.labels(o="ok").observe(v)
    reg.gauge("cimba_p_plain", "no labels").set(1e-3)
    reg.tick_history(t=1.0)
    return reg


def test_prometheus_text_matches_reference():
    """The same registry operations give the reference's Prometheus text
    byte for byte, and both parsers read it alike."""
    text = xp.render_prometheus(_registry_ops(tm))
    ref = jxp.render_prometheus(_registry_ops(jtm))
    assert text == ref
    assert xp.parse_prometheus_text(text) == \
        jxp.parse_prometheus_text(ref)
    assert tm.METRIC_PREFIX == jtm.METRIC_PREFIX
    info = tm.build_info()
    assert "jax" not in info and info["torch"] == torch.__version__


# --- exposition over a live service, and the operator CLI -------------------


def test_exposition_endpoints_and_metrics_dump(tiny, shared_cache, tmp_path,
                                               capsys):
    tel = tm.Telemetry(interval=0.05, spans=True,
                       span_path=tmp_path / "spans.jsonl")
    with xp.start(tel) as srv:
        with _service(max_wave=16, cache=shared_cache,
                      telemetry=tel) as svc:
            results = [svc.submit(_req(tiny, seed=i + 1, label=f"r{i}"))
                       .result(60) for i in range(3)]
            tel.sample()
            met = urllib.request.urlopen(srv.url + "/metrics",
                                         timeout=10).read().decode()
            hz = urllib.request.urlopen(srv.url + "/healthz", timeout=10)
            assert hz.status == 200
            health = json.loads(hz.read())
            varz = json.loads(urllib.request.urlopen(
                srv.url + "/varz", timeout=10).read())
            assert metrics_dump.main(["--url", srv.url]) == 0
            out = capsys.readouterr().out
            assert "cimba_serve_requests_completed_total" in out
            assert "HEALTH: ok" in out
            # two urls: the fleet table, one row a url
            assert metrics_dump.main(["--url", srv.url,
                                      "--url", srv.url]) == 0
            assert "fleet: 2 slice(s)" in capsys.readouterr().out
    tel.close()
    parsed = xp.parse_prometheus_text(met)
    key = (("service", "cimba-serve"),)
    s = parsed["samples"]
    assert s["cimba_serve_requests_completed_total"][key] == 3.0
    assert s["cimba_serve_requests_submitted_total"][key] == 3.0
    assert s["cimba_serve_queue_depth"][key] == 0.0
    assert parsed["types"]["cimba_serve_request_latency_seconds"] == \
        "histogram"
    assert s["cimba_serve_request_latency_seconds_count"][
        (("outcome", "completed"), ("service", "cimba-serve"))] == 3.0
    assert health["status"] == "ok"
    assert health["services"]["cimba-serve"]["dispatcher_alive"]
    assert varz["spans"]["open"] == 0
    assert "jax" not in varz["build"]
    # shutdown detached the service; its last values stay
    assert tel.healthz()["services"] == {}
    assert tel.registry.get_sample("cimba_serve_requests_completed_total",
                                   service="cimba-serve") == 3.0
    direct = ex.run_experiment_stream(
        tiny, (), 4, wave_size=4, chunk_steps=16, seed=1,
        summary_path=_clock_path, program_cache=shared_cache, device="cpu")
    _bitwise(results[0].summary, direct.summary)


# --- span lifecycle ----------------------------------------------------------


class _GatedPoison(_Gated):
    def _run_batch(self, slots, fused=None):
        if slots[0][0].label == "poison":
            raise RuntimeError("injected dispatch failure")
        return super()._run_batch(slots, fused=fused)


def test_span_lifecycle_all_four_outcomes(tiny, shared_cache, tmp_path):
    from cimba_tpu_torch.obs import export as oe

    span_path = tmp_path / "lifecycle.jsonl"
    tel = tm.Telemetry(interval=0, spans=True, span_path=span_path)
    svc = _GatedPoison(max_wave=8, cache=shared_cache, telemetry=tel,
                       max_retries=0,
                       backoff=serve.Backoff(base=0.01, cap=0.01))
    try:
        lead = svc.submit(_req(tiny, label="lead"))
        _wait(lambda: svc.stats()["batches"] == 1)
        h_cancel = svc.submit(_req(tiny, seed=2, label="victim"))
        h_dead = svc.submit(_req(tiny, seed=3, label="late", deadline=0.01))
        h_poison = svc.submit(_req(tiny, seed=4, label="poison"))
        assert h_cancel.cancel()
        time.sleep(0.05)
        svc.gate.set()
        assert lead.result(60) is not None
        with pytest.raises(serve.Cancelled):
            h_cancel.result(60)
        with pytest.raises(serve.DeadlineExceeded):
            h_dead.result(60)
        with pytest.raises(serve.RetriesExhausted):
            h_poison.result(60)
        doc = svc.chrome_trace()
        oe.validate_chrome_trace(doc)
    finally:
        svc.gate.set()
        svc.shutdown(timeout=60)
        tel.close()
    by_trace: dict = {}
    for line in open(span_path):
        r = json.loads(line)
        by_trace.setdefault(r["trace"], []).append(r)
    assert len(by_trace) == 4
    outcomes = {}
    for trace, recs in by_trace.items():
        spans = [r for r in recs if r.get("ph") != "i"]
        roots = [r for r in spans if r["parent"] is None]
        assert len(roots) == 1 and roots[0]["name"] == "request"
        sids = {r["span"] for r in spans}
        for r in recs:
            assert r["parent"] is None or r["parent"] in sids, r
        assert all(r["dur"] >= 0.0 for r in spans)
        outcomes[roots[0]["label"]] = roots[0]["outcome"]
    assert outcomes == {"lead": "completed", "victim": "cancelled",
                        "late": "deadline_exceeded", "poison": "failed"}
    assert tel.spans.open_count() == 0
    assert tel.spans.counters["spans_started"] == \
        tel.spans.counters["spans_ended"]
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"queue", "wave", "fold", "deliver"} <= names
    for outcome in ("completed", "cancelled", "deadline_exceeded",
                    "failed"):
        assert tel.registry.get_sample(
            "cimba_serve_request_latency_seconds", service="cimba-serve",
            outcome=outcome) == 1.0


def test_multiwave_and_rejected_spans_close(tiny, shared_cache):
    tel = tm.Telemetry(interval=0, spans=True)
    with _service(max_wave=4, max_pending=1, cache=shared_cache,
                  telemetry=tel) as svc:
        assert svc.submit(_req(tiny, R=12, wave_size=4,
                               label="multi")).result(60) is not None
        _wait(lambda: tel.spans.open_count() == 0)
    gated = _Gated(max_wave=4, max_pending=1, cache=shared_cache,
                   telemetry=tel)
    try:
        lead = gated.submit(_req(tiny, label="glead"))
        _wait(lambda: gated.stats()["batches"] == 1)
        filler = gated.submit(_req(tiny, seed=2, label="filler"))
        with pytest.raises(serve.QueueFull):
            gated.submit(_req(tiny, seed=3, label="tooslow"), block=False)
        gated.gate.set()
        assert lead.result(60) is not None
        assert filler.result(60) is not None
    finally:
        gated.gate.set()
        gated.shutdown(timeout=60)
    recs = list(tel.spans.completed)
    multi = [r for r in recs if r["parent"] is None
             and r.get("attrs", {}).get("label") == "multi"]
    assert len(multi) == 1 and multi[0]["outcome"] == "completed"
    mt = multi[0]["trace"]
    assert len([r for r in recs if r["name"] == "wave"
                and r["trace"] == mt]) == 3
    assert len([r for r in recs if r["name"] == "queue"
                and r["trace"] == mt]) == 3
    rejected = [r for r in recs if r.get("outcome") == "rejected"]
    assert len(rejected) == 1
    assert rejected[0]["attrs"]["label"] == "tooslow"
    assert tel.spans.open_count() == 0
    tel.close()


def test_refill_spans_and_trace_context(tiny, shared_cache):
    """A refill service's requests close their trees too (wave spans at
    birth and at a splice's admission), and a request's
    ``trace_context`` grafts its tree under the remote parent."""
    tel = tm.Telemetry(interval=0, spans=True)
    with _service(max_wave=8, cache=shared_cache, telemetry=tel,
                  refill=True, refill_every=1) as svc:
        hs = [svc.submit(_req(tiny, R=4, seed=i + 1, label=f"f{i}"))
              for i in range(4)]
        ctx = svc.submit(_req(tiny, seed=9, label="grafted",
                              trace_context={"id": "abc123",
                                             "parent": "remote-7"}))
        for h in hs + [ctx]:
            assert h.result(60) is not None
        _wait(lambda: tel.spans.open_count() == 0)
    recs = list(tel.spans.completed)
    root = [r for r in recs if r["name"] == "request"
            and r.get("attrs", {}).get("label") == "grafted"]
    assert len(root) == 1
    assert root[0]["trace"] == "abc123"
    assert root[0]["parent"] == "remote-7"
    assert tel.spans.counters["traces_adopted"] == 1
    assert tel.spans.counters["spans_started"] == \
        tel.spans.counters["spans_ended"]
    tel.close()


# --- disabled == zero overhead, and the runners' ticks ----------------------


def test_disabled_is_zero_overhead_and_bitwise(tiny, shared_cache):
    plane = ("cimba-telemetry", "cimba-exposition")
    before = {t.name for t in threading.enumerate() if t.name in plane}
    with _service(max_wave=8, cache=shared_cache) as svc:
        h = svc.submit(_req(tiny, label="plain"))
        res_off = h.result(60)
        assert h._entry.trace is None and h._entry.span_root is None
    assert {t.name for t in threading.enumerate()
            if t.name in plane} == before
    kw = dict(wave_size=4, chunk_steps=16, seed=7, summary_path=_clock_path,
              program_cache=shared_cache, device="cpu")
    st_off = ex.run_experiment_stream(tiny, (), 8, **kw)
    tel = tm.Telemetry(interval=0.01, spans=True)
    tel.start()
    st_on = ex.run_experiment_stream(tiny, (), 8, telemetry=tel, **kw)
    with _service(max_wave=8, cache=shared_cache, telemetry=tel) as svc:
        res_on = svc.submit(_req(tiny, label="plain")).result(60)
    tel.close()
    _bitwise((st_off.summary, st_off.n_failed, st_off.total_events),
             (st_on.summary, st_on.n_failed, st_on.total_events))
    _bitwise((res_off.summary, res_off.total_events),
             (res_on.summary, res_on.total_events))
    misses = shared_cache.stats()["misses"]
    ex.run_experiment_stream(tiny, (), 8,
                             telemetry=tm.Telemetry(interval=0, spans=True),
                             **kw)
    assert shared_cache.stats()["misses"] == misses


def test_runner_and_sweep_telemetry_ticks(tiny, shared_cache, tmp_path):
    tel = tm.Telemetry(interval=0, spans=True,
                       span_path=tmp_path / "sweep.jsonl")
    st = ex.run_experiment_stream(
        tiny, (), 8, wave_size=4, chunk_steps=16, seed=3,
        summary_path=_clock_path, program_cache=shared_cache,
        telemetry=tel, device="cpu")
    assert st.n_waves == 2
    ticks = tm.METRIC_PREFIX + "ticks_total"
    assert tel.registry.get_sample(ticks, source="stream.wave") == 2.0
    assert tel.registry.get_sample(ticks, source="stream.chunk") >= 1.0
    assert tel.heartbeat_age("stream.wave") < 60.0
    spec = usergen.sweep_spec(usergen.torch_lib())
    grid = sweep.SweepGrid(
        {"step_mean": (0.2, 0.9)},
        lambda step_mean: (np.float64(step_mean), np.int32(6)), name="tiny")
    res = sweep.run_sweep(spec, grid, reps_per_cell=4, seed=5, cell_wave=4,
                          max_wave=8, chunk_steps=16,
                          program_cache=pc.ProgramCache(), telemetry=tel,
                          device="cpu")
    assert res.n_rounds == 1
    assert tel.registry.get_sample(ticks, source="sweep.round") == 1.0
    assert tel.registry.get_sample(ticks, source="sweep.chunk") >= 1.0
    assert tel.spans.open_count() == 0
    tel.close()
    lines = [json.loads(ln) for ln in open(tmp_path / "sweep.jsonl")]
    sweeps = [ln for ln in lines if ln.get("name") == "sweep"]
    rounds = [ln for ln in lines if ln.get("name") == "round"]
    assert len(sweeps) == 1 and sweeps[0]["outcome"] == "completed"
    assert len(rounds) == 1 and rounds[0]["n_live"] == 2


def test_chunked_ticks_and_run_card_block(tiny, shared_cache):
    """The chunked runner ticks a chunk; an audited stream's run card
    carries the plane's snapshot, and a run without one carries none."""
    tel = tm.Telemetry(interval=0)
    seen = []
    plain = ex.run_experiment(tiny, (), 4, seed=2, device="cpu")
    res = ex.run_experiment_chunked(tiny, (), 4, seed=2, chunk_steps=4,
                                    telemetry=tel, on_chunk=seen.append,
                                    device="cpu")
    _bitwise(plain.sims, res.sims)
    n = tel.registry.get_sample(tm.METRIC_PREFIX + "ticks_total",
                                source="chunked.chunk")
    assert n == len(seen) >= 3
    kw = dict(wave_size=4, chunk_steps=16, seed=7, summary_path=_clock_path,
              program_cache=shared_cache, device="cpu", audit=True)
    card = ex.run_experiment_stream(tiny, (), 8, telemetry=tel,
                                    **kw).audit
    assert card["telemetry"]["ticks"]["stream.wave"] == 2
    assert "telemetry" not in ex.run_experiment_stream(tiny, (), 8,
                                                       **kw).audit
    tel.close()


def test_healthz_503_for_a_dead_dispatcher(tiny, shared_cache):
    tel = tm.Telemetry(interval=0)
    svc = _service(max_wave=8, cache=shared_cache, telemetry=tel)
    with xp.start(tel) as srv:
        assert urllib.request.urlopen(srv.url + "/healthz",
                                      timeout=10).status == 200
        # the dispatcher thread gone while the service stays attached
        with svc._lock:
            svc._stop = True
        svc._queue.kick()
        svc._thread.join(30)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/healthz", timeout=10)
        assert e.value.code == 503
        assert json.loads(e.value.read())["status"] == "unhealthy"
        assert metrics_dump.main(["--url", srv.url]) == 1
    svc.shutdown(timeout=10)
    tel.close()


def test_metrics_dump_demo_on_cpu(capsys):
    assert metrics_dump.main(["--demo"]) == 0
    out = capsys.readouterr().out
    assert "cimba_serve_requests_completed_total" in out
    assert "HEALTH: ok" in out
    assert metrics_dump.main(["--version"]) == 0
