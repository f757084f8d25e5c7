"""The port's experiment service (``cimba_tpu_torch.serve``) against the
reference's direct stream and against its own direct calls.

* served mm1 and M/G/1 requests (the sweep's per-lane parameter rows),
  f64 and f32, R <= 32, packed with strangers: integers equal to the
  reference's ``run_experiment_stream`` of the same request, floats within
  ``rtol`` 1e-9 (f64) and 2e-5 (f32); and bitwise the port's own direct
  call, by ``obs.audit.stream_result_digest`` too;
* the semantics of ``tests/test_serve.py`` on the port alone, on the
  reference's tiny hold-and-exit spec: packing compatible and incompatible
  requests, priority, deadlines, cancellation, backpressure and
  ``QueueFull``, shutdown, retries with backoff after an injected failure,
  a failing fold, a packed failure charging no innocent member, the
  program cache's LRU, its environment cap and zero misses after
  ``serve.warm``, and the Chrome trace validating
  (``obs.export.dump_service_trace``);
* ``stats()`` has the reference's key set, nested groups included;
* the modules still to port raise, naming themselves, and no card with no
  ``device="cpu"`` raises at construction.

Every service is shut down by a fixture and every ``result()`` has a
timeout, so a hang fails a test rather than the suite.  The reference's
compiles are shared through ``functools.lru_cache``; torch runs on one
thread.
"""

import functools
import threading
import time

import jax
import numpy as np
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu import serve as jserve
from cimba_tpu.models import mg1 as jmg1
from cimba_tpu.models import mm1 as jmm1
from cimba_tpu.runner import experiment as jex
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import serve, tree
from cimba_tpu_torch.core import api, process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.models import mg1, mm1
from cimba_tpu_torch.obs import audit, export
from cimba_tpu_torch.obs import metrics as obs_metrics
from cimba_tpu_torch.runner import experiment as ex
from cimba_tpu_torch.serve import cache as pc
from cimba_tpu_torch.stats import summary as sm

torch.set_num_threads(1)

RTOL = {"f64": 1e-9, "f32": 2e-5}
T = 60  # every result() waits at most this long


def tiny_spec(t_stop=12.0):
    """The reference tests' smallest chunkable model: one process holding
    unit steps until its clock passes ``t_stop``."""
    m = Model("tiny", event_cap=1, guard_cap=2)

    @m.block
    def work(sim, p, sig):
        done = api.clock(sim) > t_stop
        return sim, cmd.select(done, cmd.exit_(),
                               cmd.hold(1.0, next_pc=work.pc))

    m.process("w", entry=work)
    return m.build()


def clock_path(sims):
    """tiny records no summary: each lane's final clock, one sample."""
    return sm.add(sm.empty(sims.clock.shape, sims.clock.device), sims.clock)


def equal_results(a, b):
    assert (a.n_waves, a.n_regrows) == (b.n_waves, b.n_regrows)
    la = tree.leaves((a.summary, a.n_failed, a.total_events, a.metrics))
    lb = tree.leaves((b.summary, b.n_failed, b.total_events, b.metrics))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert audit.stream_result_digest(a) == audit.stream_result_digest(b)


@pytest.fixture(scope="module")
def tiny():
    return tiny_spec()


@pytest.fixture(scope="module")
def shared_cache():
    return pc.ProgramCache(capacity=256)


@pytest.fixture
def services():
    """Services made by a test, each shut down at its end (without
    waiting: a test that failed half way must not hang the suite)."""
    made = []
    yield made
    for s in made:
        if hasattr(s, "gate"):
            s.gate.set()
        s.shutdown(wait=False, timeout=T)


def start(services, cls=serve.Service, **kw):
    kw.setdefault("device", "cpu")
    svc = cls(**kw)
    services.append(svc)
    return svc


class Gated(serve.Service):
    """A service whose dispatch waits until the test opens the gate: the
    queue under test is built, not raced."""

    def __init__(self, **kw):
        self.gate = threading.Event()
        super().__init__(**kw)

    def _run_batch(self, slots):
        assert self.gate.wait(T), "test gate never opened"
        return super()._run_batch(slots)


def wait_for(pred, timeout=30.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("condition not reached in time")
        time.sleep(0.005)


def tiny_req(spec, R, *, wave=None, seed=1, **kw):
    return serve.Request(spec, (), R, seed=seed, chunk_steps=16,
                         wave_size=wave, summary_path=clock_path, **kw)


def direct(spec, R, cache, *, wave=None, seed=1, t_end=None):
    return ex.run_experiment_stream(spec, (), R, wave_size=wave or R,
                                    chunk_steps=16, seed=seed, t_end=t_end,
                                    summary_path=clock_path,
                                    program_cache=cache, device="cpu")


# --- served against the reference's direct stream -------------------------

CASES = {
    # (requests: (params of the model, R, wave, seed, t_end), chunk)
    "mm1": (((lambda m: m.params(10), 16, 8, 3, None),
             (lambda m: m.params(12), 16, 8, 5, 30.0)), 37),
    "mg1": (((lambda m: m.sweep_params(8, reps_per_cell=1)[0], 20, 10, 7,
              None),
             (lambda m: m.sweep_params(8, reps_per_cell=1)[0], 20, 10, 9,
              None)), 37),
}


@functools.lru_cache(maxsize=None)
def ref_streams(model, prof):
    jm = {"mm1": jmm1, "mg1": jmg1}[model]
    reqs, chunk = CASES[model]
    with jconfig.profile(prof):
        spec = jm.build(record=False)[0] if model == "mm1" else jm.build()[0]
        cache = jserve.ProgramCache()
        out = []
        for params, R, wave, seed, t_end in reqs:
            st = jex.run_experiment_stream(
                spec, params(jm), R, wave_size=wave, chunk_steps=chunk,
                seed=seed, t_end=t_end, program_cache=cache)
            out.append((st.n_waves, int(st.n_failed), int(st.total_events),
                        [float(x) for x in jax.tree.leaves(st.summary)]))
    return out


@pytest.mark.parametrize("model", ["mm1", "mg1"])
@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_served_matches_reference_and_own_direct(model, prof, services):
    tm = {"mm1": mm1, "mg1": mg1}[model]
    reqs, chunk = CASES[model]
    with tconfig.profile(prof):
        spec = tm.build(record=False)[0] if model == "mm1" else tm.build()[0]
        cache = serve.ProgramCache()
        svc = start(services, Gated, max_wave=64, cache=cache)
        hs = [svc.submit(serve.Request(
            spec, params(tm), R, seed=seed, t_end=t_end, wave_size=wave,
            chunk_steps=chunk)) for params, R, wave, seed, t_end in reqs]
        svc.gate.set()
        got = [h.result(T) for h in hs]
        for (params, R, wave, seed, t_end), res, ref in zip(
                reqs, got, ref_streams(model, prof)):
            assert (res.n_waves, int(res.n_failed),
                    int(res.total_events)) == tuple(ref[:3])
            assert res.total_events.dtype == torch.int64
            np.testing.assert_allclose([float(x) for x in res.summary],
                                       ref[3], rtol=RTOL[prof])
            own = ex.run_experiment_stream(
                spec, params(tm), R, wave_size=wave, chunk_steps=chunk,
                seed=seed, t_end=t_end, program_cache=cache, device="cpu")
            equal_results(res, own)
        if model == "mm1":
            # the horizonless request and the horizon one share a class
            # only within a bucket: here they do not, so two waves
            assert svc.stats()["batches"] == 2


# --- bitwise isolation ------------------------------------------------------


def test_single_and_multiwave_match_direct_bitwise(tiny, shared_cache,
                                                   services):
    svc = start(services, max_wave=16, cache=shared_cache)
    one = svc.submit(tiny_req(tiny, 8, wave=8, seed=3)).result(T)
    multi = svc.submit(tiny_req(tiny, 24, wave=8, seed=4)).result(T)
    ragged = svc.submit(tiny_req(tiny, 20, wave=8, seed=5)).result(T)
    equal_results(one, direct(tiny, 8, shared_cache, wave=8, seed=3))
    equal_results(multi, direct(tiny, 24, shared_cache, wave=8, seed=4))
    equal_results(ragged, direct(tiny, 20, shared_cache, wave=8, seed=5))
    assert multi.n_waves == 3 and ragged.n_waves == 3


def test_concurrent_clients_match_direct_bitwise(tiny, shared_cache,
                                                 services):
    svc = start(services, max_wave=32, cache=shared_cache)
    cases = [(8, 1, None), (16, 2, 6.0), (8, 3, None), (24, 4, 9.5),
             (12, 5, None)]
    out = {}

    def client(i, R, seed, t_end):
        out[i] = svc.submit(tiny_req(tiny, R, wave=8, seed=seed,
                                     t_end=t_end)).result(T)

    ts = [threading.Thread(target=client, args=(i,) + c)
          for i, c in enumerate(cases)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(T)
    for i, (R, seed, t_end) in enumerate(cases):
        equal_results(out[i], direct(tiny, R, shared_cache, wave=8,
                                     seed=seed, t_end=t_end))


def test_packing_compatible_shares_wave_incompatible_does_not(
        tiny, shared_cache, services):
    other = tiny_spec(5.0)  # another spec: another class
    svc = start(services, Gated, max_wave=64, cache=shared_cache)
    hs = [svc.submit(tiny_req(tiny, 8, seed=s)) for s in (1, 2, 3)]
    hs.append(svc.submit(tiny_req(other, 8, seed=1)))
    svc.gate.set()
    res = [h.result(T) for h in hs]
    st = svc.stats()
    # the first popped request packs its two classmates; the stranger
    # rides alone
    assert st["batch_occupancy"] == {1: 1, 3: 1}, st["batch_occupancy"]
    assert st["classes_seen"] == 2 and st["lanes_padded"] == 8
    for s, r in zip((1, 2, 3), res):
        equal_results(r, direct(tiny, 8, shared_cache, seed=s))
    equal_results(res[3], direct(other, 8, shared_cache, seed=1))


def test_priority_orders_dispatch(tiny, shared_cache, services):
    other = tiny_spec(6.0)
    svc = start(services, Gated, max_wave=8, cache=shared_cache)
    order = []
    lo = svc.submit(tiny_req(other, 8, seed=1, label="lo"))
    wait_for(lambda: svc.stats()["batches"] == 1)  # lo holds the gate
    reqs = [("p0", 0), ("p5", 5), ("p1", 1), ("p5b", 5)]
    hs = [svc.submit(tiny_req(tiny, 8, seed=1, priority=p, label=lab))
          for lab, p in reqs]
    for h in hs:
        threading.Thread(target=lambda h=h: (h.result(T),
                                             order.append(h.label))).start()
    svc.gate.set()
    lo.result(T)
    wait_for(lambda: len(order) == 4)
    assert order == ["p5", "p5b", "p1", "p0"]


def test_deadline_exceeded_mid_queue_without_stalling_others(
        tiny, shared_cache, services):
    svc = start(services, Gated, max_wave=8, cache=shared_cache)
    first = svc.submit(tiny_req(tiny, 8, seed=1))
    wait_for(lambda: svc.stats()["batches"] == 1)
    late = svc.submit(tiny_req(tiny, 8, seed=2, deadline=0.01))
    ok = svc.submit(tiny_req(tiny, 8, seed=3))
    time.sleep(0.05)
    svc.gate.set()
    first.result(T)
    with pytest.raises(serve.DeadlineExceeded) as ei:
        late.result(T)
    assert ei.value.deadline_s == 0.01 and ei.value.waited_s > 0.01
    equal_results(ok.result(T), direct(tiny, 8, shared_cache, seed=3))
    assert svc.stats()["deadline_exceeded"] == 1


def test_cancel_queued_yes_inflight_no(tiny, shared_cache, services):
    svc = start(services, Gated, max_wave=8, cache=shared_cache)
    running = svc.submit(tiny_req(tiny, 8, seed=1))
    wait_for(lambda: svc.stats()["batches"] == 1)
    queued = svc.submit(tiny_req(tiny, 8, seed=2))
    assert running.cancel() is False
    assert queued.cancel() is True
    with pytest.raises(serve.Cancelled):
        queued.result(T)
    svc.gate.set()
    equal_results(running.result(T), direct(tiny, 8, shared_cache, seed=1))
    assert queued.cancel() is False  # done already
    assert svc.stats()["cancelled"] == 1


def test_admission_backpressure_and_queue_full(tiny, shared_cache,
                                               services):
    svc = start(services, Gated, max_wave=8, max_pending=2,
                cache=shared_cache)
    running = svc.submit(tiny_req(tiny, 8, seed=1))
    wait_for(lambda: svc.stats()["batches"] == 1)
    queued = [svc.submit(tiny_req(tiny, 8, seed=s)) for s in (2, 3)]
    with pytest.raises(serve.QueueFull) as ei:
        svc.submit(tiny_req(tiny, 8, seed=4), block=False)
    assert ei.value.capacity == 2
    with pytest.raises(serve.QueueFull):
        svc.submit(tiny_req(tiny, 8, seed=4), timeout=0.05)
    # a blocking submit waits for space, then is admitted
    got = {}
    th = threading.Thread(target=lambda: got.setdefault(
        "h", svc.submit(tiny_req(tiny, 8, seed=5))))
    th.start()
    time.sleep(0.05)
    assert "h" not in got
    svc.gate.set()
    th.join(T)
    for h in [running, *queued, got["h"]]:
        h.result(T)
    st = svc.stats()
    assert st["rejected"] == 2 and st["queue_depth_hwm"] == 2
    assert st["completed"] == 4


def test_submit_after_shutdown_and_validation_errors(tiny, shared_cache,
                                                     services):
    svc = start(services, max_wave=8, cache=shared_cache)
    with pytest.raises(ValueError, match="n_replications"):
        svc.submit(tiny_req(tiny, 0))
    with pytest.raises(ValueError, match="max_wave"):
        svc.submit(tiny_req(tiny, 16, wave=16))
    svc.shutdown()
    with pytest.raises(serve.ServiceClosed):
        svc.submit(tiny_req(tiny, 8))
    svc.shutdown()  # idempotent
    with pytest.raises(ValueError, match="max_wave"):
        serve.Service(max_wave=0, device="cpu")
    with pytest.raises(ValueError, match="horizon_bucket"):
        serve.Service(horizon_bucket=1.0, device="cpu")
    with pytest.raises(ValueError, match="fuse_max_specs"):
        serve.Service(fuse_max_specs=1, device="cpu")


class Flaky(serve.Service):
    """Fails its first ``fails`` dispatches with a transient error."""

    def __init__(self, fails, exc=RuntimeError, **kw):
        self.fails = fails
        self.exc = exc
        self.calls = 0
        super().__init__(**kw)

    def _run_batch(self, slots):
        self.calls += 1
        if self.calls <= self.fails:
            raise self.exc(f"injected failure {self.calls}")
        return super()._run_batch(slots)


def test_retry_backoff_recovers_and_budget_exhausts(tiny, shared_cache,
                                                    services):
    fast = serve.Backoff(base=0.01, factor=2.0, cap=0.05)
    svc = start(services, Flaky, fails=2, max_wave=8, cache=shared_cache,
                backoff=fast, max_retries=2)
    h = svc.submit(tiny_req(tiny, 8, seed=7))
    equal_results(h.result(T), direct(tiny, 8, shared_cache, seed=7))
    assert svc.stats()["retries"] == 2 and svc.calls == 3
    svc2 = start(services, Flaky, fails=10, max_wave=8, cache=shared_cache,
                 backoff=fast, max_retries=1)
    h2 = svc2.submit(tiny_req(tiny, 8, seed=7, label="doomed"))
    with pytest.raises(serve.RetriesExhausted) as ei:
        h2.result(T)
    assert ei.value.attempts == 2 and ei.value.label == "doomed"
    assert isinstance(ei.value.__cause__, RuntimeError)
    # the dispatcher still serves
    svc2.fails = 0
    equal_results(svc2.submit(tiny_req(tiny, 8, seed=7)).result(T),
                  direct(tiny, 8, shared_cache, seed=7))
    assert serve.Backoff(0.05, 2.0, 2.0).delay(3) == pytest.approx(0.2)


def test_permanent_error_surfaces_immediately(tiny, shared_cache,
                                              services):
    svc = start(services, Flaky, fails=1, exc=ValueError, max_wave=8,
                cache=shared_cache)
    with pytest.raises(ValueError, match="injected"):
        svc.submit(tiny_req(tiny, 8, seed=2)).result(T)
    assert svc.stats()["retries"] == 0 and svc.stats()["failed"] == 1


def test_fold_failure_fails_request_not_dispatcher(tiny, shared_cache,
                                                   services):
    def bad_path(sims):
        # the preflight passes (a Summary a lane); the fold's merge fails
        if sims.clock.shape[0] > 2:
            raise RuntimeError("fold-time failure")
        return clock_path(sims)

    svc = start(services, max_wave=8, cache=shared_cache, max_retries=0,
                backoff=serve.Backoff(0.01, 1.0, 0.01))
    h = svc.submit(serve.Request(tiny, (), 8, seed=1, chunk_steps=16,
                                 summary_path=bad_path))
    with pytest.raises(serve.RetriesExhausted):
        h.result(T)
    equal_results(svc.submit(tiny_req(tiny, 8, seed=1)).result(T),
                  direct(tiny, 8, shared_cache, seed=1))
    # a summary_path that does not exist on the model is a bad request
    with pytest.raises(ValueError, match="summary_path"):
        svc.submit(serve.Request(tiny, (), 8, chunk_steps=16)).result(T)


def test_metrics_flip_between_submit_and_dispatch_fails(tiny, shared_cache,
                                                        services):
    svc = start(services, Gated, max_wave=8, cache=shared_cache)
    h = svc.submit(tiny_req(tiny, 8, seed=1))
    obs_metrics.enable()
    try:
        svc.gate.set()
        with pytest.raises(ValueError, match="changed between"):
            h.result(T)
    finally:
        obs_metrics.disable()


class PackFlaky(Gated):
    """Its first (packed) dispatch fails; later (solo) ones run."""

    def __init__(self, **kw):
        self.n = 0
        super().__init__(**kw)

    def _run_batch(self, slots):
        self.n += 1
        if self.n == 1:
            assert self.gate.wait(T)
            raise RuntimeError("poison")
        return super()._run_batch(slots)


def test_packed_failure_does_not_charge_innocents(tiny, shared_cache,
                                                  services):
    svc = start(services, PackFlaky, max_wave=32, cache=shared_cache,
                max_retries=0, backoff=serve.Backoff(0.01, 1.0, 0.01))
    hs = [svc.submit(tiny_req(tiny, 8, seed=s)) for s in (1, 2, 3)]
    svc.gate.set()
    for s, h in zip((1, 2, 3), hs):
        # max_retries=0: a charged failure would have exhausted it
        equal_results(h.result(T), direct(tiny, 8, shared_cache, seed=s))
    st = svc.stats()
    assert st["retries"] == 3 and st["completed"] == 3


def test_shutdown_nowait_cancels_queued(tiny, shared_cache, services):
    svc = start(services, Gated, max_wave=8, cache=shared_cache)
    running = svc.submit(tiny_req(tiny, 16, wave=8, seed=1))
    wait_for(lambda: svc.stats()["batches"] == 1)
    queued = svc.submit(tiny_req(tiny, 8, seed=2))
    t = threading.Thread(target=lambda: svc.shutdown(wait=False, timeout=T))
    t.start()
    with pytest.raises(serve.Cancelled):
        queued.result(T)
    svc.gate.set()
    t.join(T)
    # the in-flight wave finishes; its requeued remainder is cancelled
    with pytest.raises(serve.Cancelled):
        running.result(T)
    assert not svc._thread.is_alive()


# --- the program cache --------------------------------------------------


def test_program_cache_lru_bounds_and_counters():
    c = pc.ProgramCache(capacity=2)
    assert c.get_or_create("a", lambda: 1) == 1
    assert c.get_or_create("b", lambda: 2) == 2
    assert c.get_or_create("a", lambda: 9) == 1  # hit, refreshes a
    assert c.get_or_create("c", lambda: 3) == 3  # evicts b
    assert "b" not in c and "a" in c and len(c) == 2
    st = c.stats()
    assert (st["hits"], st["misses"], st["evictions"], st["size"]) == (
        1, 3, 1, 2)
    assert st["hit_ratio"] == 0.25 and set(st) == set(
        jserve.ProgramCache(capacity=2).stats())
    with pytest.raises(ValueError):
        pc.ProgramCache(capacity=0)


def test_program_cache_env_cap(monkeypatch):
    monkeypatch.setenv("CIMBA_PROGRAM_CACHE_CAP", "7")
    assert pc.ProgramCache().capacity == 7 == pc.default_capacity()
    monkeypatch.setenv("CIMBA_PROGRAM_CACHE_CAP", "0")
    with pytest.raises(ValueError, match="CIMBA_PROGRAM_CACHE_CAP"):
        pc.ProgramCache()
    monkeypatch.delenv("CIMBA_PROGRAM_CACHE_CAP")
    assert pc.default_capacity() == 64


def test_warm_then_zero_misses(tiny, services):
    cache = pc.ProgramCache()
    serve.warm(cache, tiny, (), 8, chunk_steps=16, seed=1,
               summary_path=clock_path, device="cpu")
    m0 = cache.stats()["misses"]
    # another seed, horizon or R: lane data, nothing new to build
    direct(tiny, 8, cache, seed=9)
    direct(tiny, 16, cache, wave=8, seed=2, t_end=7.0)
    assert cache.stats()["misses"] == m0
    svc = start(services, max_wave=32, cache=cache)
    hs = [svc.submit(tiny_req(tiny, 8, wave=8, seed=s,
                              t_end=None if s % 2 else 20.0))
          for s in range(1, 7)]
    for h in hs:
        h.result(T)
    assert svc.stats()["program_cache"]["misses"] == m0
    # a new chunk budget is a new chunk program
    direct_st = ex.run_experiment_stream(
        tiny, (), 8, chunk_steps=5, seed=1, summary_path=clock_path,
        program_cache=cache, device="cpu")
    assert cache.stats()["misses"] == m0 + 1 and int(
        direct_st.n_failed) == 0


def test_stream_correct_under_eviction_pressure(tiny):
    cache = pc.ProgramCache(capacity=1)
    a = direct(tiny, 16, cache, wave=8, seed=3)
    b = direct(tiny, 16, pc.ProgramCache(), wave=8, seed=3)
    equal_results(a, b)
    assert cache.stats()["evictions"] > 0


# --- observability ----------------------------------------------------------


def test_chrome_trace_validates_and_carries_stats(tiny, shared_cache,
                                                  services, tmp_path):
    svc = start(services, max_wave=16, cache=shared_cache)
    idle = export.dump_service_trace(str(tmp_path / "idle.json"), svc)
    assert idle["otherData"]["service"]["submitted"] == 0
    for s in (1, 2):
        svc.submit(tiny_req(tiny, 8, seed=s, label=f"r{s}")).result(T)
    doc = export.dump_service_trace(str(tmp_path / "t.json"), svc)
    assert (tmp_path / "t.json").exists()
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert sorted(e["name"] for e in spans) == ["r1", "r2"]
    assert all(e["args"]["outcome"] == "completed" for e in spans)
    assert doc["otherData"]["service"]["completed"] == 2
    assert any(e["name"] == "wave_lanes" for e in doc["traceEvents"])


def _key_tree(d):
    return {k: _key_tree(v) if isinstance(v, dict) and k not in (
        "batch_occupancy", "queue_depth_by_class", "by_class", "tenants",
        "lanes_held", "deficits", "sources") else None
        for k, v in d.items()}


def test_stats_keys_are_the_reference_keys(tiny, shared_cache, services):
    svc = start(services, max_wave=16, cache=shared_cache)
    svc.submit(tiny_req(tiny, 8, seed=1)).result(T)
    ref = jserve.Service(max_wave=16)
    try:
        want = _key_tree(ref.stats())
    finally:
        ref.shutdown()
    got = _key_tree(svc.stats())
    assert got == want
    for k in ("refill", "fusion", "lane_occupancy", "time_to_first_wave",
              "program_cache", "batch_occupancy"):
        assert k in got


# --- what is not ported, and the device rule --------------------------------


def test_unported_modules_raise_naming_themselves(tiny, monkeypatch):
    for kw, mod in (({"device_sched": True}, "serve/device.py"),
                    ({"qos": True}, "qos/"),
                    ({"tenants": object()}, "qos/")):
        with pytest.raises(NotImplementedError, match=mod):
            serve.Service(device="cpu", **kw)
    # telemetry= is ported (obs/telemetry.py): the plane attaches the
    # service, scrapes its stats and detaches it at shutdown
    from cimba_tpu_torch.obs import telemetry as tm

    tel = tm.Telemetry(interval=0)
    with serve.Service(device="cpu", telemetry=tel) as svc:
        assert list(tel.healthz()["services"]) == [svc.name]
        tel.sample()
        assert tel.registry.get_sample("cimba_serve_requests_submitted_total",
                                       service=svc.name) == 0.0
    assert tel.healthz()["services"] == {}
    tel.close()
    for env, mod in (("CIMBA_DEVICE_SCHED", "serve/device.py"),
                     ("CIMBA_QOS", "qos/")):
        monkeypatch.setenv(env, "1")
        with pytest.raises(NotImplementedError, match=mod):
            serve.Service(device="cpu")
        monkeypatch.delenv(env)
    with pytest.raises(NotImplementedError, match="serve/store.py"):
        pc.ProgramCache(store=object())
    with pytest.raises(NotImplementedError, match="serve/store.py"):
        serve.warm(pc.ProgramCache(), tiny, (), 8, manifest="somewhere")
    assert pc.ProgramCache(store=False).store is None
    names = set(jserve.__all__) - {
        "ProgramStore", "StoreInvalidationWarning", "UnstableStoreKey",
        "default_store", "maybe_enable_persistent_cache"}
    assert set(serve.__all__) == names


def test_no_card_and_no_cpu_raises_at_construction(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.Service()
    assert threading.active_count() == before
