"""Continuous wave refill in the port's service (``Service(refill=True)``)
against ``tests/test_refill.py``'s semantics, the port's direct calls and
the reference's direct stream.

On the reference tests' tiny hold-and-exit spec (its clock values are
whole numbers, so the reference's streams give the same bits):

* a lead and a short-horizon mate pack, the short one's lanes die and
  free, a request queued after the wave started is spliced into them,
  and all three are bitwise their direct calls, in both profiles, and
  equal to the reference's ``run_experiment_stream`` of each;
* a wave is born at ``max_wave`` lanes with ``pad_waves`` and a request
  queued mid-wave fills the pads; three horizons retire at three
  boundaries, a request of two slots folds in the direct call's order;
* a cancel or a deadline mid-wave frees the request's lanes at the next
  boundary, its mates unperturbed; a cancelled two-slot request's second
  slot never runs; a queued request of another class stops the wave's
  admissions (the fairness valve);
* the plain path samples lane occupancy from its liveness readback and
  adds no entry to the shared cache; ``CIMBA_REFILL`` sets the default;
  a warmed refill service builds nothing;
* 16 client threads with a short switch interval: every result bitwise
  its direct call, each slot retired once.

Every service is shut down by a fixture and every ``result()`` has a
timeout; torch runs on one thread.
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
from cimba_tpu.core import api as japi
from cimba_tpu.core import cmd as jcmd
from cimba_tpu.core.model import Model as JModel
from cimba_tpu.runner import experiment as jex
from cimba_tpu.stats import summary as jsm
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import serve, tree
from cimba_tpu_torch.core import api, process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.obs import audit
from cimba_tpu_torch.runner import experiment as ex
from cimba_tpu_torch.serve import cache as pc
from cimba_tpu_torch.stats import summary as sm

torch.set_num_threads(1)

T = 60


def tiny_spec(Model, api, cmd, t_stop=12.0):
    m = Model("tiny", event_cap=1, guard_cap=2)

    @m.block
    def work(sim, p, sig):
        done = api.clock(sim) > t_stop
        return sim, cmd.select(done, cmd.exit_(),
                               cmd.hold(1.0, next_pc=work.pc))

    m.process("w", entry=work)
    return m.build()


def clock_path(sims):
    return sm.add(sm.empty(sims.clock.shape, sims.clock.device), sims.clock)


def jclock_path(sims):
    return jax.vmap(lambda c: jsm.add(jsm.empty(), c))(sims.clock)


def equal_results(a, b):
    assert (a.n_waves, a.n_regrows) == (b.n_waves, b.n_regrows)
    for x, y in zip(tree.leaves((a.summary, a.n_failed, a.total_events)),
                    tree.leaves((b.summary, b.n_failed, b.total_events))):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert audit.stream_result_digest(a) == audit.stream_result_digest(b)


def req(spec, R, *, seed=1, t_end=None, wave=None, **kw):
    return serve.Request(spec, (), R, seed=seed, t_end=t_end,
                         wave_size=wave or R, chunk_steps=4,
                         summary_path=clock_path, **kw)


def direct(spec, R, cache, *, seed, t_end=None, wave=None):
    return ex.run_experiment_stream(spec, (), R, wave_size=wave or R,
                                    chunk_steps=4, seed=seed, t_end=t_end,
                                    summary_path=clock_path,
                                    program_cache=cache, device="cpu")


@functools.lru_cache(maxsize=None)
def ref_direct(prof, R, seed, t_end):
    """The reference's direct stream of the same request."""
    with jconfig.profile(prof):
        st = jex.run_experiment_stream(
            ref_spec(prof), (), R, wave_size=R, chunk_steps=4, seed=seed,
            t_end=t_end, summary_path=jclock_path, program_cache=ref_cache())
        return (st.n_waves, int(st.n_failed), int(st.total_events),
                [np.asarray(x) for x in jax.tree.leaves(st.summary)])


@functools.lru_cache(maxsize=None)
def ref_spec(prof):
    with jconfig.profile(prof):
        return tiny_spec(JModel, japi, jcmd)


@functools.lru_cache(maxsize=None)
def ref_cache():
    return jserve.ProgramCache(capacity=64)


class Gated(serve.Service):
    """A refill service with two gates: ``pack_gate`` holds the wave's
    first pack, ``release`` every chunk boundary (``started`` is set at
    the first), so admissions are built, not raced."""

    def __init__(self, **kw):
        self.pack_gate = threading.Event()
        self.started = threading.Event()
        self.release = threading.Event()
        kw.setdefault("refill", True)
        kw.setdefault("horizon_bucket", None)
        kw.setdefault("refill_every", 1)
        kw.setdefault("device", "cpu")
        super().__init__(**kw)

    def _serve_refill_wave(self, lead):
        assert self.pack_gate.wait(T), "pack gate never opened"
        return super()._serve_refill_wave(lead)

    def _refill_boundary(self, wave, n, sims, final=False):
        self.started.set()
        assert self.release.wait(T), "boundary gate never opened"
        return super()._refill_boundary(wave, n, sims, final=final)


@pytest.fixture(scope="module")
def tiny():
    return tiny_spec(Model, api, cmd)


@pytest.fixture(scope="module")
def shared_cache():
    return pc.ProgramCache(capacity=256)


@pytest.fixture
def services():
    made = []
    yield made
    for s in made:
        for g in ("pack_gate", "release"):
            if hasattr(s, g):
                getattr(s, g).set()
        s.shutdown(wait=False, timeout=T)


def start(services, cls=Gated, **kw):
    svc = cls(**kw)
    services.append(svc)
    return svc


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_refilled_request_bitwise_equals_solo_and_reference(prof,
                                                            services):
    with tconfig.profile(prof):
        spec = tiny_spec(Model, api, cmd)
        cache = pc.ProgramCache(capacity=64)
        svc = start(services, max_wave=8, cache=cache, pad_waves=False)
        lead = svc.submit(req(spec, 4, seed=1, t_end=10.0, label="lead"))
        short = svc.submit(req(spec, 4, seed=7, t_end=3.0, label="short"))
        svc.pack_gate.set()
        assert svc.started.wait(T)
        queued = svc.submit(req(spec, 4, seed=9, t_end=6.0,
                                label="queued"))
        svc.release.set()
        results = {(1, 10.0): lead.result(T), (7, 3.0): short.result(T),
                   (9, 6.0): queued.result(T)}
        st = svc.stats()
        assert st["refill"]["refill_admissions"] >= 1, st["refill"]
        assert st["refill"]["refill_retirements"] >= 2
        assert st["refill"]["mid_wave_deliveries"] >= 1
        for (seed, t_end), res in results.items():
            equal_results(res, direct(spec, 4, cache, seed=seed,
                                      t_end=t_end))
            n_waves, n_failed, events, summ = ref_direct(prof, 4, seed,
                                                         t_end)
            assert (res.n_waves, int(res.n_failed),
                    int(res.total_events)) == (n_waves, n_failed, events)
            for x, y in zip(res.summary, summ):
                np.testing.assert_array_equal(x.numpy(), y)


def test_pad_lane_reclamation(tiny, shared_cache, services):
    svc = start(services, max_wave=8, cache=shared_cache, pad_waves=True)
    lead = svc.submit(req(tiny, 3, seed=2, t_end=9.0, label="lead"))
    svc.pack_gate.set()
    assert svc.started.wait(T)
    queued = svc.submit(req(tiny, 1, seed=3, t_end=5.0, label="padfill"))
    svc.release.set()
    rl, rq = lead.result(T), queued.result(T)
    st = svc.stats()
    assert st["lane_occupancy"]["lanes_padded"] == 5  # born at capacity
    assert st["refill"]["refill_admissions"] >= 1
    equal_results(rl, direct(tiny, 3, shared_cache, seed=2, t_end=9.0))
    equal_results(rq, direct(tiny, 1, shared_cache, seed=3, t_end=5.0))


def test_mixed_horizon_staggered_retirement_exact(tiny, shared_cache,
                                                  services):
    svc = start(services, max_wave=8, cache=shared_cache, pad_waves=False)
    lead = svc.submit(req(tiny, 8, seed=4, t_end=10.0, wave=4,
                          label="lead"))
    a = svc.submit(req(tiny, 2, seed=5, t_end=2.0, label="a"))
    b = svc.submit(req(tiny, 2, seed=6, t_end=5.0, label="b"))
    svc.pack_gate.set()
    svc.release.set()
    rl, ra, rb = lead.result(T), a.result(T), b.result(T)
    st = svc.stats()
    assert rl.n_waves == 2  # two slots, two folds: the direct partition
    assert st["refill"]["mid_wave_deliveries"] >= 2, st["refill"]
    assert st["refill"]["refill_admissions"] >= 1
    assert int(ra.total_events) < int(rb.total_events)
    equal_results(rl, direct(tiny, 8, shared_cache, seed=4, t_end=10.0,
                             wave=4))
    equal_results(ra, direct(tiny, 2, shared_cache, seed=5, t_end=2.0))
    equal_results(rb, direct(tiny, 2, shared_cache, seed=6, t_end=5.0))
    occ = st["lane_occupancy"]
    assert occ["occupancy_samples"] >= 1 and occ["lanes_in_wave"] >= 4


def test_cancel_mid_wave_frees_lanes(tiny, shared_cache, services):
    svc = start(services, max_wave=4, cache=shared_cache, pad_waves=False)
    lead = svc.submit(req(tiny, 2, seed=4, t_end=20.0, label="lead"))
    victim = svc.submit(req(tiny, 2, seed=5, t_end=20.0, label="victim"))
    svc.pack_gate.set()
    assert svc.started.wait(T)
    assert victim.cancel()          # in flight, refill: honoured
    assert not victim.done()        # at the next boundary
    svc.release.set()
    with pytest.raises(serve.Cancelled):
        victim.result(T)
    rl = lead.result(T)
    st = svc.stats()
    assert st["cancelled"] == 1 and st["completed"] == 1
    assert st["refill"]["lanes_reclaimed"] == 2
    equal_results(rl, direct(tiny, 2, shared_cache, seed=4, t_end=20.0))


def test_deadline_expiry_mid_wave_frees_lanes(tiny, shared_cache,
                                              services):
    svc = start(services, max_wave=4, cache=shared_cache, pad_waves=False)
    lead = svc.submit(req(tiny, 2, seed=6, t_end=20.0, label="lead"))
    doomed = svc.submit(req(tiny, 2, seed=7, t_end=20.0, label="doomed",
                            deadline=0.3))
    svc.pack_gate.set()
    assert svc.started.wait(T)
    time.sleep(0.45)
    svc.release.set()
    with pytest.raises(serve.DeadlineExceeded) as ei:
        doomed.result(T)
    assert ei.value.waited_s >= 0.3
    rl = lead.result(T)
    st = svc.stats()
    assert st["deadline_exceeded"] == 1
    assert st["refill"]["lanes_reclaimed"] == 2
    equal_results(rl, direct(tiny, 2, shared_cache, seed=6, t_end=20.0))


def test_foreign_class_queued_stops_boundary_admissions(tiny, shared_cache,
                                                        services):
    svc = start(services, max_wave=8, cache=shared_cache, pad_waves=True,
                horizon_bucket=16.0)
    lead = svc.submit(req(tiny, 4, seed=1, t_end=12.0, label="lead"))
    svc.pack_gate.set()
    assert svc.started.wait(T)
    foreign = svc.submit(req(tiny, 2, seed=2, t_end=500.0,
                             label="foreign"))
    mate = svc.submit(req(tiny, 2, seed=3, t_end=6.0, label="mate"))
    svc.release.set()
    rl, rf, rm = lead.result(T), foreign.result(T), mate.result(T)
    st = svc.stats()
    assert st["refill"]["refill_admissions"] == 0, st["refill"]
    assert st["completed"] == 3
    equal_results(rl, direct(tiny, 4, shared_cache, seed=1, t_end=12.0))
    equal_results(rf, direct(tiny, 2, shared_cache, seed=2, t_end=500.0))
    equal_results(rm, direct(tiny, 2, shared_cache, seed=3, t_end=6.0))


def test_cancelled_multislot_remainder_not_readmitted(tiny, shared_cache,
                                                      services):
    svc = start(services, max_wave=4, cache=shared_cache, pad_waves=False)
    victim = svc.submit(serve.Request(
        tiny, (), 8, seed=4, t_end=4.0, chunk_steps=64, wave_size=4,
        summary_path=clock_path, label="victim"))
    svc.pack_gate.set()
    assert svc.started.wait(T)
    assert victim.cancel()
    svc.release.set()
    with pytest.raises(serve.Cancelled):
        victim.result(T)
    st = svc.stats()
    assert st["cancelled"] == 1
    assert st["refill"]["refill_admissions"] == 0, st["refill"]
    assert st["waves"] == 1, st


def test_plain_path_occupancy_from_live_readback(tiny, shared_cache,
                                                 services):
    before = len(shared_cache)
    direct(tiny, 4, shared_cache, seed=8, t_end=9.0)
    size = len(shared_cache)
    svc = start(services, serve.Service, max_wave=8, cache=shared_cache,
                refill=False, horizon_bucket=None, device="cpu")
    res = svc.submit(req(tiny, 4, seed=8, t_end=9.0, label="plain")
                     ).result(T)
    st = svc.stats()
    occ = st["lane_occupancy"]
    assert occ["occupancy_samples"] >= 1, occ
    assert occ["lanes_in_wave"] == 4 and 0.0 <= occ["occupancy_mean"] <= 1.0
    assert st["refill"]["enabled"] is False
    assert st["refill"]["refill_boundaries"] == 0
    # the readback is the service's own: one gather entry, no program
    assert len(shared_cache) - size <= 1 and size >= before
    equal_results(res, direct(tiny, 4, shared_cache, seed=8, t_end=9.0))


def test_refill_env_knob_resolves_service_default(monkeypatch, services):
    monkeypatch.setenv("CIMBA_REFILL", "1")
    assert start(services, serve.Service, device="cpu").refill is True
    assert start(services, serve.Service, device="cpu",
                 refill=False).refill is False
    monkeypatch.setenv("CIMBA_REFILL", "")
    assert start(services, serve.Service, device="cpu").refill is False
    s = start(services, serve.Service, device="cpu", poll_every=3)
    assert s.refill_every == 3


def test_refill_zero_program_cache_misses_after_warm(tiny, services):
    cache = pc.ProgramCache(capacity=64)

    def one_round():
        with serve.Service(max_wave=8, cache=cache, refill=True,
                           refill_every=1, horizon_bucket=None,
                           device="cpu") as svc:
            hs = [svc.submit(req(tiny, 2, seed=s, t_end=float(3 + s)))
                  for s in range(6)]
            out = [h.result(T) for h in hs]
            st = svc.stats()
        return out, st

    one_round()  # warms every program a refill wave dispatches
    m0 = cache.stats()["misses"]
    out, st = one_round()
    assert cache.stats()["misses"] == m0, cache.stats()
    assert st["refill"]["refill_boundaries"] > 0
    for s, res in enumerate(out):
        equal_results(res, direct(tiny, 2, cache, seed=s,
                                  t_end=float(3 + s)))


def test_refill_ownership_soak_many_threads(tiny, shared_cache):
    """16 client threads (more than the cores) with a short switch
    interval submit requests of random sizes, horizons and wave sizes to
    one refill service: every result is bitwise its direct call, and the
    lane accounting closes (no lost or doubled slot)."""
    import random
    import sys

    rng = random.Random(7)
    cases = [(rng.choice((1, 2, 3, 4)), rng.randrange(1, 50),
              rng.choice((None, 3.0, 6.0, 15.0)), rng.choice((None, 2)))
             for _ in range(32)]
    out = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with serve.Service(max_wave=8, cache=shared_cache, refill=True,
                           refill_every=1, horizon_bucket=None,
                           device="cpu") as svc:
            def client(k):
                for i in range(k, len(cases), 16):
                    R, seed, t_end, wave = cases[i]
                    out[i] = svc.submit(req(tiny, R, seed=seed, t_end=t_end,
                                            wave=wave)).result(T)

            ts = [threading.Thread(target=client, args=(k,))
                  for k in range(16)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(T)
            assert not any(t.is_alive() for t in ts)
            st = svc.stats()
    finally:
        sys.setswitchinterval(old)
    assert st["completed"] == st["submitted"] == len(cases) == len(out)
    slots = sum(-(-R // (wave or R)) for R, _, _, wave in cases)
    assert st["refill"]["refill_retirements"] == slots
    assert st["waves"] == slots
    for i, (R, seed, t_end, wave) in enumerate(cases):
        equal_results(out[i], direct(tiny, R, shared_cache, seed=seed,
                                     t_end=t_end, wave=wave))
