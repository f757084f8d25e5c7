"""The serve layer on the card (skips without one): ``chip_smoke.py``
phase 16's checks at small R.

Run on a machine with an NVIDIA card:

    python -m pytest --noconftest tests/test_torch_cuda_serve.py -m cuda -q

* served mm1 requests packed into one wave through the hand-written K1,
  each bitwise its direct ``run_experiment_stream`` (digest, events,
  failures), with zero program-cache misses after ``serve.warm`` and the
  K1 launches counted;
* a fused wave of three ``usergen.fuse_spec`` models through the
  superspec's generated K1, each result bitwise its solo direct call;
* refill with mixed horizons: a short request's lanes retire mid-wave, a
  queued one is spliced in, each result bitwise its direct call;
* the kernel-path contract: a request with the metrics registry on
  raises at submit, naming the route.
"""

import threading

import pytest
import torch

from cimba_tpu_torch import serve
from cimba_tpu_torch.core import kernel_run
from cimba_tpu_torch.models import mm1
from cimba_tpu_torch.obs import audit
from cimba_tpu_torch.obs import metrics as om
from cimba_tpu_torch.runner import experiment as ex
from cimba_tpu_torch.stats import summary as sm
from cimba_tpu_torch.tools import usergen

pytestmark = pytest.mark.cuda

T = 300


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    yield torch.device("cuda")
    om.disable()


def clock_path(sims):
    return sm.add(sm.empty(sims.clock.shape, sims.clock.device), sims.clock)


def same(res, want):
    assert audit.stream_result_digest(res) == audit.stream_result_digest(want)
    assert int(res.total_events) == int(want.total_events)
    assert int(res.n_failed) == int(want.n_failed) == 0


def launches():
    return (kernel_run.queue_chunk.launches + kernel_run.gen_chunk.launches
            + kernel_run.awacs_chunk.launches)


@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_served_mm1_bitwise_direct_and_no_misses_after_warm(card, prof):
    from cimba_tpu_torch import config

    with config.profile(prof):
        spec = mm1.build(record=False)[0]
        cache = serve.ProgramCache()
        serve.warm(cache, spec, mm1.params(1), 1024, chunk_steps=256,
                   seed=5)
        m0 = cache.stats()["misses"]
        n0 = launches()
        cases = [(200, 5), (300, 5), (200, 9), (250, 7)]
        with serve.Service(max_wave=4096, cache=cache) as svc:
            hs = [svc.submit(serve.Request(spec, mm1.params(n), 1024,
                                           seed=s, wave_size=1024,
                                           chunk_steps=256))
                  for n, s in cases]
            got = [h.result(T) for h in hs]
        assert launches() > n0
        assert cache.stats()["misses"] == m0
        for (n, s), res in zip(cases, got):
            same(res, ex.run_experiment_stream(
                spec, mm1.params(n), 1024, wave_size=1024, chunk_steps=256,
                seed=s, program_cache=cache))


def test_fused_wave_bitwise_solo(card):
    lib = usergen.torch_lib()
    specs = [usergen.fuse_spec(lib, i, 64.0) for i in range(3)]
    cache = serve.ProgramCache()
    solo = [ex.run_experiment_stream(s, (), 256, chunk_steps=32,
                                     seed=11 + i, summary_path=clock_path,
                                     program_cache=cache)
            for i, s in enumerate(specs)]

    class Gated(serve.Service):
        def __init__(self, **kw):
            self.gate = threading.Event()
            super().__init__(**kw)

        def _serve_refill_wave(self, lead):
            assert self.gate.wait(T)
            return super()._serve_refill_wave(lead)

    svc = Gated(max_wave=1024, cache=cache, refill=True, refill_every=1,
                horizon_bucket=None, fuse=True, fuse_max_specs=3)
    try:
        g0 = kernel_run.gen_chunk.launches
        hs = [svc.submit(serve.Request(s, (), 256, seed=11 + i,
                                       wave_size=256, chunk_steps=32,
                                       summary_path=clock_path))
              for i, s in enumerate(specs)]
        svc.gate.set()
        got = [h.result(T) for h in hs]
        st = svc.stats()
    finally:
        svc.gate.set()
        svc.shutdown()
    assert st["fusion"]["fused_waves"] >= 1
    assert st["fusion"]["roster_sizes"] == [3]
    assert kernel_run.gen_chunk.launches > g0
    for res, want in zip(got, solo):
        same(res, want)


def test_refill_mixed_horizon_bitwise(card):
    spec = mm1.build(record=False)[0]
    cache = serve.ProgramCache()
    cases = [("long", 400, 3, None), ("short", 400, 4, 20.0),
             ("late", 300, 5, 60.0)]
    with serve.Service(max_wave=2048, cache=cache, refill=True,
                       refill_every=1, horizon_bucket=None) as svc:
        hs = {}
        for label, n, s, t_end in cases[:2]:
            hs[label] = svc.submit(serve.Request(
                spec, mm1.params(n), 1024, seed=s, t_end=t_end,
                wave_size=1024, chunk_steps=64, label=label))
        hs["late"] = svc.submit(serve.Request(
            spec, mm1.params(300), 1024, seed=5, t_end=60.0,
            wave_size=1024, chunk_steps=64, label="late"))
        got = {k: h.result(T) for k, h in hs.items()}
        st = svc.stats()
    assert st["refill"]["refill_boundaries"] > 0
    for label, n, s, t_end in cases:
        same(got[label], ex.run_experiment_stream(
            spec, mm1.params(n), 1024, wave_size=1024, chunk_steps=64,
            seed=s, t_end=t_end, program_cache=cache))


def test_kernel_path_contract_at_submit(card):
    spec = mm1.build(record=False)[0]
    with serve.Service(max_wave=64) as svc:
        om.enable()
        try:
            with pytest.raises(RuntimeError, match="serve.Service"):
                svc.submit(serve.Request(spec, mm1.params(10), 64))
        finally:
            om.disable()
