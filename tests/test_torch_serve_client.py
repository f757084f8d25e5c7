"""The port's load generators (``cimba_tpu_torch.serve.client``) against the
reference's (``cimba_tpu.serve.client``).

``percentile`` equals the reference's on random samples and the edge
cases; ``mixed_requests`` interleaves a weighted template mix in the
reference's order with its labels; ``run_load`` (a burst and an open-loop
schedule from several client threads) and ``run_mixed_load`` report every
request completed, each result bitwise its template's direct call,
latencies in arrival order, per-template percentiles, and admission
rejects counted by class.  Services run on the CPU, shut down by their
context; torch runs on one thread.
"""

import math
import random

import pytest
import torch

from cimba_tpu.serve import client as jclient
from cimba_tpu_torch import serve
from cimba_tpu_torch.core import api, process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.obs import audit
from cimba_tpu_torch.runner import experiment as ex
from cimba_tpu_torch.serve import client
from cimba_tpu_torch.stats import summary as sm

torch.set_num_threads(1)

T = 60


def tiny_spec(t_stop=12.0):
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


def test_percentile_equals_reference():
    rng = random.Random(5)
    for n in (1, 2, 3, 7, 50, 101):
        xs = [rng.expovariate(1.0) for _ in range(n)]
        for q in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
            assert client.percentile(xs, q) == jclient.percentile(xs, q)
    assert math.isnan(client.percentile([], 50))
    assert client.percentile([3.0, 1.0, 2.0], 50) == 2.0


def templates(spec):
    def req(seed, R=4, t_end=None):
        return serve.Request(spec, (), R, seed=seed, t_end=t_end,
                             wave_size=R, chunk_steps=8,
                             summary_path=clock_path)

    return [client.RequestTemplate("a", req(11), 2.0),
            client.RequestTemplate("b", req(22, R=2), 1.0),
            client.RequestTemplate("short", req(33, t_end=5.0), 1.0)]


def test_mixed_requests_order_equals_reference():
    spec = tiny_spec()
    ts = templates(spec)
    reqs, names = client.mixed_requests(ts, 9)
    jts = [jclient.RequestTemplate(t.name, t.request, t.weight) for t in ts]
    jreqs, jnames = jclient.mixed_requests(jts, 9)
    assert names == jnames
    assert [r.label for r in reqs] == [r.label for r in jreqs]
    assert names.count("a") == 5 and names.count("b") == 2
    with pytest.raises(ValueError, match="weight"):
        client.mixed_requests([client.RequestTemplate("z", ts[0].request,
                                                      0.0)], 2)
    with pytest.raises(ValueError, match="template"):
        client.mixed_requests([], 2)


def test_run_load_and_mixed_load_reports():
    spec = tiny_spec()
    cache = serve.ProgramCache()
    ts = templates(spec)
    want = {t.name: audit.stream_result_digest(ex.run_experiment_stream(
        spec, (), t.request.n_replications, wave_size=t.request.wave_size,
        chunk_steps=8, seed=t.request.seed, t_end=t.request.t_end,
        summary_path=clock_path, program_cache=cache, device="cpu"))
        for t in ts}
    with serve.Service(max_wave=16, cache=cache, device="cpu") as svc:
        burst = client.run_load(svc, [ts[0].request] * 6, n_clients=3,
                                result_timeout=T)
        mixed = client.run_mixed_load(svc, ts, 8, n_clients=2,
                                      inter_arrival_s=0.002,
                                      result_timeout=T)
    assert burst.n_completed == burst.n_requests == 6 and not burst.errors
    assert [i for i, _ in burst.results] == list(range(6))
    assert burst.total_replications == 24
    assert burst.replications_per_sec > 0
    for _, res in burst.results:
        assert audit.stream_result_digest(res) == want["a"]
    summ = burst.summary()
    assert summ["completed"] == 6 and summ["p50_s"] <= summ["max_s"]
    assert set(summ) >= {"requests", "completed", "wall_s",
                         "replications_per_sec", "errors", "p50_s",
                         "p95_s", "p99_s", "max_s"}
    assert mixed.n_completed == 8
    for i, res in mixed.results:
        assert audit.stream_result_digest(res) == \
            want[mixed.template_names[i]]
    per = mixed.per_template()
    assert sum(v["count"] for v in per.values()) == 8
    assert all(v["completed"] == v["count"] for v in per.values())
    assert set(mixed.per_tenant()) == {"default"}
    with pytest.raises(ValueError, match="run_mixed_load"):
        burst.per_template()


def test_run_load_counts_rejects_by_class():
    spec = tiny_spec()
    req = serve.Request(spec, (), 4, chunk_steps=8, summary_path=clock_path)
    bad = serve.Request(spec, (), 64, wave_size=64, chunk_steps=8,
                        summary_path=clock_path)  # past max_wave
    with serve.Service(max_wave=16, device="cpu") as svc:
        rep = client.run_load(svc, [req, bad, req], n_clients=1,
                              result_timeout=T)
    assert rep.n_completed == 2 and rep.errors == {"ValueError": 1}
