"""The sweep engine and the replication mesh on the card (skips without
one): ``chip_smoke.py`` phase 15's checks at small R.

Run on a machine with an NVIDIA card:

    python -m pytest --noconftest tests/test_torch_cuda_sweep.py -m cuda -q

* a fixed-R M/G/1 sweep through mg1's K1: every cell bitwise its direct
  ``run_experiment_stream`` at ``round_seed(seed, c, 0)``, the run card's
  per-cell digest the stream's ``stream_result_digest``;
* an adaptive sweep reproduces bit for bit;
* pad-and-mask is inert on mg1 and on the generated one-block spec
  (``usergen.sweep_spec``), whose cells meet the plain engine on the card;
* two shards on one card: ``run_experiment(mesh=)`` bitwise the unsharded
  run, the sharded experiment's pooled summary the shards'
  ``merge_tree``, the mesh stream and the mesh sweep bitwise the unsharded
  ones; ``run_dryrun(2)`` on that mesh;
* the kernel-path contract under a mesh: the registry on raises, naming
  the route.
"""

import numpy as np
import pytest
import torch

from cimba_tpu_torch import config, sweep, tree
from cimba_tpu_torch.core import kernel_run, loop
from cimba_tpu_torch.models import mg1, mm1
from cimba_tpu_torch.obs import audit
from cimba_tpu_torch.obs import metrics as om
from cimba_tpu_torch.runner import dryrun
from cimba_tpu_torch.runner import experiment as ex
from cimba_tpu_torch.stats import summary as sm
from cimba_tpu_torch.tools import usergen

pytestmark = pytest.mark.cuda

RTOL = {"f32": 2e-5, "f64": 1e-12}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    yield torch.device("cuda")
    om.disable()


def launches():
    return (kernel_run.queue_chunk.launches + kernel_run.gen_chunk.launches
            + kernel_run.awacs_chunk.launches)


def assert_bitwise(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())


def grid():
    return mg1.sweep_grid(300, cvs=(0.5, 2.0), utilizations=(0.5, 0.9))


@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_fixed_sweep_bitwise_direct_streams(card, prof):
    with config.profile(prof):
        spec, g = mg1.build()[0], grid()
        n0 = launches()
        res = sweep.run_sweep(spec, g, reps_per_cell=256, cell_wave=128,
                              max_wave=1024, seed=2026, audit=True)
        assert res.launches == launches() - n0 > 0
        assert int(res.n_failed.sum()) == 0
        for c in range(g.n_cells):
            d = ex.run_experiment_stream(
                spec, g.cell_row(c), 256, wave_size=128,
                seed=sweep.round_seed(2026, c, 0), chunk_steps=1024)
            assert_bitwise(res.cell_summary(c), d.summary)
            assert int(res.total_events[c]) == int(d.total_events)
            assert res.audit["cells"][c]["result_digest"] == \
                audit.stream_result_digest(d)


def test_adaptive_sweep_reproduces(card):
    spec, g = mg1.build()[0], grid()
    # replication means: cells stop over several rounds (the pooled
    # sample meets this target in round 0), so the re-run holds the
    # redistribution and the round seeds past round 0
    kw = dict(reps_per_cell=64, cell_wave=64, max_wave=512, seed=7,
              stop=sweep.HalfwidthTarget(0.05, relative=True),
              max_rounds=6, summary_path=sweep.replication_means())
    a = sweep.run_sweep(spec, g, **kw)
    b = sweep.run_sweep(spec, g, **kw)
    assert a.n_rounds > 1 and len(set(a.stop_round.tolist())) > 1
    assert_bitwise(a.summaries, b.summaries)
    np.testing.assert_array_equal(a.n_reps, b.n_reps)
    np.testing.assert_array_equal(a.stop_round, b.stop_round)
    assert a.n_rounds == b.n_rounds
    means = a.summaries.m1.double().cpu().numpy()
    assert (a.halfwidth[a.met] <= 0.05 * np.abs(means[a.met])).all()


@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_pad_and_mask_inert_and_generated_spec_vs_plain(card, prof):
    with config.profile(prof):
        tiny = usergen.sweep_spec(usergen.torch_lib())
        tg = sweep.SweepGrid(
            {"step_mean": (0.1, 1.0, 2.5)},
            lambda step_mean: (np.float64(step_mean), np.int32(12)),
            name="tiny")
        for spec, g, reps, mw in ((mg1.build()[0], grid(), 60, 512),
                                  (tiny, tg, 300, 1024)):
            pad = sweep.run_sweep(spec, g, reps_per_cell=reps, max_wave=mw,
                                  seed=3, pad_waves=True)
            plain = sweep.run_sweep(spec, g, reps_per_cell=reps,
                                    max_wave=mw, seed=3)
            assert pad.occupancy["lanes_padded"] > 0
            assert_bitwise(pad.summaries, plain.summaries)
        for c in range(tg.n_cells):
            s0 = loop.init_sim(
                tiny, ex._seed_column(sweep.round_seed(3, c, 0), 300, card),
                torch.arange(300), ex._slice_params(tg.cell_row(c), 300, 0,
                                                    300), device=card)
            acc = ex._fold(ex.stream_acc(tiny, False, card),
                           loop.make_run(tiny)(s0), ex.default_summary_path)
            assert int(acc[2]) == int(plain.total_events[c])
            for x, y in zip(plain.cell_summary(c), acc[0]):
                np.testing.assert_allclose(float(x), float(y),
                                           rtol=RTOL[prof])


def test_mesh_of_two_shards_on_one_card(card):
    mesh = ex.Mesh((card, card))
    spec, params, R = mm1.build(record=False)[0], mm1.params(200), 4096
    one = ex.run_experiment(spec, params, R, seed=11)
    two = ex.run_experiment(spec, params, R, seed=11, mesh=mesh)
    assert two.launches > 0
    assert_bitwise(one.sims, two.sims)
    wait = one.sims.user["wait"]
    parts = [sm.merge_tree(sm.Summary(*[x[lo:hi] for x in wait]))
             for lo, hi in mesh.bounds(R)]
    want = sm.merge_tree(sm.Summary(*[torch.stack(xs)
                                      for xs in zip(*parts)]))
    pooled, n_failed, events = ex.make_sharded_experiment(spec, R, mesh)(
        params, seed=11)
    assert_bitwise(pooled, want)
    assert int(n_failed) == 0 and int(events) == int(one.total_events)
    kw = dict(wave_size=1024, seed=11)
    a = ex.run_experiment_stream(spec, params, R, **kw)
    b = ex.run_experiment_stream(spec, params, R, mesh=mesh, **kw)
    assert_bitwise((a.summary, a.total_events), (b.summary, b.total_events))
    g = grid()
    kw = dict(reps_per_cell=64, cell_wave=32, max_wave=256, seed=5)
    assert_bitwise(sweep.run_sweep(mg1.build()[0], g, **kw).summaries,
                   sweep.run_sweep(mg1.build()[0], g, mesh=mesh,
                                   **kw).summaries)
    out = dryrun.run_dryrun(2, mesh=mesh)
    assert out["stream_mesh_events"] == out["events"] > 0
    assert ex.make_mesh().size == torch.cuda.device_count()


def test_mesh_on_the_card_refuses_the_registry(card):
    mesh = ex.Mesh((card, card))
    spec = mm1.build(record=False)[0]
    om.enable()
    with pytest.raises(RuntimeError, match=r"run_experiment\(mesh=\) on the"):
        ex.run_experiment(spec, mm1.params(10), 64, mesh=mesh)
    with pytest.raises(RuntimeError, match="make_sharded_experiment on the"):
        ex.make_sharded_experiment(spec, 64, mesh)
    with pytest.raises(RuntimeError, match="run_sweep on the"):
        sweep.run_sweep(spec, mg1.sweep_grid(10, cvs=(1.0,),
                                             utilizations=(0.5,)),
                        reps_per_cell=2)
