"""The replication mesh (``runner.experiment.make_mesh``,
``make_sharded_experiment``, ``mesh=`` on the runners and the sweep,
``obs.metrics.pool_across``, ``runner.dryrun``) on virtual CPU shards
(``make_mesh(n, device="cpu")``, the counterpart of the reference tests'
forced host-platform device count; ``tests/test_sharding.py``'s cases).

* a 4-shard run gives every lane's leaves bitwise the unsharded run's;
* ``make_sharded_experiment`` pools bitwise as the shard-ordered merge of
  the unsharded lanes' summaries, and within ``rtol`` 1e-9 of the
  reference's ``make_sharded_experiment`` on 4 of the test run's 8
  virtual devices (its compile ~10 s, shared by ``lru_cache``);
* the chunked run (checkpointed and resumed), the stream (audited: the
  trail equal to the unsharded stream's), the regrown run and the sweep
  under a mesh are bitwise the runs without one;
* a batch that does not divide over the shards raises;
* ``pool_across`` equals the reference's ``psum``/``pmax`` leg;
* the dry run's sharded arm on 8 shards (``run_dryrun(8)``'s first arm)
  meets the reference's golden pooled mean 4.112945867223963 within
  1e-9 relative, and ``run_dryrun(2, device="cpu")`` runs every arm
  (8 shards of every arm take ~60 s: the plain engine's cost a step
  does not fall with its lanes).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from cimba_tpu.models import mm1 as jmm1
from cimba_tpu.obs import metrics as jmetrics
from cimba_tpu.runner import experiment as jex
from cimba_tpu_torch import config, sweep, tree
from cimba_tpu_torch.models import mg1, mm1
from cimba_tpu_torch.obs import audit
from cimba_tpu_torch.obs import metrics as om
from cimba_tpu_torch.runner import dryrun
from cimba_tpu_torch.runner import experiment as ex
from cimba_tpu_torch.stats import summary as sm

torch.set_num_threads(1)

R, N, SEED = 16, 20, 5


@functools.lru_cache(maxsize=None)
def spec():
    return mm1.build()[0]


@functools.lru_cache(maxsize=None)
def mesh4():
    return ex.make_mesh(4, device="cpu")


@functools.lru_cache(maxsize=None)
def single():
    return ex.run_experiment(spec(), mm1.params(N), R, seed=SEED,
                             device="cpu")


def assert_bitwise(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_make_mesh(monkeypatch):
    m = ex.make_mesh(3, device="cpu")
    assert m.size == 3 and m.axis_names == ("rep",)
    assert all(d == torch.device("cpu") for d in m.devices)
    assert ex.make_mesh(device="cpu").size == 1
    assert m.bounds(6) == [(0, 2), (2, 4), (4, 6)]
    with pytest.raises(ValueError, match="positive"):
        ex.make_mesh(0, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        ex.run_experiment(spec(), mm1.params(N), R, device="cpu",
                          mesh=(torch.device("cpu"),))
    with pytest.raises(ValueError, match="device type"):
        ex.run_experiment(spec(), mm1.params(N), R, device="cpu",
                          mesh=ex.Mesh((torch.device("meta"),)))
    # no fallback: without a card the default device raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ex.make_mesh(), lambda: dryrun.run_dryrun(2),
                 lambda: ex.make_sharded_experiment(spec(), R, m),
                 lambda: ex.run_experiment(spec(), mm1.params(N), 6,
                                           mesh=m)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_mesh_run_experiment_bitwise_unsharded():
    sharded = ex.run_experiment(spec(), mm1.params(N), R, seed=SEED,
                                device="cpu", mesh=mesh4(), chunk_steps=16)
    assert int(sharded.n_failed) == 0 and sharded.launches == 0
    assert int(sharded.total_events) == int(single().total_events)
    assert_bitwise(single().sims, sharded.sims)
    # with the run report: the same lanes, the report's counts
    res, rep = ex.run_experiment(spec(), mm1.params(N), R, seed=SEED,
                                 device="cpu", mesh=mesh4(), chunk_steps=64,
                                 with_report=True)
    assert_bitwise(single().sims, res.sims)
    assert rep.total_events == int(single().total_events)
    assert rep.backend == "cpu" and rep.execute_s > 0


@functools.lru_cache(maxsize=None)
def ref_sharded():
    fn = jex.make_sharded_experiment(jmm1.build()[0], R, jex.make_mesh(4))
    return jax.block_until_ready(fn(jmm1.params(N), seed=SEED))


def test_sharded_experiment_pooled_merge():
    fn = ex.make_sharded_experiment(spec(), R, mesh4(), device="cpu",
                                    chunk_steps=16)
    pooled, n_failed, events = fn(mm1.params(N), seed=SEED)
    wait = single().sims.user["wait"]
    parts = [sm.merge_tree(sm.Summary(*[x[lo:hi] for x in wait]))
             for lo, hi in mesh4().bounds(R)]
    want = sm.merge_tree(sm.Summary(*[torch.stack(xs)
                                      for xs in zip(*parts)]))
    assert_bitwise(pooled, want)
    assert int(n_failed) == 0
    assert int(events) == int(single().total_events)
    # the event total is int64 in either profile, as the reference's sum
    # (an f32 run's i32 counts summed in i32 would wrap at full width)
    with config.profile("f32"):
        _, _, ev32 = ex.make_sharded_experiment(
            mm1.build(record=False)[0], 8, mesh4(), device="cpu")(
            mm1.params(5), seed=SEED)
    assert ev32.dtype == events.dtype == torch.int64
    # the reference's sharded experiment on 4 virtual devices
    jpooled, jfailed, jevents = ref_sharded()
    assert int(jfailed) == 0 and int(jevents) == int(events)
    for f, x, y in zip(sm.Summary._fields, pooled, jpooled):
        np.testing.assert_allclose(float(x), float(y), rtol=1e-9,
                                   err_msg=f)


def test_mesh_chunked_bitwise(tmp_path):
    s, m = spec(), mesh4()
    # chunked, checkpointed every 2 chunks, then resumed from its last
    # checkpoint, split over the mesh again
    path = str(tmp_path / "mesh.npz")
    ch = ex.run_experiment_chunked(s, mm1.params(N), R, seed=SEED,
                                   chunk_steps=8, device="cpu", mesh=m,
                                   checkpoint_path=path, checkpoint_every=2)
    assert_bitwise(single().sims, ch.sims)
    resumed = ex.run_experiment_chunked(s, mm1.params(N), R, seed=SEED,
                                        chunk_steps=8, device="cpu", mesh=m,
                                        checkpoint_path=path, resume=True)
    assert_bitwise(single().sims, resumed.sims)


def test_mesh_stream_bitwise():
    # the stream, audited: the sharded trail is the unsharded one's
    s, m = spec(), mesh4()
    kw = dict(wave_size=8, chunk_steps=16, seed=SEED, device="cpu")
    a, b = audit.Audit(), audit.Audit()
    st = ex.run_experiment_stream(s, mm1.params(N), R, audit=a, **kw)
    sh = ex.run_experiment_stream(s, mm1.params(N), R, audit=b, mesh=m,
                                  **kw)
    assert_bitwise((st.summary, st.n_failed, st.total_events),
                   (sh.summary, sh.n_failed, sh.total_events))
    assert sh.n_waves == 2
    assert audit.diff_trails(a.trail_rows(), b.trail_rows()) is None
    assert sh.audit["geometry"]["mesh"]["size"] == 4
    assert sh.audit["result_digest"] == st.audit["result_digest"]


def test_mesh_regrow_bitwise():
    # regrow: the mesh rides every run
    s, m = spec(), mesh4()
    rg, _, n = ex.run_experiment_regrow(s, mm1.params(N), R, seed=SEED,
                                        device="cpu", mesh=m)
    assert n == 0
    assert_bitwise(single().sims, rg.sims)


def test_mesh_sweep_bitwise():
    # the sweep: waves sharded, slots folded on the mesh's first device
    m = mesh4()
    g = mg1.sweep_grid(20, cvs=(0.5, 2.0), utilizations=(0.6,))
    kw = dict(reps_per_cell=6, cell_wave=4, max_wave=16, seed=2,
              chunk_steps=64, device="cpu")
    plain = sweep.run_sweep(mg1.build()[0], g, **kw)
    meshed = sweep.run_sweep(mg1.build()[0], g, mesh=m, **kw)
    assert_bitwise(plain.summaries, meshed.summaries)
    np.testing.assert_array_equal(plain.total_events, meshed.total_events)


def test_mesh_divisibility_raises():
    s, m = spec(), mesh4()
    with pytest.raises(ValueError, match="divide evenly over 4"):
        ex.run_experiment(s, mm1.params(N), 6, device="cpu", mesh=m)
    with pytest.raises(ValueError, match="divide evenly over 4"):
        ex.make_sharded_experiment(s, 6, m, device="cpu")
    with pytest.raises(ValueError, match="wave_size=6"):
        ex.run_experiment_stream(s, mm1.params(N), 12, wave_size=6,
                                 device="cpu", mesh=m)
    with pytest.raises(ValueError, match="divide evenly over 4"):
        ex.run_experiment_chunked(s, mm1.params(N), 6, device="cpu", mesh=m)
    g = mg1.sweep_grid(5, cvs=(1.0,), utilizations=(0.5,))
    with pytest.raises(ValueError, match="divide evenly over 4"):
        sweep.run_sweep(mg1.build()[0], g, reps_per_cell=6, cell_wave=6,
                        device="cpu", mesh=m)


def test_pool_across_equals_reference():
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(7)
    fields = dict(dispatch_by_kind=(3,), guard_retries=(), queue_hwm=(2,),
                  event_hwm=(), chain_hist=(om.CHAIN_BINS,))
    dts = dict(queue_hwm=np.int32, event_hwm=np.int32)
    arrs = {k: rng.integers(0, 1000, (4,) + shp).astype(dts.get(k,
                                                                np.int64))
            for k, shp in fields.items()}
    shards = [om.Metrics(**{k: torch.from_numpy(np.array(a[i]))
                            for k, a in arrs.items()}) for i in range(4)]
    got = om.pool_across(shards, "rep")

    @jex.partial(jex.shard_map, mesh=jex.make_mesh(4), in_specs=(P("rep"),),
                 out_specs=P(), check_vma=False)
    def pool(m):
        return jmetrics.pool_across(
            jmetrics.Metrics(*[x[0] for x in m]), "rep")

    want = jax.jit(pool)(jmetrics.Metrics(**arrs))
    for f, x, y in zip(om.Metrics._fields, got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f)
    # the sharded experiment's fourth output: the registry over lanes and
    # shards, equal to the pool of the unsharded lanes
    om.enable()
    try:
        fn = ex.make_sharded_experiment(spec(), 8, mesh4(), device="cpu")
        _, _, _, metrics = fn(mm1.params(10), seed=SEED)
        mono = ex.run_experiment(spec(), mm1.params(10), 8, seed=SEED,
                                 device="cpu")
        assert_bitwise(metrics, om.pool(mono.sims.metrics))
    finally:
        om.disable()
    with pytest.raises(RuntimeError, match="flipped"):
        fn(mm1.params(10), seed=SEED)


def test_dryrun_eight_shards_meets_the_golden_mean():
    # the dry run's sharded arm on 8 shards, the golden's configuration
    pooled, events = dryrun.sharded_arm(ex.make_mesh(8, device="cpu"),
                                        spec(), device="cpu")
    mean = float(sm.mean(pooled))
    assert abs(mean - dryrun.GOLDEN_MEAN_8) <= 1e-9 * dryrun.GOLDEN_MEAN_8
    assert int(events) == 28995


@functools.lru_cache(maxsize=None)
def ref_serve_mesh_events(n_devices):
    """The reference's serve-arm requests as direct streams (the serve
    arm holds each served result bitwise to the direct stream)."""
    spec, _ = jmm1.build()
    per_req = 8 * n_devices
    return sum(int(jex.run_experiment_stream(
        spec, jmm1.params(n), per_req, wave_size=per_req, chunk_steps=32,
        seed=seed).total_events) for _, n, seed in dryrun.SERVE_CASES)


def test_dryrun_runs_every_arm():
    # every arm at 2 shards: the stream, kernel and AWACS arms are each
    # bitwise their unsharded runs at 4 shards above
    out = dryrun.run_dryrun(2, device="cpu")
    assert out["stream_mesh_events"] == out["events"]
    # the serve arm: its events are the reference's
    # _dryrun_serve_mesh cases run as direct streams
    assert out["serve_mesh_events"] == ref_serve_mesh_events(2)
    assert out["kernel_mesh_events"] > 0 and out["awacs_mesh_events"] > 0
