"""The sweep engine (``cimba_tpu_torch.sweep``) against its own direct
stream calls and against the reference's (``tests/test_sweep.py``'s
cases, without its serve-backed one, on the same one-block spec).

* ``round_seed`` equals the reference's on a table of (seed, cell,
  round), seeds near 2**64 included;
* fixed-R: every cell bitwise the port's direct ``run_experiment_stream``
  call at ``seed=round_seed(seed, c, 0)``, in both profiles, with a
  cell's own waves and with slots packed into shared waves; each cell
  against the reference's ``run_sweep`` on the same grid (integers
  exact, floats within ``rtol`` 1e-9 in f64 and 2e-5 in f32), and the
  exported rows and CSV carry the reference's columns and values;
* pad-and-mask (``t_stop=-inf`` lanes) is inert;
* adaptive: the easy cell stops before the hard one, a re-run is bitwise
  the first, and ``n_reps``, ``stop_round`` and ``n_rounds`` equal the
  reference's; ``max_rounds`` reports unmet cells;
* ``replication_means`` is memoised and gives the batch-means n;
* the arguments are validated, the serve-backed paths and the unported
  knobs raise naming their modules, and the sweep's run card carries
  each cell's ``result_digest``, the direct stream's
  ``stream_result_digest`` (``tests/test_audit.py``'s sweep card);
* ``examples/mg1_sweep.py`` restated runs both arms at a tiny size.

The reference's runs are shared through ``functools.lru_cache`` (one
program cache), so each of its compiles is paid once.
"""

import functools
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cimba_tpu.random as jcr
from cimba_tpu import config as jconfig
from cimba_tpu import sweep as jsweep
from cimba_tpu.core import api as japi
from cimba_tpu.core import cmd as jcmd
from cimba_tpu.core.model import Model as JModel
from cimba_tpu.serve import cache as jpc
from cimba_tpu.stats import summary as jsm
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import sweep, tree
from cimba_tpu_torch.examples import mg1_sweep
from cimba_tpu_torch.models import mm1
from cimba_tpu_torch.obs import audit
from cimba_tpu_torch.runner import experiment as ex
from cimba_tpu_torch.stats import summary as tsm
from cimba_tpu_torch.tools import usergen

torch.set_num_threads(1)

RTOL = {"f64": 1e-9, "f32": 2e-5}


def port_spec():
    """The reference test's one-block model (``usergen.sweep_spec``): one
    process drawing exp(step_mean) holds, each draw a sample of
    ``wait``, until ``n_steps`` samples."""
    return usergen.sweep_spec(usergen.torch_lib())


def ref_spec():
    m = JModel("tinysweep", event_cap=1, guard_cap=2)

    @m.user_state
    def ui(params):
        step_mean, n_steps = params
        return {"step_mean": jnp.asarray(step_mean, jconfig.REAL),
                "n_steps": jnp.asarray(n_steps, jnp.int32),
                "wait": jsm.empty()}

    @m.block
    def work(sim, p, sig):
        sim, t = japi.draw(sim, jcr.exponential, sim.user["step_mean"])
        wait = jsm.add(sim.user["wait"], t)
        sim = japi.set_user(sim, {**sim.user, "wait": wait})
        sim = japi.stop(sim,
                        wait.n >= sim.user["n_steps"].astype(wait.n.dtype))
        return sim, jcmd.hold(t, next_pc=work.pc)

    m.process("w", entry=work)
    return m.build()


def _row(n_steps):
    return lambda step_mean: (np.float64(step_mean), np.int32(n_steps))


def grid(means=(0.1, 1.0, 2.5), n_steps=12, mod=sweep):
    return mod.SweepGrid({"step_mean": means}, _row(n_steps), name="tiny")


@functools.lru_cache(maxsize=None)
def tiny(prof):
    with tconfig.profile(prof):
        return port_spec()


@functools.lru_cache(maxsize=None)
def jtiny(prof):
    with jconfig.profile(prof):
        return ref_spec()


@functools.lru_cache(maxsize=None)
def jcache():
    return jpc.ProgramCache(capacity=256)


@functools.lru_cache(maxsize=None)
def ref_sweep(prof, means, n_steps, reps, seed, cell_wave, max_wave,
              chunk, stop=None, max_rounds=32):
    """The reference's ``run_sweep`` on the grid (one compile each)."""
    with jconfig.profile(prof):
        rule = None if stop is None else jsweep.HalfwidthTarget(*stop)
        return jsweep.run_sweep(
            jtiny(prof), grid(means, n_steps, jsweep), reps_per_cell=reps,
            stop=rule, max_rounds=max_rounds, seed=seed, cell_wave=cell_wave,
            max_wave=max_wave, chunk_steps=chunk, program_cache=jcache())


def port_sweep(prof, means, n_steps, reps, seed, cell_wave, max_wave, chunk,
               stop=None, max_rounds=32, **kw):
    with tconfig.profile(prof):
        rule = None if stop is None else sweep.HalfwidthTarget(*stop)
        return sweep.run_sweep(
            tiny(prof), grid(means, n_steps), reps_per_cell=reps, stop=rule,
            max_rounds=max_rounds, seed=seed, cell_wave=cell_wave,
            max_wave=max_wave, chunk_steps=chunk, device="cpu", **kw)


def direct(prof, row, reps, wave, chunk, seed, **kw):
    with tconfig.profile(prof):
        return ex.run_experiment_stream(
            tiny(prof), row, reps, wave_size=wave, chunk_steps=chunk,
            seed=seed, device="cpu", **kw)


def assert_bitwise(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def assert_near_ref(port_summary, ref_summary, prof):
    for f, x, y in zip(tsm.Summary._fields, port_summary, ref_summary):
        np.testing.assert_allclose(x.double().numpy(),
                                   np.asarray(y, np.float64),
                                   rtol=RTOL[prof], err_msg=f)


# --- round_seed ------------------------------------------------------------


def test_round_seed_equals_reference():
    seeds = (0, 1, 5, 2026, 2**32 - 1, 2**32, 2**63 - 1, 2**63,
             2**64 - 2, 2**64 - 1)
    for s in seeds:
        for c in (0, 1, 7, 19, 1000):
            for r in (0, 1, 2, 23, 31):
                want = jsweep.round_seed(s, c, r)
                assert sweep.round_seed(s, c, r) == want, (s, c, r)
                assert 0 <= want < 2**64
    assert sweep.round_seed(3, 2) == jsweep.round_seed(3, 2, 0)


# --- fixed-R ---------------------------------------------------------------


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("max_wave", [16, 4])
def test_fixed_r_cells_bitwise_direct_stream(prof, max_wave):
    """Whole slots, ragged tails, and with max_wave=16 several cells'
    slots packed into one physical wave: every cell bitwise its direct
    stream call."""
    g = grid()
    res = port_sweep(prof, (0.1, 1.0, 2.5), 12, 6, 5, 4, max_wave, 8)
    assert res.met is None and (res.stop_round == -1).all()
    assert res.n_rounds == 1
    if max_wave == 16:
        assert res.occupancy["waves"] < 6  # packing really happened
    else:
        assert res.occupancy["waves"] == 6
    for i in range(g.n_cells):
        d = direct(prof, g.cell_row(i), 6, 4, 8, sweep.round_seed(5, i, 0))
        assert_bitwise(res.cell_summary(i), d.summary)
        assert int(res.n_failed[i]) == int(d.n_failed)
        assert int(res.total_events[i]) == int(d.total_events)


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_cells_against_reference_run_sweep(prof):
    args = (prof, (0.2, 1.5), 10, 6, 3, 4, 16, 8)
    res, ref = port_sweep(*args), ref_sweep(*args)
    for i in range(res.n_cells):
        assert_near_ref(res.cell_summary(i), ref.cell_summary(i), prof)
    np.testing.assert_array_equal(res.n_failed, np.asarray(ref.n_failed))
    np.testing.assert_array_equal(res.total_events,
                                  np.asarray(ref.total_events))
    np.testing.assert_array_equal(res.n_reps, np.asarray(ref.n_reps))
    np.testing.assert_allclose(res.halfwidth, np.asarray(ref.halfwidth),
                               rtol=RTOL[prof])
    assert res.occupancy == ref.occupancy


def test_pad_and_mask_waves_bitwise_inert():
    kw = dict(prof="f64", means=(0.1, 1.0, 2.5), n_steps=12, reps=6,
              seed=7, cell_wave=4, max_wave=32, chunk=8)
    padded = port_sweep(pad_waves=True, **kw)
    plain = port_sweep(pad_waves=False, **kw)
    assert padded.occupancy["lanes_padded"] > 0
    assert plain.occupancy["lanes_padded"] == 0
    assert 0.0 < padded.occupancy["padding_waste_frac"] < 1.0
    assert_bitwise(padded.summaries, plain.summaries)
    np.testing.assert_array_equal(padded.n_failed, plain.n_failed)
    np.testing.assert_array_equal(padded.total_events, plain.total_events)


# --- adaptive --------------------------------------------------------------


def test_adaptive_easy_stops_before_hard_and_reproduces():
    args = ("f64", (0.1, 0.6), 16, 8, 7, 8, 32, 16, (0.05, False, 0.95, 4),
            20)
    res = port_sweep(*args)
    assert res.met is not None and res.met.all(), (res.halfwidth,
                                                    res.n_reps)
    assert 0 <= res.stop_round[0] < res.stop_round[1]
    assert res.n_reps[0] < res.n_reps[1]
    assert res.n_reps[1] > 4  # redistributed after cell 0 stopped
    assert (res.halfwidth <= 0.05).all()
    twin = port_sweep(*args)
    assert_bitwise(res.summaries, twin.summaries)
    np.testing.assert_array_equal(res.stop_round, twin.stop_round)
    np.testing.assert_array_equal(res.n_reps, twin.n_reps)
    ref = ref_sweep(*args)
    np.testing.assert_array_equal(res.n_reps, np.asarray(ref.n_reps))
    np.testing.assert_array_equal(res.stop_round,
                                  np.asarray(ref.stop_round))
    assert res.n_rounds == ref.n_rounds
    assert_near_ref(res.summaries, ref.summaries, "f64")


def test_adaptive_max_rounds_reports_unmet():
    res = port_sweep("f64", (2.0,), 8, 4, 1, 4, 4096, 8,
                     (1e-6, False, 0.95, 4), 2)
    assert res.n_rounds == 2
    assert not res.met.any()
    assert (res.stop_round == -1).all()
    assert (res.halfwidth > 1e-6).all()
    assert int(res.n_reps[0]) == 8


def test_replication_means_batch_ci():
    assert sweep.replication_means() is sweep.replication_means()
    path = sweep.replication_means()
    args = ("f64", (0.5, 2.0), 8, 6, 4, 6, 4096, 8)
    res = port_sweep(*args, summary_path=path)
    # n = replications, not the pooled samples within them
    assert res.summaries.n.tolist() == [6.0, 6.0]
    g = grid((0.5, 2.0), 8)
    for i in range(g.n_cells):
        d = direct("f64", g.cell_row(i), 6, 6, 8, sweep.round_seed(4, i, 0),
                   summary_path=path)
        assert_bitwise(res.cell_summary(i), d.summary)
    pooled = port_sweep(*args)
    assert (res.halfwidth > pooled.halfwidth).all()


# --- export ----------------------------------------------------------------


def test_sweep_result_rows_and_csv_match_reference():
    args = ("f64", (0.2, 1.5), 10, 6, 3, 4, 16, 8)
    res, ref = port_sweep(*args), ref_sweep(*args)
    rows, ref_rows = res.rows(), ref.rows()
    assert [list(r) for r in rows] == [list(r) for r in ref_rows]
    for r, q in zip(rows, ref_rows):
        for k in r:
            if isinstance(q[k], float):
                np.testing.assert_allclose(r[k], q[k], rtol=1e-9,
                                           err_msg=k)
            else:
                assert r[k] == q[k], k
    buf = io.StringIO()
    res.to_csv(buf)
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 3 and lines[0].startswith("step_mean,")
    # an axis named like a statistic keeps its column; the statistic
    # moves to stat_<name>
    g2 = sweep.SweepGrid({"mean": (0.5,)},
                         lambda mean: (np.float64(mean), np.int32(4)))
    r2 = sweep.run_sweep(tiny("f64"), g2, reps_per_cell=2, seed=2,
                         cell_wave=2, chunk_steps=8, device="cpu")
    row = r2.rows()[0]
    assert row["mean"] == 0.5 and "stat_mean" in row


# --- arguments and refusals --------------------------------------------------


def test_run_sweep_validates_arguments(monkeypatch):
    spec, g = tiny("f64"), grid((1.0,))
    with pytest.raises(ValueError, match="reps_per_cell"):
        sweep.run_sweep(spec, g, reps_per_cell=0, device="cpu")
    with pytest.raises(ValueError, match="cell_wave"):
        sweep.run_sweep(spec, g, reps_per_cell=4, cell_wave=64,
                        max_wave=32, device="cpu")
    with pytest.raises(ValueError, match="max_rounds"):
        sweep.run_sweep(spec, g, reps_per_cell=4, max_rounds=0,
                        stop=sweep.HalfwidthTarget(1.0), device="cpu")
    with pytest.raises(ValueError, match="target"):
        sweep.HalfwidthTarget(target=0.0)
    with pytest.raises(ValueError, match="confidence"):
        sweep.HalfwidthTarget(target=1.0, confidence=1.5)
    with pytest.raises(ValueError, match="summary_path"):
        sweep.run_sweep(spec, g, reps_per_cell=2, device="cpu",
                        summary_path=lambda s: s.user["nope"])
    bad = sweep.SweepGrid({"a": (0, 1)},
                          lambda a: (1.0,) if a == 0 else (1.0, 2.0))
    with pytest.raises(ValueError, match="structure"):
        sweep.run_sweep(spec, bad, reps_per_cell=2, device="cpu")
    # no fallback: without a card only device="cpu" runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.run_sweep(spec, g, reps_per_cell=2)


def test_unported_paths_raise_naming_their_modules():
    # telemetry= (obs/telemetry.py), the serve-backed sweep,
    # program_cache= and run_fused_sweeps are ported: each is bitwise the
    # direct engine's fixed-R run
    from cimba_tpu_torch import serve
    from cimba_tpu_torch.obs import telemetry as tm

    spec, g = tiny("f64"), grid((1.0, 2.5))
    args = ("f64", (1.0, 2.5), 12, 6, 5, 4, 16, 8)
    want = port_sweep(*args)
    tel = tm.Telemetry(interval=0, spans=True)
    ticked = port_sweep(*args, telemetry=tel)
    assert tel.registry.get_sample(tm.METRIC_PREFIX + "ticks_total",
                                   source="sweep.round") == 1.0
    assert tel.spans.open_count() == 0
    tel.close()
    with serve.Service(max_wave=16, device="cpu") as svc:
        with pytest.raises(ValueError, match="mesh=/program_cache="):
            port_sweep(*args, service=svc, program_cache={})
        got = port_sweep(*args, service=svc)
    cached = port_sweep(*args, program_cache={})
    fused = sweep.run_fused_sweeps(
        [(spec, grid((1.0, 2.5)))], reps_per_cell=6, seed=5, cell_wave=4,
        max_wave=16, chunk_steps=8, device="cpu")[0]
    for res in (got, cached, fused, ticked):
        for x, y in zip(tree.leaves((res.summaries,
                                     torch.as_tensor(res.n_failed),
                                     torch.as_tensor(res.total_events))),
                        tree.leaves((want.summaries,
                                     torch.as_tensor(want.n_failed),
                                     torch.as_tensor(want.total_events)))):
            assert torch.equal(x, y)
    assert got.occupancy["serve"]["batches"] >= 1
    assert set(sweep.__all__) == set(jsweep.__all__)


# --- the sweep's run card ----------------------------------------------------


def test_sweep_audit_card_per_cell_digests():
    spec = mm1.build(record=False)[0]
    g = sweep.SweepGrid(
        {"rho": (0.5, 0.9)},
        lambda rho: (np.float64(1.0 / rho), np.float64(1.0), np.int32(30)),
        name="mm1_audit")
    res = sweep.run_sweep(spec, g, reps_per_cell=8, cell_wave=8,
                          max_wave=16, chunk_steps=64, seed=3, audit=True,
                          device="cpu")
    card = res.audit
    assert card is not None and card["kind"] == "sweep"
    assert len(card["cells"]) == 2
    assert card["geometry"]["n_rounds"] == 1
    assert card["card_digest"] == audit.card_digest(card)
    for c, cell in enumerate(card["cells"]):
        assert cell["cell"] == g.cell_label(c)
        assert cell["seeds"] == [sweep.round_seed(3, c, 0)]
        assert cell["reps"] == 8 and cell["stop_round"] == -1
        d = ex.run_experiment_stream(spec, g.cell_row(c), 8, wave_size=8,
                                     chunk_steps=64,
                                     seed=sweep.round_seed(3, c, 0),
                                     device="cpu")
        assert cell["result_digest"] == audit.stream_result_digest(d)


def test_mg1_sweep_example():
    mono, res = mg1_sweep.main(
        n_objects=40, reps_per_cell=2, adaptive_objects=40, adaptive_reps=4,
        target=0.5, max_rounds=2, chunk_steps=256, cvs=(0.5, 1.0),
        utilizations=(0.5, 0.8), device="cpu")
    assert len(mono) == 4 and res.n_cells == 4
    assert 1 <= res.n_rounds <= 2 and (res.n_reps >= 4).all()
