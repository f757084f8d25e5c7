"""``run_experiment_stream`` in the port against the reference's.

mm1, 32 replications of 40 objects in waves of 8, seed 11, chunks of 37
events (``tests/test_stream.py``'s configuration).  ``n_waves``,
``n_failed`` and ``total_events`` must equal the reference's and the
port's monolithic run's exactly; the pooled summary must equal, bit for
bit, the fold oracle of the port's own monolithic run (each wave's lanes
pooled by ``merge_tree``, the pools merged in wave order), and lie
within 1e-12 of the reference's streamed summary.  Then a horizon
(``t_end`` riding as each lane's ``t_stop``), the M/G/1 sweep in a
ragged last wave, and a wave-granular regrow: the burst spec of
``tests/test_regrow.py`` overflows in its first wave, runs it again at a
doubled cap and keeps the cap for the later waves.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from cimba_tpu.models import mm1 as jmm1
from cimba_tpu.runner import experiment as jex
from cimba_tpu_torch import tree
from cimba_tpu_torch.models import mg1 as tmg1
from cimba_tpu_torch.models import mm1 as tmm1
from cimba_tpu_torch.runner import experiment as tex
from cimba_tpu_torch.stats import summary as sm
from cimba_tpu_torch.tools import usergen

torch.set_num_threads(1)

_R, _WAVE, _N, _SEED = 32, 8, 40, 11


@functools.lru_cache(maxsize=None)
def ref_stream():
    spec, _ = jmm1.build(record=False)
    st = jex.run_experiment_stream(spec, jmm1.params(_N), _R,
                                   wave_size=_WAVE, chunk_steps=37,
                                   seed=_SEED)
    return (st.n_waves, int(st.n_failed), int(st.total_events),
            [float(x) for x in jax.tree.leaves(st.summary)])


def fold_oracle(summaries, wave):
    """Each wave's lanes pooled by merge_tree, merged in wave order."""
    acc = None
    n = summaries.n.shape[0]
    for lo in range(0, n, wave):
        pooled = sm.merge_tree(sm.Summary(*[x[lo:lo + wave]
                                            for x in summaries]))
        acc = pooled if acc is None else sm.merge(acc, pooled)
    return acc


def test_stream_matches_reference_and_fold_oracle():
    spec, _ = tmm1.build(record=False)
    mono = tex.run_experiment(spec, tmm1.params(_N), _R, seed=_SEED,
                              device="cpu")
    waves = []
    st = tex.run_experiment_stream(
        spec, tmm1.params(_N), _R, wave_size=_WAVE, chunk_steps=37,
        seed=_SEED, device="cpu",
        on_wave=lambda w, lanes: waves.append((w, lanes)))
    assert waves == [(1, 8), (2, 16), (3, 24), (4, 32)]
    n_waves, n_failed, events, ref_summary = ref_stream()
    assert (st.n_waves, int(st.n_failed), int(st.total_events)) == (
        n_waves, n_failed, events)
    assert int(st.total_events) == int(mono.total_events)
    assert st.total_events.dtype == torch.int64 and st.n_regrows == 0
    # bit for bit the fold of the monolithic run's per-wave pools, which
    # starts from sm.empty() as the stream's accumulator does
    oracle = sm.merge(sm.empty((), "cpu"),
                      fold_oracle(mono.sims.user["wait"], _WAVE))
    for x, y in zip(st.summary, oracle):
        assert torch.equal(x, y)
    np.testing.assert_allclose([float(x) for x in st.summary], ref_summary,
                               rtol=1e-12)


def test_stream_with_horizon_and_ragged_sweep():
    spec, _ = tmm1.build(record=False)
    st = tex.run_experiment_stream(spec, tmm1.params(_N), 12, wave_size=5,
                                   t_end=15.0, seed=3, device="cpu")
    mono = tex.run_experiment(spec, tmm1.params(_N), 12, t_end=15.0,
                              seed=3, device="cpu")
    assert st.n_waves == 3  # 5 + 5 + 2
    assert int(st.total_events) == int(mono.total_events)
    assert float(st.summary.n) == float(mono.sims.user["wait"].n.sum())
    gspec, _ = tmg1.build()
    params, cells = tmg1.sweep_params(20, reps_per_cell=1)
    R = len(cells)
    res = tex.run_experiment(gspec, params, R, seed=9, device="cpu")
    st = tex.run_experiment_stream(gspec, params, R, wave_size=8,
                                   chunk_steps=41, seed=9, device="cpu")
    assert st.n_waves == 3 and int(st.total_events) == int(
        res.total_events)
    oracle = sm.merge(sm.empty((), "cpu"),
                      fold_oracle(res.sims.user["wait"], 8))
    for x, y in zip(st.summary, oracle):
        assert torch.equal(x, y)


def _burst(lib, n_timers=12, event_cap=4):
    m = lib.Model("burst", event_cap=event_cap, guard_cap=2)
    api, cmd, cr = lib.api, lib.cmd, lib.cr

    @m.block
    def work(sim, p, sig):
        sim, t = api.draw(sim, cr.exponential, 1.0)
        for k in range(n_timers):
            sim, _ = api.timer_add(sim, p, 10.0 + k, 100 + k)
        sim = api.timers_clear(sim, p)
        done = api.clock(sim) > 3.0
        return sim, cmd.select(done, cmd.exit_(),
                               cmd.hold(t, next_pc=work.pc))

    m.process("w", entry=work)
    return m.build()


def _clock_path(sims):
    """The burst spec records nothing: pool each lane's final clock."""
    return sm.add(sm.empty(sims.clock.shape, sims.clock.device),
                  sims.clock)


def test_stream_regrows_a_wave():
    spec = _burst(usergen.torch_lib())
    st = tex.run_experiment_stream(spec, (), 12, wave_size=4, seed=3,
                                   summary_path=_clock_path, max_regrows=3,
                                   device="cpu")
    assert st.n_regrows >= 1 and int(st.n_failed) == 0
    grown = _burst(usergen.torch_lib(),
                   event_cap=spec.event_cap * 2 ** st.n_regrows)
    direct = tex.run_experiment(grown, (), 12, seed=3, device="cpu")
    assert int(st.total_events) == int(direct.total_events)
    oracle = sm.merge(sm.empty((), "cpu"),
                      fold_oracle(_clock_path(direct.sims), 4))
    for x, y in zip(st.summary, oracle):
        assert torch.equal(x, y)
    # without regrows every lane fails, and is counted
    failed = tex.run_experiment_stream(spec, (), 12, wave_size=4, seed=3,
                                       summary_path=_clock_path,
                                       device="cpu")
    assert int(failed.n_failed) == 12 and failed.n_regrows == 0


def test_stream_refuses_what_is_not_ported():
    spec, _ = tmm1.build(record=False)
    for kw in ("telemetry", "schedule"):
        with pytest.raises(NotImplementedError, match=kw):
            tex.run_experiment_stream(spec, tmm1.params(4), 4,
                                      device="cpu", **{kw: {}})
    # program_cache= is ported (serve.cache): a plain dict holds the
    # programs as a ProgramCache does, and a second call reuses them
    cache = {}
    a = tex.run_experiment_stream(spec, tmm1.params(4), 4, device="cpu",
                                  program_cache=cache)
    n = len(cache)
    b = tex.run_experiment_stream(spec, tmm1.params(4), 4, seed=3,
                                  device="cpu", program_cache=cache)
    assert n >= 3 and len(cache) == n
    assert int(a.n_failed) == int(b.n_failed) == 0
    # mesh= is ported (runner.experiment.make_mesh): a value that is not
    # a Mesh is refused by name
    with pytest.raises(TypeError, match="mesh"):
        tex.run_experiment_stream(spec, tmm1.params(4), 4, device="cpu",
                                  mesh={})
    # audit= is ported (obs.audit): a value it cannot take is refused
    with pytest.raises(TypeError, match="audit="):
        tex.run_experiment_stream(spec, tmm1.params(4), 4, device="cpu",
                                  audit={})
    with pytest.raises(ValueError, match="wave_size"):
        tex.run_experiment_stream(spec, tmm1.params(4), 4, wave_size=0,
                                  device="cpu")
