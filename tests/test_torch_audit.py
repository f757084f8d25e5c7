"""The determinism audit of the port (``cimba_tpu_torch.obs.audit``).

* ``sim_digest`` gives the reference's hex digests on the same state, in
  both profiles, with and without the flight recorder's ring, the
  metrics registry and a ``t_stop`` leaf: mm1 (4 lanes, 40 objects) run
  17 events by the port's plain engine, carried into the reference's
  Sim (``interop.sim_to_numpy`` under the reference's tree structure).
  Threefry words (int64 here, ``uint32`` there) digest in the i32 class.
* The class sums are exact mod 2**64: sums of mixes near 2**63 and
  2**64 against Python integers.
* An audited ``run_experiment_stream`` (the port's plain engine, mm1, 16
  replications of 20 objects in waves of 8, chunks of 32 events) gives
  results bitwise equal to the unaudited one, one trail row a chunk, a
  content-addressed card whose digest two clean runs share; a flipped
  seed or a parameter drift is localized to wave 0, chunk 1; a regrown
  wave keeps the rows of its first attempt, then the regrown run's.
* ``cimba_tpu_torch.tools.audit_diff`` exits 0 on equal cards, 1 on a
  divergence and 2 on incomparable ones.

The trails against the reference's own audited stream are in
``tests/test_torch_audit_stream.py``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import loop as jloop
from cimba_tpu.models import mm1 as jmm1
from cimba_tpu.obs import audit as jaudit
from cimba_tpu.obs import metrics as jmetrics
from cimba_tpu.obs import trace as jtrace
from cimba_tpu_torch import config, interop, tree
from cimba_tpu_torch.core import loop
from cimba_tpu_torch.models import mm1
from cimba_tpu_torch.obs import audit
from cimba_tpu_torch.obs import metrics as om
from cimba_tpu_torch.obs import trace as ot
from cimba_tpu_torch.runner import experiment as ex
from cimba_tpu_torch.tools import audit_diff, usergen

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, N, WAVE, CHUNK = 16, 20, 8, 32


@pytest.fixture
def obs_off():
    yield
    for mod in (ot, om, jtrace, jmetrics):
        mod.disable()


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("obs", [False, True])
@pytest.mark.parametrize("horizon", [None, 30.0])
def test_sim_digest_equals_reference(obs_off, prof, obs, horizon):
    if obs:
        ot.enable(8)  # 17 events wrap a ring of 8
        om.enable()
        jtrace.enable(8)
        jmetrics.enable()
    with config.profile(prof):
        spec, _ = mm1.build(record=False)
        s = loop.init_sim(spec, 3, torch.arange(4), mm1.params(40),
                          t_stop=horizon, device="cpu")
        s = loop.make_run(spec, max_steps=17)(s)
        got = audit.format_digests(audit.sim_digest(s))
        leaves = interop.sim_to_numpy(s)
    with jconfig.profile(prof):
        jspec, _ = jmm1.build(record=False)
        shape = jax.eval_shape(jax.vmap(lambda r: jloop.init_sim(
            jspec, 3, r, jmm1.params(40), t_stop=horizon)), jnp.arange(4))
        jsims = jax.tree.unflatten(jax.tree.structure(shape),
                                   [jnp.asarray(x) for x in leaves])
        want = jaudit.format_digests(jaudit.sim_digest(jsims))
    assert got == want
    # the lane offset shifts every position key: another digest
    assert audit.format_digests(audit.sim_digest(s, lane_offset=4)) != got


def test_class_sum_exact_mod_2_64():
    """The halves' sum against Python integers, near 2**63 and 2**64."""
    vals = [2**63 - 1, 2**63 - 5, 2**64 - 3, 2**64 - 1, 2**62 + 7, 1]
    h = torch.tensor([audit._i64(v) for v in vals], dtype=torch.int64)
    got = int(audit._sum_u64(h)) & audit._U64
    assert got == sum(vals) % 2**64


def _stream(seed=7, n=N, aud=None, **kw):
    spec, _ = mm1.build(record=False)
    return ex.run_experiment_stream(
        spec, mm1.params(n), R, wave_size=WAVE, chunk_steps=CHUNK,
        seed=seed, device="cpu", audit=aud, **kw)


def test_audited_stream_bitwise_unperturbed_and_card(tmp_path):
    plain = _stream()
    a1, a2 = audit.Audit(out_dir=tmp_path), audit.Audit(out_dir=tmp_path)
    r1, r2 = _stream(aud=a1), _stream(aud=a2)
    assert plain.audit is None
    assert audit.stream_result_digest(plain) == r1.audit["result_digest"]
    for x, y in zip((plain.summary, plain.n_failed, plain.total_events),
                    (r1.summary, r1.n_failed, r1.total_events)):
        for u, v in zip(x if isinstance(x, tuple) else (x,),
                        y if isinstance(y, tuple) else (y,)):
            assert torch.equal(u, v)
    t1, t2 = a1.trail_rows(), a2.trail_rows()
    # one row a chunk: the chunks of both waves, each with the chunks a
    # late poll dispatches past the end
    chunks = []
    _stream(on_chunk=chunks.append)
    assert len(t1) == len(chunks) and t1 == t2
    assert [r["wave"] for r in t1] == sorted(r["wave"] for r in t1)
    assert {r["wave"] for r in t1} == {0, 1}
    assert r1.audit["card_digest"] == r2.audit["card_digest"]
    assert a1.card_path == a2.card_path
    card = audit.load_run_card(a1.card_path)
    assert audit.card_digest(card) == card["card_digest"]
    assert card["spec"]["spec_fingerprint"]
    assert card["seed_schedule"] == {"seed": 7}
    assert card["geometry"]["R"] == R
    assert card["env"]["backend"] == "cpu"
    rep = audit.diff_cards(r1.audit, r2.audit)
    assert rep["identical"] and rep["result_equal"]
    assert audit_diff.main([a1.card_path, a2.card_path]) == 0


def test_divergence_localizes_and_exit_codes(tmp_path):
    base = audit.Audit(out_dir=tmp_path / "a")
    _stream(aud=base)
    for kw in ({"seed": 8}, {"n": N + 10}):
        other = audit.Audit(out_dir=tmp_path / str(kw))
        res = _stream(aud=other, **kw)
        rep = audit.diff_cards(base.card, res.audit)
        assert not rep["identical"] and rep["result_equal"] is False
        d = rep["first_divergence"]
        assert d is not None and (d["wave"], d["chunk"]) == (0, 1)
        assert d["classes"] and set(d["classes"]) <= set(audit.CLASS_NAMES)
        assert audit_diff.main([base.card_path, other.card_path]) == 1
    # a divergence planted in one class of one row: found there
    rows = base.trail_rows()
    planted = [dict(r) for r in rows]
    planted[3]["i64"] = "0x0000000000000000"
    d = audit.diff_trails(rows, planted)
    assert (d["index"], d["classes"]) == (3, ["i64"])
    assert (d["wave"], d["chunk"]) == (rows[3]["wave"], rows[3]["chunk"])
    assert audit.diff_trails(rows, rows[:-1])["classes"] == ["length"]
    # incomparable geometry: exit 2, through the command line
    a = audit.run_card("stream", geometry={"R": 16, "wave_size": 8})
    b = audit.run_card("stream", geometry={"R": 16, "wave_size": 4})
    assert not audit.diff_cards(a, b)["comparable"]
    pa = audit.write_run_card(a, tmp_path)
    pb = audit.write_run_card(b, tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "cimba_tpu_torch.tools.audit_diff", pa, pb],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "incomparable" in proc.stdout
    # a bare trail list is a card too
    trail = tmp_path / "trail.json"
    trail.write_text(json.dumps(rows))
    assert audit_diff.main([str(trail), base.card_path, "--force"]) == 0


def test_regrown_wave_keeps_first_attempt_rows():
    """A wave that overflows runs again at a doubled event_cap: its
    first attempt's rows stay in the trail, then the regrown run's, all
    under the wave's index."""
    spec = _burst_spec(event_cap=4)
    aud = audit.Audit()
    res = ex.run_experiment_stream(spec, None, 8, wave_size=4, seed=3,
                                   chunk_steps=4, max_regrows=2,
                                   device="cpu", audit=aud,
                                   summary_path=lambda s: _clock_summary(s))
    assert res.n_regrows >= 1
    rows = aud.trail_rows()
    wave0 = [r["chunk"] for r in rows if r["wave"] == 0]
    restarts = [i for i in range(1, len(wave0)) if wave0[i] <= wave0[i - 1]]
    assert len(restarts) == res.n_regrows
    assert all(r["chunk"] >= 1 for r in rows)


def _burst_spec(event_cap):
    lib = usergen.torch_lib()
    m = lib.Model("burst", event_cap=event_cap, guard_cap=2)

    @m.block
    def work(sim, p, sig):
        sim, t = lib.api.draw(sim, lib.cr.exponential, 1.0)
        for k in range(12):
            sim, _ = lib.api.timer_add(sim, p, 10.0 + k, 100 + k)
        sim = lib.api.timers_clear(sim, p)
        done = lib.api.clock(sim) > 3.0
        return sim, lib.cmd.select(done, lib.cmd.exit_(),
                                   lib.cmd.hold(t, next_pc=work.pc))

    m.process("w", entry=work)
    return m.build()


def _clock_summary(sims):
    from cimba_tpu_torch.stats import summary as sm

    s = sm.empty(sims.clock.shape, sims.clock.device, sims.clock.dtype)
    return sm.add(s, sims.clock)


def test_resolve_knob(monkeypatch, tmp_path):
    monkeypatch.delenv(audit.AUDIT_ENV, raising=False)
    assert audit.resolve(None) is None and audit.resolve(False) is None
    assert isinstance(audit.resolve(True), audit.Audit)
    monkeypatch.setenv(audit.AUDIT_ENV, "1")
    assert audit.resolve(None).out_dir is None
    monkeypatch.setenv(audit.AUDIT_ENV, str(tmp_path))
    assert audit.resolve(None).out_dir == str(tmp_path)
    with pytest.raises(TypeError, match="audit="):
        audit.resolve(3)


def test_audited_chunk_returns_the_digest_of_its_state():
    spec, _ = mm1.build(record=False)
    s = loop.init_sim(spec, 5, torch.arange(4), mm1.params(10),
                      device="cpu")
    plain = loop.make_chunk(spec, max_steps=8)
    audited = loop.make_chunk(spec, max_steps=8, audit=True)
    a, live_a = plain(s)
    b, live_b, vec = audited(s)
    assert bool(live_a) == bool(live_b)
    assert all(torch.equal(x, y)
               for x, y in zip(tree.leaves(a), tree.leaves(b)))
    assert audit.format_digests(vec) == audit.format_digests(
        audit.sim_digest(b))
    seen = []
    loop.drive_chunks(audited, s, poll_every=2,
                      on_digest=lambda n, v: seen.append(n))
    assert seen == list(range(1, len(seen) + 1)) and len(seen) >= 2
    assert np.all(np.diff(seen) == 1)
