"""Chunked runs in the port (``core.loop.make_chunk``, ``drive_chunks``,
``make_chunked_run``; ``runner.experiment.run_experiment_chunked``)
against the reference's ``run_experiment_chunked``.

The configuration is ``tests/test_stream.py``'s: mm1, 32 replications of
40 objects, seed 11, chunks of 37 events (which divide no lane's run, so
chunks end mid-cycle), the liveness flag read every 3 chunks.  The port's
chunked run is held bit for bit against its own monolithic run, and leaf
for leaf against the reference's chunked run: integers exact, floats
within 1e-9 of each leaf's scale (the reference's chunked run is its
monolithic run bit for bit; the packages' log1p differ in the last
place, as in every parity test).  Then the M/G/1 sweep's per-wave
parameter rows (``_slice_params``, ``tests/test_stream.py:173``), and
``drive_chunks``' late poll: chunks dispatched after every lane is done
change nothing, on mm1 and on the reference's tiny hold/exit spec in
the f32 profile.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from cimba_tpu.models import mm1 as jmm1
from cimba_tpu.runner import experiment as jex
from cimba_tpu_torch import config as tconfig
from cimba_tpu_torch import interop, tree
from cimba_tpu_torch.core import api
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.core import process as cmd
from cimba_tpu_torch.core.model import Model
from cimba_tpu_torch.models import mg1 as tmg1
from cimba_tpu_torch.models import mm1 as tmm1
from cimba_tpu_torch.runner import experiment as tex

torch.set_num_threads(1)

_R, _N, _SEED = 32, 40, 11


def _same(a, b):
    return interop.diff_leaves(interop.sim_to_numpy(a),
                               interop.sim_to_numpy(b), 0.0) == []


@functools.lru_cache(maxsize=None)
def ref_chunked():
    spec, _ = jmm1.build(record=False)
    res = jex.run_experiment_chunked(spec, jmm1.params(_N), _R, seed=_SEED,
                                     chunk_steps=37, poll_every=3)
    return [np.asarray(x) for x in jax.tree.leaves(res.sims)]


@functools.lru_cache(maxsize=None)
def port_mono():
    spec, _ = tmm1.build(record=False)
    return tex.run_experiment(spec, tmm1.params(_N), _R, seed=_SEED,
                              device="cpu").sims


def test_chunked_matches_reference_and_monolithic_mm1():
    spec, _ = tmm1.build(record=False)
    counted = []
    res = tex.run_experiment_chunked(spec, tmm1.params(_N), _R, seed=_SEED,
                                     chunk_steps=37, poll_every=3,
                                     device="cpu", on_chunk=counted.append)
    assert int(res.sims.n_events.sum()) > 300
    assert res.launches == 0 and int(res.n_failed) == 0
    assert _same(port_mono(), res.sims)
    assert interop.diff_leaves(ref_chunked(),
                               interop.sim_to_numpy(res.sims), 1e-9) == []
    # chunks are counted 1, 2, ...; the last few ran past the end
    assert counted == list(range(1, len(counted) + 1))


def test_late_poll_changes_nothing():
    """``drive_chunks`` reads the oldest flag only once ``poll_every`` are
    queued: the chunks run after the end change no leaf, and a chunk of
    a finished Sim returns it unchanged."""
    spec, _ = tmm1.build(record=False)
    s0 = tloop.init_sim(spec, _SEED, torch.arange(8), tmm1.params(_N),
                        device="cpu")
    chunk = tloop.make_chunk(spec, max_steps=37)
    prompt, slow = [], []
    a = tloop.drive_chunks(chunk, s0, poll_every=1, on_chunk=prompt.append)
    late = tloop.drive_chunks(chunk, s0, poll_every=9, on_chunk=slow.append)
    assert _same(a, late)
    assert len(slow) == len(prompt) + 8  # 8 more chunks ran past the end
    again, live = chunk(late)
    assert not bool(live) and _same(late, again)
    # max_chunks stops early, unfinished; n0 offsets the count
    seen = []
    part = tloop.drive_chunks(chunk, s0, max_chunks=2, n0=5,
                              on_chunk=seen.append)
    assert seen == [6, 7]
    assert bool(tloop.make_lanes_live(spec)(part).any())


def _tiny_spec(t_stop=30.0):
    """The reference's smallest chunkable model (tests/test_stream.py):
    one process holding unit steps until ``t_stop``."""
    m = Model("tiny", event_cap=1, guard_cap=2)

    @m.block
    def work(sim, p, sig):
        done = api.clock(sim) > t_stop
        return sim, cmd.select(done, cmd.exit_(),
                               cmd.hold(1.0, next_pc=work.pc))

    m.process("w", entry=work)
    return m.build()


def test_chunked_run_matches_monolithic_f32():
    with tconfig.profile("f32"):
        spec = _tiny_spec()
        s0 = tloop.init_sim(spec, 7, torch.arange(4), device="cpu")
        mono = tloop.make_run(spec)(s0)
        run = tloop.make_chunked_run(spec, chunk_steps=7, poll_every=3)
        chunked = run(s0)
        assert int(mono.n_events.sum()) > 100
        assert _same(mono, chunked)
        assert run.chunk is not None


def test_wave_param_slicing_mg1_sweep():
    """A wave's parameter rows are the monolithic broadcast's rows, and a
    wave's init the matching rows of the whole init, bit for bit; a
    shared leaf whose length equals the wave's is still broadcast."""
    spec, _ = tmg1.build()
    params, cells = tmg1.sweep_params(30, reps_per_cell=1)
    R = len(cells)
    assert R == 20
    full = tloop._broadcast_params(params, R, "cpu")
    for lo, n in [(0, 8), (8, 8), (16, 4), (0, R)]:
        sliced = tex._slice_params(params, R, lo, n)
        for x, y in zip(tree.leaves(sliced), tree.leaves(full)):
            assert torch.equal(x, y[lo:lo + n])
    shared = (torch.arange(4.0, dtype=torch.float64),)
    sliced = tex._slice_params(shared, R, 8, 4)
    assert torch.equal(sliced[0], torch.arange(4.0, dtype=torch.float64)
                       .expand(4, 4))
    init_full = tloop.init_sim(spec, 9, torch.arange(R), params,
                               device="cpu")
    for lo, n in [(0, 8), (8, 8), (16, 4)]:
        wave = tloop.init_sim(spec, 9, torch.arange(lo, lo + n),
                              tex._slice_params(params, R, lo, n),
                              device="cpu")
        for x, y in zip(tree.leaves(wave), tree.leaves(init_full)):
            assert torch.equal(x, y[lo:lo + n])


def test_chunked_refuses_what_is_not_ported():
    spec, _ = tmm1.build(record=False)
    # mesh= is ported (runner.experiment.make_mesh): a value that is not
    # a Mesh is refused by name
    with pytest.raises(TypeError, match="mesh"):
        tex.run_experiment_chunked(spec, tmm1.params(4), 4, mesh=object(),
                                   device="cpu")
    with pytest.raises(ValueError, match="max_steps"):
        tloop.make_chunk(spec, max_steps=0)
