"""Checkpoints in the port (``runner.checkpoint``) against the reference.

The three cases of ``tests/test_checkpoint_atomic.py`` restated: a
partial temp file beside the checkpoint is ignored, a save that dies
half way keeps the previous checkpoint and leaves no temp file, and
repeated saves use temp files of their own names.  A tag, shape or dtype
that differs raises, naming it.  A chunked run checkpointed every 2
chunks, stopped at chunk 3 and resumed ends bit for bit as the
uninterrupted run (mm1).  And the file itself is the reference's: a
tiny hold/exit spec (no libm in its arithmetic, its hold the run's
parameter) checkpointed at chunk 2 of the same run in both packages
gives ``.npz`` files with the same leaves, names, dtypes and bytes, and
the same fingerprint (leaf list and run tag); each package's file
restores in the port, and the port's run resumed from the reference's
file ends as its uninterrupted run.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu.core import api as japi
from cimba_tpu.core import cmd as jcmd
from cimba_tpu.core.model import Model as JModel
from cimba_tpu.runner import experiment as jex
from cimba_tpu_torch import interop, tree
from cimba_tpu_torch.core import api as tapi
from cimba_tpu_torch.core import loop as tloop
from cimba_tpu_torch.core import process as tcmd
from cimba_tpu_torch.core.model import Model as TModel
from cimba_tpu_torch.models import mm1
from cimba_tpu_torch.runner import checkpoint as ck
from cimba_tpu_torch.runner import experiment as tex

torch.set_num_threads(1)


def _tree(x=0.0):
    return {"a": torch.arange(4) + int(x),
            "b": torch.tensor(x, dtype=torch.float32)}


def test_partial_temp_file_is_ignored(tmp_path):
    path = str(tmp_path / "run.npz")
    ck.save(path, _tree(1.0), tag="t")
    for name in ("run.npz.tmp", "run.npz.abc123.tmp"):
        with open(str(tmp_path / name), "wb") as fh:
            fh.write(b"PK\x03\x04 this is not a complete archive")
    out = ck.restore(path, _tree(), tag="t")
    assert torch.equal(out["a"], torch.arange(4) + 1)
    assert float(out["b"]) == 1.0


def test_crashed_save_preserves_previous_checkpoint(tmp_path, monkeypatch):
    path = str(tmp_path / "run.npz")
    ck.save(path, _tree(7.0), tag="t")
    before = open(path, "rb").read()

    def dying_savez(fh, **arrays):
        fh.write(b"partial bytes that must never be published")
        raise RuntimeError("simulated preemption mid-save")

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        ck.save(path, _tree(8.0), tag="t")
    monkeypatch.undo()
    assert open(path, "rb").read() == before
    assert float(ck.restore(path, _tree(), tag="t")["b"]) == 7.0
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_resumable_roundtrip_and_unique_temps(tmp_path, monkeypatch):
    path = str(tmp_path / "resume.npz")
    names = []
    real = ck.tempfile.mkstemp

    def spy(**kw):
        fd, name = real(**kw)
        names.append(name)
        return fd, name

    monkeypatch.setattr(ck.tempfile, "mkstemp", spy)
    for k in range(3):
        ck.save_resumable(path, _tree(float(k)), tag="r", progress=k)
    sims, progress = ck.restore_resumable(path, _tree(), tag="r")
    assert progress == 2 and float(sims["b"]) == 2.0
    assert len(set(names)) == 3 and path + ".tmp" not in names
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_mismatch_raises_naming_it(tmp_path):
    path = str(tmp_path / "m.npz")
    ck.save(path, _tree(1.0), tag="t")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        ck.restore(path, _tree(), tag="other")
    with pytest.raises(ValueError, match="leaf 0: shape"):
        ck.restore(path, {"a": torch.arange(5), "b": _tree()["b"]}, tag="t")
    with pytest.raises(ValueError, match="leaf 1: dtype float32 != "
                                         "expected float64"):
        ck.restore(path, {"a": torch.arange(4),
                          "b": torch.tensor(0.0, dtype=torch.float64)},
                   tag="t")
    with pytest.raises(ValueError, match="2 leaves, expected 3"):
        ck.restore(path, {**_tree(), "c": torch.zeros(1)}, tag="t")


class _Stop(Exception):
    pass


def _interrupted(run, at: int):
    """Call ``run(on_chunk=...)``, stopping it as chunk ``at`` ends."""
    def on_chunk(n):
        if n == at:
            raise _Stop

    with pytest.raises(_Stop):
        run(on_chunk=on_chunk)


def test_chunked_mm1_resume_is_bitwise(tmp_path):
    spec, _ = mm1.build(record=False)
    path = str(tmp_path / "mm1.npz")

    def run(**kw):
        return tex.run_experiment_chunked(
            spec, mm1.params(40), 16, seed=11, chunk_steps=37,
            poll_every=3, device="cpu", checkpoint_path=path,
            checkpoint_every=2, **kw)

    _interrupted(run, 3)
    # the checkpoint of chunk 2, with its count
    like = tloop.init_sim(spec, 11, torch.arange(16), mm1.params(40),
                          device="cpu")
    _, n = ck.restore_resumable(path, like, tag=ck.run_tag(
        spec, seed=11, params=tex._slice_params(mm1.params(40), 16, 0, 16)))
    assert n == 2
    counted = []
    resumed = run(resume=True, on_chunk=counted.append)
    assert counted[0] == 3
    whole = tex.run_experiment(spec, mm1.params(40), 16, seed=11,
                               device="cpu")
    assert interop.diff_leaves(interop.sim_to_numpy(whole.sims),
                               interop.sim_to_numpy(resumed.sims),
                               0.0) == []
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        tex.run_experiment_chunked(
            spec, mm1.params(40), 16, seed=12, device="cpu",
            checkpoint_path=path, resume=True)


def tiny(Model, api, cmd, t_stop=12.0):
    """Holds of the run's parameter (a time) until the clock passes
    ``t_stop``."""
    m = Model("tiny", event_cap=1, guard_cap=2)

    @m.user_state
    def user_init(params):
        return {"dt": params}

    @m.block
    def work(sim, p, sig):
        done = api.clock(sim) > t_stop
        return sim, cmd.select(done, cmd.exit_(),
                               cmd.hold(sim.user["dt"], next_pc=work.pc))

    m.process("w", entry=work)
    return m.build()


_TINY_P = 1.0


@functools.lru_cache(maxsize=None)
def ref_file(d):
    path = os.path.join(d, "ref.npz")

    def run(**kw):
        jex.run_experiment_chunked(tiny(JModel, japi, jcmd), _TINY_P, 8,
                                   seed=5,
                                   chunk_steps=3, checkpoint_path=path,
                                   checkpoint_every=2, **kw)

    _interrupted(run, 3)
    return path


def test_checkpoint_file_is_the_references(tmp_path):
    ref = ref_file(str(tmp_path))
    path = str(tmp_path / "port.npz")
    spec = tiny(TModel, tapi, tcmd)

    def run(**kw):
        return tex.run_experiment_chunked(
            spec, _TINY_P, 8, seed=5, chunk_steps=3, device="cpu",
            checkpoint_path=path, checkpoint_every=2, **kw)

    _interrupted(run, 3)
    with np.load(ref) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            if name == "__spec__":
                continue
            assert a[name].dtype == b[name].dtype, name
            assert a[name].shape == b[name].shape, name
            assert a[name].tobytes() == b[name].tobytes(), name
        import json

        fa = json.loads(bytes(a["__spec__"]).decode())
        fb = json.loads(bytes(b["__spec__"]).decode())
        assert fa["format"] == fb["format"] == ck._FORMAT
        assert fa["leaves"] == fb["leaves"]
        assert fa["tag"] == fb["tag"]
    like = tloop.init_sim(spec, 5, torch.arange(8), _TINY_P, device="cpu")
    mine, n = ck.restore_resumable(path, like)
    theirs, m = ck.restore_resumable(ref, like)
    assert n == m == 2
    for x, y in zip(tree.leaves(mine), tree.leaves(theirs)):
        assert torch.equal(x, y)
    assert int(mine.n_events.sum()) > 0
    # the port's run resumed from the reference's file, its tag checked,
    # ends as its own uninterrupted run
    with open(ref, "rb") as src, open(path, "wb") as dst:
        dst.write(src.read())
    counted = []
    resumed = run(resume=True, on_chunk=counted.append)
    assert counted[0] == 3
    whole = tex.run_experiment(spec, _TINY_P, 8, seed=5, device="cpu")
    assert interop.diff_leaves(interop.sim_to_numpy(whole.sims),
                               interop.sim_to_numpy(resumed.sims),
                               0.0) == []
