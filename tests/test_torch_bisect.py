"""The port's chunk-kernel bisect tools on the CPU.

``tools/cuda_bisect.py`` (K6's driver) and ``tools/cuda_event_bisect.py``
(K7's) run their plain versions on CPU tensors, so here they are held to
their own contract: every stage of every model passes; a failing stage
is reported and makes the driver exit non-zero (and a failure at stage 4
or later stops it); a stage run in its own process hands its JSON line
back; the event bisect names a planted divergence's event, lane, leaf
and block exactly, reports none when there is none, and reports a probe
that faults.  The kernels themselves are held against these plain
versions on the card (test_torch_cuda.py, chip_smoke.py).
"""

import io
import json

import pytest
import torch

from cimba_tpu_torch import config, tree
from cimba_tpu_torch.tools import bisect_kernels as bk
from cimba_tpu_torch.tools import cuda_bisect as cb
from cimba_tpu_torch.tools import cuda_event_bisect as eb


def _lines(buf):
    return [json.loads(x) for x in buf.getvalue().splitlines()]


@pytest.mark.parametrize("model", ["mm1", "mm1-record", "mmc", "jobshop",
                                   "awacs", "park2", "spawnshop", "waitev"])
def test_every_stage_passes_on_cpu(model):
    buf = io.StringIO()

    def runner(stage):
        return cb.run_stage(model, "f32", "cpu", stage, lanes=6, size=12)

    rc = cb.drive(range(6), runner, out=buf)
    lines = _lines(buf)
    assert rc == 0
    assert [x["stage"] for x in lines[:-1]] == list(range(6))
    assert all(x["ok"] for x in lines[:-1])
    assert lines[-1]["failed"] == 0
    # the plain versions launch nothing
    assert all(n == 0 for x in lines[:-1] for n in x["launches"].values())


@pytest.mark.parametrize("bad, printed", [(3, [0, 1, 2, 3, 4, 5]),
                                          (4, [0, 1, 2, 3, 4])])
def test_failing_stage_is_reported(bad, printed):
    """A stage that fails is reported as failed and the driver exits 1;
    after a failure at stage 4 or later it stops, as the reference's."""
    buf = io.StringIO()

    def runner(stage):
        if stage == bad:
            return {"ok": False, "tail": "differs: [('queues.size', ...)]"}
        return {"ok": True, "tail": ""}

    assert cb.drive(range(6), runner, jobs=3, out=buf) == 1
    lines = _lines(buf)
    assert [x["stage"] for x in lines[:-1]] == printed
    assert [x["stage"] for x in lines[:-1] if not x["ok"]] == [bad]
    assert "queues.size" in lines[bad]["tail"]
    assert lines[-1]["failed"] == 1


def test_subprocess_stage_round_trips_its_json_line():
    run = cb.subprocess_runner("mmc", "f32", "cpu", timeout=300, lanes=4,
                               size=10)
    res = run(2)
    assert res["ok"] and res["tail"] == ""
    assert res["launches"]["queue_chunk"] == 0
    res = run(7)  # no such stage: the child fails and says why
    assert not res["ok"] and "no stage 7" in res["tail"]


def test_copy_and_peek_plain_versions():
    """On a CPU Sim the wrappers run their plain versions and launch
    nothing: the copy is a new, equal Sim; the peek is peek_merged."""
    with config.profile("f32"):
        st = cb.Setup("mmc", "cpu", lanes=5, size=10)
        sims = st.plain(st.start, 9)
        n_copy, n_peek = bk.sim_copy.launches, bk.peek.launches
        cp = bk.sim_copy(sims, st.table, st.lay)
        ev = bk.peek(sims, st.table, st.lay)
    assert (bk.sim_copy.launches, bk.peek.launches) == (n_copy, n_peek)
    for a, b in zip(tree.leaves(sims), tree.leaves(cp)):
        assert a is not b and torch.equal(cb.bits(a), cb.bits(b))
    want = bk.peek_plain(sims)
    assert all(torch.equal(a, b) for a, b in zip(want, ev))


def _planted(st, lane, leaf, at, delta):
    names = [n for n, _, _ in st.table]
    pos = names.index(leaf)

    def kernel(sims, k):
        got = st.chunk(sims, k)
        if int(got.n_events[lane] - sims.n_events[lane]) >= at:
            xs = tree.leaves(got)
            x = xs[pos].clone()
            x[lane] += delta
            xs[pos] = x
            got = tree.unflatten(got, xs)
        return got

    return kernel


@pytest.mark.parametrize("model, lane, leaf, at", [
    ("mmc", 5, "queues.size", 11),
    ("mm1-record", 2, "queues.acc.summary.m1", 20),
    ("awacs", 3, "user.pos_x", 7),
    ("jobshop", 4, "buffers.level", 9),
    ("park2", 1, "pools.level", 9),
    ("spawnshop", 6, "procs.locals_f", 12),
    ("waitev", 3, "procs.await_evt", 10),
])
def test_event_bisect_names_a_planted_divergence(model, lane, leaf, at):
    with config.profile("f32"):
        st = cb.Setup(model, "cpu", lanes=8, size=12)
        kernel = _planted(st, lane, leaf, at, 1)
        res = eb.find_divergence(st.spec, st.start, kernel, 64,
                                 cb.RTOL["f32"], st.table)
        before = st.plain(st.start, at - 1)
    ev = bk.peek_plain(before)
    pid = int(ev.subj[lane])
    block = st.spec.blocks[int(before.procs.pc[lane, pid])].__name__
    assert res["k"] == at and res["lane"] == lane
    assert res["leaves"] == [leaf] and res["lanes_differing"] == 1
    assert res["event"]["pid"] == pid and res["event"]["block"] == block
    assert res["probes"] == 7  # K=64 first, then log2(64)
    assert eb.describe(res).startswith(f"CULPRIT k={at} lane={lane} ")


def test_event_bisect_without_divergence_and_with_a_fault():
    with config.profile("f32"):
        st = cb.Setup("mmc", "cpu", lanes=4, size=10)
        res = eb.find_divergence(st.spec, st.start, st.chunk, 16)

        def faulty(sims, k):
            if k >= 9:
                raise eb.Probe("an illegal memory access was encountered")
            return st.chunk(sims, k)

        bad = eb.find_divergence(st.spec, st.start, faulty, 16)
    assert res == {"k": None, "K": 16, "probes": 1}
    assert eb.describe(res) == "no divergence within 16 events (1 probes)"
    assert bad["k"] == 9 and "illegal memory" in bad["fault"]
    assert "faults from event 9" in eb.describe(bad)


def test_event_bisect_isolated_probe_on_cpu(capsys):
    """From the command line each probe runs in its own process and its
    state comes back through a file."""
    rc = eb.main(["--model", "mm1", "--device", "cpu", "--lanes", "4",
                  "--size", "10", "--K", "8"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert json.loads(out[0])["k"] is None
    assert out[1] == "no divergence within 8 events (1 probes)"
