"""Invariants the AWACS chunk and dwell kernels (csrc/awacs_chunk.cu) rely on.

The chunk keeps, per thread, the best wake of a block of pids across
events and refreshes only the dispatched pid's block; it caches the
general event table's minimum for the chunk; and tgt_leg computes both of
its Threefry blocks before it branches.  These are exact only while the
AWACS model keeps these invariants, checked here on the plain engine,
event by event, through the host loop's protocol (a deferred chunk of
one event, then the plain boundary round of the frozen lanes), in both
profiles and scorings:

* an event changes ``wakes.time`` / ``wakes.seq`` at the dispatched pid
  only;
* ``procs.prio`` never changes;
* the general event table stays empty;
* a target's event draws exactly two counter ticks, a dwell one.

The dwell kernel leaves the lanes that are not pending bit for bit
untouched; its plain version (the CPU boundary round) is held to the
same contract here.  A change to the model that breaks one of these
fails here, on the CPU, rather than as a divergence on the card.
"""

import functools

import pytest
import torch

from cimba_tpu_torch import config, tree
from cimba_tpu_torch.core import eventset as ev
from cimba_tpu_torch.core import kernel_run, loop
from cimba_tpu_torch.models import awacs

N_TARGETS, LANES, T_END = 64, 16, 4.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    at once, and torch's thread pools in each of them would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counter(sims):
    return sims.rng.ctr_hi * 2**32 + sims.rng.ctr_lo


@functools.lru_cache(maxsize=None)
def _trajectory(prof, scoring):
    """The host loop's protocol on the plain engine, one event at a time:
    for each event of each lane, (dispatched pid, counter ticks, pids
    whose wake row changed), and whether prio or the general table ever
    changed."""
    with config.profile(prof):
        spec, _ = awacs.build(N_TARGETS, scoring=scoring)
        sims = loop.init_sim(spec, 2026, torch.arange(LANES),
                             awacs.params(T_END), device="cpu")
        one = loop.make_run(spec, max_steps=1, defer_boundary=True)
        round_ = kernel_run.make_boundary_step_plain(spec)
        cond = loop.make_cond(spec, defer_boundary=True)
        prio0 = sims.procs.prio.clone()
        events, prio_same, table_empty = [], True, True
        while True:
            live = cond(sims)
            if bool(live.any()):
                step, moved = one, live
            elif bool(sims.boundary_pending.any()):
                step, moved = round_, sims.boundary_pending
            else:
                break
            peek, _, _ = ev.peek_merged(sims.events, sims.wakes,
                                        sims.procs.prio, loop.K_PROC)
            nxt = step(sims)
            # a deferred chunk that only froze a lane dispatched nothing
            moved = moved & (nxt.n_events != sims.n_events)
            ticks = _counter(nxt) - _counter(sims)
            changed = ((nxt.wakes.time != sims.wakes.time)
                       | (nxt.wakes.seq != sims.wakes.seq))
            for lane in range(LANES):
                if bool(moved[lane]):
                    events.append((int(peek.subj[lane]), int(ticks[lane]),
                                   changed[lane].nonzero().flatten()
                                   .tolist()))
                else:
                    assert int(ticks[lane]) == 0
                    assert not bool(changed[lane].any())
            prio_same &= torch.equal(nxt.procs.prio, prio0)
            table_empty &= not bool(torch.isfinite(nxt.events.time).any())
            sims = nxt
        assert bool(sims.done.all()) and int(sims.err.abs().sum()) == 0
    return events, prio_same, table_empty


CASES = [(p, s) for p in ("f32", "f64") for s in ("nn", "threshold")]


@pytest.mark.parametrize("prof,scoring", CASES)
def test_an_event_changes_only_its_pids_wake_row(prof, scoring):
    events, _, _ = _trajectory(prof, scoring)
    assert len(events) > LANES * N_TARGETS
    for pid, _, changed in events:
        assert set(changed) <= {pid}


@pytest.mark.parametrize("prof,scoring", CASES)
def test_prio_and_general_table_never_change(prof, scoring):
    _, prio_same, table_empty = _trajectory(prof, scoring)
    assert prio_same and table_empty


@pytest.mark.parametrize("prof,scoring", CASES)
def test_a_target_draws_two_ticks_a_dwell_one(prof, scoring):
    events, _, _ = _trajectory(prof, scoring)
    sensor = N_TARGETS
    dwells = [t for pid, t, _ in events if pid == sensor]
    legs = [t for pid, t, _ in events if pid != sensor]
    assert set(dwells) == {1} and set(legs) == {2}
    # every dwell at t = 0 .. T_END, on every lane
    assert len(dwells) == LANES * (int(T_END) + 1)


@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_boundary_round_leaves_other_lanes_untouched(prof):
    """The round on a Sim where only some lanes are frozen: those are
    stepped exactly as the plain step steps them, and every other lane
    keeps every leaf, bit for bit."""
    with config.profile(prof):
        spec, _ = awacs.build(N_TARGETS)
        s0 = loop.init_sim(spec, 2026, torch.arange(LANES),
                           awacs.params(T_END), device="cpu")
        round_ = kernel_run.make_boundary_step(spec)
        s1 = round_(loop.make_run(spec, max_steps=512,
                                  defer_boundary=True)(s0))
        # events until the first lanes freeze at the next dwell
        one = loop.make_run(spec, max_steps=1, defer_boundary=True)
        part = s1
        while not bool(part.boundary_pending.any()):
            part = one(part)
        pending = part.boundary_pending
        assert 0 < int(pending.sum()) < LANES
        out = round_(part)
        stepped = loop.make_step(spec)(
            part._replace(boundary_pending=torch.zeros_like(pending)))
    assert not bool(out.boundary_pending.any())
    for x, y, z in zip(tree.leaves(part), tree.leaves(out),
                       tree.leaves(stepped)):
        if x is not part.boundary_pending:
            assert torch.equal(y[~pending], x[~pending])
        assert torch.equal(y[pending], z[pending])
    assert bool((out.user["dwells"][pending]
                 == part.user["dwells"][pending] + 1).all())


def test_dwell_refuses_cpu_sims():
    """The dwell kernel takes a Sim on the card; on the CPU the round is
    its plain version, and a launch wrapper called there raises."""
    spec, _ = awacs.build(8)
    lay = kernel_run.awacs_layout(spec)
    assert lay["scoring"] == "nn"
    assert kernel_run.awacs_layout(
        awacs.build(8, scoring="threshold")[0])["scoring"] == "threshold"
    s0 = loop.init_sim(spec, 3, torch.arange(2), awacs.params(2.0),
                       device="cpu")
    before = kernel_run.awacs_dwell.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel_run.awacs_dwell(s0, lay)
    assert kernel_run.awacs_dwell.launches == before
