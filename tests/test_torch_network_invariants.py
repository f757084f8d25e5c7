"""What the mg1 and tandem instances of the chunk kernel
(csrc/queue_chunk.cu) rely on, event by event on the plain engine.

The kernel computes one Threefry block right after the pick, at the
lane's counter as the event found it, with its transform chosen from
the event's subject (and, in tandem, the subject's pc), in code all
lanes of a warp run together; a later draw of the same event takes a
fresh block inline.  The general event table's minimum is cached.  These
are exact only while the models keep the invariants checked here, for
both profiles:

* mg1: at most one draw an event; its first draw is the arrival's
  exponential (subject 0) or the server's lognormal (subject 1);
* tandem: at most two draws an event, two only when server 2 completes
  a service (subject 2 at ``s2_cycle``: the routing uniform, then the
  next service's exponential in ``s2_take``);
* both: at most two chained commands an event (a block's command that
  does not yield, such as a put into a queue with room, then the next
  block's), far inside the engine's MAX_CHAIN; and the general event
  table never holds a finite time.
"""

import functools

import pytest
import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.core import eventset as ev
from cimba_tpu_torch.core import loop
from cimba_tpu_torch.models import mg1, tandem

torch.set_num_threads(1)

LANES, N_OBJECTS = 24, 120
#: the most draws and chained commands one event makes, per model
MOST = {"mg1": (1, 2), "tandem": (2, 2)}


def _spec(name):
    if name == "mg1":
        p, _ = mg1.sweep_params(N_OBJECTS, cvs=(0.5, 2.0),
                                utilizations=(0.6, 0.9), reps_per_cell=6)
        return mg1.build()[0], p
    p, _ = tandem.sweep_grid(N_OBJECTS).rows(LANES // 6)
    return tandem.build()[0], p


def _counter(sims):
    return sims.rng.ctr_hi * 2**32 + sims.rng.ctr_lo


def _counting_step(spec, counts):
    """``loop.make_step(spec)`` whose command handler adds one to
    ``counts["n"]`` on every lane it applies a command to."""
    real = loop._make_apply

    def make_apply(spec_):
        apply = real(spec_)

        def counted(sim, p, cmd, is_retry, active):
            counts["n"] = counts["n"] + active.to(torch.int64)
            return apply(sim, p, cmd, is_retry, active)

        return counted

    loop._make_apply = make_apply
    try:
        return loop.make_step(spec)
    finally:
        loop._make_apply = real


@functools.lru_cache(maxsize=None)
def _trajectory(name, prof):
    """One plain run to the end, a step at a time: per live lane and
    step, the counter advance, the commands applied, the subject and its
    pc before the step; and the finite general-table slots after it."""
    with config.profile(prof):
        spec, params = _spec(name)
        sims = loop.init_sim(spec, 2026, torch.arange(LANES), params,
                             device="cpu")
        counts = {}
        step = _counting_step(spec, counts)
        cond = loop.make_cond(spec)
        rows, finite_slots = [], []
        assert not bool(torch.isfinite(sims.events.time).any())
        while bool(cond(sims).any()):
            live = cond(sims)
            event, _, _ = ev.peek_merged(sims.events, sims.wakes,
                                         sims.procs.prio, loop.K_PROC)
            subj = event.subj.clamp(0, spec.n_procs - 1)
            pc = sims.procs.pc.gather(1, subj[:, None].long())[:, 0]
            counts["n"] = torch.zeros(LANES, dtype=torch.int64)
            nxt = loop._where(live, step(sims), sims)
            rows.append(torch.stack([_counter(nxt) - _counter(sims),
                                     counts["n"], subj.long(), pc.long()],
                                    1)[live])
            finite_slots.append(int(torch.isfinite(nxt.events.time).sum()))
            sims = nxt
        assert bool(sims.done.all()) and int(sims.err.abs().sum()) == 0
    return torch.cat(rows), finite_slots


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("name", ["mg1", "tandem"])
def test_most_draws_and_chained_commands_an_event(name, prof):
    rows, _ = _trajectory(name, prof)
    adv, chain = rows[:, 0], rows[:, 1]
    draws, links = MOST[name]
    assert int(adv.min()) >= 0 and int(adv.max()) == draws
    assert int(chain.min()) >= 0 and int(chain.max()) == links
    assert int(adv.sum()) > adv.numel() // 2  # most events draw


@pytest.mark.parametrize("prof", ["f32", "f64"])
def test_tandem_draws_twice_only_at_s2_cycle(prof):
    rows, _ = _trajectory("tandem", prof)
    two = rows[rows[:, 0] == 2]
    s2_cycle = tandem.BLOCK_NAMES.index("s2_cycle")
    assert two.shape[0] > 0
    assert bool((two[:, 2] == 2).all()) and bool((two[:, 3] == s2_cycle).all())


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("name", ["mg1", "tandem"])
def test_general_event_table_stays_empty(name, prof):
    _, finite_slots = _trajectory(name, prof)
    assert len(finite_slots) > 2 * N_OBJECTS
    assert max(finite_slots) == 0
