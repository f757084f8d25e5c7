"""Invariants the single-queue chunk kernel (csrc/queue_chunk.cu) relies on.

The kernel computes one standard exponential per event, at the lane's
counter as the event found it, before it dispatches (the warp-converged
draw), and it caches the general event table's minimum instead of
scanning the table every event.  Both are exact only while these models
keep two invariants, checked here on the plain engine, step by step, for
every spec of the kernel's mm family (mg1 and tandem, whose instances
draw by other rules: tests/test_torch_network_invariants.py):

* each event advances the lane's Threefry counter ``(ctr_lo, ctr_hi)``
  by 0 or 1 blocks: at most one draw an event;
* the general event table never holds a finite time: the models
  schedule only dense wakes.

A change to these models that breaks one of them fails here, on the CPU,
rather than as a divergence on the card.
"""

import functools

import pytest
import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.core import loop
from cimba_tpu_torch.models import mm1, mmc

LANES, N_OBJECTS = 64, 200
CASES = ["mm1", "mm1_record", "mmc1", "mmc2", "mmc3", "mmc4"]


def _spec(name):
    if name == "mm1":
        return mm1.build(record=False)[0], mm1.params(N_OBJECTS)
    if name == "mm1_record":
        return mm1.build()[0], mm1.params(N_OBJECTS)
    c = int(name[-1])
    return mmc.build(c)[0], mmc.params(N_OBJECTS, 0.83 * c, 1.0)


def _counter(sims):
    return sims.rng.ctr_hi * 2**32 + sims.rng.ctr_lo


@functools.lru_cache(maxsize=None)
def _trajectory(name, prof):
    """One plain run to the end, a step at a time: per step, the counter
    advances of the lanes that took it, and the finite general-table
    slots after it."""
    with config.profile(prof):
        spec, params = _spec(name)
        sims = loop.init_sim(spec, 2026, torch.arange(LANES), params,
                             device="cpu")
        one = loop.make_run(spec, max_steps=1)
        cond = loop.make_cond(spec)
        advances, finite_slots = [], []
        assert not bool(torch.isfinite(sims.events.time).any())
        while bool(cond(sims).any()):
            live = cond(sims)
            nxt = one(sims)
            advances.append((_counter(nxt) - _counter(sims))[live])
            finite_slots.append(int(torch.isfinite(nxt.events.time).sum()))
            sims = nxt
        assert bool(sims.done.all()) and int(sims.err.abs().sum()) == 0
    return torch.cat(advances), finite_slots


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("name", CASES)
def test_at_most_one_draw_an_event(name, prof):
    adv, _ = _trajectory(name, prof)
    assert int(adv.min()) >= 0 and int(adv.max()) <= 1
    # the invariant is not vacuous: most events draw
    assert int(adv.sum()) > adv.numel() // 2


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("name", CASES)
def test_general_event_table_stays_empty(name, prof):
    _, finite_slots = _trajectory(name, prof)
    assert len(finite_slots) > 2 * N_OBJECTS
    assert max(finite_slots) == 0
