"""What the job-shop instance of the chunk kernel (csrc/queue_chunk.cu)
relies on, event by event on the plain engine, and the job shop's
conservation laws.

The kernel computes one Threefry block right after the pick, at the
lane's counter as the event found it, as the exponential the event's
first drawing block takes; a later draw would take a fresh block inline.
It bounds a resume's chain at the engine's MAX_CHAIN = 1024 commands
where the reference's kernel mode bounds it at ``spec.max_chain`` = 16
(ROADMAP.md, section C); the two rules give the same results while no
event chains more than 16 commands.  Checked for both builds the kernel
serves (``backlog`` 8 and 4) and both profiles:

* at most one draw an event, and most events draw;
* at most two chained commands an event (a buffer get that succeeds,
  retried or b_fin's, then b_svc's pool acquire; a signalled condition
  wait that proceeds, then mt_act's acquire; stage A's last put, then its
  exit), far inside both chain bounds;
* the general event table never holds a finite time.

And the reference's conservation test (tests/test_models.py): with
``backlog=4`` every job completes (``done.n == N``), every crew unit is
back in the pool, and the maintenance process ran in every replication.
"""

import functools

import pytest
import torch

from cimba_tpu_torch import config
from cimba_tpu_torch.core import eventset as ev
from cimba_tpu_torch.core import loop
from cimba_tpu_torch.models import jobshop

torch.set_num_threads(1)

LANES, N_JOBS = 8, 40


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
def _trajectory(backlog, prof):
    """One plain run to the end, a step at a time: per live lane and
    step, the counter advance and the commands applied; the finite
    general-table slots after each step; the end state."""
    with config.profile(prof):
        spec, _ = jobshop.build(backlog=backlog)
        sims = loop.init_sim(spec, 2026, torch.arange(LANES),
                             jobshop.params(N_JOBS), device="cpu")
        counts = {}
        step = _counting_step(spec, counts)
        cond = loop.make_cond(spec)
        rows, finite_slots = [], []
        while bool(cond(sims).any()):
            live = cond(sims)
            counts["n"] = torch.zeros(LANES, dtype=torch.int64)
            nxt = loop._where(live, step(sims), sims)
            rows.append(torch.stack([_counter(nxt) - _counter(sims),
                                     counts["n"]], 1)[live])
            finite_slots.append(int(torch.isfinite(nxt.events.time).sum()))
            sims = nxt
        assert bool(sims.done.all()) and int(sims.err.abs().sum()) == 0
    return torch.cat(rows), finite_slots, sims


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("backlog", [8.0, 4.0])
def test_most_draws_and_chained_commands_an_event(backlog, prof):
    rows, _, _ = _trajectory(backlog, prof)
    adv, chain = rows[:, 0], rows[:, 1]
    assert int(adv.min()) >= 0 and int(adv.max()) == 1
    assert int(chain.min()) >= 0 and int(chain.max()) == 2
    assert int(adv.sum()) > adv.numel() // 2  # most events draw


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("backlog", [8.0, 4.0])
def test_general_event_table_stays_empty(backlog, prof):
    _, finite_slots, end = _trajectory(backlog, prof)
    assert len(finite_slots) > 3 * N_JOBS
    assert max(finite_slots) == 0
    assert bool((end.user["done"].n == N_JOBS).all())
    assert bool((end.pools.level == 3.0).all())


def test_conserves_jobs_and_runs_maintenance():
    """tests/test_models.py's conservation test (seed 5, replications
    0-3, 300 jobs, backlog 4) on the port's plain engine."""
    spec, _ = jobshop.build(backlog=4.0)
    s = loop.init_sim(spec, 5, torch.arange(4), jobshop.params(300),
                      device="cpu")
    out = loop.make_run(spec)(s)
    assert int(out.err.abs().sum()) == 0
    assert bool((out.user["done"].n == 300).all())
    assert torch.allclose(out.pools.level[:, 0],
                          torch.full((4,), 3.0, dtype=out.pools.level.dtype))
    assert bool((out.user["maintenance_runs"] >= 1).all())
