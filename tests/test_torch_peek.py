"""K6's peek on the CPU: the planted cases and the host-built kernel.

``tools.bisect_kernels.plant_peek_cases`` plants, lane by lane, the cases
the peek kernel (``csrc/bisect_stages.cu``) must get right: ties on time,
on (time, prio) and on the whole key in the event table (the last summed
field by field), empty lanes, a -inf and a NaN time, ties across the
event and wake tables, a whole key tied in the wake table, and a -inf
wake.  Here the planted states are held to the reference: the port's
plain peek (``eventset.peek_merged``) must give every lane the Event
that ``cimba_tpu.core.eventset.peek_merged`` gives, and each planted
case the Event it was planted for.  Then the kernel itself, built with
g++ (``gxx_shim.build_bisect``: each block's threads are fibers whose
warps shuffle as the card's lanes do), must give the plain peek's Event
bit for bit, on the models' states, a few events in and planted, at
lane counts that leave the last warp part full, AWACS's 1001 wake rows
(a group of 32 threads a lane) included.  The card runs the same cases
(tests/test_torch_cuda.py, chip_smoke.py phase 9).  torch runs on one
thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cimba_tpu import config as jconfig
from cimba_tpu.core import eventset as jev
from cimba_tpu.core import loop as jloop
from cimba_tpu_torch import config
from cimba_tpu_torch.core import loop
from cimba_tpu_torch.tools import bisect_kernels as bk
from cimba_tpu_torch.tools import cuda_bisect as cb
from cimba_tpu_torch.tools import gxx_shim

torch.set_num_threads(1)

LANES = 37  # three rounds of the twelve cases and one more


def _states(model, size, lanes=LANES):
    st = cb.Setup(model, "cpu", lanes=lanes, size=size)
    s7 = st.plain(st.start, 7)
    return st, (st.start, s7, bk.plant_peek_cases(st.start),
                bk.plant_peek_cases(s7))


def _reference(sims):
    """The reference's peek_merged, lane by lane, on the same arrays."""
    e, w = sims.events, sims.wakes

    def j(x):
        return jnp.asarray(x.numpy())

    es = jev.EventSet(j(e.time), j(e.prio), j(e.seq), j(e.kind), j(e.subj),
                      j(e.arg), j(e.gen), j(e.next_seq), j(e.overflow))
    wk = jev.Wakes(j(w.time), j(w.sig), j(w.seq))
    return jax.vmap(lambda a, b, p: jev.peek_merged(a, b, p, jloop.K_PROC)
                    [0])(es, wk, j(sims.procs.prio))


def _same(got, want, what):
    for f, a, b in zip(got._fields, got, want):
        a = np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype, (what, f)
        assert np.array_equal(a, b, equal_nan=True), (what, f)


def _expected(sims, event):
    """Each planted lane's Event against what was planted."""
    e = event
    case = torch.arange(sims.clock.shape[0]) % len(bk.PEEK_CASES)
    seen = set()
    for lane in range(sims.clock.shape[0]):
        c = bk.PEEK_CASES[int(case[lane])]
        seen.add(c)
        found, time = bool(e.found[lane]), float(e.time[lane])
        got = (int(e.prio[lane]), int(e.kind[lane]), int(e.subj[lane]),
               int(e.arg[lane]), int(e.handle[lane]))
        if c == "time_tie":
            assert found and got == (5, 1, 0, 0, 1), (lane, c, got)
        elif c == "prio_tie":
            assert found and got == (4, 1, 0, 0, 1), (lane, c, got)
        elif c == "same_key":
            assert found and got == (4, 5, 11, 3, 30 << 16), (lane, c, got)
        elif c == "empty":
            assert not found and time == float("inf") and got[-1] == -1
        elif c == "minus_inf":
            assert not found and time == float("-inf") and got[-1] == -1
        elif c == "nan":
            assert not found and np.isnan(time) and got[-1] == -1
        elif c == "nan_beside_wake":
            assert got[1] == loop.K_PROC and got[-1] == -1, (lane, c, got)
        elif c == "event_before_wake":
            gen = int(sims.events.gen[lane, 0])
            assert found and got == (2, 1, 0, 0, gen << 16), (lane, c, got)
        elif c == "wake_before_event":
            assert found and got == (2, loop.K_PROC, 0, 0, -1), (lane, c, got)
        elif c == "same_wake_key":
            assert found and got == (1, loop.K_PROC, 0, 7, -1), (lane, c, got)
    assert seen == set(bk.PEEK_CASES)


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("model,size", [("mmc", 12), ("awacs", 16),
                                        ("jobshop", 12)])
def test_planted_cases_match_reference(model, size, prof):
    with config.profile(prof), jconfig.profile(prof):
        st, states = _states(model, size)
        for k, sims in enumerate(states):
            got = bk.peek_plain(sims)
            _same(got, _reference(sims), (model, prof, k))
            if k >= 2 and st.lay["E"] >= 2 and st.lay["P"] >= 2:
                _expected(sims, got)


@pytest.fixture(scope="module")
def lib():
    if not gxx_shim.available():
        pytest.skip("no g++ on PATH: the host build of the peek needs it")
    return gxx_shim.load(gxx_shim.build_bisect())


@pytest.mark.parametrize("prof", ["f32", "f64"])
@pytest.mark.parametrize("model,size,lanes", [
    ("mm1", 12, LANES), ("mmc", 12, LANES), ("mmc", 12, 301),
    ("jobshop", 12, LANES), ("awacs", 1000, 13)])
def test_host_built_peek_matches_plain(lib, model, size, lanes, prof):
    with config.profile(prof):
        st, states = _states(model, size, lanes)
        for k, sims in enumerate(states):
            got = gxx_shim.peek(lib, sims, st.table, st.lay)
            want = bk.peek_plain(sims)
            for f, a, b in zip(want._fields, want, got):
                assert a.dtype == b.dtype, (model, k, f)
                assert torch.equal(cb.bits(a), cb.bits(b)), (model, k, f)
