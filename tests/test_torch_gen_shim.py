"""The generated chunk kernel built with g++ on the CPU, against the plain
engine.

``cimba_tpu_torch.tools.gxx_shim`` builds ``csrc/queue_chunk.cu`` with a
generated header for the host (a stand-in for ``cuda_runtime.h``, the
launch run as a loop over the grid).  The generated instances of five
cells (tutorial 3's jockeying park, tutorial 2's cheese park, tutorial
4's harbor, the cookbook's balking queue, the reference's kernel-path
model of ``wait_event``), each in f64 and f32, are held against
``loop.make_run`` chunk by chunk on the same lanes: K = 1, 7 and 64
events, then to the end of the run (the harbor to t=15, the cheese park
to t=30), integers
exact, floats within 1e-9 (f64) or 2e-5 (f32) of each leaf's scale
(glibc's log1p, exp and sin are not torch's to the last place).  Then
states planted to reach the edges of the kernel's live-slot searches
(``csrc/queue_chunk.cu``: the masks of the general table and the
priority queues):

* ties in the general table: equal times with equal and higher
  priorities, equal seqs (the lowest slot), ties with the dense wakes,
  across the mask's words;
* equal priorities, a -inf and a NaN priority in a priority queue (the
  reference's amax propagates the NaN: no slot matches, the get takes
  column 0);
* a full general table, and one with a single free slot at a word's edge
  (a timer's insert overflows, failing the lane);
* far timers in every word of the table (the scans visit each word, an
  insert takes the lowest clear bit around them, a process's cancel of
  its timers clears bits across the words);
* a full priority queue (a put pends on the rear guard, the get's signal
  retries it), in the ``tools/usergen.py`` timers spec.

The boundary protocol (``usergen.build(2026, lib, boundary=True)``, a
calibrator whose hold resumes into a boundary block, and
``usergen.midchain_spec``): the host-built kernel freezes a lane at a
boundary dispatch and the plain round (``kernel_run.
make_boundary_step_plain``) steps it between chunks; K = 1, 7 and 64
events and then to the end, each chunk against the plain engine's
deferred chunk (``make_run(..., defer_boundary=True)``) from the same
state, and the end against ``make_run`` with no defer; then planted
states: a table event tied in time with the calibrator's boundary wake
(the wake first on some lanes, the event on others), a timer aimed at
the calibrator while it holds into its boundary block (frozen by the
table arm) and a user-kind event aimed at it (not frozen: its resume
reaches the block and fails the lane), and the mid-chain spec, whose
lanes all fail with ``ERR_BOUNDARY``.

The host stand-ins of ``__ffs``, ``__ffsll``, ``__popc`` and ``__popcll``
(and the shim's other bit intrinsics) are held against Python's integers.
Every test skips where there is no ``g++``; torch runs on one thread.
"""

import ctypes
import random
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from cimba_tpu_torch import config, interop, tree
from cimba_tpu_torch.core import kernel_run, loop
from cimba_tpu_torch.examples import (cookbook_balking, tut_2_park,
                                      tut_3_balking, tut_4_harbor)
from cimba_tpu_torch.tools import gxx_shim, usergen

torch.set_num_threads(1)

RTOL = {"f64": 1e-9, "f32": 2e-5}
LANES = 16
#: (build, params, seed, t_end) of each instance held to its end
CELLS = {
    "park3": (tut_3_balking.build, tut_3_balking.params, tut_3_balking.SEED,
              tut_3_balking.T_END),
    "park2": (lambda: tut_2_park.build()[0], tut_2_park.params,
              tut_2_park.SEED, 30.0),
    "harbor": (tut_4_harbor.build, tut_4_harbor.params, 4, 15.0),
    "balking": (lambda: cookbook_balking.build()[0],
                lambda: cookbook_balking.params(12), 7, None),
    "waitev": (lambda: usergen.wait_event_spec(usergen.torch_lib()),
               lambda: None, 17, None),
    "usergent5": (lambda: usergen.build(5, usergen.torch_lib(),
                                        timers=True)[0],
                  lambda: None, 11, None),
    "boundary": (lambda: usergen.build(2026, usergen.torch_lib(),
                                       boundary=True)[0],
                 lambda: None, 2026, 35.0),
    "midchain": (lambda: usergen.midchain_spec(usergen.torch_lib()),
                 lambda: None, 3, None),
}
K_TIMER, SIG_JOCKEY = 1, 101


@pytest.fixture(scope="module")
def built():
    """``{(name, profile): (spec, layout, library)}``, every instance
    built at once."""
    if not gxx_shim.available():
        pytest.skip("no g++ on PATH: the host build of the chunk kernel "
                    "needs one")
    lays = {}
    for name, (build, params, _, _) in CELLS.items():
        for prof in ("f64", "f32"):
            with config.profile(prof):
                spec = build()
                s = loop.init_sim(spec, 0, torch.arange(1), params(),
                                  device="cpu")
                lays[name, prof] = (spec, kernel_run.generated_kernel_for(
                    spec, s)[0])
    with ThreadPoolExecutor(len(lays)) as pool:
        paths = dict(zip(lays, pool.map(
            lambda k: gxx_shim.build(lays[k][1]["header"]), lays)))
    return {k: (spec, lay, gxx_shim.load(paths[k]))
            for k, (spec, lay) in lays.items()}


def _start(name, prof):
    build, params, seed, _ = CELLS[name]
    with config.profile(prof):
        spec = build()
        return loop.init_sim(spec, seed, torch.arange(LANES), params(),
                             device="cpu")


def _clone(s):
    return tree.map(lambda x: x.clone(), s)


def _diff(ref, got, rtol):
    """``interop.diff_leaves`` with NaN entries compared by position (a
    planted NaN priority or time is carried, not computed)."""
    ref, got = tree.leaves(ref), tree.leaves(got)
    bad = []
    for k, (a, b) in enumerate(zip(ref, got)):
        if a.is_floating_point() and not torch.equal(a.isnan(), b.isnan()):
            bad.append((k, "NaN entries differ"))
    return bad + interop.diff_leaves(
        [x.nan_to_num(0.0, float("inf"), float("-inf"))
         if x.is_floating_point() else x for x in ref],
        [x.nan_to_num(0.0, float("inf"), float("-inf"))
         if x.is_floating_point() else x for x in got], rtol)


def _held(built, name, prof, s, ks, to_end=True):
    """Chunks of ``ks`` events from ``s``, then (``to_end``) chunks of 64
    until no lane is live, by the host-built kernel and by the plain
    engine from the same state each time, equal leaf for leaf; returns
    the last state."""
    spec, lay, lib = built[name, prof]
    t_end = CELLS[name][3]
    with config.profile(prof):
        for k in ks:
            ker = gxx_shim.chunk(lib, _clone(s), lay, k, t_end)
            pla = loop.make_run(spec, t_end=t_end, max_steps=k)(s)
            bad = _diff(pla, ker, RTOL[prof])
            assert bad == [], (name, prof, k, [
                (lay["table"][i][0], w) for i, w in bad[:4]])
            s = pla
        if to_end:
            cond = loop.make_cond(spec, t_end)
            ker = _clone(s)
            while bool(cond(ker).any()):
                gxx_shim.chunk(lib, ker, lay, 64, t_end)
            pla = loop.make_run(spec, t_end=t_end)(s)
            bad = _diff(pla, ker, RTOL[prof])
            assert bad == [], (name, prof, "end", [
                (lay["table"][i][0], w) for i, w in bad[:4]])
            s = pla
    return s


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("name", ["park3", "park2", "harbor", "balking",
                                  "waitev"])
def test_generated_instance_matches_plain_engine(built, name, prof):
    s0 = _start(name, prof)
    end = _held(built, name, prof, s0, (1, 7, 64))
    assert int(end.err.ne(0).sum()) == 0
    assert int(end.n_events.min()) > 20


def _table(s, rows, lanes=None):
    """General-table events (slot, time, prio, seq, kind, subj, arg) on
    ``lanes`` (a bool mask, all by default)."""
    ev = s.events
    cols = {f: getattr(ev, f).clone()
            for f in ("time", "prio", "seq", "kind", "subj", "arg")}
    m = torch.ones(ev.time.shape[0], dtype=torch.bool) if lanes is None \
        else lanes
    for slot, t, prio, seq, kind, subj, arg in rows:
        for f, v in zip(cols, (t, prio, seq, kind, subj, arg)):
            cols[f][m, slot] = v
    return s._replace(events=ev._replace(**cols))


def _lanes(s, k, r):
    return torch.arange(s.clock.shape[0]) % k == r


def plant_table_ties(s):
    """Equal times at 0.5 across the words of park3's 96-slot table, their
    seqs unique as the engine stamps them (902 in slot 2, 899 in slot 35,
    901 in slot 70: slot 35 pops first), a higher priority on odd lanes
    (slot 50), and a time of 0 on every third lane (slot 90) that ties
    with the process starts' wakes (the servers' priority 1 first, then
    the visitors' lower seqs); the lanes' next seq past them."""
    s = _table(s, [(2, 0.5, 0, 902, K_TIMER, 1, SIG_JOCKEY),
                   (35, 0.5, 0, 899, K_TIMER, 2, SIG_JOCKEY),
                   (70, 0.5, 0, 901, K_TIMER, 3, SIG_JOCKEY)])
    s = _table(s, [(50, 0.5, 3, 950, K_TIMER, 4, SIG_JOCKEY)], _lanes(s, 2, 1))
    s = _table(s, [(90, 0.0, 0, 960, K_TIMER, 5, SIG_JOCKEY)],
               _lanes(s, 3, 0))
    return s._replace(events=s.events._replace(
        next_seq=torch.full_like(s.events.next_seq, 1000)))


def plant_table_full(s):
    """Every slot of the general table held by a far timer, but for one
    free slot on some lanes: the last (95), slot 31 (a word's edge) or
    slot 0; the first timer insert past them overflows."""
    n = s.events.time.shape[1]
    s = _table(s, [(i, 1e6 + i, 0, 5000 + i, K_TIMER, i % 10, SIG_JOCKEY)
                   for i in range(n)])
    for r, slot in ((1, n - 1), (2, 31), (3, 0)):
        s = _table(s, [(slot, float("inf"), 0, 0, 0, 0, 0)], _lanes(s, 4, r))
    return s


def plant_table_words(s):
    """Far timers of the visitors in one slot of each word of park3's
    96-slot table (1, 33, 64, 95), and in slot 0 on odd lanes: every
    scan visits each word, an insert takes the lowest clear bit around
    them, and a visitor's cancel of its timers clears its bits across
    the words."""
    rows = [(slot, 1e6 + slot, 0, 7000 + slot, K_TIMER, subj, SIG_JOCKEY)
            for slot, subj in ((1, 2), (33, 3), (64, 2), (95, 4))]
    s = _table(s, rows)
    s = _table(s, [(0, 2e6, 0, 7100, K_TIMER, 5, SIG_JOCKEY)],
               _lanes(s, 2, 1))
    return s._replace(events=s.events._replace(
        next_seq=torch.full_like(s.events.next_seq, 8000)))


def plant_pq_ties(s):
    """Priority queue 0: live tickets of visitors 1-3 at equal priority in
    slots 5, 33 and 60 (seqs 10, 5, 5: slot 33 dequeues first), visitor
    4's at priority -inf in slot 40; queue 1: visitors 5-7 in slots 3, 10
    and 40 at priorities 1, NaN, 2 on odd lanes (the amax is NaN: the get
    takes column 0, not live, which holds visitor 6's ticket) and 1, 1, 1
    with seqs 7, 7, 3 on even ones."""
    pq = s.pqueues
    items, prio, seq, live = (pq.items.clone(), pq.prio.clone(),
                              pq.seq.clone(), pq.live.clone())
    for slot, item, p, sq in ((5, 1.0, 0.0, 10), (33, 2.0, 0.0, 5),
                              (60, 3.0, 0.0, 5),
                              (40, 4.0, float("-inf"), 0)):
        items[:, 0, slot], prio[:, 0, slot] = item, p
        seq[:, 0, slot], live[:, 0, slot] = sq, True
    odd = _lanes(s, 2, 1)
    # column 0, which the NaN maximum's get takes: visitor 6's ticket
    items[:, 1, 0] = 6.0
    for slot, item, po, pe, sq in ((3, 5.0, 1.0, 1.0, 7),
                                   (10, 6.0, float("nan"), 1.0, 7),
                                   (40, 7.0, 2.0, 1.0, 3)):
        items[:, 1, slot] = item
        prio[:, 1, slot] = torch.where(odd, po, pe).to(prio.dtype)
        seq[:, 1, slot], live[:, 1, slot] = sq, True
    return s._replace(pqueues=pq._replace(
        items=items, prio=prio, seq=seq, live=live,
        next_seq=torch.full_like(pq.next_seq, 100)))


def plant_pq_full(s):
    """The usergen timers spec's priority queue full to its capacity (a
    producer's put pends on the rear guard) on even lanes, one below it
    on odd lanes, at priorities 0, 1 and 2 in turn."""
    pq = s.pqueues
    cap = int(pq.live.shape[2])
    live, prio, seq = pq.live.clone(), pq.prio.clone(), pq.seq.clone()
    odd = _lanes(s, 2, 1)
    for j in range(cap):
        live[:, 0, j] = ~odd if j == cap - 1 else True
        prio[:, 0, j] = float(j % 3)
        seq[:, 0, j] = j
    return s._replace(pqueues=pq._replace(
        live=live, prio=prio, seq=seq,
        next_seq=torch.full_like(pq.next_seq, cap)))


#: each plant's instance and chunks (the NaN queue's get takes column 0
#: again and again once its ticket there is stale: a chain that runs to
#: the bound, so its chunks stop short of that)
PLANTS = {"table_ties": ("park3", plant_table_ties, (1, 16, 24)),
          "table_full": ("park3", plant_table_full, (1, 16, 24)),
          "table_words": ("park3", plant_table_words, (1, 16, 24)),
          "pq_ties": ("park3", plant_pq_ties, (1, 3, 8)),
          "pq_full": ("usergent5", plant_pq_full, (1, 7, 16))}


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("plant", list(PLANTS))
def test_planted_edges_match_plain_engine(built, plant, prof):
    name, fn, ks = PLANTS[plant]
    s0 = fn(_start(name, prof))
    end = _held(built, name, prof, s0, ks, to_end=False)
    if plant == "table_full":  # the full lanes failed on the insert
        assert bool(end.err[_lanes(end, 4, 0)].ne(0).all())


def test_usergen_timers_spec_matches_plain_engine(built):
    """The usergen timers spec (a priority queue of capacity 4-16, three
    priorities, timeouts on pool and buffer waits), f64, for 32 events."""
    end = _held(built, "usergent5", "f64", _start("usergent5", "f64"),
                (1, 7, 24), to_end=False)
    assert int(end.err.ne(0).sum()) == 0


def _held_boundary(built, name, prof, s, ks, to_end=True):
    """:func:`_held` for a spec with boundary blocks: each chunk by the
    host-built kernel against the plain engine's deferred chunk from the
    same state, then the plain round on the frozen lanes (the card's
    round of a generated spec is that step); to the end, then against
    ``make_run`` with no defer.  Returns (last state, rounds)."""
    spec, lay, lib = built[name, prof]
    t_end = CELLS[name][3]
    start, rounds = s, 0
    with config.profile(prof):
        cond = loop.make_cond(spec, t_end, defer_boundary=True)
        step = kernel_run.make_boundary_step_plain(spec)

        def one(s, k):
            ker = gxx_shim.chunk(lib, _clone(s), lay, k, t_end)
            pla = loop.make_run(spec, t_end=t_end, max_steps=k,
                                defer_boundary=True)(s)
            bad = _diff(pla, ker, RTOL[prof])
            assert bad == [], (name, prof, k, [
                (lay["table"][i][0], w) for i, w in bad[:4]])
            return pla

        for k in ks:
            s = one(s, k)
            if bool(s.boundary_pending.any()):
                s, rounds = step(s), rounds + 1
        while to_end and bool((cond(s) | s.boundary_pending).any()):
            s = one(s, 64)
            if bool(s.boundary_pending.any()):
                s, rounds = step(s), rounds + 1
        if to_end:
            bad = _diff(loop.make_run(spec, t_end=t_end)(start), s,
                        RTOL[prof])
            assert bad == [], (name, prof, "end", [
                (lay["table"][i][0], w) for i, w in bad[:4]])
    return s, rounds


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_boundary_spec_matches_plain_engine(built, prof):
    """The calibrator's boundary block: frozen lanes, plain rounds, the
    run to t=35 equal to the plain engine's with no defer."""
    end, rounds = _held_boundary(built, "boundary", prof,
                                 _start("boundary", prof), (1, 7, 64))
    assert int(end.err.ne(0).sum()) == 0 and rounds >= 3
    assert bool((end.user["cal_n"] == 3).all())


def _calibrator(spec):
    return spec.n_procs - 1, spec.boundary_pcs[0]


def plant_boundary_tie(s, spec):
    """A timer of the producer (pid 0) at the calibrator's boundary wake
    time, its priority above the wake's (0) on odd lanes, equal with a
    later seq on even ones: the event dispatches first, then the wake
    freezes the lane; or the wake freezes it first."""
    cal, _ = _calibrator(spec)
    t = s.wakes.time[:, cal].clone()
    ev = s.events
    time_, prio, seq, kind, subj, arg = (ev.time.clone(), ev.prio.clone(),
                                         ev.seq.clone(), ev.kind.clone(),
                                         ev.subj.clone(), ev.arg.clone())
    odd = _lanes(s, 2, 1)
    time_[:, 0], kind[:, 0], subj[:, 0], arg[:, 0] = t, K_TIMER, 0, -5
    prio[:, 0] = torch.where(odd, 1, 0).to(prio.dtype)
    seq[:, 0] = 10_000
    return s._replace(events=ev._replace(
        time=time_, prio=prio, seq=seq, kind=kind, subj=subj, arg=arg,
        next_seq=torch.full_like(ev.next_seq, 10_001)))


def plant_boundary_timer(s, spec):
    """An event aimed at the calibrator, which holds into its boundary
    block, before its wake: a timer (kind 1, frozen by the table arm) on
    even lanes; kind 5, past the spec's handlers, on odd ones (not
    frozen: it clips to a resume that reaches the block mid-dispatch and
    fails the lane)."""
    cal, _ = _calibrator(spec)
    rows = [(1, 0.0, 0, 10_000, K_TIMER, cal, -5)]
    s = _table(s, rows)
    s = _table(s, [(1, 0.0, 0, 10_000, 5, cal, 0)], _lanes(s, 2, 1))
    t = s.clock + 0.25 * (s.wakes.time[:, cal] - s.clock)
    ev = s.events
    time_ = ev.time.clone()
    time_[:, 1] = t
    return s._replace(events=ev._replace(
        time=time_, next_seq=torch.full_like(ev.next_seq, 10_001)))


@pytest.mark.parametrize("prof", ["f64", "f32"])
@pytest.mark.parametrize("plant", ["tie", "timer"])
def test_boundary_planted_match_plain_engine(built, plant, prof):
    spec, _, _ = built["boundary", prof]
    cal, bpc = _calibrator(spec)
    s = _start("boundary", prof)
    with config.profile(prof):  # the calibrator holds into its block
        s = loop.make_run(spec, max_steps=8, defer_boundary=True)(s)
    assert bool((s.procs.pc[:, cal] == bpc).all())
    fn = plant_boundary_tie if plant == "tie" else plant_boundary_timer
    end, rounds = _held_boundary(built, "boundary", prof, fn(s, spec),
                                 (1, 1, 7, 24), to_end=False)
    assert rounds >= 1
    if plant == "timer":
        odd = _lanes(end, 2, 1)
        assert bool((end.err[odd] == loop.ERR_BOUNDARY).all())
        assert bool((end.err[~odd] == 0).all())


@pytest.mark.parametrize("prof", ["f64", "f32"])
def test_midchain_boundary_entry_fails_every_lane(built, prof):
    """The reference's mid-chain spec: the kernel (and the plain
    engine's deferred chunks) fail every lane with ERR_BOUNDARY; with no
    defer it runs clean."""
    end, rounds = _held_boundary(built, "midchain", prof,
                                 _start("midchain", prof), (1, 7),
                                 to_end=False)
    end, _ = _held_boundary(built, "midchain", prof, end, (64,),
                            to_end=False)
    assert rounds == 1
    assert bool((end.err == loop.ERR_BOUNDARY).all())
    spec = built["midchain", prof][0]
    with config.profile(prof):
        clean = loop.make_run(spec)(_start("midchain", prof))
    assert int(clean.err.ne(0).sum()) == 0


SHIM_TEST = r"""
#include "cuda_runtime.h"
extern "C" {
int t_ffs(int x) { return __ffs(x); }
int t_ffsll(long long x) { return __ffsll(x); }
int t_popc(unsigned x) { return __popc(x); }
int t_popcll(unsigned long long x) { return __popcll(x); }
int t_clzll(long long x) { return __clzll(x); }
unsigned long long t_umul64hi(unsigned long long a, unsigned long long b) {
  return __umul64hi(a, b);
}
}
"""


def test_shim_bit_intrinsics_are_exact(tmp_path):
    """``__ffs`` (1-based lowest set bit, 0 for none), ``__ffsll``,
    ``__popc``, ``__popcll``, ``__clzll`` and ``__umul64hi`` of the shim
    against Python's integers at the edges and on random words."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH")
    (tmp_path / "cuda_runtime.h").write_text(gxx_shim.SHIM_H)
    (tmp_path / "t.cc").write_text(SHIM_TEST)
    so = tmp_path / "t.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(tmp_path), "-o", str(so), str(tmp_path / "t.cc")],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.t_ffs.argtypes = [ctypes.c_int]
    lib.t_ffsll.argtypes = [ctypes.c_longlong]
    lib.t_popc.argtypes = [ctypes.c_uint]
    lib.t_popcll.argtypes = [ctypes.c_ulonglong]
    lib.t_clzll.argtypes = [ctypes.c_longlong]
    lib.t_umul64hi.argtypes = [ctypes.c_ulonglong] * 2
    lib.t_umul64hi.restype = ctypes.c_ulonglong
    rng = random.Random(14)
    words = [0, 1, 2, 3, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x10000]
    words += [rng.getrandbits(32) for _ in range(300)]
    longs = [0, 1, 1 << 32, 1 << 63, (1 << 64) - 1, 0xFFFFFFFF,
             (1 << 63) - 1] + [rng.getrandbits(64) for _ in range(300)]
    longs += [1 << rng.randrange(64) for _ in range(64)]

    def ffs(x):
        return (x & -x).bit_length()

    def signed(x, bits):
        return x - (1 << bits) if x >> (bits - 1) else x

    for x in words:
        assert lib.t_ffs(signed(x, 32)) == ffs(x), x
        assert lib.t_popc(x) == bin(x).count("1"), x
    for x in longs:
        assert lib.t_ffsll(signed(x, 64)) == ffs(x), x
        assert lib.t_popcll(x) == bin(x).count("1"), x
        assert lib.t_clzll(signed(x, 64)) == 64 - x.bit_length(), x
        y = longs[(longs.index(x) * 7 + 3) % len(longs)]
        assert lib.t_umul64hi(x, y) == (x * y) >> 64, (x, y)
