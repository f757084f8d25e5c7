"""K6, the two kernels of the chunk-kernel bisect (``csrc/bisect_stages.cu``).

Counterparts of stages 0 and 1 of the JAX package's Mosaic bisect
(``tools/mosaic_bisect.py``: "copy" at ``:68``, "pop" at ``:94``).  Both
take a Sim through the leaf-pointer array the chunk kernels take
(:mod:`cimba_tpu_torch.core.kernel_run`), checked against the spec's
leaf table:

* :func:`sim_copy` — every leaf, in -> out, byte for byte: the plumbing
  that every chunk kernel shares.  Plain version: a leaf-wise clone.
* :func:`peek` — per lane, the engine's event pick
  (``eventset.peek_merged``).  Plain version: ``peek_merged`` itself.

On a Sim on the card each wrapper launches its kernel (and adds one to
its ``launches``); on a CPU Sim it runs the plain version.
:func:`plant_peek_cases` plants the cases the peek must get right (ties,
empty lanes, -inf and NaN times) into a Sim, lane by lane.
"""

from __future__ import annotations

import ctypes

import torch

from cimba_tpu_torch import tree
from cimba_tpu_torch.config import INDEX
from cimba_tpu_torch.core import eventset as ev
from cimba_tpu_torch.core import kernel_run, loop


def _checked(sims: loop.Sim, table, lay: dict):
    leaves = tree.leaves(sims)
    kernel_run._check_leaves(leaves, table, lay, sims.clock.dtype,
                             sims.n_events.dtype)
    return leaves


def sim_copy_plain(sims: loop.Sim) -> loop.Sim:
    return tree.map(lambda x: x.clone(), sims)


def copy_launcher(sims: loop.Sim, table, lay: dict, lib=None):
    """``(launch, outs)``: ``launch()`` runs the copy kernel of ``lib``
    (this checkout's build by default; ``chip_smoke.py --ab`` times
    another) from the leaves of a Sim on the card into ``outs``, on the
    current stream, without synchronising, and raises on a refused
    launch.  It counts no launch: the wrapper does."""
    from cimba_tpu_torch import _build

    leaves = _checked(sims, table, lay)
    lanes = leaves[0].shape[0]
    outs = [torch.empty_like(x) for x in leaves]
    n = len(leaves)
    fn = (lib or _build.load("bisect_stages")).cimba_sim_copy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    ins = (ctypes.c_void_p * n)(*[x.data_ptr() for x in leaves])
    out_p = (ctypes.c_void_p * n)(*[y.data_ptr() for y in outs])
    rows = (ctypes.c_int * n)(*[x.numel() // lanes for x in leaves])
    sizes = (ctypes.c_int * n)(*[x.element_size() for x in leaves])
    dev = leaves[0].device

    def launch():
        with torch.cuda.device(dev):
            rc = fn(ins, out_p, rows, sizes, n, lanes,
                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"sim_copy kernel launch failed (code {rc})")

    return launch, outs


def sim_copy(sims: loop.Sim, table, lay: dict) -> loop.Sim:
    """A copy of ``sims`` (``table``/``lay``: the spec's leaf table and
    layout, ``kernel_run.kernel_for``), made by the copy kernel on the
    card; on the current stream, without synchronising."""
    if not sims.clock.is_cuda:
        return sim_copy_plain(sims)
    launch, outs = copy_launcher(sims, table, lay)
    launch()
    sim_copy.launches += 1
    return tree.unflatten(sims, outs)


def peek_plain(sims: loop.Sim) -> ev.Event:
    return ev.peek_merged(sims.events, sims.wakes, sims.procs.prio,
                          loop.K_PROC)[0]


def peek_args(lib, sims: loop.Sim, leaves: list) -> tuple:
    """The peek's C entry in ``lib`` for the Sim's profile with its
    argument types set, the leaves' pointer array, a new Event of ``[L]``
    outputs on the leaves' device and their pointer array."""
    lanes, dev = leaves[0].shape[0], leaves[0].device
    out = ev.Event(
        time=torch.empty((lanes,), dtype=sims.clock.dtype, device=dev),
        prio=torch.empty((lanes,), dtype=INDEX, device=dev),
        kind=torch.empty((lanes,), dtype=INDEX, device=dev),
        subj=torch.empty((lanes,), dtype=INDEX, device=dev),
        arg=torch.empty((lanes,), dtype=INDEX, device=dev),
        found=torch.empty((lanes,), dtype=torch.bool, device=dev),
        handle=torch.empty((lanes,), dtype=INDEX, device=dev),
    )
    fn = getattr(lib, "cimba_peek_f32" if sims.clock.dtype == torch.float32
                 else "cimba_peek_f64")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    ptrs = (ctypes.c_void_p * len(leaves))(*[x.data_ptr() for x in leaves])
    outs = (ctypes.c_void_p * 7)(*[x.data_ptr() for x in out])
    return fn, ptrs, out, outs


def peek_launcher(sims: loop.Sim, table, lay: dict, lib=None):
    """``(launch, out)``: ``launch()`` runs the peek kernel of ``lib``
    (this checkout's build by default) on a Sim on the card into the
    Event ``out``, as :func:`copy_launcher` runs the copy."""
    from cimba_tpu_torch import _build

    leaves = _checked(sims, table, lay)
    dev = leaves[0].device
    fn, ptrs, out, outs = peek_args(lib or _build.load("bisect_stages"),
                                    sims, leaves)
    lanes = leaves[0].shape[0]

    def launch():
        with torch.cuda.device(dev):
            rc = fn(ptrs, len(leaves), lanes, lay["E"], lay["P"],
                    loop.K_PROC, outs,
                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"peek kernel launch failed (code {rc})")

    return launch, out


def peek(sims: loop.Sim, table, lay: dict) -> ev.Event:
    """Every lane's next event, not consumed (``eventset.Event`` of
    ``[L]`` tensors), computed by the peek kernel on the card; on the
    current stream, without synchronising."""
    if not sims.clock.is_cuda:
        return peek_plain(sims)
    launch, out = peek_launcher(sims, table, lay)
    launch()
    peek.launches += 1
    return out


#: the planted cases of :func:`plant_peek_cases`, by ``lane % 12``
PEEK_CASES = ("as_is", "time_tie", "prio_tie", "same_key", "empty",
              "minus_inf", "nan", "nan_beside_wake", "event_before_wake",
              "wake_before_event", "same_wake_key", "wake_minus_inf")


def plant_peek_cases(sims: loop.Sim) -> loop.Sim:
    """``sims`` with lane l set to case ``PEEK_CASES[l % 12]`` (a case
    that needs two event slots or two processes leaves a narrower lane as
    it is).  t is one before the lane's earliest finite time (0 where it
    has none).  Events: ``time_tie``, slots 0 and 1 at t, prio 3 and 5;
    ``prio_tie``, both at (t, 4), seq 9 and 7; ``same_key``, both at (t,
    4, 7) with kind, subj, arg, gen (2, 5, 1, 10) and (3, 6, 2, 20),
    which the pick sums; ``empty``, no event and no wake; ``minus_inf``
    and ``nan``, slot 0 at -inf or slot 1 at NaN, no wake;
    ``nan_beside_wake``, slot 1 at NaN, the wakes as they are.  Across
    the tables: process 0's wake at t, its prio 2, seq 50, and event slot
    0 at (t, 2) with seq 40 (``event_before_wake``) or 60
    (``wake_before_event``).  Wakes: ``same_wake_key``, processes 0 and 1
    at t, prio 1, seq 8, signals 3 and 4 (summed); ``wake_minus_inf``,
    process 0's wake at -inf."""
    ev, wk = sims.events, sims.wakes
    L, E = ev.time.shape
    P = wk.time.shape[1]
    case = torch.arange(L, device=ev.time.device) % len(PEEK_CASES)
    e = {f: getattr(ev, f).clone()
         for f in ("time", "prio", "seq", "kind", "subj", "arg", "gen")}
    w = {f: getattr(wk, f).clone() for f in ("time", "sig", "seq")}
    prio = sims.procs.prio.clone()
    both = torch.cat([ev.time, wk.time], dim=1)
    first = torch.where(torch.isfinite(both), both,
                        torch.full_like(both, float("inf"))).amin(1)
    t = torch.where(torch.isfinite(first), first - 1.0,
                    torch.zeros_like(first))
    inf, nan = float("inf"), float("nan")

    def put(col_of, c, col, v):
        """Column ``col`` of ``col_of`` set to ``v`` in the lanes of
        case ``c``."""
        m = case == PEEK_CASES.index(c)
        v = torch.as_tensor(v, device=col_of.device).to(col_of.dtype)
        col_of[:, col] = torch.where(m, v.expand(L), col_of[:, col])

    def event(c, col, time, p, seq, fields=(1, 0, 0, 0)):
        for f, v in zip(("time", "prio", "seq", "kind", "subj", "arg",
                         "gen"), (time, p, seq, *fields)):
            put(e[f], c, col, v)

    if E >= 2:
        event("time_tie", 0, t, 3, 11)
        event("time_tie", 1, t, 5, 12)
        event("prio_tie", 0, t, 4, 9)
        event("prio_tie", 1, t, 4, 7)
        event("same_key", 0, t, 4, 7, (2, 5, 1, 10))
        event("same_key", 1, t, 4, 7, (3, 6, 2, 20))
        put(e["time"], "nan", 1, nan)
        put(e["time"], "nan_beside_wake", 1, nan)
    for c in ("empty", "minus_inf", "nan"):
        for col in range(E):
            if not (c == "nan" and col == 1):
                put(e["time"], c, col, inf)
        for col in range(P):
            put(w["time"], c, col, inf)
    put(e["time"], "minus_inf", 0, -inf)
    for c, seq in (("event_before_wake", 40), ("wake_before_event", 60)):
        put(w["time"], c, 0, t)
        put(w["seq"], c, 0, 50)
        put(prio, c, 0, 2)
        event(c, 0, t, 2, seq)
    if P >= 2:
        for col, sig in ((0, 3), (1, 4)):
            put(w["time"], "same_wake_key", col, t)
            put(w["seq"], "same_wake_key", col, 8)
            put(w["sig"], "same_wake_key", col, sig)
            put(prio, "same_wake_key", col, 1)
    put(w["time"], "wake_minus_inf", 0, -inf)
    return sims._replace(
        events=ev._replace(**e), wakes=wk._replace(**w),
        procs=sims.procs._replace(prio=prio))


sim_copy.launches = 0
peek.launches = 0
