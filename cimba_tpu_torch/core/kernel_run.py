"""The chunked event loop on the card: the host loop of the CUDA chunk kernel.

Counterpart of :mod:`cimba_tpu.core.pallas_run` (``make_kernel_run``,
whose Pallas body ``_kernel_body`` advances every live lane by up to
``chunk_steps`` events per call).  Here the chunk is the hand-written
CUDA kernel ``csrc/mm1_chunk.cu``: one thread per replication lane, the
lane's state in registers, in place on the Sim's tensors.

The kernel is specialised to the M/M/1 fused-verb cycle
(``models.mm1.build(record=False)``); :func:`make_kernel_run` refuses
any other spec rather than switching to the plain engine.  On CPU
tensors the chunk is the plain engine, ``loop.make_run(spec,
max_steps=chunk_steps)`` — the version the kernel is held against —
driven by the same host loop.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cimba_tpu_torch import tree
from cimba_tpu_torch.config import BITS, INDEX
from cimba_tpu_torch.core import loop
from cimba_tpu_torch.core.model import ModelSpec

#: the Sim leaves the kernel takes, in the reference's leaf order, with
#: their dtype role and per-lane shape; roles: T time/real, I int32,
#: B u32-in-int64 word, ? bool, C event count.  Shapes name the spec's
#: dims: P processes, E event slots, G guards, Q queues, W ring width,
#: F/N float/int locals.
LEAVES = (
    ("clock", "T", ()), ("rep", "I", ()),
    ("rng.key0", "B", ()), ("rng.key1", "B", ()),
    ("rng.ctr_lo", "B", ()), ("rng.ctr_hi", "B", ()),
    ("events.time", "T", ("E",)), ("events.prio", "I", ("E",)),
    ("events.seq", "I", ("E",)), ("events.kind", "I", ("E",)),
    ("events.subj", "I", ("E",)), ("events.arg", "I", ("E",)),
    ("events.gen", "I", ("E",)), ("events.next_seq", "I", ()),
    ("events.overflow", "?", ()),
    ("wakes.time", "T", ("P",)), ("wakes.sig", "I", ("P",)),
    ("wakes.seq", "I", ("P",)),
    ("procs.pc", "I", ("P",)), ("procs.status", "I", ("P",)),
    ("procs.prio", "I", ("P",)), ("procs.pend_tag", "I", ("P",)),
    ("procs.pend_f", "T", ("P",)), ("procs.pend_f2", "T", ("P",)),
    ("procs.pend_f3", "T", ("P",)), ("procs.pend_i", "I", ("P",)),
    ("procs.pend_pc", "I", ("P",)), ("procs.pend_guard", "I", ("P",)),
    ("procs.pend_seq", "I", ("P",)), ("procs.await_pid", "I", ("P",)),
    ("procs.await_evt", "I", ("P",)), ("procs.exit_sig", "I", ("P",)),
    ("procs.got", "T", ("P",)), ("procs.locals_f", "T", ("P", "F")),
    ("procs.locals_i", "I", ("P", "N")),
    ("guards.next_seq", "I", ("G",)),
    ("queues.items", "T", ("Q", "W")), ("queues.head", "I", ("Q",)),
    ("queues.size", "I", ("Q",)),
    ("user.arr_mean", "T", ()), ("user.n_objects", "I", ()),
    ("user.srv_mean", "T", ()),
    ("user.wait.n", "T", ()), ("user.wait.w", "T", ()),
    ("user.wait.mn", "T", ()), ("user.wait.mx", "T", ()),
    ("user.wait.m1", "T", ()), ("user.wait.m2", "T", ()),
    ("user.wait.m3", "T", ()), ("user.wait.m4", "T", ()),
    ("done", "?", ()), ("err", "I", ()), ("n_events", "C", ()),
    ("boundary_pending", "?", ()),
)


def mm1_layout(spec: ModelSpec) -> dict:
    """The static shape the chunk kernel needs, or NotImplementedError
    when ``spec`` is not the mm1 fused-verb model the kernel implements
    (``cimba_tpu_torch.models.mm1.build(record=False)``)."""
    from cimba_tpu_torch.models import mm1

    names = tuple(getattr(b, "__name__", "") for b in spec.blocks)
    mods = {getattr(b, "__module__", "") for b in spec.blocks}
    q = spec.queues[0] if len(spec.queues) == 1 else None
    ok = (
        names == mm1.BLOCK_NAMES
        and mods == {mm1.__name__}
        and list(spec.proc_entry) == [0, 3]
        and list(spec.proc_prio) == [0, 0]
        and q is not None and not q.record
        and spec.n_guards == 2
        and {q.front_guard, q.rear_guard} == {0, 1}
        and spec.n_ilocals >= 1
    )
    if not ok:
        raise NotImplementedError(
            f"the CUDA chunk kernel implements only the M/M/1 fused-verb "
            f"model (models.mm1.build(record=False)); spec {spec.name!r} "
            "needs a kernel of its own (ROADMAP.md, queue B)"
        )
    return dict(E=spec.event_cap, P=2, G=2, Q=1, W=spec.queue_cap_max,
                F=max(spec.n_flocals, 1), N=max(spec.n_ilocals, 1),
                cap=q.capacity, front=q.front_guard, rear=q.rear_guard)


def _check_leaves(leaves, lay: dict, real, count):
    if len(leaves) != len(LEAVES):
        raise ValueError(f"Sim has {len(leaves)} leaves, the mm1 kernel "
                         f"takes {len(LEAVES)}")
    dtypes = {"T": real, "I": INDEX, "B": BITS, "?": torch.bool, "C": count}
    lanes = leaves[0].shape[0]
    dev = leaves[0].device
    for (name, role, dims), x in zip(LEAVES, leaves):
        shape = (lanes,) + tuple(lay[d] for d in dims)
        if x.dtype != dtypes[role] or tuple(x.shape) != shape:
            raise ValueError(f"Sim leaf {name}: {x.dtype} {tuple(x.shape)}, "
                             f"the kernel takes {dtypes[role]} {shape}")
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"Sim leaf {name} must be a contiguous tensor "
                             f"on {dev}")
    return lanes


def mm1_chunk(sims: loop.Sim, lay: dict, chunk_steps: int,
              t_end: Optional[float] = None) -> loop.Sim:
    """Launch the CUDA chunk kernel on a lane-first Sim on the card:
    every live lane advances by up to ``chunk_steps`` events, IN PLACE
    (the Sim's tensors are the kernel's inputs and outputs, as the
    Pallas call aliases them).  Launches on the current stream without
    synchronising.  ``mm1_chunk.launches`` counts launches."""
    from cimba_tpu_torch import _build

    leaves = tree.leaves(sims)
    if not leaves[0].is_cuda:
        raise ValueError("mm1_chunk takes a Sim on a CUDA device")
    real, count = sims.clock.dtype, sims.n_events.dtype
    if (real, count) not in ((torch.float32, torch.int32),
                             (torch.float64, torch.int64)):
        raise ValueError(f"no kernel instance for {real}/{count} Sims")
    lanes = _check_leaves(leaves, lay, real, count)
    lib = _build.load("mm1_chunk")
    fn = (lib.cimba_mm1_chunk_f32 if real == torch.float32
          else lib.cimba_mm1_chunk_f64)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 8
                   + [ctypes.c_int, ctypes.c_double, ctypes.c_void_p])
    ptrs = (ctypes.c_void_p * len(leaves))(*[x.data_ptr() for x in leaves])
    with torch.cuda.device(leaves[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(ptrs, len(leaves), lanes, lay["E"], lay["W"], lay["cap"],
                lay["front"], lay["rear"], lay["N"], chunk_steps,
                int(t_end is not None),
                float(t_end) if t_end is not None else 0.0, stream)
    if rc != 0:
        raise RuntimeError(f"mm1_chunk kernel launch failed (code {rc})")
    mm1_chunk.launches += 1
    return sims


mm1_chunk.launches = 0


def make_kernel_run(spec: ModelSpec, t_end: Optional[float] = None,
                    chunk_steps: int = 512, max_chunks: int = 10_000):
    """Build ``run(sims) -> sims`` over a lane-first Sim: call the chunk
    until no lane is live.  On the card each chunk is one launch of the
    CUDA kernel; on CPU tensors it is the plain engine.  After a call,
    ``run.launches`` is the number of kernel launches it made (read off
    ``mm1_chunk.launches``, the one counter).  Raises if lanes are still
    live after ``max_chunks`` chunks — a silent partial run would
    corrupt statistics."""
    lay = mm1_layout(spec)
    if chunk_steps <= 0:
        raise ValueError(f"chunk_steps must be positive, got {chunk_steps}")
    plain = loop.make_run(spec, t_end=t_end, max_steps=chunk_steps)
    cond = loop.make_cond(spec, t_end)

    def run(sims: loop.Sim) -> loop.Sim:
        if sims.clock.is_cuda:
            # the kernel works in place: keep the caller's Sim intact
            sims = tree.map(
                lambda x: x.clone(memory_format=torch.contiguous_format),
                sims)
        it, before = 0, mm1_chunk.launches
        while bool(cond(sims).any()) and it < max_chunks:
            if sims.clock.is_cuda:
                sims = mm1_chunk(sims, lay, chunk_steps, t_end)
            else:
                sims = plain(sims)
            it += 1
        run.launches = mm1_chunk.launches - before
        if bool(cond(sims).any()):
            raise RuntimeError(
                f"make_kernel_run: lanes still live after {it} chunks "
                f"(max {max_chunks} x {chunk_steps} events) — raise "
                "chunk_steps/max_chunks")
        return sims

    run.launches = 0
    return run
