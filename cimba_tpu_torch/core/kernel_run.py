"""The chunked event loop on the card: the host loop of the CUDA chunk kernels.

Counterpart of :mod:`cimba_tpu.core.pallas_run` (``make_kernel_run``,
whose Pallas body ``_kernel_body`` advances every live lane by up to
``chunk_steps`` events per call).  Here a chunk is one launch of a
hand-written CUDA kernel specialised to one spec, in place on the Sim's
tensors:

* ``csrc/queue_chunk.cu`` — the models of the templated single-queue
  engine, one thread per lane, the lane's state in registers: the
  fused-verb single-queue cycle that ``models.mm1.build`` and
  ``models.mmc.build(c)`` share, the same cycle with lognormal service
  (``models.mg1.build``), the two-station network
  ``models.tandem.build``, and the job shop ``models.jobshop.build``
  (a resource pool, a buffer and a condition, no object queue);
  instances for (family, servers, recording) in
  :data:`QUEUE_INSTANCES`;
* ``csrc/awacs_chunk.cu`` — the AWACS target legs
  (``models.awacs.build(n)``), 16 threads a lane, the per-pid columns in
  device memory; and its boundary round, the dwell kernel (a warp a
  lane).

These six hand-written families (M/M/1, M/M/c, M/G/1, tandem, the job
shop and AWACS) are chosen first.  Any other spec built from the toolkit
the port has runs through a *generated* family of the single-queue
engine (:func:`generated_kernel_for`): its blocks and predicates are
traced (:mod:`cimba_tpu_torch.core.trace`) on the Sim the run starts
from, emitted as a header (:mod:`cimba_tpu_torch.core.emit`) and built
with the engine into ``build/gen/<hash>/`` at first use
(:func:`cimba_tpu_torch._build.build_gen`).  A spec the generator
cannot take raises, naming the verb, op, leaf or sampler; nothing
switches to the plain engine.  On CPU tensors the chunk is the plain engine,
``loop.make_run(spec, max_steps=chunk_steps, defer_boundary=True)`` —
the version the kernels are held against — driven by the same host loop.

Boundary protocol (parity: ``pallas_run.py`` ``_boundary_apply``).  A
chunk freezes a lane whose next dispatch targets a boundary block
(``Model.boundary_block``) with ``boundary_pending`` set; after such a
chunk the host applies one ordinary engine step (``loop.make_step``,
defer off) to exactly the frozen lanes and clears the flag
(:func:`make_boundary_step`).  For AWACS that step is the radar dwell:
on the card one launch of the dwell kernel (:func:`awacs_dwell`), which
runs the step, the features and the detection MLP of every frozen lane;
on CPU tensors its plain version, the gathered lanes stepped by the
plain engine (:func:`make_boundary_step_plain`).

Horizon (parity: ``make_cond``'s ``lim = sim.t_stop if sim.t_stop is not
None else t_end``).  A Sim that carries the per-lane ``t_stop`` leaf
passes it to every kernel as the pointer array's last leaf, and each
lane compares its next event time with its own horizon (:data:`H_LANE`);
otherwise the kernel takes the scalar ``t_end`` (:data:`H_SCALAR`) or no
horizon (:data:`H_NONE`).  The mode is a run-time argument, so one
instance serves all three.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from cimba_tpu_torch import tree
from cimba_tpu_torch.config import BITS, INDEX
from cimba_tpu_torch.core import loop
from cimba_tpu_torch.core.model import ModelSpec

# The Sim leaves a kernel takes, in the reference's leaf order, with their
# dtype role and per-lane shape; roles: T time/real, I int32, B
# u32-in-int64 word, ? bool, C event count.  Shapes name the spec's dims:
# P processes, E event slots, G guards, Q queues, W ring width, F/N
# float/int locals, X targets, K resource pools, V buffers.
_HEAD = (
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
)
_TAIL = (
    ("done", "?", ()), ("err", "I", ()), ("n_events", "C", ()),
    ("boundary_pending", "?", ()),
)
_SUMMARY = tuple((f"{{}}.{f}", "T", ()) for f in
                 ("n", "w", "mn", "mx", "m1", "m2", "m3", "m4"))


def _acc(part: str, dim: str) -> tuple:
    """A component's StepAccum leaves (``Sim.<part>.acc``), one row per
    component of dimension ``dim``."""
    return tuple((f"{part}.acc.summary.{f}", "T", (dim,)) for f in
                 ("n", "w", "mn", "mx", "m1", "m2", "m3", "m4")) + (
        (f"{part}.acc.last_t", "T", (dim,)),
        (f"{part}.acc.last_v", "T", (dim,)),
        (f"{part}.acc.started", "?", (dim,)),
    )


#: the queue's StepAccum (``Sim.queues.acc``), one row per queue
_ACC = _acc("queues", "Q")
#: the resource pools' and buffers' leaves (``Sim.pools``,
#: ``Sim.buffers``), their recording accumulators included
_POOLS = (
    ("pools.level", "T", ("K",)), ("pools.held", "T", ("K", "P")),
    ("pools.held_seq", "I", ("K", "P")), ("pools.next_seq", "I", ("K",)),
) + _acc("pools", "K")
_BUFFERS = (("buffers.level", "T", ("V",)),) + _acc("buffers", "V")


def _summary(key: str) -> tuple:
    return tuple((n.format(f"user.{key}"), r, d) for n, r, d in _SUMMARY)


def _scalars(*keys: str) -> tuple:
    return tuple((f"user.{k}",
                  "I" if k in ("n_objects", "n_jobs", "maintenance_runs")
                  else "T", ())
                 for k in keys)


#: the user leaves of each model family of the single-queue engine, in
#: sorted key order
_USER = {
    "mm": _scalars("arr_mean", "n_objects", "srv_mean") + _summary("wait"),
    "mg1": (_scalars("arr_mean", "ln_mu", "ln_sigma", "n_objects")
            + _summary("wait")),
    "tandem": (_scalars("arr_mean", "n_objects", "p_back", "s1_mean",
                        "s2_mean")
               + _summary("w1") + _summary("w2") + _summary("wait")),
    "shop": (_scalars("arr_mean") + _summary("done")
             + _scalars("maintenance_runs", "n_jobs", "work_mean")),
}
#: the user state's keys a family's spec must have (from its user_init)
_USER_KEYS = {f: tuple(sorted({n.split(".")[1] for n, _, _ in leaves}))
              for f, leaves in _USER.items()}


@functools.lru_cache(maxsize=None)
def queue_leaves(family: str, record: bool) -> tuple:
    """The single-queue engine's leaves for a model ``family`` ("mm",
    "mg1", "tandem" or "shop"), with the queues' recording accumulators
    when ``record``; the job shop has no object queue, and its pool's
    and buffer's leaves (always recording) in their place."""
    if family == "shop":
        return _HEAD + _POOLS + _BUFFERS + _USER[family] + _TAIL
    return _HEAD + (
        ("queues.items", "T", ("Q", "W")), ("queues.head", "I", ("Q",)),
        ("queues.size", "I", ("Q",)),
    ) + (_ACC if record else ()) + _USER[family] + _TAIL


#: (family, servers, recording) of the single-queue engine's instances:
#: mm1.build(record=False); mm1.build() and mmc.build(1);
#: mmc.build(2..4); mg1.build() (lognormal service); tandem.build() (two
#: servers, two recording queues); jobshop.build() (two stage-B
#: processes; a recording pool and buffer)
QUEUE_INSTANCES = (("mm", 1, False), ("mm", 1, True), ("mm", 2, True),
                   ("mm", 3, True), ("mm", 4, True), ("mg1", 1, True),
                   ("tandem", 2, True), ("shop", 2, True))

#: the AWACS kernel's leaves (no queues; user keys in sorted order)
AWACS_LEAVES = _HEAD + _summary("detections") + (
    ("user.dwells", "I", ()),
    ("user.pos_x", "T", ("X",)), ("user.pos_y", "T", ("X",)),
    ("user.t_end", "T", ()), ("user.t_mark", "T", ("X",)),
    ("user.vel_x", "T", ("X",)), ("user.vel_y", "T", ("X",)),
) + _TAIL


def _user_keys(spec: ModelSpec, arity: int):
    """The sorted keys of the user state ``spec.user_init`` makes from
    one lane of ``arity`` placeholder parameters (reals, then an integer
    count), or None when it takes no such parameters."""
    if spec.user_init is None:
        return None
    params = tuple(torch.ones(1, dtype=torch.float64)
                   for _ in range(arity - 1)) + (
        torch.ones(1, dtype=torch.int32),)
    try:
        user = spec.user_init(params)
    except (TypeError, ValueError, KeyError, IndexError, RuntimeError):
        return None
    return tuple(sorted(user)) if isinstance(user, dict) else None


def _queue_family(spec: ModelSpec):
    """``(family, servers, record)`` when ``spec`` is a model the
    single-queue engine restates: the fused-verb single-queue cycle of
    ``models.mm1`` or ``models.mmc`` (family "mm", one arrival and
    ``servers`` service processes) or of ``models.mg1`` (lognormal
    service), the network of ``models.tandem``, or the job shop of
    ``models.jobshop`` (family "shop"); else None.  A family is told by
    the blocks' module and the user state's keys, not by the block names
    alone (mg1 shares mm1's)."""
    from cimba_tpu_torch.models import jobshop, mg1, mm1, mmc, tandem

    names = tuple(getattr(b, "__name__", "") for b in spec.blocks)
    mods = frozenset(getattr(b, "__module__", "") for b in spec.blocks)
    if (spec.boundary_pcs or spec.n_ilocals < 1
            or any(p != 0 for p in spec.proc_prio)):
        return None
    qs = spec.queues
    if names == jobshop.BLOCK_NAMES:
        pools, bufs, conds = spec.pools, spec.buffers, spec.conditions
        ok = (
            mods == {jobshop.__name__}
            and list(spec.proc_entry) == [0, 4, 4, 7]
            and not qs and len(pools) == len(bufs) == len(conds) == 1
            and spec.n_guards == 4
            # the guards in the order the model allots them: the buffer's
            # front and rear, the pool's, the condition's (observing the
            # buffer's two)
            and (bufs[0].front_guard, bufs[0].rear_guard, pools[0].guard,
                 conds[0].guard, conds[0].observes) == (0, 1, 2, 3, (0, 1))
            and pools[0].record and bufs[0].record
            and set(spec.constants) >= {"backlog", "b_slow"}
            and _user_keys(spec, 3) == _USER_KEYS["shop"]
        )
        return ("shop", 2, True) if ok else None
    if spec.pools or spec.buffers or spec.conditions:
        return None
    if names == mm1.BLOCK_NAMES == mmc.BLOCK_NAMES == mg1.BLOCK_NAMES:
        family = {frozenset({mm1.__name__}): "mm",
                  frozenset({mmc.__name__}): "mm",
                  frozenset({mg1.__name__}): "mg1"}.get(mods)
        ns = spec.n_procs - 1
        ok = (
            family is not None
            and ns >= 1
            and list(spec.proc_entry) == [0] + [3] * ns
            and len(qs) == 1
            and spec.n_guards == 2
            and {qs[0].front_guard, qs[0].rear_guard} == {0, 1}
            and _user_keys(spec, 4 if family == "mg1" else 3)
            == _USER_KEYS[family]
        )
        return (family, ns, bool(qs[0].record)) if ok else None
    ok = (
        names == tandem.BLOCK_NAMES
        and mods == {tandem.__name__}
        and list(spec.proc_entry) == [0, 3, 6]
        and len(qs) == 2
        and spec.n_guards == 4
        and [(q.front_guard, q.rear_guard) for q in qs] == [(0, 1), (2, 3)]
        and all(q.record for q in qs)
        and _user_keys(spec, 5) == _USER_KEYS["tandem"]
    )
    return ("tandem", 2, True) if ok else None


def _is_awacs(spec: ModelSpec) -> bool:
    from cimba_tpu_torch.models import awacs

    names = tuple(getattr(b, "__name__", "") for b in spec.blocks)
    mods = {getattr(b, "__module__", "") for b in spec.blocks}
    n = spec.n_procs - 1
    return (
        names == awacs.BLOCK_NAMES
        and mods == {awacs.__name__}
        and n >= 1
        and list(spec.proc_entry) == [0] * n + [1]
        and list(spec.proc_prio) == [0] * n + [1]
        and not spec.queues
        and spec.boundary_pcs == (1,)
    )


def _refuse(spec: ModelSpec, family: str):
    raise NotImplementedError(
        f"spec {spec.name!r} is not {family}, which this hand-written "
        f"kernel restates (kernel_for chooses the generated family for "
        f"other specs)")


def queue_layout(spec: ModelSpec) -> dict:
    """The static shape the single-queue chunk kernel needs: the model
    ``family``, the server count ``NS`` and recording flag ``REC`` select
    its instance; per queue its capacity and guards (the job shop: its
    pool's and buffer's counts ``K``, ``V`` and capacities, and its
    ``backlog`` and ``b_slow``).  Raises
    NotImplementedError when ``spec`` is none of the families, or has a
    server count no instance serves."""
    shape = _queue_family(spec)
    if shape is None:
        _refuse(spec, "a model of the single-queue engine's hand-written "
                      "families")
    if shape not in QUEUE_INSTANCES:
        have = ", ".join(f"{n} server{'s' * (n > 1)}"
                         f"{' recording' if r else ''}"
                         for f, n, r in QUEUE_INSTANCES if f == "mm")
        raise NotImplementedError(
            f"spec {spec.name!r} has {shape[1]} servers"
            f"{' and records its queue' if shape[2] else ''}: the CUDA "
            f"single-queue chunk kernel has instances for {have} only "
            "(csrc/queue_chunk.cu)")
    family, ns, rec = shape
    qs = spec.queues
    lay = dict(family=family, NS=ns, REC=rec, E=spec.event_cap,
               P=spec.n_procs, G=spec.n_guards, Q=len(qs),
               W=spec.queue_cap_max, F=max(spec.n_flocals, 1),
               N=max(spec.n_ilocals, 1),
               caps=tuple(q.capacity for q in qs),
               fronts=tuple(q.front_guard for q in qs),
               rears=tuple(q.rear_guard for q in qs))
    if family == "shop":
        # the pool's and the buffer's capacities and the blocks' build
        # constants, which the kernel takes as arguments
        lay.update(K=len(spec.pools), V=len(spec.buffers),
                   pool_cap=spec.pools[0].capacity,
                   buf_cap=spec.buffers[0].capacity,
                   backlog=float(spec.constants["backlog"]),
                   b_slow=float(spec.constants["b_slow"]))
    return lay


def awacs_layout(spec: ModelSpec) -> dict:
    """The static shape the AWACS chunk and dwell kernels need, with the
    sensor's scoring (``"nn"`` or ``"threshold"``, which the dwell
    computes), or NotImplementedError when ``spec`` is not
    ``models.awacs.build(n)``."""
    if not _is_awacs(spec):
        _refuse(spec, "models.awacs.build(n)")
    return dict(E=spec.event_cap, P=spec.n_procs, X=spec.n_procs - 1,
                G=spec.n_guards, F=max(spec.n_flocals, 1),
                N=max(spec.n_ilocals, 1),
                scoring=spec.blocks[1].scoring)


def _check_leaves(leaves, table, lay: dict, real, count,
                  horizon: bool = False):
    """Every leaf of the Sim as the kernel's leaf table has it: its dtype
    (a role, or a generated table's own dtype) and its per-lane shape
    (dims named in ``lay``, or a generated table's sizes).  With
    ``horizon`` the Sim's last leaf is its ``t_stop``, one time a lane,
    after the table's."""
    if horizon:
        table = tuple(table) + (("t_stop", "T", ()),)
    if len(leaves) != len(table):
        raise ValueError(f"Sim has {len(leaves)} leaves, the kernel takes "
                         f"{len(table)}")
    from cimba_tpu_torch.core.emit import MAX_LEAVES

    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"Sim has {len(leaves)} leaves (its t_stop "
                         f"counted), the kernel's pointer array holds "
                         f"{MAX_LEAVES}")
    dtypes = {"T": real, "I": INDEX, "B": BITS, "?": torch.bool, "C": count}
    lanes = leaves[0].shape[0]
    dev = leaves[0].device
    for (name, role, dims), x in zip(table, leaves):
        shape = (lanes,) + tuple(lay[d] if isinstance(d, str) else d
                                 for d in dims)
        dt = dtypes[role] if isinstance(role, str) else role
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"Sim leaf {name}: {x.dtype} {tuple(x.shape)}, "
                             f"the kernel takes {dt} {shape}")
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"Sim leaf {name} must be a contiguous tensor "
                             f"on {dev}")
    return lanes


def refuse_observed(sims: Optional[loop.Sim]) -> None:
    """The kernel-path contract (the reference's): a Sim carrying the
    flight recorder's ring or the metrics registry is refused by every
    CUDA chunk kernel, loudly — the ring and the registry are never
    dropped, and the run never moves to the plain engine on its own."""
    from cimba_tpu_torch.obs import metrics as obs_metrics
    from cimba_tpu_torch.obs import trace as obs_trace

    if sims is None:
        return
    if sims.trace is not None:
        raise RuntimeError(obs_trace.KERNEL_REFUSAL)
    if sims.metrics is not None:
        raise RuntimeError(obs_metrics.KERNEL_REFUSAL)


def _launch(lib_name, entry: str, table, sims: loop.Sim, lay: dict,
            args) -> None:
    """One launch of ``cimba_<entry>_<f32|f64>`` of ``csrc/<lib_name>.cu``
    (or of a loaded library) on the current stream: (leaf pointers,
    count, lanes, *args, stream), ``args`` as (ctypes type, value)
    pairs."""
    from cimba_tpu_torch import _build

    refuse_observed(sims)
    leaves = tree.leaves(sims)
    if not leaves[0].is_cuda:
        raise ValueError(f"{entry} takes a Sim on a CUDA device")
    real, count = sims.clock.dtype, sims.n_events.dtype
    if (real, count) not in ((torch.float32, torch.int32),
                             (torch.float64, torch.int64)):
        raise ValueError(f"no kernel instance for {real}/{count} Sims")
    lanes = _check_leaves(leaves, table, lay, real, count,
                          sims.t_stop is not None)
    lib = _build.load(lib_name) if isinstance(lib_name, str) else lib_name
    fn = getattr(lib, f"cimba_{entry}_"
                      f"{'f32' if real == torch.float32 else 'f64'}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [t for t, _ in args] + [ctypes.c_void_p])
    ptrs = (ctypes.c_void_p * len(leaves))(*[x.data_ptr() for x in leaves])
    with torch.cuda.device(leaves[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(ptrs, len(leaves), lanes, *[v for _, v in args], stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed (code {rc})")


#: a chunk's horizon (the kernels' ``horizon`` argument): none, the
#: scalar ``t_end``, or each lane's ``t_stop`` leaf, the pointer array's
#: last
H_NONE, H_SCALAR, H_LANE = 0, 1, 2


def horizon_mode(sims: Optional[loop.Sim], t_end: Optional[float]) -> int:
    """The horizon a chunk of ``sims`` keeps: each lane's own where the
    Sim carries ``t_stop`` (which ``loop.make_cond`` reads in place of
    ``t_end``), else ``t_end``'s, else none."""
    if sims is not None and sims.t_stop is not None:
        return H_LANE
    return H_NONE if t_end is None else H_SCALAR


def _chunk_args(shape_args, chunk_steps: int, t_end: Optional[float],
                sims: Optional[loop.Sim] = None):
    return ([(ctypes.c_double if isinstance(a, float) else ctypes.c_int, a)
             for a in shape_args]
            + [(ctypes.c_int, chunk_steps),
               (ctypes.c_int, horizon_mode(sims, t_end)),
               (ctypes.c_double,
                float(t_end) if t_end is not None else 0.0)])


def queue_entry(lay: dict) -> tuple:
    """``(entry, shape)``: the C entry of the single-queue engine's
    instance for ``lay`` (``cimba_<entry>_<f32|f64>``) and the numbers
    of its shape that it takes after the lane count (ints, and for the
    job shop floats, which go as doubles)."""
    q = tuple(x for cfg in zip(lay["caps"], lay["fronts"], lay["rears"])
              for x in cfg)
    if lay["family"] == "shop":
        return "shop_chunk", (lay["E"], lay["N"], float(lay["pool_cap"]),
                              float(lay["buf_cap"]), lay["backlog"],
                              lay["b_slow"])
    if lay["family"] == "mm":
        return "queue_chunk", (lay["NS"], int(lay["REC"]), lay["E"],
                               lay["W"]) + q + (lay["N"],)
    return f"{lay['family']}_chunk", (lay["E"], lay["W"]) + q + (lay["N"],)


def queue_chunk(sims: loop.Sim, lay: dict, chunk_steps: int,
                t_end: Optional[float] = None) -> loop.Sim:
    """Launch the single-queue chunk kernel's instance for ``lay``
    (:func:`queue_layout`) on a lane-first Sim on the card: every live
    lane advances by up to ``chunk_steps`` events, IN PLACE (the Sim's
    tensors are the kernel's inputs and outputs, as the Pallas call
    aliases them).  A Sim with a ``t_stop`` leaf runs each lane to its own
    horizon, in place of ``t_end``.  Launches on the current stream
    without synchronising.  ``queue_chunk.launches`` counts launches, of
    every family's instances."""
    entry, shape = queue_entry(lay)
    _launch("queue_chunk", entry, queue_leaves(lay["family"], lay["REC"]),
            sims, lay, _chunk_args(shape, chunk_steps, t_end, sims))
    queue_chunk.launches += 1
    return sims


def awacs_chunk(sims: loop.Sim, lay: dict, chunk_steps: int,
                t_end: Optional[float] = None) -> loop.Sim:
    """Launch the AWACS chunk kernel, in place, as :func:`queue_chunk`
    does: up to ``chunk_steps`` target legs per live lane; a lane whose
    next dispatch is the sensor freezes with ``boundary_pending`` set.
    ``awacs_chunk.launches`` counts launches."""
    _launch("awacs_chunk", "awacs_chunk", AWACS_LEAVES, sims, lay,
            _chunk_args((lay["E"], lay["P"]), chunk_steps, t_end, sims))
    awacs_chunk.launches += 1
    return sims


def awacs_dwell(sims: loop.Sim, lay: dict) -> loop.Sim:
    """The AWACS boundary round on the card: one launch of the dwell
    kernel of ``csrc/awacs_chunk.cu``, IN PLACE, which gives every lane
    with ``boundary_pending`` set one ordinary engine step (the sensor's
    dwell, its detection MLP fused in with scoring "nn") and clears the
    flag; the other lanes are untouched.  Launches on the current stream
    without synchronising.  ``awacs_dwell.launches`` counts launches."""
    from cimba_tpu_torch.models import awacs

    nn = lay["scoring"] == "nn"
    weights = awacs._weights(sims.clock.device)[1].data_ptr() if nn else None
    _launch("awacs_chunk", "awacs_dwell", AWACS_LEAVES, sims, lay,
            [(ctypes.c_int, lay["E"]), (ctypes.c_int, lay["P"]),
             (ctypes.c_void_p, weights), (ctypes.c_int, int(nn))])
    awacs_dwell.launches += 1
    return sims


def gen_chunk(sims: loop.Sim, lay: dict, chunk_steps: int,
              t_end: Optional[float] = None) -> loop.Sim:
    """Launch a generated instance of the chunk kernel (``lay`` from
    :func:`generated_kernel_for`) in place, as :func:`queue_chunk` does.
    ``gen_chunk.launches`` counts launches, of every generated
    instance."""
    from cimba_tpu_torch import _build

    _launch(_build.load_gen(lay["header"]), "gen_chunk", lay["table"], sims,
            lay, _chunk_args((lay["E"], lay["W"]), chunk_steps, t_end,
                             sims))
    gen_chunk.launches += 1
    return sims


def gen_smem_bytes(header: str) -> int:
    """The dynamic shared memory a block of the generated instance of
    ``header`` (a layout's, :func:`generated_kernel_for`) takes, as its
    library computes it; 0 where its columns are static shared memory."""
    from cimba_tpu_torch import _build

    prof = "f64" if "#define CIMBA_GEN_F64" in header else "f32"
    fn = getattr(_build.load_gen(header), f"cimba_gen_smem_{prof}")
    fn.restype = ctypes.c_int
    return int(fn())


queue_chunk.launches = 0
awacs_chunk.launches = 0
awacs_dwell.launches = 0
gen_chunk.launches = 0

#: generated layouts, by spec and the Sim's structure
_GEN: dict = {}


def generated_kernel_for(spec: ModelSpec, sims: loop.Sim):
    """``(layout, gen_chunk, leaf table)`` of the generated family for
    ``spec`` in the profile and shapes of ``sims`` (any Sim of the
    spec, on any device: its first lane is traced).  Any spec built from
    the ported toolkit takes it, the six hand-written families' too;
    NotImplementedError names what a spec uses that it cannot take."""
    from cimba_tpu_torch.core import emit
    from cimba_tpu_torch.core import trace

    refuse_observed(sims)
    # the horizon leaf is the kernel's run-time argument: one instance
    # serves a Sim with it and without it (each launch counts it against
    # the pointer array, _check_leaves)
    sims = sims._replace(t_stop=None)
    named = trace.named_leaves(sims)
    key = (id(spec), tuple((n, x.dtype, tuple(x.shape[1:]))
                           for n, x in named))
    got = _GEN.get(key)
    if got is not None and got[0] is spec:
        return got[1], gen_chunk, got[1]["table"]
    header = emit.emit(spec, sims)
    table = tuple((n, x.dtype, tuple(x.shape[1:])) for n, x in named)
    lay = dict(family="gen", header=header, table=table, E=spec.event_cap,
               W=spec.queue_cap_max, P=spec.n_procs, G=spec.n_guards,
               NS=0, REC=False)
    _GEN[key] = (spec, lay)
    return lay, gen_chunk, table


def _hand_written(spec: ModelSpec):
    if _queue_family(spec) is not None:
        lay = queue_layout(spec)
        return lay, queue_chunk, queue_leaves(lay["family"], lay["REC"])
    if _is_awacs(spec):
        return awacs_layout(spec), awacs_chunk, AWACS_LEAVES
    return None


def load_library(kernel, lay: dict):
    """The built library a chunk wrapper (``queue_chunk``,
    ``awacs_chunk`` or ``gen_chunk``) launches for ``lay``, compiled
    first where this checkout has not built it (the build-or-load leg of
    ``obs.prof``'s report)."""
    from cimba_tpu_torch import _build

    if kernel is gen_chunk:
        return _build.load_gen(lay["header"])
    return _build.load("awacs_chunk" if kernel is awacs_chunk
                       else "queue_chunk")


class NeedsSim(NotImplementedError):
    """:func:`kernel_for` of a spec whose kernel is generated, without a
    Sim to trace it on."""


def kernel_for(spec: ModelSpec, sims: Optional[loop.Sim] = None):
    """``(layout, chunk wrapper, leaf table)`` of the spec's CUDA chunk
    kernel: a hand-written family's where the spec is one, else the
    generated family's for ``sims`` (:func:`generated_kernel_for`;
    :class:`NeedsSim` without a Sim to trace, NotImplementedError for a
    spec it cannot take).  A Sim carrying the flight recorder's ring or
    the metrics registry raises (:func:`refuse_observed`)."""
    refuse_observed(sims)
    hand = _hand_written(spec)
    if hand is not None:
        return hand
    from cimba_tpu_torch.core import emit

    emit.check_spec(spec)
    if sims is None:
        raise NeedsSim(
            f"spec {spec.name!r} runs on a generated kernel, traced from a "
            "Sim of the spec: pass one")
    return generated_kernel_for(spec, sims)


def make_boundary_step_plain(spec: ModelSpec):
    """The boundary round's plain version: ``apply(sims) -> sims``, one
    ordinary engine step (``loop.make_step``, defer off) on exactly the
    lanes with ``boundary_pending`` set, gathered and scattered back,
    the flag cleared; the other lanes are untouched.  Returns new
    tensors, on any device."""
    step = loop.make_step(spec)

    def apply(sims: loop.Sim) -> loop.Sim:
        pending = sims.boundary_pending
        idx = pending.nonzero().squeeze(1)
        cleared = sims._replace(boundary_pending=torch.zeros_like(pending))
        stepped = step(tree.map(lambda x: x.index_select(0, idx), cleared))
        return tree.map(lambda x, y: x.index_copy(0, idx, y), cleared,
                        stepped)

    return apply


def make_boundary_step(spec: ModelSpec):
    """``apply(sims) -> sims``: the boundary round, one ordinary engine
    step on exactly the lanes with ``boundary_pending`` set, which it
    clears.  On the card it is one launch of the spec's dwell kernel
    (:func:`awacs_dwell`, AWACS only), IN PLACE; a Sim of another spec
    with boundary blocks raises there.  On CPU tensors it is the plain
    version, :func:`make_boundary_step_plain`."""
    plain = make_boundary_step_plain(spec)
    lay = awacs_layout(spec) if _is_awacs(spec) else None

    def apply(sims: loop.Sim) -> loop.Sim:
        if not sims.clock.is_cuda:
            return plain(sims)
        if lay is None:
            raise NotImplementedError(
                f"spec {spec.name!r}: a CUDA boundary round (dwell kernel) "
                "exists for models.awacs.build(n) only (ROADMAP.md, queue "
                "B)")
        return awacs_dwell(sims, lay)

    return apply


def make_kernel_run(spec: ModelSpec, t_end: Optional[float] = None,
                    chunk_steps: int = 512, max_chunks: int = 10_000):
    """Build ``run(sims) -> sims`` over a lane-first Sim: call the chunk
    until no lane is live, with a boundary round after every chunk that
    leaves a lane frozen at a boundary block.  On the card each chunk is
    one launch of the spec's CUDA kernel; on CPU tensors it is the plain
    engine.  After a call, ``run.launches`` is the number of chunk
    launches it made (read off the kernel wrapper's counter) and
    ``run.boundary_rounds`` the number of boundary rounds, each one
    launch of the dwell kernel on the card (counted where it launches,
    :func:`awacs_dwell`).

    The liveness check between chunks is ``loop.make_cond``: a lane of a
    spec that waits on events stays live while a RUNNING process waits on
    a handle that died with the tables (the next chunk's first step wakes
    it with CANCELLED), as the kernel's own loop keeps it.

    Budget (parity: ``pallas_run``): a boundary freeze can cut a chunk
    short, so a chunk followed by a boundary round does not count against
    ``max_chunks``; boundary rounds have their own budget of ``max_chunks
    x chunk_steps`` (each dispatches at least one event per frozen lane).
    Raises if lanes are still live when a budget runs out — a silent
    partial run would corrupt statistics."""
    try:  # the refusals, before any Sim
        kernel = kernel_for(spec)[1]
    except NeedsSim:
        kernel = gen_chunk
    if chunk_steps <= 0:
        raise ValueError(f"chunk_steps must be positive, got {chunk_steps}")
    plain = loop.make_run(spec, t_end=t_end, max_steps=chunk_steps,
                          defer_boundary=True)
    cond = loop.make_cond(spec, t_end, defer_boundary=True)
    boundary = make_boundary_step(spec) if spec.boundary_pcs else None

    def run(sims: loop.Sim) -> loop.Sim:
        on_card = sims.clock.is_cuda
        klay = kernel_for(spec, sims)[0] if on_card else None
        if on_card:
            # the kernel works in place: keep the caller's Sim intact
            sims = tree.map(
                lambda x: x.clone(memory_format=torch.contiguous_format),
                sims)
        it = rounds = 0
        max_rounds = max_chunks * chunk_steps
        before = kernel.launches
        while bool(cond(sims).any()) and it < max_chunks:
            sims = (kernel(sims, klay, chunk_steps, t_end) if on_card
                    else plain(sims))
            if boundary is not None and bool(sims.boundary_pending.any()):
                sims = boundary(sims)
                rounds += 1
                if rounds >= max_rounds:
                    break
            else:
                it += 1
        run.launches = kernel.launches - before
        run.boundary_rounds = rounds
        if bool(cond(sims).any()):
            raise RuntimeError(
                f"make_kernel_run: lanes still live after {it} full chunks "
                f"(max {max_chunks} x {chunk_steps} events) and {rounds} "
                "boundary rounds — raise chunk_steps/max_chunks")
        return sims

    run.launches = run.boundary_rounds = 0
    return run
