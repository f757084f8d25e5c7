"""Model definition: the static structure a simulation is built from
(torch port of :mod:`cimba_tpu.core.model`).

A :class:`Model` collects blocks, process types, object queues and the
user-state initialiser at Python time; :meth:`Model.build` freezes them into
a :class:`ModelSpec`.  Block registration is the reference's::

    m = Model("mm1", n_ilocals=1)
    q = m.objectqueue("buffer", capacity=128, record=False)

    @m.block
    def a_hold(sim, p, sig):
        sim, t = api.draw(sim, random.exponential, sim.user["arr_mean"])
        return sim, cmd.hold(t, next_pc=a_put.pc)

    m.process("arrival", entry=a_hold)

Blocks run on every replication lane at once: ``p`` and ``sig`` are
``[L]`` tensors.  Object queues, binary resources, resource pools,
buffers, priority queues, conditions, user event handlers and spawn
pools (``process(start=False)``, activated by ``api.spawn``) are
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class QueueRef:
    id: int
    name: str
    capacity: int
    front_guard: int  # getters wait here
    rear_guard: int   # putters wait here
    record: bool = False


@dataclasses.dataclass
class ResourceRef:
    id: int
    name: str
    guard: int
    record: bool = True  # utilization StepAccum recording


@dataclasses.dataclass
class PoolRef:
    id: int
    name: str
    capacity: float
    guard: int
    record: bool = True  # in-use StepAccum recording


@dataclasses.dataclass
class BufferRef:
    id: int
    name: str
    capacity: float
    initial: float
    front_guard: int  # getters wait here
    rear_guard: int   # putters wait here
    record: bool = True  # level StepAccum recording


@dataclasses.dataclass
class PQueueRef:
    id: int
    name: str
    capacity: int
    front_guard: int  # getters wait here
    rear_guard: int   # putters wait here
    record: bool = True  # length StepAccum recording


@dataclasses.dataclass
class ConditionRef:
    id: int
    name: str
    guard: int
    predicate: Callable  # predicate(sim, pid) -> [L] bool
    #: guard ids this condition observes: a signal on any of them also
    #: signals the condition (parity: cmb_resourceguard_register)
    observes: tuple = ()


@dataclasses.dataclass
class ProcessType:
    name: str
    entry_pc: int
    prio: int
    count: int
    #: False = the rows exist but stay CREATED until api.spawn activates
    #: them (a spawn pool)
    start: bool = True
    first_pid: int = -1  # assigned at build


@dataclasses.dataclass
class ModelSpec:
    """Frozen model structure."""

    name: str
    blocks: List[Callable]
    proc_entry: np.ndarray  # [P] i32
    proc_prio: np.ndarray   # [P] i32
    #: [P] bool: False rows are spawn-pool members, CREATED at init until
    #: api.spawn activates them
    proc_start: np.ndarray
    proc_names: List[str]
    queues: List[QueueRef]
    pools: List[PoolRef]
    buffers: List[BufferRef]
    conditions: List[ConditionRef]
    n_guards: int
    event_cap: int
    queue_cap_max: int
    n_flocals: int
    n_ilocals: int
    user_init: Optional[Callable[..., Any]]
    #: pcs of blocks dispatched outside the chunk kernel, between chunks
    #: (see Model.boundary_block); empty for most models
    boundary_pcs: tuple = ()
    #: the build arguments a model's blocks close over (e.g. the job
    #: shop's ``backlog`` and ``b_slow``), by name: a CUDA kernel that
    #: restates the blocks takes them from here
    constants: dict = dataclasses.field(default_factory=dict)
    pqueues: List[PQueueRef] = dataclasses.field(default_factory=list)
    #: the widest priority queue's capacity (the rows' width)
    pqueue_cap_max: int = 1
    resources: List[ResourceRef] = dataclasses.field(default_factory=list)
    #: ``fn(sim, subj, arg) -> sim`` of each user event kind
    #: ``N_KINDS + k`` (Model.handler)
    user_handlers: List[Callable] = dataclasses.field(default_factory=list)
    #: the spawn pools' process types (``process(start=False)``), in
    #: declaration order
    spawn_types: List[ProcessType] = dataclasses.field(default_factory=list)

    @property
    def n_procs(self) -> int:
        return len(self.proc_entry)


class Model:
    """A model under construction (Python-time only)."""

    def __init__(self, name: str, *, n_flocals: int = 0, n_ilocals: int = 0,
                 event_cap: int = 16, guard_cap: int = 8,
                 max_chain: int = 16):
        # guard_cap and max_chain are accepted for signature parity: dense
        # guards cannot overflow, and the port's chain bound is the
        # engine's MAX_CHAIN
        self.name = name
        self.n_flocals = n_flocals
        self.n_ilocals = n_ilocals
        self.event_cap = event_cap
        self._blocks: List[Callable] = []
        self._types: List[ProcessType] = []
        self._queues: List[QueueRef] = []
        self._pools: List[PoolRef] = []
        self._buffers: List[BufferRef] = []
        self._conditions: List[ConditionRef] = []
        self._pqueues: List[PQueueRef] = []
        self._resources: List[ResourceRef] = []
        self._user_handlers: List[Callable] = []
        self._n_guards = 0
        #: see ModelSpec.constants
        self.constants: dict = {}
        self._user_init: Optional[Callable] = None
        self._boundary_pcs: List[int] = []

    def block(self, fn: Callable) -> Callable:
        """Register a block; sets ``fn.pc`` to its global index."""
        fn.pc = len(self._blocks)
        self._blocks.append(fn)
        return fn

    def process(self, name: str, entry, *, prio: int = 0, count: int = 1,
                start: bool = True):
        """Declare ``count`` instances of a process type starting at
        block ``entry``.  ``start=False`` declares a spawn pool: the rows
        stay CREATED until a block activates one with ``api.spawn(sim,
        pt)``, and finished rows are recycled by later spawns (parity:
        the reference's runtime cmb_process_create/start)."""
        pt = ProcessType(name, entry.pc, prio, count, start)
        self._types.append(pt)
        return pt

    def _guard(self) -> int:
        g = self._n_guards
        self._n_guards += 1
        return g

    def objectqueue(self, name: str, capacity: int,
                    record: bool = True) -> QueueRef:
        """FIFO of REAL payloads (parity: cmb_objectqueue).  With
        ``record`` the engine keeps the queue's length as a time-weighted
        series (``Sim.queues.acc``, a ``stats.timeseries.StepAccum`` row
        per queue)."""
        q = QueueRef(
            id=len(self._queues), name=name, capacity=capacity,
            front_guard=self._guard(), rear_guard=self._guard(),
            record=record,
        )
        self._queues.append(q)
        return q

    def resource(self, name: str, record: bool = True) -> ResourceRef:
        """Single-holder resource (parity: cmb_resource); with
        ``record`` the engine keeps its utilization (1 held, 0 free) as
        a time-weighted series (``Sim.resources.acc``)."""
        r = ResourceRef(id=len(self._resources), name=name,
                        guard=self._guard(), record=record)
        self._resources.append(r)
        return r

    def resourcepool(self, name: str, capacity: float,
                     record: bool = True) -> PoolRef:
        """Counting resource of ``capacity`` fungible units (parity:
        cmb_resourcepool); with ``record`` the engine keeps the units in
        use as a time-weighted series (``Sim.pools.acc``)."""
        p = PoolRef(id=len(self._pools), name=name,
                    capacity=float(capacity), guard=self._guard(),
                    record=record)
        self._pools.append(p)
        return p

    def buffer(self, name: str, capacity: float, initial: float = 0.0,
               record: bool = True) -> BufferRef:
        """Producer-consumer store of a fungible amount (parity:
        cmb_buffer); with ``record`` the engine keeps its level as a
        time-weighted series (``Sim.buffers.acc``)."""
        b = BufferRef(id=len(self._buffers), name=name,
                      capacity=float(capacity), initial=float(initial),
                      front_guard=self._guard(), rear_guard=self._guard(),
                      record=record)
        self._buffers.append(b)
        return b

    def priorityqueue(self, name: str, capacity: int,
                      record: bool = True) -> PQueueRef:
        """Object queue ordered by per-item priority, FIFO among equal
        priorities (parity: cmb_priorityqueue); with ``record`` the
        engine keeps its length as a time-weighted series
        (``Sim.pqueues.acc``)."""
        q = PQueueRef(id=len(self._pqueues), name=name, capacity=capacity,
                      front_guard=self._guard(), rear_guard=self._guard(),
                      record=record)
        self._pqueues.append(q)
        return q

    def condition(self, name: str, predicate: Callable,
                  observes=()) -> ConditionRef:
        """Condition variable: processes wait until ``predicate(sim,
        pid)`` (an ``[L]`` bool for the ``[L]`` pid tensor) holds at a
        signal (parity: cmb_condition).  ``observes`` lists components
        (queues, pools, buffers) whose guard signals also signal this
        condition, so the model need not call ``api.cond_signal`` where
        they change (parity: cmb_resourceguard_register)."""
        gids = []
        for comp in observes:
            found = False
            for attr in ("guard", "front_guard", "rear_guard"):
                g = getattr(comp, attr, None)
                if g is not None:
                    gids.append(g)
                    found = True
            if not found:
                raise TypeError(
                    f"condition {name!r}: observes entry {comp!r} has no "
                    "guard — pass component refs (queue/pool/buffer)")
        c = ConditionRef(id=len(self._conditions), name=name,
                         guard=self._guard(), predicate=predicate,
                         observes=tuple(gids))
        self._conditions.append(c)
        return c

    def handler(self, fn: Callable) -> Callable:
        """Register a user event handler ``fn(sim, subj, arg) -> sim``;
        sets ``fn.kind`` for ``api.schedule`` (parity: an event with an
        arbitrary action, cmb_event_schedule).  Kinds 0 and 1 are the
        engine's process resume and timer."""
        fn.kind = 2 + len(self._user_handlers)
        self._user_handlers.append(fn)
        return fn

    def boundary_block(self, fn: Callable) -> Callable:
        """Register a block whose dispatch runs outside the chunk kernel:
        the kernel freezes a lane whose next dispatch targets it, and the
        host loop applies one ordinary engine step to the frozen lanes
        between chunks (parity: ``cimba_tpu.core.model.Model.
        boundary_block``).  Semantics are those of a normal block; the
        plain engine ignores the marker unless it runs with
        ``defer_boundary=True``.  A boundary block must be entered by
        resumes (process entry, hold continuations), never mid-chain by a
        jump or a command's ``next_pc``: under ``defer_boundary`` such an
        entry fails the lane with ERR_BOUNDARY."""
        fn = self.block(fn)
        self._boundary_pcs.append(fn.pc)
        return fn

    def user_state(self, fn: Callable) -> Callable:
        """Register ``fn(params) -> pytree`` building the user state; the
        params arrive as ``[L]`` tensors, one row per replication."""
        self._user_init = fn
        return fn

    def build(self) -> ModelSpec:
        if not self._types:
            raise ValueError("model has no processes")
        entries, prios, names, started = [], [], [], []
        for pt in self._types:
            pt.first_pid = len(entries)
            for k in range(pt.count):
                entries.append(pt.entry_pc)
                prios.append(pt.prio)
                started.append(pt.start)
                names.append(pt.name if pt.count == 1 else f"{pt.name}[{k}]")
        from cimba_tpu_torch.utils import logger as _logger

        _logger.names_set(names)  # log lines render name(pid)
        return ModelSpec(
            name=self.name,
            blocks=list(self._blocks),
            proc_entry=np.asarray(entries, np.int32),
            proc_prio=np.asarray(prios, np.int32),
            proc_start=np.asarray(started, np.bool_),
            proc_names=names,
            queues=list(self._queues),
            pools=list(self._pools),
            buffers=list(self._buffers),
            conditions=list(self._conditions),
            n_guards=max(self._n_guards, 1),
            event_cap=self.event_cap,
            queue_cap_max=max([q.capacity for q in self._queues], default=1),
            n_flocals=self.n_flocals,
            n_ilocals=self.n_ilocals,
            user_init=self._user_init,
            boundary_pcs=tuple(self._boundary_pcs),
            constants=dict(self.constants),
            pqueues=list(self._pqueues),
            pqueue_cap_max=max([q.capacity for q in self._pqueues],
                               default=1),
            resources=list(self._resources),
            user_handlers=list(self._user_handlers),
            spawn_types=[pt for pt in self._types if not pt.start],
        )
