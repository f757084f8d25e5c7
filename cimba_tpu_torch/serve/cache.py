"""The shared program cache behind streaming and serving (torch port of
:mod:`cimba_tpu.serve.cache`).

A "program" of the port is what one compatibility class runs a wave
with: the lane init, the chunk (on the card one launch of the spec's K1,
whose built and loaded library the chunk keeps after its first call),
the liveness readback and the refill splice, each a closure over the
spec and the mesh.  This module holds them in a bounded, thread-safe LRU
(:class:`ProgramCache`) keyed by what a program bakes in, so

* ``run_experiment_stream(program_cache=)`` and the service share warm
  programs (a service's first request after :func:`warm` builds nothing);
* the service's compatibility class (which requests may share a wave) is
  a prefix of the key that selects a program (:func:`program_class_key`
  vs :func:`program_key`).  Seed, horizon, parameter values and R are
  per-lane data columns, in neither key: a second call that differs only
  in them adds no miss;
* ``hits``/``misses``/``evictions`` make the cache's health observable
  (:meth:`ProgramCache.stats`, ``Service.stats()["program_cache"]``).

Entry pinning: a key that holds object identities (the fingerprint's
block and handler ids) is stored with a value that keeps the spec alive,
so an id cannot be recycled while its entry lives.

The persistent program store (``serve/store.py``: built libraries and
CUDA graphs on disk) is not ported: ``ProgramCache(store=...)`` and
``warm(manifest=...)`` raise, naming it.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from collections.abc import MutableMapping
from typing import Any, Callable, Optional

from cimba_tpu_torch import config
from cimba_tpu_torch.runner.experiment import (  # noqa: F401  (re-exports)
    preflight_summary_path, stream_acc)

#: the environment knob of the default capacity (``config.ENV_KNOBS``:
#: 64 entries, one a (spec, settings) point)
CAP_ENV = "CIMBA_PROGRAM_CACHE_CAP"

_STORE_REFUSAL = ("the persistent program store (serve/store.py: built "
                  "libraries and CUDA graphs) is not ported to "
                  "cimba_tpu_torch yet")


def default_capacity() -> int:
    cap = int(config.env_raw(CAP_ENV))
    if cap <= 0:
        raise ValueError(f"{CAP_ENV}={cap}: the program cache capacity must "
                         "be positive")
    return cap


class ProgramCache(MutableMapping):
    """A bounded, thread-safe LRU mapping of programs (parity:
    ``cimba_tpu.serve.cache.ProgramCache``): inserting past ``capacity``
    evicts the least recently used entry (a program is a pure cache: an
    evicted one is rebuilt on next use); every operation holds one lock,
    so a service's dispatcher and direct-calling threads share it; misses
    are counted in :meth:`get_or_create`.  ``store=`` other than None or
    False raises: the program store is not ported."""

    def __init__(self, capacity: Optional[int] = None, *, store=None):
        if store not in (None, False):
            raise NotImplementedError(f"ProgramCache(store=): "
                                      f"{_STORE_REFUSAL}")
        self._cap = default_capacity() if capacity is None else int(capacity)
        if self._cap <= 0:
            raise ValueError(f"capacity must be positive, got {self._cap}")
        self._od: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def store(self):
        """The program store behind this cache: always None (not
        ported)."""
        return None

    def __getitem__(self, key):
        with self._lock:
            val = self._od[key]
            self._od.move_to_end(key)
            return val

    def __setitem__(self, key, val):
        with self._lock:
            self._od[key] = val
            self._od.move_to_end(key)
            while len(self._od) > self._cap:
                self._od.popitem(last=False)
                self.evictions += 1

    def __delitem__(self, key):
        with self._lock:
            del self._od[key]

    def __contains__(self, key):
        with self._lock:
            return key in self._od

    def __iter__(self):
        with self._lock:
            return iter(list(self._od))

    def __len__(self):
        with self._lock:
            return len(self._od)

    def get_or_create(self, key, factory: Callable[[], Any]):
        """The cached value for ``key``, built by ``factory()`` on a miss.
        The factory runs outside the lock (a K1 build takes seconds);
        where another thread won the race its value wins."""
        with self._lock:
            if key in self._od:
                self.hits += 1
                self._od.move_to_end(key)
                return self._od[key]
        val = factory()
        with self._lock:
            if key in self._od:
                self.hits += 1
                self._od.move_to_end(key)
                return self._od[key]
            self.misses += 1
            self[key] = val
            return val

    @property
    def capacity(self) -> int:
        return self._cap

    def stats(self) -> dict:
        """One lock acquisition's counters: ``capacity``, ``size``,
        ``hits``, ``misses``, ``evictions``, ``hit_ratio``."""
        with self._lock:
            lookups = self.hits + self.misses
            return {"capacity": self._cap, "size": len(self._od),
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "hit_ratio": self.hits / lookups if lookups else 0.0}


def _get_or_create(programs: MutableMapping, key, factory):
    """``get_or_create`` on a :class:`ProgramCache` or a plain dict."""
    if isinstance(programs, ProgramCache):
        return programs.get_or_create(key, factory)
    if key not in programs:
        programs[key] = factory()
    return programs[key]


def cached(programs: MutableMapping, key, factory):
    """Get-or-create for a subsystem's own entries in the shared cache
    (the sweep's serve merge, say), keys namespaced by a leading tag; a
    key holding an object's id must be pinned by its value."""
    return _get_or_create(programs, key, factory)


# --- keys -----------------------------------------------------------------


def spec_fingerprint(spec) -> tuple:
    """The structural identity of a ModelSpec (parity:
    ``cimba_tpu.serve.cache.spec_fingerprint``): the block, handler,
    ``user_init`` and predicate functions by object identity, the rest by
    value, so a ``dataclasses.replace`` twin shares programs and a model
    rebuilt from source gets its own.  Cached on the spec."""
    import dataclasses

    import numpy as np

    got = getattr(spec, "_cimba_fingerprint", None)
    if got is not None:
        return got

    def ref_key(r):
        out = []
        for f in dataclasses.fields(r):
            v = getattr(r, f.name)
            if callable(v):
                out.append(("fn", id(v)))
            elif isinstance(v, (list, tuple)):
                out.append(tuple(v))
            else:
                out.append(v)
        return tuple(out)

    fp = (
        spec.name,
        tuple(id(b) for b in spec.blocks),
        np.asarray(spec.proc_entry).tobytes(),
        np.asarray(spec.proc_prio).tobytes(),
        np.asarray(spec.proc_start).tobytes(),
        tuple(spec.proc_names),
        tuple(ref_key(q) for q in spec.queues),
        tuple(ref_key(r) for r in spec.resources),
        tuple(ref_key(p) for p in spec.pools),
        tuple(ref_key(b) for b in spec.buffers),
        tuple(ref_key(q) for q in spec.pqueues),
        tuple(ref_key(c) for c in spec.conditions),
        tuple(ref_key(t) for t in spec.spawn_types),
        spec.n_guards, spec.event_cap, spec.queue_cap_max,
        spec.pqueue_cap_max, spec.n_flocals, spec.n_ilocals,
        None if spec.user_init is None else id(spec.user_init),
        tuple(id(h) for h in spec.user_handlers),
        tuple(spec.boundary_pcs),
        tuple(sorted((k, repr(v)) for k, v in spec.constants.items())),
    )
    try:
        object.__setattr__(spec, "_cimba_fingerprint", fp)
    except (AttributeError, TypeError):
        pass
    return fp


def kernel_instance(spec) -> str:
    """Which K1 instance the spec's waves run on the card: a hand-written
    family (``mm/1/False``, ``awacs``, ...) or ``gen`` (the generated
    family, built from the blocks); ``refused`` where no instance takes
    it (the chunk then raises on the card, naming what it uses)."""
    from cimba_tpu_torch.core import kernel_run

    try:
        fam = kernel_run._queue_family(spec)
        if fam is not None:
            return "/".join(str(x) for x in fam)
        return "awacs" if kernel_run._is_awacs(spec) else "gen"
    except NotImplementedError:
        return "refused"


def program_class_key(spec, with_metrics: bool, *, mesh, pack=None) -> tuple:
    """The compatibility class: everything a wave's programs bake in
    except ``chunk_steps`` (parity: ``cimba_tpu.serve.cache.
    program_class_key``): the spec's fingerprint, the dtype profile, the
    metrics and flight-recorder flags (resolved now, so a flip between
    calls misses rather than replays), the mesh (its devices: a CPU
    program is not a card's) and the K1 instance.  ``pack`` (the
    reference's packed XLA carry) is a TPU-only lever the port does not
    have: it is accepted and keys nothing."""
    from cimba_tpu_torch.obs import trace as obs_trace

    del pack
    return (spec_fingerprint(spec), config.active_profile(),
            bool(with_metrics), obs_trace.enabled(), mesh,
            kernel_instance(spec))


def program_key(spec, with_metrics: bool, *, mesh, chunk_steps: int,
                pack=None) -> tuple:
    """The key of one ``(init, chunk)`` pair: the class plus the chunk
    budget the chunk bakes in."""
    return program_class_key(spec, with_metrics, mesh=mesh,
                             pack=pack) + (int(chunk_steps),)


def get_programs(programs: MutableMapping, spec, *, mesh, chunk_steps: int,
                 with_metrics: bool, audit: bool = False, pack=None):
    """``(init, chunk)`` for one :func:`program_key` point (parity:
    ``cimba_tpu.serve.cache.get_programs``): ``init(reps, seeds,
    t_stops, params) -> shards`` and ``chunk(shards) -> (shards,
    any_live[, digest])`` over ``mesh``'s devices, the chunk built with
    no static horizon (each lane's ``t_stop`` column is its horizon).
    ``audit=True`` selects the audited chunk, at a key of its own."""
    from cimba_tpu_torch.runner import experiment as ex

    key = program_key(spec, with_metrics, mesh=mesh, chunk_steps=chunk_steps)
    if audit:
        key = key + ("audit",)

    def build():
        import torch

        dev = torch.device(mesh.devices[0])
        return (ex._init_program(spec, mesh),
                ex._chunk_program(spec, mesh, dev, chunk_steps, audit=audit),
                spec)  # pins the fingerprint's function ids

    return _get_or_create(programs, key, build)[:2]


def get_refill_programs(programs: MutableMapping, spec, *, mesh,
                        with_metrics: bool, pack=None):
    """``(refill, live)`` of one compatibility class (parity:
    ``cimba_tpu.serve.cache.get_refill_programs``): the lane splice
    (``core.loop.make_refill`` over the shards) and the per-lane liveness
    readback (``make_lanes_live``, a ``bool [L]`` on the mesh's first
    device)."""
    from cimba_tpu_torch.runner import experiment as ex

    key = ("refill",) + program_class_key(spec, with_metrics, mesh=mesh)

    def build():
        return (ex._refill_program(spec, mesh), ex._live_program(spec, mesh),
                spec)

    return _get_or_create(programs, key, build)[:2]


# --- the fusion rung --------------------------------------------------------


def fusion_order_key(spec) -> str:
    """The canonical member order of a fused bundle (parity:
    ``cimba_tpu.serve.cache.fusion_order_key``): members sort by the
    sha256 of their value-based fingerprint
    (``obs.audit.stable_spec_fingerprint``), so one member set builds one
    merged table, and one K1 instance, whatever the arrival order; a spec
    that resists it falls back to its name and id."""
    got = getattr(spec, "_cimba_fusion_order", None)
    if got is not None:
        return got
    import hashlib

    from cimba_tpu_torch.obs import audit as obs_audit

    try:
        key = "s:" + hashlib.sha256(repr(
            obs_audit.stable_spec_fingerprint(spec)).encode()).hexdigest()
    except Exception:
        key = f"u:{spec.name}:{id(spec):x}"
    try:
        object.__setattr__(spec, "_cimba_fusion_order", key)
    except (AttributeError, TypeError):
        pass
    return key


def _params_sig(params, n_replications: int) -> tuple:
    """The parameter row's signature: the tree's structure and each
    leaf's per-lane shape and dtype (what two requests' rows need to
    concatenate)."""
    from cimba_tpu_torch import tree
    from cimba_tpu_torch.obs.audit import _structure
    from cimba_tpu_torch.runner import experiment as ex

    row = ex._slice_params(params, int(n_replications), 0, 1)
    return (_structure(row),
            tuple((tuple(x.shape[1:]), str(x.dtype))
                  for x in tree.leaves(row)))


def sim_structure_sig(programs: MutableMapping, spec, params,
                      n_replications: int, with_metrics: bool, *, mesh,
                      pack=None) -> tuple:
    """One lane's Sim structure signature (parity:
    ``cimba_tpu.serve.cache.sim_structure_sig``): its tree structure and
    each leaf's per-lane shape and dtype, from a one-lane init on the CPU
    with a horizon column.  The fusion class holds it, so two specs share
    a fused wave only where their lanes' trees are the same."""
    from cimba_tpu_torch import tree
    from cimba_tpu_torch.core.loop import init_sim
    from cimba_tpu_torch.obs.audit import _structure
    from cimba_tpu_torch.runner import experiment as ex

    key = ("sim_sig",) + program_class_key(spec, with_metrics, mesh=mesh) + (
        _params_sig(params, n_replications),)

    def build():
        import torch

        one = init_sim(spec, ex._seed_column(0, 1, "cpu"), torch.arange(1),
                       ex._slice_params(params, int(n_replications), 0, 1),
                       t_stop=ex._horizon_column(None, 1, "cpu"),
                       device="cpu")
        sig = (_structure(one),
               tuple((tuple(x.shape[1:]), str(x.dtype))
                     for x in tree.leaves(one)))
        return (sig, spec)

    return _get_or_create(programs, key, build)[0]


def get_fused(programs: MutableMapping, specs):
    """The cached ``core.fuse.FusedSpec`` of an ordered member tuple: one
    bundle a member tuple, so its merged spec (and that spec's K1
    instance) is built once."""
    from cimba_tpu_torch.core import fuse

    specs = tuple(specs)
    key = ("fuse_bundle",) + tuple(spec_fingerprint(s) for s in specs)
    return _get_or_create(programs, key,
                          lambda: (fuse.fuse_specs(specs),))[0]


def get_fused_wave_programs(programs: MutableMapping, fused, *, mesh,
                            chunk_steps: int, with_metrics: bool,
                            pack=None):
    """``(fused init, chunk)`` of a fused wave: the init selects each
    lane's member by its spec-id column; the chunk is the merged spec's
    ordinary :func:`get_programs` entry (on the card its generated K1)."""
    from cimba_tpu_torch.runner import experiment as ex

    key = ("fused_init",) + program_class_key(fused.spec, with_metrics,
                                              mesh=mesh)
    finit = _get_or_create(programs, key, lambda: (
        ex._fused_init_program(fused, mesh), fused))[0]
    _, chunk = get_programs(programs, fused.spec, mesh=mesh,
                            chunk_steps=chunk_steps,
                            with_metrics=with_metrics)
    return finit, chunk


def get_fused_refill_programs(programs: MutableMapping, fused, *, mesh,
                              with_metrics: bool, pack=None):
    """``(fused refill, live)``: the spec-id-selected splice and the
    merged spec's liveness readback (liveness reads no block)."""
    from cimba_tpu_torch.runner import experiment as ex

    key = ("fused_refill",) + program_class_key(fused.spec, with_metrics,
                                                mesh=mesh)
    return _get_or_create(programs, key, lambda: (
        ex._fused_refill_program(fused, mesh),
        ex._live_program(fused.spec, mesh), fused))[:2]


# --- folds, gathers, the preflight -------------------------------------------


def get_fold(programs: MutableMapping, with_metrics: bool, summary_path):
    """The wave fold of the stream and of every served request, keyed by
    the metrics flag and ``summary_path``: the stream's own
    ``runner.experiment._fold``, so a served request folds exactly as its
    direct call does."""
    from cimba_tpu_torch.runner import experiment as ex

    def build():
        def fold(acc, sims):
            return ex._fold(acc, sims, summary_path, with_metrics)
        return fold

    return _get_or_create(programs, ("fold", bool(with_metrics),
                                     summary_path), build)


def get_gather(programs: MutableMapping):
    """``gather(shards, idx) -> Sim``: the lanes ``idx`` (ascending, an
    int64 tensor) of a wave's shards, on the first shard's device, by
    ``index_select`` (data movement only: the leaves' bits)."""
    def build():
        import torch

        from cimba_tpu_torch import tree

        def gather(shards, idx):
            dev = shards[0].clock.device
            if len(shards) == 1:
                whole = shards[0]
            else:
                whole = tree.map(lambda *xs: torch.cat([x.to(dev)
                                                        for x in xs]),
                                 *shards)
            idx = idx.to(dev)
            return tree.map(lambda x: x.index_select(0, idx), whole)
        return gather

    return _get_or_create(programs, ("gather",), build)


def preflight(programs: MutableMapping, spec, summary_path, params,
              n_total: int, n_first: int, with_metrics: bool,
              device) -> None:
    """:func:`preflight_summary_path` once a (spec structure,
    ``summary_path``, metrics flag) point, cached beside the programs it
    guards (parity: the reference's cached preflight)."""
    key = ("preflight", spec_fingerprint(spec), summary_path,
           bool(with_metrics))
    if key in programs:
        return

    def check():
        preflight_summary_path(spec, summary_path, params, n_total, n_first,
                               device)
        return spec

    _get_or_create(programs, key, check)


def warm(cache: MutableMapping, spec, params, wave_size: int, *,
         manifest=None, **stream_kwargs):
    """Run one full wave of ``wave_size`` lanes through
    ``run_experiment_stream`` against ``cache`` (parity:
    ``cimba_tpu.serve.warm`` in its default mode), so a service over the
    same cache serves its first request from built programs; on the card
    this is where the K1 instance is built (a generated one's ``nvcc``)
    and loaded, before any client arrives.  Returns the wave's
    StreamResult.  ``manifest=`` (the program store) raises: not
    ported."""
    from cimba_tpu_torch.runner import experiment as ex

    if manifest is not None:
        raise NotImplementedError(f"warm(manifest=): {_STORE_REFUSAL}")
    res = ex.run_experiment_stream(spec, params, wave_size,
                                   wave_size=wave_size, program_cache=cache,
                                   **stream_kwargs)
    get_gather(cache)
    return res
