"""Cross-spec wave fusion: one wave over several specs (torch port of
:mod:`cimba_tpu.core.fuse`).

A wave packs lanes of one compatibility class, one spec.  A service
holding many small distinct models would run each in its own mostly
padded wave.  :func:`fuse_specs` merges N shape-compatible member specs
into one **superspec** whose block table concatenates the members'
tables, each member's entry pcs rebased by its table offset.  The chunk
of the superspec is the ordinary ``core.loop.make_chunk``: block dispatch
is already by each lane's ``procs.pc``, so once a lane's pcs live in
member k's slice of the merged table, the dispatch is the per-lane model
switch.  On the card the superspec is a user spec like any other: its K1
is the generated family's instance of the merged table
(``kernel_run.generated_kernel_for``).  Only the birth of a lane needs an
explicit choice: :func:`make_fused_init` starts each lane as its member
does (its own process table and ``user_init``) on a per-lane spec-id
column, and :func:`make_fused_refill` does the same for the lanes a
refill splices in.

Why a lane stays bitwise its solo run:

* the reference's ``lax.switch`` under ``vmap`` computes every member's
  init and selects a lane's own; here each member's ``init_sim`` runs over
  the wave's columns and ``torch.where`` on the ``sids`` column selects
  each leaf, which is as exact: a selection never changes a value;
* member 0's blocks are its own function objects; another member's are
  thin wrappers that add the member's base to ``Command.next_pc`` and
  change nothing else.  A pc never reaches a result (summaries fold user
  state, ``n_events`` and metrics);
* members of one :func:`fusion_shape_key` have the same capacities and
  component layout, so every Sim leaf has one shape and dtype across
  them.

What cannot fuse (:class:`FusionError`): specs with spawn pools
(``api.spawn`` carries the pool's unrebased entry pc), specs with
``boundary_pcs`` (the boundary protocol keys block indices, which
rebasing renumbers), and specs whose component geometry, capacities,
local counts, condition predicates or user handlers differ (the merged
spec keeps one copy of them).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from cimba_tpu_torch import tree
from cimba_tpu_torch.core import loop as _loop
from cimba_tpu_torch.core.model import ModelSpec


class FusionError(ValueError):
    """The spec (or spec set) cannot take part in wave fusion; the message
    names the structure at fault.  A service serves such a spec on its
    own."""


def _ref_shape(r):
    # the identity-free twin of serve.cache.spec_fingerprint's ref_key:
    # the display name dropped; callables (condition predicates) by
    # identity, since the merged spec keeps one copy of them
    out = []
    for f in dataclasses.fields(r):
        if f.name == "name":
            continue
        v = getattr(r, f.name)
        if callable(v):
            out.append((f.name, "fn", id(v)))
        elif isinstance(v, (list, tuple)):
            out.append((f.name, tuple(v)))
        else:
            out.append((f.name, v))
    return (type(r).__name__, tuple(out))


def fusion_shape_key(spec: ModelSpec) -> tuple:
    """The structural geometry of a spec without its model identity
    (parity: ``cimba_tpu.core.fuse.fusion_shape_key``): specs with equal
    keys can share one superspec.  It keeps the process count, local and
    capacity counts, the component layout, and the predicate and handler
    identities; it leaves out the name, the block table, the per-process
    entry, priority and start data and ``user_init`` (consumed only by
    ``init_sim``, which a fused wave runs per member).  Raises
    :class:`FusionError` for a spec that cannot fuse."""
    got = getattr(spec, "_cimba_fusion_shape", None)
    if got is not None:
        return got
    if tuple(spec.boundary_pcs):
        raise FusionError(
            f"spec {spec.name!r} has boundary_pcs: the kernel boundary "
            "protocol keys block indices, which fusion renumbers")
    if not all(bool(s) for s in np.asarray(spec.proc_start).tolist()):
        raise FusionError(
            f"spec {spec.name!r} declares a spawn pool (start=False): "
            "api.spawn carries the pool's unrebased entry pc "
            "(loop.spawn_process), so spawned rows cannot be rebased")
    key = (
        int(spec.n_procs),
        tuple(_ref_shape(q) for q in spec.queues),
        tuple(_ref_shape(r) for r in spec.resources),
        tuple(_ref_shape(p) for p in spec.pools),
        tuple(_ref_shape(b) for b in spec.buffers),
        tuple(_ref_shape(q) for q in spec.pqueues),
        tuple(_ref_shape(c) for c in spec.conditions),
        spec.n_guards, spec.event_cap, spec.queue_cap_max,
        spec.pqueue_cap_max, spec.n_flocals, spec.n_ilocals,
        tuple(id(h) for h in spec.user_handlers),
    )
    try:
        object.__setattr__(spec, "_cimba_fusion_shape", key)
    except (AttributeError, TypeError):
        pass
    return key


def _rebase_block(fn, base: int):
    """Member block ``fn`` with every pc it yields moved into the
    member's slice of the merged table: ``Command.next_pc`` is the only
    field that carries a pc, and a ``cmd.select`` merges whole Commands,
    so one shift covers every arm (under the tracer of ``core/trace.py``
    the sum is a node of the block's command)."""

    def rebased(sim, p, sig, _fn=fn, _base=base):
        sim, c = _fn(sim, p, sig)
        return sim, c._replace(next_pc=c.next_pc + _base)

    rebased.__name__ = getattr(fn, "__name__", "block")
    return rebased


@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """A fused superspec bundle (parity: ``cimba_tpu.core.fuse.
    FusedSpec``).  ``spec`` is a real ModelSpec, the merged block table
    over member 0's machinery, so chunks, program caches and the K1
    emitter take it as they are.  ``rebased[k]`` is member k's twin with
    the merged table and its entry pcs rebased: what a lane of member k
    is born from.  ``members`` keeps the original specs alive (cache keys
    hold their function ids)."""

    spec: ModelSpec
    members: Tuple[ModelSpec, ...]
    rebased: Tuple[ModelSpec, ...]
    bases: Tuple[int, ...]

    @property
    def n_members(self) -> int:
        return len(self.members)


def fuse_specs(specs: Sequence[ModelSpec]) -> FusedSpec:
    """Merge shape-compatible member specs into one superspec (parity:
    ``cimba_tpu.core.fuse.fuse_specs``): the members' tables concatenated
    (member 0's blocks verbatim), the merged spec member 0's process
    arrays and machinery, named ``fused(a+b+...)``, with no boundary
    pcs."""
    specs = tuple(specs)
    if not specs:
        raise FusionError("fuse_specs: empty member set")
    shape0 = fusion_shape_key(specs[0])
    for s in specs[1:]:
        if fusion_shape_key(s) != shape0:
            raise FusionError(
                f"fuse_specs: {s.name!r} is not shape-compatible with "
                f"{specs[0].name!r} (component geometry, caps, locals, "
                "predicates and handlers must match exactly)")
    merged: list = []
    bases: list = []
    for s in specs:
        base = len(merged)
        bases.append(base)
        if base == 0:
            merged.extend(s.blocks)
        else:
            merged.extend(_rebase_block(b, base) for b in s.blocks)
    name = "fused(" + "+".join(s.name for s in specs) + ")"
    spec = dataclasses.replace(specs[0], name=name, blocks=list(merged),
                               boundary_pcs=())
    rebased = tuple(
        dataclasses.replace(s, blocks=list(merged),
                            proc_entry=np.asarray(s.proc_entry) + b)
        for s, b in zip(specs, bases))
    return FusedSpec(spec=spec, members=specs, rebased=rebased,
                     bases=tuple(bases))


def _select(sids, outs):
    """Each lane's leaves from ``outs[sids[l]]`` (the index clipped into
    range, as the reference's switch clamps it)."""
    if len(outs) == 1:
        return outs[0]
    k = sids.clamp(0, len(outs) - 1)

    def sel(*xs):
        out = xs[0]
        for j in range(1, len(xs)):
            m = (k == j).reshape((-1,) + (1,) * (out.dim() - 1))
            out = torch.where(m, xs[j], out)
        return out

    return tree.map(sel, *outs)


def make_fused_init(fused: FusedSpec):
    """``init(reps, seeds, t_stops, sids, params, device=) -> Sim`` (parity:
    ``cimba_tpu.core.fuse.make_fused_init``): each member's ``init_sim``
    (rebased entry pcs, its own priorities, starts and ``user_init``) over
    the wave's columns, and each lane's leaves taken from the member its
    ``sids`` entry names.  A member lane's birth is bitwise its solo
    wave's.  Every member of a fusion class has one parameter-row
    signature, so one batched params tree serves each."""
    def init(reps, seeds, t_stops, sids, params, device="cuda"):
        sids = torch.as_tensor(sids, device=device)
        outs = [_loop.init_sim(sp, seeds, reps, params, t_stop=t_stops,
                               device=device) for sp in fused.rebased]
        return _select(sids, outs)

    return init


def make_fused_refill(fused: FusedSpec):
    """``refill(sims, mask, reps, seeds, t_stops, sids, params) -> sims``
    (parity: ``cimba_tpu.core.fuse.make_fused_refill``): the masked lanes
    born afresh through :func:`make_fused_init`, every other lane's
    leaves kept bit for bit.  One refill serves every member; the wave
    must carry its ``t_stop`` leaf."""
    finit = make_fused_init(fused)

    def refill(sims, mask, reps, seeds, t_stops, sids, params):
        if sims.t_stop is None:
            raise ValueError(
                "make_fused_refill: the wave carries no per-lane t_stop "
                "leaf; fused refill waves always carry the horizon column")
        dev = sims.clock.device
        fresh = finit(reps, seeds, t_stops, sids, params, device=dev)
        m = torch.as_tensor(mask, dtype=torch.bool, device=dev)

        def sel(a, b):
            return torch.where(m.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

        return tree.map(sel, fresh, sims)

    return refill
