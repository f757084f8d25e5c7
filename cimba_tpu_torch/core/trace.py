"""Trace a spec's blocks into a small explicit IR (the generated K1's front end).

The TPU package lowers a spec's whole step to Mosaic through its jaxpr
(``cimba_tpu/core/pallas_run.py``).  The port instead runs each block
``(sim, p, sig) -> (sim, Command)``, and each condition predicate ``(sim,
pid)``, once on a symbolic one-lane Sim and records what it computes:

* every Sim leaf element the block reads is a ``leaf`` node, the pid a
  ``pid`` node and the resume signal a ``sig`` node;
* every torch op on a traced value is a node of the op table (the
  unary and binary elementwise ops of ``_UN`` and ``_BIN``, ``where``,
  ``clamp``, ``cast``, and ``pick`` for a gather by a traced index,
  ``where`` of an ``eq`` for a scatter by one), with the dtype torch gives
  its result and the dtype it computes in, so the IR holds the plain
  engine's own order of operations (``stats.summary.add``'s Pébay merge
  included);
* ``api.draw`` is one ``draw`` node naming its sampler (the samplers'
  loops and tables are not traced); ``api.pool_release``,
  ``api.release``, ``api.cond_signal``, ``api.interrupt``,
  ``api.stop_process``, ``api.timer_add``, ``api.timers_clear``,
  ``api.schedule``, ``api.spawn``, ``api.timer_cancel`` and
  ``api.event_cancel`` (``event_cancel``, whether the call passed the
  spec a constant of it), ``api.event_reschedule``,
  ``api.event_reprioritize``, ``api.event_pattern_cancel``,
  ``api.priority_set``, ``api.pqueue_cancel`` and
  ``api.pqueue_reprioritize`` are engine calls, since they scan guard
  waiters, the processes, a queue or the event table (a timer's, an
  event's handle, a spawn's pid, a cancel's or a move's ``existed`` and
  a pattern cancel's count are ``callres`` nodes); the readers
  ``api.pqueue_length``, ``pqueue_position``, ``queue_position``,
  ``event_is_scheduled``, ``event_time``, ``event_priority``,
  ``event_pattern_count`` and ``event_pattern_find`` are one node each
  (``pq_length``, ``pq_position``, ``q_position``, ``ev_scheduled``,
  ``ev_time``, ``ev_prio``, ``ev_pcount``, ``ev_pfind``), since they
  scan a queue's slots or the event table, read where they stand
  between the calls;
* a user event handler ``fn(sim, subj, arg) -> sim`` is traced as a
  block that returns no command (:func:`trace_handler`): its subject is
  the ``pid`` node, its argument the ``sig`` node;
* an engine call whose effect the block keeps or drops by selecting
  between the whole Sim before and after it (``where(pred, after,
  before)`` on every leaf the call touches, the reference's
  ``jax.tree.map(jnp.where, ...)`` idiom) becomes the call gated by that
  predicate (a chain of calls selected together, each gated); the
  leaves it touches are then read afresh after the select.  A select
  that covers only part of what a call touches, a predicate computed
  after the call, a read of the state after a gated call outside the
  select, or a use of a gated call's result (a handle, a pid,
  ``existed`` or a count) raises, naming the block and the line.

A traced value is a :class:`Sym`: a tensor subclass holding the value
torch computes on a real one-lane Sim (the *shadow*, which gives every
result its dtype and shape) and, element for element, the id of the node
that computes it.  Ops that only move elements (reshape, slicing, cat,
a gather by a constant index) move the ids with the same torch call.
A Python branch on a traced value (``__bool__``, ``.item()``,
``.tolist()``) raises, and so does any op the emitter
(:mod:`cimba_tpu_torch.core.emit`) does not know, naming the block, the
op and the source line.

:func:`replay` evaluates a block's IR with torch on a real batched Sim;
the tests hold it against the block itself, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
import os
import traceback
from typing import Any, List, NamedTuple, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode

from cimba_tpu_torch import config
from cimba_tpu_torch.core import process as pr
from cimba_tpu_torch.core.model import ProcessType


class TraceError(NotImplementedError):
    """A block the tracer (and so the generated kernel) cannot take."""


class Lit(NamedTuple):
    """A Python number in an op: torch rounds it to the op's dtype."""

    value: Any


@dataclasses.dataclass(frozen=True)
class Node:
    op: str
    args: tuple          # node ids (int) and Lit
    dtype: torch.dtype   # the result's
    cdt: Optional[torch.dtype] = None  # the dtype the op computes in
    aux: Any = None      # leaf: (name, flat index); const: value;
                         # draw: (sampler name, profile); cast: None


#: the comparisons (a bool result, computed in the operands' common
#: dtype)
COMPARE = ("lt", "le", "gt", "ge", "eq", "ne")

# torch function name -> (IR op, swap the two operands)
_BIN = {
    "add": ("add", False), "__add__": ("add", False),
    "__radd__": ("add", True), "sub": ("sub", False),
    "__sub__": ("sub", False), "subtract": ("sub", False),
    "__rsub__": ("sub", True), "mul": ("mul", False),
    "__mul__": ("mul", False), "__rmul__": ("mul", True),
    "multiply": ("mul", False), "div": ("div", False),
    "__truediv__": ("div", False), "true_divide": ("div", False),
    "divide": ("div", False), "__div__": ("div", False),
    "lt": ("lt", False), "__lt__": ("lt", False), "less": ("lt", False),
    "le": ("le", False), "__le__": ("le", False),
    "gt": ("gt", False), "__gt__": ("gt", False), "greater": ("gt", False),
    "ge": ("ge", False), "__ge__": ("ge", False),
    "eq": ("eq", False), "__eq__": ("eq", False),
    "ne": ("ne", False), "__ne__": ("ne", False),
    "__and__": ("and", False), "__rand__": ("and", True),
    "bitwise_and": ("and", False), "logical_and": ("and", False),
    "__or__": ("or", False), "__ror__": ("or", True),
    "bitwise_or": ("or", False), "logical_or": ("or", False),
    "__xor__": ("xor", False), "__rxor__": ("xor", True),
    "bitwise_xor": ("xor", False), "logical_xor": ("xor", False),
    "minimum": ("minimum", False), "maximum": ("maximum", False),
}
_UN = {
    "neg": "neg", "__neg__": "neg", "negative": "neg", "abs": "abs",
    "__abs__": "abs", "absolute": "abs", "sin": "sin", "cos": "cos",
    "exp": "exp", "log": "log", "log1p": "log1p", "sqrt": "sqrt",
    "floor": "floor", "ceil": "ceil", "isnan": "isnan",
    "isfinite": "isfinite", "isinf": "isinf", "__invert__": "not", "bitwise_not": "not",
    "logical_not": "not", "reciprocal": "reciprocal", "round": "round",
}
_CAST = {"double": torch.float64, "float": torch.float32,
         "int": torch.int32, "long": torch.int64, "bool": torch.bool}
_MOVE = {"reshape", "view", "expand", "squeeze", "unsqueeze", "flatten",
         "permute", "transpose", "t", "contiguous", "clone", "detach",
         "__getitem__", "select", "narrow", "broadcast_to", "cat", "concat",
         "concatenate", "stack", "index_select", "repeat"}
_META = {"__get__", "dim", "size", "numel", "is_floating_point",
         "is_contiguous", "element_size", "__len__", "nelement", "ndimension",
         "get_device", "__format__", "__repr__", "__str__", "data_ptr"}
_LIKE = {"ones_like", "zeros_like", "full_like", "empty_like"}
#: the ops of a Python branch on a tensor's value (the tracer refuses
#: them, and so does the plain engine's tag inference)
HOST_BRANCH = {"__bool__", "item", "tolist", "__int__", "__float__",
               "__index__", "numpy", "__array__", "__nonzero__"}


class Sym(torch.Tensor):
    """A traced value: the shadow's data, and ``ids`` (an int64 tensor
    of its shape) naming each element's node."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @staticmethod
    def __new__(cls, shadow, ids, tracer):
        r = torch.Tensor._make_subclass(cls, shadow)
        r.ids = ids
        r.tracer = tracer
        return r


def is_symbolic(sim) -> bool:
    """Whether ``sim`` is the tracer's symbolic Sim (api helpers ask)."""
    return isinstance(getattr(sim, "clock", None), Sym)


def _plain(x):
    return x.as_subclass(torch.Tensor) if isinstance(x, Sym) else x


def _unwrap(x):
    if isinstance(x, Sym):
        return _plain(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_unwrap(v) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    if isinstance(x, dict):
        return {k: _unwrap(v) for k, v in x.items()}
    return x


def _syms(x):
    if isinstance(x, Sym):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _syms(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _syms(v)


def _where_in_source() -> str:
    """file:line of the innermost frame outside torch and this module."""
    here = os.path.abspath(__file__)
    tdir = os.path.dirname(os.path.abspath(torch.__file__))
    for fr in reversed(traceback.extract_stack()):
        f = os.path.abspath(fr.filename)
        if f != here and not f.startswith(tdir):
            return f"{os.path.relpath(f)}:{fr.lineno}"
    return "?"


class Tracer(TorchFunctionMode):
    """Records the nodes and effects of one block or predicate."""

    def __init__(self, what: str):
        super().__init__()
        self.what = what
        self.nodes: List[Node] = []
        self._memo: dict = {}
        #: ("draw", nid) | ("write", leaf, flat, nid) | ("call", kind,
        #: args, nodes made before it)
        self.effects: list = []
        #: leaf name -> ids the storage holds now (writes committed)
        self.committed: dict = {}
        self.template: dict = {}
        #: the selects of each element a write by a traced index makes
        #: (one a candidate position): for the bound, one store
        self.puts: List[List[int]] = []
        #: the engine calls: what each touches, its gate (predicate node,
        #: negated) once a select lowers it, the elements the selects
        #: covered, the node count before it, its effect's index
        self.calls: List[dict] = []
        #: a leaf node read afresh after call k -> (k, the element's id
        #: before the call)
        self.post_of: dict = {}

    def fail(self, msg: str):
        raise TraceError(f"{self.what}: {msg} ({_where_in_source()})")

    # --- nodes ----------------------------------------------------------
    def node(self, op, args, dtype, cdt=None, aux=None) -> int:
        n = Node(op, tuple(args), dtype, cdt, aux)
        if op not in ("draw", "leaf") and op not in READERS:
            # reads of the state are tagged by their position
            key = (op, n.args, dtype, cdt, aux)
            got = self._memo.get(key)
            if got is not None:
                return got
            self._memo[key] = len(self.nodes)
        self.nodes.append(n)
        return len(self.nodes) - 1

    def const(self, value, dtype) -> int:
        v = bool(value) if dtype == torch.bool else (
            float(value) if dtype.is_floating_point else int(value))
        return self.node("const", (), dtype, aux=v)

    def const_ids(self, t: torch.Tensor) -> torch.Tensor:
        flat = [self.const(v, t.dtype) for v in t.reshape(-1).tolist()]
        return torch.tensor(flat, dtype=torch.int64).reshape(t.shape)

    def wrap(self, shadow, ids) -> Sym:
        return Sym(shadow, ids, self)

    def ids_of(self, x) -> torch.Tensor:
        return x.ids if isinstance(x, Sym) else self.const_ids(x)

    def cast_ids(self, ids, to):
        """Cast nodes where an element's dtype differs from ``to``."""
        out = ids.reshape(-1).tolist()
        for i, nid in enumerate(out):
            if self.nodes[nid].dtype != to:
                out[i] = self.node("cast", (nid,), to, to)
        return torch.tensor(out, dtype=torch.int64).reshape(ids.shape)

    # --- the torch function hook ----------------------------------------
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        syms = list(_syms(args)) + list(_syms(kwargs))
        if not syms:
            return func(*args, **kwargs)
        if name in HOST_BRANCH:
            self.fail("branches in Python on a traced value "
                      f"({name} of a traced tensor)")
        out = func(*_unwrap(args), **_unwrap(kwargs))
        if name in _META or name in _LIKE:
            return out
        if name.endswith("_") and not name.endswith("__"):
            self.fail(f"in-place op {name} on a traced value")
        if not isinstance(out, torch.Tensor):
            self.fail(f"op {name} returns {type(out).__name__}")
        if name in _BIN:
            op, swap = _BIN[name]
            a, b = args[0], args[1] if len(args) > 1 else kwargs.get("other")
            if kwargs.get("alpha", 1) != 1 or kwargs.get("rounding_mode"):
                self.fail(f"op {name} with {kwargs}")
            return self._elementwise(op, [b, a] if swap else [a, b], out)
        if name in ("__rtruediv__", "__rdiv__"):
            # python / tensor: torch computes reciprocal(tensor) * python
            r = self._elementwise("reciprocal", [args[0]], out.dtype)
            return self._elementwise("mul", [r, args[1]], out)
        if name in _UN:
            return self._elementwise(_UN[name], [args[0]], out)
        if name == "where":
            if len(args) + len(kwargs) != 3:
                self.fail("torch.where with one argument")
            c, a, b = (list(args) + [kwargs.get(k) for k in
                                     ("input", "other")])[:3]
            return self._select(c, a, b, out)
        if name in ("clamp", "clip", "clamp_min", "clamp_max"):
            x = args[0]
            lo = args[1] if len(args) > 1 else kwargs.get("min")
            hi = args[2] if len(args) > 2 else kwargs.get("max")
            if name == "clamp_max":
                lo, hi = None, lo
            return self._elementwise("clamp", [x, lo, hi], out)
        if name in _CAST or name in ("to", "type", "as_tensor", "tensor"):
            src = args[0] if name != "as_tensor" or args else kwargs["data"]
            if not isinstance(src, Sym):
                self.fail(f"op {name} on a traced value inside a container")
            if out.dtype == src.dtype and tuple(out.shape) == tuple(
                    src.shape):
                return self.wrap(out, src.ids.clone())
            if tuple(out.shape) != tuple(src.shape):
                self.fail(f"op {name} changes the shape")
            return self._elementwise("cast", [src], out)
        if name == "gather":
            return self._gather(args, kwargs, out)
        if name == "scatter":
            return self._scatter(args, kwargs, out)
        if name == "expand_as":
            return self.wrap(out, self.ids_of(args[0]).expand_as(
                _unwrap(args[1])))
        if name in _MOVE:
            return self._move(func, args, kwargs, out)
        self.fail(f"op {name} is not in the generated kernel's op table")

    def _move(self, func, args, kwargs, out):
        """An op that only moves elements: the same call on the ids."""
        if func.__name__ in ("__getitem__", "index_select") and any(
                True for x in list(args[1:]) + list(kwargs.values())
                for _ in _syms(x)):
            self.fail(f"indexing by a traced value ({func.__name__}); "
                      "use core.ix.get")

        def ids(x):
            if isinstance(x, Sym):
                return x.ids
            if isinstance(x, torch.Tensor) and func.__name__ in (
                    "cat", "concat", "concatenate", "stack"):
                return self.const_ids(x)
            if isinstance(x, (list, tuple)):
                return type(x)(ids(v) for v in x)
            return x

        moved = func(*ids(args), **{k: ids(v) for k, v in kwargs.items()})
        return self.wrap(out, self.cast_ids(moved, out.dtype))

    def _operand(self, x, bshape):
        """An operand of an elementwise op: node ids broadcast to
        ``bshape``, or a Lit for a Python number."""
        if x is None or isinstance(x, (bool, int, float)):
            return x if x is None else Lit(x)
        if isinstance(x, Sym):
            return x.ids.expand(bshape)
        if isinstance(x, torch.Tensor):
            return self.const_ids(x).expand(bshape)
        self.fail(f"operand of type {type(x).__name__}")

    def _elementwise(self, op, operands, out):
        """One node an element; ``out`` is the shadow result (or its
        dtype for an intermediate the op is expanded into)."""
        if isinstance(out, torch.dtype):
            dtype, shape = out, None
        else:
            dtype, shape = out.dtype, tuple(out.shape)
        tens = [x for x in operands if isinstance(x, torch.Tensor)]
        if shape is None:
            shape = tuple(torch.broadcast_shapes(*[t.shape for t in tens]))
        ops = [self._operand(x, shape) for x in operands]
        if op in COMPARE:
            a, b = operands
            cdt = torch.result_type(_plain(a) if isinstance(a, torch.Tensor)
                                    else a,
                                    _plain(b) if isinstance(b, torch.Tensor)
                                    else b)
        elif op in ("isnan", "isfinite", "isinf"):
            cdt = operands[0].dtype  # a bool of its operand's dtype
        else:
            cdt = dtype
        n = math.prod(shape) if shape else 1
        cols = [o.contiguous().reshape(-1).tolist()
                if isinstance(o, torch.Tensor) else [o] * n for o in ops]
        flat = [self.node(op, [c[i] for c in cols], dtype, cdt)
                for i in range(n)]
        ids = torch.tensor(flat, dtype=torch.int64).reshape(shape)
        if isinstance(out, torch.dtype):
            # an intermediate: its shadow is never read
            return self.wrap(torch.zeros(shape, dtype=dtype), ids)
        return self.wrap(out, ids)

    def _select(self, c, a, b, out):
        """``where(c, a, b)``: an element both sides share passes
        through; one that selects between the state after a chain of
        engine calls and the state before it gates the calls by ``c``
        (negated where the state before is the ``a`` side) and reads the
        element afresh; any other element is a ``where`` node."""
        shape = tuple(out.shape)
        tens = [x for x in (c, a, b) if isinstance(x, torch.Tensor)]
        if (len(tens) < 3 or not isinstance(c, Sym)
                or not (isinstance(a, Sym) or isinstance(b, Sym))):
            return self._elementwise("where", [c, a, b], out)
        fc, fa, fb = [self._operand(x, shape).contiguous().reshape(-1)
                      .tolist() for x in (c, a, b)]
        flat, fresh = [], {}
        for j in range(len(fa)):
            x, y = fa[j], fb[j]
            if x == y and self.nodes[x].dtype == out.dtype:
                flat.append(x)
                continue
            hit, neg = self._chain(x, y), False
            if hit is None:
                hit, neg = self._chain(y, x), True
            if hit is None:
                flat.append(self.node("where", (fc[j], x, y), out.dtype,
                                      out.dtype))
                continue
            self._gate(hit, fc[j], neg)
            name, i = self.nodes[x if not neg else y].aux
            nid = self.node("leaf", (), out.dtype, aux=(name, i))
            flat.append(nid)
            fresh.setdefault(name, {})[i] = nid
        # the storage holds what the fresh reads read
        for name, got in fresh.items():
            held = self.committed[name].clone()
            for i, nid in got.items():
                held.view(-1)[i] = nid
            self.committed[name] = held
        ids = torch.tensor(flat, dtype=torch.int64).reshape(shape)
        return self.wrap(out, ids)

    def _chain(self, post, pre):
        """The calls (and the element each re-read) between ``pre`` and
        ``post``, where ``post`` is an element's read after a chain of
        calls that began at ``pre``; else None."""
        hits, x = [], post
        while x in self.post_of:
            k, prev = self.post_of[x]
            hits.append((k, self.nodes[x].aux))
            if prev == pre:
                return hits
            x = prev
        return None

    def _gate(self, hits, pred, neg):
        for k, aux in hits:
            call = self.calls[k]
            if call["gate"] is None:
                if pred >= call["mark"]:
                    self.fail(f"the select of the state before and after "
                              f"the engine call {call['kind']} takes a "
                              "predicate computed after the call")
                call["gate"] = (pred, neg)
                call["line"] = _where_in_source()
            elif call["gate"] != (pred, neg):
                self.fail(f"the engine call {call['kind']} is selected "
                          "under two predicates")
            call["covered"].add(aux)

    def _gather(self, args, kwargs, out):
        arr, dim, index = (list(args) + [kwargs.get("dim"),
                                         kwargs.get("index")])[:3]
        if not isinstance(index, Sym):
            return self._move(torch.gather, args, kwargs, out)
        src = self.ids_of(arr)
        dim = dim % src.dim()
        flat = []
        for pos in _positions(index.shape):
            entries = []
            for j in range(src.shape[dim]):
                p = list(pos)
                p[dim] = j
                entries.append(int(src[tuple(p)]))
            flat.append(self.node("pick", [int(index.ids[pos])] + entries,
                                  out.dtype))
        ids = torch.tensor(flat, dtype=torch.int64).reshape(out.shape)
        return self.wrap(out, ids)

    def _scatter(self, args, kwargs, out):
        arr, dim, index = args[:3]
        src = args[3] if len(args) > 3 else kwargs.get("src",
                                                       kwargs.get("value"))
        if not isinstance(index, Sym):
            sv = (self.ids_of(src) if isinstance(src, torch.Tensor)
                  else self.const(src, out.dtype))
            moved = torch.scatter(self.ids_of(arr), dim, index, sv)
            return self.wrap(out, self.cast_ids(moved, out.dtype))
        ids = self.ids_of(arr).clone()
        dim = dim % ids.dim()
        src_ids = (self.ids_of(src) if isinstance(src, torch.Tensor)
                   else None)
        for pos in _positions(index.shape):
            iv = int(index.ids[pos])
            sv = (int(src_ids[pos]) if src_ids is not None
                  else self.const(src, out.dtype))
            if self.nodes[sv].dtype != out.dtype:
                sv = self.node("cast", (sv,), out.dtype, out.dtype)
            group = []
            for j in range(ids.shape[dim]):
                p = list(pos)
                p[dim] = j
                p = tuple(p)
                hit = self.node("eq", (iv, Lit(j)), torch.bool,
                                self.nodes[iv].dtype)
                ids[p] = self.node("where", (hit, sv, int(ids[p])), out.dtype,
                                   out.dtype)
                group.append(int(ids[p]))
            self.puts.append(group)
        return self.wrap(out, ids)


def _positions(shape):
    if not shape:
        yield ()
        return
    for i in range(math.prod(shape)):
        pos, r = [], i
        for d in reversed(shape):
            pos.append(r % d)
            r //= d
        yield tuple(reversed(pos))


# --- named leaves ---------------------------------------------------------


def named_leaves(tree, prefix="") -> list:
    """``[(name, leaf)]`` in JAX's leaf order (the names the kernel's
    leaf tables use: ``procs.locals_f``, ``user.wait.n``, ...)."""
    out = []

    def walk(x, name):
        if x is None:
            return
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            for f, v in zip(x._fields, x):
                walk(v, f"{name}.{f}" if name else f)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{name}.{i}")
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{name}.{k}" if name else str(k))
        else:
            out.append((name, x))

    walk(tree, prefix)
    return out


def _rebuild(template, leaves):
    from cimba_tpu_torch import tree

    return tree.unflatten(template, leaves)


# --- the IR ------------------------------------------------------------------


@dataclasses.dataclass
class BlockIR:
    """One block: its nodes, its effects in program order (draws, leaf
    writes, engine calls) and its command's six fields (node ids)."""

    name: str
    pc: int
    nodes: List[Node]
    effects: list
    cmd: Tuple[int, ...]  # tag, f, f2, f3, i, next_pc
    #: the selects of each write by a traced index (Tracer.puts)
    puts: List[List[int]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PredIR:
    """A condition's predicate for a waiter pid: a bool node."""

    name: str
    cid: int
    nodes: List[Node]
    out: int


#: leaves an engine call may change: read afresh after one
_CALL_TOUCHES = ("wakes.", "events.", "procs.pend_tag", "procs.pend_guard",
                 "procs.got", "procs.await_pid", "procs.await_evt",
                 "resources.", "pools.", "buffers.", "err", "guards.")
#: and a stop's, which also ends its target
_STOP_TOUCHES = _CALL_TOUCHES + ("procs.status", "procs.exit_sig")
#: and a spawn's, which resets the row it activates
_SPAWN_TOUCHES = _STOP_TOUCHES + ("procs.pc", "procs.prio",
                                  "procs.locals_f", "procs.locals_i")
#: the touches of the calls that change more than _CALL_TOUCHES
_TOUCHES = {"stop_process": _STOP_TOUCHES, "spawn": _SPAWN_TOUCHES,
            "priority_set": _CALL_TOUCHES + ("procs.prio",),
            "pqueue_cancel": _CALL_TOUCHES + ("pqueues.",),
            "pqueue_reprioritize": _CALL_TOUCHES + ("pqueues.",)}
#: the engine calls that return ``(sim, result)``, and the result's dtype
#: (a spawn's is the pid it activated)
_RESULTS = {"timer_add": torch.int32, "schedule": torch.int32,
            "spawn": torch.int32, "event_cancel": torch.bool,
            "event_reschedule": torch.bool, "event_reprioritize": torch.bool,
            "event_pattern_cancel": torch.int32, "pqueue_cancel": torch.bool,
            "pqueue_reprioritize": torch.bool}
#: the reader nodes: each scans a queue or the event table where it
#: stands (never shared with a read of the same state elsewhere)
READERS = ("pq_length", "pq_position", "q_position", "ev_scheduled",
           "ev_time", "ev_prio", "ev_pcount", "ev_pfind")


def _symbolic_sim(tr: Tracer, shadow):
    leaves = []
    for name, t in named_leaves(shadow):
        n = t.numel() // max(t.shape[0], 1)
        ids = torch.tensor([tr.node("leaf", (), t.dtype, aux=(name, i))
                            for i in range(n)],
                           dtype=torch.int64).reshape(t.shape)
        tr.committed[name] = ids
        tr.template[name] = t
        leaves.append(tr.wrap(t, ids))
    return _rebuild(shadow, leaves)


def _commit(tr: Tracer, sim):
    """Record a write for every leaf element whose node differs from
    what the storage holds."""
    for name, x in named_leaves(sim):
        if isinstance(x, Sym):
            ids = x.ids
        elif isinstance(x, torch.Tensor):
            ids = tr.const_ids(x)
        else:
            tr.fail(f"leaf {name} is a {type(x).__name__}")
        tmpl = tr.template.get(name)
        if tmpl is None:
            tr.fail(f"the block adds leaf {name}")
        if tuple(ids.shape) != tuple(tmpl.shape):
            tr.fail(f"leaf {name} changes shape {tuple(tmpl.shape)} -> "
                    f"{tuple(ids.shape)}")
        old = tr.committed[name].reshape(-1).tolist()
        for i, nid in enumerate(ids.reshape(-1).tolist()):
            if nid != old[i]:
                if tr.nodes[nid].dtype != tmpl.dtype:
                    tr.fail(f"leaf {name} written as {tr.nodes[nid].dtype}, "
                            f"the Sim holds {tmpl.dtype}")
                tr.effects.append(("write", name, i, nid))
        tr.committed[name] = ids.clone()


def _arg(tr: Tracer, x):
    if isinstance(x, Sym):
        if x.numel() != 1:
            tr.fail("an engine call's argument is not one value a lane")
        return int(x.ids.reshape(-1)[0])
    if isinstance(x, torch.Tensor):
        if x.numel() != 1:
            tr.fail("an engine call's argument is not one value a lane")
        return tr.const(x.reshape(-1)[0].item(), x.dtype)
    return Lit(x)


def engine_call(sim, kind: str, *args):
    """An engine call of a block under the tracer (``api.pool_release``,
    ``release``, ``cond_signal``, ``interrupt``, ``stop_process``,
    ``timer_add``, ``timers_clear``, ``schedule``, ``spawn``): the writes
    so far are committed, the call recorded, and the leaves it may change
    read afresh.  ``timer_add``, ``schedule`` and ``spawn`` return ``(sim,
    handle)``, the handle (a spawn's pid) a ``callres`` node, which no
    block may use where the call is gated."""
    tr = sim.clock.tracer
    refs = tuple(_arg(tr, a) for a in args)
    _commit(tr, sim)
    k, mark = len(tr.calls), len(tr.nodes)
    tr.effects.append(("call", kind, refs, mark))
    touched = {}
    leaves = []
    touches = _TOUCHES.get(kind, _CALL_TOUCHES)
    for name, x in named_leaves(sim):
        if name.startswith(touches):
            t = tr.template[name]
            n = t.numel() // t.shape[0]
            pre = tr.committed[name].reshape(-1).tolist()
            ids = torch.tensor([tr.node("leaf", (), t.dtype, aux=(name, i))
                                for i in range(n)],
                               dtype=torch.int64).reshape(t.shape)
            for nid, old in zip(ids.reshape(-1).tolist(), pre):
                tr.post_of[nid] = (k, old)
            touched[name] = n
            tr.committed[name] = ids
            x = tr.wrap(t, ids)
        leaves.append(x)
    tr.calls.append(dict(kind=kind, touched=touched, gate=None,
                         covered=set(), mark=mark,
                         effect=len(tr.effects) - 1, line=None))
    out = _rebuild(sim, leaves)
    dt = _RESULTS.get(kind)
    if dt is not None:
        h = tr.node("callres", (), dt, aux=k)
        return out, tr.wrap(torch.zeros(1, dtype=dt),
                            torch.tensor([h], dtype=torch.int64))
    return out


_API_OF = {"pq_length": "pqueue_length", "pq_position": "pqueue_position",
           "q_position": "queue_position"}


def read(sim, op: str, qid, *args):
    """A reader of the state under the tracer (``READERS``): one node,
    read where it stands between the block's engine calls.  ``pq_length``
    and ``pq_position`` (of the item ``args[0]``) scan priority queue
    ``qid``'s slots, ``q_position`` object queue ``qid``'s ring;
    ``ev_scheduled``, ``ev_time`` and ``ev_prio`` read the event table at
    the handle ``args[0]``, ``ev_pcount`` and ``ev_pfind`` scan it for
    the pattern (kind, subject) ``args``."""
    tr = sim.clock.tracer
    if op in _API_OF:
        if not isinstance(qid, int):
            tr.fail(f"api.{_API_OF[op]} of a traced queue id")
        leaf = "queues.items" if op == "q_position" else "pqueues.live"
        aux = (qid, tr.template[leaf].shape[2])
    else:
        aux = (tr.template["events.time"].shape[1],)
    refs = tuple(_arg(tr, a) for a in args)
    # pqueue_length is the reference's int64 sum, event_time the table's
    # time, event_is_scheduled a bool, the rest int32
    dt = {"pq_length": torch.int64, "ev_scheduled": torch.bool,
          "ev_time": tr.template["events.time"].dtype}.get(op, torch.int32)
    nid = tr.node(op, refs, dt, aux=aux)
    return tr.wrap(torch.zeros(1, dtype=dt),
                   torch.tensor([nid], dtype=torch.int64))


def _check_calls(tr: Tracer, ir_roots) -> None:
    """The gated calls' selects cover every element the call touches,
    and nothing live reads the state after a gated call but the
    select."""
    post = {}
    for k, call in enumerate(tr.calls):
        if call["gate"] is None:
            continue
        for name, n in call["touched"].items():
            for i in range(n):
                if (name, i) not in call["covered"]:
                    raise TraceError(
                        f"{tr.what}: the select at {call['line']} keeps or "
                        f"drops the engine call {call['kind']} but leaves "
                        f"{name}[{i}] out: select every leaf the call "
                        "touches under one predicate")
    gated = {k for k, c in enumerate(tr.calls) if c["gate"] is not None}
    for nid, (k, _) in tr.post_of.items():
        if k in gated:
            post[nid] = k
    if not gated:
        return
    live, stack = set(), [r for r in ir_roots if isinstance(r, int)]
    while stack:
        i = stack.pop()
        if i in live:
            continue
        live.add(i)
        n = tr.nodes[i]
        if i in post:
            call = tr.calls[post[i]]
            raise TraceError(
                f"{tr.what}: reads {n.aux[0]} after the engine "
                f"call {call['kind']} outside the select at {call['line']} "
                "that keeps or drops it")
        if n.op == "callres" and n.aux in gated:
            # the kernel makes a gated call under its gate only: its
            # result names nothing where the gate is shut
            call = tr.calls[n.aux]
            what = {"spawn": "pid", "timer_add": "handle",
                    "schedule": "handle"}.get(call["kind"], "result")
            raise TraceError(
                f"{tr.what}: uses the {what} of a {call['kind']} that the "
                f"select at {call['line']} keeps or drops")
        stack += [a for a in n.args if isinstance(a, int)]


def draw(sim, dist, params):
    """``api.draw`` under the tracer: one draw node naming the sampler;
    its shadow value comes from the sampler itself."""
    tr = sim.clock.tracer
    prof = "f32" if sim.clock.dtype == torch.float32 else "f64"
    refs = []
    for x in params:
        if isinstance(x, (bool, int, float)):
            refs.append(Lit(x))
        elif isinstance(x, torch.Tensor):
            refs.append(_arg(tr, x))
        else:
            tr.fail(f"sampler {getattr(dist, '__name__', dist)} takes a "
                    f"{type(x).__name__} parameter")
    with config.profile(prof):
        _, x = dist(_unwrap(sim.rng), *_unwrap(list(params)))
    if x.numel() != 1:
        tr.fail("a draw gives more than one value a lane")
    name = f"{getattr(dist, '__module__', '')}.{getattr(dist, '__name__', '')}"
    nid = tr.node("draw", refs, x.dtype, aux=(name, prof))
    tr.effects.append(("draw", nid))
    return sim, tr.wrap(x, torch.tensor([nid], dtype=torch.int64)
                        .reshape(x.shape))


def _one_lane(sims):
    from cimba_tpu_torch import tree

    return tree.map(lambda x: x[:1].detach().to("cpu").clone(), sims)


def trace_block(spec, pc: int, sims) -> BlockIR:
    """Trace block ``pc`` of ``spec`` on a one-lane copy of ``sims``
    (any Sim of the spec: it fixes the dtypes and shapes)."""
    blk = spec.blocks[pc]
    return _trace(spec, blk, pc, f"block {getattr(blk, '__name__', pc)!r} "
                  f"(pc {pc}) of spec {spec.name!r}", sims, handler=False)


def trace_handler(spec, k: int, sims) -> BlockIR:
    """Trace user event handler ``k`` of ``spec`` (event kind
    ``N_KINDS + k``): a block whose ``pid`` node is the event's subject,
    whose ``sig`` node is its argument, and which returns no command
    (``BlockIR.cmd`` is empty)."""
    fn = spec.user_handlers[k]
    return _trace(spec, fn, k, f"handler {getattr(fn, '__name__', k)!r} "
                  f"(kind {k + 2}) of spec {spec.name!r}", sims, handler=True)


def _trace(spec, fn, pc, what, sims, handler) -> BlockIR:
    tr = Tracer(what)
    shadow = _one_lane(sims)
    real = shadow.clock.dtype
    prof = "f32" if real == torch.float32 else "f64"
    with config.profile(prof):
        with tr:
            sym = _symbolic_sim(tr, shadow)
            p = tr.wrap(torch.zeros(1, dtype=torch.int32),
                        torch.tensor([tr.node("pid", (), torch.int32)]))
            sig = tr.wrap(torch.zeros(1, dtype=torch.int32),
                          torch.tensor([tr.node("sig", (), torch.int32)]))
            out = fn(sym, p, sig)
            fields = []
            if handler:
                if not is_symbolic(out):
                    tr.fail("a handler returns the Sim")
                _commit(tr, out)
            else:
                if not (isinstance(out, tuple) and len(out) == 2):
                    tr.fail("a block returns (sim, Command)")
                sim2, cmd = out
                cmd = pr.normalize(cmd, 1, torch.device("cpu"), real)
                _commit(tr, sim2)
                for k, v in enumerate(cmd):
                    if isinstance(v, Sym):
                        fields.append(int(v.ids.reshape(-1)[0]))
                    else:
                        fields.append(tr.const(v.reshape(-1)[0].item(),
                                               v.dtype))
    effects = list(tr.effects)
    for call in tr.calls:
        if call["gate"] is not None:
            effects[call["effect"]] = effects[call["effect"]] + (
                call["gate"],)
    roots = list(fields)
    for e in effects:
        if e[0] == "draw":
            roots += [a for a in tr.nodes[e[1]].args if isinstance(a, int)]
        elif e[0] == "write":
            roots.append(e[3])
        else:
            roots += [a for a in e[2] if isinstance(a, int)]
            if len(e) > 4:
                roots.append(e[4][0])
    _check_calls(tr, roots)
    return BlockIR(getattr(fn, "__name__", str(pc)), pc, tr.nodes,
                   effects, tuple(fields), tr.puts)


def trace_predicate(spec, cid: int, sims) -> PredIR:
    """Trace condition ``cid``'s predicate for a symbolic waiter pid."""
    c = spec.conditions[cid]
    tr = Tracer(f"predicate of condition {c.name!r} of spec {spec.name!r}")
    shadow = _one_lane(sims)
    prof = "f32" if shadow.clock.dtype == torch.float32 else "f64"
    with config.profile(prof):
        with tr:
            sym = _symbolic_sim(tr, shadow)
            pid = tr.wrap(torch.zeros(1, dtype=torch.int32),
                          torch.tensor([tr.node("pid", (), torch.int32)]))
            v = c.predicate(sym, pid)
            if isinstance(v, Sym):
                if v.numel() != 1:
                    tr.fail("the predicate is not one bool a lane")
                out = int(v.ids.reshape(-1)[0])
                if tr.nodes[out].dtype != torch.bool:
                    out = tr.node("cast", (out,), torch.bool, torch.bool)
            else:
                out = tr.const(bool(torch.as_tensor(v).reshape(-1)[0]),
                               torch.bool)
    if tr.effects:
        tr.fail("a predicate draws or calls the engine")
    return PredIR(c.name, cid, tr.nodes, out)


# --- replay ----------------------------------------------------------------


def _sampler(name: str):
    import importlib

    mod, _, fn = name.rpartition(".")
    return getattr(importlib.import_module(mod), fn)


def eval_nodes(nodes, env_leaf, pid, sig, lanes, device, draw_fn=None,
               upto=None, vals=None, results=None):
    """Evaluate ``nodes`` (in order) with torch over ``lanes`` lanes:
    ``env_leaf(name, flat)`` reads a leaf element, ``draw_fn(node,
    params)`` draws, ``results[k]`` is engine call k's result.  Returns
    the list of values (a node's own order)."""
    vals = [] if vals is None else vals
    end = len(nodes) if upto is None else upto
    for nid in range(len(vals), end):
        n = nodes[nid]
        if n.op == "callres":
            vals.append(results[n.aux])
            continue
        vals.append(_eval(n, vals, env_leaf, pid, sig, lanes, device,
                          draw_fn))
    return vals


def _pq_rows(env_leaf, qid, width):
    """Queue ``qid``'s slots, ``[lanes, width]`` each: live, items, prio,
    seq."""
    def rows(name):
        return torch.stack([env_leaf(name, qid * width + j)
                            for j in range(width)], dim=1)

    return (rows("pqueues.live"), rows("pqueues.items"),
            rows("pqueues.prio"), rows("pqueues.seq"))


def _lit(a, vals, cdt):
    if isinstance(a, Lit):
        return a.value
    v = vals[a]
    return v if cdt is None or v.dtype == cdt else v.to(cdt)


def _eval(n: Node, vals, env_leaf, pid, sig, lanes, device, draw_fn):
    op = n.op
    if op == "leaf":
        return env_leaf(*n.aux)
    if op == "const":
        return torch.full((lanes,), n.aux, dtype=n.dtype, device=device)
    if op == "pid":
        return pid.to(torch.int32)
    if op == "sig":
        return sig.to(torch.int32)
    if op == "draw":
        params = [a.value if isinstance(a, Lit) else vals[a] for a in n.args]
        return draw_fn(n, params)
    if op == "pick":
        idx = vals[n.args[0]].to(torch.int64)
        out = vals[n.args[1]]
        for j, e in enumerate(n.args[1:]):
            out = torch.where(idx == j, vals[e], out)
        return out
    if op == "cast":
        return vals[n.args[0]].to(n.dtype)
    if op in ("pq_length", "pq_position"):
        from cimba_tpu_torch.core import api

        live, items, prio, seq = _pq_rows(env_leaf, *n.aux)
        if op == "pq_length":
            return live.to(torch.int32).sum(dim=1)
        pq = _PQ(items=items[:, None], prio=prio[:, None],
                 seq=seq[:, None], live=live[:, None])
        return api.pqueue_position(_PQSim(pq), 0, vals[n.args[0]])
    if op in READERS:
        return _read_state(n, vals, env_leaf)
    if op == "where":
        c = vals[n.args[0]]
        a = _lit(n.args[1], vals, n.cdt)
        b = _lit(n.args[2], vals, n.cdt)
        a = a if isinstance(a, torch.Tensor) else torch.tensor(
            a, dtype=n.cdt, device=device)
        b = b if isinstance(b, torch.Tensor) else torch.tensor(
            b, dtype=n.cdt, device=device)
        return torch.where(c, a, b).to(n.dtype)
    if op == "clamp":
        x = _lit(n.args[0], vals, n.cdt)
        lo = None if n.args[1] is None else _lit(n.args[1], vals, n.cdt)
        hi = None if n.args[2] is None else _lit(n.args[2], vals, n.cdt)
        return torch.clamp(x, lo, hi)
    args = [_lit(a, vals, n.cdt) for a in n.args]
    args = [a if isinstance(a, torch.Tensor) else torch.tensor(
        a, dtype=n.cdt, device=device) for a in args]
    fn = {
        "neg": torch.neg, "abs": torch.abs, "sin": torch.sin,
        "cos": torch.cos, "exp": torch.exp, "log": torch.log,
        "log1p": torch.log1p, "sqrt": torch.sqrt, "floor": torch.floor,
        "ceil": torch.ceil, "isnan": torch.isnan, "isfinite": torch.isfinite,
        "isinf": torch.isinf,
        "not": torch.bitwise_not, "reciprocal": torch.reciprocal,
        "round": torch.round,
        "add": torch.add, "sub": torch.sub, "mul": torch.mul,
        "div": torch.div, "lt": torch.lt, "le": torch.le, "gt": torch.gt,
        "ge": torch.ge, "eq": torch.eq, "ne": torch.ne,
        "and": torch.bitwise_and, "or": torch.bitwise_or,
        "xor": torch.bitwise_xor, "minimum": torch.minimum,
        "maximum": torch.maximum,
    }[op]
    return fn(*args).to(n.dtype)


def _read_state(n: Node, vals, env_leaf):
    """A reader node of the object queues or the event table, evaluated
    by the api's own reader on the rows it scans."""
    from cimba_tpu_torch.core import api
    from cimba_tpu_torch.core import eventset as ev
    from cimba_tpu_torch.core import loop

    args = [a.value if isinstance(a, Lit) else vals[a] for a in n.args]

    def rows(name, lo, width):
        return torch.stack([env_leaf(name, lo + j) for j in range(width)],
                           dim=1)

    if n.op == "q_position":
        qid, width = n.aux
        q = loop.Queues(items=rows("queues.items", qid * width, width)[
            :, None], head=env_leaf("queues.head", qid)[:, None],
            size=env_leaf("queues.size", qid)[:, None])
        return api.queue_position(_QSim(q), 0, args[0])
    (cap,) = n.aux
    time = rows("events.time", 0, cap)
    z = torch.zeros_like(time, dtype=torch.int32)
    es = ev.EventSet(time=time, prio=rows("events.prio", 0, cap), seq=z,
                     kind=rows("events.kind", 0, cap),
                     subj=rows("events.subj", 0, cap),
                     arg=z, gen=rows("events.gen", 0, cap),
                     next_seq=z[:, 0], overflow=z[:, 0].bool())
    fn = {"ev_scheduled": api.event_is_scheduled, "ev_time": api.event_time,
          "ev_prio": api.event_priority,
          "ev_pcount": lambda s, k, sj: ev.pattern_count(s.events, k, sj),
          "ev_pfind": lambda s, k, sj: ev.pattern_find(s.events, k, sj)}
    return fn[n.op](_ESim(es), *args)


class _QSim(NamedTuple):
    queues: Any


class _ESim(NamedTuple):
    events: Any


class _PQ(NamedTuple):
    items: Any
    prio: Any
    seq: Any
    live: Any


class _PQSim(NamedTuple):
    pqueues: Any


def replay(spec, ir: BlockIR, sim, p, sig):
    """Run ``ir`` as a block on a real batched Sim: ``(sim, Command)``
    as the block itself returns it (fields normalised); a handler's IR
    (no command) gives the Sim alone, ``p`` its subject and ``sig`` its
    argument."""
    from cimba_tpu_torch.core import api
    from cimba_tpu_torch.core import loop

    lanes, dev = sim.clock.shape[0], sim.clock.device
    state = {"sim": sim}

    def leaf(name, flat):
        x = dict(named_leaves(state["sim"]))[name]
        return x.reshape(lanes, -1)[:, flat]

    def do_draw(n, params):
        s, x = api.draw(state["sim"], _sampler(n.aux[0]), *params)
        state["sim"] = s
        return x.reshape(lanes) if x.numel() == lanes else x.expand(lanes)

    vals: list = []
    results: dict = {}  # engine call k -> its result (a timer's handle)
    pending: dict = {}  # leaf -> {flat index: node} (committed at calls)

    def flush(vals):
        s = state["sim"]
        leaves = []
        for name, x in named_leaves(s):
            w = pending.get(name)
            if w:
                flat = x.reshape(lanes, -1).clone()
                for i, nid in w.items():
                    flat[:, i] = vals[nid]
                x = flat.reshape(x.shape)
            leaves.append(x)
        state["sim"] = _rebuild(s, leaves)
        pending.clear()

    n_call = 0
    for e in ir.effects:
        if e[0] == "draw":
            eval_nodes(ir.nodes, leaf, p, sig, lanes, dev, do_draw, e[1] + 1,
                       vals, results)
        elif e[0] == "write":
            pending.setdefault(e[1], {})[e[2]] = e[3]
        else:
            # every node made before the call reads the state before it
            eval_nodes(ir.nodes, leaf, p, sig, lanes, dev, do_draw, e[3],
                       vals, results)
            flush(vals)
            args = [a.value if isinstance(a, Lit) else vals[a]
                    for a in e[2]]
            s = state["sim"]
            out, res = _call(spec, s, e[1], args)
            if len(e) > 4:  # gated by a select of the whole Sim
                g = vals[e[4][0]]
                out = loop._where(~g if e[4][1] else g, out, s)
            state["sim"] = out
            results[n_call] = res
            n_call += 1
    eval_nodes(ir.nodes, leaf, p, sig, lanes, dev, do_draw, None, vals,
               results)
    flush(vals)
    if not ir.cmd:
        return state["sim"]
    cmd = pr.Command(*[vals[f] for f in ir.cmd])
    return state["sim"], cmd


def _call(spec, s, kind, args):
    """An engine call on a real Sim: (sim, result)."""
    from cimba_tpu_torch.core import loop

    if kind == "pool_release":
        k, pp, amt = args
        return loop.release_pool(spec, s, pp.to(torch.int32), k, amt), None
    if kind == "cond_signal":
        return loop.cond_signal(spec, s, args[0]), None
    if kind == "interrupt":
        return loop.interrupt(spec, s, *args), None
    if kind == "stop_process":
        return loop.stop_process(spec, s, args[0]), None

    def pid(x):
        return x.to(torch.int32) if isinstance(x, torch.Tensor) else x

    if kind == "release":
        rid, pp = args
        return loop.release_resource(spec, s, pid(pp), rid), None
    if kind == "schedule":
        return loop.schedule(s, *args)
    if kind == "timer_add":
        pp, dur, sig = args
        return loop.timer_add(s, pid(pp), dur, sig)
    if kind == "timers_clear":
        return loop.timers_clear(s, pid(args[0])), None
    if kind == "spawn":
        first, count, entry, prio, at, prio_ = args
        pt = ProcessType("", entry, prio, count, False, first)
        return loop.spawn_process(s, pt, at=at, prio=prio_)
    from cimba_tpu_torch.core import api

    if kind == "event_cancel":
        h, eager = args
        return loop.timer_cancel(s, h, spec if eager else None)
    if kind == "event_reschedule":
        return api.event_reschedule(s, *args)
    if kind == "event_reprioritize":
        return api.event_reprioritize(s, *args)
    if kind == "event_pattern_cancel":
        return api.event_pattern_cancel(s, *args)
    if kind == "priority_set":
        return loop.priority_set(s, pid(args[0]), args[1]), None
    if kind == "pqueue_cancel":
        return loop.pqueue_cancel(s, spec.pqueues[args[0]], args[1])
    if kind == "pqueue_reprioritize":
        return loop.pqueue_reprioritize(s, *args)
    raise TraceError(f"engine call {kind}")
