"""Emit a spec's traced blocks as a family of the CUDA chunk kernel.

The IR of :mod:`cimba_tpu_torch.core.trace` becomes one header that
defines ``Gen<float>`` or ``Gen<double>`` (the profile of the Sim it was
traced on), a model family of the engine in ``csrc/queue_chunk.cu`` with
the interface the hand-written families have:

* the blocks, the user event handlers and the conditions' predicates as
  inlined device functions, a switch on pc, a template on the handler
  and on the condition id;
* the Sim's leaf positions, the user state's leaves as shared-memory
  columns (``UCold``, with the processes' float and integer locals), and
  their load and store;
* ``NP``, ``NQ``, ``NR``, ``NK``, ``NV``, ``NC``, ``NPQ``, ``NH``, the
  queues', resources', pools', buffers', priority queues' and
  conditions' capacities, guards, recording flags and observer lists,
  all compile-time constants (a command's component id is dispatched
  over them, ``by_id``), ``MUG``, whether a block may issue a pool
  preempt, and each spawn pool's pids and entry (``spawn_first``,
  ``spawn_count``, ``spawn_entry``);
* the engine calls of a block or handler (a resource's or a pool's
  release, a condition's signal, an interrupt, a stop, a timer's insert,
  a pattern cancel of a process's timers, a user event's insert, a spawn
  of a pool type, an event's cancel, move or reprioritize by handle, a
  pattern cancel, a process's priority, a priority queue's item cancel
  or reprioritize), each under its gate where a select of the whole Sim
  keeps or drops it, and the readers of the queues and the event table
  (``pq_length<Q>``, ``pq_position<Q>``, ``queue_position<Q>``,
  ``ev_valid``, ``ev_time``, ``ev_prio``, ``pattern_count``,
  ``pattern_find``);
* ``WAITP`` and ``WAITE``, whether a block may return ``wait_process`` or
  ``wait_event`` (the kernel compiles the waits' rules, and keeps each
  process's awaited pid or handle, only where it may);
* the launch bounds, the block's lanes and whether its shared columns
  take dynamic shared memory (:func:`smem_plan`, ``DYN``);
* ``BOUNDARY`` and ``boundary(pc)``, the spec's boundary blocks
  (``Model.boundary_block``): each is a stub, never traced, since the
  kernel freezes a lane whose next dispatch resumes a process there and
  the host's boundary round runs the block with torch
  (``kernel_run.make_boundary_step``), so its body may use any torch op.

Each node is one ``const`` local of the C++ type of its dtype; an op casts
its operands to the dtype torch computes it in, a Python number is rounded
to that dtype as torch rounds it, and a division by a Python number is a
multiply by its reciprocal, as torch's CUDA kernel computes it.  Reads of
per-process columns by a traced pid (``ix.get``) are unrolled selects, and
writes by one (``ix.put``) predicated stores, never a local array indexed
by a run-time pid.  A leaf, op or sampler the kernel has no counterpart
for raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List

import torch

from cimba_tpu_torch.core import process as pr
from cimba_tpu_torch.core import trace as tr
from cimba_tpu_torch.core.model import ModelSpec

_CTYPE = {torch.float32: "float", torch.float64: "double",
          torch.int32: "int32_t", torch.int64: "int64_t",
          torch.bool: "bool"}

#: the samplers with a device counterpart (csrc/samplers.cuh), by the
#: name the draw node gives them, and their parameter counts
SAMPLERS = {
    "cimba_tpu_torch.random.distributions.uniform01": ("uniform01", 0),
    "cimba_tpu_torch.random.distributions.exponential": ("exponential", 1),
    "cimba_tpu_torch.random.distributions.uniform": ("uniform", 2),
    "cimba_tpu_torch.random.distributions.normal": ("normal", 2),
    "cimba_tpu_torch.random.distributions.lognormal": ("lognormal", 2),
    "cimba_tpu_torch.random.distributions.triangular": ("triangular", 3),
    "cimba_tpu_torch.random.distributions.pert": ("pert", 3),
    "cimba_tpu_torch.random.distributions.beta": ("beta", 4),
    "cimba_tpu_torch.random.distributions.gamma": ("gamma", 2),
}
#: the samplers that draw a data-dependent number of blocks (a rejection
#: loop): they take the lane's state and draw through it
LOOPING = {"pert", "beta", "gamma"}
#: the integer sampler: dice(a, b), an int64 of one block
DICE = "cimba_tpu_torch.random.distributions.dice"

#: a process's packed word holds a guard id and a pc in 8 signed bits
#: each; past REG_NP processes the wakes and words, past REG_NG guards the
#: guards' seq counters, live in shared columns (queue_chunk.cu Col; the
#: header's BIG and GBIG, decided here only), which bound the processes
#: only by a lane's shared memory and the code the kicks' dispatch inlines
MAX_GUARDS, MAX_PROCS, MAX_BLOCKS = 127, 32, 127
REG_NP, REG_NG = 10, 8
#: the kernel's leaf pointer array (queue_chunk.cu MAX_LEAVES)
MAX_LEAVES = 128
#: static shared memory a block may use, and dynamic shared memory (the
#: card's 227 KB a block; a family past it is refused)
SMEM, SMEM_DYN = 48 * 1024, 227 * 1024


def _ctype(dt, what):
    c = _CTYPE.get(dt)
    if c is None:
        raise NotImplementedError(f"{what}: dtype {dt} has no kernel type")
    return c


def _lit(value, dt) -> str:
    """A Python number rounded to ``dt`` as torch rounds it."""
    if dt == torch.bool:
        return "true" if value else "false"
    if dt.is_floating_point:
        v = float(value)
        if math.isnan(v):
            return f"{_CTYPE[dt]}(NAN)"
        if math.isinf(v):
            return f"{_CTYPE[dt]}({'-' if v < 0 else ''}INFINITY)"
        return f"{_CTYPE[dt]}({v.hex()})"
    v = int(value)
    if dt == torch.int64:
        return f"int64_t({v}LL)"
    return f"{_CTYPE[dt]}({v})"


class _Layout:
    """The Sim's leaves as the kernel sees them."""

    def __init__(self, spec: ModelSpec, sims):
        self.spec = spec
        named = tr.named_leaves(sims)
        self.names = [n for n, _ in named]
        self.pos = {n: i for i, n in enumerate(self.names)}
        self.leaf = {n: x for n, x in named}
        self.real = sims.clock.dtype
        self.user = [n for n in self.names if n.startswith("user.")]
        for n in self.user:
            x = self.leaf[n]
            if x.dim() != 1:
                raise NotImplementedError(
                    f"spec {spec.name!r}: user leaf {n} has per-lane shape "
                    f"{tuple(x.shape[1:])}; the generated kernel takes one "
                    "value a lane")
            _ctype(x.dtype, f"spec {spec.name!r}: user leaf {n}")
        if len(self.names) > MAX_LEAVES:
            raise NotImplementedError(
                f"spec {spec.name!r}: {len(self.names)} Sim leaves, the "
                f"kernel takes at most {MAX_LEAVES}")

    def at(self, name) -> int:
        return self.pos.get(name, -1)


def check_spec(spec: ModelSpec) -> None:
    """Refuse what the generated family cannot hold, before tracing."""
    why = None
    if spec.n_guards > MAX_GUARDS:
        why = f"{spec.n_guards} guards (at most {MAX_GUARDS})"
    elif spec.n_procs > MAX_PROCS:
        why = f"{spec.n_procs} processes (at most {MAX_PROCS})"
    elif len(spec.blocks) > MAX_BLOCKS:
        why = f"{len(spec.blocks)} blocks (at most {MAX_BLOCKS})"
    if why:
        raise NotImplementedError(
            f"spec {spec.name!r}: the generated chunk kernel takes no {why}")


class _Fn:
    """The C++ body of one block or predicate."""

    def __init__(self, lay: _Layout, nodes, what: str):
        self.lay, self.nodes, self.what = lay, nodes, what
        self.lines: List[str] = []
        self.done = 0
        self.live = [False] * len(nodes)

    def fail(self, msg):
        raise NotImplementedError(f"{self.what}: {msg}")

    def mark(self, roots):
        stack = [r for r in roots if isinstance(r, int)]
        while stack:
            i = stack.pop()
            if self.live[i]:
                continue
            self.live[i] = True
            stack += [a for a in self.nodes[i].args if isinstance(a, int)]

    # --- leaves --------------------------------------------------------
    def access(self, name, i, write=False) -> str:
        lay = self.lay
        if name.startswith("user."):
            return f"UCOL(s, u{lay.user.index(name)}, 0)"
        if name == "procs.locals_f":
            return f"UCOL(s, lf, {i})"
        if name == "procs.locals_i":
            return f"UCOL(s, li, {i})"
        if name == "done":
            return "s.done"
        if name == "err":
            return "s.err"
        if not write:
            if name == "clock":
                return "s.clock"
            if name == "n_events":
                return "s.n_events"
            if name == "rep":
                return "row<int32_t, S>(w, REP, 1)[0]"
            if name == "procs.got":
                return f"COLD(s, got, {i})"
            if name == "procs.prio":
                return f"COLD(s, prio, {i})"
            if name == "procs.status":
                return f"get(s, F_STATUS, {i})"
            if name == "queues.size":
                return f"s.size[{i}]"
            if name == "queues.head":
                return f"s.head[{i}]"
            if name == "pools.level":
                return f"s.pool_level[{i}]"
            if name == "pools.next_seq":
                return f"s.pool_next_seq[{i}]"
            if name == "pools.held":
                return f"SCOL(s, held, {i})"
            if name == "pools.held_seq":
                return f"SCOL(s, held_seq, {i})"
            if name == "buffers.level":
                return f"s.buf_level[{i}]"
            if name == "resources.holder":
                return f"s.holder[{i}]"
        self.fail(f"{'writes' if write else 'reads'} Sim leaf {name}, which "
                  "the generated kernel does not give a block")

    # --- nodes -----------------------------------------------------------
    def ref(self, a, cdt) -> str:
        if isinstance(a, tr.Lit):
            return _lit(a.value, cdt)
        n = self.nodes[a]
        if cdt is None or n.dtype == cdt:
            return f"v{a}"
        return f"static_cast<{_ctype(cdt, self.what)}>(v{a})"

    def expr(self, i) -> str:
        n = self.nodes[i]
        op, a, cdt = n.op, n.args, n.cdt
        if op == "leaf":
            return self.access(*n.aux)
        if op == "const":
            return _lit(n.aux, n.dtype)
        if op == "pid":
            return "int32_t(p)"
        if op == "sig":
            return "sig"
        if op == "cast":
            return f"static_cast<{_ctype(n.dtype, self.what)}>(v{a[0]})"
        if op == "pick":
            out = f"v{a[1]}"
            for j, e in enumerate(a[2:], start=1):
                out = f"(v{a[0]} == {j} ? v{e} : {out})"
            return out
        if op == "pq_length":
            return f"pq_length<{n.aux[0]}>(s, w)"
        if op in ("pq_position", "q_position"):
            fn = "pq_position" if op == "pq_position" else "queue_position"
            return (f"{fn}<{n.aux[0]}>(s, w, "
                    f"{self.ref(a[0], self.lay.real)})")
        if op in ("ev_scheduled", "ev_time", "ev_prio"):
            fn = {"ev_scheduled": "ev_valid"}.get(op, op)
            return f"{fn}(s, w, {self.ref(a[0], torch.int32)})"
        if op in ("ev_pcount", "ev_pfind"):
            fn = "pattern_count" if op == "ev_pcount" else "pattern_find"
            return (f"{fn}(s, w, {self.ref(a[0], torch.int32)}, "
                    f"{self.ref(a[1], torch.int32)})")
        if op == "callres":  # a kept handle or pid (never a gated call's)
            return f"h{n.aux}"
        fl = cdt is not None and cdt.is_floating_point
        x = [self.ref(v, cdt) if v is not None else None for v in a]
        if op == "where":
            return f"(v{a[0]} ? {x[1]} : {x[2]})"
        if op == "clamp":
            v = x[0]
            if x[1] is not None:
                v = f"({v} < {x[1]} ? {x[1]} : {v})"
            if x[2] is not None:
                v = f"({v} > {x[2]} ? {x[2]} : {v})"
            return f"({x[0]} != {x[0]} ? {x[0]} : {v})" if fl else v
        bin_ = {"add": "+", "sub": "-", "mul": "*", "lt": "<", "le": "<=",
                "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
        if op in bin_:
            if cdt == torch.bool and op in ("add", "sub", "mul"):
                self.fail(f"op {op} on bools")
            return f"({x[0]} {bin_[op]} {x[1]})"
        if op == "div":
            if not fl:
                self.fail("an integer division")
            if isinstance(a[1], tr.Lit):
                # torch's CUDA kernel: a * (1 / b) for a Python number b
                return f"({x[0]} * ({_lit(1, cdt)} / {x[1]}))"
            return f"({x[0]} / {x[1]})"
        if op in ("and", "or", "xor"):
            sym = {"and": "&", "or": "|", "xor": "^"}[op]
            if cdt == torch.bool:
                return f"bool({x[0]} {sym} {x[1]})"
            return f"({x[0]} {sym} {x[1]})"
        if op in ("minimum", "maximum"):
            cmp = "<" if op == "minimum" else ">"
            pick = f"({x[0]} {cmp} {x[1]} ? {x[0]} : {x[1]})"
            if fl:
                return (f"({x[0]} != {x[0]} ? {x[0]} : ({x[1]} != {x[1]} ? "
                        f"{x[1]} : {pick}))")
            return pick
        if op == "not":
            return f"(!{x[0]})" if cdt == torch.bool else f"(~{x[0]})"
        if op == "neg":
            return f"(-{x[0]})"
        if op == "reciprocal":
            return f"({_lit(1, cdt)} / {x[0]})"
        if op == "isnan":
            return f"({x[0]} != {x[0]})" if fl else "false"
        if op == "isfinite":
            return f"finite({x[0]})" if fl else "true"
        if op == "isinf":
            return (f"({x[0]} == {_lit(math.inf, cdt)} || {x[0]} == "
                    f"{_lit(-math.inf, cdt)})") if fl else "false"
        if op in ("sin", "cos") and fl:
            # frame-free, the library's slow path in registers
            # (queue_chunk.cu trig_of)
            return f"trig_of<{str(op == 'sin').lower()}>({x[0]})"
        f32 = cdt == torch.float32
        libm = {"abs": "fabs", "exp": "exp",
                "log": "log", "log1p": "log1p", "sqrt": "sqrt",
                "floor": "floor", "ceil": "ceil", "round": "rint"}
        if op in libm:
            if not fl:
                if op == "abs":
                    return f"({x[0]} < 0 ? -{x[0]} : {x[0]})"
                if op in ("floor", "ceil", "round"):
                    return x[0]
                self.fail(f"op {op} on {cdt}")
            return f"{libm[op]}{'f' if f32 else ''}({x[0]})"
        self.fail(f"op {op} has no CUDA counterpart")

    def dice(self, i) -> List[str]:
        """``dice(a, b)``: ``a`` plus the block's 64-bit word modulo ``b -
        a + 1``, an int64 (samplers.cuh ``dice``)."""
        n = self.nodes[i]
        if len(n.args) != 2:
            self.fail(f"sampler dice with {len(n.args)} parameters")
        args = []
        for a in n.args:
            if isinstance(a, tr.Lit):
                if not isinstance(a.value, int) or isinstance(a.value, bool):
                    self.fail("sampler dice of a non-integer bound")
                args.append(_lit(a.value, torch.int64))
            else:
                if self.nodes[a].dtype not in (torch.int32, torch.int64):
                    self.fail("sampler dice of a non-integer bound")
                args.append(f"int64_t(v{a})")
        lits = [a.value for a in n.args if isinstance(a, tr.Lit)]
        if len(lits) == 2 and not 0 < lits[1] - lits[0] + 1 < 2**47:
            self.fail(f"sampler dice({lits[0]}, {lits[1]}): the faces' "
                      "count must be in (0, 2**47)")
        if n.dtype != torch.int64:
            self.fail(f"sampler dice gives {n.dtype}, the device one int64")
        b0, b1 = f"b{i}_0", f"b{i}_1"
        return [f"uint32_t {b0}, {b1};", f"draw_bits(s, {b0}, {b1});",
                f"const int64_t v{i} = dice({b0}, {b1}, {args[0]}, "
                f"{args[1]});"]

    def draw(self, i) -> List[str]:
        n = self.nodes[i]
        name, _ = n.aux
        if name == DICE:
            return self.dice(i)
        fn = SAMPLERS.get(name)
        if fn is None:
            self.fail(f"sampler {name} has no device counterpart "
                      "(csrc/samplers.cuh)")
        dev, arity = fn
        if len(n.args) != arity:
            self.fail(f"sampler {name} with {len(n.args)} parameters")
        lits = [isinstance(a, tr.Lit) for a in n.args]
        real = self.lay.real
        if all(lits):
            args = [f"Lit{{{float(a.value).hex()}}}" for a in n.args]
            want = real
        else:
            dts = {self.nodes[a].dtype for a in n.args
                   if not isinstance(a, tr.Lit)}
            if any(lits) or len(dts) != 1 or not next(iter(dts)) \
                    .is_floating_point:
                self.fail(f"sampler {name}'s parameters: all Python numbers "
                          "or all tensors of one float dtype")
            pdt = next(iter(dts))
            args = [f"v{a}" for a in n.args]
            want = torch.promote_types(pdt, real)
        if n.dtype != want:
            self.fail(f"sampler {name} gives {n.dtype}, the device sampler "
                      f"{want}")
        ct = _ctype(n.dtype, self.what)
        if dev in LOOPING:  # draws through the lane's state
            return [f"const {ct} v{i} = {dev}<R>(Draws<S>{{s}}, "
                    f"{', '.join(args)});"]
        b0, b1 = f"b{i}_0", f"b{i}_1"
        return [f"uint32_t {b0}, {b1};", f"draw_bits(s, {b0}, {b1});",
                f"const {_ctype(n.dtype, self.what)} v{i} = "
                f"{dev}<R>({', '.join([b0, b1] + args)});"]

    def emit_upto(self, end):
        for i in range(self.done, end):
            if not self.live[i]:
                continue
            n = self.nodes[i]
            if n.op == "draw":
                self.lines += self.draw(i)
            else:
                self.lines.append(f"const {_ctype(n.dtype, self.what)} v{i} "
                                  f"= {self.expr(i)};")
        self.done = max(self.done, end)

    def store(self, name, i, nid):
        x = self.lay.leaf[name]
        t = _ctype(x.dtype, self.what)
        self.lines.append(f"{self.access(name, i, write=True)} = "
                          f"static_cast<{t}>(v{nid});")


def _block_fn(lay: _Layout, ir: tr.BlockIR, spec: ModelSpec) -> List[str]:
    what = (f"handler {ir.name!r} (kind {ir.pc + 2})" if not ir.cmd
            else f"block {ir.name!r} (pc {ir.pc})")
    f = _Fn(lay, ir.nodes, f"{what} of spec {spec.name!r}")
    roots = list(ir.cmd)
    for e in ir.effects:
        if e[0] == "draw":
            roots.append(e[1])
        elif e[0] == "write":
            roots.append(e[3])
        else:
            roots += [a for a in e[2] if isinstance(a, int)]
            if len(e) > 4:
                roots.append(e[4][0])
    f.mark(roots)
    handles = {n.aux for i, n in enumerate(ir.nodes)
               if n.op == "callres" and f.live[i]}
    pending = []
    k = 0
    for e in ir.effects:
        if e[0] == "write":
            pending.append(e)
        elif e[0] == "call":
            f.emit_upto(e[3])
            for w in pending:
                f.store(w[1], w[2], w[3])
            pending = []
            body = _call(f, e, spec, k in handles, k)
            if len(e) > 4:
                pred, neg = e[4]
                f.lines.append(f"if ({'!' if neg else ''}v{pred}) {{")
                f.lines += ["  " + ln for ln in body]
                f.lines.append("}")
            else:
                f.lines += body
            k += 1
    f.emit_upto(len(ir.nodes))
    for w in pending:
        f.store(w[1], w[2], w[3])
    if not ir.cmd:  # a handler
        return f.lines
    tag, f1, f2, f3, i, npc = ir.cmd
    real = lay.real
    f.lines.append(
        f"return Cmd<R>{{{f.ref(tag, torch.int32)}, {f.ref(f1, real)}, "
        f"{f.ref(f3, real)}, {f.ref(npc, torch.int32)}, "
        f"{f.ref(i, torch.int32)}, {f.ref(f2, real)}}};")
    return f.lines


def _pid(f: _Fn, p) -> str:
    return str(int(p.value)) if isinstance(p, tr.Lit) else f.ref(p, None)


def _result(call: str, kind: str, handle: bool, k: int) -> List[str]:
    """An engine call's line: its result ``h<k>`` kept where a live node
    reads it."""
    if not handle:
        return [f"{call};"]
    ct = _CTYPE[tr._RESULTS[kind]]
    return [f"const {ct} h{k} = {call};"]


def _queue_id(f: _Fn, q, refs, what) -> int:
    if not isinstance(q, tr.Lit):
        f.fail(f"api.{what} of a traced queue id")
    if not 0 <= int(q.value) < len(refs):
        f.fail(f"api.{what} of queue {q.value}")
    return int(q.value)


def _call(f: _Fn, e, spec: ModelSpec, handle=False, k=0) -> List[str]:
    kind, args = e[1], e[2]
    if kind == "pool_release":
        k_, p, amount = args
        if not isinstance(k_, tr.Lit):
            f.fail("api.pool_release of a traced pool id")
        if not 0 <= int(k_.value) < len(spec.pools):
            f.fail(f"api.pool_release of pool {k_.value}")
        return [f"release_pool<{int(k_.value)}>(s, w, int({_pid(f, p)}), "
                f"{f.ref(amount, f.lay.real)});"]
    if kind == "release":
        r, p = args
        if not isinstance(r, tr.Lit):
            f.fail("api.release of a traced resource id")
        if not 0 <= int(r.value) < len(spec.resources):
            f.fail(f"api.release of resource {r.value}")
        return [f"release_resource<{int(r.value)}>(s, w, "
                f"int({_pid(f, p)}));"]
    if kind == "stop_process":
        (target,) = args
        if isinstance(target, tr.Lit):
            t = int(target.value)
            # a pid out of range is no process: nothing to stop
            return [f"stop_at<{t}>(s, w);"] if 0 <= t < spec.n_procs else []
        return [f"stop_process(s, w, int({_pid(f, target)}));"]
    if kind == "schedule":
        t, prio, kind_, subj, arg = args
        call = (f"schedule_event(s, w, {f.ref(t, f.lay.real)}, "
                f"{f.ref(prio, torch.int32)}, {f.ref(kind_, torch.int32)}, "
                f"{f.ref(subj, torch.int32)}, {f.ref(arg, torch.int32)})")
        return [f"const int32_t h{k} = {call};" if handle else f"{call};"]
    if kind == "cond_signal":
        (c,) = args
        if not 0 <= int(c.value) < len(spec.conditions):
            f.fail(f"api.cond_signal of condition {c.value}")
        return [f"cond_signal<{int(c.value)}>(s, w);"]
    if kind == "interrupt":
        target, sig = args
        return [f"interrupt(s, w, int({_pid(f, target)}), "
                f"{f.ref(sig, torch.int32)});"]
    if kind == "timer_add":
        p, dur, sig = args
        call = (f"timer_add(s, w, int({_pid(f, p)}), "
                f"{f.ref(dur, f.lay.real)}, {f.ref(sig, torch.int32)})")
        return [f"const int32_t h{k} = {call};" if handle else f"{call};"]
    if kind == "timers_clear":
        (p,) = args
        return [f"timers_clear(s, w, int({_pid(f, p)}));"]
    if kind == "spawn":
        first, count, entry, prio, at, prio_ = args
        types = [pt.first_pid for pt in spec.spawn_types]
        if int(first.value) not in types:
            f.fail(f"api.spawn of a process type at pid {first.value} that "
                   "is no spawn pool of the spec")
        t = types.index(int(first.value))
        at_ = ("s.clock" if isinstance(at, tr.Lit) and at.value is None
               else f.ref(at, f.lay.real))
        pr_ = (_lit(int(prio.value), torch.int32)
               if isinstance(prio_, tr.Lit) and prio_.value is None
               else f.ref(prio_, torch.int32))
        call = f"spawn_pool<{t}>(s, w, {at_}, {pr_})"
        return [f"const int32_t h{k} = {call};" if handle else f"{call};"]
    real, i32 = f.lay.real, torch.int32
    if kind == "event_cancel":
        h, eager = args
        call = (f"event_cancel<{str(bool(eager.value)).lower()}>(s, w, "
                f"{f.ref(h, i32)})")
    elif kind == "event_reschedule":
        h, t = args
        call = f"event_reschedule(s, w, {f.ref(h, i32)}, {f.ref(t, real)})"
    elif kind == "event_reprioritize":
        h, prio = args
        call = (f"event_reprioritize(s, w, {f.ref(h, i32)}, "
                f"{f.ref(prio, i32)})")
    elif kind == "event_pattern_cancel":
        kind_, subj = args
        call = (f"pattern_cancel(s, w, {f.ref(kind_, i32)}, "
                f"{f.ref(subj, i32)})")
    elif kind == "priority_set":
        p, prio = args
        call = f"priority_set(s, w, int({_pid(f, p)}), {f.ref(prio, i32)})"
    elif kind == "pqueue_cancel":
        q, item = args
        qid = _queue_id(f, q, spec.pqueues, "pqueue_cancel")
        call = f"pq_cancel<{qid}>(s, w, {f.ref(item, real)})"
    elif kind == "pqueue_reprioritize":
        q, item, prio = args
        qid = _queue_id(f, q, spec.pqueues, "pqueue_reprioritize")
        call = (f"pq_reprioritize<{qid}>(s, w, {f.ref(item, real)}, "
                f"{f.ref(prio, real)})")
    else:
        f.fail(f"engine call {kind}")
    return _result(call, kind, handle, k)


def _pred_fn(lay: _Layout, ir: tr.PredIR, spec: ModelSpec) -> List[str]:
    f = _Fn(lay, ir.nodes, f"predicate of condition {ir.name!r} of spec "
                           f"{spec.name!r}")
    f.mark([ir.out])
    f.emit_upto(len(ir.nodes))
    f.lines.append(f"return {f.ref(ir.out, torch.bool)};")
    return f.lines


def command_tags(ir: tr.BlockIR):
    """The command tags a block may return: the constants its tag field
    selects among (through ``where`` nodes), or None where a tag is
    computed otherwise."""
    out, stack, seen = set(), [ir.cmd[0]], set()
    while stack:
        i = stack.pop()
        if isinstance(i, tr.Lit):
            out.add(int(i.value))
            continue
        if i in seen:
            continue
        seen.add(i)
        n = ir.nodes[i]
        if n.op == "const":
            out.add(int(n.aux))
        elif n.op in ("where", "cast"):
            stack += list(n.args[1:] if n.op == "where" else n.args)
        else:
            return None
    return out


def _ternary(name, values, default=0, fmt=str) -> str:
    """A constexpr function of a component id: nested selects."""
    out = fmt(default)
    for j in reversed(range(len(values))):
        out = f"({name} == {j} ? {fmt(values[j])} : {out})"
    return out


def smem_plan(spec: ModelSpec, lay: _Layout, n_acc: int,
              toolkit: bool, waits: bool = False, masks: int = 0) -> dict:
    """The shared columns a lane takes (``per_lane`` bytes, as the
    kernel's Cold, ColdAcc, ColdQ, ColdShop, ColdSig, UCold, ColdWake,
    ColdG and, where the family waits past the register limit, ColdAwait
    lay them out, and the ``masks`` words of the live-slot masks'
    ColdMask), the block's lanes (``threads``: 64 where 64 lanes fit in
    the static 48 KB, else 32) and whether the
    columns take dynamic shared memory (``dyn``: past the static 48 KB,
    or past the register limits, whose columns only the dynamic layout
    has); a spec whose block exceeds the card's 227 KB is refused.
    ``columns`` gives each struct's bytes a lane."""
    np_, real = spec.n_procs, lay.real
    rb = torch.finfo(real).bits // 8
    nka = max(len(spec.pools), 1)
    nf, ni = max(spec.n_flocals, 1), max(spec.n_ilocals, 1)
    big, gbig = np_ > REG_NP, spec.n_guards > REG_NG
    columns = {
        # the summary, pend_f, pend_f3, got; pend_pc, pend_seq, prio,
        # produced
        "Cold": rb * (8 + 3 * np_) + 16 * np_,
        "ColdAcc": (10 * rb + 1) * n_acc,
        "ColdQ": 4 * np_,
        "ColdSig": 4 * (np_ + max(len(spec.pqueues), 1)),
        "ColdShop": ((rb * (nka * np_ + np_) + 4 * nka * np_) if toolkit
                     else 0),
        "UCold": (rb * np_ * nf + 4 * np_ * ni
                  + sum(lay.leaf[n].element_size() for n in lay.user)),
        "ColdWake": (rb + 8) * np_ if big else 0,
        "ColdAwait": 8 * np_ if big and waits else 0,
        "ColdG": 4 * spec.n_guards if gbig else 0,
        "ColdMask": 4 * masks,
    }
    per_lane = sum(columns.values())
    threads = 64 if per_lane * 64 <= SMEM - 1024 else 32
    dyn = big or gbig or per_lane * threads > SMEM - 1024
    if per_lane * threads > SMEM_DYN - 1024:
        raise NotImplementedError(
            f"spec {spec.name!r}: {per_lane} B of shared state a lane, more "
            f"than a block of {threads} lanes can hold")
    return dict(per_lane=per_lane, threads=threads, dyn=dyn,
                columns=columns)


#: the general table's and a priority queue's widest mask (wider tables
#: keep the linear scans)
MASK_MAX = 128


#: the resident warps an SM a generated instance asks for (the register
#: cap 65536 / (32 x warps)): 16 for a small family (at most SMALL_NP
#: processes and no pool, buffer, resource, priority queue or
#: condition), 8 for the others
WARPS_SMALL, WARPS, SMALL_NP = 16, 8, 3


def launch_plan(spec: ModelSpec, plan: dict) -> dict:
    """The generated instance's launch shape: the block's lanes
    (``threads``, :func:`smem_plan`'s) and the register cap (``minb``,
    the blocks an SM that ``__launch_bounds__`` asks for).  The rule the
    measurements justify (PERF.md): a small family fits 128 registers
    without a spill and runs faster at 16 warps an SM than at 8 where
    it needs more (waitev and the generated mm1 in f64: 0.83x and 0.82x
    of their 8-warp K=512 chunks; one under 128 registers builds the
    same either way); a larger one lost up to 20 % at 12 or 16 warps
    (harbor f32) or gained nothing, held at 6-8 warps by its shared
    columns (park3, spawnshop), so it keeps 8 warps and 255
    registers."""
    threads = plan["threads"]
    small = (spec.n_procs <= SMALL_NP and not (
        spec.pools or spec.buffers or spec.resources or spec.pqueues
        or spec.conditions))
    warps = WARPS_SMALL if small else WARPS
    return dict(threads=threads, minb=warps * 32 // threads)


def emit(spec: ModelSpec, sims) -> str:
    """The generated family's header for ``spec`` in the profile (and
    with the shapes) of ``sims``."""
    check_spec(spec)
    lay = _Layout(spec, sims)
    real = lay.real
    R = _ctype(real, "the Sim's clock")
    bpcs = sorted(set(spec.boundary_pcs))
    # the boundary blocks run on the host (their stubs below)
    blocks = [tr.trace_block(spec, pc, sims) for pc in
              range(len(spec.blocks)) if pc not in bpcs]
    handlers = [tr.trace_handler(spec, k, sims) for k in
                range(len(spec.user_handlers))]
    preds = [tr.trace_predicate(spec, c.id, sims) for c in spec.conditions]
    np_, nq = spec.n_procs, len(spec.queues)
    nk, nv, nc = len(spec.pools), len(spec.buffers), len(spec.conditions)
    npq, nr, nh = len(spec.pqueues), len(spec.resources), len(handlers)
    # the pool preempt's rule, where a block may issue one
    tags = [command_tags(ir) for ir in blocks]
    mug = nk > 0 and any(t is None or t & {16, 23} for t in tags)
    # the waits' rules, where a block may return the wait
    waitp, waite = (any(t is None or tag in t for t in tags)
                    for tag in (pr.C_WAIT_PROC, pr.C_WAIT_EVT))
    nf, ni = max(spec.n_flocals, 1), max(spec.n_ilocals, 1)
    q_acc = lay.at("queues.acc.summary.n")
    p_acc = lay.at("pools.acc.summary.n")
    b_acc = lay.at("buffers.acc.summary.n")
    pq_acc = lay.at("pqueues.acc.summary.n")
    r_acc = lay.at("resources.acc.summary.n")
    n_qa = nq if q_acc >= 0 else 0
    n_pa = nk if p_acc >= 0 else 0
    n_ba = nv if b_acc >= 0 else 0
    n_pqa = npq if pq_acc >= 0 else 0
    n_ra = nr if r_acc >= 0 else 0
    big, gbig = np_ > REG_NP, spec.n_guards > REG_NG
    # a pended priority-queue put keeps its item's priority in pend_f2,
    # the toolkit's column; the resources' verbs are the toolkit's; past
    # REG_NP processes pend_f2 is a column in any family (no dirty mask)
    toolkit = nk + nv + nc + npq + nr > 0 or big
    u0 = lay.pos[lay.user[0]] if lay.user else lay.pos["done"]
    # the live-slot masks, shared columns: the general table's where a
    # block or handler inserts into it (a table nothing fills is scanned
    # once a chunk, and the mask cost such a cell up to 4 %, PERF.md) and
    # it has at most MASK_MAX slots, the priority queues' where they are
    # that narrow
    ecap, pqw = spec.event_cap, spec.pqueue_cap_max
    inserts = any(e[0] == "call" and e[1] in ("timer_add", "schedule")
                  for ir in blocks + handlers for e in ir.effects)
    emask = inserts and 0 < ecap <= MASK_MAX
    pmask = npq > 0 and pqw <= MASK_MAX
    mask_words = ((ecap + 31) // 32 if emask else 0) + (
        npq * ((pqw + 31) // 32) if pmask else 0)
    plan = smem_plan(spec, lay, n_qa + n_pa + n_ba + n_pqa + n_ra, toolkit,
                     waitp or waite, mask_words)
    choice = launch_plan(spec, plan)
    threads, dyn = plan["threads"], plan["dyn"]

    def cx(expr_, args="int i", ret="int"):
        return f"__host__ __device__ static constexpr {ret} {expr_}"

    observes = " || ".join(
        f"(c == {c.id} && ({' || '.join(f'g == {g}' for g in c.observes)}))"
        for c in spec.conditions if c.observes) or "false"
    out = [
        f"// {'f32' if real == torch.float32 else 'f64'} profile of spec "
        f"{spec.name!r}: {np_} processes, {len(spec.blocks)} blocks, "
        f"{nh} handlers, {nq} queues, {nr} resources, {nk} pools, {nv} "
        f"buffers, {npq} priority queues, {nc} conditions",
        f"template <>",
        f"struct Gen<{R}> : Family {{",
        f"  static constexpr bool GEN = true, RECORD = false, SHOP = false;",
        f"  static constexpr bool TOOLKIT = {str(toolkit).lower()}, "
        f"PEND_I = true, PRED_BY_PID = true;",
        f"  static constexpr bool ABORT = {str(nk + nv > 0).lower()}, "
        f"WSIG = true, MUG = {str(mug).lower()};",
        f"  static constexpr bool WAITP = {str(waitp).lower()}, WAITE = "
        f"{str(waite).lower()};",
        f"  // shared columns a lane, B: "
        + ", ".join(f"{k} {v}" for k, v in plan["columns"].items() if v),
        f"  // {plan['per_lane']} B of shared columns a lane, "
        f"{'dynamic' if dyn else 'static'} shared memory"
        + (f"; wakes and words in shared columns ({np_} > {REG_NP} "
           "processes)" if big else ""),
        f"  static constexpr bool DYN = {str(dyn).lower()}, BIG = "
        f"{str(big).lower()}, GBIG = {str(gbig).lower()};",
        f"  static constexpr int NR = {nr}, NH = {nh}, L_R_HOLDER = "
        f"{lay.at('resources.holder')}, L_RACC = {r_acc};",
        f"  static constexpr int NPQ = {npq}, PQW = {pqw}, ECAP = {ecap};",
        f"  // live-slot masks of the general table and the priority "
        f"queues (shared columns)",
        f"  static constexpr bool EMASK = {str(emask).lower()}, PMASK = "
        f"{str(pmask).lower()};",
        f"  static constexpr int NP = {np_}, NQ = {nq}, NG = "
        f"{spec.n_guards}, NK = {nk}, NV = {nv}, NC = {nc};",
        f"  static constexpr int NF = {nf}, NI = {ni}, NSUM = 1, NPAR = 1, "
        f"N_BLOCKS = {len(spec.blocks)};",
        f"  static constexpr int THREADS = {threads}, NACC = "
        f"{n_qa + n_pa + n_ba + n_pqa + n_ra}, U0 = {u0}, N_USER = "
        f"{len(lay.user)};",
        f"  static constexpr int L_QACC = {q_acc}, L_PACC = {p_acc}, "
        f"L_BACC = {b_acc}, L_PQACC = {pq_acc};",
        f"  static constexpr int L_PQ_ITEMS = {lay.at('pqueues.items')}, "
        f"L_PQ_PRIO = {lay.at('pqueues.prio')}, L_PQ_SEQ = "
        f"{lay.at('pqueues.seq')}, L_PQ_LIVE = {lay.at('pqueues.live')}, "
        f"L_PQ_NEXT_SEQ = {lay.at('pqueues.next_seq')};",
        f"  static constexpr int L_P_LEVEL = {lay.at('pools.level')}, "
        f"L_P_HELD = {lay.at('pools.held')}, L_P_HELD_SEQ = "
        f"{lay.at('pools.held_seq')}, L_P_NEXT_SEQ = "
        f"{lay.at('pools.next_seq')}, L_B_LEVEL = "
        f"{lay.at('buffers.level')};",
        f"  static constexpr int LN_MU = 0, LN_SIGMA = 0;",
        f"  // {threads} lanes a block, at most "
        f"{min(255, 65536 // (threads * choice['minb']))} registers a thread "
        f"(launch_plan); a frame or a spill fails the build's check",
        f"  template <typename RR>",
        f"  __host__ __device__ static constexpr int minb() {{ return "
        f"{choice['minb']}; }}",
        "  " + cx(f"q_cap(int i) {{ return "
                  f"{_ternary('i', [q.capacity for q in spec.queues], 1)}; }}"),
        "  " + cx(f"q_front(int i) {{ return "
                  f"{_ternary('i', [q.front_guard for q in spec.queues])}; }}"),
        "  " + cx(f"q_rear(int i) {{ return "
                  f"{_ternary('i', [q.rear_guard for q in spec.queues])}; }}"),
        "  " + cx(f"q_rec(int i) {{ return "
                  f"{_ternary('i', [q.record and q_acc >= 0 for q in spec.queues], False, lambda v: str(bool(v)).lower())}; }}",
                  ret="bool"),
        "  " + cx("acc_q(int i) { return i; }"),
        "  " + cx(f"acc_pool(int i) {{ return {n_qa} + i; }}"),
        "  " + cx(f"acc_buf(int i) {{ return {n_qa + n_pa} + i; }}"),
        "  " + cx(f"acc_pq(int i) {{ return {n_qa + n_pa + n_ba} + i; }}"),
        "  " + cx(f"acc_res(int i) {{ return {n_qa + n_pa + n_ba + n_pqa} "
                  "+ i; }"),
        "  " + cx(f"g_res(int i) {{ return "
                  f"{_ternary('i', [r.guard for r in spec.resources])}; }}"),
        "  " + cx(f"res_rec(int i) {{ return "
                  f"{_ternary('i', [r.record and r_acc >= 0 for r in spec.resources], False, lambda v: str(bool(v)).lower())}; }}",
                  ret="bool"),
        "  " + cx(f"pq_cap(int i) {{ return "
                  f"{_ternary('i', [q.capacity for q in spec.pqueues], 1)}; }}"),
        "  " + cx(f"pq_front(int i) {{ return "
                  f"{_ternary('i', [q.front_guard for q in spec.pqueues])}; }}"),
        "  " + cx(f"pq_rear(int i) {{ return "
                  f"{_ternary('i', [q.rear_guard for q in spec.pqueues])}; }}"),
        "  " + cx(f"pq_rec(int i) {{ return "
                  f"{_ternary('i', [q.record and pq_acc >= 0 for q in spec.pqueues], False, lambda v: str(bool(v)).lower())}; }}",
                  ret="bool"),
        "  " + cx(f"pool_rec(int i) {{ return "
                  f"{_ternary('i', [pl.record and p_acc >= 0 for pl in spec.pools], False, lambda v: str(bool(v)).lower())}; }}",
                  ret="bool"),
        "  " + cx(f"buf_rec(int i) {{ return "
                  f"{_ternary('i', [b.record and b_acc >= 0 for b in spec.buffers], False, lambda v: str(bool(v)).lower())}; }}",
                  ret="bool"),
        "  " + cx(f"g_pool(int i) {{ return "
                  f"{_ternary('i', [pl.guard for pl in spec.pools])}; }}"),
        "  " + cx(f"g_front(int i) {{ return "
                  f"{_ternary('i', [b.front_guard for b in spec.buffers])}; }}"),
        "  " + cx(f"g_rear(int i) {{ return "
                  f"{_ternary('i', [b.rear_guard for b in spec.buffers])}; }}"),
        "  " + cx(f"g_cond(int i) {{ return "
                  f"{_ternary('i', [c.guard for c in spec.conditions])}; }}"),
        "  " + cx(f"observes(int c, int g) {{ return {observes}; }}",
                  ret="bool"),
        f"  // boundary blocks (pcs {bpcs or 'none'}): the host's round "
        "runs them",
        f"  static constexpr bool BOUNDARY = {str(bool(bpcs)).lower()};",
        "  " + cx("boundary(int pc) { return "
                  + (" || ".join(f"pc == {b}" for b in bpcs) or "false")
                  + "; }", ret="bool"),
        f"  // spawn pools: "
        + (", ".join(f"type {t} {pt.name!r} pids [{pt.first_pid}, "
                     f"{pt.first_pid + pt.count})"
                     for t, pt in enumerate(spec.spawn_types)) or "none"),
        f"  static constexpr int N_SPAWN = {len(spec.spawn_types)};",
        "  " + cx(f"spawn_first(int i) {{ return "
                  f"{_ternary('i', [pt.first_pid for pt in spec.spawn_types])}"
                  "; }"),
        "  " + cx(f"spawn_count(int i) {{ return "
                  f"{_ternary('i', [pt.count for pt in spec.spawn_types])}"
                  "; }"),
        "  " + cx(f"spawn_entry(int i) {{ return "
                  f"{_ternary('i', [pt.entry_pc for pt in spec.spawn_types])}"
                  "; }"),
        "  template <typename RR>",
        "  __device__ static RR pool_cap(const Where&, int i) {",
        f"    return RR({_ternary('i', [float(pl.capacity).hex() for pl in spec.pools], '0.0')});",
        "  }",
        "  template <typename RR>",
        "  __device__ static RR buf_cap(const Where&, int i) {",
        f"    return RR({_ternary('i', [float(b.capacity).hex() for b in spec.buffers], '0.0')});",
        "  }",
        "  struct UCold {",
        f"    {R} lf[{np_ * nf}][{threads}];",
        f"    int32_t li[{np_ * ni}][{threads}];",
    ]
    for j, n in enumerate(lay.user):
        out.append(f"    {_CTYPE[lay.leaf[n].dtype]} u{j}[1][{threads}];"
                   f"  // {n}")
    out += ["  };", "  template <bool LOAD, class S>",
            "  __device__ static void xfer_user(S& s, const Where& w) {"]
    for j, n in enumerate(lay.user):
        t = _CTYPE[lay.leaf[n].dtype]
        out.append(f"    xfer<LOAD>(row<{t}, S>(w, {lay.pos[n]}, 1), "
                   f"UCOL(s, u{j}, 0));")
    out.append("  }")
    for ir in preds:
        out += [f"  // condition {ir.cid} {ir.name!r}",
                "  template <class S>",
                f"  __device__ __forceinline__ static bool pred{ir.cid}("
                "S& s, const Where& w, int p) {",
                "    using R = typename S::R;"]
        out += ["    " + ln for ln in _pred_fn(lay, ir, spec)]
        out.append("  }")
    out += ["  template <int C, class S>",
            "  __device__ __forceinline__ static bool cond_holds(S& s, "
            "const Where& w, int p) {"]
    for ir in preds:
        out.append(f"    if constexpr (C == {ir.cid}) return pred{ir.cid}"
                   "(s, w, p);")
    out += ["    return false;", "  }"]
    for ir in blocks:
        out += [f"  // block {ir.pc} {ir.name!r}",
                "  template <class S>",
                f"  __device__ __forceinline__ static Cmd<typename S::R> "
                f"blk{ir.pc}(S& s, const Where& w, int p, int32_t sig) {{",
                "    using R = typename S::R;"]
        out += ["    " + ln for ln in _block_fn(lay, ir, spec)]
        out.append("  }")
    for ir in handlers:
        out += [f"  // handler {ir.pc} {ir.name!r} (event kind {ir.pc + 2}): "
                "p is the event's subject, sig its argument",
                "  template <class S>",
                f"  __device__ __forceinline__ static void hdl{ir.pc}(S& s, "
                "const Where& w, int p, int32_t sig) {",
                "    using R = typename S::R;"]
        out += ["    " + ln for ln in _block_fn(lay, ir, spec)]
        out.append("  }")
    out += ["  template <int K, class S>",
            "  __device__ __forceinline__ static void handler(S& s, const "
            "Where& w, int p, int32_t sig) {"]
    for ir in handlers:
        out.append(f"    if constexpr (K == {ir.pc}) hdl{ir.pc}(s, w, p, sig);")
    out.append("  }")
    for pc in bpcs:
        out += [f"  // block {pc} {getattr(spec.blocks[pc], '__name__', pc)!r}"
                ": a boundary block, run by the host's round; the kernel "
                "reaches",
                "  // its stub only mid-chain, where the lane has failed "
                "(ERR_BOUNDARY)",
                "  template <class S>",
                f"  __device__ __forceinline__ static Cmd<typename S::R> "
                f"blk{pc}(S& s, const Where& w, int p, int32_t sig) {{",
                "    using R = typename S::R;",
                "    return Cmd<R>{C_EXIT, R(0), R(0), 0, 0};", "  }"]
    out += ["  template <class S>",
            "  __device__ static Cmd<typename S::R> block(S& s, const Where& "
            "w, int p, int b, int32_t sig) {",
            "    switch (b) {"]
    pcs = range(len(spec.blocks))
    for pc in pcs[:-1]:
        out.append(f"      case {pc}: return blk{pc}(s, w, p, sig);")
    out += [f"      default: return blk{pcs[-1]}(s, w, p, sig);",
            "    }", "  }", "};"]
    prof = "F32" if real == torch.float32 else "F64"
    head = [
        f"// Generated by cimba_tpu_torch/core/emit.py from spec "
        f"{spec.name!r}: a model family of the chunk kernel",
        "// (csrc/queue_chunk.cu includes it with -DCIMBA_GEN_HEADER).  "
        "A resume's chain is bounded",
        "// at MAX_CHAIN = 1024 commands, the plain engine's rule "
        "(make_run), not the reference",
        "// kernel mode's spec.max_chain.",
        f"#define CIMBA_GEN_{prof} 1",
        "template <typename R>",
        "struct Gen;",
    ]
    return "\n".join(head + out) + "\n"


def header_hash(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def op_counts(spec: ModelSpec, sims, weights=None) -> Dict[object, int]:
    """Live float and integer ops of each block's IR (pc -> count) and of
    each user handler's (``("h", k)`` -> count; a boundary block, which
    the host's round runs, has none): the least the generated kernel
    computes a dispatch of that block or handler, for the bound
    (draws counted by their samplers elsewhere).  An op counts
    ``weights.get(op, 1)`` (a library function's operations), a division
    by a Python number one multiply.  A write by a traced pid counts as
    one store, not the candidate positions' tests and selects it is
    emitted as (``BlockIR.puts``); a read by one (``pick``) as one
    load."""
    weights = weights or {}
    counts = {}
    lay = _Layout(spec, sims)
    # a boundary block runs on the host, never in the kernel
    irs = [(pc, tr.trace_block(spec, pc, sims))
           for pc in range(len(spec.blocks)) if pc not in spec.boundary_pcs]
    irs += [(("h", k), tr.trace_handler(spec, k, sims))
            for k in range(len(spec.user_handlers))]
    for pc, ir in irs:
        f = _Fn(lay, ir.nodes, "")
        roots = list(ir.cmd) + [e[1] if e[0] == "draw" else e[3]
                                for e in ir.effects if e[0] != "call"]
        f.mark(roots)
        live = {i for i, n in enumerate(ir.nodes) if f.live[i]
                and n.op not in ("leaf", "const", "pid", "sig", "draw")}
        put = {w for g in ir.puts for w in g} & live
        # a put's position tests: eq nodes no live node but its selects
        # reads
        users: Dict[int, set] = {}
        for i in live:
            for a in ir.nodes[i].args:
                if isinstance(a, int):
                    users.setdefault(a, set()).add(i)
        tests = {i for i in live if ir.nodes[i].op == "eq" and users.get(i)
                 and users[i] <= put}
        n = sum(1 for g in ir.puts if any(f.live[w] for w in g))
        for i in live - put - tests:
            node = ir.nodes[i]
            lit = node.op == "div" and isinstance(node.args[1], tr.Lit)
            n += 1 if lit else weights.get(node.op, 1)
        counts[pc] = n
    return counts
