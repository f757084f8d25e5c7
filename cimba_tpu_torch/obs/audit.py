"""Determinism audit and provenance (torch port of
:mod:`cimba_tpu.obs.audit`).

* **Chunk-boundary digests.**  With auditing on, every chunk is followed
  by :func:`sim_digest` of the lane state on its device: each leaf
  bitcast to its carry class's unsigned payload (the reference's classes
  f32, i32, f64 and i64; bool leaves skipped), each element mixed with
  its (lane, offset, leaf) position through fmix64, and the mixes summed
  mod 2**64 a class — an exact integer sum, independent of the order of
  the reduction.  The same leaves in the same order give the reference's
  digest bit for bit, so equal digests mean equal states.  The host
  appends one row a chunk: the **digest trail**.
* **Run cards.**  A content-addressed JSON record of a run: the spec's
  fingerprint, the seed schedule, the environment (package, torch and
  CUDA versions, the card's name and power limit), the wave and chunk
  geometry, the trail and the result digest.  The card's digest leaves
  out the creation time, so two clean runs of one seed give one digest.
* **Divergence localization.**  :func:`diff_cards` and
  :func:`diff_trails` name the first (wave, chunk, class) where two
  trails part; ``cimba_tpu_torch.tools.audit_diff`` wraps them.

The port holds Threefry words as int64 values in ``[0, 2**32)`` where
the reference holds ``uint32``; they digest in the i32 class from their
low 32 bits, as the reference's words do.

torch has no unsigned 64-bit arithmetic: the mixes run on int64 bit
patterns with wrapping multiplies and logical shifts written as an
arithmetic shift and a mask (``random.bits.fmix64``), and a class sum is
taken over the 32-bit halves of its mixes, each exact in int64, then
recombined mod 2**64.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
import types
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "AUDIT_ENV", "CARD_FORMAT", "CLASS_NAMES",
    "Audit", "resolve", "sim_digest", "combine_digests", "format_digests",
    "result_digest", "stream_result_digest",
    "run_card", "card_digest", "write_run_card", "load_run_card",
    "diff_trails", "diff_cards", "environment",
]

#: environment knob: unset/"0" = off, "1" = collect in memory, any
#: other value = a directory run cards are written into
AUDIT_ENV = "CIMBA_AUDIT"

#: run-card schema version
CARD_FORMAT = 1

#: the carry classes digested, in the reference's order
CLASS_NAMES = ("f32", "i32", "f64", "i64")

_CLASS_BITS = {"f32": 32, "i32": 32, "f64": 64, "i64": 64}

_U64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF

#: splitmix64 golden gamma — the per-leaf salt stride
_GAMMA = 0x9E3779B97F4A7C15


def _fmix64_host(x: int) -> int:
    """murmur3 fmix64 on a Python int (the per-leaf salts)."""
    x &= _U64
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & _U64
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & _U64
    x ^= x >> 33
    return x


def _i64(v: int) -> int:
    """A u64 as the int64 with the same bits."""
    v &= _U64
    return v - (1 << 64) if v >= 1 << 63 else v


# ---------------------------------------------------------------------------
# device-side digest
# ---------------------------------------------------------------------------


#: the payload groups, in the order their elements are concatenated:
#: (class, how a leaf of the group becomes its class's int64 payload)
_GROUPS = (("f32", "f32"), ("i32", "i32"), ("i32", "word"), ("f64", "f64"),
           ("i64", "i64"))


def _layout(sims) -> tuple:
    """``(leaves by group, layout key)``: each digested leaf with its
    ordinal in ``tree.leaves`` order, in the group of its dtype; a
    Threefry word (int64 here, ``uint32`` in the reference) is in the
    i32 class.  Bool leaves are derived state and are skipped."""
    import torch

    from cimba_tpu_torch import tree

    words = ({id(x) for x in tree.leaves(sims.rng)}
             if getattr(sims, "rng", None) is not None else set())
    kinds = {torch.float32: "f32", torch.int32: "i32", torch.float64: "f64",
             torch.int64: "i64"}
    groups = {g: [] for _, g in _GROUPS}
    for ordinal, leaf in enumerate(tree.leaves(sims)):
        g = "word" if id(leaf) in words else kinds.get(leaf.dtype)
        if g is not None:
            groups[g].append((ordinal, leaf))
    key = tuple((g, tuple((o, tuple(x.shape)) for o, x in groups[g]))
                for _, g in _GROUPS)
    return groups, key


def _payload(group: str, flat):
    """A group's concatenated leaves as their class's payload, int64 bit
    patterns: a 32-bit class's word in ``[0, 2**32)``."""
    import torch

    if group == "f32":
        return flat.view(torch.int32).to(torch.int64) & _M32
    if group in ("i32", "word"):
        return flat.to(torch.int64) & _M32
    if group == "f64":
        return flat.view(torch.int64)
    return flat


#: position keys by (device, lane offset, layout): the mix of each
#: element's (lane, offset, leaf) position, which depends on the Sim's
#: shapes only, and the elements of each class
_KEYS: dict = {}


def _position_keys(groups, key, lane_offset: int, device) -> tuple:
    """``(keys, lens)``: ``fmix64(pos ^ salt)`` of every digested
    element, in the order :func:`sim_digest` concatenates them (class by
    class), ``pos = (lane + lane_offset) * inner + offset`` and the salt
    its leaf's ordinal's; and each class's number of elements."""
    import torch

    from cimba_tpu_torch.random import bits as rb

    cache = (str(device), int(lane_offset), key)
    got = _KEYS.get(cache)
    if got is not None:
        return got
    keys, lens = [], [0] * len(CLASS_NAMES)
    for cname, g in _GROUPS:
        for ordinal, leaf in groups[g]:
            W = int(leaf.shape[0])
            inner = leaf[0].numel() if W else 0
            pos = (torch.arange(W * inner, dtype=torch.int64, device=device)
                   + int(lane_offset) * inner)
            salt = _i64(_fmix64_host((ordinal + 1) * _GAMMA))
            keys.append(rb.fmix64(pos ^ salt))
            lens[CLASS_NAMES.index(cname)] += W * inner
    got = (torch.cat(keys) if keys
           else torch.zeros(0, dtype=torch.int64, device=device), lens)
    if len(_KEYS) >= 8:
        _KEYS.clear()
    _KEYS[cache] = got
    return got


def _sum_u64(h, lens=None):
    """``sum(h) mod 2**64`` of int64 bit patterns, exact (a vector of
    the sums of the consecutive runs of ``lens`` elements where given):
    the 32-bit halves summed apart (each sum below 2**63 for fewer than
    2**31 elements), the carry of the low half folded into the high
    half."""
    import torch

    parts = h.split(lens) if lens is not None else (h,)
    lo = torch.stack([(x & _M32).sum() for x in parts])
    hi = torch.stack([((x >> 32) & _M32).sum() for x in parts])
    hi = (hi + (lo >> 32)) & _M32
    out = (hi << 32) | (lo & _M32)
    return out if lens is not None else out[0]


def sim_digest(sims, lane_offset: int = 0):
    """The ``[4]`` digest vector (int64 tensors holding u64 bits, class
    order :data:`CLASS_NAMES`) of a lane-first Sim, on the Sim's device
    — what an audited chunk appends at every chunk boundary.

    Each leaf in ``tree.leaves`` order is taken as its class's unsigned
    payload (f32 and i32 as 32 bits, f64 and i64 as 64), each element is
    mixed with its position key ``(lane + lane_offset) * inner + offset``
    and a salt of the leaf's ordinal through fmix64, and the mixes are
    summed mod 2**64 into the class's accumulator.  A 32-bit class sums
    in full 64 bits; :func:`format_digests` masks it.  The sums do not
    depend on the order of the elements, so the leaves are concatenated
    by dtype, a few launches for the whole Sim."""
    import torch

    from cimba_tpu_torch.random import bits as rb

    groups, key = _layout(sims)
    dev = sims.clock.device
    keys, lens = _position_keys(groups, key, lane_offset, dev)
    parts = [_payload(g, torch.cat([x.reshape(-1) for _, x in groups[g]]))
             for _, g in _GROUPS if groups[g]]
    if not parts:
        return torch.zeros(len(CLASS_NAMES), dtype=torch.int64, device=dev)
    h = rb.fmix64(torch.cat(parts) ^ keys)
    return _sum_u64(h, lens)


def combine_digests(vecs):
    """The digest vector of a Sim whose lanes are split over shards:
    each shard's :func:`sim_digest` at its global lane offset, summed mod
    2**64 class by class (exact: the halves of every class summed apart),
    equal to the digest of the gathered Sim."""
    import torch

    if len(vecs) == 1:
        return vecs[0]
    k = len(vecs)
    h = torch.stack(list(vecs)).t().reshape(-1)
    return _sum_u64(h, [k] * len(CLASS_NAMES))


def format_digests(vec) -> Dict[str, str]:
    """One digest vector as a trail row's payload: hex strings, the
    32-bit classes masked to their u32 payload."""
    import numpy as np

    v = np.asarray(vec.detach().cpu() if hasattr(vec, "detach") else vec)
    out = {}
    for i, name in enumerate(CLASS_NAMES):
        x = int(v[i]) & _U64
        if _CLASS_BITS[name] == 32:
            out[name] = f"0x{x & _M32:08x}"
        else:
            out[name] = f"0x{x:016x}"
    return out


# ---------------------------------------------------------------------------
# result digests (host-side, exact)
# ---------------------------------------------------------------------------


def _structure(x) -> str:
    """The tree's structure as text: NamedTuple types and fields, dict
    keys, sequence lengths, ``*`` for a leaf."""
    if x is None:
        return "None"
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (f"{type(x).__name__}(" + ",".join(
            f"{f}={_structure(v)}" for f, v in zip(x._fields, x)) + ")")
    if isinstance(x, (list, tuple)):
        return f"{type(x).__name__}[" + ",".join(map(_structure, x)) + "]"
    if isinstance(x, dict):
        return "{" + ",".join(f"{k}:{_structure(x[k])}"
                              for k in sorted(x)) + "}"
    return "*"


def result_digest(tree_) -> str:
    """sha256 hex over a tree of tensors: its structure, then each
    leaf's dtype, shape and bytes in ``tree.leaves`` order.  Two results
    digest equal iff every leaf is bit for bit equal."""
    import numpy as np

    from cimba_tpu_torch import tree

    h = hashlib.sha256()
    h.update(_structure(tree_).encode("utf-8"))
    for leaf in tree.leaves(tree_):
        a = np.asarray(leaf.detach().cpu() if hasattr(leaf, "detach")
                       else leaf)
        h.update(str(a.dtype).encode("utf-8"))
        h.update(repr(a.shape).encode("utf-8"))
        h.update(a.tobytes())
    return h.hexdigest()


def stream_result_digest(res) -> str:
    """The digest of a ``StreamResult``: summary, failure count, event
    total (and the pooled metrics where carried).  ``n_waves`` and
    ``n_regrows`` are geometry, which the card records apart."""
    parts: tuple = (res.summary, res.n_failed, res.total_events)
    if res.metrics is not None:
        parts = parts + (res.metrics,)
    return result_digest(parts)


# ---------------------------------------------------------------------------
# the host-side collector
# ---------------------------------------------------------------------------


class Audit:
    """One run's audit collector: the digest trail (device vectors, one a
    chunk, converted when the card is made) and the run card.
    ``out_dir`` (optional) is where :meth:`finalize` writes the card."""

    def __init__(self, out_dir=None, label: Optional[str] = None):
        self.out_dir = None if out_dir is None else str(out_dir)
        self.label = label
        self._trail: List[Tuple[int, int, Any]] = []
        self.card: Optional[dict] = None
        self.card_path: Optional[str] = None

    def on_chunk(self, wave: int, chunk: int, vec) -> None:
        """Append one chunk boundary's digest vector (kept on its device:
        the drive loop does not wait for it)."""
        self._trail.append((int(wave), int(chunk), vec))

    def trail_rows(self) -> List[dict]:
        """The trail as JSON rows ``{"wave", "chunk", "f32", "i32",
        "f64", "i64"}`` in append order."""
        rows = []
        for w, c, vec in self._trail:
            row: dict = {"wave": w, "chunk": c}
            row.update(format_digests(vec))
            rows.append(row)
        return rows

    def finalize(self, kind: str, **blocks) -> dict:
        """Build (and, with ``out_dir``, write) this run's card; keyword
        blocks go to :func:`run_card`."""
        card = run_card(kind, digest_trail=self.trail_rows(),
                        label=self.label, **blocks)
        self.card = card
        if self.out_dir:
            self.card_path = write_run_card(card, self.out_dir)
        return card


def resolve(audit) -> Optional[Audit]:
    """An ``audit=`` argument as a collector: ``None`` defers to the
    ``CIMBA_AUDIT`` environment knob (unset or "0" off, "1" in memory, a
    path writes cards there), ``False`` is off, ``True`` in memory, a
    path string collects and writes, an :class:`Audit` is used as is."""
    if audit is None:
        v = os.environ.get(AUDIT_ENV, "")
        if v in ("", "0"):
            return None
        return Audit() if v == "1" else Audit(out_dir=v)
    if audit is False:
        return None
    if audit is True:
        return Audit()
    if isinstance(audit, Audit):
        return audit
    if isinstance(audit, (str, os.PathLike)):
        return Audit(out_dir=audit)
    raise TypeError(
        f"audit= expects None, bool, a directory path, or an "
        f"obs.audit.Audit — got {type(audit).__name__}")


# ---------------------------------------------------------------------------
# run cards
# ---------------------------------------------------------------------------

_CARD_INFO: dict = {}


def _card_of(index: int) -> tuple:
    """(name, power limit) of card ``index`` from ``nvidia-smi``; the
    name from torch where nvidia-smi is missing."""
    import subprocess

    import torch

    if index in _CARD_INFO:
        return _CARD_INFO[index]
    name, limit = torch.cuda.get_device_name(index), None
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        if out:
            name, limit = (s.strip() for s in out.split(",", 1))
    except (OSError, subprocess.SubprocessError, ValueError):
        pass
    _CARD_INFO[index] = (name, limit)
    return name, limit


def environment(device="cpu") -> dict:
    """The card's env block: Python, the package and torch versions,
    CUDA's, the backend the run used, and on the card its name, the card
    count and its power limit (``nvidia-smi``)."""
    import platform

    import torch

    import cimba_tpu_torch

    dev = torch.device(device)
    out = {
        "python": platform.python_version(),
        "package": f"cimba_tpu_torch {cimba_tpu_torch.__version__}",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": dev.type,
    }
    if dev.type == "cuda":
        name, limit = _card_of(dev.index or 0)
        out.update(device_kind=name, n_devices=torch.cuda.device_count(),
                   power_limit=limit)
    else:
        out.update(device_kind="cpu", n_devices=1)
    return out


# the value-based fingerprint of a spec: a copy of the reference store's
# (cimba_tpu.serve.store.stable_spec_fingerprint), functions digested by
# value — module, qualname, bytecode, constants, defaults and closure
# cell contents — so a spec rebuilt in a fresh process digests the same


class UnstableSpecKey(Exception):
    """The spec's structure cannot be fingerprinted by value."""


def _stable_code(code: types.CodeType, seen: dict) -> tuple:
    consts = tuple(
        _stable_code(c, seen) if isinstance(c, types.CodeType)
        else _stable_obj(c, seen) for c in code.co_consts)
    return ("code", code.co_code, consts, code.co_names, code.co_varnames,
            code.co_freevars, code.co_argcount, code.co_kwonlyargcount,
            code.co_flags)


def _stable_callable(fn, seen: dict) -> tuple:
    import functools

    if isinstance(fn, functools.partial):
        kw = tuple(sorted((fn.keywords or {}).items()))
        return ("partial", _stable_callable(fn.func, seen),
                _stable_obj(tuple(fn.args), seen), _stable_obj(kw, seen))
    if isinstance(fn, types.MethodType):
        return ("method", _stable_callable(fn.__func__, seen),
                _stable_obj(fn.__self__, seen))
    if id(fn) in seen:
        # a revisited callable: its first visit's ordinal, so (f, g, f)
        # and (f, g, g) digest apart
        return ("ref", seen[id(fn)])
    seen[id(fn)] = len(seen)
    code = getattr(fn, "__code__", None)
    if code is None:
        mod = getattr(fn, "__module__", None)
        qn = getattr(fn, "__qualname__", None) or getattr(fn, "__name__",
                                                          None)
        if qn is None:
            raise UnstableSpecKey(
                f"callable {fn!r} has no code object and no qualified "
                "name — it cannot be fingerprinted by value")
        return ("c", mod, qn)
    cells: tuple = ()
    if fn.__closure__:
        cells = tuple(_stable_obj(c.cell_contents, seen)
                      for c in fn.__closure__)
    defaults = (None if fn.__defaults__ is None
                else _stable_obj(tuple(fn.__defaults__), seen))
    return ("fn", fn.__module__, fn.__qualname__, _stable_code(code, seen),
            cells, defaults)


def _stable_obj(v, seen: dict) -> tuple:
    import numpy as np
    import torch

    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return ("p", repr(v))
    if isinstance(v, np.ndarray):
        return ("nd", str(v.dtype), v.shape, v.tobytes())
    if isinstance(v, np.generic):
        return ("ns", str(v.dtype), v.tobytes())
    if isinstance(v, np.dtype):
        return ("dt", str(v))
    if isinstance(v, torch.dtype):
        return ("tdt", str(v))
    if isinstance(v, torch.Tensor):
        a = v.detach().cpu()
        return ("tt", str(a.dtype), tuple(a.shape),
                a.contiguous().view(torch.uint8).numpy().tobytes()
                if a.numel() else b"")
    if isinstance(v, (list, tuple)):
        return ("seq", type(v).__name__,
                tuple(_stable_obj(x, seen) for x in v))
    if isinstance(v, (set, frozenset)):
        return ("set", tuple(sorted(_stable_obj(x, seen) for x in v)))
    if isinstance(v, dict):
        return ("map", tuple(sorted(
            (_stable_obj(k, seen), _stable_obj(x, seen))
            for k, x in v.items())))
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return ("dc", type(v).__module__, type(v).__qualname__,
                tuple((f.name, _stable_obj(getattr(v, f.name), seen))
                      for f in dataclasses.fields(v)))
    if callable(v):
        return _stable_callable(v, seen)
    raise UnstableSpecKey(
        f"{type(v).__module__}.{type(v).__qualname__} has no "
        "deterministic value digest")


def stable_spec_fingerprint(spec) -> tuple:
    """The value-based structural identity of a ModelSpec (the
    reference store's ``stable_spec_fingerprint``, on the port's
    fields)."""
    import numpy as np

    seen: dict = {}
    return (
        spec.name,
        tuple(_stable_callable(b, seen) for b in spec.blocks),
        np.asarray(spec.proc_entry).tobytes(),
        np.asarray(spec.proc_prio).tobytes(),
        np.asarray(spec.proc_start).tobytes(),
        tuple(spec.proc_names),
        tuple(_stable_obj(q, seen) for q in spec.queues),
        tuple(_stable_obj(r, seen) for r in spec.resources),
        tuple(_stable_obj(p, seen) for p in spec.pools),
        tuple(_stable_obj(b, seen) for b in spec.buffers),
        tuple(_stable_obj(q, seen) for q in spec.pqueues),
        tuple(_stable_obj(c, seen) for c in spec.conditions),
        spec.n_guards, spec.event_cap, spec.queue_cap_max,
        spec.pqueue_cap_max, spec.n_flocals, spec.n_ilocals,
        None if spec.user_init is None
        else _stable_callable(spec.user_init, seen),
        tuple(_stable_callable(h, seen) for h in spec.user_handlers),
        tuple(spec.boundary_pcs),
    )


def spec_block(spec) -> dict:
    """The card's spec identity: the name and the sha256 of
    :func:`stable_spec_fingerprint`; a spec that resists it records
    why."""
    out: dict = {"name": getattr(spec, "name", None)}
    try:
        fp = stable_spec_fingerprint(spec)
        out["spec_fingerprint"] = hashlib.sha256(
            repr(fp).encode("utf-8")).hexdigest()
    except Exception as e:
        out["spec_fingerprint"] = None
        out["unstable"] = f"{type(e).__name__}: {e}"
    return out


def run_card(kind: str, *, spec=None, geometry: Optional[dict] = None,
             seed_schedule: Optional[dict] = None,
             digest_trail: Optional[List[dict]] = None,
             result_digest: Optional[str] = None,
             cells: Optional[List[dict]] = None,
             label: Optional[str] = None, device="cpu") -> dict:
    """Assemble one run card (omitted blocks are left out) and stamp its
    content digest.  ``spec`` is a ModelSpec (hashed by
    :func:`spec_block`) or a dict; ``device`` the run's, for the env
    block.  ``cells`` is a sweep card's per-cell block (label, seed list,
    replications, stop round and each cell's :func:`result_digest`).
    The reference's blocks of the layers the port does not have yet
    (telemetry, tuned schedules, program keys) are not written."""
    card: dict = {"format": CARD_FORMAT, "kind": str(kind),
                  "created_unix": time.time(),
                  "env": environment(device)}
    if label:
        card["label"] = str(label)
    if spec is not None:
        card["spec"] = spec if isinstance(spec, dict) else spec_block(spec)
    for name, block in (("seed_schedule", seed_schedule),
                        ("geometry", geometry),
                        ("digest_trail", digest_trail),
                        ("result_digest", result_digest),
                        ("cells", cells)):
        if block is not None:
            card[name] = block
    card["card_digest"] = card_digest(card)
    return card


def card_digest(card: dict) -> str:
    """sha256 over the canonical JSON of the card without
    ``card_digest`` and the creation time: two clean same-seed runs in
    one environment give the same digest."""
    body = {k: v for k, v in card.items()
            if k not in ("card_digest", "created_unix")}
    return hashlib.sha256(json.dumps(body, sort_keys=True, default=str)
                          .encode("utf-8")).hexdigest()


def write_run_card(card: dict, out_dir) -> str:
    """Write a card content-addressed (``runcard_<digest16>.json``),
    atomically (a temporary file renamed)."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"runcard_{card['card_digest'][:16]}.json")
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(card, f, indent=2, sort_keys=True, default=str)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_run_card(path) -> dict:
    """Load a run card (or a bare digest-trail JSON list, wrapped),
    failing loudly with the file's name on anything malformed."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):
        doc = {"format": CARD_FORMAT, "kind": "trail", "digest_trail": doc}
    if not isinstance(doc, dict) or "kind" not in doc:
        raise ValueError(
            f"{path}: not a run card (expected a JSON object with a "
            "'kind' field, or a bare digest-trail list)")
    return doc


# ---------------------------------------------------------------------------
# divergence localization
# ---------------------------------------------------------------------------


def diff_trails(a_rows: List[dict], b_rows: List[dict]) -> Optional[dict]:
    """The first divergent row of two digest trails, or ``None`` when
    they are equal: its (wave, chunk) and the classes that differ
    (``["geometry"]`` where the coordinates disagree, ``["length"]``
    where one trail is a prefix of the other)."""
    for i, (ra, rb) in enumerate(zip(a_rows, b_rows)):
        if (ra.get("wave"), ra.get("chunk")) != (rb.get("wave"),
                                                 rb.get("chunk")):
            return {"index": i, "wave": ra.get("wave"),
                    "chunk": ra.get("chunk"), "classes": ["geometry"],
                    "a": ra, "b": rb}
        classes = [n for n in CLASS_NAMES if ra.get(n) != rb.get(n)]
        if classes:
            return {"index": i, "wave": ra.get("wave"),
                    "chunk": ra.get("chunk"), "classes": classes,
                    "a": {n: ra.get(n) for n in classes},
                    "b": {n: rb.get(n) for n in classes}}
    if len(a_rows) != len(b_rows):
        i = min(len(a_rows), len(b_rows))
        longer = a_rows if len(a_rows) > len(b_rows) else b_rows
        row = longer[i] if i < len(longer) else {}
        return {"index": i, "wave": row.get("wave"),
                "chunk": row.get("chunk"), "classes": ["length"],
                "a_len": len(a_rows), "b_len": len(b_rows)}
    return None


#: geometry fields that must match for two trails to be comparable
_GEOMETRY_KEYS = ("R", "wave_size", "chunk_steps", "poll_every", "t_end",
                  "profile", "mesh", "with_metrics")


def diff_cards(a: dict, b: dict) -> dict:
    """Compare two run cards: ``comparable`` (False, with ``reasons``,
    when spec, kind or geometry differ), ``env_drift`` (reported, not
    blocking), ``first_divergence`` (:func:`diff_trails`),
    ``result_equal`` (None where a card has no result digest) and
    ``identical``."""
    reasons: List[str] = []
    fa = (a.get("spec") or {}).get("spec_fingerprint")
    fb = (b.get("spec") or {}).get("spec_fingerprint")
    if fa and fb and fa != fb:
        reasons.append("spec fingerprint differs")
    if a.get("kind") != b.get("kind"):
        reasons.append(f"kind differs ({a.get('kind')!r} vs "
                       f"{b.get('kind')!r})")
    ga, gb = a.get("geometry") or {}, b.get("geometry") or {}
    geo_drift = [k for k in _GEOMETRY_KEYS
                 if k in ga and k in gb and ga[k] != gb[k]]
    if geo_drift:
        reasons.append("geometry differs: " + ", ".join(geo_drift))
    ea, eb = a.get("env") or {}, b.get("env") or {}
    env_drift = sorted(k for k in set(ea) | set(eb)
                       if ea.get(k) != eb.get(k))
    seeds_differ = (a.get("seed_schedule") is not None
                    and b.get("seed_schedule") is not None
                    and a["seed_schedule"] != b["seed_schedule"])
    divergence = diff_trails(a.get("digest_trail") or [],
                             b.get("digest_trail") or [])
    ra, rb = a.get("result_digest"), b.get("result_digest")
    result_equal = None if (ra is None or rb is None) else (ra == rb)
    comparable = not reasons
    return {
        "comparable": comparable, "reasons": reasons,
        "env_drift": env_drift, "seeds_differ": seeds_differ,
        "first_divergence": divergence, "result_equal": result_equal,
        "trail_len": (len(a.get("digest_trail") or []),
                      len(b.get("digest_trail") or [])),
        "identical": bool(comparable and divergence is None
                          and result_equal is not False),
    }
