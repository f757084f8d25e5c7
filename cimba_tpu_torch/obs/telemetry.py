"""Host-side telemetry plane: time-series registry, spans, health (parity:
``cimba_tpu.obs.telemetry``, its own copy: the port imports nothing of the
JAX package).

The in-run observability (:mod:`obs.trace`, :mod:`obs.metrics`) lives
*inside* the Sim as tensors; this module is its host-side
counterpart — the control-plane signals a production serving stack needs
scrapeable at runtime: how deep are the queues, how full are the waves,
how often do deadlines miss, is the dispatcher thread alive.  Three parts:

* :class:`Registry` — a thread-safe registry of **labeled time series**:
  monotone counters, gauges, and log2-bucket histograms, each series
  keeping a ring-buffered history of recent samples.  Rendered to
  Prometheus text / scraped over HTTP by :mod:`cimba_tpu_torch.obs.expose`.
* :class:`SpanRecorder` — **request-scoped spans**: a ``trace_id`` minted
  at :meth:`cimba_tpu_torch.serve.Service.submit` and threaded through
  admit → queue → pack → wave → chunk → fold → deliver (and through
  :func:`cimba_tpu_torch.sweep.run_sweep`'s rounds), streamed as JSONL (one
  complete span per line, written at span END so a line is never torn)
  and exported into the validator-clean ``chrome_trace()`` docs.
* :class:`Telemetry` — the plane itself: a background **sampler** thread
  that scrapes ``Service.stats()`` / ``ProgramCache.stats()`` (store
  counters included) into the registry on an interval, heartbeats for
  liveness (a watchdog's primitive), and the
  ``healthz()``/``varz()`` snapshots the exposition server serves.

The disabled == zero-overhead contract: every integration point takes
``telemetry=None`` as its default, and None means NO background threads,
NO span objects allocated on the hot submit path, and — because
everything here is host-side bookkeeping that never touches a kernel or
a Sim — results bitwise-unchanged either way (pinned in
tests/test_torch_telemetry.py).  This module is stdlib-only at import
time: it imports no torch, so the operator tooling
(``cimba_tpu_torch/tools/metrics_dump.py``) stays light and nothing here
can perturb a run.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "Registry", "Family", "SpanRecorder", "Telemetry",
    "METRIC_PREFIX", "build_info",
]

#: every metric family this package creates is namespaced under this
METRIC_PREFIX = "cimba_"

_BUILD_INFO: Optional[dict] = None


def build_info() -> dict:
    """The process's build/provenance block — python, the package's
    version, and (when torch is importable) the torch and CUDA versions,
    the device kind and count.  ONE definition serves both the ``/varz``
    ``build`` section and the run cards' ``telemetry`` block, so a
    scraped process cross-checks against a stored artifact
    field-for-field.  torch is imported lazily and guarded: this module
    stays stdlib-only at import time.  Cached — none of it changes
    within a process."""
    global _BUILD_INFO
    if _BUILD_INFO is not None:
        return dict(_BUILD_INFO)
    import platform

    out: dict = {"python": platform.python_version()}
    try:
        from importlib import metadata as _md

        out["package"] = _md.version("cimba_tpu_torch")
    except Exception:
        out["package"] = None
    try:
        import torch

        card = torch.cuda.is_available()
        out.update(
            torch=torch.__version__,
            cuda=torch.version.cuda,
            backend="cuda" if card else "cpu",
            device_kind=(torch.cuda.get_device_name(0) if card
                         else "cpu"),
            n_devices=torch.cuda.device_count() if card else 0,
        )
    except Exception:
        # a deviceless scrape still gets the python/package half; the
        # card's probe can fail with CUDA errors, not just ImportError,
        # and a build-info probe must never take down a scrape
        pass
    _BUILD_INFO = out
    return dict(out)

#: log2 histogram exponent clamp — buckets span 2^-30 .. 2^30 (seconds:
#: ~1 ns to ~34 years), anything outside lands in the edge buckets, so
#: label cardinality is bounded no matter what gets observed
_EXP_MIN, _EXP_MAX = -30, 30

_KINDS = ("counter", "gauge", "histogram")


def _label_key(label_names: Tuple[str, ...], kv: dict) -> tuple:
    if set(kv) != set(label_names):
        raise ValueError(
            f"labels {sorted(kv)} do not match the family's declared "
            f"label names {sorted(label_names)}"
        )
    return tuple(str(kv[k]) for k in label_names)


class _Series:
    """One labeled time series: the current value plus a bounded ring of
    ``(t, value)`` history samples (appended by the sampler's
    :meth:`Registry.tick_history`, not per update — history is a
    sampled view, the live value is exact)."""

    __slots__ = ("label_values", "value", "sum", "count", "buckets",
                 "ring")

    def __init__(self, label_values: tuple, kind: str, history: int):
        self.label_values = label_values
        self.value = 0.0          # counter/gauge current value
        self.sum = 0.0            # histogram
        self.count = 0            # histogram
        self.buckets: Optional[Dict[int, int]] = (
            {} if kind == "histogram" else None
        )
        self.ring: deque = deque(maxlen=max(int(history), 1))


class _Handle:
    """A series bound to its family and registry lock — what
    ``family.labels(...)`` returns and what update calls go through."""

    __slots__ = ("_family", "_series")

    def __init__(self, family: "Family", series: _Series):
        self._family = family
        self._series = series

    # -- counter -------------------------------------------------------------

    def inc(self, n: float = 1.0) -> None:
        if self._family.kind not in ("counter", "gauge"):
            raise TypeError(f"inc() on a {self._family.kind}")
        if self._family.kind == "counter" and n < 0:
            raise ValueError(f"counters only go up, got inc({n})")
        with self._family._lock:
            self._series.value += n

    def set_total(self, v: float) -> None:
        """Mirror an externally-maintained cumulative total (e.g. a
        ``Service.stats()`` counter) into this counter.  Monotone: a
        smaller value than the current one is ignored rather than
        making the counter appear to go backwards mid-scrape."""
        if self._family.kind != "counter":
            raise TypeError(f"set_total() on a {self._family.kind}")
        with self._family._lock:
            if v > self._series.value:
                self._series.value = float(v)

    # -- gauge ---------------------------------------------------------------

    def set(self, v: float) -> None:
        if self._family.kind != "gauge":
            raise TypeError(f"set() on a {self._family.kind}")
        with self._family._lock:
            self._series.value = float(v)

    # -- histogram -----------------------------------------------------------

    def observe(self, v: float) -> None:
        if self._family.kind != "histogram":
            raise TypeError(f"observe() on a {self._family.kind}")
        e = _log2_exponent(v)
        with self._family._lock:
            s = self._series
            s.buckets[e] = s.buckets.get(e, 0) + 1
            s.sum += float(v)
            s.count += 1

    # -- reads ---------------------------------------------------------------

    def get(self) -> float:
        with self._family._lock:
            s = self._series
            return float(s.count if self._family.kind == "histogram"
                         else s.value)


def _log2_exponent(v: float) -> int:
    """The log2 bucket ``v`` falls in: the smallest integer ``e`` with
    ``v <= 2**e`` (clamped to the bounded exponent range; non-positive
    and non-finite values clamp to the edge buckets)."""
    if not (v > 0.0) or math.isinf(v):
        return _EXP_MIN if not v > 0.0 else _EXP_MAX
    m, e = math.frexp(v)        # v = m * 2**e, m in [0.5, 1)
    if m == 0.5:                # exact power of two sits ON its boundary
        e -= 1
    return min(max(e, _EXP_MIN), _EXP_MAX)


class Family:
    """One metric family: a name, a kind (counter | gauge | histogram),
    help text, declared label names, and the labeled series under it."""

    # cimba-check: must-hold(_lock) _series

    def __init__(self, registry: "Registry", name: str, kind: str,
                 help: str, label_names: Tuple[str, ...]):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = registry._lock
        self._history = registry.history
        self._series: "OrderedDict[tuple, _Series]" = OrderedDict()

    def labels(self, **kv) -> _Handle:
        key = _label_key(self.label_names, kv)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = _Series(key, self.kind, self._history)
                self._series[key] = s
        return _Handle(self, s)

    def remove(self, **kv) -> None:
        """Drop one labeled series (no-op when absent) — how the fleet
        federation prunes a dead slice's series so rollups stay
        sum-of-live (docs/23_fleet_observability.md)."""
        key = _label_key(self.label_names, kv)
        with self._lock:
            self._series.pop(key, None)

    # label-less convenience: family-level update ops act on the () series
    def inc(self, n: float = 1.0) -> None:
        self.labels().inc(n)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def set_total(self, v: float) -> None:
        self.labels().set_total(v)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def get(self, **kv) -> float:
        return self.labels(**kv).get()


class Registry:
    """A thread-safe registry of metric families.

    ``counter``/``gauge``/``histogram`` are get-or-create: asking for an
    existing name returns the existing family (kind must match — a name
    silently changing kind would corrupt every scrape).  ``history``
    bounds each series' sample ring; :meth:`tick_history` (called by the
    Telemetry sampler) appends one ``(t, value)`` sample per series."""

    # cimba-check: must-hold(_lock) _families

    def __init__(self, history: int = 256):
        self.history = int(history)
        self._lock = threading.RLock()
        self._families: "OrderedDict[str, Family]" = OrderedDict()

    def _family(self, name: str, kind: str, help: str,
                labels: Tuple[str, ...]) -> Family:
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}, not {kind}"
                    )
                return fam
            fam = Family(self, name, kind, help, tuple(labels))
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Tuple[str, ...] = ()) -> Family:
        return self._family(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Tuple[str, ...] = ()) -> Family:
        return self._family(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Tuple[str, ...] = ()) -> Family:
        return self._family(name, "histogram", help, labels)

    # -- snapshots -----------------------------------------------------------

    def collect(self) -> List[dict]:
        """An atomic snapshot of every family and series — ONE lock
        acquisition for the whole registry, so a scrape can never see
        half of one update (the torn-read contract the exposition
        endpoints rely on).  Returns plain data (JSON-able)."""
        out = []
        with self._lock:
            for fam in self._families.values():
                series = []
                for s in fam._series.values():
                    rec: Dict[str, Any] = {
                        "labels": dict(zip(fam.label_names,
                                           s.label_values)),
                    }
                    if fam.kind == "histogram":
                        rec["buckets"] = dict(s.buckets)
                        rec["sum"] = s.sum
                        rec["count"] = s.count
                    else:
                        rec["value"] = s.value
                    rec["history"] = list(s.ring)
                    series.append(rec)
                out.append({
                    "name": fam.name, "kind": fam.kind, "help": fam.help,
                    "label_names": list(fam.label_names),
                    "series": series,
                })
        return out

    def tick_history(self, t: Optional[float] = None) -> None:
        """Append one ``(t, value)`` sample to every series' ring (the
        sampler's job; histogram series sample their count)."""
        t = time.monotonic() if t is None else t
        with self._lock:
            for fam in self._families.values():
                for s in fam._series.values():
                    v = s.count if fam.kind == "histogram" else s.value
                    s.ring.append((t, v))

    def get_sample(self, name: str, **labels) -> Optional[float]:
        """The current value of one series (None when absent) —
        convenience for tests and the bench snapshot."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            key = tuple(str(labels[k]) for k in fam.label_names
                        if k in labels)
            if len(key) != len(fam.label_names):
                return None
            s = fam._series.get(key)
            if s is None:
                return None
            return float(s.count if fam.kind == "histogram" else s.value)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class SpanRecorder:
    """Request-scoped span trees, streamed as JSONL.

    A **trace** is one request's (or one sweep's) lifetime; **spans**
    are its phases (queue, wave, …) and **events** are instants on them
    (chunk ticks, fold boundaries, deliver).  A span line is written at
    span END — complete, never torn — as::

        {"trace": "t0001", "span": "s0003", "parent": "s0001",
         "name": "wave", "t0": 0.0123, "dur": 0.4, "outcome": "ok", ...}

    events carry ``"ph": "i"`` and a single ``"t"``.  Completeness is a
    structural guarantee, not a convention: :meth:`end_trace` closes
    every still-open span of the trace in reverse start order before
    closing the root, so a request that is cancelled, deadline-expired,
    or retried-to-exhaustion still yields exactly one complete span
    tree (tests/test_telemetry.py pins all four outcomes).  A bounded
    ring keeps recent completed spans in memory for the
    ``chrome_trace()`` export.

    ``max_bytes`` (opt-in) caps the JSONL file's growth: once the
    current file exceeds it, the log rotates (``path`` →
    ``path + ".1"``, replacing the previous generation) — but ONLY at
    a trace boundary with NO other trace open, so a span tree is never
    torn across files (a long soak keeps at most two generations on
    disk; ``counters["rotations"]`` says how often it happened).

    **Cross-process grafting** (docs/23_fleet_observability.md): a
    recorder can :meth:`adopt_trace` a trace id minted by ANOTHER
    process's recorder (the fleet router), recording its local span
    tree under the remote trace with the local root parented on a
    remote span id.  ``node`` namespaces every locally-minted id with a
    ``.node`` suffix, so the two processes' per-process counters cannot
    collide when their JSONL files are merged into one tree."""

    # cimba-check: must-hold(_lock) _open, _by_trace, _n, _bytes, _fh, counters, completed, _remote_parent

    def __init__(self, path=None, cap: int = 4096,
                 max_bytes: Optional[int] = None,
                 node: Optional[str] = None):
        self._lock = threading.Lock()
        self._m0 = time.monotonic()
        self._n = 0
        self._node = None if node is None else str(node)
        self._suffix = "" if node is None else f".{node}"
        self._open: Dict[str, dict] = {}
        self._by_trace: "OrderedDict[str, List[str]]" = OrderedDict()
        # trace id -> the REMOTE parent span id its local root hangs
        # under (adopt_trace); end_trace needs it to recognize the
        # local root, whose parent is NOT None for an adopted trace
        self._remote_parent: Dict[str, str] = {}
        self.completed: deque = deque(maxlen=int(cap))
        self.counters = {
            "traces_started": 0, "traces_ended": 0, "traces_adopted": 0,
            "spans_started": 0, "spans_ended": 0, "events": 0,
            "rotations": 0,
        }
        self._path = None if path is None else str(path)
        self._max_bytes = None if max_bytes is None else int(max_bytes)
        self._bytes = 0
        self._fh = None
        if self._path is not None:
            self._fh = open(self._path, "a", buffering=1)
            try:
                self._bytes = os.path.getsize(self._path)
            except OSError:
                self._bytes = 0

    # -- lifecycle -----------------------------------------------------------

    def new_trace(self) -> str:
        with self._lock:
            self._n += 1
            tid = f"t{self._n:08x}{self._suffix}"
            self._by_trace[tid] = []
            self.counters["traces_started"] += 1
            return tid

    def adopt_trace(self, trace: str,
                    parent: Optional[str] = None) -> str:
        """Adopt a trace id minted by a REMOTE recorder (the wire's
        ``trace`` header): spans recorded locally under ``trace`` write
        lines carrying the remote id, so the two processes' JSONL files
        merge into one tree.  ``parent`` is the remote span id the
        local root will hang under — :meth:`end_trace` treats the span
        parented on it as the root (its parent is not ``None``, which
        is how a purely local root is recognized).  Idempotent per
        trace id; returns ``trace``."""
        with self._lock:
            if trace not in self._by_trace:
                self._by_trace[trace] = []
                self.counters["traces_adopted"] += 1
            if parent is not None:
                self._remote_parent[trace] = str(parent)
            return trace

    def start(self, trace: str, name: str,
              parent: Optional[str] = None, **attrs) -> str:
        now = time.monotonic()
        with self._lock:
            self._n += 1
            sid = f"s{self._n:08x}{self._suffix}"
            rec = {
                "trace": trace, "span": sid, "parent": parent,
                "name": name, "m0": now,
            }
            if attrs:
                rec["attrs"] = attrs
            self._open[sid] = rec
            self._by_trace.setdefault(trace, []).append(sid)
            self.counters["spans_started"] += 1
            return sid

    def end(self, span: str, outcome: Optional[str] = None,
            **attrs) -> None:
        now = time.monotonic()
        with self._lock:
            rec = self._open.pop(span, None)
            if rec is None:
                return           # already closed (end_trace raced) — fine
            sids = self._by_trace.get(rec["trace"])
            if sids is not None and span in sids:
                sids.remove(span)
            self._finish_locked(rec, now, outcome, attrs)

    def _finish_locked(self, rec, now, outcome, attrs) -> None:
        rec["m1"] = now
        if outcome is not None:
            rec["outcome"] = outcome
        if attrs:
            rec.setdefault("attrs", {}).update(attrs)
        self.counters["spans_ended"] += 1
        self.completed.append(rec)
        if self._fh is not None:
            line = {
                "trace": rec["trace"], "span": rec["span"],
                "parent": rec["parent"], "name": rec["name"],
                "t0": rec["m0"] - self._m0,
                "dur": rec["m1"] - rec["m0"],
            }
            if "outcome" in rec:
                line["outcome"] = rec["outcome"]
            if "attrs" in rec:
                line.update(rec["attrs"])
            data = json.dumps(line) + "\n"
            self._fh.write(data)
            self._bytes += len(data)

    def event(self, trace: str, name: str,
              parent: Optional[str] = None, **attrs) -> None:
        """An instant event on a trace (one JSONL line, ``ph: "i"``)."""
        now = time.monotonic()
        with self._lock:
            rec = {
                "trace": trace, "span": None, "parent": parent,
                "name": name, "m0": now, "m1": now, "ph": "i",
            }
            if attrs:
                rec["attrs"] = attrs
            self.counters["events"] += 1
            self.completed.append(rec)
            if self._fh is not None:
                line = {
                    "trace": trace, "parent": parent, "name": name,
                    "t": now - self._m0, "ph": "i",
                }
                line.update(attrs)
                data = json.dumps(line) + "\n"
                self._fh.write(data)
                self._bytes += len(data)

    def end_trace(self, trace: str, outcome: str, **attrs) -> None:
        """Close the trace: every still-open span ends in reverse start
        order (children before parents), the LAST one — the root —
        carrying ``outcome``.  The no-orphans guarantee lives here."""
        now = time.monotonic()
        with self._lock:
            sids = self._by_trace.pop(trace, None)
            remote = self._remote_parent.pop(trace, None)
            if sids is None:
                return
            for sid in reversed(sids):
                rec = self._open.pop(sid, None)
                if rec is None:
                    continue
                # an adopted trace's local root is parented on the
                # REMOTE span id, not None (adopt_trace recorded it)
                is_root = (
                    rec["parent"] is None or rec["parent"] == remote
                )
                self._finish_locked(
                    rec, now, outcome if is_root else "aborted",
                    attrs if is_root else {},
                )
            self.counters["traces_ended"] += 1
            self._maybe_rotate_locked()

    def _maybe_rotate_locked(self) -> None:
        """Rotate the JSONL log once it exceeds ``max_bytes`` — called
        only from :meth:`end_trace` (a trace boundary) and only when NO
        trace remains open, so every trace's lines live in exactly one
        generation (the never-tear-a-tree contract)."""
        if (
            self._fh is None
            or self._max_bytes is None
            or self._bytes <= self._max_bytes
            or self._by_trace
        ):
            return
        self._fh.close()
        try:
            os.replace(self._path, self._path + ".1")
            rotated = True
        except OSError:
            rotated = False  # best-effort; keep appending either way
        self._fh = open(self._path, "a", buffering=1)
        if rotated:
            self._bytes = 0
            self.counters["rotations"] += 1
        else:
            # the full file is still live: keep the byte count honest
            # (a reset here would silently defeat the cap and report
            # phantom rotations forever)
            try:
                self._bytes = os.path.getsize(self._path)
            except OSError:
                pass

    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def close(self) -> None:
        with self._lock:
            fh, self._fh = self._fh, None
        if fh is not None:
            fh.close()

    # -- export --------------------------------------------------------------

    def chrome_events(self, t0: float, pid_of: Callable[[str], Any],
                      tid_of: Callable[[str], int]) -> List[dict]:
        """Completed spans/events as Chrome-trace events: ``'X'`` spans
        and ``'i'`` instants, ``ts`` offset against the caller's ``t0``
        (a monotonic origin), pid/tid resolved per record by the caller
        (``pid_of(trace)`` may return None to skip a record).  The
        caller is responsible for per-pid timestamp ordering (sort by
        ``ts``)."""
        with self._lock:
            recs = list(self.completed)
        out = []
        for r in recs:
            pid = pid_of(r["trace"])
            if pid is None:
                continue
            ev = {
                "name": r["name"],
                "ts": (r["m0"] - t0) * 1e6,
                "pid": pid,
                "tid": tid_of(r["name"]),
                "args": dict(r.get("attrs", {})),
            }
            if r.get("ph") == "i":
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = max((r["m1"] - r["m0"]) * 1e6, 0.0)
                if "outcome" in r:
                    ev["args"]["outcome"] = r["outcome"]
            out.append(ev)
        return out


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------


class Telemetry:
    """The host-side telemetry plane: registry + spans + sampler +
    health.

    Opt-in by construction — code paths take ``telemetry=None`` and do
    nothing (no threads, no allocations) without one.  With one:

    * :meth:`attach_service` registers a collector that scrapes
      ``Service.stats()`` (counters, queue depths by class, lane
      occupancy/waste, program cache + store counters) into the
      registry, and starts the background sampler (interval > 0).
    * :meth:`tick`/:meth:`heartbeat` are the cheap hot-path hooks the
      runner/sweep/serve layers call per wave/chunk/round.
    * :meth:`healthz` / :meth:`varz` are what
      :mod:`cimba_tpu_torch.obs.expose` serves.

    ``spans=True`` (or a ``span_path``) turns on the
    :class:`SpanRecorder`; ``interval=0`` disables the sampler thread
    (ticks and collectors still work, scrapes just happen on demand).
    """

    # cimba-check: must-hold(_lock) _hb, _collectors, _services, _service_collectors, _errors, _thread

    def __init__(
        self,
        *,
        interval: float = 0.25,
        history: int = 256,
        spans: bool = False,
        span_path=None,
        span_max_bytes: Optional[int] = None,
        span_node: Optional[str] = None,
        registry: Optional[Registry] = None,
        stall_s: float = 30.0,
        autostart: bool = True,
    ):
        self.registry = registry if registry is not None else Registry(
            history=history
        )
        self.spans: Optional[SpanRecorder] = (
            SpanRecorder(path=span_path, max_bytes=span_max_bytes,
                         node=span_node)
            if (spans or span_path is not None) else None
        )
        self.interval = float(interval)
        self.stall_s = float(stall_s)
        self._autostart = bool(autostart)
        self._lock = threading.RLock()
        self._hb: Dict[str, float] = {}
        self._collectors: List[Callable[[], None]] = []
        self._healthz_hooks: "OrderedDict[str, Callable[[], dict]]" = (
            OrderedDict()
        )
        self._services: List[tuple] = []       # (name, service)
        self._service_collectors: Dict[int, Callable] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._errors = 0
        self._ticks = self.registry.counter(
            METRIC_PREFIX + "ticks_total",
            "progress ticks by source (waves, chunks, rounds)",
            labels=("source",),
        )
        self._hb_gauge = self.registry.gauge(
            METRIC_PREFIX + "heartbeat_age_seconds",
            "seconds since the source last reported progress",
            labels=("source",),
        )

    # -- hot-path hooks ------------------------------------------------------

    def heartbeat(self, source: str = "main") -> None:
        with self._lock:
            self._hb[source] = time.monotonic()

    def heartbeat_age(self, source: Optional[str] = None) -> float:
        """Seconds since ``source`` last beat — or, with no source, the
        FRESHEST beat across all sources (the watchdog reading: any
        progress anywhere counts).  ``inf`` when nothing ever beat."""
        now = time.monotonic()
        with self._lock:
            if source is not None:
                t = self._hb.get(source)
                return float("inf") if t is None else now - t
            if not self._hb:
                return float("inf")
            return now - max(self._hb.values())

    def tick(self, source: str, n: int = 1) -> None:
        """One progress tick: counter + heartbeat.  The generalized
        ``on_wave``/``on_chunk`` hook body (docs/17_telemetry.md)."""
        self._ticks.labels(source=source).inc(n)
        self.heartbeat(source)

    # -- wiring --------------------------------------------------------------

    def add_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors.append(fn)
        if self._autostart:
            self.start()

    def remove_collector(self, fn: Callable[[], None]) -> None:
        """Drop a collector registered with :meth:`add_collector`
        (idempotent) — what a shutting-down fleet router calls so a
        long-lived plane stops scraping it."""
        with self._lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    def add_healthz(self, name: str, fn: Callable[[], dict]) -> None:
        """Register an extra health contributor: ``fn()`` returns a
        check dict whose ``"status"`` ("ok" | "degraded" | "unhealthy")
        folds into the overall :meth:`healthz` verdict and whose body
        lands under ``checks[name]``.  How a non-``Service`` component
        (the fleet router's slice-verdict rollup,
        docs/23_fleet_observability.md) joins the verdict."""
        with self._lock:
            self._healthz_hooks[str(name)] = fn

    def remove_healthz(self, name: str) -> None:
        with self._lock:
            self._healthz_hooks.pop(str(name), None)

    def attach_service(self, service, name: Optional[str] = None) -> str:
        """Register ``service`` with the plane: a stats collector, the
        health checks, and (autostart) the sampler thread.  Returns the
        label the service's series carry.  ``Service.shutdown()`` calls
        :meth:`detach_service`, so a long-lived plane observing a
        churn of short-lived services neither pins them in memory nor
        keeps scraping corpses."""
        with self._lock:
            # the default-name read of _services happens under the same
            # lock as the append: two services attaching concurrently
            # must not mint one label (CHK002)
            name = name or getattr(service, "name", None) or (
                f"service{len(self._services)}"
            )
            collector = _service_collector(self.registry, name, service)
            self._services.append((name, service))
            self._service_collectors[id(service)] = collector
        self.add_collector(collector)
        return name

    def detach_service(self, service) -> None:
        """Stop observing ``service``: take one final stats sample
        (counters freeze at their true final values), then drop its
        collector, health entry, and the plane's reference to it —
        the service can be garbage-collected.  Idempotent."""
        with self._lock:
            collector = self._service_collectors.pop(id(service), None)
        if collector is not None:
            try:
                collector()        # final sample, best-effort
            except Exception:
                with self._lock:
                    self._errors += 1
        with self._lock:
            self._services = [
                (n, s) for n, s in self._services if s is not service
            ]
            if collector is not None:
                try:
                    self._collectors.remove(collector)
                except ValueError:
                    pass

    def observe_request(self, service: str, outcome: str,
                        latency_s: float,
                        ttfw_s: Optional[float] = None) -> None:
        """Push-side request telemetry (called by ``Service._finish``):
        the latency histogram by outcome, plus time-to-first-wave."""
        self.registry.histogram(
            METRIC_PREFIX + "serve_request_latency_seconds",
            "submit-to-result latency by outcome (log2 buckets)",
            labels=("service", "outcome"),
        ).labels(service=service, outcome=outcome).observe(latency_s)
        if ttfw_s is not None:
            self.registry.histogram(
                METRIC_PREFIX + "serve_time_to_first_wave_seconds",
                "submit-to-first-dispatch latency (log2 buckets)",
                labels=("service",),
            ).labels(service=service).observe(ttfw_s)

    # -- sampler -------------------------------------------------------------

    def start(self) -> None:
        """Start the background sampler (idempotent; no-op when
        ``interval <= 0`` — on-demand sampling only)."""
        if self.interval <= 0:
            return
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="cimba-telemetry", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.sample()

    def sample(self) -> None:
        """One sampler pass: run every collector, refresh the
        heartbeat-age gauges, append one history sample per series.
        Collector exceptions are counted, never propagated — a flaky
        stats source must not kill the sampler."""
        with self._lock:
            collectors = list(self._collectors)
            hb = dict(self._hb)
        for fn in collectors:
            try:
                fn()
            except Exception:
                with self._lock:
                    self._errors += 1
        now = time.monotonic()
        for source, t in hb.items():
            self._hb_gauge.labels(source=source).set(now - t)
        self.heartbeat("sampler")
        self.registry.tick_history(now)

    def close(self) -> None:
        """Stop the sampler thread and close the span log (idempotent).
        Attached services are NOT shut down — the plane observes them,
        it does not own them."""
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        if self.spans is not None:
            self.spans.close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    # -- health / snapshots --------------------------------------------------

    def healthz(self) -> dict:
        """The liveness/saturation verdict behind ``/healthz``:

        * ``unhealthy`` — a service's dispatcher thread is dead, or its
          heartbeat is staler than ``stall_s`` while work is
          outstanding (a live dispatcher beats at least every queue
          poll; chunk ticks keep it fresh through long waves);
        * ``degraded`` — the admission queue is saturated, or the
          program store reports corruption/downgrades (serving still
          works, somebody should look);
        * ``ok`` otherwise.
        """
        checks: Dict[str, Any] = {}
        status = "ok"

        def worse(s):
            nonlocal status
            order = ("ok", "degraded", "unhealthy")
            if order.index(s) > order.index(status):
                status = s

        with self._lock:
            services = list(self._services)
        for name, svc in services:
            c: Dict[str, Any] = {}
            thread = getattr(svc, "_thread", None)
            alive = bool(thread is not None and thread.is_alive())
            c["dispatcher_alive"] = alive
            age = self.heartbeat_age(f"serve.{name}.dispatch")
            chunk_age = self.heartbeat_age(f"serve.{name}.chunk")
            age = min(age, chunk_age)
            c["heartbeat_age_s"] = None if math.isinf(age) else round(
                age, 3
            )
            try:
                st = svc.stats()
            except Exception as e:
                c["stats_error"] = repr(e)
                worse("unhealthy")
                checks[name] = c
                continue
            outstanding = st.get("outstanding", 0)
            stalled = (
                outstanding > 0 and age > self.stall_s
            )
            c["stalled"] = stalled
            if not alive or stalled:
                worse("unhealthy")
            depth = st.get("queue_depth", 0)
            cap = st.get("queue_capacity")
            c["queue_depth"] = depth
            c["queue_capacity"] = cap
            saturated = cap is not None and depth >= cap
            c["queue_saturated"] = saturated
            if saturated:
                worse("degraded")
            store = st.get("program_store")
            if store is not None:
                flags = store.get("flags") or {}
                c["store_flags"] = flags
                if any(flags.values()):
                    worse("degraded")
            # determinism audit (docs/18_audit.md): a result digest
            # that failed its expectation means the fleet is no longer
            # bitwise-reproducible — serving still works, but somebody
            # must look before citing any run card
            mism = st.get("digest_mismatches", 0)
            c["digest_mismatches"] = mism
            if mism:
                worse("degraded")
            checks[name] = c
        # extra contributors (add_healthz): each returns a check dict
        # with a "status" that folds into the verdict — the fleet
        # router's slice rollup reports through here
        with self._lock:
            hooks = list(self._healthz_hooks.items())
        extra: Dict[str, Any] = {}
        for hname, fn in hooks:
            try:
                c = dict(fn())
            except Exception as e:
                c = {"status": "unhealthy", "error": repr(e)}
            s = c.get("status", "ok")
            worse(s if s in ("ok", "degraded", "unhealthy")
                  else "unhealthy")
            extra[hname] = c
        with self._lock:
            thread = self._thread
            errors = self._errors
        out = {
            "status": status,
            "ok": status != "unhealthy",
            "services": checks,
            "sampler_alive": thread is not None and thread.is_alive(),
            "collector_errors": errors,
        }
        if extra:
            out["checks"] = extra
        return out

    def varz(self) -> dict:
        """The full JSON snapshot behind ``/varz``: every registry
        family with history rings, raw ``stats()`` of every attached
        service, span counters, heartbeats."""
        with self._lock:
            services = list(self._services)
            hb = dict(self._hb)
        now = time.monotonic()
        out: Dict[str, Any] = {
            "metrics": self.registry.collect(),
            "heartbeat_age_s": {
                k: round(now - t, 3) for k, t in hb.items()
            },
            "health": self.healthz(),
            # the build/provenance block — the SAME dict run cards
            # record as their env block (docs/18_audit.md), so a
            # scraped process cross-checks against a stored artifact
            "build": build_info(),
        }
        svc_stats = {}
        for name, svc in services:
            try:
                svc_stats[name] = svc.stats()
            except Exception as e:
                svc_stats[name] = {"error": repr(e)}
        out["services"] = svc_stats
        if self.spans is not None:
            out["spans"] = dict(self.spans.counters)
            out["spans"]["open"] = self.spans.open_count()
        return out

    def snapshot(self) -> dict:
        """A compact dict for embedding in reports (the bench JSON's
        per-battery telemetry section): tick counters, heartbeat ages,
        span counters — no history rings."""
        now = time.monotonic()
        with self._lock:
            hb = {k: round(now - t, 3) for k, t in self._hb.items()}
        ticks = {}
        with self.registry._lock:
            fam = self.registry._families.get(
                METRIC_PREFIX + "ticks_total"
            )
            if fam is not None:
                for s in fam._series.values():
                    ticks[s.label_values[0]] = int(s.value)
        out: Dict[str, Any] = {
            "heartbeat_age_s": hb, "ticks": ticks,
        }
        if self.spans is not None:
            out["spans"] = dict(self.spans.counters)
            out["spans"]["open"] = self.spans.open_count()
        return out


def _service_collector(registry: Registry, name: str, service):
    """The collector :meth:`Telemetry.attach_service` registers: map one
    atomic ``Service.stats()`` snapshot into registry families.  Keeps a
    previous sample to derive per-second outcome rates (deadline-miss /
    retry / cancel) as gauges alongside the raw cumulative counters."""
    P = METRIC_PREFIX
    lab = {"service": name}
    req_counters = (
        "submitted", "admitted", "rejected", "throttled", "completed",
        "failed", "cancelled", "deadline_exceeded",
    )
    raw_counters = (
        "retries", "batches", "waves", "lanes_dispatched", "lanes_padded",
        "digest_mismatches",
    )
    rate_keys = ("completed", "cancelled", "deadline_exceeded",
                 "retries", "throttled")
    prev = {"t": None, "vals": {}, "qos": {}}

    def collect():
        st = service.stats()
        now = time.monotonic()
        for k in req_counters:
            registry.counter(
                P + f"serve_requests_{k}_total",
                f"requests {k.replace('_', ' ')}", labels=("service",),
            ).labels(**lab).set_total(st[k])
        for k in raw_counters:
            registry.counter(
                P + f"serve_{k}_total", k.replace("_", " "),
                labels=("service",),
            ).labels(**lab).set_total(st[k])
        registry.gauge(
            P + "serve_queue_depth", "admitted requests waiting",
            labels=("service",),
        ).labels(**lab).set(st["queue_depth"])
        registry.gauge(
            P + "serve_queue_depth_hwm", "queue depth high-water mark",
            labels=("service",),
        ).labels(**lab).set(st["queue_depth_hwm"])
        cap = st.get("queue_capacity")
        if cap is not None:
            registry.gauge(
                P + "serve_queue_capacity", "admission queue capacity",
                labels=("service",),
            ).labels(**lab).set(cap)
        registry.gauge(
            P + "serve_outstanding", "admitted, not yet delivered",
            labels=("service",),
        ).labels(**lab).set(st["outstanding"])
        by_class = registry.gauge(
            P + "serve_queue_depth_class",
            "queued requests per compatibility class",
            labels=("service", "klass"),
        )
        for klass, depth in st.get("queue_depth_by_class", {}).items():
            by_class.labels(service=name, klass=klass).set(depth)
        occ = st.get("lane_occupancy", {})
        registry.gauge(
            P + "serve_padding_waste_ratio",
            "padded lanes / all dispatched lanes",
            labels=("service",),
        ).labels(**lab).set(occ.get("padding_waste_frac", 0.0))
        # the LIVE per-chunk occupancy view (docs/22_refill.md): how
        # full the in-flight wave is right now / on average over the
        # recent boundary window — decay (and refill) in real time,
        # not the pack-time snapshot
        registry.gauge(
            P + "serve_lane_occupancy_now",
            "live lanes / wave lanes at the latest chunk boundary",
            labels=("service",),
        ).labels(**lab).set(occ.get("occupancy_now", 0.0))
        registry.gauge(
            P + "serve_lane_occupancy_mean",
            "mean live-lane occupancy over recent chunk boundaries",
            labels=("service",),
        ).labels(**lab).set(occ.get("occupancy_mean", 0.0))
        ref = st.get("refill")
        if ref:
            registry.gauge(
                P + "serve_refill_enabled",
                "continuous wave refill active (docs/22_refill.md)",
                labels=("service",),
            ).labels(**lab).set(1.0 if ref.get("enabled") else 0.0)
            # the refill wave's free-lane pool RIGHT NOW — the fleet
            # router's capacity-placement signal (docs/23): admission
            # headroom, where queue depth is only backlog
            registry.gauge(
                P + "serve_free_lanes",
                "free lanes in the in-flight refill wave",
                labels=("service",),
            ).labels(**lab).set(ref.get("free_lanes", 0))
            for k in ("refill_boundaries", "refill_admissions",
                      "refill_retirements", "lanes_refilled",
                      "lanes_reclaimed", "mid_wave_deliveries"):
                if k in ref:
                    registry.counter(
                        P + f"serve_{k}_total",
                        k.replace("_", " "), labels=("service",),
                    ).labels(**lab).set_total(ref[k])
        ds = st.get("device_sched")
        if ds:
            registry.gauge(
                P + "serve_device_sched_enabled",
                "preemptive device scheduler active "
                "(docs/24_device_scheduler.md)",
                labels=("service",),
            ).labels(**lab).set(1.0 if ds.get("enabled") else 0.0)
            registry.gauge(
                P + "serve_waves_live",
                "concurrent RUNNING waves on the device right now",
                labels=("service",),
            ).labels(**lab).set(ds.get("waves_live", 0))
            # the admission headroom in BYTES — the memory-side twin
            # of serve_free_lanes for capacity-aware placement
            free = ds.get("est_free_mem_bytes")
            if free is not None:
                registry.gauge(
                    P + "serve_est_free_device_mem_bytes",
                    "estimated free device memory under the "
                    "admission budget",
                    labels=("service",),
                ).labels(**lab).set(free)
            for k in ("preemptions", "evictions", "restores",
                      "sched_waves_started", "mem_rejects"):
                if k in ds:
                    registry.counter(
                        P + f"serve_{k}_total",
                        k.replace("_", " "), labels=("service",),
                    ).labels(**lab).set_total(ds[k])
        qs = st.get("qos")
        if qs:
            registry.gauge(
                P + "serve_qos_enabled",
                "multi-tenant QoS plane active (docs/27_qos.md)",
                labels=("service",),
            ).labels(**lab).set(1.0 if qs.get("enabled") else 0.0)
            tenants = qs.get("tenants", {})
            held = qs.get("lanes_held", {})
            held_g = registry.gauge(
                P + "serve_qos_lanes_held",
                "lanes a tenant holds in flight against its quota",
                labels=("service", "tenant"),
            )
            goodput_g = registry.gauge(
                P + "serve_qos_goodput_ratio",
                "completed / submitted per tenant",
                labels=("service", "tenant"),
            )
            p99_g = registry.gauge(
                P + "serve_qos_latency_p99_seconds",
                "p99 completed-request latency per tenant over the "
                "recent window",
                labels=("service", "tenant"),
            )
            for tname, tc in tenants.items():
                tlab = {"service": name, "tenant": tname}
                for k in ("submitted", "admitted", "throttled",
                          "throttled_rate", "throttled_quota",
                          "completed", "deadline_exceeded",
                          "claims", "lanes_claimed"):
                    if k in tc:
                        registry.counter(
                            P + f"serve_qos_{k}_total",
                            f"per-tenant requests {k.replace('_', ' ')}"
                            " (docs/27_qos.md)",
                            labels=("service", "tenant"),
                        ).labels(**tlab).set_total(tc[k])
                # every tenant ever seen reports, zeros included — the
                # held gauge must drop to 0 when a tenant drains, and
                # goodput is completed/submitted (the fairness signal
                # a flooded victim's dashboard watches)
                held_g.labels(**tlab).set(held.get(tname, 0))
                sub = tc.get("submitted", 0)
                goodput_g.labels(**tlab).set(
                    tc.get("completed", 0) / sub if sub else 0.0
                )
                p99_g.labels(**tlab).set(tc.get("latency_p99_s", 0.0))
        registry.gauge(
            P + "serve_classes_seen", "distinct compatibility classes",
            labels=("service",),
        ).labels(**lab).set(st.get("classes_seen", 0))
        cache = st.get("program_cache")
        if cache:
            for k in ("hits", "misses", "evictions"):
                registry.counter(
                    P + f"program_cache_{k}_total", f"program cache {k}",
                    labels=("service",),
                ).labels(**lab).set_total(cache[k])
            for k in ("size", "capacity"):
                registry.gauge(
                    P + f"program_cache_{k}", f"program cache {k}",
                    labels=("service",),
                ).labels(**lab).set(cache[k])
        store = st.get("program_store")
        if store:
            for k in ("saves", "hits", "misses", "invalidated",
                      "corrupt", "downgrades", "fallback_shapes",
                      "artifact_dispatches"):
                if k in store:
                    registry.counter(
                        P + f"program_store_{k}_total",
                        f"program store {k}", labels=("service",),
                    ).labels(**lab).set_total(store[k])
        # per-second outcome rates from the sampler's own cadence
        t_prev, vals_prev = prev["t"], prev["vals"]
        vals_now = {k: st[k] for k in rate_keys}
        # per-tenant outcome rates (docs/27_qos.md): throttle and
        # completion velocity per tenant — the live view of a flood
        # being absorbed (cumulative counters only show it in slope)
        qos_now = {}
        if qs:
            for tname, tc in qs.get("tenants", {}).items():
                for k in ("completed", "throttled"):
                    qos_now[(tname, k)] = tc.get(k, 0)
        if t_prev is not None and now > t_prev:
            dt = now - t_prev
            for k in rate_keys:
                registry.gauge(
                    P + f"serve_{k}_per_second",
                    f"{k.replace('_', ' ')} rate over the last sample "
                    "interval",
                    labels=("service",),
                ).labels(**lab).set(
                    max(vals_now[k] - vals_prev.get(k, 0), 0) / dt
                )
            for (tname, k), v in qos_now.items():
                registry.gauge(
                    P + f"serve_qos_{k}_per_second",
                    f"per-tenant {k} rate over the last sample "
                    "interval (docs/27_qos.md)",
                    labels=("service", "tenant"),
                ).labels(service=name, tenant=tname).set(
                    max(v - prev["qos"].get((tname, k), 0), 0) / dt
                )
        prev["t"], prev["vals"], prev["qos"] = now, vals_now, qos_now

    return collect
