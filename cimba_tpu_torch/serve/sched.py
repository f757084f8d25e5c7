"""Admission control, deadlines, retries: the serving layer's queue
(torch port of :mod:`cimba_tpu.serve.sched`, the port's own copy).

Request *admission* is decoupled from program *execution* behind a
bounded priority queue.  Everything here is host-side threading, with no
torch, so the scheduling policy is testable without a device.

* :class:`AdmissionQueue`: a bounded priority queue with blocking
  backpressure (``put(block=True)`` waits for space; ``block=False``
  raises :class:`QueueFull`, the admission reject), a delayed-retry heap
  (:meth:`requeue` with a backoff delay keeps the entry out of the ready
  set until its retry time, so a failing request backs off without
  stalling the dispatcher), and a :meth:`take` scan the service fills
  waves with.
* :class:`Backoff`: deterministic exponential backoff (no jitter).
* The structured errors: :class:`DeadlineExceeded`, :class:`Cancelled`,
  :class:`QueueFull`, :class:`ServiceClosed`, :class:`RetriesExhausted`,
  :class:`MemoryBudgetExceeded`, :class:`RetryAfter`, all subclasses of
  :class:`ServeError`.  Nothing in the port raises the last two yet:
  they belong to the device scheduler (``serve/device.py``) and the QoS
  plane (``qos/``), which are not ported.

Ordering: higher ``priority`` pops first; ties break FIFO by admission
sequence number (a total order, so the pack scan is deterministic).
"""

from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple


class ServeError(Exception):
    """Base class of every structured serving error."""


class QueueFull(ServeError):
    """Admission rejected: the bounded queue is at capacity (and the
    caller declined to block, or its backpressure timeout expired)."""

    def __init__(self, capacity: int, label: Optional[str] = None):
        self.capacity = capacity
        self.label = label
        super().__init__(
            f"admission queue full (capacity {capacity})"
            + (f" — request {label!r} rejected" if label else "")
        )


class ServiceClosed(ServeError):
    """Submitted to a service that is draining or shut down."""


class Cancelled(ServeError):
    """The request was cancelled before it was dispatched."""

    def __init__(self, label: Optional[str] = None):
        self.label = label
        super().__init__(f"request {label!r} cancelled" if label else
                         "request cancelled")


class DeadlineExceeded(ServeError):
    """The request's deadline expired while it was still queued (or
    between dispatches of a multi-wave request).  Carries the deadline
    and the time actually waited — structured, not a string to parse."""

    def __init__(
        self, deadline_s: float, waited_s: float,
        label: Optional[str] = None,
    ):
        self.deadline_s = deadline_s
        self.waited_s = waited_s
        self.label = label
        super().__init__(
            f"deadline of {deadline_s:.3f}s exceeded after waiting "
            f"{waited_s:.3f}s"
            + (f" (request {label!r})" if label else "")
        )


class RetriesExhausted(ServeError):
    """Dispatch kept failing past the retry budget; the last failure is
    chained as ``__cause__``."""

    def __init__(self, attempts: int, label: Optional[str] = None):
        self.attempts = attempts
        self.label = label
        super().__init__(
            f"dispatch failed after {attempts} attempt(s)"
            + (f" (request {label!r})" if label else "")
        )


class MemoryBudgetExceeded(ServeError):
    """The request's wave could NEVER be admitted: its estimated device
    footprint (programs + lane buffers at the quantized wave shape)
    exceeds the device scheduler's whole memory budget on its own
    (docs/24_device_scheduler.md).  Structured backpressure — carries
    the estimate and the budget so a client can resize (smaller
    ``wave_size``) or route elsewhere, never a wrong program or a
    silent OOM.  A request that merely doesn't fit *right now* (budget
    held by live waves) is not an error: it waits, or preempts a
    lower-priority wave."""

    def __init__(
        self, needed_bytes: int, budget_bytes: int,
        label: Optional[str] = None,
    ):
        self.needed_bytes = int(needed_bytes)
        self.budget_bytes = int(budget_bytes)
        self.label = label
        super().__init__(
            f"estimated wave footprint {self.needed_bytes} B exceeds "
            f"the device memory budget {self.budget_bytes} B"
            + (f" (request {label!r})" if label else "")
        )


class RetryAfter(ServeError):
    """Admission throttled by the tenant's QoS policy (docs/27_qos.md):
    the tenant's token bucket is empty or its lane quota is saturated.
    Unlike bare :class:`QueueFull` this is *structured* backpressure —
    it names the tenant, the reason (``"rate"`` | ``"quota"``), and a
    concrete ``delay_s`` after which a retry can succeed, so a client
    can sleep exactly that long instead of guessing.  Other tenants'
    admission is untouched; the request was never admitted (nothing to
    cancel, no lanes held)."""

    def __init__(
        self, delay_s: float, tenant: str, reason: str = "rate",
        label: Optional[str] = None,
    ):
        self.delay_s = float(delay_s)
        self.tenant = str(tenant)
        self.reason = str(reason)
        self.label = label
        super().__init__(
            f"tenant {tenant!r} throttled ({reason}): retry after "
            f"{self.delay_s:.3f}s"
            + (f" (request {label!r})" if label else "")
        )


@dataclass(frozen=True)
class Backoff:
    """Deterministic exponential backoff: retry k (1-based) waits
    ``min(base * factor**(k-1), cap)`` seconds."""

    base: float = 0.05
    factor: float = 2.0
    cap: float = 2.0

    def delay(self, attempt: int) -> float:
        return min(self.base * self.factor ** max(attempt - 1, 0), self.cap)


@dataclass
class _Delayed:
    """Heap record for a backoff-delayed entry."""

    ready_at: float
    seq: int
    entry: Any = field(compare=False)

    def __lt__(self, other):  # heapq ordering
        return (self.ready_at, self.seq) < (other.ready_at, other.seq)


class AdmissionQueue:
    """Bounded priority queue + delayed-retry heap under one lock.

    Entries are opaque to the queue except for the attributes the
    service sets: ``priority`` (higher pops first), ``seq`` (FIFO
    tiebreak), and ``cls`` (the compatibility class, read only by the
    :meth:`class_depths` introspection) — the queue never inspects
    anything else; the pack policy lives in the service's :meth:`take`
    predicate.
    """


    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"queue capacity must be positive: {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._ready = threading.Condition(self._lock)
        self._heap: List[Tuple[Tuple[int, int], Any]] = []
        self._delayed: List[_Delayed] = []
        self._closed = False
        self.depth_hwm = 0

    # -- introspection -------------------------------------------------------

    def __len__(self):
        with self._lock:
            return len(self._heap) + len(self._delayed)

    def depth(self) -> int:
        return len(self)

    def class_depths(self) -> dict:
        """Queued entries (ready + backoff-delayed) per compatibility
        class — the ``cls`` attribute the service stamps on entries.
        Feeds ``Service.stats()['queue_depth_by_class']`` and the
        per-class Chrome-trace counter tracks, so a class starving
        behind another's traffic is visible.  Entries without a ``cls``
        (the queue stays generic) group under ``None``.  O(depth) scan
        under the lock: the queue is bounded by ``capacity``."""
        with self._lock:
            return self._class_depths_locked()

    def _class_depths_locked(self) -> dict:
        out: dict = {}
        for _, e in self._heap:
            c = getattr(e, "cls", None)
            out[c] = out.get(c, 0) + 1
        for d in self._delayed:
            c = getattr(d.entry, "cls", None)
            out[c] = out.get(c, 0) + 1
        return out

    def snapshot(self) -> dict:
        """``{"depth", "depth_hwm", "capacity", "by_class"}`` read under
        ONE lock acquisition — the atomic view ``Service.stats()`` (and
        the telemetry scraper behind ``/metrics``) reports, so a scrape
        landing mid-dispatch can never see a total depth that
        contradicts its own per-class breakdown (``depth`` is always
        exactly ``sum(by_class.values())``; the torn-read audit of
        docs/17_telemetry.md)."""
        with self._lock:
            by_class = self._class_depths_locked()
            return {
                "depth": len(self._heap) + len(self._delayed),
                "depth_hwm": self.depth_hwm,
                "capacity": self.capacity,
                "by_class": by_class,
            }

    # -- admission -----------------------------------------------------------

    def put(
        self, entry, *, block: bool = True,
        timeout: Optional[float] = None,
    ) -> None:
        """Admit ``entry``; blocks for space when full (backpressure)
        unless ``block=False``/timeout expiry, which raise
        :class:`QueueFull`."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while len(self._heap) + len(self._delayed) >= self.capacity:
                if self._closed:
                    raise ServiceClosed("service is shutting down")
                if not block:
                    raise QueueFull(
                        self.capacity, getattr(entry, "label", None)
                    )
                remaining = (
                    None if deadline is None
                    else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise QueueFull(
                        self.capacity, getattr(entry, "label", None)
                    )
                self._not_full.wait(remaining)
            if self._closed:
                raise ServiceClosed("service is shutting down")
            self._push(entry)
            self._ready.notify()

    def _push(self, entry) -> None:
        heapq.heappush(self._heap, ((-entry.priority, entry.seq), entry))
        self.depth_hwm = max(
            self.depth_hwm, len(self._heap) + len(self._delayed)
        )

    def requeue(self, entry, *, delay: float = 0.0) -> None:
        """Return an entry to the queue (a multi-wave request between
        waves, or a failed dispatch backing off ``delay`` seconds).
        Bypasses the capacity check: the entry was already admitted —
        bouncing it on a full queue would lose it."""
        with self._lock:
            if delay > 0:
                heapq.heappush(
                    self._delayed,
                    _Delayed(time.monotonic() + delay, entry.seq, entry),
                )
                # the high-water mark tracks DEPTH (ready + delayed);
                # a backoff-delayed entry raises depth exactly like a
                # ready one, so it must ratchet the mark the same way
                # _push does — stats() would otherwise report a depth
                # above its own recorded maximum
                self.depth_hwm = max(
                    self.depth_hwm,
                    len(self._heap) + len(self._delayed),
                )
            else:
                self._push(entry)
            self._ready.notify()

    # -- the dispatcher side --------------------------------------------------

    def _mature(self, now: float) -> None:
        """Move backoff-delayed entries whose time has come into the
        ready heap (caller holds the lock).

        Deadline override: an entry whose DEADLINE expired while it was
        serving its backoff delay matures immediately, ready_at or not —
        the dispatcher then fails it with ``DeadlineExceeded`` (waited
        time included) at the next dispatch boundary instead of holding
        the already-dead request through the rest of its backoff and
        burning a retry on it.  The scan is O(delayed) only when some
        entry actually carries a deadline; the delay heap is small by
        construction (failed requests, not the queue)."""
        while self._delayed and self._delayed[0].ready_at <= now:
            d = heapq.heappop(self._delayed)
            self._push(d.entry)
        if self._delayed and any(
            getattr(d.entry, "deadline_at", None) is not None
            for d in self._delayed
        ):
            keep = []
            matured = False
            for d in self._delayed:
                dl = getattr(d.entry, "deadline_at", None)
                if dl is not None and dl <= now:
                    self._push(d.entry)
                    matured = True
                else:
                    keep.append(d)
            if matured:
                self._delayed = keep
                heapq.heapify(self._delayed)

    def pop_ready(self, timeout: Optional[float] = None):
        """Pop the highest-priority ready entry, waiting up to
        ``timeout`` (and at most until the earliest delayed entry
        matures).  Returns None on timeout or close-with-empty."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                now = time.monotonic()
                self._mature(now)
                if self._heap:
                    entry = heapq.heappop(self._heap)[1]
                    self._not_full.notify()
                    return entry
                if self._closed and not self._delayed:
                    return None
                waits = []
                if deadline is not None:
                    if deadline - now <= 0:
                        return None
                    waits.append(deadline - now)
                if self._delayed:
                    waits.append(
                        max(self._delayed[0].ready_at - now, 0.0)
                    )
                    # wake for the earliest DEADLINE among delayed
                    # entries too: a deadline expiring mid-backoff
                    # matures the entry (see _mature), and an untimed
                    # pop must not sleep through that
                    dls = [
                        dl for d in self._delayed
                        if (dl := getattr(d.entry, "deadline_at", None))
                        is not None
                    ]
                    if dls:
                        waits.append(max(min(dls) - now, 0.0))
                self._ready.wait(min(waits) if waits else None)

    def take(self, want: Callable[[Any], bool]) -> List[Any]:
        """Remove and return every queued READY entry for which
        ``want(entry)`` is true, scanning in priority order — the
        service's wave-fill hook (``want`` closes over the lead
        request's compatibility key and the remaining lane budget; it
        must be cheap and must not touch the queue).  Backoff-delayed
        entries are not offered: they are serving their delay."""
        with self._lock:
            self._mature(time.monotonic())
            taken, kept = [], []
            for key, entry in sorted(self._heap):
                if want(entry):
                    taken.append(entry)
                else:
                    kept.append((key, entry))
            if taken:
                self._heap = kept
                heapq.heapify(self._heap)
                self._not_full.notify_all()
            return taken

    def take_selected(
        self, selector: Callable[[List[Any]], List[Any]],
    ) -> List[Any]:
        """Offer the WHOLE ready set (priority order) to ``selector``
        and remove exactly the entries it returns — the QoS wave-fill
        hook (docs/27_qos.md).  Where :meth:`take` commits to each
        entry with a single-pass predicate, a weighted-fair policy
        needs to see every candidate before choosing any (a flooding
        tenant's older requests must not pre-empt the scan); the
        selector runs under the queue lock, so it must be cheap, pure
        over its argument, and must not touch the queue.  Returns the
        selected entries in the selector's order.  Backoff-delayed
        entries are not offered: they are serving their delay."""
        with self._lock:
            self._mature(time.monotonic())
            offered = [entry for _, entry in sorted(self._heap)]
            taken = selector(offered)
            if taken:
                chosen = {id(e) for e in taken}
                self._heap = [
                    (key, entry) for key, entry in self._heap
                    if id(entry) not in chosen
                ]
                heapq.heapify(self._heap)
                self._not_full.notify_all()
            return taken

    # -- shutdown ------------------------------------------------------------

    def close(self) -> List[Any]:
        """Refuse further ``put``s.  Returns nothing; entries already
        queued stay queued (drain semantics — the dispatcher keeps
        popping until empty)."""
        with self._lock:
            self._closed = True
            self._ready.notify_all()
            self._not_full.notify_all()
            return []

    def drain_now(self) -> List[Any]:
        """Remove and return EVERY queued entry (ready and delayed) —
        the non-graceful shutdown path; the service fails them."""
        with self._lock:
            entries = [e for _, e in self._heap]
            entries += [d.entry for d in self._delayed]
            self._heap.clear()
            self._delayed.clear()
            self._not_full.notify_all()
            return entries

    def kick(self) -> None:
        """Wake a blocked ``pop_ready`` (state changed elsewhere)."""
        with self._lock:
            self._ready.notify_all()
