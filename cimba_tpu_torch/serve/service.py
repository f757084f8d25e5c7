"""The experiment service: many clients multiplexed onto shared waves
(torch port of :mod:`cimba_tpu.serve.service`).

* **One dispatcher thread owns the device.**  It builds every wave, runs
  every init, chunk (on the card one K1 launch a chunk, through
  ``core.loop.make_chunk``), liveness readback, refill splice and fold on
  the service's device; client threads only enqueue and wait on futures.
  On the card it enters ``torch.cuda.device`` itself (the current device
  is a thread's), and its work goes to the device's default stream, so a
  client reading a result it handed over is ordered after the fold.
* **Compatibility-class packing.**  Requests of one class (the program
  class of ``serve.cache.program_class_key``, the parameter rows'
  signature and the horizon bucket) pack into one wave of one program;
  seed, parameter values, R, priority, horizon and chunk budget are lane
  data (or do not change trajectories), so requests differing in them
  pack.  A partly filled wave is padded to a power-of-two shape with dead
  lanes (``t_stop=-inf``, the lead's parameter row), which dispatch no
  event and join no fold.
* **Bitwise isolation.**  Lanes are independent, so a request packed
  with strangers gets the result of its direct ``run_experiment_stream``
  call at the same ``wave_size``: its slots are that call's wave
  partition, each slot's lanes fold through the same fold
  (``runner.experiment._fold``) in ``lo`` order, from the same zeros.

Around the dispatcher: a bounded admission queue with backpressure,
deadlines checked at dispatch boundaries, cancellation (queued yes, in
flight no, except under refill), and retries with exponential backoff
for transient dispatch failures (a ValueError or TypeError fails its
request at once).  ``refill=True`` retires lanes at chunk boundaries and
splices queued requests into them (``core.loop.make_refill``);
``fuse=True`` packs shape-compatible distinct specs into one fused wave
(``core.fuse``), whose K1 on the card is the generated instance of the
merged block table.

Not ported, each raising and naming its module: the preemptive device
scheduler (``device_sched``, ``serve/device.py``), the QoS plane
(``qos``, ``tenants``, ``qos/``), the telemetry plane (``telemetry``,
``obs/telemetry.py``) and tuned schedules (``tune/``: ``chunk_steps=None``
is 1024 and ``fuse_max_specs=None`` is 4, the reference's untuned
defaults).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

from cimba_tpu_torch.serve import cache as _pcache
from cimba_tpu_torch.serve.sched import (AdmissionQueue, Backoff, Cancelled,
                                         DeadlineExceeded, QueueFull,
                                         RetriesExhausted, ServeError,
                                         ServiceClosed)

__all__ = [
    "Request", "ResultHandle", "Service",
    "request_class_key", "horizon_bucket_of",
    "ServeError", "QueueFull", "ServiceClosed", "Cancelled",
    "DeadlineExceeded", "RetriesExhausted", "Backoff",
]

#: ``chunk_steps=None``: the reference's untuned default (``tune/`` is not
#: ported)
DEFAULT_CHUNK_STEPS = 1024
#: ``fuse_max_specs=None``: the reference's untuned default
#: (``cimba_tpu.tune.space.DEFAULT_FUSE_MAX_SPECS``)
DEFAULT_FUSE_MAX_SPECS = 4

_NOT_PORTED = {
    "device_sched": "the preemptive device scheduler (serve/device.py)",
    "qos": "the multi-tenant QoS plane (qos/)",
    "tenants": "the multi-tenant QoS plane (qos/)",
    "telemetry": "the telemetry plane (obs/telemetry.py)",
}


def _refuse(name: str, how: str = "=") -> None:
    raise NotImplementedError(f"Service({name}{how}): {_NOT_PORTED[name]} "
                              "is not ported to cimba_tpu_torch yet")


def _default_summary_path():
    from cimba_tpu_torch.runner import experiment as ex

    return ex.default_summary_path


def horizon_bucket_of(t_end, horizon_bucket) -> object:
    """The horizon bucket of ``t_end`` (parity:
    ``cimba_tpu.serve.service.horizon_bucket_of``): ``"inf"`` for no
    horizon, ``"nonpos"`` for ``t_end <= 0``, ``"finite"`` for every
    finite horizon when ``horizon_bucket`` is None, else
    ``floor(log(t_end) / log(horizon_bucket))``.  Truncation is exact
    whoever shares the wave; the bucket bounds how much longer than its
    own horizon a request's wave may run."""
    if t_end is None:
        return "inf"
    t = float(t_end)
    if not t > 0.0:
        return "nonpos"
    if horizon_bucket is None:
        return "finite"
    import math

    return math.floor(math.log(t) / math.log(horizon_bucket))


def request_class_key(request, with_metrics: bool, *, mesh,
                      horizon_bucket) -> tuple:
    """What may share a wave (parity: ``cimba_tpu.serve.service.
    request_class_key``): the program class (``serve.cache.
    program_class_key``, ``mesh`` the run's mesh), the parameter rows'
    signature and the horizon bucket."""
    return (_pcache.program_class_key(request.spec, with_metrics, mesh=mesh),
            _pcache._params_sig(request.params, request.n_replications),
            horizon_bucket_of(request.t_end, horizon_bucket))


def fusion_class_key(request, with_metrics: bool, *, cache, mesh,
                     horizon_bucket) -> tuple:
    """What may share a fused wave (parity: ``cimba_tpu.serve.service.
    fusion_class_key``): ``core.fuse.fusion_shape_key`` (the spec's
    geometry without its identity), one lane's Sim structure, the
    parameter rows' signature, the profile and observability flags, the
    mesh and the horizon bucket.  Raises ``core.fuse.FusionError`` for a
    spec that cannot fuse."""
    from cimba_tpu_torch import config
    from cimba_tpu_torch.core import fuse
    from cimba_tpu_torch.obs import trace as obs_trace

    return (fuse.fusion_shape_key(request.spec),
            _pcache.sim_structure_sig(cache, request.spec, request.params,
                                      request.n_replications, with_metrics,
                                      mesh=mesh),
            _pcache._params_sig(request.params, request.n_replications),
            config.active_profile(), bool(with_metrics), obs_trace.enabled(),
            mesh, horizon_bucket_of(request.t_end, horizon_bucket))


@dataclass
class Request:
    """One experiment request (parity: ``cimba_tpu.serve.Request``): the
    arguments of a direct ``runner.experiment.run_experiment_stream``
    call, plus serving policy (priority, deadline, label).

    ``wave_size=None`` is the service's ``max_wave``; the effective wave
    size is the request's slot partition, and its result is bitwise the
    direct call's at that ``wave_size``.  ``deadline`` is seconds from
    submission, checked at every dispatch boundary (work already on the
    device is never interrupted).  ``expect_digest``: the
    ``obs.audit.stream_result_digest`` the result should have; a mismatch
    counts ``digest_mismatches`` and the result is delivered all the
    same.  ``chunk_steps=None`` is 1024.  ``pack`` (the reference's packed
    XLA carry, a TPU-only lever) is accepted and changes nothing.  The
    reference's ``trace_context`` (telemetry) and ``tenant`` (QoS) wait
    with their modules."""

    spec: Any
    params: Any
    n_replications: int
    seed: int = 0
    t_end: Optional[float] = None
    pack: Optional[bool] = None
    chunk_steps: Optional[int] = None
    wave_size: Optional[int] = None
    summary_path: Optional[Callable] = None
    priority: int = 0
    deadline: Optional[float] = None
    label: Optional[str] = None
    expect_digest: Optional[str] = None

    def __post_init__(self):
        if self.summary_path is None:
            self.summary_path = _default_summary_path()


def _broadcast_row(row, n: int):
    """A one-lane parameter row (leaves ``[1, ...]``) as ``n`` rows."""
    from cimba_tpu_torch import tree

    return tree.map(lambda x: x.expand((n,) + tuple(x.shape[1:])).clone(),
                    row)


class _Entry:
    """The dispatcher's state of one request (what the queue holds)."""

    __slots__ = (
        "request", "seq", "priority", "label", "cls", "eff_wave",
        "with_metrics", "next_lo", "acc", "n_waves", "retries", "solo",
        "cancelled", "in_flight", "submit_t", "first_dispatch_t",
        "deadline_at", "done", "result", "exc", "result_digest",
        "finish_t", "fuse_cls", "spec_fp",
    )

    def __init__(self, request, seq, cls, eff_wave, with_metrics):
        self.request = request
        self.seq = seq
        self.priority = request.priority
        self.label = request.label
        self.cls = cls
        self.eff_wave = eff_wave
        self.with_metrics = with_metrics
        self.next_lo = 0
        self.acc = None
        self.n_waves = 0
        self.retries = 0
        self.solo = False          # excluded from packing (retry isolation)
        self.cancelled = False
        self.in_flight = False
        self.submit_t = time.monotonic()
        self.first_dispatch_t = None
        self.deadline_at = (None if request.deadline is None
                            else self.submit_t + request.deadline)
        self.done = threading.Event()
        self.result = None
        self.exc = None
        self.result_digest = None
        self.finish_t = None
        # wave fusion: the fusion class and the spec's fingerprint, both
        # None unless fusion is on, the spec can fuse and its roster took it
        self.fuse_cls = None
        self.spec_fp = None


class ResultHandle:
    """The future :meth:`Service.submit` returns."""

    def __init__(self, service: "Service", entry: _Entry):
        self._service = service
        self._entry = entry

    @property
    def label(self) -> Optional[str]:
        return self._entry.label

    def done(self) -> bool:
        return self._entry.done.is_set()

    @property
    def finish_t(self) -> Optional[float]:
        """The ``time.monotonic()`` stamp of the request's retirement
        (None while in flight): a load generator's delivery latency."""
        return self._entry.finish_t

    def cancel(self) -> bool:
        """Cancel if still undispatched (under refill, also in flight: the
        lanes are freed at the next chunk boundary); False once it cannot
        be."""
        return self._service._cancel(self._entry)

    def exception(self, timeout: Optional[float] = None):
        if not self._entry.done.wait(timeout):
            raise TimeoutError(f"request {self._entry.label or self._entry.seq}"
                               f" not done within {timeout}s")
        return self._entry.exc

    def result(self, timeout: Optional[float] = None):
        """The request's ``StreamResult`` (raises its serving error)."""
        exc = self.exception(timeout)
        if exc is not None:
            raise exc
        return self._entry.result

    def digest(self, timeout: Optional[float] = None) -> str:
        """The result's ``obs.audit.stream_result_digest``: the direct
        ``run_experiment_stream`` call's, whoever shared the wave."""
        res = self.result(timeout)
        if self._entry.result_digest is None:
            from cimba_tpu_torch.obs import audit

            self._entry.result_digest = audit.stream_result_digest(res)
        return self._entry.result_digest


#: outcomes recorded in stats and trace spans
_OUTCOMES = ("completed", "failed", "cancelled", "deadline_exceeded")
#: the refill counters, grouped in ``stats()["refill"]``
_REFILL_COUNTERS = ("refill_boundaries", "refill_admissions",
                    "refill_retirements", "lanes_refilled", "lanes_reclaimed",
                    "mid_wave_deliveries")
#: the device scheduler's counters (``stats()["device_sched"]``; always 0:
#: not ported)
_DEVSCHED_COUNTERS = ("preemptions", "evictions", "restores",
                      "sched_waves_started", "mem_rejects")
#: the fusion counters, grouped in ``stats()["fusion"]``
_FUSION_COUNTERS = ("fused_batches", "fused_waves", "fused_lanes",
                    "fusion_rejects")


class _RefillSlot:
    """One request slot in a refill wave: the entry, its replications
    ``[lo, lo + n)`` and the wave lanes it owns (ascending: lane order is
    replication order, so its fold gathers the rows as the direct call's
    contiguous wave has them)."""

    __slots__ = ("entry", "lo", "n", "lanes", "folded")

    def __init__(self, entry, lo, n):
        self.entry = entry
        self.lo = lo
        self.n = n
        self.lanes = []
        self.folded = False


class _RefillWave:
    """One refill wave's bookkeeping: the slots, the free lanes (the pads
    at birth and every retired or killed slot's lanes), the programs, and
    for a fused wave its bundle and the member-fingerprint to spec-id map
    (fixed at birth: a splice never builds anything)."""

    __slots__ = ("cls", "slots", "free", "L", "batch_no", "no_admit",
                 "init_j", "chunk_j", "refill_j", "live_j", "pad_row",
                 "fused", "sid_of")

    def __init__(self, cls, no_admit):
        self.cls = cls
        self.slots = []
        self.free = []
        self.L = 0
        self.batch_no = 0
        self.no_admit = no_admit
        self.init_j = self.chunk_j = self.refill_j = self.live_j = None
        self.pad_row = None
        self.fused = None
        self.sid_of = None


class Service:
    """A thread-based experiment service over one device or mesh (parity:
    ``cimba_tpu.serve.Service``).

    ``max_wave`` bounds the lanes of one wave; ``max_pending`` the
    admission queue (backpressure past it); ``cache`` is the shared
    :class:`~cimba_tpu_torch.serve.cache.ProgramCache` (pass the one of
    direct ``run_experiment_stream`` calls or of ``serve.warm`` to share
    built programs); ``max_retries``/``backoff`` govern retries of
    transient dispatch failures; ``on_chunk(n)`` is called after every
    chunk.  ``device`` is the card unless the caller asks for the CPU
    (without a card only ``device="cpu"`` runs: nothing falls back);
    ``mesh`` (``runner.experiment.Mesh``) shards every wave over its
    devices.  Use as a context manager for a graceful shutdown.

    ``pad_waves`` pads a wave to the next power-of-two multiple of the
    mesh's size (at most ``max_wave``) with dead lanes; ``horizon_bucket``
    (a ratio > 1, or None for every finite horizon together) bounds which
    horizons pack.  ``refill`` (None: the ``CIMBA_REFILL`` knob) drives
    each wave chunk by chunk with a boundary controller every
    ``refill_every`` chunks (default ``poll_every``): a request whose
    lanes all died is folded and delivered there, a cancelled or
    deadline-expired request's lanes are freed, and queued compatible
    requests are spliced into free lanes.  ``fuse`` (None: the
    ``CIMBA_WAVE_FUSE`` knob) packs shape-compatible distinct specs into
    one fused wave; each fusion class's roster binds the first
    ``fuse_max_specs`` (default 4) distinct specs it sees, for the
    service's life.

    ``device_sched``, ``qos``, ``tenants`` and ``telemetry`` (and the
    ``CIMBA_DEVICE_SCHED=1``/``CIMBA_QOS=1`` knobs) raise: their modules
    are not ported (nor are their own knobs, ``waves_per_device``,
    ``preempt_quantum``, ``mem_fraction``, ``mem_budget_bytes`` and
    ``qos_clock``, which this constructor does not take)."""

    def __init__(self, *, max_wave: int = 4096, max_pending: int = 64,
                 mesh=None, cache=None, max_retries: int = 2,
                 backoff: Backoff = Backoff(), poll_every: int = 4,
                 on_chunk: Optional[Callable] = None, trace_cap: int = 4096,
                 pad_waves: bool = True,
                 horizon_bucket: Optional[float] = 16.0, telemetry=None,
                 refill: Optional[bool] = None,
                 refill_every: Optional[int] = None,
                 fuse: Optional[bool] = None,
                 fuse_max_specs: Optional[int] = None,
                 device_sched: Optional[bool] = None,
                 qos: Optional[bool] = None, tenants=None,
                 name: str = "cimba-serve", device="cuda"):
        from cimba_tpu_torch import config
        from cimba_tpu_torch.runner import experiment as ex

        if telemetry is not None:
            _refuse("telemetry")
        if tenants is not None:
            _refuse("tenants")
        if (bool(device_sched) if device_sched is not None
                else config.env_raw("CIMBA_DEVICE_SCHED") == "1"):
            _refuse("device_sched", "=True")
        if (bool(qos) if qos is not None
                else config.env_raw("CIMBA_QOS") == "1"):
            _refuse("qos", "=True")
        if max_wave <= 0:
            raise ValueError(f"max_wave must be positive: {max_wave}")
        # the device: no card and no device="cpu" raises here, before any
        # dispatcher starts
        self._mesh, self.device = ex._run_mesh(mesh, device)
        self.max_wave = int(max_wave)
        self.name = name
        self.mesh = mesh
        self.poll_every = poll_every
        self.refill = (config.env_raw("CIMBA_REFILL") == "1" if refill is None
                       else bool(refill))
        self.refill_every = max(int(poll_every if refill_every is None
                                    else refill_every), 1)
        self.fuse = (config.env_raw("CIMBA_WAVE_FUSE") == "1" if fuse is None
                     else bool(fuse))
        self._fuse_max_specs = (None if fuse_max_specs is None
                                else int(fuse_max_specs))
        if self._fuse_max_specs is not None and self._fuse_max_specs < 2:
            raise ValueError(f"fuse_max_specs must be >= 2 (a fusion needs "
                             f"two members to exist): {fuse_max_specs}")
        # fusion class -> {spec fingerprint: spec}, insertion-ordered: the
        # first fuse_max_specs distinct specs of a class are its members
        # for the service's life (one superspec, one K1 instance)
        self._fuse_roster: dict = {}
        self.device_sched = False
        self.qos = False
        self.max_retries = int(max_retries)
        self.backoff = backoff
        self.cache = cache if cache is not None else _pcache.ProgramCache()
        self.pad_waves = bool(pad_waves)
        if horizon_bucket is not None and not horizon_bucket > 1.0:
            raise ValueError(f"horizon_bucket must be > 1 (a ratio), got "
                             f"{horizon_bucket}")
        self.horizon_bucket = horizon_bucket
        self._on_chunk = on_chunk
        self._queue = AdmissionQueue(max_pending)
        self._lock = threading.RLock()
        self._drained = threading.Condition(self._lock)
        self._outstanding = 0
        self._seq = 0
        self._closed = False
        self._stop = False
        self._t0 = time.monotonic()
        self._spans = deque(maxlen=trace_cap)
        self._depth_samples = deque(maxlen=trace_cap)
        self._counters = {
            "submitted": 0, "admitted": 0, "rejected": 0, "throttled": 0,
            "retries": 0, "batches": 0, "waves": 0, "lanes_dispatched": 0,
            "lanes_padded": 0, "digest_mismatches": 0,
        }
        for o in (_OUTCOMES + _REFILL_COUNTERS + _DEVSCHED_COUNTERS
                  + _FUSION_COUNTERS):
            self._counters[o] = 0
        # per-chunk occupancy samples (live, lanes): ``live`` a host int at
        # refill boundaries (already synced), a device [L] bool vector on
        # the plain path (no sync on the dispatch path; stats() reads it)
        self._occ_samples = deque(maxlen=256)
        self._free_lanes = 0
        # the plain path's liveness readbacks, by class: service-local, so
        # a warmed service adds no entry to the shared cache
        self._live_cache: dict = {}
        self._occupancy: dict = {}       # requests a wave -> waves
        self._class_ids: dict = {}       # class key -> short label
        self._sched_sources = {"tuned": 0, "default": 0, "override": 0,
                               "off": 0}
        self._schedules: dict = {}
        self._ttfw_sum = 0.0
        self._ttfw_max = 0.0
        self._ttfw_n = 0
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    # -- client surface ------------------------------------------------------

    def submit(self, request: Request, *, block: bool = True,
               timeout: Optional[float] = None) -> ResultHandle:
        """Admit a request; returns its future.  ``block=True`` waits for
        queue space (backpressure); ``block=False`` or a ``timeout``
        expiry raises :class:`QueueFull` and counts a reject.  On the card
        a request with the flight recorder or the metrics registry on
        raises: K1 carries neither (the kernel-path contract)."""
        import dataclasses

        from cimba_tpu_torch.obs import metrics as obs_metrics
        from cimba_tpu_torch.runner import experiment as ex

        R = int(request.n_replications)
        if R <= 0:
            raise ValueError(f"n_replications must be positive, got {R}")
        eff_wave = min(R, self.max_wave if request.wave_size is None
                       else int(request.wave_size))
        if eff_wave <= 0:
            raise ValueError(f"wave_size must be positive, got "
                             f"{request.wave_size}")
        if eff_wave > self.max_wave:
            raise ValueError(f"request wave_size={eff_wave} exceeds the "
                             f"service's max_wave={self.max_wave} — it "
                             "could never be scheduled")
        n_dev = self._mesh.size
        if self.mesh is not None and (R % n_dev or eff_wave % n_dev):
            raise ValueError(f"n_replications={R} and wave_size={eff_wave} "
                             f"must divide evenly over {n_dev} devices")
        ex._refuse_observed(self.device, "serve.Service")
        source = "override"
        if request.chunk_steps is None:
            # a copy: the caller's Request is never changed
            request = dataclasses.replace(request,
                                          chunk_steps=DEFAULT_CHUNK_STEPS)
            source = "default"
        with_metrics = obs_metrics.enabled()
        cls = self._class_key(request, with_metrics)
        fuse_cls = None
        if self.fuse:
            from cimba_tpu_torch.core import fuse as _fuse

            try:
                fuse_cls = fusion_class_key(
                    request, with_metrics, cache=self.cache, mesh=self._mesh,
                    horizon_bucket=self.horizon_bucket)
            except _fuse.FusionError:
                fuse_cls = None
        with self._lock:
            if self._closed:
                raise ServiceClosed("service is draining/shut down — no new "
                                    "requests")
            self._counters["submitted"] += 1
            self._seq += 1
            label = self._class_ids.setdefault(cls,
                                               f"class{len(self._class_ids)}")
            self._sched_sources[source] += 1
            self._schedules[label] = {"source": source,
                                      "chunk_steps": request.chunk_steps}
            entry = _Entry(request, self._seq, cls, eff_wave, with_metrics)
            if self.fuse:
                self._bind_fusion(entry, fuse_cls)
            self._outstanding += 1
        try:
            self._queue.put(entry, block=block, timeout=timeout)
        except (QueueFull, ServiceClosed):
            with self._lock:
                self._outstanding -= 1
                self._counters["rejected"] += 1
                self._drained.notify_all()
            raise
        with self._lock:
            self._counters["admitted"] += 1
        return ResultHandle(self, entry)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request has completed (admission
        stays open).  Returns False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._outstanding > 0:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._drained.wait(remaining)
            return True

    def shutdown(self, wait: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop admitting.  ``wait=True`` drains queued requests first;
        ``wait=False`` cancels everything still queued.  Idempotent."""
        with self._lock:
            self._closed = True
        self._queue.close()
        if wait:
            self.drain(timeout)
        else:
            for entry in self._queue.drain_now():
                self._finish(entry, exc=Cancelled(entry.label),
                             outcome="cancelled")
        with self._lock:
            self._stop = True
        self._queue.kick()
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(wait=True)

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        """The service's counters, with the reference's keys: queue depth
        (its high-water mark, by class), the batch-occupancy histogram
        (requests a wave), lane occupancy (live against padded lanes, and
        the live share at the chunk boundaries sampled), the refill,
        fusion and (zero) device-scheduler groups, time to first wave, and
        the program cache's counters.  One lock acquisition; the plain
        path's device liveness vectors are read after it."""
        with self._lock:
            qs = self._queue.snapshot()
            out = dict(self._counters)
            out["queue_depth"] = qs["depth"]
            out["queue_depth_hwm"] = qs["depth_hwm"]
            out["queue_capacity"] = qs["capacity"]
            out["queue_depth_by_class"] = {
                label: qs["by_class"].get(c, 0)
                for c, label in sorted(self._class_ids.items(),
                                       key=lambda cl: cl[1])}
            out["classes_seen"] = len(self._class_ids)
            out["outstanding"] = self._outstanding
            out["batch_occupancy"] = dict(sorted(self._occupancy.items()))
            live = self._counters["lanes_dispatched"]
            padded = self._counters["lanes_padded"]
            out["lane_occupancy"] = {
                "lanes_live": live, "lanes_padded": padded,
                "padding_waste_frac": (padded / (live + padded)
                                       if live + padded else 0.0)}
            out["refill"] = {"enabled": self.refill}
            for k in _REFILL_COUNTERS:
                out["refill"][k] = self._counters[k]
            out["refill"]["free_lanes"] = self._free_lanes
            out["device_sched"] = {
                "enabled": False, "waves_per_device": None,
                "preempt_quantum": None, "mem_fraction": None,
                "mem_budget_bytes": None, "waves_live": 0,
                "est_free_mem_bytes": None}
            for k in _DEVSCHED_COUNTERS:
                out["device_sched"][k] = self._counters[k]
            out["fusion"] = {
                "enabled": self.fuse, "fuse_max_specs": self._eff_fuse_max(),
                "classes": len(self._fuse_roster),
                "roster_sizes": sorted(len(r)
                                       for r in self._fuse_roster.values())}
            for k in _FUSION_COUNTERS:
                out["fusion"][k] = self._counters[k]
            out["qos"] = {"enabled": False, "tenants": {}, "lanes_held": {},
                          "deficits": {}, "admission_log": []}
            occ_samples = list(self._occ_samples)
            out["time_to_first_wave"] = {
                "count": self._ttfw_n,
                "mean_s": self._ttfw_sum / self._ttfw_n if self._ttfw_n
                else 0.0,
                "max_s": self._ttfw_max}
            out["schedule"] = {"sources": dict(self._sched_sources),
                               "by_class": dict(self._schedules)}
        vals = []
        for v, tot in occ_samples:
            if not isinstance(v, int):
                v = int(v.sum())
            vals.append((v, tot))
        fracs = [lv / t for lv, t in vals if t]
        last_live, last_tot = vals[-1] if vals else (0, 0)
        out["lane_occupancy"].update({
            "lanes_live_now": last_live, "lanes_in_wave": last_tot,
            "occupancy_now": last_live / last_tot if last_tot else 0.0,
            "occupancy_mean": sum(fracs) / len(fracs) if fracs else 0.0,
            "occupancy_samples": len(vals)})
        if hasattr(self.cache, "stats"):
            out["program_cache"] = self.cache.stats()
        return out

    def chrome_trace(self) -> dict:
        """Request lifecycle spans and queue-depth counter tracks (total,
        by class, and each wave's live and padded lanes) as a Chrome-trace
        dict that ``obs.export.validate_chrome_trace`` takes: one complete
        ``X`` span a request on its own pid track, the service's stats in
        ``otherData.service``."""
        with self._lock:
            spans = list(self._spans)
            depths = list(self._depth_samples)
        events, meta = [], []
        for s in spans:
            name = s["label"] or f"request {s['seq']}"
            events.append({
                "name": name, "ph": "X",
                "ts": (s["submit"] - self._t0) * 1e6,
                "dur": max((s["end"] - s["submit"]) * 1e6, 0.0),
                "pid": s["seq"], "tid": 0,
                "args": {"outcome": s["outcome"], "lanes": s["lanes"],
                         "time_to_first_wave_s": s["ttfw"],
                         "retries": s["retries"]}})
            meta.append({"name": "process_name", "ph": "M", "pid": s["seq"],
                         "args": {"name": name}})
        # a live depth sample closes the counter tracks, and gives an idle
        # service's trace one event
        with self._lock:
            closing = self._class_sample()
        depths.append((time.monotonic(), self._queue.depth(), closing, 0, 0))
        for t, d, by_class, live, padded in depths:
            ts = (t - self._t0) * 1e6
            events.append({"name": "queue_depth", "ph": "C", "ts": ts,
                           "pid": 0, "tid": 0, "args": {"depth": d}})
            for label, depth in by_class:
                events.append({"name": f"queue_depth/{label}", "ph": "C",
                               "ts": ts, "pid": 0, "tid": 0,
                               "args": {"depth": depth}})
            if live or padded:
                events.append({"name": "wave_lanes", "ph": "C", "ts": ts,
                               "pid": 0, "tid": 0,
                               "args": {"live": live, "padded": padded}})
        return {"traceEvents": events + meta, "displayTimeUnit": "ms",
                "otherData": {"service": self.stats()}}

    # -- internals -----------------------------------------------------------

    def _wave_shape(self, total: int) -> int:
        """The lanes one wave of ``total`` live lanes runs: the next
        power-of-two multiple of the mesh's size, at most ``max_wave``;
        ``total`` where padding is off or the cap undershoots."""
        if not self.pad_waves or total <= 0:
            return total
        unit = self._mesh.size
        q = unit
        while q < total:
            q *= 2
        q = min(q, self.max_wave)
        if q < total or q % unit:
            return total
        return q

    def _plan_pad(self, slots) -> tuple:
        """``(live lanes, pad lanes)`` of one packed wave: the one
        definition the stats and the dispatch both use."""
        total = sum(n for _, _, n in slots)
        return total, self._wave_shape(total) - total

    def _class_sample(self) -> tuple:
        """Queue depth of every class ever seen (zeros included), the
        caller holding the lock."""
        depths = self._queue.class_depths()
        return tuple((label, depths.get(c, 0))
                     for c, label in self._class_ids.items())

    def _class_key(self, request: Request, with_metrics: bool) -> tuple:
        return request_class_key(request, with_metrics, mesh=self._mesh,
                                 horizon_bucket=self.horizon_bucket)

    def _cancel(self, entry: _Entry) -> bool:
        with self._lock:
            if entry.done.is_set():
                return False
            if entry.in_flight:
                if not self.refill:
                    return False
                # refill: the lanes are freed at the next chunk boundary,
                # where the controller finishes the request with Cancelled
                entry.cancelled = True
                return True
            entry.cancelled = True
        self._finish(entry, exc=Cancelled(entry.label), outcome="cancelled")
        self._queue.kick()
        return True

    def _finish(self, entry: _Entry, *, result=None, exc=None,
                outcome: str) -> None:
        with self._lock:
            if entry.done.is_set():
                return
            entry.result = result
            entry.exc = exc
            now = time.monotonic()
            entry.finish_t = now
            self._counters[outcome] += 1
            ttfw = (None if entry.first_dispatch_t is None
                    else entry.first_dispatch_t - entry.submit_t)
            self._spans.append({
                "seq": entry.seq, "label": entry.label,
                "submit": entry.submit_t, "end": now, "outcome": outcome,
                "lanes": entry.request.n_replications, "ttfw": ttfw,
                "retries": entry.retries})
            if ttfw is not None:
                self._ttfw_sum += ttfw
                self._ttfw_max = max(self._ttfw_max, ttfw)
                self._ttfw_n += 1
            self._outstanding -= 1
            entry.done.set()
            self._drained.notify_all()

    def _eff_fuse_max(self) -> int:
        return (self._fuse_max_specs if self._fuse_max_specs is not None
                else DEFAULT_FUSE_MAX_SPECS)

    def _bind_fusion(self, entry: _Entry, fuse_cls) -> None:
        """Bind an admitted entry to its fusion class: join (or match) the
        class roster, the first ``fuse_max_specs`` distinct specs winning
        for the service's life.  A spec that cannot fuse, or meets a full
        roster, counts a ``fusion_rejects`` and serves through its exact
        class.  The caller holds the lock."""
        if fuse_cls is None:
            self._counters["fusion_rejects"] += 1
            return
        fp = _pcache.spec_fingerprint(entry.request.spec)
        roster = self._fuse_roster.setdefault(fuse_cls, {})
        if fp not in roster:
            if len(roster) >= self._eff_fuse_max():
                self._counters["fusion_rejects"] += 1
                return
            roster[fp] = entry.request.spec
        entry.fuse_cls = fuse_cls
        entry.spec_fp = fp

    def _fused_bundle(self, fuse_cls):
        """The cached FusedSpec of a class's current roster, members in
        ``fusion_order_key`` order (one member set, one superspec); None
        below two members."""
        with self._lock:
            roster = self._fuse_roster.get(fuse_cls)
            specs = () if roster is None else tuple(roster.values())
        if len(specs) < 2:
            return None
        specs = tuple(sorted(specs, key=_pcache.fusion_order_key))
        return _pcache.get_fused(self.cache, specs)

    def _loop(self) -> None:
        import contextlib

        import torch

        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            self._dispatch_loop()

    def _dispatch_loop(self) -> None:
        while True:
            entry = self._queue.pop_ready(timeout=0.25)
            with self._lock:
                stopping = self._stop
                drained = self._closed and self._outstanding == 0
            if entry is None:
                if stopping or drained:
                    # a backoff-delayed retry may still wait in the heap:
                    # cancel it rather than strand its future
                    for e in self._queue.drain_now():
                        if not e.done.is_set():
                            self._finish(e, exc=Cancelled(e.label),
                                         outcome="cancelled")
                    return
                continue
            if stopping:
                if not entry.done.is_set():
                    self._finish(entry, exc=Cancelled(entry.label),
                                 outcome="cancelled")
                continue
            with self._lock:
                if entry.done.is_set():  # a cancelled tombstone
                    continue
                cancelled_flag = entry.cancelled
                if not cancelled_flag:
                    # claimed under the lock: from here cancel() is False
                    entry.in_flight = True
            if cancelled_flag:
                self._finish(entry, exc=Cancelled(entry.label),
                             outcome="cancelled")
                continue
            now = time.monotonic()
            if entry.deadline_at is not None and now > entry.deadline_at:
                self._finish(entry, exc=DeadlineExceeded(
                    entry.request.deadline, now - entry.submit_t,
                    entry.label), outcome="deadline_exceeded")
                continue
            if self.refill:
                self._serve_refill_wave(entry)
                continue
            slots, members, fused = self._pack(entry)
            try:
                # the fold inside the guard too: a fold that raises fails
                # its requests, never the dispatcher (a dead dispatcher
                # would hang every outstanding future)
                sims = (self._run_batch(slots) if fused is None
                        else self._run_batch(slots, fused=fused))
                self._fold_slots(slots, sims)
            except Exception as e:
                self._batch_failed(members, e)
                continue
            self._complete_members(members)

    def _pack(self, lead: _Entry):
        """One wave: the lead's whole slots first, then queued requests of
        its class (or, with fusion, of its fusion class) in priority order,
        whole slots only, within ``max_wave`` lanes.  Returns ``(slots,
        members, fused bundle or None)``."""
        budget = self.max_wave

        def plan(entry) -> list:
            nonlocal budget
            out = []
            lo = entry.next_lo
            R = entry.request.n_replications
            while lo < R:
                n = min(entry.eff_wave, R - lo)
                if n > budget:
                    break
                out.append((lo, n))
                budget -= n
                lo += n
            return out

        slots = [(lead, lo, n) for lo, n in plan(lead)]
        members = [lead]
        planned: list = []
        if budget > 0 and not lead.solo:
            now = time.monotonic()
            dropped: list = []

            def want(e: _Entry) -> bool:
                if e.done.is_set():
                    return True      # a cancelled tombstone: just remove
                if e.deadline_at is not None and now > e.deadline_at:
                    dropped.append(e)
                    return True
                if e.solo:
                    return False
                if e.cls != lead.cls and not (
                        lead.fuse_cls is not None
                        and e.fuse_cls == lead.fuse_cls):
                    return False
                p = plan(e)
                if not p:
                    return False
                planned.append((e, p))
                return True

            self._queue.take(want)
            for e in dropped:
                self._finish(e, exc=DeadlineExceeded(
                    e.request.deadline, now - e.submit_t, e.label),
                    outcome="deadline_exceeded")
        with self._lock:
            for e, p in planned:
                if e.done.is_set():
                    continue
                e.in_flight = True
                members.append(e)
                slots.extend((e, lo, n) for lo, n in p)
            for e in members:
                if e.first_dispatch_t is None:
                    e.first_dispatch_t = time.monotonic()
            total, padded = self._plan_pad(slots)
            self._counters["batches"] += 1
            self._counters["waves"] += len(slots)
            self._counters["lanes_dispatched"] += total
            self._counters["lanes_padded"] += padded
            # fused only where the members span more than one exact class
            needs_fuse = any(m.cls != lead.cls for m in members)
            if needs_fuse:
                self._counters["fused_batches"] += 1
                self._counters["fused_lanes"] += total
            k = len(members)
            self._occupancy[k] = self._occupancy.get(k, 0) + 1
            self._depth_samples.append((time.monotonic(), self._queue.depth(),
                                        self._class_sample(), total, padded))
        fused = self._fused_bundle(lead.fuse_cls) if needs_fuse else None
        return slots, members, fused

    def _check_class(self, lead: _Entry) -> None:
        """The program class froze into the request's class at submit; a
        profile or observability flag changed since raises ValueError
        (the request fails, never runs another class's program)."""
        from cimba_tpu_torch.obs import metrics as obs_metrics

        now = _pcache.program_class_key(lead.request.spec,
                                        obs_metrics.enabled(),
                                        mesh=self._mesh)
        if now != lead.cls[0]:
            raise ValueError(
                "serve: a dispatch-time global (dtype profile or "
                "obs.metrics/obs.trace state) changed between this "
                "request's submit and its dispatch — the compatibility key "
                "binds at submit time; resubmit after settling the globals")

    def _columns(self, parts, sid_of=None, horizon=True):
        """The lane columns of ``parts`` (``(entry, lo, n)``), pads
        excluded: ``(reps, seeds, t_stops or None, sids or None, params
        rows)`` lists, one item a part."""
        import torch

        from cimba_tpu_torch.runner import experiment as ex

        dev = self.device
        reps = [torch.arange(lo, lo + n) for _, lo, n in parts]
        seeds = [ex._seed_column(e.request.seed, n, dev) for e, _, n in parts]
        t_stops = ([ex._horizon_column(e.request.t_end, n, dev)
                    for e, _, n in parts] if horizon else None)
        sids = (None if sid_of is None else
                [torch.full((n,), self._entry_sid(sid_of, e),
                            dtype=torch.int32) for e, _, n in parts])
        pws = [ex._slice_params(e.request.params, e.request.n_replications,
                                lo, n) for e, lo, n in parts]
        return reps, seeds, t_stops, sids, pws

    def _add_pads(self, cols, pad: int, row) -> None:
        """Append ``pad`` dead lanes to ``_columns``' lists: rep 0, seed
        0, ``t_stop=-inf`` (no event is ever dispatched), spec-id 0 and
        the parameter row ``row`` (valid values for ``user_init``)."""
        import torch

        from cimba_tpu_torch import config
        from cimba_tpu_torch.runner import experiment as ex

        reps, seeds, t_stops, sids, pws = cols
        reps.append(torch.zeros(pad, dtype=reps[0].dtype))
        seeds.append(ex._seed_column(0, pad, self.device))
        t_stops.append(torch.full((pad,), float("-inf"), dtype=config.time(),
                                  device=self.device))
        if sids is not None:
            sids.append(torch.zeros(pad, dtype=torch.int32))
        pws.append(_broadcast_row(row, pad))

    @staticmethod
    def _concat(cols):
        """``_columns``' lists as one column each (and one params tree)."""
        import torch

        from cimba_tpu_torch import tree

        def cat(xs):
            if xs is None:
                return None
            return xs[0] if len(xs) == 1 else torch.cat(xs)

        reps, seeds, t_stops, sids, pws = cols
        pw = (pws[0] if len(pws) == 1 else
              tree.map(lambda *xs: torch.cat(xs), *pws))
        return cat(reps), cat(seeds), cat(t_stops), cat(sids), pw

    def _run_batch(self, slots, fused=None):
        """Dispatch one packed wave: init the slots' lanes (each its
        replication, seed, horizon and parameter row) and the dead pads,
        and drive the class's chunk to the end, at the lead's
        ``chunk_steps`` (chunking does not change trajectories).  Returns
        the wave's shards.  ``fused`` runs the fusion class's superspec:
        a spec-id column selects each lane's member at birth, and the
        horizon column is always carried.  The failure-injection seam of
        the retry tests."""
        from cimba_tpu_torch.core.loop import drive_chunks

        lead = slots[0][0]
        req = lead.request
        self._check_class(lead)
        if fused is None:
            init_j, chunk_j = _pcache.get_programs(
                self.cache, req.spec, mesh=self._mesh,
                chunk_steps=req.chunk_steps, with_metrics=lead.with_metrics)
            sid_of = None
        else:
            init_j, chunk_j = _pcache.get_fused_wave_programs(
                self.cache, fused, mesh=self._mesh,
                chunk_steps=req.chunk_steps, with_metrics=lead.with_metrics)
            sid_of = {_pcache.spec_fingerprint(s): k
                      for k, s in enumerate(fused.members)}
        seen: set = set()
        for e, _, n in slots:
            if id(e) not in seen:
                seen.add(id(e))
                self._preflight(e, n)
        total, pad = self._plan_pad(slots)
        # an unpadded wave of horizonless requests carries no t_stop leaf,
        # as the direct stream's; fused waves always carry it
        horizon = not (fused is None and pad == 0 and all(
            e.request.t_end is None for e, _, _ in slots))
        cols = self._columns(slots, sid_of, horizon)
        if pad:
            self._add_pads(cols, pad, self._row0(req))
        reps, seeds, t_stops, sids, pw = self._concat(cols)
        shards = (init_j(reps, seeds, t_stops, pw) if fused is None
                  else init_j(reps, seeds, t_stops, sids, pw))
        live_key = (lead.cls if fused is None else ("fused",) + tuple(
            _pcache.spec_fingerprint(s) for s in fused.members))
        ent = self._live_cache.get(live_key)
        if ent is None:
            from cimba_tpu_torch.runner import experiment as ex

            ent = (ex._live_program(req.spec if fused is None else fused.spec,
                                    self._mesh),
                   req.spec if fused is None else fused)
            self._live_cache[live_key] = ent
        live_j = ent[0]
        every = self.refill_every

        def on_boundary(c, s, _live=live_j, _L=total + pad):
            if c % every == 0:
                self._note_occupancy(_live(s), _L)
            return None

        return drive_chunks(chunk_j, shards, poll_every=self.poll_every,
                            on_chunk=self._on_chunk, on_boundary=on_boundary)

    @staticmethod
    def _row0(req):
        """The request's first parameter row, as the pads' rows."""
        from cimba_tpu_torch.runner import experiment as ex

        return ex._slice_params(req.params, req.n_replications, 0, 1)

    def _preflight(self, e: _Entry, n: int) -> None:
        _pcache.preflight(self.cache, e.request.spec, e.request.summary_path,
                          e.request.params, e.request.n_replications, n,
                          e.with_metrics, self.device)

    def _note_occupancy(self, live, lanes: int) -> None:
        with self._lock:
            self._occ_samples.append((live, lanes))

    # -- continuous wave refill ----------------------------------------------

    def _serve_refill_wave(self, lead: _Entry) -> None:
        """Drive one refill wave to its retirement: pack the lead and
        queued compatible requests (one whole slot each), then run the
        class's chunk with a boundary controller that folds and delivers
        each request the chunk its lanes die, frees the lanes of
        cancelled and deadline-expired requests, and splices queued
        compatible requests into free lanes (``make_refill``)."""
        from cimba_tpu_torch.core.loop import drive_chunks

        wave = None
        try:
            self._check_class(lead)
            wave = self._pack_refill(lead)
            sims = self._init_refill_wave(wave)
            every = self.refill_every

            def on_boundary(n, s):
                if n % every:
                    return None
                return self._refill_boundary(wave, n, s)

            sims = drive_chunks(wave.chunk_j, sims,
                                poll_every=self.poll_every,
                                on_chunk=self._on_chunk,
                                on_boundary=on_boundary)
            # every lane is dead: fold and deliver what retired during the
            # last (unpolled) chunks
            self._refill_boundary(wave, -1, sims, final=True)
        except Exception as e:
            with self._lock:
                self._free_lanes = 0
            members, seen = [], set()
            if wave is not None:
                for s in wave.slots:
                    e2 = s.entry
                    if s.folded or e2.done.is_set() or id(e2) in seen:
                        continue
                    seen.add(id(e2))
                    members.append(e2)
            else:
                members = [lead]
            if not members:
                import warnings

                warnings.warn("serve refill: late wave error after every "
                              f"member delivered ({type(e).__name__}: {e})",
                              RuntimeWarning)
                return
            self._batch_failed(members, e)

    def _refill_slot_size(self, entry: _Entry) -> int:
        """The entry's next whole slot, the direct call's partition."""
        return min(entry.eff_wave,
                   entry.request.n_replications - entry.next_lo)

    @staticmethod
    def _entry_sid(sid_of: dict, entry: _Entry) -> int:
        """The entry's lane spec-id in a fused wave."""
        fp = entry.spec_fp
        if fp is None:
            fp = _pcache.spec_fingerprint(entry.request.spec)
        return sid_of[fp]

    def _claim_compatible(self, cls, budget: int, now: float, *,
                          strict_priority: bool, fuse_cls=None,
                          fuse_members=None) -> list:
        """The queue scan of both refill claims (the initial fill and the
        boundary admission): entries of ``cls`` (or of ``fuse_cls`` whose
        spec is one of ``fuse_members``), one whole slot each, in priority
        order, within ``budget`` lanes; cancelled tombstones dropped and
        deadline-expired entries finished on the way.  With
        ``strict_priority`` the first live entry of another class stops
        the scan, so a long-lived wave cannot starve other classes.
        Returns ``[(entry, n)]``, not yet claimed."""
        planned: list = []
        dropped: list = []
        state = {"budget": int(budget), "blocked": False}

        def compatible(e: _Entry) -> bool:
            if e.cls == cls:
                return True
            if fuse_cls is None or e.fuse_cls != fuse_cls:
                return False
            if fuse_members is None:
                return True
            return e.spec_fp is not None and e.spec_fp in fuse_members

        def want(e: _Entry) -> bool:
            if e.done.is_set():
                return True
            if e.deadline_at is not None and now > e.deadline_at:
                dropped.append(e)
                return True
            if state["blocked"]:
                return False
            if e.solo or not compatible(e) or e.cancelled:
                if strict_priority:
                    state["blocked"] = True
                return False
            n = self._refill_slot_size(e)
            if n > state["budget"]:
                return False
            planned.append((e, n))
            state["budget"] -= n
            return True

        self._queue.take(want)
        for e in dropped:
            self._finish(e, exc=DeadlineExceeded(
                e.request.deadline, now - e.submit_t, e.label),
                outcome="deadline_exceeded")
        return planned

    def _pack_refill(self, lead: _Entry) -> _RefillWave:
        """The refill twin of :meth:`_pack`: the lead's next whole slot
        and queued compatible requests (one whole slot each), and the
        lane ownership table.  With ``pad_waves`` the wave is born at
        ``max_wave`` lanes, its pads free lanes for later admissions; a
        wave is born fused when the lead's fusion class has two members or
        more (its member set fixed at birth)."""
        wave = _RefillWave(lead.cls, bool(lead.solo))
        if not lead.solo and lead.fuse_cls is not None:
            wave.fused = self._fused_bundle(lead.fuse_cls)
            if wave.fused is not None:
                wave.sid_of = {_pcache.spec_fingerprint(s): k
                               for k, s in enumerate(wave.fused.members)}
        budget = self.max_wave - self._refill_slot_size(lead)
        planned: list = []
        if budget > 0 and not lead.solo:
            planned = self._claim_compatible(
                lead.cls, budget, time.monotonic(), strict_priority=False,
                fuse_cls=lead.fuse_cls if wave.fused is not None else None,
                fuse_members=wave.sid_of)
        members = [lead]
        with self._lock:
            slots = [_RefillSlot(lead, lead.next_lo,
                                 self._refill_slot_size(lead))]
            for e, n in planned:
                if e.done.is_set():
                    continue
                e.in_flight = True
                members.append(e)
                slots.append(_RefillSlot(e, e.next_lo, n))
            for e in members:
                if e.first_dispatch_t is None:
                    e.first_dispatch_t = time.monotonic()
            total = sum(s.n for s in slots)
            if self.pad_waves and not wave.no_admit:
                unit = self._mesh.size
                cap = self.max_wave - self.max_wave % unit
                pad = max(cap, total) - total
            elif self.pad_waves:
                pad = self._wave_shape(total) - total
            else:
                pad = 0
            self._counters["batches"] += 1
            wave.batch_no = self._counters["batches"]
            self._counters["waves"] += len(slots)
            self._counters["lanes_dispatched"] += total
            self._counters["lanes_padded"] += pad
            if wave.fused is not None:
                self._counters["fused_waves"] += 1
                self._counters["fused_lanes"] += total
            k = len(members)
            self._occupancy[k] = self._occupancy.get(k, 0) + 1
            self._depth_samples.append((time.monotonic(), self._queue.depth(),
                                        self._class_sample(), total, pad))
        off = 0
        for s in slots:
            s.lanes = list(range(off, off + s.n))
            off += s.n
        wave.slots = slots
        wave.free = list(range(total, total + pad))
        wave.L = total + pad
        with self._lock:
            self._free_lanes = len(wave.free)
        return wave

    def _init_refill_wave(self, wave: _RefillWave):
        """Fetch the wave's programs and init its lanes, as
        :meth:`_run_batch` does but with the ``t_stop`` column always
        carried (``t_end=None`` as ``+inf``): lane death, reclamation and
        splicing are all horizon-driven."""
        lead = wave.slots[0].entry
        req = lead.request
        if wave.fused is None:
            wave.init_j, wave.chunk_j = _pcache.get_programs(
                self.cache, req.spec, mesh=self._mesh,
                chunk_steps=req.chunk_steps, with_metrics=lead.with_metrics)
            wave.refill_j, wave.live_j = _pcache.get_refill_programs(
                self.cache, req.spec, mesh=self._mesh,
                with_metrics=lead.with_metrics)
        else:
            wave.init_j, wave.chunk_j = _pcache.get_fused_wave_programs(
                self.cache, wave.fused, mesh=self._mesh,
                chunk_steps=req.chunk_steps, with_metrics=lead.with_metrics)
            wave.refill_j, wave.live_j = _pcache.get_fused_refill_programs(
                self.cache, wave.fused, mesh=self._mesh,
                with_metrics=lead.with_metrics)
        for s in wave.slots:
            self._preflight(s.entry, s.n)
        wave.pad_row = self._row0(req)
        cols = self._columns([(s.entry, s.lo, s.n) for s in wave.slots],
                             wave.sid_of)
        if wave.free:
            self._add_pads(cols, len(wave.free), wave.pad_row)
        reps, seeds, t_stops, sids, pw = self._concat(cols)
        if wave.fused is None:
            return wave.init_j(reps, seeds, t_stops, pw)
        return wave.init_j(reps, seeds, t_stops, sids, pw)

    def _fold_refill_slot(self, s: _RefillSlot, sims) -> None:
        """Retire one slot: gather its lanes (ascending) and fold them
        through the request's own fold."""
        import torch

        from cimba_tpu_torch.runner import experiment as ex

        e = s.entry
        fold = _pcache.get_fold(self.cache, e.with_metrics,
                                e.request.summary_path)
        sl = _pcache.get_gather(self.cache)(
            sims, torch.as_tensor(s.lanes, dtype=torch.int64))
        if e.acc is None:
            e.acc = ex.stream_acc(e.request.spec, e.with_metrics, self.device)
        e.acc = fold(e.acc, sl)
        e.n_waves += 1
        e.next_lo = s.lo + s.n

    def _refill_boundary(self, wave: _RefillWave, n: int, sims,
                         final: bool = False):
        """The boundary controller: read each lane's liveness (one host
        sync), retire slots whose lanes all died (fold, then deliver or
        requeue the remainder), free the lanes of cancelled and
        deadline-expired requests, and splice queued compatible requests
        into free lanes.  Returns the spliced shards when the wave
        changed, else None."""
        import torch

        from cimba_tpu_torch import config, tree
        from cimba_tpu_torch.runner import experiment as ex

        live = wave.live_j(sims).cpu().numpy()
        with self._lock:
            self._counters["refill_boundaries"] += 1
            self._occ_samples.append((int(live.sum()), wave.L))
        now = time.monotonic()

        # 1) retire: completion wins over a simultaneous cancel/deadline
        for s in wave.slots:
            e = s.entry
            if s.folded or e.done.is_set():
                continue
            if live[s.lanes].any():
                continue
            self._fold_refill_slot(s, sims)
            s.folded = True
            wave.free.extend(s.lanes)
            with self._lock:
                self._counters["refill_retirements"] += 1
                e.in_flight = False
            if e.next_lo >= e.request.n_replications:
                if not final:
                    with self._lock:
                        self._counters["mid_wave_deliveries"] += 1
                self._finish_completed(e)
            elif e.cancelled:
                self._finish(e, exc=Cancelled(e.label), outcome="cancelled")
            else:
                self._queue.requeue(e)

        # 2) reclaim: cancelled / deadline-expired requests' lanes become
        # t_stop=-inf pads
        kills: list = []
        for s in wave.slots:
            e = s.entry
            if s.folded or e.done.is_set():
                continue
            expired = e.deadline_at is not None and now > e.deadline_at
            if not (e.cancelled or expired):
                continue
            s.folded = True  # retired without a fold
            wave.free.extend(s.lanes)
            kills.extend(s.lanes)
            with self._lock:
                e.in_flight = False
                self._counters["lanes_reclaimed"] += s.n
            if e.cancelled:
                self._finish(e, exc=Cancelled(e.label), outcome="cancelled")
            else:
                self._finish(e, exc=DeadlineExceeded(
                    e.request.deadline, now - e.submit_t, e.label),
                    outcome="deadline_exceeded")

        # 3) admit: queued compatible requests into free lanes, the
        # priority-order prefix only (the fairness valve)
        admitted: list = []
        with self._lock:
            stopping = self._stop
        if not final and not stopping and wave.free and not wave.no_admit:
            planned = self._claim_compatible(
                wave.cls, len(wave.free), now, strict_priority=True,
                fuse_cls=(wave.slots[0].entry.fuse_cls
                          if wave.fused is not None else None),
                fuse_members=wave.sid_of)
            free_sorted = sorted(wave.free)
            with self._lock:
                for e, m in planned:
                    if e.done.is_set():
                        continue
                    e.in_flight = True
                    if e.first_dispatch_t is None:
                        e.first_dispatch_t = time.monotonic()
                    s = _RefillSlot(e, e.next_lo, m)
                    s.lanes = free_sorted[:m]
                    free_sorted = free_sorted[m:]
                    wave.slots.append(s)
                    admitted.append(s)
                    self._counters["refill_admissions"] += 1
                    self._counters["lanes_refilled"] += m
                    self._counters["waves"] += 1
                    self._counters["lanes_dispatched"] += m
            wave.free = free_sorted
            for s in admitted:
                self._preflight(s.entry, s.n)

        with self._lock:
            self._free_lanes = 0 if final else len(wave.free)
        if final or (not kills and not admitted):
            return None

        # 4) splice: the masked lanes born afresh (admissions at their
        # rows; reclaimed lanes as -inf pads), every other lane untouched
        L = wave.L
        mask = torch.zeros(L, dtype=torch.bool)
        reps = torch.zeros(L, dtype=torch.int64)
        seeds = torch.zeros(L, dtype=torch.int64)
        ts = torch.full((L,), float("-inf"), dtype=config.time())
        sids = torch.zeros(L, dtype=torch.int32)
        if kills:
            mask[torch.as_tensor(kills, dtype=torch.int64)] = True
        pw = _broadcast_row(wave.pad_row, L)
        for s in admitted:
            e = s.entry
            idx = torch.as_tensor(s.lanes, dtype=torch.int64)
            mask[idx] = True
            reps[idx] = torch.arange(s.lo, s.lo + s.n)
            seeds[idx] = ex._seed_column(e.request.seed, 1, "cpu")[0]
            ts[idx] = ex._horizon_column(e.request.t_end, 1, "cpu")[0]
            if wave.fused is not None:
                sids[idx] = self._entry_sid(wave.sid_of, e)
            rows = ex._slice_params(e.request.params,
                                    e.request.n_replications, s.lo, s.n)
            pw = tree.map(lambda b, r, i=idx: b.index_copy(0, i, r.to(
                b.dtype)), pw, rows)
        if wave.fused is None:
            return wave.refill_j(sims, mask, reps, seeds, ts, pw)
        return wave.refill_j(sims, mask, reps, seeds, ts, sids, pw)

    def _fold_slots(self, slots, sims) -> None:
        """Fold a finished wave slot by slot, in slot order, each through
        its request's own fold (pads sit past the last slot); ``acc`` and
        ``next_lo`` advance together, so a retry after a failure resumes
        at the first unfolded slot."""
        import torch

        from cimba_tpu_torch.runner import experiment as ex

        gather = _pcache.get_gather(self.cache)
        off = 0
        for entry, lo, n in slots:
            fold = _pcache.get_fold(self.cache, entry.with_metrics,
                                    entry.request.summary_path)
            sl = gather(sims, torch.arange(off, off + n))
            if entry.acc is None:
                entry.acc = ex.stream_acc(entry.request.spec,
                                          entry.with_metrics, self.device)
            entry.acc = fold(entry.acc, sl)
            entry.n_waves += 1
            entry.next_lo = lo + n
            off += n

    def _complete_members(self, members) -> None:
        """After a wave's folds: finish the requests that are whole,
        requeue the rest (no user code runs here)."""
        for entry in members:
            with self._lock:
                entry.in_flight = False
            if entry.next_lo >= entry.request.n_replications:
                self._finish_completed(entry)
            else:
                self._queue.requeue(entry)

    def _finish_completed(self, entry: _Entry) -> None:
        """Deliver a whole request's StreamResult (the direct call's
        shape), its digest checked against ``expect_digest`` where the
        request carries one."""
        from cimba_tpu_torch.runner.experiment import StreamResult

        acc = entry.acc
        result = StreamResult(summary=acc[0], n_failed=acc[1],
                              total_events=acc[2], n_waves=entry.n_waves,
                              n_regrows=0,
                              metrics=acc[3] if entry.with_metrics else None)
        expect = entry.request.expect_digest
        if expect is not None:
            from cimba_tpu_torch.obs import audit

            dig = audit.stream_result_digest(result)
            entry.result_digest = dig
            if expect != dig:
                with self._lock:
                    self._counters["digest_mismatches"] += 1
        self._finish(entry, result=result, outcome="completed")

    def _batch_failed(self, members, exc: Exception) -> None:
        """A dispatch or fold failed.  Each member retries alone after an
        exponential backoff (in the delay heap: the dispatcher serves
        others meanwhile).  Only a lone request's failure is charged to
        its budget (a packed failure's blame is unknown); ValueError and
        TypeError are permanent and fail the request at once."""
        permanent = isinstance(exc, (ValueError, TypeError))
        charged = len(members) == 1
        with self._lock:
            stopping = self._stop
        for entry in members:
            with self._lock:
                entry.in_flight = False
            if entry.next_lo >= entry.request.n_replications:
                # its slots all folded before the failure: deliver it
                self._finish_completed(entry)
                continue
            with self._lock:
                entry.solo = True
                if charged:
                    entry.retries += 1
            if permanent:
                self._finish(entry, exc=exc, outcome="failed")
            elif charged and entry.retries > self.max_retries:
                err = RetriesExhausted(entry.retries, entry.label)
                err.__cause__ = exc
                self._finish(entry, exc=err, outcome="failed")
            elif stopping:
                self._finish(entry, exc=Cancelled(entry.label),
                             outcome="cancelled")
            else:
                with self._lock:
                    self._counters["retries"] += 1
                self._queue.requeue(entry, delay=self.backoff.delay(
                    max(entry.retries, 1)))
