"""Synthetic load generators for the experiment service (torch port of
:mod:`cimba_tpu.serve.client`, the port's own copy).

What serving is measured by is the distribution of latencies under
concurrent load: N client threads submitting requests against the
bounded queue, open-loop (arrivals on a fixed schedule, whatever the
completions) or as a burst.  This module drives ``examples/serve_mm1.py``
and the serve phases of ``chip_smoke.py``: host-side threading only,
no torch.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

from cimba_tpu_torch.serve.sched import RetryAfter


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) — dependency-free and
    exact on the small sample counts a load run produces."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    k = max(0, min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1)))))
    return s[k]


@dataclass
class LoadReport:
    """What a load run measured.  ``latencies_s`` is submit→result wall
    time per COMPLETED request; structured failures are counted by
    class, never silently dropped."""

    n_requests: int
    n_completed: int
    wall_s: float
    total_replications: int
    latencies_s: List[float] = field(default_factory=list)
    errors: dict = field(default_factory=dict)
    results: list = field(default_factory=list)
    #: submit→result latency keyed by request index (completed only) —
    #: what lets a mixed-template run attribute latency per template
    latency_by_index: dict = field(default_factory=dict)
    #: request index -> template name, set by :func:`run_mixed_load`
    template_names: Optional[List[str]] = None
    #: request index -> tenant id (None = default), set by
    #: :func:`run_load` from the requests' own ``tenant`` fields
    tenant_names: Optional[List[str]] = None
    #: structured RetryAfter throttles observed at submit, by tenant
    #: (docs/27_qos.md) — every sleep-and-retry counts, so the flood
    #: pressure a QoS policy absorbed is visible, not hidden by retries
    throttles_by_tenant: dict = field(default_factory=dict)

    @property
    def replications_per_sec(self) -> float:
        return self.total_replications / self.wall_s if self.wall_s else 0.0

    def latency_percentiles(self) -> dict:
        return {
            "p50_s": percentile(self.latencies_s, 50),
            "p95_s": percentile(self.latencies_s, 95),
            "p99_s": percentile(self.latencies_s, 99),
            "max_s": max(self.latencies_s) if self.latencies_s else
            float("nan"),
        }

    def summary(self) -> dict:
        out = {
            "requests": self.n_requests,
            "completed": self.n_completed,
            "wall_s": self.wall_s,
            "replications_per_sec": self.replications_per_sec,
            "errors": dict(self.errors),
        }
        if self.throttles_by_tenant:
            out["throttles"] = sum(self.throttles_by_tenant.values())
        out.update(self.latency_percentiles())
        return out

    def per_template(self) -> dict:
        """Latency percentiles grouped by template name (requires the
        run to have come through :func:`run_mixed_load`, which records
        ``template_names``): ``{name: {count, completed, p50_s, p95_s,
        p99_s, max_s}}`` — the per-template tail is where a packing
        policy's fairness shows (a starved template's p99 diverges
        while the aggregate looks fine)."""
        if self.template_names is None:
            raise ValueError(
                "per_template() needs template_names — drive the load "
                "with run_mixed_load(), not run_load()"
            )
        groups: dict = {}
        for i, name in enumerate(self.template_names):
            g = groups.setdefault(
                name, {"count": 0, "completed": 0, "lat": []}
            )
            g["count"] += 1
            if i in self.latency_by_index:
                g["completed"] += 1
                g["lat"].append(self.latency_by_index[i])
        out = {}
        for name, g in groups.items():
            lat = g["lat"]
            out[name] = {
                "count": g["count"],
                "completed": g["completed"],
                "p50_s": percentile(lat, 50),
                "p95_s": percentile(lat, 95),
                "p99_s": percentile(lat, 99),
                "max_s": max(lat) if lat else float("nan"),
            }
        return out

    def per_tenant(self) -> dict:
        """Latency percentiles, goodput, and throttle counts grouped
        by tenant (docs/27_qos.md): ``{tenant: {count, completed,
        goodput, throttled, p50_s, p95_s, p99_s, max_s}}``.  The
        per-tenant tail is the QoS claim itself — under a flooding
        tenant, the victims' p99/goodput here is what the fair-share
        scheduler protects (the aggregate hides it)."""
        if self.tenant_names is None:
            raise ValueError(
                "per_tenant() needs tenant_names — drive the load "
                "with run_load()/run_mixed_load()"
            )
        groups: dict = {}
        for i, name in enumerate(self.tenant_names):
            g = groups.setdefault(
                name or "default", {"count": 0, "completed": 0, "lat": []}
            )
            g["count"] += 1
            if i in self.latency_by_index:
                g["completed"] += 1
                g["lat"].append(self.latency_by_index[i])
        out = {}
        for name, g in groups.items():
            lat = g["lat"]
            out[name] = {
                "count": g["count"],
                "completed": g["completed"],
                "goodput": (
                    g["completed"] / g["count"] if g["count"] else 0.0
                ),
                "throttled": self.throttles_by_tenant.get(name, 0),
                "p50_s": percentile(lat, 50),
                "p95_s": percentile(lat, 95),
                "p99_s": percentile(lat, 99),
                "max_s": max(lat) if lat else float("nan"),
            }
        return out


def run_load(
    service,
    requests: Sequence[Any],
    *,
    n_clients: int = 1,
    inter_arrival_s: float = 0.0,
    submit_block: bool = True,
    submit_timeout: Optional[float] = None,
    result_timeout: Optional[float] = None,
    on_result: Optional[Callable] = None,
    max_retry_after: int = 8,
) -> LoadReport:
    """Drive ``service`` with ``requests`` from ``n_clients`` threads.

    Open-loop: request i's arrival time is ``t0 + i * inter_arrival_s``
    regardless of completions (``inter_arrival_s=0`` is a burst).
    Clients pull the next scheduled arrival off a shared cursor, sleep
    until its time, submit, and immediately move on — a second pass
    collects every future, so slow results never throttle arrivals.
    Admission rejects (``QueueFull``) and structured failures are
    counted per error class in the report.  A structured
    :class:`~cimba_tpu_torch.serve.sched.RetryAfter` throttle is HONORED
    (docs/27_qos.md): the client sleeps exactly the server's
    ``delay_s`` and resubmits, up to ``max_retry_after`` times per
    request before counting it as an error — every throttle is tallied
    per tenant in ``throttles_by_tenant``.  ``results`` keeps completed
    ``(index, StreamResult)`` pairs in arrival order for correctness
    checks (``on_result(i, res)`` streams them instead when holding all
    results would be too much)."""
    t0 = time.perf_counter()
    cursor = [0]
    lock = threading.Lock()
    handles: List[Optional[tuple]] = [None] * len(requests)
    errors: dict = {}
    throttles: dict = {}

    def client():
        while True:
            with lock:
                i = cursor[0]
                if i >= len(requests):
                    return
                cursor[0] += 1
            due = t0 + i * inter_arrival_s
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            sub_t = time.perf_counter()
            sub_mono = time.monotonic()
            attempts = 0
            while True:
                try:
                    h = service.submit(
                        requests[i], block=submit_block,
                        timeout=submit_timeout,
                    )
                except RetryAfter as e:
                    with lock:
                        throttles[e.tenant] = (
                            throttles.get(e.tenant, 0) + 1
                        )
                    attempts += 1
                    if attempts > max_retry_after:
                        with lock:
                            errors["RetryAfter"] = (
                                errors.get("RetryAfter", 0) + 1
                            )
                        break
                    time.sleep(e.delay_s)
                    continue
                except Exception as e:
                    with lock:
                        errors[type(e).__name__] = (
                            errors.get(type(e).__name__, 0) + 1
                        )
                    break
                handles[i] = (sub_t, sub_mono, h)
                break

    threads = [
        threading.Thread(target=client, daemon=True)
        for _ in range(max(1, n_clients))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    latencies: List[float] = []
    latency_by_index: dict = {}
    results: list = []
    n_completed = 0
    total_reps = 0
    for i, rec in enumerate(handles):
        if rec is None:
            continue
        sub_t, sub_mono, h = rec
        try:
            res = h.result(timeout=result_timeout)
        except Exception as e:
            errors[type(e).__name__] = errors.get(type(e).__name__, 0) + 1
            continue
        # DELIVERY latency, not collection latency: the dispatcher's
        # monotonic finish stamp against this request's monotonic
        # submit stamp.  The sequential collection pass here can reach
        # a long-resolved future arbitrarily late (e.g. while other
        # client threads sit in RetryAfter sleeps) — the wall-clock
        # fallback only covers handles without the stamp.
        ft = getattr(h, "finish_t", None)
        lat = (
            ft - sub_mono if ft is not None
            else time.perf_counter() - sub_t
        )
        latencies.append(lat)
        latency_by_index[i] = lat
        n_completed += 1
        total_reps += int(requests[i].n_replications)
        if on_result is not None:
            on_result(i, res)
        else:
            results.append((i, res))
    return LoadReport(
        n_requests=len(requests),
        n_completed=n_completed,
        wall_s=time.perf_counter() - t0,
        total_replications=total_reps,
        latencies_s=latencies,
        errors=errors,
        results=results,
        latency_by_index=latency_by_index,
        tenant_names=[
            getattr(r, "tenant", None) for r in requests
        ],
        throttles_by_tenant=throttles,
    )


# -- mixed-template traffic (the heterogeneous-packing load shape) -----------


@dataclass(frozen=True)
class RequestTemplate:
    """One request archetype in a traffic mix: a prototype ``Request``
    (spec variant x params x R x seed x horizon — whatever the
    workload's shape is) plus its relative ``weight`` in the arrival
    stream.  :func:`mixed_requests` interleaves templates
    proportionally; each instance is a ``dataclasses.replace`` clone
    labelled ``{name}#{i}``.  ``tenant`` (docs/27_qos.md) stamps every
    instance with a tenant id — how an adversarial mix puts a flooding
    tenant and its victims through one service."""

    name: str
    request: Any
    weight: float = 1.0
    tenant: Optional[str] = None


def mixed_requests(
    templates: Sequence[RequestTemplate], n_requests: int,
) -> tuple:
    """A deterministic weighted interleaving of ``n_requests`` request
    instances over ``templates`` (smooth weighted round-robin: each
    step picks the template with the largest accumulated credit, so a
    1:1:2 mix arrives interleaved — the shape that exercises wave
    packing — rather than in runs).  Returns ``(requests, names)``
    aligned by index."""
    import dataclasses

    if not templates:
        raise ValueError("mixed_requests needs at least one template")
    for t in templates:
        if not t.weight > 0:
            raise ValueError(
                f"template {t.name!r} weight must be positive, got "
                f"{t.weight}"
            )
    credit = [0.0] * len(templates)
    counts = [0] * len(templates)
    requests, names = [], []
    for _ in range(int(n_requests)):
        for j, t in enumerate(templates):
            credit[j] += t.weight
        j = max(range(len(templates)), key=lambda k: credit[k])
        credit[j] -= sum(t.weight for t in templates)
        t = templates[j]
        kw = {"label": f"{t.name}#{counts[j]}"}
        if t.tenant is not None:
            kw["tenant"] = t.tenant
        requests.append(dataclasses.replace(t.request, **kw))
        names.append(t.name)
        counts[j] += 1
    return requests, names


def run_mixed_load(
    service,
    templates: Sequence[RequestTemplate],
    n_requests: int,
    **run_load_kwargs,
) -> LoadReport:
    """Drive ``service`` with a weighted MIX of request templates (the
    heterogeneous-traffic load shape of docs/14_wave_packing.md) and
    report per-template latency percentiles on top of the aggregate:
    the returned report's :meth:`LoadReport.per_template` groups
    completions by template name (and :meth:`LoadReport.per_tenant` by
    tenant id when templates carry tenants — the QoS fairness view).
    Occupancy/padding live in
    ``service.stats()`` (``batch_occupancy``, ``lane_occupancy``) —
    the bench ``serve_mixed`` arm reads both."""
    requests, names = mixed_requests(templates, n_requests)
    report = run_load(service, requests, **run_load_kwargs)
    report.template_names = names
    return report
