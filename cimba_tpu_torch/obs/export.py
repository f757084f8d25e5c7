"""Exporters: flight-recorder rings as Chrome-trace / Perfetto JSON
(torch port of :mod:`cimba_tpu.obs.export`).

The document follows the Trace Event Format (``chrome://tracing`` and
Perfetto): a ``traceEvents`` list of instant events, one a recorded
dispatch, with ``pid`` the lane and ``tid`` the event's subject, so the
viewer shows replications as processes and simulated processes as
threads.  Names come from the spec (the tables of
:mod:`cimba_tpu_torch.utils.debug`).  ``ts`` is in microseconds and one
simulated time unit is exported as one second (``ts = t * 1e6``).
"""

from __future__ import annotations

import json

from cimba_tpu_torch.obs import metrics as _metrics
from cimba_tpu_torch.obs import trace as _trace
from cimba_tpu_torch.utils.debug import kind_name as _kind_name
from cimba_tpu_torch.utils.debug import lane as _lane
from cimba_tpu_torch.utils.debug import subj_name as _subj_name

#: top-level keys every export carries (the smoke check validates these)
REQUIRED_KEYS = ("traceEvents", "displayTimeUnit", "otherData")

#: microseconds a simulated time unit in the exported ``ts``
TS_SCALE = 1e6


def chrome_trace(sims, spec=None) -> dict:
    """The Chrome-trace dict of a lane-first Sim: every lane's ring one
    trace-viewer process.  Raises if the Sim carries no ring (the
    recorder was off at ``init_sim``)."""
    if sims.trace is None:
        raise ValueError(
            "chrome_trace: Sim carries no flight-recorder ring — call "
            "obs.trace.enable() before init_sim/run")
    events = []
    total = 0
    for r in range(sims.clock.shape[0]):
        sim = _lane(sims, r)
        # the JSON pid is the LANE (unique), not sim.rep: lanes may share
        # a replication id; rep goes into the process_name metadata
        rep = int(sim.rep)
        ring = _trace.unwrap(sim.trace)
        total += len(ring["seq"])
        seen_tids = {}
        for t, pid, kind, arg, seq in zip(ring["t"], ring["pid"],
                                          ring["kind"], ring["arg"],
                                          ring["seq"]):
            pid, kind = int(pid), int(kind)
            events.append({
                "name": f"{_kind_name(kind, spec)} "
                        f"{_subj_name(pid, kind, spec)}",
                "ph": "i", "s": "t", "ts": float(t) * TS_SCALE,
                "pid": r, "tid": pid,
                "args": {"kind": kind, "arg": int(arg), "seq": int(seq)},
            })
            seen_tids.setdefault(pid, _subj_name(pid, kind, spec))
        # metadata rows name the tracks (Trace Event Format "M" events)
        events.append({"name": "process_name", "ph": "M", "pid": r,
                       "args": {"name": f"replication {rep}"}})
        for tid, name in sorted(seen_tids.items()):
            events.append({"name": "thread_name", "ph": "M", "pid": r,
                           "tid": tid, "args": {"name": name}})
    other = {
        "model": spec.name if spec is not None else "?",
        "recorded_events": total,
        "ts_unit": "1 simulated time unit = 1 s",
    }
    if getattr(sims, "metrics", None) is not None:
        other["metrics"] = _metrics.snapshot(_metrics.pool(sims.metrics),
                                             spec)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def dump_chrome_trace(path: str, sims, spec=None) -> dict:
    """Export to ``path`` (JSON); returns the dict that was written."""
    doc = chrome_trace(sims, spec)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def dump_service_trace(path: str, service) -> dict:
    """Export a ``serve.Service``'s request-lifecycle trace (one complete
    span a request and the queue-depth counter tracks, the schema of
    :func:`chrome_trace`, the service's stats in ``otherData.service``)
    to ``path`` after validating it; returns the dict written (parity:
    ``cimba_tpu.obs.export.dump_service_trace``)."""
    doc = service.chrome_trace()
    validate_chrome_trace(doc)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def validate_chrome_trace(doc: dict) -> None:
    """Structural check: the required top-level keys, some events, each
    event's required fields, and monotone timestamps within a
    replication (dispatch order is time order)."""
    for k in REQUIRED_KEYS:
        if k not in doc:
            raise ValueError(f"chrome trace missing top-level key {k!r}")
    evs = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
    if not evs:
        raise ValueError("chrome trace has no events")
    last_ts: dict = {}
    for e in evs:
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in e:
                raise ValueError(f"trace event missing {k!r}: {e}")
        if e["ts"] < last_ts.get(e["pid"], float("-inf")):
            raise ValueError(
                f"timestamps not monotone within replication {e['pid']}")
        last_ts[e["pid"]] = e["ts"]
