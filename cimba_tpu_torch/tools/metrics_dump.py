#!/usr/bin/env python
"""One-shot telemetry dump: the operator's first-contact tool (parity:
the reference's ``tools/metrics_dump.py``, its own copy).

Hit a running exposition endpoint (``--url``) — or spin up an
in-process demo ``Service`` on the CPU (``--demo``) — and pretty-print
the Prometheus metric families plus the ``/healthz`` verdict:

    python -m cimba_tpu_torch.tools.metrics_dump --url http://127.0.0.1:9321
    python -m cimba_tpu_torch.tools.metrics_dump --url http://h:9321 --varz
    python -m cimba_tpu_torch.tools.metrics_dump --demo

With QoS traffic (docs/27_qos.md) the single-url dump adds a
per-tenant table (goodput, throttles, p99 gauge) and fleet mode adds a
per-tenant rollup line summed across slices; both are additive and
never change the exit code.

Fleet mode (docs/20_fleet.md): several ``--url``s, or ``--fleet`` with
a fleet manifest file (``{"slices": [{"name", "url"}, ...]}``, the
reference's ``FleetManager.fleet_manifest()``), prints one PER-SLICE row
(health verdict, queue depth, outstanding, padding waste, store
hits/fallbacks, lane occupancy now/mean, free lanes, refill state —
the capacity plane of docs/23_fleet_observability.md) plus a fleet
rollup (verdict counts, queued/outstanding, refill-enabled slices and
their summed free lanes):

    python -m cimba_tpu_torch.tools.metrics_dump --url http://h:9321 \
        --url http://h:9322
    python -m cimba_tpu_torch.tools.metrics_dump --fleet fleet.json

Exit code: 0 when health is ``ok`` or ``degraded`` (degraded prints a
warning), 1 when ``unhealthy`` or the endpoint is unreachable — in
fleet mode, 1 when ANY slice is unhealthy/unreachable — so the tool
slots straight into a shell health check.

``--url`` and fleet modes are stdlib-only (urllib + the package's
Prometheus parser, :mod:`cimba_tpu_torch.obs.expose`); ``--demo``
imports torch and drives three real requests through a tiny model on
the CPU with the full plane attached — the zero-to-scrape sanity path
when you don't have a service running yet.  See docs/17_telemetry.md.
"""

import argparse
import json
import os
import sys
import urllib.error
import urllib.request

#: the checkout's root, where the package sits
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def _fetch(url: str, timeout: float):
    """(status_code, body_text) — 503 healthz bodies are still read."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def print_families(text: str) -> None:
    """Pretty-print parsed Prometheus families: name, type, series
    sorted by labels; histogram child series (_bucket/_sum/_count)
    group under their parent family's header.  Raises ValueError on
    malformed input — the same minimal parser the round-trip tests
    use, so 'it printed' means 'it parses'."""
    # imported here, not at module level: --version (fleet provenance)
    # must stay light
    from cimba_tpu_torch.obs.expose import parse_prometheus_text

    parsed = parse_prometheus_text(text)
    types, samples = parsed["types"], parsed["samples"]

    def base_of(name):
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in types:
                return name[: -len(suffix)]
        return name

    for name in sorted({base_of(n) for n in samples} | set(types)):
        kind = types.get(name)
        print(f"{name}  [{kind or 'untyped'}]")
        if kind == "histogram":

            def le_order(item):
                lab = dict(item[0])
                le = lab.pop("le", None)
                return (
                    tuple(sorted(lab.items())),
                    float("inf") if le in (None, "+Inf") else float(le),
                )

            for suffix in ("_bucket", "_count", "_sum"):
                for labels, value in sorted(
                    samples.get(name + suffix, {}).items(),
                    key=le_order,
                ):
                    lab = ", ".join(f"{k}={v}" for k, v in labels)
                    print(f"  {suffix[1:]:<8} {{{lab}}} {value:g}")
        else:
            for labels, value in sorted(samples.get(name, {}).items()):
                lab = (
                    "{" + ", ".join(f"{k}={v}" for k, v in labels) + "}"
                    if labels else ""
                )
                print(f"  {lab or '(no labels)':<48} {value:g}")
    print()


def print_tenants(text: str) -> None:
    """The per-tenant QoS table (docs/27_qos.md): one row per
    (service, tenant) with goodput, throttle counts, and the p99
    latency gauge — pulled from the ``cimba_serve_qos_*`` families.
    Prints nothing when the endpoint has no QoS traffic (the table is
    additive; exit codes never depend on it)."""
    from cimba_tpu_torch.obs.expose import parse_prometheus_text

    samples = parse_prometheus_text(text)["samples"]
    rows: dict = {}

    def scan(fname, key):
        for labels, value in samples.get(fname, {}).items():
            lab = dict(labels)
            tenant = lab.get("tenant")
            if tenant is None:
                continue
            rows.setdefault(
                (lab.get("service", ""), tenant), {}
            )[key] = value

    scan("cimba_serve_qos_submitted_total", "submitted")
    scan("cimba_serve_qos_completed_total", "completed")
    scan("cimba_serve_qos_throttled_total", "throttled")
    scan("cimba_serve_qos_goodput_ratio", "goodput")
    scan("cimba_serve_qos_latency_p99_seconds", "p99")
    if not rows:
        return
    cols = (
        ("service", 16), ("tenant", 14), ("submitted", 9),
        ("completed", 9), ("goodput", 7), ("throttl", 7), ("p99_s", 8),
    )
    print("== tenants ==")
    print("  ".join(f"{name:<{w}}" for name, w in cols))
    print("  ".join("-" * w for _, w in cols))
    for (svc, tenant), r in sorted(rows.items()):
        gp = r.get("goodput")
        row = (
            svc[:16], tenant[:14],
            f"{r.get('submitted', 0):g}", f"{r.get('completed', 0):g}",
            "-" if gp is None else f"{gp:.1%}",
            f"{r.get('throttled', 0):g}",
            f"{r.get('p99', 0.0):.3f}",
        )
        print("  ".join(
            f"{v:<{w}}" for v, (_, w) in zip(row, cols)
        ))
    print()


def print_health(body: str, status: int) -> str:
    try:
        h = json.loads(body)
    except json.JSONDecodeError:
        print(f"HEALTH: unparseable body (HTTP {status})")
        return "unhealthy"
    verdict = h.get("status", "unhealthy")
    print(f"HEALTH: {verdict} (HTTP {status})")
    for name, c in (h.get("services") or {}).items():
        flags = ", ".join(
            f"{k}={v}" for k, v in c.items() if k != "store_flags"
        )
        print(f"  service {name}: {flags}")
        if c.get("store_flags"):
            print(f"    store flags: {c['store_flags']}")
    if h.get("collector_errors"):
        print(f"  collector errors: {h['collector_errors']}")
    return verdict


def dump_url(url: str, timeout: float, varz: bool) -> int:
    url = url.rstrip("/")
    try:
        _, metrics_text = _fetch(url + "/metrics", timeout)
        hz_status, hz_body = _fetch(url + "/healthz", timeout)
    except (urllib.error.URLError, OSError) as e:
        print(f"unreachable: {url} ({e})", file=sys.stderr)
        return 1
    print(f"== {url}/metrics ==")
    print_families(metrics_text)
    print_tenants(metrics_text)
    if varz:
        _, vz = _fetch(url + "/varz", timeout)
        print(f"== {url}/varz ==")
        print(json.dumps(json.loads(vz), indent=2))
        print()
    print(f"== {url}/healthz ==")
    verdict = print_health(hz_body, hz_status)
    if verdict == "degraded":
        print("warning: degraded — serving works, somebody should look")
    return 0 if verdict in ("ok", "degraded") else 1


#: the per-slice fields of a fleet row and the families they sum
SLICE_FIELDS = (
    ("queue_depth", "cimba_serve_queue_depth"),
    ("outstanding", "cimba_serve_outstanding"),
    ("padding_waste", "cimba_serve_padding_waste_ratio"),
    ("completed", "cimba_serve_requests_completed_total"),
    ("store_hits", "cimba_program_store_hits_total"),
    ("store_fallback_shapes", "cimba_program_store_fallback_shapes_total"),
    ("occupancy_now", "cimba_serve_lane_occupancy_now"),
    ("occupancy_mean", "cimba_serve_lane_occupancy_mean"),
    ("free_lanes", "cimba_serve_free_lanes"),
    ("refill_enabled", "cimba_serve_refill_enabled"),
    ("refill_admissions", "cimba_serve_refill_admissions_total"),
    ("lanes_refilled", "cimba_serve_lanes_refilled_total"),
    ("waves_live", "cimba_serve_waves_live"),
    ("preemptions", "cimba_serve_preemptions_total"),
    ("restores", "cimba_serve_restores_total"),
    ("est_free_mem", "cimba_serve_est_free_device_mem_bytes"),
)


def scrape_slice(url: str, timeout: float) -> dict:
    """One scrape of one endpoint (the reference's
    ``fleet.health.scrape_slice``, plain HTTP and JSON): the ``/healthz``
    verdict and the placement gauges of ``/metrics``, each family's
    series summed, and the per-tenant QoS rows.  ``reachable`` and
    ``verdict`` are always there; it raises nothing (an unreachable
    endpoint is the signal)."""
    from cimba_tpu_torch.obs.expose import parse_prometheus_text

    base = url.rstrip("/")
    out: dict = {"reachable": False, "verdict": "unreachable"}
    try:
        status, body = _fetch(base + "/healthz", timeout)
        hz = json.loads(body)
        out.update(reachable=True, http_status=status,
                   verdict=hz.get("status", "unhealthy"))
        _, text = _fetch(base + "/metrics", timeout)
        samples = parse_prometheus_text(text)["samples"]
        for field, metric in SLICE_FIELDS:
            fam = samples.get(metric)
            if fam:
                out[field] = sum(fam.values())
        tenants: dict = {}
        for fname, series in samples.items():
            if not fname.startswith("cimba_serve_qos_") \
                    or fname.endswith("_bucket"):
                continue
            for labels, val in series.items():
                tname = dict(labels).get("tenant")
                if tname is None:
                    continue
                row = tenants.setdefault(tname, {})
                row[fname] = row.get(fname, 0.0) + float(val)
        if tenants:
            out["tenants"] = tenants
    except (OSError, ValueError) as e:
        # refused, reset, timed out or unparseable: the slice is gone
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def dump_fleet(slices, timeout: float) -> int:
    """Per-slice health/metrics table + fleet rollup for ``slices`` =
    ``[(name, url), ...]``.  Exit 1 when any slice is unreachable or
    unhealthy (the CI/cron contract)."""
    cols = (
        ("slice", 18), ("verdict", 12), ("queue", 6), ("outst", 6),
        ("waste", 6), ("hits", 6), ("fallbk", 7), ("done", 6),
        ("occ", 6), ("mocc", 6), ("free", 5), ("refill", 6),
        ("wlive", 5), ("preempt", 7), ("restor", 6), ("freeMB", 7),
    )
    print("  ".join(f"{name:<{w}}" for name, w in cols))
    print("  ".join("-" * w for _, w in cols))
    rollup = {"ok": 0, "degraded": 0, "unhealthy": 0, "unreachable": 0}
    depth_total = 0
    outst_total = 0
    free_total = 0
    refill_on = 0
    waves_total = 0
    preempt_total = 0
    tenant_rollup: dict = {}
    bad = 0
    for name, url in slices:
        rep = scrape_slice(url, timeout)
        # the per-tenant QoS rollup (docs/27_qos.md): counters sum
        # across slices — the fleet-wide goodput/throttle view
        for tenant, row in (rep.get("tenants") or {}).items():
            agg = tenant_rollup.setdefault(
                tenant, {"submitted": 0.0, "completed": 0.0,
                         "throttled": 0.0, "p99": 0.0},
            )
            agg["submitted"] += row.get(
                "cimba_serve_qos_submitted_total", 0.0)
            agg["completed"] += row.get(
                "cimba_serve_qos_completed_total", 0.0)
            agg["throttled"] += row.get(
                "cimba_serve_qos_throttled_total", 0.0)
            agg["p99"] = max(agg["p99"], row.get(
                "cimba_serve_qos_latency_p99_seconds", 0.0))
        verdict = rep["verdict"]
        rollup[verdict] = rollup.get(verdict, 0) + 1
        if verdict in ("unhealthy", "unreachable"):
            bad += 1
        depth_total += int(rep.get("queue_depth", 0))
        outst_total += int(rep.get("outstanding", 0))
        if rep.get("refill_enabled"):
            refill_on += 1
            free_total += int(rep.get("free_lanes") or 0)
        waves_total += int(rep.get("waves_live") or 0)
        preempt_total += int(rep.get("preemptions") or 0)

        def fmt(key, pct=False):
            v = rep.get(key)
            if v is None:
                return "-"
            return f"{v:.1%}" if pct else f"{v:g}"

        # estimated free device memory scrapes in bytes; the table
        # shows MiB (a raw byte count wrecks the column layout)
        free_mem = rep.get("est_free_mem")
        row = (
            name[:18], verdict, fmt("queue_depth"), fmt("outstanding"),
            fmt("padding_waste", pct=True), fmt("store_hits"),
            fmt("store_fallback_shapes"), fmt("completed"),
            fmt("occupancy_now", pct=True),
            fmt("occupancy_mean", pct=True),
            fmt("free_lanes"),
            ("on" if rep.get("refill_enabled")
             else "-" if rep.get("refill_enabled") is None else "off"),
            fmt("waves_live"), fmt("preemptions"), fmt("restores"),
            "-" if free_mem is None else f"{free_mem / (1 << 20):.0f}",
        )
        print("  ".join(
            f"{v:<{w}}" for v, (_, w) in zip(row, cols)
        ))
        if rep.get("error"):
            print(f"    ({rep['error']})")
    print()
    print(
        f"fleet: {len(slices)} slice(s) — "
        + ", ".join(f"{k} {v}" for k, v in rollup.items() if v)
        + f"; queued {depth_total}, outstanding {outst_total}"
        + f"; refill on {refill_on}, free lanes {free_total}"
        + f"; waves live {waves_total}, preemptions {preempt_total}"
    )
    for tenant, agg in sorted(tenant_rollup.items()):
        sub = agg["submitted"]
        gp = agg["completed"] / sub if sub else 0.0
        print(
            f"  tenant {tenant}: completed {agg['completed']:g}"
            f"/{sub:g} (goodput {gp:.1%}), "
            f"throttled {agg['throttled']:g}, "
            f"worst p99 {agg['p99']:.3f}s"
        )
    if bad:
        print(f"UNHEALTHY: {bad} slice(s) down or unreachable")
    return 1 if bad else 0


def run_demo(varz: bool) -> int:
    """Spin a tiny in-process Service on the CPU with the full plane
    attached, drive 3 requests, then scrape it over real HTTP (the whole
    path the operator would scrape in production, on an ephemeral
    port)."""
    from cimba_tpu_torch import serve
    from cimba_tpu_torch.core import api
    from cimba_tpu_torch.core import process as cmd
    from cimba_tpu_torch.core.model import Model
    from cimba_tpu_torch.obs import expose as xp
    from cimba_tpu_torch.obs import telemetry as tm
    from cimba_tpu_torch.stats import summary as sm

    m = Model("demo", event_cap=1, guard_cap=2)

    @m.block
    def work(sim, p, sig):
        done = api.clock(sim) > 6.0
        return sim, cmd.select(done, cmd.exit_(),
                               cmd.hold(1.0, next_pc=work.pc))

    m.process("w", entry=work)
    spec = m.build()

    def clock_path(sims):
        return sm.add(sm.empty(sims.clock.shape, sims.clock.device),
                      sims.clock)

    tel = tm.Telemetry(interval=0.05, spans=True)
    with xp.start(tel) as srv:
        with serve.Service(max_wave=16, cache=serve.ProgramCache(),
                           telemetry=tel, device="cpu") as svc:
            for i in range(3):
                svc.submit(serve.Request(
                    spec, (), 4, seed=i + 1, chunk_steps=16,
                    summary_path=clock_path, label=f"demo{i}",
                )).result(120)
            tel.sample()  # one explicit scrape so counters are fresh
            print(f"(demo service on {srv.url})\n")
            rc = dump_url(srv.url, 10.0, varz)
    tel.close()
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="dump a cimba telemetry endpoint: Prometheus "
        "families + health verdict",
    )
    ap.add_argument(
        "--url", action="append", default=None,
        help="exposition endpoint base, e.g. "
        "http://127.0.0.1:9321 (obs.expose.start's .url); repeat for "
        "a fleet table",
    )
    ap.add_argument(
        "--fleet", metavar="FILE",
        help="fleet manifest JSON ({'slices': [{'name','url'},...]} — "
        "FleetManager.fleet_manifest()): per-slice table + rollup",
    )
    ap.add_argument(
        "--demo", action="store_true",
        help="no endpoint? start an in-process demo Service and "
        "scrape that",
    )
    ap.add_argument(
        "--varz", action="store_true",
        help="also dump the full /varz JSON snapshot",
    )
    ap.add_argument(
        "--timeout", type=float, default=10.0,
        help="per-request HTTP timeout, seconds",
    )
    ap.add_argument(
        "--version", action="store_true",
        help="print the cimba_tpu_torch package version (fleet "
        "provenance: pairs with the /varz build block) and exit",
    )
    args = ap.parse_args(argv)
    if args.version:
        # read from the file: no torch import for a version
        with open(os.path.join(ROOT, "cimba_tpu_torch",
                               "__init__.py")) as f:
            for line in f:
                if line.startswith("__version__"):
                    print(line.split("=", 1)[1].strip().strip("\"'"))
                    return 0
        return 1
    urls = args.url or []
    modes = sum((bool(urls), bool(args.fleet), bool(args.demo)))
    if modes != 1:
        ap.error("pass exactly one of --url (repeatable), --fleet, "
                 "or --demo")
    if args.demo:
        return run_demo(args.varz)
    if args.fleet:
        try:
            with open(args.fleet) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"unreadable fleet manifest {args.fleet}: {e}",
                  file=sys.stderr)
            return 1
        slices = [
            (s.get("name") or s["url"], s["url"])
            for s in manifest.get("slices", [])
        ]
        if not slices:
            print(f"{args.fleet}: no slices in manifest",
                  file=sys.stderr)
            return 1
        return dump_fleet(slices, args.timeout)
    if len(urls) > 1:
        from urllib.parse import urlsplit

        # label rows by host:port — full URLs truncate into
        # indistinguishable prefixes, defeating the table's purpose
        return dump_fleet(
            [(urlsplit(u).netloc or u, u) for u in urls],
            args.timeout,
        )
    return dump_url(urls[0], args.timeout, args.varz)


if __name__ == "__main__":
    sys.exit(main())
