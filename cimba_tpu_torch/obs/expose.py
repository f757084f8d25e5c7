"""Telemetry exposition: ``/metrics``, ``/healthz``, ``/varz`` over HTTP.

The scrape surface of the host-side telemetry plane
(:mod:`cimba_tpu_torch.obs.telemetry`): a stdlib-only
``http.server.ThreadingHTTPServer`` — opt-in, never started implicitly —
serving

* ``/metrics`` — the registry in Prometheus text exposition format
  (version 0.0.4): counters, gauges, and the log2-bucket histograms
  rendered as cumulative ``_bucket{le=...}`` series;
* ``/healthz`` — the structured liveness verdict
  (:meth:`~cimba_tpu_torch.obs.telemetry.Telemetry.healthz`): HTTP 200 for
  ``ok``/``degraded``, 503 for ``unhealthy`` (a dead or stalled
  dispatcher), JSON body either way;
* ``/varz`` — the full JSON snapshot (registry with history rings, raw
  service stats, span counters).

Also here: :func:`render_prometheus` (the formatter), and
:func:`parse_prometheus_text` — the minimal parser the round-trip tests
and ``tools/metrics_dump.py`` share, so "the text we emit parses" is
checked against one in-repo definition, not by eyeball.

See docs/17_telemetry.md for the scrape-config snippet.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from cimba_tpu_torch.obs.telemetry import Telemetry

__all__ = [
    "render_prometheus", "parse_prometheus_text",
    "ExpositionServer", "start",
]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(v: str) -> str:
    return (
        str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")
    )


def _unescape_label(v: str) -> str:
    """Invert :func:`_escape_label` one character at a time — a chain
    of str.replace calls cannot (``\\n`` produced by escaping a real
    backslash-then-n must not come back as a newline)."""
    out = []
    i = 0
    while i < len(v):
        ch = v[i]
        if ch == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append(
                {"n": "\n", '"': '"', "\\": "\\"}.get(nxt, ch + nxt)
            )
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


def render_prometheus(registry) -> str:
    """The registry as Prometheus text exposition format.  Histograms
    render their sparse log2 buckets cumulatively with ``le`` at the
    bucket's upper power-of-two boundary plus the mandatory
    ``le="+Inf"``, ``_sum``, and ``_count`` series."""
    lines = []
    for fam in registry.collect():
        name, kind = fam["name"], fam["kind"]
        if fam["help"]:
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {kind}")
        for s in fam["series"]:
            labels = s["labels"]
            if kind == "histogram":
                acc = 0
                for e in sorted(s["buckets"]):
                    acc += s["buckets"][e]
                    bl = dict(labels)
                    bl["le"] = _fmt_value(2.0 ** e)
                    lines.append(
                        f"{name}_bucket{_fmt_labels(bl)} {acc}"
                    )
                bl = dict(labels)
                bl["le"] = "+Inf"
                lines.append(f"{name}_bucket{_fmt_labels(bl)} {s['count']}")
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)} "
                    f"{_fmt_value(s['sum'])}"
                )
                lines.append(
                    f"{name}_count{_fmt_labels(labels)} {s['count']}"
                )
            else:
                lines.append(
                    f"{name}{_fmt_labels(labels)} {_fmt_value(s['value'])}"
                )
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict:
    """Minimal Prometheus text parser (the subset
    :func:`render_prometheus` emits): returns ``{"types": {name: kind},
    "samples": {name: {(("label","value"), ...): float}}}`` with label
    tuples sorted by key.  Raises ``ValueError`` on a malformed line —
    the round-trip tests lean on that."""
    types: Dict[str, str] = {}
    samples: Dict[str, Dict[tuple, float]] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            lab_str, _, val_str = rest.rpartition("}")
            val_str = val_str.strip()
            labels = []
            buf = []
            # split on commas outside quotes, tracking escapes — a
            # quote right after an escaped backslash ("a\\") CLOSES the
            # value, and a naive last-char check would miss that
            in_q = False
            esc = False
            cur = ""
            for ch in lab_str:
                if in_q:
                    cur += ch
                    if esc:
                        esc = False
                    elif ch == "\\":
                        esc = True
                    elif ch == '"':
                        in_q = False
                elif ch == '"':
                    in_q = True
                    cur += ch
                elif ch == ",":
                    buf.append(cur)
                    cur = ""
                else:
                    cur += ch
            if in_q:
                raise ValueError(f"unterminated label value: {raw!r}")
            if cur:
                buf.append(cur)
            for item in buf:
                if "=" not in item:
                    raise ValueError(f"malformed label in line: {raw!r}")
                k, v = item.split("=", 1)
                v = v.strip()
                if not (v.startswith('"') and v.endswith('"')):
                    raise ValueError(f"unquoted label value: {raw!r}")
                labels.append((k.strip(), _unescape_label(v[1:-1])))
            key = tuple(sorted(labels))
        else:
            parts = line.split()
            if len(parts) != 2:
                raise ValueError(f"malformed sample line: {raw!r}")
            name, val_str = parts
            key = ()
        name = name.strip()
        if not name:
            raise ValueError(f"empty metric name: {raw!r}")
        try:
            val = float(val_str.replace("+Inf", "inf"))
        except ValueError as e:
            raise ValueError(f"malformed value in line: {raw!r}") from e
        samples.setdefault(name, {})[key] = val
    return {"types": types, "samples": samples}


class ExpositionServer:
    """The opt-in HTTP exposition server over one
    :class:`~cimba_tpu_torch.obs.telemetry.Telemetry` plane.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` /
    ``.url``).  The server thread and every handler thread are daemons;
    :meth:`close` shuts the listener down.  Binding is loopback by
    default — exposing a fleet means fronting this with real infra, not
    flipping the default.  ``delay_s`` stalls every response by that
    long — the fleet chaos plane's ``scrape_delay_ms`` knob
    (docs/20_fleet.md), which is how the health poller's timeout path
    gets exercised deterministically; 0 (the default) adds nothing."""

    def __init__(self, telemetry: Telemetry, host: str = "127.0.0.1",
                 port: int = 0, delay_s: float = 0.0):
        self.telemetry = telemetry
        self.delay_s = float(delay_s)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):     # quiet: no stderr per scrape
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if outer.delay_s > 0:
                    time.sleep(outer.delay_s)
                try:
                    if path == "/metrics":
                        body = render_prometheus(
                            outer.telemetry.registry
                        ).encode()
                        self._send(200, body, CONTENT_TYPE)
                    elif path == "/healthz":
                        h = outer.telemetry.healthz()
                        code = 200 if h["ok"] else 503
                        self._send(
                            code, json.dumps(h, indent=2).encode(),
                            "application/json",
                        )
                    elif path == "/varz":
                        self._send(
                            200,
                            json.dumps(outer.telemetry.varz()).encode(),
                            "application/json",
                        )
                    else:
                        self._send(
                            404,
                            b'{"error": "try /metrics, /healthz, /varz"}',
                            "application/json",
                        )
                except BrokenPipeError:
                    pass           # scraper hung up mid-response
                except Exception as e:
                    # a scrape bug must return 500, not kill the thread
                    try:
                        self._send(
                            500,
                            json.dumps({"error": repr(e)}).encode(),
                            "application/json",
                        )
                    except OSError:
                        # CHK003 fix: the 500 can only fail because the
                        # socket is already gone (scraper hung up) —
                        # anything else must surface, not vanish in a
                        # handler thread
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="cimba-exposition", daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def start(telemetry: Telemetry, *, host: str = "127.0.0.1",
          port: int = 0, delay_s: float = 0.0) -> ExpositionServer:
    """Start the exposition server over ``telemetry`` (opt-in: nothing
    anywhere starts one implicitly).  Returns the running server; its
    ``.url`` is what you point a scrape config (or
    ``tools/metrics_dump.py``) at.  ``delay_s`` is the chaos-plane
    scrape stall (see :class:`ExpositionServer`)."""
    return ExpositionServer(telemetry, host=host, port=port,
                            delay_s=delay_s)
