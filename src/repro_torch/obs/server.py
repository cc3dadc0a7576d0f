"""Scrapeable observability endpoint (counterpart of
``repro/obs/server.py``).

:class:`ObsServer` runs a stdlib ``ThreadingHTTPServer`` on a daemon
thread and serves:

* ``/metrics`` -- the process metrics registry in Prometheus text
  exposition format (0.0.4).  Every scrape first re-evaluates tracked
  SLOs and publishes tracer drop counts, so exported gauges are never
  staler than the scrape interval.
* ``/healthz`` -- readiness: 200 when every watched ``ServeQueue`` is
  live and no quality/SLO alert is CRITICAL, else 503 with a JSON body
  naming the offenders.  Point an orchestrator's readiness probe here.
* ``/varz`` -- one JSON snapshot: process identity, queue liveness +
  per-key serve stats, quality + SLO state, collected metrics.
* ``/tracez`` -- tracing status and the most recent spans (Chrome event
  dicts), with per-thread ring drop counts.

:func:`validate_exposition` is a minimal Prometheus text parser used by
CI (and the ``--validate`` CLI) to fail the build on malformed output:
it checks name/label syntax, escaped label values, ``NaN``/``+-Inf``
sample values, duplicate samples, and the histogram contract
(monotonic cumulative buckets, ``+Inf`` bucket == ``_count``, ``_sum``
present).

What the port does differently: ``/healthz`` reads the pod's health
from :mod:`repro_torch.launch.multihost` (``POD_HEALTH``), never from
the reference's; the demo serves its bundle
through the port's queue on the card (``--device cpu`` to serve it on
the CPU) and shadow-scores against the bundle's ``Sequential``.

CLI::

    python -m repro_torch.obs.server --port 9151 --serve-for 60 --demo
    python -m repro_torch.obs.server --demo --self-check [--device cpu]
    python -m repro_torch.obs.server --validate scrape.prom
"""
from __future__ import annotations

import argparse
import http.server
import json
import math
import os
import re
import socket
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

from . import metrics as _metrics
from .quality import CRITICAL, SHADOW
from .slo import MONITOR, SLO
from .trace import TRACER

ENV_OBS_PORT = "REPRO_OBS_PORT"

CONTENT_TYPE_METRICS = "text/plain; version=0.0.4; charset=utf-8"


class ObsServer:
    """Background HTTP endpoint over the process-wide obs singletons."""

    def __init__(self, *, host: str = "127.0.0.1", port: int = 0,
                 registry=None, tracer=None, tracez_limit: int = 512):
        self.host = host
        self.port = int(port)
        self.registry = registry or _metrics.default_registry()
        self.tracer = tracer or TRACER
        self.tracez_limit = int(tracez_limit)
        self._queues: Dict[str, object] = {}
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------- wiring ---
    def watch_queue(self, name: str, queue) -> "ObsServer":
        """Readiness tracks ``queue`` (duck-typed: ``healthy()`` +
        optional ``snapshot()``)."""
        self._queues[name] = queue
        return self

    def start(self) -> "ObsServer":
        if self._httpd is not None:
            return self
        handler = _make_handler(self)
        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-obs-http",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def url(self, path: str = "/") -> str:
        return f"http://{self.host}:{self.port}{path}"

    # --------------------------------------------------------- payloads ---
    def _refresh(self) -> None:
        """Pre-scrape: re-evaluate SLOs, publish trace drop counts."""
        try:
            MONITOR.evaluate()
        except Exception as e:  # scrape must not 500 on a bad tracker
            _metrics.warn_once("obs-scrape-slo-eval",
                               f"SLO evaluation during scrape failed: "
                               f"{e!r}")
        self.tracer.publish_drop_counts()

    def metrics_text(self) -> str:
        self._refresh()
        return self.registry.dump()

    def health(self) -> Tuple[bool, dict]:
        quality = SHADOW.states()
        slo = MONITOR.states()
        critical = [f"quality:{k}" for k, s in sorted(quality.items())
                    if s == CRITICAL]
        critical += [f"slo:{k}:{obj}" for k, states in sorted(slo.items())
                     for obj, s in sorted(states.items()) if s == CRITICAL]
        queues = {}
        for name, q in sorted(self._queues.items()):
            try:
                ok = bool(q.healthy())
            except Exception:
                ok = False
            queues[name] = ok
        dead = [f"queue:{n}" for n, ok in queues.items() if not ok]
        for name, q in sorted(self._queues.items()):
            # tenancy-aware queues name misbehaving tenants (dropping
            # rows, stuck past their pending cap); duck-typed so plain
            # queues and stubs keep working
            offenders = getattr(q, "tenant_offenders", None)
            if offenders is None:
                continue
            try:
                dead += [f"tenant:{t}" for t in offenders()]
            except Exception:
                pass
        # lazy: multihost imports nothing heavy, and obs must not
        # import the launch layer at module level
        from repro_torch.launch.multihost import POD_HEALTH
        pod = POD_HEALTH.snapshot()
        if pod.get("degraded"):
            dead += ([f"pod:host-{k}" for k in pod.get("offenders") or ()]
                     or ["pod:degraded"])
        ready = not critical and not dead
        return ready, {
            "status": "ok" if ready else "unhealthy",
            "critical": critical + dead,
            "queues": queues,
            "quality": quality,
            "slo": slo,
            "pod": pod,
        }

    def varz(self) -> dict:
        self._refresh()
        queues = {}
        for name, q in sorted(self._queues.items()):
            entry: dict = {}
            try:
                entry = q.snapshot()
            except Exception as e:
                entry = {"error": repr(e)}
            queues[name] = entry
        return {
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "time_unix": time.time(),
            "tracing": self.tracer.enabled,
            "queues": queues,
            "quality": SHADOW.snapshot(),
            "slo": MONITOR.snapshot(),
            "metrics": self.registry.collect(),
        }

    def tracez(self) -> dict:
        events = self.tracer.chrome_events()
        return {
            "enabled": self.tracer.enabled,
            "dropped": self.tracer.drop_counts(),
            "total_events": len(events),
            "events": events[-self.tracez_limit:],
        }


def _make_handler(srv: ObsServer):
    class _Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # keep scrapes out of stderr
            pass

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            try:
                if path == "/metrics":
                    body = srv.metrics_text().encode("utf-8")
                    code, ctype = 200, CONTENT_TYPE_METRICS
                elif path == "/healthz":
                    ready, detail = srv.health()
                    body = (json.dumps(detail, indent=1) + "\n").encode()
                    code = 200 if ready else 503
                    ctype = "application/json"
                elif path == "/varz":
                    body = (json.dumps(srv.varz(), indent=1, default=str)
                            + "\n").encode()
                    code, ctype = 200, "application/json"
                elif path == "/tracez":
                    body = (json.dumps(srv.tracez(), default=str)
                            + "\n").encode()
                    code, ctype = 200, "application/json"
                elif path == "/":
                    body = (b"repro obs endpoint\n"
                            b"routes: /metrics /healthz /varz /tracez\n")
                    code, ctype = 200, "text/plain"
                else:
                    body = b"not found\n"
                    code, ctype = 404, "text/plain"
            except Exception:  # a scrape must answer, never hang
                body = traceback.format_exc().encode("utf-8")
                code, ctype = 500, "text/plain"
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            try:
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass

    return _Handler


# ------------------------------------------------- exposition validator ----
_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"       # metric name
    r"(?:\{(.*)\})?"                     # optional label body
    r"\s+(\S+)"                          # value
    r"(?:\s+(-?\d+))?$")                 # optional timestamp
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_VALUE_RE = re.compile(
    r"^[+-]?(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d+)?$"
    r"|^[+-]?[Ii]nf$|^[Nn]a[Nn]$")


def _parse_value(s: str, lineno: int) -> float:
    if not _VALUE_RE.match(s):
        raise ValueError(f"line {lineno}: invalid sample value {s!r}")
    return float(s)


def _parse_labels(body: str, lineno: int) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    i = 0
    while i < len(body):
        m = _LABEL_RE.match(body, i)
        if m is None:
            raise ValueError(
                f"line {lineno}: malformed label at offset {i}: "
                f"{body[i:i + 40]!r}")
        labels[m.group(1)] = (
            m.group(2).replace("\\\\", "\x00").replace('\\"', '"')
            .replace("\\n", "\n").replace("\x00", "\\"))
        i = m.end()
        if i < len(body):
            if body[i] != ",":
                raise ValueError(
                    f"line {lineno}: expected ',' between labels at "
                    f"offset {i}")
            i += 1
    return labels


def validate_exposition(text: str) -> dict:
    """Parse Prometheus text exposition format 0.0.4; raise ValueError
    (with line numbers) on malformed output.

    Beyond syntax it enforces the histogram contract per labelset:
    cumulative bucket counts must be non-decreasing in ``le``, the
    ``+Inf`` bucket must equal ``_count``, and ``_sum`` must be present.
    Returns ``{"samples": n, "families": {name: type}}``.
    """
    families: Dict[str, str] = {}
    samples: List[Tuple[str, frozenset, Dict[str, str], float]] = []
    seen: set = set()
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.rstrip()
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 3 or not _NAME_RE.match(parts[2]):
                raise ValueError(
                    f"line {lineno}: malformed {parts[1]} line: {raw!r}")
            if parts[1] == "TYPE":
                if len(parts) < 4 or parts[3] not in (
                        "counter", "gauge", "histogram", "summary",
                        "untyped"):
                    raise ValueError(
                        f"line {lineno}: unknown metric type in {raw!r}")
                families[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue  # comment
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: unparseable sample: {raw!r}")
        name, label_body, value_s = m.group(1), m.group(2), m.group(3)
        labels = _parse_labels(label_body, lineno) if label_body else {}
        value = _parse_value(value_s, lineno)
        ident = (name, frozenset(labels.items()))
        if ident in seen:
            raise ValueError(
                f"line {lineno}: duplicate sample {name}{labels}")
        seen.add(ident)
        samples.append((name, ident[1], labels, value))
    _check_histograms(families, samples)
    return {"samples": len(samples), "families": dict(families)}


def _check_histograms(families: Dict[str, str], samples) -> None:
    hists = {n for n, t in families.items() if t == "histogram"}
    for base in hists:
        groups: Dict[frozenset, dict] = {}
        for name, _, labels, value in samples:
            if not name.startswith(base + "_"):
                continue
            suffix = name[len(base) + 1:]
            key = frozenset((k, v) for k, v in labels.items()
                            if k != "le")
            g = groups.setdefault(
                key, {"buckets": [], "sum": None, "count": None})
            if suffix == "bucket":
                le = labels.get("le")
                if le is None:
                    raise ValueError(
                        f"histogram {base}: bucket sample missing 'le'")
                g["buckets"].append((float(le), value))
            elif suffix == "sum":
                g["sum"] = value
            elif suffix == "count":
                g["count"] = value
        for key, g in groups.items():
            where = f"histogram {base}{dict(key) or ''}"
            if g["count"] is None:
                raise ValueError(f"{where}: missing _count")
            if g["sum"] is None:
                raise ValueError(f"{where}: missing _sum")
            if not g["buckets"]:
                raise ValueError(f"{where}: no buckets")
            g["buckets"].sort(key=lambda bc: bc[0])
            last_le, prev = g["buckets"][-1][0], -1.0
            for le, c in g["buckets"]:
                if c < prev:
                    raise ValueError(
                        f"{where}: bucket counts not cumulative at "
                        f"le={le:g}")
                prev = c
            if not math.isinf(last_le):
                raise ValueError(f"{where}: missing le=\"+Inf\" bucket")
            if g["buckets"][-1][1] != g["count"]:
                raise ValueError(
                    f"{where}: +Inf bucket ({g['buckets'][-1][1]:g}) != "
                    f"_count ({g['count']:g})")


# ----------------------------------------------------------------- demo ----
def _demo_workload(device=None) -> "object":
    """Populate the registry with a real serve round-trip + shadow
    scoring + a tracked SLO, so a scrape of the demo server exercises
    every family CI greps for.  Serves on ``device`` (None: the CUDA
    card).  Returns the queue (to watch)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.nn import MLP
    from repro_torch.nn.serialize import load_model, save_model
    from repro_torch.serve import FlushPolicy, ServeQueue

    tmp = tempfile.mkdtemp(prefix="repro-obs-demo-")
    path = save_model(os.path.join(tmp, "demo_bundle"),
                      MLP((1, 5), [32, 32], 1).init(0))
    q = ServeQueue(FlushPolicy(max_batch_rows=256, max_delay_s=0.05),
                   device=device)
    net = load_model(path, q.device)[0]  # the shadow reference
    q.start()
    SHADOW.enable(rate=1.0)
    SHADOW.set_budget(path, 0.05)
    MONITOR.track(path, q.stats(path),
                  SLO(latency_threshold_s=2.0, windows_s=(30.0, 120.0),
                      min_events=1))
    rng = np.random.default_rng(0)

    def ref(x):
        with torch.no_grad():
            return net(x.to(q.device)).cpu().numpy()

    for _ in range(4):
        x = torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32))
        fut = q.submit(path, x)
        q.flush(path, reason="demo")
        y = fut.result(30.0)
        SHADOW.submit(path, pred=lambda y=y: y.numpy(),
                      ref=lambda x=x: ref(x),
                      region="demo", rows=x.shape[0], trace=fut.trace)
    SHADOW.flush(30.0)
    MONITOR.evaluate()
    return q


def _self_check(server: ObsServer, expect_quality: bool) -> None:
    import urllib.request

    for route in ("/", "/healthz", "/varz", "/tracez"):
        with urllib.request.urlopen(server.url(route), timeout=10) as r:
            if r.status != 200:
                raise SystemExit(f"{route}: HTTP {r.status}")
    with urllib.request.urlopen(server.url("/metrics"), timeout=10) as r:
        text = r.read().decode("utf-8")
    info = validate_exposition(text)
    if expect_quality and "repro_quality_rmse" not in text:
        raise SystemExit("/metrics missing repro_quality_rmse")
    print(f"self-check ok: {info['samples']} samples, "
          f"{len(info['families'])} families")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.server",
        description="serve /metrics /healthz /varz /tracez, or validate "
                    "a Prometheus exposition file")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int,
                    default=int(os.environ.get(ENV_OBS_PORT, 0) or 0))
    ap.add_argument("--serve-for", type=float, default=0.0,
                    help="serve for N seconds then exit (0 = forever)")
    ap.add_argument("--demo", action="store_true",
                    help="populate the registry with a real serve "
                         "round-trip + shadow scoring before serving")
    ap.add_argument("--device", default=None,
                    help="device the demo serves on (default: the CUDA "
                         "card; 'cpu' to serve on the CPU)")
    ap.add_argument("--self-check", action="store_true",
                    help="scrape own routes once, validate, exit")
    ap.add_argument("--validate", default=None, metavar="PATH",
                    help="validate a Prometheus text file ('-' = stdin) "
                         "and exit")
    args = ap.parse_args(argv)

    if args.validate is not None:
        text = (sys.stdin.read() if args.validate == "-"
                else open(args.validate).read())
        try:
            info = validate_exposition(text)
        except ValueError as e:
            print(f"INVALID: {e}", file=sys.stderr)
            return 1
        print(f"valid exposition: {info['samples']} samples, "
              f"{len(info['families'])} families")
        return 0

    server = ObsServer(host=args.host, port=args.port)
    q = None
    if args.demo:
        q = _demo_workload(args.device)
        server.watch_queue("serve", q)
    server.start()
    print(f"obs endpoint on {server.url()} "
          f"(routes: /metrics /healthz /varz /tracez)", flush=True)
    try:
        if args.self_check:
            _self_check(server, expect_quality=args.demo)
            return 0
        if args.serve_for > 0:
            time.sleep(args.serve_for)
        else:  # pragma: no cover - interactive
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:  # pragma: no cover - interactive
        pass
    finally:
        server.stop()
        if q is not None:
            q.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
