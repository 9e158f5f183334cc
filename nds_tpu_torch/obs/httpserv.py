"""The live-telemetry HTTP endpoint: /metrics, /statusz, /healthz — and,
in serve mode, the query-service routes on the SAME listener. The port of
nds_tpu/obs/httpserv.py; its threads read sink state and do no Arrow work.

A stdlib `http.server` ThreadingHTTPServer on a daemon thread — no new
dependency, nothing to install on a fleet node. Started by
`obs.metrics.maybe_serve` when `engine.metrics_port` / NDS_METRICS_PORT
is set (off by default; 0 binds an ephemeral port — the CI e2e reads it
back from `MetricsServer.port`).

    GET /metrics   Prometheus text exposition of the registry
    GET /statusz   JSON run status: current phase, in-flight query with
                   elapsed/attempt/ladder, completed/failed counts, cache
                   hit rates, RSS + memory high-water, heartbeat age, a
                   `mesh` section (per-device HBM high-water + last
                   exchange skew/bytes) and per-tenant serve stats when
                   serve mode is attached
    GET /healthz   "ok" liveness; 503 "draining" once a serve-mode drain
                   begins, so load balancers stop routing BEFORE shutdown
    GET /debug/flight    the flight recorder's current bundle (last-N
                   events + plan/budget/ladder/memory/conf context) as
                   JSON; `?write=1` also persists it as a
                   failure-bundle-<trace_id>.json (obs/flight.py)
    GET /debug/jaxprof   on-demand profiler status; POST with
                   {"action": "start"|"stop", "dir": ...} starts/stops a
                   torch.profiler trace on the LIVE process (the "why is
                   this serve worker slow right now" tool); the route
                   keeps the reference's name for its clients

Debug-route invariant (lint `debug-route-seam`): every /debug route
registers HERE, on the one process-wide listener — never on a second
listener, and serve-mode apps reach theirs through `attach_app` exactly
like the query routes.

Serve mode (serve/service.py, serve/router.py) and the catalog coordinator
(lakehouse/catalog.py) attach an application via `attach_app`: any route
the built-ins above don't own is dispatched to
`app.handle_http(method, path, headers, body)` — POST /query, /stream,
/drain, /reload, GET /jobs/<id> all ride this one process-wide listener
instead of binding a second port. POST bodies are size-capped, and a
per-connection read timeout bounds what a slow (or slowloris) client can
hold: a stalled socket times out and closes, never wedging a worker.

The built-in handlers only READ sink state (every read path takes the
sink's own locks), so a scrape can never block or corrupt the run it
watches; the server thread is a daemon, so a finished benchmark process
never hangs on it."""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


#: largest accepted POST body (a query request is SQL text + a small JSON
#: envelope; anything bigger is a client bug or a flood)
MAX_BODY_BYTES = 8 << 20

#: on-demand profiler state (one profiler per process); guarded by its
#: lock because two /debug/jaxprof POSTs may race on the threading server.
#: The route keeps the reference's name and payload, so its clients work
#: here; the profiler behind it is torch.profiler (_ProfilerThread).
_JAXPROF_LOCK = threading.Lock()
_JAXPROF = {"dir": None, "started_ts_ms": None, "prof": None}


def _jaxprof_status() -> dict:
    with _JAXPROF_LOCK:
        return {
            "running": _JAXPROF["dir"] is not None,
            "dir": _JAXPROF["dir"],
            "started_ts_ms": _JAXPROF["started_ts_ms"],
        }


class _ProfilerThread:
    """A torch.profiler session on a thread of its own: the profiler must
    start and stop on one thread, and each /debug/jaxprof POST arrives on
    another. Traces the host and, where the process has a CUDA card, the
    card (CUPTI: the device's kernels of whatever the process runs); on
    stop writes a Chrome trace, `trace.json`, into `out_dir`."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.error = None
        self._stop = threading.Event()
        self._started = threading.Event()
        self._done = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="nds-obs-profiler", daemon=True
        )
        self._thread.start()
        self._started.wait()
        if self.error is not None:
            raise self.error

    def _run(self):
        import torch

        try:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        except Exception as exc:
            self.error = exc
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(self.out_dir, "trace.json"))
        except Exception as exc:
            self.error = exc
        finally:
            self._done.set()

    def stop(self):
        self._stop.set()
        self._done.wait()
        if self.error is not None:
            raise self.error


def _jaxprof_action(payload: dict) -> tuple:
    """(status_code, body_dict) for a /debug/jaxprof POST."""
    import time

    action = str(payload.get("action") or "").lower()
    if action not in ("start", "stop"):
        return 400, {"error": "action must be 'start' or 'stop'"}
    with _JAXPROF_LOCK:
        if action == "start":
            if _JAXPROF["dir"] is not None:
                return 409, {
                    "error": "profiler already running",
                    "dir": _JAXPROF["dir"],
                }
            from .flight import resolve_flight_dir

            d = payload.get("dir") or os.path.join(
                resolve_flight_dir(), f"jaxprof-{int(time.time())}"
            )
            try:
                os.makedirs(str(d), exist_ok=True)
                prof = _ProfilerThread(str(d))
            except Exception as exc:
                return 500, {"error": f"start_trace: {exc}"}
            _JAXPROF["dir"] = str(d)
            _JAXPROF["started_ts_ms"] = int(time.time() * 1000)
            _JAXPROF["prof"] = prof
            return 200, {"running": True, "dir": str(d)}
        if _JAXPROF["dir"] is None:
            return 409, {"error": "profiler not running"}
        d = _JAXPROF["dir"]
        prof = _JAXPROF["prof"]
        _JAXPROF["dir"] = None
        _JAXPROF["started_ts_ms"] = None
        _JAXPROF["prof"] = None
        try:
            prof.stop()
        except Exception as exc:
            return 500, {"error": f"stop_trace: {exc}"}
        return 200, {"running": False, "dir": d}


class _Handler(BaseHTTPRequestHandler):
    server_version = "nds-tpu-torch-metrics"
    # slow-client guard: BaseHTTPRequestHandler applies this as the
    # connection's socket timeout, so a client that stops sending (or
    # never sends) its request gets its connection closed instead of
    # holding a handler thread forever (the slowloris scenario)
    timeout = float(os.environ.get("NDS_SERVE_CLIENT_TIMEOUT_S", "60"))

    def _reply(self, code, body, ctype, headers=()):
        data = body.encode("utf-8") if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _dispatch_app(self, method, path, body):
        """Route a non-built-in path to the attached serve app (if any).
        Returns True when the app owned the route."""
        app = getattr(self.server, "app", None)
        if app is None:
            return False
        headers = {k.lower(): v for k, v in self.headers.items()}
        result = app.handle_http(method, path, headers, body)
        if result is None:
            return False
        status, ctype, payload, extra = result
        self._reply(status, payload, ctype, extra)
        return True

    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler contract)
        sink = self.server.sink
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                self._reply(
                    200, sink.registry.render(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif path == "/statusz":
                self._reply(
                    200, json.dumps(sink.status_snapshot(), default=str),
                    "application/json",
                )
            elif path == "/healthz":
                app = getattr(self.server, "app", None)
                if app is not None and getattr(app, "draining", False):
                    # the load-balancer signal: stop routing here — the
                    # process is still alive (200s keep flowing on
                    # /metrics) but it is on its way out
                    self._reply(
                        503, "draining\n", "text/plain; charset=utf-8",
                        (("Retry-After", "5"),),
                    )
                else:
                    self._reply(200, "ok\n", "text/plain; charset=utf-8")
            elif path == "/debug/flight":
                self._debug_flight()
            elif path == "/debug/jaxprof":
                self._reply(
                    200, json.dumps(_jaxprof_status()), "application/json"
                )
            elif not self._dispatch_app("GET", path, None):
                self._reply(404, "not found\n", "text/plain; charset=utf-8")
        except BrokenPipeError:
            pass  # scraper hung up mid-reply: its problem, not the run's
        except Exception as exc:  # app bug: a JSON 500, not a socket reset
            self._internal_error(exc)

    def do_POST(self):  # noqa: N802 (BaseHTTPRequestHandler contract)
        path = self.path.split("?", 1)[0]
        try:
            try:
                # clamp below zero: a negative Content-Length would turn
                # rfile.read(length) into read-to-EOF, voiding the cap
                length = max(int(self.headers.get("Content-Length") or 0), 0)
            except ValueError:
                length = 0
            if length > MAX_BODY_BYTES:
                self._reply(
                    413, "request body too large\n",
                    "text/plain; charset=utf-8",
                )
                return
            body = self.rfile.read(length) if length else b""
            if path == "/debug/jaxprof":
                try:
                    payload = json.loads(body.decode("utf-8")) if body else {}
                except (ValueError, UnicodeDecodeError) as exc:
                    self._reply(
                        400, json.dumps({"error": str(exc)}),
                        "application/json",
                    )
                    return
                code, obj = _jaxprof_action(
                    payload if isinstance(payload, dict) else {}
                )
                self._reply(code, json.dumps(obj), "application/json")
                return
            try:
                handled = self._dispatch_app("POST", path, body)
            except ValueError as exc:  # malformed JSON body
                self._reply(
                    400, json.dumps({"error": str(exc)}), "application/json"
                )
                return
            if not handled:
                self._reply(404, "not found\n", "text/plain; charset=utf-8")
        except BrokenPipeError:
            # mid-query disconnect: the engine work (if any) completes on
            # its worker; only this connection's reply is lost
            pass
        except Exception as exc:  # app bug: a JSON 500, not a socket reset
            self._internal_error(exc)

    def _debug_flight(self):
        """GET /debug/flight: the current flight-recorder bundle, built on
        demand from the live ring. `?write=1` also persists it (the
        "grab me a black box from the live service" verb)."""
        from . import flight as obs_flight

        rec = obs_flight.recorder()
        if rec is None:
            self._reply(
                503,
                json.dumps({"error": "flight recorder disabled "
                            "(NDS_FLIGHT_RECORDER=off)"}),
                "application/json",
            )
            return
        from urllib.parse import parse_qs

        query = self.path.split("?", 1)
        params = parse_qs(query[1]) if len(query) > 1 else {}
        bundle = rec.bundle("on_demand")
        if params.get("write", ["0"])[-1] == "1":
            bundle["written"] = rec.flush("on_demand")
        self._reply(200, json.dumps(bundle, default=str), "application/json")

    def _internal_error(self, exc):
        """An exception escaping the attached app must still answer the
        client (otherwise the connection just resets with no status
        line); the body carries the exception TYPE only — messages can
        embed paths/SQL a multi-tenant endpoint must not leak."""
        try:
            self._reply(
                500,
                json.dumps({"error": f"internal: {type(exc).__name__}"}),
                "application/json",
            )
        except OSError:
            pass  # client already gone

    def log_message(self, format, *args):  # noqa: A002 (stdlib signature)
        pass  # a scrape every few seconds must not spam the bench stdout


class MetricsServer:
    """Daemon-thread HTTP server over one MetricsSink.

    `port=0` binds ephemeral; the resolved port is `self.port`. Bind host
    defaults to all interfaces (fleet scrapers live off-box) —
    NDS_METRICS_HOST overrides (e.g. 127.0.0.1 on a shared dev machine)."""

    def __init__(self, sink, port: int = 0, host: str | None = None):
        if host is None:
            host = os.environ.get("NDS_METRICS_HOST", "0.0.0.0")
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.sink = sink
        self._httpd.app = None
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = None

    def attach_app(self, app):
        """Attach a serve-mode application: routes the built-in telemetry
        paths don't own dispatch to `app.handle_http`, and /healthz reads
        `app.draining`. One listener, one port, the whole surface."""
        self._httpd.app = app

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="nds-obs-metrics-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
