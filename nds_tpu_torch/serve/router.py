"""QueryRouter: the fault-tolerant front over N serve replicas.

The reference harness gets this tier free from Spark (its application
master's and cluster manager's restart semantics); here the fleet story has to be built, and it
is the layer where every single-host guarantee either composes across
hosts or quietly doesn't. The router is a thin HTTP app riding the SAME
obs/httpserv.attach_app seam the replicas use (one listener per process,
never a second server stack) in its OWN process: /metrics, /statusz,
/healthz and the routed /query all answer from one port.

Routing is BY BUDGET VERDICT: the router asks a replica's POST /plan
probe for the statement's plan-budget verdict (cached by plan
fingerprint, so steady-state traffic never pays a probe), then

    reject                  429 at the edge — provably no replica worker
                            slot is consumed (the /plan probe takes no
                            admission slot and emits no serve_request)
    spill | blocked | over  the mesh-backed replica (the one with the
                            device capacity the verdict says it needs)
    direct | unknown        any warm replica, least-in-flight

In the port `mesh_replica` is routing to a URL only: the replica it names
runs on one card like the others (mesh execution, parallel/, is ROADMAP.md
queue 1 item 13).

Robustness fronts:

* failure detection + failover — per-replica health from /healthz probes
  plus passive signals (connect refused / mid-stream death / latency).
  A SIGKILL'd replica mid-query costs ONE classified failover retry:
  SELECTs retry on another replica under the per-request retry budget
  with decorrelated-jitter backoff; DML retries only when the statement
  provably never started (connection refused before dispatch) — a
  mid-stream DML death is AMBIGUOUS (the commit may have published), so
  it fails classified-retryable with the router-minted idempotency key
  echoed: the client's keyed retry is deduped by the replica ledger and
  arbitrated by the OCC statement path, never double-applied.
* anti-retry-storm — failover retries draw from a token bucket per
  (tenant, statement class); an exhausted bucket propagates the shed
  instead of amplifying it, and every 429/503 carries a Retry-After with
  decorrelated jitter so a shed burst never re-arrives in lockstep (the
  hazard documented at serve/service.py RETRY_AFTER_S).
* graceful degradation on coordinator loss — a DML that fails with
  "catalog unreachable" opens a DML circuit: further DML fast-fails at
  the edge (503, classified io_transient) while pinned SELECTs keep
  serving from replicas holding live leases; after a cooldown one
  half-open probe rides through and a success closes the circuit.
  /statusz's fleet section names exactly which capability is degraded.
* fleet lifecycle — POST /fleet/reload rolls drain -> reload across the
  replicas one at a time (the router stops routing to the draining
  replica first, so zero in-flight requests drop), and the fleet-wide
  per-tenant quota (`engine.route_tenant_cap`) is the router-enforced
  equivalent of the per-replica serve_tenant_cap.

Fault sites: `route:pick` (selection; an injected failure sheds the
request, never the router), `route:forward` (the forward hop; injected
io looks like a dead replica and exercises the failover budget).
"""

from __future__ import annotations

import hashlib
import json
import math
import random
import re
import threading
import time
import uuid

from .. import faults
from ..engine.lockdebug import make_lock

#: default per-request upstream attempt budget (first try + failovers)
DEFAULT_ROUTE_RETRIES = 3

#: default failover token bucket per (tenant, class): capacity / refill
DEFAULT_RETRY_BURST = 8
DEFAULT_RETRY_RATE = 2.0

#: decorrelated-jitter backoff between failover attempts (seconds)
DEFAULT_BACKOFF_BASE_S = 0.05
DEFAULT_BACKOFF_CAP_S = 2.0

#: active /healthz probe period; 0 disables the prober thread (tests)
DEFAULT_HEALTH_INTERVAL_S = 2.0

#: plan-fingerprint -> verdict cache entries kept (LRU)
DEFAULT_VERDICT_CACHE = 512

#: DML circuit-breaker cooldown after "catalog unreachable" (seconds)
DEFAULT_CATALOG_COOLDOWN_S = 5.0

#: upstream transport timeouts (seconds)
DEFAULT_CONNECT_TIMEOUT_S = 2.0
DEFAULT_REQUEST_TIMEOUT_S = 600.0

#: Retry-After base advertised on edge sheds (jittered per response)
EDGE_RETRY_AFTER_S = 2.0

_SELECT_LEAD = ("select", "with", "(")


def _resolve(conf, key, env, default, cast=float, floor=0.0):
    v = None
    if conf:
        v = conf.get(key)
    if v is None:
        import os

        v = os.environ.get(env)
    if v is None or str(v).strip() == "":
        return default
    try:
        return max(cast(v), floor)
    except (TypeError, ValueError):
        return default


class _ConnectError(Exception):
    """The upstream connection never opened — the request provably never
    reached the replica (safe to retry any statement class)."""


class _MidStreamError(Exception):
    """The replica died (or the socket broke) AFTER the request was
    sent — the outcome is ambiguous for writes."""


class Replica:
    """One registered upstream: address + live health/accounting state
    (mutated under the router lock)."""

    def __init__(self, url: str, mesh: bool = False):
        url = str(url).strip()
        if "//" in url:
            url = url.split("//", 1)[1]
        url = url.rstrip("/")
        host, _, port = url.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"bad replica address {url!r} (want host:port)"
            )
        self.host = host
        self.port = int(port)
        self.name = f"{host}:{port}"
        self.mesh = mesh
        self.healthy = True  # nds-guarded-by: _lock
        self.draining = False  # nds-guarded-by: _lock
        self.in_flight = 0  # nds-guarded-by: _lock
        self.requests = 0  # nds-guarded-by: _lock
        self.failures = 0  # nds-guarded-by: _lock
        self.consecutive_errors = 0  # nds-guarded-by: _lock
        self.last_latency_ms = None  # nds-guarded-by: _lock
        self.last_probe_ok_ts = None  # nds-guarded-by: _lock
        #: bumped each time the router puts the replica back in rotation
        #: (a roll's reload, a probe's 200): a `draining` answer to a
        #: request sent at an older epoch is stale (the port's own field;
        #: the reference's Replica has none)
        self.epoch = 0  # nds-guarded-by: _lock

    def snapshot(self) -> dict:
        return {
            "replica": self.name,
            "mesh": self.mesh,
            "healthy": self.healthy,
            "draining": self.draining,
            "in_flight": self.in_flight,
            "requests": self.requests,
            "failures": self.failures,
            "last_latency_ms": self.last_latency_ms,
        }


class QueryRouter:
    """The fleet-router application behind obs/httpserv.py's route seam
    (attach with `MetricsServer.attach_app`; the listener's built-in
    /healthz answers 503 while `self.draining`)."""

    def __init__(self, replicas, conf=None, tracer=None,
                 mesh_replica=None):
        conf = conf or {}
        self.tracer = tracer
        self.replicas = []
        mesh_name = str(mesh_replica).strip() if mesh_replica else None
        if mesh_name and "//" in mesh_name:
            mesh_name = mesh_name.split("//", 1)[1]
        for r in replicas:
            rep = r if isinstance(r, Replica) else Replica(r)
            if mesh_name and rep.name == mesh_name.rstrip("/"):
                rep.mesh = True
            self.replicas.append(rep)
        if not self.replicas:
            raise ValueError("router needs at least one replica")
        self.max_attempts = int(_resolve(
            conf, "engine.route_retries", "NDS_ROUTE_RETRIES",
            DEFAULT_ROUTE_RETRIES, cast=int, floor=1,
        ))
        self.retry_burst = _resolve(
            conf, "engine.route_retry_burst", "NDS_ROUTE_RETRY_BURST",
            DEFAULT_RETRY_BURST,
        )
        self.retry_rate = _resolve(
            conf, "engine.route_retry_rate", "NDS_ROUTE_RETRY_RATE",
            DEFAULT_RETRY_RATE,
        )
        self.backoff_base_s = _resolve(
            conf, "engine.route_backoff_base_s", "NDS_ROUTE_BACKOFF_BASE_S",
            DEFAULT_BACKOFF_BASE_S,
        )
        self.backoff_cap_s = _resolve(
            conf, "engine.route_backoff_cap_s", "NDS_ROUTE_BACKOFF_CAP_S",
            DEFAULT_BACKOFF_CAP_S,
        )
        self.health_interval_s = _resolve(
            conf, "engine.route_health_interval_s",
            "NDS_ROUTE_HEALTH_INTERVAL_S", DEFAULT_HEALTH_INTERVAL_S,
        )
        # 0 = no fleet cap (per-replica serve_tenant_cap still applies)
        self.tenant_cap = int(_resolve(
            conf, "engine.route_tenant_cap", "NDS_ROUTE_TENANT_CAP",
            0, cast=int,
        ))
        self.verdict_cache_cap = int(_resolve(
            conf, "engine.route_verdict_cache", "NDS_ROUTE_VERDICT_CACHE",
            DEFAULT_VERDICT_CACHE, cast=int, floor=0,
        ))
        self.catalog_cooldown_s = _resolve(
            conf, "engine.route_catalog_cooldown_s",
            "NDS_ROUTE_CATALOG_COOLDOWN_S", DEFAULT_CATALOG_COOLDOWN_S,
        )
        self.connect_timeout_s = _resolve(
            conf, "engine.route_connect_timeout_s",
            "NDS_ROUTE_CONNECT_TIMEOUT_S", DEFAULT_CONNECT_TIMEOUT_S,
            floor=0.1,
        )
        self.request_timeout_s = _resolve(
            conf, "engine.route_request_timeout_s",
            "NDS_ROUTE_REQUEST_TIMEOUT_S", DEFAULT_REQUEST_TIMEOUT_S,
            floor=1.0,
        )
        self._lock = make_lock("QueryRouter._lock")
        self._rr = 0  # nds-guarded-by: _lock
        self._tenant_in_flight = {}  # nds-guarded-by: _lock
        # (tenant, class) -> [tokens, last_refill_monotonic]
        self._buckets = {}  # nds-guarded-by: _lock
        # plan fingerprint -> /plan verdict payload (LRU via re-insert)
        self._verdicts = {}  # nds-guarded-by: _lock
        self._verdict_order = []  # nds-guarded-by: _lock
        # capability -> {"reason", "since_ts_ms"} while degraded
        self._degraded = {}  # nds-guarded-by: _lock
        self._dml_half_open_at = 0.0  # nds-guarded-by: _lock
        self.draining = False  # nds-guarded-by: _lock
        self.started_ts_ms = int(time.time() * 1000)
        self._closed = threading.Event()
        self._prober = None
        if self.health_interval_s > 0:
            self._prober = threading.Thread(
                target=self._probe_loop, name="nds-route-health",
                daemon=True,
            )
            self._prober.start()

    # ------------------------------------------------------------------
    # HTTP seam
    # ------------------------------------------------------------------
    def handle_http(self, method, path, headers, body):
        tenant = str(headers.get("x-nds-tenant") or "default")
        if method == "POST" and path == "/query":
            try:
                payload = self._json_body(body)
            except ValueError as exc:
                return self._reply(400, {"error": str(exc)})
            return self.handle_query(payload, tenant)
        if method == "GET" and path == "/fleet":
            return self._reply(200, self.fleet_snapshot())
        if method == "POST" and path == "/fleet/reload":
            return self.handle_fleet_reload()
        if method == "POST" and path == "/drain":
            return self.handle_drain()
        return None

    @staticmethod
    def _json_body(body):
        if not body:
            return {}
        try:
            obj = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as exc:
            raise ValueError(f"malformed JSON request body: {exc}") from exc
        if not isinstance(obj, dict):
            raise ValueError("request body must be a JSON object")
        return obj

    @staticmethod
    def _reply(status, obj, extra_headers=()):
        return (
            status, "application/json",
            json.dumps(obj, default=str), tuple(extra_headers),
        )

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def _emit_request(self, rid, tenant, status_label, t0, http_status,
                      replica=None, verdict=None, stmt_class=None,
                      attempts=0, queue_ms=None, forward_ms=None,
                      query=None):
        if self.tracer is None:
            return
        fields = {
            "request_id": rid,
            # the router-minted rid IS the fleet trace_id: the same value
            # rides x-nds-trace-context to every replica attempt, so one
            # grep follows router -> replica(s) -> catalog -> engine
            "trace_id": rid,
            "replica": replica,
            "verdict": verdict,
            "stmt_class": stmt_class,
            "attempts": int(attempts),
            "retries": max(int(attempts) - 1, 0),
            "query": query,
        }
        if queue_ms is not None:
            fields["queue_ms"] = round(float(queue_ms), 3)
        if forward_ms is not None:
            fields["forward_ms"] = round(float(forward_ms), 3)
        self.tracer.emit(
            "route_request",
            tenant=tenant,
            status=status_label,
            dur_ms=round((time.perf_counter() - t0) * 1000.0, 3),
            http_status=int(http_status),
            **fields,
        )

    def _emit_retry(self, replica, reason, tenant, rid, attempt,
                    delay_s=None):
        if self.tracer is None:
            return
        fields = {"tenant": tenant, "request_id": rid, "trace_id": rid,
                  "attempt": int(attempt)}
        if delay_s is not None:
            fields["delay_ms"] = round(float(delay_s) * 1000.0, 3)
        self.tracer.emit(
            "route_retry", replica=replica, reason=reason, **fields
        )

    # ------------------------------------------------------------------
    # fleet state
    # ------------------------------------------------------------------
    def fleet_snapshot(self) -> dict:
        """The live fleet view merged into /statusz's "fleet" section
        (MetricsSink.set_fleet_provider) and served raw on GET /fleet."""
        with self._lock:
            return {
                "replicas": [r.snapshot() for r in self.replicas],
                "degraded": {k: dict(v) for k, v in self._degraded.items()},
                "tenant_in_flight": dict(self._tenant_in_flight),
                "tenant_cap": self.tenant_cap,
                "verdict_cache_entries": len(self._verdicts),
                "draining": self.draining,
            }

    def _probe_loop(self):
        while not self._closed.wait(self.health_interval_s):
            for rep in self.replicas:
                self.probe_replica(rep)

    def probe_replica(self, rep: Replica):
        """One active /healthz probe: 200 -> healthy, 503 -> draining
        (alive but not routable), transport error -> unhealthy."""
        try:
            status, body, _ = self._http(
                rep, "GET", "/healthz", None, (),
                timeout=self.connect_timeout_s,
            )
        except (_ConnectError, _MidStreamError):
            with self._lock:
                rep.healthy = False
                rep.consecutive_errors += 1
            return False
        with self._lock:
            rep.healthy = True
            rep.consecutive_errors = 0
            if rep.draining and status != 503:
                rep.epoch += 1
            rep.draining = (status == 503)
            rep.last_probe_ok_ts = time.time()
        return status == 200

    def close(self):
        self._closed.set()
        # under the router lock: an unlocked flip would not order against
        # a concurrent handle_query's drain check on another thread
        with self._lock:
            self.draining = True

    # ------------------------------------------------------------------
    # transport
    # ------------------------------------------------------------------
    def _http(self, rep, method, path, payload, headers, timeout=None):
        """One upstream exchange. Raises _ConnectError when the request
        provably never reached the replica, _MidStreamError when the
        socket broke after dispatch (ambiguous outcome)."""
        import http.client

        body = None
        hdrs = dict(headers or ())
        if payload is not None:
            body = json.dumps(payload).encode("utf-8")
            hdrs["Content-Type"] = "application/json"
        conn = http.client.HTTPConnection(
            rep.host, rep.port,
            timeout=self.request_timeout_s if timeout is None else timeout,
        )
        conn.timeout = self.connect_timeout_s
        try:
            try:
                conn.connect()
            except OSError as exc:
                raise _ConnectError(
                    f"{rep.name}: {type(exc).__name__}: {exc}"
                ) from exc
            conn.sock.settimeout(
                self.request_timeout_s if timeout is None else timeout
            )
            try:
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
            except (OSError, http.client.HTTPException) as exc:
                raise _MidStreamError(
                    f"{rep.name}: {type(exc).__name__}: {exc}"
                ) from exc
            return resp.status, data, dict(resp.getheaders())
        finally:
            conn.close()

    def _forward_query(self, rep, payload, tenant, rid, request_key):
        """Forward POST /query with the trace context + idempotency
        headers stamped; accounts in-flight + passive health."""
        faults.maybe_fire("route:forward", kinds=("io", "hang", "crash"))
        parent = getattr(
            getattr(self.tracer, "context", None), "trace_id", None
        )
        hdrs = {
            "X-NDS-Tenant": tenant,
            # the HTTP carriage of NDS_TRACE_CONTEXT: the replica adopts
            # the trace_id half as its request id
            "X-NDS-Trace-Context": f"{rid},{parent or rid}",
        }
        if request_key:
            hdrs["X-NDS-Request-Key"] = request_key
        with self._lock:
            rep.in_flight += 1
            rep.requests += 1
        t0 = time.perf_counter()
        try:
            status, data, rhdrs = self._http(
                rep, "POST", "/query", payload, hdrs
            )
        except (_ConnectError, _MidStreamError):
            with self._lock:
                rep.in_flight -= 1
                rep.failures += 1
                rep.consecutive_errors += 1
                # passive failure detection: stop routing here until the
                # prober (or a probe on pick-starvation) clears it
                rep.healthy = False
            raise
        with self._lock:
            rep.in_flight -= 1
            rep.consecutive_errors = 0
            rep.last_latency_ms = round(
                (time.perf_counter() - t0) * 1000.0, 3
            )
            if status >= 500:
                rep.failures += 1
        return status, data, rhdrs

    # ------------------------------------------------------------------
    # selection + verdicts
    # ------------------------------------------------------------------
    def _still_excluded(self, tried, drain_epochs):
        """`tried` less each replica that answered `draining` and has
        been put back in rotation since (its epoch moved): in a rolling
        reload the other replica may be draining by then, and the one
        that refused this request is serving again."""
        with self._lock:
            return [
                r for r in tried
                if r not in drain_epochs or r.epoch == drain_epochs[r]
            ]

    def _pick(self, verdict=None, exclude=()):
        """Least-in-flight healthy replica (round-robin tiebreak); a
        spill/blocked/over verdict narrows to the mesh-backed replica
        when one is registered + healthy. With NO healthy candidate the
        least-loaded non-draining one gets a second chance (the request
        itself is the probe — the alternative is failing the whole fleet
        on one stale health bit)."""
        faults.maybe_fire("route:pick", kinds=("io", "hang", "crash"))
        with self._lock:
            cands = [
                r for r in self.replicas
                if r not in exclude and not r.draining and r.healthy
            ]
            if not cands:
                cands = [
                    r for r in self.replicas
                    if r not in exclude and not r.draining
                ]
            if not cands:
                return None
            v = (verdict or {}).get("verdict")
            if v in ("spill", "blocked", "over"):
                mesh = [r for r in cands if r.mesh]
                if mesh:
                    cands = mesh
            low = min(r.in_flight for r in cands)
            cands = [r for r in cands if r.in_flight == low]
            rep = cands[self._rr % len(cands)]
            self._rr += 1
            return rep

    @staticmethod
    def classify_payload(payload) -> str:
        """select | dml from the leading keyword — cheap edge routing
        only; the replica's parser is the authority (templates are
        SELECT streams by construction)."""
        sql = payload.get("sql")
        if not sql:
            return "select"
        head = re.sub(r"(?:\s|--[^\n]*\n?)*", "", str(sql), count=1)
        word = re.split(r"[\s(]", head.lower(), maxsplit=1)[0] or head[:1]
        return "select" if head[:1] == "(" or word in _SELECT_LEAD else "dml"

    @staticmethod
    def fingerprint(payload):
        """Plan fingerprint for the verdict cache: whitespace-folded SQL
        text, or template name + params (the verdict depends on both)."""
        sql = payload.get("sql")
        if sql:
            key = " ".join(str(sql).split()).lower()
        else:
            name = payload.get("template")
            if not name:
                return None
            params = {
                str(k): str(v)
                for k, v in (payload.get("params") or {}).items()
            }
            key = json.dumps(["tmpl", str(name), params], sort_keys=True)
        return hashlib.sha1(key.encode("utf-8")).hexdigest()[:16]

    def _verdict_for(self, payload, tenant, stmt_class):
        """Cached budget verdict, else one /plan probe against a warm
        replica. The probe consumes NO admission slot replica-side
        (handle_plan's contract) — an edge 429 never costs a worker."""
        if stmt_class != "select" or self.verdict_cache_cap <= 0:
            return None
        fp = self.fingerprint(payload)
        if fp is None:
            return None
        with self._lock:
            hit = self._verdicts.get(fp)
            if hit is not None:
                return hit
        rep = self._pick()
        if rep is None:
            return None
        try:
            status, data, _ = self._http(
                rep, "POST", "/plan", payload,
                {"X-NDS-Tenant": tenant},
                timeout=min(30.0, self.request_timeout_s),
            )
        except (_ConnectError, _MidStreamError):
            with self._lock:
                rep.healthy = False
                rep.consecutive_errors += 1
            return None
        if status != 200:
            return None
        try:
            obj = json.loads(data.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None
        if not isinstance(obj, dict):
            return None
        obj.pop("request_id", None)
        with self._lock:
            if fp not in self._verdicts:
                self._verdict_order.append(fp)
            self._verdicts[fp] = obj
            while len(self._verdict_order) > self.verdict_cache_cap:
                self._verdicts.pop(self._verdict_order.pop(0), None)
        return obj

    # ------------------------------------------------------------------
    # retry budget (anti-storm)
    # ------------------------------------------------------------------
    def _take_token(self, tenant, stmt_class) -> bool:
        """One failover retry costs one token from the (tenant, class)
        bucket; the FIRST attempt is free. An empty bucket means the
        fleet propagates the failure instead of amplifying it."""
        now = time.monotonic()
        with self._lock:
            tokens, last = self._buckets.get(
                (tenant, stmt_class), (self.retry_burst, now)
            )
            tokens = min(
                self.retry_burst, tokens + (now - last) * self.retry_rate
            )
            if tokens < 1.0:
                self._buckets[(tenant, stmt_class)] = (tokens, now)
                return False
            self._buckets[(tenant, stmt_class)] = (tokens - 1.0, now)
            return True

    def _jitter_retry_after(self, base=None):
        """Decorrelated Retry-After: clients that shed together must not
        re-arrive together (serve/service.py's documented lockstep
        hazard). Returns (float seconds for the body, header tuple)."""
        base = float(base or EDGE_RETRY_AFTER_S)
        ra = round(random.uniform(base * 0.5, base * 1.5), 2)
        ra = max(ra, 0.1)
        return ra, (("Retry-After", str(int(math.ceil(ra)))),)

    def _backoff_sleep(self, prev_s):
        """Decorrelated-jitter backoff between failover attempts."""
        delay = min(
            self.backoff_cap_s,
            random.uniform(self.backoff_base_s, max(prev_s, 0.001) * 3.0),
        )
        time.sleep(delay)
        return delay

    # ------------------------------------------------------------------
    # /query
    # ------------------------------------------------------------------
    def handle_query(self, payload, tenant):
        rid = uuid.uuid4().hex[:12]
        t0 = time.perf_counter()
        if self.draining:
            return self._edge_shed(
                rid, tenant, t0, "router is draining", status=503,
                label="draining",
            )
        stmt_class = self.classify_payload(payload)
        if self.tenant_cap and not self._tenant_enter(tenant):
            return self._edge_shed(
                rid, tenant, t0,
                f"tenant {tenant!r} is at the fleet in-flight cap "
                f"({self.tenant_cap}); retry later",
                stmt_class=stmt_class,
            )
        try:
            return self._routed_query(payload, tenant, rid, t0, stmt_class)
        finally:
            if self.tenant_cap:
                self._tenant_leave(tenant)

    def _tenant_enter(self, tenant) -> bool:
        with self._lock:
            if self._tenant_in_flight.get(tenant, 0) >= self.tenant_cap:
                return False
            self._tenant_in_flight[tenant] = (
                self._tenant_in_flight.get(tenant, 0) + 1
            )
            return True

    def _tenant_leave(self, tenant):
        with self._lock:
            n = self._tenant_in_flight.get(tenant, 1) - 1
            if n <= 0:
                self._tenant_in_flight.pop(tenant, None)
            else:
                self._tenant_in_flight[tenant] = n

    def _edge_shed(self, rid, tenant, t0, reason, status=429,
                   label="shed", stmt_class=None, extra=None,
                   attempts=0):
        ra, hdrs = self._jitter_retry_after()
        body = {
            "request_id": rid, "tenant": tenant, "status": label,
            "error": reason, "retry_after_s": ra,
        }
        if extra:
            body.update(extra)
        self._emit_request(
            rid, tenant, label, t0, status, stmt_class=stmt_class,
            attempts=attempts,
        )
        return self._reply(status, body, hdrs)

    def _dml_degraded_reason(self):
        """The degraded-DML circuit: fast-fail at the edge during the
        cooldown, then let exactly one half-open probe through."""
        with self._lock:
            deg = self._degraded.get("dml")
            if not deg:
                return None
            now = time.monotonic()
            if now >= self._dml_half_open_at:
                # this request is the half-open probe; hold the circuit
                # for everyone else for another cooldown
                self._dml_half_open_at = now + self.catalog_cooldown_s
                return None
            return deg.get("reason") or "catalog unreachable"

    def _open_dml_circuit(self, reason):
        with self._lock:
            self._degraded["dml"] = {
                "reason": str(reason)[:200],
                "since_ts_ms": int(time.time() * 1000),
            }
            self._dml_half_open_at = (
                time.monotonic() + self.catalog_cooldown_s
            )

    def _close_dml_circuit(self):
        with self._lock:
            self._degraded.pop("dml", None)

    @staticmethod
    def _is_catalog_unreachable(obj) -> bool:
        if not isinstance(obj, dict):
            return False
        err = str(obj.get("error") or "")
        return (
            obj.get("failure_kind") == faults.IO_TRANSIENT
            and "catalog unreachable" in err.lower()
        )

    def _routed_query(self, payload, tenant, rid, t0, stmt_class):
        if stmt_class == "dml":
            reason = self._dml_degraded_reason()
            if reason is not None:
                # SELECTs keep serving pinned reads; DML is the degraded
                # capability and fails classified-retryable at the edge
                return self._edge_shed(
                    rid, tenant, t0,
                    f"DML degraded: {reason}", status=503, label="failed",
                    stmt_class=stmt_class,
                    extra={"failure_kind": faults.IO_TRANSIENT,
                           "degraded": "dml"},
                )
        try:
            verdict = self._verdict_for(payload, tenant, stmt_class)
        except faults.FaultError as exc:
            return self._edge_shed(
                rid, tenant, t0, f"route fault: {exc}",
                stmt_class=stmt_class,
                extra={"failure_kind": faults.classify(exc)},
            )
        if (verdict or {}).get("verdict") == "reject":
            # 429 at the edge — no replica worker slot consumed (the
            # reject tenant never appears in any replica's /statusz
            # tenants section)
            ra, hdrs = self._jitter_retry_after()
            self._emit_request(
                rid, tenant, "rejected", t0, 429, verdict="reject",
                stmt_class=stmt_class,
            )
            return self._reply(429, {
                "request_id": rid, "tenant": tenant, "status": "rejected",
                "verdict": "reject",
                "error": verdict.get("error") or "plan budget reject",
                "peak_bytes": verdict.get("peak_bytes"),
                "budget_bytes": verdict.get("budget_bytes"),
                "retry_after_s": ra,
            }, hdrs)
        # DML failovers carry a router-minted idempotency key the replica
        # ledger dedups (the OCC statement path stays the arbiter)
        request_key = uuid.uuid4().hex[:16] if stmt_class == "dml" else None
        queue_ms = (time.perf_counter() - t0) * 1000.0
        return self._forward_with_retries(
            payload, tenant, rid, t0, stmt_class, verdict, request_key,
            queue_ms,
        )

    def _forward_with_retries(self, payload, tenant, rid, t0, stmt_class,
                              verdict, request_key, queue_ms):
        tried = []
        attempts = 0
        forward_ms = 0.0
        prev_delay = self.backoff_base_s
        last_error = None
        vlabel = (verdict or {}).get("verdict")
        qlabel = payload.get("template")
        # replica -> its epoch when it answered `draining` to this request
        drain_epochs = {}
        while attempts < self.max_attempts:
            try:
                rep = self._pick(
                    verdict,
                    exclude=self._still_excluded(tried, drain_epochs),
                )
            except faults.FaultError as exc:
                return self._edge_shed(
                    rid, tenant, t0, f"route fault: {exc}",
                    stmt_class=stmt_class, attempts=attempts,
                    extra={"failure_kind": faults.classify(exc)},
                )
            if rep is None:
                if not tried:
                    return self._edge_shed(
                        rid, tenant, t0, "no healthy replica", status=503,
                        label="failed", stmt_class=stmt_class,
                        extra={"failure_kind": faults.IO_TRANSIENT},
                    )
                break
            attempts += 1
            with self._lock:
                sent_epoch = rep.epoch
            f0 = time.perf_counter()
            try:
                status, data, rhdrs = self._forward_query(
                    rep, payload, tenant, rid, request_key
                )
            except faults.FaultError as exc:
                forward_ms += (time.perf_counter() - f0) * 1000.0
                last_error = f"injected fault at route:forward: {exc}"
                tried.append(rep)
                self._emit_retry(rep.name, "fault", tenant, rid, attempts)
                if attempts >= self.max_attempts or not self._take_token(
                    tenant, stmt_class
                ):
                    break
                prev_delay = self._backoff_sleep(prev_delay)
                continue
            except _ConnectError as exc:
                forward_ms += (time.perf_counter() - f0) * 1000.0
                last_error = f"connect: {exc}"
                tried.append(rep)
                delay = None
                # the request never reached the replica: ANY class is
                # safe to fail over, DML included
                if attempts < self.max_attempts and self._take_token(
                    tenant, stmt_class
                ):
                    delay = self._backoff_sleep(prev_delay)
                    prev_delay = delay
                    self._emit_retry(
                        rep.name, "connect", tenant, rid, attempts,
                        delay_s=delay,
                    )
                    continue
                self._emit_retry(rep.name, "connect", tenant, rid, attempts)
                break
            except _MidStreamError as exc:
                forward_ms += (time.perf_counter() - f0) * 1000.0
                last_error = f"mid-stream: {exc}"
                tried.append(rep)
                if stmt_class == "dml":
                    # AMBIGUOUS: the replica may have committed before
                    # dying. Fail classified-retryable with the key
                    # echoed — a keyed client retry is deduped by the
                    # replica ledger, never double-applied.
                    self._emit_retry(
                        rep.name, "midstream", tenant, rid, attempts
                    )
                    ra, hdrs = self._jitter_retry_after()
                    self._emit_request(
                        rid, tenant, "failed", t0, 503, replica=rep.name,
                        verdict=vlabel, stmt_class=stmt_class,
                        attempts=attempts, queue_ms=queue_ms,
                        forward_ms=forward_ms, query=qlabel,
                    )
                    return self._reply(503, {
                        "request_id": rid, "tenant": tenant,
                        "status": "failed",
                        "failure_kind": faults.IO_TRANSIENT,
                        "error": (
                            "replica died mid-DML (outcome ambiguous); "
                            f"retry with request_key: {last_error}"
                        ),
                        "request_key": request_key,
                        "retry_after_s": ra,
                        "route": self._route_info(rep, attempts),
                    }, hdrs)
                if attempts < self.max_attempts and self._take_token(
                    tenant, stmt_class
                ):
                    delay = self._backoff_sleep(prev_delay)
                    prev_delay = delay
                    self._emit_retry(
                        rep.name, "midstream", tenant, rid, attempts,
                        delay_s=delay,
                    )
                    continue
                self._emit_retry(
                    rep.name, "midstream", tenant, rid, attempts
                )
                break
            forward_ms += (time.perf_counter() - f0) * 1000.0
            obj = self._parse_json(data)
            if status in (429, 503):
                # upstream shed/drain: prefer another replica if the
                # budget allows, else propagate with jittered Retry-After
                tried.append(rep)
                if obj.get("status") == "draining":
                    drain_epochs[rep] = sent_epoch
                    with self._lock:
                        # an answer the router has outlived (a roll
                        # re-opened the replica meanwhile) must not take
                        # it out of rotation again
                        if rep.epoch == sent_epoch:
                            rep.draining = True
                can_retry = attempts < self.max_attempts
                try:
                    alt = self._pick(
                        verdict,
                        exclude=self._still_excluded(tried, drain_epochs),
                    )
                except faults.FaultError:
                    alt = None
                if can_retry and alt is not None and self._take_token(
                    tenant, stmt_class
                ):
                    delay = self._backoff_sleep(prev_delay)
                    prev_delay = delay
                    self._emit_retry(
                        rep.name, "shed", tenant, rid, attempts,
                        delay_s=delay,
                    )
                    continue
                return self._finish(
                    rid, tenant, t0, rep, status, obj, rhdrs, attempts,
                    vlabel, stmt_class, queue_ms, forward_ms, qlabel,
                    request_key,
                )
            if status >= 500:
                fk = obj.get("failure_kind")
                if stmt_class == "dml" and self._is_catalog_unreachable(
                    obj
                ):
                    # coordinator loss: open the DML circuit so the
                    # fleet degrades at the edge instead of timing out
                    # request by request
                    self._open_dml_circuit(obj.get("error"))
                retryable = fk in faults.RETRYABLE
                tried.append(rep)
                if (
                    stmt_class == "select" and retryable
                    and attempts < self.max_attempts
                    and self._take_token(tenant, stmt_class)
                ):
                    delay = self._backoff_sleep(prev_delay)
                    prev_delay = delay
                    self._emit_retry(
                        rep.name, "upstream", tenant, rid, attempts,
                        delay_s=delay,
                    )
                    continue
                return self._finish(
                    rid, tenant, t0, rep, status, obj, rhdrs, attempts,
                    vlabel, stmt_class, queue_ms, forward_ms, qlabel,
                    request_key,
                )
            if status == 200 and stmt_class == "dml":
                self._close_dml_circuit()
            return self._finish(
                rid, tenant, t0, rep, status, obj, rhdrs, attempts,
                vlabel, stmt_class, queue_ms, forward_ms, qlabel,
                request_key,
            )
        # attempts/budget exhausted without an upstream answer
        ra, hdrs = self._jitter_retry_after()
        self._emit_request(
            rid, tenant, "failed", t0, 503,
            replica=tried[-1].name if tried else None, verdict=vlabel,
            stmt_class=stmt_class, attempts=attempts, queue_ms=queue_ms,
            forward_ms=forward_ms, query=qlabel,
        )
        return self._reply(503, {
            "request_id": rid, "tenant": tenant, "status": "failed",
            "failure_kind": faults.IO_TRANSIENT,
            "error": (
                f"no replica answered after {attempts} attempt(s) "
                f"(last: {last_error})"
            ),
            "request_key": request_key,
            "retry_after_s": ra,
            "route": {
                "attempts": attempts,
                "retries": max(attempts - 1, 0),
                "tried": [r.name for r in tried],
            },
        }, hdrs)

    @staticmethod
    def _parse_json(data):
        try:
            obj = json.loads(data.decode("utf-8")) if data else {}
        except (ValueError, UnicodeDecodeError):
            obj = {}
        return obj if isinstance(obj, dict) else {}

    def _route_info(self, rep, attempts):
        return {
            "replica": rep.name if rep else None,
            "attempts": attempts,
            "retries": max(attempts - 1, 0),
        }

    def _finish(self, rid, tenant, t0, rep, status, obj, rhdrs, attempts,
                vlabel, stmt_class, queue_ms, forward_ms, qlabel,
                request_key):
        """Relay the replica's answer with the route hop annotated; the
        route_request event is the router's own accounting of the SAME
        outcome the client saw."""
        label = {
            200: "completed", 202: "completed",
        }.get(status)
        if label is None:
            body_label = str(obj.get("status") or "")
            if status == 429:
                label = "rejected" if body_label == "rejected" else "shed"
            elif status == 503:
                label = "draining" if body_label == "draining" else "failed"
            else:
                label = "failed"
        out = dict(obj)
        out.setdefault("request_id", rid)
        out["route"] = self._route_info(rep, attempts)
        if request_key:
            out["route"]["request_key"] = request_key
        extra = []
        if status in (429, 503):
            ra, hdrs = self._jitter_retry_after(
                base=obj.get("retry_after_s")
            )
            out["retry_after_s"] = ra
            extra = list(hdrs)
        self._emit_request(
            rid, tenant, label, t0, status,
            replica=rep.name if rep else None,
            verdict=obj.get("verdict") or vlabel, stmt_class=stmt_class,
            attempts=attempts, queue_ms=queue_ms, forward_ms=forward_ms,
            query=qlabel,
        )
        return self._reply(status, out, extra)

    # ------------------------------------------------------------------
    # fleet lifecycle
    # ------------------------------------------------------------------
    def handle_fleet_reload(self):
        """Rolling drain + reload, one replica at a time: the router
        stops routing to the replica FIRST (zero new requests land on
        it), the replica's /drain waits out its in-flight work, /reload
        re-resolves the warehouse and re-opens admission, and only then
        does the roll move on — in a 2-replica fleet the other replica
        keeps serving the whole time (zero dropped in-flight)."""
        results = []
        for rep in list(self.replicas):
            with self._lock:
                rep.draining = True
            rec = {"replica": rep.name, "drained": False,
                   "reloaded": False}
            try:
                st, data, _ = self._http(rep, "POST", "/drain", {}, ())
                obj = self._parse_json(data)
                rec["drained"] = bool(st == 200 and obj.get("drained"))
                rec["in_flight"] = obj.get("in_flight")
                st2, data2, _ = self._http(rep, "POST", "/reload", {}, ())
                rec["reloaded"] = st2 == 200
            except (_ConnectError, _MidStreamError) as exc:
                rec["error"] = str(exc)
                with self._lock:
                    rep.healthy = False
            finally:
                with self._lock:
                    rep.draining = False
                    rep.epoch += 1
            results.append(rec)
        ok = all(r.get("drained") and r.get("reloaded") for r in results)
        return self._reply(200 if ok else 500, {
            "rolled": len(results), "ok": ok, "replicas": results,
        })

    def handle_drain(self):
        """Drain the ROUTER: stop accepting (healthz flips 503 via the
        listener's draining contract); replicas are left running."""
        with self._lock:
            self.draining = True
        return self._reply(200, {"draining": True, "drained": True})
