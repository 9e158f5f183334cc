"""QueryService: admission-controlled multi-tenant SQL over HTTP.

The reference harness never needs this tier — Spark's long-lived
application process IS the service (thrift server, concurrent scheduler
pools, fair-share queues). This engine's batch CLIs build a session, run
a stream, and exit; serve mode composes the engine's robustness
components into the missing tier:

* one warm read `Session` owns the multi-tenant caches (plan / result,
  join-order, fused builds), shared by every request;
* admission control is the static plan budgeter's verdict per request:
  `reject` answers HTTP 429 carrying the modeled peak bytes before
  anything dispatches; `blocked`/`spill`/`over` admit DEGRADED with the
  verdict echoed in the response envelope;
* concurrency is gated by a semaphore sized from the device budget
  (analysis/budget.serve_concurrency) plus the host-RSS watermark as
  backpressure — over-capacity and over-watermark requests are SHED with
  `Retry-After` instead of wedging the device;
* each request pins its lakehouse snapshot at plan time (reader
  leases), so queries serve consistent reads while DM commits race them;
* DML routes through a dedicated writer session under a writer lock
  (single-writer in-process; OCC commits arbitrate across processes);
* per-tenant accounting (X-NDS-Tenant header) lands on /statusz and the
  `nds_serve_request_*` metric families via a per-request forwarding
  tracer that labels every engine event with the tenant + request id.

Failure domain: `serve:admit` / `serve:exec` are fault-injection sites
(faults.py registry), a failed execution walks the SAME BenchReport
degradation ladder a bench query would (device OOM recovers + retries,
transient IO backs off, the watchdog cuts off hangs), and a worker that
dies takes its request's connection down, never the pool.

Verdict -> HTTP status mapping (the admission contract):

    reject                   429 + modeled peak/budget bytes (never runs)
    over | spill | blocked   200, admitted degraded, verdict in envelope
    direct | unknown         200
    no capacity / watermark  429 + Retry-After   (shed)
    draining                 503 + Retry-After
    parse/bind error         400
    execution failed         500 + classified failureKind
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid

from .. import faults
from ..analysis.budget import PlanBudgetError, serve_concurrency
from ..engine.sql import ast as A
from ..engine.sql.parser import parse_script
from ..obs import trace as obs_trace
from ..obs.memwatch import rss_bytes
from ..report import BenchReport, host_rss_watermark, use_system_arrow_pool

#: default rows per response page; `engine.serve_row_cap` overrides. A
#: serve endpoint returning JSON must bound what one request can pull
#: through the host — callers paginate with offset/limit instead.
DEFAULT_ROW_CAP = 10_000

#: default seconds a request waits for an admission slot before it is
#: shed with Retry-After (`engine.serve_admit_timeout_s`)
DEFAULT_ADMIT_TIMEOUT_S = 10.0

#: default drain budget: how long /drain waits for in-flight work
#: (`engine.serve_drain_timeout_s`)
DEFAULT_DRAIN_TIMEOUT_S = 30.0

#: Retry-After seconds advertised on shed/draining responses — a load
#: balancer retry storm re-arriving in lockstep would re-shed forever
RETRY_AFTER_S = 2


def resolve_serve_port(conf: dict | None = None):
    """Serve port from conf `engine.serve_port`, else NDS_SERVE_PORT;
    None when unset. 0 binds ephemeral (tests). Serve mode feeds this
    into `engine.metrics_port` so ONE process-wide endpoint carries
    /metrics, /statusz, /healthz AND the query routes."""
    v = None
    if conf:
        v = conf.get("engine.serve_port")
    if v is None:
        v = os.environ.get("NDS_SERVE_PORT")
    if v is None or str(v).strip().lower() in ("", "off", "none"):
        return None
    try:
        port = int(v)
    except (TypeError, ValueError):
        return None
    return port if port >= 0 else None


def resolve_row_cap(conf: dict | None = None) -> int:
    v = None
    if conf:
        v = conf.get("engine.serve_row_cap")
    if v is None:
        v = os.environ.get("NDS_SERVE_ROW_CAP")
    try:
        return max(int(v), 1) if v else DEFAULT_ROW_CAP
    except (TypeError, ValueError):
        return DEFAULT_ROW_CAP


def resolve_admit_timeout(conf: dict | None = None) -> float:
    v = None
    if conf:
        v = conf.get("engine.serve_admit_timeout_s")
    if v is None:
        v = os.environ.get("NDS_SERVE_ADMIT_TIMEOUT_S")
    try:
        return max(float(v), 0.0) if v is not None and v != "" else (
            DEFAULT_ADMIT_TIMEOUT_S
        )
    except (TypeError, ValueError):
        return DEFAULT_ADMIT_TIMEOUT_S


def resolve_drain_timeout(conf: dict | None = None) -> float:
    v = None
    if conf:
        v = conf.get("engine.serve_drain_timeout_s")
    if v is None:
        v = os.environ.get("NDS_SERVE_DRAIN_TIMEOUT_S")
    try:
        return max(float(v), 0.0) if v is not None and v != "" else (
            DEFAULT_DRAIN_TIMEOUT_S
        )
    except (TypeError, ValueError):
        return DEFAULT_DRAIN_TIMEOUT_S


def resolve_tenant_cap(conf: dict | None, workers: int) -> int:
    """Per-tenant in-flight cap (`engine.serve_tenant_cap`): one tenant
    flooding the endpoint must never hold EVERY admission slot, so the
    default leaves at least one slot for other tenants."""
    v = None
    if conf:
        v = conf.get("engine.serve_tenant_cap")
    if v is None:
        v = os.environ.get("NDS_SERVE_TENANT_CAP")
    try:
        if v:
            return max(int(v), 1)
    except (TypeError, ValueError):
        pass
    return max(workers - 1, 1)


class _RequestTracer:
    """Per-request forwarding tracer: every event a request's execution
    emits (op_span, exec_cache, plan_cache, heartbeat, ladder_rung, ...)
    gets the request id + tenant stamped on, so concurrent identical
    queries from two tenants never alias in the sink's in-flight view and
    per-tenant cache traffic is attributable. Cache probes are tallied
    here as they pass through — the per-tenant hit rates on /statusz come
    from these tallies riding the request's `serve_request` event."""

    def __init__(self, inner, request_id: str, tenant: str):
        self._inner = inner
        self.request_id = request_id
        self.tenant = tenant
        self._tally_lock = threading.Lock()
        self.tallies = {
            "exec_cache_hits": 0, "exec_cache_lookups": 0,
            "plan_cache_hits": 0, "plan_cache_lookups": 0,
        }

    def __getattr__(self, name):
        # delegate app_id / sink / kernel_spans / close ... to the real
        # tracer (a None inner means an untraced session: emit() below
        # still tallies, then drops)
        return getattr(self._inner, name)

    def emit(self, kind: str, **fields):
        if kind in ("exec_cache", "plan_cache"):
            with self._tally_lock:
                self.tallies[f"{kind}_lookups"] += 1
                if fields.get("hit"):
                    self.tallies[f"{kind}_hits"] += 1
        fields.setdefault("request_id", self.request_id)
        # the request id IS the serve-entry trace_id: every event this
        # request's execution emits (op/kernel/exchange spans, ladder
        # rungs, DM commits, heartbeats) carries ONE trace_id, overriding
        # the shared session tracer's stream-level context — the whole
        # request is followable end to end by a single grep
        fields.setdefault("trace_id", self.request_id)
        fields.setdefault("tenant", self.tenant)
        if self._inner is not None:
            self._inner.emit(kind, **fields)


class _ShedError(Exception):
    """Internal: the request must be shed (429 — or 503 when the shed
    reason is a drain — plus Retry-After)."""

    def __init__(self, reason: str, status: int = 429,
                 label: str = "shed"):
        super().__init__(reason)
        self.reason = reason
        self.status = status
        self.label = label


class QueryService:
    """The serve-mode application behind obs/httpserv.py's route seam.

    `session` is the warm shared READ session; `writer_session` (optional)
    takes DML under a writer lock — when omitted, DML runs on the read
    session under both locks (test mode). `templates` maps template names
    (e.g. "query3") to SQL text, usually parsed from a generated stream
    file. `reload_fn` re-registers the warehouse on /reload (the CLI
    wires one; the default drops every cached snapshot pin + device
    column so the next statements re-resolve fresh heads)."""

    def __init__(self, session, writer_session=None, templates=None,
                 reload_fn=None, job_dir=None):
        self.session = session
        self.writer_session = writer_session
        self.templates = dict(templates or {})
        self._reload_fn = reload_fn
        conf = getattr(session, "conf", {}) or {}
        # the slots come from the working-set line of the session's device
        # (a card's own lines, analysis/budget.budget_lines)
        self.workers = serve_concurrency(
            conf, getattr(session, "device", None)
        )
        # requests page Arrow results to JSON on the listener's threads,
        # and Arrow's mimalloc pool crashed threaded readers: the system
        # allocator before any request can arrive
        use_system_arrow_pool()
        self.row_cap = resolve_row_cap(conf)
        self.admit_timeout_s = resolve_admit_timeout(conf)
        self.drain_timeout_s = resolve_drain_timeout(conf)
        self.tenant_cap = resolve_tenant_cap(conf, self.workers)
        # the bounded worker model: HTTP connection threads ARE the
        # workers, and this semaphore is the bound — at most `workers`
        # requests execute engine work concurrently, the rest wait a
        # bounded admit_timeout_s and then shed. (A separate executor
        # pool would add a thread hop per request for identical
        # semantics: every submit would be immediately awaited.)
        self._admission = threading.BoundedSemaphore(self.workers)
        # planning is serialized (Session.plan_stmt holds cache_lock), but
        # the writer path needs its own mutual exclusion: one in-process
        # writer at a time, OCC arbitrates across processes
        # plain locks, as lakehouse/leases.py's: the reference's lock
        # debugging (engine/lockdebug.py) is ROADMAP.md queue 1 item 15
        self._writer_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._in_flight = 0  # under _state_lock
        self._active_rids = set()  # under _state_lock
        # /reload lease hygiene: [(rids-still-running-at-reload, lease
        # ids dropped by that reload)] — each batch releases when the
        # LAST of its in-flight statements finishes, instead of
        # abandoning the leases to TTL expiry)
        self._deferred_leases = []  # under _state_lock
        self._tenant_in_flight = {}  # under _state_lock
        # DML idempotency ledger (router retries): request_key -> the
        # recorded completed envelope, or None while the original
        # delivery is still running. Bounded FIFO — the keys are
        # router-minted uuids, one per client DML request.
        self._dml_keys = {}  # under _state_lock
        self._dml_key_order = []  # under _state_lock
        self.draining = False  # under _state_lock
        self.started_ts_ms = int(time.time() * 1000)
        from .jobs import StreamJobs

        self.jobs = StreamJobs(self, job_dir=job_dir)

    # ------------------------------------------------------------------
    # HTTP seam (obs/httpserv.py dispatches here for non-built-in routes)
    # ------------------------------------------------------------------
    def handle_http(self, method, path, headers, body):
        """Route one request; returns (status, ctype, body, extra_headers)
        or None for paths this app doesn't own (the caller 404s)."""
        tenant = str(headers.get("x-nds-tenant") or "default")
        if method == "POST" and path == "/query":
            return self.handle_query(
                self._json_body(body), tenant,
                rid=self._adopt_rid(headers),
                request_key=self._request_key(headers),
            )
        if method == "POST" and path == "/plan":
            return self.handle_plan(self._json_body(body), tenant)
        if method == "POST" and path == "/stream":
            return self.handle_stream(self._json_body(body), tenant)
        if method == "GET" and path.startswith("/jobs/"):
            return self.handle_job_get(path[len("/jobs/"):])
        if method == "POST" and path == "/drain":
            return self.handle_drain()
        if method == "POST" and path == "/reload":
            return self.handle_reload()
        return None

    @staticmethod
    def _adopt_rid(headers):
        """Router-stamped trace context: `x-nds-trace-context` is the
        HTTP carriage of NDS_TRACE_CONTEXT ("trace_id,parent"); the
        trace_id half becomes this request's rid, so ONE trace_id greps
        router -> replica -> catalog -> engine, and a failover retry of
        the same client request lands in BOTH replicas' event logs under
        the same id. Malformed/oversized values fall back to a local rid
        (the header is client-controllable in principle)."""
        raw = headers.get("x-nds-trace-context") or ""
        rid = str(raw).split(",", 1)[0].strip()
        if rid and len(rid) <= 64 and all(
            c.isalnum() or c in "-_." for c in rid
        ):
            return rid
        return None

    @staticmethod
    def _request_key(headers):
        """Router-minted DML idempotency key (`x-nds-request-key`): a
        re-delivered DML with a known key answers the recorded envelope
        instead of re-running the statement."""
        key = str(headers.get("x-nds-request-key") or "").strip()
        if key and len(key) <= 64 and all(
            c.isalnum() or c in "-_." for c in key
        ):
            return key
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

    def _shed_reply(self, rid, tenant, t0, reason, status=429,
                    label="shed", extra=None):
        body = {
            "request_id": rid, "tenant": tenant, "status": label,
            "error": reason, "retry_after_s": RETRY_AFTER_S,
        }
        if extra:
            body.update(extra)
        self._emit_request(rid, tenant, label, t0, status)
        return self._reply(
            status, body, (("Retry-After", str(RETRY_AFTER_S)),)
        )

    # ------------------------------------------------------------------
    # request accounting + telemetry
    # ------------------------------------------------------------------
    def _emit_request(self, rid, tenant, status_label, t0, http_status,
                      query=None, verdict=None, rows=None, nbytes=None,
                      tallies=None):
        tracer = getattr(self.session, "tracer", None)
        if tracer is None:
            return
        fields = {
            "request_id": rid,
            # admission verdicts are part of the request's trace: the
            # serve_request event carries the same trace_id (= rid) the
            # execution's spans do, so shed/rejected requests trace too
            "trace_id": rid,
            "query": query,
            "verdict": verdict,
        }
        if rows is not None:
            fields["rows"] = int(rows)
        if nbytes is not None:
            fields["bytes"] = int(nbytes)
        if tallies:
            fields.update(tallies)
        tracer.emit(
            "serve_request",
            tenant=tenant,
            status=status_label,
            dur_ms=round((time.perf_counter() - t0) * 1000.0, 3),
            http_status=int(http_status),
            **fields,
        )

    def _enter(self, tenant, rid=None):
        """Claim an admission slot (semaphore + per-tenant cap) or raise
        _ShedError. The semaphore wait is bounded so an overloaded
        endpoint answers 429 instead of stacking blocked client threads.

        The tenant-cap reservation is taken ATOMICALLY with the check —
        a burst from one tenant must not all pass the check before any
        of them increments (the semaphore wait between check and
        increment can last the whole admit timeout)."""
        with self._state_lock:
            if self._tenant_in_flight.get(tenant, 0) >= self.tenant_cap:
                raise _ShedError(
                    f"tenant {tenant!r} is at its in-flight cap "
                    f"({self.tenant_cap}); retry later"
                )
            self._tenant_in_flight[tenant] = (
                self._tenant_in_flight.get(tenant, 0) + 1
            )
        if not self._admission.acquire(timeout=self.admit_timeout_s):
            self._drop_tenant_slot(tenant)
            raise _ShedError(
                f"no admission slot free within {self.admit_timeout_s:.0f}s "
                f"({self.workers} workers); retry later"
            )
        with self._state_lock:
            # re-check the drain flag AFTER the (up to admit_timeout_s)
            # semaphore wait: a request queued before /drain must not
            # start executing after drain reported drained=true and the
            # process began exiting. Both this check-and-increment and
            # handle_drain's flag flip hold _state_lock, so a request
            # that passes here is visible to the drain poll before the
            # poll can observe in_flight == 0.
            if self.draining:
                self._admission.release()
                self._drop_tenant_slot_locked(tenant)
                raise _ShedError(
                    "service is draining", status=503, label="draining"
                )
            self._in_flight += 1
            if rid is not None:
                self._active_rids.add(rid)

    def _drop_tenant_slot(self, tenant):
        with self._state_lock:
            self._drop_tenant_slot_locked(tenant)

    def _drop_tenant_slot_locked(self, tenant):
        n = self._tenant_in_flight.get(tenant, 1) - 1
        if n <= 0:
            self._tenant_in_flight.pop(tenant, None)
        else:
            self._tenant_in_flight[tenant] = n

    def _leave(self, tenant, rid=None):
        release_now = []
        with self._state_lock:
            self._in_flight -= 1
            if rid is not None:
                self._active_rids.discard(rid)
                # /reload lease hygiene: a dropped pin's lease batch
                # releases once the last statement that was in flight at
                # reload time finishes (it may still be scanning the
                # pinned snapshot's files until then)
                kept = []
                for rids, lease_ids in self._deferred_leases:
                    rids &= self._active_rids
                    if rids:
                        kept.append((rids, lease_ids))
                    else:
                        release_now.extend(lease_ids)
                self._deferred_leases = kept
        if release_now:
            from ..lakehouse.leases import LEASES

            for lid in release_now:
                LEASES.release(lid)
        self._drop_tenant_slot(tenant)
        self._admission.release()

    def in_flight(self) -> int:
        with self._state_lock:
            return self._in_flight

    # ------------------------------------------------------------------
    # /query
    # ------------------------------------------------------------------
    def resolve_sql(self, payload):
        """The SQL text of a request: `sql` verbatim, or `template` looked
        up in the loaded stream templates with `${key}` params applied."""
        sql = payload.get("sql")
        if sql:
            return str(sql), None
        name = payload.get("template")
        if not name:
            raise ValueError("request needs 'sql' or 'template'")
        text = self.templates.get(str(name))
        if text is None:
            raise KeyError(f"unknown template {name!r}")
        for k, v in (payload.get("params") or {}).items():
            text = text.replace("${" + str(k) + "}", str(v))
        return text, str(name)

    def handle_query(self, payload, tenant, rid=None, request_key=None):
        rid = rid or uuid.uuid4().hex[:12]
        t0 = time.perf_counter()
        if self.draining:
            return self._shed_reply(
                rid, tenant, t0, "service is draining", status=503,
                label="draining",
            )
        # backpressure BEFORE the queue: past the RSS watermark the right
        # move is shedding load, not admitting more working sets
        watermark = host_rss_watermark(self.session)
        if watermark:
            r = rss_bytes()
            if r is not None and r >= watermark:
                return self._shed_reply(
                    rid, tenant, t0,
                    f"host RSS {r} is over the serve watermark {watermark}",
                    extra={"rss_bytes": int(r),
                           "watermark_bytes": int(watermark)},
                )
        try:
            sql_text, qlabel = self.resolve_sql(payload)
        except KeyError as exc:
            self._emit_request(rid, tenant, "failed", t0, 404)
            return self._reply(404, {"request_id": rid, "error": str(exc)})
        except ValueError as exc:
            self._emit_request(rid, tenant, "failed", t0, 400)
            return self._reply(400, {"request_id": rid, "error": str(exc)})
        try:
            # admission fault site (io/oom/hang/crash injectable): an
            # injected failure here sheds the request, never the server
            faults.maybe_fire("serve:admit")
            self._enter(tenant, rid)
        except _ShedError as exc:
            return self._shed_reply(
                rid, tenant, t0, exc.reason, status=exc.status,
                label=exc.label,
            )
        except faults.FaultError as exc:
            return self._shed_reply(
                rid, tenant, t0, f"admission fault: {exc}",
                extra={"failure_kind": faults.classify(exc)},
            )
        try:
            return self._admitted_query(
                payload, tenant, rid, t0, sql_text, qlabel,
                request_key=request_key,
            )
        finally:
            self._leave(tenant, rid)

    def _classify_statements(self, sql_text):
        stmts = parse_script(sql_text)
        if not stmts:
            raise ValueError("empty statement")
        if all(isinstance(s, A.SelectStmt) for s in stmts):
            if len(stmts) != 1:
                raise ValueError(
                    "serve mode runs one SELECT per request (split "
                    "multi-statement scripts client-side)"
                )
            return "select", stmts
        if any(isinstance(s, (A.CreateViewStmt, A.DropViewStmt))
               for s in stmts):
            # session-mutating DDL on the SHARED warm session would leak
            # one tenant's views into every other tenant's namespace
            raise ValueError(
                "CREATE/DROP VIEW is not allowed in serve mode "
                "(the session is shared across tenants)"
            )
        return "dml", stmts

    def _admitted_query(self, payload, tenant, rid, t0, sql_text, qlabel,
                        request_key=None):
        try:
            kind, stmts = self._classify_statements(sql_text)
        except Exception as exc:
            self._emit_request(rid, tenant, "failed", t0, 400, query=qlabel)
            return self._reply(400, {"request_id": rid, "error": str(exc)})
        if kind == "dml":
            return self._run_dml(
                sql_text, tenant, rid, t0, qlabel, request_key=request_key
            )
        # plan + capture THIS statement's budgeter verdict atomically
        # (Session.plan_stmt holds the cache lock): admission control.
        # The classification pass above already parsed — plan the AST.
        try:
            res, budget = self.session.plan_stmt(stmts[0])
        except PlanBudgetError as exc:
            # the 429-with-modeled-bytes contract: rejected BEFORE any
            # device dispatch, and the client learns why (how big the
            # plan modeled vs what the device budget admits)
            self._emit_request(
                rid, tenant, "rejected", t0, 429, query=qlabel,
                verdict="reject",
            )
            return self._reply(429, {
                "request_id": rid, "tenant": tenant, "status": "rejected",
                "verdict": "reject", "error": str(exc),
                "peak_bytes": int(exc.peak_bytes),
                "budget_bytes": int(exc.budget_bytes),
            })
        except Exception as exc:
            self._emit_request(rid, tenant, "failed", t0, 400, query=qlabel)
            return self._reply(400, {
                "request_id": rid, "error": f"{type(exc).__name__}: {exc}",
            })
        verdict = (budget or {}).get("verdict")
        qname = qlabel or f"serve-{rid}"
        summary, arrow, tallies = self._execute_select(
            res, qname, rid, tenant, budget
        )
        status = summary["queryStatus"][-1]
        if status == "Failed":
            body = {
                "request_id": rid, "tenant": tenant, "status": "failed",
                "query": qlabel, "verdict": verdict,
                "failure_kind": summary.get("failureKind"),
                "error": (summary.get("exceptions") or ["failed"])[-1],
                "retries": summary.get("retries", 0),
            }
            self._emit_request(
                rid, tenant, "failed", t0, 500, query=qlabel,
                verdict=verdict, tallies=tallies,
            )
            return self._reply(500, body)
        envelope = self._page(arrow, payload)
        envelope.update({
            "request_id": rid,
            "tenant": tenant,
            "status": "completed",
            "query": qlabel,
            # the admission echo: a degraded admit (blocked window /
            # planned spill / armed-over) is visible to the client, not
            # silently slower
            "verdict": verdict,
            "admitted_degraded": verdict in ("blocked", "spill", "over"),
            "retries": summary.get("retries", 0),
            "elapsed_ms": round((time.perf_counter() - t0) * 1000.0, 3),
        })
        if summary.get("ladder"):
            envelope["ladder"] = [r["rung"] for r in summary["ladder"]]
        body = json.dumps(envelope, default=str)
        self._emit_request(
            rid, tenant, "completed", t0, 200, query=qlabel,
            verdict=verdict, rows=envelope["row_count"], nbytes=len(body),
            tallies=tallies,
        )
        return (200, "application/json", body, ())

    def handle_plan(self, payload, tenant):
        """Verdict probe for the fleet router (POST /plan): resolve +
        classify + plan one statement and answer the budget verdict
        WITHOUT consuming an admission slot and WITHOUT emitting a
        serve_request event — an edge-rejected 429 must provably never
        cost a replica worker slot, and the probe must not show up in
        per-tenant serve accounting (the router's own route_request
        event is the probe's telemetry). Planning still serializes on
        the session cache lock, which is exactly the cost the router's
        verdict cache amortizes."""
        rid = uuid.uuid4().hex[:12]
        try:
            sql_text, _ = self.resolve_sql(payload)
        except KeyError as exc:
            return self._reply(404, {"request_id": rid, "error": str(exc)})
        except ValueError as exc:
            return self._reply(400, {"request_id": rid, "error": str(exc)})
        try:
            kind, stmts = self._classify_statements(sql_text)
        except Exception as exc:
            return self._reply(400, {"request_id": rid, "error": str(exc)})
        if kind == "dml":
            # DML never has a budget verdict; the router routes it by
            # class (writer path), not by verdict
            return self._reply(200, {
                "request_id": rid, "kind": "dml", "verdict": None,
            })
        try:
            _res, budget = self.session.plan_stmt(stmts[0])
        except PlanBudgetError as exc:
            # a probe answering "reject" is a 200: the PROBE succeeded;
            # the router turns the verdict into the client's 429
            return self._reply(200, {
                "request_id": rid, "kind": "select", "verdict": "reject",
                "error": str(exc),
                "peak_bytes": int(exc.peak_bytes),
                "budget_bytes": int(exc.budget_bytes),
            })
        except Exception as exc:
            return self._reply(400, {
                "request_id": rid, "error": f"{type(exc).__name__}: {exc}",
            })
        budget = budget or {}
        return self._reply(200, {
            "request_id": rid, "kind": "select",
            "verdict": budget.get("verdict"),
            "peak_bytes": budget.get("peak_bytes"),
            "budget_bytes": budget.get("budget_bytes"),
        })

    def _execute_select(self, res, qname, rid, tenant, budget):
        """Run one planned SELECT under the BenchReport failure ladder
        with a request-scoped tracer (on the admitted connection thread —
        the admission semaphore is the worker bound). Returns
        (summary, arrow-or-None, cache tallies)."""
        rt = _RequestTracer(
            getattr(self.session, "tracer", None), rid, tenant
        )
        report = BenchReport(self.session, tracer=rt)
        box = {}

        def run():
            with faults.scope(qname):
                # engine-side fault site: exercises the ladder (an
                # injected OOM recovers + retries) and the pool-health
                # contract (a crash kills one request, not the pool)
                faults.maybe_fire("serve:exec")
                # fleet chaos site: `hang` holds this request open for a
                # deterministic external SIGKILL window (a failover
                # drill); `crash` kills the connection thread
                # mid-request so the socket closes with NO reply — what a
                # mid-stream replica death looks like to the router. Fired
                # under the bound request tracer, so the fault_injected
                # event lands in this replica's log with the request's
                # trace_id (the failover trace evidence).
                faults.maybe_fire("replica:kill", kinds=("hang", "crash"))
                box["arrow"] = res.collect(tracer=rt)

        with obs_trace.bind(rt):
            summary = report.report_on(
                run, retry_oom=True, name=qname, request_id=rid,
                plan_budget=budget,
            )
        return summary, box.get("arrow"), dict(rt.tallies)

    def _page(self, arrow, payload) -> dict:
        """Row-cap + pagination: the response carries at most
        min(limit, engine.serve_row_cap) rows starting at `offset`."""
        total = arrow.num_rows
        try:
            offset = max(int(payload.get("offset") or 0), 0)
        except (TypeError, ValueError):
            offset = 0
        raw_limit = payload.get("limit")
        try:
            # `limit: 0` is a legitimate metadata-only probe (envelope
            # without row payload) — only an ABSENT limit defaults
            limit = self.row_cap if raw_limit is None else int(raw_limit)
        except (TypeError, ValueError):
            limit = self.row_cap
        limit = max(min(limit, self.row_cap), 0)
        window = arrow.slice(offset, limit)
        return {
            "columns": list(arrow.column_names),
            "rows": [list(r.values()) for r in window.to_pylist()],
            "row_count": window.num_rows,
            "total_rows": total,
            "offset": offset,
            "truncated": offset + window.num_rows < total,
        }

    # ------------------------------------------------------------------
    # DML (writer path)
    # ------------------------------------------------------------------
    #: DML idempotency keys remembered before FIFO eviction — deep enough
    #: that a router retry (seconds later) always finds its key, bounded
    #: so a long-lived replica never grows without limit
    DML_KEY_CAP = 1024

    def _dml_key_begin(self, key):
        """Claim a DML idempotency key. Returns "run" (first delivery —
        go), "inflight" (the original delivery is still executing: the
        duplicate is shed retryable instead of double-applying), or the
        recorded envelope dict (already committed: answer it verbatim,
        marked deduped)."""
        with self._state_lock:
            if key in self._dml_keys:
                hit = self._dml_keys[key]
                return "inflight" if hit is None else hit
            self._dml_keys[key] = None
            self._dml_key_order.append(key)
            while len(self._dml_key_order) > self.DML_KEY_CAP:
                self._dml_keys.pop(self._dml_key_order.pop(0), None)
        return "run"

    def _dml_key_end(self, key, envelope):
        """Record the completed envelope under the key — or, on failure
        (envelope None), release the claim so the router's classified
        retry can re-run the statement (an aborted OCC commit published
        nothing)."""
        with self._state_lock:
            if envelope is None:
                if self._dml_keys.get(key, "x") is None:
                    del self._dml_keys[key]
                    try:
                        self._dml_key_order.remove(key)
                    except ValueError:
                        pass
            else:
                self._dml_keys[key] = dict(envelope)

    def _run_dml(self, sql_text, tenant, rid, t0, qlabel,
                 request_key=None):
        """DML on the writer session, serialized in-process: statement-
        level commit-conflict re-runs ride maintenance's one retry home
        (an aborted OCC commit published nothing, so the re-run derives
        its writes from the fresh head). Readers never block — their
        statements pin the pre-commit snapshot.

        The writer lock is held by THIS (connection) thread around the
        report, never inside `run`: with a watchdog budget configured,
        report_on runs `run` on an abandonable daemon worker, and a
        lock taken there would be held FOREVER by a hung-then-abandoned
        attempt (DML down until restart). The cost of the handler-side
        lock: a watchdog-abandoned DML zombie may still be committing
        while the next DML starts — safe, because OCC commits arbitrate
        concurrent in-process writers anyway (the lock is contention
        avoidance, not the correctness mechanism)."""
        from ..maintenance import _run_dm_statement

        if request_key:
            # idempotency guard (router-minted x-nds-request-key): a
            # re-delivered committed DML answers the recorded envelope;
            # a concurrent duplicate sheds instead of double-applying
            claim = self._dml_key_begin(request_key)
            if claim == "inflight":
                return self._shed_reply(
                    rid, tenant, t0,
                    f"request key {request_key!r} is already in flight; "
                    "retry",
                )
            if isinstance(claim, dict):
                envelope = dict(claim)
                envelope.update({"request_id": rid, "deduped": True})
                self._emit_request(
                    rid, tenant, "completed", t0, 200, query=qlabel
                )
                return self._reply(200, envelope)
        session = self.writer_session or self.session
        qname = qlabel or f"serve-dm-{rid}"
        rt = _RequestTracer(getattr(session, "tracer", None), rid, tenant)
        report = BenchReport(session, tracer=rt)
        box = {}

        def run():
            with faults.scope(qname):
                faults.maybe_fire("serve:exec")
                box["result"] = _run_dm_statement(session, sql_text)

        try:
            with obs_trace.bind(rt), self._writer_lock:
                summary = report.report_on(
                    run, retry_oom=False, name=qname, request_id=rid,
                )
        except BaseException:
            # includes InjectedCrash: the claim must not orphan — the
            # router's classified retry needs to be able to re-run
            if request_key:
                self._dml_key_end(request_key, None)
            raise
        status = summary["queryStatus"][-1]
        if status == "Failed":
            if request_key:
                self._dml_key_end(request_key, None)
            self._emit_request(
                rid, tenant, "failed", t0, 500, query=qlabel,
                tallies=dict(rt.tallies),
            )
            return self._reply(500, {
                "request_id": rid, "tenant": tenant, "status": "failed",
                "failure_kind": summary.get("failureKind"),
                "error": (summary.get("exceptions") or ["failed"])[-1],
            })
        result = box.get("result")
        rows = getattr(result, "rows_affected", None)
        envelope = {
            "request_id": rid, "tenant": tenant, "status": "completed",
            "statement": "dml",
            "rows_affected": rows,
            "version": getattr(result, "version", None),
            "elapsed_ms": round((time.perf_counter() - t0) * 1000.0, 3),
        }
        if request_key:
            self._dml_key_end(request_key, envelope)
        self._emit_request(
            rid, tenant, "completed", t0, 200, query=qlabel, rows=rows,
            tallies=dict(rt.tallies),
        )
        return self._reply(200, envelope)

    # ------------------------------------------------------------------
    # stream jobs + admin verbs
    # ------------------------------------------------------------------
    def handle_stream(self, payload, tenant):
        try:
            job = self.jobs.submit(
                stream=payload.get("stream"),
                job_id=payload.get("job_id"),
                sub_queries=payload.get("queries"),
                tenant=tenant,
            )
        except (ValueError, OSError) as exc:
            return self._reply(400, {"error": str(exc)})
        return self._reply(202, job)

    def handle_job_get(self, job_id):
        job = self.jobs.get(job_id)
        if job is None:
            return self._reply(404, {"error": f"unknown job {job_id!r}"})
        return self._reply(200, job)

    def handle_drain(self):
        """Stop admitting, wait (bounded) for in-flight work. /healthz
        turns 503 `draining` the moment the flag is set, so a load
        balancer stops routing BEFORE the pool empties. The flag flips
        under _state_lock so it orders against _enter's post-acquire
        re-check: every request the drain poll can miss is one that
        will shed instead of executing."""
        with self._state_lock:
            self.draining = True
        deadline = time.monotonic() + self.drain_timeout_s
        while self.in_flight() > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        remaining = self.in_flight()
        return self._reply(200, {
            "draining": True,
            "drained": remaining == 0,
            "in_flight": remaining,
            "jobs_paused": self.jobs.running_count(),
        })

    def handle_reload(self):
        """Re-resolve the warehouse: drop every snapshot pin + cached
        device column (and run the CLI-provided re-registration when
        wired) so the next statements read fresh lakehouse heads / newly
        added tables. In-flight statements keep their plan-time pins."""
        reloaded = {"reloaded": True}
        sessions = [self.session]
        if self.writer_session is not None:
            sessions.append(self.writer_session)
        if self._reload_fn is not None:
            reloaded["tables"] = self._reload_fn()
        dropped = []
        for s in sessions:
            s._catalog_changed()  # plan/join-order caches may be stale
            for e in s.catalog.entries.values():
                e.device_cols = {}
                e.nrows = None
                e.pk_verified = None
                # drop the pin WITHOUT releasing its reader lease here
                # (catalog.invalidate would): an in-flight statement may
                # still be scanning the pinned snapshot's files, and
                # releasing mid-scan would expose them to a concurrent
                # vacuum. The lease is released when the LAST statement
                # that was in flight at this reload finishes (below);
                # TTL expiry remains the crash backstop.
                e.pinned_version = None
                e.pinned_snapshot = None
                if e.lease_id is not None:
                    dropped.append(e.lease_id)
                    e.lease_id = None
        if dropped:
            release_now = []
            with self._state_lock:
                if self._active_rids:
                    self._deferred_leases.append(
                        (set(self._active_rids), dropped)
                    )
                else:
                    release_now = dropped
            if release_now:
                from ..lakehouse.leases import LEASES

                for lid in release_now:
                    LEASES.release(lid)
            reloaded["leases_dropped"] = len(dropped)
            reloaded["leases_deferred"] = 0 if release_now else len(dropped)
        reloaded["sessions"] = len(sessions)
        # a reloaded replica re-enters service: the rolling fleet recipe
        # is drain -> reload -> resume, and /reload is the resume (the
        # router stops routing the moment /healthz flips 503 on drain,
        # and starts again when the reload answer arrives)
        with self._state_lock:
            reloaded["undrained"] = self.draining
            self.draining = False
        return self._reply(200, reloaded)

    def close(self):
        """Terminal: stop admitting (tests + CLI shutdown). Idempotent.
        The flag flips under _state_lock like handle_drain's: an unlocked
        write would not order against _enter's post-acquire re-check, so
        a request could start executing after close() returned."""
        with self._state_lock:
            self.draining = True
