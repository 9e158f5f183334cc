"""Live in-process telemetry: the metrics registry + run status behind
the `/metrics` and `/statusz` HTTP endpoints (obs/httpserv.py).

PR 3 built the POST-HOC half of observability (event log + profiler); this
module is the LIVE half, the reference analogue of Spark's driver-UI /
metrics system that the RAPIDS tools only post-process. A `MetricsSink`
rides the existing `Tracer.emit` seam: every event a traced run already
emits (op_span, query_span, exec_cache, ladder_rung, heartbeat, ...)
also updates thread-safe counters / gauges / bounded-bucket histograms
plus an in-flight run status, so a 30-minute bench or a hung stream is
inspectable while it runs instead of only after the log folds in.

Zero-cost contract (same as trace.py): with `engine.metrics_port` /
`NDS_METRICS_PORT` unset nothing here is constructed — `maybe_serve`
returns None after one conf lookup + one env read, `Tracer.sink` stays
None, and every hot instrumentation point still pays a single `is None`
check. With the port set but no trace dir, `tracer_from_conf` builds a
SINK-ONLY tracer (no file, no in-memory list) so the live counters work
without paying event-log disk.

Metric-taxonomy contract: every metric family name derives from the
EVENT_SCHEMA kind that feeds it — METRIC_KINDS below maps family ->
source kind, and the `trace-event-schema` lint rule enforces both that
the kind exists and that the family name embeds it, so live metric names
cannot drift from the event taxonomy (no free-floating names).

The sink and server are process-wide singletons on purpose: a throughput
run's per-stream sessions share one exposition endpoint (counters
aggregate across streams, like Spark executors reporting into one driver
UI), and subprocess children that inherit NDS_METRICS_PORT but lose the
bind race just keep their sink un-exposed (observability never takes the
benchmark down).
"""

from __future__ import annotations

import os
import re
import time

from ..engine.lockdebug import make_lock
from .trace import EVENT_SCHEMA


#: metric family -> the EVENT_SCHEMA kind that feeds it. The lint rule
#: `trace-event-schema` (analysis/lint.py) enforces that every value is a
#: schema kind and every key embeds its kind; the registry refuses names
#: outside this map at runtime (the belt to lint's suspenders).
METRIC_KINDS = {
    "nds_op_span_total": "op_span",
    "nds_op_span_ms_total": "op_span",
    "nds_query_span_total": "query_span",
    "nds_query_span_ms_total": "query_span",
    "nds_query_span_dur_ms": "query_span",          # histogram
    "nds_query_span_mem_hw_bytes": "query_span",    # gauge (high-water)
    "nds_plan_cache_total": "plan_cache",
    "nds_catalog_load_total": "catalog_load",
    "nds_exec_cache_total": "exec_cache",
    "nds_aot_cache_total": "aot_cache",
    "nds_aot_cache_bytes_total": "aot_cache",
    "nds_aot_cache_ms_total": "aot_cache",
    "nds_pipeline_span_total": "pipeline_span",
    "nds_kernel_span_total": "kernel_span",
    "nds_kernel_span_ms_total": "kernel_span",
    "nds_blocked_union_total": "blocked_union",
    "nds_blocked_union_windows_total": "blocked_union",
    "nds_exchange_total": "exchange",
    "nds_exchange_bytes_total": "exchange",
    "nds_exchange_retries_total": "exchange",
    "nds_exchange_skew": "exchange",                # gauge (latest ratio)
    "nds_mesh_fallback_total": "mesh_fallback",
    "nds_spill_total": "spill",
    "nds_spill_bytes_in_total": "spill",
    "nds_spill_bytes_out_total": "spill",
    "nds_spill_evictions_total": "spill",
    "nds_lake_commit_total": "lake_commit",
    "nds_lake_commit_attempts_total": "lake_commit",
    "nds_lake_vacuum_total": "lake_vacuum",
    "nds_lake_vacuum_files_total": "lake_vacuum",
    "nds_ingest_chunk_total": "ingest_chunk",
    "nds_ingest_chunk_rows_total": "ingest_chunk",
    "nds_ingest_chunk_decode_ms_total": "ingest_chunk",
    "nds_ingest_chunk_commit_ms_total": "ingest_chunk",
    "nds_scan_prune_total": "scan_prune",
    "nds_scan_prune_files_total": "scan_prune",
    "nds_scan_prune_files_pruned_total": "scan_prune",
    "nds_catalog_commit_total": "catalog_commit",
    "nds_catalog_commit_ms_total": "catalog_commit",
    "nds_catalog_lease_total": "catalog_lease",
    "nds_fault_injected_total": "fault_injected",
    "nds_ladder_rung_total": "ladder_rung",
    "nds_watchdog_fire_total": "watchdog_fire",
    "nds_io_retry_total": "io_retry",
    "nds_phase_total": "phase",
    "nds_child_stream_total": "child_stream",
    "nds_plan_verify_total": "plan_verify",
    "nds_plan_budget_total": "plan_budget",
    "nds_plan_feedback_total": "plan_feedback",
    "nds_plan_feedback_overrides_total": "plan_feedback",
    "nds_plan_feedback_err_median": "plan_feedback",  # gauge (|log| median)
    "nds_mem_watermark_total": "mem_watermark",
    "nds_heartbeat_total": "heartbeat",
    "nds_heartbeat_rss_bytes": "heartbeat",         # gauge (latest)
    "nds_heartbeat_elapsed_ms": "heartbeat",        # gauge (latest)
    "nds_lock_contention_total": "lock_contention",
    "nds_lock_contention_wait_ms": "lock_contention",  # histogram
    "nds_serve_request_total": "serve_request",
    "nds_serve_request_ms_total": "serve_request",
    "nds_serve_request_dur_ms": "serve_request",    # histogram (p99 scrape)
    "nds_serve_request_rows_total": "serve_request",
    "nds_serve_request_bytes_total": "serve_request",
    "nds_route_request_total": "route_request",
    "nds_route_request_ms_total": "route_request",
    "nds_route_request_dur_ms": "route_request",    # histogram (fleet p99)
    "nds_route_retry_total": "route_retry",
}

#: bounded histogram buckets (ms): an hour-long query lands in +Inf, the
#: bucket count never grows past this tuple (the "bounded-bucket" half of
#: the registry contract — no per-value allocation on the hot path)
HIST_BUCKETS_MS = (
    5.0, 20.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
    15000.0, 60000.0,
)


def resolve_metrics_port(conf: dict | None = None):
    """The metrics endpoint port from conf `engine.metrics_port`, else
    NDS_METRICS_PORT; None (telemetry disabled — the default) when neither
    is set. 0 binds an OS-assigned ephemeral port (read it back from
    `MetricsServer.port` / `active_server()` — the CI e2e mode)."""
    v = None
    if conf:
        v = conf.get("engine.metrics_port")
    if v is None:
        v = os.environ.get("NDS_METRICS_PORT")
    if v is None or str(v).strip().lower() in ("", "off", "none"):
        return None
    try:
        port = int(v)
    except (TypeError, ValueError):
        return None
    return port if port >= 0 else None


def _esc(value) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (
        str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


class MetricsRegistry:
    """Thread-safe counters, gauges, and bounded-bucket histograms with
    Prometheus text exposition (`render`).

    Families must be registered in METRIC_KINDS (names derive from event
    kinds — the lint-enforced taxonomy contract); series within a family
    are keyed by their sorted label items. All mutators take one short
    lock; there is no per-series allocation after first touch."""

    def __init__(self):
        self._lock = make_lock("MetricsRegistry._lock")
        # (name, labels) -> float                # nds-guarded-by: _lock
        self._counters = {}
        # (name, labels) -> float                # nds-guarded-by: _lock
        self._gauges = {}
        # (name, labels) -> [bucket cts, +Inf]   # nds-guarded-by: _lock
        self._hists = {}
        # (name, labels) -> (sum, count)         # nds-guarded-by: _lock
        self._hist_sum = {}
        # family -> counter|gauge|histogram      # nds-guarded-by: _lock
        self._types = {}

    @staticmethod
    def _key(name, labels):
        if name not in METRIC_KINDS:
            raise ValueError(
                f"metric family {name!r} is not registered in "
                f"obs/metrics.py:METRIC_KINDS (names must derive from "
                f"EVENT_SCHEMA kinds)"
            )
        return (name, tuple(sorted(labels.items())))

    def inc(self, name, value=1.0, **labels):
        key = self._key(name, labels)
        with self._lock:
            self._types.setdefault(name, "counter")
            self._counters[key] = self._counters.get(key, 0.0) + float(value)

    def set_gauge(self, name, value, **labels):
        key = self._key(name, labels)
        with self._lock:
            self._types.setdefault(name, "gauge")
            self._gauges[key] = float(value)

    def max_gauge(self, name, value, **labels):
        """Gauge that only ratchets upward (high-water marks)."""
        key = self._key(name, labels)
        with self._lock:
            self._types.setdefault(name, "gauge")
            cur = self._gauges.get(key)
            if cur is None or float(value) > cur:
                self._gauges[key] = float(value)

    def observe(self, name, value, **labels):
        key = self._key(name, labels)
        v = float(value)
        with self._lock:
            self._types.setdefault(name, "histogram")
            counts = self._hists.get(key)
            if counts is None:
                counts = self._hists[key] = [0] * (len(HIST_BUCKETS_MS) + 1)
                self._hist_sum[key] = (0.0, 0)
            for i, bound in enumerate(HIST_BUCKETS_MS):
                if v <= bound:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            s, n = self._hist_sum[key]
            self._hist_sum[key] = (s + v, n + 1)

    # -- reads -----------------------------------------------------------
    def counter_value(self, name, **labels) -> float:
        with self._lock:
            return self._counters.get(self._key(name, labels), 0.0)

    def counter_series(self, name) -> dict:
        """{label-items-tuple: value} for one counter family."""
        with self._lock:
            return {
                k[1]: v for k, v in self._counters.items() if k[0] == name
            }

    # -- exposition ------------------------------------------------------
    def render(self) -> str:
        """Prometheus text exposition format (0.0.4) of every series."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: list(v) for k, v in self._hists.items()}
            hist_sum = dict(self._hist_sum)
            types = dict(self._types)
        out = []

        def fmt(value):
            f = float(value)
            return str(int(f)) if f == int(f) else repr(f)

        def series_line(name, labels, value, suffix="", extra=()):
            items = tuple(labels) + tuple(extra)
            lbl = (
                "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in items) + "}"
                if items
                else ""
            )
            out.append(f"{name}{suffix}{lbl} {fmt(value)}")

        for name in sorted(types):
            kind = types[name]
            out.append(f"# TYPE {name} {kind}")
            if kind == "counter":
                for (n, labels), v in sorted(counters.items()):
                    if n == name:
                        series_line(name, labels, v)
            elif kind == "gauge":
                for (n, labels), v in sorted(gauges.items()):
                    if n == name:
                        series_line(name, labels, v)
            else:  # histogram
                for (n, labels), counts in sorted(hists.items()):
                    if n != name:
                        continue
                    cum = 0
                    for i, bound in enumerate(HIST_BUCKETS_MS):
                        cum += counts[i]
                        series_line(name, labels, cum, "_bucket",
                                    extra=(("le", fmt(bound)),))
                    cum += counts[-1]
                    series_line(name, labels, cum, "_bucket",
                                extra=(("le", "+Inf"),))
                    s, cnt = hist_sum[(n, labels)]
                    series_line(name, labels, s, "_sum")
                    series_line(name, labels, cnt, "_count")
        return "\n".join(out) + ("\n" if out else "")


_NAME_RE = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LABEL_RE = rf'{_NAME_RE}="(?:[^"\\\n]|\\["\\n])*"'
_VALUE_RE = r"(?:[+-]?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?|[+-]Inf|NaN)"
_SAMPLE_RE = re.compile(
    rf"^{_NAME_RE}(?:\{{{_LABEL_RE}(?:,{_LABEL_RE})*\}})? {_VALUE_RE}$"
)
_COMMENT_RE = re.compile(rf"^# (?:TYPE|HELP) {_NAME_RE}( .*)?$")


def validate_exposition(text: str) -> list:
    """Problems with a /metrics payload as strings (empty == valid):
    every line must be a well-formed comment or sample, and every sample's
    family must be TYPE-declared first. The CI e2e scrapes mid-run and
    fails on any finding (the exposition-format half of the live gate)."""
    problems = []
    declared = set()
    for i, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("#"):
            m = _COMMENT_RE.match(line)
            if not m:
                problems.append(f"line {i}: malformed comment: {line[:120]!r}")
            else:
                declared.add(line.split()[2])
            continue
        if not _SAMPLE_RE.match(line):
            problems.append(f"line {i}: malformed sample: {line[:120]!r}")
            continue
        family = re.split(r"[{ ]", line, maxsplit=1)[0]
        base = re.sub(r"_(bucket|sum|count)$", "", family)
        if family not in declared and base not in declared:
            problems.append(
                f"line {i}: sample {family!r} before its # TYPE declaration"
            )
    return problems


class MetricsSink:
    """Event -> live-telemetry bridge: `record(ev)` (called by
    `Tracer.emit` for every event) updates the registry and the in-flight
    run status; `status_snapshot()` is the /statusz payload.

    `record` must never take the run down: handler failures are swallowed
    (the same contract as a broken trace dir disabling its tracer)."""

    def __init__(self):
        self.registry = MetricsRegistry()
        self._slock = make_lock("MetricsSink._slock")
        self._status = {  # nds-guarded-by: _slock
            "pid": os.getpid(),
            "started_ts_ms": int(time.time() * 1000),
            "phase": None,
            "last_phase": None,
            "queries_completed": 0,
            "queries_failed": 0,
            "heartbeat_ts_ms": None,
            "rss_bytes": None,
            "mem_hw_bytes": None,
            "mem_source": None,
        }
        # keyed (app id, query name, request id): thread-mode throughput
        # streams share this process-wide sink and may run the SAME query
        # concurrently — a name-only key would let stream B's start
        # clobber stream A's record and A's finish retire B's (hiding a
        # live hang). The request id (serve mode) extends the same
        # guarantee to one SESSION: two tenants re-running one template
        # concurrently share the app id, so only the per-request id keeps
        # their in-flight records apart. Non-serve callers pass None and
        # keep the (app, query) semantics unchanged.
        self._in_flight = {}  # nds-guarded-by: _slock
        # router-process hook (serve/router.py): a callable returning the
        # live fleet view (replica health, degraded capabilities, tenant
        # in-flight) merged into /statusz's "fleet" section at snapshot
        # time — the router owns that state, the sink only tallies events
        # single-reference swap, installed once at router startup;
        # readers tolerate either value
        self._fleet_provider = None  # nds-guarded-by: none

    def set_fleet_provider(self, fn):
        """Install the router's fleet-snapshot callable (or None to
        clear). Called OUTSIDE the status lock at snapshot time."""
        self._fleet_provider = fn

    # -- direct harness hooks -------------------------------------------
    def query_started(self, name, app=None, request_id=None):
        """BenchReport marks the query in flight BEFORE the first attempt
        (query_span only exists at the end — too late for /statusz).
        `app` is the emitting tracer's app id, the same value the query's
        events will carry, so event handlers find this record;
        `request_id` (serve mode) disambiguates concurrent identical
        queries on one session."""
        with self._slock:
            self._in_flight[(app, str(name), request_id)] = {
                "query": str(name),
                "app": app,
                **({"request_id": request_id} if request_id else {}),
                "started_ts_ms": int(time.time() * 1000),
                "_mono": time.perf_counter(),
                "attempt": 1,
                "ladder": [],
            }

    @staticmethod
    def _flight_key(ev):
        return (ev.get("app"), str(ev.get("query")), ev.get("request_id"))

    # -- event dispatch --------------------------------------------------
    def record(self, ev: dict):
        handler = _HANDLERS.get(ev.get("kind"))
        if handler is None:
            return
        try:
            handler(self, ev)
        except Exception:
            pass  # live telemetry must never take the benchmark down

    def _h_op_span(self, ev):
        node = str(ev.get("node"))
        self.registry.inc("nds_op_span_total", node=node)
        self.registry.inc(
            "nds_op_span_ms_total", float(ev.get("dur_ms") or 0.0), node=node
        )

    def _h_query_span(self, ev):
        status = str(ev.get("status"))
        dur = float(ev.get("dur_ms") or 0.0)
        self.registry.inc("nds_query_span_total", status=status)
        self.registry.inc("nds_query_span_ms_total", dur)
        self.registry.observe("nds_query_span_dur_ms", dur)
        if ev.get("mem_hw_bytes") is not None:
            self.registry.max_gauge(
                "nds_query_span_mem_hw_bytes", int(ev["mem_hw_bytes"])
            )
        with self._slock:
            self._in_flight.pop(self._flight_key(ev), None)
            if status == "Failed":
                self._status["queries_failed"] += 1
            else:
                self._status["queries_completed"] += 1
            if ev.get("mem_hw_bytes") is not None:
                cur = self._status["mem_hw_bytes"] or 0
                if int(ev["mem_hw_bytes"]) > cur:
                    self._status["mem_hw_bytes"] = int(ev["mem_hw_bytes"])
                    self._status["mem_source"] = ev.get("mem_source")
            if isinstance(ev.get("mem_hw_per_device"), list):
                self._merge_device_hw_locked(ev["mem_hw_per_device"])

    def _h_plan_cache(self, ev):
        self.registry.inc(
            "nds_plan_cache_total", result="hit" if ev.get("hit") else "miss"
        )

    def _h_catalog_load(self, ev):
        self.registry.inc(
            "nds_catalog_load_total", cache=str(ev.get("cache"))
        )

    def _h_exec_cache(self, ev):
        self.registry.inc(
            "nds_exec_cache_total", result="hit" if ev.get("hit") else "miss"
        )

    def _h_aot_cache(self, ev):
        op = str(ev.get("op"))
        result = str(ev.get("result"))
        self.registry.inc("nds_aot_cache_total", op=op, result=result)
        if ev.get("bytes") is not None:
            self.registry.inc(
                "nds_aot_cache_bytes_total", int(ev["bytes"]), op=op
            )
        if ev.get("dur_ms") is not None:
            self.registry.inc(
                "nds_aot_cache_ms_total", float(ev["dur_ms"]), op=op
            )

    def _h_pipeline_span(self, ev):
        self.registry.inc(
            "nds_pipeline_span_total",
            fused="true" if ev.get("fused") else "false",
        )

    def _h_kernel_span(self, ev):
        kernel = str(ev.get("kernel"))
        self.registry.inc("nds_kernel_span_total", kernel=kernel)
        self.registry.inc(
            "nds_kernel_span_ms_total", float(ev.get("dur_ms") or 0.0),
            kernel=kernel,
        )

    def _h_exchange(self, ev):
        self.registry.inc("nds_exchange_total", op=str(ev.get("op")))
        self.registry.inc(
            "nds_exchange_bytes_total", int(ev.get("bytes_moved") or 0)
        )
        self.registry.inc(
            "nds_exchange_retries_total", int(ev.get("retries") or 0)
        )
        try:
            self.registry.set_gauge(
                "nds_exchange_skew", float(ev.get("skew") or 1.0)
            )
        except (TypeError, ValueError):
            pass
        with self._slock:
            mesh = self._status.setdefault("mesh", {})
            mesh["last_exchange"] = {
                "op": ev.get("op"),
                "partitions": ev.get("partitions"),
                "bytes_moved": ev.get("bytes_moved"),
                "skew": ev.get("skew"),
                "retries": ev.get("retries"),
                "ts": ev.get("ts"),
                **({"per_device": list(ev["per_device"])}
                   if isinstance(ev.get("per_device"), list) else {}),
            }

    def _merge_device_hw_locked(self, per_dev):
        """Element-wise max-merge per-device HBM samples into the mesh
        section (caller holds _slock)."""
        mesh = self._status.setdefault("mesh", {})
        hw = mesh.setdefault("device_mem_hw", [])
        for i, b in enumerate(per_dev):
            b = int(b)
            if i < len(hw):
                if b > hw[i]:
                    hw[i] = b
            else:
                hw.append(b)

    def _h_mesh_fallback(self, ev):
        self.registry.inc(
            "nds_mesh_fallback_total", table=str(ev.get("table"))
        )

    def _h_spill(self, ev):
        self.registry.inc("nds_spill_total", op=str(ev.get("op")))
        self.registry.inc(
            "nds_spill_bytes_in_total", int(ev.get("bytes_in") or 0)
        )
        self.registry.inc(
            "nds_spill_bytes_out_total", int(ev.get("bytes_out") or 0)
        )
        self.registry.inc(
            "nds_spill_evictions_total", int(ev.get("evictions") or 0)
        )

    def _h_blocked_union(self, ev):
        self.registry.inc("nds_blocked_union_total")
        self.registry.inc(
            "nds_blocked_union_windows_total", int(ev.get("windows") or 0)
        )

    def _h_lake_commit(self, ev):
        status = "conflict" if ev.get("conflict") else (
            "rebased" if ev.get("rebased") else "ok"
        )
        self.registry.inc(
            "nds_lake_commit_total",
            operation=str(ev.get("operation")), status=status,
        )
        self.registry.inc(
            "nds_lake_commit_attempts_total", int(ev.get("attempts") or 1)
        )

    def _h_lake_vacuum(self, ev):
        self.registry.inc("nds_lake_vacuum_total", table=str(ev.get("table")))
        self.registry.inc(
            "nds_lake_vacuum_files_total", int(ev.get("files_removed") or 0)
        )

    def _layout_status_locked(self, ev):
        """The /statusz `layout` section (caller holds _slock): the data-
        layout subsystem's live tallies — ingest chunk progress on the
        fill side, zone-map pruning effectiveness on the scan side.
        Scalars only, so status_snapshot's one-level copy suffices."""
        lay = self._status.setdefault("layout", {
            "ingest_chunks": 0, "ingest_rows": 0, "ingest_skipped": 0,
            "last_ingest_table": None, "prunes": 0, "files_seen": 0,
            "files_pruned": 0, "last_prune_table": None,
            "last_ts_ms": None,
        })
        lay["last_ts_ms"] = ev.get("ts")
        return lay

    def _h_ingest_chunk(self, ev):
        table = str(ev.get("table"))
        skipped = bool(ev.get("skipped"))
        self.registry.inc(
            "nds_ingest_chunk_total", table=table,
            status="skipped" if skipped else "ok",
        )
        self.registry.inc(
            "nds_ingest_chunk_rows_total", int(ev.get("rows") or 0)
        )
        self.registry.inc(
            "nds_ingest_chunk_decode_ms_total",
            float(ev.get("decode_ms") or 0.0),
        )
        self.registry.inc(
            "nds_ingest_chunk_commit_ms_total",
            float(ev.get("commit_ms") or 0.0),
        )
        with self._slock:
            lay = self._layout_status_locked(ev)
            lay["ingest_chunks"] += 1
            lay["ingest_rows"] += int(ev.get("rows") or 0)
            if skipped:
                lay["ingest_skipped"] += 1
            lay["last_ingest_table"] = ev.get("table")

    def _h_scan_prune(self, ev):
        self.registry.inc(
            "nds_scan_prune_total", table=str(ev.get("table"))
        )
        self.registry.inc(
            "nds_scan_prune_files_total", int(ev.get("files_total") or 0)
        )
        self.registry.inc(
            "nds_scan_prune_files_pruned_total",
            int(ev.get("files_pruned") or 0),
        )
        with self._slock:
            lay = self._layout_status_locked(ev)
            lay["prunes"] += 1
            lay["files_seen"] += int(ev.get("files_total") or 0)
            lay["files_pruned"] += int(ev.get("files_pruned") or 0)
            lay["last_prune_table"] = ev.get("table")

    def _catalog_status_locked(self, ev):
        """The /statusz `catalog` section (caller holds _slock): scalar
        tallies only, so status_snapshot's one-level dict copy suffices."""
        cat = self._status.setdefault("catalog", {
            "backend": None, "commits": 0, "conflicts": 0, "fenced": 0,
            "rolled_back": 0, "unreachable": 0, "expired": 0,
            "lease_ops": 0, "fence": None, "last_table": None,
            "last_version": None, "last_ts_ms": None,
        })
        cat["backend"] = ev.get("backend")
        cat["last_ts_ms"] = ev.get("ts")
        return cat

    def _h_catalog_commit(self, ev):
        outcome = str(ev.get("outcome"))
        backend = str(ev.get("backend"))
        self.registry.inc(
            "nds_catalog_commit_total", backend=backend, outcome=outcome
        )
        if ev.get("dur_ms") is not None:
            self.registry.inc(
                "nds_catalog_commit_ms_total", float(ev["dur_ms"]),
                backend=backend,
            )
        with self._slock:
            cat = self._catalog_status_locked(ev)
            key = {
                "ok": "commits", "conflict": "conflicts",
                "fenced": "fenced", "rolled_back": "rolled_back",
                "unreachable": "unreachable", "expired": "expired",
            }.get(outcome)
            if key:
                cat[key] += 1
            cat["last_table"] = ev.get("table")
            if outcome == "ok":
                cat["last_version"] = ev.get("version")

    def _h_catalog_lease(self, ev):
        self.registry.inc(
            "nds_catalog_lease_total",
            op=str(ev.get("op")), outcome=str(ev.get("outcome")),
        )
        with self._slock:
            cat = self._catalog_status_locked(ev)
            cat["lease_ops"] += 1
            if ev.get("fence") is not None:
                cat["fence"] = ev.get("fence")

    def _h_fault_injected(self, ev):
        self.registry.inc(
            "nds_fault_injected_total", kind=str(ev.get("fault_kind"))
        )

    def _h_ladder_rung(self, ev):
        self.registry.inc("nds_ladder_rung_total", rung=str(ev.get("rung")))
        with self._slock:
            rec = self._in_flight.get(self._flight_key(ev))
            if rec is not None:
                rec["attempt"] += 1
                rec["ladder"].append(str(ev.get("rung")))

    def _h_watchdog_fire(self, ev):
        self.registry.inc("nds_watchdog_fire_total")

    def _h_io_retry(self, ev):
        self.registry.inc("nds_io_retry_total")

    def _h_phase(self, ev):
        name = str(ev.get("phase"))
        event = str(ev.get("event"))
        self.registry.inc("nds_phase_total", phase=name, event=event)
        with self._slock:
            if event == "begin":
                self._status["phase"] = {
                    "name": name,
                    "index": ev.get("index"),
                    "total": ev.get("total"),
                    "since_ts_ms": ev.get("ts"),
                }
            else:
                cur = self._status.get("phase")
                if cur and cur.get("name") == name:
                    self._status["phase"] = None
                self._status["last_phase"] = {
                    "name": name, "status": ev.get("status"),
                }

    def _h_child_stream(self, ev):
        self.registry.inc("nds_child_stream_total")

    def _h_plan_verify(self, ev):
        self.registry.inc(
            "nds_plan_verify_total", ok="true" if ev.get("ok") else "false"
        )

    def _h_plan_budget(self, ev):
        self.registry.inc(
            "nds_plan_budget_total", verdict=str(ev.get("verdict"))
        )

    #: |log(est/actual)| bucket edges for the budgeter-accuracy median.
    #: Bounded on purpose: a long-lived service records one sample per
    #: executed feedback node forever, and an exact sample list would grow
    #: without limit. 0.69 ~= a 2x miss, 2.3 ~= a 10x miss.
    FEEDBACK_ERR_EDGES = (0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0)

    def _feedback_err_median_locked(self, fb):
        """Median |log(est/actual)| from the bounded bucket tallies —
        reported as the upper edge of the bucket the median sample falls
        in (the overflow bucket reports 2x the last edge). Caller holds
        _slock."""
        n = fb.get("err_n") or 0
        if not n:
            return None
        half = (n + 1) // 2
        acc = 0
        for i, c in enumerate(fb["err_buckets"]):
            acc += c
            if acc >= half:
                edges = self.FEEDBACK_ERR_EDGES
                return edges[i] if i < len(edges) else edges[-1] * 2
        return None

    def _h_plan_feedback(self, ev):
        op = str(ev.get("op"))
        self.registry.inc(
            "nds_plan_feedback_total", op=op, result=str(ev.get("result"))
        )
        if ev.get("overrides"):
            self.registry.inc(
                "nds_plan_feedback_overrides_total", int(ev["overrides"])
            )
        med = None
        with self._slock:
            fb = self._status.setdefault("feedback", {
                "lookups": 0, "hits": 0, "records": 0, "overrides": 0,
                "err_n": 0,
                "err_buckets": [0] * (len(self.FEEDBACK_ERR_EDGES) + 1),
                "mode": None, "last_verdict": None,
            })
            if op in ("consume", "annotate"):
                # budget-time event: one per budgeted plan, carries the
                # store's lookup/hit tallies for that plan
                fb["lookups"] += int(ev.get("lookups") or 0)
                fb["hits"] += int(ev.get("hits") or 0)
                fb["overrides"] += int(ev.get("overrides") or 0)
                if ev.get("mode") is not None:
                    fb["mode"] = str(ev["mode"])
                if ev.get("verdict") is not None:
                    fb["last_verdict"] = str(ev["verdict"])
            elif op == "record":
                fb["records"] += 1
                err = ev.get("abs_log_err")
                if err is not None:
                    e = float(err)
                    fb["err_n"] += 1
                    for i, hi in enumerate(self.FEEDBACK_ERR_EDGES):
                        if e <= hi:
                            fb["err_buckets"][i] += 1
                            break
                    else:
                        fb["err_buckets"][-1] += 1
                    med = self._feedback_err_median_locked(fb)
        if med is not None:
            self.registry.set_gauge("nds_plan_feedback_err_median", med)

    def _h_mem_watermark(self, ev):
        self.registry.inc("nds_mem_watermark_total")

    #: distinct tenants tracked before new ones fold into "__other__":
    #: the tenant header is client-controlled, and unbounded label values
    #: would grow process memory + Prometheus series cardinality forever
    #: on a long-lived service
    MAX_TENANT_SERIES = 64

    def _h_serve_request(self, ev):
        tenant = str(ev.get("tenant"))
        with self._slock:
            known = self._status.get("tenants") or {}
            if (
                tenant not in known
                and len(known) >= self.MAX_TENANT_SERIES
            ):
                tenant = "__other__"
        status = str(ev.get("status"))
        dur = float(ev.get("dur_ms") or 0.0)
        self.registry.inc(
            "nds_serve_request_total", tenant=tenant, status=status
        )
        self.registry.inc("nds_serve_request_ms_total", dur, tenant=tenant)
        # unlabeled histogram on purpose: the serve_bench p99 scrape wants
        # ONE bucket series to invert, not a per-tenant product
        self.registry.observe("nds_serve_request_dur_ms", dur)
        if ev.get("rows") is not None:
            self.registry.inc(
                "nds_serve_request_rows_total", int(ev["rows"]),
                tenant=tenant,
            )
        if ev.get("bytes") is not None:
            self.registry.inc(
                "nds_serve_request_bytes_total", int(ev["bytes"]),
                tenant=tenant,
            )
        with self._slock:
            tenants = self._status.setdefault("tenants", {})
            t = tenants.setdefault(tenant, {
                "requests": 0, "completed": 0, "failed": 0, "rejected": 0,
                "shed": 0, "draining": 0, "degraded": 0, "rows": 0,
                "bytes": 0, "ms_total": 0.0,
                "exec_cache_hits": 0, "exec_cache_lookups": 0,
                "plan_cache_hits": 0, "plan_cache_lookups": 0,
            })
            t["requests"] += 1
            if status in t:
                t[status] += 1
            if ev.get("verdict") in ("blocked", "spill", "over"):
                t["degraded"] += 1
            t["rows"] += int(ev.get("rows") or 0)
            t["bytes"] += int(ev.get("bytes") or 0)
            t["ms_total"] = round(t["ms_total"] + dur, 3)
            for k in ("exec_cache_hits", "exec_cache_lookups",
                      "plan_cache_hits", "plan_cache_lookups"):
                t[k] += int(ev.get(k) or 0)

    def _h_route_request(self, ev):
        """Router-edge accounting (serve/router.py): the same tenant
        folding bound as serve_request — the fleet tenants section is
        the per-tenant FLEET counter home (satellite: the per-replica
        serve_tenant_cap's router-enforced equivalent reports here)."""
        tenant = str(ev.get("tenant"))
        with self._slock:
            fleet = self._status.get("fleet") or {}
            known = fleet.get("tenants") or {}
            if (
                tenant not in known
                and len(known) >= self.MAX_TENANT_SERIES
            ):
                tenant = "__other__"
        status = str(ev.get("status"))
        dur = float(ev.get("dur_ms") or 0.0)
        self.registry.inc(
            "nds_route_request_total", tenant=tenant, status=status
        )
        self.registry.inc("nds_route_request_ms_total", dur, tenant=tenant)
        # unlabeled on purpose, like nds_serve_request_dur_ms: the fleet
        # bench p99 scrape inverts ONE bucket series
        self.registry.observe("nds_route_request_dur_ms", dur)
        with self._slock:
            fleet = self._status.setdefault("fleet", {
                "requests": 0, "edge_rejected": 0, "retries": 0,
                "tenants": {},
            })
            fleet["requests"] += 1
            if status == "rejected" or (
                status == "shed" and ev.get("replica") is None
            ):
                # answered at the edge: no replica worker slot consumed
                fleet["edge_rejected"] += 1
            tenants = fleet.setdefault("tenants", {})
            t = tenants.setdefault(tenant, {
                "requests": 0, "completed": 0, "failed": 0, "rejected": 0,
                "shed": 0, "draining": 0, "retries": 0, "ms_total": 0.0,
            })
            t["requests"] += 1
            if status in t:
                t[status] += 1
            t["retries"] += int(ev.get("retries") or 0)
            t["ms_total"] = round(t["ms_total"] + dur, 3)

    def _h_route_retry(self, ev):
        self.registry.inc(
            "nds_route_retry_total", reason=str(ev.get("reason"))
        )
        with self._slock:
            fleet = self._status.setdefault("fleet", {
                "requests": 0, "edge_rejected": 0, "retries": 0,
                "tenants": {},
            })
            fleet["retries"] += 1

    def _h_lock_contention(self, ev):
        self.registry.inc(
            "nds_lock_contention_total", lock=str(ev.get("lock") or "?")
        )
        # unlabeled histogram on purpose (like the request-duration one):
        # the question is "how long do waits run fleet-wide", per-lock
        # attribution comes from the counter + the event stream
        self.registry.observe(
            "nds_lock_contention_wait_ms", float(ev.get("wait_ms") or 0.0)
        )

    def _h_heartbeat(self, ev):
        self.registry.inc("nds_heartbeat_total")
        if ev.get("rss_bytes") is not None:
            self.registry.set_gauge(
                "nds_heartbeat_rss_bytes", int(ev["rss_bytes"])
            )
        self.registry.set_gauge(
            "nds_heartbeat_elapsed_ms", float(ev.get("elapsed_ms") or 0.0)
        )
        with self._slock:
            self._status["heartbeat_ts_ms"] = ev.get("ts")
            if ev.get("rss_bytes") is not None:
                self._status["rss_bytes"] = int(ev["rss_bytes"])
            if isinstance(ev.get("dev_bytes"), list):
                self._merge_device_hw_locked(ev["dev_bytes"])
            rec = self._in_flight.get(self._flight_key(ev))
            if rec is not None:
                rec["heartbeat_elapsed_ms"] = ev.get("elapsed_ms")

    # -- /statusz --------------------------------------------------------
    def _hit_rate(self, family, hit_label, hit_value):
        series = self.registry.counter_series(family)
        total = sum(series.values())
        hits = sum(
            v for labels, v in series.items()
            if (hit_label, hit_value) in labels
        )
        return {
            "hits": int(hits),
            "total": int(total),
            "rate": round(hits / total, 4) if total else None,
        }

    def status_snapshot(self) -> dict:
        now_ms = int(time.time() * 1000)
        now_mono = time.perf_counter()
        with self._slock:
            st = {
                k: (dict(v) if isinstance(v, dict) else v)
                for k, v in self._status.items()
            }
            if "mesh" in st:
                # deep-copy: the live list/dict keep mutating under this
                # lock after the snapshot escapes it
                mesh = self._status["mesh"]
                st["mesh"] = {
                    k: (list(v) if isinstance(v, list)
                        else dict(v) if isinstance(v, dict) else v)
                    for k, v in mesh.items()
                }
            if "tenants" in st:
                # deep-copy + derive per-tenant cache hit rates (the
                # shallow copy above would alias the live tallies)
                tenants = {}
                for name, t in self._status["tenants"].items():
                    t = dict(t)
                    for fam in ("exec_cache", "plan_cache"):
                        total = t.get(f"{fam}_lookups") or 0
                        t[f"{fam}_hit_rate"] = (
                            round(t[f"{fam}_hits"] / total, 4)
                            if total else None
                        )
                    tenants[name] = t
                st["tenants"] = tenants
            if "fleet" in st:
                # deep-copy: the tallies keep mutating under this lock
                fleet = self._status["fleet"]
                st["fleet"] = {
                    k: (
                        {tn: dict(t) for tn, t in v.items()}
                        if k == "tenants" else v
                    )
                    for k, v in fleet.items()
                }
            if "feedback" in st:
                # deep-copy: err_buckets is a live list mutating under
                # this lock after the snapshot escapes it
                fb = dict(self._status["feedback"])
                fb["err_buckets"] = list(fb["err_buckets"])
                fb["err_median"] = self._feedback_err_median_locked(fb)
                st["feedback"] = fb
            in_flight = []
            for rec in self._in_flight.values():
                rec = dict(rec)
                rec["elapsed_ms"] = round(
                    (now_mono - rec.pop("_mono")) * 1000, 1
                )
                rec["ladder"] = list(rec["ladder"])
                in_flight.append(rec)
        in_flight.sort(key=lambda r: -r["elapsed_ms"])
        st["in_flight"] = in_flight
        # the longest-running in-flight query is the hang-detection view
        st["query"] = in_flight[0] if in_flight else None
        st["caches"] = {
            "exec_cache": self._hit_rate("nds_exec_cache_total", "result", "hit"),
            "plan_cache": self._hit_rate("nds_plan_cache_total", "result", "hit"),
            "catalog": self._hit_rate("nds_catalog_load_total", "cache", "hit"),
        }
        fb = st.get("feedback")
        if fb:
            # budgeter accuracy: how wrong the static estimates are
            # (median |log(est/actual)| over recorded nodes), what verdicts
            # the budgeter handed out, and how often a lookup found a
            # recorded actual to override with
            lookups = fb.get("lookups") or 0
            verdicts = {}
            for labels, v in self.registry.counter_series(
                    "nds_plan_budget_total").items():
                for k, val in labels:
                    if k == "verdict":
                        verdicts[val] = verdicts.get(val, 0) + int(v)
            st["budgeter_accuracy"] = {
                "err_median": fb.get("err_median"),
                "err_samples": fb.get("err_n") or 0,
                "feedback_hit_rate": (
                    round((fb.get("hits") or 0) / lookups, 4)
                    if lookups else None
                ),
                "feedback_mode": fb.get("mode"),
                "verdicts": verdicts,
            }
        hb = st.get("heartbeat_ts_ms")
        # epoch-minus-epoch on purpose: heartbeat `ts` is the event's epoch
        # stamp (possibly from another thread's clock read) — there is no
        # monotonic pair to subtract; a rare NTP step skews one snapshot's
        # AGE display, never a recorded duration
        # nds-lint: disable=perf-counter
        st["heartbeat_age_ms"] = (now_ms - hb) if hb else None
        # nds-lint: disable=perf-counter
        st["uptime_ms"] = now_ms - st["started_ts_ms"]
        provider = self._fleet_provider
        if provider is not None:
            # live router state (replica health, degraded capabilities,
            # fleet tenant in-flight) — merged outside _slock: the
            # provider takes the router's own lock
            try:
                live = provider()
            except Exception:
                live = None
            if isinstance(live, dict):
                fleet = st.setdefault("fleet", {
                    "requests": 0, "edge_rejected": 0, "retries": 0,
                    "tenants": {},
                })
                fleet.update(live)
        return st


#: kind -> bound-method handler (resolved once at import; record() does a
#: single dict lookup per event — the sink's whole hot path)
_HANDLERS = {
    "op_span": MetricsSink._h_op_span,
    "query_span": MetricsSink._h_query_span,
    "plan_cache": MetricsSink._h_plan_cache,
    "catalog_load": MetricsSink._h_catalog_load,
    "exec_cache": MetricsSink._h_exec_cache,
    "aot_cache": MetricsSink._h_aot_cache,
    "pipeline_span": MetricsSink._h_pipeline_span,
    "kernel_span": MetricsSink._h_kernel_span,
    "blocked_union": MetricsSink._h_blocked_union,
    "exchange": MetricsSink._h_exchange,
    "mesh_fallback": MetricsSink._h_mesh_fallback,
    "spill": MetricsSink._h_spill,
    "lake_commit": MetricsSink._h_lake_commit,
    "lake_vacuum": MetricsSink._h_lake_vacuum,
    "ingest_chunk": MetricsSink._h_ingest_chunk,
    "scan_prune": MetricsSink._h_scan_prune,
    "catalog_commit": MetricsSink._h_catalog_commit,
    "catalog_lease": MetricsSink._h_catalog_lease,
    "fault_injected": MetricsSink._h_fault_injected,
    "ladder_rung": MetricsSink._h_ladder_rung,
    "watchdog_fire": MetricsSink._h_watchdog_fire,
    "io_retry": MetricsSink._h_io_retry,
    "phase": MetricsSink._h_phase,
    "child_stream": MetricsSink._h_child_stream,
    "plan_verify": MetricsSink._h_plan_verify,
    "plan_budget": MetricsSink._h_plan_budget,
    "plan_feedback": MetricsSink._h_plan_feedback,
    "mem_watermark": MetricsSink._h_mem_watermark,
    "heartbeat": MetricsSink._h_heartbeat,
    "serve_request": MetricsSink._h_serve_request,
    "route_request": MetricsSink._h_route_request,
    "route_retry": MetricsSink._h_route_retry,
    "lock_contention": MetricsSink._h_lock_contention,
}

# every handled kind must be a real schema kind (drift breaks import, not
# a 3am scrape); kinds without a handler (trace_meta) are counted nowhere
assert set(_HANDLERS) <= set(EVENT_SCHEMA)


# ---------------------------------------------------------------------------
# process-wide singletons: one sink + one endpoint per process
# ---------------------------------------------------------------------------

_SHARED_LOCK = make_lock("obs/metrics.py:_SHARED_LOCK")
_SHARED = {}  # "sink": MetricsSink, "server": MetricsServer, "warned": bool


def shared_sink() -> MetricsSink:
    """The process-wide sink, created on first use (all sessions/streams
    of a process aggregate into one exposition, like executors reporting
    into one driver UI)."""
    with _SHARED_LOCK:
        sink = _SHARED.get("sink")
        if sink is None:
            sink = _SHARED["sink"] = MetricsSink()
        return sink


def active_server():
    """The running MetricsServer (read `.port` for an ephemeral bind), or
    None when the endpoint is off / failed to bind."""
    return _SHARED.get("server")


def maybe_serve(conf: dict | None = None):
    """The shared MetricsSink when live telemetry is configured
    (`engine.metrics_port` / NDS_METRICS_PORT), with the HTTP endpoint
    started on first call; None when disabled — the zero-cost default.

    A bind failure (port taken — e.g. a throughput child inheriting the
    parent's fixed port) warns once and returns the sink anyway: counters
    still aggregate, only this process's exposition is missing."""
    port = resolve_metrics_port(conf)
    if port is None:
        return None
    sink = shared_sink()
    with _SHARED_LOCK:
        if _SHARED.get("server") is None and not _SHARED.get("warned"):
            from .httpserv import MetricsServer

            try:
                _SHARED["server"] = MetricsServer(sink, port).start()
            except OSError as exc:
                _SHARED["warned"] = True
                print(
                    f"obs: metrics endpoint disabled "
                    f"(port {port}: {exc}); counters stay live in-process"
                )
    return sink


def reset_shared():
    """Stop the shared server and drop the shared sink (test isolation;
    production processes never call this — the endpoint lives as long as
    the process)."""
    with _SHARED_LOCK:
        server = _SHARED.pop("server", None)
        _SHARED.pop("sink", None)
        _SHARED.pop("warned", None)
    if server is not None:
        server.stop()
