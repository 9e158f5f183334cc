"""Structured run-wide event tracing: the engine's own observability stream.

The reference harness is measured entirely through Spark's instrumentation —
event logs, per-task metrics, and the RAPIDS profiling/qualification tools
that post-process them. This engine has no Spark underneath, so the
equivalent seam lives here: a `Tracer` appends JSON-lines events to
`events-<appid>.jsonl` under a trace directory (`NDS_TRACE_DIR` env / conf
`engine.trace_dir`), one self-contained JSON object per line — rotating to
`events-<appid>.<seq>.jsonl` segments at `engine.trace_rotate_bytes` so
long-running fleets can compact closed segments (`profile compact`) — and
`cli/profile.py` is the post-processor (the local analogue of the
reference's profiling tool over Spark event logs). The LIVE half is
`obs/metrics.py`: an optional MetricsSink on the same emit seam feeds the
`/metrics` + `/statusz` endpoint while the run is still going.

Near-zero-cost contract (amended by the flight recorder): with no trace
dir and no metrics port configured, `tracer_from_conf` now returns a
RING-ONLY tracer — events are built and appended to the process-wide
flight-recorder ring (obs/flight.py: one bounded deque append, no file,
no in-memory list) so a crash or hang ALWAYS leaves a failure bundle
behind, trace dir or not. Setting `engine.flight_recorder` /
NDS_FLIGHT_RECORDER to off restores the historical contract
(`tracer_from_conf` -> None, every instrumentation point one `is None`
check). The ring's per-event cost is budgeted in CI (<2% of SF0.01
stream wall — the tier1 diagnosis gate).

Trace context: every tracer carries a `TraceContext` (trace_id + parent)
and `emit` stamps `trace_id` on every event. Entry points mint one
(power/throughput/full_bench/serve request/DM function — via
`tracer_from_conf`, or explicitly); subprocess launchers export it as
NDS_TRACE_CONTEXT so a child process ADOPTS the exact context its parent
minted for it, and child event files fold by trace_id instead of the
pid-recycling-prone pid match.

Crash-safety contract: each event is written with ONE `write()` call of a
complete line and flushed, so a reader never sees an interleaved line from
two threads and a crashed process leaves at most one torn FINAL line (which
readers tolerate; any earlier malformed line is a hard error —
`obs.reader.iter_events`).

Event taxonomy (golden schema — tests/test_obs.py asserts it):
every event carries `ts` (epoch ms), `kind`, `app`, the stamped
CONTEXT_FIELDS (`trace_id`; see TraceContext), and (when a query scope
is active, `faults.scope`) `query`; per-kind required fields are listed in
EVENT_SCHEMA below. `trace_id` is stamped centrally by `Tracer.emit` —
emission sites must NOT pass it ad hoc unless the kind declares it in
EVENT_SCHEMA (the `trace-event-schema` lint rule enforces this).
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid

from .. import faults
from .. import __version__
from ..engine.lockdebug import make_lock


#: kind -> tuple of required per-kind fields (beyond ts/kind/app).
#: Optional fields events may also carry are documented in README
#: "Observability". This mapping is the schema contract the golden test and
#: `profile --check`/`obs.reader.validate_events` enforce.
EVENT_SCHEMA = {
    # first line of every file: identifies the producing process
    "trace_meta": ("pid", "version"),
    # one per executed plan node (inclusive wall time; children nest inside)
    "op_span": ("exec_id", "seq", "depth", "node", "explain", "dur_ms",
                "rows", "est_bytes"),
    # one per benchmarked query/function (BenchReport.report_on)
    "query_span": ("query", "dur_ms", "status", "retries"),
    # catalog table load (cache: "hit" | "partial" | "miss")
    "catalog_load": ("table", "columns", "loaded", "rows", "dur_ms", "cache"),
    # session plan-result cache probe on a cacheable plan node
    "plan_cache": ("node", "hit"),
    # blocked union-aggregation completed (PR 1 window stats)
    "blocked_union": ("windows", "window_rows", "total_rows"),
    # one fused-pipeline execution (fused=False: eager per-stage fallback;
    # also carries `agg` when the pipeline has a fused aggregate tail)
    "pipeline_span": ("stages", "fused", "dur_ms"),
    # one synchronized device-kernel dispatch (ops/kernels.py hot kernels;
    # only with kernel tracing on — engine.trace_kernels/NDS_TRACE_KERNELS —
    # because the measurement blocks on the result, trading pipelining for
    # per-kernel attribution below plan-node op_spans). `n` is the leading
    # input length. Also records the Pallas-vs-jnp promotion measurements
    # (kernel "segment_<fn>:jnp" / ":pallas", exec._pallas_promoted).
    "kernel_span": ("kernel", "dur_ms", "n"),
    # executable-cache probe for a pipeline (hit=True: an executable for
    # this (structure, dtypes, bucket) already existed this session)
    "exec_cache": ("pipeline", "bucket", "hit"),
    # persistent AOT executable cache activity (engine/aotcache.py):
    # op "load" (result hit | miss | key_mismatch | quarantined), "store"
    # (stored | io_error | unserializable), "evict", "vacuum". Optional:
    # bytes, dur_ms, key, entries, removed, error. A `load`/`hit` event in
    # a fresh process is the trace-level evidence an executable came from
    # disk instead of a recompile (the two-process microbench gate reads
    # exactly this).
    "aot_cache": ("op", "result"),
    # a fault-injection rule fired (faults.FaultRegistry)
    "fault_injected": ("site", "fault_kind"),
    # one degradation-ladder rung taken (BenchReport). Optional:
    # attempt_ms (the FAILED attempt's wall this rung recovers from —
    # the critical-path ladder-retry cause), delay_s (backoff rungs)
    "ladder_rung": ("query", "rung", "failure_kind"),
    # the per-query watchdog abandoned a hung attempt
    "watchdog_fire": ("query", "budget_s"),
    # a transient remote-IO failure was retried (io/fs.py)
    "io_retry": ("path", "error", "delay_s"),
    # full_bench orchestrator phase boundary (event: "begin" | "end")
    "phase": ("phase", "event"),
    # parent fold-in of one throughput child stream's event file(s)
    "child_stream": ("stream", "files", "queries", "completed", "failed"),
    # the plan verifier checked a statement's plan at one rewrite stage
    # (engine.verify_plans; ok=False events also carry violations/first)
    "plan_verify": ("stage", "ok"),
    # the static plan budgeter's per-statement verdict (engine.plan_budget;
    # analysis/budget.py): modeled peak vs the working-set budget, plus
    # peak_blocked_bytes/window_rows/nodes detail
    "plan_budget": ("verdict", "peak_bytes", "budget_bytes"),
    # the host-RSS watermark sampler pre-empted memory pressure mid-query
    # (report.py; shrinks the blocked-union window before the allocator
    # fails)
    "mem_watermark": ("rss_bytes", "watermark_bytes"),
    # one collective exchange executed under a device mesh
    # (exec._try_exchange_join hash-partitioned join / _try_dist_sort
    # samplesort): interconnect bytes moved (padded-capacity measure over
    # both all_to_all passes), partition (device) count, the received-row
    # skew ratio (max device / mean; 1.0 = perfectly balanced), and how
    # many capacity-overflow retries the step burned before it fit.
    # Optional: dur_ms (measured wall of the whole exchange step, retries
    # included — the critical-path exchange-wait cause) and per_device
    # (received-row counts per device — what names the straggler)
    "exchange": ("op", "partitions", "bytes_moved", "skew", "retries"),
    # a fact table could not row-shard over the session mesh (capacity not
    # divisible by the device count) and fell back to full replication
    # (session.Catalog._to_device) — loud by contract: the event feeds a
    # metric family and the entry flag arms the verifier's replicated-dim
    # rule. Optional: bytes (host-side table size now copied per device).
    "mesh_fallback": ("table", "n_dev", "cap"),
    # one out-of-core (spilled) operator execution (engine/spill.py +
    # exec's _spilled_join/_spilled_take/_spilled_distinct): host-pool
    # traffic for a partitioned hash join / external sort / spilling
    # distinct — bytes into/out of the pool, partition count, and how many
    # segments tiered down to the spill dir
    "spill": ("op", "partitions", "bytes_in", "bytes_out", "evictions"),
    # one lakehouse manifest publish attempt outcome (lakehouse/table.py
    # _commit): `attempts` counts OCC tries incl. rebases; successful
    # commits also carry `rebased`, losers carry `conflict`: true
    "lake_commit": ("table", "operation", "version", "attempts"),
    # one lakehouse vacuum (snapshot expiry + unreferenced-file delete):
    # files_leased counts files KEPT because a live reader lease covers
    # them — the vacuum safety contract made visible
    "lake_vacuum": ("table", "files_removed", "manifests_removed",
                    "files_leased"),
    # one parallel-ingest chunk committed through the lakehouse ledger
    # (transcode.py _ingest_chunks → table.ingest_chunk): decode_ms is
    # the Arrow decode of the chunk file, commit_ms covers stage+commit
    # (the commit-wait critical-path bucket). Optional: files (staged
    # file count), version, skipped: true (chunk already in the ledger
    # — the resume path's exactly-once skip)
    "ingest_chunk": ("table", "chunk", "rows", "decode_ms", "commit_ms"),
    # one zone-map pruning pass over a pinned lakehouse scan
    # (Session._prune_lake_scans): files_pruned of files_total were
    # excluded by the manifest's per-file stats; rows_bound is the
    # surviving-row upper bound handed to the budgeter (None when
    # nothing pruned)
    "scan_prune": ("table", "files_total", "files_pruned", "rows_bound",
                   "dur_ms"),
    # one fleet-catalog commit arbitration (lakehouse/catalog.py): outcome
    # is ok | conflict | fenced | unreachable | expired (a slow
    # coordinator refusing a publish past the client's deadline) |
    # rolled_back (coordinator WAL recovery). Optional: dur_ms, txid,
    # epoch — the cross-host half of lake_commit's story (a table-level
    # lake_commit may cover several catalog_commit attempts)
    "catalog_commit": ("table", "backend", "version", "outcome"),
    # one fleet-catalog lease/fence operation: op is acquire | renew |
    # release | sweep | writer_register | fence_bump. Optional: table,
    # version, epoch, fence, live_writers, removed
    "catalog_lease": ("op", "backend", "outcome"),
    # one serve-mode request outcome (nds_tpu/serve/service.py): status is
    # completed | failed | rejected | shed | draining, http_status the
    # wire answer. Optional: request_id, query, verdict (the admission
    # echo), rows, bytes, and per-request cache tallies
    # (exec_cache_hits/_lookups, plan_cache_hits/_lookups) that feed the
    # per-tenant hit rates on /statusz.
    "serve_request": ("tenant", "status", "dur_ms", "http_status"),
    # one router-edge request outcome (nds_tpu/serve/router.py): status is
    # completed | failed | rejected | shed | draining, http_status the
    # answer the CLIENT saw. Optional: request_id, replica (the upstream
    # that served it), verdict (cached/probed budget verdict that drove
    # the pick), stmt_class (select | dml), attempts (total upstream
    # forwards), retries, queue_ms (edge admission: verdict lookup +
    # replica pick), forward_ms (total upstream wire time), query — the
    # critical-path profiler folds queue_ms/forward_ms into the
    # router-queue / router-forward buckets.
    "route_request": ("tenant", "status", "dur_ms", "http_status"),
    # one router failover/shed retry decision (nds_tpu/serve/router.py):
    # reason is connect | midstream | shed | fault | upstream. Optional:
    # tenant, request_id, attempt, delay_ms
    "route_retry": ("replica", "reason"),
    # estimate-vs-actual cardinality feedback (analysis/feedback.py):
    # op "annotate"/"consume" (budget_plan's per-statement summary —
    # result applied | static, with mode/lookups/hits/overrides/verdict)
    # and "record" (one executed node's measured cardinality folded into
    # the FeedbackStore — result ok, with node/actual_rows and, when the
    # static estimate was annotated, est_rows + abs_log_err, the
    # |log(est/actual)| error sample `profile --accuracy` distributes).
    # op_span events on feedback-annotated nodes also carry node_fp /
    # est_rows / est_live_bytes / actual_rows / actual_bytes as optional
    # fields (est_bytes keeps its historical realized-bytes meaning)
    "plan_feedback": ("op", "result"),
    # liveness beacon from the per-query memory-sampler thread
    # (obs/memwatch.py, armed by report.py while a traced query runs):
    # a hung query keeps heartbeating, so the hang is visible live on
    # /statusz (heartbeat age + in-flight elapsed) and classifiable
    # post-hoc from the log tail. Interval: NDS_HEARTBEAT_INTERVAL_MS.
    # Optional: dev_bytes (per-device HBM sample list, device-source
    # runs — feeds the /statusz mesh section's high-water)
    "heartbeat": ("query", "elapsed_ms", "rss_bytes"),
    # runtime lock sanitizer (engine/lockdebug.py, engine.lock_debug):
    # one acquisition whose wait crossed engine.lock_contention_ms.
    # `lock` is the static model's name (ClassName.attr / relpath:NAME,
    # anchors/lock_order.golden), wait_ms the measured acquire wait
    "lock_contention": ("lock", "wait_ms"),
}

#: fields `Tracer.emit` stamps on EVERY event from the tracer's
#: TraceContext (alongside ts/kind/app). Readers treat them as optional
#: (pre-context logs lack them); call sites never pass them explicitly —
#: the `trace-event-schema` lint flags an explicit `trace_id=` kwarg on a
#: kind that does not declare it in EVENT_SCHEMA.
CONTEXT_FIELDS = ("trace_id",)

#: kinds kept in EVENT_SCHEMA for old-log readers but no longer emitted by
#: the current tree; the golden-sync test (tests/test_analysis.py) requires
#: every NON-deprecated kind to have a live emission site, and every
#: emitted kind to be in EVENT_SCHEMA
DEPRECATED_EVENT_KINDS = frozenset()


def resolve_trace_dir(conf: dict | None = None) -> str | None:
    """Trace directory from conf `engine.trace_dir`, else NDS_TRACE_DIR;
    None (tracing disabled) when neither is set."""
    v = None
    if conf:
        v = conf.get("engine.trace_dir")
    v = v or os.environ.get("NDS_TRACE_DIR")
    return str(v) if v else None


def resolve_kernel_trace(conf: dict | None = None) -> bool:
    """Per-kernel dispatch timing (conf `engine.trace_kernels`, env
    NDS_TRACE_KERNELS). Off by default: each traced kernel call blocks on
    its result, so this is a profiling mode, not a steady-state default."""
    v = None
    if conf:
        v = conf.get("engine.trace_kernels")
    if v is None:
        v = os.environ.get("NDS_TRACE_KERNELS")
    return str(v).lower() in ("1", "on", "true") if v is not None else False


def resolve_rotate_bytes(conf: dict | None = None) -> int:
    """Trace-segment rotation threshold in bytes (conf
    `engine.trace_rotate_bytes`, env NDS_TRACE_ROTATE_BYTES); 0 — the
    default — disables rotation (one `events-<appid>.jsonl` forever, the
    pre-rotation behavior). With a threshold, the tracer rolls to
    `events-<appid>.<seq>.jsonl` segments so long-running fleets can
    compact closed segments (`profile compact`) instead of growing one
    unbounded log."""
    v = None
    if conf:
        v = conf.get("engine.trace_rotate_bytes")
    if v is None:
        v = os.environ.get("NDS_TRACE_ROTATE_BYTES")
    try:
        return max(int(v), 0) if v else 0
    except (TypeError, ValueError):
        return 0


def default_app_id() -> str:
    """Unique per-tracer app id: pid + epoch second + random suffix (two
    thread-mode throughput streams in one process must not collide)."""
    return f"nds-tpu-{os.getpid()}-{int(time.time())}-{uuid.uuid4().hex[:6]}"


#: env var carrying a parent-minted trace context into a child process
TRACE_CONTEXT_ENV = "NDS_TRACE_CONTEXT"


class TraceContext:
    """Cross-process trace correlation: a `trace_id` (the whole-run or
    per-request correlation key `Tracer.emit` stamps on every event) plus
    the minting parent's trace_id.

    Propagation contract: a LAUNCHER mints one context per child
    (`ctx.child()`) and exports it (`ctx.export(env)`); the child's
    `tracer_from_conf` finds NDS_TRACE_CONTEXT and adopts the context
    VERBATIM — so the parent knows the exact trace_id the child's event
    files carry and folds them by trace_id, immune to pid recycling. A
    process with nothing in the environment mints a fresh root context."""

    __slots__ = ("trace_id", "parent")

    def __init__(self, trace_id: str, parent: str | None = None):
        self.trace_id = str(trace_id)
        self.parent = str(parent) if parent else None

    def __repr__(self):
        return f"TraceContext({self.trace_id!r}, parent={self.parent!r})"

    @classmethod
    def mint(cls, entry: str = "nds", parent: str | None = None):
        """A fresh context for an entry point (power, throughput,
        full_bench, a serve request, a DM function...)."""
        return cls(f"{entry}-{uuid.uuid4().hex[:16]}", parent=parent)

    def child(self, entry: str = "child") -> "TraceContext":
        """A context for a subprocess this process launches: fresh
        trace_id, parented to this one."""
        return TraceContext.mint(entry, parent=self.trace_id)

    # -- env carriage ----------------------------------------------------
    def to_env_value(self) -> str:
        return (
            f"{self.trace_id},{self.parent}" if self.parent
            else self.trace_id
        )

    @classmethod
    def from_env_value(cls, value: str):
        value = str(value).strip()
        if not value:
            return None
        bits = value.split(",", 1)
        return cls(bits[0], parent=bits[1] if len(bits) > 1 else None)

    def export(self, env: dict) -> dict:
        """Write this context into a subprocess environment dict (and
        return it, for call-site chaining)."""
        env[TRACE_CONTEXT_ENV] = self.to_env_value()
        return env


def resolve_trace_context(entry: str = "proc") -> TraceContext:
    """The process's trace context: adopt a parent-exported
    NDS_TRACE_CONTEXT verbatim, else mint a fresh root for `entry`."""
    ctx = TraceContext.from_env_value(
        os.environ.get(TRACE_CONTEXT_ENV, "")
    )
    return ctx if ctx is not None else TraceContext.mint(entry)


def current_context() -> TraceContext | None:
    """The thread-bound tracer's context (None unbound) — launchers that
    want to parent a child context to the running stream's reach it
    here."""
    t = current()
    return getattr(t, "context", None) if t is not None else None


class Tracer:
    """Append-only JSON-lines event writer (or an in-memory collector when
    `trace_dir` is None — the dev-tool mode tools/trace_query.py uses; or
    a sink-only forwarder with `collect=False` — the live-telemetry-
    without-a-trace-dir mode).

    Thread-safe: a lock serializes writes, and each event line is emitted
    with a single write() + flush so concurrent streams/threads sharing a
    tracer never interleave mid-line.

    Rotation: with `rotate_bytes` set the tracer rolls to a new segment
    (`events-<appid>.<seq>.jsonl`, seq 1..) once the current one reaches
    the threshold; every segment opens with its own `trace_meta` line so
    each file is independently discoverable/attributable. Segment 0 keeps
    the classic un-suffixed name, so unrotated runs look exactly as
    before. `obs.reader` reassembles chains in seq order.

    Lifecycle: `close()` is terminal — a late emit after close is a
    harness-ordering bug and becomes a NO-OP with a one-shot warning
    (historically it silently reopened the file and leaked the handle)."""

    def __init__(self, trace_dir: str | None = None, app_id: str | None = None,
                 kernel_spans: bool = False, sink=None, rotate_bytes: int = 0,
                 collect: bool | None = None, context=None, ring=None):
        self.app_id = app_id or default_app_id()
        self.trace_dir = trace_dir
        # opt-in per-kernel dispatch timing: the ops.kernels instrumentation
        # only fires when the thread-bound tracer carries this flag
        self.kernel_spans = kernel_spans
        # live-telemetry bridge (obs/metrics.py): every emitted event also
        # updates the sink's counters/status; None = no live metrics
        self.sink = sink
        # cross-process correlation: every emitted event is stamped with
        # this context's trace_id (adopted from NDS_TRACE_CONTEXT when a
        # launcher minted one for this process, else freshly minted)
        self.context = context or resolve_trace_context("tracer")
        # flight-recorder ring (obs/flight.py): every emitted event also
        # lands in the process-wide bounded ring so a failure bundle has
        # the last-N events even when nothing else is configured. Ring
        # append is one GIL-atomic deque op — emitters never block.
        if ring is None:
            from . import flight as obs_flight

            ring = obs_flight.recorder()
        self.ring = ring or None
        self.rotate_bytes = max(int(rotate_bytes or 0), 0)
        self.seq = 0  # nds-guarded-by: _lock
        self.path = self._segment_path(0) if trace_dir else None  # nds-guarded-by: _lock
        if collect is None:
            collect = trace_dir is None
        self.events: list[dict] | None = (  # nds-guarded-by: _lock
            [] if (trace_dir is None and collect) else None
        )
        self._fh = None  # nds-guarded-by: _lock
        self._lock = make_lock("Tracer._lock")
        self._broken = False  # nds-guarded-by: _lock
        self._closed = False  # nds-guarded-by: _lock
        self._close_warned = False  # nds-guarded-by: _lock
        self._seg_bytes = 0  # nds-guarded-by: _lock
        if trace_dir:
            # eager meta line: the file exists (and is discoverable by a
            # parent/orchestrator) even if the process dies before its
            # first real event. Carries the trace context (trace_id via
            # the central stamp, parent explicitly) so fold-in can match
            # this file to its LAUNCH RECORD instead of trusting the pid.
            self.emit(
                "trace_meta", pid=os.getpid(), version=__version__,
                **({"parent": self.context.parent}
                   if self.context.parent else {}),
            )

    def _segment_path(self, seq: int) -> str:
        if seq == 0:
            return os.path.join(self.trace_dir, f"events-{self.app_id}.jsonl")
        # zero-padded so chains stay scannable by eye; ordering itself is
        # parsed, not lexicographic (obs.reader.segment_key)
        return os.path.join(
            self.trace_dir, f"events-{self.app_id}.{seq:04d}.jsonl"
        )

    # ------------------------------------------------------------------
    def emit(self, kind: str, **fields):
        """Record one event. `ts`/`kind`/`app` are added here; `query` is
        added from the active faults.scope when the caller didn't pass it."""
        if self._closed:
            # emit-after-close: a harness loop closed this tracer before
            # some late worker finished. Dropping is correct (the reader
            # contract says a closed file is final); reopening would leak
            # the handle and resurrect a file a parent may already have
            # folded in.
            with self._lock:
                if not self._close_warned:
                    self._close_warned = True
                    print(
                        f"obs: tracer {self.app_id} got an emit({kind!r}) "
                        f"after close(); dropping this and later events "
                        f"(close tracers only after their last emitter)"
                    )
            return
        ev = {
            "ts": int(time.time() * 1000), "kind": kind, "app": self.app_id,
            "trace_id": self.context.trace_id,
        }
        if "query" not in fields:
            scope = faults.current_scope()
            if scope is not None:
                ev["query"] = scope
        ev.update(fields)  # an explicit trace_id (serve's per-request
        # forwarding tracer) overrides the stamped context here
        if self.sink is not None:
            try:
                self.sink.record(ev)
            except Exception:
                pass  # live telemetry must never take the benchmark down
        if self.ring is not None:
            self.ring.record(ev)  # one bounded deque append; never blocks
        if self.path is None and self.events is None:
            return  # sink-only / ring-only mode: nothing to persist
        # serialize outside the lock (sink-only mode skipped it above)
        line = json.dumps(ev, default=str) if self.path is not None else None
        with self._lock:
            if self._closed:
                return  # raced a concurrent close(): the unlocked check
                # above passed before close() took the lock — reopening
                # here would resurrect the leak this check exists to kill
            if self.events is not None:
                self.events.append(ev)
                return
            if self._broken:
                return
            try:
                if self._fh is None:
                    parent = os.path.dirname(self.path)
                    # lazy open under _lock is the design: this lock
                    # exists to serialize exactly this segment handle,
                    # the makedirs/open pair runs once per segment, and
                    # emit serialized the payload before taking the lock.
                    if parent:
                        os.makedirs(parent, exist_ok=True)  # nds-lint: disable=blocking-under-lock
                    self._fh = open(self.path, "a", encoding="utf-8")  # nds-lint: disable=blocking-under-lock
                    self._seg_bytes = os.fstat(self._fh.fileno()).st_size
                data = line + "\n"
                self._fh.write(data)
                self._fh.flush()
                if self.rotate_bytes:
                    # byte accounting (an extra encode per line) only when
                    # rotation can actually consume it
                    self._seg_bytes += len(data.encode("utf-8"))
                    if self._seg_bytes >= self.rotate_bytes:
                        self._rotate_locked()
            except OSError as exc:
                # observability must never take the benchmark down: an
                # unwritable trace dir disables this tracer, loudly, once
                self._broken = True
                print(f"obs: disabling tracer ({self.path}: {exc})")

    def _rotate_locked(self):
        """Roll to the next segment (caller holds the lock). The new
        segment opens with its own trace_meta line (carrying `seq`) so a
        segment file found alone is still attributable to its process."""
        self._fh.close()
        self.seq += 1
        self.path = self._segment_path(self.seq)
        self._fh = open(self.path, "a", encoding="utf-8")
        meta = json.dumps({
            "ts": int(time.time() * 1000), "kind": "trace_meta",
            "app": self.app_id, "trace_id": self.context.trace_id,
            "pid": os.getpid(),
            "version": __version__, "seq": self.seq,
            **({"parent": self.context.parent}
               if self.context.parent else {}),
        })
        self._fh.write(meta + "\n")
        self._fh.flush()
        self._seg_bytes = len(meta.encode("utf-8")) + 1

    def close(self):
        """Terminal: flush + release the file handle and refuse later
        emits (see class docstring). Idempotent."""
        with self._lock:
            self._closed = True
            if self._fh is not None:
                self._fh.close()
                self._fh = None  # nds-guarded-by: _lock


def tracer_from_conf(conf: dict | None = None, app_id: str | None = None,
                     context: TraceContext | None = None):
    """A Tracer for the configured observability shape.

    Four live shapes: a trace dir gives the classic file tracer; a
    metrics port alone gives a SINK-ONLY tracer (no file, no in-memory
    list — emission sites fire so the live registry stays hot, nothing is
    persisted); both give a file tracer that also feeds the sink; and
    with NEITHER configured the flight recorder keeps a RING-ONLY tracer
    (events feed the process-wide bounded ring so failures always leave a
    bundle). Only `engine.flight_recorder: off` / NDS_FLIGHT_RECORDER=off
    returns None — the historical fully-disabled zero-cost state.

    `context`: an explicit TraceContext for this tracer; default adopts
    NDS_TRACE_CONTEXT (a launcher minted one for this process) or mints a
    fresh root."""
    d = resolve_trace_dir(conf)
    # lazy: obs.metrics imports EVENT_SCHEMA from this module
    from . import flight as obs_flight
    from . import metrics as obs_metrics

    sink = obs_metrics.maybe_serve(conf)
    ring = obs_flight.recorder(conf)
    if context is None:
        context = resolve_trace_context("session")
    if not d:
        if sink is None and ring is None:
            return None
        return Tracer(
            None, app_id=app_id, kernel_spans=resolve_kernel_trace(conf),
            sink=sink, collect=False, context=context, ring=ring or False,
        )
    return Tracer(
        d, app_id=app_id, kernel_spans=resolve_kernel_trace(conf),
        sink=sink, rotate_bytes=resolve_rotate_bytes(conf),
        context=context, ring=ring or False,
    )


# ---------------------------------------------------------------------------
# thread-local binding: layers without a Session in hand (faults, io/fs)
# reach the right stream's tracer through `current()`
# ---------------------------------------------------------------------------

_tls = threading.local()


class bind:
    """Context manager binding a tracer (or None: no-op) to this thread so
    session-less layers (fault registry, fs retries) can emit into the
    stream that is actually running. Harness loops bind their session's
    tracer around query execution; BenchReport re-binds inside its watchdog
    worker thread (thread-locals don't inherit)."""

    def __init__(self, tracer: Tracer | None):
        self.tracer = tracer

    def __enter__(self):
        self.prev = getattr(_tls, "tracer", None)
        _tls.tracer = self.tracer
        return self.tracer

    def __exit__(self, *exc):
        _tls.tracer = self.prev
        return False


def current() -> Tracer | None:
    """The tracer bound to this thread, or None (events dropped)."""
    return getattr(_tls, "tracer", None)
