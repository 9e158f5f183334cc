"""Per-query benchmark report: timing, environment and status as a JSON
summary, with the degradation ladder and the watchdog — the port of
nds_tpu/report.py.

The counterpart of the reference's PysparkBenchReport and listener chain
(reference: nds/PysparkBenchReport.py:58-119, nds/python_listener/
PythonListener.py:5-45). Recoverable incidents inside the engine reach the
listeners registered on the Session, and a query that completed despite
them is reported `CompletedWithTaskFailures`.

Failure domain: a failed attempt is classified (faults.classify) and walked
down a degradation ladder. A device OOM (an XLA RESOURCE_EXHAUSTED text in
the reference; here also a CUDA OOM, torch.OutOfMemoryError) gets
`budget_shrink` when the plan budgeter predicted the pressure, then
`recover_retry`, `shrink_union_window` and `spill_retry`; a host OOM one
`recover_retry`; transient IO backoff retries; a commit conflict bounded
`commit_rebase_retry` re-runs; a hung query is cut off by the watchdog
(`engine.query_timeout` / NDS_QUERY_TIMEOUT) and recorded as a `timeout`
failure instead of stalling the stream. Every attempt's error lands in
`exceptions`, the rungs walked in `ladder`, and a terminal failure carries
`failureKind`.

The summary's field set and the `<prefix>-<query>-<startTime>.json`
filename contract are the reference's: `env.sparkConf` / `env.sparkVersion`
and their aliases `env.engineConf` / `env.engineVersion` (always equal),
`queryStatus`, `exceptions`, `ladder`, `retries`, `failureKind`,
`taskFailures`, `queryTimes`, `startTime`, and `memoryHighWater` where
the memory sampler ran.

Observability: when the session carries a tracer (the flight recorder's
ring-only one by default, a file tracer with engine.trace_dir),
report_on emits a `query_span` event per benchmarked callable (status,
duration, retries, memory high-water), a `ladder_rung` event per recovery
rung, a `watchdog_fire` event when the watchdog abandons a hung attempt,
and a `mem_watermark` event when the host-RSS watermark
(`engine.host_rss_watermark`) pre-empts; a terminal failure flushes the
flight recorder as a failure bundle. A MemorySampler (obs/memwatch.py)
records the query's device-memory (or RSS) high-water into both the event
and the summary. Its heartbeat renews the session's lakehouse reader
leases every NDS_HEARTBEAT_INTERVAL_MS (default 1000), so a statement
that outlives `engine.lake_lease_ttl_s` never has its pinned snapshot
vacuumed mid-read.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Callable

import torch

from . import __version__, faults
from .engine.spill import DEFAULT_FORCE_PARTITIONS as _SPILL_RETRY_PARTS
from .io.fs import fs_open_atomic, io_retry_budget
from .lakehouse.table import commit_backoff_base, resolve_conflict_retries
from .obs import trace as obs_trace
from .obs.memwatch import MemorySampler

_REDACTED = ("TOKEN", "SECRET", "PASSWORD", "PASSWD", "CREDENTIAL", "KEY")

#: marker embedded in watchdog-generated error text; classify() maps it to
#: faults.TIMEOUT (keep in sync with faults._TIMEOUT_PAT)
_WATCHDOG_MARK = "query watchdog"

#: shrunken blocked-union window (rows) the ladder forces when a query
#: keeps OOMing and no window was in effect
_DEGRADED_WINDOW_ROWS = 1 << 18

#: watchdog poll slice: the deadline loop re-checks spill progress at this
#: granularity, so a timeout still fires within one slice of its budget
_WATCHDOG_POLL_S = 0.25


def engine_conf(session) -> dict:
    """The engine's effective configuration (reference analogue:
    sparkConf): the reference's shape, with the torch and CUDA facts in
    place of jax's."""
    dev = getattr(session, "device", None)
    conf = {
        "engine.version": __version__,
        "torch.version": torch.__version__,
        "torch.cuda.version": torch.version.cuda,
        "torch.device": str(dev),
        "torch.cuda.device_count": (
            torch.cuda.device_count() if torch.cuda.is_available() else 0),
        "engine.use_decimal": getattr(session, "use_decimal", True),
    }
    if dev is not None and dev.type == "cuda":
        conf["torch.cuda.device_name"] = torch.cuda.get_device_name(dev)
    conf.update(getattr(session, "conf", {}) or {})
    return {k: str(v) for k, v in conf.items()}


def use_system_arrow_pool() -> None:
    """Make Arrow allocate from the system allocator unless the user chose a
    pool (ARROW_DEFAULT_MEMORY_POOL). With Arrow's default mimalloc pool,
    the watchdog's thread per attempt crashed the process (SIGSEGV inside
    Arrow's dataset discovery and compute kernels, after a few queries of
    a parquet stream); the system and jemalloc pools did not. Buffers keep
    the pool that allocated them, so switching mid-process is safe."""
    if os.environ.get("ARROW_DEFAULT_MEMORY_POOL"):
        return
    pa = sys.modules.get("pyarrow")
    if pa is None:
        os.environ["ARROW_DEFAULT_MEMORY_POOL"] = "system"
    elif pa.default_memory_pool().backend_name == "mimalloc":
        pa.set_memory_pool(pa.system_memory_pool())


def host_rss_watermark(session) -> int:
    """Host-RSS pre-emption watermark in bytes; 0 disables (the default).
    Conf `engine.host_rss_watermark` wins over NDS_HOST_RSS_WATERMARK.
    When the process RSS crosses it mid-query, the sampler shrinks the
    blocked-union window for the remaining windows and later queries and
    records a `host_watermark_shrink` ladder entry: recovery before the
    allocator fails, instead of after."""
    v = getattr(session, "conf", {}).get(
        "engine.host_rss_watermark"
    ) or os.environ.get("NDS_HOST_RSS_WATERMARK")
    try:
        return max(int(v), 0) if v else 0
    except (TypeError, ValueError):
        return 0


def query_timeout(session) -> float:
    """Per-query watchdog budget in seconds; 0 disables (the default).
    Conf `engine.query_timeout` wins over the NDS_QUERY_TIMEOUT env knob."""
    v = getattr(session, "conf", {}).get("engine.query_timeout") or os.environ.get(
        "NDS_QUERY_TIMEOUT"
    )
    try:
        return max(float(v), 0.0) if v else 0.0
    except (TypeError, ValueError):
        return 0.0


class BenchReport:
    """Records one benchmarked callable: environment, wall-clock, status."""

    def __init__(self, session, tracer=None) -> None:
        self.session = session
        # everything this report (and its sampler thread) emits rides the
        # session's tracer, or `tracer`: serve mode wraps the session's in
        # a per-request forwarder that labels each event with the request
        # id and tenant
        self.tracer = (
            tracer if tracer is not None
            else getattr(session, "tracer", None)
        )
        # live telemetry (obs/metrics.py): the sink learns query starts
        # directly (query_span comes only at the end, too late for
        # /statusz's in-flight view); all else reaches it through emit
        self.sink = getattr(session, "metrics", None)
        self.summary = {
            "env": {
                "envVars": {},
                # sparkConf/sparkVersion: kept for report-pipeline
                # compatibility; engineConf/engineVersion are the
                # first-class aliases (always equal)
                "sparkConf": {},
                "sparkVersion": None,
                "engineConf": {},
                "engineVersion": None,
            },
            "queryStatus": [],
            "exceptions": [],
            "startTime": None,
            "queryTimes": [],
            "retries": 0,
        }
        self._name = None  # query/function label for emitted events
        self._request_id = None  # serve mode's per-request id (report_on)
        # serve mode's ladder isolation: `session.last_plan_budget` is one
        # field of a session that concurrent requests share, so the ladder
        # reads the record captured when this statement was planned
        # (Session.plan_stmt; report_on's plan_budget), when there is one
        self._plan_budget_override = None

    # ------------------------------------------------------------------
    # single attempt, optionally under the watchdog
    # ------------------------------------------------------------------
    def _attempt(self, fn, args, timeout: float):
        """Run fn(*args); return None on success or the error text.

        The error is returned as TEXT, without holding the exception: a
        live traceback would pin the failed attempt's device tensors
        through the recovery and the retry. With a timeout budget the
        attempt runs on a daemon worker thread; if the budget expires the
        worker is abandoned and the query becomes a classified `timeout`
        failure instead of stalling the stream. The worker needs no device
        set-up: every tensor of the session names its device, and torch's
        current stream, kept per thread and device, is the default stream
        in every thread (the port sets none), so the worker's work and its
        kernel launches go to the stream the caller's would."""

        def _call():
            try:
                fn(*args)
                return None
            except faults.InjectedCrash:
                raise
            except Exception as e:
                msg = str(e)
                return f"{type(e).__name__}: {msg}" if msg else type(e).__name__

        if timeout <= 0:
            return _call()
        use_system_arrow_pool()
        box = {}
        done = threading.Event()

        def _worker():
            try:
                # re-bind the session tracer: thread-locals don't inherit,
                # and session-less layers (fault registry, fs retries) find
                # their tracer through the thread-local binding
                with obs_trace.bind(self.tracer):
                    box["err"] = _call()
            except BaseException as e:  # InjectedCrash: re-raised on the caller
                box["crash"] = e
            finally:
                done.set()

        t = threading.Thread(
            target=_worker, name="nds-query-watchdog-worker", daemon=True
        )
        # a stale beat from a previous query's spill phase must not extend
        # this attempt's deadline
        if hasattr(self.session, "_progress_ts"):
            self.session._progress_ts = None
        t.start()
        deadline = time.monotonic() + timeout
        fired = False
        while True:
            wait_s = min(max(deadline - time.monotonic(), 0.0),
                         _WATCHDOG_POLL_S)
            if done.wait(wait_s):
                break
            now = time.monotonic()
            if now < deadline:
                continue
            # deadline reached. A healthy out-of-core phase beats through
            # Session.spill_progress while it works: as long as the last
            # beat of THIS attempt's worker is younger than the budget, the
            # attempt is slow but alive, so re-arm one budget past the
            # beat. A beat of an abandoned earlier attempt's worker does
            # not count.
            prog = getattr(self.session, "_progress_ts", None)
            if (
                isinstance(prog, tuple)
                and prog[0] == t.ident
                and now - prog[1] < timeout
            ):
                deadline = prog[1] + timeout
                continue
            fired = True
            break
        if fired:
            if self.tracer is not None:
                self.tracer.emit(
                    "watchdog_fire", query=self._name, budget_s=timeout,
                    **self._rid_fields(),
                )
            return (
                f"{_WATCHDOG_MARK}: query exceeded the {timeout:.1f}s budget "
                f"(engine.query_timeout / NDS_QUERY_TIMEOUT); worker abandoned"
            )
        if "crash" in box:
            raise box["crash"]
        return box.get("err")

    def _flight_flush(self, reason: str, rungs, sampler=None):
        """Flush the process flight ring as a failure bundle for this
        query's incident (watchdog fire, ladder exhaustion, terminal
        failure). Best-effort: forensics must never take the stream down,
        and a disabled recorder is a no-op."""
        from .obs import flight as obs_flight
        from .obs.memwatch import device_bytes_per_device, rss_bytes

        rec = obs_flight.recorder()
        if rec is None:
            return
        conf = getattr(self.session, "conf", {}) or {}
        budget = self._plan_budget()
        memory = {
            "rss_bytes": rss_bytes(),
            "device_bytes_per_device": device_bytes_per_device(),
            "mem_hw_bytes": getattr(sampler, "peak_bytes", None),
            "mem_hw_per_device": getattr(sampler, "peak_per_device", None),
            "mem_source": getattr(sampler, "source", None),
        }
        rec.flush(
            reason,
            trace_id=self._trace_id(),
            query=self._name,
            budget=budget if isinstance(budget, dict) else None,
            ladder=list(rungs) if rungs else None,
            memory=memory,
            conf=conf,
            out_dir=obs_flight.resolve_flight_dir(conf),
        )

    # ------------------------------------------------------------------
    # degradation ladder
    # ------------------------------------------------------------------
    def _plan_budget(self):
        """This statement's budgeter record: the one the caller captured
        at plan time (report_on's plan_budget), else the session's."""
        if self._plan_budget_override is not None:
            return self._plan_budget_override
        return getattr(self.session, "last_plan_budget", None)

    def _rid_fields(self) -> dict:
        """The per-request id for emitted events ({} outside serve mode)."""
        return {"request_id": self._request_id} if self._request_id else {}

    def _trace_id(self):
        """The trace_id a failure bundle files under: the serve request id
        (the request is the trace in serve mode), else the tracer's
        stamped context."""
        if self._request_id:
            return self._request_id
        ctx = getattr(self.tracer, "context", None)
        return getattr(ctx, "trace_id", None)

    def _budget_prediction(self):
        """The plan budgeter's record of the last planned statement when
        its verdict predicted memory pressure, else None."""
        rec = self._plan_budget()
        if not isinstance(rec, dict):
            return None
        if rec.get("verdict") not in ("blocked", "spill", "over", "reject"):
            return None
        return rec

    def _explicit_window(self):
        """The explicitly forced blocked-union window (conf wins over the
        NDS_UNION_AGG_WINDOW_ROWS env knob, as in
        Session.union_agg_window_rows), or None. Every shrink derives from
        this, so that a shrink can never grow the effective window."""
        v = getattr(self.session, "conf", {}).get(
            "engine.union_agg_window_rows"
        ) or os.environ.get("NDS_UNION_AGG_WINDOW_ROWS")
        try:
            return int(v) if v else None
        except (TypeError, ValueError):
            return None

    def _budget_recommendation(self):
        """A window recommendation the budget_shrink rung can still apply:
        the prediction carries a window and it was not already annotated
        into the plan (that attempt ran the static window and OOM'd
        anyway). None otherwise."""
        rec = self._budget_prediction()
        if rec is None or rec.get("annotated"):
            return None
        return rec.get("window_rows") or None

    def _next_rung(self, kind: str, rungs_taken, can_retry: bool):
        """The next recovery rung for a failure of `kind`, or None.

        device_oom: `budget_shrink` first when the budgeter predicted this
        plan over budget with a window it can still apply, then
        recover_retry, shrink_union_window, and spill_retry where the plan
        has an out-of-core seam; host_oom: one recover_retry;
        io_transient: up to NDS_IO_RETRIES backoff retries;
        commit_conflict: bounded re-runs; timeout, planner, data, unknown:
        deterministic or likely to repeat, so fail fast."""
        if not can_retry:
            return None
        taken = [r["rung"] for r in rungs_taken]
        if kind == faults.DEVICE_OOM:
            rec = self._budget_recommendation()
            cur = self._explicit_window()
            if (
                "budget_shrink" not in taken
                and rec is not None
                # an explicit window at or below the recommendation means
                # the failed attempt already ran it
                and (not cur or int(cur) > int(rec))
            ):
                return "budget_shrink"
            if "recover_retry" not in taken:
                return "recover_retry"
            if "shrink_union_window" not in taken:
                return "shrink_union_window"
            if "spill_retry" not in taken and self._spill_applicable():
                return "spill_retry"
            return None
        if kind == faults.HOST_OOM:
            return "recover_retry" if "recover_retry" not in taken else None
        if kind == faults.IO_TRANSIENT:
            retries, _ = io_retry_budget()
            if sum(1 for r in taken if r == "io_backoff_retry") < retries:
                return "io_backoff_retry"
            return None
        if kind == faults.COMMIT_CONFLICT:
            taken_n = sum(1 for r in taken if r == "commit_rebase_retry")
            if taken_n < resolve_conflict_retries():
                return "commit_rebase_retry"
            return None
        return None

    def _spill_applicable(self) -> bool:
        """True when a device OOM can still retry through the host spill
        pool: the last planned statement has an out-of-core seam
        (`spillable`), spill is not off, and the failed attempt did not
        already run forced out-of-core."""
        conf = getattr(self.session, "conf", None)
        if conf is None:
            return False
        mode = str(conf.get("engine.spill", "auto")).lower()
        if mode in ("off", "force"):
            return False
        rec = self._plan_budget()
        return bool(isinstance(rec, dict) and rec.get("spillable"))

    def _apply_rung(self, rung: str, kind: str, prior_same_rung: int):
        session = self.session
        if rung in ("recover_retry", "shrink_union_window", "budget_shrink",
                    "spill_retry"):
            if hasattr(session, "recover_memory"):
                session.recover_memory(
                    "device memory exhausted"
                    if kind == faults.DEVICE_OOM
                    else "host memory exhausted"
                )
        conf = getattr(session, "conf", None)
        if rung == "budget_shrink":
            # retry with the budgeter's window; only ever shrinks
            rec = self._budget_recommendation()
            if conf is not None and rec:
                cur = self._explicit_window()
                new = min(int(cur), int(rec)) if cur else int(rec)
                conf["engine.union_agg_window_rows"] = new
                return {"window_rows": new}
            return None
        if rung == "shrink_union_window":
            # degrade persistently: halve the window the failed attempt ran
            # (the explicit conf, else the annotated static window), else
            # force a small one, for every later statement of the session
            if conf is not None:
                cur = self._explicit_window()
                if not cur:
                    cur = (self._budget_prediction() or {}).get("window_rows")
                new = max(int(cur) // 2, 4096) if cur else _DEGRADED_WINDOW_ROWS
                conf["engine.union_agg_window_rows"] = new
                return {"window_rows": new}
        if rung == "spill_retry":
            # route every eligible join, sort and distinct through the host
            # spill pool, persistently for the rest of the session
            if conf is not None:
                rec = self._plan_budget() or {}
                parts = (
                    int(rec.get("spill_partitions") or 0)
                    or _SPILL_RETRY_PARTS
                )
                conf["engine.spill"] = "force"
                conf["engine.spill_partitions"] = parts
                return {"partitions": parts}
            return None
        if rung in ("io_backoff_retry", "commit_rebase_retry"):
            # jittered backoff, escalating on this rung's own prior count
            base = (io_retry_budget()[1] if rung == "io_backoff_retry"
                    else commit_backoff_base())
            delay = next(
                faults.backoff_delays(1, base * (2 ** prior_same_rung)), 0.0)
            if delay:
                time.sleep(delay)
            return {"delay_s": round(delay, 3)}
        return None

    def report_on(self, fn: Callable, *args, retry_oom: bool = False,
                  name: str = None, request_id: str = None,
                  plan_budget: dict = None):
        """Run fn(*args), recording env (secrets redacted), status and time.

        retry_oom: allow the retrying ladder rungs (the caller guarantees
        fn is idempotent: read-only queries yes, DML no). Other callables
        still get classification, the watchdog and full attempt records;
        they just never re-run. The ladder reads the budgeter's record of
        the statement from the session's `last_plan_budget`.

        name: query/function label for emitted trace events (the summary
        itself gets its name later, in write_summary).

        request_id: serve mode's per-request id, threaded into the sink's
        in-flight record and every emitted event, so two tenants running
        the same query name at once on one session keep apart on
        /statusz.

        plan_budget: the budgeter record captured when this statement was
        planned (Session.plan_stmt); the ladder reads it instead of the
        shared `session.last_plan_budget`, which a concurrent request may
        have overwritten by retry time."""
        self._name = name
        self._request_id = request_id
        self._plan_budget_override = plan_budget
        env_vars = {
            k: v
            for k, v in os.environ.items()
            if not any(tag in k.upper() for tag in _REDACTED)
        }
        self.summary["env"]["envVars"] = env_vars
        conf = engine_conf(self.session)
        version = f"nds-tpu-torch {__version__}"
        self.summary["env"]["sparkConf"] = conf
        self.summary["env"]["sparkVersion"] = version
        self.summary["env"]["engineConf"] = conf
        self.summary["env"]["engineVersion"] = version
        failures: list[str] = []
        registered = False
        try:
            self.session.register_listener(failures.append)
            registered = True
        except AttributeError:
            pass
        timeout = query_timeout(self.session)
        start_time = int(time.time() * 1000)
        start_mono = time.perf_counter()
        rungs: list[dict] = []
        attempt_errors: list[str] = []
        # memory high-water sampling rides with a tracer (the flight
        # recorder's ring-only one by default, so every reported query
        # unless NDS_FLIGHT_RECORDER=off with no trace dir), a configured
        # host-RSS watermark, or lakehouse leases to renew
        watermark = host_rss_watermark(self.session)
        if hasattr(self.session, "_mem_pressure"):
            self.session._mem_pressure = False
        # hysteresis: RSS rarely drops back once crossed (allocators keep
        # their pages), so the latch re-arms only after a query starts
        # below the watermark again: one shrink per excursion
        if watermark and getattr(self.session, "_rss_above_watermark", False):
            from .obs.memwatch import rss_bytes

            r = rss_bytes()
            if r is not None and r < watermark:
                self.session._rss_above_watermark = False

        def _on_watermark(rss):
            # sampler-thread callback, at most once per query: shrink the
            # blocked-union window for the remaining windows (the
            # executor's window loop polls _mem_pressure) and for every
            # later statement of the session, and leave ladder evidence
            session = self.session
            if getattr(session, "_rss_above_watermark", False):
                return  # same excursion as an earlier query: shrunk already
            session._rss_above_watermark = True
            conf = getattr(session, "conf", None)
            new = None
            if conf is not None:
                cur = self._explicit_window()
                new = max(int(cur) // 2, 4096) if cur else _DEGRADED_WINDOW_ROWS
                # never grow past the budgeter's static window
                rec = (self._budget_prediction() or {}).get("window_rows")
                if rec:
                    new = min(new, int(rec))
                conf["engine.union_agg_window_rows"] = new
            if hasattr(session, "_mem_pressure"):
                session._mem_pressure = True
            # host-tier relief: tier the spill pool's RAM segments to disk
            # before the allocator fails (only a pool that exists already)
            spilled = 0
            pool = getattr(session, "_spill_pool", None)
            if pool is not None:
                try:
                    spilled = pool.evict_host()
                except Exception:
                    spilled = 0  # relief is best-effort, never fatal here
            rungs.append({
                "rung": "host_watermark_shrink",
                "kind": faults.HOST_OOM,
                "rss_bytes": int(rss),
                **({"window_rows": new} if new else {}),
                **({"spill_segments_evicted": spilled} if spilled else {}),
            })
            if self.tracer is not None:
                self.tracer.emit(
                    "mem_watermark", query=self._name, rss_bytes=int(rss),
                    watermark_bytes=watermark,
                    **({"window_rows": new} if new else {}),
                    **self._rid_fields(),
                )
            notify = getattr(session, "notify_failure", None)
            if notify is not None:
                notify(
                    f"host RSS watermark crossed ({rss} >= {watermark}); "
                    f"blocked-union window shrunk pre-emptively"
                )

        # lease renewal on the sampler's heartbeat, armed only when the
        # session serves lakehouse tables (else no thread per statement
        # unless a tracer or watermark wants one)
        cat = getattr(self.session, "catalog", None)
        renews_leases = hasattr(cat, "renew_lake_leases") and any(
            getattr(e, "fmt", None) == "lakehouse"
            for e in getattr(cat, "entries", {}).values()
        )
        sampler = (
            MemorySampler(
                watermark_bytes=watermark or None,
                on_watermark=_on_watermark if watermark else None,
                # the sampler thread is the liveness beacon too: it
                # heartbeats through the tracer (passed explicitly, since
                # thread-locals don't reach its thread)
                tracer=self.tracer,
                query=name,
                on_heartbeat=cat.renew_lake_leases if renews_leases else None,
            )
            if self.tracer is not None or watermark or renews_leases
            else None
        )
        if self.sink is not None:
            # the app id keys the sink's in-flight record to this stream
            self.sink.query_started(
                name, app=getattr(self.tracer, "app_id", None),
                request_id=request_id,
            )
        try:
            if sampler is not None:
                sampler.__enter__()
            att_t0 = time.perf_counter()
            err = self._attempt(fn, args, timeout)
            att_ms = (time.perf_counter() - att_t0) * 1000.0
            while err is not None:
                attempt_errors.append(err)
                kind = faults.classify(err)
                rung = self._next_rung(kind, rungs, can_retry=retry_oom)
                if rung is None:
                    break
                same_rung_so_far = sum(1 for r in rungs if r["rung"] == rung)
                detail = self._apply_rung(rung, kind, same_rung_so_far)
                entry = {"rung": rung, "kind": kind}
                if detail:
                    entry.update(detail)
                rungs.append(entry)
                if self.tracer is not None:
                    # attempt_ms: the failed attempt's wall this rung
                    # recovers from (the critical path's ladder-retry cause)
                    self.tracer.emit(
                        "ladder_rung", query=name, rung=rung,
                        failure_kind=kind, attempt_ms=round(att_ms, 3),
                        **(detail or {}),
                        **self._rid_fields(),
                    )
                att_t0 = time.perf_counter()
                err = self._attempt(fn, args, timeout)
                att_ms = (time.perf_counter() - att_t0) * 1000.0
            if err is not None and faults.classify(err) == faults.DEVICE_OOM:
                # terminal OOM: drop the caches once more so the failure
                # cannot poison the rest of the stream
                if hasattr(self.session, "recover_memory"):
                    self.session.recover_memory("device memory exhausted")
        finally:
            if sampler is not None:
                sampler.__exit__(None, None, None)
            if registered:
                self.session.unregister_listener(failures.append)
        end_time = int(time.time() * 1000)
        # watermark pre-emption leaves ladder evidence but is not a retry
        self.summary["retries"] = sum(
            1 for r in rungs if r["rung"] != "host_watermark_shrink"
        )
        if rungs:
            self.summary["ladder"] = rungs
        if err is None:
            if attempt_errors:
                # recovered by the ladder: record what it took
                self.summary["exceptions"].extend(attempt_errors)
            if failures or attempt_errors:
                self.summary["queryStatus"].append("CompletedWithTaskFailures")
            else:
                self.summary["queryStatus"].append("Completed")
        else:  # a failed query must not abort the stream
            print(err)
            self.summary["queryStatus"].append("Failed")
            self.summary["exceptions"].extend(attempt_errors)
            self.summary["failureKind"] = faults.classify(err)
            # flight recorder: a terminal failure leaves a self-contained
            # bundle (ring, plan, budget, ladder, memory, conf) even with
            # no trace dir; the reason names what exhausted
            kind = self.summary["failureKind"]
            self._flight_flush(
                "watchdog" if kind == faults.TIMEOUT
                else "ladder_exhausted" if rungs
                else "query_failed",
                rungs, sampler=sampler,
            )
        self.summary["startTime"] = start_time
        # the epoch-ms difference is the queryTimes report contract; the
        # monotonic duration rides the query_span event below
        # nds-lint: disable=perf-counter
        self.summary["queryTimes"].append(end_time - start_time)
        if failures:
            self.summary["taskFailures"] = list(failures)
        if sampler is not None and sampler.peak_bytes is not None:
            self.summary["memoryHighWater"] = {
                "bytes": sampler.peak_bytes,
                "source": sampler.source,
            }
        if self.tracer is not None:
            ev = {
                "query": name,
                "dur_ms": round((time.perf_counter() - start_mono) * 1000, 3),
                "status": self.summary["queryStatus"][-1],
                "retries": self.summary["retries"],
            }
            if err is not None:
                ev["failure_kind"] = self.summary["failureKind"]
            ev.update(self._rid_fields())
            if sampler is not None and sampler.peak_bytes is not None:
                ev["mem_hw_bytes"] = sampler.peak_bytes
                ev["mem_source"] = sampler.source
                if sampler.peak_per_device is not None:
                    ev["mem_hw_per_device"] = list(sampler.peak_per_device)
            self.tracer.emit("query_span", **ev)
        return self.summary

    def write_summary(self, query_name: str, prefix: str = "") -> str:
        """Write `<prefix>-<query>-<startTime>.json` (the reference's name
        format), atomically (temp name + rename), so that a crash mid-dump
        cannot leave a torn JSON behind."""
        self.summary["query"] = query_name
        filename = f"{prefix}-{query_name}-{self.summary['startTime']}.json"
        self.summary["filename"] = filename
        with fs_open_atomic(filename, "w") as f:
            json.dump(self.summary, f, indent=2)
        return filename
