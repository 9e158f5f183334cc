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
`taskFailures`, `queryTimes`, `startTime`. Tracing, the memory sampler
(`memoryHighWater`), the host-RSS watermark and the flight recorder are
ROADMAP.md queue 1 item 12: the summary is what the reference writes with
NDS_FLIGHT_RECORDER=off.

While a statement runs on a session with lakehouse entries, a heartbeat
thread renews the session's reader leases every NDS_HEARTBEAT_INTERVAL_MS
(default 1000; the reference renews them on its memory sampler's
heartbeat of that knob), so a
statement that outlives `engine.lake_lease_ttl_s` never has its pinned
snapshot vacuumed mid-read. A session without lakehouse entries starts no
thread.
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


def heartbeat_seconds() -> float:
    """Seconds between two heartbeats (NDS_HEARTBEAT_INTERVAL_MS, default
    1000), read as nds_tpu/obs/memwatch.py reads it."""
    return max(
        float(os.environ.get("NDS_HEARTBEAT_INTERVAL_MS", "1000")) / 1000,
        0.0)


class _LeaseHeartbeat:
    """Renews `catalog`'s lakehouse reader leases on a daemon thread every
    heartbeat_seconds() while the context is open."""

    def __init__(self, catalog, interval):
        self.catalog = catalog
        self.interval = interval
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, name="nds-lease-heartbeat",
                                   daemon=True)

    def _run(self):
        while not self._stop.wait(self.interval):
            self.catalog.renew_lake_leases()

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        return False


def _lease_heartbeat(session):
    """A _LeaseHeartbeat over the session's catalog when it has lakehouse
    entries and the heartbeat is on (a 0 interval turns it off), else
    None."""
    cat = getattr(session, "catalog", None)
    interval = heartbeat_seconds()
    if not interval or cat is None or not hasattr(
            cat, "renew_lake_leases") or not any(
        getattr(e, "fmt", None) == "lakehouse"
        for e in getattr(cat, "entries", {}).values()
    ):
        return None
    return _LeaseHeartbeat(cat, interval)


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

    def __init__(self, session) -> None:
        self.session = session
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
            return (
                f"{_WATCHDOG_MARK}: query exceeded the {timeout:.1f}s budget "
                f"(engine.query_timeout / NDS_QUERY_TIMEOUT); worker abandoned"
            )
        if "crash" in box:
            raise box["crash"]
        return box.get("err")

    # ------------------------------------------------------------------
    # degradation ladder
    # ------------------------------------------------------------------
    def _plan_budget(self):
        return getattr(self.session, "last_plan_budget", None)

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

    def report_on(self, fn: Callable, *args, retry_oom: bool = False):
        """Run fn(*args), recording env (secrets redacted), status and time.

        retry_oom: allow the retrying ladder rungs (the caller guarantees
        fn is idempotent: read-only queries yes, DML no). Other callables
        still get classification, the watchdog and full attempt records;
        they just never re-run. The ladder reads the budgeter's record of
        the statement from the session's `last_plan_budget`."""
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
        heartbeat = _lease_heartbeat(self.session)
        start_time = int(time.time() * 1000)
        rungs: list[dict] = []
        attempt_errors: list[str] = []
        try:
            if heartbeat is not None:
                heartbeat.__enter__()
            err = self._attempt(fn, args, timeout)
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
                err = self._attempt(fn, args, timeout)
            if err is not None and faults.classify(err) == faults.DEVICE_OOM:
                # terminal OOM: drop the caches once more so the failure
                # cannot poison the rest of the stream
                if hasattr(self.session, "recover_memory"):
                    self.session.recover_memory("device memory exhausted")
        finally:
            if heartbeat is not None:
                heartbeat.__exit__(None, None, None)
            if registered:
                self.session.unregister_listener(failures.append)
        end_time = int(time.time() * 1000)
        self.summary["retries"] = len(rungs)
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
        self.summary["startTime"] = start_time
        # the epoch-ms difference is the queryTimes report contract
        self.summary["queryTimes"].append(end_time - start_time)
        if failures:
            self.summary["taskFailures"] = list(failures)
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
