"""Always-on flight recorder: a bounded in-memory ring of recent events
plus self-contained failure bundles.

The reference harness gets post-mortem forensics free from Spark's event
log + history server — but only when the event log is configured, and a
crashed driver still scatters its evidence. This engine's equivalent is
deliberately ALWAYS on: every `Tracer.emit` (file-backed, sink-only, or
the new ring-only default) also appends the event to one process-wide
bounded ring (`collections.deque(maxlen=...)` — append is GIL-atomic, so
emitters never block on a flush), and on a failure the ring is flushed
as a `failure-bundle-<trace_id>.json` that carries everything a human
needs to diagnose the incident WITHOUT the trace dir that may never have
been configured:

    ring events (last N, schema-valid — they came from real emitters),
    the failing statement's plan explain + budget verdict,
    the degradation-ladder history,
    host-RSS / per-device HBM high-water,
    a redacted engine-conf snapshot.

Flush triggers (report.py + faults.py): watchdog fire, terminal query
failure (ladder exhaustion), an injected crash rule (evidence lands
before the process dies), and on demand via the `/debug/flight` endpoint
(obs/httpserv.py — the one process-wide listener).

Knobs: `engine.flight_recorder` / NDS_FLIGHT_RECORDER ("off"/"0"
disables the ring AND restores the historical tracer-is-None zero-cost
default), `engine.flight_ring_events` / NDS_FLIGHT_RING_EVENTS (ring
capacity, default 512), `engine.flight_dir` / NDS_FLIGHT_DIR (bundle
destination; defaults to the trace dir when one is configured, else
`<tempdir>/nds-flight`).

Overhead contract: the ring-only default costs one dict build + one
deque append per event; ci/tier1-check's diagnosis gate measures the
per-event cost against a real SF0.01 stream's event volume and fails
when the modeled share of wall exceeds 2%.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import OrderedDict, deque

from .. import __version__
from ..engine.lockdebug import make_lock


#: default ring capacity (events); enough to hold a failing query's last
#: op spans + heartbeats from every live thread without unbounded memory
DEFAULT_RING_EVENTS = 512

#: bundle filename prefix (the reader/profiler discover bundles by it)
BUNDLE_PREFIX = "failure-bundle-"

#: top-level keys every bundle carries (validate_bundle's contract);
#: evidence sections may be null when the incident left no such evidence,
#: but the KEY must be present so a consumer can tell "no ladder walked"
#: from "truncated bundle"
BUNDLE_KEYS = (
    "bundle", "reason", "trace_id", "ts", "pid", "version", "query",
    "events", "plan", "budget", "ladder", "memory", "conf",
)

_REDACTED = ("TOKEN", "SECRET", "PASSWORD", "PASSWD", "CREDENTIAL", "KEY")


def resolve_flight_enabled(conf: dict | None = None) -> bool:
    """The flight recorder is ON by default; `engine.flight_recorder` /
    NDS_FLIGHT_RECORDER set to off/0/false disables it (and restores the
    pre-flight zero-cost tracer default)."""
    v = None
    if conf:
        v = conf.get("engine.flight_recorder")
    if v is None:
        v = os.environ.get("NDS_FLIGHT_RECORDER")
    if v is None:
        return True
    return str(v).strip().lower() not in ("0", "off", "false", "no")


def resolve_ring_events(conf: dict | None = None) -> int:
    v = None
    if conf:
        v = conf.get("engine.flight_ring_events")
    if v is None:
        v = os.environ.get("NDS_FLIGHT_RING_EVENTS")
    try:
        return max(int(v), 16) if v else DEFAULT_RING_EVENTS
    except (TypeError, ValueError):
        return DEFAULT_RING_EVENTS


def resolve_flight_dir(conf: dict | None = None) -> str:
    """Bundle destination: `engine.flight_dir` / NDS_FLIGHT_DIR, else the
    trace dir when one is configured (bundles sit next to the event logs
    they complement), else `<tempdir>/nds-flight` — a crashed run with NO
    observability configured still leaves its black box somewhere
    discoverable and documented."""
    v = None
    if conf:
        v = conf.get("engine.flight_dir")
    v = v or os.environ.get("NDS_FLIGHT_DIR")
    if v:
        return str(v)
    from .trace import resolve_trace_dir

    d = resolve_trace_dir(conf)
    if d:
        return d
    return os.path.join(tempfile.gettempdir(), "nds-flight")


class FlightRecorder:
    """Process-wide bounded event ring + incident-context notes.

    `record` is the hot path: ONE deque append (GIL-atomic, lock-free for
    the emitter — a concurrent `snapshot`/flush never blocks it). Notes
    (`note`, `note_plan`) hold the latest slow-changing context a bundle
    wants (last plan explains, budget verdicts) behind a short lock."""

    #: recent plan explains kept per process (keyed by query label): a
    #: bundle wants the FAILING statement's plan, and concurrent streams
    #: may be planning other statements at the same time
    MAX_PLANS = 8

    def __init__(self, capacity: int = DEFAULT_RING_EVENTS):
        # bounded-deque appends are atomic under the GIL; the hot path
        # stays lock-free on purpose (record rides every event emit)
        self._ring = deque(maxlen=capacity)  # nds-guarded-by: none
        self.capacity = capacity
        self.events_recorded = 0  # approximate under races  # nds-guarded-by: none
        self._lock = make_lock("FlightRecorder._lock")
        self._plans = OrderedDict()  # query label -> explain  # nds-guarded-by: _lock

    # -- hot path --------------------------------------------------------
    def record(self, ev: dict):
        self._ring.append(ev)
        self.events_recorded += 1  # telemetry only

    # -- incident context ------------------------------------------------
    def note_plan(self, query, explain):
        """Remember a statement's plan explain — a string, or a LAZY
        callable rendered only when a bundle actually flushes (the
        planner's hot path must not pay a string render per statement)."""
        with self._lock:
            key = str(query) if query is not None else "<unscoped>"
            self._plans[key] = explain
            self._plans.move_to_end(key)
            while len(self._plans) > self.MAX_PLANS:
                self._plans.popitem(last=False)

    def plan_for(self, query):
        with self._lock:
            key = str(query) if query is not None else "<unscoped>"
            explain = self._plans.get(key)
        if callable(explain):
            try:
                explain = explain()
            except Exception as exc:  # a stale plan must not kill a flush
                explain = f"<plan explain failed: {type(exc).__name__}>"
        return explain

    def snapshot(self) -> list:
        return list(self._ring)

    # -- bundles ---------------------------------------------------------
    def bundle(self, reason: str, trace_id=None, query=None, plan=None,
               budget=None, ladder=None, memory=None, conf=None,
               threads=None) -> dict:
        events = self.snapshot()
        if trace_id is None:
            # best effort: the newest ring event's stamped context
            for ev in reversed(events):
                if ev.get("trace_id"):
                    trace_id = ev["trace_id"]
                    break
        if trace_id is None:
            trace_id = f"flight-{os.getpid()}-{int(time.time())}"
        if plan is None:
            plan = self.plan_for(query)
        return {
            "bundle": 1,
            "reason": str(reason),
            "trace_id": str(trace_id),
            "ts": int(time.time() * 1000),
            "pid": os.getpid(),
            "version": __version__,
            "query": query,
            "events": events,
            "plan": plan,
            "budget": budget,
            "ladder": ladder,
            "memory": memory,
            "conf": redact_conf(conf) if conf else None,
            # suspected-deadlock evidence (engine/lockdebug.py watchdog):
            # {"stacks": {thread: [...frames]}, "locks": held-lock table}.
            # Optional-extra rather than a BUNDLE_KEYS key: most bundles
            # are not lock incidents, and the validate contract already
            # tolerates extras
            **({"threads": threads} if threads is not None else {}),
        }

    def flush(self, reason: str, trace_id=None, query=None, plan=None,
              budget=None, ladder=None, memory=None, conf=None,
              out_dir=None, threads=None):
        """Write the bundle atomically; returns its path, or None when the
        write failed (forensics must never take the run down — a broken
        flight dir is reported once to stdout, not raised)."""
        try:
            b = self.bundle(
                reason, trace_id=trace_id, query=query, plan=plan,
                budget=budget, ladder=ladder, memory=memory, conf=conf,
                threads=threads,
            )
            out_dir = out_dir or resolve_flight_dir()
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(
                out_dir, f"{BUNDLE_PREFIX}{b['trace_id']}.json"
            )
            from ..io.fs import fs_open_atomic

            with fs_open_atomic(path, "w") as f:
                json.dump(b, f, default=str)
            print(f"obs: flight recorder wrote {path} ({reason})")
            return path
        except Exception as exc:
            print(f"obs: flight recorder flush failed ({exc})")
            return None


def redact_conf(conf: dict) -> dict:
    """Conf snapshot with credential-shaped keys dropped (same tag list
    the per-query report summary redacts its env with)."""
    return {
        str(k): str(v)
        for k, v in conf.items()
        if not any(tag in str(k).upper() for tag in _REDACTED)
    }


def validate_bundle(obj) -> list:
    """Structural problems with a failure bundle as strings (empty ==
    valid): the BUNDLE_KEYS contract plus event-schema validation of the
    ring (`profile --check` routes bundle paths here, so CI can assert a
    crash left a USABLE black box, not just a file)."""
    problems = []
    if not isinstance(obj, dict) or obj.get("bundle") != 1:
        return ["not a flight-recorder bundle (missing bundle: 1)"]
    for key in BUNDLE_KEYS:
        if key not in obj:
            problems.append(f"bundle missing key {key!r}")
    events = obj.get("events")
    if not isinstance(events, list):
        problems.append("bundle events is not a list")
    else:
        from .reader import validate_events

        problems.extend(
            f"ring {p}" for p in validate_events(events)
        )
    if not obj.get("trace_id"):
        problems.append("bundle has no trace_id")
    return problems


def read_bundle(path) -> dict:
    with open(path, encoding="utf-8") as f:
        obj = json.load(f)
    if not isinstance(obj, dict) or obj.get("bundle") != 1:
        raise ValueError(f"{path}: not a flight-recorder bundle")
    return obj


def is_bundle_path(path) -> bool:
    base = os.path.basename(str(path))
    return base.startswith(BUNDLE_PREFIX) and base.endswith(".json")


# ---------------------------------------------------------------------------
# process-wide singleton (one black box per process, like the sink)
# ---------------------------------------------------------------------------

_SHARED_LOCK = make_lock("obs/flight.py:_SHARED_LOCK")
_SHARED = {}  # "recorder": FlightRecorder


def recorder(conf: dict | None = None):
    """The process-wide FlightRecorder, or None when disabled. Capacity
    resolves on first construction (one ring per process)."""
    if not resolve_flight_enabled(conf):
        return None
    with _SHARED_LOCK:
        rec = _SHARED.get("recorder")
        if rec is None:
            rec = _SHARED["recorder"] = FlightRecorder(
                resolve_ring_events(conf)
            )
        return rec


def reset_shared():
    """Drop the shared ring (test isolation; production processes keep
    theirs for the process lifetime)."""
    with _SHARED_LOCK:
        _SHARED.pop("recorder", None)
