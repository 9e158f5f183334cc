"""Failure-domain core: fault injection and a classified failure taxonomy —
the port of nds_tpu/faults.py.

The harness has no scheduler underneath it, so its failure domain lives
here:

* a deterministic fault-injection registry, so that every recovery path
  of the harness can be driven on demand instead of waiting for a real
  OOM;
* a failure taxonomy (`classify`) that the degradation ladder of
  report.py reads, so that what is transient and what is deterministic is
  decided in one place.

The spec grammar, the sites and the fire counts are the JAX package's:

    spec  := rule (';' rule)*
    rule  := kind ':' site [':' arg]
    kind  := oom | hostoom | io | hang | crash
    site  := free-form label matched against injection points

e.g. ``oom:query5:1;io:store_sales:2;hang:query9:30;crash:power_test``.
`arg` is the number of times the rule fires (default 1), except for
`hang`, where it is the seconds to sleep (the rule fires once). The port
fires these sites:

    <query_name>          the Power Run, per stream entry
    exec:<query_name>     executor root, inside the engine proper
    load:<table_name>     catalog device load of a registered table
    <table_name>          the same load
    spill:evict|write|read  the spill pool's disk tier (io/crash only)
    catalog:commit|lease|fence  the fleet catalog (io/hang/crash); on the
                          tcp coordinator catalog:commit fires between the
                          WAL intent and the manifest publish
    catalog:unreachable   the tcp catalog client's transport (io/hang): the
                          call fails CatalogUnreachableError off the wire
    serve:admit           serve admission: the request is shed (429)
    serve:exec            serve execution: the BenchReport ladder
    replica:kill          serve SELECT execution (hang/crash): a replica
                          dying mid-request, as the router sees it
    route:pick            the router's replica selection: shed at the edge
    route:forward         the router's forward hop: a dead replica
    any path substring    fs_open (maybe_fire_path; io/crash only)

The one departure from the reference is the repair of `classify`: a CUDA
out-of-memory error is a device OOM. torch raises `torch.OutOfMemoryError`
("CUDA out of memory. ..."), whose type name contains "MemoryError", so
the reference's patterns would call it a host OOM and give it one
`recover_retry` instead of the device ladder. The port tests for it before
the host patterns, for an exception object and for the rendered text that
the report layer passes.

The registry is a module singleton; with no spec installed every
injection point is one `is None` check. Counts decrement under a lock, so
concurrent streams share one deterministic budget. A fired rule emits a
`fault_injected` event into the thread-bound tracer before it takes
effect, and a crash rule flushes the flight recorder first.
"""

from __future__ import annotations

import os
import sys
import threading
import time

# ---------------------------------------------------------------------------
# failure taxonomy
# ---------------------------------------------------------------------------

DEVICE_OOM = "device_oom"  # accelerator memory exhausted (recover + retry)
HOST_OOM = "host_oom"  # host allocation failed (recover + retry)
IO_TRANSIENT = "io_transient"  # flaky storage/network (backoff + retry)
COMMIT_CONFLICT = "commit_conflict"  # OCC loser (re-run the transaction)
TIMEOUT = "timeout"  # watchdog fired (no retry: likely hangs again)
PLANNER = "planner"  # parse/bind/exec logic error (deterministic)
DATA = "data"  # malformed input data (deterministic)
UNKNOWN = "unknown"

#: kinds a retry can plausibly fix; everything else fails fast
RETRYABLE = frozenset({DEVICE_OOM, HOST_OOM, IO_TRANSIENT, COMMIT_CONFLICT})

_DEVICE_OOM_PAT = (
    "RESOURCE_EXHAUSTED",
    "Out of memory allocating",
    # torch's caching allocator: torch.OutOfMemoryError("CUDA out of
    # memory. Tried to allocate ..."), rendered "OutOfMemoryError: ..."
    "CUDA out of memory",
    "OutOfMemoryError",
    # the CUDA runtime's cudaErrorMemoryAllocation, as torch reports it
    # ("CUDA error: out of memory") and as a kernel wrapper's launch check
    # names it (ops/gpu_kernels._raise_if)
    "CUDA error: out of memory",
    "cudaErrorMemoryAllocation",
)
_HOST_OOM_PAT = (
    "MemoryError",
    "Cannot allocate memory",
    "std::bad_alloc",
    "Unable to allocate",
    "host OOM",  # InjectedHostOOM renders as "injected host OOM at ..."
)
_TIMEOUT_PAT = ("watchdog", "DEADLINE_EXCEEDED")
_IO_PAT = (
    "transient io",
    "Connection reset",
    "Connection aborted",
    "ConnectionError",
    "Broken pipe",
    "Temporary failure",
    "temporarily unavailable",
    "EAGAIN",
    "timed out",
    "TimeoutError",
    "SlowDown",
    "Slow Down",
    # anchored: a bare "503" would match row counts or shapes in unrelated
    # error text
    "HTTP 503",
    "503 Service",
    # spill-pool segment IO (engine/spill.py SpillIOError): storage
    # flakiness, which the ladder's io_backoff_retry rung owns
    "SpillIOError",
    "catalog unreachable",
)
# an optimistic commit that lost its race (the lakehouse of the reference;
# checked before DATA, since it is the one transient lakehouse failure)
_COMMIT_PAT = (
    "CommitConflictError", "concurrent commit conflict",
    "CatalogFencedError", "fenced by catalog",
)
# deterministic for a given plan and catalog: the ladder fails fast
_PLANNER_PAT = (
    "ParseError", "BindError", "ExecError", "SyntaxError", "PlanVerifyError",
    "PlanBudgetError",
)
_DATA_PAT = ("malformed", "LakehouseError", "schema mismatch", "Invalid value")


def classify(err) -> str:
    """Map an exception (or its rendered text) to a taxonomy kind.

    Order matters: TIMEOUT before IO_TRANSIENT (the watchdog's words are
    near "timed out"), and device OOM before host OOM, both for the XLA
    texts of the reference and for torch's OutOfMemoryError, whose name
    contains "MemoryError"."""
    if isinstance(err, BaseException):
        text = f"{type(err).__name__}: {err}"
        # torch is not imported here: a process that never imported it (the
        # Load Test's ingest workers) cannot hold a torch.OutOfMemoryError
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(err, torch.OutOfMemoryError):
            return DEVICE_OOM
        if isinstance(err, MemoryError):
            return HOST_OOM
        if isinstance(err, (ConnectionError, TimeoutError)):
            return IO_TRANSIENT
    else:
        text = str(err)
    for kind, pats in (
        (DEVICE_OOM, _DEVICE_OOM_PAT),
        (HOST_OOM, _HOST_OOM_PAT),
        (TIMEOUT, _TIMEOUT_PAT),
        (IO_TRANSIENT, _IO_PAT),
        (COMMIT_CONFLICT, _COMMIT_PAT),
        (PLANNER, _PLANNER_PAT),
        (DATA, _DATA_PAT),
    ):
        if any(pat in text for pat in pats):
            return kind
    return UNKNOWN


def backoff_delays(retries: int, base: float, cap: float = 30.0):
    """Exponential backoff with full jitter: delay_i ~ U(0, base * 2**i],
    capped. Deterministic tests set base ~ 0 so the jitter vanishes."""
    import random

    for i in range(retries):
        yield random.uniform(0, min(base * (2 ** i), cap)) if base > 0 else 0.0


# ---------------------------------------------------------------------------
# injected fault exceptions
# ---------------------------------------------------------------------------


class FaultError(Exception):
    """Base for injected faults (except crash, which must not be caught)."""


class InjectedOOM(FaultError):
    """Renders with RESOURCE_EXHAUSTED, so it classifies (and is handled)
    exactly like a real device OOM."""


class InjectedHostOOM(FaultError, MemoryError):
    pass


class TransientIOError(FaultError, OSError):
    """Renders with 'transient io' so it classifies as IO_TRANSIENT."""


class InjectedCrash(BaseException):
    """Simulated process death. Derives from BaseException so it sails
    through every `except Exception` recovery layer, as a SIGKILL would."""


# ---------------------------------------------------------------------------
# fault registry
# ---------------------------------------------------------------------------

_KINDS = ("oom", "hostoom", "io", "hang", "crash")


class FaultRule:
    __slots__ = ("kind", "site", "arg", "remaining")

    def __init__(self, kind: str, site: str, arg: float):
        self.kind = kind
        self.site = site
        self.arg = arg
        # hang sleeps `arg` seconds and fires once; others fire `arg` times
        self.remaining = 1 if kind == "hang" else int(arg)

    def __repr__(self):
        return f"FaultRule({self.kind}:{self.site}:{self.arg}, remaining={self.remaining})"


class FaultRegistry:
    def __init__(self, rules):
        self.rules = list(rules)
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultRegistry":
        rules = []
        for part in str(spec).split(";"):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            if len(bits) < 2 or bits[0] not in _KINDS or not bits[1]:
                raise ValueError(
                    f"bad fault rule {part!r} (want kind:site[:arg] with "
                    f"kind in {_KINDS})"
                )
            kind = bits[0]
            # sites may themselves contain ':' (e.g. exec:query3); a rule's
            # trailing segment is the arg only if it parses as a number
            arg, site_bits = 1.0, bits[1:]
            if len(site_bits) > 1:
                try:
                    arg = float(site_bits[-1])
                    site_bits = site_bits[:-1]
                except ValueError:
                    pass
            rules.append(FaultRule(kind, ":".join(site_bits), arg))
        return cls(rules)

    def _claim(self, site: str, substring: bool, kinds=None):
        with self._lock:
            for r in self.rules:
                if r.remaining <= 0 or (kinds is not None and r.kind not in kinds):
                    continue
                hit = (r.site in site) if substring else (r.site == site)
                if hit:
                    r.remaining -= 1
                    return r
        return None

    def fire(self, site: str, substring: bool = False, kinds=None):
        r = self._claim(site, substring, kinds)
        if r is None:
            return
        # observability: record the injection in the bound tracer's stream
        # before the fault takes effect (a crash rule still leaves its own
        # evidence behind: parents classify child deaths from it). Lazy
        # import: the registry reaches here only when a rule fires.
        from .obs import trace as _obs_trace

        tracer = _obs_trace.current()
        if tracer is not None:
            tracer.emit("fault_injected", site=site, fault_kind=r.kind)
        if r.kind == "hang":
            print(f"faults: injected hang at {site!r} for {r.arg:.0f}s")
            time.sleep(r.arg)
            return
        if r.kind == "oom":
            raise InjectedOOM(
                f"RESOURCE_EXHAUSTED: injected device OOM at {site!r}"
            )
        if r.kind == "hostoom":
            raise InjectedHostOOM(f"injected host OOM at {site!r}")
        if r.kind == "io":
            raise TransientIOError(f"injected transient io failure at {site!r}")
        if r.kind == "crash":
            # simulated process death: flush the flight-recorder ring
            # before raising, as a real crash handler would leave one
            try:
                from .obs import flight as _obs_flight

                # the bound tracer's ring honours a conf-tier
                # engine.flight_recorder=off of the crashing session; the
                # module recorder serves session-less sites
                if tracer is not None:
                    rec = getattr(tracer, "ring", None)
                else:
                    rec = _obs_flight.recorder()
                if rec is not None:
                    ctx = getattr(tracer, "context", None)
                    rec.flush(
                        "crash",
                        trace_id=getattr(ctx, "trace_id", None),
                        query=current_scope(),
                    )
            except Exception:
                pass  # forensics must never mask the injected death
            raise InjectedCrash(f"injected crash at {site!r}")


# module singleton; None == injection disabled (the zero-cost path)
_registry: FaultRegistry | None = None
_installed_spec: str | None = None


def install(spec: str | None):
    """(Re)build the registry from a spec string; None/"" disables injection.
    Idempotent for an unchanged spec, so that a second session of one run
    does not reset the shared fire counts."""
    global _registry, _installed_spec
    if spec == _installed_spec:
        return
    _installed_spec = spec
    _registry = FaultRegistry.parse(spec) if spec else None


def install_from_env(conf: dict | None = None):
    """Install from conf `engine.fault_spec`, falling back to NDS_FAULT_SPEC
    (Session construction calls it)."""
    spec = None
    if conf:
        spec = conf.get("engine.fault_spec")
    spec = spec or os.environ.get("NDS_FAULT_SPEC")
    if spec:
        install(str(spec))


def reset():
    global _registry, _installed_spec
    _registry = None
    _installed_spec = None


def active() -> bool:
    return _registry is not None


def maybe_fire(site: str, kinds=None):
    """Exact-match injection point; one None check when no spec is
    installed. `kinds` restricts which rule kinds may fire here (the spill
    pool's `spill:<site>` points take io and crash only)."""
    if _registry is None:
        return
    _registry.fire(site, kinds=kinds)


def maybe_fire_path(path):
    """Substring-match injection point for filesystem paths (a rule site
    `store_sales` hits any IO touching that table's files). Only io and
    crash rules match here: an `oom:query5` rule is about the query site."""
    if _registry is None:
        return
    _registry.fire(str(path), substring=True, kinds=("io", "crash"))


# ---------------------------------------------------------------------------
# thread-local scope (which query is executing) for engine-level sites
# ---------------------------------------------------------------------------

_scope = threading.local()


class scope:
    """Context manager labelling the currently executing query, so that the
    executor root can fire scoped sites like exec:<query>."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.prev = getattr(_scope, "name", None)
        _scope.name = self.name
        return self

    def __exit__(self, *exc):
        _scope.name = self.prev
        return False


def current_scope():
    return getattr(_scope, "name", None)


# installs the env-tier spec for processes that never build a Session
install_from_env()
