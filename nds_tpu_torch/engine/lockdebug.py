"""tsan-lite runtime lock sanitizer (`engine.lock_debug`, off by default),
the port of nds_tpu/engine/lockdebug.py.

The static half (analysis/concurrency.py) pins the port's canonical lock
order in anchors/lock_order_torch.golden. This module is the runtime half:
with
`engine.lock_debug` / NDS_LOCK_DEBUG on, `make_lock` wraps each named lock
in an order-recording proxy that

  * asserts the pinned static order on every live acquisition — taking a
    lock ranked BELOW one already held by this thread raises
    LockOrderError with both stacks' worth of context (the inversion a
    chaos gate can only witness; the proxy makes it deterministic);
  * emits a `lock_contention` event (and the `nds_lock_*` metric
    families) when an acquisition waited longer than
    `engine.lock_contention_ms`;
  * runs a watchdog that, when any lock is held past
    `engine.lock_hold_budget_s`, dumps every thread's stack plus the
    held-lock table into a flight-recorder bundle (obs/flight.py) —
    the post-hoc artifact for a suspected deadlock.

Off (the default), `make_lock` returns a plain threading.Lock/RLock: the
hot path pays nothing. Lock sites opt in by constructing through
`make_lock("Class.attr", conf)` instead of `threading.Lock()` — the name
must match the static model's (`ClassName.attr` for instance locks,
`relpath:NAME` for module-level ones) or order assertions are skipped
for it.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback

__all__ = (
    "LockOrderError", "make_lock", "resolve_lock_debug",
    "resolve_contention_ms", "resolve_hold_budget_s", "held_locks",
    "check_holds", "reset_for_tests",
)


def resolve_lock_debug(conf: dict | None = None) -> bool:
    """`engine.lock_debug` / NDS_LOCK_DEBUG; off by default."""
    v = None
    if conf:
        v = conf.get("engine.lock_debug")
    if v is None:
        v = os.environ.get("NDS_LOCK_DEBUG")
    if v is None:
        return False
    return str(v).strip().lower() in ("1", "true", "yes", "on")


def resolve_contention_ms(conf: dict | None = None) -> float:
    """`engine.lock_contention_ms` / NDS_LOCK_CONTENTION_MS: acquisition
    waits at or above this emit `lock_contention` (default 50ms)."""
    v = None
    if conf:
        v = conf.get("engine.lock_contention_ms")
    if v is None:
        v = os.environ.get("NDS_LOCK_CONTENTION_MS")
    try:
        return max(float(v), 0.0) if v is not None and v != "" else 50.0
    except (TypeError, ValueError):
        return 50.0


def resolve_hold_budget_s(conf: dict | None = None) -> float:
    """`engine.lock_hold_budget_s` / NDS_LOCK_HOLD_BUDGET_S: a lock held
    past this is a suspected deadlock — the watchdog dumps all-thread
    stacks + the held-lock table to the flight recorder (default 30s;
    0 disables the watchdog)."""
    v = None
    if conf:
        v = conf.get("engine.lock_hold_budget_s")
    if v is None:
        v = os.environ.get("NDS_LOCK_HOLD_BUDGET_S")
    try:
        return max(float(v), 0.0) if v is not None and v != "" else 30.0
    except (TypeError, ValueError):
        return 30.0


class LockOrderError(RuntimeError):
    """A live acquisition inverted the pinned static lock order."""


# per-thread stack of currently-held DebugLocks (innermost last) and the
# re-entrancy latch that keeps the sanitizer's own telemetry (which may
# take a wrapped Tracer/Metrics lock) out of its own order checks
_tls = threading.local()

# process-wide held-lock registry for the watchdog/deadlock dump, keyed
# by id(proxy) — two Sessions share the NAME "Session.cache_lock" but
# are distinct locks. Guarded by a PLAIN lock on purpose: the registry
# must never recurse into its own instrumentation.
_REG_LOCK = threading.Lock()
# id(DebugLock) -> {"name","thread","since"}; process-wide BY DESIGN —
# the watchdog and the deadlock dump must see every session's holds
_HELD = {}  # nds-lint: disable=mutable-module-global

_rank_cache = None  # {lock name -> rank}, lazily loaded pinned order
_watchdog = None  # singleton watchdog thread handle
# (id, since) holds already bundled — dump once each (process-wide for
# the same reason as _HELD)
_dumped = set()  # nds-lint: disable=mutable-module-global


def _ranks() -> dict:
    """The pinned canonical order, name -> position. Loaded lazily from
    anchors/lock_order_torch.golden via the static model; an unreadable
    golden disables order assertions (never takes the workload down)."""
    # process-wide memo of one immutable golden — not per-stream state
    global _rank_cache  # nds-lint: disable=mutable-module-global
    if _rank_cache is None:
        try:
            from ..analysis import concurrency

            _rank_cache = concurrency.load_pinned_order()
        except Exception:
            _rank_cache = {}
    return _rank_cache


def _held_stack():
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


def _in_hook() -> bool:
    return getattr(_tls, "hook", False)


class _HookScope:
    def __enter__(self):
        self._prev = getattr(_tls, "hook", False)
        _tls.hook = True

    def __exit__(self, *exc):
        _tls.hook = self._prev
        return False


def _emit_contention(name: str, wait_ms: float):
    # the tracer's own lock may be a DebugLock: latch the hook flag so
    # this emission is exempt from order checks and wait accounting
    with _HookScope():
        try:
            from ..obs import trace as obs_trace

            tr = obs_trace.current()
            if tr is not None:
                tr.emit("lock_contention", lock=name, wait_ms=wait_ms)
        except Exception:
            pass  # telemetry must never take the workload down


class DebugLock:
    """Order-recording proxy over one named lock (see module docstring).
    Context-manager + acquire/release compatible with threading.Lock."""

    def __init__(self, name: str, inner, contention_ms: float,
                 hold_budget_s: float):
        self.name = str(name)
        self._inner = inner
        self._contention_ms = float(contention_ms)
        self._hold_budget_s = float(hold_budget_s)
        self._depth = 0  # re-entrant holds by the owning thread

    # -- order assertion -------------------------------------------------
    def _assert_order(self):
        ranks = _ranks()
        mine = ranks.get(self.name)
        if mine is None:
            return
        for held in _held_stack():
            if held is self:
                continue  # re-entrant re-acquire of an RLock
            r = ranks.get(held.name)
            if r is not None and r > mine:
                raise LockOrderError(
                    f"lock order inversion: acquiring {self.name!r} "
                    f"(rank {mine}) while holding {held.name!r} (rank "
                    f"{r}); the pinned order "
                    f"(anchors/lock_order_torch.golden) requires "
                    f"{self.name!r} first. Fix the nesting or "
                    f"re-pin the order after review."
                )

    # -- bookkeeping -----------------------------------------------------
    def _on_acquired(self, waited_s: float):
        _held_stack().append(self)
        self._depth += 1
        if self._depth == 1:
            with _REG_LOCK:
                _HELD[id(self)] = {
                    "name": self.name,
                    "thread": threading.current_thread().name,
                    "since": time.monotonic(),
                }
        wait_ms = waited_s * 1000.0
        if self._contention_ms and wait_ms >= self._contention_ms:
            _emit_contention(self.name, round(wait_ms, 1))

    def _on_released(self):
        st = _held_stack()
        # release order may differ from acquire order under explicit
        # acquire()/release() pairs: drop the newest entry for self
        for i in range(len(st) - 1, -1, -1):
            if st[i] is self:
                del st[i]
                break
        self._depth -= 1
        if self._depth <= 0:
            self._depth = 0
            with _REG_LOCK:
                _HELD.pop(id(self), None)

    # -- lock protocol ---------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        if _in_hook():
            return self._inner.acquire(blocking, timeout)
        self._assert_order()
        t0 = time.monotonic()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._on_acquired(time.monotonic() - t0)
        return ok

    def release(self):
        if _in_hook():
            return self._inner.release()
        self._inner.release()
        self._on_released()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        fn = getattr(self._inner, "locked", None)  # RLock lacks it pre-3.14
        return fn() if fn is not None else self._depth > 0

    def __repr__(self):
        return f"<DebugLock {self.name!r} depth={self._depth}>"


def make_lock(name: str, conf: dict | None = None, reentrant: bool = False):
    """The named-lock factory every shared-state lock site constructs
    through. Debug off (default): a plain Lock/RLock, zero overhead.
    Debug on: a DebugLock asserting the pinned order (module docstring).
    Module-level locks (created at import, no conf in scope) resolve the
    knob from the environment only."""
    inner = threading.RLock() if reentrant else threading.Lock()
    if not resolve_lock_debug(conf):
        return inner
    lock = DebugLock(
        name, inner,
        contention_ms=resolve_contention_ms(conf),
        hold_budget_s=resolve_hold_budget_s(conf),
    )
    _ensure_watchdog(resolve_hold_budget_s(conf))
    return lock


# ---------------------------------------------------------------------------
# watchdog: suspected-deadlock dump
# ---------------------------------------------------------------------------


def held_locks() -> list:
    """The held-lock table (name, owning thread, held-for seconds),
    oldest hold first — the bundle's `threads.locks` section."""
    now = time.monotonic()
    with _REG_LOCK:
        rows = [
            {
                "lock": rec["name"],
                "thread": rec["thread"],
                "held_s": round(now - rec["since"], 3),
            }
            for rec in _HELD.values()
        ]
    rows.sort(key=lambda r: -r["held_s"])
    return rows


def _thread_stacks() -> dict:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        label = f"{names.get(ident, 'unknown')}-{ident}"
        out[label] = traceback.format_stack(frame)
    return out


def _dump_suspected_deadlock(over: list):
    """Bundle all-thread stacks + the held-lock table into the flight
    recorder: the post-hoc artifact for a hold past budget."""
    with _HookScope():
        try:
            from ..obs import flight

            names = ", ".join(sorted(r["lock"] for r in over))
            flight.recorder().flush(
                reason=f"lock hold budget exceeded: {names}",
                threads={"stacks": _thread_stacks(), "locks": held_locks()},
            )
        except Exception:
            pass  # forensics must never take the workload down


def check_holds(now: float | None = None, budget_s: float | None = None):
    """One watchdog sweep, separable for tests: returns the over-budget
    held-lock rows (and bundles them once per hold when any exist)."""
    if now is None:
        now = time.monotonic()
    over, fresh = [], []
    with _REG_LOCK:
        for key, rec in _HELD.items():
            budget = budget_s
            if budget is None:
                budget = resolve_hold_budget_s()
            if budget and now - rec["since"] >= budget:
                row = {
                    "lock": rec["name"],
                    "thread": rec["thread"],
                    "held_s": round(now - rec["since"], 3),
                }
                over.append(row)
                if (key, rec["since"]) not in _dumped:
                    _dumped.add((key, rec["since"]))
                    fresh.append(row)
    if fresh:
        _dump_suspected_deadlock(fresh)
    return over


def _watchdog_loop(budget_s: float):
    interval = min(1.0, max(budget_s / 4.0, 0.05))
    while True:
        time.sleep(interval)
        try:
            check_holds(budget_s=budget_s)
        except Exception:
            pass  # the sweeper must never die loudly mid-run


def _ensure_watchdog(budget_s: float):
    # one sweeper per process, whichever session arms it first
    global _watchdog  # nds-lint: disable=mutable-module-global
    if not budget_s or _watchdog is not None:
        return
    with _REG_LOCK:
        if _watchdog is None:
            t = threading.Thread(
                target=_watchdog_loop, args=(budget_s,),
                name="nds-lockdebug-watchdog", daemon=True,
            )
            t.start()
            _watchdog = t


def reset_for_tests():
    """Drop the lazy rank cache + held/dumped registries (unit tests
    flip the golden and the knob between cases)."""
    global _rank_cache  # nds-lint: disable=mutable-module-global
    _rank_cache = None
    with _REG_LOCK:
        _HELD.clear()
        _dumped.clear()
    if getattr(_tls, "held", None):
        _tls.held = []
