"""Concurrency contract analyzer over nds_tpu_torch/: the static half of
the thread-safety story, the port of nds_tpu/analysis/concurrency.py, built
on the lint substrate (analysis/lint.py).

The engine's multi-thread tier is built by hand (serve worker pool, router
prober, DM/maintenance threads, memwatch sampler, http handlers, spill
eviction, fleet-shared stores). A chaos test can *witness* a race or
deadlock once; the rules here make the whole class unwritable:

  guarded-by            every mutation of declared-shared state must happen
                        under the declared lock. Shared state is declared
                        at its initialising assignment with a
                        `# nds-guarded-by: <lock-attr>` comment (same line
                        or the line above); `# nds-guarded-by: none` plus a
                        reason declares by-design unguarded state (atomic
                        word stamps, monotonic beats). Any OTHER attribute
                        of a MULTITHREAD_CLASSES class that is mutated
                        outside __init__ is an UNDECLARED shared attr — the
                        annotation map must be the complete inventory.
                        Methods named `*_locked` follow the caller-holds-
                        the-lock convention and are exempt from the span
                        check. Subsumes the older `cache-lock-discipline`
                        (the Session-cache half below is its old body; the
                        old rule name still works in pragmas via
                        RULE_ALIASES).
  blocking-under-lock   no filesystem / network / compile / sleep call
                        inside a `with <lock>:` span: a blocking call under
                        a hot lock convoys every other thread behind a
                        syscall (and a compile under a lock can stall the
                        fleet for seconds). Known-bounded writes that the
                        lock exists to serialize carry a justified pragma.
  lock-order            the static lock-acquisition graph (nested `with`
                        spans plus call edges, resolved through the named-
                        lock registry) must stay acyclic and must match the
                        canonical order pinned in
                        anchors/lock_order_torch.golden (the JAX package
                        pins its own in anchors/lock_order.golden) —
                        regenerate with
                        `python -m nds_tpu_torch.cli.lint --write-lock-order`.
                        The runtime half (engine/lockdebug.py,
                        `engine.lock_debug`) asserts the same pinned order
                        on live acquisitions.
  thread-leak           every `threading.Thread(...)` must either be
                        daemonized (`daemon=True`) or have its binding
                        (variable or attribute) `.join()`ed somewhere in
                        the same module — the throughput child-handle bug
                        class, for threads.

Scope note (honest limits): span detection is line-based and per-file, the
same bet `cache-lock-discipline` made — a lock held by a caller needs a
`*_locked` method name or a justified pragma; aliasing a shared attr into
a local and mutating the alias dodges the rule. Lock-order call edges
resolve `self.m()` within a class, bare `f()` within a module, and
`<expr>.m()` only when `m` names exactly one lock-acquiring method across
the tree (generic names are blocklisted) — the golden file pins whatever
the model finds, so resolution drift is visible in review.
"""

from __future__ import annotations

import ast
import os
import re

from .lint import (
    Finding,
    RULE_ALIASES,
    _rule,
    _scope_all,
    iter_py_files,
    package_root,
)

# ---------------------------------------------------------------------------
# shared-state model: who runs on more than one thread
# ---------------------------------------------------------------------------

#: thread entry points (informational — the reason the classes below are
#: multi-thread): methods reachable from any two of these run concurrently
THREAD_ENTRY_POINTS = {
    "serve worker pool": "serve/service.py QueryService (ThreadPoolExecutor)",
    "router prober": "serve/router.py QueryRouter._probe_loop (daemon)",
    "stream job runners": "serve/jobs.py StreamJobs._run_job (daemon)",
    "DM/maintenance threads": "lakehouse/maintenance.py + serve DM lane",
    "memwatch sampler": "obs/memwatch.py MemorySampler (daemon)",
    "http handlers": "obs/httpserv.py ThreadingHTTPServer (daemon)",
    "lockdebug watchdog": "engine/lockdebug.py hold-budget sweeper (daemon)",
}

#: classes whose methods run on more than one of the entry points above;
#: the guarded-by rule requires every attr they mutate outside __init__ to
#: be declared (`# nds-guarded-by: <lock>` / `none`). Keyed by package-
#: relative path so the rule stays per-file (the lint substrate contract).
MULTITHREAD_CLASSES = {
    "engine/session.py": ("Session", "Catalog"),
    "engine/aotcache.py": ("AotCache", "PromotionStore"),
    "engine/spill.py": ("SpillPool",),
    "serve/service.py": ("QueryService",),
    "serve/jobs.py": ("StreamJobs",),
    "serve/router.py": ("QueryRouter", "Replica"),
    "obs/trace.py": ("Tracer",),
    "obs/metrics.py": ("MetricsRegistry", "MetricsSink"),
    "obs/flight.py": ("FlightRecorder",),
    "obs/memwatch.py": ("MemorySampler",),
    "analysis/feedback.py": ("FeedbackStore",),
    "lakehouse/leases.py": ("ReaderLeases",),
    "lakehouse/catalog.py": ("CatalogCoordinator",),
}

_GUARD_DECL_RE = re.compile(
    r"#\s*nds-guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*|none)\b"
)

#: constructors whose product is itself a synchronizer (internally safe);
#: attrs initialised from one are exempt from the declaration requirement
_SYNC_CTORS = (
    "Lock", "RLock", "Event", "Condition", "Semaphore", "BoundedSemaphore",
    "Barrier", "local", "make_lock",
)

#: container-mutator method names treated as writes to the receiver
_CONTAINER_MUTATORS = (
    "append", "appendleft", "add", "update", "pop", "popleft", "popitem",
    "clear", "extend", "remove", "discard", "insert", "setdefault",
    "move_to_end", "sort",
)


def _is_lockish(name: str) -> bool:
    return name.lower().endswith("lock")


def _is_sync_ctor(value) -> bool:
    if not isinstance(value, ast.Call):
        return False
    f = value.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None
    )
    return name in _SYNC_CTORS


def guard_decls(src: str) -> dict:
    """line number -> declared lock-attr name (or "none")."""
    out = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = _GUARD_DECL_RE.search(line)
        if m:
            out[i] = m.group(1)
    return out


def class_guard_map(tree, src: str) -> dict:
    """{class name: {attr: lock-attr | "none"}} from `# nds-guarded-by:`
    comments attached to `self.<attr> = ...` assignments (the comment sits
    on the assignment's first/last line or the line above)."""
    decls = guard_decls(src)
    out = {}
    for cls in (n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)):
        amap = {}
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            else:
                continue
            lock = (
                decls.get(node.lineno)
                or decls.get(node.lineno - 1)
                or decls.get(node.end_lineno)
            )
            if not lock:
                continue
            for t in targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    amap[t.attr] = lock
        out[cls.name] = amap
    return out


def lock_spans(tree):
    """[(start, end, {identifier})] for every `with` statement whose
    context expression mentions a lock-ish name. Line-span based, like the
    cache-lock-discipline rule: everything inside the span counts as
    guarded by the names."""
    spans = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        names = set()
        for item in node.items:
            for x in ast.walk(item.context_expr):
                if isinstance(x, ast.Attribute):
                    names.add(x.attr)
                elif isinstance(x, ast.Name):
                    names.add(x.id)
        if any(_is_lockish(n) for n in names):
            spans.append((node.lineno, node.end_lineno, names))
    return spans


def _sync_attrs(cls) -> set:
    """Attrs of `cls` initialised from a synchronizer constructor (or from
    a `threading.Thread(...)`): internally safe, exempt from declaration."""
    out = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        if not (_is_sync_ctor(node.value) or _is_thread_ctor(node.value)):
            continue
        for t in node.targets:
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ):
                out.add(t.attr)
    return out


def iter_attr_mutations(fn):
    """Yield (receiver expr, attr, lineno, description) for attribute-state
    mutations lexically inside `fn` (nested defs included: closures run on
    the same thread entry points as their definer)."""
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            for t in targets:
                if isinstance(t, ast.Attribute):
                    yield t.value, t.attr, node.lineno, "assignment to"
                elif isinstance(t, ast.Subscript) and isinstance(
                    t.value, ast.Attribute
                ):
                    yield (
                        t.value.value, t.value.attr, node.lineno,
                        "subscript store into",
                    )
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Attribute):
                    yield t.value, t.attr, node.lineno, "delete of"
                elif isinstance(t, ast.Subscript) and isinstance(
                    t.value, ast.Attribute
                ):
                    yield (
                        t.value.value, t.value.attr, node.lineno,
                        "subscript delete from",
                    )
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _CONTAINER_MUTATORS
            and isinstance(node.func.value, ast.Attribute)
        ):
            recv = node.func.value
            yield (
                recv.value, recv.attr, node.lineno,
                f".{node.func.attr}() on",
            )


def _class_findings(tree, src, classes):
    """The declared-attr half of guarded-by, over one file's multithread
    classes."""
    gmap = class_guard_map(tree, src)
    spans = lock_spans(tree)

    def guarded(line, lock):
        return any(a <= line <= b and lock in names for a, b, names in spans)

    # attr -> (owner class, lock) for attrs declared by exactly one of the
    # file's multithread classes: lets `rep.healthy = ...` in QueryRouter
    # methods resolve to Replica's declared guard without type inference
    uniq = {}
    for cls_name in classes:
        for attr, lock in gmap.get(cls_name, {}).items():
            uniq[attr] = None if attr in uniq else (cls_name, lock)

    out = []
    for cls in (n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)):
        if cls.name not in classes:
            continue
        declared = gmap.get(cls.name, {})
        sync = _sync_attrs(cls)
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if meth.name == "__init__":
                continue
            holds_callers_lock = meth.name.endswith("_locked")
            for recv, attr, line, desc in iter_attr_mutations(meth):
                is_self = isinstance(recv, ast.Name) and recv.id == "self"
                if is_self:
                    owner, lock = cls.name, declared.get(attr)
                    if lock is None:
                        if attr in sync:
                            continue
                        out.append((line, (
                            f"{desc} undeclared attr `self.{attr}` of "
                            f"multithread class {cls.name} outside __init__;"
                            f" declare it at its initialising assignment "
                            f"(`# nds-guarded-by: <lock>` or "
                            f"`# nds-guarded-by: none -- <reason>`) so the "
                            f"shared-state inventory stays complete"
                        )))
                        continue
                else:
                    hit = uniq.get(attr)
                    if not hit:
                        continue
                    owner, lock = hit
                if lock == "none" or holds_callers_lock:
                    continue
                if not guarded(line, lock):
                    out.append((line, (
                        f"{desc} `{attr}` (declared "
                        f"`# nds-guarded-by: {lock}` on {owner}) outside a "
                        f"`with ...{lock}:` span; every unguarded mutation "
                        f"of declared-shared state is a latent race "
                        f"(caller-holds-lock helpers use the `_locked` "
                        f"name suffix)"
                    )))
    return out


# ---------------------------------------------------------------------------
# guarded-by: the Session-cache half (cache-lock-discipline's body, moved
# here verbatim when that rule was retired into this one)
# ---------------------------------------------------------------------------

#: session-level caches whose mutation must hold the session cache lock
#: (Session.cache_lock): serve mode makes these multi-tenant, and every
#: unguarded mutation is a latent race.
#: `aot_cache` (the persistent executable cache) and `promotion_store`
#: (the persisted A/B verdicts) are internally locked AND cross-process
#: atomic (tempfile+rename), but their session-level mutation sites hold
#: the same discipline so a future refactor cannot silently regress them.
_GUARDED_CACHES = (
    "exec_cache", "join_order_cache", "pallas_promotions", "plan_cache",
    "aot_cache", "promotion_store", "feedback_store",
)

#: attribute calls that mutate a cache object (ExecutableCache.lookup
#: builds + inserts; AotCache.store/vacuum write + unlink entries;
#: PromotionStore.record merges a verdict; FeedbackStore.lookup caches
#: misses, record/record_skew buffer deltas, flush commits them;
#: OrderedDict/dict mutators). Plain `.get`/`.load` reads are not
#: flagged — the LRU caches' own get() sites are lock-wrapped anyway.
_CACHE_MUTATORS = (
    "clear", "put", "pop", "popitem", "update", "setdefault", "lookup",
    "store", "vacuum", "record", "record_skew", "flush",
)


def _chain_cache_name(expr):
    """The guarded-cache attribute name reachable in an expression's
    attribute chain (session.exec_cache.map -> "exec_cache"), or None."""
    for x in ast.walk(expr):
        if isinstance(x, ast.Attribute) and x.attr in _GUARDED_CACHES:
            return x.attr
    return None


def _session_cache_findings(tree):
    spans = lock_spans(tree)

    def guarded(line):
        return any(a <= line <= b for a, b, _ in spans)

    # local-alias taint: `cache = self._session_cache()` / `c = s.plan_cache`
    # / `c = getattr(s, "plan_cache", None)` — the string-constant getattr
    # form reaches the same object with no Attribute node, so without it
    # an alias could silently dodge the rule
    def _getattr_cache_name(src):
        if (
            isinstance(src, ast.Call)
            and isinstance(src.func, ast.Name)
            and src.func.id == "getattr"
            and len(src.args) >= 2
            and isinstance(src.args[1], ast.Constant)
            and src.args[1].value in _GUARDED_CACHES
        ):
            return src.args[1].value
        return None

    tainted = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(
            node.value, (ast.Attribute, ast.Call)
        ):
            src = node.value
            hit = (
                _chain_cache_name(src) is not None
                or _getattr_cache_name(src) is not None
                or (
                    isinstance(src, ast.Call)
                    and isinstance(src.func, ast.Attribute)
                    and src.func.attr == "_session_cache"
                )
            )
            if hit:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        tainted.add(t.id)

    def receiver_is_cache(value):
        if _chain_cache_name(value) is not None:
            return True
        return isinstance(value, ast.Name) and value.id in tainted

    out = []
    for node in ast.walk(tree):
        line = msg = None
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _CACHE_MUTATORS
            and receiver_is_cache(node.func.value)
        ):
            line = node.lineno
            msg = f".{node.func.attr}() on a session cache"
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                if isinstance(t, ast.Subscript) and receiver_is_cache(t.value):
                    line = node.lineno
                    msg = "subscript store into a session cache"
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and receiver_is_cache(t.value):
                    line = node.lineno
                    msg = "subscript delete from a session cache"
        if line is not None and not guarded(line):
            out.append((line, (
                f"{msg} outside a held session lock "
                f"(`with session.cache_lock:`); exec/join-order/pallas/"
                f"plan caches go multi-tenant under the serve work and "
                f"every unguarded mutation is a latent race"
            )))
    return out


@_rule("guarded-by", _scope_all)
def _r_guarded_by(tree, relpath):
    out = list(_session_cache_findings(tree))
    classes = MULTITHREAD_CLASSES.get(relpath)
    if classes:
        src = getattr(tree, "_nds_lint_source", "") or ""
        out.extend(_class_findings(tree, src, classes))
    return out


# the retired rule's name keeps working in `# nds-lint: disable=` pragmas
RULE_ALIASES["cache-lock-discipline"] = "guarded-by"


# ---------------------------------------------------------------------------
# blocking-under-lock
# ---------------------------------------------------------------------------

#: module-qualified blocking calls: (receiver module name, attr)
_BLOCKING_QUALIFIED = {
    ("time", "sleep"), ("os", "replace"), ("os", "rename"),
    ("os", "makedirs"), ("os", "unlink"), ("os", "remove"),
    ("os", "listdir"), ("os", "scandir"),
    ("shutil", "rmtree"), ("shutil", "copy"), ("shutil", "copyfile"),
    ("shutil", "move"),
    ("json", "dump"), ("json", "load"),
    ("pickle", "dump"), ("pickle", "load"),
    ("subprocess", "run"), ("subprocess", "check_call"),
    ("subprocess", "check_output"), ("subprocess", "Popen"),
    ("socket", "create_connection"),
    ("torch", "compile"), ("torch", "save"), ("torch", "load"),
}

#: bare-name blocking calls (direct or `from x import y` forms)
_BLOCKING_BARE = {"open", "fs_open", "fs_open_atomic", "urlopen", "sleep",
                  "jit"}

#: method names that block regardless of receiver (network handshake /
#: HTTP round-trip / compile). `.compile()` on `re` is exempt (CPU-bound
#: and bounded). The reference's `.lower(...)` (jax AOT lowering) has no
#: counterpart in the port; `.synchronize()` waits for the card.
_BLOCKING_METHODS = {"connect", "request", "getresponse", "compile",
                     "synchronize"}


def _blocking_call_desc(node):
    f = node.func
    if isinstance(f, ast.Name):
        if f.id in _BLOCKING_BARE:
            return f"{f.id}()"
        return None
    if not isinstance(f, ast.Attribute):
        return None
    recv = f.value
    if isinstance(recv, ast.Name) and (recv.id, f.attr) in _BLOCKING_QUALIFIED:
        return f"{recv.id}.{f.attr}()"
    if f.attr in _BLOCKING_METHODS:
        if isinstance(recv, ast.Name) and recv.id == "re":
            return None
        return f".{f.attr}()"
    return None


@_rule("blocking-under-lock", _scope_all)
def _r_blocking_under_lock(tree, relpath):
    spans = lock_spans(tree)
    if not spans:
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        desc = _blocking_call_desc(node)
        if desc is None:
            continue
        if any(a <= node.lineno <= b for a, b, _ in spans):
            out.append((node.lineno, (
                f"blocking call {desc} inside a `with <lock>:` span; a "
                f"syscall or compile under a hot lock convoys every other "
                f"thread behind it — move the slow work outside the span "
                f"(or pragma with a reason when the lock exists to "
                f"serialize exactly this bounded write)"
            )))
    return out


# ---------------------------------------------------------------------------
# thread-leak
# ---------------------------------------------------------------------------


def _is_thread_ctor(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr == "Thread"
    return isinstance(f, ast.Name) and f.id == "Thread"


@_rule("thread-leak", _scope_all)
def _r_thread_leak(tree, relpath):
    # every identifier (variable or attribute name) that gets `.join()`ed
    # or `.daemon = True`d anywhere in the module
    joined, daemonized = set(), set()
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "join"
        ):
            for x in ast.walk(node.func.value):
                if isinstance(x, ast.Name):
                    joined.add(x.id)
                elif isinstance(x, ast.Attribute):
                    joined.add(x.attr)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and t.attr == "daemon"
                    and getattr(node.value, "value", None) is True
                ):
                    for x in ast.walk(t.value):
                        if isinstance(x, ast.Name):
                            daemonized.add(x.id)
                        elif isinstance(x, ast.Attribute):
                            daemonized.add(x.attr)

    # `for t in threads: t.join()` joins every handle in `threads`: map
    # loop vars back to the names they iterate (two passes cover a
    # nested `for group in batches: for t in group: t.join()`)
    loops = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            tgt = {
                x.id for x in ast.walk(node.target)
                if isinstance(x, ast.Name)
            }
            src = set()
            for x in ast.walk(node.iter):
                if isinstance(x, ast.Name):
                    src.add(x.id)
                elif isinstance(x, ast.Attribute):
                    src.add(x.attr)
            loops.append((tgt, src))
    for _ in range(2):
        for tgt, src in loops:
            if tgt & joined:
                joined |= src
            if tgt & daemonized:
                daemonized |= src

    # Thread(...) ctor -> the names its handle is bound to
    bound = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for x in ast.walk(node.value):
            if _is_thread_ctor(x):
                names = bound.setdefault(id(x), set())
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
                    elif isinstance(t, ast.Attribute):
                        names.add(t.attr)

    out = []
    for node in ast.walk(tree):
        if not _is_thread_ctor(node):
            continue
        if any(
            kw.arg == "daemon" and getattr(kw.value, "value", None) is True
            for kw in node.keywords
        ):
            continue
        names = bound.get(id(node), set())
        if names & joined or names & daemonized:
            continue
        out.append((node.lineno, (
            "non-daemon Thread with no `.join()` of its handle in this "
            "module: a leaked worker outlives shutdown and pins the "
            "process (the throughput child-handle class). Pass "
            "`daemon=True`, join the handle on the shutdown path, or "
            "pragma with the lifecycle reason"
        )))
    return out


# ---------------------------------------------------------------------------
# lock-order: static acquisition graph, cycles, pinned canonical order
# ---------------------------------------------------------------------------

#: method names too generic for cross-object call resolution (a `.get()`
#: could be anything; resolving it to one class's method would fabricate
#: lock edges)
_GENERIC_METHODS = frozenset({
    "acquire", "release", "locked", "wait", "notify", "notify_all",
    "set", "clear", "get", "put", "items", "keys", "values", "append",
    "add", "pop", "update", "copy", "read", "write", "close", "flush",
    "start", "join", "run", "submit", "record", "send", "recv", "result",
    "cancel", "done", "shutdown", "encode", "decode", "format", "strip",
    "split", "lower", "upper", "observe", "inc",
})

#: model edges known to be artifacts of coarse name-based resolution, not
#: real nested acquisitions: (outer, inner) -> reason. Reviewed config,
#: the tree-wide analogue of a pragma.
FALSE_EDGES = {}

#: the converse: real nested acquisitions the name-based resolution cannot
#: see, because the callee's method name is generic or shared by several
#: classes. (outer, inner) -> the functions ("relpath", "Class.method")
#: whose `with <outer>:` span makes the call; each adds the edge at that
#: span's line, so a site that goes away drops its edge and the golden
#: shows the drift. Reviewed config, like FALSE_EDGES.
KNOWN_EDGES = {
    # the session lock is held around every feedback-store call (the
    # guarded-by rule demands it); `record`, `flush` and `lookup` do not
    # resolve by name. The JAX package's model sees this edge through
    # `record_skew`, which the port's exchange (item 13) does not call yet
    ("Session.cache_lock", "FeedbackStore._lock"): (
        ("engine/exec.py", "Executor._record_feedback"),
        ("analysis/budget.py", "budget_plan"),
        ("engine/session.py", "Result.table"),
    ),
    # the port's exec cache builds a missing fused entry under the session
    # lock, and the build loads or stores it in the persistent cache
    # (fuse.build_entry, called from a lambda the model does not enter)
    ("Session.cache_lock", "AotCache._lock"): (
        ("engine/exec.py", "Executor._exec_pipeline"),
        ("engine/exec.py", "Executor._apply_wrappers_fused"),
    ),
    # a measured kernel verdict is memoized and persisted in one critical
    # section (`record` is generic)
    ("Session.cache_lock", "PromotionStore._lock"): (
        ("engine/exec.py", "Executor._measure_promotion"),
    ),
    # serve's admission plans a statement under the session lock: binding
    # reads lakehouse manifests (a fault-injection site), pinning a scan
    # registers its reader lease, and the budgeter's and pruner's events
    # reach the metrics sink. `maybe_fire` is a module function, `emit` has
    # two owners and the sink dispatches through a table, so none resolves
    ("Session.cache_lock", "FaultRegistry._lock"): (
        ("engine/session.py", "Session.plan_stmt"),
    ),
    ("Session.cache_lock", "ReaderLeases._lock"): (
        ("engine/session.py", "Session.plan_stmt"),
    ),
    ("Session.cache_lock", "MetricsRegistry._lock"): (
        ("engine/session.py", "Session.plan_stmt"),
    ),
    ("Session.cache_lock", "MetricsSink._slock"): (
        ("engine/session.py", "Session.plan_stmt"),
    ),
    # serve's writer runs a whole DML statement under its lock: the
    # statement's fault sites and the memory sampler's heartbeat events
    ("QueryService._writer_lock", "FaultRegistry._lock"): (
        ("serve/service.py", "QueryService._run_dml"),
    ),
    ("QueryService._writer_lock", "MetricsRegistry._lock"): (
        ("serve/service.py", "QueryService._run_dml"),
    ),
}


class LockModel:
    """The tree-wide lock model: named locks, the acquisition graph, its
    cycles, and the canonical (topological) order."""

    def __init__(self):
        self.locks = {}    # canonical name -> "relpath:line" definition
        self.edges = {}    # (outer, inner) -> sorted ["relpath:line", ...]
        self.cycles = []   # [[name, ...], ...] (each a cycle)
        self.order = []    # canonical order over all named locks


def _lock_name_for_attr_assign(cls_name, target, value):
    if not (_is_sync_ctor(value) and isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self" and _is_lockish(target.attr)):
        return None
    return f"{cls_name}.{target.attr}"


class _Fn:
    __slots__ = ("key", "spans", "calls", "direct")

    def __init__(self, key):
        self.key = key        # (relpath, class name | None, func name)
        self.spans = []       # (lock name | None, start, end)
        self.calls = []       # (kind, payload, lineno)
        self.direct = set()   # lock names acquired directly


def _walk_excluding_defs(node):
    """Yield every node in `node`'s subtree without descending into nested
    function/class definitions or lambdas: a nested def's body executes at
    call time, so its acquisitions are NOT lexically nested under the
    enclosing function's lock spans (modelling it inline would fabricate
    containment edges)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _walk_file(relpath, tree, locks, attr_owner, module_locks, fns,
               method_index, module_fns):
    """Pass 2 over one parsed file: collect per-function spans and calls.
    `fns` etc. are the tree-wide accumulators."""

    def visit_fn(fn_node, cls_name):
        fn = _Fn((relpath, cls_name, fn_node.name))
        fns[fn.key] = fn
        if cls_name is not None:
            method_index.setdefault(fn_node.name, []).append(fn.key)
        else:
            module_fns[(relpath, fn_node.name)] = fn.key

        def resolve_lock(expr):
            # `self.X` inside the owning class
            if (
                isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and cls_name is not None
                and f"{cls_name}.{expr.attr}" in locks
            ):
                return f"{cls_name}.{expr.attr}"
            # unique attr name across every class in the tree
            if isinstance(expr, ast.Attribute):
                owners = attr_owner.get(expr.attr, ())
                if len(owners) == 1:
                    return next(iter(owners))
            # module-level lock in this module
            if isinstance(expr, ast.Name):
                name = f"{relpath}:{expr.id}"
                if name in module_locks:
                    return name
            return None

        for node in _walk_excluding_defs(fn_node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lockish = [
                        x for x in ast.walk(item.context_expr)
                        if isinstance(x, (ast.Attribute, ast.Name))
                        and _is_lockish(
                            x.attr if isinstance(x, ast.Attribute) else x.id
                        )
                    ]
                    if not lockish:
                        continue
                    resolved = resolve_lock(lockish[0])
                    fn.spans.append((resolved, node.lineno, node.end_lineno))
                    if resolved:
                        fn.direct.add(resolved)
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Name):
                    fn.calls.append(("module", f.id, node.lineno))
                elif isinstance(f, ast.Attribute):
                    if (
                        isinstance(f.value, ast.Name)
                        and f.value.id == "self"
                        and cls_name is not None
                    ):
                        fn.calls.append(("self", f.attr, node.lineno))
                    elif f.attr not in _GENERIC_METHODS:
                        fn.calls.append(("unique", f.attr, node.lineno))

        # directly-nested defs (thread targets, callbacks): separate model
        # functions, reachable by bare name within the module; visit_fn
        # recurses for deeper nesting
        stack = list(ast.iter_child_nodes(fn_node))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit_fn(n, cls_name)
                continue
            if isinstance(n, (ast.ClassDef, ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(n))

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            visit_fn(node, None)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    visit_fn(sub, node.name)


def build_lock_model(root: str | None = None) -> LockModel:
    """Parse the tree once and build the static lock model."""
    root = root or package_root()
    root = _rebase(root)

    model = LockModel()
    trees = {}
    attr_owner = {}     # lock attr -> {canonical names}
    module_locks = set()

    for path in iter_py_files(root):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            try:
                tree = ast.parse(f.read())
            except SyntaxError:
                continue
        trees[rel] = tree
        for node in tree.body:
            if isinstance(node, ast.Assign) and _is_sync_ctor(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name) and _is_lockish(t.id):
                        name = f"{rel}:{t.id}"
                        model.locks[name] = f"{rel}:{node.lineno}"
                        module_locks.add(name)
        for cls in (n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)):
            for node in ast.walk(cls):
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    name = _lock_name_for_attr_assign(cls.name, t, node.value)
                    if name:
                        model.locks[name] = f"{rel}:{node.lineno}"
                        attr_owner.setdefault(t.attr, set()).add(name)

    fns, method_index, module_fns = {}, {}, {}
    for rel, tree in trees.items():
        _walk_file(rel, tree, model.locks, attr_owner, module_locks, fns,
                   method_index, module_fns)

    def resolve_call(fn, kind, payload):
        if kind == "self":
            key = (fn.key[0], fn.key[1], payload)
            return key if key in fns else None
        if kind == "module":
            return module_fns.get((fn.key[0], payload))
        owners = method_index.get(payload, ())
        if len(owners) == 1:
            return owners[0]
        return None

    # fixpoint: transitive acquire sets across the resolved call graph
    acquires = {k: set(fn.direct) for k, fn in fns.items()}
    changed = True
    while changed:
        changed = False
        for key, fn in fns.items():
            cur = acquires[key]
            before = len(cur)
            for kind, payload, _line in fn.calls:
                callee = resolve_call(fn, kind, payload)
                if callee is not None:
                    cur |= acquires[callee]
            if len(cur) != before:
                changed = True

    def add_edge(outer, inner, site):
        if outer == inner or (outer, inner) in FALSE_EDGES:
            return
        model.edges.setdefault((outer, inner), set()).add(site)

    for key, fn in fns.items():
        rel = key[0]
        for outer, start, end in fn.spans:
            if outer is None:
                continue
            for inner, s2, _e2 in fn.spans:
                if inner is not None and start < s2 <= end:
                    add_edge(outer, inner, f"{rel}:{s2}")
            for kind, payload, line in fn.calls:
                if not (start <= line <= end):
                    continue
                callee = resolve_call(fn, kind, payload)
                if callee is None:
                    continue
                for inner in acquires[callee]:
                    add_edge(outer, inner, f"{rel}:{line}")

    for (outer, inner), sites in KNOWN_EDGES.items():
        if outer not in model.locks or inner not in model.locks:
            continue
        for rel, qual in sites:
            cls, _, name = qual.rpartition(".")
            fn = fns.get((rel, cls or None, name))
            if fn is None:
                continue
            for lock, start, _end in fn.spans:
                if lock == outer:
                    add_edge(outer, inner, f"{rel}:{start}")
                    break

    model.edges = {k: sorted(v) for k, v in model.edges.items()}
    model.cycles = _find_cycles(model.edges)
    model.order = _canonical_order(set(model.locks), model.edges)
    return model


def _find_cycles(edges) -> list:
    adj = {}
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
    cycles, done = [], set()
    for start in sorted(adj):
        if start in done:
            continue
        stack, path, onpath = [(start, iter(sorted(adj.get(start, ()))))], \
            [start], {start}
        while stack:
            node, it = stack[-1]
            for nxt in it:
                if nxt in onpath:
                    cycles.append(path[path.index(nxt):] + [nxt])
                elif nxt not in done:
                    stack.append((nxt, iter(sorted(adj.get(nxt, ())))))
                    path.append(nxt)
                    onpath.add(nxt)
                    break
            else:
                done.add(node)
                onpath.discard(node)
                path.pop()
                stack.pop()
    return cycles


def _canonical_order(nodes, edges) -> list:
    """Deterministic topological order (Kahn, alphabetical tie-break) over
    every named lock; nodes stuck in a cycle are appended alphabetically
    (the cycle itself is a separate, blocking finding)."""
    nodes = set(nodes)
    for a, b in edges:
        nodes.add(a)
        nodes.add(b)
    indeg = {n: 0 for n in nodes}
    adj = {n: set() for n in nodes}
    for (a, b) in edges:
        if b not in adj[a]:
            adj[a].add(b)
            indeg[b] += 1
    ready = sorted(n for n in nodes if indeg[n] == 0)
    out = []
    while ready:
        n = ready.pop(0)
        out.append(n)
        for m in sorted(adj[n]):
            indeg[m] -= 1
            if indeg[m] == 0:
                ready.append(m)
        ready.sort()
    out.extend(sorted(nodes - set(out)))
    return out


# ---------------------------------------------------------------------------
# golden file
# ---------------------------------------------------------------------------

GOLDEN_RELPATH = os.path.join("anchors", "lock_order_torch.golden")


def _rebase(root):
    """The nds_tpu_torch package directory under `root` when the caller
    passed its parent (the repository), else `root` itself."""
    nested = os.path.join(root, "nds_tpu_torch")
    if (os.path.basename(os.path.abspath(root)) != "nds_tpu_torch"
            and os.path.isdir(nested)):
        return nested
    return root


def golden_path(root: str | None = None) -> str:
    root = root or package_root()
    root = _rebase(root)
    repo = os.path.dirname(os.path.abspath(root))
    return os.path.join(repo, GOLDEN_RELPATH)


def format_golden(model: LockModel) -> str:
    lines = [
        "# nds_tpu_torch canonical lock order "
        "(anchors/lock_order_torch.golden).",
        "# Acquire locks in nondecreasing `order:` position; every",
        "# `edge: A -> B` is a static nested-acquisition site (A held",
        "# while B is taken). Drift fails the lock-order lint;",
        "# regenerate with `python -m nds_tpu_torch.cli.lint "
        "--write-lock-order`",
        "# after reviewing the new nesting. engine.lock_debug asserts",
        "# this same order on live acquisitions.",
    ]
    lines += [f"order: {name}" for name in model.order]
    for (a, b), sites in sorted(model.edges.items()):
        lines.append(f"edge: {a} -> {b}  # {sites[0]}")
    return "\n".join(lines) + "\n"


def load_golden(path: str):
    """(order list, edge set) from a golden file, or None if unreadable."""
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return None
    order, edges = [], set()
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip() if not line.startswith("#") \
            else ""
        if line.startswith("order:"):
            order.append(line[len("order:"):].strip())
        elif line.startswith("edge:"):
            a, _, b = line[len("edge:"):].partition("->")
            edges.add((a.strip(), b.strip()))
    return order, edges


def write_golden(root: str | None = None) -> str:
    model = build_lock_model(root)
    path = golden_path(root)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(format_golden(model))
    return path


def load_pinned_order(root: str | None = None) -> dict:
    """{lock name: rank} from the checked-in golden, for the runtime
    sanitizer (engine/lockdebug.py). Empty when no golden ships (installed
    package without the repo) — the sanitizer then skips order assertions
    for unranked locks."""
    got = load_golden(golden_path(root))
    if got is None:
        return {}
    order, _edges = got
    return {name: i for i, name in enumerate(order)}


def run_lock_order_lint(root: str | None = None) -> list[Finding]:
    """Tree-wide lock-order pass (run by lint.run_lint, like the unread-
    knob pass): cycles are always findings; the computed model must match
    the checked-in golden byte-for-byte in content."""
    model = build_lock_model(root)
    findings = []
    for cycle in model.cycles:
        first = model.edges.get((cycle[0], cycle[1]), ["?:0"])[0]
        path, _, line = first.partition(":")
        findings.append(Finding(path or GOLDEN_RELPATH, int(line or 0),
                                "lock-order", (
            f"lock-acquisition cycle {' -> '.join(cycle)}: two threads "
            f"taking these locks in opposite orders deadlock; break the "
            f"cycle (release before re-acquiring, or split the lock) — "
            f"a genuinely-false call-graph edge goes in "
            f"analysis/concurrency.py FALSE_EDGES with a reason"
        )))
    gpath = golden_path(root)
    if not os.path.isdir(os.path.dirname(gpath)):
        return findings  # installed package without the repo: nothing to sync
    got = load_golden(gpath)
    if got is None:
        findings.append(Finding(GOLDEN_RELPATH, 0, "lock-order", (
            "lock-order golden file missing; generate and check it in: "
            "python -m nds_tpu_torch.cli.lint --write-lock-order"
        )))
        return findings
    order, edges = got
    new_edges = set(model.edges) - edges
    gone_edges = edges - set(model.edges)
    if order != model.order or new_edges or gone_edges:
        detail = []
        if new_edges:
            detail.append("new edges: " + ", ".join(
                f"{a} -> {b}" for a, b in sorted(new_edges)))
        if gone_edges:
            detail.append("removed edges: " + ", ".join(
                f"{a} -> {b}" for a, b in sorted(gone_edges)))
        if order != model.order:
            detail.append("canonical order changed")
        findings.append(Finding(GOLDEN_RELPATH, 0, "lock-order", (
            "lock model drifted from the checked-in golden "
            f"({'; '.join(detail)}); review the new nesting, then "
            "regenerate: python -m nds_tpu_torch.cli.lint "
            "--write-lock-order"
        )))
    return findings


# ---------------------------------------------------------------------------
# shared-state report (the discovery half of the model, as a CLI)
# ---------------------------------------------------------------------------


def shared_state_report(root: str | None = None) -> str:
    """Human-readable inventory: every multithread class's declared attrs
    with their guards, plus the named-lock table and acquisition edges."""
    root = root or package_root()
    root = _rebase(root)
    lines = ["shared-state inventory (guarded-by declarations)", ""]
    for rel, classes in sorted(MULTITHREAD_CLASSES.items()):
        path = os.path.join(root, *rel.split("/"))
        try:
            with open(path, encoding="utf-8") as f:
                src = f.read()
        except OSError:
            continue
        gmap = class_guard_map(ast.parse(src), src)
        for cls in classes:
            amap = gmap.get(cls, {})
            lines.append(f"  {rel} {cls}: {len(amap)} declared attr(s)")
            for attr, lock in sorted(amap.items()):
                lines.append(f"    {attr:28s} guarded-by {lock}")
    model = build_lock_model(root)
    lines += ["", f"named locks ({len(model.locks)}):"]
    for name, site in sorted(model.locks.items()):
        lines.append(f"  {name:40s} {site}")
    lines += ["", f"acquisition edges ({len(model.edges)}):"]
    for (a, b), sites in sorted(model.edges.items()):
        lines.append(f"  {a} -> {b}  ({sites[0]})")
    if model.cycles:
        lines += ["", "CYCLES:"] + [
            "  " + " -> ".join(c) for c in model.cycles
        ]
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="nds_tpu_torch concurrency model (shared-state + "
                    "lock-order)"
    )
    ap.add_argument("root", nargs="?", default=None)
    ap.add_argument("--report", action="store_true",
                    help="print the shared-state / lock-model inventory")
    ap.add_argument("--write-lock-order", action="store_true",
                    help="regenerate anchors/lock_order_torch.golden")
    args = ap.parse_args(argv)
    if args.write_lock_order:
        print(f"wrote {write_golden(args.root)}")
        return 0
    print(shared_state_report(args.root))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
