"""Engine lint over nds_tpu_torch/: AST rules codifying the engine's known
bug classes, the port of nds_tpu/analysis/lint.py (every rule, scoped to
the port's package root).

Every rule below encodes a bug class the engine shipped (and fixed):

  mutable-module-global   a module-global dict in the executor corrupted
                          spans across concurrent throughput streams.
                          Per-stream state must live on Session/Executor
                          instances. Scope: engine/, ops/.
  perf-counter            durations computed from time.time() jump with
                          wall-clock adjustments (NTP steps mid-benchmark
                          corrupt Tpower). Durations must use
                          time.perf_counter(); epoch stamps are fine.
  atomic-write            a crash mid-`open(path, "w")` leaves a torn
                          report/state/summary a later reader chokes on.
                          Harness artifacts must go through
                          io.fs.fs_open_atomic (tmp + rename).
                          Scope: top-level harness modules
                          (nds_tpu_torch/*.py).
  host-sync-in-fuse       a fused chain is recorded once and replayed per
                          call (engine/fuse.py): a host sync in the replay
                          (`.item()`, `.tolist()`, `.cpu()`, int() /
                          float() / bool() of a tensor,
                          torch.cuda.synchronize, np.asarray) stalls the
                          host on the card once per call. Scope: the
                          replayed methods of engine/fuse.py
                          (_Tape.replay, and the per-call bodies of
                          FusedPipeline and FusedAggPipeline); the
                          reference's jitted bodies have no counterpart in
                          the port.
  local-import            a function-local `import` in the op-span hot path
                          paid a sys.modules lookup per executed plan node.
                          Hot-path modules import at module level;
                          genuinely-cold lazy imports carry a pragma.
                          Scope: engine/exec.py, engine/expr.py,
                          engine/fuse.py, ops/kernels.py.
  trace-event-schema      every `tracer.emit("<kind>", ...)` call's kind
                          must exist in obs/trace.py:EVENT_SCHEMA and pass
                          the kind's required fields (or forward **fields),
                          so schema drift breaks lint instead of the
                          tolerant trace reader. Context fields
                          (trace_id — obs/trace.py:CONTEXT_FIELDS) are
                          stamped centrally by Tracer.emit: a call site
                          passing one explicitly must declare it in the
                          kind's EVENT_SCHEMA entry. Scope: everywhere. In
                          obs/metrics.py the same rule also checks the
                          live-metric taxonomy: every family in
                          METRIC_KINDS must map to a real EVENT_SCHEMA
                          kind AND embed that kind in its name, and every
                          literal metric name passed to a registry
                          mutator must be a registered family.
  undocumented-conf-knob  every `engine.*` conf key the code reads must
                          appear in the README knob tables or a
                          properties/ template — an invisible knob can't
                          be tuned. Scope: everywhere (skipped when no
                          README is present, e.g. an installed package).
  unread-conf-knob        the inverse (tree-wide, run_unread_knob_lint):
                          every documented `engine.*` key must be
                          mentioned somewhere in the code, so dead knob
                          rows can't accumulate in the docs. Same
                          README-on-disk skip as above.
  debug-route-seam        the single-listener invariant: /debug routes
                          register on the ONE process-wide listener
                          (obs/httpserv.py) or dispatch through its
                          attach_app seam, and nothing else may construct
                          an HTTP server. Scope: everywhere except
                          obs/httpserv.py.
  manifest-write-seam     the single-committer invariant: lakehouse
                          manifest/commit-log writes happen ONLY inside
                          the committer/catalog API (lakehouse/table.py
                          `_commit` + lakehouse/catalog.py). Scope:
                          everywhere except the two committer modules.
  guarded-by              the concurrency contract (analysis/
                          concurrency.py): every mutation of declared-
                          shared state (`# nds-guarded-by: <lock>` at the
                          initialising assignment) must sit inside a
                          `with <lock>:` span, and every attr a
                          MULTITHREAD_CLASSES class mutates outside
                          __init__ must be declared. Subsumes the older
                          `cache-lock-discipline` (its name still works in
                          pragmas via RULE_ALIASES). Scope: everywhere.
  blocking-under-lock     no fs/network/compile/sleep call inside a
                          `with <lock>:` span — a syscall under a hot
                          lock convoys every thread behind it. Scope:
                          everywhere (analysis/concurrency.py).
  lock-order              tree-wide (run_lock_order_lint): the static
                          lock-acquisition graph (nested `with` spans +
                          call edges) must stay acyclic and match
                          anchors/lock_order_torch.golden; regenerate with
                          `--write-lock-order`. engine.lock_debug asserts
                          the same pinned order at runtime.
  thread-leak             every `threading.Thread(` must be daemonized
                          or have its handle `.join()`ed in the same
                          module. Scope: everywhere (analysis/
                          concurrency.py).
  scan-path-listing       the zone-map invariant: the scan path discovers
                          table files ONLY through the pinned manifest
                          (TableSnapshot.files()/file_stats()), never by
                          glob/listdir of data directories. Scope:
                          engine/session.py, engine/exec.py (the modules
                          that resolve a Scan node to files).

Pragma: append `# nds-lint: disable=<rule>[,<rule>...]` (with a
justification!) on the offending line or the line directly above to
acknowledge a known-sound exception. `disable=all` silences every rule for
that line.

Run: `./nds-tpu-torch-submit lint` (or `python -m nds_tpu_torch.cli.lint
[path]`); exits non-zero on any finding.
"""

from __future__ import annotations

import ast
import os
import re
import sys
from dataclasses import dataclass

#: rule registry: name -> (scope predicate over package-relative path,
#: checker). Populated at module bottom (and by analysis/concurrency.py,
#: imported at the bottom of this module so its rules always register).
RULES = {}

#: retired rule name -> successor: pragmas written against the old name
#: keep silencing the rule that absorbed it (`cache-lock-discipline` ->
#: `guarded-by`, registered by analysis/concurrency.py)
RULE_ALIASES = {}

_PRAGMA_RE = re.compile(r"#\s*nds-lint:\s*disable=([A-Za-z0-9_,\- ]+)")

_MUTABLE_CTORS = ("dict", "list", "set", "defaultdict", "OrderedDict",
                  "Counter", "deque")

#: the engine/fuse.py methods a fused call replays (the cursor of the
#: recorded tape, the stages, the aggregate tail and the gathers after it)
_TRACED_FNS = ("replay", "call", "_apply_stages", "_run", "_agg_column")

#: hot-path modules where function-local imports are banned
_HOT_MODULES = (
    "engine/exec.py", "engine/expr.py", "engine/fuse.py", "ops/kernels.py",
)


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _rule(name, scope):
    def deco(fn):
        RULES[name] = (scope, fn)
        return fn
    return deco


def _scope_all(relpath):
    return True


def _scope_engine_ops(relpath):
    return relpath.startswith(("engine/", "ops/"))


def _scope_harness(relpath):
    # top-level harness modules: report/state/summary artifacts are written
    # here (engine/io/datagen layers have their own seams)
    return "/" not in relpath


def _scope_fuse(relpath):
    return relpath == "engine/fuse.py"


def _scope_hot(relpath):
    return relpath in _HOT_MODULES


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


@_rule("mutable-module-global", _scope_engine_ops)
def _r_mutable_module_global(tree, relpath):
    out = []
    for node in tree.body:
        if isinstance(node, ast.Assign):
            value, line = node.value, node.lineno
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            value, line = node.value, node.lineno
        else:
            continue
        if _is_mutable_ctor(value):
            out.append((line, (
                "module-global mutable container; per-stream state must "
                "live on Session/Executor instances (the TRACE_NODES "
                "cross-stream corruption class)"
            )))
    for node in ast.walk(tree):
        if isinstance(node, ast.Global):
            out.append((node.lineno, (
                f"function rebinds module global(s) "
                f"{', '.join(node.names)}; shared mutable module state is "
                f"unsafe across concurrent streams"
            )))
    return out


def _is_mutable_ctor(value):
    if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                          ast.ListComp, ast.SetComp)):
        return True
    if isinstance(value, ast.Call) and isinstance(value.func, ast.Name):
        return value.func.id in _MUTABLE_CTORS
    return False


@_rule("perf-counter", _scope_all)
def _r_perf_counter(tree, relpath):
    # names `time` resolves to in this file (import time / from time import
    # time as x)
    bare_time_names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name == "time":
                    bare_time_names.add(a.asname or "time")

    def is_epoch_call(n):
        if not isinstance(n, ast.Call):
            return False
        f = n.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr == "time"
            and isinstance(f.value, ast.Name)
            and f.value.id == "time"
        ):
            return True
        return isinstance(f, ast.Name) and f.id in bare_time_names

    tainted = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
            is_epoch_call(x) for x in ast.walk(node.value)
        ):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    tainted.add(t.id)
    out = []
    seen_lines = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
            for side in (node.left, node.right):
                hit = is_epoch_call(side) or (
                    isinstance(side, ast.Name) and side.id in tainted
                )
                if hit and node.lineno not in seen_lines:
                    seen_lines.add(node.lineno)
                    out.append((node.lineno, (
                        "duration computed from time.time(); wall-clock "
                        "steps (NTP) corrupt elapsed figures — use "
                        "time.perf_counter() for durations (epoch stamps "
                        "themselves are fine)"
                    )))
    return out


@_rule("atomic-write", _scope_harness)
def _r_atomic_write(tree, relpath):
    out = []
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "open"
        ):
            continue
        mode = None
        if len(node.args) >= 2:
            mode = node.args[1]
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
        if (
            isinstance(mode, ast.Constant)
            and isinstance(mode.value, str)
            and "w" in mode.value
        ):
            out.append((node.lineno, (
                "bare open(..., 'w') on a harness artifact; a crash "
                "mid-write leaves a torn file — use io.fs.fs_open_atomic "
                "(tmp + rename) for report/state/summary paths"
            )))
    return out


@_rule("host-sync-in-fuse", _scope_fuse)
def _r_host_sync_in_fuse(tree, relpath):
    out = []
    seen = set()  # a _TRACED_FNS name nested in another would double-walk
    for fn in ast.walk(tree):
        if not (
            isinstance(fn, ast.FunctionDef) and fn.name in _TRACED_FNS
        ):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            seen.add(id(node))
            f = node.func
            msg = None
            if isinstance(f, ast.Attribute):
                if f.attr in ("item", "tolist", "cpu"):
                    msg = f".{f.attr}() forces a host sync"
                elif (
                    f.attr in ("asarray", "array")
                    and isinstance(f.value, ast.Name)
                    and f.value.id in ("np", "numpy")
                ):
                    msg = f"np.{f.attr}() pulls a device value to host"
                elif (
                    f.attr == "synchronize"
                    and isinstance(f.value, ast.Attribute)
                    and f.value.attr == "cuda"
                ):
                    msg = "torch.cuda.synchronize() waits for the card"
            elif isinstance(f, ast.Name) and f.id in ("int", "float", "bool"):
                # int() on a .shape element is static metadata, not a sync
                shapes_only = all(
                    any(
                        isinstance(x, ast.Attribute) and x.attr == "shape"
                        for x in ast.walk(a)
                    )
                    for a in node.args
                )
                if not shapes_only:
                    msg = (
                        f"{f.id}() on a tensor forces a host sync"
                    )
            if msg is not None:
                out.append((node.lineno, (
                    f"{msg} inside a fused call's replay ({fn.name}); "
                    f"host work belongs in the build (recorded on the "
                    f"tape) or after the call"
                )))
    return out


@_rule("local-import", _scope_hot)
def _r_local_import(tree, relpath):
    # dedupe by node id: ast.walk yields nested functions from the outer
    # function's walk too, which would double-report their imports
    out = []
    seen = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                if id(node) in seen:
                    continue
                seen.add(id(node))
                out.append((node.lineno, (
                    "function-local import in a hot-path module pays a "
                    "sys.modules lookup per call; import at module level "
                    "(pragma genuinely-cold lazy imports with a reason)"
                )))
    return out


@_rule("trace-event-schema", _scope_all)
def _r_trace_event_schema(tree, relpath):
    from ..obs.trace import CONTEXT_FIELDS, EVENT_SCHEMA

    out = []
    for kind, kwargs, has_star, line in iter_emit_calls(tree):
        if kind not in EVENT_SCHEMA:
            out.append((line, (
                f"trace event kind {kind!r} is not in "
                f"obs/trace.py:EVENT_SCHEMA; register it (with its "
                f"required fields) before emitting"
            )))
            continue
        # `query` is auto-bound from faults.scope by Tracer.emit
        missing = set(EVENT_SCHEMA[kind]) - set(kwargs) - {"query"}
        if missing and not has_star:
            out.append((line, (
                f"trace event {kind!r} missing required field(s) "
                f"{sorted(missing)} (EVENT_SCHEMA contract)"
            )))
        # trace-context discipline: trace_id (and friends) are stamped
        # centrally by Tracer.emit from the tracer's TraceContext; an
        # emission site passing one ad hoc either aliases another run's
        # trace or silently shadows the stamp — a kind that legitimately
        # needs an explicit value must DECLARE the field in EVENT_SCHEMA
        for ctx_field in CONTEXT_FIELDS:
            if ctx_field in kwargs and ctx_field not in EVENT_SCHEMA[kind]:
                out.append((line, (
                    f"trace event {kind!r} passes {ctx_field!r} "
                    f"explicitly but does not declare it in EVENT_SCHEMA; "
                    f"context fields are stamped centrally by Tracer.emit "
                    f"— declare the field or drop the kwarg"
                )))
    if relpath == "obs/metrics.py":
        out.extend(_metric_name_findings(tree, EVENT_SCHEMA))
    return out


#: modules allowed to construct an HTTP listener / own /debug routes: the
#: ONE process-wide endpoint (no second listener)
_LISTENER_MODULE = "obs/httpserv.py"

_HTTP_SERVER_CTORS = ("HTTPServer", "ThreadingHTTPServer", "TCPServer")


@_rule("debug-route-seam", _scope_all)
def _r_debug_route_seam(tree, relpath):
    """The single-listener invariant, mechanized: /debug routes
    register on the shared listener (obs/httpserv.py) — or dispatch
    through its `attach_app` seam — and nothing outside it may construct
    its own HTTP server. A second listener forks the diagnosis surface
    (two ports, one of them unmonitored) and breaks the serve-mode
    contract that ONE port carries the whole surface."""
    # the listener itself, and this rule's own definition (its prefix
    # literal + finding text), are the two legitimate homes of the string
    if relpath in (_LISTENER_MODULE, "analysis/lint.py"):
        return []
    out = []
    # collect docstring constants (module/class/function first-statement
    # strings): route tables documented in prose must not trip the rule
    doc_ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = getattr(node, "body", [])
            if body and isinstance(body[0], ast.Expr) and isinstance(
                body[0].value, ast.Constant
            ) and isinstance(body[0].value.value, str):
                doc_ids.add(id(body[0].value))
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and node.value.startswith("/debug")
            and id(node) not in doc_ids
        ):
            out.append((node.lineno, (
                f"/debug route {node.value!r} referenced outside "
                f"{_LISTENER_MODULE}; debug routes register on the one "
                f"process-wide listener (or dispatch via attach_app) — "
                f"no second listener"
            )))
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, (ast.Name, ast.Attribute))
            and (
                node.func.id if isinstance(node.func, ast.Name)
                else node.func.attr
            ) in _HTTP_SERVER_CTORS
        ):
            out.append((node.lineno, (
                f"HTTP server constructed outside {_LISTENER_MODULE}; "
                f"the process has ONE listener (obs/httpserv.py) — "
                f"attach new surfaces through attach_app"
            )))
    return out


#: the only modules allowed to publish lakehouse manifests / touch the
#: commit log: the table committer and the fleet catalog it routes through
_COMMITTER_MODULES = ("lakehouse/table.py", "lakehouse/catalog.py")


def _collect_docstring_ids(tree):
    """ids of module/class/function docstring Constant nodes (shared by
    the seam rules: prose route tables / path examples must not trip)."""
    doc_ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = getattr(node, "body", [])
            if body and isinstance(body[0], ast.Expr) and isinstance(
                body[0].value, ast.Constant
            ) and isinstance(body[0].value.value, str):
                doc_ids.add(id(body[0].value))
    return doc_ids


@_rule("manifest-write-seam", _scope_all)
def _r_manifest_write_seam(tree, relpath):
    """The single-committer invariant, mechanized: every manifest publish
    routes through `LakehouseTable._commit` (which itself routes through
    lakehouse/catalog.py when a fleet catalog is configured). A
    `put_if_absent` call or a `_manifests` path literal anywhere else is
    a second committer — it would bypass OCC arbitration, the epoch
    fence, and the coordinator's WAL, exactly the storage-corruption
    class the catalog service exists to close."""
    if relpath in _COMMITTER_MODULES or relpath == "analysis/lint.py":
        return []
    out = []
    doc_ids = _collect_docstring_ids(tree)
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and "_manifests" in node.value
            and id(node) not in doc_ids
        ):
            out.append((node.lineno, (
                f"manifest path {node.value!r} built outside the committer "
                f"modules ({', '.join(_COMMITTER_MODULES)}); manifest/"
                f"commit-log writes go through LakehouseTable._commit and "
                f"the catalog API — no second committer"
            )))
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, (ast.Name, ast.Attribute))
            and (
                node.func.id if isinstance(node.func, ast.Name)
                else node.func.attr
            ) == "put_if_absent"
        ):
            out.append((node.lineno, (
                f"put_if_absent() called outside the committer modules "
                f"({', '.join(_COMMITTER_MODULES)}); the create-exclusive "
                f"publish primitive belongs to the commit seam — route "
                f"writes through LakehouseTable._commit / the catalog"
            )))
    return out


#: MetricsRegistry mutators whose first argument is a metric family name
_METRIC_MUTATORS = ("inc", "set_gauge", "max_gauge", "observe")


def metric_kinds_literal(tree) -> dict:
    """{family name: (source kind, lineno)} from the METRIC_KINDS dict
    literal in obs/metrics.py's AST (empty when absent). Shared with the
    golden-sync test that keeps the live-metric taxonomy anchored to
    EVENT_SCHEMA."""
    families = {}
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "METRIC_KINDS"
                for t in node.targets
            )
            and isinstance(node.value, ast.Dict)
        ):
            continue
        for k, v in zip(node.value.keys, node.value.values):
            if (
                isinstance(k, ast.Constant) and isinstance(k.value, str)
                and isinstance(v, ast.Constant) and isinstance(v.value, str)
            ):
                families[k.value] = (v.value, k.lineno)
    return families


def _metric_name_findings(tree, event_schema):
    """obs/metrics.py half of the trace-event-schema rule: the live-metric
    taxonomy must DERIVE from the event taxonomy. Every METRIC_KINDS entry
    maps a family to a real EVENT_SCHEMA kind and embeds that kind in the
    family name; every literal family name a registry mutator is called
    with must be registered — a free-floating metric name cannot appear
    on /metrics without first anchoring to an event kind."""
    out = []
    families = metric_kinds_literal(tree)
    for name, (kind, line) in families.items():
        if kind not in event_schema:
            out.append((line, (
                f"metric family {name!r} derives from {kind!r}, which is "
                f"not an obs/trace.py:EVENT_SCHEMA kind — live metrics "
                f"must anchor to the event taxonomy"
            )))
        elif kind not in name:
            out.append((line, (
                f"metric family {name!r} does not embed its source event "
                f"kind {kind!r} in its name — free-floating metric names "
                f"drift from the event taxonomy"
            )))
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _METRIC_MUTATORS
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            continue
        name = node.args[0].value
        if name not in families:
            out.append((node.lineno, (
                f"metric name {name!r} is used in a registry mutator but "
                f"not registered in METRIC_KINDS (family -> event kind); "
                f"register it before exposing it"
            )))
    return out


_CONF_DOC_CACHE = None


def documented_conf_keys(repo: str | None = None):
    """`engine.*` keys named in the repo's README (knob tables, prose) or
    any properties/ template — the set the code's reads must stay inside.
    None when the repo docs aren't present (installed package): the rule
    then skips rather than flagging everything. The default (installed)
    repo's key set is cached; an explicit `repo` re-reads (tests)."""
    global _CONF_DOC_CACHE
    if repo is not None:
        return _read_conf_doc_keys(repo)
    if _CONF_DOC_CACHE is None:
        _CONF_DOC_CACHE = (
            _read_conf_doc_keys(os.path.dirname(package_root())),
        )
    return _CONF_DOC_CACHE[0]


def _read_conf_doc_keys(repo: str):
    readme = os.path.join(repo, "README.md")
    if not os.path.isfile(readme):
        return None
    keys = set()
    with open(readme, encoding="utf-8") as f:
        keys.update(re.findall(r"engine\.[a-z0-9_]+", f.read()))
    propdir = os.path.join(repo, "properties")
    if os.path.isdir(propdir):
        for name in os.listdir(propdir):
            if not name.endswith(".properties"):
                continue
            with open(os.path.join(propdir, name), encoding="utf-8") as f:
                keys.update(re.findall(r"engine\.[a-z0-9_]+", f.read()))
    return keys


def iter_conf_keys(tree):
    """Yield (key, lineno) for every `engine.*` conf-key literal read or
    written in the AST: `<obj>.get("engine.x"[, default])`,
    `<obj>.setdefault("engine.x", ...)`, and `<obj>["engine.x"]`."""
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("get", "setdefault")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and node.args[0].value.startswith("engine.")
        ):
            yield node.args[0].value, node.lineno
        elif (
            isinstance(node, ast.Subscript)
            and isinstance(node.slice, ast.Constant)
            and isinstance(node.slice.value, str)
            and node.slice.value.startswith("engine.")
        ):
            yield node.slice.value, node.lineno


@_rule("undocumented-conf-knob", _scope_all)
def _r_undocumented_conf_knob(tree, relpath):
    documented = documented_conf_keys()
    if documented is None:
        return []
    out = []
    for key, line in iter_conf_keys(tree):
        if key not in documented:
            out.append((line, (
                f"conf knob {key!r} is read by code but absent from the "
                f"README knob tables / properties templates — document it "
                f"(with its default) or drop the dead knob"
            )))
    return out


#: directory-listing calls the scan path must not make: file discovery
#: goes through the pinned manifest (TableSnapshot.files()/dataset()),
#: never the filesystem — a raw listing sees uncommitted staged files,
#: vacuum-doomed debris, and files from OTHER snapshot versions
_LISTING_ATTRS = ("glob", "iglob", "listdir", "scandir", "walk")


@_rule("scan-path-listing", lambda rp: rp in ("engine/session.py",
                                              "engine/exec.py"))
def _r_scan_path_listing(tree, relpath):
    out = []
    from_imports = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module in ("glob", "os"):
            for a in node.names:
                if a.name in _LISTING_ATTRS:
                    from_imports.add(a.asname or a.name)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        hit = (
            isinstance(f, ast.Attribute) and f.attr in _LISTING_ATTRS
            and isinstance(f.value, ast.Name) and f.value.id in ("glob", "os")
        ) or (isinstance(f, ast.Name) and f.id in from_imports)
        if hit:
            out.append((node.lineno, (
                "filesystem listing on the scan path; table-file discovery "
                "must go through the pinned manifest / zone-map API "
                "(TableSnapshot.files()/file_stats()) — a raw glob/listdir "
                "sees uncommitted staged files, vacuum debris, and other "
                "snapshot versions' files"
            )))
    return out


def run_unread_knob_lint(root: str | None = None,
                         mentioned: set | None = None) -> list[Finding]:
    """Inverse of `undocumented-conf-knob` (tree-wide, so not a per-file
    rule): every `engine.*` key named in the README knob tables or a
    properties/ template must be MENTIONED somewhere in the code (read,
    written, or emitted) — dead knobs in the docs otherwise accumulate and
    mis-teach operators. Findings point at README.md / the template.
    `mentioned`: pre-collected engine.* mention set (run_lint passes the
    one it gathered while reading the tree for the AST rules); None =
    standalone invocation, read the tree here."""
    root = _rebase(root or package_root())
    documented = documented_conf_keys(os.path.dirname(os.path.abspath(root)))
    if documented is None:
        return []
    if mentioned is None:
        mentioned = set()
        for path in iter_py_files(root):
            with open(path, encoding="utf-8") as f:
                mentioned.update(
                    re.findall(r"engine\.[a-z0-9_]+", f.read())
                )
    dead = sorted(documented - mentioned)
    if not dead:
        return []
    repo = os.path.dirname(root)
    findings = []
    sources = [("README.md", os.path.join(repo, "README.md"))]
    propdir = os.path.join(repo, "properties")
    if os.path.isdir(propdir):
        sources += [
            (f"properties/{n}", os.path.join(propdir, n))
            for n in sorted(os.listdir(propdir))
            if n.endswith(".properties")
        ]
    for key in dead:
        for rel, path in sources:
            try:
                with open(path, encoding="utf-8") as f:
                    lines = f.read().splitlines()
            except OSError:
                continue
            for i, line in enumerate(lines, start=1):
                if key in line:
                    findings.append(Finding(rel, i, "unread-conf-knob", (
                        f"conf knob {key!r} is documented here but no code "
                        f"reads it — drop the dead knob row or wire the "
                        f"knob back up"
                    )))
                    break
            else:
                continue
            break
    return findings


def iter_emit_calls(tree):
    """Yield (kind, kwarg names, has_star_kwargs, lineno) for every
    `<obj>.emit("<literal>", ...)` call in the AST. Shared with the
    golden-sync test that keeps emitted kinds and EVENT_SCHEMA equal."""
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "emit"
        ):
            continue
        if not (
            node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            continue
        kwargs = [kw.arg for kw in node.keywords if kw.arg is not None]
        has_star = any(kw.arg is None for kw in node.keywords)
        yield node.args[0].value, kwargs, has_star, node.lineno


# ---------------------------------------------------------------------------
# running the rules over a file and a tree
# ---------------------------------------------------------------------------


def _pragmas(src: str) -> dict:
    """line number -> set of disabled rule names (or {'all'})."""
    out = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = _PRAGMA_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def lint_source(src: str, relpath: str) -> list[Finding]:
    """Lint one file's source under its package-relative path (the path
    selects which rules apply)."""
    tree = ast.parse(src)
    # comment-level annotations (`# nds-guarded-by:`) are invisible to the
    # AST; rules that need them read the source off the tree
    tree._nds_lint_source = src
    pragmas = _pragmas(src)
    findings = []
    for name, (scope, check) in RULES.items():
        if not scope(relpath):
            continue
        for line, message in check(tree, relpath):
            disabled = pragmas.get(line, set()) | pragmas.get(line - 1, set())
            disabled |= {RULE_ALIASES.get(r, r) for r in disabled}
            if name in disabled or "all" in disabled:
                continue
            findings.append(Finding(relpath, line, name, message))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def package_root() -> str:
    """The nds_tpu_torch package directory this lint module ships inside."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rebase(root: str) -> str:
    """Path-scoped rules key off package-relative paths ("engine/exec.py"):
    linting from the REPO root would silently skip every scoped rule and
    mis-scope the harness rule onto repo-level scripts — rebase onto the
    contained nds_tpu_torch package when the caller passed its parent."""
    nested = os.path.join(root, "nds_tpu_torch")
    if (os.path.basename(os.path.abspath(root)) != "nds_tpu_torch"
            and os.path.isdir(nested)):
        return nested
    return root


def iter_py_files(root: str):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [
            d for d in dirnames if d not in ("__pycache__", "native")
        ]
        for f in sorted(filenames):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def run_lint(root: str | None = None) -> list[Finding]:
    root = _rebase(root or package_root())
    findings = []
    mentioned = set()
    for path in iter_py_files(root):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            src = f.read()
        mentioned.update(re.findall(r"engine\.[a-z0-9_]+", src))
        findings.extend(lint_source(src, rel))
    # tree-wide inverse knob pass (documented-but-unread keys): per-file
    # rules cannot see the whole read set, so it runs once here, reusing
    # the mention set gathered above instead of re-reading the tree
    findings.extend(run_unread_knob_lint(root, mentioned=mentioned))
    # tree-wide lock-order pass (cycles + golden sync): the acquisition
    # graph spans call edges between files, so it cannot be a per-file rule
    from . import concurrency

    findings.extend(concurrency.run_lock_order_lint(root))
    return findings


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="nds_tpu_torch engine lint (AST rules over "
                    "nds_tpu_torch/)"
    )
    ap.add_argument(
        "root", nargs="?", default=None,
        help="package root to lint (default: the installed nds_tpu_torch "
             "dir)",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule table"
    )
    ap.add_argument(
        "--write-lock-order", action="store_true",
        help="regenerate anchors/lock_order_torch.golden from the tree "
             "(review the diff: every new edge is a new nested acquisition)",
    )
    args = ap.parse_args(argv)
    if args.list_rules:
        for name in sorted(RULES):
            print(name)
        return 0
    if args.write_lock_order:
        from . import concurrency

        print(f"lint: wrote {concurrency.write_golden(args.root)}")
        return 0
    findings = run_lint(args.root)
    for f in findings:
        print(f)
    n = len(findings)
    print(f"lint: {n} finding(s)" if n else "lint: clean")
    return 1 if findings else 0


# registers the concurrency rules (guarded-by / blocking-under-lock /
# thread-leak) into RULES and the cache-lock-discipline alias — imported
# last so the substrate above is fully defined either import order
from . import concurrency as _concurrency  # noqa: E402,F401

if __name__ == "__main__":
    sys.exit(main())
