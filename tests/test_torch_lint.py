"""The port's engine lint (nds_tpu_torch/analysis/lint.py, cli/lint.py)
against the JAX package's (nds_tpu/analysis/lint.py).

The lint cases of the JAX package's tests/test_analysis.py (with its
unread-knob, cache-lock, manifest-seam and scan-path cases from
tests/test_budget.py, tests/test_catalog.py and tests/test_layout.py) run
the same fixture sources through both packages' rules (`pkg`) and must
give the same findings. `host-sync-in-fuse` guards different bodies in
the two packages (the reference's jitted FusedPipeline methods, the port's
replayed ones), so each package gets its own fixture of the same shape.
Then the port's own tree: lint-clean (one whole-tree run per process,
from the repository root, which also proves the rebase), every emitted
event kind in its EVENT_SCHEMA, its METRIC_KINDS anchored to it, and the
launcher's `lint` verb.

Tolerance: exact (rule names, lines and the message fragments asserted).
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from nds_tpu.analysis import lint as JL
from nds_tpu_torch.analysis import lint as TL

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401
from torch_lint_cases import port_tree_findings  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINTS = {"jax": JL, "torch": TL}
PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


def _rules(pkg, src, relpath):
    return [f.rule for f in LINTS[pkg].lint_source(src, relpath)]


# ---------------------------------------------------------------------------
# seeded violations + the pragma, through both packages' rules
# ---------------------------------------------------------------------------


@PKG
def test_lint_undocumented_conf_knob(pkg):
    L = LINTS[pkg]
    bad = 'x = conf.get("engine.definitely_not_a_real_knob")\n'
    fs = L.lint_source(bad, "engine/session.py")
    assert [f.rule for f in fs] == ["undocumented-conf-knob"]
    good = 'x = conf.get("engine.fuse", "on")\n'
    assert L.lint_source(good, "engine/session.py") == []
    bad2 = 'conf["engine.not_documented_either"] = 1\n'
    fs = L.lint_source(bad2, "power.py")
    assert [f.rule for f in fs] == ["undocumented-conf-knob"]
    ok = ('# internal probe knob, never user-facing\n'
          '# nds-lint: disable=undocumented-conf-knob\n'
          'x = conf.get("engine.secret_internal_probe")\n')
    assert L.lint_source(ok, "engine/session.py") == []
    # the knobs this slice ported are documented for the port too
    for knob in ("engine.plan_feedback", "engine.feedback_dir",
                 "engine.feedback_bytes", "engine.lock_debug",
                 "engine.lock_contention_ms", "engine.lock_hold_budget_s"):
        assert L.lint_source(f'x = conf.get("{knob}")\n', "faults.py") == []


@PKG
def test_lint_unread_conf_knob(pkg, tmp_path):
    L = LINTS[pkg]
    name = "nds_tpu" if pkg == "jax" else "nds_tpu_torch"
    p = tmp_path / name
    p.mkdir()
    (p / "mod.py").write_text('X = conf.get("engine.real_knob", 1)\n',
                              encoding="utf-8")
    (tmp_path / "README.md").write_text(
        "| `engine.real_knob` | used |\n| `engine.ghost_knob` | dead |\n",
        encoding="utf-8",
    )
    findings = L.run_unread_knob_lint(str(tmp_path))
    assert len(findings) == 1
    f = findings[0]
    assert f.rule == "unread-conf-knob"
    assert "engine.ghost_knob" in f.message and f.path == "README.md"


@PKG
def test_lint_mutable_module_global(pkg):
    src = "CACHE = {}\n"
    assert _rules(pkg, src, "engine/foo.py") == ["mutable-module-global"]
    assert _rules(pkg, src, "io/fs.py") == []  # out of scope
    ok = "CACHE = {}  # nds-lint: disable=mutable-module-global\n"
    assert _rules(pkg, ok, "engine/foo.py") == []
    g = "def f():\n    global STATE\n    STATE = 1\n"
    assert _rules(pkg, g, "ops/k.py") == ["mutable-module-global"]


@PKG
def test_lint_perf_counter(pkg):
    L = LINTS[pkg]
    src = "import time\nt0 = time.time()\nd = time.time() - t0\n"
    fs = L.lint_source(src, "power.py")
    assert [f.rule for f in fs] == ["perf-counter"] and fs[0].line == 3
    assert L.lint_source(
        "import time\nts = int(time.time() * 1000)\n", "power.py"
    ) == []
    ok = (
        "import time\nt0 = time.time()\n"
        "# nds-lint: disable=perf-counter\nd = time.time() - t0\n"
    )
    assert L.lint_source(ok, "power.py") == []


@PKG
def test_lint_atomic_write(pkg):
    src = "f = open(p, 'w')\n"
    assert _rules(pkg, src, "report.py") == ["atomic-write"]
    assert _rules(pkg, src, "engine/exec.py") == []  # harness scope only
    assert _rules(pkg, "f = open(p)\n", "report.py") == []  # read mode


#: the same shape of fused body in each package: a static shape read
#: (fine) and a device value pulled to the host (a finding)
HOST_SYNC = {
    "jax": ("_run_full", "    def _run_full(self, *flat):\n"
            "        n = int(flat[0].shape[0])  # static shape: fine\n"
            "        return np.asarray(flat[1])\n"),
    "torch": ("call", "    def call(self, table, donate):\n"
              "        n = int(table.columns['a'].data.shape[0])  # fine\n"
              "        return np.asarray(table.columns['a'].data)\n"),
}


@PKG
def test_lint_host_sync_in_fuse(pkg):
    L = LINTS[pkg]
    fn, body = HOST_SYNC[pkg]
    src = "class FusedPipeline:\n" + body
    fs = L.lint_source(src, "engine/fuse.py")
    assert [f.rule for f in fs] == ["host-sync-in-fuse"]
    assert "np.asarray" in fs[0].message
    # the same code outside the guarded bodies is not flagged
    assert L.lint_source(src.replace(fn, "_other"), "engine/fuse.py") == []


@pytest.mark.parametrize("sync,what", [
    ("x = t.item()", ".item()"),
    ("x = t.tolist()", ".tolist()"),
    ("x = t.cpu()", ".cpu()"),
    ("x = bool(t.any())", "bool()"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
])
def test_lint_host_sync_in_fuse_torch_syncs(sync, what):
    """The syncs torch has in a replayed fused call, each in each of the
    replay's bodies (_Tape.replay, FusedPipeline / FusedAggPipeline's
    per-call methods)."""
    for fn in TL._TRACED_FNS:
        src = textwrap.dedent(f"""
            class FusedAggPipeline:
                def {fn}(self, t):
                    {sync}
                    return t
        """)
        fs = TL.lint_source(src, "engine/fuse.py")
        assert [f.rule for f in fs] == ["host-sync-in-fuse"], (fn, sync)
        assert what in fs[0].message
        # the build-time helpers are out of the rule's reach
        assert TL.lint_source(src.replace(fn, "_resolve_bounds"),
                              "engine/fuse.py") == []


@PKG
def test_lint_local_import(pkg):
    src = "def f():\n    import os\n    return os\n"
    assert _rules(pkg, src, "engine/exec.py") == ["local-import"]
    assert _rules(pkg, src, "power.py") == []  # hot modules only
    nested = "def outer():\n    def inner():\n        import os\n"
    assert len(LINTS[pkg].lint_source(nested, "engine/exec.py")) == 1


@PKG
def test_lint_trace_event_schema(pkg):
    L = LINTS[pkg]
    bad_kind = "tracer.emit('no_such_kind', a=1)\n"
    assert _rules(pkg, bad_kind, "engine/exec.py") == ["trace-event-schema"]
    missing = "tracer.emit('query_span', query=q)\n"
    fs = L.lint_source(missing, "report.py")
    assert fs and "dur_ms" in fs[0].message
    assert L.lint_source("tracer.emit('query_span', **ev)\n",
                         "report.py") == []
    good = "tracer.emit('plan_cache', node=n, hit=True)\n"
    assert L.lint_source(good, "engine/exec.py") == []
    # the feedback and sanitizer kinds this slice emits
    assert L.lint_source("tracer.emit('plan_feedback', op=o, result=r)\n",
                         "engine/exec.py") == []
    assert L.lint_source("tr.emit('lock_contention', lock=n, wait_ms=w)\n",
                         "engine/lockdebug.py") == []
    # a context field passed ad hoc
    ctx = "tracer.emit('plan_cache', node=n, hit=True, trace_id=t)\n"
    assert _rules(pkg, ctx, "engine/exec.py") == ["trace-event-schema"]


@PKG
def test_lint_metric_names_derive_from_event_kinds(pkg):
    L = LINTS[pkg]
    bad_kind = 'METRIC_KINDS = {"nds_bogus_total": "bogus"}\n'
    fs = L.lint_source(bad_kind, "obs/metrics.py")
    assert [f.rule for f in fs] == ["trace-event-schema"]
    assert "not an obs/trace.py:EVENT_SCHEMA kind" in fs[0].message
    free = 'METRIC_KINDS = {"nds_free_total": "query_span"}\n'
    fs = L.lint_source(free, "obs/metrics.py")
    assert fs and "does not embed its source event kind" in fs[0].message
    unreg = (
        'METRIC_KINDS = {"nds_query_span_total": "query_span"}\n'
        'reg.inc("nds_query_span_total", status=s)\n'
        'reg.inc("nds_rogue_total")\n'
    )
    fs = L.lint_source(unreg, "obs/metrics.py")
    assert len(fs) == 1 and "nds_rogue_total" in fs[0].message
    assert L.lint_source(bad_kind, "obs/reader.py") == []
    clean = (
        'METRIC_KINDS = {"nds_exec_cache_total": "exec_cache"}\n'
        'reg.inc("nds_exec_cache_total", result="hit")\n'
    )
    assert L.lint_source(clean, "obs/metrics.py") == []


@PKG
def test_lint_debug_route_seam(pkg):
    route = 'ROUTES = {"/debug/stacks": h}\n'
    assert _rules(pkg, route, "serve/service.py") == ["debug-route-seam"]
    assert _rules(pkg, route, "obs/httpserv.py") == []
    server = "srv = ThreadingHTTPServer(addr, H)\n"
    assert _rules(pkg, server, "serve/router.py") == ["debug-route-seam"]
    doc = '"""routes: /debug/stacks"""\nX = 1\n'
    assert _rules(pkg, doc, "serve/router.py") == []


@PKG
def test_lint_manifest_write_seam(pkg):
    bad_call = ("def f(fs, tmp, dest):\n"
                "    return put_if_absent(fs, tmp, dest)\n")
    assert "manifest-write-seam" in _rules(pkg, bad_call, "maintenance.py")
    bad_path = 'MANIFESTS = "_manifests"\n'
    assert "manifest-write-seam" in _rules(pkg, bad_path, "serve/service.py")
    for home in ("lakehouse/table.py", "lakehouse/catalog.py"):
        assert _rules(pkg, bad_call + bad_path, home) == []
    pragma = "# nds-lint: disable=manifest-write-seam\n" + bad_path
    assert _rules(pkg, pragma, "serve/service.py") == []


@PKG
def test_lint_scan_path_listing(pkg):
    src = "import os, glob\nfs = os.listdir(d)\ng = glob.glob(p)\n"
    assert _rules(pkg, src, "engine/exec.py") == ["scan-path-listing"] * 2
    assert _rules(pkg, src, "engine/spill.py") == []
    frm = "from os import scandir\nx = scandir(d)\n"
    assert _rules(pkg, frm, "engine/session.py") == ["scan-path-listing"]


@PKG
def test_lint_cache_lock_discipline(pkg):
    L = LINTS[pkg]
    bad = (
        "def f(session, fp, sig):\n"
        "    session.exec_cache.map[(fp, sig)] = None\n"
        "    session.join_order_cache.setdefault(fp, {})\n"
        "    session.plan_cache.clear()\n"
        "    session.feedback_store.flush()\n"
    )
    hits = [f for f in L.lint_source(bad, "engine/whatever.py")
            if f.rule == "guarded-by"]
    assert len(hits) == 4
    good = (
        "def f(session, fp, sig):\n"
        "    with session.cache_lock:\n"
        "        session.exec_cache.map[(fp, sig)] = None\n"
        "        session.feedback_store.record(fp, rows=1)\n"
    )
    assert [f for f in L.lint_source(good, "engine/whatever.py")
            if f.rule == "guarded-by"] == []
    alias = ("def f(self, node, out):\n"
             "    cache = self._session_cache()\n"
             "    cache.put(node, out)\n")
    assert [f.rule for f in L.lint_source(alias, "engine/whatever.py")] == [
        "guarded-by"]


def test_the_two_rule_tables_match():
    assert sorted(TL.RULES) == sorted(JL.RULES)
    assert TL.RULE_ALIASES == JL.RULE_ALIASES


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------


def test_lint_clean_over_real_tree():
    findings = port_tree_findings()
    assert findings == (), "\n".join(str(f) for f in findings)


def test_lint_rebases_repo_root_onto_package():
    # linting from the repository root must not skip the path-scoped rules
    # (the whole-tree run above starts there)
    assert TL._rebase(ROOT) == TL.package_root()
    assert os.path.basename(TL.package_root()) == "nds_tpu_torch"
    assert TL._rebase(TL.package_root()) == TL.package_root()


def test_emitted_kinds_sync_with_event_schema():
    from nds_tpu_torch.obs.trace import DEPRECATED_EVENT_KINDS, EVENT_SCHEMA

    emitted = set()
    for path in TL.iter_py_files(TL.package_root()):
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for kind, _kwargs, _star, _line in TL.iter_emit_calls(tree):
            emitted.add(kind)
    assert emitted - set(EVENT_SCHEMA) == set()
    # the mesh's kinds wait for their emitters (ROADMAP.md queue 1 item 13)
    live_required = (set(EVENT_SCHEMA) - set(DEPRECATED_EVENT_KINDS)
                     - {"exchange", "mesh_fallback"})
    assert live_required - emitted == set(), live_required - emitted


def test_metric_kinds_sync_with_event_schema():
    from nds_tpu_torch.obs.metrics import METRIC_KINDS
    from nds_tpu_torch.obs.trace import EVENT_SCHEMA

    for name, kind in METRIC_KINDS.items():
        assert kind in EVENT_SCHEMA, (name, kind)
        assert kind in name, (name, kind)
    path = os.path.join(TL.package_root(), "obs", "metrics.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    parsed = {k: v for k, (v, _line) in TL.metric_kinds_literal(tree).items()}
    assert parsed == dict(METRIC_KINDS)


def test_validate_summary_update_is_atomic(tmp_path, monkeypatch):
    from nds_tpu_torch import validate

    f = tmp_path / "pfx-query1-123.json"
    f.write_text(json.dumps({"queryStatus": ["Completed"]}))
    validate.update_summary(str(tmp_path), [], ["query1"])
    assert json.loads(f.read_text())["queryValidationStatus"] == ["Pass"]
    before = f.read_text()

    def boom(*a, **k):
        raise RuntimeError("disk full mid-write")

    monkeypatch.setattr(validate.json, "dump", boom)
    with pytest.raises(RuntimeError):
        validate.update_summary(str(tmp_path), ["query1"], ["query1"])
    monkeypatch.undo()
    assert f.read_text() == before
    assert list(tmp_path.glob("*.tmp-*")) == []


def test_hot_path_imports_hoisted():
    """The modules the lint holds to module-level imports resolved them at
    import time; pyarrow stays unimported until an Arrow path reads
    engine/arrowlib.py (the card's path needs no pyarrow)."""
    import nds_tpu_torch.engine.exec as xc
    import nds_tpu_torch.engine.expr as xp
    import nds_tpu_torch.ops.kernels as K

    assert hasattr(xc, "fuse") and hasattr(xc, "faults")
    assert hasattr(xc, "arrowlib") and hasattr(xc, "np")
    assert hasattr(xp, "arrowlib") and hasattr(xp, "unify_dictionaries")
    assert hasattr(K, "bucket_cap") and hasattr(K, "_HOST")
    code = ("import sys\nsys.modules['pyarrow'] = None\n"
            "import nds_tpu_torch.engine.exec, nds_tpu_torch.engine.expr\n"
            "from nds_tpu_torch.engine import arrowlib\n"
            "try:\n    arrowlib.pa\nexcept ImportError:\n    print('LAZY')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.stdout.strip() == "LAZY", p.stderr[-2000:]


def test_cli_lists_rules_and_launcher_runs_lint():
    r = subprocess.run(["bash", os.path.join(ROOT, "nds-tpu-torch-submit"),
                        "lint", "--list-rules"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == sorted(TL.RULES)
