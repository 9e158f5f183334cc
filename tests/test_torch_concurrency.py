"""The port's concurrency analyzer (nds_tpu_torch/analysis/concurrency.py)
and runtime lock sanitizer (nds_tpu_torch/engine/lockdebug.py) against the
JAX package's.

The cases of the JAX package's tests/test_concurrency_analysis.py run
through both packages (`pkg`): one seeded violation per static rule
(unguarded mutation of declared state, undeclared shared attr, blocking
call under a lock, lock-order cycle, thread leak), the retired rule's
alias, each package's golden file in sync with its own tree, the
sanitizer's order assertion, contention event and deadlock dump, the knob
resolvers, and the regressions the analyzer surfaced in the serve,
router, promotion-store, coordinator and session code. Then the port's
own: its tree lint-clean, every lock name the two golden files share in
the same relative order but for the differences listed below with their
reasons, every reference edge present, and a session and a query service
that run clean under `engine.lock_debug`.

Tolerance: exact.
"""

import ast
import json
import os
import sys
import textwrap
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from nds_tpu.analysis import concurrency as JC
from nds_tpu.analysis import lint as JL
from nds_tpu.engine import lockdebug as JLD
from nds_tpu.obs import trace as JTR
from nds_tpu_torch.analysis import concurrency as TC
from nds_tpu_torch.analysis import lint as TL
from nds_tpu_torch.engine import lockdebug as TLD
from nds_tpu_torch.obs import trace as TTR

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401
from torch_lint_cases import port_tree_findings  # noqa: E402
from torch_serve_cases import TORCH, env, mini_lake, post  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (JC, JL, JLD, JTR, "nds_tpu"),
        "torch": (TC, TL, TLD, TTR, "nds_tpu_torch")}
PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


def _rules(pkg, src, relpath):
    L = PKGS[pkg][1]
    return [f.rule for f in L.lint_source(textwrap.dedent(src), relpath)]


# ---------------------------------------------------------------------------
# guarded-by: declarations + span discipline
# ---------------------------------------------------------------------------


@PKG
def test_unguarded_mutation_of_declared_state_fires(pkg):
    src = """
    import threading

    class QueryRouter:
        def __init__(self):
            self._lock = threading.Lock()
            self.draining = False  # nds-guarded-by: _lock

        def close(self):
            self.draining = True
    """
    assert _rules(pkg, src, "serve/router.py") == ["guarded-by"]


@PKG
def test_undeclared_shared_attr_fires(pkg):
    src = """
    import threading

    class QueryRouter:
        def __init__(self):
            self._lock = threading.Lock()
            self._rr = 0

        def bump(self):
            with self._lock:
                self._rr += 1
    """
    assert _rules(pkg, src, "serve/router.py") == ["guarded-by"]


@PKG
def test_declared_and_spanned_is_clean(pkg):
    src = """
    import threading

    class QueryRouter:
        def __init__(self):
            self._lock = threading.Lock()
            self.draining = False  # nds-guarded-by: _lock

        def close(self):
            with self._lock:
                self.draining = True
    """
    assert _rules(pkg, src, "serve/router.py") == []


@PKG
def test_guarded_by_none_and_locked_suffix_pass(pkg):
    src = """
    import threading

    class QueryRouter:
        def __init__(self):
            self._lock = threading.Lock()
            # single atomic store, readers tolerate staleness
            self.beat = None  # nds-guarded-by: none
            self.n = 0  # nds-guarded-by: _lock

        def stamp(self):
            self.beat = 1.0

        def _bump_locked(self):
            self.n += 1
    """
    assert _rules(pkg, src, "serve/router.py") == []


@PKG
def test_non_multithread_class_is_exempt(pkg):
    src = """
    class Helper:
        def poke(self):
            self.x = 1
    """
    assert _rules(pkg, src, "serve/router.py") == []


_CACHE_SRC = """
class Runner:
    def go(self, session):
        session.plan_cache.clear()
"""


@PKG
def test_session_cache_rule_lives_on_in_guarded_by(pkg):
    fs = PKGS[pkg][1].lint_source(_CACHE_SRC, "power.py")
    assert [f.rule for f in fs] == ["guarded-by"]
    assert "cache_lock" in fs[0].message


@PKG
def test_cache_lock_discipline_alias_pragma_still_silences(pkg):
    C, L = PKGS[pkg][:2]
    src = _CACHE_SRC.replace(
        "session.plan_cache.clear()",
        "session.plan_cache.clear()  # nds-lint: disable=cache-lock-discipline",
    )
    assert L.lint_source(src, "power.py") == []
    assert C.RULE_ALIASES["cache-lock-discipline"] == "guarded-by"


# ---------------------------------------------------------------------------
# blocking-under-lock
# ---------------------------------------------------------------------------


@PKG
def test_blocking_call_under_lock_fires(pkg):
    src = """
    import json, os, threading

    class PromotionStore:
        def __init__(self):
            self._lock = threading.Lock()
            self._cache = None  # nds-guarded-by: _lock

        def record(self, rec):
            with self._lock:
                self._cache = rec
                with open("/tmp/x", "w") as f:
                    json.dump(rec, f)
    """
    assert "blocking-under-lock" in _rules(pkg, src, "engine/aotcache.py")


@PKG
def test_blocking_call_outside_lock_is_clean(pkg):
    src = """
    import json, threading

    class PromotionStore:
        def __init__(self):
            self._lock = threading.Lock()
            self._cache = None  # nds-guarded-by: _lock

        def record(self, rec):
            with self._lock:
                self._cache = rec
            with open("/tmp/x", "w") as f:
                json.dump(rec, f)
    """
    assert _rules(pkg, src, "engine/aotcache.py") == []


def test_port_blocking_calls_are_torch_s():
    """The port flags torch's blocking calls under a lock (a compile, a
    checkpoint read or write, a wait for the card) where the reference
    flags jax's."""
    for call in ("torch.compile(f)", "torch.save(x, p)", "torch.load(p)",
                 "torch.cuda.synchronize()"):
        src = f"""
        def f(self):
            with self._lock:
                {call}
        """
        assert _rules("torch", src, "engine/exec.py") == [
            "blocking-under-lock"], call


# ---------------------------------------------------------------------------
# thread-leak
# ---------------------------------------------------------------------------


@PKG
def test_thread_leak_fires(pkg):
    src = """
    import threading

    def go():
        threading.Thread(target=print).start()
    """
    assert _rules(pkg, src, "power.py") == ["thread-leak"]


@PKG
def test_thread_leak_daemon_and_join_pass(pkg):
    src = """
    import threading

    def go():
        t = threading.Thread(target=print)
        t.start()
        t.join()
        threading.Thread(target=print, daemon=True).start()
    """
    assert _rules(pkg, src, "power.py") == []


@PKG
def test_thread_leak_joined_via_list_iteration_passes(pkg):
    src = """
    import threading

    def go(items):
        threads = [threading.Thread(target=print, args=(i,)) for i in items]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    """
    assert _rules(pkg, src, "power.py") == []


# ---------------------------------------------------------------------------
# lock-order: cycles + golden sync
# ---------------------------------------------------------------------------


def _write_tree(tmp_path, files):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(tmp_path)


@PKG
def test_lock_order_cycle_detected(pkg, tmp_path):
    C = PKGS[pkg][0]
    root = _write_tree(tmp_path, {
        "mod.py": """
        import threading

        _A_LOCK = threading.Lock()
        _B_LOCK = threading.Lock()

        def forward():
            with _A_LOCK:
                with _B_LOCK:
                    pass

        def backward():
            with _B_LOCK:
                with _A_LOCK:
                    pass
        """,
    })
    model = C.build_lock_model(root)
    assert model.cycles
    fs = C.run_lock_order_lint(root)
    assert any(f.rule == "lock-order" and "cycle" in f.message for f in fs)


@PKG
def test_lock_order_nested_in_branches_and_call_edges(pkg, tmp_path):
    C = PKGS[pkg][0]
    root = _write_tree(tmp_path, {
        "mod.py": """
        import threading

        _A_LOCK = threading.Lock()
        _B_LOCK = threading.Lock()

        def inner():
            with _B_LOCK:
                pass

        def outer(flag):
            if flag:
                with _A_LOCK:
                    inner()
        """,
    })
    model = C.build_lock_model(root)
    assert ("mod.py:_A_LOCK", "mod.py:_B_LOCK") in model.edges
    assert not model.cycles


@pytest.fixture(scope="module")
def models():
    return {"jax": JC.build_lock_model(), "torch": TC.build_lock_model()}


@PKG
def test_golden_file_in_sync_with_tree(pkg, models):
    C = PKGS[pkg][0]
    model = models[pkg]
    assert not model.cycles
    with open(C.golden_path(), encoding="utf-8") as f:
        assert f.read() == C.format_golden(model)


@PKG
def test_golden_roundtrip_and_pinned_order(pkg, models):
    C = PKGS[pkg][0]
    order, edges = C.load_golden(C.golden_path())
    model = models[pkg]
    assert order == model.order
    assert edges == set(model.edges)
    ranks = C.load_pinned_order()
    assert ranks["Session.cache_lock"] < ranks["FeedbackStore._lock"]
    assert set(ranks) == set(order)


def test_port_golden_is_its_own_file():
    assert TC.golden_path() == os.path.join(ROOT, "anchors",
                                            "lock_order_torch.golden")
    assert JC.golden_path() == os.path.join(ROOT, "anchors",
                                            "lock_order.golden")


def test_lint_clean_over_real_tree():
    findings = port_tree_findings()
    assert findings == (), "\n".join(str(f) for f in findings)


#: the locks the port ranks after Session.cache_lock (or the writer lock)
#: where the reference ranks them before it, because the port's model
#: holds a real nesting the reference's model does not see (the
#: KNOWN_EDGES of the port's analysis/concurrency.py); each a reason
MOVED = {
    "AotCache._lock": "the port's exec cache loads and stores a fused "
                      "entry in the persistent cache under the session "
                      "lock",
    "FaultRegistry._lock": "planning under the session lock and the "
                           "writer's DML reach fault-injection sites",
    "MetricsRegistry._lock": "planning under the session lock and the "
                             "writer's DML emit events the sink counts",
    "MetricsSink._slock": "planning under the session lock emits "
                          "scan_prune, whose handler updates the sink",
    "PromotionStore._lock": "a measured verdict is persisted under the "
                            "session lock",
    "ReaderLeases._lock": "pinning a lakehouse scan under the session "
                          "lock registers its reader lease",
}


def test_shared_lock_names_keep_their_relative_order(models):
    jorder, torder = models["jax"].order, models["torch"].order
    shared = [n for n in jorder if n in set(torder)]
    # the port names every lock the reference does, its own build and
    # launch-count locks besides (their modules have no reference
    # counterpart)
    assert set(jorder) <= set(torder)
    assert set(torder) - set(jorder) == {"ops/_build.py:_lock",
                                         "ops/gpu_kernels.py:_LAUNCHES_LOCK"}
    jr = {n: i for i, n in enumerate(jorder)}
    tr = {n: i for i, n in enumerate(torder)}
    inverted = {
        (a, b) for a in shared for b in shared
        if jr[a] < jr[b] and tr[a] > tr[b]
    }
    for a, b in inverted:
        assert a in MOVED or b in MOVED, (a, b)
    # with the moved locks set aside, the two orders agree exactly
    keep = [n for n in shared if n not in MOVED]
    assert sorted(keep, key=tr.get) == sorted(keep, key=jr.get)
    # and each move is a known edge the port's model adds
    known = {inner for (_outer, inner) in TC.KNOWN_EDGES}
    assert set(MOVED) <= known
    for n in MOVED:
        assert tr[n] > tr["Session.cache_lock"], n
    # every reference edge is in the port's model too
    assert set(models["jax"].edges) <= set(models["torch"].edges)


@PKG
def test_shared_state_report_smoke(pkg, capsys):
    C = PKGS[pkg][0]
    assert C.main(["--report"]) == 0
    out = capsys.readouterr().out
    assert "QueryRouter" in out and "FeedbackStore" in out


# ---------------------------------------------------------------------------
# runtime sanitizer (engine/lockdebug.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def lockdebug_on(monkeypatch):
    monkeypatch.setenv("NDS_LOCK_DEBUG", "1")
    for ld in (JLD, TLD):
        ld.reset_for_tests()
    yield
    for ld in (JLD, TLD):
        ld.reset_for_tests()


@PKG
def test_make_lock_is_plain_when_off(pkg, monkeypatch):
    ld = PKGS[pkg][2]
    monkeypatch.delenv("NDS_LOCK_DEBUG", raising=False)
    lk = ld.make_lock("Session.cache_lock")
    assert not isinstance(lk, ld.DebugLock)
    with lk:
        pass


@PKG
def test_sanitizer_catches_inverted_acquisition(pkg, lockdebug_on):
    ld = PKGS[pkg][2]
    a = ld.make_lock("Session.cache_lock", reentrant=True)
    b = ld.make_lock("FeedbackStore._lock")
    assert isinstance(a, ld.DebugLock) and isinstance(b, ld.DebugLock)
    with a:
        with b:
            pass
        with a:
            pass
    with b:
        with pytest.raises(ld.LockOrderError, match="inversion"):
            a.acquire()
    assert ld.held_locks() == []


@PKG
def test_unpinned_lock_names_skip_order_assertions(pkg, lockdebug_on):
    ld = PKGS[pkg][2]
    a = ld.make_lock("Session.cache_lock")
    x = ld.make_lock("NotInTheGolden._lock")
    with x:
        with a:
            pass


@PKG
def test_contention_event_matches_schema(pkg, lockdebug_on):
    ld, TR = PKGS[pkg][2], PKGS[pkg][3]
    lk = ld.DebugLock(
        "SpillPool._lock", threading.Lock(),
        contention_ms=5.0, hold_budget_s=0.0,
    )
    tr = TR.Tracer(collect=True)

    def holder():
        with lk:
            time.sleep(0.05)

    t = threading.Thread(target=holder)
    t.start()
    time.sleep(0.01)
    with TR.bind(tr):
        with lk:
            pass
    t.join()
    evs = [e for e in tr.events if e["kind"] == "lock_contention"]
    assert evs
    for field in TR.EVENT_SCHEMA["lock_contention"]:
        assert field in evs[0], field
    assert evs[0]["lock"] == "SpillPool._lock"
    assert evs[0]["wait_ms"] >= 5.0


@PKG
def test_deadlock_dump_lands_in_flight_bundle(pkg, lockdebug_on, monkeypatch,
                                              tmp_path):
    ld = PKGS[pkg][2]
    monkeypatch.setenv("NDS_FLIGHT_DIR", str(tmp_path))
    lk = ld.make_lock("AotCache._lock")
    lk.acquire()
    try:
        time.sleep(0.02)
        over = ld.check_holds(budget_s=0.01)
    finally:
        lk.release()
    assert over and over[0]["lock"] == "AotCache._lock"
    bundles = list(tmp_path.glob("failure-bundle-*.json"))
    assert bundles
    b = json.loads(bundles[0].read_text())
    assert b["reason"].startswith("lock hold budget exceeded")
    locks = b["threads"]["locks"]
    assert any(r["lock"] == "AotCache._lock" for r in locks)
    assert b["threads"]["stacks"]
    assert ld.check_holds(budget_s=0.01) == []


@PKG
def test_knob_resolvers(pkg):
    ld = PKGS[pkg][2]
    assert ld.resolve_lock_debug({"engine.lock_debug": "on"}) is True
    assert ld.resolve_lock_debug({}) is False
    assert ld.resolve_contention_ms({"engine.lock_contention_ms": 7}) == 7.0
    assert ld.resolve_contention_ms(
        {"engine.lock_contention_ms": "junk"}) == 50.0
    assert ld.resolve_hold_budget_s({"engine.lock_hold_budget_s": 0}) == 0.0


# ---------------------------------------------------------------------------
# regressions: the unguarded sites the analyzer surfaced
# ---------------------------------------------------------------------------


def _with_span_covering(pkg, path, cls_name, fn_name, attr, lock_attr):
    with open(os.path.join(ROOT, PKGS[pkg][4], path), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    cls = next(n for n in ast.walk(tree)
               if isinstance(n, ast.ClassDef) and n.name == cls_name)
    fn = next(n for n in ast.walk(cls)
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    spans = [
        (node.lineno, max(
            x.lineno for x in ast.walk(node) if hasattr(x, "lineno")
        ))
        for node in ast.walk(fn) if isinstance(node, ast.With)
        if any(
            isinstance(it.context_expr, ast.Attribute)
            and it.context_expr.attr == lock_attr
            for it in node.items
        )
    ]
    writes = [
        n.lineno for n in ast.walk(fn) if isinstance(n, ast.Assign)
        for t in n.targets
        if isinstance(t, ast.Attribute) and t.attr == attr
    ]
    assert writes, f"{cls_name}.{fn_name} no longer writes {attr}"
    return all(any(s <= w <= e for s, e in spans) for w in writes)


@PKG
def test_service_close_flips_draining_under_state_lock(pkg):
    assert _with_span_covering(
        pkg, "serve/service.py", "QueryService", "close", "draining",
        "_state_lock",
    )


@PKG
def test_router_drain_flips_run_under_router_lock(pkg):
    assert _with_span_covering(
        pkg, "serve/router.py", "QueryRouter", "close", "draining", "_lock"
    )
    assert _with_span_covering(
        pkg, "serve/router.py", "QueryRouter", "handle_drain", "draining",
        "_lock",
    )


@PKG
def test_promotion_store_record_does_io_outside_lock(pkg, tmp_path):
    L = PKGS[pkg][1]
    if pkg == "jax":
        from nds_tpu.engine.aotcache import PromotionStore
    else:
        from nds_tpu_torch.engine.aotcache import PromotionStore
    store = PromotionStore(str(tmp_path / "promotions"))
    store.record("k1", {"winner": "pallas", "speedup": 1.4})
    assert store.get("k1")["winner"] == "pallas"
    path = os.path.join(ROOT, PKGS[pkg][4], "engine", "aotcache.py")
    with open(path, encoding="utf-8") as f:
        fs = [x for x in L.lint_source(f.read(), "engine/aotcache.py")
              if x.rule == "blocking-under-lock"]
    assert fs == []


@PKG
def test_catalog_ref_no_duplicate_tableref_under_race(pkg):
    if pkg == "jax":
        from nds_tpu.lakehouse.catalog import CatalogCoordinator
    else:
        from nds_tpu_torch.lakehouse.catalog import CatalogCoordinator
    coord = CatalogCoordinator.__new__(CatalogCoordinator)
    coord._lock = threading.Lock()
    coord._refs = {}
    seen = []
    gate = threading.Barrier(4)

    def grab():
        gate.wait()
        for _ in range(50):
            seen.append(coord._ref("/tables/store_sales"))

    threads = [threading.Thread(target=grab) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len({id(r) for r in seen}) == 1


@PKG
def test_session_listener_registration_is_thread_safe(pkg):
    if pkg == "jax":
        from nds_tpu.engine.session import Session
        s = Session(conf={"engine.aot_cache_dir": ""})
    else:
        from nds_tpu_torch.engine.session import Session
        s = Session(conf={}, device="cpu")
    gate = threading.Barrier(4)

    def add(n):
        gate.wait()
        for i in range(50):
            s.register_listener(lambda reason, n=n, i=i: None)

    threads = [threading.Thread(target=add, args=(n,)) for n in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(s._listeners) == 200


# ---------------------------------------------------------------------------
# the port under the sanitizer
# ---------------------------------------------------------------------------


def _assert_no_inversion(ld, fn):
    """Run `fn` with every order assertion recorded instead of raised, and
    hold the record empty: a violation deep in a worker thread must not
    hide behind an HTTP 500."""
    seen = []
    orig = ld.DebugLock._assert_order

    def assert_order(self):
        try:
            orig(self)
        except ld.LockOrderError as exc:
            seen.append(str(exc))
            raise

    ld.DebugLock._assert_order = assert_order
    try:
        fn()
    finally:
        ld.DebugLock._assert_order = orig
    assert seen == [], seen


def test_session_runs_clean_under_the_sanitizer(lockdebug_on, tmp_path):
    """A CPU session with the persistent cache, consuming feedback and the
    kernel routes' measured promotion: its statements take the session,
    cache, store and promotion locks nested, in the pinned order."""
    from nds_tpu_torch.engine.session import Session

    rng = np.random.default_rng(3)
    t = pa.table({"k": rng.integers(0, 50, 5000).astype(np.int64),
                  "w": rng.integers(0, 9, 5000).astype(np.int32),
                  "v": rng.random(5000)})

    def run():
        for mode in ("record", "on"):
            s = Session(conf={
                "engine.aot_cache_dir": str(tmp_path / "aot"),
                "engine.plan_feedback": mode,
                "engine.pallas_agg": "auto", "engine.pallas_sort": "auto",
            }, device="cpu")
            assert isinstance(s.cache_lock, TLD.DebugLock)
            s.register_arrow("t", t)
            for q in ("select k, sum(v) s from t where w < 5 group by k "
                      "order by k",
                      "select w, count(*) c from t where v > 0.5 group by w "
                      "order by w",
                      "select a.k, count(*) c from t a join t b "
                      "on a.w = b.w where a.k < 3 and b.k < 2 group by a.k"):
                assert s.sql(q).to_pylist()
            assert s.last_plan_budget["feedback_mode"] == mode

    _assert_no_inversion(TLD, run)


def test_query_service_runs_clean_under_the_sanitizer(lockdebug_on, env,
                                                      tmp_path):
    """The serve path chip_smoke.py drives on the card with the sanitizer
    on: admission plans under the session lock, a DML commits under the
    writer lock, and neither inverts the pinned order."""
    path = mini_lake(TORCH, tmp_path, rows=64)

    def run():
        service, port, session = env.service(
            TORCH, conf={"engine.lock_debug": "on",
                         "engine.feedback_dir": str(tmp_path / "fb")},
            lake_path=path)
        assert isinstance(session.cache_lock, TLD.DebugLock)
        q = "select k, count(*) c from fact group by k order by k"
        for sql, tenant in ((q, "default"),
                            ("insert into fact select k, v + 1000, f "
                             "from fact where v < 8", "writer"),
                            (q, "default")):
            status, body, _ = post(port, {"sql": sql}, tenant=tenant)
            assert status == 200, body
        status, body, _ = post(port, {"sql": q}, path="/plan")
        assert status == 200, body

    _assert_no_inversion(TLD, run)
