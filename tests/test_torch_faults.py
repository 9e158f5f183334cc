"""The port's failure domain against the JAX package's: the fault taxonomy
(`classify`), the fault-spec registry and its fire counts, the report's
degradation ladder and watchdog, the atomic writes, and the catalog's and
spill pool's injection sites.

Both packages run on the CPU: the JAX session with NDS_FLIGHT_RECORDER=off
(no tracer, so no memory sampler and no `memoryHighWater`) and no AOT
cache, the port's as Session(device="cpu"). Each scripted failure goes
through both packages' BenchReport; the summaries must be EQUAL apart from
the environment and the times (`env`, `startTime`, `queryTimes`), and the
sessions' conf changes equal. The one intended difference is the repair
of the OOM classification: a CUDA OOM (torch.OutOfMemoryError, or its
text) is a `device_oom` in the port, which is what the reference gives an
XLA RESOURCE_EXHAUSTED, and what its text patterns would call `host_oom`.
"""

import json
import os
import sys
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from nds_tpu import faults as JF
from nds_tpu import report as JR
from nds_tpu.engine import spill as JSP
from nds_tpu.engine.session import Session as JaxSession
from nds_tpu_torch import faults as TF
from nds_tpu_torch import report as TR
from nds_tpu_torch.engine import spill as TSP
from nds_tpu_torch.engine.session import Session as TorchSession
from nds_tpu_torch.io import fs as TFS
from nds_tpu_torch.lakehouse.table import CommitConflictError
from nds_tpu_torch.ops import gpu_kernels as GK

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401

#: summary fields that hold the environment or a time
VOLATILE = ("env", "startTime", "queryTimes", "filename")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("NDS_FAULT_SPEC", "NDS_QUERY_TIMEOUT", "NDS_IO_RETRIES",
                "NDS_IO_BACKOFF", "NDS_UNION_AGG_WINDOW_ROWS",
                "NDS_LAKE_CONFLICT_RETRIES", "NDS_LAKE_COMMIT_BACKOFF"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NDS_FLIGHT_RECORDER", "off")
    JF.reset()
    TF.reset()
    yield
    JF.reset()
    TF.reset()


def _pair(conf=None):
    conf = dict(conf or {})
    return (JaxSession(conf={**conf, "engine.aot_cache_dir": ""}),
            TorchSession(conf=conf, device="cpu"))


def _stable(summary):
    return {k: v for k, v in summary.items() if k not in VOLATILE}


def _conf(session):
    return {k: v for k, v in session.conf.items()
            if k != "engine.aot_cache_dir"}


# ---------------------------------------------------------------------------
# the taxonomy
# ---------------------------------------------------------------------------

#: every case of tests/test_faults.py::test_classify_taxonomy, then the
#: other patterns of the taxonomy; an entry that is a callable makes each
#: package's own exception from its faults module
CLASSIFY_CASES = {
    "resource_exhausted": "RESOURCE_EXHAUSTED: out of HBM",
    "memory_error_obj": MemoryError(),
    "memory_error_text": "MemoryError",
    "watchdog": "query watchdog: exceeded budget",
    "conn_reset_text": "OSError: Connection reset by peer",
    "conn_reset_obj": ConnectionResetError("x"),
    "bind": "BindError: unknown column foo",
    "exec": "ExecError: bad plan",
    "malformed": "ValueError: malformed stream file",
    "unknown": "something else entirely",
    "watchdog_timed_out": "query watchdog: timed out",
    "injected_host_oom_text": "InjectedHostOOM: injected host OOM at 'q1'",
    "shape_1503": "ValueError: shape (1503, 4) mismatch",
    "xla_internal": "XlaRuntimeError: InternalError: crash",
    "http_503": "HTTP 503 from object store",
    "xla_oom_allocating": "Out of memory allocating 123 bytes",
    "bad_alloc": "std::bad_alloc",
    "numpy_alloc": "MemoryError: Unable to allocate 3.2 GiB",
    "deadline": "DEADLINE_EXCEEDED: rpc",
    "timeout_obj": TimeoutError("slow"),
    "spill_io": "SpillIOError: spill segment write failed",
    "commit_conflict": "CommitConflictError: lost the race",
    "fenced": "CatalogFencedError: fenced by catalog",
    "plan_budget": "PlanBudgetError: peak 9 GiB over the reject line",
    "plan_verify": "PlanVerifyError: bad node",
    "schema_mismatch": "schema mismatch in table",
    "injected_oom": lambda f: f.InjectedOOM(
        "RESOURCE_EXHAUSTED: injected device OOM at 'q'"),
    "injected_host_oom": lambda f: f.InjectedHostOOM("injected host OOM"),
    "injected_io": lambda f: f.TransientIOError("injected transient io"),
    "spill_io_obj": lambda f: (JSP if f is JF else TSP).SpillIOError("disk"),
}


@pytest.mark.parametrize("case", sorted(CLASSIFY_CASES))
def test_classify_matches_jax(case):
    err = CLASSIFY_CASES[case]
    if callable(err):
        assert TF.classify(err(TF)) == JF.classify(err(JF))
    else:
        assert TF.classify(err) == JF.classify(err)


def _cuda_oom():
    return torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
        "capacity of 79.18 GiB of which 1.02 GiB is free.")


def _attempt_text(exc):
    """What the port's BenchReport._attempt passes to the ladder."""
    def fn():
        raise exc
    return TR.BenchReport(None)._attempt(fn, (), 0)


CUDA_OOM_CASES = {
    "object": lambda: _cuda_oom(),
    "attempt_text": lambda: _attempt_text(_cuda_oom()),
    "runtime_text": lambda: _attempt_text(
        RuntimeError("CUDA error: out of memory")),
    "kernel_launch_text": lambda: _attempt_text(_launch_error(2)),
}


def _launch_error(rc):
    try:
        GK._raise_if(rc, "segment_sums")
    except RuntimeError as e:
        return e
    raise AssertionError("no error raised")


@pytest.mark.parametrize("case", sorted(CUDA_OOM_CASES))
def test_cuda_oom_is_a_device_oom(case):
    """A CUDA OOM classifies as the reference classifies an XLA device
    OOM; the reference's own patterns call torch's text a host OOM."""
    err = CUDA_OOM_CASES[case]()
    assert TF.classify(err) == TF.DEVICE_OOM
    assert JF.classify("RESOURCE_EXHAUSTED: out of HBM") == JF.DEVICE_OOM
    if isinstance(err, str) and "OutOfMemoryError" in err:
        assert JF.classify(err) == JF.HOST_OOM  # the repaired fault


def test_cuda_oom_text_renders_its_type():
    assert _attempt_text(_cuda_oom()).startswith(
        "OutOfMemoryError: CUDA out of memory.")


@pytest.mark.parametrize("err", [MemoryError(), "MemoryError: x",
                                 "ArrowMemoryError: malloc failed"])
def test_host_memory_errors_stay_host_oom(err):
    assert TF.classify(err) == JF.classify(err) == TF.HOST_OOM


def test_other_launch_errors_are_not_oom():
    assert TF.classify(_attempt_text(_launch_error(700))) == TF.UNKNOWN


def test_injected_oom_keeps_resource_exhausted():
    TF.install("oom:a:1")
    with pytest.raises(TF.InjectedOOM, match="RESOURCE_EXHAUSTED"):
        TF.maybe_fire("a")


def test_taxonomy_constants_match_jax():
    names = ("DEVICE_OOM", "HOST_OOM", "IO_TRANSIENT", "COMMIT_CONFLICT",
             "TIMEOUT", "PLANNER", "DATA", "UNKNOWN", "RETRYABLE")
    for n in names:
        assert getattr(TF, n) == getattr(JF, n), n
    assert not issubclass(TF.InjectedCrash, Exception)
    assert issubclass(TF.InjectedHostOOM, MemoryError)
    assert issubclass(TF.TransientIOError, OSError)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

SPECS = [
    "oom:query5:2;io:store_sales;hang:q:30",
    "oom:exec:query3:2;io:commit:store_sales",
    "io:spill:write:1;crash:spill:read",
    "crash:power_test",
    "hostoom:q1:3;oom:load:item:2",
    " oom:a:1 ; ;io:b:2.0 ",
    "hang:query9:0.5",
]


def _rules(reg):
    return [(r.kind, r.site, r.arg, r.remaining) for r in reg.rules]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parses_to_the_same_rules(spec):
    assert _rules(TF.FaultRegistry.parse(spec)) == _rules(
        JF.FaultRegistry.parse(spec))


@pytest.mark.parametrize("spec", ["explode:query5", "oom", "oom::1", ":a"])
def test_bad_spec_raises_in_both(spec):
    for f in (JF, TF):
        with pytest.raises(ValueError, match="bad fault rule"):
            f.FaultRegistry.parse(spec)


def _outcomes(f, calls):
    """What each injection call does: None, or the exception's class name
    and message."""
    out = []
    for how, site, kinds in calls:
        try:
            if how == "path":
                f.maybe_fire_path(site)
            else:
                f.maybe_fire(site, kinds=kinds)
            out.append(None)
        except BaseException as e:  # InjectedCrash included
            out.append((type(e).__name__, str(e)))
    return out


FIRE_CASES = {
    "counts": ("oom:a:1;io:b:2;crash:c",
               [("site", s, None) for s in "aabbbcc"]),
    "path_substring": ("io:store_sales:1",
                       [("path", "/wh/store_sales/part-0.parquet", None),
                        ("path", "/wh/store_sales/part-1.parquet", None),
                        ("path", "/wh/item/part-0.parquet", None)]),
    "path_ignores_oom": ("oom:query5:1",
                         [("path", "/out/query5/part-0.parquet", None),
                          ("site", "query5", None)]),
    "kinds_filter": ("oom:spill:write:1;io:spill:write:1",
                     [("site", "spill:write", ("io", "crash")),
                      ("site", "spill:write", ("io", "crash")),
                      ("site", "spill:write", None)]),
    "scoped_exec": ("oom:exec:query3:2",
                    [("site", "exec:query3", None),
                     ("site", "query3", None),
                     ("site", "exec:query3", None),
                     ("site", "exec:query3", None)]),
    "hostoom": ("hostoom:q1:1", [("site", "q1", None), ("site", "q1", None)]),
}


@pytest.mark.parametrize("case", sorted(FIRE_CASES))
def test_fire_counts_match_jax(case):
    spec, calls = FIRE_CASES[case]
    JF.install(spec)
    TF.install(spec)
    assert _outcomes(TF, calls) == _outcomes(JF, calls)


def test_install_idempotent_keeps_counts():
    for f in (JF, TF):
        f.install("oom:a:1")
        with pytest.raises(f.InjectedOOM):
            f.maybe_fire("a")
        f.install("oom:a:1")  # unchanged spec: counts keep
        f.maybe_fire("a")
        f.install("oom:a:1;oom:z:1")  # a different spec rebuilds
        with pytest.raises(f.InjectedOOM):
            f.maybe_fire("a")
        f.reset()
        assert not f.active()


def test_install_from_env_and_session(monkeypatch):
    monkeypatch.setenv("NDS_FAULT_SPEC", "oom:envsite:1")
    TorchSession(device="cpu")
    assert TF.active()
    with pytest.raises(TF.InjectedOOM):
        TF.maybe_fire("envsite")
    TF.reset()
    TorchSession(conf={"engine.fault_spec": "io:confsite:1"}, device="cpu")
    with pytest.raises(TF.TransientIOError):
        TF.maybe_fire("confsite")


def test_hang_sleeps_and_fires_once():
    TF.install("hang:h:0.2")
    t0 = time.monotonic()
    TF.maybe_fire("h")
    TF.maybe_fire("h")
    assert 0.2 <= time.monotonic() - t0 < 1.5


def test_scope_nests():
    assert TF.current_scope() is None
    with TF.scope("outer"):
        with TF.scope("inner"):
            assert TF.current_scope() == "inner"
        assert TF.current_scope() == "outer"
    assert TF.current_scope() is None


@pytest.mark.parametrize("base,cap", [(0.5, 2.0), (0.1, 30.0), (0.0, 30.0)])
def test_backoff_delays_jitter_bounds(base, cap):
    ds = list(TF.backoff_delays(4, base, cap=cap))
    assert len(ds) == 4
    for i, d in enumerate(ds):
        assert 0 <= d <= min(base * 2 ** i, cap)
    if base == 0:
        assert ds == list(JF.backoff_delays(4, base, cap=cap))


# ---------------------------------------------------------------------------
# atomic writes
# ---------------------------------------------------------------------------


def test_fs_open_atomic_commit_and_discard(tmp_path):
    p = tmp_path / "sub" / "report.json"
    with TFS.fs_open_atomic(str(p), "w") as f:
        f.write('{"ok": 1}')
    assert json.load(open(p)) == {"ok": 1}
    with pytest.raises(RuntimeError):
        with TFS.fs_open_atomic(str(p), "w") as f:
            f.write('{"torn"')
            raise RuntimeError("simulated crash mid-write")
    assert json.load(open(p)) == {"ok": 1}
    assert [x.name for x in p.parent.iterdir()] == ["report.json"]


def test_fs_open_fires_path_faults(tmp_path):
    p = tmp_path / "store_sales" / "x.txt"
    with TFS.fs_open(str(p), "w") as f:
        f.write("x")
    TF.install("io:store_sales:1")
    with pytest.raises(TF.TransientIOError):
        TFS.fs_open(str(p))
    with TFS.fs_open(str(p)) as f:
        assert f.read() == "x"
    with pytest.raises(ValueError, match="write-only"):
        TFS.fs_open_atomic(str(p), "r")


@pytest.mark.parametrize("path", ["memory://x/report.csv", "s3://b/k",
                                  "file:///tmp/x"])
def test_remote_paths_are_not_ported(path, monkeypatch):
    """Remote paths are ported now (the name is older): every scheme goes
    to fsspec.get_fs_token_paths, as in the JAX package. It is stubbed here
    onto one memory filesystem, so no store is reached; a write through
    either package reads back through the other, atomic writes too."""
    import fsspec
    from fsspec.implementations.memory import MemoryFileSystem

    from nds_tpu.io import fs as JFS

    mem = MemoryFileSystem()
    seen = []

    def resolve(url, *a, **kw):
        seen.append(url)
        return mem, None, ["/stub-faults/"
                           + url.split("://", 1)[1].lstrip("/")]

    monkeypatch.setattr(fsspec, "get_fs_token_paths", resolve)
    try:
        with TFS.fs_open(path, "w") as f:
            f.write("port")
        with JFS.fs_open(path) as f:
            assert f.read() == "port"
        with JFS.fs_open_atomic(path, "w") as f:
            f.write("jax")
        with TFS.fs_open(path) as f:
            assert f.read() == "jax"
        with TFS.fs_open_atomic(path, "w") as f:
            f.write("atomic")
        with JFS.fs_open(path) as f:
            assert f.read() == "atomic"
        assert mem.ls("/stub-faults", detail=False)
    finally:
        mem.rm("/stub-faults", recursive=True)
    assert TFS.is_remote(path)
    assert seen and all(u.startswith(path) for u in seen)
    assert TFS.join(path, "a", "b") == JFS.join(path, "a", "b")


def test_io_retry_budget(monkeypatch):
    from nds_tpu.io.fs import io_retry_budget as jax_budget

    assert TFS.io_retry_budget() == jax_budget() == (3, 0.5)
    monkeypatch.setenv("NDS_IO_RETRIES", "5")
    monkeypatch.setenv("NDS_IO_BACKOFF", "0")
    assert TFS.io_retry_budget() == jax_budget() == (5, 0.0)


# ---------------------------------------------------------------------------
# the degradation ladder, scripted
# ---------------------------------------------------------------------------


def _flaky(f, sequence):
    """fn failing with sequence[i](f) on call i (None = succeed); `f` is
    the package's faults module, so each package raises its own class."""
    calls = {"n": 0}

    def fn():
        i = calls["n"]
        calls["n"] += 1
        make = sequence[i] if i < len(sequence) else None
        if make is not None:
            raise make(f)

    fn.calls = calls
    return fn


def _oom(f):
    return f.InjectedOOM("RESOURCE_EXHAUSTED: injected")


def _host_oom(f):
    return f.InjectedHostOOM("injected host OOM at 'q1'")


def _io(f):
    return f.TransientIOError("injected transient io")


def _conflict(f):
    return CommitConflictError("concurrent commit conflict on store_sales")


def _planner(f):
    return ValueError("BindError: unknown column foo")


#: budgeter records of the plan that failed (Session.last_plan_budget)
BLOCKED = {"verdict": "blocked", "window_rows": 2048, "annotated": False,
           "spillable": False, "spill_partitions": None}
BLOCKED_ANNOTATED = {**BLOCKED, "annotated": True}
SPILL = {"verdict": "spill", "window_rows": None, "annotated": False,
         "spillable": True, "spill_partitions": 4}
DIRECT_SPILLABLE = {"verdict": "direct", "window_rows": None,
                    "annotated": False, "spillable": True,
                    "spill_partitions": None}

#: name -> (failures, retry_oom, session conf, budget record, env)
LADDER_CASES = {
    "oom_once": ([_oom], True, {}, None, {}),
    "oom_persistent": ([_oom] * 9, True, {}, None, {}),
    "oom_explicit_window": ([_oom] * 9, True,
                            {"engine.union_agg_window_rows": 65536}, None, {}),
    "oom_blocked_window": ([_oom] * 9, True, {}, BLOCKED, {}),
    "oom_blocked_recovers": ([_oom], True, {}, BLOCKED, {}),
    "oom_blocked_annotated": ([_oom] * 9, True, {}, BLOCKED_ANNOTATED, {}),
    "oom_blocked_smaller_explicit": ([_oom] * 9, True,
                                     {"engine.union_agg_window_rows": 1024},
                                     BLOCKED, {}),
    "oom_spill": ([_oom] * 9, True, {}, SPILL, {}),
    "oom_spill_recovers": ([_oom] * 3, True, {}, SPILL, {}),
    "oom_direct_spillable": ([_oom] * 9, True, {}, DIRECT_SPILLABLE, {}),
    "oom_spill_off": ([_oom] * 9, True, {"engine.spill": "off"},
                      DIRECT_SPILLABLE, {}),
    "oom_not_idempotent": ([_oom], False, {}, None, {}),
    "host_oom_once": ([_host_oom], True, {}, None, {}),
    "host_oom_twice": ([_host_oom] * 2, True, {}, None, {}),
    "io_twice": ([_io] * 2, True, {}, None,
                 {"NDS_IO_RETRIES": "2", "NDS_IO_BACKOFF": "0"}),
    "io_exhausted": ([_io] * 3, True, {}, None,
                     {"NDS_IO_RETRIES": "2", "NDS_IO_BACKOFF": "0"}),
    "commit_conflict": ([_conflict] * 2, True, {}, None,
                        {"NDS_LAKE_COMMIT_BACKOFF": "0"}),
    "commit_conflict_exhausted": ([_conflict] * 3, True, {}, None,
                                  {"NDS_LAKE_COMMIT_BACKOFF": "0"}),
    "planner": ([_planner], True, {}, None, {}),
    "succeeds": ([], True, {}, None, {}),
}


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_ladder_matches_jax(case, monkeypatch):
    failures, retry_oom, conf, budget, env = LADDER_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    js, ts = _pair(conf)
    out = []
    for f, R, s in ((JF, JR, js), (TF, TR, ts)):
        s.last_plan_budget = None if budget is None else dict(budget)
        fn = _flaky(f, failures)
        summary = R.BenchReport(s).report_on(fn, retry_oom=retry_oom)
        out.append((_stable(summary), fn.calls["n"], _conf(s)))
    assert out[1] == out[0]


def test_ladder_device_oom_walks_device_rungs_for_a_cuda_oom():
    """The repair end to end: a CUDA OOM gets the device ladder (the
    reference's rungs for RESOURCE_EXHAUSTED), not one recover_retry."""
    _, ts = _pair()
    ts.last_plan_budget = dict(DIRECT_SPILLABLE)
    fn = _flaky(TF, [lambda f: _cuda_oom()] * 9)
    s = TR.BenchReport(ts).report_on(fn, retry_oom=True)
    assert s["queryStatus"] == ["Failed"]
    assert s["failureKind"] == TF.DEVICE_OOM
    assert [r["rung"] for r in s["ladder"]] == [
        "recover_retry", "shrink_union_window", "spill_retry"]
    assert {r["kind"] for r in s["ladder"]} == {TF.DEVICE_OOM}
    assert all(e.startswith("OutOfMemoryError: CUDA out of memory")
               for e in s["exceptions"])
    assert len(s["exceptions"]) == 4


@pytest.mark.parametrize("retry_oom", [True, False])
def test_watchdog_timeout_matches_jax(retry_oom):
    js, ts = _pair({"engine.query_timeout": "0.3"})
    out = []
    for R, s in ((JR, js), (TR, ts)):
        t0 = time.monotonic()
        summary = R.BenchReport(s).report_on(lambda: time.sleep(1.5),
                                             retry_oom=retry_oom)
        assert time.monotonic() - t0 < 1.2  # the stream moved on
        out.append(_stable(summary))
    assert out[1] == out[0]
    assert out[1]["failureKind"] == TF.TIMEOUT
    assert out[1]["retries"] == 0


def test_watchdog_honours_spill_progress_of_its_worker():
    """A slow attempt that keeps beating through Session.spill_progress is
    alive: the watchdog re-arms past each beat."""
    _, ts = _pair({"engine.query_timeout": "0.4"})

    def slow_but_alive():
        for _ in range(8):
            time.sleep(0.1)
            ts.spill_progress()

    s = TR.BenchReport(ts).report_on(slow_but_alive, retry_oom=True)
    assert s["queryStatus"] == ["Completed"]


def test_watchdog_ignores_beats_of_another_thread():
    import threading

    _, ts = _pair({"engine.query_timeout": "0.3"})
    stop = threading.Event()

    def zombie():  # an abandoned earlier attempt still beating
        while not stop.is_set():
            ts.spill_progress()
            time.sleep(0.05)

    z = threading.Thread(target=zombie, daemon=True)
    z.start()
    try:
        s = TR.BenchReport(ts).report_on(lambda: time.sleep(1.5))
    finally:
        stop.set()
        z.join(timeout=5)
    assert not z.is_alive()
    assert s["failureKind"] == TF.TIMEOUT


def test_watchdog_moves_arrow_off_mimalloc(monkeypatch):
    """An armed watchdog makes Arrow allocate from the system allocator
    (Arrow's mimalloc pool crashed under the watchdog's thread per attempt),
    unless the user chose a pool."""
    import pyarrow as pa

    _, ts = _pair({"engine.query_timeout": "5"})
    monkeypatch.delenv("ARROW_DEFAULT_MEMORY_POOL", raising=False)
    pools = []
    monkeypatch.setattr(pa, "set_memory_pool", pools.append)
    monkeypatch.setattr(pa, "default_memory_pool",
                        lambda: pa.mimalloc_memory_pool())
    TR.BenchReport(ts).report_on(lambda: None)
    assert [p.backend_name for p in pools] == ["system"]
    monkeypatch.setenv("ARROW_DEFAULT_MEMORY_POOL", "mimalloc")
    TR.BenchReport(ts).report_on(lambda: None)
    assert len(pools) == 1  # the user's choice stands
    monkeypatch.delenv("ARROW_DEFAULT_MEMORY_POOL")
    _, off = _pair({})
    TR.BenchReport(off).report_on(lambda: None)
    assert len(pools) == 1  # no watchdog, no worker threads


def test_watchdog_reraises_an_injected_crash():
    _, ts = _pair({"engine.query_timeout": "5"})

    def crash():
        raise TF.InjectedCrash("injected crash at 'q'")

    with pytest.raises(TF.InjectedCrash):
        TR.BenchReport(ts).report_on(crash, retry_oom=True)


def test_task_failures_match_jax():
    js, ts = _pair()
    out = []
    for R, s in ((JR, js), (TR, ts)):
        summary = R.BenchReport(s).report_on(
            lambda s=s: s.notify_failure("task retry: exchange capacity"))
        out.append(_stable(summary))
    assert out[1] == out[0]
    assert out[1]["queryStatus"] == ["CompletedWithTaskFailures"]


def test_report_redacts_secrets_and_names_the_card(monkeypatch):
    monkeypatch.setenv("MY_SECRET_KEY", "hunter2")
    monkeypatch.setenv("API_TOKEN", "tok")
    monkeypatch.setenv("SAFE_VAR", "ok")
    _, ts = _pair({"engine.pallas_agg": "on"})
    r = TR.BenchReport(ts)
    r.report_on(lambda: None)
    env = r.summary["env"]
    assert "MY_SECRET_KEY" not in env["envVars"]
    assert "API_TOKEN" not in env["envVars"]
    assert env["envVars"].get("SAFE_VAR") == "ok"
    assert env["sparkConf"] == env["engineConf"]
    assert env["sparkVersion"] == env["engineVersion"]
    conf = env["engineConf"]
    assert conf["torch.version"] == torch.__version__
    assert conf["torch.device"] == "cpu"
    assert conf["engine.pallas_agg"] == "on"
    assert not any(k.startswith("jax.") for k in conf)


def test_write_summary_filename_contract(tmp_path):
    _, ts = _pair()
    r = TR.BenchReport(ts)
    r.report_on(lambda: None)
    name = r.write_summary("query7", prefix=str(tmp_path / "power"))
    s = json.load(open(name))
    assert s["filename"].endswith(f"-query7-{s['startTime']}.json")
    assert s["query"] == "query7"
    assert not [p for p in os.listdir(tmp_path) if ".tmp-" in p]


def test_query_timeout_resolution(monkeypatch):
    _, ts = _pair()
    assert TR.query_timeout(ts) == 0.0
    monkeypatch.setenv("NDS_QUERY_TIMEOUT", "7")
    assert TR.query_timeout(ts) == 7.0
    ts.conf["engine.query_timeout"] = "2.5"
    assert TR.query_timeout(ts) == JR.query_timeout(ts) == 2.5
    ts.conf["engine.query_timeout"] = "nope"
    assert TR.query_timeout(ts) == 0.0


#: knobs the harness reads, unported until their items (verify_plans: item
#: 9.5; the others: item 12a), with their environment knobs
_REPORT_KNOBS = {
    "engine.host_rss_watermark": "NDS_HOST_RSS_WATERMARK",
    "engine.verify_plans": "NDS_VERIFY_PLANS",
    "engine.trace_dir": "NDS_TRACE_DIR",
    "engine.metrics_port": "NDS_METRICS_PORT",
}


@pytest.mark.parametrize("knob", sorted(_REPORT_KNOBS))
def test_unported_report_knobs_raise(knob, monkeypatch, tmp_path):
    if knob == "engine.verify_plans":
        # ported: the session starts, and its plans check the level as the
        # reference's do (off | final | all)
        for conf in ({knob: "1"}, {knob: "off"}, {}):
            TorchSession(conf=conf, device="cpu")
        monkeypatch.setenv(_REPORT_KNOBS[knob], "0")
        for conf in ({}, {knob: "1"}):
            with pytest.raises(ValueError, match="engine.verify_plans"):
                TorchSession(conf=conf, device="cpu").sql("select 1 as a")
        for level in ("off", "final", "all"):
            assert TorchSession(conf={knob: level}, device="cpu").sql(
                "select 1 as a").to_pylist() == [{"a": 1}]
        return
    # ported by item 12a (obs/): the knob turns its layer on, from the conf
    # and from the environment, as the reference's resolver reads it
    from nds_tpu_torch.obs import metrics as TM

    for var in _REPORT_KNOBS.values():
        monkeypatch.delenv(var, raising=False)
    env = _REPORT_KNOBS[knob]
    if knob == "engine.host_rss_watermark":
        for conf, want in (({knob: "1"}, 1), ({knob: "off"}, 0), ({}, 0)):
            s = TorchSession(conf=conf, device="cpu")
            assert TR.host_rss_watermark(s) == JR.host_rss_watermark(s) == want
        monkeypatch.setenv(env, "4096")
        assert TR.host_rss_watermark(TorchSession(device="cpu")) == 4096
        # 0 leaves only the watermark off, as in the reference
        monkeypatch.setenv(env, "0")
        assert TR.host_rss_watermark(TorchSession(device="cpu")) == 0
        return
    if knob == "engine.trace_dir":
        for where in ("conf", "env"):
            d = str(tmp_path / where)
            if where == "env":
                monkeypatch.setenv(env, d)
            s = TorchSession(conf={knob: d} if where == "conf" else {},
                             device="cpu")
            assert os.path.dirname(s.tracer.path) == d
            s.tracer.close()
            assert os.listdir(d) == [os.path.basename(s.tracer.path)]
        return
    # a metrics port of 0 binds an ephemeral port, in conf and environment
    monkeypatch.setenv("NDS_METRICS_HOST", "127.0.0.1")
    TM.reset_shared()
    try:
        assert TorchSession(device="cpu").metrics is None
        s = TorchSession(conf={knob: "0"}, device="cpu")
        assert s.metrics is TM.shared_sink() and TM.active_server().port > 0
        monkeypatch.setenv(env, "0")
        assert TorchSession(device="cpu").metrics is s.metrics
        assert TorchSession(conf={knob: "off"}, device="cpu").metrics is None
    finally:
        TM.reset_shared()


# ---------------------------------------------------------------------------
# the engine's injection sites and recovery
# ---------------------------------------------------------------------------


def _tables():
    rng = np.random.default_rng(7)
    n = 5000
    return {
        "t1": pa.table({"k": rng.integers(0, 300, n).astype(np.int64),
                        "v": rng.integers(0, 1000, n).astype(np.int64)}),
        "d": pa.table({"dk": np.arange(300, dtype=np.int64),
                       "g": (np.arange(300) % 7).astype(np.int64)}),
    }


def _registered(conf=None, tmp_path=None):
    conf = dict(conf or {})
    if tmp_path is not None:
        conf["engine.spill_dir"] = str(tmp_path)
    js, ts = _pair(conf)
    for name, t in _tables().items():
        js.register_arrow(name, t)
        ts.register_arrow(name, t)
    return js, ts


Q_JOIN = ("select t1.k, count(*) c, sum(v) s from t1, d where t1.k = d.dk "
          "group by t1.k order by t1.k")
#: spilled through the pool under engine.spill=force (its DISTINCT's
#: partitions and its ORDER BY's runs)
Q_SPILL = "select distinct k from t1 order by k"
#: every segment past the first tiers to disk
DISK_TIER = {"engine.spill": "force", "engine.spill_partitions": 4,
             "engine.spill_pool_bytes": 1}

#: name -> (spec, scope name or None, session conf, query); each runs
#: through both packages' BenchReport
SITE_CASES = {
    "load_table": ("io:load:t1:1", None, {}, Q_JOIN),
    "table_name": ("oom:t1:1", None, {}, Q_JOIN),
    "exec_scope": ("oom:exec:qsite:1", "qsite", {}, Q_JOIN),
    "exec_scope_persistent": ("oom:exec:qsite:3", "qsite", {}, Q_JOIN),
    "exec_other_scope": ("oom:exec:other:1", "qsite", {}, Q_JOIN),
    "spill_write": ("io:spill:write:1", None, DISK_TIER, Q_SPILL),
    "spill_evict": ("io:spill:evict:1", None, DISK_TIER, Q_SPILL),
    "spill_read": ("io:spill:read:1", None, DISK_TIER, Q_SPILL),
    "spill_write_twice": ("io:spill:write:2", None, DISK_TIER, Q_SPILL),
}


@pytest.mark.parametrize("case", sorted(SITE_CASES))
def test_injection_sites_match_jax(case, tmp_path, monkeypatch):
    monkeypatch.setenv("NDS_IO_BACKOFF", "0")
    spec, scope, conf, sql = SITE_CASES[case]
    js, ts = _registered(conf, tmp_path)
    out = []
    for f, R, s in ((JF, JR, js), (TF, TR, ts)):
        f.install(spec)

        def run(f=f, s=s):
            if scope is None:
                return s.sql(sql).collect()
            with f.scope(scope):
                return s.sql(sql).collect()

        summary = R.BenchReport(s).report_on(run, retry_oom=True)
        out.append((_stable(summary), run().to_pylist()))
        f.reset()
    assert out[1] == out[0]
    if case != "exec_other_scope":  # every other rule fires
        assert out[1][0]["exceptions"], out[1][0]


def test_spill_io_fault_retries_with_backoff(tmp_path, monkeypatch):
    """tests/test_spill.py's drill: an injected spill-write fault walks the
    io_backoff_retry rung, and a real segment-IO error classifies
    io_transient."""
    monkeypatch.setenv("NDS_IO_RETRIES", "2")
    monkeypatch.setenv("NDS_IO_BACKOFF", "0")
    _, ts = _registered(DISK_TIER, tmp_path)
    TF.install("io:spill:write:1")
    s = TR.BenchReport(ts).report_on(
        lambda: ts.sql(Q_SPILL).collect(), retry_oom=True)
    assert s["queryStatus"] == ["CompletedWithTaskFailures"]
    assert [r["rung"] for r in s["ladder"]] == ["io_backoff_retry"]
    assert TF.classify(TSP.SpillIOError("disk went away")) == TF.IO_TRANSIENT


def test_spill_crash_rule_sails_through(tmp_path):
    _, ts = _registered(DISK_TIER, tmp_path)
    TF.install("crash:spill:write")
    with pytest.raises(TF.InjectedCrash):
        ts.sql(Q_SPILL).collect()


def test_recover_memory_empties_device_caches():
    from nds_tpu_torch.engine.columnar import table_from_numpy

    _, ts = _registered()
    pinned = table_from_numpy(
        {"x": (np.arange(10, dtype=np.int64), None, "int64", None)}, 10,
        device="cpu")
    ts.register_table("pinned", pinned)
    ts.sql(Q_JOIN).collect()
    ts.sql("select sum(x) from pinned").collect()
    assert ts.catalog.entries["t1"].device_cols
    assert ts.catalog.resident_bytes() > 0
    seen = []
    ts.register_listener(seen.append)
    ts.recover_memory("device memory exhausted")
    assert ts.catalog.entries["t1"].device_cols == {}
    assert ts.catalog.entries["d"].device_cols == {}
    # a register_table entry has no host source: it keeps its columns
    assert ts.catalog.entries["pinned"].device_cols
    assert seen == ["task retry: device memory exhausted; dropped device "
                    "caches"]
    ts.unregister_listener(seen.append)
    ts.unregister_listener(seen.append)  # a second removal is a no-op
    ts.notify_failure("x")
    assert len(seen) == 1
    # the next scan reloads what was dropped
    assert ts.sql(Q_JOIN).collect().num_rows > 0
    assert ts.catalog.entries["t1"].device_cols


def test_load_retries_after_a_cuda_oom(monkeypatch):
    """The catalog's load-time retry takes a CUDA OOM as the reference
    takes RESOURCE_EXHAUSTED: recover, reload the whole requested column
    set once, and report a task failure."""
    _, ts = _registered()
    calls = {"n": 0}
    real = ts.catalog._to_device

    def flaky(arrow, e):
        calls["n"] += 1
        if calls["n"] == 1:
            raise _cuda_oom()
        return real(arrow, e)

    monkeypatch.setattr(ts.catalog, "_to_device", flaky)
    s = TR.BenchReport(ts).report_on(
        lambda: ts.sql("select sum(v) from t1").collect(), retry_oom=True)
    assert s["queryStatus"] == ["CompletedWithTaskFailures"]
    assert "ladder" not in s  # recovered inside the load
    assert any("device memory exhausted loading 't1'" in f
               for f in s["taskFailures"])
    assert calls["n"] == 2


def test_load_does_not_retry_other_errors(monkeypatch):
    _, ts = _registered()

    def broken(arrow, e):
        raise ValueError("Invalid value in column")

    monkeypatch.setattr(ts.catalog, "_to_device", broken)
    with pytest.raises(ValueError, match="Invalid value"):
        ts.sql("select sum(v) from t1").collect()


def test_run_script_runs_every_statement():
    _, ts = _registered()
    res = ts.run_script("select 1 as a; select count(*) as n from d;")
    assert res.collect().to_pylist() == [{"n": 300}]
    assert ts.run_script("") is None
    # a script ending in CREATE VIEW returns None, and the view holds its
    # query's rows
    assert ts.run_script(
        "select 1 as a; create view v as select k from t1;") is None
    assert ts.sql("select count(*) as n from v").to_pylist() == ts.sql(
        "select count(*) as n from t1").to_pylist()
