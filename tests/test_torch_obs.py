"""The port's observability subsystem (nds_tpu_torch/obs/ and
cli/profile.py) through the JAX package's own cases, tests/test_obs.py:
the structured event log (golden schema and nesting invariants), memory
high-water sampling, child-stream fold-in and subprocess failure
classification, the live metrics endpoint, trace rotation and compaction,
and the operator-level profiler CLI. Every case runs the port's modules
with its sessions on the CPU; the event schema itself is held
byte-identical to the reference's. The reference's two end-to-end power
runs (marked slow there) have their counterpart in
tests/test_torch_profile.py, over a warehouse the module writes.

Exact: no tolerance is involved (event fields, counts and exit codes)."""

import collections
import functools
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from nds_tpu.obs import trace as JOT
from nds_tpu_torch import faults
from nds_tpu_torch import full_bench as FB
from nds_tpu_torch import throughput as TP
from nds_tpu_torch.cli import profile as profile_cli
from nds_tpu_torch.engine.session import Session as _TorchSession
from nds_tpu_torch.obs import metrics as M
from nds_tpu_torch.obs import reader as R
from nds_tpu_torch.obs import trace as OT
from nds_tpu_torch.obs.memwatch import MemorySampler
from nds_tpu_torch.obs.trace import EVENT_SCHEMA, Tracer, bind, tracer_from_conf
from nds_tpu_torch.report import BenchReport

sys.path.insert(0, os.path.dirname(__file__))
from torch_join_cases import strict_budget  # noqa: E402,F401

#: the port's sessions run on the CPU here
Session = functools.partial(_TorchSession, device="cpu")


def test_event_schema_is_the_references():
    """EVENT_SCHEMA, CONTEXT_FIELDS and the deprecated kinds are the
    reference's, byte for byte (the lint of ROADMAP item 15 reads them),
    and the schema literal's source text is the reference's."""
    assert OT.EVENT_SCHEMA == JOT.EVENT_SCHEMA
    assert list(OT.EVENT_SCHEMA) == list(JOT.EVENT_SCHEMA)
    assert OT.CONTEXT_FIELDS == JOT.CONTEXT_FIELDS
    assert OT.DEPRECATED_EVENT_KINDS == JOT.DEPRECATED_EVENT_KINDS
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def literal(pkg):
        text = open(os.path.join(here, pkg, "obs", "trace.py")).read()
        a = text.index("EVENT_SCHEMA = {")
        return text[a:text.index("\n}\n", a)]

    assert literal("nds_tpu_torch") == literal("nds_tpu")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch, tmp_path_factory):
    # failure bundles of this module land in a private directory, never
    # the shared <tempdir>/nds-flight
    monkeypatch.setenv("NDS_FLIGHT_DIR", str(tmp_path_factory.mktemp("fl")))
    monkeypatch.setenv("NDS_METRICS_HOST", "127.0.0.1")
    monkeypatch.delenv("NDS_FLIGHT_RECORDER", raising=False)
    monkeypatch.delenv("NDS_TRACE_KERNELS", raising=False)
    monkeypatch.delenv("NDS_TRACE_DIR", raising=False)
    monkeypatch.delenv("NDS_FAULT_SPEC", raising=False)
    monkeypatch.delenv("NDS_METRICS_PORT", raising=False)
    monkeypatch.delenv("NDS_TRACE_ROTATE_BYTES", raising=False)
    monkeypatch.delenv("NDS_TRACE_CONTEXT", raising=False)
    faults.reset()
    yield
    faults.reset()
    # the metrics sink/server and the flight ring are process-wide
    # singletons by design; tests must not leak one test's counters (or a
    # bound port, or ring events) into the next
    M.reset_shared()
    from nds_tpu_torch.obs import flight as FL

    FL.reset_shared()


def _scrape(port, path):
    import urllib.request

    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=5
    ) as resp:
        return resp.read().decode("utf-8")


def _events(path_or_dir):
    return R.read_events(path_or_dir, strict=True)


def _traced_session(tmp_path, **conf):
    conf = {"engine.trace_dir": str(tmp_path / "trace"), **conf}
    s = Session(conf=conf)
    s.register_arrow(
        "t",
        pa.table({"a": [1, 2, 3, 4, 2, 1], "b": [10, 20, 30, 40, 50, 60]}),
    )
    return s


# ---------------------------------------------------------------------------
# tracer core
# ---------------------------------------------------------------------------


def test_tracer_defaults_to_ring_only(monkeypatch):
    """With nothing configured the session still gets a RING-ONLY tracer
    (the always-on flight recorder): no file, no in-memory list, events
    land in the process-wide bounded ring. NDS_FLIGHT_RECORDER=off
    restores the historical fully-disabled None."""
    from nds_tpu_torch.obs import flight as FL

    FL.reset_shared()
    s = Session()
    assert s.tracer is not None
    assert s.tracer.path is None and s.tracer.events is None
    assert s.tracer.ring is FL.recorder()
    assert s.tracer.context.trace_id
    before = len(FL.recorder().snapshot())
    s.tracer.emit("plan_cache", node="Aggregate", hit=True)
    ring = FL.recorder().snapshot()
    assert len(ring) == before + 1
    assert ring[-1]["trace_id"] == s.tracer.context.trace_id
    monkeypatch.setenv("NDS_FLIGHT_RECORDER", "off")
    assert tracer_from_conf({}) is None
    assert Session().tracer is None
    FL.reset_shared()


def test_tracer_writes_meta_and_appends(tmp_path):
    tr = tracer_from_conf({"engine.trace_dir": str(tmp_path)})
    tr.emit("io_retry", path="/x", error="e", delay_s=0.0)
    tr.close()
    evs = _events(tr.path)
    assert [e["kind"] for e in evs] == ["trace_meta", "io_retry"]
    assert evs[0]["pid"] == os.getpid()
    assert all("ts" in e and e["app"] == tr.app_id for e in evs)


def test_tracer_auto_scopes_query(tmp_path):
    tr = tracer_from_conf({"engine.trace_dir": str(tmp_path)})
    with faults.scope("query42"):
        tr.emit("plan_cache", node="Aggregate", hit=True)
    tr.emit("plan_cache", node="Aggregate", hit=False)
    evs = _events(tr.path)
    assert evs[1]["query"] == "query42"
    assert "query" not in evs[2]


def test_memory_tracer_collects_in_process():
    tr = Tracer()  # no dir: in-memory (tools/trace_query.py mode)
    tr.emit("plan_cache", node="Distinct", hit=False)
    assert tr.path is None
    assert [e["kind"] for e in tr.events] == ["plan_cache"]


def test_tracer_thread_binding():
    tr = Tracer()
    seen = {}

    def worker():
        from nds_tpu_torch.obs.trace import current

        seen["inner"] = current()

    with bind(tr):
        from nds_tpu_torch.obs.trace import current

        assert current() is tr
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    from nds_tpu_torch.obs.trace import current

    assert current() is None
    assert seen["inner"] is None  # thread-locals do not inherit


# ---------------------------------------------------------------------------
# golden schema + engine emission sites
# ---------------------------------------------------------------------------


def test_engine_events_golden_schema(tmp_path):
    s = _traced_session(tmp_path)
    with bind(s.tracer):
        with faults.scope("q_agg"):
            s.sql("select a, sum(b) sb from t group by a order by a").collect()
        with faults.scope("q_agg2"):  # plan-cache hit on the aggregate
            s.sql("select a, sum(b) sb from t group by a order by a").collect()
        with faults.scope("q_scan"):  # catalog cache hit (columns resident)
            s.sql("select a, b from t").collect()
    evs = _events(s.tracer.path)
    assert R.validate_events(evs) == []
    kinds = {e["kind"] for e in evs}
    assert {"trace_meta", "op_span", "catalog_load", "plan_cache"} <= kinds
    # plan cache: one miss (first aggregate) then one hit (second)
    pc = [e for e in evs if e["kind"] == "plan_cache"]
    assert [e["hit"] for e in pc] == [False, True]
    # catalog: first load is a miss, the later full-resident load is a hit
    cl = [e for e in evs if e["kind"] == "catalog_load"]
    assert cl[0]["cache"] == "miss" and cl[-1]["cache"] == "hit"
    assert all(e["table"] == "t" for e in cl)
    # op spans carry rows + bytes and are query-scoped
    ops = [e for e in evs if e["kind"] == "op_span"]
    assert all(e["query"].startswith("q_") for e in ops)
    assert any(e["rows"] is not None and e["rows"] > 0 for e in ops)
    assert all(e["est_bytes"] >= 0 for e in ops)


def test_op_span_nesting_invariants(tmp_path):
    s = _traced_session(tmp_path)
    with faults.scope("q"):
        s.sql(
            "select a, sum(b) sb from t where b > 10 group by a order by a"
        ).collect()
    ops = [e for e in _events(s.tracer.path) if e["kind"] == "op_span"]
    by_exec = {}
    for e in ops:
        by_exec.setdefault(e["exec_id"], []).append(e)
    for spans in by_exec.values():
        spans.sort(key=lambda e: e["seq"])
        # seq is 1..n with no gaps; completion (post-) order means a parent
        # at depth d completes after its depth-d+1 children
        assert [e["seq"] for e in spans] == list(range(1, len(spans) + 1))
        assert spans[-1]["depth"] == 0  # the root completes last
        acc = {}
        for e in spans:
            d = e["depth"]
            child_ms = acc.pop(d + 1, 0.0)
            # inclusive timing: a parent's span covers its children
            assert e["dur_ms"] >= child_ms - 1e-6
            acc[d] = acc.get(d, 0.0) + e["dur_ms"]
        # nothing left dangling deeper than the root
        assert set(acc) == {0}
    withx = R.op_spans_with_exclusive(ops)
    assert all(e["excl_ms"] >= 0 for e in withx)
    # exclusive sums to the root inclusive time per executor
    for eid, spans in by_exec.items():
        root = max(e["dur_ms"] for e in spans if e["depth"] == 0)
        tot_excl = sum(
            e["excl_ms"] for e in withx if e["exec_id"] == eid
        )
        roots = sum(
            e["dur_ms"] for e in spans if e["depth"] == 0
        )
        assert abs(tot_excl - roots) < 1e-3


def test_blocked_union_event(tmp_path):
    s = _traced_session(tmp_path)
    rng = np.random.default_rng(7)
    for t in ("u1", "u2"):
        s.register_arrow(
            t,
            pa.table({
                "k": pa.array(rng.integers(1, 5, 3000), pa.int32()),
                "v": pa.array(rng.integers(-50, 50, 3000), pa.int32()),
            }),
        )
    s.conf["engine.union_agg_window_rows"] = 512
    with faults.scope("q_union"):
        s.sql(
            "select k, sum(v) sv from (select k, v from u1 union all "
            "select k, v from u2) u group by k order by k"
        ).collect()
    evs = _events(s.tracer.path)
    assert R.validate_events(evs) == []
    bu = [e for e in evs if e["kind"] == "blocked_union"]
    assert bu and bu[0]["windows"] > 1 and bu[0]["window_rows"] == 512
    assert bu[0]["total_rows"] == 6000
    assert bu[0]["query"] == "q_union"


def test_report_events_ladder_fault_and_query_span(tmp_path):
    s = _traced_session(tmp_path)
    faults.install("oom:q_flaky:1")
    with bind(s.tracer):
        def fn():
            faults.maybe_fire("q_flaky")

        summary = BenchReport(s).report_on(fn, retry_oom=True, name="q_flaky")
    assert summary["queryStatus"] == ["CompletedWithTaskFailures"]
    # engineConf/engineVersion aliases mirror the spark-named compat keys
    assert summary["env"]["engineConf"] == summary["env"]["sparkConf"]
    assert summary["env"]["engineVersion"] == summary["env"]["sparkVersion"]
    assert summary["memoryHighWater"]["bytes"] > 0
    assert summary["memoryHighWater"]["source"] in ("device", "rss")
    evs = _events(s.tracer.path)
    assert R.validate_events(evs) == []
    fi = [e for e in evs if e["kind"] == "fault_injected"]
    assert fi and fi[0]["site"] == "q_flaky" and fi[0]["fault_kind"] == "oom"
    lr = [e for e in evs if e["kind"] == "ladder_rung"]
    assert [e["rung"] for e in lr] == ["recover_retry"]
    assert lr[0]["failure_kind"] == faults.DEVICE_OOM
    qs = [e for e in evs if e["kind"] == "query_span"]
    assert qs[-1]["query"] == "q_flaky"
    assert qs[-1]["status"] == "CompletedWithTaskFailures"
    assert qs[-1]["retries"] == 1
    assert qs[-1]["mem_hw_bytes"] == summary["memoryHighWater"]["bytes"]


def test_watchdog_fire_event(tmp_path):
    s = _traced_session(tmp_path, **{"engine.query_timeout": 0.3})

    def hang():
        time.sleep(5)

    summary = BenchReport(s).report_on(hang, name="q_hang")
    assert summary["failureKind"] == faults.TIMEOUT
    evs = _events(s.tracer.path)
    wf = [e for e in evs if e["kind"] == "watchdog_fire"]
    assert wf and wf[0]["query"] == "q_hang" and wf[0]["budget_s"] == 0.3
    qs = [e for e in evs if e["kind"] == "query_span"]
    assert qs[-1]["status"] == "Failed"
    assert qs[-1]["failure_kind"] == faults.TIMEOUT


def test_io_retry_event(tmp_path, monkeypatch):
    import fsspec

    from nds_tpu_torch.io.fs import fs_open

    monkeypatch.setenv("NDS_IO_BACKOFF", "0")
    monkeypatch.setenv("NDS_IO_RETRIES", "2")
    fs = fsspec.filesystem("memory")
    with fs.open("/obs_retry/data.txt", "w") as f:
        f.write("payload")
    faults.install("io:obs_retry:1")
    tr = Tracer()
    with bind(tr):
        with fs_open("memory://obs_retry/data.txt") as f:
            assert f.read() == "payload"
    io_evs = [e for e in tr.events if e["kind"] == "io_retry"]
    assert len(io_evs) == 1
    assert "obs_retry" in io_evs[0]["path"]
    assert "transient io" in io_evs[0]["error"]


def test_memwatch_sampler_reads_a_peak():
    with MemorySampler(interval_s=0.005) as ms:
        _ = [0] * 100000
        time.sleep(0.03)
    assert ms.peak_bytes is not None and ms.peak_bytes > 0
    assert ms.source in ("device", "rss")


# ---------------------------------------------------------------------------
# reader: parsing contracts + fold-in + failure classification
# ---------------------------------------------------------------------------


def _write_jsonl(path, events, torn_tail=None):
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")
        if torn_tail is not None:
            f.write(torn_tail)  # no newline: a crash mid-write


def _ev(kind, **kw):
    base = {"ts": 1, "kind": kind, "app": "app-x"}
    base.update(kw)
    return base


def test_iter_events_tolerates_torn_final_line_only(tmp_path):
    p = tmp_path / "events-a.jsonl"
    _write_jsonl(
        p, [_ev("trace_meta", pid=1, version="0")], torn_tail='{"ts": 2, "ki'
    )
    assert len(list(R.iter_events(p, strict=True))) == 1
    # a malformed MIDDLE line is corruption, not a crash artifact
    with open(p, "a") as f:
        f.write("\n{broken}\n" + json.dumps(_ev("plan_cache", node="x", hit=True)) + "\n")
    with pytest.raises(R.MalformedEventError):
        list(R.iter_events(p, strict=True))
    assert len(list(R.iter_events(p, strict=False))) >= 1


def test_validate_events_flags_missing_fields():
    ok = _ev("query_span", query="q1", dur_ms=1.0, status="Completed",
             retries=0)
    bad = _ev("query_span", query="q1")
    unknown = _ev("not_a_kind")
    probs = R.validate_events([ok, bad, unknown])
    assert len(probs) == 2
    assert "missing fields" in probs[0] and "unknown kind" in probs[1]
    assert set(EVENT_SCHEMA) >= {"op_span", "query_span", "child_stream"}


def test_failure_kind_from_events_prefers_failed_query_span():
    evs = [
        _ev("query_span", query="q1", dur_ms=1, status="Completed", retries=0),
        _ev("fault_injected", site="q2", fault_kind="io"),
        _ev("query_span", query="q2", dur_ms=1, status="Failed", retries=0,
            failure_kind=faults.DEVICE_OOM),
    ]
    assert R.failure_kind_from_events(evs) == faults.DEVICE_OOM
    # no failed span: the last injected fault's mapped kind
    assert (
        R.failure_kind_from_events(evs[:2]) == faults.IO_TRANSIENT
    )
    assert R.failure_kind_from_events([]) is None
    # a recorded query failure BEATS a later (recovered) injected fault
    evs2 = [
        _ev("query_span", query="q3", dur_ms=1, status="Failed", retries=0,
            failure_kind=faults.PLANNER),
        _ev("fault_injected", site="q4", fault_kind="io"),
        _ev("query_span", query="q4", dur_ms=1, status="Completed",
            retries=1),
    ]
    assert R.failure_kind_from_events(evs2) == faults.PLANNER


def test_profile_multi_stream_sums_per_query(tmp_path):
    """Profiling several streams' files together (a throughput trace dir)
    must SUM per query name — not mix one stream's wall with all streams'
    operator times — and a single failed run marks the query Failed."""
    d = tmp_path / "tt"
    d.mkdir()
    for app, status, mem in (("s1", "Completed", 500), ("s2", "Failed", 900)):
        _write_jsonl(d / f"events-{app}.jsonl", [
            _ev("op_span", app=app, query="query1", exec_id=1, seq=1,
                depth=0, node="Aggregate", explain="Aggregate",
                dur_ms=100.0, rows=5, est_bytes=40),
            _ev("query_span", app=app, query="query1", dur_ms=120.0,
                status=status, retries=0, mem_hw_bytes=mem,
                mem_source="rss",
                **({"failure_kind": faults.DEVICE_OOM}
                   if status == "Failed" else {})),
        ])
    prof = R.profile_events(R.read_events(str(d)))
    q1 = prof["queries"]["query1"]
    assert q1["runs"] == 2
    assert q1["wall_ms"] == 240.0  # summed across streams
    assert q1["root_incl_ms"] == 200.0  # plan time stays <= wall time
    assert q1["root_incl_ms"] <= q1["wall_ms"]
    assert q1["status"] == "Failed"  # any failed run surfaces
    assert q1["failure_kind"] == faults.DEVICE_OOM
    assert q1["mem_hw_bytes"] == 900  # max, not last-wins


def test_fold_child_streams_emits_summary_and_classifies(tmp_path):
    trace_dir = tmp_path / "trace"
    trace_dir.mkdir()
    pid = 54321
    child = trace_dir / f"events-nds-tpu-{pid}-1-abc.jsonl"
    now_ms = int(time.time() * 1000)
    _write_jsonl(child, [
        _ev("trace_meta", pid=pid, version="0", ts=now_ms,
            trace_id="tp-child-3"),
        _ev("query_span", query="query1", dur_ms=5, status="Completed",
            retries=0),
        _ev("query_span", query="query5", dur_ms=9, status="Failed",
            retries=2, failure_kind=faults.DEVICE_OOM),
    ], torn_tail='{"torn')
    # a leftover file from a RECYCLED pid (same pid, a different minted
    # trace_id, stamped long before this launch): must NOT fold in
    stale = trace_dir / f"events-nds-tpu-{pid}-0-old.jsonl"
    _write_jsonl(stale, [
        _ev("trace_meta", pid=pid, version="0", ts=now_ms - 86_400_000,
            trace_id="tp-dead-run"),
        _ev("query_span", query="query9", dur_ms=1, status="Failed",
            retries=0, failure_kind=faults.TIMEOUT),
    ])

    parent = Tracer()
    kinds = TP._fold_child_streams(
        parent, str(trace_dir), pre_existing=set(),
        launches={3: {"pid": pid, "ts_ms": now_ms - 100,
                      "trace_id": "tp-child-3"}},
    )
    assert kinds == {3: faults.DEVICE_OOM}
    cs = [e for e in parent.events if e["kind"] == "child_stream"]
    assert len(cs) == 1
    assert cs[0]["stream"] == 3
    assert cs[0]["queries"] == 2 and cs[0]["completed"] == 1
    assert cs[0]["failed"] == {"query5": faults.DEVICE_OOM}
    assert cs[0]["child_trace_id"] == "tp-child-3"
    assert R.validate_events(cs) == []


def test_fold_child_streams_pid_fallback_rejects_stale(tmp_path):
    """Pre-context children (no trace_id in the meta line) fold by pid
    PLUS launch-time verification: a recycled pid's leftover file from a
    long-dead process predates the launch record and is rejected."""
    trace_dir = tmp_path / "trace"
    trace_dir.mkdir()
    pid = 777
    now_ms = int(time.time() * 1000)
    fresh = trace_dir / f"events-nds-tpu-{pid}-2-new.jsonl"
    _write_jsonl(fresh, [
        _ev("trace_meta", pid=pid, version="0", ts=now_ms),
        _ev("query_span", query="q", dur_ms=1, status="Failed",
            retries=0, failure_kind=faults.IO_TRANSIENT),
    ])
    stale = trace_dir / f"events-nds-tpu-{pid}-1-old.jsonl"
    _write_jsonl(stale, [
        _ev("trace_meta", pid=pid, version="0", ts=now_ms - 86_400_000),
        _ev("query_span", query="q", dur_ms=1, status="Failed",
            retries=0, failure_kind=faults.TIMEOUT),
    ])
    # a child killed BEFORE its eager meta line landed leaves an empty
    # file: unverifiable, but still this pid's crash evidence — the
    # pid-filename fallback keeps it (only a READABLE mismatching meta
    # rejects)
    empty = trace_dir / f"events-nds-tpu-{pid}-3-empty.jsonl"
    empty.write_text("")
    parent = Tracer()
    kinds = TP._fold_child_streams(
        parent, str(trace_dir), pre_existing=set(),
        launches={1: {"pid": pid, "ts_ms": now_ms - 50}},
    )
    # only the fresh file's events attributed; the stale one never
    # mis-blames (its TIMEOUT kind must not win)
    assert kinds == {1: faults.IO_TRANSIENT}
    cs = [e for e in parent.events if e["kind"] == "child_stream"]
    assert len(cs) == 1
    assert sorted(cs[0]["files"]) == sorted(
        [os.path.basename(str(fresh)), os.path.basename(str(empty))]
    )


def test_phase_failure_classified_from_child_events(tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    trace_dir.mkdir()
    monkeypatch.setenv("NDS_TRACE_DIR", str(trace_dir))
    monkeypatch.setenv("NDS_PHASE_RETRIES", "1")
    monkeypatch.setenv("NDS_PHASE_BACKOFF", "0")
    state = FB.BenchState(str(tmp_path / "state.json"), "fp")
    calls = {"n": 0}

    def phase_fn():
        calls["n"] += 1
        # simulate a child process that wrote events then died opaquely;
        # the child ADOPTS the phase's exported context (trace_meta
        # trace_id), which is what the classifier now verifies against
        _write_jsonl(
            trace_dir / f"events-nds-tpu-99-{calls['n']}-x.jsonl",
            [_ev("trace_meta", pid=99, version="0",
                 ts=int(time.time() * 1000),
                 trace_id=os.environ["NDS_TRACE_CONTEXT"].split(",")[0]),
             _ev("query_span", query="q", dur_ms=1, status="Failed",
                 retries=0, failure_kind=faults.IO_TRANSIENT)],
        )
        if calls["n"] == 1:
            raise subprocess.CalledProcessError(1, ["child"])  # opaque

    tracer = Tracer()
    FB._run_phase(state, "power_test", None, phase_fn, tracer=tracer)
    # opaque exit reclassified io_transient from the child's events -> retried
    assert calls["n"] == 2
    assert state.is_done("power_test")
    ph = [e for e in tracer.events if e["kind"] == "phase"]
    assert [e["event"] for e in ph] == ["begin", "end"]
    assert ph[-1]["status"] == "ok" and ph[-1]["attempts"] == 2
    assert R.validate_events(ph) == []


def test_phase_deterministic_failure_still_fails_fast(tmp_path, monkeypatch):
    monkeypatch.setenv("NDS_PHASE_RETRIES", "3")
    monkeypatch.setenv("NDS_PHASE_BACKOFF", "0")
    state = FB.BenchState(str(tmp_path / "state.json"), "fp")
    calls = {"n": 0}

    def phase_fn():
        calls["n"] += 1
        raise ValueError("ExecError: deterministic")

    tracer = Tracer()
    with pytest.raises(FB.PhaseError):
        FB._run_phase(state, "load_test", None, phase_fn, tracer=tracer)
    assert calls["n"] == 1
    ph = [e for e in tracer.events if e["kind"] == "phase"]
    assert ph[-1]["status"] == "failed"
    assert ph[-1]["failure_kind"] == faults.PLANNER


# ---------------------------------------------------------------------------
# profiler: aggregation + A/B compare + CLI
# ---------------------------------------------------------------------------


def _synthetic_run(tmp_path, name, scale=1.0, fail_q2=False):
    d = tmp_path / name
    d.mkdir()
    spans = [
        _ev("trace_meta", pid=1, version="0"),
        _ev("op_span", query="query1", exec_id=1, seq=1, depth=1,
            node="Scan", explain="Scan t", dur_ms=40 * scale, rows=100,
            est_bytes=800),
        _ev("op_span", query="query1", exec_id=1, seq=2, depth=1,
            node="MultiJoin", explain="MultiJoin", dur_ms=100 * scale,
            rows=50, est_bytes=400),
        _ev("op_span", query="query1", exec_id=1, seq=3, depth=0,
            node="Aggregate", explain="Aggregate", dur_ms=200 * scale,
            rows=5, est_bytes=40),
        _ev("query_span", query="query1", dur_ms=250 * scale,
            status="Completed", retries=0, mem_hw_bytes=1000,
            mem_source="rss"),
        _ev("catalog_load", table="t", columns=2, loaded=2, rows=100,
            dur_ms=3.0, cache="miss"),
        _ev("catalog_load", table="t", columns=2, loaded=0, rows=100,
            dur_ms=0.1, cache="hit"),
        _ev("plan_cache", node="Aggregate", hit=False),
    ]
    if fail_q2:
        spans.append(
            _ev("query_span", query="query2", dur_ms=10, status="Failed",
                retries=1, failure_kind=faults.DEVICE_OOM)
        )
    else:
        spans.append(
            _ev("query_span", query="query2", dur_ms=80, status="Completed",
                retries=0)
        )
    _write_jsonl(d / "events-run.jsonl", spans)
    return d


def test_profile_aggregation_and_exclusive_time(tmp_path):
    d = _synthetic_run(tmp_path, "run")
    prof = R.profile_events(R.read_events(str(d)))
    q1 = prof["queries"]["query1"]
    assert q1["wall_ms"] == 250.0
    assert q1["root_incl_ms"] == 200.0  # root span <= recorded wall
    assert q1["root_incl_ms"] <= q1["wall_ms"]
    # Aggregate exclusive = 200 - (40 + 100) children
    assert q1["ops"]["Aggregate"]["excl_ms"] == pytest.approx(60.0)
    assert q1["ops"]["Scan"]["rows"] == 100
    assert q1["mem_hw_bytes"] == 1000
    assert prof["op_totals"]["MultiJoin"]["excl_ms"] == pytest.approx(100.0)
    t = prof["tallies"]
    assert t["catalog_loads"] == 2 and t["catalog_cache_hits"] == 1
    assert t["plan_cache_misses"] == 1


def test_profile_compare_flags_regressions(tmp_path):
    old = _synthetic_run(tmp_path, "old", scale=1.0)
    new = _synthetic_run(tmp_path, "new", scale=3.0, fail_q2=True)
    regs = R.compare_profiles(
        R.profile_events(R.read_events(str(old))),
        R.profile_events(R.read_events(str(new))),
        ratio=1.25, min_ms=50.0,
    )
    changes = {(r["level"], r.get("node"), r["query"]): r for r in regs}
    assert ("query", None, "query1") in changes
    assert changes[("query", None, "query1")]["ratio"] == pytest.approx(3.0)
    assert ("operator", "Aggregate", "query1") in changes
    q2 = [r for r in regs if r["query"] == "query2"]
    assert q2 and q2[0]["change"] == "status_change"
    # identical runs: clean
    assert R.compare_profiles(
        R.profile_events(R.read_events(str(old))),
        R.profile_events(R.read_events(str(old))),
    ) == []


def test_profile_cli_renders_and_compares(tmp_path, capsys):
    old = _synthetic_run(tmp_path, "old", scale=1.0)
    new = _synthetic_run(tmp_path, "new", scale=3.0)
    profile_cli.main([str(old), "--per_query"])
    out = capsys.readouterr().out
    assert "query1" in out and "Aggregate" in out and "top" in out
    assert "catalog 2 loads (1 cache-hit)" in out
    profile_cli.main(["--compare", str(old), str(new)])
    out = capsys.readouterr().out
    assert "regression" in out and "query1" in out
    with pytest.raises(SystemExit) as exc:
        profile_cli.main([
            "--compare", str(old), str(new), "--fail_on_regression",
        ])
    assert exc.value.code == 1


def test_profile_cli_fails_on_malformed_log(tmp_path, capsys):
    d = tmp_path / "bad"
    d.mkdir()
    (d / "events-x.jsonl").write_text('{"ts": 1}\n{broken}\n{"ts": 2}\n')
    with pytest.raises(SystemExit) as exc:
        profile_cli.main([str(d)])
    assert exc.value.code == 2


def test_profile_cli_check_flags_schema_problems(tmp_path):
    d = tmp_path / "odd"
    d.mkdir()
    _write_jsonl(d / "events-x.jsonl", [_ev("not_a_kind")])
    with pytest.raises(SystemExit) as exc:
        profile_cli.main([str(d), "--check"])
    assert exc.value.code == 2
    profile_cli.main([str(d)])  # without --check: warn only


# ---------------------------------------------------------------------------
# live telemetry: registry, sink, HTTP endpoint
# ---------------------------------------------------------------------------


def test_metrics_registry_counters_gauges_histograms():
    reg = M.MetricsRegistry()
    reg.inc("nds_exec_cache_total", result="hit")
    reg.inc("nds_exec_cache_total", result="hit")
    reg.inc("nds_exec_cache_total", result="miss")
    reg.set_gauge("nds_heartbeat_rss_bytes", 100)
    reg.set_gauge("nds_heartbeat_rss_bytes", 50)  # gauges move both ways
    reg.max_gauge("nds_query_span_mem_hw_bytes", 10)
    reg.max_gauge("nds_query_span_mem_hw_bytes", 5)  # high-water ratchets
    reg.observe("nds_query_span_dur_ms", 3.0)
    reg.observe("nds_query_span_dur_ms", 999999.0)  # lands in +Inf, bounded
    assert reg.counter_value("nds_exec_cache_total", result="hit") == 2
    text = reg.render()
    assert M.validate_exposition(text) == []
    assert 'nds_exec_cache_total{result="hit"} 2' in text
    assert "nds_heartbeat_rss_bytes 50" in text
    assert "nds_query_span_mem_hw_bytes 10" in text
    assert 'nds_query_span_dur_ms_bucket{le="+Inf"} 2' in text
    assert "nds_query_span_dur_ms_count 2" in text
    # free-floating metric names are refused at runtime (lint's belt)
    with pytest.raises(ValueError):
        reg.inc("nds_made_up_total")
    # every registered family name embeds its source event kind
    for name, kind in M.METRIC_KINDS.items():
        assert kind in EVENT_SCHEMA and kind in name


def test_validate_exposition_flags_malformed():
    assert M.validate_exposition("# TYPE a counter\na 1\n") == []
    probs = M.validate_exposition(
        "# TYPE a counter\na{x=unquoted} 1\nb 2\nnot a line\n"
    )
    assert len(probs) == 3  # bad labels, undeclared family, junk line


def test_metrics_sink_records_events_and_status():
    sink = M.MetricsSink()
    sink.query_started("q1", app="app-x")  # _ev events carry app="app-x"
    st = sink.status_snapshot()
    assert st["query"]["query"] == "q1" and st["query"]["attempt"] == 1
    assert st["query"]["elapsed_ms"] >= 0
    sink.record(_ev("ladder_rung", query="q1", rung="recover_retry",
                    failure_kind=faults.DEVICE_OOM))
    sink.record(_ev("heartbeat", query="q1", elapsed_ms=40.0,
                    rss_bytes=2048))
    st = sink.status_snapshot()
    assert st["query"]["attempt"] == 2
    assert st["query"]["ladder"] == ["recover_retry"]
    assert st["rss_bytes"] == 2048
    assert st["heartbeat_age_ms"] is not None
    sink.record(_ev("query_span", query="q1", dur_ms=55.0,
                    status="Completed", retries=1, mem_hw_bytes=9000,
                    mem_source="rss"))
    sink.record(_ev("query_span", query="q2", dur_ms=5.0, status="Failed",
                    retries=0, failure_kind=faults.TIMEOUT))
    sink.record(_ev("exec_cache", pipeline="p", bucket=1024, hit=True))
    sink.record(_ev("exec_cache", pipeline="p", bucket=1024, hit=False))
    sink.record(_ev("phase", phase="power_test", event="begin", index=4,
                    total=8))
    st = sink.status_snapshot()
    assert st["query"] is None  # q1's span retired the in-flight record
    assert st["queries_completed"] == 1 and st["queries_failed"] == 1
    assert st["mem_hw_bytes"] == 9000 and st["mem_source"] == "rss"
    assert st["caches"]["exec_cache"] == {"hits": 1, "total": 2, "rate": 0.5}
    assert st["phase"]["name"] == "power_test" and st["phase"]["index"] == 4
    sink.record(_ev("phase", phase="power_test", event="end", status="ok"))
    st = sink.status_snapshot()
    assert st["phase"] is None
    assert st["last_phase"] == {"name": "power_test", "status": "ok"}
    reg = sink.registry
    assert reg.counter_value("nds_query_span_total", status="Completed") == 1
    assert reg.counter_value("nds_query_span_total", status="Failed") == 1
    assert M.validate_exposition(reg.render()) == []


def test_metrics_sink_in_flight_keyed_per_stream():
    """Thread-mode throughput: two streams running the SAME query name
    concurrently must keep independent in-flight records — one stream's
    finish must not retire (or its rungs mutate) the other's."""
    sink = M.MetricsSink()
    sink.query_started("query5", app="stream-a")
    sink.query_started("query5", app="stream-b")
    sink.record(_ev("ladder_rung", app="stream-b", query="query5",
                    rung="recover_retry", failure_kind=faults.DEVICE_OOM))
    sink.record(_ev("query_span", app="stream-a", query="query5",
                    dur_ms=10.0, status="Completed", retries=0))
    st = sink.status_snapshot()
    assert len(st["in_flight"]) == 1  # only stream-b's run still lives
    assert st["in_flight"][0]["app"] == "stream-b"
    assert st["in_flight"][0]["attempt"] == 2  # b's rung stayed with b
    sink.record(_ev("query_span", app="stream-b", query="query5",
                    dur_ms=20.0, status="Completed", retries=1))
    assert sink.status_snapshot()["in_flight"] == []


def test_metrics_sink_never_raises_on_garbage():
    sink = M.MetricsSink()
    sink.record({"kind": "query_span"})  # all fields missing
    sink.record({"kind": "no_such_kind"})
    sink.record({})
    assert sink.status_snapshot()["queries_completed"] == 1  # status=None != Failed


def test_metrics_server_endpoints():
    from nds_tpu_torch.obs.httpserv import MetricsServer

    sink = M.MetricsSink()
    sink.record(_ev("plan_cache", node="Aggregate", hit=True))
    server = MetricsServer(sink, port=0, host="127.0.0.1").start()
    try:
        body = _scrape(server.port, "/metrics")
        assert M.validate_exposition(body) == []
        assert 'nds_plan_cache_total{result="hit"} 1' in body
        st = json.loads(_scrape(server.port, "/statusz"))
        assert st["caches"]["plan_cache"]["hits"] == 1
        assert _scrape(server.port, "/healthz").strip() == "ok"
        import urllib.error

        with pytest.raises(urllib.error.HTTPError):
            _scrape(server.port, "/nope")
    finally:
        server.stop()


def test_session_metrics_without_trace_dir(monkeypatch, tmp_path):
    """The live-telemetry-only mode: NDS_METRICS_PORT set, no trace dir —
    the session gets a sink-only tracer (no file, no in-memory growth) and
    the shared endpoint serves live counters for its queries."""
    monkeypatch.setenv("NDS_METRICS_PORT", "0")
    s = Session()
    assert s.metrics is not None
    assert s.tracer is not None
    assert s.tracer.path is None and s.tracer.events is None
    s.register_arrow("t", pa.table({"a": [1, 2, 3], "b": [10, 20, 30]}))
    with bind(s.tracer):
        summary = BenchReport(s).report_on(
            lambda: s.sql("select a, sum(b) sb from t group by a").collect(),
            name="q_live",
        )
    assert summary["queryStatus"] == ["Completed"]
    server = M.active_server()
    assert server is not None
    body = _scrape(server.port, "/metrics")
    assert M.validate_exposition(body) == []
    assert 'nds_query_span_total{status="Completed"} 1' in body
    assert "nds_op_span_total" in body
    st = json.loads(_scrape(server.port, "/statusz"))
    assert st["queries_completed"] == 1
    # a second session in the same process reuses the shared sink/server
    s2 = Session()
    assert s2.metrics is s.metrics
    assert M.active_server() is server


def test_metrics_disabled_is_zero_cost(monkeypatch):
    monkeypatch.delenv("NDS_METRICS_PORT", raising=False)
    assert M.resolve_metrics_port({}) is None
    assert M.maybe_serve({}) is None
    # with the flight recorder ALSO off, the historical fully-disabled
    # zero-cost shape holds; by default the tracer is ring-only instead
    monkeypatch.setenv("NDS_FLIGHT_RECORDER", "off")
    assert tracer_from_conf({}) is None
    s = Session()
    assert s.metrics is None and s.tracer is None
    monkeypatch.delenv("NDS_FLIGHT_RECORDER", raising=False)
    s2 = Session()
    assert s2.metrics is None and s2.tracer is not None
    assert s2.tracer.sink is None and s2.tracer.path is None


def test_traced_session_feeds_sink_and_file(monkeypatch, tmp_path):
    """Trace dir AND metrics port: one tracer writes the event file and
    feeds the live registry — the same events, two surfaces."""
    monkeypatch.setenv("NDS_METRICS_PORT", "0")
    s = _traced_session(tmp_path)
    assert s.tracer.sink is s.metrics
    with faults.scope("q_both"):
        s.sql("select a, b from t").collect()
    evs = _events(s.tracer.path)
    n_cat = len([e for e in evs if e["kind"] == "catalog_load"])
    assert n_cat >= 1
    series = s.metrics.registry.counter_series("nds_catalog_load_total")
    assert sum(series.values()) == n_cat


def test_heartbeat_events_from_sampler(tmp_path, monkeypatch):
    monkeypatch.setenv("NDS_HEARTBEAT_INTERVAL_MS", "20")
    monkeypatch.setenv("NDS_TRACE_MEM_INTERVAL_MS", "5")
    s = _traced_session(tmp_path)

    def slow():
        time.sleep(0.15)

    BenchReport(s).report_on(slow, name="q_slow")
    evs = _events(s.tracer.path)
    assert R.validate_events(evs) == []
    hbs = [e for e in evs if e["kind"] == "heartbeat"]
    assert len(hbs) >= 2  # one immediate + periodic beats
    assert all(e["query"] == "q_slow" for e in hbs)
    assert hbs[-1]["elapsed_ms"] > hbs[0]["elapsed_ms"]
    # rss present on Linux (the honest liveness signal for a hang)
    assert hbs[-1]["rss_bytes"] is None or hbs[-1]["rss_bytes"] > 0


# ---------------------------------------------------------------------------
# trace-dir rotation + compaction
# ---------------------------------------------------------------------------


def test_tracer_rotates_segments_and_reader_reassembles(tmp_path):
    tr = Tracer(str(tmp_path), app_id="rot", rotate_bytes=400)
    for i in range(40):
        tr.emit("plan_cache", node=f"n{i:03d}", hit=False)
    tr.close()
    files = R.discover_event_files(str(tmp_path))
    assert len(files) > 2, "rotation must have produced segments"
    assert [R.segment_key(f) for f in files] == sorted(
        R.segment_key(f) for f in files
    )
    # segment 0 keeps the classic name; later segments carry the seq
    assert os.path.basename(files[0]) == "events-rot.jsonl"
    assert os.path.basename(files[1]) == "events-rot.0001.jsonl"
    # every segment under the threshold + one line of slack
    for f in files:
        assert os.path.getsize(f) <= 400 + 200
    # each segment opens with its own trace_meta (independently attributable)
    for f in files:
        first = next(R.iter_events(f, strict=True))
        assert first["kind"] == "trace_meta" and first["app"] == "rot"
    evs = R.read_events(str(tmp_path), strict=True)
    assert R.validate_events(evs) == []
    nodes = [e["node"] for e in evs if e["kind"] == "plan_cache"]
    assert nodes == [f"n{i:03d}" for i in range(40)], (
        "chain reassembly must preserve emission order"
    )


def test_reader_tolerates_torn_tail_of_non_final_segment(tmp_path):
    """Satellite: torn-line classification is PER-SEGMENT. A torn final
    line in a non-final rotated segment (crash evidence) must not
    hard-error strict mode; mid-file corruption still must."""
    _write_jsonl(
        tmp_path / "events-app.jsonl",
        [_ev("trace_meta", pid=1, version="0")],
        torn_tail='{"ts": 3, "ki',
    )
    _write_jsonl(
        tmp_path / "events-app.0001.jsonl",
        [_ev("plan_cache", node="x", hit=True)],
    )
    evs = R.read_events(str(tmp_path), strict=True)
    assert [e["kind"] for e in evs] == ["trace_meta", "plan_cache"]
    # mid-file corruption in any segment is still a hard error
    with open(tmp_path / "events-app.jsonl", "a") as f:
        f.write("\n{broken}\n" + json.dumps(_ev("plan_cache", node="y",
                                                hit=False)) + "\n")
    with pytest.raises(R.MalformedEventError):
        R.read_events(str(tmp_path), strict=True)


def test_concurrent_emit_under_rotation(tmp_path):
    """Satellite: N threads x M events through one rotating tracer — no
    torn/interleaved lines, stable per-thread ordering, exact counts
    after chain reassembly."""
    n_threads, n_events = 8, 150
    tr = Tracer(str(tmp_path), app_id="conc", rotate_bytes=2000)

    def worker(t):
        for i in range(n_events):
            tr.emit("plan_cache", node=f"t{t}:{i:04d}", hit=True)

    threads = [
        threading.Thread(target=worker, args=(t,)) for t in range(n_threads)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tr.close()
    files = R.discover_event_files(str(tmp_path))
    assert len(files) > 2
    evs = R.read_events(str(tmp_path), strict=True)  # no torn/mixed lines
    assert R.validate_events(evs) == []
    pc = [e["node"] for e in evs if e["kind"] == "plan_cache"]
    assert len(pc) == n_threads * n_events
    for t in range(n_threads):
        mine = [n for n in pc if n.startswith(f"t{t}:")]
        assert mine == [f"t{t}:{i:04d}" for i in range(n_events)], (
            f"thread {t}'s events must reassemble in emission order"
        )


def test_tracer_emit_after_close_is_noop(tmp_path, capsys):
    """Satellite: a late emit after close() must not silently reopen the
    file (the old handle leak) — it drops the event with ONE warning."""
    tr = Tracer(str(tmp_path), app_id="late")
    tr.emit("plan_cache", node="a", hit=True)
    tr.close()
    before = open(tr.path).read()
    tr.emit("plan_cache", node="late1", hit=True)
    tr.emit("plan_cache", node="late2", hit=True)
    assert tr._fh is None, "post-close emit must not reopen the file"
    assert open(tr.path).read() == before
    out = capsys.readouterr().out
    assert out.count("after close()") == 1  # one-shot, not per event
    tr.close()  # idempotent


def test_compact_trace_dir_folds_closed_segments(tmp_path):
    tr = Tracer(str(tmp_path), app_id="cmp", rotate_bytes=500)
    for i in range(30):
        tr.emit("op_span", exec_id=1, seq=i + 1, depth=0, node="Scan",
                explain="Scan t", dur_ms=2.0, rows=10, est_bytes=80,
                query="q1")
    tr.emit("query_span", query="q1", dur_ms=99.0, status="Completed",
            retries=0)
    tr.close()
    before = R.load_profile(str(tmp_path))
    n_seg = len(R.discover_event_files(str(tmp_path)))
    assert n_seg > 2
    folded, skipped = R.compact_trace_dir(str(tmp_path))
    assert skipped == []
    assert len(folded) == 1 and len(folded[0][1]) == n_seg - 1
    remaining = R.discover_event_files(str(tmp_path))
    assert len(remaining) == 1  # only the open tail keeps raw spans
    assert R.discover_compact_files(str(tmp_path))
    # disk now bounded: raw spans <= one segment (the rotate threshold)
    raw = sum(os.path.getsize(f) for f in remaining)
    assert raw <= 500 + 200
    after = R.load_profile(str(tmp_path))
    assert after["tallies"] == before["tallies"]
    assert after["queries"]["q1"]["wall_ms"] == before["queries"]["q1"]["wall_ms"]
    assert after["queries"]["q1"]["status"] == "Completed"
    ops_b = before["queries"]["q1"]["ops"]["Scan"]
    ops_a = after["queries"]["q1"]["ops"]["Scan"]
    assert ops_a["count"] == ops_b["count"] == 30
    assert ops_a["incl_ms"] == pytest.approx(ops_b["incl_ms"])
    assert ops_a["rows"] == ops_b["rows"]
    # a second round folds the chain's remaining tail segment and MERGES
    # into the existing artifact (one artifact per app, accumulating)
    folded2, _ = R.compact_trace_dir(str(tmp_path), fold_open=True)
    assert folded2 and len(R.discover_compact_files(str(tmp_path))) == 1
    assert R.discover_event_files(str(tmp_path)) == []
    final = R.load_profile(str(tmp_path))
    assert final["queries"]["q1"]["ops"]["Scan"]["count"] == 30
    assert final["tallies"] == before["tallies"]
    # a later tracer (fresh app id, as default_app_id guarantees) adds its
    # own chain; the dir profile sums across both apps' artifacts
    tr2 = Tracer(str(tmp_path), app_id="cmp2", rotate_bytes=500)
    for i in range(30):
        tr2.emit("op_span", exec_id=2, seq=i + 1, depth=0, node="Scan",
                 explain="Scan t", dur_ms=2.0, rows=10, est_bytes=80,
                 query="q1")
    tr2.close()
    R.compact_trace_dir(str(tmp_path), fold_open=True)
    assert R.discover_event_files(str(tmp_path)) == []
    assert final["queries"]["q1"]["ops"]["Scan"]["count"] == 30
    total = R.load_profile(str(tmp_path))
    assert total["queries"]["q1"]["ops"]["Scan"]["count"] == 60


def test_compact_crash_between_write_and_delete_never_double_counts(
    tmp_path,
):
    """The artifact commits before the raw deletes; a crash in between
    leaves folded segments on disk. The next run must recognize them via
    the artifact's `segments` provenance and finish the delete WITHOUT
    re-merging (and the half-compacted dir must not profile double)."""
    tr = Tracer(str(tmp_path), app_id="crash", rotate_bytes=400)
    for i in range(20):
        tr.emit("plan_cache", node=f"n{i}", hit=True)
    tr.close()
    before = R.load_profile(str(tmp_path))
    folded, _ = R.compact_trace_dir(str(tmp_path), fold_open=True)
    deleted = folded[0][1]
    # simulate the crash: resurrect the folded raw segments post-artifact
    for i, f in enumerate(deleted):
        _write_jsonl(f, [_ev("plan_cache", app="crash", node=f"n{i}",
                             hit=True)])
    # even the half-compacted state profiles ONCE (load_profile drops raw
    # segments named in an artifact's provenance before aggregating)
    half = R.load_profile(str(tmp_path))
    assert half["tallies"]["plan_cache_hits"] == \
        before["tallies"]["plan_cache_hits"]
    folded2, skipped2 = R.compact_trace_dir(str(tmp_path), fold_open=True)
    assert skipped2 == []
    assert sorted(folded2[0][1]) == sorted(deleted)  # delete finished
    assert R.discover_event_files(str(tmp_path)) == []
    after = R.load_profile(str(tmp_path))
    assert after["tallies"]["plan_cache_hits"] == \
        before["tallies"]["plan_cache_hits"] == 20


def test_compact_leaves_corrupt_segments_in_place(tmp_path):
    _write_jsonl(tmp_path / "events-bad.jsonl",
                 [_ev("plan_cache", node="a", hit=True)])
    with open(tmp_path / "events-bad.jsonl", "a") as f:
        f.write("{broken}\n")
        f.write(json.dumps(_ev("plan_cache", node="b", hit=True)) + "\n")
    _write_jsonl(tmp_path / "events-bad.0001.jsonl",
                 [_ev("plan_cache", node="c", hit=True)])
    folded, skipped = R.compact_trace_dir(str(tmp_path), fold_open=True)
    assert len(skipped) == 1 and "events-bad.jsonl" in skipped[0][0]
    assert os.path.exists(tmp_path / "events-bad.jsonl"), (
        "compaction must never delete evidence it could not read"
    )
    assert not os.path.exists(tmp_path / "events-bad.0001.jsonl")


def test_compact_refuses_schema_dirty_segments(tmp_path):
    """`profile --check` must keep its teeth over compacted dirs: a
    segment with schema-breaking events is never absorbed into an
    artifact — it stays raw (where --check flags it) and is reported."""
    _write_jsonl(tmp_path / "events-dirty.jsonl",
                 [_ev("op_span", query="q")])  # missing required fields
    _write_jsonl(tmp_path / "events-dirty.0001.jsonl",
                 [_ev("plan_cache", node="x", hit=True)])
    folded, skipped = R.compact_trace_dir(str(tmp_path), fold_open=True)
    assert len(skipped) == 1 and "schema" in skipped[0][1]
    assert os.path.exists(tmp_path / "events-dirty.jsonl")
    assert not os.path.exists(tmp_path / "events-dirty.0001.jsonl")
    with pytest.raises(SystemExit) as exc:
        profile_cli.main([str(tmp_path), "--check"])
    assert exc.value.code == 2


def test_compact_and_profile_reject_structurally_bad_artifact(tmp_path):
    """An artifact with "profile": null (torn/hand-edited) must fail the
    ValueError path everywhere — never an AttributeError inside merge."""
    (tmp_path / "compact-app.json").write_text(
        json.dumps({"compact": 1, "app": "app", "segments": [],
                    "events": 0, "profile": None})
    )
    with pytest.raises(ValueError):
        R.read_compact(str(tmp_path / "compact-app.json"))
    _write_jsonl(tmp_path / "events-app.jsonl",
                 [_ev("plan_cache", node="a", hit=True)])
    folded, skipped = R.compact_trace_dir(str(tmp_path), fold_open=True)
    assert folded == [] and len(skipped) == 1  # chain skipped, not crashed
    with pytest.raises(SystemExit) as exc:  # CLI: exit 2, not a traceback
        profile_cli.main([str(tmp_path)])
    assert exc.value.code == 2
    # nested damage is caught too (profile.queries value not a mapping)
    (tmp_path / "compact-app.json").write_text(
        json.dumps({"compact": 1, "app": "app", "segments": [],
                    "events": 0, "profile": {"queries": {"q1": "junk"}}})
    )
    with pytest.raises(ValueError):
        R.read_compact(str(tmp_path / "compact-app.json"))


def test_profile_mem_source_tracks_high_water_through_compaction(tmp_path):
    """mem_source must describe the run HOLDING the high-water, and a
    compacted dir must agree with the raw profile on it."""
    tr = Tracer(str(tmp_path), app_id="mem", rotate_bytes=250)
    tr.emit("query_span", query="q1", dur_ms=1.0, status="Completed",
            retries=0, mem_hw_bytes=9000, mem_source="device")
    tr.emit("query_span", query="q1", dur_ms=1.0, status="Completed",
            retries=0, mem_hw_bytes=5000, mem_source="rss")
    tr.close()
    raw = R.load_profile(str(tmp_path))
    assert raw["queries"]["q1"]["mem_hw_bytes"] == 9000
    assert raw["queries"]["q1"]["mem_source"] == "device"
    R.compact_trace_dir(str(tmp_path), fold_open=True)
    compacted = R.load_profile(str(tmp_path))
    assert compacted["queries"]["q1"]["mem_hw_bytes"] == 9000
    assert compacted["queries"]["q1"]["mem_source"] == "device"


def test_compact_skips_chain_with_corrupt_prior_artifact(tmp_path, capsys):
    (tmp_path / "compact-app.json").write_text("{truncated")
    _write_jsonl(tmp_path / "events-app.jsonl",
                 [_ev("plan_cache", node="a", hit=True)])
    _write_jsonl(tmp_path / "events-other.jsonl",
                 [_ev("plan_cache", node="b", hit=True)])
    folded, skipped = R.compact_trace_dir(str(tmp_path), fold_open=True)
    # the bad artifact's chain is skipped (nothing overwritten/deleted)...
    assert len(skipped) == 1 and "compact-app.json" in skipped[0][0]
    assert os.path.exists(tmp_path / "events-app.jsonl")
    # ...while the other app's chain still folds
    assert [app for app, _ in folded] == ["other"]
    assert not os.path.exists(tmp_path / "events-other.jsonl")
    # and the CLI reports + exits nonzero instead of dying with a traceback
    with pytest.raises(SystemExit) as exc:
        profile_cli.main(["compact", str(tmp_path), "--all"])
    assert exc.value.code == 1


def test_profile_cli_compact_subcommand(tmp_path, capsys):
    tr = Tracer(str(tmp_path), app_id="cli", rotate_bytes=300)
    for i in range(25):
        tr.emit("plan_cache", node=f"n{i}", hit=True)
    tr.close()
    profile_cli.main(["compact", str(tmp_path), "--dry_run"])
    out = capsys.readouterr().out
    assert "would fold" in out
    assert len(R.discover_compact_files(str(tmp_path))) == 0
    profile_cli.main(["compact", str(tmp_path)])
    out = capsys.readouterr().out
    assert "folded" in out
    assert len(R.discover_compact_files(str(tmp_path))) == 1
    # the profiler renders a compacted dir transparently
    profile_cli.main([str(tmp_path)])
    out = capsys.readouterr().out
    assert "plan-cache 25 hit" in out




# ---------------------------------------------------------------------------
# the cases of other reference test files that waited for the port's
# tracing (ROADMAP.md item 12a): kernel spans (test_fuse_agg.py), the
# persistent cache's events (test_aotcache.py), the exec-cache events
# (test_fuse.py), the lakehouse events (test_lakehouse_txn.py, both
# packages) and the ingest's (test_layout.py)
# ---------------------------------------------------------------------------


def _kv_table(n, seed=0):
    """tests/test_fuse_agg.py's table."""
    r = np.random.default_rng(seed)
    ks = r.integers(0, 15, n)
    vs = r.integers(-80, 80, n)
    return pa.table({
        "k": pa.array([None if i % 11 == 0 else int(v)
                       for i, v in enumerate(ks)], pa.int32()),
        "v": pa.array([None if i % 7 == 3 else int(v)
                       for i, v in enumerate(vs)], pa.int64()),
    })


def test_kernel_span_schema_and_profiler_aggregation(tmp_path):
    """engine.trace_kernels: the kernel entry points emit schema-valid
    kernel_span events, and the profiler aggregates them into
    kernel_totals (count / dur / rows per kernel)."""
    s = Session(conf={
        "engine.trace_dir": str(tmp_path),
        "engine.trace_kernels": "on",
        "engine.fuse": "off",  # eager path: every kernel call is traced
    })
    assert s.tracer.kernel_spans is True
    s.register_arrow("t", _kv_table(2000))
    with bind(s.tracer):
        s.sql("select k, sum(v) sv, min(v) mn from t where v > 0 "
              "group by k order by k").collect()
    s.tracer.close()
    events = R.read_events([str(tmp_path)], strict=True)
    assert R.validate_events(events) == []
    spans = [e for e in events if e["kind"] == "kernel_span"]
    assert spans, "no kernel_span events recorded"
    for ev in spans:
        assert isinstance(ev["kernel"], str)
        assert isinstance(ev["dur_ms"], (int, float))
        assert isinstance(ev["n"], int)
    kt = R.profile_events(events)["kernel_totals"]
    assert "segment_reduce_with_count" in kt
    for rec in kt.values():
        assert rec["count"] >= 1 and rec["dur_ms"] >= 0.0


def test_kernel_span_off_by_default(tmp_path):
    s = Session(conf={"engine.trace_dir": str(tmp_path),
                      "engine.fuse": "off"})
    assert s.tracer.kernel_spans is False
    s.register_arrow("t", _kv_table(500))
    with bind(s.tracer):
        s.sql("select k, sum(v) sv from t group by k").collect()
    s.tracer.close()
    events = R.read_events([str(tmp_path)], strict=True)
    assert not [e for e in events if e["kind"] == "kernel_span"]


def test_no_kernel_span_from_a_fused_chain(tmp_path):
    """A fused chain's build (the tape recording) and its replays call the
    kernels with no kernel_span: the JAX package's fused executable is one
    call that never enters the decorator. The same statement unfused
    emits the aggregate's spans."""
    q = "select k, sum(v) sv, count(*) c from t where v > 0 group by k"
    spans = {}
    for fuse in ("on", "off"):
        d = tmp_path / fuse
        s = Session(conf={"engine.trace_dir": str(d),
                          "engine.trace_kernels": "on",
                          "engine.plan_cache": "off", "engine.fuse": fuse})
        s.register_arrow("t", _kv_table(2000))
        with bind(s.tracer):
            s.sql(q).collect()  # fused: builds and records the chain
            s.sql(q).collect()  # fused: replays it
        s.tracer.close()
        events = R.read_events([str(d)], strict=True)
        ps = [e for e in events if e["kind"] == "pipeline_span"]
        assert len(ps) == (2 if fuse == "on" else 0)
        assert all(e["fused"] and e["agg"] for e in ps)
        spans[fuse] = collections.Counter(
            e["kernel"] for e in events if e["kind"] == "kernel_span")
    agg = ("direct_gid", "occupancy_map", "segment_reduce",
           "segment_reduce_with_count")
    assert all(spans["off"][k] >= 2 for k in agg), spans
    assert not any(spans["on"][k] for k in agg), spans


def test_executable_reuse_and_trace_events(tmp_path):
    """tests/test_fuse.py's case, its trace half: a miss then a hit in the
    exec_cache events, every pipeline_span fused."""
    s = Session(conf={"engine.trace_dir": str(tmp_path)})
    s.register_arrow("t", _kv_table(2000))
    q = "select k, v + 1 vv from t where v > 0 order by k, vv"
    s.sql(q).collect()
    s.conf["engine.plan_cache"] = "off"
    s.sql(q).collect()
    evs = [json.loads(line) for line in open(s.tracer.path, encoding="utf-8")
           if line.strip()]
    ec = [e for e in evs if e["kind"] == "exec_cache"]
    ps = [e for e in evs if e["kind"] == "pipeline_span"]
    assert ec and ps
    assert ec[0]["hit"] is False and ec[-1]["hit"] is True
    assert all(e["fused"] for e in ps)
    assert all(isinstance(e["bucket"], int) for e in ec)


AOT_QUERY = (
    "select k, sum(v) s, count(*) c from t "
    "where v > -50 group by k order by k"
)


def test_aot_events_ride_the_trace(tmp_path):
    """tests/test_aotcache.py's case: the first session's builds store
    (misses first), a second session over the same cache directory loads
    them from disk (every lookup a disk hit)."""
    def session(trace):
        s = Session(conf={"engine.aot_cache_dir": str(tmp_path / "aot"),
                          "engine.trace_dir": str(trace)})
        s.register_arrow("t", _kv_table(2000))
        return s

    s1 = session(tmp_path / "trace")
    s1.sql(AOT_QUERY).collect()
    s1.tracer.close()
    prof = R.load_profile([str(tmp_path / "trace")], strict=True)
    assert prof["tallies"]["aot_stores"] >= 1
    assert prof["tallies"]["aot_misses"] >= 1
    s2 = session(tmp_path / "trace2")
    s2.sql(AOT_QUERY).collect()
    s2.tracer.close()
    prof2 = R.load_profile([str(tmp_path / "trace2")], strict=True)
    assert prof2["tallies"]["aot_disk_hits"] >= 1
    assert R.aot_disk_hit_rate(prof2) == 1.0


def _lake_pkg(name):
    """(lakehouse table module, trace module, reader, metrics) of one
    package."""
    if name == "jax":
        from nds_tpu.lakehouse import table as T
        from nds_tpu.obs import metrics as MM
        from nds_tpu.obs import reader as RR
        return T, JOT, RR, MM
    from nds_tpu_torch.lakehouse import table as T
    return T, OT, R, M


def _ints(*vals):
    return pa.table({"a": pa.array(list(vals), type=pa.int64())})


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_lake_events_schema_and_metrics(tmp_path, monkeypatch, pkg):
    T, OTm, RR, MM = _lake_pkg(pkg)
    monkeypatch.setenv("NDS_LAKE_COMMIT_BACKOFF", "0")
    lt = T.LakehouseTable.create(str(tmp_path / "t"), _ints(1))
    sink = MM.MetricsSink()
    tracer = OTm.Tracer(sink=sink)
    with OTm.bind(tracer):
        lt.append(_ints(2))
        lt.replace(_ints(3))
        lt.vacuum(retain_last=1)
    kinds = [e["kind"] for e in tracer.events]
    assert kinds.count("lake_commit") == 2
    assert kinds.count("lake_vacuum") == 1
    assert RR.validate_events(tracer.events) == []
    for e in tracer.events:
        for field in EVENT_SCHEMA.get(e["kind"], ()):
            assert field in e
    reg = sink.registry
    assert reg.counter_value(
        "nds_lake_commit_total", operation="append", status="ok") == 1
    assert reg.counter_value(
        "nds_lake_commit_total", operation="overwrite", status="ok") == 1
    assert reg.counter_value("nds_lake_commit_attempts_total") == 2
    assert reg.counter_value("nds_lake_vacuum_total", table="t") == 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_profile_tallies_lake_events(tmp_path, monkeypatch, pkg):
    T, OTm, RR, _ = _lake_pkg(pkg)
    monkeypatch.setenv("NDS_LAKE_COMMIT_BACKOFF", "0")
    path = str(tmp_path / "t")
    lt = T.LakehouseTable.create(path, _ints(1))
    tracer = OTm.Tracer()
    with OTm.bind(tracer):
        lt.append(_ints(2))
        try:
            def clash(name, op, version):
                T._COMMIT_HOOK = None
                T.LakehouseTable(path).append(_ints(7))

            T._COMMIT_HOOK = clash
            lt.replace(_ints(3))
        except T.CommitConflictError:
            pass
        finally:
            T._COMMIT_HOOK = None
        # a successful replace detaches the old files: vacuum has work
        T.LakehouseTable(path).replace(_ints(9))
        lt.vacuum(retain_last=1)
    t = RR.profile_events(tracer.events)["tallies"]
    # create is untraced; append, the clashing append and the last
    # replace succeed
    assert t["lake_commits"] == 3
    assert t["lake_commit_conflicts"] == 1
    assert t["lake_vacuums"] == 1
    assert t["lake_vacuum_files"] >= 1


def test_ingest_emits_ledgered_trace_events(tmp_path):
    from nds_tpu_torch.lakehouse.table import LakehouseTable
    from nds_tpu_torch.schema import get_schemas
    from nds_tpu_torch.transcode import _ingest_chunks

    schema = get_schemas(True)["income_band"]
    src = tmp_path / "raw"
    src.mkdir()
    p = src / "c0.dat"
    p.write_text("".join(f"{sk}|{sk * 10}|{sk * 10 + 9}|\n"
                         for sk in range(5)))
    dst = str(tmp_path / "t")
    LakehouseTable.create(dst, schema=pa.schema(
        [(f.name, f.dtype.to_arrow(True)) for f in schema]))
    tracer = Tracer(None)
    with bind(tracer):
        rows, committed = _ingest_chunks(
            dst, "income_band", schema, True, [str(p)], None)
    assert (rows, committed) == (5, 1)
    evs = [e for e in tracer.events if e["kind"] == "ingest_chunk"]
    assert len(evs) == 1
    ev = evs[0]
    assert ev["table"] == "income_band" and ev["rows"] == 5
    assert ev["chunk"] == "income_band:c0.dat"
    assert not ev["skipped"] and ev["decode_ms"] >= 0


def test_debug_jaxprof_start_stop_writes_a_trace(tmp_path):
    """/debug/jaxprof keeps the reference's route and payload: POST start
    and stop (on two request threads) run one torch.profiler session and
    write its Chrome trace; a second start while one runs is refused, a
    stop with none running too."""
    import urllib.error
    import urllib.request

    from nds_tpu_torch.obs.httpserv import MetricsServer

    def post(port, obj):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/debug/jaxprof",
            data=json.dumps(obj).encode(), method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    server = MetricsServer(M.MetricsSink(), port=0, host="127.0.0.1").start()
    try:
        d = str(tmp_path / "prof")
        assert post(server.port, {"action": "start", "dir": d}) == (
            200, {"running": True, "dir": d})
        assert post(server.port, {"action": "start"})[0] == 409
        assert json.loads(_scrape(server.port, "/debug/jaxprof"))["running"]
        assert post(server.port, {"action": "stop"}) == (
            200, {"running": False, "dir": d})
        assert post(server.port, {"action": "stop"})[0] == 409
        assert post(server.port, {"action": "bogus"})[0] == 400
    finally:
        server.stop()
    trace = json.load(open(os.path.join(d, "trace.json")))
    assert isinstance(trace["traceEvents"], list)
