"""The port's flight recorder and trace context (nds_tpu_torch/obs/flight.py,
trace.py, critpath.py) through the JAX package's own cases,
tests/test_flight.py: the ring is always on (a bundle with no trace dir),
an injected hang (watchdog) and an injected crash each flush a
schema-valid self-contained bundle, concurrent emitters are never blocked
by a flush, trace contexts propagate through the environment and stamp
every event, and the critical-path profiler attributes wall to named
causes. The port's sessions run on the CPU.

Exact: no tolerance is involved."""

import json
import os
import threading
import time

import pyarrow as pa
import pytest

import functools
import gc
import sys

from nds_tpu_torch import faults
from nds_tpu_torch.engine.session import Session as _TorchSession
from nds_tpu_torch.obs import critpath as CP
from nds_tpu_torch.obs import flight as FL
from nds_tpu_torch.obs import metrics as M
from nds_tpu_torch.obs import reader as R
from nds_tpu_torch.obs.trace import (
    TraceContext, Tracer, bind, resolve_trace_context, tracer_from_conf,
)
from nds_tpu_torch.report import BenchReport

sys.path.insert(0, os.path.dirname(__file__))
from torch_join_cases import strict_budget  # noqa: E402,F401

#: the port's sessions run on the CPU here
Session = functools.partial(_TorchSession, device="cpu")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.delenv("NDS_TRACE_DIR", raising=False)
    monkeypatch.delenv("NDS_METRICS_PORT", raising=False)
    monkeypatch.setenv("NDS_METRICS_HOST", "127.0.0.1")
    monkeypatch.delenv("NDS_TRACE_CONTEXT", raising=False)
    monkeypatch.delenv("NDS_FAULT_SPEC", raising=False)
    monkeypatch.delenv("NDS_FLIGHT_RECORDER", raising=False)
    # bundles land in a per-test dir, never the repo cwd
    monkeypatch.setenv("NDS_FLIGHT_DIR", str(tmp_path / "flight"))
    faults.reset()
    FL.reset_shared()
    yield
    faults.reset()
    FL.reset_shared()
    M.reset_shared()


def _session():
    s = Session()
    s.register_arrow(
        "t", pa.table({"a": [1, 2, 3, 4], "b": [10, 20, 30, 40]})
    )
    return s


def _bundles(tmp_path):
    d = tmp_path / "flight"
    if not d.is_dir():
        return []
    return sorted(str(d / f) for f in os.listdir(d)
                  if FL.is_bundle_path(f))


# ---------------------------------------------------------------------------
# trace context
# ---------------------------------------------------------------------------


def test_trace_context_env_roundtrip(monkeypatch):
    ctx = TraceContext.mint("power")
    child = ctx.child("stream3")
    assert child.parent == ctx.trace_id
    env = child.export({})
    monkeypatch.setenv("NDS_TRACE_CONTEXT", env["NDS_TRACE_CONTEXT"])
    adopted = resolve_trace_context("ignored")
    # a launcher-minted context is adopted VERBATIM (fold-by-trace_id
    # requires the parent to know the child's exact id)
    assert adopted.trace_id == child.trace_id
    assert adopted.parent == ctx.trace_id


def test_every_event_carries_the_trace_id(tmp_path):
    tr = tracer_from_conf({"engine.trace_dir": str(tmp_path / "tr")})
    tr.emit("plan_cache", node="Aggregate", hit=False)
    tr.emit("io_retry", path="/x", error="e", delay_s=0.0)
    tr.close()
    evs = R.read_events(tr.path)
    assert len(evs) == 3  # trace_meta + 2
    assert {e["trace_id"] for e in evs} == {tr.context.trace_id}
    assert evs[0]["kind"] == "trace_meta"
    meta = R.trace_meta_of(tr.path)
    assert meta["trace_id"] == tr.context.trace_id


def test_traced_run_is_greppable_by_one_trace_id(tmp_path, monkeypatch):
    """End-to-end: a query's whole event stream — catalog loads, op
    spans, query span — carries exactly ONE trace_id."""
    conf = {"engine.trace_dir": str(tmp_path / "tr")}
    s = Session(conf=conf)
    s.register_arrow("t", pa.table({"a": [1, 2, 2], "b": [5, 6, 7]}))
    with bind(s.tracer), faults.scope("q1"):
        s.sql("select a, sum(b) sb from t group by a").collect()
    s.tracer.close()
    evs = R.read_events(str(tmp_path / "tr"))
    assert {e["kind"] for e in evs} >= {"trace_meta", "op_span",
                                       "catalog_load"}
    assert {e["trace_id"] for e in evs} == {s.tracer.context.trace_id}


# ---------------------------------------------------------------------------
# flight recorder: bundles with NO trace dir configured
# ---------------------------------------------------------------------------


def test_watchdog_fire_flushes_bundle_without_trace_dir(tmp_path,
                                                        monkeypatch):
    s = _session()
    assert s.tracer is not None and s.tracer.path is None  # ring-only
    s.conf["engine.query_timeout"] = 0.3
    faults.install("hang:q_hang:5")

    def hang():
        faults.maybe_fire("q_hang")

    with bind(s.tracer):
        summary = BenchReport(s).report_on(hang, name="q_hang")
    assert summary["queryStatus"] == ["Failed"]
    assert summary["failureKind"] == faults.TIMEOUT
    paths = _bundles(tmp_path)
    assert len(paths) == 1
    b = FL.read_bundle(paths[0])
    assert FL.validate_bundle(b) == []
    assert b["reason"] == "watchdog"
    assert b["query"] == "q_hang"
    assert b["trace_id"] == s.tracer.context.trace_id
    assert os.path.basename(paths[0]) == (
        f"failure-bundle-{b['trace_id']}.json"
    )
    kinds = {e["kind"] for e in b["events"]}
    assert "watchdog_fire" in kinds and "fault_injected" in kinds
    assert isinstance(b["conf"], dict)
    assert b["memory"] is not None and "rss_bytes" in b["memory"]


def test_injected_crash_flushes_bundle_before_dying(tmp_path):
    s = _session()
    faults.install("crash:exec:q_crash")
    with bind(s.tracer), faults.scope("exec:q_crash"):
        with pytest.raises(faults.InjectedCrash):
            faults.maybe_fire("exec:q_crash")
    paths = _bundles(tmp_path)
    assert len(paths) == 1
    b = FL.read_bundle(paths[0])
    assert FL.validate_bundle(b) == []
    assert b["reason"] == "crash"
    # the fault_injected event itself is the ring's crash evidence
    assert any(e["kind"] == "fault_injected" for e in b["events"])


def test_ladder_exhaustion_flushes_bundle_with_history(tmp_path):
    s = _session()
    faults.install("oom:q_oom:99")  # OOMs forever: ladder exhausts

    def boom():
        faults.maybe_fire("q_oom")

    with bind(s.tracer):
        summary = BenchReport(s).report_on(boom, retry_oom=True,
                                           name="q_oom")
    assert summary["queryStatus"] == ["Failed"]
    paths = _bundles(tmp_path)
    assert len(paths) == 1
    b = FL.read_bundle(paths[0])
    assert FL.validate_bundle(b) == []
    assert b["reason"] == "ladder_exhausted"
    assert [r["rung"] for r in b["ladder"]] == [
        r["rung"] for r in summary["ladder"]
    ]
    assert len(b["ladder"]) >= 1
    # rung events in the ring carry the failed attempt's wall
    rungs = [e for e in b["events"] if e["kind"] == "ladder_rung"]
    assert rungs and all("attempt_ms" in e for e in rungs)


def test_ring_is_bounded_and_plan_notes_windowed(monkeypatch):
    monkeypatch.setenv("NDS_FLIGHT_RING_EVENTS", "32")
    FL.reset_shared()
    rec = FL.recorder()
    assert rec.capacity == 32
    tr = Tracer()  # in-memory + ring
    for i in range(100):
        tr.emit("plan_cache", node="Aggregate", hit=False)
    assert len(rec.snapshot()) == 32
    assert rec.events_recorded == 100
    for i in range(20):
        rec.note_plan(f"q{i}", f"explain {i}")
    assert rec.plan_for("q19") == "explain 19"
    assert rec.plan_for("q0") is None  # windowed out


def test_concurrent_emitters_never_block_on_flush(tmp_path, monkeypatch):
    """N threads emit through the ring while a crash-triggered flush
    snapshots it: the bundle is valid JSON, carries the failing query's
    last events AND every live thread's recent events, and emitters are
    never blocked by the flush (they keep completing against a
    deadline)."""
    monkeypatch.setenv("NDS_FLIGHT_RING_EVENTS", "8192")
    FL.reset_shared()
    s = _session()
    n_threads = 6
    per_thread = 400
    done = []

    def emitter(tid):
        tr = tracer_from_conf({})  # ring-only, own app id
        with bind(tr):
            for _ in range(per_thread):
                tr.emit(
                    "plan_cache", node=f"N{tid}", hit=False,
                    query=f"bg{tid}",
                )
        done.append(tid)

    threads = [
        threading.Thread(target=emitter, args=(t,)) for t in range(n_threads)
    ]
    # the crash (and its flush) races the emitters on another thread
    def crasher():
        time.sleep(0.001)
        faults.install("crash:exec:fg")
        with bind(s.tracer), faults.scope("exec:fg"):
            try:
                faults.maybe_fire("exec:fg")
            except faults.InjectedCrash:
                done.append(-1)

    ct = threading.Thread(target=crasher)
    for t in threads:
        t.start()
    ct.start()
    deadline = time.monotonic() + 20
    for t in threads + [ct]:
        t.join(timeout=max(deadline - time.monotonic(), 0.1))
    assert sorted(d for d in done if d >= 0) == list(range(n_threads)), (
        "emitter threads starved — the ring (or the flush) blocked them"
    )
    assert -1 in done
    paths = _bundles(tmp_path)
    assert len(paths) == 1
    with open(paths[0]) as f:
        b = json.load(f)  # schema-valid JSON despite racing emitters
    assert FL.validate_bundle(b) == []
    queries = {e.get("query") for e in b["events"]}
    # the crash evidence is in the ring...
    assert any(e["kind"] == "fault_injected" for e in b["events"])
    # ...and at the 8192-event capacity every thread's events survived;
    # run the foreground crash again AFTER all emits to also assert the
    # post-quiescence view (flush during the race may predate laggards)
    rec = FL.recorder()
    b2 = rec.bundle("on_demand")
    q2 = {e.get("query") for e in b2["events"]}
    for t in range(n_threads):
        assert f"bg{t}" in q2, f"thread {t}'s events missing from ring"


def test_debug_flight_endpoint_on_shared_listener(monkeypatch, tmp_path):
    import urllib.request

    monkeypatch.setenv("NDS_METRICS_PORT", "0")
    s = _session()
    server = M.active_server()
    assert server is not None
    with bind(s.tracer), faults.scope("q_live"):
        s.sql("select a from t").collect()

    def get(path):
        with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}{path}", timeout=5
        ) as r:
            return json.loads(r.read().decode())

    b = get("/debug/flight")
    assert b["bundle"] == 1 and b["reason"] == "on_demand"
    assert any(e["kind"] == "op_span" for e in b["events"])
    assert FL.validate_bundle(b) == []
    # ?write=1 persists it
    b2 = get("/debug/flight?write=1")
    assert b2["written"] and os.path.exists(b2["written"])
    # jaxprof status answers (start/stop exercised in the serve suite to
    # avoid a process-wide profiler session in the unit tier)
    st = get("/debug/jaxprof")
    assert st["running"] is False


def test_statusz_mesh_section(monkeypatch):
    sink = M.MetricsSink()
    sink.record({
        "ts": 1, "kind": "exchange", "app": "a", "op": "join",
        "partitions": 8, "bytes_moved": 4096, "skew": 2.5, "retries": 1,
        "per_device": [10, 10, 500, 10, 10, 10, 10, 10],
    })
    sink.record({
        "ts": 2, "kind": "heartbeat", "app": "a", "query": "q",
        "elapsed_ms": 5.0, "rss_bytes": 100,
        "dev_bytes": [1000, 2000, 9000, 1000],
    })
    sink.record({
        "ts": 3, "kind": "heartbeat", "app": "a", "query": "q",
        "elapsed_ms": 6.0, "rss_bytes": 100,
        "dev_bytes": [2000, 1000, 3000, 1000],
    })
    st = sink.status_snapshot()
    mesh = st["mesh"]
    assert mesh["last_exchange"]["skew"] == 2.5
    assert mesh["last_exchange"]["bytes_moved"] == 4096
    assert mesh["last_exchange"]["per_device"][2] == 500
    # per-device high-water max-merges across samples
    assert mesh["device_mem_hw"] == [2000, 2000, 9000, 1000]


# ---------------------------------------------------------------------------
# critical-path attribution
# ---------------------------------------------------------------------------


def _ev(kind, **kw):
    base = {"ts": 1, "kind": kind, "app": "a", "trace_id": "t1"}
    base.update(kw)
    return base


def test_critical_path_attributes_causes_and_names_straggler():
    events = [
        _ev("query_span", query="q1", dur_ms=1000.0, status="Completed",
            retries=1),
        _ev("op_span", query="q1", exec_id=1, seq=1, depth=1, node="Scan",
            explain="Scan t", dur_ms=200.0, rows=10, est_bytes=80),
        _ev("op_span", query="q1", exec_id=1, seq=2, depth=0,
            node="MultiJoin", explain="join", dur_ms=700.0, rows=5,
            est_bytes=40),
        _ev("exchange", query="q1", op="join", partitions=4,
            bytes_moved=1 << 20, skew=2.0, retries=0, dur_ms=300.0,
            per_device=[10, 10, 10, 400]),
        _ev("catalog_load", query="q1", table="t", columns=2, loaded=2,
            rows=10, dur_ms=50.0, cache="miss"),
        _ev("ladder_rung", query="q1", rung="recover_retry",
            failure_kind="device_oom", attempt_ms=100.0),
    ]
    cp = CP.critical_path(events)
    q = cp["queries"]["q1"]
    c = q["causes"]
    assert c["exchange-wait"] == 300.0
    assert c["catalog-load"] == 50.0
    assert c["ladder-retry"] == 100.0
    # execute = root incl (700) - exchange (300) - catalog (50)
    assert c["execute"] == 350.0
    # residual (wall 1000 - measured 800) lands in plan-host
    assert c["plan-host"] == 200.0
    assert q["attributed_frac"] == 1.0
    # chain walks root -> heaviest child
    assert [h["node"] for h in q["chain"]] == ["MultiJoin", "Scan"]
    # straggler: device 3 received 400 of 430 rows
    assert q["exchange"]["straggler_device"] == 3
    assert q["exchange"]["skew_ms"] == pytest.approx(150.0)  # 300*(1-1/2)
    assert cp["mesh"]["straggler_device"] == 3
    assert cp["mesh"]["skew_share"] == pytest.approx(0.5)


def test_critical_path_attributes_watchdog_hang():
    """A terminal watchdog failure: the hang budget is the dominant
    cause, capped only by what the OTHER measured causes leave of the
    wall (regression: an earlier cut subtracted hung time twice and left
    a fully-explained hang 'unattributed')."""
    events = [
        _ev("query_span", query="qh", dur_ms=2150.0, status="Failed",
            retries=0, failure_kind="timeout"),
        _ev("op_span", query="qh", exec_id=1, seq=1, depth=0, node="Scan",
            explain="s", dur_ms=100.0, rows=1, est_bytes=8),
        _ev("watchdog_fire", query="qh", budget_s=2.0),
    ]
    cp = CP.critical_path(events)
    q = cp["queries"]["qh"]
    assert q["causes"]["hung-wait"] == 2000.0
    assert q["causes"]["execute"] == 100.0
    assert q["attributed_frac"] >= 0.97


def test_critical_path_honest_about_missing_evidence():
    # a query with a wall but almost no spans: the residual majority must
    # NOT be laundered into plan-host
    events = [
        _ev("query_span", query="q2", dur_ms=1000.0, status="Completed",
            retries=0),
        _ev("op_span", query="q2", exec_id=1, seq=1, depth=0, node="Scan",
            explain="s", dur_ms=100.0, rows=1, est_bytes=8),
    ]
    cp = CP.critical_path(events)
    q = cp["queries"]["q2"]
    assert q["causes"]["plan-host"] == 0.0
    assert q["unattributed_ms"] == 900.0
    assert q["attributed_frac"] == pytest.approx(0.1)
    assert CP.min_attributed_frac(cp) == pytest.approx(0.1)


def test_profile_cli_critical_path_and_bundle_check(tmp_path, capsys):
    from nds_tpu_torch.cli import profile as profile_cli

    trace = tmp_path / "tr"
    s = Session(conf={"engine.trace_dir": str(trace)})
    s.register_arrow("t", pa.table({"a": [1, 2, 2], "b": [3, 4, 5]}))
    def run():
        # the harness always scopes queries (power.run_one_query); the
        # scope is what keys op spans to the query for attribution
        with faults.scope("q_cp"):
            s.sql("select a, sum(b) sb from t group by a").collect()

    # the port runs this 3-row query in a few ms on the CPU, so one pause
    # of the cyclic collector over the earlier tests' garbage outlasts it
    # and the residual turns the majority: collect before, not during
    gc.collect()
    with bind(s.tracer):
        BenchReport(s).report_on(run, name="q_cp")
    s.tracer.close()
    profile_cli.main([str(trace), "--critical-path",
                      "--min_attributed", "0.9"])
    out = capsys.readouterr().out
    assert "critical path" in out and "q_cp" in out
    assert "execute" in out
    # bundle validation through the same CLI
    rec = FL.recorder()
    path = rec.flush("on_demand", trace_id="cli-test",
                     out_dir=str(tmp_path / "fl"))
    profile_cli.main([path, "--check"])
    out = capsys.readouterr().out
    assert "bundle" in out and "cli-test" in out
    # a truncated bundle fails --check with exit 2
    bad = tmp_path / "fl" / "failure-bundle-bad.json"
    bad.write_text(json.dumps({"bundle": 1, "events": "nope"}))
    with pytest.raises(SystemExit) as exc:
        profile_cli.main([str(bad), "--check"])
    assert exc.value.code == 2
