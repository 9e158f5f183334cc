"""The port's query service (nds_tpu_torch/serve/service.py, jobs.py) against
the JAX package's (nds_tpu/serve/), through the cases of
tests/test_serve.py: admission by the budgeter's verdict, backpressure,
drain, snapshot-pinned requests under racing commits, the writer path,
per-tenant accounting, the fault sites, stream jobs and /reload.

Each case runs through both packages behind a real HTTP listener (the
process-wide obs/httpserv.py endpoint) over the same seeded numpy data,
and the port's answers are held to the reference's: status codes,
envelope keys, verdicts, rows, /statusz counters and the `nds_serve_*`
metric families. The port's sessions run on the CPU.

Tolerance: status codes, keys, verdicts, integers and strings exact;
floats within nds_tpu/validate.py compare's relative epsilon, 1e-5
(torch_serve_cases.EPS)."""

import json
import os
import socket
import sys
import threading
import time

import pyarrow as pa
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from torch_join_cases import strict_budget  # noqa: E402,F401
from torch_serve_cases import (  # noqa: E402,F401
    FQUERY, JAX, PKGS, QUERY, TORCH, assert_same_answer,
    assert_same_answers, env, get, mini_lake, post, same_value,
    wait_hang_fired,
)


def _per_pkg(fn):
    """{package name: fn(P)} for both packages, the reference first."""
    return {P.name: fn(P) for P in PKGS}


# ---------------------------------------------------------------------------
# request round trip, pagination, templates
# ---------------------------------------------------------------------------


def test_query_roundtrip_and_pagination(env):
    def run(P):
        service, port, _ = env.service(P, conf={"engine.serve_row_cap": 3})
        out = [post(port, {"sql": QUERY}),
               post(port, {"sql": QUERY, "offset": 3, "limit": 3}),
               post(port, {"sql": QUERY, "offset": 6, "limit": 3}),
               post(port, {"sql": QUERY, "limit": 0}),
               post(port, {"sql": FQUERY})]
        status, body, _ = out[0]
        assert status == 200 and body["status"] == "completed"
        assert body["columns"] == ["k", "c", "s"]
        assert body["row_count"] == 3 and body["total_rows"] == 8
        assert body["truncated"] is True
        assert body["verdict"] in ("direct", "unknown")
        assert body["admitted_degraded"] is False and body["request_id"]
        assert [r[0] for r in out[1][1]["rows"]] == [3, 4, 5]
        assert out[2][1]["row_count"] == 2
        assert out[2][1]["truncated"] is False
        meta = out[3][1]
        assert meta["rows"] == [] and meta["row_count"] == 0
        assert meta["total_rows"] == 8 and meta["truncated"] is True
        # every float of the envelope is a float64's JSON
        assert all(isinstance(x, float) for r in out[4][1]["rows"]
                   for x in r[1:])
        service.close()
        return out

    assert_same_answers(_per_pkg(run))


def test_template_resolution_and_errors(env):
    def run(P):
        service, port, _ = env.service(
            P, templates={"q_k": "select k from fact where k = ${K} limit 1"})
        out = [post(port, {"template": "q_k", "params": {"K": 3}}),
               post(port, {"template": "nope"}),
               post(port, {}),
               post(port, {"sql": "select 1 from fact; select 2 from fact"}),
               post(port, {"sql": "create temp view z as select k from fact"})]
        assert out[0][0] == 200 and out[0][1]["rows"] == [[3]]
        assert out[1][0] == 404
        assert out[2][0] == 400 and "sql" in out[2][1]["error"]
        assert out[3][0] == 400
        assert out[4][0] == 400 and "serve mode" in out[4][1]["error"]
        service.close()
        return out

    out = _per_pkg(run)
    assert_same_answers(out)
    # the refusals say the same thing
    for a, b in zip(out["jax"][1:], out["torch"][1:]):
        assert a[1]["error"] == b[1]["error"]


def test_unknown_route_404_and_parse_error_400(env):
    def run(P):
        service, port, _ = env.service(P)
        out = [post(port, {}, path="/nope")[0],
               post(port, {"sql": "selec k frm fact"})[0]]
        assert out == [404, 400]
        service.close()
        return out

    out = _per_pkg(run)
    assert out["jax"] == out["torch"]


# ---------------------------------------------------------------------------
# admission control (the budgeter verdict contract)
# ---------------------------------------------------------------------------


def test_admission_reject_429_carries_modeled_bytes(env):
    def run(P):
        service, port, _ = env.service(P, conf={
            "engine.plan_budget_bytes": 1024,
            "engine.plan_budget_reject_bytes": 2048,
        }, rows=1 << 16)
        out = [post(port, {"sql": "select k + v from fact"})]
        status, body, _ = out[0]
        assert status == 429
        assert body["status"] == "rejected" and body["verdict"] == "reject"
        assert body["peak_bytes"] > 2048 and body["budget_bytes"] == 1024
        # never admitted: no slot was taken
        assert service.in_flight() == 0
        service.close()
        return out

    assert_same_answers(_per_pkg(run))


def test_degraded_admit_echoes_verdict_in_envelope(env):
    def run(P):
        service, port, _ = env.service(P, conf={
            "engine.plan_budget_bytes": 1024,
            "engine.serve_row_cap": 1 << 17,
        }, rows=1 << 12)
        out = [post(port, {"sql": "select k, v from fact order by v desc"})]
        status, body, _ = out[0]
        assert status == 200
        assert body["verdict"] in ("spill", "over", "blocked")
        assert body["admitted_degraded"] is True
        assert body["rows"][0][1] == (1 << 12) - 1
        service.close()
        return out

    assert_same_answers(_per_pkg(run))


def test_backpressure_sheds_with_retry_after(env):
    def run(P):
        service, port, _ = env.service(
            P, conf={"engine.host_rss_watermark": 1})
        out = [post(port, {"sql": QUERY})]
        status, body, headers = out[0]
        assert status == 429 and body["status"] == "shed"
        assert "watermark" in body["error"] and headers.get("Retry-After")
        service.close()
        return out

    assert_same_answers(_per_pkg(run))


def test_capacity_shed_and_tenant_flood_cap(env):
    def run(P):
        service, port, _ = env.service(P, conf={
            "engine.serve_workers": 2,
            "engine.serve_tenant_cap": 1,
            "engine.serve_admit_timeout_s": 0.05,
        })
        out = []
        service._enter("tenant-a")
        try:
            out.append(post(port, {"sql": QUERY}, tenant="tenant-a"))
            out.append(post(port, {"sql": QUERY}, tenant="tenant-b"))
        finally:
            service._leave("tenant-a")
        service._enter("x")
        service._enter("y")
        try:
            out.append(post(port, {"sql": QUERY}, tenant="tenant-c"))
        finally:
            service._leave("x")
            service._leave("y")
        out.append(post(port, {"sql": QUERY}, tenant="tenant-c"))
        (s0, b0, h0), (s1, _, _), (s2, b2, _), (s3, _, _) = out
        assert s0 == 429 and b0["status"] == "shed"
        assert "cap" in b0["error"] and h0.get("Retry-After")
        assert s1 == 200
        assert s2 == 429 and "admission slot" in b2["error"]
        assert s3 == 200
        service.close()
        return out

    assert_same_answers(_per_pkg(run))


# ---------------------------------------------------------------------------
# drain + healthz
# ---------------------------------------------------------------------------


def test_drain_completes_in_flight_then_refuses(env):
    def run(P):
        service, port, _ = env.service(
            P, conf={"engine.serve_drain_timeout_s": 10})
        assert get(port, "/healthz") == (200, "ok\n")
        service._enter("t")  # simulated in-flight work
        box = {}
        t = threading.Thread(
            target=lambda: box.update(resp=post(port, {}, path="/drain")),
            daemon=True)
        t.start()
        deadline = time.monotonic() + 5
        while get(port, "/healthz")[0] != 503 and (
                time.monotonic() < deadline):
            time.sleep(0.02)
        code, text = get(port, "/healthz")
        assert code == 503 and "draining" in text
        assert not box  # still waiting on the in-flight slot
        service._leave("t")
        t.join(20)
        status, body, _ = box["resp"]
        assert status == 200 and body["drained"] is True
        assert body["in_flight"] == 0
        after = post(port, {"sql": QUERY})
        assert after[0] == 503 and after[1]["status"] == "draining"
        assert after[2].get("Retry-After")
        service.close()
        return [box["resp"], after]

    assert_same_answers(_per_pkg(run))


def test_request_queued_before_drain_sheds_after_semaphore_wait(env):
    def run(P):
        service, port, _ = env.service(P, conf={
            "engine.serve_workers": 1,
            "engine.serve_admit_timeout_s": 20,
            "engine.serve_drain_timeout_s": 10,
        })
        service._enter("holder")  # occupy the only slot
        box, drain_box = {}, {}
        t = threading.Thread(target=lambda: box.update(
            resp=post(port, {"sql": QUERY}, tenant="queued")), daemon=True)
        t.start()
        time.sleep(0.3)  # the request waits on the semaphore
        dt = threading.Thread(target=lambda: drain_box.update(
            r=post(port, {}, path="/drain")), daemon=True)
        dt.start()
        time.sleep(0.3)
        service._leave("holder")  # the queued request takes the slot
        t.join(30)
        dt.join(30)
        status, body, headers = box["resp"]
        assert status == 503 and body["status"] == "draining"
        assert headers.get("Retry-After")
        assert drain_box["r"][0] == 200 and drain_box["r"][1]["drained"]
        service.close()
        return [box["resp"], drain_box["r"]]

    assert_same_answers(_per_pkg(run))


# ---------------------------------------------------------------------------
# snapshot isolation vs racing commits; the writer path
# ---------------------------------------------------------------------------


def test_snapshot_pinned_request_vs_racing_dm_commit(env, tmp_path):
    q = "select k, count(*) c, sum(v) s from fact group by k order by k"

    def run(P):
        path = mini_lake(P, tmp_path)
        service, port, _ = env.service(P, lake_path=path)
        baseline = post(port, {"sql": q})
        assert baseline[0] == 200
        commits = []
        P.T._COMMIT_HOOK = lambda name, op, version: commits.append(
            (name, op, version, time.monotonic()))
        P.faults.install("hang:serve:exec:2")
        box = {}

        def request():
            box["t_planned"] = time.monotonic()
            box["resp"] = post(port, {"sql": q})
            box["t_done"] = time.monotonic()

        try:
            t = threading.Thread(target=request, daemon=True)
            t.start()
            wait_hang_fired(P)  # inside the 2 s serve:exec hang: pinned
            P.T.LakehouseTable(path).append(pa.table({
                "k": pa.array([0], type=pa.int64()),
                "v": pa.array([100_000], type=pa.int64()),
                "f": pa.array([0.5], type=pa.float64()),
            }))
            t.join(30)
        finally:
            P.T._COMMIT_HOOK = None
        status, body, _ = box["resp"]
        assert status == 200
        assert commits and commits[0][1] == "append"
        assert box["t_planned"] < commits[0][3] < box["t_done"]
        # the pinned snapshot's answer, equal to the baseline
        assert body["rows"] == baseline[1]["rows"]
        after = post(port, {"sql": q})
        assert after[0] == 200 and after[1]["rows"] != baseline[1]["rows"]
        service.close()
        return [baseline, box["resp"], after]

    assert_same_answers(_per_pkg(run))


def test_dml_commits_through_writer_path(env, tmp_path):
    def run(P):
        path = mini_lake(P, tmp_path, rows=8)
        service, port, _ = env.service(P, lake_path=path)
        before = post(port, {"sql": "select count(*) c from fact"})
        dml = post(port, {
            "sql": "insert into fact select k, v + 1000, f from fact "
                   "where v < 8"}, tenant="writer")
        after = post(port, {"sql": "select count(*) c from fact"})
        status, body, _ = dml
        assert status == 200
        assert body["status"] == "completed" and body["statement"] == "dml"
        assert body["rows_affected"] == 8 and body["version"] == 2
        assert after[1]["rows"][0][0] == before[1]["rows"][0][0] + 8
        service.close()
        return [before, dml, after]

    assert_same_answers(_per_pkg(run))


def test_serve_request_traceable_by_single_trace_id(env, tmp_path):
    q = "select k, sum(v) s from fact group by k order by k"

    def run(P):
        path = mini_lake(P, tmp_path)
        trace = tmp_path / P.name / "trace"
        service, port, _ = env.service(
            P, conf={"engine.trace_dir": str(trace)}, lake_path=path)
        P.faults.install("oom:serve:exec")  # one rung of ladder evidence
        sel = post(port, {"sql": q})
        assert sel[0] == 200 and sel[1]["retries"] == 1
        rid = sel[1]["request_id"]
        dm = post(port, {
            "sql": "insert into fact select k, v + 500, f from fact "
                   "where v < 4"}, tenant="writer")
        assert dm[0] == 200
        rid_dm = dm[1]["request_id"]
        evs = P.R.read_events(str(trace), strict=True)
        assert P.R.validate_events(evs) == []
        mine = [e for e in evs
                if e.get("request_id") == rid or e.get("trace_id") == rid]
        kinds = {e["kind"] for e in mine}
        assert {"serve_request", "op_span", "catalog_load", "query_span",
                "ladder_rung", "fault_injected"} <= kinds
        assert {e["trace_id"] for e in mine} == {rid}
        dm_evs = [e for e in evs if e.get("trace_id") == rid_dm]
        assert {"serve_request", "lake_commit", "query_span"} <= {
            e["kind"] for e in dm_evs}
        assert {e["trace_id"] for e in dm_evs} == {rid_dm}
        assert rid != rid_dm
        service.close()
        return [sel, dm], {e["kind"] for e in dm_evs}

    out = _per_pkg(run)
    assert_same_answers({k: v[0] for k, v in out.items()})
    assert out["jax"][1] == out["torch"][1]


def test_debug_jaxprof_start_stop_on_live_service(env, tmp_path):
    """The profiler verbs on the live listener (the port's route keeps the
    reference's name and runs torch.profiler); queries keep answering."""
    import glob as _glob

    def run(P):
        service, port, _ = env.service(P)
        prof_dir = str(tmp_path / P.name / "prof")
        start = post(port, {"action": "start", "dir": prof_dir},
                     path="/debug/jaxprof")
        assert start[0] == 200 and start[1]["running"]
        assert start[1]["dir"] == prof_dir
        again = post(port, {"action": "start"}, path="/debug/jaxprof")
        assert again[0] == 409
        q = post(port, {"sql": "select count(*) c from fact"})
        assert q[0] == 200
        stop = post(port, {"action": "stop"}, path="/debug/jaxprof")
        assert stop[0] == 200 and stop[1]["running"] is False
        assert _glob.glob(os.path.join(prof_dir, "**", "*"), recursive=True)
        bogus = post(port, {"action": "bogus"}, path="/debug/jaxprof")
        assert bogus[0] == 400
        service.close()
        return [x[0] for x in (start, again, q, stop, bogus)], q

    out = _per_pkg(run)
    assert out["jax"][0] == out["torch"][0]
    assert_same_answer(out["jax"][1], out["torch"][1])


# ---------------------------------------------------------------------------
# fault family: the server survives what its requests do not
# ---------------------------------------------------------------------------


def test_serve_exec_oom_walks_ladder_and_pool_stays_healthy(env):
    def run(P):
        service, port, _ = env.service(P)
        P.faults.install("oom:serve:exec:1")
        first = post(port, {"sql": QUERY})
        assert first[0] == 200 and first[1]["status"] == "completed"
        assert first[1]["retries"] >= 1
        assert service.in_flight() == 0
        second = post(port, {"sql": QUERY})
        assert second[0] == 200
        service.close()
        return [first, second]

    assert_same_answers(_per_pkg(run))


def test_serve_admit_fault_sheds_not_crashes(env):
    def run(P):
        service, port, _ = env.service(P)
        P.faults.install("io:serve:admit:1")
        shed = post(port, {"sql": QUERY})
        assert shed[0] == 429 and shed[1]["status"] == "shed"
        assert shed[1]["failure_kind"] == P.faults.IO_TRANSIENT
        ok = post(port, {"sql": QUERY})
        assert ok[0] == 200
        service.close()
        return [shed, ok]

    assert_same_answers(_per_pkg(run))


def test_disconnect_mid_query_leaves_worker_pool_healthy(env):
    def run(P):
        service, port, _ = env.service(P)
        payload = json.dumps({"sql": QUERY}).encode()
        request = (
            b"POST /query HTTP/1.1\r\nHost: x\r\n"
            b"Content-Type: application/json\r\n"
            b"Content-Length: " + str(len(payload)).encode() + b"\r\n\r\n"
            + payload
        )
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(request)
        s.close()  # hang up before the reply
        deadline = time.monotonic() + 30
        while service.in_flight() > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert service.in_flight() == 0
        ok = post(port, {"sql": QUERY})
        assert ok[0] == 200 and ok[1]["status"] == "completed"
        service.close()
        return [ok]

    assert_same_answers(_per_pkg(run))


# ---------------------------------------------------------------------------
# per-tenant accounting + per-request in-flight isolation
# ---------------------------------------------------------------------------

#: /statusz tenant counters that both packages count alike
TENANT_COUNTS = ("requests", "completed", "failed", "rejected", "shed",
                 "draining", "degraded", "rows", "exec_cache_lookups",
                 "plan_cache_lookups")


def test_per_tenant_stats_on_statusz_and_metrics(env):
    def run(P):
        service, port, _ = env.service(P)
        for _ in range(2):
            post(port, {"sql": QUERY}, tenant="alpha")
        post(port, {"sql": QUERY}, tenant="beta")
        post(port, {"sql": "selec nope"}, tenant="beta")  # 400 -> failed
        tenants = json.loads(get(port, "/statusz")[1])["tenants"]
        assert tenants["alpha"]["requests"] == 2
        assert tenants["alpha"]["completed"] == 2
        assert tenants["beta"]["requests"] == 2
        assert tenants["beta"]["failed"] == 1
        assert tenants["alpha"]["exec_cache_lookups"] > 0
        assert tenants["alpha"]["exec_cache_hit_rate"] is not None
        _, exposition = get(port, "/metrics")
        assert P.M.validate_exposition(exposition) == []
        assert ('nds_serve_request_total{status="completed",'
                'tenant="alpha"} 2') in exposition
        assert "nds_serve_request_dur_ms_bucket" in exposition
        families = sorted({
            line.split("{")[0].split(" ")[0]
            for line in exposition.splitlines()
            if line.startswith("nds_serve_")})
        series = P.M.shared_sink().registry.counter_series(
            "nds_serve_request_total")
        service.close()
        return ({t: {k: rec.get(k) for k in TENANT_COUNTS}
                 for t, rec in tenants.items()}, families, series)

    out = _per_pkg(run)
    assert out["jax"] == out["torch"]


def test_in_flight_records_keyed_per_request_id():
    def run(P):
        sink = P.M.MetricsSink()
        sink.query_started("query3", app="app-1", request_id="r1")
        sink.query_started("query3", app="app-1", request_id="r2")
        st = sink.status_snapshot()
        assert len(st["in_flight"]) == 2
        assert {r.get("request_id") for r in st["in_flight"]} == {"r1", "r2"}
        sink.record({"kind": "ladder_rung", "app": "app-1",
                     "query": "query3", "request_id": "r2",
                     "rung": "recover_retry"})
        sink.record({"kind": "query_span", "app": "app-1",
                     "query": "query3", "request_id": "r1", "dur_ms": 5.0,
                     "status": "Completed", "retries": 0})
        st = sink.status_snapshot()
        assert len(st["in_flight"]) == 1
        rec = st["in_flight"][0]
        assert rec["request_id"] == "r2" and rec["ladder"] == ["recover_retry"]
        sink.query_started("q", app="a")
        sink.record({"kind": "query_span", "app": "a", "query": "q",
                     "dur_ms": 1.0, "status": "Completed", "retries": 0})
        left = sink.status_snapshot()["in_flight"]
        assert len(left) == 1
        # times differ: every other field of the record is compared
        return [{k: v for k, v in r.items()
                 if not k.endswith(("_ms", "ts"))} for r in left]

    out = _per_pkg(run)
    assert out["jax"] == out["torch"]


def test_concurrent_identical_queries_isolated_end_to_end(env):
    def run(P):
        service, port, _ = env.service(P, conf={"engine.serve_workers": 4})
        results = []
        threads = [threading.Thread(
            target=lambda t=f"t{i}": results.append(
                post(port, {"sql": QUERY}, tenant=t)), daemon=True)
            for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert len(results) == 3
        assert all(status == 200 for status, _, _ in results)
        rows = [body["rows"] for _, body, _ in results]
        assert rows[0] == rows[1] == rows[2]
        assert len({body["request_id"] for _, body, _ in results}) == 3
        assert json.loads(get(port, "/statusz")[1])["in_flight"] == []
        service.close()
        return results

    out = _per_pkg(run)
    by_tenant = {k: sorted(v, key=lambda r: r[1]["tenant"])
                 for k, v in out.items()}
    assert_same_answers(by_tenant)


# ---------------------------------------------------------------------------
# stream jobs (resumable, the bench-state pattern)
# ---------------------------------------------------------------------------


def _mini_stream(dirpath):
    os.makedirs(dirpath, exist_ok=True)
    p = os.path.join(dirpath, "query_9.sql")
    with open(p, "w") as f:
        f.write(
            "-- start query 1 in stream 9 using template query1.tpl\n"
            "select k, sum(v) s from fact group by k order by k;\n"
            "-- start query 2 in stream 9 using template query2.tpl\n"
            "select count(*) c from fact;\n")
    return p


def _wait_job(port, job_id, seconds=30):
    deadline = time.monotonic() + seconds
    while True:
        code, text = get(port, f"/jobs/{job_id}")
        job = json.loads(text)
        if job.get("state") in ("completed", "failed") or (
                time.monotonic() > deadline):
            return code, job
        time.sleep(0.05)


def _job_view(job):
    return {k: job[k] for k in ("job_id", "state", "tenant", "total",
                                "completed", "failed")} | {
        "queries": {n: (r["status"], r["http_status"])
                    for n, r in job["queries"].items()}}


def test_stream_job_runs_checkpoints_and_resumes(env, tmp_path):
    def run(P):
        base = tmp_path / P.name
        stream = _mini_stream(str(base))
        job_dir = str(base / "jobs")
        service, port, _ = env.service(P, job_dir=job_dir)
        status, job, _ = post(port, {"stream": stream, "job_id": "j1"},
                              path="/stream")
        assert status == 202 and job["job_id"] == "j1"
        _, job = _wait_job(port, "j1")
        assert job["state"] == "completed"
        assert (job["total"], job["completed"], job["failed"]) == (2, 2, 0)
        state_file = os.path.join(job_dir, "serve-job-j1.json")
        before = json.load(open(state_file))
        status, _, _ = post(port, {"stream": stream, "job_id": "j1"},
                            path="/stream")
        assert status == 202
        _, job2 = _wait_job(port, "j1")
        assert job2["state"] == "completed"
        # nothing re-ran: the per-query records are the checkpoint's
        assert json.load(open(state_file))["queries"] == before["queries"]
        other = base / "other.sql"
        other.write_text(
            "-- start query 1 in stream 0 using template query5.tpl\n"
            "select count(*) c from fact;\n")
        bad = post(port, {"stream": str(other), "job_id": "j1"},
                   path="/stream")
        assert bad[0] == 400 and "different stream" in bad[1]["error"]
        missing = get(port, "/jobs/missing")[0]
        assert missing == 404
        service.close()
        return _job_view(job), _job_view(job2), bad[0], missing

    out = _per_pkg(run)
    assert out["jax"] == out["torch"]


def test_reload_drops_pins_and_caches(env, tmp_path):
    def run(P):
        path = mini_lake(P, tmp_path, rows=8)
        service, port, session = env.service(P, lake_path=path)
        first = post(port, {"sql": "select count(*) c from fact"})
        assert session.catalog.entries["fact"].pinned_version is not None
        reload = post(port, {}, path="/reload")
        assert reload[0] == 200 and reload[1]["reloaded"] is True
        assert session.catalog.entries["fact"].pinned_version is None
        again = post(port, {"sql": "select count(*) c from fact"})
        assert again[0] == 200
        service.close()
        return [first, reload, again]

    assert_same_answers(_per_pkg(run))


def test_reload_releases_dropped_lease_after_last_in_flight(env, tmp_path):
    q = "select k, count(*) c from fact group by k order by k"

    def run(P):
        path = mini_lake(P, tmp_path, rows=8)
        root = P.T.LakehouseTable(path).root
        service, port, session = env.service(P, lake_path=path)
        leases = P.L.LEASES
        baseline = leases.live_count(root)
        post(port, {"sql": q})
        assert leases.live_count(root) == baseline + 1
        idle = post(port, {}, path="/reload")
        assert idle[0] == 200 and idle[1]["leases_dropped"] == 1
        assert idle[1]["leases_deferred"] == 0
        assert leases.live_count(root) == baseline
        P.faults.install("hang:serve:exec:1.5")
        box = {}
        t = threading.Thread(
            target=lambda: box.update(resp=post(port, {"sql": q})),
            daemon=True)
        t.start()
        # admission counts the request before it plans and pins: wait
        # for it to be held at serve:exec, holding its pin
        wait_hang_fired(P)
        assert service.in_flight() == 1
        dropped = session.catalog.entries["fact"].lease_id
        assert dropped is not None
        busy = post(port, {}, path="/reload")
        assert busy[0] == 200
        assert busy[1]["leases_deferred"] == busy[1]["leases_dropped"]
        assert dropped in leases._leases  # the statement still scans
        t.join(30)
        assert box["resp"][0] == 200
        deadline = time.monotonic() + 5
        while dropped in leases._leases and time.monotonic() < deadline:
            time.sleep(0.02)
        assert dropped not in leases._leases
        service.close()
        return [idle, busy, box["resp"]]

    assert_same_answers(_per_pkg(run))


# ---------------------------------------------------------------------------
# knob derivations and the event schema
# ---------------------------------------------------------------------------


def test_serve_concurrency_derives_from_budget(monkeypatch):
    """The port's serve_concurrency equals the JAX function for every conf
    and environment case, and the slot size is the reference's."""
    assert TORCH.B.SERVE_SLOT_BYTES == JAX.B.SERVE_SLOT_BYTES
    slot = TORCH.B.SERVE_SLOT_BYTES
    confs = [None, {}, {"engine.serve_workers": 7},
             {"engine.serve_workers": "3"}, {"engine.serve_workers": 0},
             {"engine.serve_workers": "x"}, {"engine.serve_workers": "-2"},
             {"engine.plan_budget_bytes": 4 * slot},
             {"engine.plan_budget_bytes": 1},
             {"engine.plan_budget_bytes": 1 << 50},
             {"engine.plan_budget_bytes": str(5 * slot + 7)},
             {"engine.serve_workers": 2, "engine.plan_budget_bytes": 1}]
    envs = [{}, {"NDS_SERVE_WORKERS": "5"}, {"NDS_SERVE_WORKERS": ""},
            {"NDS_SERVE_WORKERS": "bad"},
            {"NDS_PLAN_BUDGET_BYTES": str(9 * slot)},
            {"NDS_SERVE_WORKERS": "2", "NDS_PLAN_BUDGET_BYTES": "1"}]
    seen = set()
    for environ in envs:
        for var in ("NDS_SERVE_WORKERS", "NDS_PLAN_BUDGET_BYTES"):
            monkeypatch.delenv(var, raising=False)
        for k, v in environ.items():
            monkeypatch.setenv(k, v)
        for conf in confs:
            want = JAX.B.serve_concurrency(conf)
            assert TORCH.B.serve_concurrency(conf) == want, (environ, conf)
            seen.add(want)
    assert {1, 2, 3, 4, 5, 7, 9, 16} <= seen
    monkeypatch.delenv("NDS_SERVE_WORKERS", raising=False)
    monkeypatch.delenv("NDS_PLAN_BUDGET_BYTES", raising=False)
    assert TORCH.B.serve_concurrency({"engine.serve_workers": 7}) == 7
    assert TORCH.B.serve_concurrency(
        {"engine.plan_budget_bytes": 4 * slot}) == 4
    assert TORCH.B.serve_concurrency({"engine.plan_budget_bytes": 1}) == 1
    assert TORCH.B.serve_concurrency(
        {"engine.plan_budget_bytes": 1 << 50}) == 16


def test_event_schema_has_serve_request():
    for P in PKGS:
        assert set(P.TR.EVENT_SCHEMA["serve_request"]) == {
            "tenant", "status", "dur_ms", "http_status"}
        for family in ("nds_serve_request_total", "nds_serve_request_dur_ms",
                       "nds_serve_request_ms_total"):
            assert P.M.METRIC_KINDS[family] == "serve_request"
    serve = {k: v for k, v in TORCH.M.METRIC_KINDS.items()
             if k.startswith(("nds_serve_", "nds_route_"))}
    assert serve == {k: v for k, v in JAX.M.METRIC_KINDS.items()
                     if k.startswith(("nds_serve_", "nds_route_"))}
    assert TORCH.TR.EVENT_SCHEMA["serve_request"] == (
        JAX.TR.EVENT_SCHEMA["serve_request"])


# ---------------------------------------------------------------------------
# a small closed loop: concurrent readers and a writer
# ---------------------------------------------------------------------------


def test_closed_loop_readers_and_writer_on_the_port(env, tmp_path):
    """The reference's closed-loop case, cut to the CPU (it drives
    tools/serve_bench.py at SF0.01 in its slow tier): four client threads
    send point lookups, a heavy aggregate and INSERTs to the port's
    service over a lakehouse table. No 5xx; every read's answer is one
    snapshot's (its count agrees with its sum); the final count is the
    base rows plus every acknowledged insert."""
    path = mini_lake(TORCH, tmp_path, rows=32)
    service, port, _ = env.service(
        TORCH, conf={"engine.serve_workers": 4}, lake_path=path)
    acked, seen, statuses = [], [], []
    lock = threading.Lock()

    def reader(i):
        for j in range(4):
            q = ("select count(*) c, sum(v) s from fact" if (i + j) % 2
                 else "select k, v from fact where v = 3 limit 1")
            status, body, _ = post(port, {"sql": q}, tenant=f"r{i}")
            with lock:
                statuses.append(status)
                if status == 200 and body["columns"] == ["c", "s"]:
                    seen.append(tuple(body["rows"][0]))

    def writer():
        for j in range(3):
            status, body, _ = post(port, {
                "sql": f"insert into fact select k, v + {1000 * (j + 1)}, f "
                       f"from fact where v < 2"}, tenant="w")
            with lock:
                statuses.append(status)
                if status == 200:
                    acked.append(body["rows_affected"])

    threads = [threading.Thread(target=reader, args=(i,), daemon=True)
               for i in range(3)] + [
        threading.Thread(target=writer, daemon=True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert statuses and all(s < 500 for s in statuses), statuses
    assert acked
    # a snapshot of n rows: base rows 0..31 and whole inserted batches
    for c, s in seen:
        assert c >= 32 and s >= sum(range(32)), (c, s)
    status, body, _ = post(port, {"sql": "select count(*) c from fact"})
    assert status == 200
    assert body["rows"][0][0] == 32 + sum(acked)
    assert same_value(body["rows"][0][0], 32 + sum(acked))
    service.close()


def test_cli_serve_runs_on_the_card_or_raises(tmp_path, monkeypatch):
    """The CLI's sessions resolve to the card: with no GPU and no
    --device, building the service raises instead of moving to the CPU."""
    import argparse

    import torch

    from nds_tpu_torch.cli.serve import build_service

    wh = tmp_path / "wh"
    wh.mkdir()
    TORCH.T.LakehouseTable.create(str(wh / "store_sales"),
                                  pa.table({"a": pa.array([1])}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = argparse.Namespace(
        warehouse_path=str(wh), input_format="lakehouse", port=0,
        property_file=None, stream=None, job_dir=None, floats=False,
        aot_cache_dir=None, device=None)
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_service(args)
    finally:
        TORCH.M.reset_shared()
