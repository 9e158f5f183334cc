"""The port's fleet router (nds_tpu_torch/serve/router.py, cli/route.py)
against the JAX package's (nds_tpu/serve/router.py), through the cases of
tests/test_router.py: verdict routing, edge rejects that take no replica
slot, failover on replica death, the retry token bucket, fleet tenant
caps, DML idempotency keys, the degraded-DML circuit, rolling reload and
the router hop in the request trace.

Each case runs through both packages: real QueryServices on listeners of
their own, fronted over HTTP by a router of the same package, over the
same seeded numpy data. The port's answers are held to the reference's:
status codes, envelope keys, verdicts, rows, the `nds_route_*` metric
families, /statusz's fleet section, and the replica the router picks for
the same fingerprints. The router's fingerprint hashes on the host
(hashlib), so torch's missing uint64 arithmetic never enters it. The
port's sessions run on the CPU.

Tolerance: status codes, keys, verdicts, integers and strings exact;
floats within nds_tpu/validate.py compare's relative epsilon, 1e-5
(torch_serve_cases.EPS)."""

import argparse
import json
import os
import sys
import threading
import time

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from torch_join_cases import strict_budget  # noqa: E402,F401
from torch_serve_cases import (  # noqa: E402,F401
    FQUERY, JAX, PKGS, POINT, QUERY, TORCH, assert_same_answer,
    assert_same_answers, env, fact_table, get, mini_lake, post,
)


def _per_pkg(fn):
    return {P.name: fn(P) for P in PKGS}


def _counts(rec):
    """A /statusz tenant record without its times."""
    return {k: v for k, v in rec.items() if "ms" not in k}


def _strip_route(answers):
    """Answers without the replica addresses (ports differ by package)."""
    out = []
    for status, body, headers in answers:
        body = dict(body)
        route = dict(body.get("route") or {})
        route.pop("replica", None)
        route.pop("tried", None)
        route.pop("request_key", None)
        if "route" in body:
            body["route"] = route
        out.append((status, body, headers))
    return out


# ---------------------------------------------------------------------------
# address parsing, classification, fingerprints (pure units)
# ---------------------------------------------------------------------------

PAYLOADS = [
    {"sql": QUERY}, {"sql": "  WITH t AS (select 1) select * from t"},
    {"sql": "(select 1)"}, {"sql": "insert into fact select * from fact"},
    {"sql": "delete from fact where v < 0"}, {"template": "query3"},
    {"sql": "-- note\nselect 1"}, {"sql": "\n\tSELECT  1\nFROM fact"},
    {"template": "q", "params": {"K": 1}}, {"template": "q",
                                            "params": {"K": 2}},
    {}, {"sql": "call system.rollback_to_timestamp('t', 1)"},
]


def test_replica_parsing_and_payload_classification():
    for P in PKGS:
        R = P.RT.Replica
        assert R("http://127.0.0.1:1234/").name == "127.0.0.1:1234"
        assert R("host:80").name == "host:80"
        with pytest.raises(ValueError):
            R("no-port")
        cls = P.RT.QueryRouter.classify_payload
        assert cls({"sql": QUERY}) == "select"
        assert cls({"sql": "insert into fact select * from fact"}) == "dml"
        fp = P.RT.QueryRouter.fingerprint
        assert fp({"sql": "select  1\nfrom fact"}) == fp(
            {"sql": "SELECT 1 FROM fact"})
        assert fp({}) is None
    # classification and fingerprints equal the reference's, payload by
    # payload
    J, T = JAX.RT.QueryRouter, TORCH.RT.QueryRouter
    for p in PAYLOADS:
        assert T.fingerprint(p) == J.fingerprint(p), p
        if p:
            assert T.classify_payload(p) == J.classify_payload(p), p
    for addr in ("127.0.0.1:9", "http://h:1/", "https://a.b:443"):
        assert TORCH.RT.Replica(addr).snapshot() == (
            JAX.RT.Replica(addr).snapshot())


def test_pick_order_matches_for_the_same_fingerprints(env):
    """The replica each package's router picks, fingerprint by
    fingerprint, for the same fleet state: the same index into its
    replica list."""
    def run(P):
        ports = [env.replica(P)[1] for _ in range(3)]
        router, _ = env.router(P, ports, mesh_port=ports[2])
        names = [r.name for r in router.replicas]
        picks = []
        for i, p in enumerate(PAYLOADS * 2):
            verdict = {"verdict": ("direct", "spill", None)[i % 3]}
            rep = router._pick(verdict)
            picks.append((router.fingerprint(p), names.index(rep.name)))
            if i % 4 == 0:
                with router._lock:
                    rep.in_flight += 1
        return picks

    out = _per_pkg(run)
    assert out["jax"] == out["torch"]


# ---------------------------------------------------------------------------
# routed round trip + fleet view
# ---------------------------------------------------------------------------


def test_routed_select_roundtrip_and_fleet_view(env):
    def run(P):
        _, p1, _ = env.replica(P)
        _, p2, _ = env.replica(P)
        router, rport = env.router(P, [p1, p2])
        answers = [post(rport, {"sql": QUERY}), post(rport, {"sql": FQUERY})]
        status, body, _ = answers[0]
        assert status == 200 and body["status"] == "completed"
        assert body["columns"] == ["k", "c", "s"]
        assert body["route"]["attempts"] == 1
        assert body["route"]["replica"] in (f"127.0.0.1:{p1}",
                                            f"127.0.0.1:{p2}")
        status, raw = get(rport, "/fleet")
        view = json.loads(raw)
        assert status == 200 and len(view["replicas"]) == 2
        assert all(r["healthy"] for r in view["replicas"])
        assert view["degraded"] == {} and view["draining"] is False
        return _strip_route(answers), sorted(view)

    out = _per_pkg(run)
    assert_same_answers({k: v[0] for k, v in out.items()})
    assert out["jax"][1] == out["torch"][1]


# ---------------------------------------------------------------------------
# verdict routing: reject answered at the edge, zero worker slots
# ---------------------------------------------------------------------------


def test_verdict_reject_429_at_edge_consumes_no_replica_slot(env):
    def run(P):
        service, p1, _ = env.replica(P, conf={
            "engine.plan_budget_bytes": 1024,
            "engine.plan_budget_reject_bytes": 2048,
        }, rows=1 << 16)
        router, rport = env.router(P, [p1])
        heavy = {"sql": "select k + v from fact"}
        answers = []
        for _ in range(2):
            status, body, headers = post(rport, heavy, tenant="rej")
            assert status == 429
            assert body["status"] == "rejected"
            assert body["verdict"] == "reject"
            assert body["peak_bytes"] > 2048 and body["budget_bytes"] == 1024
            assert body["retry_after_s"] > 0 and headers.get("Retry-After")
            answers.append((status, body, headers))
        assert router.fleet_snapshot()["verdict_cache_entries"] == 1
        snap = P.M.shared_sink().status_snapshot()
        assert "rej" not in (snap.get("tenants") or {})
        series = P.M.shared_sink().registry.counter_series(
            "nds_serve_request_total")
        assert not any(("tenant", "rej") in labels for labels in series)
        assert service._in_flight == 0
        assert snap["fleet"]["edge_rejected"] == 2
        assert snap["fleet"]["tenants"]["rej"]["rejected"] == 2
        return answers, _counts(snap["fleet"]["tenants"]["rej"])

    out = _per_pkg(run)
    assert_same_answers({k: v[0] for k, v in out.items()})
    assert out["jax"][1] == out["torch"][1]


def test_plan_probe_is_slotless_on_the_replica(env):
    def run(P):
        service, p1, _ = env.replica(P)
        answers = [
            post(p1, {"sql": QUERY}, path="/plan"),
            post(p1, {"sql": "insert into fact select * from fact"},
                 path="/plan"),
            post(p1, {"template": "nope"}, path="/plan")]
        assert answers[0][0] == 200 and answers[0][1]["kind"] == "select"
        assert answers[0][1]["verdict"] in ("direct", "unknown")
        assert answers[1][0] == 200 and answers[1][1]["kind"] == "dml"
        assert answers[1][1]["verdict"] is None
        assert answers[2][0] == 404
        assert service._in_flight == 0
        assert P.M.shared_sink().registry.counter_series(
            "nds_serve_request_total") == {}
        return answers

    assert_same_answers(_per_pkg(run))


def test_spill_verdict_pins_to_mesh_replica(env):
    """`mesh_replica` in the port is routing to a URL: spill, blocked and
    over verdicts go to that replica, as in the reference."""
    def run(P):
        _, p1, _ = env.replica(P)
        _, p2, _ = env.replica(P)
        router, _ = env.router(P, [p1, p2], mesh_port=p2)
        mesh = [r for r in router.replicas if r.mesh]
        assert [r.name for r in mesh] == [f"127.0.0.1:{p2}"]
        for v in ("spill", "blocked", "over"):
            assert router._pick({"verdict": v}).name == f"127.0.0.1:{p2}"
        picked = [router._pick({"verdict": "direct"}).name
                  for _ in range(4)]
        assert set(picked) == {f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"}
        return [picked.index(n) for n in picked]

    out = _per_pkg(run)
    assert out["jax"] == out["torch"]


# ---------------------------------------------------------------------------
# failure detection + failover
# ---------------------------------------------------------------------------


def test_failover_on_replica_death_marks_unhealthy(env):
    def run(P):
        _, p1, s1 = env.replica(P)
        _, p2, _ = env.replica(P)
        router, rport = env.router(
            P, [p1, p2], conf={"engine.route_verdict_cache": 0})
        s1.stop()  # replica death: connect refused from now on
        dead = f"127.0.0.1:{p1}"
        names = [r.name for r in router.replicas]
        router._rr = names.index(dead)
        answer = post(rport, {"sql": QUERY})
        status, body, _ = answer
        assert status == 200 and body["status"] == "completed"
        assert body["route"]["attempts"] == 2
        assert body["route"]["replica"] == f"127.0.0.1:{p2}"
        by_name = {r["replica"]: r for r in
                   router.fleet_snapshot()["replicas"]}
        assert by_name[dead]["healthy"] is False
        assert by_name[f"127.0.0.1:{p2}"]["healthy"] is True
        _, text = get(rport, "/metrics")
        assert 'nds_route_retry_total{reason="connect"}' in text
        assert router.probe_replica(
            router.replicas[names.index(dead)]) is False
        assert router.probe_replica(
            router.replicas[names.index(f"127.0.0.1:{p2}")]) is True
        return _strip_route([answer])

    assert_same_answers(_per_pkg(run))


def test_all_replicas_dead_fails_bounded_and_classified(env):
    def run(P):
        _, p1, s1 = env.replica(P)
        _, p2, s2 = env.replica(P)
        router, rport = env.router(P, [p1, p2])
        s1.stop()
        s2.stop()
        answer = post(rport, {"sql": QUERY})
        status, body, headers = answer
        assert status == 503 and body["status"] == "failed"
        assert body["failure_kind"] == P.faults.IO_TRANSIENT
        assert 2 <= body["route"]["attempts"] <= router.max_attempts
        assert sorted(body["route"]["tried"]) == sorted(
            [f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"])
        assert body["retry_after_s"] > 0 and headers.get("Retry-After")
        return _strip_route([answer])

    assert_same_answers(_per_pkg(run))


def test_retry_token_bucket_bounds_the_failover_storm(env):
    def run(P):
        _, p1, _ = env.replica(P)
        _, p2, _ = env.replica(P)
        router, rport = env.router(P, [p1, p2], conf={
            "engine.route_retry_burst": 1, "engine.route_retry_rate": 0})
        P.faults.install("io:route:forward:100")
        attempts = []
        for _ in range(5):
            status, body, _ = post(rport, {"sql": QUERY}, tenant="storm")
            assert status == 503 and body["status"] == "failed"
            assert "injected" in body["error"]
            attempts.append(body["route"]["attempts"])
        assert sum(attempts) == 5 + 1
        assert attempts[0] == 2 and set(attempts[1:]) == {1}
        return attempts

    out = _per_pkg(run)
    assert out["jax"] == out["torch"]


def test_upstream_drain_propagates_with_jittered_retry_after(env):
    def run(P):
        service, p1, _ = env.replica(P)
        router, rport = env.router(P, [p1])
        service.handle_drain()
        answers = [post(rport, {"sql": QUERY})]
        status, body, headers = answers[0]
        assert status == 503 and body["status"] == "draining"
        assert headers.get("Retry-After")
        ras = [body["retry_after_s"]]
        assert router.fleet_snapshot()["replicas"][0]["draining"] is True
        for _ in range(4):
            answers.append(post(rport, {"sql": QUERY}))
            status, body, _ = answers[-1]
            assert status == 503 and body["status"] == "failed"
            assert "no healthy replica" in body["error"]
            ras.append(body["retry_after_s"])
        assert len(set(ras)) >= 2  # decorrelated jitter
        return _strip_route(answers)

    out = _per_pkg(run)
    # the jitter differs by draw; every other field agrees
    for k in out:
        for _, body, _ in out[k]:
            body.pop("retry_after_s")
    assert_same_answers(out)


# ---------------------------------------------------------------------------
# fleet-wide tenant quota
# ---------------------------------------------------------------------------


def test_fleet_tenant_cap_sheds_at_edge(env):
    def run(P):
        _, p1, _ = env.replica(P)
        router, rport = env.router(P, [p1],
                                   conf={"engine.route_tenant_cap": 1})
        before = router.fleet_snapshot()["replicas"][0]["requests"]
        assert router._tenant_enter("cap")
        answers = []
        try:
            answers.append(post(rport, {"sql": QUERY}, tenant="cap"))
            status, body, headers = answers[-1]
            assert status == 429 and body["status"] == "shed"
            assert "fleet in-flight cap" in body["error"]
            assert headers.get("Retry-After")
            assert router.fleet_snapshot()["tenant_in_flight"] == {"cap": 1}
            assert router.fleet_snapshot()["replicas"][0]["requests"] == (
                before)
            answers.append(post(rport, {"sql": QUERY}, tenant="other"))
            assert answers[-1][0] == 200
        finally:
            router._tenant_leave("cap")
        answers.append(post(rport, {"sql": QUERY}, tenant="cap"))
        assert answers[-1][0] == 200
        fl = P.M.shared_sink().status_snapshot()["fleet"]
        assert fl["tenants"]["cap"]["shed"] == 1
        assert fl["tenants"]["cap"]["completed"] == 1
        for _, body, _ in answers:
            body.pop("retry_after_s", None)
        return _strip_route(answers), {
            t: _counts(rec) for t, rec in fl["tenants"].items()}

    out = _per_pkg(run)
    assert_same_answers({k: v[0] for k, v in out.items()})
    assert out["jax"][1] == out["torch"][1]


# ---------------------------------------------------------------------------
# DML: idempotency keys, ambiguous mid-stream death
# ---------------------------------------------------------------------------

DML = {"sql": "insert into fact select k, v + 1000, f from fact"}


def test_dml_request_key_dedups_redelivery(env, tmp_path):
    def run(P):
        path = mini_lake(P, tmp_path, rows=8)
        _, p1, _ = env.replica(P, lake_path=path)
        key = {"X-NDS-Request-Key": "k" * 16}
        first = post(p1, DML, tenant="w", headers=key)
        assert first[0] == 200 and first[1]["status"] == "completed"
        assert first[1]["rows_affected"] == 8 and first[1]["version"] == 2
        assert "deduped" not in first[1]
        again = post(p1, DML, tenant="w", headers=key)
        assert again[0] == 200 and again[1]["deduped"] is True
        assert again[1]["version"] == 2 and again[1]["rows_affected"] == 8
        count = post(p1, {"sql": "select count(*) c from fact"})
        assert count[1]["rows"][0][0] == 16
        third = post(p1, DML, tenant="w",
                     headers={"X-NDS-Request-Key": "x" * 16})
        assert third[0] == 200 and third[1]["version"] == 3
        return [first, again, count, third]

    assert_same_answers(_per_pkg(run))


def test_dml_midstream_death_is_ambiguous_then_keyed_retry_lands(
        env, tmp_path):
    def run(P):
        path = mini_lake(P, tmp_path, rows=8)
        _, p1, _ = env.replica(P, lake_path=path)
        router, rport = env.router(P, [p1])
        P.faults.install("crash:commit:fact")
        dead = post(rport, DML, tenant="w")
        status, body, _ = dead
        assert status == 503 and body["status"] == "failed"
        assert body["failure_kind"] == P.faults.IO_TRANSIENT
        assert "ambiguous" in body["error"]
        key = body["request_key"]
        assert key
        retry = post(p1, DML, tenant="w",
                     headers={"X-NDS-Request-Key": key})
        assert retry[0] == 200 and retry[1]["status"] == "completed"
        count = post(p1, {"sql": "select count(*) c from fact"})
        replay = post(p1, DML, tenant="w",
                      headers={"X-NDS-Request-Key": key})
        assert replay[0] == 200 and replay[1]["deduped"] is True
        count2 = post(p1, {"sql": "select count(*) c from fact"})
        assert count2[1]["rows"][0][0] == count[1]["rows"][0][0]
        routed = post(rport, DML, tenant="w")
        assert routed[0] == 200 and routed[1]["route"]["request_key"]
        dead[1].pop("request_key")
        dead[1].pop("retry_after_s")
        return _strip_route([dead, retry, count, replay, count2, routed])

    out = _per_pkg(run)
    for k in out:  # the error names the replica's address
        out[k][0][1].pop("error")
    assert_same_answers(out)


# ---------------------------------------------------------------------------
# coordinator loss: the degraded-DML circuit
# ---------------------------------------------------------------------------


def test_coordinator_loss_degrades_dml_keeps_selects(env, tmp_path):
    def run(P):
        path = mini_lake(P, tmp_path, rows=8)
        service, p1, _ = env.replica(P, lake_path=path)
        router, rport = env.router(
            P, [p1], conf={"engine.route_catalog_cooldown_s": 0.2})
        real_run_dml = service._run_dml

        def unreachable(sql_text, tenant, rid, t0, qlabel,
                        request_key=None):
            return service._reply(500, {
                "request_id": rid, "tenant": tenant, "status": "failed",
                "failure_kind": P.faults.IO_TRANSIENT,
                "error": "catalog unreachable at http://127.0.0.1:9 "
                         "(injected: coordinator down)",
            })

        service._run_dml = unreachable
        answers = [post(rport, DML, tenant="w")]
        assert answers[0][0] == 500
        assert "dml" in router.fleet_snapshot()["degraded"]
        reqs = router.fleet_snapshot()["replicas"][0]["requests"]
        answers.append(post(rport, DML, tenant="w"))
        status, body, _ = answers[-1]
        assert status == 503 and body["status"] == "failed"
        assert body["failure_kind"] == P.faults.IO_TRANSIENT
        assert body["degraded"] == "dml"
        assert router.fleet_snapshot()["replicas"][0]["requests"] == reqs
        answers.append(post(rport, {"sql": QUERY}))
        assert answers[-1][0] == 200
        service._run_dml = real_run_dml
        time.sleep(0.25)
        answers.append(post(rport, DML, tenant="w"))
        assert answers[-1][0] == 200
        assert router.fleet_snapshot()["degraded"] == {}
        for _, body, _ in answers:
            body.pop("retry_after_s", None)
        return _strip_route(answers)

    assert_same_answers(_per_pkg(run))


# ---------------------------------------------------------------------------
# fleet lifecycle: rolling drain + reload with zero dropped requests
# ---------------------------------------------------------------------------


def test_rolling_fleet_reload_drops_nothing(env):
    def run(P):
        _, p1, _ = env.replica(P)
        _, p2, _ = env.replica(P)
        router, rport = env.router(P, [p1, p2])
        stop = threading.Event()
        results = []

        def client():
            while not stop.is_set():
                status, body, _ = post(rport, {"sql": POINT}, tenant="roll")
                results.append((status, body.get("status")
                                if status == 200 else body))

        t = threading.Thread(target=client, daemon=True)
        t.start()
        time.sleep(0.2)
        roll = post(rport, {}, path="/fleet/reload")
        stop.set()
        t.join(30)
        status, body, _ = roll
        assert status == 200 and body["ok"] is True and body["rolled"] == 2
        for rec in body["replicas"]:
            assert rec["drained"] is True and rec["reloaded"] is True
        assert results
        dropped = [(s, b) for s, b in results if s != 200]
        stranded = [r["replica"] for r in router.fleet_snapshot()["replicas"]
                    if r["draining"]]
        assert get(p1, "/healthz")[0] == 200
        assert get(p2, "/healthz")[0] == 200
        if P is JAX:
            # the reference's roll race, which the port repairs
            # (test_late_drain_answer_never_strands_a_reopened_replica):
            # a `draining` answer read after the roll re-opened its
            # replica drops the request (503) and takes that replica out
            # of the router's rotation though it serves (200 above)
            assert all(s == 503 for s, _ in dropped), dropped
        else:
            assert not dropped and not stranded, (dropped, stranded)
        drain = post(rport, {}, path="/drain")
        assert drain[0] == 200 and router.draining is True
        after = post(rport, {"sql": POINT})
        assert after[0] == 503
        after[1].pop("retry_after_s")
        return [roll, drain, after], {s for s, _ in results}

    out = _per_pkg(run)
    for k in out:  # replica addresses differ by package
        for rec in out[k][0][0][1]["replicas"]:
            rec.pop("replica")
    assert_same_answers({k: v[0] for k, v in out.items()})
    assert out["torch"][1] == {200}
    assert 200 in out["jax"][1] <= {200, 503}


def _until(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.005)


def test_late_drain_answer_never_strands_a_reopened_replica(env):
    """The rolling reload's race, forced step by step. A request sent to
    replica A is refused `draining` while the roll drains A, and the router
    reads that answer only after the roll has re-opened A and is draining
    B. The reference takes A out of rotation again on the stale answer,
    finds no replica, drops the request (503) and leaves A out after the
    roll. The port's router knows A was re-opened since the request was
    sent (`Replica.epoch`) and serves it on A. Held slots keep each drain
    open until the step that ends it."""
    def run(P):
        conf = {"engine.serve_drain_timeout_s": 20}
        svc_a, port_a, _ = env.replica(P, conf=conf)
        svc_b, port_b, _ = env.replica(P, conf=conf)
        router, rport = env.router(P, [port_a, port_b],
                                   conf={"engine.route_verdict_cache": 0})
        rep_a, rep_b = router.replicas
        real = router._forward_query
        sent = []

        def forward(rep, *args, **kw):
            sent.append(rep)
            if len(sent) > 1:
                return real(rep, *args, **kw)
            assert rep is rep_a
            _until(lambda: svc_a.draining)  # the roll drains A
            answer = real(rep, *args, **kw)  # refused: draining
            svc_a._leave("hold-a")  # A's drain ends, the roll reloads it
            _until(lambda: not rep_a.draining and rep_b.draining)
            return answer

        router._forward_query = forward
        svc_a._enter("hold-a")
        svc_b._enter("hold-b")
        box = {}
        q = threading.Thread(target=lambda: box.update(
            q=post(rport, {"sql": POINT}, tenant="q")), daemon=True)
        q.start()
        _until(lambda: sent)
        roll = threading.Thread(target=lambda: box.update(
            roll=post(rport, {}, path="/fleet/reload")), daemon=True)
        roll.start()
        q.join(30)
        svc_b._leave("hold-b")  # B's drain ends, the roll finishes
        roll.join(30)
        status, body, _ = box["q"]
        assert box["roll"][0] == 200 and box["roll"][1]["ok"] is True
        stranded = [i for i, r in enumerate(
            router.fleet_snapshot()["replicas"]) if r["draining"]]
        return status, body.get("status"), stranded, len(sent)

    out = _per_pkg(run)
    assert out["jax"] == (503, "draining", [0], 1)
    assert out["torch"] == (200, "completed", [], 2)


# ---------------------------------------------------------------------------
# observability: the router hop joins the request's trace
# ---------------------------------------------------------------------------


def test_route_hop_joins_the_request_trace(env, tmp_path):
    def run(P):
        trace = tmp_path / P.name / "trace"
        _, p1, _ = env.replica(P, conf={"engine.trace_dir": str(trace)})
        router, rport = env.router(P, [p1], trace_dir=trace)
        answer = post(rport, {"sql": QUERY}, tenant="tr")
        assert answer[0] == 200
        rid = answer[1]["request_id"]
        evs = P.R.read_events(str(trace), strict=True)
        assert P.R.validate_events(evs) == []
        mine = [e for e in evs if e.get("trace_id") == rid]
        kinds = {e["kind"] for e in mine}
        assert {"route_request", "serve_request", "query_span"} <= kinds
        route_ev = [e for e in mine if e["kind"] == "route_request"][0]
        assert route_ev["tenant"] == "tr"
        assert route_ev["status"] == "completed"
        assert route_ev["attempts"] == 1
        assert route_ev["replica"] == f"127.0.0.1:{p1}"
        assert route_ev["queue_ms"] >= 0 and route_ev["forward_ms"] >= 0
        # the critical path reads the router's queue and forward spans
        return _strip_route([answer]), sorted(kinds), sorted(
            k for k in route_ev if not k.endswith(("_ms", "ts")))

    out = _per_pkg(run)
    assert_same_answers({k: v[0] for k, v in out.items()})
    assert out["jax"][1:] == out["torch"][1:]


# ---------------------------------------------------------------------------
# CLI construction seams
# ---------------------------------------------------------------------------


def test_cli_build_router_wires_listener_and_fleet_provider():
    from nds_tpu_torch.cli.route import build_router

    args = argparse.Namespace(
        replica=["127.0.0.1:9", "127.0.0.1:11"], port=0,
        mesh_replica="127.0.0.1:11", property_file=None,
    )
    router, server = build_router(args)
    try:
        assert server.port > 0
        assert [r.mesh for r in router.replicas] == [False, True]
        fl = TORCH.M.shared_sink().status_snapshot()["fleet"]
        assert len(fl["replicas"]) == 2
        assert fl["tenant_cap"] == router.tenant_cap
        assert set(router.fleet_snapshot()) <= set(fl)
    finally:
        router.close()
        TORCH.M.reset_shared()


def test_cli_serve_aot_cache_dir_flag(tmp_path, monkeypatch):
    from nds_tpu_torch.cli.serve import build_service

    monkeypatch.setenv("NDS_AOT_CACHE_DIR", "0")  # restored at teardown
    monkeypatch.setenv("NDS_FEEDBACK_DIR", "0")
    wh = tmp_path / "wh"
    wh.mkdir()
    TORCH.T.LakehouseTable.create(str(wh / "store_sales"), fact_table(4))
    aot = str(tmp_path / "aot")
    args = argparse.Namespace(
        warehouse_path=str(wh), input_format="lakehouse", port=0,
        property_file=None, stream=None, job_dir=None, floats=False,
        aot_cache_dir=aot, device="cpu",
    )
    service, server = build_service(args)
    try:
        assert os.environ["NDS_AOT_CACHE_DIR"] == aot
        # the session armed the shared persistent cache
        assert service.session.aot_cache is not None
        assert service.writer_session is not None
        # the listener answers the service's routes
        status, body, _ = post(server.port, {
            "sql": "select count(*) c from store_sales"}, path="/plan")
        assert status == 200 and body["kind"] == "select"
        # ported (item 14): the flag points the replica's sessions at a
        # shared feedback store
        args.feedback_dir = str(tmp_path / "fb")
        fb_service, _ = build_service(args)
        try:
            assert os.environ["NDS_FEEDBACK_DIR"] == args.feedback_dir
            assert fb_service.session.feedback_store.dir == args.feedback_dir
        finally:
            fb_service.close()
    finally:
        service.close()
        TORCH.M.reset_shared()


def test_cache_warm_fleet_flag_accepted(tmp_path):
    from nds_tpu_torch.cli import cache as cache_cli

    empty = tmp_path / "empty"
    empty.mkdir()
    rc = cache_cli.main([
        "warm", str(empty), "nope.sql",
        "--cache_dir", str(tmp_path / "c"), "--fleet", "--json",
        "--device", "cpu",
    ])
    assert rc == 2  # parsed fine; failed on the empty warehouse
