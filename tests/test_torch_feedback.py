"""Cardinality feedback in the port (nds_tpu_torch/analysis/feedback.py and
its wiring through analysis/budget.py, engine/exec.py and
engine/session.py) against the JAX package's.

Every case of the JAX package's tests/test_feedback.py runs through both
packages (`pkg`): the two-run gate (record, then consume: the verdict
flips and the error shrinks), mode `off`, the scale tag's clean miss, the
resolvers, and the store's units (round trip, quarantine, foreign key,
two processes, vacuum, LRU). Then the parity of the two packages: the
same store keys and scale tags for every template's plan at SF0.01
(planning only), the same `last_plan_budget` after a record and an `on`
pass over the gate table and chip_smoke.py's star, a store written by one
package read as hits by the other, the default conf with a cache
directory, and the same op_span accounting fields.

Tolerance: exact, except the |log(est/actual)| samples (`abs_log_err`,
`err_stats`), within 1e-12.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow as pa
import pytest

from nds_tpu.analysis import feedback as JFB
from nds_tpu.datagen.query_streams import available_templates, instantiate
from nds_tpu.engine.session import Session as JaxSession
from nds_tpu.engine.session import _Entry as JaxEntry
from nds_tpu.engine.sql.parser import parse_script as jax_parse
from nds_tpu.schema import get_schemas as jax_schemas
from nds_tpu_torch.analysis import feedback as TFB
from nds_tpu_torch.engine.session import Session as TorchSession
from nds_tpu_torch.engine.session import _Entry as TorchEntry
from nds_tpu_torch.engine.sql.parser import parse_script as torch_parse
from nds_tpu_torch.schema import get_schemas as torch_schemas

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import CS, arrow_table, strict_budget  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ERR_TOL = 1e-12

FB = {"jax": JFB, "torch": TFB}
FP_A = "a" * 40
FP_B = "b" * 40


def _session(pkg, conf):
    if pkg == "jax":
        # no persistent executable cache of its own unless asked for: the
        # JAX package's default directory is shared (reference caveat B)
        return JaxSession(conf={"engine.aot_cache_dir": "", **conf})
    return TorchSession(conf=conf, device="cpu")


def _store(pkg, tmp_path, budget=1 << 30):
    return FB[pkg].FeedbackStore(str(tmp_path / "fb"), budget)


def _misest_table(n=200_000, seed=5):
    """A table whose `k < 10` selectivity the static model misestimates by
    orders of magnitude: 50k distinct keys, so the filter keeps ~n/5000
    rows while the conjunction floor models vastly more."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, 50_000, n).astype(np.int64),
        "v": rng.random(n),
    })


def _gate_session(pkg, fb_dir, mode, table=None, budget_bytes=8 << 20):
    s = _session(pkg, {
        "engine.feedback_dir": str(fb_dir),
        "engine.plan_feedback": mode,
        "engine.plan_budget": "warn",
        "engine.plan_budget_bytes": budget_bytes,
    })
    s.register_arrow("t", table if table is not None else _misest_table())
    return s


GATE_Q = "select k, sum(v) s from t where k < 10 group by k order by k"

PKG = pytest.mark.parametrize("pkg", ["jax", "torch"])


# ---------------------------------------------------------------------------
# the JAX package's cases, through both packages
# ---------------------------------------------------------------------------


@PKG
def test_two_run_gate_verdict_flips_and_error_shrinks(pkg, tmp_path):
    s1 = _gate_session(pkg, tmp_path / "fb", "record")
    out1 = s1.sql(GATE_Q).to_pylist()
    pb1 = s1.last_plan_budget
    assert pb1["feedback_mode"] == "record"
    assert pb1["feedback_overrides"] == 0  # record never changes estimates
    assert pb1["verdict"] == "spill", pb1
    med1, _mx1, n1 = s1.feedback_store.err_stats()
    assert n1 > 0 and med1 is not None
    entries, nbytes = s1.feedback_store.usage()
    assert entries > 0 and nbytes > 0

    s2 = _gate_session(pkg, tmp_path / "fb", "on")
    out2 = s2.sql(GATE_Q).to_pylist()
    pb2 = s2.last_plan_budget
    assert out2 == out1  # feedback may replan, never change answers
    assert pb2["feedback_hits"] > 0
    assert pb2["feedback_overrides"] >= 1
    assert pb2["verdict"] == "direct", pb2
    assert pb2["peak_bytes"] < pb1["peak_bytes"]
    med2, _mx2, n2 = s2.feedback_store.err_stats()
    assert n2 > 0
    assert med2 < med1, (med1, med2)


@PKG
def test_feedback_off_is_static_and_silent(pkg, tmp_path):
    s = _gate_session(pkg, tmp_path / "fb", "off")
    s.sql(GATE_Q).to_pylist()
    pb = s.last_plan_budget
    assert pb["feedback_mode"] == "off"
    assert pb["feedback_hits"] == 0 and pb["feedback_overrides"] == 0
    assert not os.path.isdir(str(tmp_path / "fb"))


@PKG
def test_scale_tag_change_invalidates_into_clean_miss(pkg, tmp_path):
    s1 = _gate_session(pkg, tmp_path / "fb", "record")
    s1.sql(GATE_Q).to_pylist()
    assert s1.feedback_store.usage()[0] > 0
    s2 = _gate_session(pkg, tmp_path / "fb", "on",
                       table=_misest_table(n=100_000))
    s2.sql(GATE_Q).to_pylist()
    pb = s2.last_plan_budget
    assert pb["feedback_hits"] == 0 and pb["feedback_overrides"] == 0
    assert s2.feedback_store.stats["misses"] > 0


@PKG
def test_mode_resolution_and_validation(pkg, monkeypatch):
    F = FB[pkg]
    for var in ("NDS_PLAN_FEEDBACK", "NDS_FEEDBACK_DIR"):
        monkeypatch.delenv(var, raising=False)
    assert F.resolve_feedback_mode({}) == "record"  # the default
    assert F.resolve_feedback_mode({"engine.plan_feedback": "on"}) == "on"
    monkeypatch.setenv("NDS_PLAN_FEEDBACK", "off")
    assert F.resolve_feedback_mode({}) == "off"
    with pytest.raises(ValueError):
        F.resolve_feedback_mode({"engine.plan_feedback": "always"})
    monkeypatch.setenv("NDS_FEEDBACK_DIR", "0")
    assert F.resolve_feedback_dir({}) is None
    monkeypatch.setenv("NDS_FEEDBACK_DIR", "/some/dir")
    assert F.resolve_feedback_dir({}) == "/some/dir"
    assert F.resolve_feedback_dir(
        {"engine.feedback_dir": "/conf/dir"}
    ) == "/conf/dir"
    # unset: a `feedback/` namespace under the AOT cache dir, and off with it
    monkeypatch.delenv("NDS_FEEDBACK_DIR")
    assert F.resolve_feedback_dir({"engine.aot_cache_dir": "/aot"}) == \
        os.path.join("/aot", "feedback")
    assert F.resolve_feedback_dir({"engine.aot_cache_dir": ""}) is None
    assert F.resolve_feedback_bytes({"engine.feedback_bytes": 12345}) == 12345


@PKG
def test_record_flush_lookup_roundtrip(pkg, tmp_path):
    st = _store(pkg, tmp_path)
    err = st.record(FP_A, rows=1000, nbytes=8000, est_rows=10)
    assert err == pytest.approx(abs(np.log(10) - np.log(1000)))
    st.record(FP_A, rows=1200, nbytes=9600, est_rows=10)
    st.record_skew(FP_A, 5.16, retries=2)
    assert st.flush() == 1
    st2 = _store(pkg, tmp_path)
    rec = st2.lookup(FP_A)
    assert rec["rows"]["n"] == 2
    assert rec["rows"]["max"] == 1200 and rec["rows"]["min"] == 1000
    assert rec["skew"]["max"] == pytest.approx(5.16)
    assert rec["skew"]["retries"] == 2
    assert st2.lookup(FP_B) is None
    assert st2.stats["hits"] == 1 and st2.stats["misses"] == 1
    assert st2.hit_rate() == 0.5


@PKG
def test_corrupt_entry_quarantines_as_miss(pkg, tmp_path):
    st = _store(pkg, tmp_path)
    st.record(FP_A, rows=7, est_rows=7)
    st.flush()
    [name] = [n for n in os.listdir(st.dir) if n.startswith("fb-")]
    path = os.path.join(st.dir, name)
    with open(path, "wb") as f:
        f.write(b"{torn json" + os.urandom(16))
    st2 = _store(pkg, tmp_path)
    assert st2.lookup(FP_A) is None
    assert st2.stats["quarantined"] == 1
    names = os.listdir(st.dir)
    assert not any(n.startswith("fb-") for n in names)
    assert any(n.startswith("quarantine-") for n in names)
    st2.record(FP_A, rows=7, est_rows=7)
    st2.flush()
    with open(path, "rb") as f:
        doc = json.loads(f.read())
    doc["body"]["rows"]["max"] = 999999
    with open(path, "wb") as f:
        f.write(json.dumps(doc).encode())
    st3 = _store(pkg, tmp_path)
    assert st3.lookup(FP_A) is None
    assert st3.stats["quarantined"] == 1


@PKG
def test_foreign_key_is_clean_miss_not_quarantine(pkg, tmp_path):
    F = FB[pkg]
    st = _store(pkg, tmp_path)
    st.record(FP_A, rows=7, est_rows=7)
    st.flush()
    src = os.path.join(st.dir, F._entry_name(FP_A))
    os.rename(src, os.path.join(st.dir, F._entry_name(FP_B)))
    st2 = _store(pkg, tmp_path)
    assert st2.lookup(FP_B) is None
    assert st2.stats["quarantined"] == 0
    assert os.path.exists(os.path.join(st.dir, F._entry_name(FP_B)))


@PKG
def test_two_process_share_through_one_dir(pkg, tmp_path):
    """A child process records and flushes; the parent's store sees the
    merged record (the serve fleet's sharing contract)."""
    mod = "nds_tpu" if pkg == "jax" else "nds_tpu_torch"
    st = _store(pkg, tmp_path)
    st.record(FP_A, rows=100, est_rows=10)
    st.flush()
    script = textwrap.dedent(f"""
        import sys
        from {mod}.analysis.feedback import FeedbackStore
        st = FeedbackStore({str(tmp_path / "fb")!r}, 1 << 30)
        st.record({FP_A!r}, rows=400, est_rows=10)
        st.record_skew({FP_A!r}, 3.5, retries=1)
        assert st.flush() == 1
        assert {pkg!r} == "jax" or "jax" not in sys.modules
        print("SHARED")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    p = subprocess.run(
        [sys.executable, "-c", script], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert p.returncode == 0, p.stderr[-2000:]
    assert "SHARED" in p.stdout
    st2 = _store(pkg, tmp_path)
    rec = st2.lookup(FP_A)
    assert rec["rows"]["n"] == 2
    assert rec["rows"]["max"] == 400
    assert rec["skew"]["retries"] == 1
    assert not any(".tmp-" in n for n in os.listdir(st.dir))


@PKG
def test_vacuum_sweeps_dead_temps_and_quarantines(pkg, tmp_path):
    F = FB[pkg]
    st = _store(pkg, tmp_path)
    st.record(FP_A, rows=7)
    st.flush()
    dead = os.path.join(st.dir, f"{F._entry_name(FP_B)}.tmp-999999-aa")
    with open(dead, "wb") as f:
        f.write(b"torn")
    live = os.path.join(st.dir, f"{F._entry_name(FP_B)}.tmp-{os.getpid()}-bb")
    with open(live, "wb") as f:
        f.write(b"in-flight")
    quar = os.path.join(st.dir, f"quarantine-{F._entry_name(FP_B)}.1")
    with open(quar, "wb") as f:
        f.write(b"bad")
    removed = st.vacuum()
    assert removed == 2  # the dead temp + the quarantine; never the live
    assert os.path.exists(live) and not os.path.exists(dead)
    assert not os.path.exists(quar)
    assert st.lookup(FP_A) is not None
    os.unlink(live)
    assert st.vacuum(drop_all=True) >= 1
    assert st.usage() == (0, 0)
    st2 = _store(pkg, tmp_path)
    assert st2.lookup(FP_A) is None


@PKG
def test_lru_eviction_holds_byte_budget(pkg, tmp_path):
    F = FB[pkg]
    st = _store(pkg, tmp_path)
    st.record(FP_A, rows=7, est_rows=7)
    assert st.flush() == 1
    _, size_a = st.usage()
    st.budget = int(size_a * 1.5)
    old = os.path.join(st.dir, F._entry_name(FP_A))
    os.utime(old, (1, 1))  # backdate: FP_A is the LRU victim
    st.record(FP_B, rows=9, est_rows=9)
    assert st.flush() == 1
    assert st.stats["evictions"] >= 1
    assert not os.path.exists(old)
    names = [n for n in os.listdir(st.dir) if n.startswith("fb-")]
    assert names == [F._entry_name(FP_B)]
    entries, total = st.usage()
    assert entries == 1 and total <= st.budget


# ---------------------------------------------------------------------------
# the two packages against each other
# ---------------------------------------------------------------------------


def _same_err_stats(a, b):
    (ma, xa, na), (mb, xb, nb) = a, b
    assert na == nb
    for x, y in ((ma, mb), (xa, xb)):
        assert (x is None) == (y is None)
        if x is not None:
            assert abs(x - y) <= ERR_TOL, (a, b)


def test_gate_budgets_and_stores_match_across_packages(tmp_path):
    """The record pass and the `on` pass give the same `last_plan_budget`
    in both packages, the same error samples, and byte-identical store
    entries (the same keys, the same recorded rows and bytes)."""
    pbs, errs, docs = {}, {}, {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        for mode in ("record", "on"):
            s = _gate_session(pkg, d, mode)
            s.sql(GATE_Q).to_pylist()
            pbs[pkg, mode] = s.last_plan_budget
            errs[pkg, mode] = s.feedback_store.err_stats()
        docs[pkg] = {}
        for n in sorted(os.listdir(d)):
            with open(d / n) as f:
                body = json.load(f)["body"]
            body.pop("updated")  # the flush's wall-clock second
            docs[pkg][n] = body
    for mode in ("record", "on"):
        assert pbs["torch", mode] == pbs["jax", mode], mode
        _same_err_stats(errs["torch", mode], errs["jax", mode])
    assert docs["torch"] == docs["jax"] and docs["torch"]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_a_store_reads_as_hits_in_the_other_package(writer, reader,
                                                    tmp_path):
    s = _gate_session(writer, tmp_path / "fb", "record")
    s.sql(GATE_Q).to_pylist()
    on = {}
    for pkg in (writer, reader):
        s = _gate_session(pkg, tmp_path / "fb", "on")
        s.sql(GATE_Q)  # planning consumes the store; no execution needed
        on[pkg] = s.last_plan_budget
    assert on[reader]["feedback_hits"] > 0
    assert on[reader]["feedback_overrides"] >= 1
    assert on[reader] == on[writer]


def test_default_conf_with_a_cache_dir_matches_jax(tmp_path):
    """The repaired default: with a cache directory and nothing else set,
    both packages record into `<dir>/feedback` and carry the same feedback
    keys (the port once pinned them at `off` and 0)."""
    pbs = {}
    for pkg in ("jax", "torch"):
        aot = tmp_path / pkg
        s = _session(pkg, {"engine.aot_cache_dir": str(aot)})
        s.register_arrow("t", _misest_table(20_000))
        s.sql(GATE_Q).to_pylist()
        pbs[pkg] = s.last_plan_budget
        assert s.feedback_store.dir == str(aot / "feedback")
        assert os.listdir(aot / "feedback")
    assert pbs["torch"] == pbs["jax"]
    assert pbs["torch"]["feedback_mode"] == "record"


# -- every template's plan: the same keys and scale tags --------------------


def _schema_session(pkg, sf):
    conf = {"engine.plan_budget": "off", "engine.plan_cache": "off",
            "engine.plan_budget_sf": sf}
    s = _session(pkg, conf)
    schemas = jax_schemas(True) if pkg == "jax" else torch_schemas(True)
    entry = JaxEntry if pkg == "jax" else TorchEntry
    for name, schema in schemas.items():
        s.catalog.entries[name] = entry(schema=schema)
    return s


@pytest.fixture(scope="module")
def schema_sessions():
    return _schema_session("jax", 0.01), _schema_session("torch", 0.01)


@pytest.mark.parametrize("qnum", available_templates())
def test_template_node_keys_match_jax(schema_sessions, qnum):
    j, t = schema_sessions
    keys = []
    for s, parse, F in ((j, jax_parse, JFB), (t, torch_parse, TFB)):
        rng = np.random.default_rng(np.random.SeedSequence([0, 0]))
        got = []
        for stmt in parse(instantiate(qnum, rng, 0.01)):
            plan = s.run_stmt(stmt).plan
            tag = F.plan_scale_tag(plan, s)
            got.append((tag, list(F.plan_node_fps(plan, s, tag).values())))
        keys.append(got)
    assert keys[1] == keys[0]
    for tag, fps in keys[1]:
        assert "sf=0.01" in tag.split(";") and fps


# -- chip_smoke.py's star: a record pass, then an `on` pass -----------------


CHIP_SCALE = 1e-5


@pytest.fixture(scope="module")
def star_arrow():
    return {n: arrow_table(c) for n, c in CS.make_star(0, CHIP_SCALE).items()}


def _chip_sql(q):
    if q in CS.JOIN_QUERIES:
        return CS.JOIN_QUERIES[q]
    return CS.QUERIES[q]


@pytest.mark.parametrize("q", ["q3", "q93", "q78", "q16"])
def test_chip_queries_record_then_consume_as_jax(star_arrow, q, tmp_path):
    """The statements chip_smoke.py records and replans on the card, at the
    cut size under a line the static model overshoots: the same verdicts,
    peaks, hits and overrides in both packages."""
    sql = _chip_sql(q)
    pbs = {}
    for pkg in ("jax", "torch"):
        for mode in ("record", "on"):
            s = _session(pkg, {
                "engine.feedback_dir": str(tmp_path / pkg),
                "engine.plan_feedback": mode,
                "engine.plan_budget": "warn",
                "engine.plan_budget_bytes": 1 << 18,
            })
            for name, at in star_arrow.items():
                s.register_arrow(name, at)
            r = s.sql(sql)
            if mode == "record":
                r.collect()
            pbs[pkg, mode] = s.last_plan_budget
    for mode in ("record", "on"):
        assert pbs["torch", mode] == pbs["jax", mode], (q, mode)
    assert pbs["torch", "on"]["feedback_hits"] > 0, q


def test_op_spans_carry_the_same_accounting(tmp_path):
    """A traced record pass: each annotated node's op_span carries its
    store key, static estimates and measured rows, and each record its
    plan_feedback event, the same in both packages."""
    from nds_tpu.obs import reader as JR
    from nds_tpu_torch.obs import reader as TR

    got = {}
    for pkg, R in (("jax", JR), ("torch", TR)):
        trace = tmp_path / f"trace_{pkg}"
        s = _session(pkg, {
            "engine.feedback_dir": str(tmp_path / f"fb_{pkg}"),
            "engine.trace_dir": str(trace),
            "engine.plan_budget": "warn",
            "engine.plan_budget_bytes": 8 << 20,
        })
        s.register_arrow("t", _misest_table(20_000))
        s.sql(GATE_Q).to_pylist()
        s.tracer.close()
        evs = R.read_events(str(trace), strict=True)
        assert R.validate_events(evs) == []
        spans = sorted(
            (e["node"], e["node_fp"], e["est_rows"], e["est_live_bytes"],
             e["actual_rows"])
            for e in evs if e["kind"] == "op_span" and "node_fp" in e
        )
        records = sorted(
            (e["node"], e["actual_rows"], e.get("est_rows"),
             e.get("abs_log_err"))
            for e in evs
            if e["kind"] == "plan_feedback" and e["op"] == "record"
        )
        annotate = [
            {k: e[k] for k in ("mode", "lookups", "hits", "overrides",
                               "verdict")}
            for e in evs
            if e["kind"] == "plan_feedback" and e["op"] == "annotate"
        ]
        got[pkg] = (spans, records, annotate)
    assert got["torch"][0] == got["jax"][0] and got["torch"][0]
    assert len(got["torch"][1]) == len(got["jax"][1]) > 0
    for a, b in zip(got["torch"][1], got["jax"][1]):
        assert a[:3] == b[:3]
        assert abs((a[3] or 0.0) - (b[3] or 0.0)) <= ERR_TOL
    assert got["torch"][2] == got["jax"][2] and got["torch"][2]


def test_cache_cli_reports_and_vacuums_the_store(tmp_path, capsys):
    from nds_tpu_torch.cli import cache as cache_cli

    aot = tmp_path / "aot"
    s = _session("torch", {"engine.aot_cache_dir": str(aot)})
    s.register_arrow("t", _misest_table(20_000))
    s.sql(GATE_Q).to_pylist()
    entries, _ = s.feedback_store.usage()
    assert entries > 0
    assert cache_cli.main(["stats", "--cache_dir", str(aot), "--json"]) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["feedback"]["entries"] == entries
    assert cache_cli.main(["vacuum", "--cache_dir", str(aot), "--all",
                           "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["feedback_removed"] >= entries
    assert out["stats"]["feedback"]["entries"] == 0
