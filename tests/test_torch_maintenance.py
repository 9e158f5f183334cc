"""The port's Data Maintenance phase (nds_tpu_torch/maintenance.py,
cli/maintenance.py, cli/rollback.py and the refresh functions' SQL) against
the JAX package's (nds_tpu/maintenance.py).

The fast cases of the JAX package's tests/test_maintenance.py and
tests/test_maintenance_under_load.py run against both packages,
parametrised by `pkg`, each with the reference's expected outcome. The
whole phase: the port's gen_data makes SF0.01 data and its --update 1
refresh data into this module's temporary directory, the port's transcode
loads a lakehouse warehouse, and a copy of it goes to each package. Both
run the 11 refresh functions with --optimize (branch_spy on each executor;
the port's kernels on, the JAX package's routes off), then roll back to
the heads before. chip_smoke.py's
gates (expected_dm_deletes, fact_digests, MAINTENANCE_KERNELS) are held to
the same runs.

Tolerance: exact. Fact tables compare as multisets of rows (sorted by
every column), integers, decimals, dates and strings bit for bit; rows
affected, statuses, time-log row names, branches and file counts are
equal. No float is involved.
"""

import contextlib
import json
import os
import shutil
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest

from nds_tpu import faults as JF
from nds_tpu import maintenance as JM
from nds_tpu.cli import maintenance as JCLI
from nds_tpu.cli import rollback as JRB
from nds_tpu.engine import exec as JX
from nds_tpu.engine.session import Session as JaxSession
from nds_tpu.lakehouse import table as JT
from nds_tpu_torch import faults as TF
from nds_tpu_torch import maintenance as TM
from nds_tpu_torch.cli import gen_data as TG
from nds_tpu_torch.cli import maintenance as TCLI
from nds_tpu_torch.cli import rollback as TRB
from nds_tpu_torch.cli import transcode as TTC
from nds_tpu_torch.engine import exec as TX
from nds_tpu_torch.engine.session import Session as TorchSession
from nds_tpu_torch.lakehouse import table as TT
from nds_tpu_torch.ops import gpu_kernels as GK

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import CS, strict_budget, structural  # noqa: E402,F401

PKGS = {
    "jax": SimpleNamespace(
        name="jax", M=JM, T=JT, X=JX, faults=JF,
        session=lambda **conf: JaxSession(
            conf={"engine.aot_cache_dir": "", "engine.plan_cache": "off",
                  **conf}),
        # the JAX package's kernel routes stay off: its Pallas kernels in
        # interpret mode would take minutes here, and the routes change no
        # result and no branch
        props={"engine.aot_cache_dir": "", "engine.plan_cache": "off"},
        device={}),
    "port": SimpleNamespace(
        name="port", M=TM, T=TT, X=TX, faults=TF,
        session=lambda **conf: TorchSession(conf=conf, device="cpu"),
        props={f"engine.pallas_{k}": "on" for k in ("agg", "join", "sort")},
        device={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("NDS_FAULT_SPEC", "NDS_LAKE_CONFLICT_RETRIES",
              "NDS_LAKE_LEASE_TTL_S", "NDS_TRACE_DIR", "NDS_QUERY_TIMEOUT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NDS_LAKE_COMMIT_BACKOFF", "0")
    monkeypatch.setenv("NDS_FLIGHT_RECORDER", "off")
    for p in PKGS.values():
        p.faults.reset()
    yield
    for p in PKGS.values():
        p.faults.reset()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


# ---------------------------------------------------------------------------
# the SQL, the function lists, the helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", JM.DM_FUNCS)
def test_sql_file_is_a_byte_identical_copy(fn):
    with open(os.path.join(JM.MAINTENANCE_SQL_DIR, fn + ".sql"), "rb") as a, \
            open(os.path.join(TM.MAINTENANCE_SQL_DIR, fn + ".sql"),
                 "rb") as b:
        assert a.read() == b.read()


def test_all_dm_functions_have_sql():
    assert sorted(os.listdir(TM.MAINTENANCE_SQL_DIR)) == sorted(
        os.listdir(JM.MAINTENANCE_SQL_DIR)) == sorted(
        f + ".sql" for f in TM.DM_FUNCS)


def test_function_lists_match_jax():
    for name in ("INSERT_FUNCS", "DELETE_FUNCS", "INVENTORY_DELETE_FUNC",
                 "DM_FUNCS", "_FUNC_STAGING"):
        assert getattr(TM, name) == getattr(JM, name), name
    assert sorted(TM.FACT_TABLES) == sorted(CS.DM_FACT_TABLES)
    assert sorted(CS.DF_TABLES) == sorted(
        TM.DELETE_FUNCS + TM.INVENTORY_DELETE_FUNC)


@pytest.mark.parametrize("pairs", [
    [("2000-05-20", "2000-05-10")],
    [("1998-01-01", "1998-01-31"), ("1998-03-02", "1998-04-01")],
    [("2001-02-03", "2001-02-03")],
])
def test_replace_date_matches_jax(pairs):
    stmts = ["x DATE1 y DATE2", "between date 'DATE1' and date 'DATE2';"]
    assert TM.replace_date(stmts, pairs) == JM.replace_date(stmts, pairs)
    assert TM.replace_date(["x DATE1 y DATE2"],
                           [("2000-05-20", "2000-05-10")]) == [
        "x 2000-05-10 y 2000-05-20"]


@pytest.mark.parametrize("spec", [None, [], ["LF_SS", "DF_SS"], ["LF_XX"]])
def test_get_valid_query_names_matches_jax(spec):
    def run(mod):
        try:
            return mod.get_valid_query_names(spec)
        except Exception as e:
            return type(e).__name__, str(e)

    assert run(TM) == run(JM)


@pytest.mark.parametrize("times", [[], [5.0], [1.0, 2.0, 3.0],
                                   list(range(1, 201)), [7, 3, 9, 1]])
def test_p99_nearest_rank_matches_jax(times):
    assert TM._p99_ms(times) == JM._p99_ms(times)
    if len(times) == 200:
        assert TM._p99_ms(times) == 198  # ceil(0.99 * 200) = the 198th


def _flags(main):
    out = []

    class Done(Exception):
        pass

    import argparse

    orig = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        out.extend(s for act in self._actions for s in act.option_strings)
        out.extend(act.dest for act in self._actions
                   if not act.option_strings)
        raise Done()

    argparse.ArgumentParser.parse_args = grab
    try:
        main([])
    except Done:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    return set(out)


@pytest.mark.parametrize("cli", ["maintenance", "rollback"])
def test_cli_flags_are_the_jax_packages_and_device(cli):
    j, t = {"maintenance": (JCLI, TCLI), "rollback": (JRB, TRB)}[cli]
    assert _flags(t.main) == _flags(j.main) | {"--device"}


def test_cli_routes_under_load_mode(monkeypatch, tmp_path):
    calls = {}
    monkeypatch.setattr(TCLI, "run_maintenance_under_load",
                        lambda **kw: calls.update(kw))
    TCLI.main([
        "/wh", "/refresh", str(tmp_path / "log.csv"),
        "--under_load_stream", "/streams/query_1.sql",
        "--under_load_report", str(tmp_path / "r.json"),
        "--under_load_queries", "query3,query7",
        "--maintenance_queries", "LF_SS,DF_SS", "--device", "cpu",
    ])
    assert calls["stream_file"] == "/streams/query_1.sql"
    assert calls["sub_queries"] == ["query3", "query7"]
    assert calls["spec_queries"] == ["LF_SS", "DF_SS"]
    assert calls["report_path"] == str(tmp_path / "r.json")
    assert calls["device"] == "cpu" and calls["use_decimal"] is True


def test_cli_routes_plain_mode_and_rollback(monkeypatch, tmp_path):
    calls = {}
    monkeypatch.setattr(TCLI, "run_maintenance",
                        lambda **kw: calls.update(kw))
    TCLI.main(["/wh", "/refresh", "t.csv", "--floats", "--optimize",
               "--vacuum"])
    assert (calls["optimize_after"], calls["vacuum_after"],
            calls["use_decimal"], calls["device"]) == (True, True, False,
                                                       None)
    got = []
    monkeypatch.setattr(TRB, "rollback", lambda *a, **kw: got.append(
        (a, kw)))
    TRB.main(["/wh", "2024-01-02 03:04:05", "--device", "cpu"])
    assert got == [(("/wh", "2024-01-02 03:04:05"), {"device": "cpu"})]


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without a device the sessions resolve to cuda, which raises here."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.rollback(str(tmp_path), "2024-01-02")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.run_maintenance(str(tmp_path), str(tmp_path),
                           str(tmp_path / "t.csv"))


def test_dm_statement_level_conflict_retry(pkg, monkeypatch):
    """A commit conflict inside a refresh function re-runs only the aborted
    statement (never the whole function: earlier statements committed),
    bounded by NDS_LAKE_CONFLICT_RETRIES."""
    monkeypatch.setenv("NDS_LAKE_CONFLICT_RETRIES", "2")
    runs = []

    class FakeSession:
        def run_script(self, q):
            runs.append(q)
            if q == "s2" and runs.count("s2") == 1:
                raise pkg.T.CommitConflictError(
                    "concurrent commit conflict at version 4")

    pkg.M.run_dm_query(FakeSession(), ["s1", "s2", "s3"], "LF_X")
    assert runs == ["s1", "s2", "s2", "s3"]

    class AlwaysConflict:
        def run_script(self, q):
            raise pkg.T.CommitConflictError("concurrent commit conflict")

    with pytest.raises(pkg.T.CommitConflictError):
        pkg.M.run_dm_query(AlwaysConflict(), ["s1"], "LF_Y")


def test_register_refresh_views_missing_directory(pkg, tmp_path):
    s = pkg.session()
    with pytest.raises(FileNotFoundError, match="staging table .delete.*gen_data --update"):
        pkg.M.register_refresh_views(s, str(tmp_path), ["LF_SS"])


# ---------------------------------------------------------------------------
# deterministic interleavings (tests/test_maintenance_under_load.py)
# ---------------------------------------------------------------------------


QUERY = "select k, count(*) c, sum(v) s from fact group by k order by k"


def _mini_warehouse(p, tmp_path, rows=64):
    path = str(tmp_path / "fact")
    p.T.LakehouseTable.create(path, pa.table({
        "k": pa.array(np.arange(rows) % 8, type=pa.int64()),
        "v": pa.array(np.arange(rows), type=pa.int64()),
    }))
    s = p.session(**{"lakehouse.warehouse": str(tmp_path)})
    s.register_lakehouse("fact", path)
    return s, path


def test_query_stream_pinned_results_invariant_under_dm_commits(pkg,
                                                                tmp_path):
    """A query planned at version N returns the same table whether the
    refresh commits land before, between its plan and its execution, or
    after; a fresh statement sees the new state."""
    s, path = _mini_warehouse(pkg, tmp_path)
    before = s.sql(QUERY).collect()
    r = s.sql(QUERY)
    writer = pkg.T.LakehouseTable(path)
    writer.append(pa.table({"k": pa.array([3], type=pa.int64()),
                            "v": pa.array([10_000], type=pa.int64())}))
    kept = writer.snapshot().dataset().to_table().filter(
        pa.compute.less(pa.compute.field("v"), 10))
    writer.replace(kept, operation="delete")
    s.recover_memory("test: no cache luck")
    assert r.collect().equals(before)
    after = s.sql(QUERY).collect()
    assert not after.equals(before) and after.num_rows >= 1


def test_interleaved_writer_thread_with_schedule_and_vacuum(pkg, tmp_path):
    """The reader pins; a maintenance thread appends, rewrites and vacuums;
    the reader's pinned statement re-reads the same table, its files kept
    by its lease, and the vacuum collected the unleased middle version."""
    s, path = _mini_warehouse(pkg, tmp_path)
    r = s.sql(QUERY)
    baseline = r.collect()
    pinned, maintained = threading.Event(), threading.Event()
    results = {}

    def maintenance_thread():
        assert pinned.wait(10)
        w = pkg.T.LakehouseTable(path)
        w.append(pa.table({"k": pa.array([0], type=pa.int64()),
                           "v": pa.array([777], type=pa.int64())}))
        w.replace(w.snapshot().dataset().to_table())
        results["vacuum"] = w.vacuum(retain_last=1)
        maintained.set()

    t = threading.Thread(target=maintenance_thread, daemon=True)
    t.start()
    pinned.set()
    assert maintained.wait(30)
    t.join(10)
    s.recover_memory("test: re-read pinned files after the vacuum")
    assert r.collect().equals(baseline)
    assert results["vacuum"]["manifests_removed"] >= 1


# ---------------------------------------------------------------------------
# the whole phase at SF0.01, both packages
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _recorded(p, ev, calls):
    """Per statement: (function, rows affected or None, branch events)."""
    orig = p.M._run_dm_statement
    got = []

    def run(session, q):
        n = len(ev)
        res = orig(session, q)
        got.append((p.faults.current_scope(),
                    getattr(res, "rows_affected", None), ev[n:]))
        return res

    p.M._run_dm_statement = run
    restore = CS.branch_spy(p.X.Executor, ev)
    wrapped = {}
    if p.name == "port":
        for name in ("segment_sums", "segment_extreme", "dense_build",
                     "sort_perm"):
            fn = wrapped[name] = getattr(GK, name)
            setattr(GK, name, lambda *a, _n=name, _f=fn:
                    calls.append(_n) or _f(*a))
    try:
        yield got
    finally:
        p.M._run_dm_statement = orig
        restore()
        for name, fn in wrapped.items():
            setattr(GK, name, fn)


def _props(path, conf):
    with open(path, "w") as f:
        f.writelines(f"{k}={v}\n" for k, v in conf.items())
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("maintenance_sf001")
    TG.main(["--scale", "0.01", "--parallel", "2", "--data_dir",
             str(root / "raw")])
    TG.main(["--scale", "0.01", "--parallel", "2", "--data_dir",
             str(root / "refresh"), "--update", "1"])
    TTC.main([str(root / "raw"), str(root / "wh"), str(root / "load.report"),
              "--output_format", "lakehouse"])
    return root


@pytest.fixture(scope="module")
def phase(data):
    """Both packages' runs of the 11 functions (then rollback) over copies
    of one warehouse: per package its statements, time log rows,
    summaries, fact digests before / after / rolled back, files after the
    optimize, the port's kernel wrapper calls and the DF_* pyarrow
    counts."""
    env = {k: os.environ.get(k) for k in
           ("NDS_PLAN_BUDGET_STRICT", "NDS_FLIGHT_RECORDER",
            "NDS_LAKE_COMMIT_BACKOFF")}
    os.environ.update({"NDS_PLAN_BUDGET_STRICT": "1",
                       "NDS_FLIGHT_RECORDER": "off",
                       "NDS_LAKE_COMMIT_BACKOFF": "0"})
    out = {}
    try:
        for p in PKGS.values():
            d = data / p.name
            d.mkdir()
            wh = str(d / "wh")
            shutil.copytree(str(data / "wh"), wh)
            pre = CS.fact_digests(wh)
            ts = CS.head_timestamp_ms(wh)
            ev, calls = [], []
            with _recorded(p, ev, calls) as stmts:
                tdm = p.M.run_maintenance(
                    wh, str(data / "refresh"), str(d / "time.csv"),
                    json_summary_folder=str(d / "json"),
                    property_file=_props(d / "p.properties", p.props),
                    optimize_after=True, **p.device)
            after = CS.fact_digests(wh)
            deletes = CS.expected_dm_deletes(
                wh, str(data / "refresh"), CS.pre_delete_versions(wh))
            files = CS.lake_files_per_table(wh)
            p.M.rollback(wh, str(ts), **p.device)
            out[p.name] = SimpleNamespace(
                tdm=tdm, stmts=stmts, calls=calls, pre=pre, after=after,
                back=CS.fact_digests(wh), deletes=deletes, files=files,
                log=CS.read_dm_time_log(str(d / "time.csv")),
                summaries=CS.read_summaries(str(d / "json")))
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


@pytest.mark.parametrize("table", CS.DM_FACT_TABLES)
def test_phase_fact_tables_match_jax(phase, table):
    j, t = phase["jax"], phase["port"]
    assert t.pre[table] == j.pre[table]
    assert t.after[table] == j.after[table]
    assert t.after[table] != t.pre[table]  # the functions changed it


def test_phase_rows_affected_match_jax(phase):
    j, t = phase["jax"], phase["port"]
    assert [(f, n) for f, n, _ in t.stmts] == [(f, n) for f, n, _ in j.stmts]
    assert len(t.stmts) == 7 * 3 + 3 * 6 + 3
    assert all(n > 0 for f, n, _ in t.stmts if f.startswith("LF_")
               and n is not None)


def test_phase_df_deletes_equal_pyarrow_counts(phase):
    """chip_smoke.expected_dm_deletes (the card's gate) counts what the
    engine deleted, statement by statement."""
    for p in phase.values():
        got = {}
        for f, n, _ in p.stmts:
            if f.startswith("DF_"):
                got.setdefault(f, []).append(n)
        assert got == p.deletes
    assert sum(map(sum, phase["port"].deletes.values())) > 0


def test_phase_statuses_and_time_log_rows_match_jax(phase):
    for p in phase.values():
        assert {q: s["queryStatus"] for q, s in p.summaries.items()} == {
            q: ["Completed"] for q in TM.DM_FUNCS}
        assert [r for r, _ in p.log] == CS.dm_time_log_rows(
            TM.DM_FUNCS, optimize=True)
        assert p.tdm > 0
    assert phase["port"].files == phase["jax"].files


def test_phase_branches_match_jax(phase):
    """Each statement takes the same joins and DISTINCTs in both engines
    (the views' left outer joins over string keys, the DELETEs' mark joins;
    aggregations may fuse in the JAX one)."""
    j, t = phase["jax"], phase["port"]
    assert [structural(e) for _, _, e in t.stmts] == [
        structural(e) for _, _, e in j.stmts]
    took = {b for _, _, e in t.stmts for b in e}
    assert {"left hash join, 1 key", "left dense join, 1 key",
            "mark dense join, 1 key", "distinct"} <= took


def test_phase_launches_the_kernels_chip_smoke_gates(phase):
    assert set(phase["port"].calls) == set(CS.MAINTENANCE_KERNELS)


def test_phase_rollback_restores_both(phase):
    for p in phase.values():
        assert p.back == p.pre


def test_get_maintenance_queries_matches_jax(data):
    got = {}
    for p in PKGS.values():
        s = p.session()
        p.M.register_refresh_views(s, str(data / "refresh"))
        got[p.name] = p.M.get_maintenance_queries(
            s, p.M.MAINTENANCE_SQL_DIR, p.M.get_valid_query_names(None))
    assert got["port"] == got["jax"]
    assert len(got["port"]["DF_SS"]) == 6 and "DATE1" not in str(got)


def test_chip_smoke_sf100_range_is_a_generated_one(data):
    assert CS.MAINTENANCE_SF100_RANGE in CS.delete_ranges(
        str(data / "refresh"))["delete"]


def _stream(data):
    from nds_tpu_torch.cli import gen_query_stream as TQ

    d = data / "streams"
    if not d.exists():
        TQ.main(["--scale", "0.01", "--streams", "1", "--rngseed",
                 "19620718", "--output_dir", str(d)])
    return str(d / "query_0.sql")


def test_maintenance_under_load_on_the_port(data, tmp_path):
    """The port's under-load run at SF0.01: the refresh functions and a
    vacuum race three statements of stream 0; every statement completes,
    the vacuum removes files and none a reader lease holds."""
    wh = str(tmp_path / "wh")
    shutil.copytree(str(data / "wh"), wh)
    with CS.audited_vacuums(TT) as vacuums:
        report = TM.run_maintenance_under_load(
            wh, str(data / "refresh"), _stream(data),
            str(tmp_path / "time.csv"),
            report_path=str(tmp_path / "report.json"),
            spec_queries=["LF_SS", "DF_SS"],
            sub_queries=["query3", "query7", "query52"], device="cpu")
    assert report == json.load(open(tmp_path / "report.json"))
    assert report["dm_functions"] == 2 and report["dm_failed"] == 0
    assert report["under_load_failed"] == 0 and report["solo_failed"] == 0
    assert report["query_p99_ms_solo"] > 0
    assert report["query_p99_degradation"] > 0
    assert report["dm_functions_per_s"] > 0
    assert report["vacuums"] > 0 and report["vacuum_files_removed"] > 0
    assert not [v for v in vacuums if v[2]]
    tags = {r[0].split(":")[0] for r in CS.read_dm_time_log(
        str(tmp_path / "time.csv"))}
    assert {"warmup", "solo", "under_load", "dm",
            "Maintenance Under Load Time"} <= tags


def test_under_load_dm_thread_failure_is_loud(data, tmp_path):
    """An injected io fault escaping the under-load vacuum: the report
    carries dm_error, and the run raises after writing it."""
    wh = str(tmp_path / "wh")
    shutil.copytree(str(data / "wh"), wh)
    TF.install("io:vacuum:store_sales:1")
    with pytest.raises(RuntimeError, match="DM thread failed"):
        TM.run_maintenance_under_load(
            wh, str(data / "refresh"), _stream(data),
            str(tmp_path / "time.csv"),
            report_path=str(tmp_path / "report.json"),
            spec_queries=["LF_SS"], sub_queries=["query52"], device="cpu")
    report = json.load(open(tmp_path / "report.json"))
    assert "TransientIOError" in report["dm_error"]
    assert report["dm_functions"] == 1


def test_register_nds_tables_maintenance_matches_jax(data, tmp_path):
    """register_nds_tables(..., maintenance=True) registers the refresh
    staging tables of a transcoded --update warehouse, as the JAX
    package's does, with the same rows."""
    wh = str(tmp_path / "refresh_wh")
    TTC.main([str(data / "refresh"), wh, str(tmp_path / "r.report"),
              "--update"])
    out = {}
    for p in PKGS.values():
        s = p.session()
        s.register_nds_tables(wh, maintenance=True)
        out[p.name] = (
            sorted(s.catalog.entries),
            s.sql("select count(*) c, sum(plin_quantity) q from "
                  "s_purchase_lineitem").to_pylist())
    assert out["port"] == out["jax"]
    assert "s_purchase" in out["port"][0] and out["port"][1][0]["c"] > 0
