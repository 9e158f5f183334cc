"""The port's lakehouse (nds_tpu_torch/lakehouse/, the catalog's lakehouse
entry, the planner's snapshot pins and zone-map pruning) against the JAX
package's (nds_tpu/lakehouse/).

Every table is made under `tmp_path` from seeded numpy data. The on-disk
format is shared, so the strongest check is cross-reading: each package
reads the table the other wrote. The cases of the JAX package's
tests/test_lakehouse_txn.py (snapshot reads, the commit-conflict matrix,
crash hygiene, vacuum under reader leases, rollback) and of
tests/test_catalog.py's fs backend (epoch names, the conflict matrix, the
fence, the fenced zombie, cross-host leases, the heartbeat) run against
both packages, parametrised by `pkg`, with the reference's expected
outcome for each. Their DML cases run in tests/test_torch_dml.py and their
trace-event cases in tests/test_torch_obs.py; the tcp coordinator waits
for ROADMAP.md queue 1 item 12b.

Tolerance: exact. Rows, versions, file stats, manifests (after pids,
epochs, uuids and timestamps in names are normalised away: files compare
by content) and row counts are equal; SQL answers are integers and
decimals, equal exactly.
"""

import json
import os
import posixpath
import sys
import threading
import time
import uuid
from decimal import Decimal
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest

from nds_tpu import faults as JF
from nds_tpu.analysis import budget as JB
from nds_tpu.engine.session import Session as JaxSession
from nds_tpu.lakehouse import catalog as JC
from nds_tpu.lakehouse import leases as JL
from nds_tpu.lakehouse import table as JT
from nds_tpu.lakehouse import zonemap as JZ
from nds_tpu.report import BenchReport as JaxReport
from nds_tpu_torch import faults as TF
from nds_tpu_torch.analysis import budget as TB
from nds_tpu_torch.engine import plan as TPLAN
from nds_tpu_torch.engine.session import Session as TorchSession
from nds_tpu_torch.lakehouse import catalog as TC
from nds_tpu_torch.lakehouse import leases as TL
from nds_tpu_torch.lakehouse import table as TT
from nds_tpu_torch.lakehouse import zonemap as TZ
from nds_tpu_torch.report import BenchReport as TorchReport

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401

PKGS = {
    "jax": SimpleNamespace(
        name="jax", T=JT, C=JC, L=JL, Z=JZ, faults=JF, Report=JaxReport,
        session=lambda **conf: JaxSession(
            conf={"engine.aot_cache_dir": "", "engine.plan_cache": "off",
                  **conf})),
    "port": SimpleNamespace(
        name="port", T=TT, C=TC, L=TL, Z=TZ, faults=TF, Report=TorchReport,
        session=lambda **conf: TorchSession(conf=conf, device="cpu")),
}

_ENV = ("NDS_LAKE_CATALOG", "NDS_LAKE_COMMIT_BACKOFF", "NDS_LAKE_WRITER_TTL_S",
        "NDS_LAKE_LEASE_TTL_S", "NDS_HEARTBEAT_INTERVAL_MS",
        "NDS_LAKE_COMMIT_RETRIES", "NDS_LAKE_CONFLICT_RETRIES",
        "NDS_FAULT_SPEC")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NDS_LAKE_COMMIT_BACKOFF", "0")
    monkeypatch.setenv("NDS_FLIGHT_RECORDER", "off")
    for p in PKGS.values():
        p.faults.reset()
        p.C.reset_clients()
        p.T._COMMIT_HOOK = None
    yield
    for p in PKGS.values():
        p.faults.reset()
        p.C.reset_clients()
        p.T._COMMIT_HOOK = None


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _ints(*vals):
    return pa.table({"a": pa.array(list(vals), type=pa.int64())})


def _make(p, tmp_path, *vals):
    path = str(tmp_path / "t")
    return p.T.LakehouseTable.create(path, _ints(*vals)), path


def _vals(p, path):
    return sorted(x["a"] for x in
                  p.T.LakehouseTable(path).dataset().to_table().to_pylist())


def _versions(p, path):
    return [v for v, _, _ in p.T.LakehouseTable(path).versions()]


def _data_files(path):
    return sorted(os.listdir(os.path.join(path, "data")))


def _manifests(path):
    return sorted(f for f in os.listdir(os.path.join(path, "_manifests"))
                  if f.startswith("v"))


def _report(p, session, fn, retry_oom=False):
    kw = {"name": "txn"} if p.name == "jax" else {}
    return p.Report(session).report_on(fn, retry_oom=retry_oom, **kw)


class _Sess:
    """Minimal session facade for BenchReport."""

    def __init__(self):
        self.conf = {}
        self.tracer = None
        self.metrics = None

    def register_listener(self, cb):
        pass

    def unregister_listener(self, cb):
        pass


# ---------------------------------------------------------------------------
# seeded fact-like data: several clustered files with zone maps
# ---------------------------------------------------------------------------

FACT_ROWS = 6000
FACT_CHUNKS = 3
#: small files, so each chunk splits into several key ranges
FACT_FILE_BYTES = 24_000


def _fact_chunk(seed, n=FACT_ROWS // FACT_CHUNKS):
    rng = np.random.default_rng(seed)
    date = rng.integers(2450800, 2451900, n)
    date = np.where(rng.random(n) < 0.02, -1, date)
    cents = rng.integers(-50_000, 500_000, n)
    words = np.array(["alpha", "beta", "gamma", "delta", "omega"])
    return pa.table({
        "ss_sold_date_sk": pa.array(date, mask=date < 0, type=pa.int64()),
        "ss_item_sk": pa.array(rng.integers(1, 400, n), type=pa.int64()),
        "ss_quantity": pa.array(rng.integers(1, 100, n), type=pa.int32()),
        "ss_ext_sales_price": pa.array(
            [Decimal(int(c)).scaleb(-2) for c in cents],
            type=pa.decimal128(7, 2)),
        "ss_store": pa.array(words[rng.integers(0, 5, n)]),
    })


def _write_fact(p, path):
    """A fact table of FACT_CHUNKS ledgered chunks, each clustered on the
    date key into small files. Returns the table."""
    lt = p.T.LakehouseTable.create(path, schema=_fact_chunk(0).schema)
    for i in range(FACT_CHUNKS):
        lt.ingest_chunk(_fact_chunk(100 + i), f"store_sales:chunk{i}",
                        cluster_by="ss_sold_date_sk",
                        max_file_bytes=FACT_FILE_BYTES)
    return lt


@pytest.fixture(scope="module")
def facts(tmp_path_factory):
    """{writer package: fact table path}: the same seeded chunks written
    by each package."""
    out = {}
    for name, p in PKGS.items():
        d = tmp_path_factory.mktemp(f"fact_{name}")
        _write_fact(p, str(d / "store_sales"))
        out[name] = str(d / "store_sales")
    return out


def _rows(tbl):
    """A table's rows as a multiset (None sorts first)."""
    return sorted((tuple((v is not None, v) for v in r.values())
                   for r in tbl.to_pylist()))


def _file_key(fs_table, rel):
    """A data file's identity by content: its rows in order."""
    import pyarrow.parquet as pq

    with open(posixpath.join(fs_table.root, rel), "rb") as fh:
        return tuple(tuple(r.values()) for r in pq.read_table(fh).to_pylist())


# ---------------------------------------------------------------------------
# cross-reading: each package reads the table the other wrote
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", sorted(PKGS))
@pytest.mark.parametrize("reader", sorted(PKGS))
def test_cross_read_fact_table(facts, writer, reader):
    path = facts[writer]
    w = PKGS[writer].T.LakehouseTable(path)
    r = PKGS[reader].T.LakehouseTable(path)
    assert r.versions() == w.versions()
    assert r.current_version() == w.current_version() == FACT_CHUNKS + 1
    ws, rs = w.snapshot(), r.snapshot()
    assert rs.rel_files == ws.rel_files and len(rs.rel_files) > FACT_CHUNKS
    assert rs.file_stats() == ws.file_stats()
    assert rs.num_rows() == ws.num_rows() == FACT_ROWS
    assert rs.ingest_chunks() == {f"store_sales:chunk{i}"
                                  for i in range(FACT_CHUNKS)}
    assert _rows(rs.dataset().to_table()) == _rows(ws.dataset().to_table())
    for v in range(1, FACT_CHUNKS + 2):
        assert r.snapshot(v).manifest == w.snapshot(v).manifest


def test_both_writers_write_the_same_table(facts):
    """The same seeded chunks give the same manifests in both packages
    (file names aside) and the same rows in every file."""
    j = JT.LakehouseTable(facts["jax"])
    t = TT.LakehouseTable(facts["port"])
    assert [(v, op) for v, _, op in t.versions()] == [
        (v, op) for v, _, op in j.versions()]
    for v in range(1, FACT_CHUNKS + 2):
        assert _norm_manifest(t, t.snapshot(v).manifest) == _norm_manifest(
            j, j.snapshot(v).manifest)


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_cross_read_through_sql(facts, writer):
    sql = ("select ss_store, count(*) c, sum(ss_ext_sales_price) s, "
           "sum(ss_quantity) q from store_sales group by ss_store "
           "order by ss_store")
    got = {}
    for name, p in PKGS.items():
        s = p.session()
        s.register_lakehouse("store_sales", facts[writer])
        got[name] = s.sql(sql).to_pylist()
    assert got["port"] == got["jax"] and len(got["port"]) == 5


# ---------------------------------------------------------------------------
# zone maps
# ---------------------------------------------------------------------------

def _zone_batches(case, seed):
    rng = np.random.default_rng(seed)
    n = 257
    if case == "ints":
        v = rng.integers(-1000, 1000, n)
        return [pa.record_batch({"x": pa.array(v, mask=rng.random(n) < 0.1)})]
    if case == "floats_nan":
        v = rng.normal(size=n)
        v[rng.integers(0, n)] = np.nan
        return [pa.record_batch({"x": pa.array(v[: n // 2])}),
                pa.record_batch({"x": pa.array(v[n // 2:])})]
    if case == "floats":
        return [pa.record_batch({"x": pa.array(rng.normal(size=n))})
                for _ in range(3)]
    if case == "all_null":
        return [pa.record_batch({"x": pa.nulls(n, pa.int64()),
                                 "y": pa.array(rng.integers(0, 9, n))})]
    if case == "strings":
        words = ["a" * rng.integers(1, 120) + chr(97 + i) for i in range(n)]
        return [pa.record_batch({"x": pa.array(words)})]
    if case == "strings_ceiling":
        top = chr(0x10FFFF) * 70
        return [pa.record_batch({"x": pa.array(["b", top, "c" * 80])})]
    if case == "strings_round_up":
        s = "m" * 63 + chr(0x10FFFF) + "tail"
        return [pa.record_batch({"x": pa.array(["a", s])})]
    if case == "decimals":
        return [pa.record_batch({"x": pa.array(
            [Decimal(int(c)).scaleb(-2) for c in rng.integers(0, 9999, n)],
            type=pa.decimal128(7, 2))})]
    if case == "mixed":
        return [pa.record_batch({
            "b": pa.array(rng.random(n) < 0.5),
            "d": pa.array(rng.integers(0, 20000, n).astype("datetime64[D]")),
            "i": pa.array(rng.integers(0, 5, n), type=pa.int32()),
            "s": pa.array(rng.choice(["x", "yy", None], n)),
        })]
    raise KeyError(case)


ZONE_CASES = ("ints", "floats_nan", "floats", "all_null", "strings",
              "strings_ceiling", "strings_round_up", "decimals", "mixed")


@pytest.mark.parametrize("case", ZONE_CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_stats_accumulator_matches_jax(case, seed):
    acc = {}
    for name, p in PKGS.items():
        a = p.Z.StatsAccumulator()
        for b in _zone_batches(case, seed):
            a.update(b)
        acc[name] = a.finish()
    assert acc["port"] == acc["jax"]
    json.dumps(acc["port"])  # manifest-safe


def _random_stats(rng, n_files):
    stats, files = {}, []
    for i in range(n_files):
        rel = f"data/part-{i}.parquet"
        files.append(rel)
        rows = int(rng.integers(0, 50))
        cols = {}
        lo = int(rng.integers(0, 100))
        ent = {"nulls": int(rng.integers(0, rows + 1))}
        if rng.random() < 0.8:
            ent.update(min=lo, max=lo + int(rng.integers(0, 30)))
        cols["k"] = ent
        w = sorted(rng.choice(["ant", "bee", "cat", "dog", "eel"], 2))
        cols["s"] = {"nulls": 0, "min": str(w[0]), "max": str(w[1])}
        if rng.random() < 0.9:
            stats[rel] = {"rows": rows, "columns": cols}
    return files, stats


PREDS = [
    [("cmp", "k", "=", 40)], [("cmp", "k", "<", 20)],
    [("cmp", "k", ">=", 90)], [("cmp", "k", "<=", 5), ("notnull", "k")],
    [("between", "k", 30, 45)], [("in", "k", (1, 50, 99))],
    [("notnull", "k")], [("cmp", "s", "=", "cat")],
    [("between", "s", "b", "c")], [("cmp", "k", "=", "text")],
    [("cmp", "k", "=", True)], [("cmp", "missing", ">", 3)],
    [("cmp", "k", ">", 60), ("in", "s", ("eel",))], [],
]


@pytest.mark.parametrize("i", range(len(PREDS)))
def test_prune_files_matches_jax(i):
    rng = np.random.default_rng(i)
    files, stats = _random_stats(rng, 40)
    got = TZ.prune_files(files, stats, PREDS[i])
    assert got == JZ.prune_files(files, stats, PREDS[i])
    for rel in files:
        assert TZ.file_may_match(stats.get(rel), PREDS[i]) == (
            JZ.file_may_match(stats.get(rel), PREDS[i]))


# ---------------------------------------------------------------------------
# manifests: one sequence of operations through both packages
# ---------------------------------------------------------------------------

def _norm_manifest(lt, m):
    """A manifest with its files named by content and its timestamp
    dropped."""
    out = {k: v for k, v in m.items()
           if k not in ("timestamp_ms", "files", "stats")}
    keys = [_file_key(lt, f) for f in m["files"]]
    out["files"] = keys
    out["stats"] = {_file_key(lt, f): s
                    for f, s in (m.get("stats") or {}).items()}
    return out


def _sequence(p, path):
    """The same operations in both packages; returns each step's result
    with names and timestamps normalised away."""
    seq = []
    lt = p.T.LakehouseTable.create(path, _ints(*range(10)))
    seq.append(lt.append(_ints(10, 11)))
    seq.append(lt.replace(_ints(5, 6, 7)))
    chunk = _fact_chunk(7, 300).select(["ss_sold_date_sk", "ss_item_sk"])
    chunk = chunk.rename_columns(["a", "b"]).select(["a"])
    seq.append(lt.ingest_chunk(chunk, "t:c1", cluster_by="a",
                               max_file_bytes=800))
    seq.append(lt.ingest_chunk(chunk, "t:c1", cluster_by="a"))
    seq.append(lt.ingest_chunk(_ints(*range(100, 140)), "t:c2",
                               cluster_by="a", max_file_bytes=200))
    ts2 = dict((v, t) for v, t, _ in lt.versions())[2]
    res = lt.compact(target_bytes=1 << 20, min_input_files=2)
    seq.append({k: v for k, v in res.items()})
    seq.append(lt.rollback_to_version(4))
    seq.append(lt.rollback_to_timestamp(ts2))
    seq.append(lt.expire_snapshots(retain_last=4))
    res = lt.vacuum(retain_last=3)
    res.pop("removed")
    seq.append(res)
    seq.append([(v, op) for v, _, op in lt.versions()])
    seq.append([_norm_manifest(lt, lt.snapshot(v).manifest)
                for v, _, _ in lt.versions()])
    seq.append(_rows(lt.dataset().to_table()))
    return seq


def test_manifest_sequence_matches_jax(tmp_path):
    j = _sequence(PKGS["jax"], str(tmp_path / "jax" / "t"))
    t = _sequence(PKGS["port"], str(tmp_path / "port" / "t"))
    assert len(t) == len(j)
    for i, (a, b) in enumerate(zip(t, j)):
        assert a == b, i
    # the compaction rewrote files, vacuum collected the expired ones
    assert j[5]["files_in"] > 2 and j[9]["files_removed"] > 0


# ---------------------------------------------------------------------------
# snapshot-isolated reads (tests/test_lakehouse_txn.py)
# ---------------------------------------------------------------------------

def test_snapshot_handle_pins_version(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 1, 2, 3)
    snap = lt.snapshot()
    lt.replace(_ints(9))
    assert snap.dataset().count_rows() == 3
    assert snap.num_rows() == 3
    assert lt.dataset().count_rows() == 1
    assert lt.snapshot(1).dataset().count_rows() == 3


def test_session_pin_survives_racing_replace(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, *range(15))
    s = pkg.session()
    s.register_lakehouse("t", path)
    baseline = s.sql("select a from t order by a").collect()
    r = s.sql("select a from t order by a")  # plan: pins v1
    pkg.T.LakehouseTable(path).replace(_ints(99))
    s.recover_memory("test: force reload through the pin")
    assert r.collect().equals(baseline)
    r2 = s.sql("select a from t order by a")
    assert r2.collect().equals(r2.collect())
    assert s.sql("select count(*) c from t").to_pylist() == [{"c": 1}]


def test_pin_registers_and_releases_reader_lease(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 1, 2)
    root = pkg.T.LakehouseTable(path).root
    s = pkg.session()
    s.register_lakehouse("t", path)
    before = pkg.L.LEASES.live_count(root)
    s.sql("select count(*) c from t").collect()
    assert pkg.L.LEASES.live_count(root) == before + 1
    e = s.catalog.entries["t"]
    assert e.pinned_version == 1 and e.lease_id is not None
    s.catalog.invalidate("t")
    assert pkg.L.LEASES.live_count(root) == before
    assert e.pinned_version is None and e.lease_id is None


def test_shared_session_concurrent_repin_serves_plan_version(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 1, 2, 3)
    s = pkg.session()
    s.register_lakehouse("t", path)
    r_old = s.sql("select a from t order by a")  # pins v1
    old = r_old.collect()
    pkg.T.LakehouseTable(path).replace(_ints(9))
    assert s.sql("select count(*) c from t").to_pylist() == [{"c": 1}]
    r_old._table = None  # re-execute the v1 plan on the re-pinned entry
    assert r_old.collect().equals(old)
    # the detached read served the plan and left the entry's cache at v2
    assert s.catalog.entries["t"].pinned_version == 2


# ---------------------------------------------------------------------------
# the commit-conflict matrix
# ---------------------------------------------------------------------------

def test_append_append_rebase_converges_both_rows(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 0)
    fired = []

    def land_competitor(name, op, version):
        if not fired:
            fired.append(version)
            pkg.T._COMMIT_HOOK = None
            pkg.T.LakehouseTable(path).append(_ints(100))

    pkg.T._COMMIT_HOOK = land_competitor
    pkg.T.LakehouseTable(path).append(_ints(200))
    assert _vals(pkg, path) == [0, 100, 200]
    assert fired == [2]
    assert _versions(pkg, path) == [1, 2, 3]


def test_overwrite_conflict_aborts_and_discards_staged(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 1, 2, 3)

    def land_append(name, op, version):
        pkg.T._COMMIT_HOOK = None
        pkg.T.LakehouseTable(path).append(_ints(50))

    before = set(_data_files(path))
    pkg.T._COMMIT_HOOK = land_append
    with pytest.raises(pkg.T.CommitConflictError):
        pkg.T.LakehouseTable(path).replace(_ints(7))
    assert len(set(_data_files(path)) - before) == 1
    assert _vals(pkg, path) == [1, 2, 3, 50]


def test_two_inprocess_writers_same_version_oracle(pkg, tmp_path,
                                                   monkeypatch):
    lt, path = _make(pkg, tmp_path, 0)
    monkeypatch.setenv("NDS_LAKE_COMMIT_RETRIES", "0")

    def land_append(name, op, version):
        pkg.T._COMMIT_HOOK = None
        pkg.T.LakehouseTable(path).append(_ints(1))

    pkg.T._COMMIT_HOOK = land_append
    with pytest.raises(pkg.T.LakehouseError) as ei:
        pkg.T.LakehouseTable(path).append(_ints(2))
    assert "concurrent commit conflict" in str(ei.value)
    assert _versions(pkg, path) == [1, 2]
    monkeypatch.delenv("NDS_LAKE_COMMIT_RETRIES")

    def land_replace(name, op, version):
        pkg.T._COMMIT_HOOK = None
        pkg.T.LakehouseTable(path).replace(_ints(77))

    pkg.T._COMMIT_HOOK = land_replace
    with pytest.raises(pkg.T.CommitConflictError):
        pkg.T.LakehouseTable(path).replace(_ints(88))
    assert _vals(pkg, path) == [77]


def test_deterministic_two_thread_schedule(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 0)
    a_at_commit = threading.Event()
    b_done = threading.Event()

    def hook(name, op, version):
        if threading.current_thread().name == "writer-a":
            pkg.T._COMMIT_HOOK = None
            a_at_commit.set()
            assert b_done.wait(10)

    pkg.T._COMMIT_HOOK = hook
    errs = []

    def writer_a():
        try:
            pkg.T.LakehouseTable(path).append(_ints(1))
        except Exception as e:  # surfaces below
            errs.append(e)

    ta = threading.Thread(target=writer_a, name="writer-a")
    ta.start()
    assert a_at_commit.wait(10)
    pkg.T.LakehouseTable(path).append(_ints(2))
    b_done.set()
    ta.join(10)
    assert not errs
    assert _vals(pkg, path) == [0, 1, 2]


def test_commit_conflict_walks_ladder_then_succeeds(pkg):
    attempts = []

    def txn():
        attempts.append(1)
        if len(attempts) == 1:
            raise pkg.T.CommitConflictError(
                "concurrent commit conflict at version 9; retry")

    summary = _report(pkg, _Sess(), txn, retry_oom=True)
    assert summary["queryStatus"] == ["CompletedWithTaskFailures"]
    assert [r["rung"] for r in summary["ladder"]] == ["commit_rebase_retry"]
    assert summary["ladder"][0]["kind"] == pkg.faults.COMMIT_CONFLICT
    assert len(attempts) == 2


def test_commit_conflict_budget_exhausts_to_hard_failure(pkg, monkeypatch):
    monkeypatch.setenv("NDS_LAKE_CONFLICT_RETRIES", "2")

    def txn():
        raise pkg.T.CommitConflictError(
            "concurrent commit conflict at version 3")

    summary = _report(pkg, _Sess(), txn, retry_oom=True)
    assert summary["queryStatus"] == ["Failed"]
    assert summary["failureKind"] == pkg.faults.COMMIT_CONFLICT
    assert [r["rung"] for r in summary["ladder"]] == [
        "commit_rebase_retry", "commit_rebase_retry"]


def test_commit_conflict_without_retry_opt_in_fails_fast(pkg):
    def txn():
        raise pkg.T.CommitConflictError(
            "concurrent commit conflict at version 3")

    summary = _report(pkg, _Sess(), txn)
    assert summary["queryStatus"] == ["Failed"]
    assert "ladder" not in summary


def test_conflict_knob_parsing_single_home(pkg, monkeypatch):
    monkeypatch.setenv("NDS_LAKE_CONFLICT_RETRIES", "7")
    assert pkg.T.resolve_conflict_retries() == 7
    monkeypatch.setenv("NDS_LAKE_CONFLICT_RETRIES", "junk")
    assert pkg.T.resolve_conflict_retries() == 2
    monkeypatch.delenv("NDS_LAKE_CONFLICT_RETRIES")
    assert pkg.T.commit_backoff_base() == 0.0
    for v in ("3", "-1", "x", ""):
        monkeypatch.setenv("NDS_LAKE_COMMIT_RETRIES", v)
        assert TT.resolve_commit_retries() == JT.resolve_commit_retries()
    conf = {"engine.lake_compact_target_bytes": "77",
            "engine.lake_compact_min_files": "1"}
    assert (TT.resolve_compact_target_bytes(conf),
            TT.resolve_compact_min_files(conf)) == (
        JT.resolve_compact_target_bytes(conf),
        JT.resolve_compact_min_files(conf))


# ---------------------------------------------------------------------------
# crash hygiene and the fault sites
# ---------------------------------------------------------------------------

def test_crash_at_commit_during_replace_is_all_or_nothing(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 1, 2, 3)
    manifests_before, files_before = _manifests(path), _data_files(path)
    pkg.faults.install("crash:commit:t")
    with pytest.raises(pkg.faults.InjectedCrash):
        pkg.T.LakehouseTable(path).replace(_ints(9))
    pkg.faults.reset()
    assert _manifests(path) == manifests_before
    assert pkg.T.LakehouseTable(path).current_version() == 1
    assert _vals(pkg, path) == [1, 2, 3]
    assert len(set(_data_files(path)) - set(files_before)) == 1


def test_crash_at_stage_never_loses_committed_snapshot(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 1, 2, 3)
    manifests_before = _manifests(path)
    pkg.faults.install("crash:stage:t")
    with pytest.raises(pkg.faults.InjectedCrash):
        pkg.T.LakehouseTable(path).append(_ints(4))
    pkg.faults.reset()
    assert _manifests(path) == manifests_before
    assert _vals(pkg, path) == [1, 2, 3]


def test_stage_write_io_fault_walks_io_ladder(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 1)
    pkg.faults.install("io:stage:t:1")
    summary = _report(
        pkg, _Sess(), lambda: pkg.T.LakehouseTable(path).append(_ints(2)),
        retry_oom=True)
    assert summary["queryStatus"] == ["CompletedWithTaskFailures"]
    assert [r["rung"] for r in summary["ladder"]] == ["io_backoff_retry"]
    assert pkg.T.LakehouseTable(path).num_rows() == 2


def test_manifest_read_io_fault_site(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 1)
    pkg.faults.install("io:manifest:t:1")
    with pytest.raises(pkg.faults.TransientIOError):
        pkg.T.LakehouseTable(path).snapshot()
    pkg.faults.reset()
    assert pkg.T.LakehouseTable(path).snapshot().version == 1


def test_vacuum_crash_never_loses_committed_snapshot(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 1, 2)
    lt.replace(_ints(3))
    lt.replace(_ints(4))
    pkg.faults.install("crash:vacuum:t")
    with pytest.raises(pkg.faults.InjectedCrash):
        pkg.T.LakehouseTable(path).vacuum(retain_last=1)
    pkg.faults.reset()
    lt2 = pkg.T.LakehouseTable(path)
    for v, _, _ in lt2.versions():
        for f in lt2.snapshot(v).files():
            assert os.path.exists(f)
    res = lt2.vacuum(retain_last=1)
    assert res["manifests_removed"] == 2 and res["files_removed"] == 2
    assert lt2.dataset().to_table().to_pylist() == [{"a": 4}]


def test_orphan_sweep_units(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 1, 2)
    data = os.path.join(path, "data")
    mans = os.path.join(path, "_manifests")
    dead_stage = "part-999999-abcdefabcdef.parquet"
    live_stage = f"part-{os.getpid()}-abcdefabcdef.parquet"
    torn_tmp = ".tmp-999999-deadbeef.json"
    live_tmp = f".tmp-{os.getpid()}-deadbeef.json"
    foreign = "somebody-elses.file"
    legacy = "part-abcdefabcdef.parquet"
    for n in (dead_stage, live_stage, foreign, legacy):
        open(os.path.join(data, n), "w").close()
    for n in (torn_tmp, live_tmp):
        open(os.path.join(mans, n), "w").close()
    assert lt.sweep_orphans() == 2
    remaining = set(os.listdir(data))
    assert dead_stage not in remaining
    assert {live_stage, foreign, legacy} <= remaining
    man_remaining = set(os.listdir(mans))
    assert torn_tmp not in man_remaining and live_tmp in man_remaining
    assert lt.dataset().count_rows() == 2


def test_session_start_sweep_removes_crashed_writer_orphans(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 1)
    orphan = "part-999999-abcdefabcdef.parquet"
    open(os.path.join(path, "data", orphan), "w").close()
    s = pkg.session()
    s.register_lakehouse("t", path)
    assert orphan not in _data_files(path)
    lt2 = pkg.T.LakehouseTable(path)
    referenced = set()
    for v, _, _ in lt2.versions():
        referenced.update(posixpath.basename(f)
                          for f in lt2.snapshot(v).files())
    assert set(_data_files(path)) == referenced


def test_register_nds_tables_sweeps_lakehouse_tables(pkg, tmp_path):
    path = str(tmp_path / "store")
    pkg.T.LakehouseTable.create(path, _ints(1))
    orphan = "part-999999-abcdefabcdef.parquet"
    open(os.path.join(path, "data", orphan), "w").close()
    s = pkg.session()
    s.register_nds_tables(str(tmp_path), "lakehouse")
    assert sorted(s.catalog.entries) == ["store"]
    assert s.catalog.entries["store"].fmt == "lakehouse"
    assert orphan not in _data_files(path)


# ---------------------------------------------------------------------------
# vacuum and reader leases
# ---------------------------------------------------------------------------

def test_vacuum_respects_retention_and_reader_leases(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, *range(10))
    lt.replace(_ints(1, 2))
    lt.replace(_ints(3))
    lt.replace(_ints(4))
    root = pkg.T.LakehouseTable(path).root
    snap1 = lt.snapshot(1)
    lease = pkg.L.LEASES.acquire(root, 1, snap1.rel_files, ttl_s=60)
    res = lt.vacuum(retain_last=2)
    assert res["manifests_removed"] == 1 and res["files_removed"] == 1
    assert [v for v, _, _ in lt.versions()] == [1, 3, 4]
    for v, _, _ in lt.versions():
        for f in lt.snapshot(v).files():
            assert os.path.exists(f)
    os.unlink(os.path.join(path, "_manifests", "v000001.json"))
    res2 = lt.vacuum(retain_last=2)
    assert res2["files_leased"] == 1
    assert posixpath.basename(snap1.rel_files[0]) in set(_data_files(path))
    pkg.L.LEASES.release(lease)


def test_expired_lease_no_longer_blocks_vacuum(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 1)
    lt.replace(_ints(2))
    root = pkg.T.LakehouseTable(path).root
    snap1 = lt.snapshot(1)
    pkg.L.LEASES.acquire(root, 1, snap1.rel_files, ttl_s=0.05)
    time.sleep(0.1)
    res = lt.vacuum(retain_last=1)
    assert res["manifests_removed"] == 1 and res["files_removed"] == 1
    assert posixpath.basename(snap1.rel_files[0]) not in set(
        _data_files(path))


def test_vacuum_never_deletes_file_under_live_session_pin(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, *range(5))
    s = pkg.session()
    s.register_lakehouse("t", path)
    r = s.sql("select a from t order by a")  # pins v1, leases its files
    baseline = r.collect()
    pkg.T.LakehouseTable(path).replace(_ints(9))
    res = pkg.T.LakehouseTable(path).vacuum(retain_last=1)
    s.recover_memory("test: force re-read through the pin")
    r._table = None
    assert r.collect().equals(baseline)
    assert res["files_removed"] == 0


def test_expire_snapshots_keeps_head_always(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 1)
    assert lt.expire_snapshots(retain_last=1) == []
    assert [v for v, _, _ in lt.versions()] == [1]


def test_lease_table_units(pkg):
    lt = pkg.L.ReaderLeases()
    i1 = lt.acquire("/r", 3, ["data/a", "data/b"], ttl_s=60)
    i2 = lt.acquire("/r", 4, ["data/c"], ttl_s=60)
    lt.acquire("/other", 1, ["data/z"], ttl_s=60)
    assert lt.held_versions("/r") == {3, 4}
    assert lt.held_files("/r") == {"data/a", "data/b", "data/c"}
    assert lt.live_count("/r") == 2
    assert lt.release(i1) and not lt.release(i1)
    assert lt.held_files("/r") == {"data/c"}
    assert lt.renew(i2, ttl_s=60)
    i3 = lt.acquire("/r", 5, ["data/d"], ttl_s=0.01)
    time.sleep(0.05)
    assert 5 not in lt.held_versions("/r")
    assert not lt.renew(i3, ttl_s=60)


@pytest.mark.parametrize("v", [None, "", "12.5", "-3", "junk"])
def test_lease_ttl_resolution_matches_jax(v, monkeypatch):
    if v is not None:
        monkeypatch.setenv("NDS_LAKE_LEASE_TTL_S", v)
        monkeypatch.setenv("NDS_LAKE_WRITER_TTL_S", v)
    conf = {"engine.lake_lease_ttl_s": v} if v == "12.5" else None
    assert TL.resolve_lease_ttl(conf) == JL.resolve_lease_ttl(conf)
    assert TC.resolve_writer_ttl(conf) == JC.resolve_writer_ttl(conf)


def test_versions_tolerates_concurrently_expired_manifest(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 1)
    lt.append(_ints(2))

    class _FlakyFS:
        def __init__(self, inner, fail_substr):
            self._inner = inner
            self._sub = fail_substr
            self._fired = False

        def open(self, p, *a, **kw):
            if not self._fired and self._sub in str(p):
                self._fired = True
                raise FileNotFoundError(p)
            return self._inner.open(p, *a, **kw)

        def __getattr__(self, name):
            return getattr(self._inner, name)

    lt.fs = _FlakyFS(lt.fs, "v000001.json")
    assert [v for v, _, _ in lt.versions()] == [2]
    assert lt.current_version() == 2


def test_remote_warehouse_never_pid_attributes(pkg):
    root = f"memory://lake-{uuid.uuid4().hex}/t"
    lt = pkg.T.LakehouseTable.create(root, _ints(1))
    lt.replace(_ints(2))
    lt.fs.pipe_file(lt.data_dir + "/part-999999-abcdefabcdef.parquet", b"x")
    assert not lt._is_local()
    assert lt.sweep_orphans() == 0
    res = lt.vacuum(retain_last=1)
    names = {f.rsplit("/", 1)[-1] for f in lt.fs.ls(lt.data_dir, detail=False)}
    assert "part-999999-abcdefabcdef.parquet" in names
    assert res["files_removed"] == 1


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_memory_table_cross_read(writer):
    """A memory:// table one package wrote, the other reads."""
    root = f"memory://lake-{uuid.uuid4().hex}/t"
    w = PKGS[writer].T.LakehouseTable.create(root, _ints(3, 1, 2))
    w.append(_ints(7))
    for p in PKGS.values():
        r = p.T.LakehouseTable(root)
        assert r.versions() == w.versions()
        assert sorted(x["a"] for x in r.dataset().to_table().to_pylist()) == [
            1, 2, 3, 7]


# ---------------------------------------------------------------------------
# rollback
# ---------------------------------------------------------------------------

def test_rollback_timestamp_tie_selects_that_snapshot(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 1, 2)
    v1_ts = lt.versions()[0][1]
    lt.append(_ints(3))
    assert lt.rollback_to_timestamp(v1_ts) == 3
    assert lt.dataset().count_rows() == 2
    with pytest.raises(pkg.T.LakehouseError):
        pkg.T.LakehouseTable(path).rollback_to_timestamp(v1_ts - 1)


def test_rollback_of_rollback_replays_right_file_list(pkg, tmp_path):
    lt, path = _make(pkg, tmp_path, 1, 2)
    lt.append(_ints(3))
    v3 = lt.rollback_to_version(1)
    lt.append(_ints(4))
    v3_ts = dict((v, ts) for v, ts, _ in lt.versions())[v3]
    assert lt.rollback_to_timestamp(v3_ts) == 5
    assert lt.snapshot(5).rel_files == lt.snapshot(1).rel_files
    assert _vals(pkg, path) == [1, 2]


# ---------------------------------------------------------------------------
# the fs catalog (tests/test_catalog.py)
# ---------------------------------------------------------------------------

def _make_fs_table(p, tmp_path, monkeypatch, *vals):
    monkeypatch.setenv("NDS_LAKE_CATALOG", "fs")
    p.C.reset_clients()
    return _make(p, tmp_path, *vals)


def test_fs_catalog_commit_roundtrip_and_epoch_names(pkg, tmp_path,
                                                     monkeypatch):
    lt, path = _make_fs_table(pkg, tmp_path, monkeypatch, 1, 2)
    pkg.T.LakehouseTable(path).append(_ints(3))
    assert _vals(pkg, path) == [1, 2, 3]
    assert _versions(pkg, path) == [1, 2]
    names = _data_files(path)
    assert all(pkg.T._DATA_FILE_RE.match(n) for n in names)
    assert all("-e" in n for n in names)
    m = pkg.T._STAGED_RE.match(names[0])
    assert m is not None and m.group(2) is not None
    assert os.path.isdir(os.path.join(path, "_catalog"))


def test_fs_catalog_conflict_matrix_preserved(pkg, tmp_path, monkeypatch):
    lt, path = _make_fs_table(pkg, tmp_path, monkeypatch, 0)

    def land_append(name, op, version):
        pkg.T._COMMIT_HOOK = None
        pkg.T.LakehouseTable(path).append(_ints(100))

    pkg.T._COMMIT_HOOK = land_append
    pkg.T.LakehouseTable(path).append(_ints(200))
    assert _vals(pkg, path) == [0, 100, 200]

    def land_replace(name, op, version):
        pkg.T._COMMIT_HOOK = None
        pkg.T.LakehouseTable(path).replace(_ints(77))

    pkg.T._COMMIT_HOOK = land_replace
    with pytest.raises(pkg.T.CommitConflictError):
        pkg.T.LakehouseTable(path).replace(_ints(88))
    assert _vals(pkg, path) == [77]


def test_fence_advances_past_dead_writers_only(pkg, tmp_path, monkeypatch):
    lt, path = _make_fs_table(pkg, tmp_path, monkeypatch, 1)
    cat = lt.catalog
    live = cat.writer_register(lt, ttl_s=60)
    dead = cat.writer_register(lt, ttl_s=0.01)
    time.sleep(0.05)
    assert cat.bump_fence(lt) == live["epoch"]
    cat.writer_renew(lt, live, 0.0)
    fence2 = cat.bump_fence(lt)
    assert fence2 > live["epoch"] and fence2 > dead["epoch"]


def test_fenced_zombie_never_publishes_and_stage_is_collected(
        pkg, tmp_path, monkeypatch):
    lt, path = _make_fs_table(pkg, tmp_path, monkeypatch, 1, 2)
    monkeypatch.setenv("NDS_LAKE_WRITER_TTL_S", "0.05")
    zombie = pkg.T.LakehouseTable(path)
    staged = zombie._stage(_ints(99))
    stage_name = posixpath.basename(staged[0][0])
    time.sleep(0.1)
    monkeypatch.setattr(pkg.T.LakehouseTable, "_is_local",
                        lambda self: False)
    monkeypatch.delenv("NDS_LAKE_WRITER_TTL_S")
    res = pkg.T.LakehouseTable(path).vacuum(retain_last=2)
    assert stage_name not in _data_files(path)
    assert posixpath.join("data", stage_name) in res["removed"]
    with pytest.raises(pkg.T.CommitConflictError) as ei:
        zombie._commit(staged, "append")
    assert pkg.faults.classify(ei.value) == pkg.faults.COMMIT_CONFLICT
    assert _vals(pkg, path) == [1, 2]


def test_vacuum_never_deletes_under_remote_host_lease(pkg, tmp_path,
                                                      monkeypatch):
    lt, path = _make_fs_table(pkg, tmp_path, monkeypatch, *range(5))
    snap1 = lt.snapshot(1)
    other = pkg.C.FsCatalog()
    remote = other.lease_acquire(pkg.C._TableRef(path), 1, snap1.rel_files,
                                 ttl_s=60)
    assert remote is not None
    pkg.T.LakehouseTable(path).replace(_ints(9))
    monkeypatch.setattr(pkg.T.LakehouseTable, "_is_local",
                        lambda self: False)
    res = pkg.T.LakehouseTable(path).vacuum(retain_last=1)
    assert res["files_removed"] == 0
    os.unlink(os.path.join(path, "_manifests", "v000001.json"))
    res = pkg.T.LakehouseTable(path).vacuum(retain_last=1)
    assert res["files_removed"] == 0 and res["files_leased"] >= 1
    for f in snap1.files():
        assert os.path.exists(f)
    remote.release()
    res2 = pkg.T.LakehouseTable(path).vacuum(retain_last=1)
    assert posixpath.basename(snap1.rel_files[0]) in {
        posixpath.basename(r) for r in res2["removed"]}


def test_catalog_lease_ttl_and_sweep(pkg, tmp_path, monkeypatch):
    lt, path = _make_fs_table(pkg, tmp_path, monkeypatch, 1)
    cat = lt.catalog
    snap = lt.snapshot()
    remote = cat.lease_acquire(lt, snap.version, snap.rel_files, ttl_s=0.05)
    assert cat.held_files(lt) == set(snap.rel_files)
    assert cat.held_versions(lt) == {1}
    time.sleep(0.1)
    assert cat.held_files(lt) == set()
    assert cat.sweep_expired(lt) == 1
    assert remote.renew(60) is False


def test_session_pin_writes_through_to_catalog(pkg, tmp_path, monkeypatch):
    lt, path = _make_fs_table(pkg, tmp_path, monkeypatch, 1, 2, 3)
    s = pkg.session(**{"engine.lake_catalog": "fs"})
    s.register_lakehouse("t", path)
    s.sql("select count(*) c from t").collect()
    ref = pkg.C._TableRef(path)
    assert pkg.C.FsCatalog().held_versions(ref) == {1}
    s.catalog.invalidate("t")
    assert pkg.C.FsCatalog().held_versions(ref) == set()


def test_heartbeat_renews_lease_through_slow_statement(pkg, tmp_path,
                                                       monkeypatch):
    lt, path = _make_fs_table(pkg, tmp_path, monkeypatch, *range(8))
    monkeypatch.setenv("NDS_LAKE_LEASE_TTL_S", "0.4")
    monkeypatch.setenv("NDS_HEARTBEAT_INTERVAL_MS", "50")
    s = pkg.session(**{"engine.lake_catalog": "fs"})
    s.register_lakehouse("t", path)
    r = s.sql("select a from t order by a")
    baseline = r.collect()
    s.catalog.pin_lakehouse("t")
    vacuum_result = {}

    def racing_maintenance():
        time.sleep(0.8)
        pkg.T.LakehouseTable(path).replace(_ints(9))
        vacuum_result["res"] = pkg.T.LakehouseTable(path).vacuum(
            retain_last=1)

    pkg.faults.install("hang:renewal_probe:1.3")
    racer = threading.Thread(target=racing_maintenance)

    def slow_statement():
        racer.start()
        pkg.faults.maybe_fire("renewal_probe")
        racer.join(10)

    kw = {"name": "renewal_probe"} if pkg.name == "jax" else {}
    summary = pkg.Report(s).report_on(slow_statement, **kw)
    assert summary["queryStatus"] == ["Completed"]
    assert vacuum_result["res"]["files_removed"] == 0
    s.recover_memory("test: force re-read through the pin")
    r._table = None
    assert r.collect().equals(baseline)


def test_catalog_fault_sites_io_classification(pkg, tmp_path, monkeypatch):
    lt, path = _make_fs_table(pkg, tmp_path, monkeypatch, 1)
    pkg.faults.install("io:catalog:commit:1")
    with pytest.raises(pkg.faults.TransientIOError) as ei:
        pkg.T.LakehouseTable(path).append(_ints(2))
    assert pkg.faults.classify(ei.value) == pkg.faults.IO_TRANSIENT
    pkg.faults.reset()
    pkg.T.LakehouseTable(path).append(_ints(2))
    assert _vals(pkg, path) == [1, 2]
    pkg.faults.install("io:catalog:fence:1")
    with pytest.raises(pkg.faults.TransientIOError):
        pkg.T.LakehouseTable(path).vacuum(retain_last=1)


@pytest.mark.parametrize("spec", ["fs", "off", "none", "", "bogus",
                                  "http://localhost:1"])
def test_catalog_resolution(spec, monkeypatch):
    """`fs` and off resolve as in the JAX package; a bad value raises its
    CatalogError; an http(s) coordinator raises NotImplementedError (item
    12b) in the port, where the JAX package builds its tcp client."""
    conf = {"engine.lake_catalog": spec}
    if spec == "bogus":
        with pytest.raises(JC.CatalogError):
            JC.resolve_catalog(conf)
        with pytest.raises(TC.CatalogError):
            TC.resolve_catalog(conf)
        return
    if spec.startswith("http"):
        with pytest.raises(NotImplementedError, match="item 12b"):
            TC.resolve_catalog(conf)
        with pytest.raises(NotImplementedError, match="item 12b"):
            TorchSession(conf=conf, device="cpu")
        monkeypatch.setenv("NDS_LAKE_CATALOG", spec)
        with pytest.raises(NotImplementedError, match="item 12b"):
            TorchSession(device="cpu")
        return
    j, t = JC.resolve_catalog(conf), TC.resolve_catalog(conf)
    assert (j is None) == (t is None)
    if t is not None:
        assert type(t).__name__ == type(j).__name__ == "FsCatalog"


# ---------------------------------------------------------------------------
# SQL over pinned, pruned scans; the budgeter's clamp
# ---------------------------------------------------------------------------

PRUNE_SQL = {
    "between": ("select ss_store, count(*) c, sum(ss_ext_sales_price) s "
                "from store_sales where ss_sold_date_sk between 2451000 "
                "and 2451100 group by ss_store order by ss_store"),
    "cmp": ("select sum(ss_quantity) q, count(*) c from store_sales "
            "where ss_sold_date_sk >= 2451800"),
    "flip_and_in": ("select ss_item_sk, sum(ss_ext_sales_price) s "
                    "from store_sales where 2450900 > ss_sold_date_sk "
                    "and ss_store in ('alpha', 'beta') group by ss_item_sk "
                    "order by s desc, ss_item_sk limit 10"),
    "count": ("select count(*) c from store_sales "
              "where ss_sold_date_sk = 2451500"),
    "no_file": ("select count(*) c, sum(ss_quantity) q from store_sales "
                "where ss_sold_date_sk > 9999999"),
    "notnull": ("select count(*) c from store_sales "
                "where ss_sold_date_sk is not null and ss_quantity < 10"),
    "unprunable": ("select count(*) c from store_sales "
                   "where ss_sold_date_sk + 1 > 2451000 "
                   "or ss_quantity = 3"),
}


def _scan(plan):
    return next(n for n in TPLAN.walk_plan(plan) if isinstance(n, TPLAN.Scan))


def _jscan(plan):
    from nds_tpu.engine import plan as JPLAN

    return next(n for n in JPLAN.walk_plan(plan) if isinstance(n, JPLAN.Scan))


@pytest.mark.parametrize("case", sorted(PRUNE_SQL))
@pytest.mark.parametrize("writer", sorted(PKGS))
def test_pruned_scan_matches_unpruned_and_jax(facts, case, writer):
    sql = PRUNE_SQL[case]
    path = facts[writer]
    got = {}
    for name, p in PKGS.items():
        for prune in ("on", "off"):
            s = p.session(**{"engine.lake_prune": prune,
                             "engine.fuse": "off"})
            s.register_lakehouse("store_sales", path)
            r = s.sql(sql)
            scan = (_scan if name == "port" else _jscan)(r.plan)
            got[name, prune] = (r.to_pylist(), scan.lake_files,
                                scan.prune_rows, scan.lake_version)
    want = got["jax", "off"]
    assert want[1] is None and want[2] is None
    assert got["port", "off"] == want
    assert got["port", "on"] == got["jax", "on"]
    assert got["port", "on"][0] == want[0]
    files = TT.LakehouseTable(path).snapshot().rel_files
    lake_files = got["port", "on"][1]
    if case in ("unprunable", "notnull"):
        # no file is all null, and every file holds quantities below 10
        assert lake_files is None
    else:
        assert lake_files is not None and len(lake_files) < len(files)
        assert set(lake_files) <= set(files)


@pytest.mark.parametrize("case", ["between", "cmp", "count", "no_file"])
def test_budget_clamps_pruned_rows_like_jax(facts, case):
    path = facts["port"]
    budgets = {}
    for name, p, B in (("jax", PKGS["jax"], JB), ("port", PKGS["port"], TB)):
        s = p.session(**{"engine.fuse": "off", "engine.plan_budget": "off"})
        s.register_lakehouse("store_sales", path)
        plan = s.sql(PRUNE_SQL[case]).plan
        budgets[name] = B.analyze_plan(plan, s.catalog, budget_bytes=4 << 30,
                                       reject_bytes=14 << 30)
    jb, tb = budgets["jax"], budgets["port"]
    for key in ("verdict", "peak_bytes", "peak_blocked_bytes", "window_rows",
                "unknown_tables"):
        assert getattr(tb, key) == getattr(jb, key), key
    assert [(n.desc, n.rows, n.cap, n.alloc_bytes) for n in tb.nodes] == [
        (n.desc, n.rows, n.cap, n.alloc_bytes) for n in jb.nodes]
    scan_rows = [n.rows for n in tb.nodes if n.desc.startswith("Scan")]
    assert scan_rows and scan_rows[0] < FACT_ROWS


def test_zero_projection_pruned_count(facts):
    """A pruned load with no columns counts the subset's rows."""
    path = facts["port"]
    counts = {}
    for name, p in PKGS.items():
        s = p.session()
        s.register_lakehouse("store_sales", path)
        r = s.sql(PRUNE_SQL["count"])
        scan = (_scan if name == "port" else _jscan)(r.plan)
        t = s.catalog.load("store_sales", [], lake_version=scan.lake_version,
                           lake_files=scan.lake_files)
        counts[name] = int(t.nrows)
        e = s.catalog.entries["store_sales"]
        assert e.device_cols == {}  # the subset never enters the cache
    assert counts["port"] == counts["jax"]
    snap = TT.LakehouseTable(path).snapshot()
    kept = set(_scan(s.sql(PRUNE_SQL["count"]).plan).lake_files)
    assert counts["port"] == sum(snap.file_stats()[f]["rows"] for f in kept)


def test_subset_reads_leave_the_residency_budget_alone(facts, monkeypatch):
    """Pruned and detached reads are served to the plan and never cached:
    the residency budget neither counts nor evicts them."""
    monkeypatch.setenv("NDS_CATALOG_BUDGET_BYTES", "1")
    s = TorchSession(device="cpu")
    s.register_lakehouse("store_sales", facts["port"])
    s.register_arrow("other", pa.table({"x": [1, 2, 3]}))
    s.catalog.load("other", ["x"])
    assert s.catalog.entries["other"].device_cols
    s.sql(PRUNE_SQL["between"]).collect()
    assert s.catalog.entries["store_sales"].device_cols == {}
    assert s.catalog.evictions == 0
    assert s.catalog.entries["other"].device_cols


def test_empty_pruned_string_dimension(tmp_path):
    """Zone maps that prune every file of a table with a string column
    leave an empty dictionary: the port answers as the unpruned plan (the
    JAX package's gather raises there, ROADMAP.md queue 3)."""
    path = str(tmp_path / "store")
    TT.LakehouseTable.create(path, pa.table({
        "s_store_sk": pa.array([1, 2], type=pa.int64()),
        "s_county": pa.array(["Ziebach County", "Bronx County"])}))
    sql = ("select count(*) c from store where s_county in "
           "('Williamson County', 'Barrow County') and s_store_sk > 5")
    got = {}
    for prune in ("on", "off"):
        s = TorchSession(conf={"engine.lake_prune": prune}, device="cpu")
        s.register_lakehouse("store", path)
        got[prune] = s.sql(sql).to_pylist()
    j = PKGS["jax"].session(**{"engine.lake_prune": "off"})
    j.register_lakehouse("store", path)
    assert got["on"] == got["off"] == j.sql(sql).to_pylist() == [{"c": 0}]
