"""The port's statements other than SELECT (nds_tpu_torch/lakehouse/dml.py
and Session.run_stmt: INSERT, DELETE, CREATE TABLE AS, CALL
rollback_to_timestamp, CREATE / DROP (TEMP) VIEW; Catalog.hold_pins)
against the JAX package's (nds_tpu/lakehouse/dml.py).

The DML cases of the JAX package's tests/test_maintenance.py and
tests/test_lakehouse_txn.py run against both packages, parametrised by
`pkg`, each with the reference's expected outcome; the other cases run the
same statements through both packages and compare what they leave. Every
table is made under `tmp_path` from seeded numpy data.

Tolerance: exact. Rows affected, versions, operations and table contents
(integers, decimals, dates, strings) are equal; no float is involved.
"""

import datetime
import os
import sys
import time
from decimal import Decimal
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest

from nds_tpu import faults as JF
from nds_tpu.engine.session import Session as JaxSession
from nds_tpu.lakehouse import dml as JD
from nds_tpu.lakehouse import leases as JL
from nds_tpu.lakehouse import table as JT
from nds_tpu_torch import faults as TF
from nds_tpu_torch.engine.session import Session as TorchSession
from nds_tpu_torch.lakehouse import dml as TD
from nds_tpu_torch.lakehouse import leases as TL
from nds_tpu_torch.lakehouse import table as TT

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401

PKGS = {
    "jax": SimpleNamespace(
        name="jax", T=JT, D=JD, L=JL, faults=JF,
        session=lambda **conf: JaxSession(
            conf={"engine.aot_cache_dir": "", "engine.plan_cache": "off",
                  **conf})),
    "port": SimpleNamespace(
        name="port", T=TT, D=TD, L=TL, faults=TF,
        session=lambda **conf: TorchSession(conf=conf, device="cpu")),
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("NDS_LAKE_CATALOG", "NDS_LAKE_CONFLICT_RETRIES",
              "NDS_FAULT_SPEC", "NDS_LAKE_LEASE_TTL_S"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NDS_LAKE_COMMIT_BACKOFF", "0")
    monkeypatch.setenv("NDS_FLIGHT_RECORDER", "off")
    for p in PKGS.values():
        p.faults.reset()
        p.T._COMMIT_HOOK = None
    yield
    for p in PKGS.values():
        p.faults.reset()
        p.T._COMMIT_HOOK = None


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _ints(*vals):
    return pa.table({"a": pa.array(list(vals), type=pa.int64())})


def _lake(p, d, name, table):
    """A lakehouse table `name` under `d`, registered on a new session."""
    path = os.path.join(d, name)
    p.T.LakehouseTable.create(path, table)
    s = p.session(**{"lakehouse.warehouse": d})
    s.register_lakehouse(name, path)
    return s, path


def _vals(p, path, col="a"):
    return sorted(
        (r[col] for r in
         p.T.LakehouseTable(path).dataset().to_table().to_pylist()),
        key=lambda v: (v is None, v))


def _ops(p, path):
    return [op for _, _, op in p.T.LakehouseTable(path).versions()]


# ---------------------------------------------------------------------------
# the reference's DML cases (tests/test_maintenance.py), on both packages
# ---------------------------------------------------------------------------


def test_dml_insert_delete_ctas_call(pkg, tmp_path):
    d = str(tmp_path)
    s, path = _lake(pkg, d, "t", pa.table({"a": np.arange(10,
                                                          dtype=np.int64)}))
    # strftime truncates to seconds: wait, so that before_ts > create time
    time.sleep(1.1)
    before_ts = time.strftime("%Y-%m-%d %H:%M:%S")
    r = s.sql("insert into t (select a + 10 a from t)")
    assert r.rows_affected == 10
    assert s.sql("select count(*) c from t").to_pylist() == [{"c": 20}]
    r = s.sql("delete from t where a >= 15")
    assert r.rows_affected == 5
    # survivors whose predicate is NULL stay (3VL)
    s.sql("create table t3 location '" + os.path.join(d, "t3") + "' as " +
          "select a, cast(null as int) n from t")
    s.register_lakehouse("t3", os.path.join(d, "t3"))
    r = s.sql("delete from t3 where n > 0")
    assert r.rows_affected == 0
    s.sql(f"call system.rollback_to_timestamp('t', timestamp '{before_ts}')")
    assert s.sql("select count(*) c from t").to_pylist() == [{"c": 10}]
    assert _ops(pkg, path) == ["create", "insert", "delete", "rollback-to-v1"]
    assert _vals(pkg, path) == list(range(10))


def test_delete_all_rows_keeps_table_readable(pkg, tmp_path):
    """An all-rows DELETE leaves no data file; the manifest's schema keeps
    the table readable, and a truncate of an empty table works."""
    s, _ = _lake(pkg, str(tmp_path), "t",
                 pa.table({"a": np.arange(5, dtype=np.int64)}))
    r = s.sql("delete from t where a >= 0")
    assert r.rows_affected == 5
    assert s.sql("select count(*) c from t").to_pylist() == [{"c": 0}]
    assert s.sql("delete from t").rows_affected == 0  # truncate, empty
    assert s.sql("select count(*) c from t").to_pylist() == [{"c": 0}]
    s.sql("insert into t (select 7 a)")
    assert s.sql("select a from t").to_pylist() == [{"a": 7}]


#: (DELETE predicate over t(a) = [1, 2, NULL, 4, 5] and u(b) = [4, 2, NULL],
#: the values left, whether the Arrow translation takes it). A row whose
#: predicate is NULL survives on both paths.
DELETE_PREDICATES = {
    "range_arrow": ("a >= 2", [1, None], True),
    "literal_fold_engine": ("1 = 1", [], False),
    "between": ("a between 2 and 4", [1, 5, None], True),
    "not_between": ("a not between 2 and 4", [2, 4, None], True),
    "in_list": ("a in (1, 5)", [2, 4, None], True),
    "in_list_with_null_engine": ("a in (1, null)", [2, 4, 5, None], False),
    # SQL's three-valued NOT IN keeps every row here (a <> NULL is NULL);
    # both packages delete 2, 4 and 5 (ROADMAP.md queue 3)
    "not_in_list_with_null_engine": ("a not in (1, null)", [1, None],
                                     False),
    "is_null": ("a is null", [1, 2, 4, 5], True),
    "is_not_null": ("a is not null", [None], True),
    "not": ("not (a > 2)", [4, 5, None], True),
    "or": ("a = 1 or a = 5", [2, 4, None], True),
    "scalar_subquery": ("a >= (select max(b) from u)", [1, 2, None], True),
    "empty_scalar_engine": ("a >= (select max(b) from u where b > 100)",
                            [1, 2, 4, 5, None], False),
    "in_subquery_engine": ("a in (select b from u)", [1, 5, None], False),
    # u holds a NULL: NOT IN is never TRUE, so nothing goes
    "not_in_subquery_engine": ("a not in (select b from u)",
                               [1, 2, 4, 5, None], False),
    "expression_engine": ("a + 1 > 3", [1, 2, None], False),
    "truncate": (None, [], None),
}


@pytest.mark.parametrize("case", sorted(DELETE_PREDICATES))
def test_delete_predicate_edge_paths(pkg, tmp_path, case, monkeypatch):
    """The streaming DELETE's translation edges: what the Arrow path takes
    and what falls back to the engine (a literal-to-literal comparison, a
    NULL in an IN list, an IN subquery, an empty scalar subquery, an
    expression over the column), with the rows whose predicate is NULL
    surviving on both."""
    pred, left, arrow = DELETE_PREDICATES[case]
    s, path = _lake(pkg, str(tmp_path), "t",
                    pa.table({"a": pa.array([1, 2, None, 4, 5],
                                            type=pa.int64())}))
    s.register_arrow("u", pa.table({"b": pa.array([4, 2, None],
                                                  type=pa.int64())}))
    took = []
    orig = pkg.D._to_arrow_predicate

    def spy(session, e):
        out = orig(session, e)
        took.append(out is not None)
        return out

    monkeypatch.setattr(pkg.D, "_to_arrow_predicate", spy)
    sql = "delete from t" + ("" if pred is None else f" where {pred}")
    assert s.sql(sql).rows_affected == 5 - len(left)
    assert took == ([] if arrow is None else [arrow])
    assert _vals(pkg, path) == left


@pytest.mark.parametrize("case", sorted(DELETE_PREDICATES))
def test_delete_leaves_what_the_jax_package_leaves(tmp_path, case):
    pred = DELETE_PREDICATES[case][0]
    out = {}
    for p in PKGS.values():
        d = str(tmp_path / p.name)
        s, path = _lake(p, d, "t",
                        pa.table({"a": pa.array([1, 2, None, 4, 5],
                                                type=pa.int64())}))
        s.register_arrow("u", pa.table({"b": pa.array([4, 2, None],
                                                      type=pa.int64())}))
        r = s.sql("delete from t" + ("" if pred is None else
                                     f" where {pred}"))
        out[p.name] = (r.rows_affected, r.version, _vals(p, path),
                       _ops(p, path),
                       p.T.LakehouseTable(path).schema())
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# tests/test_lakehouse_txn.py:122, on both packages
# ---------------------------------------------------------------------------


def test_dml_delete_reads_one_snapshot_and_aborts_on_conflict(pkg,
                                                             tmp_path):
    """A DELETE's row count and survivor scan read one snapshot, and a
    commit racing it aborts it (an overwrite never rebases) instead of
    dropping the winner's rows."""
    s, path = _lake(pkg, str(tmp_path), "t", _ints(*range(10)))

    def land_append(name, op, version):
        pkg.T._COMMIT_HOOK = None  # fire once
        pkg.T.LakehouseTable(path).append(_ints(1000))

    pkg.T._COMMIT_HOOK = land_append
    with pytest.raises(pkg.T.CommitConflictError):
        s.sql("delete from t where a >= 5")
    assert (pkg.faults.classify(pkg.T.CommitConflictError("x"))
            == pkg.faults.COMMIT_CONFLICT)
    # the loser published nothing: the winner's append is the head
    assert _vals(pkg, path) == list(range(10)) + [1000]


@pytest.mark.parametrize("engine_path", [False, True])
def test_delete_reads_its_snapshot_under_a_racing_append(pkg, tmp_path,
                                                         engine_path):
    """A DELETE reads the snapshot it counted: an append landing just before
    the statement's first nested SELECT (the engine path's survivor scan,
    which runs with the pin held; the Arrow path's scalar subquery) never
    reaches the survivors. The replace then publishes over the append,
    which is lost, as in the JAX package: replace() checks the head only
    inside its own commit (ROADMAP.md queue 3)."""
    s, path = _lake(pkg, str(tmp_path), "t", _ints(*range(10)))
    s.register_arrow("u", pa.table({"b": pa.array([3], type=pa.int64())}))
    seen = []
    orig = s.run_stmt

    def run_stmt(stmt):
        if type(stmt).__name__ == "SelectStmt" and not seen:
            pkg.T.LakehouseTable(path).append(_ints(1000))
            res = orig(stmt)
            seen.append(sorted(res.collect().column(0).to_pylist()))
            return res
        return orig(stmt)

    s.run_stmt = run_stmt
    pred = "a in (select b from u)" if engine_path else "a >= (select b from u)"
    r = s.sql(f"delete from t where {pred}")
    survivors = [x for x in range(10) if (x != 3 if engine_path else x < 3)]
    assert seen[0] == (survivors if engine_path else [3])
    assert r.rows_affected == 10 - len(survivors)
    assert _vals(pkg, path) == survivors
    assert _ops(pkg, path) == ["create", "append", "delete"]


def test_hold_pins_freezes_the_pin(pkg, tmp_path):
    s, path = _lake(pkg, str(tmp_path), "t", _ints(1, 2))
    assert s.sql("select count(*) c from t").to_pylist() == [{"c": 2}]
    pkg.T.LakehouseTable(path).append(_ints(3))
    with s.catalog.hold_pins(["T"]):
        assert s.sql("select count(*) c from t").to_pylist() == [{"c": 2}]
        with s.catalog.hold_pins([]):  # nested: the outer hold stays
            assert s.sql("select count(*) c from t").to_pylist() == [
                {"c": 2}]
    # released: the next statement re-pins the head
    assert s.sql("select count(*) c from t").to_pylist() == [{"c": 3}]


def test_select_after_dml_reads_the_new_head(pkg, tmp_path):
    """A statement after an INSERT or a DELETE in the same session reads the
    committed head, never the columns cached from the old pin; the commit
    released the old pin's lease."""
    s, path = _lake(pkg, str(tmp_path), "t", _ints(1, 2, 3))
    root = pkg.T.LakehouseTable(path).root
    q = "select count(*) c, sum(a) s from t"
    assert s.sql(q).to_pylist() == [{"c": 3, "s": 6}]
    leases = pkg.L.LEASES.live_count(root)
    s.sql("insert into t (select a * 10 a from t)")
    assert pkg.L.LEASES.live_count(root) == leases - 1
    assert s.catalog.entries["t"].pinned_version is None
    assert s.sql(q).to_pylist() == [{"c": 6, "s": 66}]
    s.sql("delete from t where a < 10")
    assert s.sql(q).to_pylist() == [{"c": 3, "s": 60}]
    assert s.catalog.entries["t"].pinned_version == 3


# ---------------------------------------------------------------------------
# inserts: the positional cast, decimals
# ---------------------------------------------------------------------------


def _decimal_target():
    return pa.table({
        "k": pa.array([0], type=pa.int32()),
        "amt": pa.array([Decimal("0.01")], type=pa.decimal128(7, 2)),
        "d": pa.array([datetime.date(1998, 1, 1)], type=pa.date32()),
        "s": pa.array(["z"], type=pa.string()),
    })


def test_decimal_insert_truncates_as_the_jax_package(tmp_path):
    """LF_SS's net_paid_inc_tax shape: a decimal(7,2) product with a
    decimal(5,2) (scale 4 and above) inserted into a decimal(7,2) column
    truncates; dates and strings insert as they are."""
    src = pa.table({
        "k": pa.array([1, 2, 3, 4], type=pa.int64()),
        "price": pa.array([Decimal("12.34"), Decimal("-5.67"), None,
                           Decimal("99999.99")], type=pa.decimal128(7, 2)),
        "tax": pa.array([Decimal("0.07"), Decimal("0.09"), Decimal("0.01"),
                         Decimal("0.00")], type=pa.decimal128(5, 2)),
        "dt": pa.array(["2000-01-02", "1999-12-31", None, "2002-02-28"]),
        "s": pa.array(["a", None, "ccc", "d"]),
    })
    sql = ("insert into f (select cast(k as int) k, price * (1 + tax) amt, "
           "cast(dt as date) d, s from src order by k)")
    out = {}
    for p in PKGS.values():
        d = str(tmp_path / p.name)
        s, path = _lake(p, d, "f", _decimal_target())
        s.register_arrow("src", src)
        assert s.sql(sql).rows_affected == 4
        out[p.name] = p.T.LakehouseTable(path).dataset().to_table()
    assert out["port"].schema == out["jax"].schema
    assert out["port"].equals(out["jax"])
    assert out["port"].sort_by("k").column("amt").to_pylist()[1:3] == [
        Decimal("13.20"), Decimal("-6.18")]


@pytest.mark.parametrize("target,values", [
    (pa.decimal128(7, 2), [Decimal("1.2345"), Decimal("-9.999"), None]),
    (pa.float32(), [1.0000001, 2.5, None]),
    (pa.int32(), [1, 2, None]),
])
def test_cast_to_schema_matches_jax(target, values):
    src_type = (pa.decimal128(10, 4) if pa.types.is_decimal(target)
                else pa.float64() if pa.types.is_floating(target)
                else pa.int64())
    rows = pa.table({"x": pa.array(values, type=src_type)})
    schema = pa.schema([("x", target)])
    a = JD._cast_to_schema(rows, schema)
    b = TD._cast_to_schema(rows, schema)
    assert b.schema == schema and a.equals(b)


@pytest.mark.parametrize("ts", [
    "1700000000", "1700000000000", "1700000000.5", 1700000000,
    1700000000123, 1.7e9, "2024-01-02", "2024-01-02 03:04:05",
    "2024-01-02 03:04:05.250", " 2024-01-02 ", "20240101", "202401011200",
    "20240101120000", "yesterday",
])
def test_to_ts_ms_matches_jax(ts):
    def run(fn):
        try:
            return fn(ts)
        except Exception as e:
            return type(e).__name__, str(e)

    assert run(TD._to_ts_ms) == run(JD._to_ts_ms)


def test_ctas_needs_a_location_or_warehouse(pkg, tmp_path):
    s = pkg.session()
    s.register_arrow("src", _ints(1, 2))
    with pytest.raises(pkg.T.LakehouseError, match="LOCATION"):
        s.sql("create table c as select a from src")
    s = pkg.session(**{"lakehouse.warehouse": str(tmp_path)})
    s.register_arrow("src", _ints(1, 2))
    r = s.sql("create table c as select a from src")
    assert (r.rows_affected, r.version) == (2, 1)
    assert _vals(pkg, str(tmp_path / "c")) == [1, 2]
    assert s.sql("select sum(a) s from c").to_pylist() == [{"s": 3}]


def test_unknown_procedure_and_unregistered_table(pkg, tmp_path):
    s, _ = _lake(pkg, str(tmp_path), "t", _ints(1))
    with pytest.raises(pkg.T.LakehouseError, match="unknown procedure"):
        s.sql("call system.expire_snapshots('t', 1)")
    s.register_arrow("m", _ints(1))
    with pytest.raises(pkg.T.LakehouseError, match="not a lakehouse table"):
        s.sql("insert into m (select 2 a)")


# ---------------------------------------------------------------------------
# CREATE / DROP (TEMP) VIEW
# ---------------------------------------------------------------------------


def test_views_match_jax(tmp_path):
    src = pa.table({"k": pa.array([3, 1, 2, None], type=pa.int64()),
                    "v": pa.array(["x", "y", None, "w"])})
    script = ("drop view if exists never_made; "
              "create temp view v1 as select k, v from src where k > 1; "
              "create view v2 as select count(*) c from v1; "
              "drop view v1; "
              "drop view if exists v1; ")
    out = {}
    for p in PKGS.values():
        s = p.session()
        s.register_arrow("src", src)
        assert s.run_script(script) is None
        out[p.name] = (s.sql("select c from v2").to_pylist(),
                       "v1" in s.catalog.entries, "v2" in s.catalog.entries,
                       s.catalog.entries["v2"].arrow)
    assert out["port"][:3] == out["jax"][:3] == ([{"c": 2}], False, True)
    assert out["port"][3].equals(out["jax"][3])
