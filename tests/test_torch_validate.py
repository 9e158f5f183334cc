"""The port's validator (nds_tpu_torch.validate and its CLI) against the JAX
package's nds_tpu.validate, on outputs built here.

Tolerance: exact. Every function returns what the JAX function returns on
the same inputs (the verdicts, the unmatched lists, the rewritten
summaries); the epsilon is the reference's 1e-5 relative.
"""

import json
import os
import sys
from decimal import Decimal

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from nds_tpu import validate as JV
from nds_tpu.cli import validate as JCLI
from nds_tpu_torch import validate as TV
from nds_tpu_torch.cli import validate as TCLI

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401

EPS = 1e-5
NAN = float("nan")

#: (expected, actual) pairs around the epsilon and across types
SCALARS = [
    (1.0, 1.0), (1.0, 1.0 + 0.9e-5), (1.0, 1.0 + 1.1e-5), (1.0, 1.0 - 1.1e-5),
    (0.0, 0.0), (0.0, 1e-300), (-5.0, -5.00004), (-5.0, -5.0001),
    (1e300, 1.00000999e300), (NAN, NAN), (NAN, 1.0), (1.0, NAN),
    (None, None), (None, 1.0), (1.0, None), (None, "a"), ("a", "a"),
    ("a", "b"), ("a", "a "), (3, 3), (3, 4), (3, 3.00002), (3, 3.0000001),
    (Decimal("10.00"), Decimal("10.0000001")),
    (Decimal("10.00"), Decimal("10.01")), (Decimal("10.00"), 10.0),
    (Decimal("-0.01"), -0.01), (Decimal("1.5"), 2), (True, True),
    (True, False), ([1], [1]), ("1", 1),
]


@pytest.mark.parametrize("pair", range(len(SCALARS)))
def test_compare_matches_jax(pair):
    a, b = SCALARS[pair]
    assert TV.compare(a, b) == JV.compare(a, b)
    assert TV.compare(a, b, 1e-3) == JV.compare(a, b, 1e-3)


def test_compare_epsilon_edges():
    assert TV.compare(1.0, 1.0 + 0.9e-5)
    assert not TV.compare(1.0, 1.0 + 1.1e-5)
    assert TV.compare(NAN, NAN) and not TV.compare(NAN, 1.0)
    assert TV.compare(None, None) and not TV.compare(None, 0.0)
    assert TV.compare(Decimal("10.00"), 10.0)


ROWS = [
    ([1, "a", 2, 0.50, 9.0], [1, "a", 2, 0.505, 9.0]),
    ([1, "a", 2, 0.50, 9.0], [1, "a", 2, 0.52, 9.0]),
    ([1, "a", 2, 0.50, 9.0], [1, "a", 2, 0.51, 9.0]),
    ([1, 2, 3, None], [1, 2, 3, None]),
    ([1, 2, 3, None], [1, 2, 3, 0.5]),
    ([1, 2, 3, 0.5], [1, 2, 3, None]),
    ([1, 2, 4, 0.5], [1, 2, 3, 0.5]),
    ([1, 2, 3, Decimal("0.50")], [1, 2, 3, 0.509]),
    ([NAN, "x", None, 1.0], [NAN, "x", None, 1.0 + 2e-5]),
    ([1.0, 2.0, 3, 0.5], [1.0, 2.0 + 1e-6, 3, 0.5]),
]


@pytest.mark.parametrize("is_q78", [False, True])
@pytest.mark.parametrize("pair", range(len(ROWS)))
def test_row_equal_matches_jax(pair, is_q78):
    a, b = ROWS[pair]
    got = TV.row_equal(list(a), list(b), EPS, is_q78)
    assert got == JV.row_equal(list(a), list(b), EPS, is_q78)


def test_row_equal_q78_carve_out():
    assert TV.row_equal(*ROWS[0], EPS, True)
    assert not TV.row_equal(*ROWS[0], EPS, False)
    assert not TV.row_equal(*ROWS[1], EPS, True)


def _write(path, table):
    os.makedirs(path, exist_ok=True)
    pq.write_table(table, os.path.join(path, "part-0.parquet"))


#: output pairs: name -> (left table, right table)
TABLES = {
    "same": (pa.table({"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]}),
             pa.table({"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]})),
    "reordered": (pa.table({"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]}),
                  pa.table({"k": [3, 1, 2], "v": [3.0, 1.0, 2.0]})),
    "within_eps": (pa.table({"k": [1], "v": [1.0]}),
                   pa.table({"k": [1], "v": [1.0 + 5e-6]})),
    "past_eps": (pa.table({"k": [1], "v": [1.0]}),
                 pa.table({"k": [1], "v": [1.0 + 5e-5]})),
    "count": (pa.table({"k": [1, 2]}), pa.table({"k": [1]})),
    "nulls_nan": (pa.table({"k": [None, 2], "v": [NAN, None]}),
                  pa.table({"k": [None, 2], "v": [NAN, None]})),
    "null_vs_value": (pa.table({"k": [None, 2]}), pa.table({"k": [1, 2]})),
    "decimal": (pa.table({"d": pa.array([Decimal("1.00"), Decimal("2.50")],
                                        pa.decimal128(7, 2))}),
                pa.table({"d": [1.0, 2.5]})),
    "strings": (pa.table({"s": ["a", None, "c"]}),
                pa.table({"s": ["a", None, "d"]})),
    "many_errors": (pa.table({"k": list(range(30))}),
                    pa.table({"k": list(range(100, 130))})),
    "empty": (pa.table({"k": pa.array([], pa.int64())}),
              pa.table({"k": pa.array([], pa.int64())})),
}


@pytest.mark.parametrize("ignore_ordering", [False, True])
@pytest.mark.parametrize("name", sorted(TABLES))
def test_compare_results_matches_jax(tmp_path, name, ignore_ordering):
    left, right = TABLES[name]
    _write(tmp_path / "a", left)
    _write(tmp_path / "b", right)
    args = (str(tmp_path / "a"), str(tmp_path / "b"))
    kw = dict(ignore_ordering=ignore_ordering, max_errors=5)
    assert TV.compare_results(*args, **kw) == JV.compare_results(*args, **kw)


def test_collect_results_sorts_non_floats_first():
    t = pa.table({"f": [2.0, 1.0, 3.0], "k": [1, 1, 0]})
    got = list(TV.collect_results(t, True, batch_rows=1))
    assert got == list(JV.collect_results(t, True, batch_rows=1))
    assert got == [[3.0, 0], [1.0, 1], [2.0, 1]]
    assert list(TV.collect_results(t, False)) == [[2.0, 1], [1.0, 1],
                                                 [3.0, 0]]


def _runs(tmp_path, pairs):
    for q, (left, right) in pairs.items():
        _write(tmp_path / "run1" / q, left)
        _write(tmp_path / "run2" / q, right)
    return str(tmp_path / "run1"), str(tmp_path / "run2")


OK = pa.table({"k": [1], "v": [1.0]})
BAD = pa.table({"k": [1], "v": [9.0]})
Q78_L = pa.table({"a": [1], "b": ["x"], "c": [2], "ratio": [0.50]})
Q78_R = pa.table({"a": [1], "b": ["x"], "c": [2], "ratio": [0.505]})
STREAM_PAIRS = {
    "query1": (OK, OK), "query2": (OK, BAD), "query65": (OK, BAD),
    "query67": (OK, BAD), "query78": (Q78_L, Q78_R),
    "query14_part1": (OK, OK), "query14_part2": (OK, BAD),
}


@pytest.mark.parametrize("is_float", [False, True])
def test_iterate_queries_carve_outs_match_jax(tmp_path, is_float):
    r1, r2 = _runs(tmp_path, STREAM_PAIRS)
    names = list(STREAM_PAIRS)
    got = TV.iterate_queries(r1, r2, names, is_float=is_float)
    assert got == JV.iterate_queries(r1, r2, names, is_float=is_float)
    # q65 always skipped, q67 skipped under floats, q78 with its tolerance
    want = ["query2", "query67", "query14_part2"]
    assert got == ([q for q in want if q != "query67"] if is_float else want)


def _summaries(jdir, statuses, dup=None):
    os.makedirs(jdir, exist_ok=True)
    for q, status in statuses.items():
        with open(jdir / f"power-{q}-123.json", "w") as f:
            json.dump({"query": q, "queryStatus": [status]}, f)
    if dup:
        with open(jdir / f"power-{dup}-456.json", "w") as f:
            json.dump({"query": dup, "queryStatus": ["Completed"]}, f)


def _read(jdir):
    out = {}
    for f in sorted(os.listdir(jdir)):
        s = json.load(open(jdir / f))
        out[f] = s
    return out


def test_update_summary_matches_jax(tmp_path):
    statuses = {"query1": "Completed", "query2": "Completed",
                "query3": "Failed", "query4": "CompletedWithTaskFailures",
                "query5": "Failed"}
    unmatch = ["query2", "query3", "query4"]
    for who, mod in (("port", TV), ("jax", JV)):
        _summaries(tmp_path / who, statuses)
        mod.update_summary(str(tmp_path / who), unmatch, list(statuses))
    got = _read(tmp_path / "port")
    assert got == _read(tmp_path / "jax")
    assert {s["query"]: s["queryValidationStatus"] for s in got.values()} == {
        "query1": ["Pass"], "query2": ["Fail"], "query3": ["NotAttempted"],
        "query4": ["Fail"], "query5": ["Pass"]}
    assert not [f for f in os.listdir(tmp_path / "port") if ".tmp" in f]


@pytest.mark.parametrize("case", ["missing_folder", "missing", "duplicate"])
def test_update_summary_errors_match_jax(tmp_path, case):
    errors = []
    for who, mod in (("port", TV), ("jax", JV)):
        jdir = tmp_path / who
        if case != "missing_folder":
            _summaries(jdir, {"query1": "Completed"},
                       dup="query1" if case == "duplicate" else None)
        names = ["query1", "query9"] if case == "missing" else ["query1"]
        with pytest.raises(Exception) as exc:
            mod.update_summary(str(jdir), [], names)
        errors.append(str(exc.value).replace(str(jdir), "<dir>"))
    assert errors[0] == errors[1]


def _stream(path, names):
    parts = []
    for n, q in enumerate(names, 1):
        parts.append(f"-- start query {n} in stream 0 using template {q}.tpl\n"
                     f"select {n} as c\n;\n-- end query {n} in stream 0 "
                     f"using template {q}.tpl\n")
    path.write_text("\n".join(parts))
    return str(path)


@pytest.mark.parametrize("floats", [False, True])
def test_cli_matches_jax(tmp_path, floats):
    pairs = {k: v for k, v in STREAM_PAIRS.items() if "_part" not in k}
    r1, r2 = _runs(tmp_path, pairs)
    stream = _stream(tmp_path / "query_0.sql", list(pairs))
    rcs = []
    for who, cli in (("port", TCLI), ("jax", JCLI)):
        jdir = tmp_path / f"json_{who}"
        _summaries(jdir, {q: "Completed" for q in pairs})
        argv = [r1, r2, stream, "--json_summary_folder", str(jdir)]
        rcs.append(cli.main(argv + (["--floats"] if floats else [])))
    assert rcs == [1, 1]
    got = _read(tmp_path / "json_port")
    assert got == _read(tmp_path / "json_jax")
    status = {s["query"]: s["queryValidationStatus"][0] for s in got.values()}
    assert status["query2"] == "Fail" and status["query78"] == "Pass"
    assert status["query67"] == ("Pass" if floats else "Fail")


def test_cli_all_matched(tmp_path):
    r1, r2 = _runs(tmp_path, {"query1": (OK, OK), "query65": (OK, BAD)})
    stream = _stream(tmp_path / "s.sql", ["query1", "query65"])
    assert TCLI.main([r1, r2, stream]) == JCLI.main([r1, r2, stream]) == 0
