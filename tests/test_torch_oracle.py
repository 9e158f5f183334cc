"""The port against an independent SQL engine: nds_tpu_torch's Session on
the CPU against sqlite3 over the same generated data, with the sqlite
oracle battery of tests/test_oracle.py (its QUERIES and every template
its `_sqlite_compatible()` lists, lowered to sqlite by its `_to_sqlite`).

The port's generator writes SF0.01 data into a temporary directory of this
module; the same .dat files load into the port (float mode, as the oracle
runs the JAX engine) and into an in-memory sqlite database, dates as ISO
strings. The templates sqlite cannot run in time, or cannot run at all,
are skipped as tests/test_oracle.py skips them.

Tolerance: tests/test_oracle.py's `_rows_close` (floats within 1e-6
relative, 1e-9 absolute; everything else exact), rows sorted by their
text where the statement has no ORDER BY.
"""

import datetime
import os
import sqlite3
import sys
import time

import pytest

from nds_tpu_torch.cli import gen_data as TG
from nds_tpu_torch.engine.session import Session as TorchSession
from nds_tpu_torch.io.csv import read_dat_dir
from nds_tpu_torch.schema import get_schemas

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_oracle as O  # noqa: E402
from torch_join_cases import strict_budget  # noqa: E402,F401


def _plain(v):
    return v.isoformat() if isinstance(v, datetime.date) else v


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(the port's CPU session, a sqlite connection) over identical
    float-typed SF0.01 data."""
    raw = tmp_path_factory.mktemp("oracle_sf001")
    TG.main(["--scale", "0.01", "--parallel", "2", "--data_dir", str(raw)])
    sess = TorchSession(use_decimal=False, device="cpu")
    conn = sqlite3.connect(":memory:")
    conn.create_aggregate("stddev_samp", 1, O._StddevSamp)
    for t, schema in get_schemas(use_decimal=False).items():
        path = os.path.join(raw, t)
        if not os.path.isdir(path):
            continue
        arrow = read_dat_dir(path, schema, use_decimal=False)
        sess.register_arrow(t, arrow, schema)
        names = [f.name for f in schema]
        conn.execute(f"create table {t} ({', '.join(names)})")
        rows = zip(*(map(_plain, arrow.column(n).to_pylist())
                     for n in names))
        conn.executemany(
            f"insert into {t} ({', '.join(names)}) values "
            f"({', '.join('?' for _ in names)})", rows)
    return sess, conn


@pytest.mark.parametrize("qi", range(len(O.QUERIES)))
def test_port_matches_sqlite(engines, qi):
    sess, conn = engines
    q = O.QUERIES[qi]
    ours = [[_plain(v) for v in r.values()] for r in sess.sql(q).to_pylist()]
    oracle = [list(r) for r in conn.execute(q).fetchall()]
    if "order by" not in q.lower():
        ours.sort(key=str)
        oracle.sort(key=str)
    assert O._rows_close(ours, oracle), (
        f"query {qi} mismatch:\nport: {ours[:5]}\nsqlite: {oracle[:5]}"
    )


@pytest.mark.parametrize("qnum,part", O._sqlite_compatible())
def test_port_template_matches_sqlite(engines, qnum, part):
    if qnum in O._SQLITE_NESTED_LOOP_TEMPLATES:
        pytest.skip(
            f"sqlite's nested-loop plan for query{qnum} exceeds the 60s "
            f"deadline (tests/test_oracle.py _SQLITE_NESTED_LOOP_TEMPLATES)"
        )
    sess, conn = engines
    parts = [p for p in O._template_sql(qnum).split(";")
             if "select" in p.lower()]
    sql = parts[part]
    deadline = time.monotonic() + 60
    conn.set_progress_handler(
        lambda: 1 if time.monotonic() > deadline else 0, 100_000)
    try:
        oracle = [list(r) for r in conn.execute(O._to_sqlite(sql)).fetchall()]
    except sqlite3.OperationalError as e:
        pytest.skip(f"sqlite can't run query{qnum} part {part}: {e}")
    finally:
        conn.set_progress_handler(None, 0)
    ours = [[_plain(v) for v in r.values()]
            for r in sess.sql(sql).to_pylist()]
    if "order by" not in sql.lower():
        ours.sort(key=str)
        oracle.sort(key=str)
    assert O._rows_close(ours, oracle, eps=1e-4), (
        f"query{qnum} mismatch ({len(ours)} vs {len(oracle)} rows):\n"
        f"port: {ours[:3]}\nsqlite: {oracle[:3]}"
    )
