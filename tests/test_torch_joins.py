"""The joins and set operators of nds_tpu_torch against the JAX package.

Small synthetic tables, built in memory from a numpy seed, go through the
JAX package's Session (CPU; its Pallas kernels in interpret mode where the
`on` routes reach them; no AOT cache) and the port's Session(device="cpu"),
with engine.pallas_{agg,join,sort} `off` and `on`. Every join branch of the
JAX executor has a case: the packed-word join (inner, left, semi, anti,
mark), the hash-candidate join (semi, anti, mark with and without a
residual; inner, left and full with and without one; a right join), the
cross join (with an empty side), DISTINCT, UNION [ALL] / INTERSECT / EXCEPT
over rows with NULLs, and count / sum / avg(distinct). Then small versions
of chip_smoke.py's six joins-phase queries, on chip_smoke's own generator.

Tolerance: integers, dates and strings EXACTLY; floats within
nds_tpu.validate.compare's 1e-5 relative epsilon. Results without an ORDER
BY are compared as row multisets. A spy (chip_smoke.branch_spy) on both
executors asserts that every join, set operation and DISTINCT takes the same
branch in both engines, and that each case reaches the branch it is for.
The tables, cases and comparison live in tests/torch_join_cases.py (jax-free,
shared with the card's tests). No test reads or writes shared files.
"""

import os
import sys

import numpy as np
import pytest
import torch

from nds_tpu.engine import exec as JX
from nds_tpu_torch.engine import exec as TX

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401
from torch_join_cases import (  # noqa: E402
    CASES, CS, EDGE_CASES, EPS, arrow_table, assert_same, structural, tables,
)
from torch_parity import run_both as _run_both, sessions as _sessions  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sessions():
    return _sessions(tables())


@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_join_branch_matches_jax(sessions, case, mode):
    sql, wanted = CASES[case]
    j, t = sessions[mode]
    a, b, ev_j, ev_t = _run_both(j, t, sql)
    assert structural(ev_t) == structural(ev_j), (ev_j, ev_t)
    assert not CS.missing_branches(ev_t, wanted), (wanted, ev_t)
    assert_same(a, b, (case, mode))


@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_case_matches_jax(sessions, case, mode):
    """Empty sides of joins, set operations, DISTINCT and distinct
    aggregates, and set operations over literals and casts."""
    j, t = sessions[mode]
    a, b, ev_j, ev_t = _run_both(j, t, EDGE_CASES[case])
    assert structural(ev_t) == structural(ev_j), (ev_j, ev_t)
    assert_same(a, b, (case, mode))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("kind", ["inner", "left", "right", "full", "semi",
                                  "anti", "mark"])
def test_join_method_matches_jax(sessions, kind, residual):
    """Executor._join itself, kind by kind, with and without a residual
    (SQL reaches an inner join's residual only as a filter after it): the
    hash-candidate path on a float key, which no packing takes."""
    from nds_tpu.engine import expr as JE
    from nds_tpu.engine.columnar import table_to_arrow as j_arrow
    from nds_tpu_torch.engine import expr as TE
    from nds_tpu_torch.engine.columnar import table_to_arrow as t_arrow

    j, t = sessions["off"]
    outs, events = [], []
    for sess, ex, E, to_arrow in (
            (j, JX.Executor(j.catalog), JE, j_arrow),
            (t, TX.Executor(t.catalog, "cpu"), TE, t_arrow)):
        left = sess.catalog.load("fact", ["f_id", "f_val", "f_qty"])
        right = sess.catalog.load("dim", ["d_val", "d_qty", "d_str"])
        res = (E.BinOp("<", E.Col("d_qty"), E.Col("f_qty"))
               if residual else None)
        ev = []
        restore = CS.branch_spy(type(ex), ev)
        try:
            out = ex._join(left, right, kind, [E.Col("f_val")],
                           [E.Col("d_val")], res, "m")
        finally:
            restore()
        outs.append(to_arrow(out))
        events.append(ev)
    assert events[0] == events[1]
    assert events[1][-1].startswith(f"{kind} hash join"), events[1]
    assert outs[1].num_rows > 0
    assert_same(outs[0], outs[1], (kind, residual))


def test_cases_return_rows(sessions):
    """Every case but the empty cross join's count has rows to compare, and
    the left / full / set-operation cases produce NULLs where they should."""
    t = sessions["off"][1]
    for case, (sql, _) in CASES.items():
        res = t.sql(sql).collect()
        assert res.num_rows > 0, case
    left = t.sql(CASES["hash_left_residual"][0]).collect()
    assert left.column("d_qty").null_count > 0
    full = t.sql(CASES["hash_full_residual"][0]).collect()
    assert full.column("f_id").null_count > 0
    assert full.column("d_key").null_count > 0
    inter = t.sql(CASES["intersect"][0]).collect()
    assert inter.column("f_grp").null_count > 0
    empty = t.sql(CASES["cross_empty_side"][0]).collect().to_pylist()
    assert empty == [{"n": 0, "s": None}]


# ---------------------------------------------------------------------------
# chip_smoke.py's joins-phase queries on its own generator, cut to size
# ---------------------------------------------------------------------------

CHIP_SCALE = 1e-5


@pytest.fixture(scope="module")
def chip_data():
    star = CS.make_star(0, CHIP_SCALE)
    return star, _sessions({n: arrow_table(c) for n, c in star.items()})


@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("q", sorted(CS.JOIN_QUERIES))
def test_chip_join_query_matches_jax(chip_data, q, mode):
    star, sessions = chip_data
    j, t = sessions[mode]
    a, b, ev_j, ev_t = _run_both(j, t, CS.JOIN_QUERIES[q])
    assert structural(ev_t) == structural(ev_j), (ev_j, ev_t)
    assert a.num_rows > 0
    # ORDER BY sum among near-equal f32 sums: compare q93 as a row set
    assert_same(a, b, (q, mode), ordered=q == "q78")


def test_chip_references_match_the_port(chip_data):
    """chip_smoke's numpy references, held against the port at the cut
    size: q93 by customer, q16's count exactly and its sum within EPS."""
    star, sessions = chip_data
    t = sessions["off"][1]
    ref = CS.q93_reference(star)
    got = t.sql(CS.JOIN_QUERIES["q93"]).collect().to_pylist()
    assert got
    for r in got:
        s, _ = ref[r["ss_customer_sk"]]
        assert abs(r["sumsales"] - s) <= EPS * max(abs(s), 1.0)
    n, total, rows = CS.q16_reference(star)
    row = t.sql(CS.JOIN_QUERIES["q16"]).collect().to_pylist()[0]
    assert row["order_count"] == n and rows > 0
    assert abs(row["total_sales"] - total) <= EPS * max(abs(total), 1.0)


def test_generator_keys_hold(chip_data):
    """The declared keys the packed joins rely on hold in the generated
    data: (ss_item_sk, ss_ticket_number) and (sr_item_sk,
    sr_ticket_number) are unique, tickets have 8..16 lines."""
    star, _ = chip_data
    ss, sr = star["store_sales"], star["store_returns"]
    for items, tickets in ((ss["ss_item_sk"], ss["ss_ticket_number"]),
                           (sr["sr_item_sk"], sr["sr_ticket_number"])):
        w = items.astype(np.int64) << 32 | tickets
        assert np.unique(w).size == w.size
    lines = np.bincount(ss["ss_ticket_number"])[1:]
    assert lines.min() >= 8 and lines.max() <= 16
    assert lines.sum() == ss["ss_ticket_number"].size
