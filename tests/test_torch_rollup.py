"""ROLLUP / grouping sets, grouping() and blocked union aggregation of
nds_tpu_torch against the JAX package.

Small synthetic tables, built in memory from a numpy seed
(tests/torch_window_cases.py), go through the JAX package's Session (CPU;
its Pallas kernels in interpret mode where the `on` routes reach them; no
AOT cache) and the port's Session(device="cpu"), with
engine.pallas_{agg,join,sort} `off` and `on`. Cases: ROLLUP with
decomposable aggregates (the cascade, avg through hidden sum and count
columns) and with non-decomposable ones (each set from scratch), explicit
GROUPING SETS, grouping(), the query36-shaped rank over a grouping()
partition, an empty input; then blocked union aggregation forced by a small
engine.union_agg_window_rows on both engines: the query5 shape, a union
inside an inner multijoin, avg decomposition, branches with different
string dictionaries (the aligners), a global aggregate, a union filtered to
nothing, ROLLUP over a union, and the single-window bail.

Tolerance: integers, dates and strings EXACTLY; floats within
nds_tpu.validate.compare's 1e-5 relative epsilon. Results without an ORDER
BY are compared as row multisets. A spy (chip_smoke.branch_spy) on both
executors asserts that both take the same grouping-set, grouping(),
blocked-union, window and join branches, and that each case reaches its
own; the blocked path's window statistics must agree too.
"""

import os
import sys

import pytest
import torch

from nds_tpu_torch.engine.columnar import bucket_cap

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import CS, assert_same  # noqa: E402
from torch_parity import run_both, session_pair, sessions  # noqa: E402
from torch_window_cases import (  # noqa: E402
    BLOCKED_CASES, ONE_WINDOW_SQL, ROLLUP_CASES, SMALL_WINDOW,
    channel_tables, structural, window_tables,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pairs():
    return sessions(window_tables())


@pytest.fixture(scope="module")
def blocked_pairs():
    return sessions(channel_tables(),
                    {"engine.union_agg_window_rows": SMALL_WINDOW})


@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("case", sorted(ROLLUP_CASES))
def test_grouping_sets_match_jax(pairs, case, mode):
    sql, wanted = ROLLUP_CASES[case]
    j, t = pairs[mode]
    a, b, ev_j, ev_t = run_both(j, t, sql)
    assert structural(ev_t) == structural(ev_j), (ev_j, ev_t)
    assert not CS.missing_branches(ev_t, wanted), (wanted, ev_t)
    assert_same(a, b, (case, mode), ordered="order by" in sql)
    if case != "rollup_empty_input":
        assert b.num_rows > 0


@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("case", sorted(BLOCKED_CASES))
def test_blocked_union_matches_jax(blocked_pairs, case, mode):
    sql, wanted = BLOCKED_CASES[case]
    j, t = blocked_pairs[mode]
    j.last_blocked_union = t.last_blocked_union = None
    a, b, ev_j, ev_t = run_both(j, t, sql)
    assert structural(ev_t) == structural(ev_j), (ev_j, ev_t)
    assert not CS.missing_branches(ev_t, wanted), (wanted, ev_t)
    assert_same(a, b, (case, mode), ordered="order by" in sql)
    stats = t.last_blocked_union
    assert stats == j.last_blocked_union
    assert stats["windows"] > 1
    assert stats["max_table_cap"] < bucket_cap(stats["total_rows"])


@pytest.mark.parametrize("case", sorted(BLOCKED_CASES))
def test_blocked_equals_plain_path(blocked_pairs, case):
    """The port's windowed result equals its own single-window (plain)
    result for every blocked case."""
    sql, _ = BLOCKED_CASES[case]
    t_small = blocked_pairs["off"][1]
    _, t_big = session_pair(channel_tables(),
                            {"engine.union_agg_window_rows": 10**9})
    assert_same(t_big.sql(sql).collect(), t_small.sql(sql).collect(), case,
                ordered="order by" in sql)
    assert t_big.last_blocked_union is None


def test_one_window_bail_matches_jax():
    """A window past the union's rows: both engines bail to the plain
    concat and aggregation (no blocked level, no window statistics)."""
    j, t = session_pair(channel_tables(),
                        {"engine.union_agg_window_rows": 10**9})
    a, b, ev_j, ev_t = run_both(j, t, ONE_WINDOW_SQL)
    assert structural(ev_t) == structural(ev_j), (ev_j, ev_t)
    assert "union_all" in ev_t
    assert not any(e.startswith("blocked union") for e in ev_t)
    assert j.last_blocked_union is None and t.last_blocked_union is None
    assert_same(a, b, "one window", ordered=True)


def test_non_decomposable_union_stays_plain(blocked_pairs):
    """count(distinct) over a union is never marked for the blocked path
    (plan.aggs_decomposable), whatever the window."""
    sql = """select k, count(distinct v) dv
             from (select k, v from t1 union all select k, v from t2) u
             group by k order by k"""
    j, t = blocked_pairs["off"]
    j.last_blocked_union = t.last_blocked_union = None
    a, b, ev_j, ev_t = run_both(j, t, sql)
    assert structural(ev_t) == structural(ev_j)
    assert not any(e.startswith("blocked union") for e in ev_t)
    assert t.last_blocked_union is None
    assert_same(a, b, "count distinct over a union", ordered=True)
