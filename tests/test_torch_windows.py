"""The window functions of nds_tpu_torch against the JAX package.

Small synthetic tables, built in memory from a numpy seed
(tests/torch_window_cases.py), go through the JAX package's Session (CPU;
its Pallas kernels in interpret mode where the `on` routes reach them; no
AOT cache) and the port's Session(device="cpu"), with
engine.pallas_{agg,join,sort} `off` and `on`. Cases: rank, dense_rank and
row_number; sum, avg, count, min and max over the whole partition, the
RANGE default with peer groups, ROWS UNBOUNDED PRECEDING..CURRENT ROW and
bounded ROWS frames (empty frames included); min / max of strings; ties
and NULLs in partition and order keys, asc and desc, no partition; windows
over aggregates; an empty input and a filter that kills every row. Then
small versions of chip_smoke.py's windows-phase queries on chip_smoke's
own generator.

Tolerance: integers, dates and strings EXACTLY; floats within
nds_tpu.validate.compare's 1e-5 relative epsilon. Results without an ORDER
BY are compared as row multisets. A spy (chip_smoke.branch_spy) on both
executors asserts that every window, join, set operation and grouping set
takes the same branch in both engines, and that each case reaches the
window functions and frames it is for.
"""

import os
import sys

import numpy as np
import pytest
import torch

from nds_tpu.engine.exec import ExecError as JaxExecError
from nds_tpu_torch.engine.exec import ExecError as TorchExecError

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import (  # noqa: E402,F401
    CS, EPS, arrow_table, assert_same, strict_budget,
)
from torch_parity import run_both, sessions  # noqa: E402
from torch_window_cases import (  # noqa: E402
    WINDOW_CASES, WINDOW_ERROR_SQL, missing_kinds, structural,
    window_tables,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pairs():
    return sessions(window_tables())


@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_matches_jax(pairs, case, mode):
    sql, kinds = WINDOW_CASES[case]
    j, t = pairs[mode]
    a, b, ev_j, ev_t = run_both(j, t, sql)
    assert structural(ev_t) == structural(ev_j), (ev_j, ev_t)
    assert not missing_kinds(ev_t, kinds), (kinds, ev_t)
    assert_same(a, b, (case, mode))
    if not case.startswith(("empty", "all_dead")):
        assert b.num_rows > 0


def test_window_frame_error_both_engines(pairs):
    """min / max over a bounded ROWS frame raise ExecError in both engines
    (the JAX executor has no such branch either)."""
    j, t = pairs["off"]
    with pytest.raises(JaxExecError) as ej:
        j.sql(WINDOW_ERROR_SQL).collect()
    with pytest.raises(TorchExecError) as et:
        t.sql(WINDOW_ERROR_SQL).collect()
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("case", ["int64", "float64", "one_segment",
                                  "singletons"])
def test_segment_cumsum_matches_jax(case):
    """exec._segment_cumsum: the prefix sum within sorted segments, int64
    exactly and float64 within EPS, the first segment starting at row 0."""
    import jax.numpy as jnp

    from nds_tpu.engine.exec import _segment_cumsum as jax_fn
    from nds_tpu_torch.engine.exec import _segment_cumsum as torch_fn

    rng = np.random.default_rng(3)
    n = 4096
    gid = {"one_segment": np.zeros(n, np.int32),
           "singletons": np.arange(n, dtype=np.int32)}.get(
        case, np.sort(rng.integers(0, 500, n)).astype(np.int32))
    x = (rng.random(n) * 100 if case == "float64"
         else rng.integers(-1000, 1000, n))
    t = torch_fn(torch.from_numpy(x), torch.from_numpy(gid)).numpy()
    j = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(gid)))
    heads = np.r_[True, gid[1:] != gid[:-1]]
    if case == "float64":
        np.testing.assert_allclose(t, j, rtol=EPS, atol=0)
        np.testing.assert_allclose(t[heads], x[heads], rtol=EPS, atol=0)
    else:
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t[heads], x[heads])


# ---------------------------------------------------------------------------
# chip_smoke.py's windows-phase queries on its own generator, cut to size
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chip_data():
    from torch_window_cases import CHIP_CONF, CHIP_SCALE

    star = CS.make_star(0, CHIP_SCALE)
    return star, sessions({n: arrow_table(c) for n, c in star.items()},
                          CHIP_CONF)


@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("q", sorted(CS.WINDOW_QUERIES))
def test_chip_window_query_matches_jax(chip_data, q, mode):
    from torch_window_cases import chip_window_sql

    star, pairs_ = chip_data
    j, t = pairs_[mode]
    a, b, ev_j, ev_t = run_both(j, t, chip_window_sql(q, star))
    assert structural(ev_t) == structural(ev_j), (ev_j, ev_t)
    assert not CS.missing_branches(ev_t, CS.WINDOW_BRANCHES[q]), ev_t
    assert a.num_rows > 0
    assert_same(a, b, (q, mode))


def test_chip_window_references_match_the_port(chip_data):
    """chip_smoke's numpy references, held against the port at the cut
    size (kernels off, sums in f64): q98 revenue and ratio per item, q36
    margins and ranks, the q5 shape's per-store sums, within EPS."""
    from torch_window_cases import chip_window_sql

    star, pairs_ = chip_data
    t = pairs_["off"][1]
    ref98 = CS.q98_reference(star)
    ids = CS.dictionary("i_item_id")
    item_of = {ids[c]: r for r, c in enumerate(star["item"]["i_item_id"])}
    got = t.sql(CS.WINDOW_QUERIES["q98"]).collect().to_pylist()
    assert got and len(got) == min(100, len(ref98))
    for r in got:
        rev, _, ratio = ref98[item_of[r["i_item_id"]]]
        assert abs(r["itemrevenue"] - rev) <= EPS * abs(rev)
        assert abs(r["revenueratio"] - ratio) <= EPS * abs(ratio)
    states = tuple(sorted({CS.STATES[i] for i in star["store"]["s_state"]}))
    ref36 = CS.q36_reference(star, states=states)
    got = t.sql(chip_window_sql("q36", star)).collect().to_pylist()
    assert got and len(got) == len(ref36)
    for r in got:
        m = ref36[(r["lochierarchy"], r["i_category"], r["i_class"])][0]
        assert abs(r["gross_margin"] - m) <= EPS * abs(m)
    ref5 = CS.q5_reference(star)
    got = t.sql(CS.WINDOW_QUERIES["q5"]).collect().to_pylist()
    stores = [r for r in got if r["id"] is not None]
    assert stores and len(stores) == min(98, len(ref5))
    for r in stores:
        sales, rets, prof, _, aprof = ref5[r["id"][len("store"):]]
        assert abs(r["sales"] - sales) <= EPS * abs(sales)
        assert abs(r["returns_amt"] - rets) <= EPS * max(abs(rets), 1.0)
        assert abs(r["profit"] - prof) <= EPS * aprof
