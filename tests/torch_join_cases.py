"""Shared, jax-free inputs of the port's join tests: small synthetic tables
built in memory from a numpy seed, the SQL cases that reach every join
branch (with the branch each must take), and the result comparison.
tests/test_torch_joins.py holds the cases against the JAX package on the
CPU; tests/test_torch_gpu.py runs them on the card against the port on the
CPU.

Tolerance: integers, dates and strings EXACTLY; floats within
nds_tpu.validate.compare's 1e-5 relative epsilon. Results without an
ORDER BY are compared as row multisets.
"""

import math
import os
import sys

import numpy as np
import pyarrow as pa
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as CS  # noqa: E402,F401

EPS = 1e-5  # nds_tpu/validate.py compare's relative epsilon


@pytest.fixture(autouse=True, scope="module")
def strict_budget():
    """A plan-budgeter fault fails the statement instead of being recorded
    as `verdict="error"`, and no session of either package without its own
    `engine.aot_cache_dir` reads or writes a persistent cache in the
    user's home (import this fixture into a test module; the cache's own
    tests give each session a private directory). Module-scoped, so that
    it holds for the module's fixtures too."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NDS_PLAN_BUDGET_STRICT", "1")
        mp.setenv("NDS_AOT_CACHE_DIR", "0")
        yield
#: a key domain past the dense join's reach (domain > 2^14 and > 8 x rows):
#: single-key joins on f_key take the packed or the hash path
KEY_SPAN = 9_000_000


def _nullable(rng, values, p):
    return pa.array([None if rng.random() < p else v for v in values])


def tables(seed=0, n_fact=2000, n_dim=400):
    rng = np.random.default_rng(seed)
    keys = rng.choice(KEY_SPAN, 300, replace=False) + 1
    val_grid = np.round(rng.random(60) * 20, 1)
    f_val = [float(v) for v in rng.choice(val_grid, n_fact)]
    f_val[3] = f_val[17] = float("nan")
    fact = pa.table({
        "f_id": np.arange(n_fact, dtype=np.int64),
        "f_key": rng.choice(keys, n_fact),
        "f_item": rng.integers(1, 41, n_fact),
        "f_grp": _nullable(rng, rng.integers(1, 7, n_fact).tolist(), 0.15),
        "f_str": _nullable(rng, rng.choice(["a", "b", "c"], n_fact).tolist(),
                           0.1),
        "f_qty": rng.integers(1, 101, n_fact),
        "f_val": pa.array([None if rng.random() < 0.05 else v for v in f_val],
                          type=pa.float64()),
    })
    # dim: keys from the fact's pool (with repeats) and outside it
    dkeys = np.concatenate([rng.choice(keys[:150], n_dim - 50),
                            rng.choice(KEY_SPAN, 50) + KEY_SPAN])
    dim = pa.table({
        "d_key": dkeys,
        "d_item": rng.integers(1, 41, n_dim),
        "d_grp": _nullable(rng, rng.integers(1, 9, n_dim).tolist(), 0.15),
        "d_str": _nullable(rng, rng.choice(["b", "c", "d"], n_dim).tolist(),
                           0.1),
        "d_qty": rng.integers(1, 101, n_dim),
        "d_val": pa.array([None if rng.random() < 0.05 else float(v)
                           for v in rng.choice(val_grid, n_dim)],
                          type=pa.float64()),
    })
    return {"fact": fact, "dim": dim}


#: a right side unique on (d_key, d_item) from plan metadata (a group-by)
DIM_U = """(select d_key, d_item, sum(d_qty) dq, min(d_val) dv
            from dim group by d_key, d_item)"""

#: name -> (SQL, events the case must produce in both engines)
CASES = {
    # -- packed-word join ------------------------------------------------
    "packed_inner": (f"""
        select f_id, f_qty, u.dq, u.dv from fact f, {DIM_U} u
        where f.f_key = u.d_key and f.f_item = u.d_item""",
        ["inner packed join, 2 keys"]),
    "packed_left": (f"""
        select f_id, u.dq, u.dv from fact f
        left join {DIM_U} u on f.f_key = u.d_key and f.f_item = u.d_item""",
        ["left packed join, 2 keys"]),
    "packed_semi": ("""
        select f_id from fact f where exists (
            select * from dim d where d.d_key = f.f_key)""",
        ["semi packed join, 1 key"]),
    "packed_anti": ("""
        select f_id, f_grp from fact f where not exists (
            select * from dim d where d.d_key = f.f_key
                                  and d.d_item = f.f_item)""",
        ["anti packed join, 2 keys"]),
    "packed_mark_not_in": ("""
        select f_id from fact where f_key not in (
            select d_key from dim where d_qty > 40)""",
        ["mark packed join, 1 key"]),
    "packed_mark_or": ("""
        select f_id from fact f
        where f_key in (select d_key from dim where d_qty > 60)
           or f_qty > 95""",
        ["mark packed join, 1 key"]),
    # three-valued IN under OR: NULL operands and NULLs in the subquery
    "dense_mark_or_nulls": ("""
        select f_id, f_grp from fact f
        where f_grp in (select d_grp from dim where d_qty > 60)
           or f_qty > 95""",
        ["mark dense join, 1 key"]),
    # -- hash-candidate semi / anti / mark -------------------------------
    "hash_semi": ("""
        select f_id, f_val from fact where f_val in (
            select d_val from dim where d_qty > 20)""",
        ["semi hash join, 1 key"]),
    "hash_anti": ("""
        select f_id from fact f where not exists (
            select * from dim d where d.d_val = f.f_val)""",
        ["anti hash join, 1 key"]),
    "hash_mark_not_in": ("""
        select f_id, f_val from fact where f_val not in (
            select d_val from dim where d_qty > 30 and d_val is not null)""",
        ["mark hash join, 1 key"]),
    "hash_semi_residual": ("""
        select f_id from fact f where exists (
            select * from fact f2 where f2.f_key = f.f_key
                                    and f2.f_item <> f.f_item)""",
        ["semi hash join, 1 key, residual"]),
    "hash_anti_residual": ("""
        select f_id, f_key from fact f where not exists (
            select * from dim d where d.d_key = f.f_key
                                  and d.d_qty > f.f_qty)""",
        ["anti hash join, 1 key, residual"]),
    "hash_mark_residual": ("""
        select f_id from fact f
        where exists (select * from dim d where d.d_key = f.f_key
                                             and d.d_qty > f.f_qty)
           or f_qty > 95""",
        ["mark hash join, 1 key, residual"]),
    # -- hash-candidate inner / left / full / right ---------------------
    # the binder filters an inner join's non-equi ON conjunct after the
    # join (test_join_method_matches_jax drives the residual itself)
    "hash_inner": ("""
        select f_id, d_qty from fact f join dim d
          on f.f_key = d.d_key and d.d_qty < f.f_qty""",
        ["inner hash join, 1 key"]),
    "hash_left": ("""
        select f_id, d_qty, d_str from fact f
        left join dim d on f.f_key = d.d_key""",
        ["left hash join, 1 key"]),
    "hash_left_residual": ("""
        select f_id, d_qty, d_val from fact f
        left join dim d on f.f_key = d.d_key and d.d_qty < f.f_qty""",
        ["left hash join, 1 key, residual"]),
    "hash_full": ("""
        select f_id, d_key, d_qty from fact f
        full outer join dim d on f.f_key = d.d_key""",
        ["full hash join, 1 key"]),
    "hash_full_residual": ("""
        select f_id, f_str, d_key, d_str from fact f
        full outer join dim d on f.f_key = d.d_key and d.d_qty < f.f_qty""",
        ["full hash join, 1 key, residual"]),
    "right_join": ("""
        select f_id, d_key, d_grp from fact f
        right join dim d on f.f_key = d.d_key""",
        ["right hash join, 1 key"]),
    # -- cross join ------------------------------------------------------
    "cross": ("""
        select a.f_grp, b.d_str, a.c * b.c n from
          (select f_grp, count(*) c from fact group by f_grp) a,
          (select d_str, count(*) c from dim group by d_str) b""",
        ["cross join"]),
    "cross_empty_side": ("""
        select count(*) n, sum(a.c) s from
          (select f_grp, count(*) c from fact group by f_grp) a,
          (select d_key from dim where d_qty > 1000) b""",
        ["cross join"]),
    # -- DISTINCT and set operations (NULLs equal) -----------------------
    "distinct": ("select distinct f_grp, f_str from fact", ["distinct"]),
    "distinct_floats": ("select distinct f_val from fact", ["distinct"]),
    "union": ("""
        select f_grp, f_str from fact where f_qty > 70
        union select d_grp, d_str from dim""",
        ["union"]),
    "union_all": ("""
        select f_grp g, f_val v from fact where f_qty > 90
        union all select d_grp, d_val from dim where d_qty > 90""",
        ["union_all"]),
    "intersect": ("""
        select f_grp, f_str from fact
        intersect select d_grp, d_str from dim""",
        ["intersect"]),
    "except": ("""
        select f_grp, f_str from fact
        except select d_grp, d_str from dim where d_qty > 50""",
        ["except"]),
    "union_all_aggregate": ("""
        select g, count(*) c, sum(q) s from (
            select f_grp g, f_qty q from fact
            union all select d_grp g, d_qty q from dim) u
        group by g""",
        ["union_all"]),
    # -- distinct aggregates --------------------------------------------
    "distinct_aggs_global": ("""
        select count(distinct f_item) ci, sum(distinct f_qty) sq,
               avg(distinct f_val) av, count(distinct f_str) cs
        from fact""",
        ["count(distinct)", "sum(distinct)", "avg(distinct)",
         "count(distinct)"]),
    "distinct_aggs_grouped": ("""
        select f_grp, count(distinct f_item) ci, sum(distinct f_qty) sq,
               avg(distinct f_val) av, count(*) n
        from fact group by f_grp""",
        ["count(distinct)", "sum(distinct)", "avg(distinct)"]),
    "distinct_aggs_string_key": ("""
        select f_str, f_grp, count(distinct f_key) ck,
               avg(distinct f_qty) aq
        from fact group by f_str, f_grp""",
        ["count(distinct)", "avg(distinct)"]),
}

#: empty inputs and mixed types: name -> SQL (no rows is a right answer)
EDGE_CASES = {
    "empty_distinct_aggs": """
        select count(distinct f_item) c, sum(distinct f_qty) s,
               avg(distinct f_val) a from fact where f_qty > 1000""",
    "empty_grouped_distinct_agg": """
        select f_grp, count(distinct f_item) c from fact
        where f_qty > 1000 group by f_grp""",
    "empty_union": """
        select f_grp from fact where f_qty > 1000
        union select d_grp from dim where d_qty > 1000""",
    "intersect_empty_right": """
        select f_grp from fact
        intersect select d_grp from dim where d_qty > 1000""",
    "except_empty_right": """
        select f_grp, f_str from fact
        except select d_grp, d_str from dim where d_qty > 1000""",
    "left_join_empty_left": """
        select f_id, d_qty from fact f left join dim d on f.f_key = d.d_key
        where f.f_qty > 1000""",
    "left_join_empty_right": """
        select f_id, d_qty from fact f
        left join (select * from dim where d_qty > 1000) d
          on f.f_key = d.d_key""",
    "full_join_empty_right": """
        select f_id, d_key from fact f
        full join (select * from dim where d_qty > 1000) d
          on f.f_key = d.d_key""",
    "semi_empty_right": """
        select count(*) c from fact f where exists (
            select * from dim d where d.d_key = f.f_key and d.d_qty > 1000)""",
    "distinct_empty": "select distinct f_grp from fact where f_qty > 1000",
    "union_all_string_literal": """
        select f_str s from fact where f_qty > 95
        union all select 'zz' s from dim where d_qty > 95""",
    "intersect_decimals": """
        select cast(f_qty as decimal(7,2)) q from fact
        intersect select cast(d_qty as decimal(7,2)) from dim""",
}

SET_EVENTS = ("distinct", "union", "union_all", "intersect", "except")


def structural(events):
    """The events both engines must share: joins, set operations, DISTINCT
    and distinct aggregates (aggregation routes may fuse in the JAX one)."""
    return [e for e in events
            if " join" in e or e in SET_EVENTS or "(distinct)" in e]


def canon(v):
    if v is None:
        return (0, 0)
    if isinstance(v, float) and math.isnan(v):
        return (1, 0)
    return (2, v)


def rows(table, ordered):
    cols = [table.column(c).to_pylist() for c in table.schema.names]
    rows = list(zip(*cols)) if cols else []
    if not ordered:
        rows.sort(key=lambda r: tuple(canon(v) for v in r))
    return rows


def assert_same(a, b, tag, ordered=False):
    assert a.schema.names == b.schema.names, tag
    assert a.num_rows == b.num_rows, (tag, a.num_rows, b.num_rows)
    for ra, rb in zip(rows(a, ordered), rows(b, ordered)):
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                if math.isnan(x) and math.isnan(y):
                    continue
                assert abs(x - y) <= EPS * max(abs(x), abs(y), 1.0), (
                    tag, x, y)
            else:
                assert x == y, (tag, ra, rb)


def arrow_table(cols):
    out = {}
    for c, d in cols.items():
        if c.endswith("__valid"):
            continue
        v = cols.get(c + "__valid")
        if CS.dictionary(c) is not None:
            out[c] = pa.array(np.array(CS.dictionary(c), dtype=object)[d])
        elif CS.COLUMN_TYPES.get(c) == "date":
            out[c] = pa.array(d.astype("datetime64[D]"))
        else:
            out[c] = pa.array(d, mask=None if v is None else ~v)
    return pa.table(out)
