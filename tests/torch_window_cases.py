"""Shared, jax-free inputs of the port's window, ROLLUP / grouping-set and
blocked-union tests: small synthetic tables built in memory from a numpy
seed, the SQL cases that reach every branch (with the window functions and
frames, grouping-set counts and blocked levels each must show), and the
event filters. tests/test_torch_windows.py and tests/test_torch_rollup.py
hold the cases against the JAX package on the CPU; tests/test_torch_gpu.py
runs them on the card against the port on the CPU.

Tolerance: integers, dates and strings EXACTLY; floats within
nds_tpu.validate.compare's 1e-5 relative epsilon (torch_join_cases.EPS).
Results without an ORDER BY are compared as row multisets.
"""

from decimal import Decimal

import numpy as np
import pyarrow as pa

from torch_join_cases import CS, SET_EVENTS

#: the window rows that force blocked union aggregation on the channel
#: tables (3 x 3,000 rows and 2,000 returns: several windows per branch)
SMALL_WINDOW = 700


def _nullable(rng, values, p, typ=None):
    return pa.array([None if rng.random() < p else v for v in values],
                    type=typ)


def window_tables(seed=0, n=1500):
    """`w`: partition keys with NULLs (g int, h string), order keys with
    ties and NULLs (o) and a tie breaker (o2), float / int / decimal /
    string measures with NULLs; `w_empty`: the same columns, no rows."""
    rng = np.random.default_rng(seed)
    # non-negative floats (and a -0.0): the `on` routes sum in f32, and a
    # sum of n non-negative terms stays within (n + 1) * 2^-24 of the f64
    # one, inside the 1e-5 epsilon (ROADMAP.md queue 3 item 4)
    grid = np.round(np.abs(rng.standard_normal(40)) * 50, 2)
    grid[0] = -0.0
    w = pa.table({
        "g": _nullable(rng, rng.integers(1, 7, n).tolist(), 0.1, pa.int32()),
        "h": _nullable(rng, rng.choice(["Books", "Music", "Shoes", "Home"],
                                       n).tolist(), 0.05),
        "o": _nullable(rng, rng.integers(0, 40, n).tolist(), 0.05,
                       pa.int32()),
        "o2": rng.permutation(n).astype(np.int64) * 7 + 3,
        "v": _nullable(rng, [float(x) for x in rng.choice(grid, n)], 0.08,
                       pa.float64()),
        "q": pa.array(rng.integers(1, 101, n), pa.int32()),
        "d": pa.array([Decimal(int(x)) / 100
                       for x in rng.integers(-5000, 50000, n)],
                      pa.decimal128(7, 2)),
        "s": _nullable(rng, rng.choice(["kiwi", "apple", "fig", "date",
                                        "cherry", "banana"], n).tolist(),
                       0.07),
    })
    return {"w": w, "w_empty": w.slice(0, 0)}


#: name -> (SQL, window kinds the case must show: chip_smoke.window_kind of
#: each function, across the window events of both engines)
WINDOW_CASES = {
    "rank_family": ("""
        select g, o, o2,
               rank() over (partition by g order by o) r,
               dense_rank() over (partition by g order by o) dr,
               row_number() over (partition by g order by o, o2) rn
        from w""",
        ["rank", "dense_rank", "row_number"]),
    "rank_desc_strings": ("""
        select h, g, s, o, o2,
               rank() over (partition by h order by s desc, o) r,
               dense_rank() over (partition by h, g order by o desc) dr,
               row_number() over (partition by s order by o2 desc) rn
        from w""",
        ["rank", "dense_rank", "row_number"]),
    "no_partition": ("""
        select o, o2, rank() over (order by o desc) r,
               row_number() over (order by o2) rn,
               sum(v) over () tot, count(*) over () n
        from w""",
        ["rank", "row_number", "sum whole", "count whole"]),
    "whole": ("""
        select g, sum(v) over (partition by g) sv,
               avg(v) over (partition by g) av,
               count(v) over (partition by g) cv,
               min(v) over (partition by g) mn,
               max(v) over (partition by g) mx,
               count(*) over (partition by g) n,
               sum(q) over (partition by g) sq,
               avg(d) over (partition by g) ad,
               min(s) over (partition by g) ms,
               max(s) over (partition by h) xs
        from w""",
        ["sum whole", "avg whole", "count whole", "min whole", "max whole",
         "count whole", "sum whole", "avg whole", "min whole",
         "max whole"]),
    "whole_explicit_frame": ("""
        select h, o,
               sum(v) over (partition by h order by o rows between
                            unbounded preceding and unbounded following) s,
               max(s) over (partition by h order by o rows between
                            unbounded preceding and unbounded following) m
        from w""",
        ["sum whole", "max whole"]),
    "range": ("""
        select g, o, sum(v) over (partition by g order by o) sv,
               avg(d) over (partition by g order by o) ad,
               count(v) over (partition by g order by o) cv,
               min(v) over (partition by g order by o) mn,
               max(s) over (partition by g order by o) ms
        from w""",
        ["sum range", "avg range", "count range", "min range",
         "max range"]),
    "range_desc_no_partition": ("""
        select o, sum(q) over (order by o desc) sq,
               max(v) over (order by o desc) mx,
               count(*) over (order by o desc) n
        from w""",
        ["sum range", "max range", "count range"]),
    "running": ("""
        select h, o, o2,
               sum(v) over (partition by h order by o, o2 rows between
                            unbounded preceding and current row) sv,
               avg(v) over (partition by h order by o, o2 rows between
                            unbounded preceding and current row) av,
               count(*) over (partition by h order by o, o2 rows between
                              unbounded preceding and current row) n,
               min(v) over (partition by h order by o, o2 rows between
                            unbounded preceding and current row) mn,
               max(q) over (partition by h order by o, o2 rows between
                            unbounded preceding and current row) mq,
               min(s) over (partition by h order by o, o2 rows between
                            unbounded preceding and current row) ms
        from w""",
        ["sum running", "avg running", "count running", "min running",
         "max running", "min running"]),
    "running_desc": ("""
        select g, o, o2,
               sum(d) over (partition by g order by o desc, o2 rows
                            between unbounded preceding and current row) sd,
               max(v) over (partition by g order by o desc, o2 rows
                            between unbounded preceding and current row) mx
        from w""",
        ["sum running", "max running"]),
    "rows_bounded": ("""
        select g, o2,
               avg(v) over (partition by g order by o2 rows between
                            2 preceding and 1 preceding) a21,
               sum(q) over (partition by g order by o2 rows between
                            1 preceding and 1 following) s11,
               count(v) over (partition by g order by o2 rows between
                              current row and 2 following) c02,
               sum(d) over (partition by g order by o2 rows between
                            1 following and unbounded following) s1u,
               sum(v) over (partition by g order by o2 rows between
                            unbounded preceding and 1 following) su1,
               count(*) over (partition by g order by o2 rows between
                              3 following and 5 following) c35
        from w""",
        ["avg rows", "sum rows", "count rows", "sum rows", "sum rows",
         "count rows"]),
    "over_aggregate": ("""
        select h, g, sum(q) sq, sum(sum(q)) over (partition by h) tot,
               sum(q) * 100 / sum(sum(q)) over (partition by h) ratio
        from w group by h, g""",
        ["sum whole"]),
    "rank_over_aggregate": ("""
        select g, h, sum(v) sv,
               rank() over (partition by g order by sum(v) desc) rk
        from w group by g, h""",
        ["rank"]),
    "filtered_input": ("""
        select g, o, o2, v,
               row_number() over (partition by g order by o2) rn,
               sum(v) over (partition by g order by o) sv
        from w where q > 50""",
        ["row_number", "sum range"]),
    "empty_input": ("""
        select g, rank() over (partition by g order by o) r,
               sum(v) over (partition by g) sv,
               avg(v) over (partition by g order by o rows between
                            1 preceding and 1 following) av
        from w_empty""",
        ["rank", "sum whole", "avg rows"]),
    "all_dead_rows": ("""
        select g, rank() over (partition by g order by o) r,
               sum(v) over (partition by g order by o) sv,
               min(v) over (partition by g order by o rows between
                            unbounded preceding and current row) mn
        from w where q > 1000""",
        ["rank", "sum range", "min running"]),
}

#: min / max over a frame other than the whole partition, RANGE or the
#: running ROWS frame: ExecError in both engines
WINDOW_ERROR_SQL = """
    select g, min(v) over (partition by g order by o2 rows between
                           1 preceding and 1 following) m
    from w"""


#: name -> (SQL, events the case must produce in both engines)
ROLLUP_CASES = {
    "rollup_decomposable": ("""
        select g, h, sum(q) sq, count(*) n, count(v) cv, min(v) mn,
               max(s) mx, avg(v) av, sum(d) sd, avg(d) ad
        from w group by rollup(g, h)""",
        ["grouping sets, 3 sets"]),
    "rollup_three_keys": ("""
        select h, g, s, sum(v) sv, count(*) n, max(o) mo
        from w group by rollup(h, g, s)""",
        ["grouping sets, 4 sets"]),
    "rollup_non_decomposable": ("""
        select g, h, count(distinct q) cq, stddev_samp(v) sd, sum(q) sq
        from w group by rollup(g, h)""",
        ["grouping sets, 3 sets", "count(distinct)", "count(distinct)",
         "count(distinct)"]),
    "grouping_sets": ("""
        select g, h, sum(q) sq, avg(v) av, count(*) n
        from w group by grouping sets ((g, h), (h), (g), ())""",
        ["grouping sets, 4 sets"]),
    "grouping_sets_distinct": ("""
        select g, h, count(distinct s) cs, sum(q) sq
        from w group by grouping sets ((g, h), (h))""",
        ["grouping sets, 2 sets", "count(distinct)", "count(distinct)"]),
    "grouping": ("""
        select g, h, sum(q) sq, grouping(g) gg, grouping(h) gh
        from w group by rollup(g, h)""",
        ["grouping sets, 3 sets"] + ["grouping()"] * 6),
    # query36.tpl's shape over `w`
    "q36_shape": ("""
        select sum(v) / sum(q) as gross_margin, h, s,
               grouping(h) + grouping(s) as lochierarchy,
               rank() over (
                 partition by grouping(h) + grouping(s),
                              case when grouping(s) = 0 then h end
                 order by sum(v) / sum(q) asc) as rank_within_parent
        from w where q > 5
        group by rollup(h, s)
        order by lochierarchy desc,
                 case when lochierarchy = 0 then h end,
                 rank_within_parent, h, s
        limit 100""",
        ["grouping sets, 3 sets", "window rank"]),
    "rollup_empty_input": ("""
        select g, h, sum(q) sq, count(*) n, avg(v) av
        from w where q > 1000 group by rollup(g, h)""",
        ["grouping sets, 3 sets"]),
}


def _channel(n, seed, cats):
    r = np.random.default_rng(seed)
    ks = r.integers(1, 6, n)
    vs = r.integers(-50, 50, n)
    return pa.table({
        "k": pa.array([None if i % 13 == 0 else int(v)
                       for i, v in enumerate(ks)], pa.int32()),
        "cat": pa.array([cats[int(v) % len(cats)] for v in ks]),
        "v": pa.array([None if i % 7 == 0 else int(v)
                       for i, v in enumerate(vs)], pa.int32()),
        "amt": pa.array([Decimal(int(v) * 7) / 100 for v in vs],
                        pa.decimal128(7, 2)),
        "dt": pa.array(r.integers(1, 31, n), pa.int32()),
        # non-negative, as window_tables' floats: the `on` routes sum in f32
        "f": np.abs(r.standard_normal(n)).round(3),
    })


def channel_tables():
    """Three sales channels whose `cat` dictionaries differ (the union
    aligners remap them), a returns table, a store-like dimension and a
    date-like dimension."""
    r = np.random.default_rng(7)
    n_ret = 2000
    returns = pa.table({
        "rk": pa.array(r.integers(1, 6, n_ret), pa.int32()),
        "rdt": pa.array(r.integers(1, 31, n_ret), pa.int32()),
        "ramt": pa.array([Decimal(int(x)) / 100
                          for x in r.integers(0, 9000, n_ret)],
                         pa.decimal128(7, 2)),
        "rloss": r.random(n_ret).round(4) * 30,
    })
    return {
        "t1": _channel(3000, 100, ["Books", "Music", "Shoes"]),
        "t2": _channel(3000, 101, ["Toys", "Books"]),
        "t3": _channel(3000, 102, ["Shoes", "Garden", "Music", "Home"]),
        "ret": returns,
        "dim": pa.table({
            "dk": pa.array(range(1, 6), pa.int32()),
            "dname": pa.array([f"store {i}" for i in range(1, 6)]),
            "flag": pa.array([i % 2 for i in range(1, 6)], pa.int32()),
        }),
        "dates": pa.table({
            "dd": pa.array(range(1, 31), pa.int32()),
            "dweek": pa.array([i // 7 for i in range(1, 31)], pa.int32()),
        }),
    }


#: name -> (SQL, events both engines must produce under SMALL_WINDOW)
BLOCKED_CASES = {
    "plain_all_aggs": ("""
        select k, sum(v) sv, min(v) mn, max(v) mx, count(v) cv, count(*) c,
               avg(v) av, sum(amt) sa, avg(amt) aa, max(f) xf
        from (select k, cat, v, amt, f from t1
              union all select k, cat, v, amt, f from t2 where v > -40
              union all select k, cat, v, amt, f from t3) u
        where v < 45 group by k order by k""",
        ["blocked union, 1 key"]),
    "string_key_dictionaries": ("""
        select cat, sum(v) sv, count(*) c, avg(v) av, min(cat) mc
        from (select cat, v from t1 union all select cat, v from t2
              union all select cat, v from t3) u
        group by cat order by cat""",
        ["blocked union, 1 key"]),
    "global": ("""
        select sum(v) sv, min(v) mn, count(v) cv, count(*) c, avg(f) af
        from (select v, f from t1 union all select v, f from t2
              where v > 0) u""",
        ["blocked union, 0 keys"]),
    "empty_after_filter": ("""
        select k, sum(v) sv from
        (select k, v from t1 union all select k, v from t2) u
        where v > 1000 group by k""",
        ["blocked union, 1 key"]),
    "through_inner_join": ("""
        select d.dname, sum(u.v) sv, count(*) c, avg(u.amt) av
        from (select k, v, amt from t1 union all select k, v, amt from t2) u,
             dim d
        where u.k = d.dk and d.flag = 1
        group by d.dname order by d.dname""",
        ["blocked union, 1 key", "inner dense join, 1 key"]),
    "rollup_over_union": ("""
        select cat, k, sum(v) sv, count(*) c, avg(v) av
        from (select cat, k, v from t1
              union all select cat, k, v from t2
              union all select cat, k, v from t3) u
        group by rollup(cat, k)
        order by cat, k""",
        ["grouping sets, 3 sets", "blocked union, 2 keys"]),
    # query5.tpl's store channel: sales and returns as one union, joined
    # to the date and store dimensions, summed by store, then rolled up
    "q5_shape": ("""
        with ssr as (
          select s_id, sum(sales_price) as sales, sum(profit) as profit,
                 sum(return_amt) as returns, sum(net_loss) as profit_loss
          from (select k as store_sk, dt as date_sk, amt as sales_price,
                       f as profit, cast(0 as decimal(7,2)) as return_amt,
                       cast(0 as double) as net_loss
                from t1
                union all
                select rk as store_sk, rdt as date_sk,
                       cast(0 as decimal(7,2)) as sales_price,
                       cast(0 as double) as profit, ramt as return_amt,
                       rloss as net_loss
                from ret) salesreturns,
               dates, (select dk, dname as s_id from dim) st
          where date_sk = dd and dweek between 1 and 3
            and store_sk = dk
          group by s_id)
        select channel, id, sum(sales) as sales, sum(returns) as returns,
               sum(profit) as profit
        from (select 'store channel' as channel, 'store' || s_id as id,
                     sales, returns, (profit - profit_loss) as profit
              from ssr) x
        group by rollup(channel, id)
        order by channel, id""",
        ["blocked union, 1 key", "grouping sets, 3 sets"]),
}

#: the single-window bail: a window past the union's rows takes the plain
#: concat + aggregation path in both engines
ONE_WINDOW_SQL = BLOCKED_CASES["through_inner_join"][0]

WINDOW_EVENT_PREFIXES = ("window ", "grouping sets", "blocked union")


def structural(events):
    """The events both engines must share: joins, set operations,
    DISTINCT, distinct aggregates, windows, grouping sets, grouping() and
    blocked union levels (plain aggregation routes may fuse in the JAX
    engine)."""
    return [e for e in events
            if " join" in e or e in SET_EVENTS or "(distinct)" in e
            or e == "grouping()" or e.startswith(WINDOW_EVENT_PREFIXES)]


def window_kinds(events):
    """The window kinds of every window event, flattened."""
    out = []
    for e in events:
        if e.startswith("window "):
            out += e[len("window "):].split(", ")
    return out


def missing_kinds(events, wanted):
    return CS.missing_branches(window_kinds(events), wanted)


#: chip_smoke's windows-phase queries cut to size: the scale of its
#: generator, and the union window that keeps the q5 shape blocked there
CHIP_SCALE = 1e-4
CHIP_CONF = {"engine.union_agg_window_rows": 4096}


def chip_window_sql(q, star):
    """WINDOW_QUERIES[q] over a cut star: q36's state list becomes the
    states its few stores have (at SF100 the template's eight states hold
    ~16% of the stores; at a cut scale they may hold none)."""
    sql = CS.WINDOW_QUERIES[q]
    if q == "q36":
        states = tuple(sorted({CS.STATES[i] for i in star["store"]["s_state"]}))
        sql = sql.replace(str(CS.Q36_STATES), str(states + ("ZZ",)))
    return sql
