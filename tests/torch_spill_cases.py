"""Shared, jax-free inputs of the port's out-of-core tests: small tables
built in memory from a numpy seed and the SQL cases that reach each
spilled path (with the path each must take). tests/test_torch_spill.py
holds them against the JAX package on the CPU; tests/test_torch_gpu.py
runs them on the card against the port on the CPU.
"""

from decimal import Decimal

import numpy as np
import pyarrow as pa

N = 4000


def _fact(seed):
    r = np.random.default_rng(seed)
    ks = r.integers(1, 40, N)
    vs = r.integers(-50, 50, N)
    return pa.table({
        "k": pa.array([None if i % 13 == 0 else int(x)
                       for i, x in enumerate(ks)], pa.int32()),
        "cat": pa.array([["Books", "Music", "Shoes", None][int(x) % 4]
                         for x in ks]),
        "v": pa.array([None if i % 7 == 0 else int(x)
                       for i, x in enumerate(vs)], pa.int32()),
        "amt": pa.array([Decimal(int(x) * 7) / 100 for x in vs],
                        pa.decimal128(7, 2)),
        # non-negative, as the window and channel tables: a kernel route's
        # f32 sums stay within the 1e-5 epsilon only without cancellation
        "f": pa.array([float(x + 50) / 3 for x in vs], pa.float64()),
    })


def _dup_dim(seed=5):
    # duplicated join keys keep the dense and packed paths out (they need
    # a unique right side), so the hash join the spilled path replaces runs
    r = np.random.default_rng(seed)
    return pa.table({
        "dk": pa.array([int(x) for x in r.integers(1, 40, 300)], pa.int32()),
        "dv": pa.array([int(x) for x in r.integers(0, 9, 300)], pa.int32()),
    })


def tables():
    return {"t1": _fact(1), "t2": _fact(2), "d": _dup_dim()}

JOIN_AGG = ("select t1.k, d.dv, sum(t1.v) sv, count(*) c, sum(t1.amt) sa, "
            "sum(t1.f) sf from t1, d where t1.k = d.dk group by t1.k, d.dv "
            "order by t1.k, d.dv")

#: name -> (SQL, the spilled path it must take). Where a query has no
#: ORDER BY, its rows come in the spilled path's partition-major order.
CASES = {
    "inner_join": (JOIN_AGG, "join"),
    "left_join": ("select t1.k, t1.cat, d.dv from t1 left join d "
                  "on t1.k = d.dk order by t1.k, t1.cat, d.dv", "join"),
    "join_empty_input": ("select t1.k, d.dv from t1, d where t1.k = d.dk "
                         "and t1.v > 1000 order by t1.k, d.dv", "join"),
    "sort_exact_order": ("select k, cat, v, amt, f from t1 order by cat, k",
                         "sort"),
    "distinct": ("select distinct k, cat from t1 order by k, cat",
                 "distinct"),
    "union": ("select k, v from t1 union select k, v from t2 "
              "order by k, v", "distinct"),
    "distinct_empty_after_filter": (
        "select distinct k from t1 where v > 1000 order by k", None),
    "left_join_partition_order": (
        "select t1.k, t1.cat, t1.f, d.dv from t1 left join d "
        "on t1.k = d.dk", "join"),
    "distinct_partition_order": ("select distinct k, cat, v from t1",
                                 "distinct"),
}
