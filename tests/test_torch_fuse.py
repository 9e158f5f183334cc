"""Fused pipelines, fused aggregate tails, top-k and the cross-statement
caches of nds_tpu_torch (engine/fuse.py, engine/exec.py, engine/session.py)
against the JAX package.

The cases of the JAX package's tests/test_fuse.py and
tests/test_fuse_agg.py, with their inputs, through both engines: the
port's fused result must equal its own unfused result EXACTLY (the fused
call runs the eager path's tensor ops in the same order) and the JAX
package's fused result within nds_tpu.validate.compare's 1e-5 epsilon
(integers, dates and strings exactly). The plan shapes, the pinned
signatures, the entry reuse, donation, top-k, the join-order memo and the
plan cache are held to the JAX package's behaviour. The reference's two
kernel-span tracing cases and the trace-event half of its exec-cache case
run through the port in tests/test_torch_obs.py; its SF10
bench-isolation helpers belong to bench.py, which the port has not
ported.

Both engines run without a persistent cache (engine.aot_cache_dir="");
tests/test_torch_aotcache.py covers it in private directories.
"""

import gc
import math
import os
import sys
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from nds_tpu.engine import fuse as JF
from nds_tpu.engine.session import Session as JaxSession
from nds_tpu_torch.engine import fuse as TF
from nds_tpu_torch.engine import plan as P
from nds_tpu_torch.engine.session import Session as TorchSession

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import assert_same, strict_budget  # noqa: E402,F401

NO_AOT = {"engine.aot_cache_dir": ""}


def _table(n, seed=0):
    r = np.random.default_rng(seed)
    ks = r.integers(0, 15, n)
    vs = r.integers(-80, 80, n)
    return pa.table(
        {
            "k": pa.array(
                [None if i % 11 == 0 else int(v) for i, v in enumerate(ks)],
                pa.int32(),
            ),
            "v": pa.array(
                [None if i % 7 == 3 else int(v) for i, v in enumerate(vs)],
                pa.int64(),
            ),
            "cat": pa.array(
                [
                    None if i % 13 == 5
                    else ["Books", "Music", "Shoes", "Home"][int(x) % 4]
                    for i, x in enumerate(ks)
                ],
                pa.string(),
            ),
            "amt": pa.array(
                [Decimal(int(v) * 3) / 100 for v in vs], pa.decimal128(7, 2)
            ),
            "d": pa.array([10957 + int(x) * 37 for x in ks], pa.int32()),
        }
    )


def _sessions(n=2000, conf=None, tables=None):
    """(JAX fused, port fused, port unfused) over the same tables."""
    conf = dict(conf or {})
    j = JaxSession(conf={**conf, **NO_AOT})
    on = TorchSession(conf={**conf, **NO_AOT}, device="cpu")
    off = TorchSession(conf={**conf, **NO_AOT, "engine.fuse": "off"},
                       device="cpu")
    tables = tables or {"t": _table(n), "u": _table(n, seed=1)}
    for s in (j, on, off):
        for name, at in tables.items():
            s.register_arrow(name, at)
    return j, on, off


def _check(j, on, off, q, ordered=True):
    """The port's fused result: equal to its unfused one, and to JAX's."""
    a = on.sql(q).collect()
    assert a.equals(off.sql(q).collect()), q
    assert_same(j.sql(q).collect(), a, q, ordered=ordered)
    return a


def _pipelines(plan, agg=None):
    out, seen = [], set()

    def walk(n):
        if n is None or id(n) in seen:
            return
        seen.add(id(n))
        if isinstance(n, P.Pipeline) and (agg is None
                                          or (n.agg is not None) == agg):
            out.append(n)
        for c in n.children():
            walk(c)
    walk(plan)
    return out


def _raw_aggregates(plan):
    """Aggregate nodes of the tree (children only: a Pipeline's detached
    aggregate tail is not a node of it)."""
    out, seen = [], set()

    def walk(n):
        if n is None or id(n) in seen:
            return
        seen.add(id(n))
        if isinstance(n, P.Aggregate):
            out.append(n)
        for c in n.children():
            walk(c)
    walk(plan)
    return out


def _pinned(session):
    return sorted(k[0] for k, v in session.exec_cache.map.items()
                  if v is None)


# ---------------------------------------------------------------------------
# tests/test_fuse.py
# ---------------------------------------------------------------------------

EQUALITY_QUERIES = [
    # plain filter chain (mask-only pipeline, count mode)
    "select k, v from t where v > 10 and k is not null order by k, v",
    # filter + computed projection (string LIKE over dictionary)
    "select k, v * 2 vv, cat from t where cat like 'B%' and v between -50 "
    "and 50 order by k, vv",
    # IN list + CASE + decimal arithmetic
    "select k, case when v > 0 then amt else amt * -1 end aa from t "
    "where cat in ('Books', 'Shoes') order by k, aa",
    # null-sensitive predicates (three-valued logic through the fused mask)
    "select k, v from t where v <> 3 or k = 5 order by k, v",
    # chain feeding an aggregate (partial-agg input arrives fused)
    "select k, sum(v) sv, count(*) c, avg(amt) aa from t where v > -60 "
    "group by k order by k",
    # post-join linear wrappers (pipeline over a join output)
    "select x.k, x.s from (select t.k \"k\", t.v + u.v s from t, u "
    "where t.k = u.k and t.v > u.v) x where x.s > 20 order by x.k, x.s",
    # date function + projection-only pipeline
    "select k, year(cast(d as date)) y from t where v >= 0 order by k, y",
    # empty result through the fused mask
    "select k, v from t where v > 1000 order by k",
]


@pytest.mark.parametrize("qi", range(len(EQUALITY_QUERIES)))
def test_fused_path_equality(qi):
    j, on, off = _sessions()
    _check(j, on, off, EQUALITY_QUERIES[qi])
    assert _pipelines(on.sql(EQUALITY_QUERIES[qi]).plan)


def test_float_division_within_validator_epsilon():
    """The reference allows its fused float64 chains a last-ulp drift
    (XLA reassociates); the port's fused call runs the eager ops as they
    are, so it equals its unfused path exactly, and JAX's within 1e-12."""
    j, on, off = _sessions()
    q = ("select k, sum(v) * 100 / (1 + sum(amt)) r from t "
         "where v > -70 group by k order by k")
    a = on.sql(q).collect()
    assert a.equals(off.sql(q).collect())
    ja = j.sql(q).collect().to_pylist()
    assert len(ja) == a.num_rows and ja
    for x, y in zip(ja, a.to_pylist()):
        assert x["k"] == y["k"]
        if x["r"] is None or y["r"] is None:
            assert x["r"] == y["r"]
        else:
            assert math.isclose(x["r"], y["r"], rel_tol=1e-12)


def test_fused_over_empty_table():
    j, on, off = _sessions()
    for s in (j, on, off):
        s.register_arrow("e", _table(0))
    _check(j, on, off, "select k, v + 1 vv from e where v > 0 order by k")


@pytest.mark.parametrize("n", [1023, 1024, 1025])
def test_bucket_boundary_rows(n):
    j, on, off = _sessions(n=n)
    _check(j, on, off, "select k, v - 1 w from t where v > 0 and k is not "
           "null order by k, w")


def test_mark_pipelines_plan_shape():
    j, on, _ = _sessions()
    q = "select k, v * 2 vv from t where v > 0 and cat like 'B%'"
    r = on.sql(q)
    pipes = _pipelines(r.plan)
    assert len(pipes) == 1
    p = pipes[0]
    assert isinstance(p.child, P.Scan)
    # execution order: filter first, projection last
    assert isinstance(p.stages[0], P.Filter)
    assert isinstance(p.stages[-1], P.Project)
    assert all(st.child is None for st in p.stages)
    # scans alias catalog buffers: never donation-eligible
    assert p.donate_ok is False
    assert "Pipeline" in r.explain()
    assert r.explain() == j.sql(q).explain()


def test_pure_rename_chain_not_fused():
    j, on, _ = _sessions()
    q = "select k kk, v from t"
    assert not isinstance(on.sql(q).plan, P.Pipeline)
    assert on.sql(q).explain() == j.sql(q).explain()


def test_executable_reuse():
    """A rerun with the plan cache off rides the entry the first run
    built: a miss, then a hit (the reference reads the same off its
    exec_cache trace events)."""
    _, s, _ = _sessions()
    q = "select k, v + 1 vv from t where v > 0 order by k, vv"
    s.sql(q).collect()
    assert (s.exec_cache.builds, s.exec_cache.hits, s.exec_cache.misses) \
        == (1, 0, 1)
    s.conf["engine.plan_cache"] = "off"
    s.sql(q).collect()
    assert (s.exec_cache.builds, s.exec_cache.hits) == (1, 1)


def test_executable_reuse_across_scale_factors():
    """Same structure at another row count (another bucket): the SAME
    entry serves both, nothing is rebuilt."""
    j = JaxSession(conf=dict(NO_AOT))
    s = TorchSession(conf=dict(NO_AOT), device="cpu")
    q = "select k, v + 1 vv from t where v > 0 and k < 10 order by k, vv"
    for sess in (j, s):
        sess.register_arrow("t", _table(1500))
    expect_small = s.sql(q).collect()
    assert_same(j.sql(q).collect(), expect_small, q, ordered=True)
    assert len(s.exec_cache.map) == len(j.exec_cache.map) == 1
    entry_small = next(iter(s.exec_cache.map.values()))
    for sess in (j, s):
        sess.register_arrow("t", _table(12000, seed=3))
    assert_same(j.sql(q).collect(), s.sql(q).collect(), q, ordered=True)
    assert len(s.exec_cache.map) == 1  # same entry, no rebuild
    assert next(iter(s.exec_cache.map.values())) is entry_small
    assert s.exec_cache.misses >= 2 and s.exec_cache.builds == 1
    s.conf["engine.plan_cache"] = "off"
    hits0 = s.exec_cache.hits
    s.sql(q).collect()
    assert s.exec_cache.hits > hits0
    s.register_arrow("t", _table(1500))
    assert s.sql(q).collect().equals(expect_small)


def test_unfusible_chain_pins_to_eager():
    """A numeric->string cast formats device values on the host: the
    build raises, the signature is pinned (as JAX's trace fails and pins
    it), and the eager path answers."""
    j, on, off = _sessions()
    q = ("select cast(v as varchar(10)) sv, k from t where v > 0 "
         "order by k, sv")
    _check(j, on, off, q)
    assert _pinned(on) and _pinned(on) == _pinned(j)
    assert on.exec_cache.pins == 1
    on.conf["engine.plan_cache"] = "off"
    assert on.sql(q).collect().equals(off.sql(q).collect())
    assert on.exec_cache.pins == 1  # not re-attempted


def test_scalar_subquery_stays_unfused_and_correct():
    j, on, off = _sessions()
    _check(j, on, off, "select k, v from t where v > (select avg(v) from u) "
           "order by k, v")


def test_blocked_union_agg_still_blocked_with_fusion():
    conf = {"engine.union_agg_window_rows": 512}
    tables = {"t": _table(3000), "u": _table(3000, seed=1)}
    j, on, off = _sessions(conf=conf, tables=tables)
    q = """
    select k, sum(v) sv, count(*) c, avg(v) av
    from (select k, v from t where v > -70
          union all
          select k, v from u) x
    where v < 70
    group by k order by k
    """
    ra = on.sql(q)
    a = ra.collect()
    assert a.equals(off.sql(q).collect())
    assert_same(j.sql(q).collect(), a, q, ordered=True)
    assert ra.executor.last_blocked_union is not None
    assert ra.executor.last_blocked_union["windows"] > 1


def test_donation_safety_and_oom_wipe():
    """fuse_donate=on over a join-fed pipeline: results stable across
    reruns, and after an OOM-recovery wipe (new catalog buffers, new
    signatures)."""
    j, on, off = _sessions(conf={"engine.fuse_donate": "on"})
    q = ("select x.k, x.s + 1 s1 from (select t.k \"k\", t.v + u.v s "
         "from t, u where t.k = u.k and t.v > u.v) x where x.s > 10 "
         "order by x.k, s1")
    expect = _check(j, on, off, q)
    assert any(p.donate_ok for p in _pipelines(on.sql(q).plan))
    on.conf["engine.plan_cache"] = "off"
    assert on.sql(q).collect().equals(expect)
    on.recover_memory("test: simulated OOM wipe")
    assert not on.exec_cache.map
    assert on.sql(q).collect().equals(expect)


def test_limit_over_sort_topk(monkeypatch):
    j, on, off = _sessions()
    from nds_tpu_torch.engine import exec as TX

    taken = []
    orig = TX.Executor._take

    def take(self, table, idx, nrows):
        taken.append(int(idx.shape[0]))
        return orig(self, table, idx, nrows)
    monkeypatch.setattr(TX.Executor, "_take", take)
    for q in (
        "select k, v from t order by v desc, k limit 7",
        "select k, v from t where v > 0 order by k, v limit 1",
        # limit beyond the row count
        "select k, v from t where v > 78 order by v, k limit 500",
        "select cat, amt from t order by cat, amt limit 13",
    ):
        taken.clear()
        _check(j, on, off, q)
        # fused: one top-k gather of bucket_cap(k) rows; unfused: the
        # whole (packed) permutation
        assert len(taken) == 2 and taken[0] == 1024 <= taken[1], (q, taken)


def test_join_order_replay_memo():
    j, on, _ = _sessions()
    q = ("select t.k, sum(t.v) s from t, u where t.k = u.k and u.v > 0 "
         "group by t.k order by t.k")
    a = on.sql(q).collect()
    assert_same(j.sql(q).collect(), a, q, ordered=True)
    recorded = [v for v in on.join_order_cache.values() if "steps" in v]
    assert len(on.join_order_cache) >= 1 and recorded
    assert sorted(len(v["steps"]) for v in on.join_order_cache.values()) \
        == sorted(len(v["steps"]) for v in j.join_order_cache.values())
    on.conf["engine.plan_cache"] = "off"
    assert on.sql(q).collect().equals(a)  # replayed order, same result
    # a catalog change invalidates the memo
    on.register_arrow("w", _table(100))
    assert on.join_order_cache == {}


def test_input_signature_dictionary_identity():
    j, s, _ = _sessions()
    sig1 = TF.input_signature(s.catalog.load("t"))
    sig2 = TF.input_signature(s.catalog.load("t"))
    assert sig1 == sig2  # cached catalog columns: same dictionary objects
    jsig = JF.input_signature(j.catalog.load("t"))
    assert [e[:3] for e in sig1[1:]] == [e[:3] for e in jsig[1:]]
    assert sig1[0] == jsig[0]


def _words_table(words, n=400):
    return pa.table({
        "k": pa.array(np.arange(n) % 9, pa.int32()),
        "w": pa.array([words[i % len(words)] for i in range(n)]),
    })


def test_dropped_dictionary_never_aliases_a_new_one():
    """Drop a table and register one whose dictionary holds other words:
    once the old dictionary is collected, its address may be handed to
    the new one. The cache's key holds the dictionary it was built for,
    so a recycled address cannot reach an entry whose LIKE / IN tables
    belong to another dictionary. Each round's fused answer must equal
    the unfused one."""
    on = TorchSession(conf=dict(NO_AOT), device="cpu")
    off = TorchSession(conf={**NO_AOT, "engine.fuse": "off"}, device="cpu")
    q = ("select k, w from t where w like 'b%' or w in ('apple', 'kiwi') "
         "order by k, w")
    r = np.random.default_rng(7)
    pool = ["apple", "banana", "berry", "cherry", "kiwi", "bean", "date",
            "fig", "grape", "blue", "lime", "plum"]
    rounds = 12
    for _ in range(rounds):
        words = list(r.choice(pool, size=int(r.integers(3, 9)),
                              replace=False))
        for s in (on, off):
            s.drop("t")
            gc.collect()
            s.register_arrow("t", _words_table(words))
        assert on.sql(q).collect().equals(off.sql(q).collect()), words
    live = {id(e.obj) for key in on.exec_cache.map for part in key[1][1:]
            for e in part if isinstance(e, TF._Same)}
    assert len(live) == rounds  # each round's key holds its dictionary


# ---------------------------------------------------------------------------
# tests/test_fuse_agg.py
# ---------------------------------------------------------------------------

AGG_EQUALITY_QUERIES = [
    # grouped: int key with nulls, mixed aggregate set
    "select k, sum(v) sv, count(*) c, count(v) cv, min(v) mn, max(v) mx "
    "from t where v > -60 group by k order by k",
    # grouped: STRING key (dictionary + nulls) and string min/max
    "select cat, count(*) c, min(cat) mn, max(cat) mx from t "
    "where v > -70 group by cat order by cat",
    # multi-key (int x string), decimal sum/avg
    "select k, cat, sum(amt) sa, avg(amt) aa from t where v > -50 "
    "group by k, cat order by k, cat",
    # global aggregate (no keys; one output row)
    "select count(*) c, sum(v) sv, avg(v) av, min(v) mn from t "
    "where v between -40 and 40",
    # global over an EMPTY filter result (count 0, null sum)
    "select count(*) c, sum(v) sv from t where v > 1000",
    # grouped over an empty filter result (zero groups)
    "select k, sum(v) sv from t where v > 1000 group by k order by k",
    # projection-computed aggregate argument and key
    "select k + 1 k1, sum(v * 2) sv, avg(v) av from t where v > -60 "
    "group by k + 1 order by k1",
    # HAVING chain over the fused aggregate (plain Pipeline over agg tail)
    "select k, sum(v) sv from t group by k having sum(v) > 10 order by k",
]


@pytest.mark.parametrize("qi", range(len(AGG_EQUALITY_QUERIES)))
def test_fused_agg_path_equality(qi):
    j, on, off = _sessions()
    q = AGG_EQUALITY_QUERIES[qi]
    _check(j, on, off, q)
    assert _pipelines(on.sql(q).plan, agg=True)
    assert _pinned(on) == _pinned(j)


@pytest.mark.parametrize("n", [1023, 1024, 1025])
def test_fused_agg_bucket_boundaries(n):
    j, on, off = _sessions(n=n)
    _check(j, on, off, "select k, sum(v) sv, count(*) c from t where v > 0 "
           "group by k order by k")


def test_fused_agg_over_empty_table():
    j, on, off = _sessions()
    for s in (j, on, off):
        s.register_arrow("e", _table(0))
    for q in ("select k, sum(v) sv from e where v > 0 group by k order by k",
              "select count(*) c, sum(v) sv from e where v > 0"):
        _check(j, on, off, q)


def test_fused_agg_plan_shape_and_reuse():
    j, on, _ = _sessions()
    q = ("select k, sum(v) sv, avg(amt) aa from t where v > -60 "
         "group by k order by k")
    r = on.sql(q)
    pipes = _pipelines(r.plan, agg=True)
    assert len(pipes) == 1
    assert pipes[0].agg.child is None  # detached tail
    assert not _raw_aggregates(r.plan)  # the Aggregate was absorbed
    assert "Pipeline" in r.explain() and "+A" in r.explain()
    assert r.explain() == j.sql(q).explain()
    a = r.collect()
    # a rerun with the plan cache on answers from it: no call at all
    hits0 = on.exec_cache.hits
    assert on.sql(q).collect().equals(a)
    assert on.exec_cache.hits == hits0
    # a steady rerun rides the entry
    on.conf["engine.plan_cache"] = "off"
    assert on.sql(q).collect().equals(a)
    assert on.exec_cache.hits > hits0


def test_rollup_and_distinct_stay_eager_unmarked():
    j, on, off = _sessions()
    for q in (
        # ROLLUP: grouping sets never fuse
        "select k, sum(v) sv from t group by rollup(k) order by k",
        # DISTINCT aggregate: non-decomposable, never fuses
        "select k, count(distinct cat) dc from t group by k order by k",
        # stddev: non-decomposable
        "select k, stddev_samp(v) sd from t group by k order by k",
    ):
        assert not _pipelines(on.sql(q).plan, agg=True)
        _check(j, on, off, q)


def test_fuse_agg_conf_off_keeps_chain_fusion():
    j, on, off = _sessions(n=1000, conf={"engine.fuse_agg": "off"})
    q = "select k, sum(v) sv from t where v > 0 group by k order by k"
    r = on.sql(q)
    assert not _pipelines(r.plan, agg=True)
    assert _raw_aggregates(r.plan)  # the aggregate stayed raw
    assert r.explain() == j.sql(q).explain()
    _check(j, on, off, q)


def test_blocked_union_windows_ride_fused_wrappers():
    """The blocked union aggregation's per-window wrappers run through
    one entry: the first window builds it, the later ones hit it."""
    conf = {"engine.union_agg_window_rows": 512}
    tables = {"t": _table(3000), "u": _table(3000, seed=1)}
    j, on, off = _sessions(conf=conf, tables=tables)
    q = """
    select k, sum(v) sv, count(*) c, avg(v) av
    from (select k, v * 1 v from t where v > -70
          union all
          select k, v * 1 v from u) x
    where v < 70
    group by k order by k
    """
    ra = on.sql(q)
    a = ra.collect()
    assert a.equals(off.sql(q).collect())
    assert_same(j.sql(q).collect(), a, q, ordered=True)
    assert ra.executor.last_blocked_union["windows"] > 1
    assert on.exec_cache.hits > 0


def test_full_column_donation_join_fed_pipeline():
    """fuse_donate=on over a join-fed chain with its aggregate tail:
    identical results across reruns and after an OOM wipe."""
    j, on, off = _sessions(conf={"engine.fuse_donate": "on"})
    q = ("select x.k, sum(x.s) ss from (select t.k \"k\", t.v + u.v s "
         "from t, u where t.k = u.k and t.v > u.v) x where x.s > 10 "
         "group by x.k order by x.k")
    expect = _check(j, on, off, q)
    on.conf["engine.plan_cache"] = "off"
    assert on.sql(q).collect().equals(expect)
    assert on.sql(q).collect().equals(expect)
    on.recover_memory("test: simulated OOM wipe")
    assert on.sql(q).collect().equals(expect)


def test_multi_consumer_child_never_donates():
    """A CTE consumed twice: no pipeline over a shared child carries
    donate_ok, and execution under fuse_donate=on keeps the second
    consumer's input whole."""
    j, on, off = _sessions(conf={"engine.fuse_donate": "on"})
    q = """
    with base as (select k, v from t where v > -50)
    select a.k, a.v from base a, base b
    where a.k = b.k and a.v > b.v order by a.k, a.v
    """
    r = on.sql(q)
    refs = TF._count_refs(r.plan)
    for p in _pipelines(r.plan):
        if refs.get(id(p.child), 1) > 1:
            assert not p.donate_ok
    _check(j, on, off, q)


def test_donation_reuses_the_consumed_mask():
    """The port's donation (its counterpart of the reference's
    ownership flags): a donated call ANDs the first filter into the input
    mask's own storage; without donation the input mask is untouched."""
    from nds_tpu_torch.engine.columnar import Table, table_from_arrow

    base = table_from_arrow(_table(64), with_stats=True, device="cpu")
    stages = [P.Filter(predicate=TF.E.BinOp(">", TF.E.Col("v"),
                                            TF.E.Lit(0)), child=None)]
    live = torch.arange(base.cap) % 2 == 0
    t = Table(dict(base.columns), live.sum(dtype=torch.int32), live=live)
    entry = TF.FusedPipeline(stages, t)
    before = live.clone()
    out = entry.call(t, donate=False)
    assert torch.equal(live, before) and out.live is not live
    out = entry.call(t, donate=True)
    assert out.live is live  # the same storage, now the filtered mask
    assert int(out.nrows_lazy) == int((before & out.live).sum())


def test_pallas_auto_promotion_memo():
    """engine.pallas_agg=auto: the first float64 sum at a shape measures
    both routes and memoizes the verdict; on CPU tensors the kernel route
    is its plain version, and the memo is reused by a rerun."""
    t = pa.table({
        "k": pa.array([i % 5 for i in range(800)], pa.int32()),
        "f": pa.array([float(i) * 0.25 for i in range(800)], pa.float64()),
    })
    j, on, off = _sessions(conf={"engine.pallas_agg": "auto"},
                           tables={"tf": t})
    q = "select k, sum(f) sf from tf group by k order by k"
    _check(j, on, off, q)
    assert on.pallas_promotions, "auto mode recorded no A/B measurement"
    for rec in on.pallas_promotions.values():
        assert rec["plain_ms"] >= 0.0 and isinstance(rec["use"], bool)
    n_entries = len(on.pallas_promotions)
    on.conf["engine.plan_cache"] = "off"
    on.sql(q).collect()
    assert len(on.pallas_promotions) == n_entries


def test_cached_cte_survives_join_passthrough_donation():
    """A CTE aggregate consumed twice, once through a join feeding a
    donating chain: the join shares the CTE's mask and columns by
    reference, so the donation clearance must keep the cached result
    whole for the second consumer, across reruns."""
    j, on, off = _sessions(conf={"engine.fuse_donate": "on"})
    q = """
    with g as (select k, sum(v) sv from t where v > -60 group by k)
    select g.k, g.sv * 2 d, g.sv + u.v s from g, u
    where g.k = u.k and u.v > 0 and g.sv + u.v > -500
    union all
    select k, sv, sv from g
    order by 1, 2, 3
    """
    expect = _check(j, on, off, q)
    on.conf["engine.plan_cache"] = "off"
    assert on.sql(q).collect().equals(expect)
    assert on.sql(q).collect().equals(expect)


def test_node_boundary_passthrough_keeps_masks_apart():
    """The mechanism behind the CTE case, at the unit level: a masked or
    projected table shares the source's column objects, never a mask a
    fused call could AND into in place — a filter mints its own."""
    from nds_tpu_torch.engine.columnar import Table
    from nds_tpu_torch.engine.exec import Executor

    _, s, _ = _sessions()
    ex = Executor(s.catalog, "cpu")
    base = s.catalog.load("t")
    live = torch.arange(base.cap) < 100
    t = Table(dict(base.columns), 100, live=live)
    masked = ex._masked(t, ex._predicate_mask(t, TF.E.BinOp(
        ">", TF.E.Col("v"), TF.E.Lit(0))))
    assert masked.live is not live
    assert masked.columns["v"] is t.columns["v"]  # shared by reference
    proj = ex._project_table(t, [(TF.E.Col("v"), "w")])
    assert proj.columns["w"] is t.columns["v"]
    assert proj.live is live  # a projection passes the mask through...
    # ...and the rewrite never clears a Project-fed plan node's child for
    # donation unless the plan proves it single-consumer
    assert not TF._donate_ok_child(P.Scan("t", "t", ["v"]), {})


def test_pallas_mode_keeps_chain_fusion():
    """engine.pallas_agg != off keeps aggregates out of the fused tail at
    PLAN time (the segment kernels' route), while the feeding chain still
    fuses."""
    t = pa.table({
        "k": pa.array([i % 5 for i in range(800)], pa.int32()),
        "f": pa.array([float(i) * 0.25 for i in range(800)], pa.float64()),
    })
    j, on, off = _sessions(conf={"engine.pallas_agg": "auto"},
                           tables={"tf": t})
    q = ("select k, sum(f) sf from tf where f > 10 and k < 4 "
         "group by k order by k")
    r = on.sql(q)
    assert _raw_aggregates(r.plan), "aggregate missing from the plan"
    pipes = _pipelines(r.plan)
    assert pipes and all(p.agg is None for p in pipes)
    assert r.explain() == j.sql(q).explain()
    _check(j, on, off, q)


# ---------------------------------------------------------------------------
# the plan / result cache and catalog changes
# ---------------------------------------------------------------------------

def test_plan_cache_reuses_subtrees_across_statements():
    j, on, off = _sessions()
    q = ("select k, sum(v) sv from t where v > 0 group by k order by k")
    a = on.sql(q).collect()
    assert on.plan_cache.map  # the agg-tail Pipeline's result is cached
    calls0 = on.exec_cache.hits + on.exec_cache.misses
    assert on.sql(q).collect().equals(a)
    assert on.exec_cache.hits + on.exec_cache.misses == calls0
    # a scalar subquery's value rides the cache too
    q2 = "select k, v from t where v > (select avg(v) from u) order by k, v"
    _check(j, on, off, q2)
    assert on.plan_cache.scalars


@pytest.mark.parametrize("change", ["register", "drop", "invalidate"])
def test_catalog_change_clears_plan_and_join_order_caches(change):
    _, on, _ = _sessions()
    on.sql("select t.k, sum(t.v) s from t, u where t.k = u.k "
           "group by t.k").collect()
    assert on.plan_cache.map and on.join_order_cache
    entries = dict(on.exec_cache.map)
    if change == "register":
        on.register_arrow("w", _table(10))
    elif change == "drop":
        on.drop("u")
    else:
        on.catalog.invalidate("t")
    assert not on.plan_cache.map and not on.plan_cache.scalars
    assert on.join_order_cache == {}
    assert on.exec_cache.map == entries  # fused entries survive


def test_recover_memory_clears_all_three_caches():
    _, on, _ = _sessions()
    on.sql("select t.k, sum(t.v) s from t, u where t.k = u.k and t.v > 0 "
           "group by t.k").collect()
    assert on.plan_cache.map and on.join_order_cache and on.exec_cache.map
    on.recover_memory("test")
    assert not on.plan_cache.map and not on.join_order_cache
    assert not on.exec_cache.map
