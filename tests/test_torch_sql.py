"""The slice as a whole: SQL through nds_tpu_torch's Session(device="cpu")
against the JAX package's Session on the same synthetic star tables.

Both engines run with engine.pallas_{agg,join,sort} `off` and `on`. In the
`on` case the JAX side runs its Pallas kernels in interpret mode (its
executor picks that by itself off-TPU) and the port's wrappers run their
plain versions (CPU tensors). Integers, dates and strings must match
EXACTLY; floats within nds_tpu.validate.compare's 1e-5 relative epsilon
(f32 kernel accumulation on both sides, in different orders).
Plus the port's guards: no jax / nds_tpu import anywhere in the port, no
silent CPU fallback, and NotImplementedError for every unported branch;
the statements other than SELECT that raised until ROADMAP.md item 9.6
run through both packages.
The joins and set operators have their own parity file,
tests/test_torch_joins.py.
"""

import ast
import json
import os
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

from nds_tpu.engine.session import Session as JaxSession
from nds_tpu_torch.engine import session as TS
from nds_tpu_torch.engine.session import Session as TorchSession

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 1e-5  # nds_tpu/validate.py compare's relative epsilon


# synthetic star tables: a copy of tests/test_dist_sql.py's _synth_tables
def _synth_tables(n_fact=4096, n_dates=256, n_items=128, n_stores=8, seed=0):
    rng = np.random.default_rng(seed)
    date_dim = pa.table(
        {
            "d_date_sk": np.arange(2450000, 2450000 + n_dates, dtype=np.int64),
            "d_year": (1998 + (np.arange(n_dates) // 100)).astype(np.int64),
            "d_moy": (np.arange(n_dates) % 12 + 1).astype(np.int64),
        }
    )
    item = pa.table(
        {
            "i_item_sk": np.arange(1, n_items + 1, dtype=np.int64),
            "i_brand_id": rng.integers(1, 12, n_items),
            "i_manager_id": rng.integers(1, 20, n_items),
            "i_category": pa.array(
                rng.choice(["Books", "Music", "Sports", None], n_items)
            ),
        }
    )
    store = pa.table(
        {
            "s_store_sk": np.arange(1, n_stores + 1, dtype=np.int64),
            "s_state": pa.array(rng.choice(["TN", "CA", "TX"], n_stores)),
        }
    )
    price = np.round(rng.random(n_fact) * 100, 2)
    price[rng.random(n_fact) < 0.05] = np.nan
    tickets = rng.integers(1, n_fact // 2, n_fact)
    store_sales = pa.table(
        {
            "ss_sold_date_sk": rng.integers(2450000, 2450000 + n_dates, n_fact),
            "ss_item_sk": rng.integers(1, n_items + 1, n_fact),
            "ss_ticket_number": tickets,
            "ss_store_sk": pa.array(
                np.where(
                    rng.random(n_fact) < 0.03,
                    None,
                    rng.integers(1, n_stores + 1, n_fact).astype(object),
                )
            ).cast(pa.int64()),
            "ss_quantity": rng.integers(1, 100, n_fact),
            "ss_ext_sales_price": pa.array(
                np.where(np.isnan(price), None, price.astype(object)),
                type=pa.float64(),
            ),
        }
    )
    # returns: half sampled from real sales (matching ticket+item), half junk
    n_ret = n_fact // 2
    pick = rng.integers(0, n_fact, n_ret // 2)
    ret_items = np.concatenate(
        [
            np.asarray(store_sales.column("ss_item_sk"))[pick],
            rng.integers(1, n_items + 1, n_ret - n_ret // 2),
        ]
    )
    ret_tickets = np.concatenate(
        [tickets[pick], rng.integers(n_fact, 2 * n_fact, n_ret - n_ret // 2)]
    )
    store_returns = pa.table(
        {
            "sr_item_sk": ret_items,
            "sr_ticket_number": ret_tickets,
            "sr_return_amt": np.round(rng.random(n_ret) * 50, 2),
        }
    )
    return {
        "date_dim": date_dim,
        "item": item,
        "store": store,
        "store_sales": store_sales,
        "store_returns": store_returns,
    }



QUERIES = {
    # tests/test_dist_sql.py QUERIES, verbatim
    "star_agg_q3": """
        select d.d_year, i.i_brand_id brand_id, sum(ss_ext_sales_price) s,
               count(*) cnt
        from date_dim d, store_sales, item i
        where d.d_date_sk = ss_sold_date_sk and ss_item_sk = i.i_item_sk
          and i.i_manager_id = 10 and d.d_moy = 11
        group by d.d_year, i.i_brand_id
        order by d.d_year, s desc, brand_id
    """,
    "filter_sort_limit": """
        select ss_item_sk, ss_quantity from store_sales
        where ss_quantity > 90 order by ss_quantity desc, ss_item_sk limit 20
    """,
    "global_agg": """
        select count(*) c, sum(ss_quantity) sq, min(ss_ext_sales_price) mn,
               max(ss_ext_sales_price) mx
        from store_sales
    """,
    "having_groups": """
        select ss_store_sk, count(*) c from store_sales
        group by ss_store_sk having count(*) > 10 order by ss_store_sk
    """,
    "left_join_nulls": """
        select s.s_state, count(*) c, avg(ss_quantity) aq
        from store_sales left join store s on ss_store_sk = s_store_sk
        group by s.s_state order by s.s_state
    """,
    "semi_anti": """
        select count(*) c from store_sales
        where ss_item_sk in (select i_item_sk from item where i_brand_id = 3)
          and ss_store_sk not in (select s_store_sk from store where s_state = 'TN')
    """,
    # chip_smoke.py's segment-extreme and counting-sort queries
    "minmax_by_store": """
        select ss_store_sk, min(ss_ext_sales_price) mn,
               max(ss_ext_sales_price) mx
        from store_sales group by ss_store_sk order by ss_store_sk
    """,
    "order_one_word": """
        select ss_quantity, ss_item_sk from store_sales
        where ss_quantity > 90 order by ss_quantity
    """,
    # the evaluator's arithmetic, casts, CASE, BETWEEN/IN and date parts
    "expr_mix": """
        select ss_item_sk, ss_quantity / 7 q7, ss_quantity * 1.5 q15,
               case when ss_quantity between 10 and 20 then 'mid'
                    when ss_quantity in (1, 2, 3) then 'low' else 'other' end b,
               coalesce(ss_store_sk, -1) st, cast(ss_quantity as double) qd,
               ss_ext_sales_price - ss_quantity dx, d.d_year - 1998 dy
        from store_sales, date_dim d
        where ss_sold_date_sk = d.d_date_sk and ss_item_sk < 20
        order by ss_item_sk, dx, q7
    """,
    # more of the evaluator and the operators: FROM-less select, scalar
    # and IN subqueries, CTEs, string dictionaries (group, order, LIKE,
    # substr/upper), stddev, avg over nulls, CASE keys
    "dual": "select 1 a, 2.5 b, 'x' c",
    "scalar_subquery": """
        select count(*) c from store_sales
        where ss_quantity > (select avg(ss_quantity) from store_sales)
    """,
    "string_groups": """
        select i_category, count(*) c, min(i_brand_id) mb from item
        group by i_category order by i_category
    """,
    "like_substr": """
        select substr(i_category, 1, 3) s3, upper(i_category) u, count(*) c
        from item where i_category like 'M%' or i_category is null
        group by substr(i_category, 1, 3), upper(i_category) order by s3
    """,
    "cte_topk": """
        with t as (select ss_store_sk k, sum(ss_quantity) q from store_sales
                   group by ss_store_sk)
        select k, q from t where q > 100 order by q desc limit 5
    """,
    "join_string_key_stddev": """
        select s.s_state, sum(ss_ext_sales_price) sp,
               stddev_samp(ss_quantity) sd
        from store_sales, store s where ss_store_sk = s.s_store_sk
        group by s.s_state order by s.s_state
    """,
    "order_string_desc": """
        select i_item_sk, i_category from item
        order by i_category desc nulls first, i_item_sk limit 15
    """,
    "avg_over_nulls": """
        select ss_store_sk, avg(ss_ext_sales_price) a,
               count(ss_ext_sales_price) n
        from store_sales group by ss_store_sk order by ss_store_sk
    """,
    "in_subquery": """
        select count(*) c from store_sales where ss_store_sk in
            (select s_store_sk from store where s_state in ('CA', 'TX'))
    """,
    "case_group_key": """
        select case when ss_quantity < 30 then 'lo'
                    when ss_quantity < 60 then 'mid' end b, count(*) c
        from store_sales
        group by case when ss_quantity < 30 then 'lo'
                      when ss_quantity < 60 then 'mid' end
        order by b
    """,
}

#: the operators queue 1 item 8 ported (windows, ROLLUP, grouping(),
#: blocked union aggregation): once NotImplementedError, now held against
#: the JAX engine
ITEM8_CASES = {
    "window": """
        select ss_store_sk, rank() over (partition by ss_store_sk
                                         order by ss_quantity) rk
        from store_sales
    """,
    "rollup": """
        select ss_store_sk, count(*) c from store_sales
        group by rollup(ss_store_sk)
    """,
    "grouping": """
        select ss_store_sk, grouping(ss_store_sk) g, count(*) c
        from store_sales group by ss_store_sk
    """,
    # an aggregate over a UNION ALL past one window: both engines
    # aggregate it window by window (blocked union aggregation)
    "blocked_union": """
        select k, sum(q) s from (
            select ss_store_sk k, ss_quantity q from store_sales
            union all
            select ss_store_sk k, ss_quantity q from store_sales) u
        group by k
    """,
}

#: session conf a case needs to reach its branch
ITEM8_CONF = {"blocked_union": {"engine.union_agg_window_rows": 1024}}

#: what the port raised NotImplementedError for, naming the ROADMAP.md item
#: that ports it: (SQL or None, session conf). A trace directory raised
#: until item 12a was ported and the tcp lakehouse catalog until item 12b
#: was (ONCE_UNPORTED_KNOBS)
UNPORTED = {
    "lake_catalog_http": (None, {"engine.lake_catalog":
                                 "http://127.0.0.1:1"}),
    "plan_feedback_on": (None, {"engine.plan_feedback": "on"}),
    "trace_dir": (None, {"engine.trace_dir": "traces"}),
}

#: the ROADMAP.md item each UNPORTED case names
UNPORTED_ITEMS = {"lake_catalog_http": "item 12b",
                  "plan_feedback_on": "item 14", "trace_dir": "item 12a"}

#: UNPORTED cases and layer knobs that item 12a (obs/), item 12b (the tcp
#: catalog), item 14 (cardinality feedback) and item 15 (lock debugging)
#: ported: their session now starts and turns the layer on
ONCE_UNPORTED_KNOBS = {"trace_dir", "engine.flight_recorder",
                       "engine.trace_kernels", "lake_catalog_http",
                       "plan_feedback_on", "engine.plan_feedback",
                       "engine.lock_debug"}

#: the statements other than SELECT that raised until item 9.6 was ported,
#: now run by both packages over the star's store_sales as a lakehouse
#: table: (script, the query that reads what it left)
ONCE_UNPORTED = {
    "create_view": ("create view v as select ss_store_sk from store_sales",
                    "select ss_store_sk, count(*) c from v "
                    "group by ss_store_sk"),
    "insert": ("insert into store_sales select * from store_sales",
               "select ss_store_sk, count(*) c, sum(ss_quantity) q "
               "from store_sales group by ss_store_sk"),
    "delete": ("delete from store_sales where ss_store_sk = 1",
               "select ss_store_sk, count(*) c, sum(ss_quantity) q "
               "from store_sales group by ss_store_sk"),
}


def _conf(mode):
    return {f"engine.pallas_{k}": mode for k in ("agg", "join", "sort")}


def _jax_session(mode):
    # no persistent AOT executable cache: the JAX package's own tests share
    # that directory across workers, and these parity tests need no disk
    return JaxSession(conf={**_conf(mode), "engine.aot_cache_dir": ""})


@pytest.fixture(scope="module")
def tables():
    return _synth_tables()


@pytest.fixture(scope="module")
def sessions(tables):
    out = {}
    for mode in ("off", "on"):
        j = _jax_session(mode)
        t = TorchSession(conf=_conf(mode), device="cpu")
        for name, at in tables.items():
            j.register_arrow(name, at)
            t.register_arrow(name, at)
        out[mode] = (j, t)
    return out


def assert_same(a, b, tag):
    assert a.schema.names == b.schema.names, tag
    assert a.num_rows == b.num_rows, tag
    for col in a.schema.names:
        for x, y in zip(a.column(col).to_pylist(), b.column(col).to_pylist()):
            if isinstance(x, float) and isinstance(y, float):
                if np.isnan(x) and np.isnan(y):
                    continue
                assert abs(x - y) <= EPS * max(abs(x), abs(y), 1.0), (
                    tag, col, x, y)
            else:
                assert x == y, (tag, col, x, y)


@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_port_matches_jax_session(sessions, qname, mode):
    j, t = sessions[mode]
    a = j.sql(QUERIES[qname]).collect()
    b = t.sql(QUERIES[qname]).collect()
    assert a.num_rows > 0, qname
    assert_same(a, b, (qname, mode))


def test_auto_mode_measures_and_matches(tables, sessions):
    t = TorchSession(conf=_conf("auto"), device="cpu")
    for name, at in tables.items():
        t.register_arrow(name, at)
    for q in ("star_agg_q3", "minmax_by_store", "order_one_word"):
        assert_same(sessions["off"][0].sql(QUERIES[q]).collect(),
                    t.sql(QUERIES[q]).collect(), q)
    kinds = {k[0] for k in t.pallas_promotions}
    assert {"sum", "min", "max", "dense_build", "sort_perm"} <= kinds


def test_q3_routes_through_every_kernel_wrapper(sessions, monkeypatch):
    """With the kernels on, the slice reaches each wrapper (here on CPU
    tensors, so their plain versions); with them off, none. The plan cache
    is off: an earlier test's run of the same statements would otherwise
    answer their aggregates."""
    from nds_tpu_torch.ops import gpu_kernels as GK

    calls = []
    for name in ("segment_sums", "segment_extreme", "dense_build",
                 "sort_perm"):
        fn = getattr(GK, name)
        monkeypatch.setattr(
            GK, name,
            lambda *a, _n=name, _f=fn: calls.append(_n) or _f(*a),
        )
    for mode, expect in (("off", set()), ("on", {
            "segment_sums", "segment_extreme", "dense_build", "sort_perm"})):
        calls.clear()
        t = sessions[mode][1]
        monkeypatch.setitem(t.conf, "engine.plan_cache", "off")
        for q in ("star_agg_q3", "minmax_by_store", "order_one_word"):
            t.sql(QUERIES[q]).collect()
        assert set(calls) == expect, mode


@pytest.mark.parametrize("qname", sorted(ITEM8_CASES))
def test_item8_branches_match_jax(tables, qname):
    conf = {**_conf("on"), **ITEM8_CONF.get(qname, {})}
    j = JaxSession(conf={**conf, "engine.aot_cache_dir": ""})
    t = TorchSession(conf=conf, device="cpu")
    for name, at in tables.items():
        j.register_arrow(name, at)
        t.register_arrow(name, at)
    a = j.sql(ITEM8_CASES[qname]).collect()
    b = t.sql(ITEM8_CASES[qname]).collect()
    assert b.num_rows > 0
    assert_same(a, b, qname)
    if qname == "blocked_union":
        assert t.last_blocked_union["windows"] > 1


@pytest.mark.parametrize("qname", sorted(UNPORTED))
def test_unported_branches_raise(tables, qname, tmp_path):
    sql, conf = UNPORTED[qname]
    if qname == "lake_catalog_http":
        # ported: a session over a coordinator commits through it
        _lake_catalog_session_commits(tables, tmp_path)
        return
    if qname == "plan_feedback_on":
        # ported: a recording pass, then a consuming one, over one store
        fb = {"engine.feedback_dir": str(tmp_path / "fb")}
        q = ("select ss_store_sk, count(*) c from store_sales "
             "where ss_quantity < 10 group by ss_store_sk")
        runs = []
        for mode in ("record", "on"):
            t = TorchSession(conf={**_conf("on"), **fb,
                                   "engine.plan_feedback": mode},
                             device="cpu")
            t.register_arrow("store_sales", tables["store_sales"])
            runs.append(t.sql(q).collect().to_pylist())
            pb = t.last_plan_budget
            assert pb["feedback_mode"] == mode
        assert runs[0] == runs[1]
        assert pb["feedback_hits"] > 0
        return
    if qname in ONCE_UNPORTED_KNOBS:
        # ported: the session writes its events under the trace directory
        d = str(tmp_path / conf["engine.trace_dir"])
        t = TorchSession(conf={**_conf("on"), "engine.trace_dir": d},
                         device="cpu")
        t.register_arrow("store_sales", tables["store_sales"])
        t.sql("select count(*) c from store_sales").collect()
        t.tracer.close()
        (name,) = os.listdir(d)
        kinds = [json.loads(x)["kind"] for x in open(os.path.join(d, name))]
        assert kinds[0] == "trace_meta" and "op_span" in kinds
        return
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md.*{UNPORTED_ITEMS[qname]}"):
        t = TorchSession(conf={**_conf("on"), **conf}, device="cpu")
        for name, at in tables.items():
            t.register_arrow(name, at)
        t.sql(sql).collect()


def _lake_catalog_session_commits(tables, tmp_path):
    """An INSERT of a session whose `engine.lake_catalog` names a
    coordinator (lakehouse/catalog.py CatalogCoordinator behind its own
    listener) publishes through it: the manifest carries the coordinator's
    txid, and the rows read back."""
    from nds_tpu_torch.lakehouse import catalog as TC
    from nds_tpu_torch.lakehouse.table import LakehouseTable
    from nds_tpu_torch.obs.httpserv import MetricsServer
    from nds_tpu_torch.obs.metrics import MetricsSink

    path = str(tmp_path / "store_sales")
    LakehouseTable.create(path, tables["store_sales"])
    server = MetricsServer(MetricsSink(), 0, host="127.0.0.1")
    server.attach_app(TC.CatalogCoordinator())
    server.start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        TC.reset_clients()
        t = TorchSession(conf={**_conf("on"), "engine.lake_catalog": url},
                         device="cpu")
        assert type(TC.resolve_catalog(t.conf)).__name__ == "HttpCatalog"
        t.register_lakehouse("store_sales", path)
        n = tables["store_sales"].num_rows
        t.run_script("insert into store_sales select * from store_sales")
        got = t.sql("select count(*) c from store_sales").collect()
        assert got.column("c").to_pylist() == [2 * n]
        with open(os.path.join(path, "_manifests", "v000002.json")) as fh:
            assert json.load(fh).get("txid")
    finally:
        server.stop()
        TC.reset_clients()


@pytest.mark.parametrize("qname", sorted(ONCE_UNPORTED))
def test_once_unported_statements_match_jax(tables, qname, tmp_path):
    """CREATE VIEW, INSERT and DELETE through both packages, with the
    kernels on, over store_sales as a lakehouse table: what each statement
    returns and what it leaves are the JAX package's."""
    from nds_tpu_torch.lakehouse.table import LakehouseTable

    script, check = ONCE_UNPORTED[qname]
    out = {}
    for name, make in (("jax", lambda: JaxSession(conf={
            **_conf("on"), "engine.aot_cache_dir": ""})),
            ("port", lambda: TorchSession(conf=_conf("on"), device="cpu"))):
        path = str(tmp_path / name / "store_sales")
        LakehouseTable.create(path, tables["store_sales"])
        s = make()
        for t, at in tables.items():
            if t != "store_sales":
                s.register_arrow(t, at)
        s.register_lakehouse("store_sales", path)
        res = s.run_script(script)
        out[name] = (getattr(res, "rows_affected", res),
                     s.sql(check).collect().sort_by("ss_store_sk"))
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1].num_rows > 0
    assert_same(out["jax"][1], out["port"][1], qname)


def test_table_from_numpy_tables_run_through_sql(tables, sessions):
    """The state hand-over: tables given as numpy run the same SQL."""
    from nds_tpu_torch.engine.columnar import table_from_numpy

    t = TorchSession(conf=_conf("on"), device="cpu")
    for name, at in tables.items():
        cols = {}
        for cname in at.column_names:
            col = at.column(cname).combine_chunks()
            if pa.types.is_string(col.type):
                enc = col.dictionary_encode()
                data = enc.indices.fill_null(0).to_numpy(zero_copy_only=False)
                cols[cname] = (data, col.is_valid().to_numpy(
                    zero_copy_only=False), "string", enc.dictionary)
                continue
            dtype = "float64" if pa.types.is_floating(col.type) else "int64"
            data = col.fill_null(0).to_numpy(zero_copy_only=False)
            valid = col.is_valid().to_numpy(zero_copy_only=False)
            cols[cname] = (data, valid, dtype, None)
        t.register_table(name, table_from_numpy(cols, at.num_rows,
                                                device="cpu"))
    for q in ("star_agg_q3", "having_groups", "minmax_by_store"):
        assert_same(sessions["off"][0].sql(QUERIES[q]).collect(),
                    t.sql(QUERIES[q]).collect(), q)


def test_session_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchSession()
    with pytest.raises(RuntimeError):
        TorchSession(device="cuda")
    assert TorchSession(device="cpu").device.type == "cpu"
    assert TS.resolve_device("cpu").type == "cpu"


#: knobs of layers the port has not ported: (conf key, environment knob or
#: None, values that turn the layer on, values that leave it off, the
#: ROADMAP.md item), each on and off by the reference's own resolver
UNPORTED_LAYER_KNOBS = [
    ("engine.plan_feedback", "NDS_PLAN_FEEDBACK", ("on",),
     ("off", "record"), "item 14"),
    ("engine.lock_debug", "NDS_LOCK_DEBUG", ("1", "true", "yes", "on", "ON"),
     ("0", "off", "no", "false", "2"), "item 15"),
    # ported by item 12a: the recorder is on unless off (ONCE_UNPORTED_KNOBS)
    ("engine.flight_recorder", "NDS_FLIGHT_RECORDER", ("on", "1", "true"),
     ("off", "0", "false", "no", "OFF"), "item 12a"),
    ("engine.trace_kernels", "NDS_TRACE_KERNELS", ("1", "on", "true"),
     ("0", "off", "yes"), "item 12a"),
    ("engine.mesh_devices", None, ("1", "2", 8), ("0", "", "x", None),
     "item 13"),
]


@pytest.mark.parametrize("key,env,on,off,item", UNPORTED_LAYER_KNOBS,
                         ids=[k[0] for k in UNPORTED_LAYER_KNOBS])
def test_unported_conf_knobs_raise(key, env, on, off, item, monkeypatch):
    for var in ("NDS_PLAN_FEEDBACK", "NDS_LOCK_DEBUG", "NDS_FLIGHT_RECORDER",
                "NDS_TRACE_KERNELS"):
        monkeypatch.delenv(var, raising=False)
    TorchSession(device="cpu")  # unset: every layer stays off
    if key in ONCE_UNPORTED_KNOBS:
        # ported: the knob turns its layer on by the reference's resolver
        # (the recorder's ring, the tracer's kernel spans, the budgeter's
        # consuming feedback mode, the order-asserting locks), conf over
        # env
        from nds_tpu_torch.analysis import feedback as TFB
        from nds_tpu_torch.engine import lockdebug as TLD

        layer = {
            "engine.flight_recorder":
                lambda s: bool(getattr(s.tracer, "ring", None)),
            "engine.trace_kernels":
                lambda s: bool(getattr(s.tracer, "kernel_spans", None)),
            "engine.plan_feedback":
                lambda s: TFB.resolve_feedback_mode(s.conf) == "on",
            "engine.lock_debug":
                lambda s: isinstance(s.cache_lock, TLD.DebugLock),
        }[key]
        default_on = key == "engine.flight_recorder"
        assert layer(TorchSession(device="cpu")) == default_on
        for v in on:
            assert layer(TorchSession(conf={key: v}, device="cpu"))
        for v in off:
            assert not layer(TorchSession(conf={key: v}, device="cpu"))
        for v in on:
            monkeypatch.setenv(env, str(v))
            assert layer(TorchSession(device="cpu"))
            assert not layer(TorchSession(conf={key: off[0]}, device="cpu"))
        for v in off:
            monkeypatch.setenv(env, str(v))
            assert not layer(TorchSession(device="cpu"))
        return
    for v in on:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1 "
                           f"{item}"):
            TorchSession(conf={key: v}, device="cpu")
    for v in off:
        TorchSession(conf={key: v}, device="cpu")
    if env is None:
        return
    for v in on:
        monkeypatch.setenv(env, str(v))
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1 "
                           f"{item}"):
            TorchSession(device="cpu")
        # the conf tier wins over the environment
        TorchSession(conf={key: off[0]}, device="cpu")
    for v in off:
        monkeypatch.setenv(env, str(v))
        TorchSession(device="cpu")


def test_ported_conf_knobs_are_accepted():
    """Forced spill, fault injection, plan verification and feedback's
    modes are accepted; the fusion, donation, plan cache, join-order
    cache and AOT cache keys are accepted and honoured (engine/fuse.py,
    engine/aotcache.py)."""
    from nds_tpu_torch import faults

    try:
        for conf in ({"engine.spill": "force"},
                     {"engine.plan_feedback": "record"},
                     {"engine.plan_feedback": "off"},
                     {"engine.plan_feedback": "on"},
                     {"engine.fault_spec": "io:nowhere:1"},
                     {"engine.verify_plans": "all"},
                     {"engine.fuse": "on"}, {"engine.plan_cache": "on"},
                     {"engine.fuse": "off"}, {"engine.fuse_agg": "off"},
                     {"engine.fuse_donate": "on"},
                     {"engine.join_order_cache": "off"},
                     {"engine.plan_cache_bytes": 1 << 20},
                     {"engine.aot_cache_dir": ""}):
            assert TorchSession(conf=conf, device="cpu").conf == conf
    finally:
        faults.reset()


def test_cuda_session_makes_expandable_segments_hold(monkeypatch):
    """A CUDA session sets PYTORCH_CUDA_ALLOC_CONF's expandable_segments
    before CUDA starts, keeps the other settings, and refuses to start
    when CUDA already runs without it or the variable asks against it."""
    var = "PYTORCH_CUDA_ALLOC_CONF"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.delenv(var, raising=False)
    assert TS.resolve_device(None).type == "cuda"
    assert os.environ[var] == "expandable_segments:True"
    monkeypatch.setenv(var, "max_split_size_mb:512")
    TS.resolve_device("cuda")
    assert os.environ[var] == (
        "max_split_size_mb:512,expandable_segments:True")
    TS.resolve_device("cuda")  # already holds: unchanged
    assert os.environ[var].count("expandable_segments") == 1
    monkeypatch.setenv(var, "expandable_segments:False")
    with pytest.raises(RuntimeError, match="expandable_segments"):
        TS.resolve_device("cuda")
    monkeypatch.delenv(var)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="CUDA is initialised"):
        TS.resolve_device("cuda")
    monkeypatch.setenv(var, "expandable_segments:True")
    assert TS.resolve_device("cuda").type == "cuda"
    assert TS.resolve_device("cpu").type == "cpu"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


def test_port_imports_neither_jax_nor_nds_tpu():
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(ROOT, "tools", n)
        for n in os.listdir(os.path.join(ROOT, "tools"))
        if n.startswith("torch_") and n.endswith(".py")]
    for d, _, names in os.walk(os.path.join(ROOT, "nds_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    rel = {os.path.relpath(f, ROOT) for f in files}
    assert {"nds_tpu_torch/analysis/budget.py",
            "nds_tpu_torch/analysis/verifier.py",
            "nds_tpu_torch/engine/spill.py",
            "nds_tpu_torch/faults.py",
            "nds_tpu_torch/report.py",
            "nds_tpu_torch/power.py",
            "nds_tpu_torch/check.py",
            "nds_tpu_torch/io/fs.py",
            "nds_tpu_torch/cli/power.py",
            "nds_tpu_torch/datagen/build.py",
            "nds_tpu_torch/datagen/query_streams.py",
            "nds_tpu_torch/datagen/substitutions.py",
            "nds_tpu_torch/cli/gen_data.py",
            "nds_tpu_torch/cli/gen_query_stream.py",
            "nds_tpu_torch/io/csv.py",
            "nds_tpu_torch/transcode.py",
            "nds_tpu_torch/cli/transcode.py",
            "nds_tpu_torch/validate.py",
            "nds_tpu_torch/cli/validate.py",
            "nds_tpu_torch/throughput.py",
            "nds_tpu_torch/cli/throughput.py",
            "nds_tpu_torch/cli/explain.py",
            "nds_tpu_torch/io/avro.py",
            "nds_tpu_torch/lakehouse/__init__.py",
            "nds_tpu_torch/lakehouse/catalog.py",
            "nds_tpu_torch/lakehouse/leases.py",
            "nds_tpu_torch/lakehouse/table.py",
            "nds_tpu_torch/lakehouse/zonemap.py",
            "tools/torch_throughput_phase.py",
            "tools/torch_lakehouse_phase.py",
            "nds_tpu_torch/maintenance.py",
            "nds_tpu_torch/lakehouse/dml.py",
            "nds_tpu_torch/cli/maintenance.py",
            "nds_tpu_torch/cli/rollback.py",
            "tools/torch_maintenance_phase.py",
            "nds_tpu_torch/full_bench.py",
            "nds_tpu_torch/cli/bench.py",
            "nds_tpu_torch/engine/fuse.py",
            "nds_tpu_torch/engine/aotcache.py",
            "nds_tpu_torch/cli/cache.py",
            "tools/torch_bench_phase.py",
            "nds_tpu_torch/obs/__init__.py",
            "nds_tpu_torch/obs/trace.py",
            "nds_tpu_torch/obs/metrics.py",
            "nds_tpu_torch/obs/memwatch.py",
            "nds_tpu_torch/obs/flight.py",
            "nds_tpu_torch/obs/reader.py",
            "nds_tpu_torch/obs/critpath.py",
            "nds_tpu_torch/obs/httpserv.py",
            "nds_tpu_torch/cli/profile.py",
            "nds_tpu_torch/serve/__init__.py",
            "nds_tpu_torch/serve/service.py",
            "nds_tpu_torch/serve/router.py",
            "nds_tpu_torch/serve/jobs.py",
            "nds_tpu_torch/cli/serve.py",
            "nds_tpu_torch/cli/route.py",
            "nds_tpu_torch/cli/catalog.py",
            "nds_tpu_torch/analysis/feedback.py",
            "nds_tpu_torch/analysis/lint.py",
            "nds_tpu_torch/analysis/concurrency.py",
            "nds_tpu_torch/engine/lockdebug.py",
            "nds_tpu_torch/engine/arrowlib.py",
            "nds_tpu_torch/cli/lint.py"} <= rel
    for path in files:
        for mod, level in _imports(path):
            if level:  # relative: stays inside nds_tpu_torch
                continue
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "nds_tpu"), (path, mod)
        # nor does any call name a path into the JAX package (its generator,
        # templates or sources)
        for arg in _call_strings(path):
            parts = arg.replace("\\", "/").split("/")
            assert "nds_tpu" not in parts, (path, arg)


def _call_strings(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for a in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    yield a.value


def test_pyarrow_is_imported_inside_functions_only():
    """The new host modules of the port import pyarrow only inside the
    functions that read or write Arrow, CSV and parquet."""
    for rel in ("io/csv.py", "transcode.py", "validate.py",
                "datagen/query_streams.py", "cli/transcode.py",
                "cli/validate.py", "cli/gen_data.py",
                "cli/gen_query_stream.py", "datagen/build.py",
                "serve/__init__.py", "serve/service.py", "serve/router.py",
                "serve/jobs.py", "cli/serve.py", "cli/route.py",
                "cli/catalog.py", "lakehouse/catalog.py"):
        tree = ast.parse(open(os.path.join(ROOT, "nds_tpu_torch", rel)).read())
        for node in tree.body:
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            assert not [n for n in names if n.split(".")[0] == "pyarrow"], (
                rel, names)
