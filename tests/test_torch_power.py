"""The port's Power Run (nds_tpu_torch.power, its CLI, the parquet catalog
entry and Result.write) against the JAX package's, over one parquet
warehouse.

The repo's generator (nds_tpu.cli.gen_data) writes SF0.01 data into a
temporary directory of this module, and nds_tpu.transcode writes it to
parquet there (fact tables hive-partitioned on their date keys), and to
csv, orc and the lakehouse for a short generated stream over each. Both
packages read that warehouse: JAX on the CPU with NDS_FLIGHT_RECORDER=off
and no AOT cache, the port with device="cpu".

Tolerance: integers, decimals, dates and strings EXACTLY; floats within
nds_tpu.validate.compare's 1e-5 relative epsilon (torch_join_cases.
assert_same). Stream summaries are equal apart from the environment and
the times; time logs have the same row names in the same order.
"""

import csv
import json
import os
import subprocess
import sys
import time

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from nds_tpu import faults as JF
from nds_tpu import power as JP
from nds_tpu.analysis.budget import CatalogStats as JaxStats
from nds_tpu.cli import power as JCLI
from nds_tpu.datagen import query_streams as QS
from nds_tpu.engine.columnar import table_to_arrow as jax_to_arrow
from nds_tpu.engine.session import Catalog as JaxCatalog
from nds_tpu.engine.session import Session as JaxSession
from nds_tpu.schema import get_schemas as jax_schemas
from nds_tpu.transcode import transcode_table
from nds_tpu_torch import faults as TF
from nds_tpu_torch import power as TP
from nds_tpu_torch.analysis.budget import CatalogStats as TorchStats
from nds_tpu_torch.cli import power as TCLI
from nds_tpu_torch.engine.columnar import table_from_arrow
from nds_tpu_torch.engine.columnar import table_to_arrow as torch_to_arrow
from nds_tpu_torch.engine.session import Session as TorchSession
from nds_tpu_torch.schema import get_schemas as torch_schemas

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import assert_same, strict_budget  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOLATILE = ("env", "startTime", "queryTimes", "filename")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("NDS_FAULT_SPEC", "NDS_QUERY_TIMEOUT", "NDS_IO_RETRIES",
                "NDS_IO_BACKOFF", "NDS_CATALOG_BUDGET_BYTES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NDS_FLIGHT_RECORDER", "off")
    JF.reset()
    TF.reset()
    yield
    JF.reset()
    TF.reset()


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    raw = tmp_path_factory.mktemp("nds_raw_sf001")
    subprocess.run(
        [sys.executable, "-m", "nds_tpu.cli.gen_data", "--scale", "0.01",
         "--parallel", "2", "--data_dir", str(raw), "--overwrite_output"],
        check=True, capture_output=True, cwd=ROOT,
    )
    return raw


@pytest.fixture(scope="module")
def warehouse(raw, tmp_path_factory):
    wh = tmp_path_factory.mktemp("nds_parquet_sf001")
    for name, schema in jax_schemas(True).items():
        transcode_table(str(raw), str(wh), name, schema)
    return str(wh)


@pytest.fixture(scope="module")
def format_warehouses(raw, tmp_path_factory):
    """{format: warehouse}: the JAX package's Load Test of the same data to
    csv, orc and the lakehouse (made on first use)."""
    made = {}

    def get(fmt):
        if fmt not in made:
            wh = tmp_path_factory.mktemp(f"nds_{fmt}_sf001")
            for name, schema in jax_schemas(True).items():
                transcode_table(str(raw), str(wh), name, schema,
                                output_format=fmt)
            made[fmt] = str(wh)
        return made[fmt]
    return get


# ---------------------------------------------------------------------------
# stream parsing and the small helpers
# ---------------------------------------------------------------------------

def _entry(n, template, *stmts):
    body = "".join(f"{s}\n;\n" for s in stmts)
    return (f"-- start query {n} in stream 0 using template {template}.tpl\n"
            f"{body}-- end query {n} in stream 0 using template "
            f"{template}.tpl\n")


STREAMS = {
    "one": _entry(1, "query96", "select count(*) cnt from store_sales"),
    "two": (_entry(1, "query96", "select count(*) cnt from store_sales")
            + "\n" + _entry(2, "query3", "select 1 as a")),
    "two_part": _entry(1, "query23", "select 1 as a", "select 2 as b"),
    "mixed": (_entry(1, "query14", "select 1 as a",
                     "select count(*) n from item")
              + _entry(2, "query7", "select 3 as c")
              + _entry(3, "query39", "select 4 as d", "select 5 as e")),
    "generated": "\n".join(
        _entry(i + 1, f"query{q}", QS.instantiate(
            q, np.random.default_rng(q), 0.01).strip().rstrip(";"))
        for i, q in enumerate((3, 42, 96))),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_gen_sql_from_stream_matches_jax(name, tmp_path):
    p = tmp_path / "query_0.sql"
    p.write_text(STREAMS[name])
    got = TP.gen_sql_from_stream(str(p))
    assert got == JP.gen_sql_from_stream(str(p))
    assert list(got)


def test_two_part_names():
    assert TP.split_special_query(STREAMS["two_part"][len("-- start"):]) == (
        QS.split_special_query(STREAMS["two_part"][len("-- start"):]))


def test_gen_sql_malformed_stream_entry(tmp_path):
    p = tmp_path / "query_0.sql"
    p.write_text("-- start query 1 in stream 0 using template query42.tpl\n"
                 "select 1 as a\n")
    for mod in (JP, TP):
        with pytest.raises(ValueError, match="malformed stream file.*query42"):
            mod.gen_sql_from_stream(str(p))


@pytest.mark.parametrize("subset", [["query3"], ["query3", "query96"],
                                    ["query999"]])
def test_get_query_subset(subset, tmp_path):
    p = tmp_path / "query_0.sql"
    p.write_text(STREAMS["two"])
    qd = TP.gen_sql_from_stream(str(p))
    if "query999" in subset:
        for mod in (JP, TP):
            with pytest.raises(Exception, match="not found"):
                mod.get_query_subset(qd, subset)
        return
    assert TP.get_query_subset(qd, subset) == JP.get_query_subset(qd, subset)


@pytest.mark.parametrize("text", [
    "a.b=1\n# comment\n\nc.d = hello \n",
    "engine.pallas_agg=on\nengine.pallas_join=on\nengine.pallas_sort=on\n",
    "x=a=b\n  # indented comment\ny=\n",
])
def test_load_properties_matches_jax(text, tmp_path):
    f = tmp_path / "x.properties"
    f.write_text(text)
    assert TP.load_properties(str(f)) == JP.load_properties(str(f))


@pytest.mark.parametrize("names", [
    ["a", "b"], ["sum(x)", "count(*)", "a b"], ["x", "x", "x"],
    ["c=d", "e;f", "g\th", "{i}"],
])
def test_ensure_valid_column_names_matches_jax(names):
    import pyarrow as pa

    t = pa.table({f"c{i}": [i] for i in range(len(names))}).rename_columns(
        names)
    assert (TP.ensure_valid_column_names(t).column_names
            == JP.ensure_valid_column_names(t).column_names)


# ---------------------------------------------------------------------------
# the parquet catalog entry
# ---------------------------------------------------------------------------

def _parquet_pair(wh, use_decimal=True, conf=None):
    conf = dict(conf or {})
    j = JaxSession(use_decimal=use_decimal,
                   conf={**conf, "engine.aot_cache_dir": ""})
    t = TorchSession(use_decimal=use_decimal, conf=conf, device="cpu")
    j.register_nds_tables(wh, "parquet")
    t.register_nds_tables(wh, "parquet")
    return j, t


LOAD_CASES = {
    "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_ticket_number",
                    "ss_quantity", "ss_ext_sales_price", "ss_net_profit"],
    "store_returns": ["sr_returned_date_sk", "sr_item_sk", "sr_return_amt"],
    "catalog_sales": ["cs_sold_date_sk", "cs_item_sk", "cs_sales_price"],
    "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk", "ws_net_paid"],
    "inventory": ["inv_date_sk", "inv_item_sk", "inv_quantity_on_hand"],
    "date_dim": ["d_date_sk", "d_date", "d_year", "d_day_name"],
    "item": ["i_item_sk", "i_item_id", "i_current_price", "i_category",
             "i_rec_start_date"],
    "customer": ["c_customer_sk", "c_first_name", "c_birth_year"],
    "customer_address": ["ca_address_sk", "ca_state", "ca_gmt_offset"],
    "store": ["s_store_sk", "s_store_id", "s_state", "s_tax_precentage"],
    "promotion": ["p_promo_sk", "p_channel_email", "p_cost"],
    "time_dim": ["t_time_sk", "t_hour", "t_am_pm"],
}


@pytest.mark.parametrize("table", sorted(LOAD_CASES))
@pytest.mark.parametrize("use_decimal", [True, False])
def test_parquet_load_matches_jax(warehouse, table, use_decimal):
    j, t = _parquet_pair(warehouse, use_decimal)
    cols = LOAD_CASES[table]
    a = jax_to_arrow(j.catalog.load(table, cols))
    b = torch_to_arrow(t.catalog.load(table, cols))
    assert a.num_rows > 0
    assert b.equals(a), table
    assert t.catalog.entries[table].nrows == j.catalog.entries[table].nrows


@pytest.mark.parametrize("table", ["store_sales", "item", "date_dim"])
def test_parquet_load_equals_the_in_memory_path(warehouse, table):
    """Dates, decimals and dictionary strings come back from parquet as
    table_from_arrow makes them from the same Arrow table."""
    t = TorchSession(device="cpu")
    t.register_nds_tables(warehouse, "parquet")
    cols = LOAD_CASES[table]
    got = t.catalog.load(table, cols)
    e = t.catalog.entries[table]
    arrow = t.catalog._dataset(e).to_table(columns=cols)
    want = table_from_arrow(arrow, e.schema, with_stats=True, device="cpu")
    assert got.nrows == want.nrows
    for c in cols:
        g, w = got.columns[c], want.columns[c]
        assert g.dtype == w.dtype, c
        assert torch.equal(g.data, w.data), c
        assert (g.valid is None) == (w.valid is None), c
        if g.valid is not None:
            assert torch.equal(g.valid, w.valid), c
        if g.dictionary is not None:
            assert g.dictionary.equals(w.dictionary), c
        assert g.stats == w.stats, c


def test_table_rows_from_parquet_metadata_match_jax(warehouse):
    j, t = _parquet_pair(warehouse)
    js, ts = JaxStats(j.catalog), TorchStats(t.catalog)
    names = sorted(t.catalog.entries)
    assert names == sorted(j.catalog.entries)
    for name in names:
        assert ts.table_rows(name) == js.table_rows(name), name
        assert t.catalog.entries[name].device_cols == {}  # nothing loaded


#: loads in order, against a residency budget that evicts
EVICT_LOADS = [("store_sales", ["ss_item_sk", "ss_quantity"]),
               ("item", ["i_item_sk", "i_brand_id"]),
               ("date_dim", ["d_date_sk", "d_year"]),
               ("catalog_sales", ["cs_item_sk", "cs_quantity"]),
               ("item", ["i_category"]),
               ("store_sales", ["ss_store_sk"])]


@pytest.mark.parametrize("budget", [1, 300_000, 1_000_000, 4_000_000,
                                    1 << 30])
def test_catalog_eviction_matches_jax(warehouse, budget, monkeypatch):
    monkeypatch.setattr(JaxCatalog, "DEVICE_BUDGET_BYTES", budget)
    monkeypatch.setenv("NDS_CATALOG_BUDGET_BYTES", str(budget))
    j, t = _parquet_pair(warehouse)
    assert t.catalog.DEVICE_BUDGET_BYTES == budget
    for name, cols in EVICT_LOADS:
        j.catalog.load(name, cols)
        t.catalog.load(name, cols)
        resident = {n: sorted(e.device_cols)
                    for n, e in t.catalog.entries.items() if e.device_cols}
        assert resident == {n: sorted(e.device_cols)
                            for n, e in j.catalog.entries.items()
                            if e.device_cols}
        assert t.catalog.resident_bytes() == sum(
            j.catalog._cached_bytes(e) for e in j.catalog.entries.values())
    if budget in (1, 1 << 30):
        assert (t.catalog.evictions > 0) == (budget == 1)


def test_register_nds_tables_matches_jax(warehouse):
    j, t = _parquet_pair(warehouse)
    assert sorted(t.catalog.entries) == sorted(j.catalog.entries)
    for name, e in t.catalog.entries.items():
        assert e.fmt == "parquet" and os.path.isdir(e.path)
        assert (t.catalog.schema(name).names
                == j.catalog.schema(name).names)


#: a short generated stream for the Power Run over each other format
FORMAT_STREAM_QUERIES = (3, 42, 96)
FORMAT_STREAM = "\n".join(
    _entry(i + 1, f"query{q}",
           QS.instantiate(q, np.random.default_rng(2000 + q), 0.01)
           .strip().rstrip(";"))
    for i, q in enumerate(FORMAT_STREAM_QUERIES))


@pytest.mark.parametrize("fmt", ["csv", "orc", "lakehouse"])
def test_other_formats_are_not_ported(format_warehouses, fmt, tmp_path,
                                      monkeypatch):
    """The input formats this test once saw refused, now ported (the name
    is older): registration, table setup and a Power Run over each equal
    the JAX package's, results, statuses and time-log rows."""
    wh = format_warehouses(fmt)
    j = JaxSession(conf={"engine.aot_cache_dir": ""})
    t = TorchSession(device="cpu")
    j.register_nds_tables(wh, fmt)
    t.register_nds_tables(wh, fmt)
    assert sorted(t.catalog.entries) == sorted(j.catalog.entries)
    assert {e.fmt for e in t.catalog.entries.values()} == {fmt}
    jl = JP.setup_tables(JaxSession(conf={"engine.aot_cache_dir": ""}), wh,
                         fmt, True, [], "app")
    tl = TP.setup_tables(TorchSession(device="cpu"), wh, fmt, True, [], "app")
    assert [r[1] for r in tl] == [r[1] for r in jl]
    monkeypatch.setenv("NDS_PLAN_BUDGET_STRICT", "1")
    runs = {}
    for tag, mod in (("jax", JP), ("torch", TP)):
        runs[tag] = _run_stream(mod, wh, tmp_path / tag, FORMAT_STREAM,
                                input_format=fmt)
    (js, jlog), (ts, tlog) = runs["jax"], runs["torch"]
    assert [r[1] for r in tlog] == [r[1] for r in jlog]
    for q in (f"query{n}" for n in FORMAT_STREAM_QUERIES):
        assert ts[q]["queryStatus"] == js[q]["queryStatus"] == ["Completed"]
        a = pq.read_table(tmp_path / "jax" / "results" / q / "part-0.parquet")
        b = pq.read_table(tmp_path / "torch" / "results" / q /
                          "part-0.parquet")
        assert_same(a, b, (fmt, q))


def test_unknown_format_and_remote_paths(warehouse):
    """An unknown format raises as in the JAX package; a remote warehouse
    URL resolves through fsspec (memory:// here) and registers what it
    holds, like the JAX package's."""
    import uuid

    t = TorchSession(device="cpu")
    j = JaxSession(conf={"engine.aot_cache_dir": ""})
    for mod, s in ((TP, t), (JP, j)):
        with pytest.raises(ValueError, match="unsupported input format"):
            mod.setup_tables(s, warehouse, "avro", True, [], "app")
    for s in (t, j):
        s.register_parquet("x", "s3://bucket/x")
        assert s.catalog.entries["x"].path == "s3://bucket/x"
    empty = f"memory://empty-{uuid.uuid4().hex}"
    t.register_nds_tables(empty)
    j.register_nds_tables(empty)
    assert sorted(t.catalog.entries) == sorted(j.catalog.entries) == ["x"]


def test_result_write_matches_jax(warehouse, tmp_path):
    j, t = _parquet_pair(warehouse)
    sql = ("select i_category, count(*) c, sum(i_current_price) p "
           "from item group by i_category order by i_category")
    j.sql(sql).write(str(tmp_path / "j"), "parquet",
                     transform=JP.ensure_valid_column_names)
    t.sql(sql).write(str(tmp_path / "t"), "parquet",
                     transform=TP.ensure_valid_column_names)
    a = pq.read_table(tmp_path / "j" / "part-0.parquet")
    b = pq.read_table(tmp_path / "t" / "part-0.parquet")
    assert b.equals(a)


# ---------------------------------------------------------------------------
# run_query_stream, both packages over the same warehouse
# ---------------------------------------------------------------------------

POWER_STREAM = (
    _entry(1, "query96",
           "select count(*) cnt from store_sales where ss_quantity > 0")
    + _entry(2, "query3",
             "select d_year, count(*) c from date_dim group by d_year "
             "order by d_year limit 5")
    + _entry(3, "query7",
             "select d_year, i_brand_id, sum(ss_ext_sales_price) s, "
             "count(*) n from date_dim, store_sales, item "
             "where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk "
             "and d_moy = 11 group by d_year, i_brand_id "
             "order by d_year, s desc, i_brand_id limit 20")
    + _entry(4, "query23", "select count(*) n from item",
             "select i_category, count(*) c from item group by i_category "
             "order by i_category")
    + _entry(5, "query1", "select nonexistent_col from store_sales")
    + _entry(6, "query52",
             "select d_moy, sum(ss_net_paid) p from store_sales, date_dim "
             "where ss_sold_date_sk = d_date_sk and d_year = 2000 "
             "group by d_moy order by d_moy")
)
GENERATED = (3, 42, 52, 55, 96)
GENERATED_STREAM = "\n".join(
    _entry(i + 1, f"query{q}",
           QS.instantiate(q, np.random.default_rng(1000 + q), 0.01)
           .strip().rstrip(";"))
    for i, q in enumerate(GENERATED))


def _summaries(folder):
    out = {}
    for f in os.listdir(folder):
        s = json.load(open(os.path.join(folder, f)))
        out[s["query"]] = s
    return out


def _time_log(path):
    rows = list(csv.reader(open(path)))
    assert rows[0] == ["application_id", "query", "time/milliseconds"]
    return rows[1:]


def _run_stream(mod, wh, out, stream, props=None, **kw):
    out.mkdir()
    (out / "query_0.sql").write_text(stream)
    props = dict(props or {})
    if mod is TP:
        kw["device"] = "cpu"
    else:
        props["engine.aot_cache_dir"] = ""
    prop = out / "power.properties"
    prop.write_text("".join(f"{k}={v}\n" for k, v in props.items()))
    mod.run_query_stream(
        input_prefix=wh, property_file=str(prop),
        query_dict=mod.gen_sql_from_stream(str(out / "query_0.sql")),
        time_log_output_path=str(out / "time.csv"),
        extra_time_log_output_path=str(out / "extra.csv"),
        json_summary_folder=str(out / "json"),
        output_path=str(out / "results"), **kw)
    return _summaries(out / "json"), _time_log(out / "time.csv")


def _stable(s):
    return {k: v for k, v in s.items() if k not in VOLATILE}


@pytest.fixture(scope="module")
def power_runs(warehouse, tmp_path_factory):
    """{stream: {package: (summaries, time log, output dir)}}"""
    runs = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("NDS_FLIGHT_RECORDER", "off")
    mp.setenv("NDS_PLAN_BUDGET_STRICT", "1")
    try:
        for name, stream in (("power", POWER_STREAM),
                             ("generated", GENERATED_STREAM)):
            runs[name] = {}
            for tag, mod in (("jax", JP), ("torch", TP)):
                out = tmp_path_factory.mktemp(f"{name}_{tag}")
                os.rmdir(out)
                s, log = _run_stream(mod, warehouse, out, stream)
                runs[name][tag] = (s, log, out)
    finally:
        mp.undo()
    return runs


POWER_QUERIES = ["query96", "query3", "query7", "query23_part1",
                 "query23_part2", "query1", "query52"]
GENERATED_QUERIES = [f"query{q}" for q in GENERATED]


@pytest.mark.parametrize("stream", ["power", "generated"])
def test_time_log_rows_match_jax(power_runs, stream):
    (_, jlog, jout), (_, tlog, tout) = (power_runs[stream]["jax"],
                                        power_runs[stream]["torch"])
    names = [r[1] for r in tlog]
    assert names == [r[1] for r in jlog]
    tables = [n for n in names if n.startswith("CreateTempView ")]
    assert len(tables) == len(torch_schemas(True))
    assert names[-4:] == ["Power Start Time", "Power End Time",
                          "Power Test Time", "Total Time"]
    assert all(int(r[2]) >= 0 for r in tlog)
    assert len({r[0] for r in tlog}) == 1  # one application id
    # the extra time log is a copy
    assert _time_log(tout / "extra.csv") == tlog


@pytest.mark.parametrize("query", POWER_QUERIES)
def test_power_stream_summaries_match_jax(power_runs, query):
    js, ts = (power_runs["power"]["jax"][0], power_runs["power"]["torch"][0])
    assert _stable(ts[query]) == _stable(js[query])
    want = "Failed" if query == "query1" else "Completed"
    assert ts[query]["queryStatus"] == [want]
    if query == "query1":
        assert ts[query]["failureKind"] == "planner"


@pytest.mark.parametrize("stream,query",
                         [("power", q) for q in POWER_QUERIES if q != "query1"]
                         + [("generated", q) for q in GENERATED_QUERIES])
def test_power_stream_results_match_jax(power_runs, stream, query):
    jout, tout = (power_runs[stream]["jax"][2], power_runs[stream]["torch"][2])
    a = pq.read_table(jout / "results" / query / "part-0.parquet")
    b = pq.read_table(tout / "results" / query / "part-0.parquet")
    assert_same(a, b, query)


@pytest.mark.parametrize("query", GENERATED_QUERIES)
def test_generated_templates_complete_in_both(power_runs, query):
    js, ts = (power_runs["generated"]["jax"][0],
              power_runs["generated"]["torch"][0])
    assert _stable(ts[query]) == _stable(js[query])
    assert ts[query]["queryStatus"] == ["Completed"]


def test_summary_files_follow_the_filename_contract(power_runs):
    _, _, out = power_runs["power"]["torch"]
    files = sorted(os.listdir(out / "json"))
    assert len(files) == len(POWER_QUERIES)
    for f in files:
        s = json.load(open(out / "json" / f))
        assert f == os.path.basename(s["filename"])
        assert s["filename"].endswith(f"-{s['query']}-{s['startTime']}.json")
        assert os.path.basename(f).startswith("power-")
        assert s["env"]["sparkConf"] == s["env"]["engineConf"]
        assert s["env"]["engineConf"]["torch.device"] == "cpu"


# ---------------------------------------------------------------------------
# injected drills in a stream (tests/test_faults.py:358-405 and the io and
# spill drills), both packages
# ---------------------------------------------------------------------------

DRILL_STREAM = (
    _entry(1, "query96",
           "select count(*) cnt from store_sales where ss_quantity > 0")
    + _entry(2, "query3",
             "select d_year, count(*) c from date_dim group by d_year "
             "order by d_year limit 5")
)

#: the spill drill's stream: its first query spills its DISTINCT and its
#: ORDER BY through the pool
SPILL_DRILL_STREAM = (
    _entry(1, "query96", "select distinct ss_quantity from store_sales "
           "order by ss_quantity")
    + _entry(2, "query3", "select count(*) c from date_dim"))

#: name -> (spec, property-file conf, run_query_stream kwargs, env); a case
#: id never holds a table's name, since a fault site matches paths by
#: substring and the summary files lie under the test's directory
DRILLS = {
    "oom_once": ("oom:query96:1", {}, {}, {}),
    "oom_persistent": ("oom:query96:99", {}, {}, {}),
    "hang": ("hang:query96:4", {}, {"query_timeout": 1.0}, {}),
    "exec_scoped": ("oom:exec:query3:1", {}, {}, {}),
    "io_fact_load": ("io:store_sales:1", {}, {},
                     {"NDS_IO_BACKOFF": "0"}),
    "io_load_site": ("io:load:date_dim:2", {}, {},
                     {"NDS_IO_BACKOFF": "0", "NDS_IO_RETRIES": "2"}),
    "spill_write": ("io:spill:write:1",
                    {"engine.spill": "force", "engine.spill_partitions": 4,
                     "engine.spill_pool_bytes": 1}, {},
                    {"NDS_IO_BACKOFF": "0"}),
}


@pytest.mark.parametrize("drill", sorted(DRILLS))
def test_injected_drill_matches_jax(warehouse, tmp_path, drill, monkeypatch):
    spec, conf, kw, env = DRILLS[drill]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("NDS_PLAN_BUDGET_STRICT", "1")
    stream = DRILL_STREAM
    if "engine.spill" in conf:
        conf = {**conf, "engine.spill_dir": str(tmp_path / "spill")}
        stream = SPILL_DRILL_STREAM
    out = {}
    for tag, mod, f in (("jax", JP, JF), ("torch", TP, TF)):
        f.reset()
        t0 = time.monotonic()
        s, log = _run_stream(mod, warehouse, tmp_path / tag, stream,
                             props={"engine.fault_spec": spec, **conf}, **kw)
        out[tag] = ({q: _stable(v) for q, v in s.items()},
                    [r[1] for r in log], time.monotonic() - t0)
    assert out["torch"][:2] == out["jax"][:2]
    st = out["torch"][0]
    first = st["query96"]
    assert st["query3"]["queryStatus"] in (["Completed"],
                                           ["CompletedWithTaskFailures"])
    if drill == "oom_once":
        assert first["queryStatus"] == ["CompletedWithTaskFailures"]
        assert [r["rung"] for r in first["ladder"]] == ["recover_retry"]
        assert st["query3"]["queryStatus"] == ["Completed"]
    elif drill == "oom_persistent":
        assert first["failureKind"] == "device_oom"
        assert [r["rung"] for r in first["ladder"]] == [
            "recover_retry", "shrink_union_window"]
    elif drill == "hang":
        assert first["failureKind"] == "timeout"
        assert out["torch"][2] < 4.0  # cut off at the budget, not the hang
        # the abandoned attempts wake and run their query on the old
        # sessions: wait for them, or they would fire the next test's rules
        import threading

        for t in threading.enumerate():
            if t.name == "nds-query-watchdog-worker":
                t.join(timeout=60)
                assert not t.is_alive()
    elif drill == "exec_scoped":
        assert first["queryStatus"] == ["Completed"]
        assert st["query3"]["retries"] == 1
    elif drill == "io_load_site":  # date_dim loads in the second query
        assert first["queryStatus"] == ["Completed"]
        assert [r["rung"] for r in st["query3"]["ladder"]] == [
            "io_backoff_retry"] * 2
    else:
        assert [r["rung"] for r in first["ladder"]] == ["io_backoff_retry"]


# ---------------------------------------------------------------------------
# the CLI and run_query_stream's edges
# ---------------------------------------------------------------------------

def test_cli_matches_jax(warehouse, tmp_path, monkeypatch):
    monkeypatch.setenv("NDS_PLAN_BUDGET_STRICT", "1")
    (tmp_path / "query_0.sql").write_text(POWER_STREAM)
    (tmp_path / "j.properties").write_text("engine.aot_cache_dir=\n")
    logs = {}
    for tag, cli, extra in (
            ("jax", JCLI, ["--property_file", str(tmp_path / "j.properties")]),
            ("torch", TCLI, ["--device", "cpu"])):
        cli.main([warehouse, str(tmp_path / "query_0.sql"),
                  str(tmp_path / f"{tag}.csv"),
                  "--sub_queries", "query3,query23_part2",
                  "--json_summary_folder", str(tmp_path / f"{tag}_json"),
                  "--output_prefix", str(tmp_path / f"{tag}_out"),
                  "--query_timeout", "60", *extra])
        logs[tag] = [r[1] for r in _time_log(tmp_path / f"{tag}.csv")]
    assert logs["torch"] == logs["jax"]
    assert "query3" in logs["torch"] and "query7" not in logs["torch"]
    s = _summaries(tmp_path / "torch_json")
    assert s["query3"]["env"]["engineConf"]["engine.query_timeout"] == "60.0"


def test_cli_input_formats():
    """The CLI takes the JAX CLI's input formats and refuses others."""
    with pytest.raises(SystemExit):
        TCLI.main(["wh", "s.sql", "t.csv", "--input_format", "avro"])
    import argparse

    seen = {}

    class Stop(Exception):
        pass

    def parse(self, argv=None, namespace=None):
        seen["choices"] = next(a.choices for a in self._actions
                               if a.dest == "input_format")
        raise Stop

    mp = pytest.MonkeyPatch()
    mp.setattr(argparse.ArgumentParser, "parse_args", parse)
    try:
        for cli in (TCLI, JCLI):
            with pytest.raises(Stop):
                cli.main(["wh", "s.sql", "t.csv"])
            assert seen.pop("choices") == ["parquet", "csv", "orc",
                                           "lakehouse"]
    finally:
        mp.undo()


def test_mesh_devices_not_ported(warehouse, tmp_path):
    with pytest.raises(NotImplementedError, match="item 13"):
        TP.run_query_stream(warehouse, None, {"q": "select 1"},
                            str(tmp_path / "t.csv"), mesh_devices=2,
                            device="cpu")


def test_stream_session_defaults_to_the_card(warehouse, tmp_path,
                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.run_query_stream(warehouse, None, {"q": "select 1"},
                            str(tmp_path / "t.csv"))


def test_keep_session_returns_the_session(warehouse, tmp_path):
    s = TP.run_query_stream(warehouse, None, {"query1": "select 1 as a"},
                            str(tmp_path / "t.csv"), keep_session=True,
                            device="cpu")
    assert isinstance(s, TorchSession)
    assert s.conf["app.name"] == "NDS - query1"
    assert TP.run_query_stream(warehouse, None, {"query1": "select 1 as a"},
                               str(tmp_path / "t2.csv"), device="cpu") is None


def test_json_summary_folder_must_be_empty(warehouse, tmp_path):
    (tmp_path / "json").mkdir()
    (tmp_path / "json" / "old.json").write_text("{}")
    import argparse

    with pytest.raises(argparse.ArgumentTypeError, match="not empty"):
        TP.run_query_stream(warehouse, None, {"q": "select 1"},
                            str(tmp_path / "t.csv"), device="cpu",
                            json_summary_folder=str(tmp_path / "json"))
