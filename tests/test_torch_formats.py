"""The port's Load Test outputs other than parquet (csv, orc, json, avro and
the lakehouse, its --workers pool, --resume and remote output) and its
csv / orc catalog entries, against the JAX package's.

The port's generator writes SF0.01 data (two chunk files a table) into a
temporary directory of this module; both packages transcode the same .dat
files into every format under `tmp_path`.

Tolerance: exact. Read back (tests/torch_format_cases.read_back), every
format gives the same rows in both packages; avro files decode the same
through either package's reader; the catalog's csv and orc loads equal
the JAX package's, column by column.
"""

import os
import sys
import uuid

import pyarrow as pa
import pytest

from nds_tpu import transcode as JT
from nds_tpu.engine.columnar import table_to_arrow as jax_to_arrow
from nds_tpu.engine.session import Session as JaxSession
from nds_tpu.io import avro as JAVRO
from nds_tpu.lakehouse.table import LakehouseTable as JaxTable
from nds_tpu.schema import get_schemas as jax_schemas
from nds_tpu_torch import transcode as TT
from nds_tpu_torch.cli import gen_data as TG
from nds_tpu_torch.engine.columnar import table_to_arrow as torch_to_arrow
from nds_tpu_torch.engine.session import Session as TorchSession
from nds_tpu_torch.io import avro as TAVRO
from nds_tpu_torch.lakehouse.table import LakehouseTable as TorchTable
from nds_tpu_torch.schema import get_schemas as torch_schemas

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_format_cases import OTHER_FORMATS, read_back  # noqa: E402
from torch_join_cases import strict_budget  # noqa: E402,F401

#: facts (hive-partitioned in csv), dimensions with dates, decimals,
#: strings and nulls
TABLES = ("store_sales", "store_returns", "item", "date_dim", "store",
          "customer_address", "web_site")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw")
    TG.main(["local", "--scale", "0.01", "--parallel", "2", "--data_dir",
             str(d)])
    return d


def _arrow_schema(table, use_decimal=True):
    return pa.schema([(f.name, f.dtype.to_arrow(use_decimal))
                      for f in torch_schemas(use_decimal)[table]])


@pytest.fixture(scope="module")
def outputs(raw, tmp_path_factory):
    """{format: (port dir, JAX dir, port rows, JAX rows)}: TABLES in each
    format by each package (the lakehouse: the port with two workers)."""
    out = {}
    for fmt in OTHER_FORMATS:
        d = tmp_path_factory.mktemp(f"out_{fmt}")
        rows = {}
        for tag, mod, schemas in (("port", TT, torch_schemas()),
                                  ("jax", JT, jax_schemas())):
            rows[tag] = {t: mod.transcode_table(
                str(raw), str(d / tag), t, schemas[t], output_format=fmt,
                workers=2 if tag == "port" else 1) for t in TABLES}
        out[fmt] = (d / "port", d / "jax", rows["port"], rows["jax"])
    return out


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("fmt", OTHER_FORMATS)
def test_output_reads_back_as_jax(outputs, fmt, table):
    port, ref, prow, jrow = outputs[fmt]
    assert prow[table] == jrow[table] > 0
    schema = _arrow_schema(table)
    a = read_back(fmt, port / table, schema)
    b = read_back(fmt, ref / table, schema)
    assert a == b if isinstance(a, list) else a.equals(b), (fmt, table)
    assert len(a) == prow[table]


@pytest.mark.parametrize("table", TABLES)
def test_avro_files_cross_decode(outputs, table):
    port, ref, _, _ = outputs["avro"]
    f = "part-0.avro"
    mine, theirs = str(port / table / f), str(ref / table / f)
    assert TAVRO.read_avro(theirs) == JAVRO.read_avro(theirs)
    assert JAVRO.read_avro(mine) == TAVRO.read_avro(mine)
    assert TAVRO.read_avro(mine) == TAVRO.read_avro(theirs)


@pytest.mark.parametrize("table", TABLES)
def test_lakehouse_output_cross_reads(outputs, table):
    """The port's two-worker ingest against the JAX package's one: the same
    rows, ledger and row count, read by either package."""
    port, ref, _, _ = outputs["lakehouse"]
    for path in (port / table, ref / table):
        j, t = JaxTable(str(path)), TorchTable(str(path))
        assert t.versions() == j.versions()
        assert t.snapshot().manifest == j.snapshot().manifest
    mine, theirs = TorchTable(str(port / table)), JaxTable(str(ref / table))
    assert mine.num_rows() == theirs.num_rows()
    assert (mine.snapshot().ingest_chunks()
            == theirs.snapshot().ingest_chunks())
    assert len(mine.snapshot().ingest_chunks()) == 2  # two chunk files


def test_resume_converts_nothing_and_workers_match(raw, outputs, tmp_path):
    port, _, prow, _ = outputs["lakehouse"]
    sch = torch_schemas()
    for t in TABLES:
        assert TT.transcode_table(str(raw), str(port), t, sch[t],
                                  output_format="lakehouse", workers=2,
                                  resume=True) == 0
    # a one-worker ingest commits the same rows
    for t in ("store_sales", "item"):
        n = TT.transcode_table(str(raw), str(tmp_path), t, sch[t],
                               output_format="lakehouse")
        assert n == prow[t]
        assert TorchTable(str(tmp_path / t)).num_rows() == n
    # resuming after a lost chunk replays only that chunk
    lt = TorchTable(str(tmp_path / "item"))
    v = lt.rollback_to_version(1)
    assert lt.snapshot(v).ingest_chunks() == set()
    assert TT.transcode_table(str(raw), str(tmp_path), "item", sch["item"],
                              output_format="lakehouse", resume=True) == (
        prow["item"])


def test_lakehouse_to_memory_url(raw):
    wh = f"memory://wh-{uuid.uuid4().hex}"
    sch = torch_schemas()
    n = TT.transcode_table(str(raw), wh, "store", sch["store"],
                           output_format="lakehouse")
    assert n > 0
    assert JaxTable(f"{wh}/store").num_rows() == n
    s = TorchSession(device="cpu")
    s.register_nds_tables(wh, "lakehouse")
    assert sorted(s.catalog.entries) == ["store"]
    assert s.sql("select count(*) c from store").to_pylist() == [{"c": n}]
    for mod, schemas in ((TT, sch), (JT, jax_schemas())):
        with pytest.raises(ValueError, match="lakehouse"):
            mod.transcode_table(str(raw), f"memory://x-{uuid.uuid4().hex}",
                                "item", schemas["item"],
                                output_format="parquet")


def test_unknown_output_format(raw, tmp_path):
    for mod, schemas in ((TT, torch_schemas()), (JT, jax_schemas())):
        with pytest.raises(ValueError, match="unsupported output format"):
            mod.transcode_table(str(raw), str(tmp_path / mod.__name__),
                                "store", schemas["store"],
                                output_format="xml")


LOAD_COLS = {
    "store_sales": ["ss_sold_date_sk", "ss_item_sk", "ss_quantity",
                    "ss_ext_sales_price", "ss_net_profit"],
    "item": ["i_item_sk", "i_item_id", "i_current_price", "i_category",
             "i_rec_start_date"],
    "date_dim": ["d_date_sk", "d_date", "d_year", "d_day_name"],
    "customer_address": ["ca_address_sk", "ca_state", "ca_gmt_offset"],
}


@pytest.mark.parametrize("table", sorted(LOAD_COLS))
@pytest.mark.parametrize("fmt", ["csv", "orc", "lakehouse"])
def test_catalog_load_matches_jax(outputs, fmt, table):
    port = outputs[fmt][0]
    j = JaxSession(conf={"engine.aot_cache_dir": ""})
    t = TorchSession(device="cpu")
    j.register_nds_tables(str(port), fmt)
    t.register_nds_tables(str(port), fmt)
    assert sorted(t.catalog.entries) == sorted(j.catalog.entries)
    cols = LOAD_COLS[table]
    a = jax_to_arrow(j.catalog.load(table, cols))
    b = torch_to_arrow(t.catalog.load(table, cols))
    assert a.num_rows > 0
    assert b.equals(a), (fmt, table)


@pytest.mark.parametrize("fmt", ["csv", "orc", "lakehouse"])
def test_sql_over_format_matches_parquet(outputs, raw, tmp_path, fmt):
    """One star query over each format equals the same query over a parquet
    warehouse of the same data."""
    TT.transcode_table(str(raw), str(tmp_path), "store_sales",
                       torch_schemas()["store_sales"])
    TT.transcode_table(str(raw), str(tmp_path), "item",
                       torch_schemas()["item"])
    sql = ("select i_category, count(*) c, sum(ss_ext_sales_price) s "
           "from store_sales, item where ss_item_sk = i_item_sk "
           "and ss_sold_date_sk between 2451000 and 2451500 "
           "group by i_category order by i_category")
    got = {}
    for tag, wh, f in (("fmt", outputs[fmt][0], fmt),
                       ("parquet", tmp_path, "parquet")):
        s = TorchSession(device="cpu")
        s.register_nds_tables(str(wh), f)
        got[tag] = s.sql(sql).to_pylist()
    assert got["fmt"] == got["parquet"] and got["fmt"]


def test_raw_dat_csv_input(raw):
    """`--input_format csv` over raw generator output reads the .dat files
    whole, as the JAX package does."""
    from nds_tpu import power as JP
    from nds_tpu_torch import power as TP

    j = JaxSession(conf={"engine.aot_cache_dir": ""})
    t = TorchSession(device="cpu")
    JP.setup_tables(j, str(raw), "csv", True, [], "app")
    TP.setup_tables(t, str(raw), "csv", True, [], "app")
    assert sorted(t.catalog.entries) == sorted(j.catalog.entries)
    for name in ("store", "date_dim"):
        assert t.catalog.entries[name].arrow.equals(
            j.catalog.entries[name].arrow)


@pytest.mark.parametrize("fmt", ["parquet", "csv"])
def test_result_write_formats_match_jax(outputs, tmp_path, fmt):
    port = outputs["orc"][0]
    j = JaxSession(conf={"engine.aot_cache_dir": ""})
    t = TorchSession(device="cpu")
    j.register_nds_tables(str(port), "orc")
    t.register_nds_tables(str(port), "orc")
    sql = ("select i_category, count(*) c, sum(i_current_price) p "
           "from item group by i_category order by i_category")
    j.sql(sql).write(str(tmp_path / "j"), fmt)
    t.sql(sql).write(str(tmp_path / "t"), fmt)
    a = (tmp_path / "j" / f"part-0.{fmt}").read_bytes()
    b = (tmp_path / "t" / f"part-0.{fmt}").read_bytes()
    if fmt == "csv":
        assert b == a
    else:
        import pyarrow.parquet as pq

        assert pq.read_table(tmp_path / "t" / "part-0.parquet").equals(
            pq.read_table(tmp_path / "j" / "part-0.parquet"))
    for s in (j, t):
        with pytest.raises(ValueError, match="unsupported output format"):
            s.sql(sql).write(str(tmp_path / "x"), "orc")


def _module_imports(path):
    """(module, enclosing function or None) of every import in a file."""
    import ast

    tree = ast.parse(open(path).read())
    out = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            inner = fn
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = child.name
            if isinstance(child, ast.Import):
                out.extend((a.name, fn) for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                mod = child.module or ""
                out.extend((f"{mod}.{a.name}" if mod == "pyarrow" else mod,
                            fn) for a in child.names)
            visit(child, inner)
    visit(tree, None)
    return out


def test_fsspec_and_orc_imported_only_where_needed():
    """fsspec is imported only where a scheme:// path is resolved
    (io/fs.get_fs), pyarrow.orc only inside the functions that write or
    read ORC, and the lakehouse and avro modules import pyarrow inside
    their functions."""
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "nds_tpu_torch")
    seen = {"fsspec": set(), "pyarrow.orc": set()}
    for d, _, names in os.walk(root):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(d, n)
            rel = os.path.relpath(path, root)
            for mod, fn in _module_imports(path):
                top = mod.split(".")[0]
                if mod in seen or top == "fsspec":
                    key = "fsspec" if top == "fsspec" else mod
                    assert fn is not None, (rel, mod)
                    seen[key].add((rel, fn))
                if (rel.startswith("lakehouse") or rel == "io/avro.py"
                        or rel == "io/fs.py") and top == "pyarrow":
                    assert fn is not None, (rel, mod)
    assert seen["fsspec"] == {("io/fs.py", "get_fs")}
    assert {rel for rel, _ in seen["pyarrow.orc"]} == {"transcode.py"}
