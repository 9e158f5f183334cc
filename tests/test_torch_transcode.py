"""The port's Load Test (nds_tpu_torch.transcode, its CLI and io/csv.py)
against the JAX package's.

The port's generator writes SF0.01 data (and the refresh set of --update 1)
into temporary directories of this module. From the same .dat files, both
packages' transcode write parquet warehouses, with decimals and with
--floats, and two tables in each other format (csv, orc, json, avro, the
lakehouse with --workers, --resume and a memory:// output; the rest of
those formats is tests/test_torch_formats.py).

Tolerance: exact. Per table: the same partition directories, the same
Arrow schema in every file, the same rows as multisets; io/csv's readers
return equal Arrow tables; the load report has the reference's lines.
"""

import argparse
import os
import re
import sys

import pyarrow as pa
import pyarrow.dataset as pads
import pyarrow.parquet as pq
import pytest

from nds_tpu import transcode as JT
from nds_tpu.io import csv as JCSV
from nds_tpu.schema import get_maintenance_schemas as jax_maint
from nds_tpu.schema import get_schemas as jax_schemas
from nds_tpu_torch import transcode as TT
from nds_tpu_torch.cli import gen_data as TG
from nds_tpu_torch.cli import transcode as TCLI
from nds_tpu_torch.io import csv as TCSV
from nds_tpu_torch.lakehouse.table import LakehouseTable as TorchLakeTable
from nds_tpu_torch.schema import TABLE_PARTITIONING
from nds_tpu_torch.schema import get_maintenance_schemas as torch_maint
from nds_tpu_torch.schema import get_schemas as torch_schemas

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_format_cases import OTHER_FORMATS, read_back  # noqa: E402
from torch_join_cases import strict_budget  # noqa: E402,F401

SOURCE = sorted(torch_schemas())
MAINT = sorted(torch_maint())
MODES = ("decimal", "floats")


def _args(raw, out, report, **kw):
    base = dict(input_prefix=str(raw), output_prefix=str(out),
                report_file=str(report), output_format="parquet",
                output_mode="errorifexists", tables=None, floats=False,
                update=False, compression=None, workers=1, resume=False)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw")
    TG.main(["local", "--scale", "0.01", "--parallel", "2", "--data_dir",
             str(d)])
    return d


@pytest.fixture(scope="module")
def raw_update(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw_update")
    TG.main(["local", "--scale", "0.01", "--parallel", "2", "--data_dir",
             str(d), "--update", "1"])
    return d


@pytest.fixture(scope="module")
def warehouses(raw, tmp_path_factory):
    """mode -> (port warehouse, JAX warehouse, port report, JAX report)."""
    out = {}
    for mode in MODES:
        floats = mode == "floats"
        d = tmp_path_factory.mktemp(f"wh_{mode}")
        tr = TT.transcode(_args(raw, d / "port", d / "port.report",
                                floats=floats))
        jr = JT.transcode(_args(raw, d / "jax", d / "jax.report",
                                floats=floats))
        out[mode] = (d / "port", d / "jax", tr, jr, d)
    return out


@pytest.fixture(scope="module")
def update_warehouses(raw_update, tmp_path_factory):
    d = tmp_path_factory.mktemp("wh_update")
    TT.transcode(_args(raw_update, d / "port", d / "port.report",
                       update=True))
    JT.transcode(_args(raw_update, d / "jax", d / "jax.report", update=True))
    return d / "port", d / "jax"


def _listing(root):
    """Every file under `root`, relative, with its parquet schema."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = pq.read_schema(p)
    return out


def _rows(path):
    t = pads.dataset(str(path), format="parquet",
                     partitioning="hive").to_table()
    return t.sort_by([(c, "ascending") for c in t.column_names])


def _same_table(port, ref, table):
    a, b = _listing(port / table), _listing(ref / table)
    assert sorted(a) == sorted(b), table
    for f in a:
        assert a[f].equals(b[f], check_metadata=False), (table, f)
    ta, tb = _rows(port / table), _rows(ref / table)
    assert ta.schema.equals(tb.schema)
    assert ta.num_rows == tb.num_rows
    assert ta.equals(tb), table
    return ta


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("table", SOURCE)
def test_table_matches_jax(warehouses, table, mode):
    port, ref, tr, jr, _ = warehouses[mode]
    t = _same_table(port, ref, table)
    assert tr["rows"][table] == jr["rows"][table]
    if table == "dbgen_version":
        return
    assert tr["rows"][table] == t.num_rows > 0
    part = TABLE_PARTITIONING.get(table)
    names = os.listdir(port / table)
    if part is None:
        assert names == ["part-0.parquet"]
    else:
        assert all(n.startswith(f"{part}=") for n in names), names
        # the partition column lives in the directory names only
        f = next(iter(_listing(port / table).values()))
        assert part not in f.names
    schema = torch_schemas(mode == "decimal")[table]
    for fld in schema:
        if fld.name != part:
            assert t.schema.field(fld.name).type == fld.dtype.to_arrow(
                mode == "decimal"), fld.name


@pytest.mark.parametrize("table", MAINT)
def test_update_table_matches_jax(update_warehouses, table):
    _same_table(*update_warehouses, table)


def test_null_partition_reads_back_as_nulls(raw, warehouses):
    """A fact row with a null date key lands in __HIVE_DEFAULT_PARTITION__
    and comes back from the port's catalog as a null key."""
    from nds_tpu_torch.engine.session import Session

    port = warehouses["decimal"][0]
    src = TCSV.read_dat_dir(str(raw / "store_sales"),
                            torch_schemas()["store_sales"])
    nulls = src.column("ss_sold_date_sk").null_count
    assert nulls > 0
    assert "ss_sold_date_sk=__HIVE_DEFAULT_PARTITION__" in os.listdir(
        port / "store_sales")
    s = Session(device="cpu")
    s.register_parquet("store_sales", str(port / "store_sales"),
                       torch_schemas()["store_sales"])
    got = s.sql("select count(*) c, count(ss_sold_date_sk) k, "
                "sum(ss_quantity) q from store_sales").to_pylist()
    assert got == [{"c": src.num_rows, "k": src.num_rows - nulls,
                    "q": pa.compute.sum(src.column("ss_quantity")).as_py()}]


REPORT_LINES = [
    r"Load Test Time: \d+\.\d+ seconds",
    r"Load Test Finished at: \d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d{6}",
    r"RNGSEED used: \d{11}",
]


@pytest.mark.parametrize("mode", MODES)
def test_report_format_matches_jax(warehouses, mode):
    _, _, tr, jr, d = warehouses[mode]
    texts = [(d / f"{who}.report").read_text() for who in ("port", "jax")]
    heads = []
    for text in texts:
        lines = text.split("\n")
        for pat, line in zip(REPORT_LINES, lines):
            assert re.fullmatch(pat, line), line
        conv = [ln for ln in lines if ln.startswith("Time to convert")]
        assert [re.fullmatch(r"Time to convert '(\w+)' was \d+\.\d{4}s",
                             ln).group(1) for ln in conv] == list(
            torch_schemas())
        total = int(re.search(r"Total rows converted: (\d+)", text).group(1))
        body, conf = text.split("\n\n\n\nSpark configuration follows:\n\n")
        assert body.split("\n")[-1].startswith("Total rows converted")
        items = dict(eval(ln) for ln in conf.strip().split("\n"))
        heads.append((total, {k: v for k, v in items.items()
                              if k.startswith(("transcode.", "engine."))}))
    assert heads[0][0] == heads[1][0] == sum(tr["rows"].values())
    port_conf, jax_conf = heads[0][1], heads[1][1]
    port_conf.pop("engine.version"), jax_conf.pop("engine.version")
    assert port_conf == jax_conf
    assert port_conf["engine.use_decimal"] == str(mode == "decimal")
    assert re.fullmatch(r"\d{11}", tr["rngseed"])
    assert f"RNGSEED used: {tr['rngseed']}" in texts[0]
    assert "torch.version" in texts[0] and "jax" not in texts[0]


def test_tables_subset_and_unknown(raw, tmp_path):
    rep = TT.transcode(_args(raw, tmp_path / "wh", tmp_path / "r",
                             tables=["item", "warehouse"]))
    assert sorted(os.listdir(tmp_path / "wh")) == ["item", "warehouse"]
    assert list(rep["rows"]) == ["item", "warehouse"]
    with pytest.raises(Exception, match="invalid table name"):
        TT.transcode(_args(raw, tmp_path / "wh2", tmp_path / "r2",
                           tables=["nope"]))


def test_output_modes(raw, tmp_path):
    sch = torch_schemas()["warehouse"]
    n = TT.transcode_table(str(raw), str(tmp_path), "warehouse", sch)
    with pytest.raises(FileExistsError):
        TT.transcode_table(str(raw), str(tmp_path), "warehouse", sch)
    with pytest.raises(FileExistsError):
        TT.transcode_table(str(raw), str(tmp_path), "warehouse", sch,
                           output_mode="error")
    assert TT.transcode_table(str(raw), str(tmp_path), "warehouse", sch,
                              output_mode="ignore") == 0
    assert TT.transcode_table(str(raw), str(tmp_path), "warehouse", sch,
                              output_mode="append") == n
    assert pads.dataset(str(tmp_path / "warehouse")).count_rows() == 2 * n
    assert len(os.listdir(tmp_path / "warehouse")) == 2
    assert TT.transcode_table(str(raw), str(tmp_path), "warehouse", sch,
                              output_mode="overwrite") == n
    assert os.listdir(tmp_path / "warehouse") == ["part-0.parquet"]


def test_compression_and_unpartitioned_fact(raw, tmp_path):
    sch = torch_schemas()["store_returns"]
    n = TT.transcode_table(str(raw), str(tmp_path / "a"), "store_returns",
                           sch, compression="zstd", partition=False)
    JT.transcode_table(str(raw), str(tmp_path / "b"), "store_returns",
                       jax_schemas()["store_returns"], compression="zstd",
                       partition=False)
    assert os.listdir(tmp_path / "a" / "store_returns") == ["part-0.parquet"]
    meta = pq.ParquetFile(tmp_path / "a" / "store_returns" /
                          "part-0.parquet").metadata
    assert meta.row_group(0).column(0).compression == "ZSTD"
    assert _same_table(tmp_path / "a", tmp_path / "b",
                       "store_returns").num_rows == n


def test_missing_dbgen_version_is_skipped(raw, tmp_path):
    assert TT.transcode_table(str(tmp_path / "none"), str(tmp_path / "o"),
                              "dbgen_version",
                              torch_schemas()["dbgen_version"]) == 0


@pytest.mark.parametrize("fmt", OTHER_FORMATS)
def test_unported_formats_raise(raw, tmp_path, fmt):
    """The formats this test once saw refused, now ported (the name is
    older): transcode_table and the CLI write what the JAX package's do,
    read back row for row."""
    from nds_tpu.cli import transcode as JCLI

    tables = ("warehouse", "store_returns")
    for t in tables:
        n = TT.transcode_table(str(raw), str(tmp_path / "p"), t,
                               torch_schemas()[t], output_format=fmt)
        assert n == JT.transcode_table(str(raw), str(tmp_path / "j"), t,
                                       jax_schemas()[t], output_format=fmt)
    argv = ["--output_format", fmt, "--tables", ",".join(tables)]
    TCLI.main([str(raw), str(tmp_path / "pc"), str(tmp_path / "pr")] + argv)
    JCLI.main([str(raw), str(tmp_path / "jc"), str(tmp_path / "jr")] + argv)
    for t in tables:
        schema = pa.schema([(f.name, f.dtype.to_arrow(True))
                            for f in torch_schemas()[t]])
        want = read_back(fmt, tmp_path / "j" / t, schema)
        assert len(want) > 0
        for d in ("p", "pc", "jc"):
            got = read_back(fmt, tmp_path / d / t, schema)
            assert got == want if isinstance(want, list) else (
                got.equals(want)), (fmt, t, d)
    assert "Total rows converted" in (tmp_path / "pr").read_text()


@pytest.mark.parametrize("kw", [{"workers": 2}, {"resume": True},
                                {"output_prefix": "memory://wh"}])
def test_lakehouse_options_and_remote_raise(raw, tmp_path, kw):
    """The lakehouse's options and remote output, once refused, now ported
    (the name is older): the Load Test converts what the JAX package's
    does, and a rerun with --resume converts nothing."""
    import uuid

    kw = dict(kw)
    if "output_prefix" in kw:
        kw["output_prefix"] += f"-{uuid.uuid4().hex}"
    tables = ["warehouse", "store_returns"]
    args = _args(raw, tmp_path / "wh", tmp_path / "r",
                 output_format="lakehouse", tables=tables, **kw)
    rep = TT.transcode(args)
    jrep = JT.transcode(_args(raw, tmp_path / "jwh", tmp_path / "jr",
                              output_format="lakehouse", tables=tables))
    assert rep["rows"] == jrep["rows"] and all(rep["rows"].values())
    assert os.path.exists(tmp_path / "r")
    wh = str(args.output_prefix)
    for t in tables:
        mine = TorchLakeTable(f"{wh}/{t}")
        theirs = TorchLakeTable(str(tmp_path / "jwh" / t))
        assert mine.num_rows() == theirs.num_rows() == rep["rows"][t]
        assert (mine.snapshot().ingest_chunks()
                == theirs.snapshot().ingest_chunks())
    again = TT.transcode(_args(raw, wh, tmp_path / "r2",
                               output_format="lakehouse", tables=tables,
                               resume=True))
    assert again["rows"] == {t: 0 for t in tables}
    if wh.startswith("memory://"):
        with pytest.raises(ValueError, match="lakehouse"):
            TT.transcode(_args(raw, wh + "-pq", tmp_path / "r3",
                               tables=tables))


def test_cli_matches_jax(raw, tmp_path):
    from nds_tpu.cli import transcode as JCLI

    argv = ["--tables", "store,store_returns", "--floats", "--output_mode",
            "overwrite"]
    TCLI.main([str(raw), str(tmp_path / "t"), str(tmp_path / "t.rep")] + argv)
    JCLI.main([str(raw), str(tmp_path / "j"), str(tmp_path / "j.rep")] + argv)
    for t in ("store", "store_returns"):
        _same_table(tmp_path / "t", tmp_path / "j", t)
    with pytest.raises(SystemExit):
        TCLI.main([str(raw), str(tmp_path / "x"), str(tmp_path / "x.rep"),
                   "--output_format", "xml"])


@pytest.mark.parametrize("use_decimal", [True, False])
@pytest.mark.parametrize("table", ["store_sales", "customer", "date_dim"])
def test_csv_readers_match_jax(raw, table, use_decimal):
    ts, js = torch_schemas()[table], jax_schemas()[table]
    path = str(raw / table)
    a = TCSV.read_dat_dir(path, ts, use_decimal)
    assert a.equals(JCSV.read_dat_dir(path, js, use_decimal))
    assert "_trailing" not in a.column_names
    chunks_t = list(TCSV.iter_dat_chunk_tables(path, ts, use_decimal))
    chunks_j = list(JCSV.iter_dat_chunk_tables(path, js, use_decimal))
    assert len(chunks_t) == len(chunks_j)
    assert all(x.equals(y) for x, y in zip(chunks_t, chunks_j))
    bt = list(TCSV.iter_dat_batches(path, ts, use_decimal, block_size=1 << 16))
    bj = list(JCSV.iter_dat_batches(path, js, use_decimal, block_size=1 << 16))
    assert len(bt) == len(bj) > 1 or table == "date_dim"
    assert pa.Table.from_batches(bt).equals(pa.Table.from_batches(bj))
    assert sum(b.num_rows for b in bt) == a.num_rows


def test_csv_empty_and_missing(tmp_path):
    sch = torch_maint()["delete"]
    empty = tmp_path / "t" / "delete_1_2.dat"
    empty.parent.mkdir()
    empty.write_text("")
    for use_decimal in (True, False):
        got = TCSV.read_dat_file(str(empty), sch, use_decimal)
        assert got.num_rows == 0
        assert got.equals(JCSV.read_dat_file(str(empty), jax_maint()["delete"],
                                             use_decimal))
    assert list(TCSV.iter_dat_batches(str(empty.parent), sch)) == []
    with pytest.raises(FileNotFoundError):
        TCSV.read_dat_dir(str(tmp_path / "none"), sch)
    # empty strings are nulls; the trailing '|' column is dropped
    f = tmp_path / "reason.dat"
    f.write_text("1|AAAAAAAABAAAAAAA||\n2||x|\n")
    got = TCSV.read_dat_file(str(f), torch_schemas()["reason"])
    assert got.to_pylist() == [
        {"r_reason_sk": 1, "r_reason_id": "AAAAAAAABAAAAAAA",
         "r_reason_desc": None},
        {"r_reason_sk": 2, "r_reason_id": None, "r_reason_desc": "x"}]
