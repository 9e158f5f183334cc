"""The whole NDS chain of the port against the JAX package's, at SF0.01:
gen_data -> transcode (the Load Test) -> gen_query_stream (seeded from the
Load Test's RNGSEED) -> the Power Run of stream 0, all 103 statements ->
validate.

Each package runs its own chain through its CLIs into temporary
directories of this module: the port's Power Run with --device cpu, the
JAX package's on the CPU with NDS_FLIGHT_RECORDER=off and no AOT cache.
The JAX stream is generated with the port's RNGSEED, so that both run the
same statements.

Tolerance: the two chains' .dat files, streams and query names are
identical; each package's validate (the reference's 1e-5 relative epsilon,
its q65 / q78 carve-outs) finds no unmatched query between the two output
folders; the statuses agree query by query.
"""

import csv
import json
import os
import re
import sys

import pytest

from nds_tpu import power as JP
from nds_tpu import validate as JV
from nds_tpu.cli import gen_data as JG
from nds_tpu.cli import gen_query_stream as JQ
from nds_tpu.cli import power as JCLI
from nds_tpu_torch import faults as TF
from nds_tpu_torch import power as TP
from nds_tpu_torch import validate as TV
from nds_tpu_torch.cli import gen_data as TG
from nds_tpu_torch.cli import gen_query_stream as TQ
from nds_tpu_torch.cli import power as TCLI
from nds_tpu_torch.cli import transcode as TT
from nds_tpu_torch.cli import validate as TVCLI

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401

SCALE = "0.01"
STATEMENTS = 103


def _rngseed(report):
    text = open(report).read()
    return re.search(r"^RNGSEED used: (\d{11})$", text, re.M).group(1)


def _summaries(folder):
    out = {}
    for f in os.listdir(folder):
        with open(os.path.join(folder, f)) as fh:
            s = json.load(fh)
        out[s["query"]] = s
    return out


def _log_rows(path):
    with open(path) as f:
        return [r[1] for r in list(csv.reader(f))[1:]]


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    env = {k: os.environ.get(k) for k in
           ("NDS_FLIGHT_RECORDER", "NDS_FAULT_SPEC", "NDS_QUERY_TIMEOUT")}
    os.environ["NDS_FLIGHT_RECORDER"] = "off"
    os.environ.pop("NDS_FAULT_SPEC", None)
    os.environ.pop("NDS_QUERY_TIMEOUT", None)
    TF.reset()
    root = tmp_path_factory.mktemp("chain")
    out = {}
    try:
        # the port's chain
        p = root / "port"
        TG.main(["--scale", SCALE, "--parallel", "2", "--data_dir",
                 str(p / "raw")])
        TT.main([str(p / "raw"), str(p / "wh"), str(p / "load.report")])
        seed = _rngseed(p / "load.report")
        TQ.main(["--scale", SCALE, "--streams", "1", "--rngseed", seed,
                 "--output_dir", str(p / "streams")])
        TCLI.main([str(p / "wh"), str(p / "streams" / "query_0.sql"),
                   str(p / "time.csv"), "--device", "cpu",
                   "--output_prefix", str(p / "out"),
                   "--json_summary_folder", str(p / "json")])
        out["port"] = p
        # the JAX package's chain, with the port's seed
        j = root / "jax"
        JG.main(["--scale", SCALE, "--parallel", "2", "--data_dir",
                 str(j / "raw")])
        from nds_tpu.cli import transcode as JTC

        JTC.main([str(j / "raw"), str(j / "wh"), str(j / "load.report")])
        JQ.main(["--scale", SCALE, "--streams", "1", "--rngseed", seed,
                 "--output_dir", str(j / "streams")])
        (j / "jax.properties").write_text("engine.aot_cache_dir=\n")
        JCLI.main([str(j / "wh"), str(j / "streams" / "query_0.sql"),
                   str(j / "time.csv"), "--property_file",
                   str(j / "jax.properties"), "--output_prefix",
                   str(j / "out"), "--json_summary_folder", str(j / "json")])
        out["jax"] = j
        out["seed"] = seed
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        TF.reset()
    return out


def test_chains_generate_the_same_data_and_stream(chains):
    p, j = chains["port"], chains["jax"]
    for table in os.listdir(p / "raw"):
        if table == "dbgen_version":
            continue
        for f in sorted(os.listdir(p / "raw" / table)):
            assert ((p / "raw" / table / f).read_bytes()
                    == (j / "raw" / table / f).read_bytes()), (table, f)
    assert re.fullmatch(r"\d{11}", _rngseed(j / "load.report"))
    assert ((p / "streams" / "query_0.sql").read_bytes()
            == (j / "streams" / "query_0.sql").read_bytes())
    names = TP.gen_sql_from_stream(str(p / "streams" / "query_0.sql"))
    assert len(names) == STATEMENTS
    assert list(names) == list(
        JP.gen_sql_from_stream(str(j / "streams" / "query_0.sql")))


def test_every_statement_completes_in_both(chains):
    port = _summaries(chains["port"] / "json")
    jax = _summaries(chains["jax"] / "json")
    assert len(port) == len(jax) == STATEMENTS
    assert {q: s["queryStatus"] for q, s in port.items()} == {
        q: s["queryStatus"] for q, s in jax.items()}
    failed = {q: (s["queryStatus"], s["exceptions"][:1])
              for q, s in port.items() if s["queryStatus"] != ["Completed"]}
    assert not failed
    for name in TP.gen_sql_from_stream(
            str(chains["port"] / "streams" / "query_0.sql")):
        # every part of a two-part template has its own output folder
        assert os.path.isfile(chains["port"] / "out" / name /
                              "part-0.parquet"), name


def test_time_logs_have_the_same_rows(chains):
    rows = _log_rows(chains["port"] / "time.csv")
    assert rows == _log_rows(chains["jax"] / "time.csv")
    names = list(TP.gen_sql_from_stream(
        str(chains["port"] / "streams" / "query_0.sql")))
    assert [r for r in rows if not r.startswith("CreateTempView")] == (
        names + ["Power Start Time", "Power End Time", "Power Test Time",
                 "Total Time"])


@pytest.mark.parametrize("who", ["port", "jax"])
def test_validate_finds_no_unmatched_query(chains, who):
    names = list(TP.gen_sql_from_stream(
        str(chains["port"] / "streams" / "query_0.sql")))
    mod = TV if who == "port" else JV
    unmatched = mod.iterate_queries(str(chains["port"] / "out"),
                                    str(chains["jax"] / "out"), names)
    assert unmatched == []


def test_validate_cli_updates_the_summaries(chains, tmp_path):
    import shutil

    jdir = tmp_path / "json"
    shutil.copytree(chains["port"] / "json", jdir)
    rc = TVCLI.main([str(chains["port"] / "out"), str(chains["jax"] / "out"),
                     str(chains["port"] / "streams" / "query_0.sql"),
                     "--json_summary_folder", str(jdir)])
    assert rc == 0
    got = _summaries(jdir)
    assert len(got) == STATEMENTS
    assert {s["queryValidationStatus"][0] for s in got.values()} == {"Pass"}
