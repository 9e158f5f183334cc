"""The port's data generation (nds_tpu_torch.cli.gen_data, datagen/build.py
and its own copies of the generator's C++ sources) against the JAX
package's.

Both packages generate SF0.01 data with --parallel 2 into temporary
directories of this module, the source tables and the refresh set of
--update 1. The port's generator is built from nds_tpu_torch/datagen/native/
into the git-ignored nds_tpu_torch/datagen/_build/; the reference's from
nds_tpu/datagen/native/.

Tolerance: exact. Every .dat file is byte-identical to the reference's,
apart from dbgen_version's generation date and time; the native sources are
byte-identical copies.
"""

import os
import re
import subprocess
import sys

import pytest

from nds_tpu.cli import gen_data as JG
from nds_tpu.datagen import build as JB
from nds_tpu_torch import check as TC
from nds_tpu_torch.cli import gen_data as TG
from nds_tpu_torch.datagen import build as TB

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = "0.01"
#: the smaller scale of the reference's own generator tests
SMALL = "0.002"
NATIVE = sorted(TB._SOURCES + TB._HEADERS)


def _generate(main, out, *extra):
    main(["local", "--scale", SCALE, "--parallel", "2", "--data_dir",
          str(out), *extra])
    return out


@pytest.fixture(scope="module")
def source_dirs(tmp_path_factory):
    return (_generate(TG.main, tmp_path_factory.mktemp("torch_raw")),
            _generate(JG.main, tmp_path_factory.mktemp("jax_raw")))


@pytest.fixture(scope="module")
def update_dirs(tmp_path_factory):
    return (_generate(TG.main, tmp_path_factory.mktemp("torch_upd"),
                      "--update", "1"),
            _generate(JG.main, tmp_path_factory.mktemp("jax_upd"),
                      "--update", "1"))


def _files(d, table):
    return sorted(os.listdir(os.path.join(d, table)))


def _same_table(port_dir, ref_dir, table):
    names = _files(port_dir, table)
    assert names == _files(ref_dir, table)
    assert names, table
    for f in names:
        a = open(os.path.join(port_dir, table, f), "rb").read()
        b = open(os.path.join(ref_dir, table, f), "rb").read()
        assert a == b, (table, f)


@pytest.mark.parametrize("table", [t for t in TG.SOURCE_TABLE_NAMES
                                   if t != "dbgen_version"])
def test_source_table_bytes_match_jax(source_dirs, table):
    _same_table(*source_dirs, table)


@pytest.mark.parametrize("table", TG.MAINTENANCE_TABLE_NAMES)
def test_refresh_table_bytes_match_jax(update_dirs, table):
    _same_table(*update_dirs, table)


def test_layout_and_table_lists_match_jax(source_dirs, update_dirs):
    assert TG.SOURCE_TABLE_NAMES == JG.SOURCE_TABLE_NAMES
    assert TG.MAINTENANCE_TABLE_NAMES == JG.MAINTENANCE_TABLE_NAMES
    for (port, ref), names in ((source_dirs, TG.SOURCE_TABLE_NAMES),
                               (update_dirs, TG.MAINTENANCE_TABLE_NAMES)):
        assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
        for t in names:
            if t == "dbgen_version":
                continue
            for f in _files(port, t):
                assert re.fullmatch(rf"{t}_[12]_2\.dat", f), (t, f)
    # no refresh set writes the audit table
    assert "dbgen_version" not in os.listdir(update_dirs[0])


def test_dbgen_version_row_matches_jax(source_dirs):
    rows = [open(os.path.join(d, "dbgen_version",
                              "dbgen_version_1_1.dat")).read()
            for d in source_dirs]
    pat = re.compile(r"1\.0\.0\|\d{4}-\d{2}-\d{2}\|\d{2}:\d{2}:\d{2}\|"
                     r"-scale 0\.01 -parallel 2\|\n")
    for r in rows:
        assert pat.fullmatch(r), r
    # the same row apart from the generation date and time
    assert [r.split("|")[3] for r in rows] == ["-scale 0.01 -parallel 2"] * 2


@pytest.mark.parametrize("name", NATIVE)
def test_native_copy_is_byte_identical(name):
    port = open(os.path.join(TB.NATIVE_DIR, name), "rb").read()
    ref = open(os.path.join(JB.NATIVE_DIR, name), "rb").read()
    assert port == ref, name


def test_native_sources_listed_are_all():
    assert sorted(os.listdir(TB.NATIVE_DIR)) == NATIVE
    assert TB._SOURCES == JB._SOURCES and TB._HEADERS == JB._HEADERS


def test_binary_builds_from_the_port_sources(tmp_path, monkeypatch):
    """ensure_built compiles the port's own sources into its build
    directory, rebuilds when a source is newer, and check_build returns
    the port's binary."""
    build = tmp_path / "_build"
    monkeypatch.setattr(TB, "BUILD_DIR", str(build))
    monkeypatch.setattr(TB, "BINARY", str(build / "ndsgen"))
    assert TB._stale()
    path = TB.ensure_built()
    assert path == str(build / "ndsgen") and os.access(path, os.X_OK)
    assert not TB._stale()
    assert sorted(os.listdir(build)) == ["ndsgen"]  # the temp name renamed
    os.utime(path, (1, 1))
    assert TB._stale()  # the sources are newer than the binary now
    assert TC.check_build() == path
    assert not TB._stale()


def test_default_binary_is_git_ignored():
    assert os.path.dirname(TB.BINARY) == TB.BUILD_DIR
    assert os.path.commonpath([TB.BINARY, ROOT + "/nds_tpu_torch"]) == (
        ROOT + "/nds_tpu_torch")
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", os.path.relpath(TB.BINARY, ROOT)],
        cwd=ROOT).returncode
    assert ignored == 0
    assert not os.path.commonpath([TB.BINARY, JB.NATIVE_DIR]) == JB.NATIVE_DIR


def test_range_generation(tmp_path):
    d1 = tmp_path / "full"
    TG.main(["local", "--scale", SMALL, "--parallel", "4", "--data_dir",
             str(d1)])
    d2 = tmp_path / "ranged"
    TG.main(["local", "--scale", SMALL, "--parallel", "4", "--range", "1,2",
             "--data_dir", str(d2)])
    TG.main(["local", "--scale", SMALL, "--parallel", "4", "--range", "3,4",
             "--data_dir", str(d2), "--overwrite_output"])
    a = _files(d1, "catalog_sales")
    assert a == _files(d2, "catalog_sales") and len(a) == 4
    for f in a:
        assert ((d1 / "catalog_sales" / f).read_bytes()
                == (d2 / "catalog_sales" / f).read_bytes())


def test_output_guard(tmp_path):
    d = tmp_path / "d"
    TG.main(["local", "--scale", SMALL, "--parallel", "2", "--data_dir",
             str(d), "--table", "item"])
    with pytest.raises(Exception, match="overwrite_output"):
        TG.main(["local", "--scale", SMALL, "--parallel", "2", "--data_dir",
                 str(d), "--table", "item"])
    (d / "stale.txt").write_text("x")
    TG.main(["local", "--scale", SMALL, "--parallel", "2", "--data_dir",
             str(d), "--table", "item", "--overwrite_output"])
    assert not (d / "stale.txt").exists()  # a full rerun wipes stale content
    with pytest.raises(Exception, match="unknown table"):
        TG.main(["local", "--scale", SMALL, "--parallel", "2", "--data_dir",
                 str(tmp_path / "e"), "--table", "nope"])


def test_cluster_localhost_matches_local(tmp_path):
    """Cluster fan-out over a localhost hosts file is byte-identical to
    local generation (the shared-filesystem contract)."""
    local = tmp_path / "local"
    TG.main(["local", "--scale", SMALL, "--parallel", "2", "--data_dir",
             str(local)])
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("# comment\nlocalhost\n127.0.0.1\n")
    clus = tmp_path / "cluster"
    TG.main(["cluster", "--scale", SMALL, "--parallel", "2", "--data_dir",
             str(clus), "--hosts", str(hosts)])
    for table in ("store_sales", "item", "date_dim"):
        a = _files(local, table)
        assert a == _files(clus, table)
        for f in a:
            assert ((local / table / f).read_bytes()
                    == (clus / table / f).read_bytes())


def test_cluster_retries_failed_chunk(tmp_path, monkeypatch):
    """A chunk whose process dies is re-launched on the next host and the
    run still completes; exhausting --retries raises."""
    real_spawn = TG._spawn_on_host
    first_attempt_failed = set()
    hosts_used = []

    def flaky(host, cmd):
        hosts_used.append(host)
        chunk = cmd[cmd.index("-child") + 1]
        if chunk not in first_attempt_failed:
            first_attempt_failed.add(chunk)
            return subprocess.Popen(["false"])
        return real_spawn("localhost", cmd)

    monkeypatch.setattr(TG, "_spawn_on_host", flaky)
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("hostA\nhostB\n")  # never ssh'd: spawn is patched
    out = tmp_path / "out"
    TG.main(["cluster", "--scale", SMALL, "--parallel", "2", "--data_dir",
             str(out), "--hosts", str(hosts), "--table", "item"])
    assert len(first_attempt_failed) == 2  # both chunks failed once
    # each retry rotates to the next host
    assert hosts_used == ["hostA", "hostB", "hostB", "hostA"]
    assert _files(out, "item") == ["item_1_2.dat", "item_2_2.dat"]

    monkeypatch.setattr(TG, "_spawn_on_host",
                        lambda host, cmd: subprocess.Popen(["false"]))
    with pytest.raises(Exception, match="after 1 retries"):
        TG.main(["cluster", "--scale", SMALL, "--parallel", "2",
                 "--data_dir", str(tmp_path / "dead"), "--hosts", str(hosts),
                 "--retries", "1", "--table", "item"])


def test_chunk_commands_match_jax(tmp_path):
    import argparse

    args = argparse.Namespace(scale=0.5, data_dir=str(tmp_path), parallel=4,
                              seed=7, update=2, table="s_purchase")
    assert (TG._chunk_cmds("BIN", args, range(1, 5))
            == JG._chunk_cmds("BIN", args, range(1, 5)))


@pytest.mark.parametrize("fn,arg,bad", [
    ("valid_range", ("2,3", 4), ("0,3", 4)),
    ("parallel_value_type", ("2",), ("1",)),
    ("scale_of", ("0.01",), ("0",)),
])
def test_argument_checks_match_jax(fn, arg, bad):
    from nds_tpu import check as JC

    assert getattr(TC, fn)(*arg) == getattr(JC, fn)(*arg)
    for mod in (TC, JC):
        with pytest.raises(Exception):
            getattr(mod, fn)(*bad)


def test_path_and_size_helpers_match_jax(source_dirs):
    from nds_tpu import check as JC

    port, ref = source_dirs
    assert TC.get_dir_size(str(port / "item")) == JC.get_dir_size(
        str(ref / "item")) > 0
    assert TC.get_abs_path("/x/y") == "/x/y"
    assert TC.get_abs_path("native") == os.path.join(
        ROOT, "nds_tpu_torch", "datagen", "native")


def test_cli_runs_as_a_module(tmp_path):
    subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.cli.gen_data", "--scale", SMALL,
         "--parallel", "2", "--data_dir", str(tmp_path / "m"), "--table",
         "ship_mode"],
        check=True, capture_output=True, cwd=ROOT)
    lines = sum(len(open(tmp_path / "m" / "ship_mode" / f).readlines())
                for f in _files(tmp_path / "m", "ship_mode"))
    assert lines == 20  # a fixed-size table
