"""The port's cache CLI (python -m nds_tpu_torch.cli.cache) and the
launcher's `cache` verb, on the CPU: `warm` over a small star warehouse
(chip_smoke.make_star, written as parquet) builds and stores every fused
pipeline's products; a second process over the same statements loads them
all (builds 0); `stats` reports the entries and `vacuum --all` removes
them. Each case uses its own `tmp_path` cache directory.
"""

import json
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import CS, strict_budget  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER = os.path.join(REPO, "nds-tpu-torch-submit")

#: the chip script's q3 / grouped min-max / ORDER BY, and an ORDER BY ..
#: LIMIT (the top-k) over the same star
ENTRIES = [
    ("query3", [CS.QUERIES["q3"]]),
    ("minmax", [CS.QUERIES["minmax"]]),
    ("order", [CS.QUERIES["order"]]),
    ("topk", ["select ss_item_sk, ss_quantity from store_sales "
              "where ss_quantity > 50 order by ss_quantity desc, "
              "ss_item_sk limit 10"]),
]


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    root = tmp_path_factory.mktemp("cache_wh")
    wh = os.path.join(root, "wh")
    CS.write_warehouse(CS.make_star(0, 1e-3), wh, workers=1)
    stream = CS.stream_file(os.path.join(root, "query_0.sql"), ENTRIES)
    return wh, stream


def _cli(*args, launcher=False):
    cmd = (["bash", LAUNCHER, "cache"] if launcher
           else [sys.executable, "-m", "nds_tpu_torch.cli.cache"])
    return subprocess.run(cmd + list(args), cwd=REPO, capture_output=True,
                          text=True, timeout=600)


def _warm(wh, stream, d, launcher=False, *extra):
    r = _cli("warm", wh, stream, "--cache_dir", d, "--device", "cpu",
             "--json", *extra, launcher=launcher)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout)


def test_warm_then_a_fresh_process_loads_every_entry(warehouse, tmp_path):
    wh, stream = warehouse
    d = str(tmp_path / "aot")
    cold = _warm(wh, stream, d)
    assert cold["queries_warmed"] == len(ENTRIES) and not cold.get("failed")
    assert cold["exec_cache"]["builds"] > 0
    assert cold["exec_cache"]["loads"] == 0
    assert cold["aot"]["stores"] == (cold["exec_cache"]["builds"]
                                     + cold["exec_cache"]["pins"])
    assert cold["stats"]["entries"] == cold["aot"]["stores"]
    assert set(cold["query_ms"]) == {tag for tag, _ in ENTRIES}
    warm = _warm(wh, stream, d)
    assert warm["exec_cache"]["builds"] == 0
    assert warm["exec_cache"]["loads"] == cold["exec_cache"]["builds"]
    assert warm["aot"]["disk_hits"] > 0 and warm["aot"]["misses"] == 0
    assert warm["aot"]["stores"] == 0


def test_launcher_stats_warm_and_vacuum(warehouse, tmp_path):
    wh, stream = warehouse
    d = str(tmp_path / "aot")
    out = _warm(wh, stream, d, True, "--queries", "query3,minmax")
    assert out["queries_warmed"] == 2
    r = _cli("stats", "--cache_dir", d, "--json", launcher=True)
    assert r.returncode == 0, r.stderr
    st = json.loads(r.stdout)
    assert st["entries"] == out["stats"]["entries"] > 0
    assert st["quarantined"] == st["temps"] == 0
    r = _cli("stats", "--cache_dir", d, launcher=True)
    assert r.returncode == 0 and "entries" in r.stdout
    with open(os.path.join(d, "quarantine-aot-x.bin.1"), "wb") as f:
        f.write(b"junk")
    r = _cli("vacuum", "--cache_dir", d, "--json", launcher=True)
    assert json.loads(r.stdout)["removed"] == 1
    r = _cli("vacuum", "--cache_dir", d, "--all", "--json", launcher=True)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["stats"]["entries"] == 0


def test_warm_fails_when_nothing_warms(warehouse, tmp_path):
    wh, _ = warehouse
    bad = CS.stream_file(str(tmp_path / "bad.sql"),
                         [("broken", ["select nope from store_sales"])])
    r = _cli("warm", wh, bad, "--cache_dir", str(tmp_path / "aot"),
             "--device", "cpu")
    assert r.returncode == 1
    assert "still cold" in r.stderr
    r = _cli("warm", str(tmp_path / "empty"), bad, "--cache_dir",
             str(tmp_path / "aot"), "--device", "cpu")
    assert r.returncode == 2


def test_disabled_cache_needs_a_dir(monkeypatch):
    monkeypatch.setenv("NDS_AOT_CACHE_DIR", "0")
    r = _cli("stats")
    assert r.returncode == 2 and "disabled" in r.stderr
