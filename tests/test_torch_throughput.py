"""The port's Throughput Run (nds_tpu_torch.throughput and its CLI, the
start gate of power.run_query_stream) against the JAX package's.

One SF0.01 warehouse, made by the port's generator and Load Test into a
temporary directory of this module, and streams 1 and 2 generated from the
Load Test's RNGSEED, serve every test. Both packages run the two streams
in thread mode over SUB_QUERIES: JAX on the CPU with NDS_FLIGHT_RECORDER=off
and no AOT cache, the port with device="cpu". Process mode, the gate's
failure paths, the child budget and the CLI run the port alone, beside
the reference's own functions where those need no engine.

Tolerance: each stream's outputs match the JAX package's per query under
validate's rules (the reference's 1e-5 relative epsilon); time-log rows
are equal by name and order; Ttt follows _ttt_from_logs exactly.
"""

import csv
import json
import os
import sys
import threading
import time

import pytest
import torch

from nds_tpu import throughput as JT
from nds_tpu.cli import throughput as JTCLI
from nds_tpu_torch import faults as TF
from nds_tpu_torch import throughput as TT
from nds_tpu_torch import validate as TV
from nds_tpu_torch.cli import gen_data as TG
from nds_tpu_torch.cli import gen_query_stream as TQ
from nds_tpu_torch.cli import throughput as TTCLI
from nds_tpu_torch.cli import transcode as TTR
from nds_tpu_torch.ops import _build
from nds_tpu_torch.ops import gpu_kernels as GK

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401

STREAMS = (1, 2)
SUB_QUERIES = ["query3", "query7", "query19", "query42", "query52",
               "query55", "query96", "query98"]


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
def chain(tmp_path_factory):
    """The warehouse, the streams and the property file."""
    root = tmp_path_factory.mktemp("throughput")
    TG.main(["--scale", "0.01", "--parallel", "2", "--data_dir",
             str(root / "raw")])
    TTR.main([str(root / "raw"), str(root / "wh"), str(root / "load.report")])
    seed = next(line.split()[-1] for line in
                (root / "load.report").read_text().splitlines()
                if line.startswith("RNGSEED used: "))
    TQ.main(["--scale", "0.01", "--streams", "3", "--rngseed", seed,
             "--output_dir", str(root / "streams")])
    # the JAX session without an AOT cache (the port accepts the key)
    (root / "p.properties").write_text("engine.aot_cache_dir=\n")
    return root


@pytest.fixture(scope="module")
def runs(chain):
    """Both packages' thread-mode Throughput Run of streams 1 and 2."""
    env = {k: os.environ.get(k) for k in
           ("NDS_FLIGHT_RECORDER", "NDS_FAULT_SPEC", "NDS_QUERY_TIMEOUT",
            "NDS_CATALOG_BUDGET_BYTES")}
    os.environ["NDS_FLIGHT_RECORDER"] = "off"
    for k in ("NDS_FAULT_SPEC", "NDS_QUERY_TIMEOUT",
              "NDS_CATALOG_BUDGET_BYTES"):
        os.environ.pop(k, None)
    TF.reset()
    paths = {n: str(chain / "streams" / f"query_{n}.sql") for n in STREAMS}
    out = {}
    try:
        for tag, mod, extra in (("jax", JT, {}),
                                ("port", TT, {"device": "cpu"})):
            d = chain / tag
            d.mkdir()
            out[tag] = (d, mod.run_throughput(
                str(chain / "wh"), paths, str(d / "time"),
                property_file=str(chain / "p.properties"),
                json_summary_folder=str(d / "json"),
                output_path=str(d / "out"), sub_queries=SUB_QUERIES,
                **extra))
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        TF.reset()
    return out


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("query", SUB_QUERIES)
def test_stream_outputs_match_jax(runs, stream, query):
    (jd, _), (td, _) = runs["jax"], runs["port"]
    assert os.path.isdir(td / f"out_{stream}" / query)
    assert TV.iterate_queries(str(jd / f"out_{stream}"),
                              str(td / f"out_{stream}"), [query]) == []


@pytest.mark.parametrize("stream", STREAMS)
def test_time_logs_and_statuses_match_jax(runs, stream):
    (jd, _), (td, _) = runs["jax"], runs["port"]
    rows = _log_rows(td / f"time_{stream}.csv")
    assert rows == _log_rows(jd / f"time_{stream}.csv")
    assert rows[-4:] == ["Power Start Time", "Power End Time",
                         "Power Test Time", "Total Time"]
    assert [r for r in rows if not r.startswith("CreateTempView")][:-4] == (
        SUB_QUERIES)
    ts = _summaries(td / "json" / f"stream_{stream}")
    js = _summaries(jd / "json" / f"stream_{stream}")
    assert sorted(ts) == sorted(js) == sorted(SUB_QUERIES)
    for q in SUB_QUERIES:
        assert ts[q]["queryStatus"] == js[q]["queryStatus"] == ["Completed"]


def test_ttt_follows_the_logs(runs):
    for tag in ("jax", "port"):
        d, ttt = runs[tag]
        base = str(d / "time")
        assert ttt == TT._ttt_from_logs(STREAMS, base) == (
            JT._ttt_from_logs(STREAMS, base))
        windows = [TT._read_start_end(f"{base}_{n}.csv") for n in STREAMS]
        # the gate's one release time is every stream's start
        assert len({s for s, _ in windows}) == 1
        assert max(s for s, _ in windows) <= min(e for _, e in windows)
        assert ttt >= 0.1


@pytest.mark.parametrize("start,end,want", [
    (100, 100, 0.1), (100, 101, 1.0), (100.0, 103.04, 3.1),
    (5, 125, 120.0), (0, 0.01, 0.1),
])
def test_ttt_rounding_matches_jax(tmp_path, start, end, want):
    base = str(tmp_path / "t")
    for n, (s, e) in enumerate(((start, end), (start, start))):
        with open(f"{base}_{n}.csv", "w") as f:
            f.write("application_id,query,time/milliseconds\n"
                    f"a,Power Start Time,{s}\na,Power End Time,{e}\n")
    assert TT._ttt_from_logs((0, 1), base) == JT._ttt_from_logs(
        (0, 1), base) == want
    for x in (0.0, 0.01, 1.23, 9.99, 10.0):
        assert TT.round_up_to_nearest_10_percent(x) == (
            JT.round_up_to_nearest_10_percent(x))


def test_missing_start_rows_raise(tmp_path):
    p = tmp_path / "t_0.csv"
    p.write_text("application_id,query,time/milliseconds\na,q,1\n")
    for mod in (TT, JT):
        with pytest.raises(ValueError, match="missing Power Start/End"):
            mod._read_start_end(str(p))


# ---------------------------------------------------------------------------
# the start gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [TT, JT], ids=["port", "jax"])
def test_gate_releases_every_stream_at_one_time(mod):
    gate = mod._StartGate(3, timeout=30)
    got = []
    threads = [threading.Thread(target=lambda: got.append(gate.wait()))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(got) == 3 and len(set(got)) == 1


@pytest.mark.parametrize("mod", [TT, JT], ids=["port", "jax"])
def test_gate_abort_breaks_the_waiters(mod):
    gate = mod._StartGate(2, timeout=30)
    box = {}

    def waiter():
        try:
            gate.wait()
        except mod._GateBroken as exc:
            box["err"] = exc

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.2)
    gate.abort()
    t.join(timeout=30)
    assert not t.is_alive()
    assert "sibling stream failed" in str(box["err"])


@pytest.mark.parametrize("mod", [TT, JT], ids=["port", "jax"])
def test_gate_timeout_degrades_to_ungated_starts(mod, capsys,
                                                 monkeypatch):
    monkeypatch.setenv("NDS_THROUGHPUT_GATE_TIMEOUT", "0.05")
    gate = mod._StartGate(2)
    assert gate.timeout == 0.05
    t0 = time.time()
    assert gate.wait() >= t0
    assert "falling back to ungated per-stream starts" in (
        capsys.readouterr().err)


def test_missing_stream_names_the_root_cause(chain, tmp_path):
    paths = {1: str(chain / "streams" / "query_1.sql"),
             2: str(tmp_path / "no_such_stream.sql")}
    with pytest.raises(RuntimeError) as info:
        TT.run_throughput(str(chain / "wh"), paths, str(tmp_path / "time"),
                          sub_queries=["query3"], device="cpu",
                          gate_timeout=60)
    msg = str(info.value)
    # only stream 2's own error: stream 1's broken gate is not reported
    assert msg == ("throughput streams failed: {2: FileNotFoundError(2, "
                   "'No such file or directory')}")
    assert not (tmp_path / "time_1.csv").exists()


def test_gate_timeout_run_completes_ungated(chain, tmp_path, capsys,
                                           monkeypatch):
    """Stream 2's setup outlasts the gate's budget: both streams start
    ungated, and the run completes."""
    from nds_tpu_torch import power as TP

    setup = TP.setup_tables

    def slow_setup(*a, **k):
        if threading.current_thread().name == "stream-2":
            time.sleep(1.0)
        return setup(*a, **k)

    monkeypatch.setattr(TP, "setup_tables", slow_setup)
    paths = {n: str(chain / "streams" / f"query_{n}.sql") for n in STREAMS}
    ttt = TT.run_throughput(str(chain / "wh"), paths, str(tmp_path / "time"),
                            sub_queries=["query96"], device="cpu",
                            gate_timeout=0.2)
    assert "falling back to ungated per-stream starts" in (
        capsys.readouterr().err)
    assert ttt == TT._ttt_from_logs(STREAMS, str(tmp_path / "time"))


# ---------------------------------------------------------------------------
# process mode
# ---------------------------------------------------------------------------

def test_process_mode_runs_each_stream_as_a_child(chain, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv("NDS_FLIGHT_RECORDER", "off")
    monkeypatch.delenv("NDS_STREAM_TIMEOUT", raising=False)
    paths = {n: str(chain / "streams" / f"query_{n}.sql") for n in STREAMS}
    base = str(tmp_path / "time")
    ttt = TT.run_throughput(str(chain / "wh"), paths, base, mode="process",
                            sub_queries=["query3", "query96"], device="cpu",
                            json_summary_folder=str(tmp_path / "json"))
    assert ttt == TT._ttt_from_logs(STREAMS, base)
    for n in STREAMS:
        assert _log_rows(f"{base}_{n}.csv")[-4:] == [
            "Power Start Time", "Power End Time", "Power Test Time",
            "Total Time"]
        s = _summaries(tmp_path / "json" / f"stream_{n}")
        assert [s[q]["queryStatus"] for q in ("query3", "query96")] == [
            ["Completed"]] * 2
        with open(f"{base}_{n}.out") as f:
            assert "Power Test Time" in f.read()


def test_process_mode_kills_a_hung_child(chain, tmp_path, monkeypatch):
    monkeypatch.setenv("NDS_STREAM_TIMEOUT", "0.5")
    paths = {1: str(chain / "streams" / "query_1.sql")}
    with pytest.raises(RuntimeError) as info:
        TT.run_throughput(str(chain / "wh"), paths, str(tmp_path / "time"),
                          mode="process", sub_queries=["query3"],
                          device="cpu")
    assert "exceeded the 0s watchdog budget" in str(info.value) or (
        "was killed" in str(info.value))
    assert "stream 1" in str(info.value)


def test_process_mode_reports_a_failed_child(chain, tmp_path, monkeypatch):
    monkeypatch.delenv("NDS_STREAM_TIMEOUT", raising=False)
    monkeypatch.setenv("NDS_FLIGHT_RECORDER", "off")
    paths = {1: str(chain / "streams" / "query_1.sql")}
    with pytest.raises(RuntimeError, match="query999"):
        TT.run_throughput(str(chain / "wh"), paths, str(tmp_path / "time"),
                          mode="process", sub_queries=["query999"],
                          device="cpu")


@pytest.mark.parametrize("env,args", [
    ({}, (None, 103)), ({"NDS_STREAM_TIMEOUT": "42"}, (None, 103)),
    ({"NDS_STREAM_TIMEOUT": "0"}, (5, 103)),
    ({"NDS_QUERY_TIMEOUT": "10"}, (None, 103)),
    ({"NDS_QUERY_TIMEOUT": "10"}, (3, 8)),
    ({"NDS_STREAM_TIMEOUT": "7", "NDS_QUERY_TIMEOUT": "10"}, (3, 8)),
    ({}, (2.5, 4)),
])
def test_stream_wait_budget_matches_jax(env, args, monkeypatch):
    for k in ("NDS_STREAM_TIMEOUT", "NDS_QUERY_TIMEOUT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert TT.stream_wait_budget(*args) == JT.stream_wait_budget(*args)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["wh", "sdir", "1,2", "tl"],
    ["wh", "sdir", "3,4", "tl", "--floats", "--mode", "process",
     "--sub_queries", "query3, query7", "--query_timeout", "30",
     "--property_file", "p", "--json_summary_folder", "j",
     "--output_prefix", "o", "--output_format", "parquet"],
])
def test_cli_matches_jax(argv, monkeypatch, capsys):
    """The same arguments reach run_throughput, and the same line is
    printed."""
    calls = {}

    def fake(tag):
        def run(*a, **k):
            calls[tag] = (a, k)
            return 12.3
        return run

    monkeypatch.setattr(JTCLI, "run_throughput", fake("jax"))
    monkeypatch.setattr(TTCLI, "run_throughput", fake("port"))
    monkeypatch.setattr(JTCLI, "check_version", lambda: None)
    JTCLI.main(argv)
    jout = capsys.readouterr().out
    TTCLI.main(argv + ["--device", "cpu"])
    tout = capsys.readouterr().out
    assert tout == jout == "====== Throughput Test Time: 12.3 seconds ======\n"
    ja, jk = calls["jax"]
    ta, tk = calls["port"]
    assert ta == ja
    assert tk.pop("device") == "cpu"
    assert tk == jk


def test_cli_runs_the_streams(chain, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("NDS_FLIGHT_RECORDER", "off")
    base = str(tmp_path / "time")
    TTCLI.main([str(chain / "wh"), str(chain / "streams"), "1,2", base,
                "--sub_queries", "query96", "--device", "cpu"])
    out = capsys.readouterr().out
    ttt = TT._ttt_from_logs(STREAMS, base)
    assert out.splitlines()[-1] == (
        f"====== Throughput Test Time: {ttt} seconds ======")


@pytest.mark.parametrize("fmt", ["csv", "orc", "lakehouse"])
def test_other_input_formats_raise(fmt, tmp_path):
    with pytest.raises(NotImplementedError, match="item 9.3"):
        TTCLI.main(["wh", str(tmp_path), "1", str(tmp_path / "t"),
                    "--input_format", fmt, "--device", "cpu"])


# ---------------------------------------------------------------------------
# two threads at the kernels' first use
# ---------------------------------------------------------------------------

def test_two_threads_build_the_kernels_once(monkeypatch):
    """The build lock: two threads that reach `_build.load` at once build
    once and load one library."""
    builds = []

    def build_all(names=None):
        builds.append(threading.current_thread().name)
        time.sleep(0.2)
        return {}

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_all", build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    go = threading.Barrier(2)
    got = {}

    def first(i):
        go.wait()
        got[i] = _build.load("segment_sums")

    threads = [threading.Thread(target=first, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(builds) == 1
    assert got[0] is got[1]


def test_two_threads_call_the_wrappers_at_once():
    """On the CPU each wrapper runs its plain version; two threads calling
    at once get what one thread gets."""
    g = torch.Generator().manual_seed(3)
    vals = torch.randint(0, 100, (4096,), generator=g).to(torch.float32)
    gid = torch.randint(0, 64, (4096,), generator=g).to(torch.int32)
    want = GK.segment_sums(vals, gid, 64)
    go = threading.Barrier(2)
    got = {}

    def call(i):
        go.wait()
        got[i] = GK.segment_sums(vals, gid, 64)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    for i in range(2):
        assert torch.equal(got[i][0], want[0])
        assert torch.equal(got[i][1], want[1])


def test_launch_counts_lose_no_update_across_threads(monkeypatch):
    """Concurrent streams launch from several threads: the counter is
    exact under a short switch interval."""
    monkeypatch.setattr(GK, "LAUNCHES", dict.fromkeys(GK.LAUNCHES, 0))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [GK._launched("dense_build")
                            for _ in range(20000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert GK.LAUNCHES["dense_build"] == 16 * 20000
