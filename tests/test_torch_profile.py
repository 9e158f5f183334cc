"""The port's event stream and profiler held to the JAX package's.

One TPC-DS stream of templates at SF0.01 (the repo's generator writes the
data into a directory of this module; each template instantiated as the
reference's test_query_streams does, seed 1000 + its number) runs through
both packages' Power Run (`power.run_query_stream`, csv input), each with
its own trace directory and JSON summary folder; and the seeded star's q3
(tests/test_torch_sql.py's tables) runs through both packages' sessions.
Then, package against package:

  * the multiset of event kinds is the same;
  * each statement's `op_span` sequence of (node, depth, seq, rows) is
    the same;
  * `profile --json` and `profile --critical-path --json` print the same,
    durations, memory readings and ids aside;
  * each package's `cli/profile.py` reads the other package's event files
    exactly as that package's own does, and `--check` passes on both.

Also the reference's traced Power Run end to end (tests/test_obs.py, slow
there): the port's run leaves a parseable log whose root spans fit in
their query's wall time and summaries that carry `memoryHighWater`.

The memory sampler's heartbeat is off (NDS_HEARTBEAT_INTERVAL_MS=0): its
event count follows wall time, not the engine. Exact: no tolerance.
"""

import collections
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from nds_tpu import faults as JF
from nds_tpu import power as JPW
from nds_tpu import report as JREP
from nds_tpu.cli import profile as JPROF
from nds_tpu.datagen import query_streams as QS
from nds_tpu.engine.session import Session as JaxSession
from nds_tpu.obs import reader as JR
from nds_tpu.obs import trace as JOT
from nds_tpu_torch import faults as TF
from nds_tpu_torch import power as TPW
from nds_tpu_torch import report as TREP
from nds_tpu_torch.cli import profile as TPROF
from nds_tpu_torch.engine.session import Session as TorchSession
from nds_tpu_torch.obs import reader as TR
from nds_tpu_torch.obs import trace as TOT

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: single-statement templates: scans, star joins, grouping, ordering, top-k
TEMPLATES = (3, 7, 42, 52, 55, 96)

PKGS = ("jax", "port")
CLIS = {"jax": JPROF, "port": TPROF}
READERS = {"jax": JR, "port": TR}


def _stream_text():
    out = []
    for i, q in enumerate(TEMPLATES, 1):
        sql = QS.instantiate(q, np.random.default_rng(1000 + q), 0.01)
        out.append(f"-- start query {i} in stream 0 using template "
                   f"query{q}.tpl\n{sql.strip()}\n;\n-- end query {i} in "
                   f"stream 0 using template query{q}.tpl\n")
    return "\n".join(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{pkg: (trace dir, JSON summary folder)} of one Power Run each over
    the same SF0.01 data and stream."""
    root = tmp_path_factory.mktemp("profile_parity")
    data = root / "raw"
    subprocess.run(
        [sys.executable, "-m", "nds_tpu.cli.gen_data", "--scale", "0.01",
         "--parallel", "2", "--data_dir", str(data), "--overwrite_output"],
        check=True, capture_output=True, cwd=ROOT,
    )
    stream = root / "query_0.sql"
    stream.write_text(_stream_text())
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NDS_HEARTBEAT_INTERVAL_MS", "0")
        mp.delenv("NDS_METRICS_PORT", raising=False)
        for pkg, pw, kw in (("jax", JPW, {}),
                            ("port", TPW, {"device": "cpu"})):
            trace, summaries = root / f"trace_{pkg}", root / f"json_{pkg}"
            mp.setenv("NDS_TRACE_DIR", str(trace))
            pw.run_query_stream(
                input_prefix=str(data), property_file=None,
                query_dict=pw.gen_sql_from_stream(str(stream)),
                time_log_output_path=str(root / f"time_{pkg}.csv"),
                input_format="csv", json_summary_folder=str(summaries),
                **kw,
            )
            out[pkg] = (str(trace), str(summaries))
    return out


def _events(pkg, trace):
    return READERS[pkg].read_events(trace, strict=True)


def _op_spans(events):
    """{query: [(node, depth, seq, rows)]} in emission order."""
    out = collections.defaultdict(list)
    for e in events:
        if e["kind"] == "op_span":
            out[e.get("query")].append(
                (e["node"], e["depth"], e["seq"], e["rows"]))
    return dict(out)


#: profile JSON keys that carry wall-clock readings, memory readings or
#: per-process ids, and the critical path's `chain` (each step follows the
#: child with the larger wall time): the two runs differ in them by nature
_VOLATILE = ("ms", "mem_", "app", "trace_id", "ts", "path", "file", "chain")


def _normalised(obj):
    if isinstance(obj, dict):
        return {k: _normalised(v) for k, v in obj.items()
                if not any(t in k for t in _VOLATILE)}
    if isinstance(obj, list):
        return [_normalised(v) for v in obj]
    if isinstance(obj, float):
        return None  # shares and ratios of wall-clock readings
    return obj


def _cli_json(pkg, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        CLIS[pkg].main([*args, "--json"])
    return json.loads(buf.getvalue())


def test_stream_event_kinds_match(runs):
    kinds = {pkg: collections.Counter(
        e["kind"] for e in _events(pkg, runs[pkg][0])) for pkg in PKGS}
    assert kinds["port"] == kinds["jax"]
    assert {"op_span", "query_span", "catalog_load", "plan_budget",
            "exec_cache", "pipeline_span", "trace_meta"} <= set(kinds["port"])
    assert kinds["port"]["query_span"] == len(TEMPLATES)


def test_stream_op_span_trees_match(runs):
    spans = {pkg: _op_spans(_events(pkg, runs[pkg][0])) for pkg in PKGS}
    assert set(spans["port"]) == {f"query{q}" for q in TEMPLATES}
    for q in spans["jax"]:
        assert spans["port"][q] == spans["jax"][q], q


def test_stream_statuses_and_summaries_match(runs):
    for pkg in PKGS:
        evs = _events(pkg, runs[pkg][0])
        assert {e["query"]: e["status"] for e in evs
                if e["kind"] == "query_span"} == {
            f"query{q}": "Completed" for q in TEMPLATES}
    for pkg in PKGS:
        names = sorted(os.listdir(runs[pkg][1]))
        assert len(names) == len(TEMPLATES)
        for n in names:
            s = json.load(open(os.path.join(runs[pkg][1], n)))
            assert s["memoryHighWater"]["bytes"] > 0, (pkg, n)
            assert s["queryStatus"] == ["Completed"]


@pytest.mark.parametrize("mode", ["profile", "critical_path"])
def test_profile_json_matches(runs, mode):
    args = ["--critical-path"] if mode == "critical_path" else ["--per_query"]
    out = {pkg: _cli_json(pkg, runs[pkg][0], *args) for pkg in PKGS}
    assert _normalised(out["port"]) == _normalised(out["jax"])


@pytest.mark.parametrize("mode", ["profile", "critical_path", "check"])
@pytest.mark.parametrize("writer", PKGS)
def test_profile_reads_the_other_package(runs, writer, mode):
    """Each package's CLI over one package's event files prints exactly
    what the writing package's own CLI prints (same files, no
    normalisation)."""
    trace = runs[writer][0]
    if mode == "check":
        for pkg in PKGS:
            CLIS[pkg].main([trace, "--check"])  # exits 0: no SystemExit
        return
    args = ["--critical-path"] if mode == "critical_path" else ["--per_query"]
    assert _cli_json("port", trace, *args) == _cli_json("jax", trace, *args)


def test_traced_power_run_end_to_end(runs, capsys):
    """tests/test_obs.py's slow acceptance case through the port: a
    parseable log with operator, query and catalog events, each root span
    inside its query's wall, and the profiler's per-operator table."""
    trace = runs["port"][0]
    files = TR.discover_event_files(trace)
    assert len(files) == 1
    evs = TR.read_events(files, strict=True)
    assert TR.validate_events(evs) == []
    prof = TR.profile_events(evs)
    assert set(prof["queries"]) == {f"query{q}" for q in TEMPLATES}
    for q, rec in prof["queries"].items():
        assert rec["status"] == "Completed"
        assert rec["ops"], q
        assert rec["root_incl_ms"] <= rec["wall_ms"] + 1.0, q
        assert rec.get("mem_hw_bytes", 0) > 0
    TPROF.main([trace, "--per_query", "--check"])
    out = capsys.readouterr().out
    assert "query42" in out and "Pipeline" in out and "tallies" in out
    assert "plan budget" in out and "direct" in out


# ---------------------------------------------------------------------------
# the seeded star's q3 through both sessions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def star_runs(tmp_path_factory):
    from test_torch_sql import QUERIES, _synth_tables

    tables = _synth_tables()
    root = tmp_path_factory.mktemp("star_parity")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NDS_HEARTBEAT_INTERVAL_MS", "0")
        for pkg, OT, F, REP, make in (
            ("jax", JOT, JF, JREP,
             lambda c: JaxSession(conf={**c, "engine.aot_cache_dir": ""})),
            ("port", TOT, TF, TREP,
             lambda c: TorchSession(conf=c, device="cpu")),
        ):
            d = str(root / pkg)
            s = make({"engine.trace_dir": d})
            for name, at in tables.items():
                s.register_arrow(name, at)
            with OT.bind(s.tracer):
                for q in ("q3", "q3_again"):
                    with F.scope(q):
                        REP.BenchReport(s).report_on(
                            lambda: s.sql(QUERIES["star_agg_q3"]).collect(),
                            retry_oom=True, name=q)
            s.tracer.close()
            out[pkg] = d
    return out


def test_star_q3_events_match(star_runs):
    evs = {pkg: _events(pkg, star_runs[pkg]) for pkg in PKGS}
    kinds = {pkg: collections.Counter(e["kind"] for e in evs[pkg])
             for pkg in PKGS}
    assert kinds["port"] == kinds["jax"]
    # the rerun answers the aggregate from the plan cache
    pc = [e["hit"] for e in evs["port"] if e["kind"] == "plan_cache"]
    assert pc == [False, True]
    assert _op_spans(evs["port"]) == _op_spans(evs["jax"])


def test_star_q3_profiles_match(star_runs):
    for args in (["--per_query"], ["--critical-path"]):
        out = {pkg: _cli_json(pkg, star_runs[pkg], *args) for pkg in PKGS}
        assert _normalised(out["port"]) == _normalised(out["jax"]), args
