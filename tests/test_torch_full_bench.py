"""The port's whole-benchmark orchestrator (nds_tpu_torch/full_bench.py,
cli/bench.py and bench.yml) against the JAX package's (nds_tpu/full_bench.py).

- The helpers (stream ranges, the composite metric, the config fingerprint
  and the checkpoint's path) over hypothesis-drawn inputs, and the report
  parsers over the same files, through both packages.
- The orchestrator's logic through both packages' `run_full_bench` with the
  same stubbed phase runners (the pattern of tests/test_faults.py): a crash
  at power_test then --resume, a transient retry, a deterministic failure,
  a fingerprint mismatch, a resume without a checkpoint, a bad num_streams,
  and the opt-in, fail-soft maintenance-under-load phase. The metrics maps,
  the runners' calls and the checkpoint's phase keys are equal.
- Every command the port's orchestrator builds (subprocess.run stubbed):
  each `-m` target is the port's, `--device` goes to the four device phases
  only, and with it taken out each command equals the JAX package's with
  its module renamed.
- A trace directory (NDS_TRACE_DIR or engine.trace_dir in the power
  property file) raises naming ROADMAP.md item 12 before a phase runs.
- One real run of `python -m nds_tpu_torch.cli.bench --device cpu` at
  SF0.01 with 3 streams in tmp_path, crashed at power_test and resumed; the
  JAX package's parsers and metric read the port's report files to the
  port's metrics.

Tolerance: exact equality throughout (integers, strings and the metric's
own float formula).
"""

import json
import os
import subprocess
import sys

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from nds_tpu import faults as JF
from nds_tpu import full_bench as JFB
from nds_tpu.obs import trace as JOT
from nds_tpu_torch import faults as TF
from nds_tpu_torch import full_bench as TFB

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (JFB, JF), "port": (TFB, TF)}
HYP = settings(max_examples=150, deadline=None, database=None)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("NDS_FAULT_SPEC", "NDS_TRACE_DIR", "NDS_METRICS_PORT",
              "NDS_PHASE_RETRIES", "NDS_PHASE_RETRY_UNKNOWN",
              "NDS_PHASE_BACKOFF", "NDS_TRACE_CONTEXT"):
        monkeypatch.delenv(k, raising=False)
    # the JAX orchestrator's in-memory flight recorder off: the port has none
    monkeypatch.setenv("NDS_FLIGHT_RECORDER", "off")
    JF.reset()
    TF.reset()
    yield
    JF.reset()
    TF.reset()


def test_bench_yml_is_a_byte_identical_copy():
    with open(os.path.join(REPO, "nds_tpu", "bench.yml"), "rb") as a, open(
            os.path.join(REPO, "nds_tpu_torch", "bench.yml"), "rb") as b:
        assert a.read() == b.read()
    params = TFB.get_yaml_params(os.path.join(REPO, "nds_tpu_torch",
                                              "bench.yml"))
    assert params == JFB.get_yaml_params(
        os.path.join(REPO, "nds_tpu", "bench.yml"))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


@HYP
@given(st.integers(0, 201), st.sampled_from([1, 2]))
def test_stream_ranges_match(num_streams, which):
    assert TFB.get_stream_range(num_streams, which) == JFB.get_stream_range(
        num_streams, which)
    assert TFB.get_throughput_stream_nums(num_streams, which) == \
        JFB.get_throughput_stream_nums(num_streams, which)


_TIMES = st.floats(0.1, 1e6, allow_nan=False, allow_infinity=False)


@HYP
@given(st.one_of(st.floats(0.001, 0.999), st.integers(1, 100_000),
                 st.sampled_from([0.01, 0.1, 0.5, 1, 10, 100, 3000])),
       st.integers(1, 50), _TIMES, _TIMES, _TIMES, _TIMES, _TIMES, _TIMES)
def test_perf_metric_matches(sf, sq, tload, tpower, ttt1, ttt2, tdm1, tdm2):
    args = (sf, sq, tload, tpower, ttt1, ttt2, tdm1, tdm2)
    assert TFB.get_perf_metric(*args) == JFB.get_perf_metric(*args)


def test_perf_metric_below_sf1_is_not_zero():
    for pkg in (TFB, JFB):
        assert pkg.get_perf_metric(0.01, 1, 10, 10, 10, 10, 10, 10) > 0


_JSON = st.recursive(
    st.none() | st.booleans() | st.integers(-10**9, 10**9)
    | st.floats(allow_nan=False) | st.text(max_size=8),
    lambda inner: st.lists(inner, max_size=3)
    | st.dictionaries(st.text(max_size=6), inner, max_size=4),
    max_leaves=12)


@HYP
@given(st.dictionaries(st.text(max_size=8), _JSON, max_size=5),
       st.one_of(st.none(), st.just(""), st.text(max_size=12),
                 st.just("/tmp/x/metrics.csv"), st.just("memory://b/m.csv")),
       st.one_of(st.none(), st.just(""), st.text(max_size=12)))
def test_fingerprint_and_state_path_match(params, metrics_path, state_path):
    if metrics_path is not None:
        params["metrics_report_path"] = metrics_path
    if state_path is not None:
        params["bench_state_path"] = state_path
    assert TFB.params_fingerprint(params) == JFB.params_fingerprint(params)
    assert TFB.bench_state_path(params) == JFB.bench_state_path(params)


@pytest.mark.parametrize("load_s,power_ms,dm_s,window", [
    (12.5, 12345, 7.5, (100, 200)),
    (0.01, 1, 0.0, (5, 5)),
    (3605.25, 86_400_001, 999.91, (1_700_000_000, 1_700_003_333)),
])
def test_report_parsers_match(tmp_path, load_s, power_ms, dm_s, window):
    load = tmp_path / "load.txt"
    load.write_text(f"Load Test Time: {load_s} seconds\n"
                    "Load Test Finished at: 2026-01-01\n"
                    "RNGSEED used: 07300207223\n")
    power = tmp_path / "power.csv"
    power.write_text("application_id,query,time/milliseconds\n"
                     "app-1,query1,100\n"
                     f"app-1,Power Test Time,{power_ms}\n")
    for n in (1, 2, 3, 4):
        (tmp_path / f"dm_{n}.csv").write_text(
            f"app-1,LF_SS,10\napp-1,Data Maintenance Time,{dm_s * n}\n")
        (tmp_path / f"tt_{n}.csv").write_text(
            f"app,Power Start Time,{window[0] + n}\n"
            f"app,Power End Time,{window[1] + 2 * n}\n")
    for fn, args in (
        ("get_load_time", (str(load),)),
        ("get_load_end_timestamp", (str(load),)),
        ("get_power_time", (str(power),)),
        ("get_refresh_time", (str(tmp_path / "dm_2.csv"),)),
        ("get_maintenance_time", (str(tmp_path / "dm"), 5, 1)),
        ("get_maintenance_time", (str(tmp_path / "dm"), 5, 2)),
        ("get_throughput_time", (str(tmp_path / "tt"), 5, 1)),
        ("get_throughput_time", (str(tmp_path / "tt"), 5, 2)),
    ):
        got = getattr(TFB, fn)(*args)
        assert got == getattr(JFB, fn)(*args), fn
    (tmp_path / "empty.txt").write_text("nothing\n")
    for fn in ("get_load_time", "get_load_end_timestamp", "get_power_time",
               "get_refresh_time"):
        for pkg in (TFB, JFB):
            with pytest.raises(ValueError):
                getattr(pkg, fn)(str(tmp_path / "empty.txt"))


# ---------------------------------------------------------------------------
# the orchestrator's logic, phase runners stubbed
# ---------------------------------------------------------------------------


def _stub_phases(monkeypatch, FB, calls):
    """Replace every phase runner of `FB` with a fake that writes the report
    files the parsers re-read (tests/test_faults.py's stubs, plus the
    maintenance-under-load runner)."""

    def note(name):
        calls.append(name)

    def fake_load(params):
        note("load_test")
        with open(params["load_test"]["report_path"], "w") as f:
            f.write("Load Test Time: 10.0 seconds\nRNGSEED used: 123\n")

    def fake_power(params):
        note("power_test")
        with open(params["power_test"]["report_path"], "w") as f:
            f.write("app-1,Power Test Time,60000\n")

    def fake_tt(params, num_streams, which):
        note(f"throughput_test_{which}")
        for n in FB.get_stream_range(num_streams, which):
            with open(f"{params['throughput_test']['report_base_path']}_{n}"
                      ".csv", "w") as f:
                f.write("app,Power Start Time,100\napp,Power End Time,200\n")

    def fake_dm(params, num_streams, which):
        note(f"maintenance_test_{which}")
        for n in FB.get_stream_range(num_streams, which):
            base = params["maintenance_test"]["maintenance_report_base_path"]
            with open(f"{base}_{n}.csv", "w") as f:
                f.write("app,Data Maintenance Time,30\n")

    monkeypatch.setattr(FB, "run_data_gen", lambda p, n: note("data_gen"))
    monkeypatch.setattr(FB, "run_load_test", fake_load)
    monkeypatch.setattr(FB, "gen_streams", lambda p, n, s: note("gen_streams"))
    monkeypatch.setattr(FB, "power_test", fake_power)
    monkeypatch.setattr(FB, "throughput_test", fake_tt)
    monkeypatch.setattr(FB, "maintenance_test", fake_dm)
    monkeypatch.setattr(FB, "maintenance_under_load_test",
                        lambda p, n: note("maintenance_under_load"))


def _bench_params(root, num_streams=3):
    return {
        "data_gen": {"scale_factor": 1, "parallel": 2,
                     "raw_data_path": str(root / "raw")},
        "load_test": {"output_path": str(root / "wh"),
                      "report_path": str(root / "load.txt")},
        "generate_query_stream": {"num_streams": num_streams,
                                  "stream_output_path": str(root / "st")},
        "power_test": {"report_path": str(root / "power.csv")},
        "throughput_test": {"report_base_path": str(root / "tt")},
        "maintenance_test": {
            "maintenance_report_base_path": str(root / "dm")},
        "metrics_report_path": str(root / "metrics.csv"),
    }


def _state(root):
    path = root / "bench_state.json"
    return sorted(json.load(open(path))["phases"]) if path.exists() else None


def _metrics_csv(root):
    path = root / "metrics.csv"
    return path.read_text() if path.exists() else None


def _case_crash_then_resume(FB, F, root, monkeypatch, calls):
    monkeypatch.setenv("NDS_FAULT_SPEC", "crash:power_test")
    with pytest.raises(F.InjectedCrash):
        FB.run_full_bench(_bench_params(root))
    out = {"after_crash": (_state(root), _metrics_csv(root), list(calls))}
    monkeypatch.delenv("NDS_FAULT_SPEC")
    F.reset()
    calls.clear()
    out["metrics"] = FB.run_full_bench(_bench_params(root), resume=True)
    return out


def _case_transient_retry(FB, F, root, monkeypatch, calls):
    monkeypatch.setenv("NDS_PHASE_RETRIES", "2")
    monkeypatch.setenv("NDS_PHASE_BACKOFF", "0")
    monkeypatch.setenv("NDS_FAULT_SPEC", "io:power_test:2")
    return {"metrics": FB.run_full_bench(_bench_params(root))}


def _case_deterministic_failure(FB, F, root, monkeypatch, calls):
    monkeypatch.setenv("NDS_PHASE_RETRIES", "3")

    def boom(params):
        calls.append("power_test")
        raise RuntimeError("query produced wrong answer")  # not transient

    monkeypatch.setattr(FB, "power_test", boom)
    with pytest.raises(FB.PhaseError) as e:
        FB.run_full_bench(_bench_params(root))
    return {"error": (str(e.value), e.value.phase, e.value.kind)}


def _case_fingerprint_mismatch(FB, F, root, monkeypatch, calls):
    params = _bench_params(root)
    first = FB.run_full_bench(params)
    old = FB.params_fingerprint(params)
    params["data_gen"] = dict(params["data_gen"], scale_factor=100)
    with pytest.raises(ValueError, match="different.*config") as e:
        FB.run_full_bench(params, resume=True)
    # the paths in the config differ between the packages' runs
    msg = str(e.value).replace(str(root), "<root>")
    return {"metrics": first, "error": msg.replace(old, "<old>").replace(
        FB.params_fingerprint(params), "<new>")}


def _case_resume_without_checkpoint(FB, F, root, monkeypatch, calls):
    return {"metrics": FB.run_full_bench(_bench_params(root), resume=True)}


def _case_under_load_opt_in(FB, F, root, monkeypatch, calls):
    params = _bench_params(root)
    params["maintenance_under_load"] = {"enabled": True}
    return {"metrics": FB.run_full_bench(params)}


def _case_under_load_fail_soft(FB, F, root, monkeypatch, calls):
    def boom(params, num_streams):
        calls.append("maintenance_under_load")
        raise RuntimeError("refresh function failed under load")

    monkeypatch.setattr(FB, "maintenance_under_load_test", boom)
    params = _bench_params(root)
    params["maintenance_under_load"] = {"enabled": True}
    return {"metrics": FB.run_full_bench(params)}


def _case_under_load_off_by_default(FB, F, root, monkeypatch, calls):
    params = _bench_params(root)
    params["maintenance_under_load"] = {"enabled": False}
    return {"metrics": FB.run_full_bench(params)}


CASES = {
    "crash_then_resume": _case_crash_then_resume,
    "transient_retry": _case_transient_retry,
    "deterministic_failure": _case_deterministic_failure,
    "fingerprint_mismatch": _case_fingerprint_mismatch,
    "resume_without_checkpoint": _case_resume_without_checkpoint,
    "under_load_opt_in": _case_under_load_opt_in,
    "under_load_fail_soft": _case_under_load_fail_soft,
    "under_load_off_by_default": _case_under_load_off_by_default,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_orchestrator_matches_jax(tmp_path, monkeypatch, capsys, case):
    outs = {}
    for name, (FB, F) in PKGS.items():
        root = tmp_path / name
        root.mkdir()
        calls = []
        with monkeypatch.context() as m:
            _stub_phases(m, FB, calls)
            out = CASES[case](FB, F, root, m, calls)
        F.reset()
        out["calls"] = calls
        out["state"] = _state(root)
        csv_text = _metrics_csv(root)
        out["metrics_csv"] = csv_text and csv_text.replace(str(root), "<root>")
        outs[name] = out
    assert outs["port"] == outs["jax"]
    out = outs["port"]
    if case == "crash_then_resume":
        state, metrics_csv, calls = out["after_crash"]
        assert state == ["data_gen", "gen_streams", "load_test"]
        assert metrics_csv is None
        assert calls == ["data_gen", "load_test", "gen_streams"]
        assert out["calls"] == ["power_test", "throughput_test_1",
                                "maintenance_test_1", "throughput_test_2",
                                "maintenance_test_2"]
    if case == "transient_retry":
        assert out["calls"].count("power_test") == 1
        assert "power_test" in out["state"]
    if case == "deterministic_failure":
        assert out["calls"] == ["data_gen", "load_test", "gen_streams",
                                "power_test"]
        assert out["error"][1:] == ("power_test", "unknown")
    if case == "fingerprint_mismatch":
        assert "(fingerprint <old> != <new>)" in out["error"]
    if case.startswith("under_load"):
        ran = "maintenance_under_load" in out["calls"]
        assert ran == (case != "under_load_off_by_default")
        failed = "maintenance_under_load_error" in out["metrics"]
        assert failed == (case == "under_load_fail_soft")
        assert ("maintenance_under_load" in out["state"]) == (
            case == "under_load_opt_in")
    if "metrics" in out:
        assert out["metrics"]["perf_metric"] > 0
        assert "feedback_hit_rate" not in out["metrics"]


@pytest.mark.parametrize("num_streams", [0, 1, 2, 4, 6, 10])
def test_num_streams_must_be_odd_and_at_least_3(tmp_path, num_streams):
    errs = []
    for FB, _ in PKGS.values():
        with pytest.raises(ValueError) as e:
            FB.run_full_bench(_bench_params(tmp_path, num_streams))
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# the commands the orchestrator builds
# ---------------------------------------------------------------------------


def _recording_run(cmds):
    """A stand-in for subprocess.run that records each command and writes
    the report files its phase's parser re-reads."""

    def run(cmd, check=False, **kw):
        cmds.append(list(cmd))
        leaf = cmd[cmd.index("-m") + 1].rsplit(".", 1)[1]
        pos = cmd[3:]
        if leaf == "transcode":
            with open(pos[2], "w") as f:
                f.write("Load Test Time: 10.0 seconds\nRNGSEED used: 7\n")
        elif leaf == "power":
            with open(pos[2], "w") as f:
                f.write("app-1,Power Test Time,60000\n")
        elif leaf == "throughput":
            for n in pos[2].split(","):
                with open(f"{pos[3]}_{n}.csv", "w") as f:
                    f.write("app,Power Start Time,100\n"
                            "app,Power End Time,200\n")
        elif leaf == "maintenance":
            with open(pos[2], "w") as f:
                f.write("app,Data Maintenance Time,30\n")
        return subprocess.CompletedProcess(cmd, 0)

    return run


def _full_params(root):
    prop = root / "engine.properties"
    prop.write_text("engine.pallas_agg=on\n")
    params = _bench_params(root, num_streams=5)
    params["power_test"].update(property_path=str(prop),
                                output_path=str(root / "out"),
                                sub_queries="query3,query96")
    params["throughput_test"].update(mode="thread", sub_queries="query3")
    params["maintenance_test"]["maintenance_queries"] = "LF_SS,DF_SS"
    params["generate_query_stream"]["query_template_dir"] = str(root / "tpl")
    params["maintenance_under_load"] = {"enabled": True,
                                       "sub_queries": "query96"}
    return params


DEVICE_PHASES = {"power", "throughput", "maintenance"}


@pytest.mark.parametrize("device", [None, "cpu"])
def test_commands_name_the_port_and_match_jax(tmp_path, monkeypatch, device):
    cmds = {}
    for name, (FB, _) in PKGS.items():
        root = tmp_path / name
        root.mkdir()
        cmds[name] = []
        monkeypatch.setattr(subprocess, "run", _recording_run(cmds[name]))
        kw = {"device": device} if name == "port" else {}
        metrics = FB.run_full_bench(_full_params(root), **kw)
        assert metrics["perf_metric"] > 0
        cmds[name] = [[str(c).replace(str(root), "<root>") for c in cmd]
                      for cmd in cmds[name]]
    assert len(cmds["port"]) == len(cmds["jax"]) == 5 + 1 + 1 + 1 + 2 + 4 + 1
    for cmd, ref in zip(cmds["port"], cmds["jax"]):
        mod = cmd[cmd.index("-m") + 1]
        assert mod.startswith("nds_tpu_torch.cli."), cmd
        if device and mod.rsplit(".", 1)[1] in DEVICE_PHASES:
            assert cmd[-2:] == ["--device", device], cmd
            cmd = cmd[:-2]
        assert "--device" not in cmd, cmd
        assert cmd == [c.replace("nds_tpu.cli.", "nds_tpu_torch.cli.")
                       for c in ref]
    assert all(not str(c).startswith("nds_tpu.")
               for cmd in cmds["port"] for c in cmd)


def test_summary_folders_go_to_the_device_phases(tmp_path, monkeypatch):
    """`json_summary_folder` (the port's key) in the power, throughput and
    maintenance sections: `--json_summary_folder` before `--device`, one
    folder per refresh set, and each attempt's own summary directories
    emptied first (a stale file would make the CLI refuse the folder)."""
    params = _full_params(tmp_path)
    json_dir = tmp_path / "json"
    for section in ("power_test", "throughput_test", "maintenance_test"):
        params[section]["json_summary_folder"] = str(json_dir / section)
    stale = [json_dir / "power_test" / "old.json",
             json_dir / "throughput_test" / "stream_3" / "old.json",
             json_dir / "maintenance_test_2" / "old.json"]
    kept = json_dir / "throughput_test" / "stream_9" / "other.json"
    for f in stale + [kept]:
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text("{}")
    cmds = []
    monkeypatch.setattr(subprocess, "run", _recording_run(cmds))
    TFB.run_full_bench(params, device="cpu")
    folders = {}
    for cmd in cmds:
        leaf = cmd[cmd.index("-m") + 1].rsplit(".", 1)[1]
        if "--json_summary_folder" in cmd:
            assert cmd[-4] == "--json_summary_folder", cmd
            folders.setdefault(leaf, []).append(cmd[-3])
    d = str(json_dir)
    assert folders == {
        "power": [f"{d}/power_test"],
        "throughput": [f"{d}/throughput_test"] * 2,
        "maintenance": [f"{d}/maintenance_test_{i}" for i in (1, 2, 3, 4)]}
    assert not any(f.exists() for f in stale)
    assert kept.exists()


# ---------------------------------------------------------------------------
# the trace knob
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("where", ["env", "property_file"])
def test_trace_dir_raises_before_any_phase(tmp_path, monkeypatch, where):
    params = _bench_params(tmp_path / "bench")
    conf_dir = tmp_path / "conf"
    conf_dir.mkdir()
    trace_dir = str(tmp_path / "trace")
    if where == "env":
        monkeypatch.setenv("NDS_TRACE_DIR", trace_dir)
    else:
        prop = conf_dir / "engine.properties"
        prop.write_text(f"engine.pallas_join=on\nengine.trace_dir={trace_dir}\n")
        params["power_test"]["property_path"] = str(prop)
    # the JAX orchestrator turns its tracer on for the same knob
    assert JOT.resolve_trace_dir(JFB._bench_trace_conf(params)) == trace_dir
    cmds = []
    monkeypatch.setattr(subprocess, "run", _recording_run(cmds))
    monkeypatch.setenv("NDS_FAULT_SPEC", "crash:data_gen")
    with pytest.raises(NotImplementedError, match="item 12"):
        TFB.run_full_bench(params, device="cpu")
    assert cmds == []
    assert not TF.active()  # raised before the injection sites were armed
    assert sorted(os.listdir(tmp_path)) == ["conf"]


def test_metrics_port_raises_before_any_phase(tmp_path, monkeypatch):
    monkeypatch.setenv("NDS_METRICS_PORT", "0")
    cmds = []
    monkeypatch.setattr(subprocess, "run", _recording_run(cmds))
    with pytest.raises(NotImplementedError, match="item 12"):
        TFB.run_full_bench(_bench_params(tmp_path))
    assert cmds == [] and os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# one real run through the CLI
# ---------------------------------------------------------------------------

E2E_QUERIES = "query3,query7,query96"


def _e2e_params(root):
    return {
        "data_gen": {"scale_factor": 0.01, "parallel": 2,
                     "raw_data_path": str(root / "raw"), "skip": False},
        "load_test": {"output_path": str(root / "warehouse"),
                      "warehouse_format": "lakehouse",
                      "report_path": str(root / "load.txt"), "skip": False},
        "generate_query_stream": {"num_streams": 3,
                                  "query_template_dir": None,
                                  "stream_output_path": str(root / "streams"),
                                  "skip": False},
        "power_test": {"report_path": str(root / "power.csv"),
                       "property_path": None, "output_path": None,
                       "sub_queries": E2E_QUERIES,
                       "json_summary_folder": str(root / "json_power"),
                       "skip": False},
        "throughput_test": {"report_base_path": str(root / "throughput"),
                            "sub_queries": E2E_QUERIES,
                            "json_summary_folder": str(root / "json_tt"),
                            "skip": False},
        "maintenance_test": {
            "maintenance_report_base_path": str(root / "maintenance"),
            "maintenance_queries": "LF_SS,DF_SS",
            "json_summary_folder": str(root / "json_dm"), "skip": False},
        "metrics_report_path": str(root / "metrics.csv"),
    }


def _bench_cli(yml, *extra):
    return subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.cli.bench", str(yml),
         "--device", "cpu", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=600)


def test_bench_cli_crash_then_resume_end_to_end(tmp_path):
    """gen_data (base and two refresh sets), the Load Test to a lakehouse
    and gen_query_stream run, the crash at power_test kills the process;
    --resume skips those three and runs the Power Test, both Throughput
    Tests and both Maintenance Tests on the CPU to metrics.csv."""
    root = tmp_path / "bench"
    root.mkdir()
    params = _e2e_params(root)
    yml = tmp_path / "bench.yml"
    yml.write_text(yaml.safe_dump(params))
    r1 = _bench_cli(yml, "--fault_spec", "crash:power_test")
    assert r1.returncode != 0, r1.stdout[-2000:]
    assert "InjectedCrash" in r1.stderr, r1.stderr[-2000:]
    assert _state(root) == ["data_gen", "gen_streams", "load_test"]
    assert not (root / "metrics.csv").exists()
    assert (root / "raw_update2").is_dir()
    r2 = _bench_cli(yml, "--resume")
    assert r2.returncode == 0, (r2.stdout[-3000:], r2.stderr[-3000:])
    for phase in ("data_gen", "load_test", "gen_streams"):
        assert f"phase {phase}: skipped (checkpoint)" in r2.stdout
    assert r2.stdout.count("skipped (checkpoint)") == 3
    assert _state(root) == sorted(TFB.PHASES[:-1])
    got = dict(line.split(",", 1)
               for line in (root / "metrics.csv").read_text().splitlines())
    assert int(got["perf_metric"]) > 0
    # the JAX orchestrator over the port's report files, every phase
    # skipped: the same keys and values
    for section in ("data_gen", "load_test", "generate_query_stream",
                    "power_test", "throughput_test", "maintenance_test"):
        params[section]["skip"] = True
    params["metrics_report_path"] = str(tmp_path / "jax_metrics.csv")
    want = JFB.run_full_bench(params)
    assert got == {k: str(v) for k, v in want.items()}
    # and the JAX package's parsers and metric, one by one
    base = params["maintenance_test"]["maintenance_report_base_path"]
    times = (JFB.get_load_time(str(root / "load.txt")),
             JFB.get_power_time(str(root / "power.csv")),
             JFB.get_throughput_time(str(root / "throughput"), 3, 1),
             JFB.get_throughput_time(str(root / "throughput"), 3, 2),
             JFB.get_maintenance_time(base, 3, 1),
             JFB.get_maintenance_time(base, 3, 2))
    assert [float(got[k]) for k in ("Tload", "Tpower", "Ttt1", "Ttt2",
                                    "Tdm1", "Tdm2")] == list(times)
    assert int(got["perf_metric"]) == JFB.get_perf_metric(0.01, 1, *times)
    # every statement and refresh function Completed, on the CPU
    folders = {root / "json_power": E2E_QUERIES.split(","),
               root / "json_tt" / "stream_1": E2E_QUERIES.split(","),
               root / "json_tt" / "stream_2": E2E_QUERIES.split(","),
               root / "json_dm_1": ["LF_SS", "DF_SS"],
               root / "json_dm_2": ["LF_SS", "DF_SS"]}
    for folder, names in folders.items():
        summaries = [json.load(open(folder / f)) for f in os.listdir(folder)]
        assert sorted(s["query"] for s in summaries) == sorted(names)
        for s in summaries:
            assert s["queryStatus"] == ["Completed"], (folder, s["query"])
            assert s["env"]["engineConf"]["torch.device"] == "cpu"
