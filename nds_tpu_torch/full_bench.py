"""Whole-benchmark orchestrator of the port: the counterpart of
nds_tpu/full_bench.py (reference: nds/nds_bench.py).

Phase plan (reference: nds/nds_bench.py:34-42):
  0. data generation (+ per-stream --update refresh sets)   [not timed]
  1. Load Test (transcode)                    -> Tload, RNGSEED timestamp
  2. query stream generation (RNGSEED = load end timestamp, Spec 4.3.1)
  3. Power Test                               -> Tpower
  4. Throughput Test 1 (streams 1..S)         -> Ttt1
  5. Maintenance Test 1 (refresh sets 1..S)   -> Tdm1
  6. Throughput Test 2 (streams S+1..2S)      -> Ttt2
  7. Maintenance Test 2 (refresh sets S+1..)  -> Tdm2
  metric = int(SF * Sq*99 / (Tpt*Ttt*Tdm*Tld)^(1/4))   -> metrics.csv

Each phase shells out to its CLI of the port (`python -m
nds_tpu_torch.cli.*`, a process boundary like the reference's
subprocess.run of spark-submit) and state passes through report files on
disk, so any phase can be skipped and resumed from prior reports
(reference: nds_bench.py:367-497; skip semantics nds/README.md:499-503).
The device phases (power, throughput, maintenance and the under-load run)
run on the card unless `device` names another (`--device cpu`); the host
phases (gen_data, transcode, gen_query_stream) take no device. A
`json_summary_folder` in the power_test, throughput_test or
maintenance_test section (a key of the port's) gives each statement of
that phase a JSON summary (_summary_args).

Failure domain: the orchestrator checkpoints an atomically-written
`bench_state.json` after every completed phase, `--resume` derives the
skip set from it, classified-transient phase failures retry with a bounded
budget (NDS_PHASE_RETRIES), and every phase runner is a fault-injection
site (e.g. `crash:power_test` in NDS_FAULT_SPEC) so the resume path is
deterministically testable.

Tracing: with a trace directory (NDS_TRACE_DIR, else `engine.trace_dir`
in the power_test property file) the orchestrator writes `phase` begin /
end events, mints a trace context per phase that its subprocesses adopt
(NDS_TRACE_CONTEXT), and classifies an opaque phase failure (a
subprocess exit code) from the event files the phase's children wrote.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import yaml

from . import faults
from .io.fs import fs_open, fs_open_atomic, get_fs, is_remote
from .obs import reader as obs_reader
from .obs import trace as obs_trace
from .throughput import round_up_to_nearest_10_percent


def get_yaml_params(yaml_file):
    with open(yaml_file) as f:
        return yaml.safe_load(f)


# ---------------------------------------------------------------------------
# report-file parsers (state passes between phases on disk)
# ---------------------------------------------------------------------------


def get_load_end_timestamp(load_report_file):
    """RNGSEED for stream generation = load end timestamp (Spec 4.3.1);
    re-read from the load report (reference: nds_bench.py:60-74)."""
    with open(load_report_file) as f:
        for line in f:
            if "RNGSEED used" in line:
                return int(line.split(":")[1].strip())
    raise ValueError(
        f"RNGSEED not found in load report {load_report_file}; "
        "re-run the Load Test or fix the report path"
    )


def get_load_time(load_report_file):
    with open(load_report_file) as f:
        for line in f:
            if "Load Test Time" in line:
                return float(line.split(":")[1].strip().split(" ")[0])
    raise ValueError(f"Load Test Time not found in {load_report_file}")


def get_power_time(power_report_file):
    """Power Test elapsed seconds from the CSV time log (ms -> s, rounded
    up to 0.1 s; reference: nds_bench.py:92-104,207-208)."""
    import csv

    with open(power_report_file) as f:
        for row in csv.reader(f):
            if len(row) >= 3 and row[1] == "Power Test Time":
                return round_up_to_nearest_10_percent(float(row[2]) / 1000)
    raise ValueError(f"Power Test Time not found in {power_report_file}")


def get_refresh_time(maintenance_report_file):
    import csv

    with open(maintenance_report_file) as f:
        for row in csv.reader(f):
            if len(row) >= 2 and row[1] == "Data Maintenance Time":
                return float(row[2])
    raise ValueError(
        f"Data Maintenance Time not found in {maintenance_report_file}"
    )


def get_throughput_time(time_log_base, num_streams, first_or_second):
    from .throughput import _ttt_from_logs

    return _ttt_from_logs(
        get_stream_range(num_streams, first_or_second), time_log_base
    )


def get_maintenance_time(report_base, num_streams, first_or_second):
    tdm = 0.0
    for i in get_stream_range(num_streams, first_or_second):
        tdm += get_refresh_time(f"{report_base}_{i}.csv")
    return round_up_to_nearest_10_percent(tdm)


def get_stream_range(num_streams, first_or_second):
    """Streams of one Throughput Test. num_streams=9: test 1 -> [1..4],
    test 2 -> [5..8] (stream 0 is the Power stream;
    reference: nds_bench.py:126-135)."""
    if first_or_second == 1:
        return list(range(1, num_streams // 2 + 1))
    return list(range(num_streams // 2 + 1, num_streams))


def get_throughput_stream_nums(num_streams, first_or_second):
    return ",".join(str(x) for x in get_stream_range(num_streams, first_or_second))


# ---------------------------------------------------------------------------
# composite metric (reference: nds_bench.py:334-357)
# ---------------------------------------------------------------------------


def get_perf_metric(scale_factor, sq, tload, tpower, ttt1, ttt2, tdm1, tdm2):
    """int(SF * Q / (Tpt*Ttt*Tdm*Tld)^(1/4)), quantities in decimal hours;
    Q = Sq*99, Tld weighted 0.01*Sq (TPC-DS Spec 7.6.3)."""
    q = sq * 99
    tpt = (tpower * sq) / 3600
    ttt = (ttt1 + ttt2) / 3600
    tdm = (tdm1 + tdm2) / 3600
    tld = (0.01 * sq * tload) / 3600
    # reference truncates SF to int (nds_bench.py:356); float() keeps
    # fractional smoke scales (SF<1) from collapsing the metric to 0 and is
    # identical for the integral SFs the spec defines
    return int(float(scale_factor) * q / (tpt * ttt * tdm * tld) ** (1 / 4))


def write_metrics_report(report_path, metrics_map):
    with fs_open_atomic(report_path, "w") as f:
        for key, value in metrics_map.items():
            f.write(f"{key},{value}\n")


# ---------------------------------------------------------------------------
# checkpoint state (crash-safe resume without manual `skip:` editing)
# ---------------------------------------------------------------------------

#: orchestrator phase order; bench_state.json records completion per name.
#: maintenance_under_load is OPT-IN (params `maintenance_under_load:
#: enabled: true`) and sits after the timed TPC phases so its racing
#: commits/vacuum can never perturb the composite metric's inputs.
PHASES = (
    "data_gen",
    "load_test",
    "gen_streams",
    "power_test",
    "throughput_test_1",
    "maintenance_test_1",
    "throughput_test_2",
    "maintenance_test_2",
    "maintenance_under_load",
)


def params_fingerprint(params) -> str:
    """Stable digest of the bench config: a resume against a different
    config would silently mix phase outputs from two benchmarks."""
    blob = json.dumps(params, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def bench_state_path(params) -> str:
    explicit = params.get("bench_state_path")
    if explicit:
        return str(explicit)
    base = os.path.dirname(str(params.get("metrics_report_path", "")))
    return os.path.join(base, "bench_state.json") if base else "bench_state.json"


class BenchState:
    """Phase-completion checkpoint, atomically rewritten after every phase
    so the on-disk file is always a complete, parseable snapshot."""

    def __init__(self, path: str, fingerprint: str, phases=None):
        self.path = path
        self.fingerprint = fingerprint
        self.phases = dict(phases or {})  # name -> {"completed_at_ms": int}

    @classmethod
    def fresh(cls, params) -> "BenchState":
        return cls(bench_state_path(params), params_fingerprint(params))

    @classmethod
    def load(cls, params) -> "BenchState":
        """Resume state from disk; a missing file resumes from nothing
        (equivalent to a fresh run), a config mismatch is a loud error."""
        path = bench_state_path(params)
        fp = params_fingerprint(params)
        # the state file may live on remote storage (it sits next to the
        # metrics report) — route existence + read through the fs seam
        if is_remote(path):
            fs, p = get_fs(path)
            exists = fs.exists(p)
        else:
            exists = os.path.exists(path)
        if not exists:
            print(f"resume: no checkpoint at {path}; starting fresh")
            return cls(path, fp)
        with fs_open(path) as f:
            raw = json.load(f)
        if raw.get("params_fingerprint") != fp:
            raise ValueError(
                f"resume: checkpoint {path} was written by a different "
                f"bench config (fingerprint {raw.get('params_fingerprint')} "
                f"!= {fp}); delete it or fix the config"
            )
        done = sorted(raw.get("phases", {}))
        print(f"resume: checkpoint {path} has completed phases: {done}")
        return cls(path, fp, raw.get("phases"))

    def is_done(self, phase: str) -> bool:
        return phase in self.phases

    def mark_done(self, phase: str):
        self.phases[phase] = {"completed_at_ms": int(time.time() * 1000)}
        self._write()

    def _write(self):
        with fs_open_atomic(self.path, "w") as f:
            json.dump(
                {
                    "params_fingerprint": self.fingerprint,
                    "phases": self.phases,
                },
                f,
                indent=2,
            )


# ---------------------------------------------------------------------------
# phase runners (each a process boundary, like the reference's spark-submit)
# ---------------------------------------------------------------------------


def _run(cmd):
    print("====== " + " ".join(str(c) for c in cmd) + " ======", flush=True)
    subprocess.run([str(c) for c in cmd], check=True)


def _device_args(device):
    """`--device <dev>` for a device phase when the caller names one; with
    none named, the CLI's own default (the card) holds."""
    return ["--device", device] if device else []


def _summary_args(folder, subdirs=()):
    """`--json_summary_folder <folder>` where a device phase's section names
    `json_summary_folder`, a key of the port's: each statement's status,
    retries and device land in a JSON summary (the reference reads them
    from its trace directory, which the port writes too). The phase's
    summary directories (its `subdirs` of the folder, else the folder) are
    emptied before each attempt, as the CLIs overwrite their time logs."""
    if not folder:
        return []
    for d in [os.path.join(folder, d) for d in subdirs] or [folder]:
        shutil.rmtree(d, ignore_errors=True)
    return ["--json_summary_folder", folder]


def run_data_gen(params, num_streams):
    cfg = params["data_gen"]

    def gen(data_dir, extra):
        _run([
            sys.executable, "-m", "nds_tpu_torch.cli.gen_data", "local",
            "--scale", cfg["scale_factor"],
            "--parallel", cfg["parallel"],
            "--data_dir", data_dir,
            "--overwrite_output",
        ] + extra)

    gen(cfg["raw_data_path"], [])
    # one refresh set per non-power stream (maintenance phases consume them)
    for i in range(1, num_streams):
        gen(cfg["raw_data_path"] + f"_update{i}", ["--update", i])


def run_load_test(params):
    cfg = params["load_test"]
    cmd = [
        sys.executable, "-m", "nds_tpu_torch.cli.transcode",
        params["data_gen"]["raw_data_path"],
        cfg["output_path"],
        cfg["report_path"],
        "--output_format", cfg.get("warehouse_format", "lakehouse"),
        "--output_mode", "overwrite",
    ]
    _run(cmd)


def gen_streams(params, num_streams, rngseed):
    cfg = params["generate_query_stream"]
    cmd = [
        sys.executable, "-m", "nds_tpu_torch.cli.gen_query_stream",
        "--output_dir", cfg["stream_output_path"],
        "--streams", num_streams,
        "--scale", params["data_gen"]["scale_factor"],
        "--rngseed", rngseed,
    ]
    if cfg.get("query_template_dir"):
        cmd += ["--template_dir", cfg["query_template_dir"]]
    _run(cmd)


def power_test(params, device=None):
    cfg = params["power_test"]
    stream_dir = params["generate_query_stream"]["stream_output_path"]
    cmd = [
        sys.executable, "-m", "nds_tpu_torch.cli.power",
        params["load_test"]["output_path"],
        os.path.join(stream_dir, "query_0.sql"),
        cfg["report_path"],
        "--input_format", params["load_test"].get("warehouse_format", "lakehouse"),
    ]
    if cfg.get("property_path"):
        cmd += ["--property_file", cfg["property_path"]]
    if cfg.get("output_path"):
        cmd += ["--output_prefix", cfg["output_path"]]
    if cfg.get("sub_queries"):
        cmd += ["--sub_queries", cfg["sub_queries"]]
    _run(cmd + _summary_args(cfg.get("json_summary_folder"))
         + _device_args(device))


def throughput_test(params, num_streams, first_or_second, device=None):
    cfg = params["throughput_test"]
    stream_dir = params["generate_query_stream"]["stream_output_path"]
    cmd = [
        sys.executable, "-m", "nds_tpu_torch.cli.throughput",
        params["load_test"]["output_path"],
        stream_dir,
        get_throughput_stream_nums(num_streams, first_or_second),
        cfg["report_base_path"],
        "--input_format", params["load_test"].get("warehouse_format", "lakehouse"),
    ]
    if cfg.get("mode"):
        cmd += ["--mode", cfg["mode"]]
    if cfg.get("sub_queries"):
        cmd += ["--sub_queries", cfg["sub_queries"]]
    # the CLI writes each stream's summaries to <folder>/stream_<n>
    _run(cmd + _summary_args(cfg.get("json_summary_folder"), [
        f"stream_{n}" for n in get_stream_range(num_streams, first_or_second)
    ]) + _device_args(device))


def maintenance_test(params, num_streams, first_or_second, device=None):
    cfg = params["maintenance_test"]
    for i in get_stream_range(num_streams, first_or_second):
        refresh_dir = params["data_gen"]["raw_data_path"] + f"_update{i}"
        cmd = [
            sys.executable, "-m", "nds_tpu_torch.cli.maintenance",
            params["load_test"]["output_path"],
            refresh_dir,
            cfg["maintenance_report_base_path"] + f"_{i}.csv",
        ]
        if cfg.get("maintenance_queries"):
            cmd += ["--maintenance_queries", cfg["maintenance_queries"]]
        folder = cfg.get("json_summary_folder")
        # one folder per refresh set: <folder>_<i>
        _run(cmd + _summary_args(folder and f"{folder}_{i}")
             + _device_args(device))


def maintenance_under_load_test(params, num_streams, device=None):
    """Opt-in robustness phase: re-run stream 1's queries while the first
    refresh set's DM_* functions (and a lease-respecting vacuum) commit
    against the same warehouse — maintenance throughput x query p99
    degradation (cli.maintenance --under_load_stream). Re-applying update
    set 1 is safe: inserts append new snapshots, deletes ride ranged
    predicates, and the phase runs after every timed TPC phase."""
    cfg = params.get("maintenance_under_load") or {}
    dm_cfg = params["maintenance_test"]
    stream_dir = params["generate_query_stream"]["stream_output_path"]
    report_base = dm_cfg["maintenance_report_base_path"]
    cmd = [
        sys.executable, "-m", "nds_tpu_torch.cli.maintenance",
        params["load_test"]["output_path"],
        params["data_gen"]["raw_data_path"] + "_update1",
        report_base + "_under_load.csv",
        "--under_load_stream", os.path.join(stream_dir, "query_1.sql"),
        "--under_load_report",
        cfg.get("report_path") or report_base + "_under_load.json",
    ]
    if cfg.get("maintenance_queries") or dm_cfg.get("maintenance_queries"):
        cmd += [
            "--maintenance_queries",
            cfg.get("maintenance_queries")
            or dm_cfg.get("maintenance_queries"),
        ]
    if cfg.get("sub_queries"):
        cmd += ["--under_load_queries", cfg["sub_queries"]]
    _run(cmd + _device_args(device))


# ---------------------------------------------------------------------------
# phase execution with checkpointing + classified bounded retries
# ---------------------------------------------------------------------------


class PhaseError(RuntimeError):
    """A benchmark phase failed terminally (retry budget exhausted or the
    failure classified as deterministic)."""

    def __init__(self, phase, kind, attempts, cause):
        super().__init__(
            f"phase {phase} failed ({kind}) after {attempts} attempt(s): "
            f"{cause}"
        )
        self.phase = phase
        self.kind = kind


def _bench_trace_conf(params):
    """Engine conf for trace-dir resolution: the power_test property file
    is the one phase config that carries engine.* keys (env NDS_TRACE_DIR
    wins either way)."""
    prop = (params.get("power_test") or {}).get("property_path")
    if not prop:
        return None
    try:
        from .power import load_properties

        return load_properties(prop)
    except OSError:
        return None


def _phase_failure_kind(exc, trace_dir, pre_existing, launch=None) -> str:
    """Classify a phase failure; when the exception itself is opaque (a
    subprocess CalledProcessError carries only the exit code) fall back to
    the event files the phase's child processes wrote before dying.

    `launch` is the phase's launch record ({"trace_id", "ts_ms"}): a
    candidate file's `trace_meta` must belong to this phase's context (its
    trace_id, or a child parented to it) or at least postdate the launch,
    so a leftover file of an unrelated process is never blamed."""
    kind = faults.classify(exc)
    if kind != faults.UNKNOWN or not trace_dir:
        return kind
    new = [
        f
        for f in obs_reader.discover_event_files(trace_dir)
        if f not in pre_existing
    ]
    if launch:
        verified = []
        for f in new:
            meta = obs_reader.trace_meta_of(f)
            if meta is None:
                continue
            tid = launch.get("trace_id")
            if tid and meta.get("trace_id") is not None:
                if meta["trace_id"] == tid or meta.get("parent") == tid:
                    verified.append(f)
                continue
            if obs_reader.meta_matches_launch(
                meta, launch_ts_ms=launch.get("ts_ms")
            ):
                verified.append(f)
        new = verified
    if not new:
        return kind
    from_events = obs_reader.failure_kind_from_files(new)
    return from_events or kind


def _run_phase(state: BenchState, name: str, skip, fn, tracer=None,
               trace_dir=None):
    """Run one phase with checkpointing and bounded transient retries.

    Phase CLIs are rerun-idempotent (they overwrite their outputs), so a
    classified-transient failure retries up to NDS_PHASE_RETRIES times
    with backoff. Deterministic failures raise immediately; an
    unclassifiable subprocess exit is first re-classified from the event
    files its children wrote (NDS_TRACE_DIR), so a child that died on
    transient IO retries while a planner bug fails fast
    (NDS_PHASE_RETRY_UNKNOWN=1 opts opaque exits into retries). An
    injected crash (BaseException) sails through: the process dies with
    the checkpoint recording every phase completed before it."""
    if skip or state.is_done(name):
        why = "config" if skip else "checkpoint"
        print(f"====== phase {name}: skipped ({why}) ======", flush=True)
        if tracer is not None:
            tracer.emit("phase", phase=name, event="end", status="skipped",
                        reason=why)
        return
    retries = int(os.environ.get("NDS_PHASE_RETRIES", "1"))
    retry_unknown = os.environ.get("NDS_PHASE_RETRY_UNKNOWN") == "1"
    base = float(os.environ.get("NDS_PHASE_BACKOFF", "1.0"))
    delays = faults.backoff_delays(retries, base)
    if trace_dir is None:
        trace_dir = obs_trace.resolve_trace_dir()
    # per-phase trace context: a child of the orchestrator's, exported
    # through the environment so that every subprocess of the phase adopts
    # or parents to it; the failure classifier then verifies candidate
    # event files against this launch record. Phases run one at a time,
    # so the environment change races no sibling.
    parent_ctx = (
        getattr(tracer, "context", None)
        or obs_trace.resolve_trace_context("full_bench")
    )
    phase_ctx = parent_ctx.child(name)
    prev_env_ctx = os.environ.get(obs_trace.TRACE_CONTEXT_ENV)
    os.environ[obs_trace.TRACE_CONTEXT_ENV] = phase_ctx.to_env_value()
    attempt = 0
    t0 = time.perf_counter()
    if tracer is not None:
        # index / total let the live /statusz phase view render progress
        idx = PHASES.index(name) + 1 if name in PHASES else None
        tracer.emit(
            "phase", phase=name, event="begin",
            **({"index": idx, "total": len(PHASES)} if idx else {}),
        )
    try:
        while True:
            attempt += 1
            launch = {
                "trace_id": phase_ctx.trace_id,
                "ts_ms": int(time.time() * 1000),
            }
            pre_existing = set(obs_reader.discover_event_files(trace_dir))
            try:
                faults.maybe_fire(name)
                fn()
                break
            except Exception as exc:
                kind = _phase_failure_kind(
                    exc, trace_dir, pre_existing, launch=launch
                )
                transient = kind in faults.RETRYABLE or (
                    kind == faults.UNKNOWN and retry_unknown
                )
                delay = next(delays, None) if transient else None
                if delay is None:
                    if tracer is not None:
                        tracer.emit(
                            "phase", phase=name, event="end", status="failed",
                            failure_kind=kind, attempts=attempt,
                            dur_ms=round(
                                (time.perf_counter() - t0) * 1000, 3
                            ),
                        )
                    raise PhaseError(name, kind, attempt, exc) from exc
                print(
                    f"====== phase {name}: attempt {attempt} failed "
                    f"({kind}: {exc}); retrying in {delay:.1f}s ======",
                    flush=True,
                )
                time.sleep(delay)
    finally:
        # restore the orchestrator-level context for the next phase
        if prev_env_ctx is None:
            os.environ.pop(obs_trace.TRACE_CONTEXT_ENV, None)
        else:
            os.environ[obs_trace.TRACE_CONTEXT_ENV] = prev_env_ctx
    if tracer is not None:
        tracer.emit(
            "phase", phase=name, event="end", status="ok", attempts=attempt,
            dur_ms=round((time.perf_counter() - t0) * 1000, 3),
        )
    state.mark_done(name)


def run_full_bench(params, resume: bool = False, device=None):
    """Run the benchmark's phases and return (and write) the metrics map.
    `device` goes to the device phases' CLIs as `--device`; None leaves
    them on the card."""
    num_streams = params["generate_query_stream"]["num_streams"]
    if num_streams % 2 == 0 or num_streams < 3:
        raise ValueError(
            f"num_streams must be odd and >= 3 (power stream + 2 equal "
            f"non-empty throughput sets; Spec 4.3.2 wants 2*S+1, S>=4), "
            f"got {num_streams}"
        )
    faults.install_from_env()  # arm orchestrator-level injection sites
    # orchestrator event log: per-phase begin / end events, orchestrator-
    # level fault injections through the thread-local binding, and the
    # trace dir the phase-failure classifier scans for child event files
    # (NDS_TRACE_DIR, else engine.trace_dir of the power_test property
    # file); subprocesses inherit the environment and write their own
    trace_conf = _bench_trace_conf(params)
    tracer = obs_trace.tracer_from_conf(trace_conf)
    trace_dir = obs_trace.resolve_trace_dir(trace_conf)
    try:
        with obs_trace.bind(tracer):
            return _run_full_bench_phases(
                params, resume, num_streams, device, tracer, trace_dir
            )
    finally:
        if tracer is not None:
            tracer.close()


def _run_full_bench_phases(params, resume, num_streams, device, tracer,
                           trace_dir):
    state = BenchState.load(params) if resume else BenchState.fresh(params)
    sq = num_streams // 2  # streams per Throughput Test
    # the device phases' runners get `device` only when one is named
    dev = {"device": device} if device else {}
    tr = {"tracer": tracer, "trace_dir": trace_dir}
    _run_phase(
        state, "data_gen", params["data_gen"].get("skip"),
        lambda: run_data_gen(params, num_streams), **tr,
    )
    _run_phase(
        state, "load_test", params["load_test"].get("skip"),
        lambda: run_load_test(params), **tr,
    )
    load_report = params["load_test"]["report_path"]
    tload = get_load_time(load_report)
    _run_phase(
        state, "gen_streams", params["generate_query_stream"].get("skip"),
        lambda: gen_streams(
            params, num_streams, get_load_end_timestamp(load_report)
        ),
        **tr,
    )
    _run_phase(
        state, "power_test", params["power_test"].get("skip"),
        lambda: power_test(params, **dev), **tr,
    )
    tpower = get_power_time(params["power_test"]["report_path"])
    tt_cfg = params["throughput_test"]
    dm_cfg = params["maintenance_test"]
    _run_phase(
        state, "throughput_test_1", tt_cfg.get("skip"),
        lambda: throughput_test(params, num_streams, 1, **dev), **tr,
    )
    ttt1 = get_throughput_time(tt_cfg["report_base_path"], num_streams, 1)
    _run_phase(
        state, "maintenance_test_1", dm_cfg.get("skip"),
        lambda: maintenance_test(params, num_streams, 1, **dev), **tr,
    )
    tdm1 = get_maintenance_time(
        dm_cfg["maintenance_report_base_path"], num_streams, 1
    )
    _run_phase(
        state, "throughput_test_2", tt_cfg.get("skip"),
        lambda: throughput_test(params, num_streams, 2, **dev), **tr,
    )
    ttt2 = get_throughput_time(tt_cfg["report_base_path"], num_streams, 2)
    _run_phase(
        state, "maintenance_test_2", dm_cfg.get("skip"),
        lambda: maintenance_test(params, num_streams, 2, **dev), **tr,
    )
    tdm2 = get_maintenance_time(
        dm_cfg["maintenance_report_base_path"], num_streams, 2
    )
    # opt-in (off by default): maintenance-under-load runs only when the
    # config section explicitly enables it, and after every timed phase.
    # FAIL-SOFT: it is a diagnostics phase — its failure must not cost
    # the composite metric every timed phase already earned.
    mul_cfg = params.get("maintenance_under_load") or {}
    mul_error = None
    try:
        _run_phase(
            state, "maintenance_under_load", not mul_cfg.get("enabled"),
            lambda: maintenance_under_load_test(params, num_streams, **dev),
            **tr,
        )
    except PhaseError as exc:
        mul_error = str(exc)
        print(f"====== maintenance_under_load failed (metric unaffected): "
              f"{exc} ======", flush=True)
    metric = get_perf_metric(
        params["data_gen"]["scale_factor"], sq,
        tload, tpower, ttt1, ttt2, tdm1, tdm2,
    )
    metrics = {
        "scale_factor": params["data_gen"]["scale_factor"],
        "num_streams": num_streams,
        "Tload": tload,
        "Tpower": tpower,
        "Ttt1": ttt1,
        "Ttt2": ttt2,
        "Tdm1": tdm1,
        "Tdm2": tdm2,
        "perf_metric": metric,
    }
    if mul_error:
        metrics["maintenance_under_load_error"] = mul_error
    # budgeter-accuracy headline beside the composite metric, from the
    # trace directory's plan_feedback events: the trace dir aggregates
    # every phase subprocess's events (fail-soft: a torn trace file must
    # not cost a finished benchmark). With feedback off no event carries
    # them, and both keys stay None.
    if trace_dir:
        errs = []

        def _collect(events):
            errs.extend(
                float(e["abs_log_err"]) for e in events
                if e.get("kind") == "plan_feedback"
                and e.get("abs_log_err") is not None
            )

        try:
            prof = obs_reader.load_profile(
                [trace_dir], strict=False, events_hook=_collect
            )
            rate = obs_reader.feedback_hit_rate(prof)
            metrics["feedback_hit_rate"] = (
                None if rate is None else round(rate, 4)
            )
            errs.sort()
            metrics["budget_err_median"] = (
                round(errs[len(errs) // 2], 4) if errs else None
            )
        except Exception:
            metrics["feedback_hit_rate"] = None
            metrics["budget_err_median"] = None
    print(metrics)
    write_metrics_report(params["metrics_report_path"], metrics)
    return metrics
