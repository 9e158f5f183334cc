"""The Throughput Test: S concurrent query streams — the port of
nds_tpu/throughput.py.

Counterpart of the reference's `nds-throughput` wrapper (reference:
nds/nds-throughput:18-23, `xargs -d ',' -P<S>` forking one spark-submit
Power Run per stream). In thread mode the streams run as concurrent
threads over independent Sessions in one process, each with its own
catalog, reports and time log; in process mode each stream is a Power Run
process of its own (`python -m nds_tpu_torch.cli.power`).

On one card the streams' sessions share its memory: each session's
catalog and working set hold to the lines it resolves
(NDS_CATALOG_BUDGET_BYTES and `engine.plan_budget_bytes` divide them
between the streams; tools/torch_throughput_phase.py sets both). Every
stream thread issues to the card's default stream, so the overlap is host
work: parquet decode and upload, planning, the watchdog.

Ttt = max(stream end) - min(stream start), rounded UP to 0.1 s
(reference: nds/nds_bench.py:138-157, Spec 7.4.7.4).
"""

from __future__ import annotations

import csv
import math
import os
import sys
import threading
import time

from .power import (
    gen_sql_from_stream,
    get_query_subset,
    load_properties,
    run_query_stream,
)
from .report import use_system_arrow_pool


def round_up_to_nearest_10_percent(num: float) -> float:
    return math.ceil(num * 10) / 10


class _GateBroken(RuntimeError):
    """A stream's start-gate rendezvous failed (a sibling stream errored)."""


class _StartGate:
    """Aligned-start rendezvous for concurrent streams.

    All streams park in wait() and share one release timestamp (the barrier
    action runs in exactly one thread at trip time). Failure semantics:

    - a sibling erroring during setup calls abort() -> every parked wait()
      raises _GateBroken (the run fails with the root cause);
    - a PURE timeout (some stream is slow but nothing errored) degrades to
      ungated per-stream starts: each wait() returns its own clock instead
      of failing the whole run, and says so on stderr.

    `timeout` defaults to the NDS_THROUGHPUT_GATE_TIMEOUT env knob
    (seconds, default 600)."""

    def __init__(self, n_streams: int, timeout: float = None):
        if timeout is None:
            timeout = float(
                os.environ.get("NDS_THROUGHPUT_GATE_TIMEOUT", "600")
            )
        self.timeout = timeout
        self._epoch = {}
        self._aborted = threading.Event()
        self._barrier = threading.Barrier(
            n_streams,
            action=lambda: self._epoch.__setitem__("t", time.time()),
        )

    def wait(self) -> float:
        try:
            self._barrier.wait(timeout=self.timeout)
        except threading.BrokenBarrierError:
            if self._aborted.is_set():
                raise _GateBroken(
                    "stream start gate broken: a sibling stream failed "
                    "during setup"
                ) from None
            # pure timeout: no error anywhere, so fall back to an ungated
            # start; Ttt loses its aligned-start guarantee, which the output
            # must make auditable
            print(
                f"throughput start gate timed out after {self.timeout:.0f}s;"
                f" falling back to ungated per-stream starts",
                file=sys.stderr,
            )
            return time.time()
        return self._epoch["t"]

    def abort(self):
        self._aborted.set()
        self._barrier.abort()  # release siblings still parked at the gate


def _read_start_end(time_log_path: str):
    start = end = None
    with open(time_log_path) as f:
        for row in csv.reader(f):
            if len(row) >= 3 and row[1] == "Power Start Time":
                start = float(row[2])
            if len(row) >= 3 and row[1] == "Power End Time":
                end = float(row[2])
    if start is None or end is None:
        raise ValueError(f"{time_log_path}: missing Power Start/End Time rows")
    return start, end


def run_throughput(
    input_prefix,
    stream_paths: dict,
    time_log_base: str,
    input_format="parquet",
    use_decimal=True,
    property_file=None,
    json_summary_folder=None,
    output_path=None,
    output_format="parquet",
    mode="thread",
    sub_queries=None,
    gate_timeout=None,
    query_timeout=None,
    device=None,
):
    """Run the streams in `stream_paths` ({stream_num: stream_file})
    concurrently; write `<time_log_base>_<n>.csv` per stream; return Ttt
    seconds (rounded up to 0.1 s).

    mode="thread" (default): streams are threads over independent Sessions
    in this process, each with its own JSON summary folder
    (`<json_summary_folder>/stream_<n>`) and output prefix
    (`<output_path>_<n>`). mode="process": one Power Run process per
    stream (the reference's `xargs -P` shape). `device` is every stream
    session's (None: the card); process mode passes it to each child as
    `--device`."""
    if mode == "process":
        return _run_throughput_processes(
            input_prefix, stream_paths, time_log_base, input_format,
            use_decimal, property_file, json_summary_folder, output_path,
            output_format, sub_queries, query_timeout, device,
        )
    errors = {}
    # All streams rendezvous after table setup, before their Power clocks
    # start (see _StartGate). A stream that errors before reaching the gate
    # aborts it for everyone rather than deadlocking the rest.
    gate = _StartGate(len(stream_paths), timeout=gate_timeout)
    # Arrow's process-wide pool is switched here, once, before any stream
    # thread runs: switching it while a sibling discovers a dataset crashed
    # the process (report.use_system_arrow_pool)
    use_system_arrow_pool()

    def one_stream(n, path):
        try:
            queries = gen_sql_from_stream(path)
            if sub_queries:
                queries = get_query_subset(queries, sub_queries)
            run_query_stream(
                input_prefix,
                property_file,
                queries,
                f"{time_log_base}_{n}.csv",
                input_format=input_format,
                use_decimal=use_decimal,
                # per-stream subfolder: the shared folder's emptiness check
                # would race between concurrent streams
                json_summary_folder=(
                    os.path.join(json_summary_folder, f"stream_{n}")
                    if json_summary_folder
                    else None
                ),
                output_path=(
                    f"{output_path}_{n}" if output_path else None
                ),
                output_format=output_format,
                start_gate=gate.wait,
                query_timeout=query_timeout,
                device=device,
            )
        except Exception as exc:
            errors[n] = exc
            gate.abort()

    threads = [
        threading.Thread(target=one_stream, args=(n, p), name=f"stream-{n}")
        for n, p in sorted(stream_paths.items())
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        # a pre-gate failure aborts the barrier, flooding every sibling
        # with gate-broken errors; report only the root cause(s) unless the
        # gate itself was the problem
        real = {
            n: e for n, e in errors.items() if not isinstance(e, _GateBroken)
        }
        raise RuntimeError(f"throughput streams failed: {real or errors}")
    return _ttt_from_logs(stream_paths, time_log_base)


def _ttt_from_logs(streams, time_log_base) -> float:
    """Ttt = max(stream end) - min(stream start), rounded up to 0.1 s.

    `streams` is any iterable of stream numbers. Floored at 0.1 s: the time
    log's int-second timestamps truncate a sub-second run to 0, and Ttt
    feeds the composite metric's denominator, where 0 would poison the
    score."""
    starts, ends = [], []
    for n in streams:
        s, e = _read_start_end(f"{time_log_base}_{n}.csv")
        starts.append(s)
        ends.append(e)
    return max(round_up_to_nearest_10_percent(max(ends) - min(starts)), 0.1)


def stream_wait_budget(query_timeout=None, n_queries: int = 103):
    """Per-child wall-clock budget (seconds) for process-mode streams, or
    None for unbounded. NDS_STREAM_TIMEOUT wins; else it derives from the
    per-query watchdog budget (NDS_QUERY_TIMEOUT) times a full stream's
    statement count plus setup slack: a child that blows through every
    per-query watchdog AND this outer budget is declared hung."""
    v = os.environ.get("NDS_STREAM_TIMEOUT")
    if v:
        return float(v) or None
    qt = query_timeout or os.environ.get("NDS_QUERY_TIMEOUT")
    if qt:
        return float(qt) * n_queries + 600
    return None


def _fold_child_streams(tracer, trace_dir, pre_existing, launches):
    """Fold the event files the child-stream processes wrote into the
    parent's own event log: one `child_stream` summary event per stream,
    plus a best-effort failure classification per stream (the parent only
    sees an exit code; the child's events say WHY it died). A child that
    rotated (engine.trace_rotate_bytes) leaves a SEGMENT CHAIN; discovery
    returns it in rotation order (obs.reader.segment_key) and the filter
    below preserves that order, so the summary and the classification
    read the child's whole stream in emission order.

    Attribution is by TRACE CONTEXT, not pid: each file's `trace_meta`
    line is verified against the stream's LAUNCH RECORD — the trace_id
    the parent minted and exported (NDS_TRACE_CONTEXT) when authoritative,
    else pid PLUS emission-time >= launch time. A recycled pid's leftover
    file from some long-dead process can no longer mis-blame this run's
    stream (the historical `-<pid>-` filename match trusted the pid
    alone). `launches` is {stream_num: {"pid", "ts_ms", "trace_id"}}.
    Returns {stream_num: failure_kind} for streams whose events record a
    failure."""
    from .obs import reader as obs_reader

    kinds = {}
    new = [
        f
        for f in obs_reader.discover_event_files(trace_dir)
        if f not in pre_existing
    ]
    metas = {f: obs_reader.trace_meta_of(f) for f in new}
    for n, rec in sorted(launches.items()):
        mine = [
            f for f in new
            if (
                obs_reader.meta_matches_launch(
                    metas[f], pid=rec.get("pid"),
                    launch_ts_ms=rec.get("ts_ms"),
                    trace_id=rec.get("trace_id"),
                )
                # a NEW file with an unreadable/missing meta line (child
                # killed before the eager meta landed, or its first line
                # torn): keep the OLD pid-filename evidence so an
                # instant death still yields its queries=0 marker — only
                # files whose meta READS and mismatches are rejected
                or (
                    metas[f] is None
                    and f"-{rec.get('pid')}-" in os.path.basename(f)
                )
            )
        ]
        if not mine:
            continue
        try:
            events = obs_reader.read_events(mine, strict=False)
        except OSError as exc:
            # observability must never take the benchmark down: an
            # unreadable child file still leaves a fold-in marker
            tracer.emit(
                "child_stream", stream=n,
                files=[os.path.basename(f) for f in mine],
                queries=0, completed=0, failed={}, failure_kinds=[],
                error=str(exc)[:200],
                child_trace_id=rec.get("trace_id"),
            )
            continue
        s = obs_reader.summarize_stream(events)
        tracer.emit(
            "child_stream",
            stream=n,
            files=[os.path.basename(f) for f in mine],
            queries=s["queries"],
            completed=s["completed"],
            failed=s["failed"],
            failure_kinds=s["failure_kinds"],
            child_trace_id=rec.get("trace_id"),
        )
        k = obs_reader.failure_kind_from_events(events)
        if k is not None:
            kinds[n] = k
    return kinds


def _run_throughput_processes(
    input_prefix, stream_paths, time_log_base, input_format, use_decimal,
    property_file, json_summary_folder, output_path, output_format,
    sub_queries=None, query_timeout=None, device=None,
):
    """One `nds_tpu_torch.cli.power` subprocess per stream, all concurrent,
    each logging to `<time_log_base>_<n>.out`. A child still running after
    stream_wait_budget is killed; a failed or killed child fails the run
    with its log's tail.

    With a trace directory each child writes its own event file under a
    trace context the parent minted for it (NDS_TRACE_CONTEXT); the parent
    folds per-stream summaries into its own event log afterwards and
    classifies a nonzero exit from the child's events."""
    import subprocess

    from .obs import reader as obs_reader
    from .obs import trace as obs_trace

    # resolve the trace dir as the children will (the property file's
    # conf tier, then the environment)
    conf = load_properties(property_file) if property_file else None
    trace_dir = obs_trace.resolve_trace_dir(conf)
    tracer = obs_trace.tracer_from_conf(conf)
    # the children's trace_ids parent to this context, so a folded log
    # reads as one run across the process boundary
    parent_ctx = (
        getattr(tracer, "context", None)
        or obs_trace.resolve_trace_context("throughput")
    )
    pre_existing = set(obs_reader.discover_event_files(trace_dir))
    procs = {}
    launches = {}  # stream -> {"pid", "ts_ms", "trace_id"} (fold-in key)
    failures = {}
    try:
        for n, path in sorted(stream_paths.items()):
            cmd = [
                sys.executable, "-m", "nds_tpu_torch.cli.power",
                input_prefix, path, f"{time_log_base}_{n}.csv",
                "--input_format", input_format,
                "--output_format", output_format,
            ]
            if not use_decimal:
                cmd.append("--floats")
            if property_file:
                cmd += ["--property_file", property_file]
            if query_timeout:
                cmd += ["--query_timeout", str(query_timeout)]
            if json_summary_folder:
                cmd += [
                    "--json_summary_folder",
                    os.path.join(json_summary_folder, f"stream_{n}"),
                ]
            if output_path:
                cmd += ["--output_prefix", f"{output_path}_{n}"]
            if sub_queries:
                cmd += ["--sub_queries", ",".join(sub_queries)]
            if device is not None:
                cmd += ["--device", str(device)]
            # each child logs to its own file: a shared PIPE read in turn
            # would block a chatty stream on pipe backpressure, stretching
            # its window and corrupting Ttt. An append-style live log, not a
            # parsed artifact: a torn final line is crash evidence, so no
            # atomic rename here
            # nds-lint: disable=atomic-write
            logf = open(f"{time_log_base}_{n}.out", "w")
            # per-child trace context: the child adopts this trace_id
            # (tracer_from_conf reads NDS_TRACE_CONTEXT), and the parent
            # folds its event files by it instead of by pid
            ctx = parent_ctx.child(f"stream{n}")
            env = ctx.export(dict(os.environ))
            try:
                p = subprocess.Popen(
                    cmd, stdout=logf, stderr=subprocess.STDOUT, env=env,
                )
            except BaseException:
                logf.close()
                raise
            procs[n] = (p, logf)
            launches[n] = {
                "pid": p.pid,
                "ts_ms": int(time.time() * 1000),
                "trace_id": ctx.trace_id,
            }
        budget = stream_wait_budget(
            query_timeout, len(sub_queries) if sub_queries else 103
        )
        for n, (p, logf) in procs.items():
            try:
                p.wait(timeout=budget)
            except subprocess.TimeoutExpired:
                # a hung child must not stall the whole Throughput Test
                p.kill()
                p.wait()
                failures[n] = (
                    f"stream {n} exceeded the {budget:.0f}s watchdog "
                    f"budget (NDS_STREAM_TIMEOUT / NDS_QUERY_TIMEOUT) "
                    f"and was killed"
                )
                continue
            finally:
                logf.close()
            if p.returncode != 0:
                with open(f"{time_log_base}_{n}.out") as f:
                    failures[n] = f.read()[-2000:]
    finally:
        # a Popen failure (or any error above) must not leak children or
        # their log handles
        for n, (p, logf) in procs.items():
            if p.poll() is None:
                p.kill()
                p.wait()
            logf.close()
    if tracer is not None:
        try:
            child_kinds = _fold_child_streams(
                tracer, trace_dir, pre_existing, launches
            )
            for n, kind in child_kinds.items():
                if n in failures:
                    failures[n] = (
                        f"[classified {kind} from the stream's event log] "
                        f"{failures[n]}"
                    )
        finally:
            tracer.close()
    if failures:
        raise RuntimeError(f"throughput stream processes failed: {failures}")
    return _ttt_from_logs(stream_paths, time_log_base)
