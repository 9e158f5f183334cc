"""Event-log reading + aggregation: the analysis half of the obs subsystem.

Consumed by `cli/profile.py` (operator breakdowns, A/B compare),
by the throughput parent (fold-in + failure classification of child-stream
event files), and by full_bench (classifying a subprocess phase failure
from the events the child wrote before dying — the parent only sees an
exit code, closing the ROADMAP gap).
"""

from __future__ import annotations

import glob
import json
import os
import re

from .. import faults
from .trace import EVENT_SCHEMA

#: injected-fault kind -> failure-taxonomy kind (faults.classify vocabulary)
_FAULT_KIND_MAP = {
    "oom": faults.DEVICE_OOM,
    "hostoom": faults.HOST_OOM,
    "io": faults.IO_TRANSIENT,
    "hang": faults.TIMEOUT,
    "crash": faults.UNKNOWN,  # simulated process death: nothing retryable
}


class MalformedEventError(ValueError):
    """An event line that is not valid JSON (other than a torn final line,
    which a crash legitimately leaves behind and readers skip)."""


#: events-<app>.jsonl (segment 0) or events-<app>.<seq>.jsonl (rotation
#: segments, Tracer._segment_path). Non-greedy app so a numeric suffix
#: parses as the seq, not the app tail.
_SEGMENT_RE = re.compile(r"^events-(?P<app>.+?)(?:\.(?P<seq>\d+))?\.jsonl$")


def segment_key(path) -> tuple:
    """(app id, rotation seq) of one event file — the chain-reassembly
    sort key. Segment 0 is the un-suffixed classic name; rotation
    segments carry a numeric seq. Unrecognized names sort by basename
    with seq 0 (never rejected: discovery must stay tolerant)."""
    base = os.path.basename(str(path))
    m = _SEGMENT_RE.match(base)
    if not m:
        return (base, 0)
    return (m.group("app"), int(m.group("seq") or 0))


def discover_event_files(trace_dir) -> list:
    """All event logs under a trace dir, ordered by (app id, rotation
    seq) so each app's segment chain reads back in emission order (plain
    name sort would put `events-a.0001.jsonl` BEFORE `events-a.jsonl`)."""
    if not trace_dir:
        return []
    return sorted(
        glob.glob(os.path.join(str(trace_dir), "events-*.jsonl")),
        key=segment_key,
    )


def iter_events(path, strict: bool = True):
    """Yield events from one JSONL file.

    A torn FINAL line (no trailing newline — the single-write+flush
    contract means only a crash mid-write can produce one) is skipped in
    both modes; with rotation this classification is deliberately
    PER-SEGMENT, so a crash that tore the final line of what later became
    a non-final segment of its chain still reads as crash evidence, not
    corruption. Any other malformed line raises MalformedEventError when
    `strict`, else is skipped."""
    with open(path, encoding="utf-8") as f:
        raw = f.read()
    lines = raw.split("\n")
    tail = None
    if not raw.endswith("\n") and lines:
        tail = lines.pop()  # candidate torn final line
    for i, line in enumerate(lines):
        if not line:
            continue
        try:
            yield json.loads(line)
        except json.JSONDecodeError:
            if strict:
                raise MalformedEventError(
                    f"{path}:{i + 1}: malformed event line: {line[:120]!r}"
                )
    if tail:
        try:
            yield json.loads(tail)
        except json.JSONDecodeError:
            pass  # torn final line: tolerated evidence of a crash


def trace_meta_of(path):
    """The first `trace_meta` event of one event file (tolerant: None on
    an unreadable/torn/foreign file). The fold-in attribution key: every
    segment opens with its producing process's meta line carrying pid,
    emission epoch (`ts`) and — since the trace-context work — the
    `trace_id` the launcher minted for that process."""
    try:
        for ev in iter_events(path, strict=False):
            if ev.get("kind") == "trace_meta":
                return ev
            return None  # contract: meta is the FIRST line
    except OSError:
        return None
    return None


#: slack (ms) for launch-time matching: the child stamps its meta after
#: interpreter start, but clocks may disagree slightly across a remote fs
LAUNCH_TS_SLACK_MS = 5000


def meta_matches_launch(meta, pid=None, launch_ts_ms=None,
                        trace_id=None) -> bool:
    """Does one event file's trace_meta belong to the child a launcher
    recorded? The minted trace_id is authoritative when both sides carry
    one (immune to pid recycling); otherwise fall back to pid PLUS an
    emission-time check against the launch record — a recycled pid's
    leftover file from a long-dead child predates this launch and is
    rejected instead of mis-blamed."""
    if meta is None:
        return False
    if trace_id is not None and meta.get("trace_id") is not None:
        return meta["trace_id"] == trace_id
    if pid is not None and meta.get("pid") != pid:
        return False
    if launch_ts_ms is not None:
        ts = meta.get("ts")
        if ts is None or int(ts) < int(launch_ts_ms) - LAUNCH_TS_SLACK_MS:
            return False
    return pid is not None or launch_ts_ms is not None


def read_events(paths, strict: bool = True) -> list:
    """Events from one path or a list of paths (files or trace dirs),
    concatenated in file order."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    files = []
    for p in paths:
        p = str(p)
        if os.path.isdir(p):
            files.extend(discover_event_files(p))
        else:
            files.append(p)
    out = []
    for f in files:
        out.extend(iter_events(f, strict=strict))
    return out


def validate_events(events) -> list:
    """Schema problems as strings (empty == clean): unknown kinds and
    missing per-kind required fields (EVENT_SCHEMA is the contract)."""
    problems = []
    for i, ev in enumerate(events):
        kind = ev.get("kind")
        if kind is None or "ts" not in ev or "app" not in ev:
            problems.append(f"event {i}: missing ts/kind/app: {ev}")
            continue
        req = EVENT_SCHEMA.get(kind)
        if req is None:
            problems.append(f"event {i}: unknown kind {kind!r}")
            continue
        missing = [f for f in req if f not in ev]
        if missing:
            problems.append(f"event {i} ({kind}): missing fields {missing}")
    return problems


# ---------------------------------------------------------------------------
# stream summaries + failure classification (fold-in consumers)
# ---------------------------------------------------------------------------


def summarize_stream(events) -> dict:
    """Roll one (child) stream's events up for the parent's fold-in event:
    query statuses, failure kinds, and tallies the profiler also reports."""
    queries = {}
    for ev in events:
        if ev.get("kind") == "query_span":
            queries[ev.get("query")] = {
                "status": ev.get("status"),
                "failure_kind": ev.get("failure_kind"),
            }
    failed = {
        q: (v["failure_kind"] or faults.UNKNOWN)
        for q, v in queries.items()
        if v["status"] == "Failed"
    }
    return {
        "queries": len(queries),
        "completed": sum(
            1 for v in queries.values() if v["status"] != "Failed"
        ),
        "failed": failed,
        "failure_kinds": sorted(set(failed.values())),
    }


def failure_kind_from_events(events):
    """Best-effort failure classification from a stream's event log, for a
    parent that only saw a nonzero exit code: the last Failed query_span's
    kind wins (a recorded failure is the strongest evidence); only when NO
    query failed does the last injected fault's mapped kind stand in (e.g.
    a crash rule that killed the process before any span was written)."""
    failed_kind = None
    fault_kind = None
    for ev in events:
        k = ev.get("kind")
        if k == "query_span" and ev.get("status") == "Failed":
            failed_kind = ev.get("failure_kind") or faults.UNKNOWN
        elif k == "fault_injected":
            fault_kind = _FAULT_KIND_MAP.get(
                ev.get("fault_kind"), faults.UNKNOWN
            )
    return failed_kind or fault_kind


def failure_kind_from_files(paths):
    try:
        return failure_kind_from_events(read_events(paths, strict=False))
    except OSError:
        return None


# ---------------------------------------------------------------------------
# operator-level aggregation (the profiler's core)
# ---------------------------------------------------------------------------


def op_spans_with_exclusive(events) -> list:
    """op_span events with an `excl_ms` field added.

    Spans are emitted in completion (post-) order with `depth` and a
    per-executor `seq`; within one (app, query, exec_id) group a child
    completes before its parent, so exclusive time falls out of one pass:
    excl(parent at depth d) = incl - sum(incl of direct children at d+1)."""
    groups = {}
    for ev in events:
        if ev.get("kind") != "op_span":
            continue
        key = (ev.get("app"), ev.get("query"), ev.get("exec_id"))
        groups.setdefault(key, []).append(ev)
    out = []
    for spans in groups.values():
        spans.sort(key=lambda e: e.get("seq", 0))
        acc = {}  # depth -> accumulated child inclusive ms awaiting a parent
        for ev in spans:
            d = ev.get("depth", 0)
            incl = float(ev.get("dur_ms") or 0.0)
            excl = max(incl - acc.pop(d + 1, 0.0), 0.0)
            acc[d] = acc.get(d, 0.0) + incl
            ev = dict(ev)
            ev["excl_ms"] = excl
            out.append(ev)
    return out


_EMPTY_QUERY = {
    "wall_ms": None, "status": None, "runs": 0, "ops": {},
    "root_incl_ms": 0.0,
}


def profile_events(events) -> dict:
    """The aggregate the profiler renders: per-query wall/status/memory and
    per-operator breakdowns, run-wide operator totals, and tallies.

    Multi-stream semantics: profiling several streams' files together (a
    throughput run's trace dir) keys by query NAME and SUMS across streams
    — wall_ms is the total across the query's `runs` query_spans, operator
    times sum the same way (so plan time stays bounded by wall time), any
    Failed run marks the query Failed, and memory high-water is the max."""
    spans = op_spans_with_exclusive(events)
    queries = {}
    op_totals = {}
    # per-kernel dispatch totals (kernel_span events, kernel tracing mode):
    # the "which KERNEL under the hot operator" answer op_spans cannot give
    kernel_totals = {}
    for ev in spans:
        q = ev.get("query") or "<unscoped>"
        node = ev.get("node", "?")
        qrec = queries.setdefault(q, dict(_EMPTY_QUERY, ops={}))
        op = qrec["ops"].setdefault(
            node, {"count": 0, "incl_ms": 0.0, "excl_ms": 0.0, "rows": 0}
        )
        op["count"] += 1
        op["incl_ms"] += float(ev.get("dur_ms") or 0.0)
        op["excl_ms"] += ev["excl_ms"]
        if ev.get("rows") is not None:
            op["rows"] += int(ev["rows"])
        if ev.get("depth", 0) == 0:
            qrec["root_incl_ms"] += float(ev.get("dur_ms") or 0.0)
        tot = op_totals.setdefault(
            node, {"count": 0, "incl_ms": 0.0, "excl_ms": 0.0, "rows": 0}
        )
        tot["count"] += 1
        tot["incl_ms"] += float(ev.get("dur_ms") or 0.0)
        tot["excl_ms"] += ev["excl_ms"]
        if ev.get("rows") is not None:
            tot["rows"] += int(ev["rows"])
    tallies = {
        "plan_cache_hits": 0,
        "plan_cache_misses": 0,
        "catalog_loads": 0,
        "catalog_cache_hits": 0,
        "io_retries": 0,
        "ladder_rungs": 0,
        "watchdog_fires": 0,
        "faults_injected": 0,
        "blocked_union_windows": 0,
        "spill_ops": 0,
        "spill_bytes_in": 0,
        "spill_bytes_out": 0,
        "spill_evictions": 0,
        "exchange_ops": 0,
        "exchange_bytes": 0,
        "exchange_retries": 0,
        "exchange_max_skew": 0.0,
        "mesh_fallbacks": 0,
        "lake_commits": 0,
        "lake_commit_rebases": 0,
        "lake_commit_conflicts": 0,
        "lake_vacuums": 0,
        "lake_vacuum_files": 0,
        "exec_cache_hits": 0,
        "exec_cache_misses": 0,
        "aot_disk_hits": 0,
        "aot_misses": 0,
        "aot_stores": 0,
        "aot_quarantined": 0,
        "aot_evictions": 0,
        "pipelines_fused": 0,
        "pipelines_eager": 0,
        "mem_watermarks": 0,
    }
    budget = {
        "verdicts": {},  # verdict -> statement count
        "max_peak_bytes": 0,
        "max_budget_bytes": 0,
    }
    feedback = {
        "lookups": 0,       # store probes at budget time (mode=on)
        "hits": 0,          # probes that found a recorded actual
        "overrides": 0,     # per-node estimates actually replaced
        "records": 0,       # actuals recorded at execution time
        "err_n": 0,         # records that carried an |log(est/actual)|
        "err_sum": 0.0,
        "err_max": 0.0,
        # node class -> {n, err_sum, err_max}: the mergeable summary
        # behind `profile --accuracy` (full distributions come from the
        # raw op_spans, which compaction folds away)
        "by_node": {},
    }
    for ev in events:
        k = ev.get("kind")
        if k == "query_span":
            q = queries.setdefault(
                ev.get("query") or "<unscoped>", dict(_EMPTY_QUERY, ops={})
            )
            q["wall_ms"] = (q["wall_ms"] or 0.0) + float(ev.get("dur_ms") or 0.0)
            q["runs"] += 1
            if q["status"] != "Failed":  # any failed run surfaces
                q["status"] = ev.get("status")
            if ev.get("failure_kind"):
                q["failure_kind"] = ev["failure_kind"]
            if ev.get("mem_hw_bytes") is not None:
                # mem_source describes the run that HOLDS the high-water
                # (merge_profiles mirrors this, so compacted and raw
                # profiles of the same events agree on it)
                v = int(ev["mem_hw_bytes"])
                if "mem_hw_bytes" not in q or v > q["mem_hw_bytes"]:
                    q["mem_hw_bytes"] = v
                    q["mem_source"] = ev.get("mem_source")
        elif k == "plan_cache":
            tallies["plan_cache_hits" if ev.get("hit") else "plan_cache_misses"] += 1
        elif k == "catalog_load":
            tallies["catalog_loads"] += 1
            if ev.get("cache") == "hit":
                tallies["catalog_cache_hits"] += 1
        elif k == "io_retry":
            tallies["io_retries"] += 1
        elif k == "ladder_rung":
            tallies["ladder_rungs"] += 1
        elif k == "watchdog_fire":
            tallies["watchdog_fires"] += 1
        elif k == "fault_injected":
            tallies["faults_injected"] += 1
        elif k == "blocked_union":
            tallies["blocked_union_windows"] += int(ev.get("windows") or 0)
        elif k == "exchange":
            tallies["exchange_ops"] += 1
            tallies["exchange_bytes"] += int(ev.get("bytes_moved") or 0)
            tallies["exchange_retries"] += int(ev.get("retries") or 0)
            try:
                skew = float(ev.get("skew") or 0.0)
            except (TypeError, ValueError):
                skew = 0.0
            if skew > tallies["exchange_max_skew"]:
                tallies["exchange_max_skew"] = skew
        elif k == "mesh_fallback":
            tallies["mesh_fallbacks"] += 1
        elif k == "spill":
            tallies["spill_ops"] += 1
            tallies["spill_bytes_in"] += int(ev.get("bytes_in") or 0)
            tallies["spill_bytes_out"] += int(ev.get("bytes_out") or 0)
            tallies["spill_evictions"] += int(ev.get("evictions") or 0)
        elif k == "lake_commit":
            if ev.get("conflict"):
                tallies["lake_commit_conflicts"] += 1
            else:
                tallies["lake_commits"] += 1
                if ev.get("rebased"):
                    tallies["lake_commit_rebases"] += 1
        elif k == "lake_vacuum":
            tallies["lake_vacuums"] += 1
            tallies["lake_vacuum_files"] += int(ev.get("files_removed") or 0)
        elif k == "exec_cache":
            tallies[
                "exec_cache_hits" if ev.get("hit") else "exec_cache_misses"
            ] += 1
        elif k == "aot_cache":
            op, result = ev.get("op"), ev.get("result")
            if op == "load":
                if result == "hit":
                    tallies["aot_disk_hits"] += 1
                elif result == "quarantined":
                    tallies["aot_quarantined"] += 1
                else:
                    tallies["aot_misses"] += 1
            elif op == "store" and result == "stored":
                tallies["aot_stores"] += 1
            elif op == "evict":
                tallies["aot_evictions"] += int(ev.get("entries") or 0)
        elif k == "pipeline_span":
            tallies[
                "pipelines_fused" if ev.get("fused") else "pipelines_eager"
            ] += 1
        elif k == "kernel_span":
            kt = kernel_totals.setdefault(
                ev.get("kernel") or "<unknown>",
                {"count": 0, "dur_ms": 0.0, "n_rows": 0},
            )
            kt["count"] += 1
            kt["dur_ms"] += float(ev.get("dur_ms") or 0.0)
            kt["n_rows"] += int(ev.get("n") or 0)
        elif k == "plan_budget":
            v = ev.get("verdict") or "<unknown>"
            budget["verdicts"][v] = budget["verdicts"].get(v, 0) + 1
            budget["max_peak_bytes"] = max(
                budget["max_peak_bytes"], int(ev.get("peak_bytes") or 0)
            )
            budget["max_budget_bytes"] = max(
                budget["max_budget_bytes"], int(ev.get("budget_bytes") or 0)
            )
        elif k == "plan_feedback":
            op = ev.get("op")
            if op in ("consume", "annotate"):
                feedback["lookups"] += int(ev.get("lookups") or 0)
                feedback["hits"] += int(ev.get("hits") or 0)
                feedback["overrides"] += int(ev.get("overrides") or 0)
            elif op == "record":
                feedback["records"] += 1
                err = ev.get("abs_log_err")
                if err is not None:
                    e = float(err)
                    feedback["err_n"] += 1
                    feedback["err_sum"] += e
                    if e > feedback["err_max"]:
                        feedback["err_max"] = e
                    node = ev.get("node") or "<unknown>"
                    rec = feedback["by_node"].setdefault(
                        node, {"n": 0, "err_sum": 0.0, "err_max": 0.0}
                    )
                    rec["n"] += 1
                    rec["err_sum"] += e
                    if e > rec["err_max"]:
                        rec["err_max"] = e
        elif k == "mem_watermark":
            tallies["mem_watermarks"] += 1
    return {
        "queries": queries,
        "op_totals": op_totals,
        "kernel_totals": kernel_totals,
        "tallies": tallies,
        "plan_budget": budget,
        "feedback": feedback,
    }


def exec_cache_hit_rate(prof: dict):
    """Executable-cache hit rate of a profiled run, or None when the run
    recorded no exec_cache probes (fusion off / untraced). The CI
    microbench guard (`profile --min_exec_cache_hit_rate`) reads this."""
    t = prof["tallies"]
    probes = t["exec_cache_hits"] + t["exec_cache_misses"]
    if probes == 0:
        return None
    return t["exec_cache_hits"] / probes


def feedback_hit_rate(prof: dict):
    """Feedback-store hit rate of a profiled run (budget-time lookups
    that found a recorded actual), or None when the run did no lookups
    (plan_feedback off/record — record mode never probes). The bench OUT
    line and `profile --bench` headline read this."""
    fb = prof.get("feedback") or {}
    lookups = fb.get("lookups") or 0
    if not lookups:
        return None
    return (fb.get("hits") or 0) / lookups


def feedback_err_mean(prof: dict):
    """Mean |log(est/actual)| over the run's recorded feedback samples,
    or None when nothing carried an error (no estimates annotated)."""
    fb = prof.get("feedback") or {}
    n = fb.get("err_n") or 0
    if not n:
        return None
    return float(fb.get("err_sum") or 0.0) / n


def aot_disk_hit_rate(prof: dict):
    """Persistent-executable-cache disk hit rate of a profiled run, or
    None when no aot_cache load probes were recorded (cache disabled /
    untraced). The two-process microbench gate in tools/fuse_microbench.py
    reads this from the FRESH process's trace: a warmed fleet's cold
    dispatches must resolve from disk, not recompile."""
    t = prof["tallies"]
    probes = t.get("aot_disk_hits", 0) + t.get("aot_misses", 0)
    if probes == 0:
        return None
    return t.get("aot_disk_hits", 0) / probes


# ---------------------------------------------------------------------------
# trace-dir compaction: fold closed rotation segments into summary artifacts
# ---------------------------------------------------------------------------

#: compaction summary artifact (one per app chain) — the pre-aggregated
#: profile of the folded segments plus provenance
COMPACT_PREFIX = "compact-"


def discover_compact_files(trace_dir) -> list:
    if not trace_dir:
        return []
    return sorted(
        glob.glob(os.path.join(str(trace_dir), f"{COMPACT_PREFIX}*.json"))
    )


def read_compact(path) -> dict:
    """One compaction artifact ({"compact": 1, "app", "segments",
    "events", "profile"}); raises ValueError on a non-artifact OR an
    artifact whose profile is structurally unusable (e.g. a torn/edited
    file with "profile": null) — merge_profiles must never see it, so
    every consumer fails through its ValueError path instead of an
    AttributeError deep inside the merge."""
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    prof = raw.get("profile") if isinstance(raw, dict) else None
    if not isinstance(raw, dict) or raw.get("compact") != 1 or not isinstance(
        prof, dict
    ):
        raise ValueError(f"{path}: not a profile-compaction artifact")
    for key in ("queries", "op_totals", "kernel_totals", "tallies",
                "plan_budget", "feedback"):
        v = prof.get(key)
        if v is None:
            continue
        bad = not isinstance(v, dict)
        if not bad and key in ("queries", "op_totals", "kernel_totals"):
            bad = any(not isinstance(x, dict) for x in v.values())
        if not bad and key == "tallies":
            bad = any(not isinstance(x, (int, float)) for x in v.values())
        if bad:
            raise ValueError(
                f"{path}: compaction artifact with malformed "
                f"profile[{key!r}]"
            )
    return raw


def _merge_op(dst: dict, src: dict):
    dst["count"] = dst.get("count", 0) + int(src.get("count") or 0)
    dst["incl_ms"] = dst.get("incl_ms", 0.0) + float(src.get("incl_ms") or 0.0)
    dst["excl_ms"] = dst.get("excl_ms", 0.0) + float(src.get("excl_ms") or 0.0)
    dst["rows"] = dst.get("rows", 0) + int(src.get("rows") or 0)


def merge_profiles(base: dict, extra: dict) -> dict:
    """Merge two `profile_events` aggregates with the SAME multi-stream
    semantics profiling the raw files together would give: per-query
    wall/runs/operator times SUM, any Failed run surfaces, memory
    high-water is the max, tallies/verdict counts add. This is what makes
    `profile` over a compacted trace dir equal the uncompacted profile
    for the summary fields. Returns `base`, mutated."""
    for q, src in (extra.get("queries") or {}).items():
        dst = base.setdefault("queries", {}).setdefault(
            q, dict(_EMPTY_QUERY, ops={})
        )
        if src.get("wall_ms") is not None:
            dst["wall_ms"] = (dst.get("wall_ms") or 0.0) + float(src["wall_ms"])
        dst["runs"] = dst.get("runs", 0) + int(src.get("runs") or 0)
        dst["root_incl_ms"] = (
            dst.get("root_incl_ms", 0.0) + float(src.get("root_incl_ms") or 0.0)
        )
        if dst.get("status") != "Failed":  # any failed run surfaces
            dst["status"] = src.get("status") or dst.get("status")
        if src.get("failure_kind"):
            dst["failure_kind"] = src["failure_kind"]
        if src.get("mem_hw_bytes") is not None and (
            "mem_hw_bytes" not in dst
            or int(src["mem_hw_bytes"]) > int(dst.get("mem_hw_bytes") or 0)
        ):
            dst["mem_hw_bytes"] = int(src["mem_hw_bytes"])
            dst["mem_source"] = src.get("mem_source")
        for node, op in (src.get("ops") or {}).items():
            _merge_op(
                dst["ops"].setdefault(
                    node,
                    {"count": 0, "incl_ms": 0.0, "excl_ms": 0.0, "rows": 0},
                ),
                op,
            )
    for name, src in (extra.get("op_totals") or {}).items():
        _merge_op(base.setdefault("op_totals", {}).setdefault(name, {}), src)
    for name, src in (extra.get("kernel_totals") or {}).items():
        dst = base.setdefault("kernel_totals", {}).setdefault(name, {})
        dst["count"] = dst.get("count", 0) + int(src.get("count") or 0)
        dst["dur_ms"] = dst.get("dur_ms", 0.0) + float(src.get("dur_ms") or 0.0)
        dst["n_rows"] = dst.get("n_rows", 0) + int(src.get("n_rows") or 0)
    for name, v in (extra.get("tallies") or {}).items():
        base.setdefault("tallies", {})
        if name == "exchange_max_skew":
            # a ratio, not a count: the merged profile reports the worst
            # imbalance any stream saw, exactly as one raw pass would
            base["tallies"][name] = max(base["tallies"].get(name, 0.0), v)
        else:
            base["tallies"][name] = base["tallies"].get(name, 0) + v
    pb_src = extra.get("plan_budget") or {}
    pb_dst = base.setdefault(
        "plan_budget",
        {"verdicts": {}, "max_peak_bytes": 0, "max_budget_bytes": 0},
    )
    for v, n in (pb_src.get("verdicts") or {}).items():
        pb_dst["verdicts"][v] = pb_dst["verdicts"].get(v, 0) + n
    for key in ("max_peak_bytes", "max_budget_bytes"):
        pb_dst[key] = max(pb_dst.get(key, 0), int(pb_src.get(key) or 0))
    fb_src = extra.get("feedback") or {}
    fb_dst = base.setdefault("feedback", {
        "lookups": 0, "hits": 0, "overrides": 0, "records": 0,
        "err_n": 0, "err_sum": 0.0, "err_max": 0.0, "by_node": {},
    })
    for key in ("lookups", "hits", "overrides", "records", "err_n"):
        fb_dst[key] = fb_dst.get(key, 0) + int(fb_src.get(key) or 0)
    fb_dst["err_sum"] = (
        fb_dst.get("err_sum", 0.0) + float(fb_src.get("err_sum") or 0.0)
    )
    fb_dst["err_max"] = max(
        fb_dst.get("err_max", 0.0), float(fb_src.get("err_max") or 0.0)
    )
    for node, src in (fb_src.get("by_node") or {}).items():
        dst = fb_dst.setdefault("by_node", {}).setdefault(
            node, {"n": 0, "err_sum": 0.0, "err_max": 0.0}
        )
        dst["n"] = dst.get("n", 0) + int(src.get("n") or 0)
        dst["err_sum"] = (
            dst.get("err_sum", 0.0) + float(src.get("err_sum") or 0.0)
        )
        dst["err_max"] = max(
            dst.get("err_max", 0.0), float(src.get("err_max") or 0.0)
        )
    return base


def load_profile(paths, strict: bool = True, events_hook=None) -> dict:
    """The profile aggregate of raw event files AND compaction artifacts
    under `paths` — `profile_events` over the events, then every
    artifact's saved profile merged in. THE one implementation of
    "profile a (partially) compacted dir": the profiler CLI routes here
    too, passing `events_hook(events)` to schema-validate the raw half
    before aggregation (artifacts were validated when their segments
    folded — compact_trace_dir refuses schema-dirty segments).

    Safe against a CONCURRENT `profile compact` of the same dir (the
    documented fleet mode): dir-discovered segments are read first and
    individually tolerate vanishing mid-read (the compactor deleted them
    — their events are in the artifact, whose atomic commit strictly
    precedes the delete), artifacts are discovered AFTER the reads, and
    any raw segment that both got read AND appears in an artifact's
    `segments` provenance is dropped from the raw half before profiling
    (same dedup that makes a crashed compactor's half-state count once).
    Explicitly named files keep strict semantics — a missing path the
    caller asked for is still an error."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    events, compacts = [], []
    per_seg = []  # (basename, events) of dir-discovered segments
    for p in paths:
        p = str(p)
        if os.path.isdir(p):
            for f in discover_event_files(p):
                try:
                    per_seg.append(
                        (os.path.basename(f), list(iter_events(f, strict=strict)))
                    )
                except FileNotFoundError:
                    pass  # raced a concurrent compact: folded into an artifact
            compacts.extend(discover_compact_files(p))
        elif os.path.basename(p).startswith(COMPACT_PREFIX) and p.endswith(
            ".json"
        ):
            compacts.append(p)
        else:
            events.extend(iter_events(p, strict=strict))
    artifacts = [read_compact(c) for c in compacts]
    folded = set()
    for a in artifacts:
        folded.update(a.get("segments") or [])
    for base, evs in per_seg:
        if base not in folded:  # read raw AND folded would count twice
            events.extend(evs)
    if events_hook is not None:
        events_hook(events)
    prof = profile_events(events)
    for a in artifacts:
        merge_profiles(prof, a["profile"])
    return prof


def compact_trace_dir(trace_dir, fold_open: bool = False,
                      dry_run: bool = False):
    """Fold rotation segments into per-app `compact-<app>.json` summary
    artifacts and DELETE the folded raw files, bounding a long-running
    fleet's event-log disk at ~one open segment per live app.

    By default only CLOSED segments fold (everything but each chain's
    highest-seq segment, which a live tracer may still be appending to);
    `fold_open=True` folds whole chains (post-run compaction). Re-running
    merges new closed segments into the existing artifact. A segment with
    mid-file corruption is left in place for forensics and reported in
    `skipped` — compaction never destroys evidence it could not read.

    Crash safety: the artifact commits atomically BEFORE the raw deletes,
    and its `segments` provenance list is consulted on the next run — a
    segment whose basename is already recorded was folded by a run that
    died mid-delete, so it is removed without re-merging (no double
    count, ever).

    `dry_run` runs the exact same selection + readability classification
    but writes and deletes nothing (the `profile compact --dry_run`
    preview shares this one implementation so it cannot drift).

    Returns (folded, skipped): folded = [(app, [paths])...],
    skipped = [(path, reason)...]."""
    from ..io.fs import fs_open_atomic

    chains = {}
    for f in discover_event_files(trace_dir):
        app, seq = segment_key(f)
        chains.setdefault(app, []).append((seq, f))
    folded, skipped = [], []
    for app, segs in sorted(chains.items()):
        segs.sort()
        victims = [f for _, f in (segs if fold_open else segs[:-1])]
        if not victims:
            continue
        artifact = os.path.join(str(trace_dir), f"{COMPACT_PREFIX}{app}.json")
        try:
            prior = read_compact(artifact) if os.path.exists(artifact) else None
        except (OSError, ValueError) as exc:
            # an unreadable/foreign prior artifact: folding into it would
            # overwrite whatever it held — skip this chain, keep going on
            # the others (a fleet's disk must not hinge on one bad file)
            skipped.append((artifact, str(exc)))
            continue
        already = set((prior or {}).get("segments") or [])
        stale = [f for f in victims if os.path.basename(f) in already]
        victims = [f for f in victims if os.path.basename(f) not in already]
        if not dry_run:
            for f in stale:
                os.remove(f)  # folded by a crashed run: finish its delete
        events, ok_files = [], []
        for f in victims:
            try:
                evs = list(iter_events(f, strict=True))
            except MalformedEventError as exc:
                skipped.append((f, str(exc)))
                continue
            # schema-validate BEFORE folding: an artifact only ever holds
            # schema-clean events, so `profile --check` keeps its teeth
            # over compacted dirs (the raw spans it would have flagged are
            # left in place and reported instead of silently absorbed)
            problems = validate_events(evs)
            if problems:
                skipped.append((f, f"schema: {problems[0]}"))
                continue
            events.extend(evs)
            ok_files.append(f)
        if not ok_files:
            if stale:
                folded.append((app, stale))
            continue
        if dry_run:
            folded.append((app, stale + ok_files))
            continue
        prof = profile_events(events)
        if prior is not None:
            # merge INTO the prior profile so repeated compaction rounds
            # accumulate exactly like one bigger round would have
            prof = merge_profiles(prior["profile"], prof)
        payload = {
            "compact": 1,
            "app": app,
            "segments": sorted(already)
            + [os.path.basename(f) for f in ok_files],
            "events": int((prior or {}).get("events") or 0) + len(events),
            "profile": prof,
        }
        with fs_open_atomic(artifact, "w") as fh:
            json.dump(payload, fh)
        for f in ok_files:
            os.remove(f)
        folded.append((app, stale + ok_files))
    return folded, skipped


def compare_profiles(old: dict, new: dict, ratio: float = 1.25,
                     min_ms: float = 50.0) -> list:
    """Per-query wall-time and per-(query, operator) exclusive-time
    regressions between two profiles. A regression flags when new >= old *
    `ratio` AND the absolute delta >= `min_ms` (tiny operators jitter).
    Returns records sorted worst-first; disappearing/appearing queries are
    reported as `status_change` records."""
    out = []
    oq, nq = old["queries"], new["queries"]
    for q in sorted(set(oq) | set(nq)):
        o, n = oq.get(q), nq.get(q)
        if o is None or n is None:
            out.append({
                "level": "query", "query": q, "change": "status_change",
                "detail": "only in new run" if o is None else "only in old run",
            })
            continue
        if (o.get("status") != "Failed") and n.get("status") == "Failed":
            out.append({
                "level": "query", "query": q, "change": "status_change",
                "detail": f"now Failed ({n.get('failure_kind', 'unknown')})",
            })
            continue
        ow, nw = o.get("wall_ms"), n.get("wall_ms")
        if ow and nw and nw >= ow * ratio and nw - ow >= min_ms:
            out.append({
                "level": "query", "query": q, "change": "regression",
                "old_ms": ow, "new_ms": nw, "ratio": nw / ow,
            })
        for node in sorted(set(o["ops"]) | set(n["ops"])):
            oe = o["ops"].get(node, {}).get("excl_ms", 0.0)
            ne = n["ops"].get(node, {}).get("excl_ms", 0.0)
            if oe and ne >= oe * ratio and ne - oe >= min_ms:
                out.append({
                    "level": "operator", "query": q, "node": node,
                    "change": "regression",
                    "old_ms": oe, "new_ms": ne, "ratio": ne / oe,
                })
    out.sort(key=lambda r: -r.get("ratio", float("inf")))
    return out
