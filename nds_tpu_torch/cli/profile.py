"""Operator-level query profiler over the engine's structured event logs
(the local analogue of the reference's RAPIDS profiling tool over Spark
event logs).

    python -m nds_tpu_torch.cli.profile <events.jsonl | trace_dir>...
        [--top N] [--per_query] [--json] [--check]
    python -m nds_tpu_torch.cli.profile --critical-path <events | trace_dir>...
        [--min_attributed 0.9] [--json]
    python -m nds_tpu_torch.cli.profile --check <failure-bundle-*.json>...
    python -m nds_tpu_torch.cli.profile --compare OLD NEW
        [--ratio 1.25] [--min_ms 50] [--fail_on_regression]
        [--bench OLD_BENCH NEW_BENCH]
    python -m nds_tpu_torch.cli.profile compact <trace_dir> [--all] [--dry_run]

Single-run mode aggregates one or more event logs (files or trace dirs —
a throughput run's per-stream files profile together naturally) into
per-query operator time/rows breakdowns, the top-N hottest operators
across the run, and cache-hit/retry tallies; a (partially) compacted
trace dir profiles transparently — raw segments and `compact-*.json`
summary artifacts merge with identical summary semantics.
`--critical-path` attributes each query's wall time to named causes
(execute / exchange-wait / spill-io / catalog-load / ladder-retry /
backoff-wait / hung-wait / plan-host — obs/critpath.py) and, on mesh
traces, names the straggler device and the skew share of the exchange
gap; `--min_attributed R` exits 1 when any query's attributed share
falls below R (the CI diagnosis gate). Paths that look like flight-
recorder failure bundles (`failure-bundle-*.json`) are validated
structurally (bundle keys + ring event schema) instead of being parsed
as event logs — `profile --check <bundle>` is how CI asserts a crash
left a USABLE black box. `--compare`
diffs two runs and flags per-query and per-operator regressions.
`compact` folds closed rotation segments (engine.trace_rotate_bytes)
into per-app summary artifacts and deletes the raw files, bounding a
long-running fleet's trace-dir disk (--all folds the open tails too —
post-run mode). Exit codes: 0 ok, 1 regressions found under
--fail_on_regression (or segments skipped by compact), 2 malformed
event log.
"""

import argparse
import json
import sys

from ..obs import critpath as CP
from ..obs import flight as FL
from ..obs import reader as R


def _fmt_bytes(n):
    if n is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024


def _fmt_ms(v):
    return "-" if v is None else f"{v:,.1f}"


def _load_profile(paths, check: bool):
    """Validated profile aggregate over raw event files + compaction
    artifacts — one shared implementation (reader.load_profile); this
    wrapper only adds the CLI's schema reporting and exit codes. Schema
    validation applies to the raw events; artifacts were validated when
    their segments folded (compact refuses schema-dirty segments)."""

    def _validate(events):
        problems = R.validate_events(events)
        if problems:
            for p in problems[:20]:
                print(f"profile: schema: {p}", file=sys.stderr)
            if check:
                sys.exit(2)

    try:
        return R.load_profile(paths, strict=True, events_hook=_validate)
    except (R.MalformedEventError, OSError, ValueError, KeyError) as exc:
        print(f"profile: {exc}", file=sys.stderr)
        sys.exit(2)


def _render_profile(prof, top: int, per_query: bool):
    queries = prof["queries"]
    n_failed = sum(
        1 for v in queries.values() if v.get("status") == "Failed"
    )
    print(f"== {len(queries)} queries ({n_failed} failed)")
    for q in sorted(queries):
        rec = queries[q]
        mem = ""
        if rec.get("mem_hw_bytes") is not None:
            mem = (f"  mem_hw {_fmt_bytes(rec['mem_hw_bytes'])}"
                   f" ({rec.get('mem_source')})")
        status = rec.get("status") or "?"
        if rec.get("failure_kind"):
            status += f" ({rec['failure_kind']})"
        runs = f" x{rec['runs']}" if rec.get("runs", 1) > 1 else ""
        print(f"\n-- {q}{runs}: wall {_fmt_ms(rec.get('wall_ms'))} ms  "
              f"plan {_fmt_ms(rec.get('root_incl_ms'))} ms  {status}{mem}")
        if per_query and rec["ops"]:
            print(f"   {'operator':<18}{'count':>6}{'incl_ms':>12}"
                  f"{'excl_ms':>12}{'rows':>12}")
            for node, op in sorted(
                rec["ops"].items(), key=lambda kv: -kv[1]["excl_ms"]
            ):
                print(f"   {node:<18}{op['count']:>6}"
                      f"{op['incl_ms']:>12,.1f}{op['excl_ms']:>12,.1f}"
                      f"{op['rows']:>12,}")
    hot = sorted(
        prof["op_totals"].items(), key=lambda kv: -kv[1]["excl_ms"]
    )[:top]
    if hot:
        print(f"\n== top {len(hot)} operators by exclusive time (run-wide)")
        print(f"   {'operator':<18}{'count':>6}{'incl_ms':>12}"
              f"{'excl_ms':>12}{'rows':>12}")
        for node, op in hot:
            print(f"   {node:<18}{op['count']:>6}{op['incl_ms']:>12,.1f}"
                  f"{op['excl_ms']:>12,.1f}{op['rows']:>12,}")
    t = prof["tallies"]
    print(f"\n== tallies: plan-cache {t['plan_cache_hits']} hit / "
          f"{t['plan_cache_misses']} miss; catalog {t['catalog_loads']} "
          f"loads ({t['catalog_cache_hits']} cache-hit); "
          f"io retries {t['io_retries']}; ladder rungs {t['ladder_rungs']}; "
          f"watchdog fires {t['watchdog_fires']}; faults injected "
          f"{t['faults_injected']}; blocked-union windows "
          f"{t['blocked_union_windows']}")
    # mesh-execution evidence (exchange/mesh_fallback events); .get()
    # because compacted artifacts from pre-mesh runs lack the keys
    if t.get("exchange_ops") or t.get("mesh_fallbacks"):
        print(f"== exchange: {t.get('exchange_ops', 0)} collective "
              f"exchange(s) moved {_fmt_bytes(t.get('exchange_bytes', 0))} "
              f"over the interconnect; {t.get('exchange_retries', 0)} "
              f"overflow retries; worst skew "
              f"{t.get('exchange_max_skew', 0.0):.2f}x"
              + (f"; {t['mesh_fallbacks']} replication fallback(s)"
                 if t.get("mesh_fallbacks") else ""))
    # out-of-core evidence (spill events); .get() because compacted
    # artifacts from pre-spill runs lack the keys
    if t.get("spill_ops"):
        print(f"== spill: {t['spill_ops']} out-of-core op(s); "
              f"{_fmt_bytes(t.get('spill_bytes_in', 0))} into the host "
              f"pool / {_fmt_bytes(t.get('spill_bytes_out', 0))} read "
              f"back; {t.get('spill_evictions', 0)} segment(s) tiered "
              f"to disk")
    # transactional-lakehouse evidence (lake_commit/lake_vacuum events);
    # .get() because compacted artifacts from pre-lakehouse-txn runs lack
    # the keys
    if t.get("lake_commits") or t.get("lake_commit_conflicts"):
        print(f"== lakehouse: {t.get('lake_commits', 0)} commit(s) "
              f"({t.get('lake_commit_rebases', 0)} rebased, "
              f"{t.get('lake_commit_conflicts', 0)} conflict abort(s)); "
              f"{t.get('lake_vacuums', 0)} vacuum(s) removed "
              f"{t.get('lake_vacuum_files', 0)} file(s)")
    pb = prof.get("plan_budget") or {}
    if pb.get("verdicts"):
        verdicts = ", ".join(
            f"{v} x{n}" for v, n in sorted(pb["verdicts"].items())
        )
        wm = t.get("mem_watermarks", 0)
        print(f"== plan budget: {verdicts}; max modeled peak "
              f"{_fmt_bytes(pb['max_peak_bytes'])} vs budget "
              f"{_fmt_bytes(pb['max_budget_bytes'])}"
              + (f"; host watermarks {wm}" if wm else ""))
    rate = R.exec_cache_hit_rate(prof)
    if rate is not None or t["pipelines_fused"] or t["pipelines_eager"]:
        rate_s = "-" if rate is None else f"{rate:.1%}"
        print(f"== pipelines: {t['pipelines_fused']} fused / "
              f"{t['pipelines_eager']} eager; executable cache "
              f"{t['exec_cache_hits']} hit / {t['exec_cache_misses']} miss "
              f"(rate {rate_s})")
    # persistent AOT executable cache evidence (aot_cache events); .get()
    # because compacted artifacts from pre-AOT runs lack the keys
    aot_rate = R.aot_disk_hit_rate(prof)
    if aot_rate is not None or t.get("aot_stores") or t.get(
        "aot_quarantined"
    ):
        rate_s = "-" if aot_rate is None else f"{aot_rate:.1%}"
        print(f"== aot cache: {t.get('aot_disk_hits', 0)} disk hit / "
              f"{t.get('aot_misses', 0)} miss (rate {rate_s}); "
              f"{t.get('aot_stores', 0)} stored, "
              f"{t.get('aot_evictions', 0)} evicted, "
              f"{t.get('aot_quarantined', 0)} quarantined")
    # plan-feedback evidence (plan_feedback events); .get() because
    # compacted artifacts from pre-feedback runs lack the block
    fb = prof.get("feedback") or {}
    if fb.get("records") or fb.get("lookups"):
        rate = R.feedback_hit_rate(prof)
        rate_s = "-" if rate is None else f"{rate:.1%}"
        mean = R.feedback_err_mean(prof)
        mean_s = "-" if mean is None else f"{mean:.3f}"
        print(f"== plan feedback: {fb.get('records', 0)} actual(s) "
              f"recorded; {fb.get('hits', 0)}/{fb.get('lookups', 0)} "
              f"lookup(s) hit (rate {rate_s}); {fb.get('overrides', 0)} "
              f"estimate(s) overridden; mean |log(est/actual)| {mean_s}")
    kernels = sorted(
        prof.get("kernel_totals", {}).items(),
        key=lambda kv: -kv[1]["dur_ms"],
    )[:top]
    if kernels:
        print(f"\n== top {len(kernels)} kernels by dispatch time "
              f"(kernel_span; NDS_TRACE_KERNELS runs)")
        print(f"   {'kernel':<28}{'count':>6}{'total_ms':>12}"
              f"{'avg_ms':>10}{'rows':>14}")
        for name, k in kernels:
            avg = k["dur_ms"] / k["count"] if k["count"] else 0.0
            print(f"   {name:<28}{k['count']:>6}{k['dur_ms']:>12,.1f}"
                  f"{avg:>10,.3f}{k['n_rows']:>14,}")


def _accuracy_report(events, top: int) -> dict:
    """Budgeter est-vs-actual error distributions per operator class, from
    raw op_spans annotated by the plan-feedback loop (`est_rows` at budget
    time, `actual_rows` at execution). Raw events only, like
    --critical-path: compaction folds the spans away (the mergeable
    summary keeps only per-class mean/max)."""
    import math

    per_class = {}
    worst = []
    for ev in events:
        if ev.get("kind") != "op_span" or ev.get("est_rows") is None:
            continue
        actual = ev.get("actual_rows")
        if actual is None:
            actual = ev.get("rows")
        if actual is None:
            continue
        err = abs(
            math.log(max(int(ev["est_rows"]), 1))
            - math.log(max(int(actual), 1))
        )
        per_class.setdefault(ev.get("node") or "?", []).append(err)
        worst.append({
            "query": ev.get("query"),
            "node": ev.get("node"),
            "est_rows": int(ev["est_rows"]),
            "actual_rows": int(actual),
            "abs_log_err": round(err, 4),
        })
    classes = {}
    for node, errs in per_class.items():
        errs.sort()
        n = len(errs)
        classes[node] = {
            "n": n,
            "median": round(errs[n // 2], 4),
            "p90": round(errs[min(n - 1, (n * 9) // 10)], 4),
            "max": round(errs[-1], 4),
        }
    worst.sort(key=lambda s: -s["abs_log_err"])
    all_errs = sorted(e for errs in per_class.values() for e in errs)
    return {
        "samples": len(all_errs),
        "median": (
            round(all_errs[len(all_errs) // 2], 4) if all_errs else None
        ),
        "max": round(all_errs[-1], 4) if all_errs else None,
        "by_class": classes,
        "worst": worst[:top],
    }


def _render_accuracy(acc):
    if not acc["samples"]:
        print("== accuracy: no annotated op_spans (plan feedback off, or "
              "an untraced run)")
        return
    print(f"== budgeter accuracy: median |log(est/actual)| "
          f"{acc['median']:.3f}, max {acc['max']:.3f}, over "
          f"{acc['samples']} annotated span(s)")
    print(f"   {'operator':<18}{'n':>6}{'median':>10}{'p90':>10}{'max':>10}")
    for node, c in sorted(
        acc["by_class"].items(), key=lambda kv: -kv[1]["median"]
    ):
        print(f"   {node:<18}{c['n']:>6}{c['median']:>10.3f}"
              f"{c['p90']:>10.3f}{c['max']:>10.3f}")
    if acc["worst"]:
        print(f"\n== worst {len(acc['worst'])} misestimate(s)")
        for s in acc["worst"]:
            print(f"   {s['query'] or '?'}/{s['node']}: est "
                  f"{s['est_rows']:,} vs actual {s['actual_rows']:,} "
                  f"(|log err| {s['abs_log_err']:.3f})")


def _load_sqlite_shared(path):
    """The `sqlite_shared` block out of a bench artifact: a saved compact
    OUT line / bench JSON-lines output, or a driver capture whose `tail`
    holds the last emitted line. Returns the dict or None."""
    import re

    with open(path) as fh:
        text = fh.read()
    best = None
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj.get("sqlite_shared"), dict):
            best = obj["sqlite_shared"]
        elif isinstance(obj.get("tail"), str):
            # driver wrapper: scan the captured tail for the last block
            m = None
            for m in re.finditer(r'"sqlite_shared":\s*(\{[^{}]*\})',
                                 obj["tail"]):
                pass
            if m is not None:
                try:
                    best = json.loads(m.group(1))
                except ValueError:
                    pass
    return best


def _load_bench_accuracy(path):
    """The budgeter-accuracy fields (`budget_err_median`,
    `feedback_hit_rate`) out of a bench artifact: the bench OUT line /
    metrics report, or a driver capture whose `tail` holds it. Returns
    the dict (values may be None) or None when the artifact carries
    neither key — pre-feedback rounds compare as absent, not as zero."""
    import re

    try:
        with open(path) as fh:
            text = fh.read()
    except OSError:
        return None
    best = None
    for line in text.splitlines():
        line = line.strip()
        obj = None
        if line.startswith("{"):
            try:
                obj = json.loads(line)
            except ValueError:
                obj = None
        if isinstance(obj, dict) and isinstance(obj.get("tail"), str):
            line, obj = obj["tail"], None  # scan the captured tail below
        if isinstance(obj, dict):
            if "budget_err_median" in obj or "feedback_hit_rate" in obj:
                best = {
                    "budget_err_median": obj.get("budget_err_median"),
                    "feedback_hit_rate": obj.get("feedback_hit_rate"),
                }
            continue
        # metrics.csv rows ("key,value"), printed dict reprs, captured
        # tails — take the LAST occurrence, like the sqlite loader
        for key in ("budget_err_median", "feedback_hit_rate"):
            m = None
            for m in re.finditer(
                rf"['\"]?{key}['\"]?\s*[:,]\s*([0-9.]+|None|null)", line
            ):
                pass
            if m is not None:
                best = best if best is not None else {}
                v = m.group(1)
                best[key] = None if v in ("None", "null") else float(v)
    return best


def _compare_bench_accuracy(old_path, new_path):
    """Budgeter-accuracy headline comparison record (ISSUE 18: budgeter
    error is a published, shrinking number). Fail-soft like the other
    bench headlines: artifacts without the fields yield no record at
    all. Regression: the median |log(est/actual)| grew more than 25%
    AND by at least 0.1 (below that is sampling noise)."""
    old = _load_bench_accuracy(old_path) or {}
    new = _load_bench_accuracy(new_path)
    if new is None and not old:
        return []
    rec = {
        "level": "bench", "query": "budget_accuracy",
        "old_err": old.get("budget_err_median"),
        "new_err": (new or {}).get("budget_err_median"),
        "old_hit_rate": old.get("feedback_hit_rate"),
        "new_hit_rate": (new or {}).get("feedback_hit_rate"),
        "change": "headline",
    }
    e_old, e_new = rec["old_err"], rec["new_err"]
    if (
        e_old is not None and e_new is not None
        and e_new > e_old * 1.25 and e_new - e_old >= 0.1
    ):
        rec["change"] = "regression"
    return [rec]


def _compare_sqlite_shared(old_path, new_path):
    """sqlite_shared headline comparison records (ROADMAP item 3: publish
    the engine-vs-sqlite shared-subset ratio until it crosses 1.0, flag
    when it worsens). Regression: the ratio rose more than 2% — geomeans
    over ~100 queries are stable, so drift beyond that is a real loss."""
    old = _load_sqlite_shared(old_path)
    new = _load_sqlite_shared(new_path)
    out = []
    if new is None:
        out.append({
            "level": "bench", "change": "status_change",
            "query": "sqlite_shared",
            "detail": f"no sqlite_shared block in {new_path}",
        })
        return out
    r_new = new.get("ratio")
    r_old = old.get("ratio") if old else None
    rec = {
        "level": "bench", "query": "sqlite_shared",
        "old_ratio": r_old, "new_ratio": r_new,
        "queries": new.get("queries"),
        "change": "headline",
    }
    if r_old is not None and r_new is not None and r_new > r_old * 1.02:
        rec["change"] = "regression"
    out.append(rec)
    return out


def _load_multichip(path):
    """A MULTICHIP round artifact: the driver wrapper ({n_devices, rc, ok,
    tail}) or the mesh gate's metrics block (tools/mesh_stream_check.py).
    None when unreadable — comparison is fail-soft by contract."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError):
        return None
    return obj if isinstance(obj, dict) else None


def _compare_multichip(old_path, new_path):
    """MULTICHIP round comparison (ISSUE 13): the SF0.01 mesh-vs-oracle
    gate's artifact against the newest stored MULTICHIP_r*.json — the
    same fail-soft shape as the sqlite_shared headline. Old rounds
    (r01–r05 are driver wrappers with only {ok, tail}) predate the
    metrics block, so old_ratio starts null. Regression: the mesh run
    stopped being ok, or the mesh-vs-oracle wall ratio worsened > 25%."""
    old = _load_multichip(old_path) or {}
    new = _load_multichip(new_path)
    out = []
    if new is None:
        out.append({
            "level": "bench", "change": "status_change",
            "query": "multichip",
            "detail": f"unreadable multichip artifact {new_path}",
        })
        return out
    rec = {
        "level": "bench", "query": "multichip",
        "old_ratio": old.get("mesh_vs_oracle_wall_ratio"),
        "new_ratio": new.get("mesh_vs_oracle_wall_ratio"),
        "queries": new.get("matched"),
        "old_ok": old.get("ok"), "new_ok": new.get("ok"),
        "change": "headline",
    }
    r_old, r_new = rec["old_ratio"], rec["new_ratio"]
    if old.get("ok") and not new.get("ok"):
        rec["change"] = "regression"
    elif r_old is not None and r_new is not None and r_new > r_old * 1.25:
        rec["change"] = "regression"
    out.append(rec)
    return out


def _print_bench_rec(r):
    if r.get("query") == "budget_accuracy":
        def fmt(v):
            return "-" if v is None else f"{v:.3f}"

        hr = r.get("new_hit_rate")
        hr_s = "-" if hr is None else f"{hr:.1%}"
        flag = "  ** REGRESSED" if r["change"] == "regression" else ""
        print(f"== budgeter accuracy: median |log(est/actual)| "
              f"{fmt(r.get('old_err'))} -> {fmt(r.get('new_err'))} "
              f"(feedback hit rate {hr_s}){flag}")
        return
    if r.get("query") == "multichip":
        old_s = "-" if r.get("old_ratio") is None else f"{r['old_ratio']:.3f}"
        new_s = "-" if r.get("new_ratio") is None else f"{r['new_ratio']:.3f}"
        flag = "  ** REGRESSED" if r["change"] == "regression" else ""
        ok = "ok" if r.get("new_ok") else "NOT OK"
        print(f"== multichip mesh-vs-oracle wall ratio: {old_s} -> {new_s} "
              f"over {r.get('queries')} matched queries ({ok}){flag}")
        return
    old_s = "-" if r["old_ratio"] is None else f"{r['old_ratio']:.3f}"
    flag = "  ** REGRESSED" if r["change"] == "regression" else ""
    above = (
        "  (still above parity — target < 1.0)"
        if (r["new_ratio"] or 0) > 1.0
        else ""
    )
    print(f"== sqlite_shared ratio: {old_s} -> {r['new_ratio']:.3f} over "
          f"{r['queries']} shared queries{flag}{above}")


def _render_compare(regs, ratio, min_ms):
    # the sqlite_shared headline always prints, regressed or not (the
    # ratio is published every round until it crosses 1.0)
    headline = [r for r in regs if r["change"] == "headline"]
    regs = [r for r in regs if r["change"] != "headline"]
    for r in headline:
        _print_bench_rec(r)
    if not regs:
        print(f"== no regressions (threshold: {ratio:.2f}x and "
              f">= {min_ms:.0f} ms)")
        return
    print(f"== {len(regs)} regression(s) (threshold: {ratio:.2f}x and "
          f">= {min_ms:.0f} ms)")
    for r in regs:
        if r["change"] == "status_change":
            print(f"   {r['query']}: {r['detail']}")
        elif r.get("level") == "bench":
            _print_bench_rec(r)
        elif r["level"] == "query":
            print(f"   {r['query']}: wall {r['old_ms']:,.1f} -> "
                  f"{r['new_ms']:,.1f} ms ({r['ratio']:.2f}x)")
        else:
            print(f"   {r['query']}/{r['node']}: excl {r['old_ms']:,.1f} -> "
                  f"{r['new_ms']:,.1f} ms ({r['ratio']:.2f}x)")


def compact_main(argv=None) -> int:
    """`profile compact`: fold closed rotation segments into summary
    artifacts + drop the raw spans (obs.reader.compact_trace_dir)."""
    parser = argparse.ArgumentParser(
        prog="profile compact",
        description="fold closed trace-rotation segments into per-app "
        "compact-<app>.json summary artifacts and delete the raw files",
    )
    parser.add_argument("trace_dir", help="trace directory to compact")
    parser.add_argument(
        "--all", action="store_true", dest="fold_open",
        help="also fold each chain's open tail segment (post-run "
        "compaction; default keeps the highest-seq segment, which a "
        "live tracer may still be appending to)",
    )
    parser.add_argument(
        "--dry_run", action="store_true",
        help="report what would fold without writing or deleting",
    )
    args = parser.parse_args(argv)
    # --dry_run rides the SAME selection + readability classification as
    # the real run (reader.compact_trace_dir) — the preview cannot drift
    folded, skipped = R.compact_trace_dir(
        args.trace_dir, fold_open=args.fold_open, dry_run=args.dry_run
    )
    for app, files in folded:
        if args.dry_run:
            for f in files:
                print(f"compact: would fold {f}")
        else:
            print(
                f"compact: {app}: folded {len(files)} segment(s) into "
                f"compact-{app}.json"
            )
    for path, reason in skipped:
        verb = "would skip" if args.dry_run else "skipped (left in place)"
        print(f"compact: {verb} {path}: {reason}", file=sys.stderr)
    if not folded and not skipped:
        print("compact: nothing to fold")
    return 1 if skipped else 0


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "compact":
        rc = compact_main(argv[1:])
        if rc:
            sys.exit(rc)
        return
    parser = argparse.ArgumentParser(
        description="aggregate nds-tpu event logs into operator-level "
        "profiles; compare two runs for regressions"
    )
    parser.add_argument(
        "paths", nargs="*",
        help="event-log files or trace directories (events-*.jsonl)",
    )
    parser.add_argument(
        "--compare", nargs=2, metavar=("OLD", "NEW"),
        help="A/B mode: two event logs / trace dirs to diff",
    )
    parser.add_argument(
        "--bench", nargs=2, metavar=("OLD", "NEW"),
        help="bench artifacts (saved compact OUT lines / driver captures) "
        "to diff the sqlite_shared headline ratio, alongside or instead "
        "of --compare",
    )
    parser.add_argument("--top", type=int, default=10,
                        help="top-N hottest operators (10)")
    parser.add_argument("--per_query", action="store_true",
                        help="print the per-operator table for every query")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit the aggregate as JSON instead of text")
    parser.add_argument("--check", action="store_true",
                        help="exit 2 on any schema problem (CI gate); "
                        "malformed JSON lines always exit 2; failure-"
                        "bundle paths are structurally validated")
    parser.add_argument("--critical-path", "--critical_path",
                        action="store_true", dest="critical_path",
                        help="attribute per-query wall time to named "
                        "causes (and name the mesh straggler device) "
                        "instead of the operator breakdown")
    parser.add_argument("--accuracy", action="store_true",
                        help="report budgeter est-vs-actual error "
                        "distributions per operator class with the worst "
                        "misestimates, from raw op_spans annotated by the "
                        "plan-feedback loop, instead of the operator "
                        "breakdown")
    parser.add_argument("--min_attributed", type=float, metavar="FRAC",
                        help="with --critical-path: exit 1 when any "
                        "query's attributed wall share is below FRAC "
                        "(the CI diagnosis gate)")
    parser.add_argument("--min_exec_cache_hit_rate", type=float,
                        metavar="RATE",
                        help="exit 1 when the run's fused-executable cache "
                        "hit rate is below RATE (or no exec_cache events "
                        "were recorded at all) — the ci/tier1-check "
                        "microbench guard")
    parser.add_argument("--ratio", type=float, default=1.25,
                        help="compare: flag when new >= old * ratio (1.25)")
    parser.add_argument("--min_ms", type=float, default=50.0,
                        help="compare: minimum absolute delta in ms (50)")
    parser.add_argument("--fail_on_regression", action="store_true",
                        help="compare: exit 1 when regressions are flagged")
    args = parser.parse_args(argv)

    if args.compare or args.bench:
        regs = []
        if args.compare:
            old_prof = _load_profile([args.compare[0]], args.check)
            new_prof = _load_profile([args.compare[1]], args.check)
            regs = R.compare_profiles(
                old_prof, new_prof, ratio=args.ratio, min_ms=args.min_ms
            )
            # budgeter-accuracy delta rides every A/B compare: mean
            # |log(est/actual)| from the mergeable feedback summaries
            # (works on compacted dirs; --accuracy needs raw spans)
            e_old = R.feedback_err_mean(old_prof)
            e_new = R.feedback_err_mean(new_prof)
            if e_old is not None or e_new is not None:
                rec = {
                    "level": "bench", "query": "budget_accuracy",
                    "old_err": (
                        None if e_old is None else round(e_old, 4)
                    ),
                    "new_err": (
                        None if e_new is None else round(e_new, 4)
                    ),
                    "old_hit_rate": R.feedback_hit_rate(old_prof),
                    "new_hit_rate": R.feedback_hit_rate(new_prof),
                    "change": "headline",
                }
                if (
                    e_old is not None and e_new is not None
                    and e_new > e_old * 1.25 and e_new - e_old >= 0.1
                ):
                    rec["change"] = "regression"
                regs.append(rec)
        if args.bench:
            # artifact-type detection: a MULTICHIP round carries n_devices
            # (driver wrapper or mesh-gate metrics block); everything else
            # is a bench OUT line with the sqlite_shared headline. EITHER
            # side identifying as multichip routes here — an unreadable
            # NEW artifact (gate died before writing) must land on
            # _compare_multichip's fail-soft status_change record, not on
            # the sqlite loader's bare open()
            objs = [_load_multichip(p) for p in args.bench]
            if any(
                isinstance(o, dict) and "n_devices" in o for o in objs
            ):
                regs.extend(_compare_multichip(*args.bench))
            else:
                regs.extend(_compare_sqlite_shared(*args.bench))
                # accuracy headline beside the sqlite_shared ratio (bench
                # round arbitration: budgeter error must shrink)
                regs.extend(_compare_bench_accuracy(*args.bench))
        if args.as_json:
            print(json.dumps({"regressions": regs}, indent=2))
        else:
            _render_compare(regs, args.ratio, args.min_ms)
        bad = [r for r in regs if r["change"] != "headline"]
        if bad and args.fail_on_regression:
            sys.exit(1)
        return
    if not args.paths:
        parser.error("give event-log paths, or --compare OLD NEW")
    # flight-recorder failure bundles validate structurally; they are not
    # event logs and must not be parsed as one
    bundles = [p for p in args.paths if FL.is_bundle_path(p)]
    args.paths = [p for p in args.paths if not FL.is_bundle_path(p)]
    bundle_problems = 0
    for b in bundles:
        try:
            obj = FL.read_bundle(b)
            problems = FL.validate_bundle(obj)
        except (OSError, ValueError) as exc:
            problems = [str(exc)]
            obj = None
        for p in problems[:20]:
            print(f"profile: bundle {b}: {p}", file=sys.stderr)
        bundle_problems += len(problems)
        if obj is not None and not problems:
            print(
                f"== bundle {b}: reason {obj['reason']}, trace "
                f"{obj['trace_id']}, query {obj.get('query')}, "
                f"{len(obj['events'])} ring event(s)"
            )
    if bundle_problems and args.check:
        sys.exit(2)
    if not args.paths:
        return  # bundle-only invocation
    if args.critical_path or args.accuracy:
        # raw events only: compaction artifacts hold pre-aggregated
        # profiles, not the spans the reconstruction needs
        try:
            events = R.read_events(args.paths, strict=True)
        except (R.MalformedEventError, OSError) as exc:
            print(f"profile: {exc}", file=sys.stderr)
            sys.exit(2)
        if args.check:
            problems = R.validate_events(events)
            if problems:
                for p in problems[:20]:
                    print(f"profile: schema: {p}", file=sys.stderr)
                sys.exit(2)
        if args.accuracy:
            acc = _accuracy_report(events, args.top)
            if args.as_json:
                print(json.dumps(acc, indent=2))
            else:
                _render_accuracy(acc)
            return
        cp = CP.critical_path(events)
        if args.as_json:
            print(json.dumps(cp, indent=2))
        else:
            CP.render(cp)
        if args.min_attributed is not None:
            worst = CP.min_attributed_frac(cp)
            if worst is None or worst < args.min_attributed:
                print(
                    f"profile: critical-path attribution "
                    f"{'absent' if worst is None else f'{worst:.1%}'} is "
                    f"below the required {args.min_attributed:.1%}",
                    file=sys.stderr,
                )
                sys.exit(1)
        return
    prof = _load_profile(args.paths, args.check)
    if args.as_json:
        print(json.dumps(prof, indent=2))
    else:
        _render_profile(prof, args.top, args.per_query)
    if args.min_exec_cache_hit_rate is not None:
        rate = R.exec_cache_hit_rate(prof)
        if rate is None:
            print(
                "profile: no exec_cache events recorded (fusion disabled "
                "or tracing broken) — failing the hit-rate gate",
                file=sys.stderr,
            )
            sys.exit(1)
        if rate < args.min_exec_cache_hit_rate:
            print(
                f"profile: executable-cache hit rate {rate:.1%} below the "
                f"required {args.min_exec_cache_hit_rate:.1%}",
                file=sys.stderr,
            )
            sys.exit(1)


if __name__ == "__main__":
    main()
