"""Operator CLI for the persistent cache of fused builds
(engine/aotcache.py): inspect it, warm it before a run, clean it up. The
port of nds_tpu/cli/cache.py.

    python -m nds_tpu_torch.cli.cache stats  [--cache_dir D] [--json]
    python -m nds_tpu_torch.cli.cache warm   <data_dir> <stream.sql>
                                  [--cache_dir D] [--device DEV]
                                  [--format parquet|csv|lakehouse|orc]
                                  [--queries q1,q2] [--json]
    python -m nds_tpu_torch.cli.cache vacuum [--cache_dir D] [--all] [--json]

(`./nds-tpu-torch-submit cache <verb> ...` runs the same.)

`stats` reports the entry count and bytes against the budget, the
quarantine and temp counts, and the persisted promotion verdicts. `warm`
runs a query stream's templates once against a registered warehouse with
the cache armed, so every fused pipeline's build products (and each
promotion verdict) are ON DISK before the next process starts: that
process's first call of each pipeline loads instead of building. Its
report counts the entries built, loaded from disk and pinned, and times
each statement. `vacuum` sweeps dead-pid temp orphans and quarantined
entries and enforces the byte budget again; `--all` removes every
committed entry too (the operator's reset).

The learned-cardinality feedback store the JAX package keeps in the same
directory is not ported (ROADMAP.md queue 1 item 14).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _resolve_dir(args) -> str:
    from ..engine.aotcache import resolve_aot_cache_dir

    d = args.cache_dir or resolve_aot_cache_dir()
    if not d:
        print("cache: the AOT cache is disabled (NDS_AOT_CACHE_DIR=0) and "
              "no --cache_dir was given", file=sys.stderr)
        sys.exit(2)
    return d


def _dir_stats(d: str) -> dict:
    from ..engine.aotcache import (
        AotCache,
        PromotionStore,
        resolve_aot_cache_bytes,
    )

    cache = AotCache(d, resolve_aot_cache_bytes(None, d))
    entries, total = cache.usage()
    names = os.listdir(d) if os.path.isdir(d) else []
    return {
        "cache_dir": d,
        "entries": entries,
        "bytes": total,
        "budget_bytes": cache.budget,
        "quarantined": sum(1 for n in names if n.startswith("quarantine-")),
        "temps": sum(1 for n in names if ".tmp-" in n),
        "promotions": PromotionStore(d).count(),
    }


def stats_main(args) -> int:
    st = _dir_stats(_resolve_dir(args))
    if args.as_json:
        print(json.dumps(st, indent=2))
        return 0
    print(f"== aot cache {st['cache_dir']}")
    print(f"   entries      {st['entries']} "
          f"({st['bytes']:,} B of {st['budget_bytes']:,} B budget)")
    print(f"   quarantined  {st['quarantined']}")
    print(f"   temps        {st['temps']}")
    print(f"   promotions   {st['promotions']} persisted verdict(s)")
    return 0


def warm_main(args) -> int:
    from ..engine.session import Session
    from ..power import gen_sql_from_stream

    d = _resolve_dir(args)
    sess = Session(conf={"engine.aot_cache_dir": d}, device=args.device)
    sess.register_nds_tables(args.data_dir, fmt=args.format)
    if not sess.catalog.entries:
        print(f"cache warm: no tables found under {args.data_dir}",
              file=sys.stderr)
        return 2
    queries = gen_sql_from_stream(args.stream)
    if args.queries:
        keep = {s.strip() for s in args.queries.split(",") if s.strip()}
        queries = {n: q for n, q in queries.items() if n in keep}
    ok, failed, ms = 0, {}, {}
    t0 = time.perf_counter()
    for name, q in queries.items():
        t1 = time.perf_counter()
        try:
            r = sess.run_script(q)
            if r is not None:
                r.collect()
            ok += 1
        except Exception as exc:  # warm what warms; report the rest
            failed[name] = str(exc)[:200]
        ms[name] = round((time.perf_counter() - t1) * 1000.0, 3)
    ec = sess.exec_cache
    report = {
        "queries_warmed": ok,
        "queries_failed": len(failed),
        "wall_sec": round(time.perf_counter() - t0, 3),
        "query_ms": ms,
        "device": str(sess.device),
        "exec_cache": {"builds": ec.builds, "loads": ec.loads,
                       "pins": ec.pins, "entries": len(ec.map)},
        "aot": dict(sess.aot_cache.stats),
        "stats": _dir_stats(d),
    }
    if failed:
        report["failed"] = failed
    if getattr(args, "fleet", False):
        # fleet warm-up: one warm pass fills the shared dir and every
        # serve replica loads from it; print the replica's flag
        report["fleet"] = {"cache_dir": d,
                           "replica_flag": f"--aot_cache_dir {d}"}
    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        a, e = report["aot"], report["exec_cache"]
        print(f"cache warm: {ok} template(s) warmed in "
              f"{report['wall_sec']}s ({len(failed)} failed); "
              f"{e['builds']} build(s), {e['loads']} loaded from disk, "
              f"{e['pins']} pinned; {a['stores']} entr(ies) newly stored; "
              f"{report['stats']['entries']} entr(ies) / "
              f"{report['stats']['bytes']:,} B total")
        for n, err in failed.items():
            print(f"   failed {n}: {err}", file=sys.stderr)
        if "fleet" in report:
            print("cache warm --fleet: shared dir ready; start each "
                  "replica with\n"
                  f"   nds-tpu-torch-submit serve <warehouse> "
                  f"{report['fleet']['replica_flag']}\n"
                  "so N replicas pay one build, not N")
    if queries and ok == 0:
        # a warm run where NOTHING warmed leaves the next process exactly
        # as cold as if this step never ran: a pipeline must see that
        print("cache warm: every template failed; the cache is still cold",
              file=sys.stderr)
        return 1
    return 0


def vacuum_main(args) -> int:
    from ..engine.aotcache import AotCache, resolve_aot_cache_bytes

    d = _resolve_dir(args)
    cache = AotCache(d, resolve_aot_cache_bytes(None, d))
    removed = cache.vacuum(drop_all=args.drop_all)
    st = _dir_stats(d)
    if args.as_json:
        print(json.dumps({"removed": removed, "stats": st}, indent=2))
    else:
        print(f"cache vacuum: removed {removed} file(s); "
              f"{st['entries']} entr(ies) / {st['bytes']:,} B remain")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m nds_tpu_torch.cli.cache",
        description="inspect / warm / vacuum the persistent cache of fused "
        "builds",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    def _common(p):
        p.add_argument("--cache_dir", default=None,
                       help="cache directory (default: the engine's "
                       "resolved NDS_AOT_CACHE_DIR)")
        p.add_argument("--json", action="store_true", dest="as_json",
                       help="print the report as JSON")

    _common(sub.add_parser("stats", help="entries / bytes / promotions"))
    p_warm = sub.add_parser(
        "warm",
        help="run a stream's templates once so every fused build is on "
        "disk before the next process",
    )
    p_warm.add_argument("data_dir", help="warehouse directory to register")
    p_warm.add_argument("stream", help="query stream file (query_N.sql)")
    p_warm.add_argument("--format", default="parquet",
                        choices=["parquet", "csv", "lakehouse", "orc"],
                        help="warehouse format (parquet)")
    p_warm.add_argument("--queries", default=None,
                        help="comma-separated template subset")
    p_warm.add_argument("--fleet", action="store_true",
                        help="fleet warm-up: report the --aot_cache_dir "
                        "flag every serve replica should start with, so "
                        "N replicas share this one warmed dir")
    p_warm.add_argument("--device", default=None,
                        help="the session's device (default: the card)")
    _common(p_warm)
    p_vac = sub.add_parser(
        "vacuum",
        help="sweep temp orphans and quarantines, enforce the budget",
    )
    p_vac.add_argument("--all", action="store_true", dest="drop_all",
                       help="also remove every committed entry (full reset)")
    _common(p_vac)

    args = parser.parse_args(argv)
    if args.cmd == "stats":
        return stats_main(args)
    if args.cmd == "warm":
        return warm_main(args)
    return vacuum_main(args)


if __name__ == "__main__":
    sys.exit(main())
