#!/usr/bin/env python3
"""A/B of nds_tpu_torch's steady query times between two checkouts, on one
NVIDIA GPU at TPC-DS SF100 row counts.

Runs chip_smoke.py's q3 and minmax (main path) and q98 and q5 (windows
phase) on chip_smoke's SF100 tables, with the kernels on, from each of two
checkouts in turns (`--order`, default ABBA). Each turn is a fresh process
that imports that checkout's chip_smoke and nds_tpu_torch, so both run the
same way on the same card in one call. Per query and turn it prints one JSON line: the
cold ms, the median and every one of `--runs` steady runs, and one steady
run under torch.profiler (after a discarded profiled run, so the profiler's
start-up stays out of the wall time): the device ms and the device's busy
share of that run. The first line is the card's `nvidia-smi` name and power
limit.

Usage (from the repository root, on the card):
    python3 tools/torch_steady_ab.py <checkout A> <checkout B> \
        [--order ABBAABBA] [--runs 9]
"""

import argparse
import json
import os
import subprocess
import sys
import time

MAIN_QUERIES = ("q3", "minmax")
WINDOW_QUERIES = ("q98", "q5")


def worker(root: str, label: str, runs: int):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.environ["NDS_PLAN_BUDGET_STRICT"] = "1"
    import numpy as np
    import torch

    import chip_smoke as cs
    from nds_tpu_torch.analysis import budget as B
    from nds_tpu_torch.engine.session import Session, resolve_device
    from nds_tpu_torch.ops import _build

    if not os.path.samefile(os.path.dirname(cs.__file__), root):
        sys.exit(f"chip_smoke came from {cs.__file__}, not {root}")
    dev = resolve_device("cuda:0")
    _build.build_all()
    star = cs.make_star(0, 1.0)
    tables = cs.to_tables(star, dev)
    wtables = cs.to_tables(star, dev, windows=True, base=tables)
    torch.cuda.synchronize()
    on = {f"engine.pallas_{k}": "on" for k in ("agg", "join", "sort")}
    s_main, s_win = Session(conf=on), Session(conf=on)
    for name, t in tables.items():
        s_main.register_table(name, t)
    for name, t in wtables.items():
        s_win.register_table(name, t)
    work = [(q, s_main, cs.QUERIES[q]) for q in MAIN_QUERIES] + [
        (q, s_win, cs.WINDOW_QUERIES[q]) for q in WINDOW_QUERIES]

    for q, s, sql in work:
        refused = cs.refusal(B, s, sql)

        def run(s=s, sql=sql, refused=refused):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with cs.admitted(s, refused):
                res = s.sql(sql).collect()
            torch.cuda.synchronize()
            return res, (time.perf_counter() - t) * 1e3

        res, cold_ms = run()
        steady = [run()[1] for _ in range(runs)]
        cs.profile_query(torch, run, q)  # the profiler's start-up
        prof = cs.profile_query(torch, run, q)
        print(json.dumps({
            "turn": label, "root": root, "query": q, "rows": res.num_rows,
            "verdict": (s.last_plan_budget or {}).get("verdict"),
            "cold_ms": cold_ms, "steady_ms": float(np.median(steady)),
            "steady_runs_ms": steady, "profiled_wall_ms": prof["wall_ms"],
            "device_ms": prof["device_ms"],
            "device_busy_share": prof["device_busy_share"],
            "device_launches": prof["device_launches"],
        }), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a", help="checkout A (its root directory)")
    ap.add_argument("b", help="checkout B (its root directory)")
    ap.add_argument("--runs", type=int, default=9,
                    help="steady runs per query and turn")
    ap.add_argument("--order", default="ABBA",
                    help="the turns, one letter (A or B) per process")
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker, args.runs)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    if set(args.order) - {"A", "B"}:
        ap.error(f"--order takes the letters A and B: {args.order!r}")
    for label in args.order:
        root = args.a if label == "A" else args.b
        rc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), args.a, args.b,
             "--runs", str(args.runs), "--worker", root, label],
            timeout=900).returncode
        if rc != 0:
            print(f"turn {label} ({root}) exited {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
