#!/usr/bin/env python3
"""What the fused pipelines and the caches (ROADMAP item 11) cost or save a
generated stream run as users run it: one process of
`python -m nds_tpu_torch.cli.power` per turn over the same parquet
warehouse, with the kernels on, alternating two property files:

  A  the engine's defaults: fusion, top-k, the plan / result and
     join-order caches, and a persistent cache directory of its own per
     turn, empty at the start (as a fresh deployment's first process)
  B  the same with the item's layers off: engine.fuse=off,
     engine.plan_cache=off, engine.join_order_cache=off,
     engine.aot_cache_dir="" (the top-k needs the fusion pass's marks, so
     it is off too)

Data: the port's gen_data at --sf, its Load Test to parquet, stream 0 of
gen_query_stream cut to its first --templates entries (chip_smoke's
helpers). Per turn it prints one JSON line: the Power Test Time from the
time log, the process's wall seconds, the statements that did not end
Completed. The last line has each side's medians. Compare the two sides
only within one call.

Usage (from the repository root, on the card):
    python3 tools/torch_fuse_stream_ab.py [--sf 0.5] [--templates 20]
        [--order ABBA] [--device cpu]
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: side B: item 11's layers off
LAYERS_OFF = {"engine.fuse": "off", "engine.plan_cache": "off",
              "engine.join_order_cache": "off", "engine.aot_cache_dir": ""}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=0.5)
    ap.add_argument("--templates", type=int, default=20)
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--device", default=None,
                    help="the CLI's device (default: the card)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke as CS

    if args.device is None:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(),
              flush=True)
    root = tempfile.mkdtemp(prefix="nds_fuse_ab_")
    try:
        leg = os.path.join(root, "leg")
        raw, rows = CS.generate("A", leg, args.sf)
        wh, stream, _ = CS.finish_load("A", leg, args.sf, raw, rows,
                                       CS.start_load(leg, raw, False))
        CS.truncate_stream(stream, args.templates)
        on = {f"engine.pallas_{k}": "on" for k in ("agg", "join", "sort")}
        out = {"A": [], "B": []}
        for turn, side in enumerate(args.order):
            run = os.path.join(root, f"turn{turn}_{side}")
            os.makedirs(run)
            conf = dict(on)
            if side == "A":
                conf["engine.aot_cache_dir"] = os.path.join(run, "aot")
            else:
                conf.update(LAYERS_OFF)
            prop = CS.property_file(os.path.join(run, "p.properties"), conf)
            t0 = time.perf_counter()
            CS.run_cli(os.path.join(run, "power.log"),
                       "nds_tpu_torch.cli.power", wh, stream,
                       os.path.join(run, "time.csv"), "--property_file",
                       prop, "--json_summary_folder",
                       os.path.join(run, "json"),
                       *(["--device", args.device] if args.device else []))
            wall = time.perf_counter() - t0
            log = dict(CS.read_time_log(os.path.join(run, "time.csv")))
            summaries = CS.read_summaries(os.path.join(run, "json"))
            status = {n: s["queryStatus"][0] for n, s in summaries.items()}
            rec = {"phase": "fuse_stream_ab", "turn": turn, "side": side,
                   "sf": args.sf, "templates": args.templates,
                   "power_test_ms": log["Power Test Time"],
                   "process_s": wall, "statements": len(status),
                   "not_completed": {n: s for n, s in status.items()
                                     if s != "Completed"}}
            CS.emit(rec)
            out[side].append(rec)
        CS.emit({"phase": "fuse_stream_ab_medians", "sf": args.sf,
                 "templates": args.templates, "order": args.order,
                 **{f"{side}_power_test_ms": float(np.median(
                     [r["power_test_ms"] for r in recs]))
                    for side, recs in out.items() if recs},
                 **{f"{side}_process_s": float(np.median(
                     [r["process_s"] for r in recs]))
                    for side, recs in out.items() if recs}})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
