#!/usr/bin/env python3
"""chip_smoke.py's `lakehouse` phase alone, on one NVIDIA GPU, at the scale
factors given (made for SF10 / SF1): nds_tpu_torch's gen_data and
transcode make leg A (decimals) and leg B (--floats) as parquet
warehouses, their .dat files kept; stream 0 of leg A runs through
cli/power.py with the kernels on (run `A_on`, the answers the lakehouse
stream is validated against) and stream 0 of leg B the same (run
`B_card`, the csv and orc statements' reference); then the phase itself
(chip_smoke.lakehouse_phase): the lakehouse Load Test with its workers and
--resume, the 103-statement stream over the lakehouse, zone-map pruning,
the pinned reader racing compaction and vacuum, and the csv and orc
warehouses.

Prints the card's `nvidia-smi` name and power limit, the versions and the
host, the kernel build's seconds, then the phases' own JSON lines
(`stream_data`, `stream_load`, `stream_query`, `stream`,
`lakehouse_load`, `lakehouse_stream`, `lakehouse_prune`,
`lakehouse_isolation`, `lakehouse_formats`, `lakehouse`) and a last line
with the launches and the seconds. With --log_dir every JSON line is also
appended to <log_dir>/lakehouse.jsonl as it is printed, and the lakehouse
stream's summaries are written there as they come. Exits non-zero where a
gate fails.

Usage (from the repository root, on the card):
    python3 tools/torch_lakehouse_phase.py [--sf-a 10] [--sf-b 1]
        [--log_dir DIR]
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf-a", type=float, default=10.0)
    ap.add_argument("--sf-b", type=float, default=1.0)
    ap.add_argument("--log_dir",
                    help="where the JSON lines and the lakehouse stream's "
                    "summaries go as they are written (default: nowhere but "
                    "standard output)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.environ["NDS_PLAN_BUDGET_STRICT"] = "1"
    import pyarrow
    import torch

    import chip_smoke as CS
    from nds_tpu_torch.engine.session import resolve_device

    if not torch.cuda.is_available():
        CS.fail("torch.cuda.is_available() is false: this needs a GPU")
    # before any other CUDA call (the allocator's expandable segments)
    dev = resolve_device("cuda:0")
    from nds_tpu_torch import power as TP
    from nds_tpu_torch.ops import _build
    from nds_tpu_torch.ops import gpu_kernels as GK

    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        sink = open(os.path.join(args.log_dir, "lakehouse.jsonl"), "a",
                    buffering=1)
        emit = CS.emit

        def emit_and_log(obj):
            sink.write(json.dumps(obj) + "\n")
            return emit(obj)
        CS.emit = emit_and_log
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    CS.emit({"phase": "host", "python": sys.version,
             "torch": torch.__version__, "cuda": torch.version.cuda,
             "pyarrow": pyarrow.__version__, "cores": os.cpu_count(),
             "tmp_free_bytes": shutil.disk_usage(tempfile.gettempdir()).free})
    t0 = time.perf_counter()
    _build.build_all()
    CS.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    on = {f"engine.pallas_{k}": "on" for k in ("agg", "join", "sort")}
    root = tempfile.mkdtemp(prefix="nds_lakehouse_")
    try:
        legs = {}
        for leg, sf, floats in (("A", args.sf_a, False),
                                ("B", args.sf_b, True)):
            d = os.path.join(root, leg)
            raw, rows = CS.generate(leg, d, sf)
            wh, stream, names = CS.finish_load(
                leg, d, sf, raw, rows, CS.start_load(d, raw, floats),
                keep_raw=True)
            run = "A_on" if leg == "A" else "B_card"
            summaries, log, per_query, launches, secs = CS.stream_card_run(
                torch, GK, TP, dev, run, d, wh, stream, names, on, floats)
            CS.stream_queries(run, summaries, per_query)
            line = CS.stream_line(leg, run, log, summaries, per_query,
                                  launches, secs, None, None, [])
            legs[leg] = (d, raw, rows, sf, wh, stream, names, line)
        ra, raw_a, rows_a, sf_a, wh_a, stream_a, names_a, a_on = legs["A"]
        rb, raw_b, _, sf_b, _, stream_b, names_b, _ = legs["B"]
        launches = CS.lakehouse_phase(torch, GK, dev, {
            "root_a": ra, "raw_a": raw_a, "sf_a": sf_a, "wh_a": wh_a,
            "stream_a": stream_a, "names_a": names_a,
            "a_on_dir": os.path.join(ra, "A_on"), "a_on": a_on,
            "rows_a": rows_a, "root_b": rb, "raw_b": raw_b, "sf_b": sf_b,
            "stream_b": stream_b, "names_b": names_b,
            "b_card_dir": os.path.join(rb, "B_card"), "reduced": []},
            on, log_dir=args.log_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"lakehouse_launches": launches,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
