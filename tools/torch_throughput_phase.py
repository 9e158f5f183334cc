#!/usr/bin/env python3
"""chip_smoke.py's `throughput` phase alone, on one NVIDIA GPU, at the scale
and stream count given (made for SF10 with 4 streams: TPC-DS Spec 4.3.2
asks for S >= 4): nds_tpu_torch's gen_data and transcode make a decimal
warehouse (leg A of the stream phase), stream 0 runs alone through
cli/power.py with the kernels on (the single-stream reference Ttt is held
against), then streams 1..S run at once through cli/throughput.py in thread
mode, each session with 1/S of the card's catalog and working-set lines
(chip_smoke.throughput_conf), and the statements reading the most fact
rows are validated against a run without concurrency.

Prints the card's `nvidia-smi` name and power limit, the versions and the
host, the kernel build's seconds, then the phases' own JSON lines
(`stream_data`, `stream_load`, `stream_query` of the single stream,
`throughput_query`, `throughput`, `throughput_validate`) and a last line
with the launches and the seconds. Exits non-zero where a gate fails.

Usage (from the repository root, on the card):
    python3 tools/torch_throughput_phase.py [--sf 10] [--streams 4]
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
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--log_dir",
                    help="where the throughput run writes its log, time "
                    "logs and JSON summaries as it goes (default: beside "
                    "the warehouse, removed at the end)")
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
    off = {f"engine.pallas_{k}": "off" for k in ("agg", "join", "sort")}
    root = tempfile.mkdtemp(prefix="nds_throughput_")
    try:
        ra = os.path.join(root, "A")
        raw, rows = CS.generate("A", ra, args.sf)
        wh, stream, names = CS.finish_load(
            "A", ra, args.sf, raw, rows, CS.start_load(ra, raw, False))
        summaries, log, per_query, single_launches, _ = CS.stream_card_run(
            torch, GK, TP, dev, "A_on", ra, wh, stream, names, on, False)
        CS.stream_queries("A_on", summaries, per_query)
        a_on = {"power_test_ms": dict(log)["Power Test Time"],
                "load_ms": sum(r.get("load_ms", 0.0)
                               for r in per_query.values())}
        CS.emit({"phase": "single_stream", "sf": args.sf, **a_on,
                 "peak_gib": max(r.get("peak_gib", 0.0)
                                 for r in per_query.values()),
                 "launches": single_launches})
        launches = CS.throughput_phase(
            torch, GK, dev, ra, wh, args.sf, on, off, a_on, [],
            streams=tuple(range(1, args.streams + 1)), log_dir=args.log_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"single_stream_launches": single_launches,
                      "throughput_launches": launches,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
