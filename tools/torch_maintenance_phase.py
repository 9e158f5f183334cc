#!/usr/bin/env python3
"""chip_smoke.py's `maintenance` phase alone, on one NVIDIA GPU, at the scale
factor given (made for SF10): nds_tpu_torch's gen_data makes the data,
cli/transcode.py loads it into a lakehouse warehouse (4 workers, as the
lakehouse phase does) and gen_query_stream makes stream 0; then the phase
itself (chip_smoke.maintenance_phase): the refresh data (gen_data --update
1), the 11 refresh functions through cli/maintenance.py on the card with
--optimize and, beside them, on a copy on the CPU; the fact tables card
against CPU, the DF_* deletes against pyarrow counts, rollback, and
maintenance under load (stream 0's first
chip_smoke.MAINTENANCE_TEMPLATES templates). With --sf100 it
first runs step 6, DF_SS's survivor query over chip_smoke's SF100 tables
(made with numpy, ~26 GiB on the card).

Prints the card's `nvidia-smi` name and power limit, the versions and the
host, the kernel build's seconds, then the phases' own JSON lines
(`stream_data`, `maintenance_sf100`, `maintenance_refresh`,
`maintenance_function`, `maintenance`, `maintenance_cpu`,
`maintenance_rollback`, `maintenance_under_load`, `maintenance_done`) and
a last line with the launches and the seconds. With --log_dir every JSON
line is also appended to <log_dir>/maintenance.jsonl as it is printed.
Exits non-zero where a gate fails.

Usage (from the repository root, on the card):
    python3 tools/torch_maintenance_phase.py [--sf 10] [--sf100]
        [--log_dir DIR]
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--sf100", action="store_true",
                    help="run step 6 over the SF100 tables first")
    ap.add_argument("--log_dir",
                    help="where the JSON lines go as they are printed "
                    "(default: nowhere but standard output)")
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
    # start the CUDA context now: the phase reads the allocator's peak
    # statistics before its first session allocates anything
    torch.zeros(1, device=dev)
    from nds_tpu_torch.ops import _build
    from nds_tpu_torch.ops import gpu_kernels as GK

    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        sink = open(os.path.join(args.log_dir, "maintenance.jsonl"), "a",
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
    if args.sf100:
        from nds_tpu_torch.analysis import budget as B
        from nds_tpu_torch.engine import exec as TX
        from nds_tpu_torch.engine.session import Session

        star = CS.make_star(0, 1.0)  # chip_smoke.py's default seed
        tables = CS.to_tables(star, dev)
        CS.maintenance_sf100(torch, GK, TX, B, Session, star, tables, dev,
                             on)
        del star, tables
        torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="nds_maintenance_")
    try:
        d = os.path.join(root, "A")
        raw, rows = CS.generate("A", d, args.sf)
        wh, load_test_s, converted = CS.finish_lake_load(CS.start_lake_load(
            "lakehouse", d, raw, "--workers", CS.LAKE_WORKERS))
        if converted != sum(rows.values()):
            CS.fail(f"lakehouse load: converted {converted} rows of "
                    f"{sum(rows.values())}")
        shutil.rmtree(raw)
        with open(os.path.join(d, "load_lakehouse.report")) as fh:
            seed = re.search(r"^RNGSEED used: (\d+)$", fh.read(),
                             re.M).group(1)
        streams = os.path.join(d, "streams")
        CS.run_cli(os.path.join(d, "gen_query_stream.log"),
                   "nds_tpu_torch.cli.gen_query_stream", "--streams", 1,
                   "--scale", args.sf, "--rngseed", seed, "--output_dir",
                   streams)
        CS.emit({"phase": "maintenance_load", "sf": args.sf,
                 "load_test_s": load_test_s, "rows": converted,
                 "files_per_fact_table": {
                     t: f for t, (f, _) in
                     CS.lake_files_per_table(wh).items()}})
        launches = CS.maintenance_phase(
            torch, GK, dev, d, wh, args.sf,
            os.path.join(streams, "query_0.sql"), on)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"maintenance_launches": launches,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
