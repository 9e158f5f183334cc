#!/usr/bin/env python3
"""chip_smoke.py's `bench` phase alone, on one NVIDIA GPU, at the size it
was made for: the whole benchmark through nds_tpu_torch.cli.bench at
--sf (10) with --streams (3) streams over a lakehouse warehouse, every
template of every stream (no sub_queries), all 11 refresh functions, the
power_test property file with the kernels on, and maintenance under load
enabled (over stream 1's first --under_load_templates templates, as the
maintenance phase runs it). As in the script, the CLI first runs with
--fault_spec crash:power_test (gen_data with its refresh sets, the Load
Test and gen_query_stream, then the crash), then with --resume (the Power
Test, both Throughput Tests, both Maintenance Tests and the under-load
run on the card); the gates are the script's (chip_smoke.bench_phase),
and `maintenance_under_load_error` in metrics.csv fails the tool. The
Load Test ingests with NDS_TRANSCODE_WORKERS (4 unless set) workers.

Prints the card's `nvidia-smi` name and power limit, the versions and the
host, the kernel build's seconds, then the phase's JSON lines
(`bench_phase` per orchestrator phase, `bench`: Tload, Tpower, Ttt1, Ttt2,
Tdm1, Tdm2, perf_metric, each phase's seconds, the card's peak memory in
use while the --resume step ran, the under-load report) and a last line
with the seconds. With --log_dir every JSON line is also appended to
<log_dir>/bench.jsonl as it is printed, and the orchestrator's two logs
are copied there. Exits non-zero where a gate fails.

Usage (from the repository root, on the card):
    python3 tools/torch_bench_phase.py [--sf 10] [--streams 3]
        [--under_load_templates 40] [--log_dir DIR]
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
    ap.add_argument("--streams", type=int, default=3,
                    help="num_streams: odd, >= 3 (the Power stream and two "
                    "Throughput Tests of (streams - 1) / 2 streams)")
    ap.add_argument("--under_load_templates", type=int, default=40,
                    help="stream 1's first templates in the under-load run")
    ap.add_argument("--log_dir",
                    help="where the JSON lines and the orchestrator's logs "
                    "go (default: nowhere but standard output)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.environ["NDS_PLAN_BUDGET_STRICT"] = "1"
    os.environ.setdefault("NDS_TRANSCODE_WORKERS", "4")
    import pyarrow
    import torch

    import chip_smoke as CS

    if not torch.cuda.is_available():
        CS.fail("torch.cuda.is_available() is false: this needs a GPU")
    from nds_tpu_torch.ops import _build

    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        sink = open(os.path.join(args.log_dir, "bench.jsonl"), "a",
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
    # this process touches no CUDA: the orchestrator's phases are processes
    # of their own, and the card's name comes from nvidia-smi
    _build.build_all()
    CS.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    kind = subprocess.run(["nvidia-smi", "--query-gpu=name",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.splitlines()[0]
    on = {f"engine.pallas_{k}": "on" for k in ("agg", "join", "sort")}
    root = tempfile.mkdtemp(prefix="nds_bench_")
    st = CS.bench_start(root, args.sf, args.streams, on,
                        under_load=CS.template_names(
                            args.under_load_templates))
    try:
        CS.bench_phase(st, ("cuda", kind), [
            f"maintenance under load over stream 1's first "
            f"{args.under_load_templates} templates"])
    finally:
        if args.log_dir:
            for name in ("bench_crash.log", "bench_resume.log"):
                if os.path.exists(os.path.join(root, name)):
                    shutil.copy(os.path.join(root, name), args.log_dir)
        CS.stop_bench(st)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
