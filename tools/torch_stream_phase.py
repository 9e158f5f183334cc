#!/usr/bin/env python3
"""chip_smoke.py's `stream` phase alone, on one NVIDIA GPU: the whole NDS
chain of nds_tpu_torch (gen_data, transcode, gen_query_stream, the Power
Run of a generated 103-statement stream 0, validate) at the scale factors
given, without the earlier phases.

Prints the card's `nvidia-smi` name and power limit, the versions and the
host (cores, free bytes of the temporary directory), the kernel build's
seconds, then the phase's own JSON lines (`stream_data`, `stream_load`,
`stream_query`, `stream`) and a last line with each leg's launches and the
seconds. Exits non-zero where the phase fails.

Usage (from the repository root, on the card):
    python3 tools/torch_stream_phase.py [--sf-a 10] [--sf-b 1] [--scale 1.0]
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
    ap.add_argument("--sf-a", type=float, default=None,
                    help="leg A's scale factor (default chip_smoke's)")
    ap.add_argument("--sf-b", type=float, default=None,
                    help="leg B's scale factor (default chip_smoke's)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="chip_smoke's --scale (F < 1 cuts both legs)")
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
    if args.sf_a is not None:
        CS.STREAM_SF_A = args.sf_a
    if args.sf_b is not None:
        CS.STREAM_SF_B = args.sf_b
    on = {f"engine.pallas_{k}": "on" for k in ("agg", "join", "sort")}
    off = {f"engine.pallas_{k}": "off" for k in ("agg", "join", "sort")}
    a, b = CS.stream_phase(torch, GK, dev, on, off, args.scale)
    print(json.dumps({"stream_a_launches": a, "stream_b_launches": b,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
