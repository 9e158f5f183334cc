#!/usr/bin/env python3
"""A/B of the spare-slot layout of nds_tpu_torch's reducing scatters, on one
NVIDIA GPU at TPC-DS SF100 row counts.

nds_tpu_torch/ops/kernels.py sends the lanes a segment scatter drops (and
the lanes of weight False, which add nothing) to SPARE_SLOTS spare slots
past the end of its output. This runs chip_smoke.py's joins-phase queries
on chip_smoke's SF100 tables with SPARE_SLOTS = 1 (every such lane on one
slot) and 1,024, in the turns 1, 1024, 1024, 1 per query, in one process,
and prints one JSON line per query and turn: the median ms of 3 runs after
a warm-up with the kernels on (and, for q93, off). The first line is the
card's `nvidia-smi` name and power limit.

Usage (from the repository root, on the card): python3 tools/torch_spare_slots_ab.py
"""

import json
import os
import subprocess
import sys
import time

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nds_tpu_torch.engine.session import Session  # noqa: E402
from nds_tpu_torch.ops import kernels as K  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    tables = cs.to_tables(cs.make_star(0, 1.0), "cuda")
    sess = {}
    for mode in ("on", "off"):
        s = Session(conf={f"engine.pallas_{k}": mode
                          for k in ("agg", "join", "sort")})
        for n, t in tables.items():
            s.register_table(n, t)
        sess[mode] = s

    def run(s, q):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = s.sql(cs.JOIN_QUERIES[q]).collect()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    for q in cs.JOIN_QUERIES:
        for spare in (1, 1024, 1024, 1):
            K.SPARE_SLOTS = spare
            rec = {"query": q, "spare_slots": spare}
            for mode in ("on", "off") if q == "q93" else ("on",):
                res, _ = run(sess[mode], q)
                rec[mode + "_ms"] = float(np.median(
                    [run(sess[mode], q)[1] for _ in range(3)]))
                rec[mode + "_rows"] = res.num_rows
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
