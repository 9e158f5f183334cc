#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (nds_tpu_torch) runs on a GPU.

Drives the port's main path on one NVIDIA H100 at TPC-DS SF100 row counts:
`Session.sql` -> parse / bind / prune -> scan -> filter -> dense star-join ->
group-by aggregate -> ORDER BY -> collect, with engine.pallas_agg,
engine.pallas_join and engine.pallas_sort set to `on`, so every
hand-written kernel of ops/csrc/ runs. Phases, each printing one JSON line:

  device   the card (plus the nvidia-smi name/power-limit line) and whether
           pyarrow imports
  build    nvcc builds every kernel from ops/csrc/, one process per source
  data     a q3-shaped star (store_sales, item, date_dim) made with numpy from
           --seed at SF100 row counts, loaded with table_from_numpy
  slice    three queries through Session(device="cuda"): q3 (segment sums +
           dense joins), a grouped min/max (segment extreme) and a one-word
           ORDER BY (counting sort). Launch counts are zeroed just before the
           three cold runs and read just after; results must equal the same
           session with the kernels off, and q3 must equal a numpy reference
  profile  torch.profiler over one steady run of each query: device time by
           kernel and the device's busy share of the wall time
  kernels  each kernel's wrapper on the inputs the main path gave it, held
           against its plain PyTorch version; kernel, plain and library
           times (CUDA events, median of 7 after a warm-up) beside the bound,
           the device time and device operations (kernels, memsets) of one
           call from torch.profiler, and the host time to enqueue one call,
           for the wrapper and (where it is launch-bound) the library call
  kernel_sweep  the kernels redesigned for Hopper against their plain
           versions at shapes beyond the main path's: segment_extreme's
           global-atomic path, sorted ids and one group; 2^21-row builds
           and dense_build's paths on both sides of its plan's threshold;
           sort_perm at 2^24 rows over domains 128..2048, one key, sorted,
           reverse-sorted, ragged, int32 and int64 words, small sorts of
           100..65,536 rows, sort_rank with -1 lanes; segment_sums at 2^26
           rows (random, sorted, 65,536 groups on the global path), 2^24
           rows of one group, and q3's 4,096 groups with one row, with 2^18
           dead rows and q3-shaped on three grids

Any failed phase exits non-zero. The line before the last is the kernel
table as JSON; the last line is {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py [--seed N] [--scale F]   (F < 1 cuts row counts)
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: TPC-DS v3.2.0 Table 3-2 row counts at SF100
#: (nds_tpu/datagen/native/rowcounts.hpp)
SF100_ROWS = {"store_sales": 287_997_024, "item": 204_000, "date_dim": 73_049}
DATE_FIRST_SK = 2415022  # julian day of 1900-01-02, date_dim's first row
SALES_FIRST_SK, SALES_LAST_SK = 2450815, 2452642  # 1998-01-01 .. 2002-12-31
JULIAN_OF_EPOCH = 2440588
N_STORE_SF100 = 402
H100_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)

QUERIES = {
    # tests/test_dist_sql.py star_agg_q3, verbatim
    "q3": """
        select d.d_year, i.i_brand_id brand_id, sum(ss_ext_sales_price) s,
               count(*) cnt
        from date_dim d, store_sales, item i
        where d.d_date_sk = ss_sold_date_sk and ss_item_sk = i.i_item_sk
          and i.i_manager_id = 10 and d.d_moy = 11
        group by d.d_year, i.i_brand_id
        order by d.d_year, s desc, brand_id
    """,
    "minmax": """
        select ss_store_sk, min(ss_ext_sales_price) mn,
               max(ss_ext_sales_price) mx
        from store_sales group by ss_store_sk order by ss_store_sk
    """,
    # > 95 keeps the filtered fact under the counting sort's 2^24-row cap
    # (exec._sort_perm_route) at SF100
    "order": """
        select ss_quantity, ss_item_sk from store_sales
        where ss_quantity > 95 order by ss_quantity
    """,
}

KERNEL_META = {
    "segment_sums": ("nds_tpu_torch/ops/csrc/segment_sums.cu",
                     "nds_tpu/ops/pallas_kernels.py:36"),
    "segment_extreme": ("nds_tpu_torch/ops/csrc/segment_extreme.cu",
                        "nds_tpu/ops/pallas_kernels.py:96"),
    "dense_build": ("nds_tpu_torch/ops/csrc/dense_build.cu",
                    "nds_tpu/ops/pallas_kernels.py:169"),
    "sort_perm": ("nds_tpu_torch/ops/csrc/sort_perm.cu",
                  "nds_tpu/ops/pallas_kernels.py:248"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_star(seed: int, scale: float):
    """numpy columns of the q3 star, shaped as nds_tpu/datagen/native makes
    them: dims.hpp (date_dim calendar, item brand/manager encodings) and
    facts.hpp (uniform sales dates over 1998-2002, odd current-SCD item and
    store keys, ~4% null nullable FKs, quantity 1..100). Measures are
    float64, as the --floats mode stores decimal(7,2)."""
    rng = np.random.default_rng(seed)
    n_dates = SF100_ROWS["date_dim"]
    n_items = max(2, int(SF100_ROWS["item"] * scale))
    n_fact = max(1024, int(SF100_ROWS["store_sales"] * scale))
    n_store = max(2, int(N_STORE_SF100 * scale))

    jd = DATE_FIRST_SK + np.arange(n_dates, dtype=np.int64)
    days = (jd - JULIAN_OF_EPOCH).astype("datetime64[D]")
    year = days.astype("datetime64[Y]").astype(np.int64) + 1970
    month = days.astype("datetime64[M]").astype(np.int64) % 12 + 1
    date_dim = {
        "d_date_sk": jd.astype(np.int32),
        "d_year": year.astype(np.int32),
        "d_moy": month.astype(np.int32),
    }
    cat = rng.integers(0, 10, n_items)
    cls = rng.integers(0, 8, n_items)
    brand = rng.integers(1, 11, n_items)
    item = {
        "i_item_sk": np.arange(1, n_items + 1, dtype=np.int32),
        "i_brand_id": ((cat + 1) * 1_000_000 + (cls + 1) * 1000 + brand)
        .astype(np.int32),
        "i_manager_id": rng.integers(1, 101, n_items, dtype=np.int32),
    }
    qty = rng.integers(1, 101, n_fact, dtype=np.int32)
    cents = rng.integers(50, 20_000, n_fact, dtype=np.int32)
    store_sales = {
        "ss_sold_date_sk": rng.integers(SALES_FIRST_SK, SALES_LAST_SK + 1,
                                        n_fact, dtype=np.int32),
        "ss_sold_date_sk__valid": rng.integers(0, 100, n_fact,
                                               dtype=np.int8) < 96,
        "ss_item_sk": (rng.integers(0, (n_items + 1) // 2, n_fact,
                                    dtype=np.int32) * 2 + 1),
        "ss_store_sk": (rng.integers(1, (n_store + 1) // 2 + 1, n_fact,
                                     dtype=np.int32) * 2 - 1),
        "ss_store_sk__valid": rng.integers(0, 100, n_fact, dtype=np.int8) < 96,
        "ss_quantity": qty,
        "ss_ext_sales_price": cents.astype(np.float64) * qty / 100.0,
    }
    return {"date_dim": date_dim, "item": item, "store_sales": store_sales}


def to_tables(star, device):
    from nds_tpu_torch.engine.columnar import table_from_numpy

    types = {"ss_ext_sales_price": "float64"}
    out = {}
    for name, cols in star.items():
        spec = {}
        nrows = None
        for cname, data in cols.items():
            if cname.endswith("__valid"):
                continue
            nrows = data.shape[0]
            spec[cname] = (data, cols.get(cname + "__valid"),
                           types.get(cname, "int32"), None)
        out[name] = table_from_numpy(spec, nrows, device=device)
    return out


def q3_reference(star):
    """q3 over the numpy star: {(year, brand): (sum, count)}."""
    d, i, f = star["date_dim"], star["item"], star["store_sales"]
    date_ok = d["d_moy"] == 11
    item_ok = i["i_manager_id"] == 10
    di = f["ss_sold_date_sk"].astype(np.int64) - DATE_FIRST_SK
    ii = f["ss_item_sk"].astype(np.int64) - 1
    keep = f["ss_sold_date_sk__valid"] & date_ok[di] & item_ok[ii]
    years = d["d_year"][di[keep]].astype(np.int64)
    brands = i["i_brand_id"][ii[keep]].astype(np.int64)
    code = years * 100_000_000 + brands
    uniq, inv = np.unique(code, return_inverse=True)
    sums = np.bincount(inv, weights=f["ss_ext_sales_price"][keep])
    counts = np.bincount(inv)
    return {
        (int(c // 100_000_000), int(c % 100_000_000)): (float(s), int(n))
        for c, s, n in zip(uniq, sums, counts)
    }


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def f32_sum_rtol(max_group_rows: int) -> float:
    """Relative tolerance of an f32-accumulated sum of up to
    `max_group_rows` non-negative terms against an exact one: each add
    rounds by at most 2^-24 of the running sum, and the f64 -> f32 input
    cast by 2^-24 of each term, so the error is below
    (rows + 1) * 2^-24 of the sum. Never tighter than the validator's
    1e-5 epsilon (nds_tpu/validate.py compare)."""
    return max(1e-5, (max_group_rows + 1) * 2.0**-24)


#: the sweep's bound on segment_sums' relative error against an f64 sum, for
#: non-negative values: a row's value reaches its group's f32 sum through
#: at most 9 roundings in its warp (four rows a lane, five shuffle steps),
#: one per add into its block's shared table before it, and one per block
#: flushed into the output before its own; each rounds by at most 2^-24 of
#: a partial sum no larger than the whole. The sweep's shapes make at most
#: ~800 (one group of 2^24 rows on 264 blocks: 9 + 497 + 264), ~4.8e-5;
#: the cap leaves twice that. Without it f32_sum_rtol's count-based bound
#: reaches ~1.0 at 2^24 rows of one group, where a zero sum would pass.
SWEEP_SUM_RTOL_CAP = 1e-4


def sweep_sum_rtol(max_group_rows: int) -> float:
    return min(f32_sum_rtol(max_group_rows), SWEEP_SUM_RTOL_CAP)


def q3_groups(res):
    """{(year, brand): (sum, count)} of a q3 result, after checking that its
    rows follow the query's ORDER BY (d_year, s desc, brand_id)."""
    rows = res.to_pylist()
    keys = [(r["d_year"], -r["s"], r["brand_id"]) for r in rows]
    if keys != sorted(keys):
        fail("q3 rows are not in ORDER BY order")
    return {(r["d_year"], r["brand_id"]): (r["s"], r["cnt"]) for r in rows}


def same_groups(got, ref, rtol, tag):
    """Keyed comparison (row order among near-equal float sums may differ
    between f32 and f64 accumulation): counts exact, sums within rtol."""
    if set(got) != set(ref):
        fail(f"q3 {tag}: group keys differ ({len(got)} vs {len(ref)})")
    worst = 0.0
    for key, (s, n) in ref.items():
        gs, gn = got[key]
        if gn != n:
            fail(f"q3 {tag}: count {gn} != {n} for {key}")
        rel = abs(gs - s) / max(abs(s), 1e-300)
        worst = max(worst, rel)
        if rel > rtol:
            fail(f"q3 {tag}: sum {gs} vs {s} for {key} (rel {rel})")
    return worst


def check_q3(got, ref, tag):
    rtol = f32_sum_rtol(max(n for _, n in ref.values()))
    return same_groups(q3_groups(got), ref, rtol, tag), rtol


def same_result(a, b, rtol, tag):
    """Two Arrow results equal: same columns and rows, ints exact, floats
    within `rtol` relative (NaN == NaN)."""
    if a.schema.names != b.schema.names or a.num_rows != b.num_rows:
        fail(f"{tag}: shape {a.schema.names}/{a.num_rows} vs "
             f"{b.schema.names}/{b.num_rows}")
    worst = 0.0
    for name in a.schema.names:
        x = a.column(name).to_numpy(zero_copy_only=False)
        y = b.column(name).to_numpy(zero_copy_only=False)
        if x.dtype.kind == "f" or y.dtype.kind == "f":
            x = x.astype(np.float64)
            y = y.astype(np.float64)
            both_nan = np.isnan(x) & np.isnan(y)
            denom = np.maximum(np.abs(y), 1e-300)
            rel = np.where(both_nan, 0.0, np.abs(x - y) / denom)
            worst = max(worst, float(rel.max()) if rel.size else 0.0)
            if not (rel <= rtol).all():
                fail(f"{tag}: column {name} differs (max rel {rel.max()})")
        elif not np.array_equal(x, y):
            fail(f"{tag}: column {name} differs")
    return worst


# ---------------------------------------------------------------------------
# kernel timing
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, reps=7):
    """Median ms of `reps` synchronized runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def host_us(torch, fn, reps=100):
    """Mean host time (us) to enqueue one call of `fn`: the wrapper's checks,
    allocations, launch and any torch ops around it, timed call by call
    with the device drained every 10 calls outside the timed part."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for i in range(reps):
        t = time.perf_counter()
        fn()
        total += time.perf_counter() - t
        if i % 10 == 9:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return total / reps * 1e6


def device_time(torch, fn, reps=5):
    """(device ms, device operations, {operation: [ms, count]}) of one call
    of `fn`: torch.profiler over `reps` calls after a warm-up, kernels,
    memsets and copies only, divided by `reps`; the last item names each
    device operation (kernel name, cut to 70 characters), so the passes of
    a multi-kernel call show apart. The window opens with a marker kernel
    (torch.cuda._sleep's spin kernel), left out of the sums: the tracer may
    drop the first device activity of a window, and the marker takes that
    place. (None, None, None) when the profiler records no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us, ops, by_op = 0.0, 0, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        # device activity rows (kernels, memsets, copies), not the marker
        if us > 0 and e.self_cpu_time_total == 0 and "spin_kernel" not in e.key:
            dev_us += us
            ops += e.count
            by_op[e.key[:70]] = [us / 1e3 / reps, e.count / reps]
    if ops == 0:
        return None, None, None
    return dev_us / 1e3 / reps, ops / reps, by_op


def kernel_rows(torch, GK, captured, launches):
    """Kernel vs plain on the main path's own inputs: agreement, times and
    the byte bound of each kernel."""
    out = []
    for name, (src, replaces) in KERNEL_META.items():
        if name not in captured:
            fail(f"kernel {name}: the main path never called it")
        args = captured[name]
        rec = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[name]}
        if name == "segment_sums":
            vals, gid, g = args
            n = vals.shape[0]
            ks, kc = GK.segment_sums(vals, gid, g)
            ps, pc = GK.segment_sums_plain(vals, gid, g)
            torch.cuda.synchronize()
            exact = bool(torch.equal(kc, pc))
            # f32 sums in two orders: bounded by the largest group's count
            rtol = f32_sum_rtol(int(pc.max().item()))
            err = float((ks - ps).abs().max().item())
            ok = exact and bool(
                ((ks - ps).abs() <= rtol * ps.abs().clamp(min=1.0)).all()
            )
            slot = torch.where((gid >= 0) & (gid < g), gid, g).long()

            def lib():
                return torch.zeros(g + 1, dtype=torch.float32,
                                   device=vals.device).index_add_(0, slot,
                                                                  vals)
            nbytes = n * 8 + g * 8
            extra = {"n": n, "groups": g, "counts_exact": exact,
                     "rtol": rtol}
            run_k = lambda: GK.segment_sums(vals, gid, g)  # noqa: E731
            run_p = lambda: GK.segment_sums_plain(vals, gid, g)  # noqa: E731
        elif name == "segment_extreme":
            vals, gid, g, is_max = args
            n = vals.shape[0]
            ke, kc = GK.segment_extreme(vals, gid, g, is_max)
            pe, pc = GK.segment_extreme_plain(vals, gid, g, is_max)
            torch.cuda.synchronize()
            exact = bool(torch.equal(kc, pc))
            same = bool(torch.equal(torch.nan_to_num(ke), torch.nan_to_num(pe)))
            live = pc > 0
            err = float((ke[live] - pe[live]).abs().max().item()) if bool(
                live.any()) else 0.0
            ok = exact and same
            slot = torch.where((gid >= 0) & (gid < g), gid, g).long()
            fill = float("-inf") if is_max else float("inf")

            def lib():
                return torch.full((g + 1,), fill, dtype=torch.float32,
                                  device=vals.device).scatter_reduce_(
                    0, slot, vals, "amax" if is_max else "amin")
            nbytes = n * 8 + g * 8
            extra = {"n": n, "groups": g, "is_max": is_max,
                     "counts_exact": exact, "values_exact": same}
            run_k = lambda: GK.segment_extreme(vals, gid, g, is_max)  # noqa: E731
            run_p = lambda: GK.segment_extreme_plain(vals, gid, g, is_max)  # noqa: E731
        elif name == "dense_build":
            rkey, rlive, rmin, cap = args
            n = rkey.shape[0]
            kp, kr = GK.dense_build(rkey, rlive, rmin, cap)
            pp, pr = GK.dense_build_plain(rkey, rlive, rmin, cap)
            torch.cuda.synchronize()
            ok = bool(torch.equal(kp, pp)) and bool(torch.equal(kr, pr))
            err = float((kr.long() - pr.long()).abs().max().item())
            sl = rkey - rmin
            slot = torch.where(rlive & (sl >= 0) & (sl < cap), sl, cap)
            rows = torch.arange(n, dtype=torch.int32, device=rkey.device)

            def lib():
                return torch.zeros(cap + 1, dtype=torch.int32,
                                   device=rkey.device).scatter_reduce_(
                    0, slot, rows, "amax")
            nbytes = n * 9 + cap * 5
            extra = {"n": n, "table_cap": cap, "tables_exact": ok}
            run_k = lambda: GK.dense_build(rkey, rlive, rmin, cap)  # noqa: E731
            run_p = lambda: GK.dense_build_plain(rkey, rlive, rmin, cap)  # noqa: E731
        else:
            word, dom = args
            n = word.shape[0]
            kperm = GK.sort_perm(word, dom)
            pperm = GK.sort_perm_plain(word, dom)
            torch.cuda.synchronize()
            ok = bool(torch.equal(kperm, pperm))
            err = float((kperm.long() - pperm.long()).abs().max().item())

            def lib():
                return torch.sort(word, stable=True)
            nbytes = n * word.element_size() + n * 4
            extra = {"n": n, "domain": dom, "perm_exact": ok}
            run_k = lambda: GK.sort_perm(word, dom)  # noqa: E731
            run_p = lambda: GK.sort_perm_plain(word, dom)  # noqa: E731
        if not ok:
            fail(f"kernel {name} disagrees with its plain version: {extra}")
        rec["max_abs_err"] = rec["max_err"] = err
        rec["ms"] = rec["kernel_ms"] = cuda_ms(torch, run_k)
        rec["plain_ms"] = cuda_ms(torch, run_p)
        rec["bound_ms"] = nbytes / H100_BYTES_PER_S * 1e3
        rec["bound_by"] = "bytes"
        rec["library_ms"] = cuda_ms(torch, lib)
        (rec["device_ms"], rec["device_ops"],
         rec["device_by_op"]) = device_time(torch, run_k)
        rec["host_us"] = host_us(torch, run_k)
        # the library call's host and device time only where it is
        # launch-bound (the others take hundreds of ms a call)
        rec["library_host_us"] = rec["library_device_ms"] = None
        rec["library_device_ops"] = None
        if rec["library_ms"] < 1.0:
            rec["library_host_us"] = host_us(torch, lib)
            rec["library_device_ms"], rec["library_device_ops"], _ = (
                device_time(torch, lib))
        emit({"phase": "kernel", **rec, **extra})
        out.append(rec)
    return out


def kernel_sweep(torch, GK, dev, seed, scale=1.0):
    """The kernels redesigned for Hopper at shapes the main path does not
    give them: segment_extreme's global-atomic path (2^26 lanes, 65,536
    groups), sorted ids and one group (single-group warps), and dense_build
    at customer scale (2^21 rows, 2^21 slots); then dense_build's owner and
    cooperative paths on both sides of the plan's threshold; sort_perm's
    and segment_sums' cases (module docstring). Each case must equal the
    plain version exactly (segment_sums: counts exactly, sums within
    sweep_sum_rtol of an f64 sum); kernel ms (CUDA events), device ms and
    operations, by operation (profiler), plain ms and the byte bound. These
    launches are not the main path's and are not counted there. `scale` < 1
    cuts the row counts."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []

    def timed(rec, run_k, run_p, nbytes, check):
        if not check():
            fail(f"kernel_sweep {rec}: kernel disagrees with plain version")
        rec["exact"] = True
        rec["ms"] = cuda_ms(torch, run_k)
        (rec["device_ms"], rec["device_ops"],
         rec["device_by_op"]) = device_time(torch, run_k)
        rec["plain_ms"] = cuda_ms(torch, run_p, reps=3) if run_p else None
        rec["bound_ms"] = nbytes / H100_BYTES_PER_S * 1e3
        rec["bound_by"] = "bytes"
        emit({"phase": "kernel_sweep", **rec})
        rows.append(rec)

    for case, n, g in [("global", 1 << 26, 65536), ("sorted", 1 << 26, 1024),
                       ("one_group", 1 << 24, 1)]:
        n = max(1024, int(n * scale))
        vals = torch.randn(n, generator=gen, device=dev)
        gid = torch.randint(-1, g, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        if case == "sorted":
            gid = torch.sort(gid).values
        elif case == "one_group":
            gid.zero_()

        def check(vals=vals, gid=gid, g=g):
            ke, kc = GK.segment_extreme(vals, gid, g, True)
            pe, pc = GK.segment_extreme_plain(vals, gid, g, True)
            return bool(torch.equal(kc, pc)) and bool(torch.equal(ke, pe))
        plan = GK.segment_extreme_plan(n, g, n_sm)
        timed({"name": "segment_extreme", "case": case, "n": n, "groups": g,
               "tables": plan.tables, "blocks": plan.blocks},
              lambda: GK.segment_extreme(vals, gid, g, True),
              lambda: GK.segment_extreme_plain(vals, gid, g, True),
              n * 8 + g * 8, check)
        del vals, gid

    def dense_case(n, cap, paths, case):
        perm = torch.randperm(cap, generator=gen, device=dev)[:n]
        rkey = perm.to(torch.int64) - 5
        rlive = torch.rand(n, generator=gen, device=dev) > 0.04
        for path in paths:
            plan = (GK.dense_build_plan(0, cap) if path == "owner" else
                    GK.DensePlan(path, 0, 0))

            def check(plan=plan):
                kp, kr = GK.dense_build(rkey, rlive, -5, cap, plan=plan)
                pp, pr = GK.dense_build_plain(rkey, rlive, -5, cap)
                return bool(torch.equal(kp, pp)) and bool(torch.equal(kr, pr))
            chosen = GK.dense_build_plan(n, cap).path
            timed({"name": "dense_build", "case": case, "n": n,
                   "table_cap": cap, "path": plan.path,
                   "slots": plan.slots,
                   "plan_picks": chosen == path},
                  lambda plan=plan: GK.dense_build(rkey, rlive, -5, cap,
                                                   plan=plan),
                  (lambda: GK.dense_build_plain(rkey, rlive, -5, cap))
                  if path == chosen else None,
                  n * 9 + cap * 5, check)

    big = max(1024, int((1 << 21) * scale))
    dense_case(big, 1 << 21, ("cooperative",), "customer")
    for cap in (1 << 18, 1 << 21):
        edge = GK.dense_owner_max_rows(cap)
        for n in sorted({1024, 4096, edge // 2, edge, 2 * edge, 8 * edge}):
            dense_case(n, cap, ("owner", "cooperative"), "threshold")

    # -- sort_perm / sort_rank ---------------------------------------------
    def sort_case(case, n, dom, dtype=torch.int64):
        w = torch.randint(0, dom, (n,), generator=gen, device=dev,
                          dtype=dtype)
        if case == "one_key":
            w.fill_(dom // 2)
        elif case == "sorted":
            w = torch.sort(w).values
        elif case == "reverse":
            w = torch.sort(w, descending=True).values
        plan = GK.sort_perm_plan(n, dom, n_sm)

        def check():
            return bool(torch.equal(GK.sort_perm(w, dom),
                                    GK.sort_perm_plain(w, dom)))
        timed({"name": "sort_perm", "case": case, "n": n, "domain": dom,
               "word": str(dtype).split(".")[-1], "blocks": plan.blocks},
              lambda: GK.sort_perm(w, dom),
              lambda: GK.sort_perm_plain(w, dom),
              n * w.element_size() + n * 4, check)

    big = max(4096, int((1 << 24) * scale))
    sort_case("random", big, 2048)
    sort_case("random", big, 128)
    sort_case("one_key", big, 384)
    sort_case("sorted", big, 2048)
    sort_case("reverse", big, 2048)
    sort_case("ragged", big - 1, 384)
    sort_case("random", big, 384, torch.int32)
    sort_case("random", big, 384, torch.int64)
    for n in (100, 4096, 4097, 65536):
        sort_case("small", n, 384)
    v = torch.randint(0, 384, (big,), generator=gen, device=dev,
                      dtype=torch.int32)
    v[::17] = -1  # padding lanes: counted nowhere, rank unspecified
    live = v >= 0

    def rank_check():
        r, h = GK.sort_rank(v, 384)
        pr, ph = GK.sort_rank_plain(v, 384)
        return bool(torch.equal(h, ph)) and bool(torch.equal(r[live],
                                                              pr[live]))
    timed({"name": "sort_rank", "case": "padding_lanes", "n": big,
           "domain": 384, "blocks": GK.sort_perm_plan(big, 384, n_sm).blocks},
          lambda: GK.sort_rank(v, 384), lambda: GK.sort_rank_plain(v, 384),
          big * 4 + big * 4 + 384 * 4, rank_check)
    del v, live

    # -- segment_sums ------------------------------------------------------
    # non-negative values, so each sum is held against an f64 one within
    # sweep_sum_rtol; counts exact against the plain version
    # q3's 4,096 groups with one row (launch, zeroing and the grid barrier
    # alone) and with 2^18 dead rows (the loads too, no folding): what the
    # main path's 2^18 rows cost beyond them is the folding
    for case, n, g in [("random", 1 << 26, 1024), ("global", 1 << 26, 65536),
                       ("sorted", 1 << 26, 1024), ("one_group", 1 << 24, 1),
                       ("one_row", 1, 4096), ("all_dead", 1 << 18, 4096)]:
        n = max(1, int(n * scale)) if n == 1 else max(1024, int(n * scale))
        vals = torch.rand(n, generator=gen, device=dev)
        gid = torch.randint(-1, g, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        if case == "sorted":
            gid = torch.sort(gid).values
        elif case == "one_group":
            gid.zero_()
        elif case == "all_dead":
            gid.fill_(-1)
        slot = torch.where(gid >= 0, gid, g).long()
        exact = torch.zeros(g + 1, dtype=torch.float64,
                            device=dev).index_add_(0, slot, vals.double())[:g]
        plan = GK.segment_sums_plan(n, g, n_sm)
        rec = {"name": "segment_sums", "case": case, "n": n, "groups": g,
               "tables": plan.tables, "blocks": plan.blocks}

        def check(vals=vals, gid=gid, g=g, exact=exact, rec=rec):
            ks, kc = GK.segment_sums(vals, gid, g)
            _, pc = GK.segment_sums_plain(vals, gid, g)
            rec["rtol"] = sweep_sum_rtol(int(pc.max().item()))
            rel = ((ks.double() - exact).abs()
                   / exact.abs().clamp(min=1e-300))[pc > 0]
            rec["max_rel_vs_f64"] = (float(rel.max().item()) if rel.numel()
                                     else 0.0)
            rec["counts_exact"] = bool(torch.equal(kc, pc))
            return rec["counts_exact"] and rec["max_rel_vs_f64"] <= rec["rtol"]
        timed(rec, lambda: GK.segment_sums(vals, gid, g),
              lambda: GK.segment_sums_plain(vals, gid, g),
              n * 8 + g * 8, check)
        del vals, gid, slot, exact

    # q3's shape (2^18 rows, 4,096 groups): ~230K live rows sorted into
    # 2,870 runs, 4% dead lanes between them, a dead tail; the plan's grid
    # against wider ones (fewer rows per warp, shorter chains of shuffles)
    n, g = 1 << 18, 4096
    live_n = int(n * 0.88)
    gid = torch.full((n,), -1, dtype=torch.int32, device=dev)
    gid[:live_n] = torch.sort(torch.randint(
        0, 2870, (live_n,), generator=gen, device=dev,
        dtype=torch.int32)).values
    gid[torch.rand(n, generator=gen, device=dev) < 0.04] = -1
    vals = torch.rand(n, generator=gen, device=dev)
    chosen = GK.segment_sums_plan(n, g, n_sm)
    for blocks in sorted({chosen.blocks, n_sm, 2 * n_sm}):
        plan = chosen._replace(blocks=blocks)

        def check(plan=plan):
            ks, kc = GK._segment_sums_launch(vals, gid, g, plan)
            ps, pc = GK.segment_sums_plain(vals, gid, g)
            rtol = f32_sum_rtol(int(pc.max().item()))
            return bool(torch.equal(kc, pc)) and bool(
                ((ks - ps).abs() <= 2 * rtol * ps.abs()).all())
        timed({"name": "segment_sums", "case": "q3_shape", "n": n,
               "groups": g, "tables": plan.tables, "blocks": blocks,
               "plan_picks": blocks == chosen.blocks},
              lambda plan=plan: GK._segment_sums_launch(vals, gid, g, plan),
              lambda: GK.segment_sums_plain(vals, gid, g),
              n * 8 + g * 8, check)
    return rows


def profile_query(torch, run_once, q, top=10):
    """Where one steady run's time goes: torch.profiler's device time by
    kernel, the device's busy share of the wall time, and the launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_ms = run_once()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        # device activity only (kernels, memcpy, memset): the aten:: op rows
        # carry the same device time again beside their CPU time
        if dev_us > 0 and e.self_cpu_time_total == 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    return {
        "phase": "profile", "query": q, "wall_ms": wall_ms,
        "device_ms": device_ms if rows else None,
        "device_busy_share": device_ms / wall_ms if rows else None,
        "device_launches": sum(r[1] for r in rows) if rows else None,
        "top": [{"kernel": k[:80], "ms": ms, "calls": c}
                for ms, c, k in rows[:top]],
    }


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of SF100 row counts (1.0 = SF100)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    if not os.path.isdir(os.path.join(ROOT, "nds_tpu_torch")):
        fail(f"no nds_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.ops import _build
    from nds_tpu_torch.ops import gpu_kernels as GK

    # -- device ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    try:
        import pyarrow  # noqa: F401

        has_pyarrow = True
    except ImportError:
        has_pyarrow = False
    kind = torch.cuda.get_device_name(0)
    print(smi_line, flush=True)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi_line,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "pyarrow": has_pyarrow})
    dev = torch.device("cuda", 0)

    # -- build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    spills = {}  # ptxas's spill stores per source, where it built here
    for name in built:
        with open(os.path.join(_build.BUILD_DIR, f"{name}.log")) as f:
            spills[name] = sum(int(b) for b in re.findall(
                r"(\d+) bytes spill stores", f.read()))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(built), "sources": _build.sources(),
          "spill_store_bytes": spills})

    # -- data ------------------------------------------------------------
    t0 = time.perf_counter()
    star = make_star(args.seed, args.scale)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables = to_tables(star, dev)
    torch.cuda.synchronize()
    rows = {k: v.nrows for k, v in tables.items()}
    reduced = [] if args.scale >= 1.0 else [
        f"row counts x{args.scale} of SF100 (--scale)"]
    emit({"phase": "data", "scale": "TPC-DS SF100", "rows": rows,
          "reduced": reduced, "seed": args.seed, "numpy_s": gen_s,
          "load_s": time.perf_counter() - t0,
          "resident_gib": torch.cuda.memory_allocated(dev) / 2**30})

    # -- slice -----------------------------------------------------------
    on = {f"engine.pallas_{k}": "on" for k in ("agg", "join", "sort")}
    off = {f"engine.pallas_{k}": "off" for k in ("agg", "join", "sort")}
    s_on = Session(conf=on)
    s_off = Session(conf=off, device="cuda")
    for s in (s_on, s_off):
        for name, t in tables.items():
            s.register_table(name, t)

    # capture the main path's kernel inputs (largest call per kernel)
    captured = {}
    originals = {}

    def recorder(name, fn):
        def wrapped(*a):
            n = a[0].shape[0]
            if name not in captured or captured[name][0].shape[0] <= n:
                captured[name] = a
            return fn(*a)
        return wrapped

    for name in KERNEL_META:
        originals[name] = getattr(GK, name)
        setattr(GK, name, recorder(name, originals[name]))

    def run(session, q):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = session.sql(QUERIES[q]).collect()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    torch.cuda.reset_peak_memory_stats(dev)
    GK.reset_launches()
    cold = {}
    per_query = {}
    prev = dict(GK.LAUNCHES)
    for q in QUERIES:
        cold[q] = run(s_on, q)
        per_query[q] = {k: GK.LAUNCHES[k] - prev[k] for k in GK.LAUNCHES}
        prev = dict(GK.LAUNCHES)
    launches = dict(GK.LAUNCHES)
    for name, fn in originals.items():
        setattr(GK, name, fn)
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the main path")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30

    n_fact = rows["store_sales"]
    results = {}
    for q in QUERIES:
        res, cold_ms = cold[q]
        steady = [run(s_on, q)[1] for _ in range(5)]
        got_off, off_ms = run(s_off, q)
        if q == "q3":
            ref_off = q3_groups(got_off)
            rtol = f32_sum_rtol(max(n for _, n in ref_off.values()))
            worst = same_groups(q3_groups(res), ref_off, rtol, "on vs off")
        else:
            # minmax: f64 -> f32 rounding of the extreme value; order: exact
            rtol = 2.0**-23 if q == "minmax" else 0.0
            worst = same_result(res, got_off, rtol, f"{q} on vs off")
        rec = {"phase": "query", "query": q, "rows": res.num_rows,
               "cold_ms": cold_ms, "steady_ms": float(np.median(steady)),
               "off_ms": off_ms,
               "fact_rows_per_s": n_fact / (float(np.median(steady)) / 1e3),
               "launches": per_query[q], "max_rel_vs_off": worst,
               "rtol": rtol}
        if q == "q3":
            ref = q3_reference(star)
            rec["max_rel_vs_numpy"], rec["rtol_numpy"] = check_q3(
                res, ref, "vs numpy")
            if res.num_rows == 0:
                fail("q3 returned no groups")
        if q == "order" and res.num_rows == 0:
            fail("the ORDER BY query returned no rows")
        results[q] = rec
        emit(rec)
    emit({"phase": "slice", "launches": launches, "peak_gib": peak})

    # -- profile ---------------------------------------------------------
    for q in QUERIES:
        emit(profile_query(torch, lambda q=q: run(s_on, q), q))

    # -- kernels ---------------------------------------------------------
    kernels = kernel_rows(torch, GK, captured, launches)

    # -- kernel_sweep ------------------------------------------------------
    del tables, s_on, s_off, captured
    torch.cuda.empty_cache()
    kernel_sweep(torch, GK, dev, args.seed, min(1.0, args.scale))

    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
