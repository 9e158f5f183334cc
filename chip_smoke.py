#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (nds_tpu_torch) runs on a GPU.

Drives the port's main path on one NVIDIA H100 at TPC-DS SF100 row counts:
`Session.sql` -> parse / bind / prune -> scan -> filter -> dense star-join ->
group-by aggregate -> ORDER BY -> collect, with engine.pallas_agg,
engine.pallas_join and engine.pallas_sort set to `on`, so every
hand-written kernel of ops/csrc/ runs. Every statement goes through the
port's plan budgeter on the card's own lines (NDS_PLAN_BUDGET_STRICT is
set, so a budgeter fault fails the run), and every query line carries its
`budget` record: the verdict, the modeled peak, the window and partition
count it annotated, the measured working set (the peak of the steady runs
less what was allocated before them) and their ratio against the
reference's CALIBRATION_SLACK, and the allocator's gap at that peak. A
statement the budgeter refuses at the default lines (PlanBudgetError on
a `reject` verdict, as in the reference) is shown to be refused, and then
runs under REFUSED_MODE so that its checks still hold; its line says so.
Phases, each printing one JSON line:

  device   the card (plus the nvidia-smi name/power-limit line), whether
           pyarrow imports, and the caching allocator's setting and its
           segments (the package makes expandable_segments hold)
  budget_lines  the card's memory and the plan budgeter's lines on it
  build    nvcc builds every kernel from ops/csrc/, one process per source
  data     store_sales (as tickets), store_returns, catalog_sales (as
           orders), item, date_dim, reason and store, made with numpy from
           --seed at SF100 row counts (make_star), loaded with
           table_from_numpy (the WINDOW_COLUMNS wait for the windows phase;
           the line reckons their device bytes)
  slice    three queries through Session(device="cuda"): q3 (segment sums +
           dense joins), a grouped min/max (segment extreme) and a one-word
           ORDER BY (counting sort). Launch counts are zeroed just before the
           three cold runs and read just after; results must equal the same
           session with the kernels off, and q3 must equal a numpy reference
  obs      the observability layer (nds_tpu_torch/obs/) over q3: a
           session with a trace directory, metrics_port=0, trace_kernels
           on and engine.pallas_agg / pallas_join `auto` runs q3 once; its
           trace must hold a kernel_span per call of a traced
           ops/kernels.py entry point outside a fused chain (`n` the call's
           leading length) and the A/B's segment_sum / dense_build `:jnp`
           and `:pallas` pairs. Then OBS_RUNS steady runs each, alternated
           in one call, of q3 untraced (the flight recorder off), traced,
           and traced with kernel spans, each a BenchReport: equal answers
           exactly; /metrics and /statusz scraped over HTTP, every event
           family's counter equal to its kind's count in the trace. One
           `obs` line: medians, the tracer's and the kernel spans' cost
           against untraced (ms and %), the trace's event and span counts
  serve    the query service, the fleet router and the tcp lakehouse
           catalog (nds_tpu_torch/serve/, lakehouse/catalog.py) over the
           same SF100 tables, each on a listener of its own on 127.0.0.1:
           client threads POST q3, minmax and order to a QueryService of
           two slots, and every answer must equal the in-process one; q93
           answers 429 with its modeled peak; a third concurrent request
           sheds with Retry-After; an INSERT commits through a
           CatalogCoordinator; a /stream job completes and its
           re-submission re-runs nothing; /drain ends it. A QueryRouter
           over two replicas fails a request over from a drained replica,
           sheds q93 at the edge and reads the inserted rows back from the
           other replica, whose pinned lease keeps its files through a
           vacuum. Launch counts are zeroed at the step's start and read
           at its end (the kernels line's serve_launches)
  profile  torch.profiler over one steady run of each query: device time by
           kernel and the device's busy share of the wall time
  kernels  each kernel's wrapper on the inputs the main path gave it, held
           against its plain PyTorch version; kernel, plain and library
           times (CUDA events, median of 7 after a warm-up) beside the bound,
           the device time and device operations (kernels, memsets) of one
           call from torch.profiler, and the host time to enqueue one call,
           for the wrapper and (where it is launch-bound) the library call
  joins    the joins and set operators: JOIN_QUERIES (q93, q97 and q78 /
           q16 / q28 / q87 shapes) through a session with the kernels on
           and one with them off; the declared-key checks timed apart;
           launch counts zeroed just before the cold runs and read just
           after; each query must take its JOIN_BRANCHES (branch_spy) and
           equal the off session, q93 and q16 their numpy references; one
           line per query (cold / steady / off ms, fact rows/s, busy share,
           peak GiB, launches, branches) and a `joins` summary line
  windows  windows, ROLLUP / grouping sets, grouping() and blocked union
           aggregation: WINDOW_QUERIES (q98, q36, q67 and q51 / q5 shapes)
           over the tables with the WINDOW_COLUMNS (and the store table)
           uploaded for this phase, through a session with the kernels on
           and one with them off; launch counts zeroed just before the cold
           runs and read just after; each query must take its
           WINDOW_BRANCHES (the q5 shape its union in windows of the
           default size), launch segment_sums and dense_build and equal the
           off session, q98, q36 and the q5 shape their numpy references;
           one line per query and a `windows` summary line
  fuse     fused pipelines, top-k and the caches (engine/fuse.py,
           engine/aotcache.py) with engine.pallas_agg=off, so that
           aggregates fuse: order (the fused filter over store_sales),
           minmax (the fused min/max tail over it), q3 (the fused
           dimension filters; its aggregate tail pins, FUSE_ALLOWED_PINS),
           q93 as the joins phase runs it (the top-k) and the q5 shape as
           the windows phase runs it (over its tables), each fused against
           `engine.fuse=off`: the paths taken (fuse_spy), no pin but the
           allowed, the answer against the earlier phases' checks (order
           against numpy too) and the unfused one (integers exactly, q3's
           f64 sums within f64_sum_rtol, q93 as the joins phase holds
           it), steady ms
           (plan cache off) and peak of each, entries and their hits on
           reruns, q5's busy share; q3 through the caches (the plan cache
           answers a rerun, a rerun without it replays the join order);
           `python -m nds_tpu_torch.cli.cache` warm / stats / warm in
           processes of their own over a small star warehouse, on a
           thread beside the stream phase (the second loads every entry,
           builds none). The in-process SF100 phases
           run with the plan cache off (STEADY: they measure steady time);
           the CLI phases keep every default, with one AOT directory
           (NDS_AOT_CACHE_DIR) for the script and its processes
  spill    the out-of-core paths at SF100: SPILL_CASES (q3's hash join
           forced through the spill pool at 8 and at 3 partitions, the
           ORDER BY's sorted runs at 8, the same with the pool capped so
           that segments tier to a temporary directory, q87's DISTINCTs at
           8, and the ORDER BY, direct at the card's lines, in `auto` mode
           under a working-set line below its modeled peak) against the
           same queries with engine.spill=off;
           launch counts zeroed just before the cold runs and read just
           after; each case must take its SPILL_BRANCHES and equal the
           direct run (the ORDER BY bit for bit); one line per case (steady
           and direct ms, peaks and working sets, the pool's bytes in / out,
           evictions and disk bytes, partitions, launches) and a `spill`
           summary line
  maintenance_sf100  the maintenance path's heaviest device statement at
           SF100: DF_SS's returns DELETE as lakehouse/dml.py runs it on the
           engine (select * from store_returns where not coalesce(<its IN
           subquery over store_sales and date_dim>, false)) over the device
           tables, for the first generated delete-date range: cold and
           steady ms, branches, launches, peak, the budgeter's verdict (a
           refusal shown, then run under REFUSED_MODE); the survivor count
           must equal numpy's
  budget_refusals  the statements the default lines refused, with their
           modeled peaks against the reject line
  device_memory  what the CUDA runtime holds outside the caching
           allocator and each query's allocator gap: the readings
           budget.budget_lines' headrooms come from
  warehouse  the star written as a parquet warehouse in a temporary
           directory (write_warehouse: every TPC-DS source table with its
           full schema, the columns the star does not build all-null), the
           device tables and then the numpy star dropped
  power    the Power Run's harness: POWER_STREAM (the earlier phases'
           queries as one stream file, with a two-part entry) through
           nds_tpu_torch.power.run_query_stream on the card, reading the
           warehouse, with a property file that sets the kernels on.
           Launch counts are zeroed just before the stream and read just
           after. Every query the earlier phases admitted must be Completed
           and pass the check its phase made of it (power.py writes each
           result; its phase's tolerance); every refused one Failed with
           failureKind `planner` and no retry; the time log must hold the
           reference's rows. One `power_query` line per query and a `power`
           line. Then a real CUDA OOM (`power_oom`): a ballast leaves the
           card's free memory below q97's scanned columns plus its measured
           working set and above q3's, and a two-entry stream (q97, q3)
           must show a torch OutOfMemoryError first, only device_oom rungs
           in the reference's order, q97 recovered (its check) or Failed as
           device_oom, q3 completed with its check, and allocated memory
           back to the ballast plus the catalog within 1 GiB. The stream
           runs with the flight recorder on: q97's failure bundle (the
           harness's on a terminal failure, else taken on demand as
           /debug/flight?write=1 takes it) must pass `profile --check`,
           name device_oom in its ring's ladder rungs and hold q97's plan
           (the line's `flight`). Then the
           injected drills (`power_drill`, POWER_DRILLS): oom, io on
           store_sales, io on a spill write, and a hang under a 2 s
           watchdog, each against the summaries the reference's tests
           expect. The directory goes at the end.
  stream   the whole NDS chain over a generated stream 0 (103 statements),
           each step a CLI of the port, in a temporary directory removed
           at the end; both legs' gen_data and Load Tests start before the
           joins phase and run beside the SF100 phases (stream_start), as
           does the generation of their stream 0 (finish_legs). Leg
           A at SF STREAM_SF_A, decimals: gen_data with one
           process per core (`stream_data`: rows per table, the fixed
           tables against rowcounts.hpp), transcode to parquet, the .dat
           files then deleted (`stream_load`: seconds, rows/s, parquet
           bytes, RNGSEED, store_sales' partition directories),
           gen_query_stream from the Load Test's RNGSEED, then
           nds_tpu_torch.cli.power on the card with the kernels on and
           again with them off (a property file each, with a
           STREAM_QUERY_TIMEOUT watchdog; launch counts zeroed just before
           each stream and read just after), then the port's validate of
           on against off and update_summary on the `on` summaries. Leg B
           at SF STREAM_SF_B with --floats, while leg A's Load Test runs:
           the same steps, the stream on the card with the kernels on and
           on the CPU (a process of its own, beside leg A's card runs
           and the throughput phase), validated with the floats
           carve-out. Leg A's kernels-on run is traced (a trace directory
           and the flight recorder on in its property file): cli/profile.py
           over its trace with --json, --critical-path --json and --check
           must exit 0, every completed statement have its query_span and
           an op_span, every summary a memoryHighWater within the card's
           memory (`obs_stream`: the critical path's attributed share per
           statement, printed, not gated). Both SFs are cut from the SF10
           / SF1 the phase was made for, and each leg runs the first
           STREAM_TEMPLATES templates
           of its stream 0 and its STREAM_GATE_TEMPLATES (`reduced` says
           so). Every
           statement must be Completed or CompletedWithTaskFailures but
           those STREAM_EXPECTED_FAILURES names (with their failureKind),
           the time logs must hold the reference's rows, validate must
           find no unmatched query, and leg A must launch dense_build and
           sort_perm, leg B all four kernels. One `stream_query` line per
           statement and run (status, failureKind, retries and rungs, cold
           ms, catalog load ms, peak GiB, verdict, launches) and a
           `stream` line per run
  throughput  the Throughput Run over leg A's warehouse, before it goes:
           streams 1 and 2 (THROUGHPUT_STREAMS, the first Throughput Test
           of a 5-stream NDS run) generated from the Load Test's RNGSEED,
           each cut to its first THROUGHPUT_TEMPLATES templates in its own
           order (the time limit), at once through cli/throughput.py in
           thread mode with the kernels on, the stream watchdog and
           engine.verify_plans=final, each session with half the card's
           catalog and working-set lines. Launch counts are zeroed and the
           peak reset just before the run and read just after, for the
           phase as a whole; catalog load ms per stream. One
           `throughput_query` line per statement and stream, a
           `throughput` line (Ttt, each stream's Power Test Time, load ms
           and window, against leg A's single-stream A_on run; peak GiB;
           launches). Gates: every statement Completed but those
           THROUGHPUT_EXPECTED_FAILURES names, the reference's time-log
           rows, the printed Ttt equal to _ttt_from_logs of the logs, the
           windows overlapping, dense_build and sort_perm launched, no
           PlanVerifyError; then the THROUGHPUT_VALIDATE statements that
           read the most fact rows, run again stream after stream in one
           session with the kernels off, validated (`throughput_validate`:
           no unmatched query). Made for SF10 with 4 streams: `reduced` says so, and
           tools/torch_throughput_phase.py runs that
  lakehouse  the lakehouse, csv and orc entries, over the stream phase's
           legs (their .dat files kept for it) before their directory
           goes: leg A's data through cli/transcode.py --output_format
           lakehouse --workers 4 (`lakehouse_load`: Load Test seconds,
           rows/s, data files and manifest versions per fact table; below
           SF1 the files shrink with the SF, lake_env), then again with
           --resume, which must convert 0 rows, while the maintenance
           phase's Load Test starts (these host processes run on a thread,
           lake_loads, from the end of leg A's parquet Load Test, beside
           the SF100 phases); leg A's stream 0 (as the stream
           phase cut it) cold through cli/power.py --input_format lakehouse
           with the kernels on and the watchdog (run `L_on`, its
           `stream_query` lines and a `lakehouse_stream` line: Power Test
           Time, catalog load ms and peak beside A_on's), every statement
           Completed, validate against A_on finding no unmatched query,
           dense_build and sort_perm launched; `lakehouse_prune`: a
           date-range aggregate over store_sales must prune to a strict
           subset of its files, the budgeter must model the clamped rows,
           and the answer must equal engine.lake_prune=off's and the
           parquet warehouse's; `lakehouse_isolation`: a session pins
           store_sales and re-reads its snapshot from disk while another
           thread compacts the table and vacuums it (retain_last=1): the
           answer must not change, vacuum must delete no pinned file, and
           a fresh statement must read the compacted head with the same
           answer; `lakehouse_formats`: leg B's data to a csv and an orc
           warehouse (Load Test seconds), a statement per sales channel
           through --input_format csv and orc, validated against leg B's
           parquet answers (a host pyarrow without ORC fails it). Made for
           SF10 / SF1 at leg A's and leg B's scale: `reduced` says so, and
           tools/torch_lakehouse_phase.py runs that
  maintenance  the Data Maintenance phase after the lakehouse phase, over
           leg B's data loaded to a lakehouse with decimals
           (`maintenance_load`, started by lake_loads once leg A's
           lakehouse Load Test has ended; leg A's lakehouse would take longer
           than the time limit leaves: `reduced` says so, and
           tools/torch_maintenance_phase.py runs the phase at SF10):
           gen_data --update 1 (`maintenance_refresh`); a copy of the
           warehouse and the refresh data through cli/maintenance.py
           --device cpu in a process of its own; the 11 refresh functions
           through cli/maintenance.py on the card with --optimize, launch
           counts zeroed just before and read just after
           (`maintenance_function` lines: ms, status, rows affected per
           statement; `maintenance`: Tdm from the time log, files per fact
           table before and after the optimize, peak, launches). Gates:
           every function Completed, the reference's time-log rows, each
           DF_* statement's count equal to a pyarrow count
           (expected_dm_deletes), dense_build and sort_perm launched, the
           session's plan / result and join-order caches empty after every
           DML commit (`maintenance_caches`), every
           fact table equal to the CPU's as multisets (`maintenance_cpu`);
           rollback through cli/rollback.py to the heads before, every
           fact table's digest restored (`maintenance_rollback`); then
           maintenance.run_maintenance_under_load with stream 0's first
           MAINTENANCE_TEMPLATES templates, the 11 functions and a vacuum,
           each session at half the card's lines
           (`maintenance_under_load`: p99 solo and under
           load, their ratio, functions/s, files vacuumed, overlap): every
           statement of every pass Completed, 11 functions, none failed,
           the vacuum removing files and none a live lease held
  bench    the whole benchmark through nds_tpu_torch.cli.bench and its
           crash-safe checkpoint, at SF BENCH_SF with BENCH_STREAMS streams
           over a lakehouse warehouse, the power_test property file with
           the kernels on, the Power and Throughput Tests over
           BENCH_TEMPLATES, all 11 refresh functions, every device phase's
           JSON summaries. Step 1 starts after the joins phase, beside the
           SF100 phases: the CLI with --fault_spec crash:power_test in a
           process of its own runs data_gen (with two refresh sets),
           load_test and gen_streams, host work that touches no CUDA, and
           dies at power_test: it must exit non-zero with exactly those
           three checkpointed and no metrics.csv. Step 2, on a thread
           beside the stream phase from the end of the power phase (the
           card's memory in use it reports is every process's, the stream
           phase's included): the CLI with --resume skips the three from
           the checkpoint and runs the Power Test, both Throughput Tests
           and both Maintenance Tests, each a CLI process on the card;
           metrics.csv must equal Tload, Tpower, Ttt1, Ttt2, Tdm1 and Tdm2
           as the script re-derives them from the phases' own reports and
           the composite metric of TPC-DS Spec 7.6.3 over them; every
           statement and refresh function Completed, each on the card
           (the summaries' torch.device and device name). The power_test
           property file names a trace directory: the crashed
           orchestrator's events must have begun the three host phases and
           power_test and give the failure kind its log's InjectedCrash
           classifies to, and --resume's must end every phase ok or
           skipped; metrics.csv then carries the plan-feedback headline at
           its default (None). One
           `bench_phase` line per orchestrator phase (seconds, attempts)
           and a `bench` line (the times, perf_metric, the card's peak
           memory in use while step 2 ran, `reduced`). No kernel gate:
           its phases are subprocesses. Made for SF10 with 3 streams:
           tools/torch_bench_phase.py runs that
  explain  cli/explain.py --budget --scale 100 over the 99 templates on the
           card's lines with NDS_VERIFY_PLANS=all: each statement's
           verdict and modeled peak and the count per verdict; a verifier
           violation fails the run, the verdicts are not gated
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
import atexit
import collections
import contextlib
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: TPC-DS v3.2.0 Table 3-2 row counts at SF100
#: (nds_tpu/datagen/native/rowcounts.hpp)
SF100_ROWS = {"store_sales": 287_997_024, "item": 204_000, "date_dim": 73_049,
              "store_returns": 28_795_080, "catalog_sales": 143_997_065,
              "reason": 55}
#: (orders at SF100, lines per order lo, hi): rowcounts.hpp kStore, kCatalog
SF100_ORDERS = {"store_sales": (24_000_000, 8, 16),
                "catalog_sales": (16_000_000, 4, 14)}
DATE_FIRST_SK = 2415022  # julian day of 1900-01-02, date_dim's first row
SALES_FIRST_SK, SALES_LAST_SK = 2450815, 2452642  # 1998-01-01 .. 2002-12-31
JULIAN_OF_EPOCH = 2440588
N_STORE_SF100 = 402
N_CUSTOMER_SF100 = 2_000_000
H100_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)

#: vocabularies of nds_tpu/datagen/native/vocab.hpp (kCategories, kClasses
#: flattened 8 per category, kPromoNames, kStates)
CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry", "Men",
              "Music", "Shoes", "Sports", "Women"]
CLASSES = [
    "arts", "business", "computers", "cooking", "history", "mystery",
    "romance", "science",
    "infants", "newborn", "school-uniforms", "toddlers", "accessories",
    "shirts", "pants", "swimwear",
    "audio", "cameras", "dvd/vcr players", "karoke", "memory", "monitors",
    "portable", "televisions",
    "bathroom", "bedding", "blinds/shades", "curtains/drapes", "decor",
    "flatware", "furniture", "kids",
    "birdal", "costume", "diamonds", "estate", "gold", "loose stones",
    "pendants", "rings",
    "accessories", "pants", "shirts", "sports-apparel", "underwear",
    "dress shirts", "suits", "casual",
    "classical", "country", "pop", "rock", "jazz", "blues", "folk", "world",
    "athletic", "dress", "kids", "mens", "womens", "work", "sandals", "boots",
    "archery", "baseball", "basketball", "camping", "fishing", "fitness",
    "golf", "hockey",
    "dresses", "fragrances", "intimates", "maternity", "swimwear",
    "accessories", "shirts", "pants"]
PROMO_NAMES = ["ese", "anti", "ought", "able", "pri", "bar", "cally", "ation",
               "eing", "n st"]
STATES = ["AL", "AK", "AZ", "AR", "CA", "CO", "CT", "DE", "FL", "GA", "HI",
          "ID", "IL", "IN", "IA", "KS", "KY", "LA", "ME", "MD", "MA", "MI",
          "MN", "MS", "MO", "MT", "NE", "NV", "NH", "NJ", "NM", "NY", "NC",
          "ND", "OH", "OK", "OR", "PA", "RI", "SC", "SD", "TN", "TX", "UT",
          "VT", "VA", "WA", "WV", "WI", "WY"]
#: words of the item descriptions (dims.hpp draws them from a word list)
DESC_WORDS = ["able", "about", "across", "again", "always", "areas", "back",
              "basic", "better", "black", "blue", "bright", "called", "cases",
              "certain", "clear", "close", "common", "daily", "deep", "early",
              "easy", "equal", "even", "fair", "final", "fine", "free",
              "full", "good", "great", "happy", "high", "large", "light",
              "local", "major", "modern", "new", "open"]

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

#: the joins phase: TPC-DS templates (nds_tpu/datagen/templates) and shapes
#: of them over the tables make_star builds. Each must take the branches
#: JOIN_BRANCHES names for it (events of branch_spy) at SF100.
JOIN_QUERIES = {
    # query93.tpl, [REASON] = reason 28
    "q93": """
        select ss_customer_sk, sum(act_sales) sumsales
        from (select ss_item_sk, ss_ticket_number, ss_customer_sk,
                     case when sr_return_quantity is not null
                          then (ss_quantity - sr_return_quantity) * ss_sales_price
                          else (ss_quantity * ss_sales_price) end act_sales
              from store_sales
              left outer join store_returns
                on (sr_item_sk = ss_item_sk and sr_ticket_number = ss_ticket_number),
              reason
              where sr_reason_sk = r_reason_sk and r_reason_desc = 'reason 28') t
        group by ss_customer_sk
        order by sumsales, ss_customer_sk
        limit 100
    """,
    # query78.tpl's ss CTE: store sales lines that were never returned
    "q78": """
        select d_year, ss_store_sk, sum(ss_quantity) ss_qty,
               sum(ss_ext_sales_price) ss_sp, count(*) cnt
        from store_sales
        left join store_returns on sr_ticket_number = ss_ticket_number
                               and ss_item_sk = sr_item_sk
        join date_dim on ss_sold_date_sk = d_date_sk
        where sr_ticket_number is null
        group by d_year, ss_store_sk
        order by d_year, ss_store_sk
    """,
    # query16.tpl on the store channel: tickets of a 61-day window with
    # another line of another item, none of it returned
    "q16": """
        select count(distinct ss_ticket_number) order_count,
               sum(ss_ext_sales_price) total_sales
        from store_sales ss1, date_dim
        where d_date between cast('2000-02-01' as date)
                         and (cast('2000-02-01' as date) + interval 60 days)
          and ss1.ss_sold_date_sk = d_date_sk
          and exists (select * from store_sales ss2
                      where ss1.ss_ticket_number = ss2.ss_ticket_number
                        and ss1.ss_item_sk <> ss2.ss_item_sk)
          and not exists (select * from store_returns sr1
                          where ss1.ss_ticket_number = sr1.sr_ticket_number)
    """,
    # query97.tpl, [DMS] = 1200 (the year 2000)
    "q97": """
        with ssci as (
         select ss_customer_sk customer_sk, ss_item_sk item_sk
         from store_sales, date_dim
         where ss_sold_date_sk = d_date_sk
           and d_month_seq between 1200 and 1200 + 11
         group by ss_customer_sk, ss_item_sk),
         csci as (
         select cs_bill_customer_sk customer_sk, cs_item_sk item_sk
         from catalog_sales, date_dim
         where cs_sold_date_sk = d_date_sk
           and d_month_seq between 1200 and 1200 + 11
         group by cs_bill_customer_sk, cs_item_sk)
        select sum(case when ssci.customer_sk is not null
                         and csci.customer_sk is null then 1 else 0 end) store_only,
               sum(case when ssci.customer_sk is null
                         and csci.customer_sk is not null then 1 else 0 end) catalog_only,
               sum(case when ssci.customer_sk is not null
                         and csci.customer_sk is not null then 1 else 0 end)
               store_and_catalog
        from ssci
        full outer join csci on (ssci.customer_sk = csci.customer_sk
                                 and ssci.item_sk = csci.item_sk)
        limit 100
    """,
    # query28.tpl: three quantity buckets, cross-joined
    "q28": """
        select * from
         (select avg(ss_sales_price) b1_lp, count(ss_sales_price) b1_cnt,
                 count(distinct ss_sales_price) b1_cntd
          from store_sales where ss_quantity between 0 and 5) b1,
         (select avg(ss_sales_price) b2_lp, count(ss_sales_price) b2_cnt,
                 count(distinct ss_sales_price) b2_cntd
          from store_sales where ss_quantity between 6 and 10) b2,
         (select avg(ss_sales_price) b3_lp, count(ss_sales_price) b3_cnt,
                 count(distinct ss_sales_price) b3_cntd
          from store_sales where ss_quantity between 11 and 15) b3
        limit 100
    """,
    # query87.tpl on the store and catalog channels: (customer, date)
    # pairs that bought in store and never from the catalog on that date
    "q87": """
        select count(*) from (
          (select distinct ss_customer_sk, d_date
           from store_sales, date_dim
           where store_sales.ss_sold_date_sk = date_dim.d_date_sk
             and d_month_seq between 1200 and 1200 + 11)
          except
          (select distinct cs_bill_customer_sk, d_date
           from catalog_sales, date_dim
           where catalog_sales.cs_sold_date_sk = date_dim.d_date_sk
             and d_month_seq between 1200 and 1200 + 11)
        ) cool_cust
    """,
}

#: the windows phase: TPC-DS templates and shapes of them over the tables
#: make_star builds, with the qualification parameters of the TPC-DS
#: specification. Each must take the branches WINDOW_BRANCHES names for it.
Q36_STATES = ("TN", "SD", "AL", "SC", "OH", "LA", "MO", "GA")
WINDOW_QUERIES = {
    # query98.tpl, [CAT_A..C] = Sports, Books, Home; [SDATE] = 1999-02-22
    "q98": """
        select i_item_id, i_item_desc, i_category, i_class, i_current_price,
               sum(ss_ext_sales_price) as itemrevenue,
               sum(ss_ext_sales_price) * 100 / sum(sum(ss_ext_sales_price))
                 over (partition by i_class) as revenueratio
        from store_sales, item, date_dim
        where ss_item_sk = i_item_sk
          and i_category in ('Sports', 'Books', 'Home')
          and ss_sold_date_sk = d_date_sk
          and d_date between cast('1999-02-22' as date)
                         and (cast('1999-02-22' as date) + interval 30 days)
        group by i_item_id, i_item_desc, i_category, i_class, i_current_price
        order by i_category, i_class, i_item_id, i_item_desc, revenueratio
        limit 100
    """,
    # query36.tpl, [YEAR] = 2001, [STATE1..8] = Q36_STATES
    "q36": f"""
        select sum(ss_net_profit) / sum(ss_ext_sales_price) as gross_margin,
               i_category, i_class,
               grouping(i_category) + grouping(i_class) as lochierarchy,
               rank() over (
                 partition by grouping(i_category) + grouping(i_class),
                              case when grouping(i_class) = 0
                                   then i_category end
                 order by sum(ss_net_profit) / sum(ss_ext_sales_price) asc)
               as rank_within_parent
        from store_sales, date_dim d1, item, store
        where d1.d_year = 2001
          and d1.d_date_sk = ss_sold_date_sk
          and i_item_sk = ss_item_sk
          and s_store_sk = ss_store_sk
          and s_state in {Q36_STATES}
        group by rollup (i_category, i_class)
        order by lochierarchy desc,
                 case when lochierarchy = 0 then i_category end,
                 rank_within_parent
        limit 100
    """,
    # query67.tpl, [DMS] = 1200
    "q67": """
        select *
        from (select i_category, i_class, i_brand, i_product_name, d_year,
                     d_qoy, d_moy, s_store_id, sumsales,
                     rank() over (partition by i_category
                                  order by sumsales desc) rk
              from (select i_category, i_class, i_brand, i_product_name,
                           d_year, d_qoy, d_moy, s_store_id,
                           sum(coalesce(ss_sales_price * ss_quantity, 0))
                             sumsales
                    from store_sales, date_dim, store, item
                    where ss_sold_date_sk = d_date_sk
                      and ss_item_sk = i_item_sk
                      and ss_store_sk = s_store_sk
                      and d_month_seq between 1200 and 1200 + 11
                    group by rollup (i_category, i_class, i_brand,
                                     i_product_name, d_year, d_qoy, d_moy,
                                     s_store_id)) dw1) dw2
        where rk <= 100
        order by i_category, i_class, i_brand, i_product_name, d_year,
                 d_qoy, d_moy, s_store_id, sumsales, rk
        limit 100
    """,
    # query51.tpl, [DMS] = 1200, with catalog_sales in place of web_sales
    "q51": """
        with web_v1 as (
         select cs_item_sk item_sk, d_date,
                sum(sum(cs_sales_price))
                  over (partition by cs_item_sk order by d_date
                        rows between unbounded preceding and current row)
                  cume_sales
         from catalog_sales, date_dim
         where cs_sold_date_sk = d_date_sk
           and d_month_seq between 1200 and 1200 + 11
           and cs_item_sk is not null
         group by cs_item_sk, d_date),
         store_v1 as (
         select ss_item_sk item_sk, d_date,
                sum(sum(ss_sales_price))
                  over (partition by ss_item_sk order by d_date
                        rows between unbounded preceding and current row)
                  cume_sales
         from store_sales, date_dim
         where ss_sold_date_sk = d_date_sk
           and d_month_seq between 1200 and 1200 + 11
           and ss_item_sk is not null
         group by ss_item_sk, d_date)
        select *
        from (select item_sk, d_date, web_sales, store_sales,
                     max(web_sales)
                       over (partition by item_sk order by d_date
                             rows between unbounded preceding and current row)
                       web_cumulative,
                     max(store_sales)
                       over (partition by item_sk order by d_date
                             rows between unbounded preceding and current row)
                       store_cumulative
              from (select case when web.item_sk is not null
                                then web.item_sk else store.item_sk end item_sk,
                           case when web.d_date is not null
                                then web.d_date else store.d_date end d_date,
                           web.cume_sales web_sales,
                           store.cume_sales store_sales
                    from web_v1 web
                    full outer join store_v1 store
                      on (web.item_sk = store.item_sk
                          and web.d_date = store.d_date)) x) y
        where web_cumulative > store_cumulative
        order by item_sk, d_date
        limit 100
    """,
    # query5.tpl's store channel as written, [SDATE] = 2000-08-23, then
    # the outer rollup over it (no catalog or web channel)
    "q5": """
        with ssr as
         (select s_store_id,
                 sum(sales_price) as sales,
                 sum(profit) as profit,
                 sum(return_amt) as returns_amt,
                 sum(net_loss) as profit_loss
          from (select ss_store_sk as store_sk, ss_sold_date_sk as date_sk,
                       ss_ext_sales_price as sales_price,
                       ss_net_profit as profit,
                       cast(0 as decimal(7,2)) as return_amt,
                       cast(0 as decimal(7,2)) as net_loss
                from store_sales
                union all
                select sr_store_sk as store_sk,
                       sr_returned_date_sk as date_sk,
                       cast(0 as decimal(7,2)) as sales_price,
                       cast(0 as decimal(7,2)) as profit,
                       sr_return_amt as return_amt, sr_net_loss as net_loss
                from store_returns) salesreturns, date_dim, store
          where date_sk = d_date_sk
            and d_date between cast('2000-08-23' as date)
                           and (cast('2000-08-23' as date) + interval 14 days)
            and store_sk = s_store_sk
          group by s_store_id)
        select channel, id, sum(sales) as sales,
               sum(returns_amt) as returns_amt, sum(profit) as profit
        from (select 'store channel' as channel, 'store' || s_store_id as id,
                     sales, returns_amt, profit - profit_loss as profit
              from ssr) x
        group by rollup (channel, id)
        order by channel, id
        limit 100
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


#: the script's start: every line carries its seconds since (`at_s`)
_T0 = time.perf_counter()
#: the stream emit writes to: main sets it to its own standard output, so
#: that a line emitted on a thread beside a step that redirects stdout
#: (a CLI's log) still reaches it
_OUT = []
_EMIT_LOCK = threading.Lock()


def emit(obj):
    line = json.dumps({**obj, "at_s": round(time.perf_counter() - _T0, 3)})
    out = _OUT[0] if _OUT else sys.stdout
    with _EMIT_LOCK:
        out.write(line + "\n")
        out.flush()
    return obj


class Procs:
    """The child processes a step starts, beside the script's next steps:
    stop() kills those still running, and any added after it (a thread
    that starts one as the script exits)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._procs = []
        self._stopped = False

    def append(self, proc):
        with self._lock:
            self._procs.append(proc)
            stopped = self._stopped
        if stopped:
            proc.kill()
            proc.wait()
            raise SystemExit(1)
        return proc

    def stop(self):
        with self._lock:
            self._stopped = True
            procs = list(self._procs)
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def _order_lines(rng, n_rows, n_orders, lo, hi):
    """Lines per order, uniform in [lo, hi], then moved one line at a time
    on random orders until they sum to `n_rows` (the count of Table 3-2).
    Where `n_rows` is out of reach of `n_orders` (a cut --scale), the
    order count follows the mean of [lo, hi] instead."""
    if not lo * n_orders <= n_rows <= hi * n_orders:
        n_orders = max(1, round(2 * n_rows / (lo + hi)))
    lines = rng.integers(lo, hi + 1, n_orders)
    diff = int(lines.sum()) - n_rows
    while diff:
        sign = 1 if diff > 0 else -1
        room = np.flatnonzero(lines > lo if sign > 0 else lines < hi)
        pick = rng.choice(room, min(abs(diff), room.size), replace=False,
                          shuffle=False)
        lines[pick] -= sign
        diff -= sign * pick.size
    return lines


def _orders(rng, n_rows, channel, scale):
    """(order of each row, line of each row within its order, order count)
    for a sales channel made as orders of lo..hi lines (rowcounts.hpp):
    the rows of an order are adjacent, as dsdgen writes them."""
    orders, lo, hi = SF100_ORDERS[channel]
    lines = _order_lines(rng, n_rows, max(1, int(orders * scale)), lo, hi)
    order = np.repeat(np.arange(lines.size, dtype=np.int32), lines)
    start = np.cumsum(lines) - lines
    line = (np.arange(n_rows, dtype=np.int64) - start[order]).astype(np.int32)
    return order, line, lines.size


def _distinct_items(rng, order, line, n_orders, n_items, max_lines):
    """Odd current-SCD item keys, distinct within each order: order o's
    j-th line takes item (base_o + j * step_o) mod n_half, with
    step_o < n_half / max_lines, so no two lines of an order meet."""
    half = (n_items + 1) // 2
    base = rng.integers(0, half, n_orders)
    step = rng.integers(1, max(2, half // max_lines), n_orders)
    idx = (base[order] + line.astype(np.int64) * step[order]) % half
    return (idx * 2 + 1).astype(np.int32)


def business_id(idx: int) -> str:
    """dsdgen's 16-letter business key of index `idx` (ndsgen.hpp)."""
    return "".join(chr(65 + ((idx >> (4 * (15 - i))) & 15)) for i in range(16))


def _coded(values):
    """(int32 code of each value, the distinct values as the dictionary)."""
    uniq, inv = np.unique(np.asarray(values, dtype=object),
                          return_inverse=True)
    return inv.astype(np.int32), list(uniq)


@functools.lru_cache(maxsize=None)
def string_column(name):
    """(code of each raw index, dictionary) of a generated string column:
    i_class by category * 8 + class (class names repeat across categories;
    the dictionary holds each once), i_brand by category * 80 + class * 10
    + brand - 1, i_product_name by its four name parts as a base-10
    number, i_item_id and i_item_desc by item row (SF100's item count),
    s_store_id by store row (SCD pairs share an id)."""
    if name == "i_class":
        return _coded(CLASSES)
    if name == "i_brand":
        return _coded([f"{PROMO_NAMES[c]}{PROMO_NAMES[k]} #{b}"
                       for c in range(10) for k in range(8)
                       for b in range(1, 11)])
    if name == "i_product_name":
        return _coded(["".join(PROMO_NAMES[int(d)] for d in f"{n:04d}")
                       for n in range(10_000)])
    if name == "i_item_id":
        return _coded([business_id(r + 1) for r in range(SF100_ROWS["item"])])
    if name == "i_item_desc":
        w = len(DESC_WORDS)
        return _coded([" ".join(DESC_WORDS[(r * 2654435761 >> (5 * j)) % w]
                                for j in range(5))
                       for r in range(SF100_ROWS["item"])])
    if name == "s_store_id":
        return _coded([business_id(r // 2 + 1)
                       for r in range(N_STORE_SF100)])
    raise KeyError(name)


def dictionary(name):
    """The dictionary of a string column (its data are codes into it), or
    None for a column that is not a string."""
    if name in DICTIONARIES:
        return DICTIONARIES[name]
    try:
        return string_column(name)[1]
    except KeyError:
        return None


def make_star(seed: int, scale: float):
    """numpy columns of the tables the slice's queries read, shaped as
    nds_tpu/datagen/native makes them: dims.hpp (date_dim calendar, item
    brand/manager encodings and the string attributes, store ids and
    states, reason descriptions) and facts.hpp / rowcounts.hpp
    (sales as orders of 8..16 store lines or 4..14 catalog lines, each order
    on one date, store and customer with distinct items; uniform sale dates
    over 1998-2002, odd current-SCD item and store keys, ~4% null nullable
    FKs, quantity 1..100; returns drawn from distinct sales lines, so
    store_returns' key (sr_item_sk, sr_ticket_number) holds as
    store_sales' (ss_item_sk, ss_ticket_number) does). Measures are float64,
    as the --floats mode stores decimal(7,2). The columns only the windows
    phase reads (WINDOW_COLUMNS and the store table) draw from a generator
    of their own, so the other tables are the same with or without them."""
    rng = np.random.default_rng(seed)
    rng2 = np.random.default_rng([seed, 6])
    n_dates = SF100_ROWS["date_dim"]
    # at least 64 items, so a cut --scale still gives orders distinct items
    n_items = max(64, int(SF100_ROWS["item"] * scale))
    n_fact = max(1024, int(SF100_ROWS["store_sales"] * scale))
    n_store = max(2, int(N_STORE_SF100 * scale))
    n_cust = max(2, int(N_CUSTOMER_SF100 * scale))

    def nullable(n):
        return rng.integers(0, 100, n, dtype=np.int8) < 96

    jd = DATE_FIRST_SK + np.arange(n_dates, dtype=np.int64)
    days = (jd - JULIAN_OF_EPOCH).astype("datetime64[D]")
    year = days.astype("datetime64[Y]").astype(np.int64) + 1970
    month = days.astype("datetime64[M]").astype(np.int64) % 12 + 1
    date_dim = {
        "d_date_sk": jd.astype(np.int32),
        "d_date": (jd - JULIAN_OF_EPOCH).astype(np.int32),
        "d_year": year.astype(np.int32),
        "d_moy": month.astype(np.int32),
        "d_month_seq": ((year - 1900) * 12 + month - 1).astype(np.int32),
        "d_qoy": ((month - 1) // 3 + 1).astype(np.int32),
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
    brand_no = brand - 1
    rows = np.arange(n_items)
    item.update({
        "i_category": cat.astype(np.int32),
        "i_class": string_column("i_class")[0][cat * 8 + cls],
        "i_brand": string_column("i_brand")[0][cat * 80 + cls * 10 + brand_no],
        "i_product_name": string_column("i_product_name")[0][
            rng2.integers(0, 10_000, n_items)],
        "i_item_id": string_column("i_item_id")[0][rows],
        "i_item_desc": string_column("i_item_desc")[0][rows],
        "i_current_price": rng2.integers(9, 10_000, n_items) / 100.0,
    })
    n_store_rows = max(2, int(N_STORE_SF100 * scale))
    store = {
        "s_store_sk": np.arange(1, n_store_rows + 1, dtype=np.int32),
        "s_store_id": string_column("s_store_id")[0][:n_store_rows],
        "s_state": rng2.integers(0, len(STATES), n_store_rows,
                                 dtype=np.int32),
    }

    # store_sales: tickets of 8..16 lines sharing date, store and customer
    ticket, line, n_tk = _orders(rng, n_fact, "store_sales", scale)
    qty = rng.integers(1, 101, n_fact, dtype=np.int32)
    cents = rng.integers(50, 20_000, n_fact, dtype=np.int32)
    store_sales = {
        "ss_sold_date_sk": rng.integers(SALES_FIRST_SK, SALES_LAST_SK + 1,
                                        n_tk, dtype=np.int32)[ticket],
        "ss_sold_date_sk__valid": nullable(n_tk)[ticket],
        "ss_item_sk": _distinct_items(rng, ticket, line, n_tk, n_items, 16),
        "ss_store_sk": (rng.integers(1, (n_store + 1) // 2 + 1, n_tk,
                                     dtype=np.int32) * 2 - 1)[ticket],
        "ss_store_sk__valid": nullable(n_tk)[ticket],
        "ss_customer_sk": rng.integers(1, n_cust + 1, n_tk,
                                       dtype=np.int32)[ticket],
        "ss_customer_sk__valid": nullable(n_tk)[ticket],
        "ss_ticket_number": ticket + 1,
        "ss_quantity": qty,
        "ss_sales_price": cents / 100.0,
        "ss_ext_sales_price": cents.astype(np.float64) * qty / 100.0,
    }
    # facts.hpp: net profit = net paid - extended wholesale cost
    store_sales["ss_net_profit"] = (
        cents - rng2.integers(100, 10_001, n_fact, dtype=np.int32)
    ).astype(np.float64) * qty / 100.0
    del line

    # store_returns: distinct sales lines, so its key holds
    n_ret = max(64, int(SF100_ROWS["store_returns"] * scale))
    ridx = np.sort(rng.choice(n_fact, n_ret, replace=False, shuffle=False))
    store_returns = {
        "sr_item_sk": store_sales["ss_item_sk"][ridx],
        "sr_ticket_number": store_sales["ss_ticket_number"][ridx],
        "sr_customer_sk": store_sales["ss_customer_sk"][ridx],
        "sr_customer_sk__valid": store_sales["ss_customer_sk__valid"][ridx],
        "sr_reason_sk": rng.integers(1, SF100_ROWS["reason"] + 1, n_ret,
                                     dtype=np.int32),
        "sr_reason_sk__valid": nullable(n_ret),
        "sr_return_quantity": (rng.integers(0, 1 << 30, n_ret)
                               % qty[ridx] + 1).astype(np.int32),
    }
    # facts.hpp: returned 1..90 days after the sale, at the store of the
    # sale; the amount is the sales price times the returned quantity, the
    # net loss tax + fee + shipping
    ret_cents = cents[ridx].astype(np.int64) * store_returns["sr_return_quantity"]
    store_returns.update({
        "sr_store_sk": store_sales["ss_store_sk"][ridx],
        "sr_store_sk__valid": store_sales["ss_store_sk__valid"][ridx],
        "sr_returned_date_sk": (store_sales["ss_sold_date_sk"][ridx] + 1
                                + rng2.integers(0, 90, n_ret, dtype=np.int32)),
        "sr_returned_date_sk__valid":
            store_sales["ss_sold_date_sk__valid"][ridx],
        "sr_return_amt": ret_cents / 100.0,
        "sr_net_loss": (ret_cents * rng2.integers(0, 10, n_ret) // 100
                        + 50 + rng2.integers(0, 9950, n_ret)
                        + rng2.integers(0, 5000, n_ret)) / 100.0,
    })
    del ridx, ret_cents
    reason = {
        "r_reason_sk": np.arange(1, SF100_ROWS["reason"] + 1, dtype=np.int32),
        "r_reason_desc": np.arange(SF100_ROWS["reason"], dtype=np.int32),
    }

    # catalog_sales: orders of 4..14 lines on one date and bill customer
    n_cat = max(1024, int(SF100_ROWS["catalog_sales"] * scale))
    order, line, n_ord = _orders(rng, n_cat, "catalog_sales", scale)
    catalog_sales = {
        "cs_sold_date_sk": rng.integers(SALES_FIRST_SK, SALES_LAST_SK + 1,
                                        n_ord, dtype=np.int32)[order],
        "cs_sold_date_sk__valid": nullable(n_ord)[order],
        "cs_item_sk": _distinct_items(rng, order, line, n_ord, n_items, 14),
        "cs_bill_customer_sk": rng.integers(1, n_cust + 1, n_ord,
                                            dtype=np.int32)[order],
        "cs_bill_customer_sk__valid": nullable(n_ord)[order],
        "cs_sales_price": rng2.integers(50, 20_000, n_cat) / 100.0,
    }
    return {"date_dim": date_dim, "item": item, "store_sales": store_sales,
            "store_returns": store_returns, "reason": reason,
            "catalog_sales": catalog_sales, "store": store}


#: logical types of the columns that are not int32, and the dictionaries of
#: the string columns (their data are codes into the dictionary; the
#: generated ones come from string_column)
COLUMN_TYPES = {"ss_sales_price": "float64", "ss_ext_sales_price": "float64",
                "ss_net_profit": "float64", "sr_return_amt": "float64",
                "sr_net_loss": "float64", "cs_sales_price": "float64",
                "i_current_price": "float64", "d_date": "date",
                "r_reason_desc": "string", "i_category": "string",
                "i_class": "string", "i_brand": "string",
                "i_product_name": "string", "i_item_id": "string",
                "i_item_desc": "string", "s_store_id": "string",
                "s_state": "string"}
DICTIONARIES = {"r_reason_desc": [f"reason {i}" for i in
                                  range(1, SF100_ROWS["reason"] + 1)],
                "i_category": CATEGORIES, "s_state": STATES}
#: the columns (and the store table) only the windows phase reads: the
#: device holds them for that phase alone
WINDOW_COLUMNS = {
    "store_sales": ("ss_net_profit",),
    "store_returns": ("sr_store_sk", "sr_returned_date_sk", "sr_return_amt",
                      "sr_net_loss"),
    "catalog_sales": ("cs_sales_price",),
    "date_dim": ("d_qoy",),
    "item": ("i_category", "i_class", "i_brand", "i_product_name",
             "i_item_id", "i_item_desc", "i_current_price"),
    "store": ("s_store_sk", "s_store_id", "s_state"),
}


def to_tables(star, device, windows=False, base=None):
    """Device tables of the star: without the WINDOW_COLUMNS, or (windows
    True) with them, reusing the device columns of `base` (the tables
    without them) so that only the window columns are uploaded."""
    from nds_tpu_torch.engine.columnar import Table, table_from_numpy

    out = {}
    for name, cols in star.items():
        extra = WINDOW_COLUMNS.get(name, ())
        spec = {}
        nrows = None
        for cname, data in cols.items():
            if cname.endswith("__valid"):
                continue
            nrows = data.shape[0]
            if (cname in extra) != windows:
                continue
            spec[cname] = (data, cols.get(cname + "__valid"),
                           COLUMN_TYPES.get(cname, "int32"),
                           dictionary(cname))
        if not spec:
            continue
        t = table_from_numpy(spec, nrows, device=device)
        if windows and name in (base or {}):
            t = Table({**base[name].columns, **t.columns}, nrows)
        out[name] = t
    if windows:
        for name, t in (base or {}).items():
            out.setdefault(name, t)
    return out


def window_columns_bytes(star):
    """Device bytes of the WINDOW_COLUMNS at their padded capacity: data
    and, where a column has NULLs, its validity bytes."""
    from nds_tpu_torch.engine.columnar import bucket_cap

    total = 0
    for name, cols in WINDOW_COLUMNS.items():
        cap = bucket_cap(next(iter(star[name].values())).shape[0])
        for c in cols:
            total += cap * (8 if COLUMN_TYPES.get(c) == "float64" else 4)
            if c + "__valid" in star[name]:
                total += cap
    return total


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


def q93_reference(star, reason_sk=28):
    """q93 over the numpy tables: the sales lines whose packed (item,
    ticket) word np.searchsorted finds among the returns of reason
    `reason_sk`, summed by customer with np.bincount. Returns
    {customer or None: (sum, rows)}."""
    ss, sr = star["store_sales"], star["store_returns"]
    r = np.flatnonzero(sr["sr_reason_sk__valid"]
                       & (sr["sr_reason_sk"] == reason_sk))
    rw = (sr["sr_item_sk"][r].astype(np.int64) << 32) | sr["sr_ticket_number"][r]
    order = np.argsort(rw, kind="stable")
    rws = rw[order]
    # only the lines of tickets with such a return can match: a boolean
    # gather first, so that searchsorted sees those lines alone
    tickets = ss["ss_ticket_number"]
    returned = np.zeros(int(max(tickets.max(initial=0),
                                sr["sr_ticket_number"].max(initial=0))) + 1,
                        dtype=bool)
    returned[sr["sr_ticket_number"][r]] = True
    cand = np.flatnonzero(returned[tickets])
    sw = (ss["ss_item_sk"][cand].astype(np.int64) << 32) | tickets[cand]
    pos = np.searchsorted(rws, sw).clip(0, max(rws.size - 1, 0))
    hit = (rws[pos] == sw) if rws.size else np.zeros(cand.size, bool)
    rows, pos = cand[hit], pos[hit]
    del sw, cand
    ret_q = sr["sr_return_quantity"][r][order[pos]]
    act = (ss["ss_quantity"][rows] - ret_q) * ss["ss_sales_price"][rows]
    cust = np.where(ss["ss_customer_sk__valid"][rows],
                    ss["ss_customer_sk"][rows].astype(np.int64), -1) + 1
    sums = np.bincount(cust, weights=act)
    counts = np.bincount(cust)
    return {(None if k == 0 else int(k - 1)): (float(sums[k]), int(counts[k]))
            for k in np.flatnonzero(counts)}


def q16_reference(star, first_day="2000-02-01", days=60):
    """The q16 shape over the numpy tables: tickets sold in the window
    (d_date between first_day and first_day + days) with at least two lines
    (items are distinct within a ticket) and no returned line. Returns
    (order_count, total_sales, rows)."""
    ss, sr = star["store_sales"], star["store_returns"]
    d0 = int(np.datetime64(first_day, "D").astype(np.int64)) + JULIAN_OF_EPOCH
    sk = ss["ss_sold_date_sk"]
    in_win = ss["ss_sold_date_sk__valid"] & (sk >= d0) & (sk <= d0 + days)
    tk = ss["ss_ticket_number"]
    lines = np.bincount(tk)
    returned = np.zeros(lines.size, dtype=bool)
    returned[sr["sr_ticket_number"]] = True
    keep = in_win & (lines[tk] >= 2) & ~returned[tk]
    return (int(np.unique(tk[keep]).size),
            float(ss["ss_ext_sales_price"][keep].sum()), int(keep.sum()))


# ---------------------------------------------------------------------------
# branches
# ---------------------------------------------------------------------------


def window_kind(wf):
    """`fn frame` of a window function, as the executors classify its
    frame: `whole` (the partition), `range` (the default with ORDER BY:
    unbounded preceding to the current row's last peer), `running` (ROWS
    unbounded preceding to the current row) or `rows` (a bounded ROWS
    frame); ranking functions have no frame."""
    if wf.fn in ("rank", "dense_rank", "row_number"):
        return wf.fn
    f = wf.frame
    if (not wf.order_by and f is None) or f == (("unbounded", "preceding"),
                                                ("unbounded", "following")):
        kind = "whole"
    elif f is None:
        kind = "range"
    elif f == (("unbounded", "preceding"), ("current", None)):
        kind = "running"
    else:
        kind = "rows"
    return f"{wf.fn} {kind}"


def branch_spy(executor_cls, events):
    """Wrap an executor class's join, set-operator, aggregation and window
    methods so that each call appends the branch it took to `events`, e.g.
    "inner packed join, 2 keys", "semi hash join, 1 key, residual",
    "cross join", "except", "distinct", "count(distinct)",
    "sort group-by, 2 keys", "window rank, sum whole", "grouping sets, 3
    sets", "grouping()", "blocked union, 1 key", "spilled join, 8
    partitions" (the out-of-core paths, recorded where they ran rather
    than declined: a join's partitions add their own join events before
    it). Returns a function that
    restores the class. The method names are the JAX executor's too, so
    the tests put the same spy on both engines."""
    originals = {}
    joins = []  # one frame per running _join: the branch its paths took
    aggs = []  # one frame per running _aggregate_once

    def wrap(name, make):
        originals[name] = getattr(executor_cls, name)
        setattr(executor_cls, name, make(originals[name]))

    def join(orig):
        def run(self, left, right, kind, left_keys, *a, **kw):
            joins.append([])
            try:
                out = orig(self, left, right, kind, left_keys, *a, **kw)
            finally:
                took = joins.pop()
            branch = took[0] if took else "hash"
            if joins:  # a right join runs as the swapped left join
                joins[-1].append(branch)
            if branch == "cross":
                events.append("cross join")
                return out
            n = len(left_keys)
            residual = a[1] if len(a) > 1 else kw.get("residual")
            events.append(
                f"{kind} {branch} join, {n} key{'s' if n != 1 else ''}"
                + (", residual" if residual is not None else ""))
            return out
        return run

    def path(branch):
        def make(orig):
            def run(self, *a, **kw):
                out = orig(self, *a, **kw)
                if out is not None and joins:
                    joins[-1].append(branch)
                return out
            return run
        return make

    def cross(orig):
        def run(self, *a, **kw):
            if joins:
                joins[-1].append("cross")
            return orig(self, *a, **kw)
        return run

    def node(label):
        def make(orig):
            def run(self, n, *a, **kw):
                ev = label(n)
                if ev is not None:
                    events.append(ev)
                return orig(self, n, *a, **kw)
            return run
        return make

    def aggregate(orig):
        def run(self, key_items, agg_items, subset, *a, **kw):
            aggs.append([])
            try:
                out = orig(self, key_items, agg_items, subset, *a, **kw)
            finally:
                took = aggs.pop()
            n = len(key_items) if subset is None else len(subset)
            if n == 0:
                events.append("global aggregate")
            else:
                events.append(f"{took[0] if took else 'sort'} group-by, "
                              f"{n} key{'s' if n != 1 else ''}")
            return out
        return run

    def direct(orig):
        def run(self, *a, **kw):
            out = orig(self, *a, **kw)
            if out is not None and aggs:
                aggs[-1].append("direct")
            return out
        return run

    def grouping(orig):
        def run(self, agg, *a, **kw):
            if agg.fn == "grouping":
                events.append("grouping()")
            return orig(self, agg, *a, **kw)
        return run

    def spilled(op, parts_of):
        def make(orig):
            def run(self, *a, **kw):
                out = orig(self, *a, **kw)
                if out is not None:
                    events.append(f"spilled {op}, {parts_of(a)} partitions")
                return out
            return run
        return make

    def blocked(orig):
        def run(self, node, ctx, subset, *a, **kw):
            n = len(node.keys) if subset is None else len(subset)
            events.append(f"blocked union, {n} key{'s' if n != 1 else ''}")
            return orig(self, node, ctx, subset, *a, **kw)
        return run

    wrap("_join", join)
    wrap("_try_dense_join", path("dense"))
    wrap("_try_packed_join", path("packed"))
    wrap("_cross_join", cross)
    wrap("_exec_distinct", node(lambda n: "distinct"))
    wrap("_exec_setop", node(lambda n: n.op))
    wrap("_eval_distinct_agg", node(lambda agg: f"{agg.fn}(distinct)"))
    wrap("_aggregate_once", aggregate)
    wrap("_try_direct_agg", direct)
    wrap("_exec_window", node(lambda n: "window " + ", ".join(
        window_kind(wf) for wf, _ in n.fns)))
    wrap("_exec_aggregate", node(
        lambda n: None if n.grouping_sets is None
        else f"grouping sets, {len(n.grouping_sets)} sets"))
    wrap("_eval_agg", grouping)
    wrap("_blocked_union_once", blocked)
    wrap("_spilled_join", spilled("join", lambda a: a[-1]))
    wrap("_spilled_take", spilled("sort", lambda a: a[2]))
    wrap("_spilled_distinct", spilled("distinct", lambda a: a[-1]))

    def restore():
        for name, fn in originals.items():
            setattr(executor_cls, name, fn)
    return restore


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def f64_sum_rtol(max_group_rows: int) -> float:
    """Relative tolerance between two f64 sums of the same up to
    `max_group_rows` non-negative terms added in different orders: each is
    within rows * 2^-53 of the exact sum, so they differ by less than
    (rows + 1) * 2^-52 of it."""
    return (max_group_rows + 1) * 2.0**-52


def f32_sum_rtol(max_group_rows: int) -> float:
    """Relative tolerance of an f32-accumulated sum of up to
    `max_group_rows` non-negative terms against an exact one: each add
    rounds by at most 2^-24 of the running sum, and the f64 -> f32 input
    cast by 2^-24 of each term, so the error is below
    (rows + 1) * 2^-24 of the sum. Never tighter than the validator's
    1e-5 epsilon (nds_tpu/validate.py compare)."""
    return max(1e-5, (max_group_rows + 1) * 2.0**-24)


#: segment_sums' relative tolerance against another f64 sum of the same
#: f32 values (its plain version, an f64 index_add_): the kernel adds in f64
#: in some order and rounds once to f32, so its sum is within one f32 ulp
#: (2^-23 of the value) of the other sum rounded or not; the f64 orders
#: differ by far less
ROUNDED_SUM_RTOL = 2.0**-23


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
            rtol = ROUNDED_SUM_RTOL
            err = float((ks - ps).abs().max().item())
            ok = exact and bool(
                ((ks - ps).abs() <= rtol * ps.abs().clamp(min=1.0)).all()
            )
            slot = torch.where((gid >= 0) & (gid < g), gid, g).long()

            vals64 = vals.double()

            def lib():  # f64 adds, one rounding to f32
                return torch.zeros(g + 1, dtype=torch.float64,
                                   device=vals.device).index_add_(
                    0, slot, vals64)[:g].float()
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
    ROUNDED_SUM_RTOL of an f64 index_add_); kernel ms (CUDA events), device ms and
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
    # each sum is held against an f64 index_add_ of the same values within
    # ROUNDED_SUM_RTOL; counts exact against the plain version
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
            rec["rtol"] = ROUNDED_SUM_RTOL
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
            return bool(torch.equal(kc, pc)) and bool(
                ((ks - ps).abs() <= ROUNDED_SUM_RTOL * ps.abs()).all())
        timed({"name": "segment_sums", "case": "q3_shape", "n": n,
               "groups": g, "tables": plan.tables, "blocks": blocks,
               "plan_picks": blocks == chosen.blocks},
              lambda plan=plan: GK._segment_sums_launch(vals, gid, g, plan),
              lambda: GK.segment_sums_plain(vals, gid, g),
              n * 8 + g * 8, check)
    return rows


#: what each joins-phase query must do at SF100 (branch_spy events; an
#: event listed twice must happen twice) and the fact tables it reads
JOIN_BRANCHES = {
    "q93": ["inner packed join, 2 keys", "inner dense join, 1 key",
            "direct group-by, 1 key"],
    "q78": ["left packed join, 2 keys"],
    "q16": ["semi hash join, 1 key, residual", "anti packed join, 1 key",
            "count(distinct)"],
    "q97": ["sort group-by, 2 keys", "sort group-by, 2 keys",
            "full hash join, 2 keys"],
    "q28": ["cross join", "count(distinct)"],
    "q87": ["distinct", "except"],
}
JOIN_FACTS = {"q93": ("store_sales", "store_returns"),
              "q78": ("store_sales", "store_returns"),
              "q16": ("store_sales", "store_returns"),
              "q97": ("store_sales", "catalog_sales"),
              "q28": ("store_sales",),
              "q87": ("store_sales", "catalog_sales")}
#: the kernels the joins phase must launch: the dimension joins' dense
#: builds and the float sums (no join query takes a min/max, and no ORDER
#: BY of theirs sorts one word of at most SORT_MAX_DOMAIN at SF100)
JOIN_KERNELS = ("segment_sums", "dense_build")


def missing_branches(events, wanted):
    left = list(events)
    missing = []
    for w in wanted:
        if w in left:
            left.remove(w)
        else:
            missing.append(w)
    return missing


def same_topk(got, ref, rtol_of, tag):
    """Two `ORDER BY sum, key LIMIT k` results as [(key, sum)] lists: the
    sums agree position by position within rtol_of(key); a key in both
    has sums within its rtol; a key in one only is a tie at the cut (its
    sum within rtol of the last). Float order among near-equal sums may
    differ between f32 and f64 accumulation."""
    if len(got) != len(ref):
        fail(f"{tag}: {len(got)} rows vs {len(ref)}")
    worst = 0.0
    for (gk, gs), (rk, rs) in zip(got, ref):
        rel = abs(gs - rs) / max(abs(rs), 1e-300)
        worst = max(worst, rel)
        if rel > max(rtol_of(gk), rtol_of(rk)):
            fail(f"{tag}: sum {gs} vs {rs} at the same place")
    g, r = dict(got), dict(ref)
    last = ref[-1][1] if ref else 0.0
    for k in set(g) | set(r):
        if k in g and k in r:
            if abs(g[k] - r[k]) > rtol_of(k) * max(abs(r[k]), 1e-300):
                fail(f"{tag}: key {k}: {g[k]} vs {r[k]}")
        elif abs(g.get(k, r.get(k)) - last) > rtol_of(k) * max(abs(last), 1e-300):
            fail(f"{tag}: key {k} in one result only, not at the cut")
    return worst


def q93_rows(res):
    rows = res.to_pylist()
    keys = [(r["sumsales"], -float("inf") if r["ss_customer_sk"] is None
             else r["ss_customer_sk"]) for r in rows]
    if keys != sorted(keys):
        fail("q93 rows are not in ORDER BY order")
    return [(r["ss_customer_sk"], r["sumsales"]) for r in rows]


def check_q16(res, got_off, ref, both=False):
    """q16 against numpy (order_count exactly, total_sales to the f32 bound
    of its rows) and against the off session to the same bound; with
    `both`, the off session against numpy (to 1e-9) too, returning each
    side's relative error."""
    want_n, want_sum, want_rows = ref
    sides = [("on", res, f32_sum_rtol(want_rows))]
    if both:
        sides.append(("off", got_off, 1e-9))
    out = {}
    for tag, r, tol in sides:
        row = r.to_pylist()[0]
        if row["order_count"] != want_n:
            fail(f"q16 {tag}: order_count {row['order_count']} != {want_n}")
        rel = abs(row["total_sales"] - want_sum) / max(want_sum, 1e-300)
        if rel > tol:
            fail(f"q16 {tag}: total_sales {row['total_sales']} vs "
                 f"{want_sum} (rel {rel})")
        out[tag] = rel
    if both:
        return out
    return same_result(res, got_off, f32_sum_rtol(want_rows), "q16 on vs off")


def joins_phase(torch, GK, TX, B, Session, star, tables, dev, on, off,
                rows, checks):
    """The joins and set operators at SF100 row counts: JOIN_QUERIES through
    a session with the kernels on and one with them off. Each query must
    take its JOIN_BRANCHES and give the same result both ways; q93 and q16
    must equal their numpy references. Launch counts are zeroed just
    before the cold runs and read just after. `checks` gains, per query,
    the phase's check of a result with the kernels on (against the off
    result and the numpy reference, to the phase's tolerance)."""
    t_phase = time.perf_counter()
    s_on = Session(conf=on)
    s_off = Session(conf=off, device="cuda")
    for s in (s_on, s_off):
        for name, t in tables.items():
            s.register_table(name, t)

    refused = {q: refusal(B, s_on, JOIN_QUERIES[q]) for q in JOIN_QUERIES}

    def run(session, q):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with admitted(session, refused[q]):
            res = session.sql(JOIN_QUERIES[q]).collect()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    # the declared-key checks (_pk_holds: one sort of the packed key words
    # per table and session) are cold cost, timed apart from the queries
    pk_ms = {}
    for name, pk in (("store_sales", ["ss_item_sk", "ss_ticket_number"]),
                     ("store_returns", ["sr_item_sk", "sr_ticket_number"])):
        for s in (s_on, s_off):
            torch.cuda.synchronize()
            t = time.perf_counter()
            s.catalog.load(name, pk)
            torch.cuda.synchronize()
            pk_ms.setdefault(name, (time.perf_counter() - t) * 1e3)
            if not s.catalog.entries[name].pk_verified:
                fail(f"the primary key of {name} does not hold in the data")

    torch.cuda.reset_peak_memory_stats(dev)
    GK.reset_launches()
    prev = dict(GK.LAUNCHES)
    cold, events, per_query, peaks = {}, {}, {}, {}
    for q in JOIN_QUERIES:
        ev = events[q] = []
        restore = branch_spy(TX.Executor, ev)
        try:
            cold[q] = run(s_on, q)
        finally:
            restore()
        per_query[q] = {k: GK.LAUNCHES[k] - prev[k] for k in GK.LAUNCHES}
        prev = dict(GK.LAUNCHES)
    launches = dict(GK.LAUNCHES)
    peak_all = torch.cuda.max_memory_allocated(dev) / 2**30
    reserved_all = torch.cuda.max_memory_reserved(dev) / 2**30
    for name in JOIN_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the joins path")
    for q, wanted in JOIN_BRANCHES.items():
        missing = missing_branches(events[q], wanted)
        if missing:
            fail(f"{q} did not take {missing}: it took {events[q]}")

    ref93 = q93_reference(star)
    ref16 = q16_reference(star)
    out = {}
    for q in JOIN_QUERIES:
        res, cold_ms = cold[q]
        torch.cuda.synchronize()
        # the allocator gap of budget_record is read from an emptied cache
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        steady = [run(s_on, q)[1] for _ in range(STEADY_RUNS)]
        peaks[q] = torch.cuda.max_memory_allocated(dev) / 2**30
        budget = budget_record(B, s_on, peaks[q] * 2**30 - before, dev,
                               refused[q])
        got_off, off_cold_ms = run(s_off, q)
        off_ms = run(s_off, q)[1]
        prof = profile_query(torch, lambda q=q: run(s_on, q), q)
        rec = {"phase": "join_query", "query": q, "rows": res.num_rows,
               "cold_ms": cold_ms, "steady_ms": float(np.median(steady)),
               "steady_runs_ms": steady, "off_ms": off_ms,
               "off_cold_ms": off_cold_ms, "branches": events[q],
               "launches": per_query[q], "steady_peak_gib": peaks[q],
               "device_busy_share": prof["device_busy_share"],
               "device_ms": prof["device_ms"],
               "device_launches": prof["device_launches"],
               "top": prof["top"][:5], "budget": budget,
               "refusal": refused[q]}
        fact = sum(rows[t] for t in JOIN_FACTS[q])
        rec["fact_rows"] = fact
        rec["fact_rows_per_s"] = fact / (rec["steady_ms"] / 1e3)
        if res.num_rows == 0:
            fail(f"{q} returned no rows")
        if q == "q93":
            def rtol_of(k):
                return f32_sum_rtol(ref93[k][1]) if k in ref93 else 1e-5
            ref_top = sorted(
                ((k, v[0]) for k, v in ref93.items()),
                key=lambda kv: (kv[1], -float("inf") if kv[0] is None
                                else kv[0]))[:100]

            def check(r, got_off=got_off, rtol_of=rtol_of, ref_top=ref_top):
                same_topk(q93_rows(r), ref_top, rtol_of, "q93 vs numpy")
                return same_topk(q93_rows(r), q93_rows(got_off), rtol_of,
                                 "q93 on vs off")
            check.rtol_of = rtol_of  # the fuse phase compares with it too

            rec["max_rel_vs_off"] = check(res)
            rec["max_rel_vs_numpy"] = same_topk(
                q93_rows(res), ref_top, rtol_of, "q93 vs numpy")
            rec["max_rel_off_vs_numpy"] = same_topk(
                q93_rows(got_off), ref_top, lambda k: 1e-9,
                "q93 off vs numpy")
        else:
            # float sums through segment_sums (f32) against the off
            # session's f64 sums: the q3 bound for the largest group; other
            # floats (avg in f64 on both sides) to 1e-9
            rtol = 1e-9
            if q == "q78":
                rtol = f32_sum_rtol(max(got_off.column("cnt").to_pylist()))
            elif q == "q16":
                rtol = f32_sum_rtol(ref16[2])
            rec["rtol"] = rtol
            check = functools.partial(same_result, b=got_off, rtol=rtol,
                                      tag=f"{q} on vs off")
            if q == "q16":
                check = functools.partial(check_q16, got_off=got_off,
                                          ref=ref16)
            rec["max_rel_vs_off"] = check(res)
        if q == "q16":
            for tag, rel in check_q16(res, got_off, ref16, both=True).items():
                rec[f"rel_vs_numpy_{tag}"] = rel
            rec["numpy"] = dict(zip(("order_count", "total_sales", "rows"),
                                    ref16))
        checks[q] = check
        out[q] = rec
        emit(rec)
    emit({"phase": "joins", "launches": launches, "pk_check_ms": pk_ms,
          "peak_gib": peak_all, "reserved_peak_gib": reserved_all,
          "resident_gib": torch.cuda.memory_allocated(dev) / 2**30,
          "steady_runs": STEADY_RUNS, "reduced": STEADY_CUT,
          "seconds": time.perf_counter() - t_phase})
    return out, launches


#: what each windows-phase query must do at SF100 (branch_spy events; an
#: event listed twice must happen twice) and the fact tables it reads
WINDOW_BRANCHES = {
    "q98": ["window sum whole", "inner dense join, 1 key",
            "inner dense join, 1 key"],
    "q36": ["grouping sets, 3 sets", "grouping()", "window rank",
            "inner dense join, 1 key"],
    "q67": ["grouping sets, 9 sets", "window rank",
            "inner dense join, 1 key"],
    "q51": ["window sum running", "window sum running",
            "full hash join, 2 keys", "window max running, max running"],
    "q5": ["blocked union, 1 key", "grouping sets, 3 sets",
           "inner dense join, 1 key"],
}
WINDOW_FACTS = {"q98": ("store_sales",), "q36": ("store_sales",),
                "q67": ("store_sales",),
                "q51": ("store_sales", "catalog_sales"),
                "q5": ("store_sales", "store_returns")}
#: the kernels every windows-phase query must launch: the group-by float
#: sums under its windows and rollups, and its dimension joins' builds
WINDOW_KERNELS = ("segment_sums", "dense_build")
#: steady runs per query of the slice, joins and windows phases: three
#: of the five they took until the throughput phase joined the script
#: (STEADY_CUT lists the cut in their lines' `reduced`)
STEADY_RUNS = 3
STEADY_CUT = [f"{STEADY_RUNS} steady runs a query of 5 (the time limit)"]


def _julian(day: str) -> int:
    return int(np.datetime64(day, "D").astype(np.int64)) + JULIAN_OF_EPOCH


def f32_cancel_rtol(rows: int, abs_sum: float, total: float) -> float:
    """f32_sum_rtol for a sum whose terms have both signs: the error bound
    is relative to the sum of the terms' magnitudes, so it scales by
    abs_sum / |total| against the sum itself."""
    return f32_sum_rtol(rows) * abs_sum / max(abs(total), 1e-300)


def q98_reference(star, cats=("Sports", "Books", "Home"),
                  first_day="1999-02-22", days=30):
    """query98 over the numpy tables: {item row: (revenue, rows, ratio)}
    for the items of `cats` sold in the window."""
    ss, it = star["store_sales"], star["item"]
    d0 = _julian(first_day)
    sk = ss["ss_sold_date_sk"]
    ii = ss["ss_item_sk"] - 1
    cat_ok = np.isin(it["i_category"], [CATEGORIES.index(c) for c in cats])
    keep = np.flatnonzero(ss["ss_sold_date_sk__valid"] & (sk >= d0)
                          & (sk <= d0 + days) & cat_ok[ii])
    items = ii[keep]
    n = it["i_item_sk"].shape[0]
    rev = np.bincount(items, weights=ss["ss_ext_sales_price"][keep],
                      minlength=n)
    cnt = np.bincount(items, minlength=n)
    sold = np.flatnonzero(cnt)
    cls = it["i_class"]
    class_tot = np.bincount(cls[sold], weights=rev[sold],
                            minlength=len(dictionary("i_class")))
    return {int(r): (float(rev[r]), int(cnt[r]),
                     float(rev[r] * 100 / class_tot[cls[r]])) for r in sold}


def q36_reference(star, year=2001, states=Q36_STATES):
    """query36 over the numpy tables: {(lochierarchy, category, class):
    (gross margin, rows, sum of |net profit|, net profit, sales)} with
    the rolled-up keys None."""
    ss, it, st, dd = (star["store_sales"], star["item"], star["store"],
                      star["date_dim"])
    di = ss["ss_sold_date_sk"] - DATE_FIRST_SK
    year_ok = dd["d_year"] == year
    state_ok = np.isin(st["s_state"], [STATES.index(s) for s in states])
    si = ss["ss_store_sk"] - 1
    keep = np.flatnonzero(ss["ss_sold_date_sk__valid"]
                          & ss["ss_store_sk__valid"] & year_ok[di]
                          & state_ok[si])
    del di, si
    ii = ss["ss_item_sk"][keep] - 1
    n_cls = len(dictionary("i_class"))
    code = it["i_category"][ii].astype(np.int64) * n_cls + it["i_class"][ii]
    p = ss["ss_net_profit"][keep]
    s = ss["ss_ext_sales_price"][keep]
    m = 10 * n_cls
    sums = [np.bincount(code, weights=w, minlength=m)
            for w in (p, np.abs(p), s)]
    cnt = np.bincount(code, minlength=m)
    out = {}

    def put(key, sel):
        P, A, S = (float(x[sel].sum()) for x in sums)
        n = int(cnt[sel].sum())
        if n:
            out[key] = (P / S, n, A, P, S)
    cats, classes = CATEGORIES, dictionary("i_class")
    for c in np.flatnonzero(cnt):
        put((0, cats[c // n_cls], classes[c % n_cls]), np.array([c]))
    for k in range(10):
        put((1, cats[k], None), np.arange(k * n_cls, (k + 1) * n_cls))
    put((2, None, None), np.arange(m))
    return out


def q5_reference(star, first_day="2000-08-23", days=14):
    """The query5 store channel over the numpy tables: {store id: (sales,
    returns, profit, rows, sum of |profit terms|)}, profit being net profit
    less net loss."""
    ss, sr, st = star["store_sales"], star["store_returns"], star["store"]
    d0 = _julian(first_day)
    ids = np.array(dictionary("s_store_id"), dtype=object)[st["s_store_id"]]
    n_st = st["s_store_sk"].shape[0]

    def side(t, date, store, cols):
        sk = t[date]
        keep = np.flatnonzero(t[date + "__valid"] & t[store + "__valid"]
                              & (sk >= d0) & (sk <= d0 + days))
        s = t[store][keep] - 1
        return [np.bincount(s, minlength=n_st)] + [
            np.bincount(s, weights=w, minlength=n_st)
            for w in (x(t, keep) for x in cols)]
    n1, sales, prof, aprof = side(
        ss, "ss_sold_date_sk", "ss_store_sk",
        [lambda t, k: t["ss_ext_sales_price"][k],
         lambda t, k: t["ss_net_profit"][k],
         lambda t, k: np.abs(t["ss_net_profit"][k])])
    n2, rets, loss = side(
        sr, "sr_returned_date_sk", "sr_store_sk",
        [lambda t, k: t["sr_return_amt"][k],
         lambda t, k: t["sr_net_loss"][k]])
    out = {}
    for r in np.flatnonzero(n1 + n2):
        v = out.get(ids[r], (0.0, 0.0, 0.0, 0, 0.0))
        out[ids[r]] = (v[0] + sales[r], v[1] + rets[r],
                       v[2] + prof[r] - loss[r], v[3] + int(n1[r] + n2[r]),
                       v[4] + aprof[r] + loss[r])
    return out


def same_ranked(got, ref, keys, val, rank, part, rtol_of, tag):
    """Two results holding a rank over float sums, equal up to the f32
    reassociation of those sums: the same number of rows; rows matched by
    `keys` with values within rtol_of(row); a rank that differs only where
    a row of the same partition (part(row)) lies within twice the
    tolerance, so that the two could trade places; and a row in one result
    only paired with one in the other within twice the tolerance (the two
    traded places at a rank cut)."""
    if got.num_rows != ref.num_rows:
        fail(f"{tag}: {got.num_rows} rows vs {ref.num_rows}")
    g = {tuple(r[k] for k in keys): r for r in got.to_pylist()}
    f = {tuple(r[k] for k in keys): r for r in ref.to_pylist()}
    rows = list(g.values()) + list(f.values())

    def close(a, b, tol):
        return abs(a - b) <= tol * max(abs(a), abs(b), 1e-300)
    worst = 0.0
    for k in set(g) & set(f):
        a, b = g[k][val], f[k][val]
        if a is None or b is None:
            if a is not b:
                fail(f"{tag}: {k}: {a} vs {b}")
            continue
        tol = rtol_of(f[k])
        worst = max(worst, abs(a - b) / max(abs(b), 1e-300))
        if not close(a, b, tol):
            fail(f"{tag}: {k}: {a} vs {b} (rtol {tol})")
        if g[k][rank] != f[k][rank]:
            near = [r for r in rows if part(r) == part(f[k])
                    and tuple(r[c] for c in keys) != k
                    and r[val] is not None and close(r[val], b, 2 * tol)]
            if abs(g[k][rank] - f[k][rank]) > len(near):
                fail(f"{tag}: {k}: rank {g[k][rank]} vs {f[k][rank]}")
    only_g = sorted((g[k] for k in set(g) - set(f)), key=lambda r: r[val])
    only_f = sorted((f[k] for k in set(f) - set(g)), key=lambda r: r[val])
    for a, b in zip(only_g, only_f):
        if not close(a[val], b[val], 2 * rtol_of(b)):
            fail(f"{tag}: {a} in one result only, {b} in the other")
    return worst


def windows_phase(torch, GK, TX, B, Session, star, tables, dev, on, off,
                  rows, scale, checks):
    """Windows, ROLLUP / grouping sets, grouping() and blocked union
    aggregation at SF100 row counts: WINDOW_QUERIES through a session with
    the kernels on and one with them off, over the tables with the
    WINDOW_COLUMNS added. Each query must take its WINDOW_BRANCHES, launch
    the WINDOW_KERNELS and give the same result both ways; q98, q36 and
    the q5 shape must equal their numpy references. Launch counts are
    zeroed just before the cold runs and read just after. At a cut
    --scale the q5 shape's union fits one default window, so the window is
    set to an eighth of its rows there (the `union_window` of its line).
    `checks` gains, per query, the phase's check of a result with the
    kernels on. Last, over the phase's tables and conf, the fuse phase's
    q5 shape (fuse_q5). Returns (per-query lines, launches, fuse_q5's
    record)."""
    t_phase = time.perf_counter()
    wtables = to_tables(star, dev, windows=True, base=tables)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev) / 2**30
    extra = {}
    if scale < 1.0:
        union_rows = rows["store_sales"] + rows["store_returns"]
        extra["engine.union_agg_window_rows"] = max(union_rows // 8, 1024)
    s_on = Session(conf={**on, **extra})
    s_off = Session(conf={**off, **extra}, device="cuda")
    for s in (s_on, s_off):
        for name, t in wtables.items():
            s.register_table(name, t)

    refused = {q: refusal(B, s_on, WINDOW_QUERIES[q])
               for q in WINDOW_QUERIES}

    def run(session, q):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with admitted(session, refused[q]):
            res = session.sql(WINDOW_QUERIES[q]).collect()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    torch.cuda.reset_peak_memory_stats(dev)
    GK.reset_launches()
    prev = dict(GK.LAUNCHES)
    cold, events, per_query, blocked = {}, {}, {}, {}
    for q in WINDOW_QUERIES:
        ev = events[q] = []
        s_on.last_blocked_union = None
        restore = branch_spy(TX.Executor, ev)
        try:
            cold[q] = run(s_on, q)
        finally:
            restore()
        blocked[q] = s_on.last_blocked_union
        per_query[q] = {k: GK.LAUNCHES[k] - prev[k] for k in GK.LAUNCHES}
        prev = dict(GK.LAUNCHES)
    launches = dict(GK.LAUNCHES)
    peak_all = torch.cuda.max_memory_allocated(dev) / 2**30
    reserved_all = torch.cuda.max_memory_reserved(dev) / 2**30
    for q, wanted in WINDOW_BRANCHES.items():
        missing = missing_branches(events[q], wanted)
        if missing:
            fail(f"{q} did not take {missing}: it took {events[q]}")
        for name in WINDOW_KERNELS:
            if per_query[q][name] == 0:
                fail(f"{q} did not launch kernel {name}")

    t_ref = time.perf_counter()
    ref98, ref36, ref5 = (q98_reference(star), q36_reference(star),
                          q5_reference(star))
    ref_s = time.perf_counter() - t_ref
    item_of = {dictionary("i_item_id")[c]: r
               for r, c in enumerate(star["item"]["i_item_id"])}
    out = {}
    for q in WINDOW_QUERIES:
        res, cold_ms = cold[q]
        torch.cuda.synchronize()
        # the allocator gap of budget_record is read from an emptied cache
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        steady = [run(s_on, q)[1] for _ in range(STEADY_RUNS)]
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        budget = budget_record(B, s_on, peak * 2**30 - before, dev,
                               refused[q])
        got_off, off_cold_ms = run(s_off, q)
        off_ms = run(s_off, q)[1]
        # torch's scatter kernel: segment_starts' amin scatter (queue 2
        # item E1), compaction's scatter and the reducing scatters
        prof = profile_query(torch, lambda q=q: run(s_on, q), q,
                             match="_scatter_gather_elementwise_kernel")
        rec = {"phase": "window_query", "query": q, "rows": res.num_rows,
               "cold_ms": cold_ms, "steady_ms": float(np.median(steady)),
               "steady_runs_ms": steady, "off_ms": off_ms,
               "off_cold_ms": off_cold_ms, "branches": events[q],
               "launches": per_query[q], "steady_peak_gib": peak,
               "device_busy_share": prof["device_busy_share"],
               "device_ms": prof["device_ms"],
               "device_launches": prof["device_launches"],
               "scatter_ms": prof["match_ms"],
               "top": prof["top"][:5], "budget": budget,
               "refusal": refused[q]}
        fact = sum(rows[t] for t in WINDOW_FACTS[q])
        rec["fact_rows"] = fact
        rec["fact_rows_per_s"] = fact / (rec["steady_ms"] / 1e3)
        if res.num_rows == 0:
            fail(f"{q} returned no rows")
        if q == "q98":
            check = functools.partial(check_q98, got_off=got_off, ref=ref98,
                                      item_of=item_of)
        elif q == "q36":
            check = functools.partial(check_q36, got_off=got_off, ref=ref36)
        elif q == "q67":
            # the sums reach the f32 kernel once per rollup level: a row's
            # error is bounded by the fan-ins along its path (a finest
            # group's rows, 201 stores, 3 months, 4 quarters, 1 year, the
            # products of a brand, 10 brands, 8 classes, 10 categories:
            # under 512 at SF100) plus one f64 -> f32 rounding per level
            rtol = f32_sum_rtol(1024)
            rec["rtol"] = rtol

            def check(r, got_off=got_off, rtol=rtol):
                return {"max_rel_vs_off": same_ranked(
                    r, got_off, ["i_category", "i_class", "i_brand",
                                 "i_product_name", "d_year", "d_qoy",
                                 "d_moy", "s_store_id"],
                    "sumsales", "rk", lambda x: x["i_category"],
                    lambda x: rtol, "q67 on vs off")}
        elif q == "q51":
            # running sums of (item, date) group sums, each of a few rows
            # summed in f32; a running max of those
            rtol = f32_sum_rtol(64)
            rec["rtol"] = rtol

            def check(r, got_off=got_off, rtol=rtol):
                return {"max_rel_vs_off": same_result(r, got_off, rtol,
                                                      "q51 on vs off")}
        else:
            rec["union_window"] = (extra.get("engine.union_agg_window_rows")
                                   or "default")
            rec["blocked_union"] = blocked[q]
            check_q5_windows(blocked[q], extra, budget, rows)
            check = functools.partial(check_q5, got_off=got_off, ref=ref5,
                                      windows=blocked[q]["windows"])
        rec.update(check(res))
        checks[q] = check
        out[q] = rec
        emit(rec)
    del s_on, s_off
    torch.cuda.empty_cache()
    q5_fused = fuse_q5(torch, TX, B, Session, wtables, dev, on, extra, rows,
                       checks)
    del wtables
    emit({"phase": "windows", "launches": launches, "peak_gib": peak_all,
          "reserved_peak_gib": reserved_all,
          "resident_gib": resident, "numpy_reference_s": ref_s,
          "steady_runs": STEADY_RUNS, "reduced": STEADY_CUT,
          "seconds": time.perf_counter() - t_phase})
    return out, launches, q5_fused


def check_q5_windows(blocked, extra, budget, rows):
    """The q5 shape aggregates its union in windows of the size the
    session resolves (the conf window at a cut --scale; else the plan
    budgeter's static window where its verdict annotated one; else the
    catalog budget's default, a power of two in [2^16, 2^24]), one run of
    window slices (the window's power-of-two capacity) over each branch:
    store_sales, then store_returns."""
    if not blocked:
        fail("q5 did not aggregate its union in windows")
    wrows = blocked["window_rows"]
    want = extra.get("engine.union_agg_window_rows")
    if want is None and budget["annotated"]:
        want = budget["window_rows"]
    if want is not None and wrows != want:
        fail(f"q5 windows of {wrows} rows, the session resolves {want}")
    if want is None and (wrows & (wrows - 1) or
                         not 1 << 16 <= wrows <= 1 << 24):
        fail(f"q5 windows of {wrows} rows: not a default window size")
    branch_rows = (rows["store_sales"], rows["store_returns"])
    wcap = blocked["window_cap"]  # the window's power-of-two slice
    n = sum(-(-r // wcap) for r in branch_rows)
    if blocked["total_rows"] != sum(branch_rows) or blocked["windows"] != n:
        fail(f"q5 aggregated {blocked['total_rows']} rows in "
             f"{blocked['windows']} windows of {wcap}; want "
             f"{sum(branch_rows)} rows in {n}")


def check_q98(res, got_off, ref, item_of):
    """q98 on and off against numpy: every row's revenue and ratio, the
    row count, the ORDER BY."""
    rows = res.to_pylist()
    keys = [(r["i_category"], r["i_class"], r["i_item_id"], r["i_item_desc"],
             r["revenueratio"]) for r in rows]
    if keys != sorted(keys):
        fail("q98 rows are not in ORDER BY order")
    if res.num_rows != min(100, len(ref)):
        fail(f"q98: {res.num_rows} rows, numpy has {len(ref)} items")
    rtol = 2 * f32_sum_rtol(max(v[1] for v in ref.values()))
    out = {"rtol": rtol}
    for tag, r_, tol in (("on", res, rtol), ("off", got_off, 1e-9)):
        worst = 0.0
        for r in r_.to_pylist():
            rev, _, ratio = ref[item_of[r["i_item_id"]]]
            for a, b in ((r["itemrevenue"], rev), (r["revenueratio"], ratio)):
                rel = abs(a - b) / max(abs(b), 1e-300)
                worst = max(worst, rel)
                if rel > tol:
                    fail(f"q98 {tag} vs numpy: {a} vs {b} (rel {rel})")
        out[f"max_rel_vs_numpy_{tag}"] = worst
    out["max_rel_vs_off"] = same_result(res, got_off, rtol, "q98 on vs off")
    return out


def check_q36(res, got_off, ref):
    """q36 off against numpy (margins to 1e-9, ranks exactly) and on
    against off (same_ranked; a margin's bound is its two f32 sums',
    net profit's scaled by its cancellation)."""
    def key(r):
        return (r["lochierarchy"], r["i_category"], r["i_class"])

    def rtol_of(r):
        _, n, a, p, s = ref[key(r)]
        return f32_cancel_rtol(n, a, p) + f32_sum_rtol(n)

    def part(r):
        return (r["lochierarchy"],
                r["i_category"] if r["lochierarchy"] == 0 else None)
    rows = got_off.to_pylist()
    if got_off.num_rows != min(100, len(ref)):
        fail(f"q36: {got_off.num_rows} rows, numpy has {len(ref)} groups")
    worst = 0.0
    for r in rows:
        m = ref[key(r)][0]
        rel = abs(r["gross_margin"] - m) / max(abs(m), 1e-300)
        worst = max(worst, rel)
        if rel > 1e-9:
            fail(f"q36 off vs numpy: {key(r)}: {r['gross_margin']} vs {m}")
        want = 1 + sum(1 for k, v in ref.items()
                       if part({"lochierarchy": k[0], "i_category": k[1]})
                       == part(r) and v[0] < m)
        if r["rank_within_parent"] != want:
            fail(f"q36 off vs numpy: {key(r)}: rank "
                 f"{r['rank_within_parent']} vs {want}")
    return {"max_rel_off_vs_numpy": worst,
            "max_rel_vs_off": same_ranked(
                res, got_off, ["lochierarchy", "i_category", "i_class"],
                "gross_margin", "rank_within_parent", part, rtol_of,
                "q36 on vs off")}


def q5_want(ref):
    """{(channel, id): (sales, returns, profit, rows, |profit| terms)} of
    the q5 shape's numpy reference, the rollup's totals included."""
    stores = sorted(ref)
    tot = [sum(ref[s][i] for s in stores) for i in range(5)]
    want = {(None, None): tot, ("store channel", None): tot}
    for s in stores:
        want[("store channel", "store" + s)] = ref[s]
    return want


def q5_row_rtol(want_row, windows):
    """The kernels-on tolerance of one q5 row's columns: f32 sums once per
    window and once per merge of a window's partials, widened for profit
    by its cancellation (`cancel`)."""
    _, _, prof, n, aprof = want_row
    n_terms = n + 4 * windows
    cancel = max(1.0, aprof / max(abs(prof), 1e-300))
    return {"sales": f32_sum_rtol(n_terms),
            "returns_amt": f32_sum_rtol(n_terms),
            "profit": f32_sum_rtol(n_terms) * cancel, "cancel": cancel}


def q5_same(a, b, ref, windows, tag):
    """Two q5 results row by row (keyed by channel and id): each column
    within twice the kernels-on tolerance (both may sum in f32)."""
    want = q5_want(ref)
    ra = {(r["channel"], r["id"]): r for r in a.to_pylist()}
    rb = {(r["channel"], r["id"]): r for r in b.to_pylist()}
    if set(ra) != set(rb):
        fail(f"{tag}: rows differ")
    worst = 0.0
    for k, r in ra.items():
        tol = q5_row_rtol(want[k], windows)
        for col in ("sales", "returns_amt", "profit"):
            x, y = r[col], rb[k][col]
            rel = abs(x - y) / max(abs(y), 1e-300)
            worst = max(worst, rel)
            if rel > 2 * tol[col]:
                fail(f"{tag}: {k} {col}: {x} vs {y} (rel {rel})")
    return worst


def check_q5(res, got_off, ref, windows):
    """The q5 shape on and off against numpy: each store's sales, returns
    and profit, the channel and grand totals. The on session's sums run in
    f32 once per window and once per merge of a window's partials."""
    want = q5_want(ref)
    out = {}
    for tag, r_ in (("on", res), ("off", got_off)):
        rows = r_.to_pylist()
        keys = [(r["channel"] is not None, r["channel"],
                 r["id"] is not None, r["id"]) for r in rows]
        if keys != sorted(keys):
            fail(f"q5 {tag}: rows are not in ORDER BY order")
        if len(rows) != min(100, len(want)):
            fail(f"q5 {tag}: {len(rows)} rows, numpy has {len(want)}")
        worst = 0.0
        for r in rows:
            sales, rets, prof, _, _ = want[(r["channel"], r["id"])]
            on_tol = q5_row_rtol(want[(r["channel"], r["id"])], windows)
            for col, v in (("sales", sales), ("returns_amt", rets),
                           ("profit", prof)):
                tol = on_tol[col] if tag == "on" else (
                    1e-9 * on_tol["cancel"])
                rel = abs(r[col] - v) / max(abs(v), 1e-300)
                worst = max(worst, rel)
                if rel > tol:
                    fail(f"q5 {tag} vs numpy: {r['id']} {col}: {r[col]} vs "
                         f"{v} (rel {rel}, rtol {tol})")
        out[f"max_rel_vs_numpy_{tag}"] = worst
    return out


#: the mode under which a phase runs a statement that the plan budgeter
#: refuses at the card's default lines (PlanBudgetError on a `reject`
#: verdict): the reference's observe-only mode, which records the verdict
#: and neither annotates nor refuses. The refusal is checked first and
#: printed (`refused` in the query's `budget` record and the
#: `budget_refusals` line), and the phase's checks of the statement's
#: result then run as before.
# ---------------------------------------------------------------------------
# fuse: the fused pipelines, top-k and the caches at SF100
# ---------------------------------------------------------------------------

#: a session that measures steady time turns the plan / result cache off:
#: a rerun would otherwise answer from it (the JAX package's timers do the
#: same); the join-order replay stays at its default (on)
STEADY = {"engine.plan_cache": "off"}
#: the fuse phase's main-path queries: each must take FUSE_PATHS
FUSE_QUERIES = ("order", "minmax", "q3")
#: per query, the fused paths its cold run must take: (kind, stages or
#: None, fact rows in or None); `chain` a FusedPipeline call, `agg` a
#: FusedAggPipeline call, `topk` the Limit-over-Sort gather
FUSE_PATHS = {
    "order": [("chain", 1, "store_sales")],
    "minmax": [("agg", None, "store_sales")],
    "q3": [("chain", 1, "date_dim"), ("chain", 1, "item")],
    "q93": [("topk", None, None)],
}
#: the pins the JAX package's rules make on these queries at SF100 (the
#: same at any scale: they follow from the key bounds), so the fuse gate
#: allows them and no other: q3's aggregate tail groups by d_year
#: (1900..2100) and i_brand_id (1001001..10016017), a domain past the
#: direct scatter's 2^22 cells, so FusedAggPipeline raises Unfusible and
#: the tail runs on the eager sort-based group-by, as in the JAX package
FUSE_ALLOWED_PINS = {"q3": 1}
#: the cache round trip: these statements over a small star warehouse
#: (over leg A's SF0.25 warehouse each process took 75-80 s beside the
#: bench phase, which it slowed by 67 s: the time limit)
FUSE_CACHE_SCALE = 1e-4
FUSE_CACHE_ENTRIES = (
    ("query3", ("q3",)), ("minmax", ("minmax",)), ("order", ("order",)),
    ("topk", ("topk",)),
)
FUSE_TOPK_SQL = """
    select ss_item_sk, ss_quantity from store_sales
    where ss_quantity > 50 order by ss_quantity desc, ss_item_sk limit 10
"""


def fuse_spy(TF, TX, P):
    """Record the fused paths an executor takes: each FusedPipeline /
    FusedAggPipeline call (its stages and input rows), each top-k
    Limit-over-Sort, each MultiJoin's greedy order (replayed or scanned).
    Returns (events, restore)."""
    events = []
    saved = [(TF.FusedPipeline, "call"), (TF.FusedAggPipeline, "call"),
             (TX.Executor, "_exec_limit"), (TX.Executor, "_multijoin_greedy")]
    originals = [getattr(c, n) for c, n in saved]

    def fused(kind, orig):
        def call(self, table, donate):
            events.append({"kind": kind, "stages": len(self.stages),
                           "rows": table.nrows_known, "cap": table.cap})
            return orig(self, table, donate)
        return call

    def limit(self, node, _orig=originals[2]):
        if (isinstance(node.child, P.Sort)
                and getattr(node.child, "_topk_safe", False)
                and id(node.child) not in self._cte_cache):
            events.append({"kind": "topk", "n": node.n})
        return _orig(self, node)

    def greedy(self, current, edges, merged, group, n, trace=None,
               spill_parts=0, _orig=originals[3]):
        events.append({"kind": "join_order",
                       "replay": trace is not None and "steps" in trace})
        return _orig(self, current, edges, merged, group, n, trace,
                     spill_parts)

    TF.FusedPipeline.call = fused("chain", originals[0])
    TF.FusedAggPipeline.call = fused("agg", originals[1])
    TX.Executor._exec_limit = limit
    TX.Executor._multijoin_greedy = greedy

    def restore():
        for (c, n), f in zip(saved, originals):
            setattr(c, n, f)
    return events, restore


def fuse_paths_taken(events, wanted, rows):
    """The entries of `wanted` (FUSE_PATHS) that `events` lack."""
    missing = []
    for kind, stages, table in wanted:
        ok = any(e["kind"] == kind
                 and (stages is None or e["stages"] >= stages)
                 and (table is None or e["rows"] == rows[table])
                 for e in events)
        if not ok:
            missing.append((kind, stages, table))
    return missing


def order_reference_check(star):
    """The ORDER BY's numpy reference: store_sales' (ss_quantity,
    ss_item_sk) where ss_quantity > 95; the quantity column in order
    exactly, the rows as a multiset exactly."""
    ss = star["store_sales"]
    keep = ss["ss_quantity"] > 95
    q = np.sort(ss["ss_quantity"][keep])

    def packed(quantity, item):
        # one int64 per row (item keys are below 2^32): the rows as a
        # multiset, sorted
        return np.sort(quantity.astype(np.int64) << 32
                       | item.astype(np.int64))

    pairs = packed(ss["ss_quantity"][keep], ss["ss_item_sk"][keep])

    def check(res):
        gq = res.column("ss_quantity").to_numpy(zero_copy_only=False)
        gi = res.column("ss_item_sk").to_numpy(zero_copy_only=False)
        if not np.array_equal(gq.astype(np.int64), q.astype(np.int64)):
            fail("fuse: order's quantities differ from numpy's")
        if not np.array_equal(packed(gq, gi), pairs):
            fail("fuse: order's rows differ from numpy's")
        return {"rows_vs_numpy": int(q.shape[0])}
    return check


def fuse_run(torch, dev, session, sql, refused):
    torch.cuda.synchronize()
    t = time.perf_counter()
    with admitted(session, refused):
        res = session.sql(sql).collect()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t) * 1e3


def fuse_compare(torch, TF, TX, P, B, dev, q, sql, s_f, s_u, rows, checks,
                 same, profile=False):
    """One query fused (`s_f`) against unfused (`s_u`): the cold run with
    fuse_spy, the paths taken, the answer against `checks[q]` and against
    the unfused result (`same(fused, unfused)`: the query's phase
    tolerance; the card's float sums add in no fixed order), then
    STEADY_RUNS steady runs of each side in turn (the plan cache off) with
    its peak, the entries and their hits, and with `profile` one profiled
    steady run of each side (busy share)."""
    refused = refusal(B, s_f, sql)
    pins0 = s_f.exec_cache.pins
    events, restore = fuse_spy(TF, TX, P)
    try:
        res, cold_ms = fuse_run(torch, dev, s_f, sql, refused)
    finally:
        restore()
    got_u, cold_u = fuse_run(torch, dev, s_u, sql, refused)
    rec = {"phase": "fuse_query", "query": q, "rows": res.num_rows,
           "cold_ms": cold_ms, "unfused_cold_ms": cold_u,
           "paths": events,
           "pins": s_f.exec_cache.pins - pins0,
           "max_rel_vs_unfused": same(res, got_u),
           "refusal": refused}
    rec["max_rel_vs_checks"] = worst_rel(checks[q](res))
    missing = fuse_paths_taken(events, FUSE_PATHS.get(q, ()), rows)
    if missing:
        fail(f"fuse: {q} did not take {missing}: it took {rec['paths']}")
    if rec["pins"] != FUSE_ALLOWED_PINS.get(q, 0):
        fail(f"fuse: {q} pinned {rec['pins']} signature(s), "
             f"{FUSE_ALLOWED_PINS.get(q, 0)} allowed")
    for side, s in (("fused", s_f), ("unfused", s_u)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        hits0 = s.exec_cache.hits
        ms = [fuse_run(torch, dev, s, sql, refused)[1]
              for _ in range(STEADY_RUNS)]
        rec[f"{side}_steady_ms"] = float(np.median(ms))
        rec[f"{side}_steady_runs_ms"] = ms
        rec[f"{side}_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        rec[f"{side}_working_gib"] = (
            torch.cuda.max_memory_allocated(dev) - before) / 2**30
        if side == "fused":
            rec["entries"] = len(s.exec_cache.map)
            rec["rerun_hits"] = s.exec_cache.hits - hits0
            if rec["rerun_hits"] == 0 and any(
                    e["kind"] in ("chain", "agg") for e in events):
                fail(f"fuse: {q}'s reruns did not hit the exec cache")
        if profile:
            prof = profile_query(
                torch, lambda s=s: fuse_run(torch, dev, s, sql, refused), q)
            rec[f"{side}_busy_share"] = prof["device_busy_share"]
            rec[f"{side}_device_ms"] = prof["device_ms"]
    return rec


def fuse_q5(torch, TX, B, Session, wtables, dev, on, extra, rows, checks):
    """The fuse phase's q5 shape, over the windows phase's tables: fused
    against unfused with the windows phase's conf. Its blocked windows go
    through _apply_wrappers_fused; the per-window wrappers are renames,
    which neither engine fuses, so its fused entries are the union
    branches' projections, the date filter and the projections over the
    aggregate."""
    from nds_tpu_torch.engine import fuse as TF
    from nds_tpu_torch.engine import plan as P

    conf = {**on, **extra, **STEADY}
    s_f = Session(conf=conf)
    s_u = Session(conf={**conf, "engine.fuse": "off"}, device="cuda")
    for s in (s_f, s_u):
        for name, t in wtables.items():
            s.register_table(name, t)
    wrappers = []
    orig = TX.Executor._apply_wrappers_fused

    def spy(self, t, w, memo):
        wrappers.append(len(w))
        return orig(self, t, w, memo)
    TX.Executor._apply_wrappers_fused = spy
    try:
        kw = checks["q5"].keywords
        rec = fuse_compare(
            torch, TF, TX, P, B, dev, "q5", WINDOW_QUERIES["q5"], s_f, s_u,
            rows, checks, lambda a, b: q5_same(
                a, b, kw["ref"], kw["windows"], "fuse q5 vs unfused"),
            profile=True)
    finally:
        TX.Executor._apply_wrappers_fused = orig
    rec["windows_through_apply_wrappers_fused"] = len(wrappers)
    rec["blocked_union"] = s_f.last_blocked_union
    if not wrappers:
        fail("fuse: q5's windows did not go through _apply_wrappers_fused")
    if not any(e["kind"] == "chain" for e in rec["paths"]):
        fail(f"fuse: q5 took no fused chain: {rec['paths']}")
    return rec


def fuse_cache_warehouse(root, seed):
    """The cache round trip's small star warehouse under `root` and its
    stream file of FUSE_CACHE_ENTRIES. The script makes them on its main
    thread, before the round trip's thread starts: Arrow's default
    (mimalloc) pool is not safe with Arrow work on two threads (see
    nds_tpu_torch/report.py's use_system_arrow_pool). Returns (warehouse,
    stream file)."""
    wh = os.path.join(root, "cache_wh")
    write_warehouse(make_star(seed, FUSE_CACHE_SCALE), wh, workers=2)
    sql = {"q3": QUERIES["q3"], "minmax": QUERIES["minmax"],
           "order": QUERIES["order"], "topk": FUSE_TOPK_SQL}
    stream = stream_file(os.path.join(root, "cache_stream.sql"), [
        (tag, [sql[q] for q in qs]) for tag, qs in FUSE_CACHE_ENTRIES])
    return wh, stream


def fuse_cache_round_trip(root, wh, stream, procs, device=None):
    """`python -m nds_tpu_torch.cli.cache warm` in processes of their own
    over fuse_cache_warehouse's warehouse `wh` and `stream`: into an empty
    directory under `root` (cold, every entry built and stored), `stats`
    (it reads the directory only), then `warm` again (a fresh process:
    every entry loaded, none built). The script runs it beside the stream
    phase and the bench phase's --resume, over dimension dictionaries far
    smaller than a deployment's, so the cold ms of the two processes say
    nothing of what the cache saves; the gate is the builds and loads.
    Each process joins `procs` (a Procs, which stops what still runs).
    Returns the line. `device` names the children's device (default: the
    card)."""
    d = os.path.join(root, "aot")

    def cli(*args):
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "nds_tpu_torch.cli.cache", *args,
             "--cache_dir", d, "--json"], cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        procs.append(proc)
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            fail(f"fuse: cache {args[0]} exited {proc.returncode}: "
                 f"{err[-2000:]}")
        return json.loads(out), time.perf_counter() - t0

    warm = ("warm", wh, stream, *(("--device", device) if device else ()))
    empty, empty_s = cli(*warm)
    stats = cli("stats")[0]
    loaded, loaded_s = cli(*warm)
    rec = {"phase": "fuse_cache", "scale": f"x{FUSE_CACHE_SCALE} of SF100",
           "statements": [t for t, _ in FUSE_CACHE_ENTRIES],
           "beside": "the stream phase and the bench phase's --resume",
           "empty": {"query_ms": empty["query_ms"],
                     "exec_cache": empty["exec_cache"], "aot": empty["aot"],
                     "process_s": empty_s},
           "stats": stats,
           "warm": {"query_ms": loaded["query_ms"],
                    "exec_cache": loaded["exec_cache"],
                    "aot": loaded["aot"], "process_s": loaded_s},
           "cold_ms_empty": sum(empty["query_ms"].values()),
           "cold_ms_warm": sum(loaded["query_ms"].values())}
    if empty.get("failed") or loaded.get("failed"):
        fail(f"fuse: cache warm failed {empty.get('failed')} "
             f"{loaded.get('failed')}")
    if not (empty["exec_cache"]["builds"] > 0
            and stats["entries"] == empty["aot"]["stores"] > 0):
        fail(f"fuse: the cold warm built or stored nothing: {rec['empty']}")
    if (loaded["exec_cache"]["builds"] != 0
            or loaded["exec_cache"]["loads"]
            != empty["exec_cache"]["builds"]
            or loaded["aot"]["disk_hits"] == 0):
        fail(f"fuse: the fresh process did not load every entry: "
             f"{rec['warm']}")
    return rec


class Beside(threading.Thread):
    """`fn(*args)` on a thread of its own, beside the script's next step;
    join() returns its result or raises what it raised (a failed gate's
    SystemExit included)."""

    def __init__(self, fn, *args):
        super().__init__(daemon=True)
        self._call = (fn, args)
        self._out = self._exc = None
        self.start()

    def run(self):
        fn, args = self._call
        try:
            self._out = fn(*args)
        except BaseException as exc:  # re-raised by join
            self._exc = exc

    def join(self, timeout=None):
        super().join(timeout)
        if self._exc is not None:
            raise self._exc
        return self._out


def fuse_phase(torch, TX, B, Session, star, tables, dev, on, rows, checks,
               q5_rec):
    """Fused pipelines, top-k and the caches at SF100 (ROADMAP item 11),
    with engine.pallas_agg=off so that aggregates fuse: order (the fused
    filter over store_sales), minmax (the fused min/max tail over it), q3
    (the fused dimension filters; its aggregate tail pins, as in the JAX
    package) and, as the joins phase runs it, q93 (the top-k), each fused
    against unfused (fuse_compare); q3 through the caches (a rerun
    replays its join order; with the plan cache on it answers from it);
    the windows phase's q5 line (fuse_q5, `q5_rec`). One `fuse_query`
    line per query, a `fuse_caches` and a `fuse` summary line. The cache
    round trip (fuse_cache_round_trip) runs later, beside the bench
    phase."""
    from nds_tpu_torch.engine import fuse as TF
    from nds_tpu_torch.engine import plan as P

    t_phase = time.perf_counter()
    checks = dict(checks)
    numpy_order = order_reference_check(star)
    checks["order"] = (lambda r, c=checks["order"]: {
        "max_rel_vs_slice": worst_rel(c(r)), **numpy_order(r)})
    conf = {**on, "engine.pallas_agg": "off", **STEADY}
    s_f = Session(conf=conf)
    s_u = Session(conf={**conf, "engine.fuse": "off"}, device="cuda")
    j_f = Session(conf={**on, **STEADY})
    j_u = Session(conf={**on, **STEADY, "engine.fuse": "off"},
                  device="cuda")
    cached = Session(conf={**on, "engine.pallas_agg": "off"})
    for s in (s_f, s_u, j_f, j_u, cached):
        for name, t in tables.items():
            s.register_table(name, t)
    def q3_same(a, b):
        # with engine.pallas_agg=off both sides add the same f64 values in
        # torch's routines, in orders that may differ: an f64 bound
        ref = q3_groups(b)
        return same_groups(q3_groups(a), ref, f64_sum_rtol(
            max((n for _, n in ref.values()), default=0)), "fuse vs unfused")

    same = {
        # integers and extremes: exact
        "order": lambda a, b: same_result(a, b, 0.0, "fuse order"),
        "minmax": lambda a, b: same_result(a, b, 0.0, "fuse minmax"),
        # float sums: f64 against f64 (q3); the joins phase's on / off
        # bound (q93)
        "q3": q3_same,
        "q93": lambda a, b: same_topk(q93_rows(a), q93_rows(b),
                                      checks["q93"].rtol_of,
                                      "fuse q93 vs unfused"),
    }
    out = {}
    for q in FUSE_QUERIES:
        out[q] = fuse_compare(torch, TF, TX, P, B, dev, q, QUERIES[q], s_f,
                              s_u, rows, checks, same[q])
        emit(out[q])
    out["q93"] = fuse_compare(torch, TF, TX, P, B, dev, "q93",
                              JOIN_QUERIES["q93"], j_f, j_u, rows, checks,
                              same["q93"])
    emit(out["q93"])
    out["q5"] = q5_rec
    del s_f, s_u, j_f, j_u

    # q3 through the caches (the plan cache on, its default)
    refused = refusal(B, cached, QUERIES["q3"])
    runs = []
    for label in ("first", "plan_cache", "join_order"):
        if label == "join_order":
            cached.conf["engine.plan_cache"] = "off"
        events, restore = fuse_spy(TF, TX, P)
        try:
            res, ms = fuse_run(torch, dev, cached, QUERIES["q3"], refused)
        finally:
            restore()
        runs.append({"run": label, "ms": ms,
                     "paths": sorted({e["kind"] for e in events}),
                     "join_order_replayed": [e["replay"] for e in events
                                             if e["kind"] == "join_order"],
                     "max_rel_vs_checks": worst_rel(checks["q3"](res))})
    first, hit, replay = runs
    if (hit["paths"] or hit["join_order_replayed"]
            or not replay["join_order_replayed"]
            or not all(replay["join_order_replayed"])
            or any(first["join_order_replayed"])):
        fail(f"fuse: q3 through the caches: {runs}")
    emit({"phase": "fuse_caches", "query": "q3", "runs": runs,
          "plan_cache_entries": len(cached.plan_cache.map),
          "plan_cache_gib": cached.plan_cache.nbytes / 2**30,
          "join_orders": len(cached.join_order_cache)})
    del cached
    emit({"phase": "fuse", "queries": sorted(out),
          "steady_ms": {q: [r["fused_steady_ms"], r["unfused_steady_ms"]]
                        for q, r in out.items()},
          "peak_gib": {q: [r["fused_peak_gib"], r["unfused_peak_gib"]]
                       for q, r in out.items()},
          "busy_share_q5": [q5_rec["fused_busy_share"],
                            q5_rec["unfused_busy_share"]],
          "pins": {q: r["pins"] for q, r in out.items()},
          "steady_runs": STEADY_RUNS, "reduced": STEADY_CUT,
          "seconds": time.perf_counter() - t_phase})
    return out


REFUSED_MODE = "warn"


def refusal(B, session, sql):
    """Plan `sql` at the session's lines: None when the budgeter admits
    it, else the refusal (its modeled peak against the reject line)."""
    try:
        session.sql(sql)
    except B.PlanBudgetError as exc:
        rec = session.last_plan_budget
        if rec is None or rec.get("verdict") != "reject":
            fail(f"PlanBudgetError without a reject verdict: {rec}")
        return {"modeled_peak_gib": rec["peak_bytes"] / 2**30,
                "reject_gib": B.resolve_reject_bytes(
                    session.conf, session.device) / 2**30,
                "error": str(exc)}
    return None


@contextlib.contextmanager
def admitted(session, refused):
    """Run a statement under REFUSED_MODE where the budgeter `refused` it
    at the session's own mode; else as the session is."""
    if not refused:
        yield
        return
    old = session.conf.get("engine.plan_budget")
    session.conf["engine.plan_budget"] = REFUSED_MODE
    try:
        yield
    finally:
        if old is None:
            session.conf.pop("engine.plan_budget")
        else:
            session.conf["engine.plan_budget"] = old


def budget_record(B, session, working_set, dev, refused=None):
    """The plan budgeter's verdict on the statement `session` planned last,
    beside the working set the card measured for it (the peak of its steady
    runs less what was allocated before them) and their ratio, held
    against the reference's CALIBRATION_SLACK (printed, not gated), and
    the caching allocator's gap at those runs' peaks (peak reserved less
    peak allocated: the allocator headroom budget.budget_lines keeps).
    `refused`: the default mode's refusal of the statement, which then ran
    under REFUSED_MODE."""
    import torch

    rec = session.last_plan_budget
    if rec is None or rec.get("verdict") == "error":
        fail(f"the plan budgeter gave no verdict: {rec}")
    ratio = working_set / rec["peak_bytes"] if rec["peak_bytes"] else None
    gap = (torch.cuda.max_memory_reserved(dev)
           - torch.cuda.max_memory_allocated(dev))
    return {"verdict": rec["verdict"],
            "modeled_peak_gib": rec["peak_bytes"] / 2**30,
            "window_rows": rec["window_rows"],
            "spill_partitions": rec["spill_partitions"],
            "annotated": rec["annotated"],
            "refused": refused is not None,
            "ran_under": (f"engine.plan_budget={REFUSED_MODE}" if refused
                          else "default"),
            "working_set_gib": working_set / 2**30, "ratio": ratio,
            "above_slack": ratio is not None
            and ratio > B.CALIBRATION_SLACK,
            "allocator_gap_gib": gap / 2**30}


#: the spill phase: (case, query, conf beyond the kernels' `on`). `force`
#: spills every eligible node; `auto` spills the nodes the budgeter
#: annotates, here on a query whose verdict at the card's default lines is
#: `direct`, under a working-set line set below its modeled peak
#: (1 / SPILL_AUTO_SHARE of it), so that the verdict turns to `spill` and
#: the annotation switches the path; `disk` caps the pool at
#: SPILL_DISK_POOL_BYTES so that segments tier to a temporary directory.
SPILL_CASES = (
    ("q3_force_8", "q3", {"engine.spill": "force",
                          "engine.spill_partitions": 8}),
    ("q3_force_3", "q3", {"engine.spill": "force",
                          "engine.spill_partitions": 3}),
    ("order_force_8", "order", {"engine.spill": "force",
                                "engine.spill_partitions": 8}),
    ("order_disk_8", "order", {"engine.spill": "force",
                               "engine.spill_partitions": 8}),
    ("q87_force_8", "q87", {"engine.spill": "force",
                            "engine.spill_partitions": 8}),
    ("order_auto", "order", {}),
)
#: the spilled path each case must take (branch_spy events)
SPILL_BRANCHES = {
    "q3_force_8": ["spilled join, 8 partitions"],
    "q3_force_3": ["spilled join, 3 partitions"],
    "order_force_8": ["spilled sort, 8 partitions"],
    "order_disk_8": ["spilled sort, 8 partitions"],
    "q87_force_8": ["spilled distinct, 8 partitions",
                    "spilled distinct, 8 partitions"],
}
SPILL_AUTO_SHARE = 3
SPILL_DISK_POOL_BYTES = 1 << 20
SPILL_KERNELS = ("segment_sums", "dense_build", "sort_perm")
SPILL_STEADY_RUNS = 3


def spill_phase(torch, GK, TX, B, Session, tables, dev, on):
    """The out-of-core paths at SF100 row counts: SPILL_CASES through
    sessions with the kernels on, each against the same query in a session
    with `engine.spill=off` (the direct run). Each case must take its
    SPILL_BRANCHES (q3's join is the hash-candidate join, the one the
    spilled join replaces) and equal the direct run: q3's groups with
    counts exact and sums within the f32 bound, q87's count exactly, the
    ORDER BY bit for bit; the auto case (a query the default lines run
    direct) must get the `spill` verdict and spill at the annotated
    partition count (last_spill ops >= 1). The phase must launch
    SPILL_KERNELS. Launch counts are zeroed just before the cold runs and
    read just after. One line per case and a `spill` summary line."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    sql = {**QUERIES, **JOIN_QUERIES}
    spill_dir = tempfile.mkdtemp(prefix="nds-spill-")
    direct = Session(conf={**on, "engine.spill": "off"})
    for name, t in tables.items():
        direct.register_table(name, t)

    def run(session, q):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = session.sql(sql[q]).collect()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    def steady(session, q):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ms = [run(session, q)[1] for _ in range(SPILL_STEADY_RUNS)]
        peak = torch.cuda.max_memory_allocated(dev)
        return ms, peak - before, peak

    try:
        ref = {}
        for q in ("q3", "order", "q87"):
            res, _ = run(direct, q)
            if direct.last_spill is not None:
                fail(f"the direct run of {q} spilled: {direct.last_spill}")
            ref[q] = (res, *steady(direct, q),
                      direct.last_plan_budget["peak_bytes"],
                      direct.last_plan_budget["verdict"])
        sessions = {}
        for case, q, conf in SPILL_CASES:
            conf = {**on, "engine.spill_dir": spill_dir, **conf}
            if case.endswith("_auto"):
                if ref[q][5] != "direct":
                    fail(f"spill {case}: {q}'s default verdict is {ref[q][5]}"
                         f", not direct")
                conf["engine.plan_budget_bytes"] = (
                    ref[q][4] // SPILL_AUTO_SHARE)
            if case.startswith("order_disk"):
                conf["engine.spill_pool_bytes"] = SPILL_DISK_POOL_BYTES
            s = sessions[case] = Session(conf=conf)
            for name, t in tables.items():
                s.register_table(name, t)

        GK.reset_launches()
        prev = dict(GK.LAUNCHES)
        cold, events, per_case, spilled = {}, {}, {}, {}
        for case, q, _ in SPILL_CASES:
            s = sessions[case]
            s.last_spill = None
            ev = events[case] = []
            restore = branch_spy(TX.Executor, ev)
            try:
                cold[case] = run(s, q)
            finally:
                restore()
            spilled[case] = s.last_spill
            per_case[case] = {k: GK.LAUNCHES[k] - prev[k]
                              for k in GK.LAUNCHES}
            prev = dict(GK.LAUNCHES)
        launches = dict(GK.LAUNCHES)
        for name in SPILL_KERNELS:
            if launches[name] == 0:
                fail(f"kernel {name} was not launched on the spill path")

        for case, q, _ in SPILL_CASES:
            s = sessions[case]
            missing = missing_branches(events[case],
                                       SPILL_BRANCHES.get(case, []))
            if missing:
                fail(f"spill {case} did not take {missing}: it took "
                     f"{events[case]}")
            note = spilled[case]
            if not note or note["ops"] < 1:
                fail(f"spill {case}: no operator spilled ({note})")
            res, cold_ms = cold[case]
            want, direct_ms, direct_ws, direct_peak, _, _ = ref[q]
            if q == "q3":
                got, exp = q3_groups(res), q3_groups(want)
                rtol = f32_sum_rtol(max(n for _, n in exp.values()))
                worst = same_groups(got, exp, rtol, f"spill {case}")
            elif q == "order":
                rtol = 0.0
                worst = same_result(res, want, rtol, f"spill {case}")
                if not res.equals(want):
                    fail(f"spill {case}: the sorted output is not the "
                         f"direct run's, bit for bit")
            else:
                rtol = 0.0
                worst = same_result(res, want, rtol, f"spill {case}")
            ms, ws, peak = steady(s, q)
            pool = dict(s.spill_pool.stats)
            rec = {"phase": "spill_case", "case": case, "query": q,
                   "rows": res.num_rows, "cold_ms": cold_ms,
                   "steady_ms": float(np.median(ms)), "steady_runs_ms": ms,
                   "direct_steady_ms": float(np.median(direct_ms)),
                   "peak_gib": peak / 2**30,
                   "direct_peak_gib": direct_peak / 2**30,
                   "working_set_gib": ws / 2**30,
                   "direct_working_set_gib": direct_ws / 2**30,
                   "spill": note, "pool_cold_and_steady": pool,
                   "launches": per_case[case],
                   "branches": [e for e in events[case]
                                if e.startswith("spilled ")],
                   "max_rel_vs_direct": worst, "rtol": rtol,
                   "budget": budget_record(B, s, ws, dev)}
            if case.startswith("order_disk") and (
                    note["evictions"] < 1 or pool["disk_bytes_read"] < 1):
                fail(f"spill {case}: no segment went through the disk "
                     f"tier ({note}, {pool})")
            if case.endswith("_auto"):
                parts = rec["budget"]["spill_partitions"]
                if rec["budget"]["verdict"] != "spill" or not parts:
                    fail(f"spill {case}: verdict {rec['budget']} under a "
                         f"line below the modeled peak")
                if note["partitions"] != parts:
                    fail(f"spill {case}: spilled at {note['partitions']} "
                         f"partitions, annotated {parts}")
                rec["plan_budget_bytes"] = s.conf["engine.plan_budget_bytes"]
                rec["direct_verdict"] = ref[q][5]
            emit(rec)
        for s in sessions.values():
            s.spill_pool.close()
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)
    emit({"phase": "spill", "launches": launches,
          "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
          "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# the power phase: the Power Run's harness over a parquet warehouse
# ---------------------------------------------------------------------------

#: rows per parquet row group, and the files a fact table is cut into (each
#: written by its own thread): the cheapest write that keeps the data
#: (no compression, no dictionary pages)
WAREHOUSE_ROW_GROUP = 1 << 23
WAREHOUSE_FILES = 8


def write_warehouse(star, root, workers=WAREHOUSE_FILES):
    """Write the star as a parquet warehouse under `root`: every TPC-DS
    source table of nds_tpu_torch.schema (floats mode: decimals as
    float64), with its full schema. The columns the star does not build
    are all-null; the tables it does not build are empty. Fact tables are
    cut into `workers` files of consecutive rows, named so that their
    order is the rows' order. Returns the bytes written and the seconds."""
    from concurrent.futures import ThreadPoolExecutor

    import pyarrow as pa
    import pyarrow.parquet as pq

    from nds_tpu_torch.schema import get_schemas

    t0 = time.perf_counter()
    nulls = {}  # (arrow type, rows) -> one all-null array, shared

    def null_array(typ, n):
        if (typ, n) not in nulls:
            nulls[(typ, n)] = pa.nulls(n, typ)
        return nulls[(typ, n)]

    host_dtype = {pa.int32(): np.int32, pa.date32(): np.int32,
                  pa.int64(): np.int64, pa.float64(): np.float64}

    def column(cols, name, typ, lo, hi):
        data = cols[name][lo:hi]
        valid = cols.get(name + "__valid")
        bitmap = None
        if valid is not None:
            bitmap = pa.py_buffer(np.packbits(valid[lo:hi],
                                              bitorder="little"))
        if dictionary(name) is not None:
            words = pa.array(dictionary(name), type=pa.string())
            codes = pa.Array.from_buffers(
                pa.int32(), hi - lo,
                [bitmap, pa.py_buffer(np.ascontiguousarray(data,
                                                           np.int32))])
            return pa.DictionaryArray.from_arrays(codes, words).cast(typ)
        return pa.Array.from_buffers(typ, hi - lo, [
            bitmap, pa.py_buffer(np.ascontiguousarray(data, host_dtype[typ]))])

    jobs = []
    for tname, schema in get_schemas(False).items():
        fields = [pa.field(f.name, f.dtype.to_arrow(False)) for f in schema]
        arrow_schema = pa.schema(fields)
        cols = star.get(tname, {})
        unknown = {c for c in cols if not c.endswith("__valid")} - set(
            schema.names)
        if unknown:
            fail(f"{tname}: the star's columns {sorted(unknown)} are not in "
                 f"its TPC-DS schema")
        n = next(iter(cols.values())).shape[0] if cols else 0
        parts = workers if n >= WAREHOUSE_ROW_GROUP else 1
        step = -(-n // parts) if n else 0
        os.makedirs(os.path.join(root, tname))
        for k in range(parts):
            lo, hi = k * step, min(n, (k + 1) * step)
            jobs.append((tname, arrow_schema, cols, lo, hi,
                         os.path.join(root, tname, f"part-{k:05d}.parquet")))

    def write(job):
        tname, arrow_schema, cols, lo, hi, path = job
        arrays = [column(cols, f.name, f.type, lo, hi) if f.name in cols
                  else null_array(f.type, hi - lo) for f in arrow_schema]
        pq.write_table(pa.Table.from_arrays(arrays, schema=arrow_schema),
                       path, compression="none", use_dictionary=False,
                       row_group_size=WAREHOUSE_ROW_GROUP)
        return os.path.getsize(path)

    with ThreadPoolExecutor(workers) as ex:
        written = sum(ex.map(write, jobs))
    return {"bytes": written, "files": len(jobs),
            "seconds": time.perf_counter() - t0,
            "tables": sorted(star)}


#: the power phase's stream: (template tag, the earlier phases' queries it
#: runs), in the generator's format; the tag with two queries is a
#: two-part entry (query14_part1, query14_part2)
POWER_STREAM = (
    ("query3", ("q3",)), ("query14", ("minmax", "order")),
    ("query93", ("q93",)), ("query78", ("q78",)), ("query16", ("q16",)),
    ("query97", ("q97",)), ("query28", ("q28",)), ("query87", ("q87",)),
    ("query98", ("q98",)), ("query36", ("q36",)), ("query67", ("q67",)),
    ("query51", ("q51",)), ("query5", ("q5",)),
)
#: the `direct` query that meets a real CUDA OOM under a ballast, then the
#: query that must still complete after it
POWER_OOM_QUERIES = ("q97", "q3")
#: the card's free memory under the ballast sits this far below the OOM
#: query's measured need, and at least this far above the next query's
POWER_OOM_MARGIN = 3 << 29
#: injected drills: name -> (fault spec, conf beyond the kernels' `on`,
#: the two queries' SQL); the summaries the reference's tests expect for
#: each are checked in check_drill
DRILL_SQL = {
    "fact": "select count(*) cnt from store_sales where ss_quantity > 0",
    "dim": "select d_year, count(*) c from date_dim group by d_year "
           "order by d_year limit 5",
    "spill": "select distinct i_brand_id from item order by i_brand_id",
    "count": "select count(*) c from date_dim",
}
POWER_DRILLS = {
    "oom": ("oom:query96:1", {}, ("fact", "dim")),
    "io": ("io:store_sales:1", {}, ("fact", "dim")),
    "spill_io": ("io:spill:write:1",
                 {"engine.spill": "force", "engine.spill_partitions": 4,
                  "engine.spill_pool_bytes": 1}, ("spill", "count")),
    "hang": ("hang:query96:5", {"engine.query_timeout": 2},
             ("count", "dim")),
}


def phase_sql(q):
    return {**QUERIES, **JOIN_QUERIES, **WINDOW_QUERIES}[q]


def stream_file(path, entries):
    """Write a stream file in the generator's format: `entries` are
    (template tag, [SQL statements])."""
    parts = []
    for n, (tag, stmts) in enumerate(entries, 1):
        body = "".join(f"{sql.strip()}\n;\n" for sql in stmts)
        parts.append(f"-- start query {n} in stream 0 using template "
                     f"{tag}.tpl\n{body}-- end query {n} in stream 0 using "
                     f"template {tag}.tpl\n")
    with open(path, "w") as f:
        f.write("\n".join(parts))
    return path


def property_file(path, conf):
    with open(path, "w") as f:
        f.writelines(f"{k}={v}\n" for k, v in conf.items())
    return path


def stream_names(entries):
    """Query names of a stream as gen_sql_from_stream makes them, mapped to
    the phase queries they run."""
    out = {}
    for tag, qs in entries:
        if len(qs) == 1:
            out[tag] = qs[0]
        else:
            out.update({f"{tag}_part{i}": q for i, q in enumerate(qs, 1)})
    return out


def read_summaries(folder):
    out = {}
    for f in os.listdir(folder):
        with open(os.path.join(folder, f)) as fh:
            s = json.load(fh)
        out[s["query"]] = s
    return out


def read_time_log(path):
    import csv

    with open(path) as f:
        rows = list(csv.reader(f))
    if rows[0] != ["application_id", "query", "time/milliseconds"]:
        fail(f"time log header {rows[0]}")
    return [(r[1], int(r[2])) for r in rows[1:]]


def brief(summary):
    """A query summary without its environment (for a failure message)."""
    return {k: v for k, v in summary.items() if k != "env"}


def worst_rel(out):
    """A check's worst relative error (a check returns it, or a record of
    `max_rel_*` fields)."""
    if isinstance(out, dict):
        return max((v for k, v in out.items() if k.startswith("max_rel")),
                   default=0.0)
    return out


def expected_device_ladder(rec, conf):
    """The reference's device-OOM rungs, in order, for a plan whose budget
    record is `rec` in a session of `conf` (nds_tpu/report.py
    _next_rung): budget_shrink where a pressure verdict carries a window
    not yet annotated, recover_retry, shrink_union_window, and spill_retry
    where the plan has an out-of-core seam and spill is neither off nor
    forced."""
    rungs = []
    if (rec.get("verdict") in ("blocked", "spill", "over", "reject")
            and rec.get("window_rows") and not rec.get("annotated")):
        rungs.append("budget_shrink")
    rungs += ["recover_retry", "shrink_union_window"]
    if (str(conf.get("engine.spill", "auto")).lower() not in ("off", "force")
            and rec.get("spillable")):
        rungs.append("spill_retry")
    return rungs


def instrument_stream(torch, GK, TP, dev, per_query):
    """Wrap power.run_one_query (the callable each BenchReport attempt
    runs) to record, per query name, its attempts, its kernel launches, its
    peak device memory, the budget record of its last statement and
    `load_ms`, the wall ms inside the catalog's Catalog.load (the parquet
    read, the upload and the column statistics). Returns the function that
    restores both."""
    from nds_tpu_torch.engine import session as TS

    orig = TP.run_one_query
    orig_load = TS.Catalog.load
    current = []  # the record of the query running now

    def load(self, name, columns=None, **lake):
        t0 = time.perf_counter()
        try:
            return orig_load(self, name, columns, **lake)
        finally:
            if current:
                current[0]["load_ms"] += (time.perf_counter() - t0) * 1e3

    def run_one_query(session, query, query_name, output_path,
                      output_format):
        rec = per_query.setdefault(query_name, {
            "attempts": 0, "launches": {k: 0 for k in GK.LAUNCHES},
            "peak_gib": 0.0, "load_ms": 0.0})
        rec["attempts"] += 1
        prev = dict(GK.LAUNCHES)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        current[:] = [rec]
        try:
            return orig(session, query, query_name, output_path,
                        output_format)
        finally:
            current.clear()
            torch.cuda.synchronize(dev)
            for k in GK.LAUNCHES:
                rec["launches"][k] += GK.LAUNCHES[k] - prev[k]
            rec["peak_gib"] = max(
                rec["peak_gib"], torch.cuda.max_memory_allocated(dev) / 2**30)
            rec["budget"] = dict(session.last_plan_budget or {})

    TP.run_one_query = run_one_query
    TS.Catalog.load = load

    def restore():
        TP.run_one_query = orig
        TS.Catalog.load = orig_load
    return restore


def power_phase(torch, GK, dev, root, wh, checks, earlier, on, reduced):
    """The Power Run's harness at SF100 row counts, from the parquet
    warehouse `wh`: POWER_STREAM through power.run_query_stream on the
    card with the kernels on (the property file), then a real CUDA OOM
    under a ballast, then the injected drills. Launch counts are zeroed
    just before the stream and read just after. Returns them."""
    from nds_tpu_torch import faults
    from nds_tpu_torch import power as TP
    from nds_tpu_torch.schema import get_schemas

    t_phase = time.perf_counter()
    per_query = {}
    restore = instrument_stream(torch, GK, TP, dev, per_query)
    names = stream_names(POWER_STREAM)
    try:
        run = os.path.join(root, "stream")
        os.makedirs(run)
        stream = stream_file(os.path.join(run, "query_0.sql"), [
            (tag, [phase_sql(q) for q in qs]) for tag, qs in POWER_STREAM])
        prop = property_file(os.path.join(run, "power.properties"), on)
        torch.cuda.synchronize(dev)
        allocated_before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        GK.reset_launches()
        t0 = time.perf_counter()
        session = TP.run_query_stream(
            input_prefix=wh, property_file=prop,
            query_dict=TP.gen_sql_from_stream(stream),
            time_log_output_path=os.path.join(run, "time.csv"),
            use_decimal=False, output_path=os.path.join(run, "results"),
            json_summary_folder=os.path.join(run, "json"),
            keep_session=True, device=dev)
        torch.cuda.synchronize(dev)
        stream_s = time.perf_counter() - t0
        launches = dict(GK.LAUNCHES)
        peak = max(r["peak_gib"] for r in per_query.values())
        for name, n in launches.items():
            if n == 0:
                fail(f"kernel {name} was not launched on the power path")
        summaries = read_summaries(os.path.join(run, "json"))
        log = read_time_log(os.path.join(run, "time.csv"))
        want_rows = ([f"CreateTempView {t}" for t in get_schemas(False)]
                     + list(names) + ["Power Start Time", "Power End Time",
                                      "Power Test Time", "Total Time"])
        if [r for r, _ in log] != want_rows:
            fail(f"power time log rows {[r for r, _ in log]}")
        timings = dict(log)
        for name, q in names.items():
            s, pq_ = summaries[name], per_query[name]
            rec = {"phase": "power_query", "query": name, "runs": q,
                   "cold_ms": s["queryTimes"][0],
                   "status": s["queryStatus"][0],
                   "verdict": pq_["budget"].get("verdict"),
                   "retries": s["retries"], "launches": pq_["launches"],
                   "load_ms": pq_["load_ms"], "peak_gib": pq_["peak_gib"]}
            if earlier[q]["refusal"]:
                # refused at the card's lines: a deterministic planner
                # failure, as in the reference
                if (s["queryStatus"] != ["Failed"]
                        or s.get("failureKind") != faults.PLANNER
                        or s["retries"] != 0
                        or "PlanBudgetError" not in s["exceptions"][0]):
                    fail(f"power: refused {name} ({q}) gave {brief(s)}")
                rec["failure_kind"] = s["failureKind"]
            else:
                if s["queryStatus"] != ["Completed"]:
                    fail(f"power: {name} ({q}) gave {s['queryStatus']}: "
                         f"{s['exceptions']}")
                import pyarrow.parquet as pq

                res = pq.read_table(os.path.join(run, "results", name,
                                                 "part-0.parquet"))
                rec["rows"] = res.num_rows
                rec["max_rel_vs_earlier_checks"] = worst_rel(checks[q](res))
            emit(rec)
        refused = sorted(q for q in names.values() if earlier[q]["refusal"])
        emit({"phase": "power", "reduced": reduced,
              "power_test_ms": timings["Power Test Time"],
              "total_ms": timings["Total Time"],
              "setup_ms": {t[len("CreateTempView "):]: ms
                           for t, ms in log if t.startswith("CreateTempView")},
              "stream_s": stream_s, "peak_gib": peak,
              "allocated_before_gib": allocated_before / 2**30,
              "catalog_evictions": session.catalog.evictions,
              "catalog_budget_gib": session.catalog.DEVICE_BUDGET_BYTES / 2**30,
              "refused_as_planner": refused, "launches": launches})
        del session
        gc.collect()
        torch.cuda.empty_cache()

        oom_drill(torch, TP, faults, dev, root, wh, on, checks, per_query)
        for name, (spec, conf, sqls) in POWER_DRILLS.items():
            run_drill(TP, faults, dev, root, wh, on, name, spec, conf, sqls)
    finally:
        restore()
        faults.reset()
    emit({"phase": "power_done", "seconds": time.perf_counter() - t_phase})
    return launches


#: the stream entries of POWER_OOM_QUERIES
POWER_OOM_TAGS = ("query97", "query3")


def oom_stream(torch, TP, dev, root, wh, on, tag, per_query, queries):
    """Run `queries` (of POWER_OOM_QUERIES) as a stream in a fresh session
    kept afterwards; returns (session, summaries, seconds), `per_query`
    holding each query's attempts."""
    run = os.path.join(root, tag)
    os.makedirs(run)
    per_query.clear()
    entries = [(POWER_OOM_TAGS[POWER_OOM_QUERIES.index(q)], [phase_sql(q)])
               for q in queries]
    t0 = time.perf_counter()
    session = TP.run_query_stream(
        input_prefix=wh,
        property_file=property_file(os.path.join(run, "p.properties"), on),
        query_dict=TP.gen_sql_from_stream(
            stream_file(os.path.join(run, "query_0.sql"), entries)),
        time_log_output_path=os.path.join(run, "time.csv"),
        use_decimal=False, output_path=os.path.join(run, "results"),
        json_summary_folder=os.path.join(run, "json"), keep_session=True,
        device=dev)
    torch.cuda.synchronize(dev)
    return (session, read_summaries(os.path.join(run, "json")),
            time.perf_counter() - t0)


def oom_drill(torch, TP, faults, dev, root, wh, on, checks, per_query):
    """A real CUDA OOM. q97 and then q3, each alone as a stream in a fresh
    session, measure what each needs on the card: its peak allocation
    above what was allocated before, the catalog's loads included. Then a
    ballast leaves the card's free memory POWER_OOM_MARGIN below q97's
    need and at least that far above q3's, and the two-entry stream (q97,
    q3) runs in a fresh session. The first attempt must die of a torch
    OutOfMemoryError, the ladder walk only device_oom rungs in the
    reference's order for the budget record, q97 end
    CompletedWithTaskFailures (its result held to its checks) or Failed
    with device_oom, and q3 complete with its earlier result; afterwards
    allocated memory is the ballast plus the catalog, within 1 GiB."""
    import pyarrow.parquet as pq

    q_oom, q_next = POWER_OOM_QUERIES
    gib = 2**30
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    need, calib_s = {}, 0.0
    for q, tag in zip(POWER_OOM_QUERIES, POWER_OOM_TAGS):
        session, _, secs = oom_stream(torch, TP, dev, root, wh, on,
                                      f"oom_measure_{q}", per_query, [q])
        need[q] = int(per_query[tag]["peak_gib"] * gib) - base
        calib_s += secs
        del session
        gc.collect()
        torch.cuda.empty_cache()
    target = need[q_oom] - POWER_OOM_MARGIN
    if target < need[q_next] + POWER_OOM_MARGIN:
        fail(f"oom drill: no room between {q_next} ({need[q_next]} B) and "
             f"{q_oom} ({need[q_oom]} B)")
    gc.collect()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(dev)
    avail = (free + torch.cuda.memory_reserved(dev)
             - torch.cuda.memory_allocated(dev))
    ballast = torch.empty(avail - target, dtype=torch.uint8, device=dev)
    # the flight recorder on, its bundles in a directory of the drill's
    flight_dir = os.path.join(root, "oom_flight")
    session, s, seconds = oom_stream(
        torch, TP, dev, root, wh, {**on, "engine.flight_recorder": "on",
                                   "engine.flight_dir": flight_dir},
        "oom", per_query, POWER_OOM_QUERIES)
    first, second = s["query97"], s["query3"]
    if not first["exceptions"] or not first["exceptions"][0].startswith(
            "OutOfMemoryError: CUDA out of memory"):
        fail(f"oom drill: the first attempt was no CUDA OOM: {brief(first)}")
    kinds = [r["kind"] for r in first.get("ladder", [])]
    rungs = [r["rung"] for r in first.get("ladder", [])]
    budget = per_query["query97"]["budget"]
    want = expected_device_ladder(budget, on)
    host = [x for x in kinds + [r["kind"] for r in second.get("ladder", [])]
            + [first.get("failureKind"), second.get("failureKind")]
            if x == faults.HOST_OOM]
    if host or set(kinds) != {faults.DEVICE_OOM} or rungs != want[:len(rungs)]:
        fail(f"oom drill: ladder {first.get('ladder')}, want device_oom "
             f"rungs {want}")
    rec = {"phase": "power_oom", "query": q_oom, "status":
           first["queryStatus"][0], "rungs": rungs, "want_rungs": want,
           "exceptions": [e[:160] for e in first["exceptions"]],
           "verdict": budget.get("verdict"),
           "spillable": budget.get("spillable"),
           "attempts": per_query["query97"]["attempts"],
           "ballast_gib": ballast.numel() / gib, "target_free_gib": target / gib,
           "need_gib": {q: v / gib for q, v in need.items()},
           "measure_s": calib_s, "seconds": seconds}
    results = os.path.join(root, "oom", "results")
    if first["queryStatus"] == ["CompletedWithTaskFailures"]:
        rec["max_rel_vs_earlier_checks"] = worst_rel(checks[q_oom](
            pq.read_table(os.path.join(results, "query97",
                                       "part-0.parquet"))))
    elif not (first["queryStatus"] == ["Failed"]
              and first["failureKind"] == faults.DEVICE_OOM
              and rungs == want):
        fail(f"oom drill: {q_oom} ended {brief(first)}")
    if second["queryStatus"][0] not in ("Completed",
                                        "CompletedWithTaskFailures"):
        fail(f"oom drill: {q_next} after the OOM gave {brief(second)}")
    if first["queryStatus"] != ["Failed"]:
        # recovered: the harness flushes a bundle on a terminal failure
        # only, so the black box is taken on demand, as /debug/flight's
        # ?write=1 takes it from a live process
        from nds_tpu_torch.obs import flight as FL

        FL.recorder(session.conf).flush(
            "on_demand", query=POWER_OOM_TAGS[0], ladder=first.get("ladder"),
            conf=session.conf, out_dir=flight_dir)
    rec["flight"] = flight_bundle_check(flight_dir, POWER_OOM_TAGS[0],
                                        faults.DEVICE_OOM)
    rec["next_query"] = q_next
    rec["next_status"] = second["queryStatus"][0]
    rec["next_rungs"] = [r["rung"] for r in second.get("ladder", [])]
    rec["next_max_rel_vs_earlier_checks"] = worst_rel(checks[q_next](
        pq.read_table(os.path.join(results, "query3", "part-0.parquet"))))
    gc.collect()
    allocated = torch.cuda.memory_allocated(dev)
    resident = session.catalog.resident_bytes()
    rec["allocated_after_gib"] = allocated / gib
    rec["ballast_plus_catalog_gib"] = (ballast.numel() + resident) / gib
    if abs(allocated - ballast.numel() - resident) > gib:
        fail(f"oom drill: {allocated} B allocated after the stream, "
             f"ballast {ballast.numel()} + catalog {resident}")
    emit(rec)
    del session, ballast
    gc.collect()
    torch.cuda.empty_cache()


def run_drill(TP, faults, dev, root, wh, on, name, spec, conf, sqls):
    """One injected drill: a two-entry stream (query96, query3) under a
    property file holding the fault spec, checked against what the
    reference's tests expect (tests/test_faults.py, tests/test_spill.py)."""
    run = os.path.join(root, f"drill_{name}")
    os.makedirs(run)
    conf = {**on, "engine.fault_spec": spec, **conf}
    if "engine.spill" in conf:
        conf["engine.spill_dir"] = os.path.join(run, "spill")
    faults.reset()
    t0 = time.perf_counter()
    TP.run_query_stream(
        input_prefix=wh,
        property_file=property_file(os.path.join(run, "p.properties"), conf),
        query_dict=TP.gen_sql_from_stream(stream_file(
            os.path.join(run, "query_0.sql"),
            [("query96", [DRILL_SQL[sqls[0]]]),
             ("query3", [DRILL_SQL[sqls[1]]])])),
        time_log_output_path=os.path.join(run, "time.csv"),
        use_decimal=False, json_summary_folder=os.path.join(run, "json"),
        device=dev)
    seconds = time.perf_counter() - t0
    # an abandoned (hung) attempt's worker: wait for it to end
    for t in threading.enumerate():
        if t.name == "nds-query-watchdog-worker":
            t.join(timeout=60)
            if t.is_alive():
                fail(f"drill {name}: an abandoned worker did not end")
    faults.reset()
    s = read_summaries(os.path.join(run, "json"))
    first, second = s["query96"], s["query3"]
    rungs = [r["rung"] for r in first.get("ladder", [])]
    ok = second["queryStatus"] == ["Completed"] and second["retries"] == 0
    if name == "oom":
        ok &= (first["queryStatus"] == ["CompletedWithTaskFailures"]
               and first["retries"] == 1 and rungs == ["recover_retry"]
               and any("RESOURCE_EXHAUSTED" in e for e in first["exceptions"])
               and "failureKind" not in first)
    elif name in ("io", "spill_io"):
        ok &= (first["queryStatus"] == ["CompletedWithTaskFailures"]
               and rungs and set(rungs) == {"io_backoff_retry"}
               and {r["kind"] for r in first["ladder"]}
               == {faults.IO_TRANSIENT})
    else:  # hang
        ok &= (first["queryStatus"] == ["Failed"]
               and first["failureKind"] == faults.TIMEOUT
               and first["retries"] == 0
               and first["queryTimes"][0] < 15000)
    emit({"phase": "power_drill", "drill": name, "spec": spec,
          "first": {k: first.get(k) for k in (
              "queryStatus", "retries", "ladder", "failureKind",
              "queryTimes")},
          "first_exceptions": [e[:160] for e in first["exceptions"]],
          "second": second["queryStatus"], "seconds": seconds})
    if not ok:
        fail(f"drill {name}: {brief(first)} / {brief(second)}")


# ---------------------------------------------------------------------------
# the stream phase: the whole NDS chain, gen_data -> transcode ->
# gen_query_stream -> power -> validate, over a generated stream 0
# ---------------------------------------------------------------------------

#: leg A's scale factor (decimals, the NDS default: kernels on against off)
#: and leg B's (--floats: the card against the CPU); --scale F < 1 cuts both.
#: Both are cut from the SF10 / SF1 the phase was made for, so that the
#: script stays inside its 1200 s: on an H100 the whole phase took 1,016 s
#: at SF10 / SF1 alone (the SF10 transcode 304 s, each SF10 stream ~234 s).
#: With the throughput phase over leg A's warehouse the script took 1,243 s
#: at SF3 / SF0.3 and 1,196 s at SF2 / SF0.3 on an H100, so the legs ran
#: SF1 / SF0.2 (a stream's time is mostly per-file catalog loads, which
#: every SF has: 1,829 date partitions a fact table), and the lakehouse
#: phase (153 s alone at SF1 / SF0.2 on an H100) cuts leg B to SF0.1.
#: With the maintenance phase the script took 1,152 s at SF1 / SF0.1 on an
#: H100, so leg A ran SF0.5; with the fuse phase the script took 1,170 /
#: 1,239 s on H100 hosts slower than PR 14's (its Load Tests alone 20-40%
#: slower), so leg A runs SF0.25. Below ~SF0.8 a generator chunk of
#: store_sales fits one 64 MiB lakehouse file and zone maps have nothing
#: to prune, so the lakehouse phase scales its file size with leg A's SF
#: (lake_env)
STREAM_SF_A = 0.25
STREAM_SF_B = 0.1
STREAM_SF_MADE_FOR = {"A": 10, "B": 1}
#: statements of a generated stream: 99 templates, 14 / 23 / 24 / 39 in two
STREAM_STATEMENTS = 103
#: the templates of stream 0 that the script's legs run: its first
#: STREAM_TEMPLATES entries, in the stream's order, and the entries of
#: STREAM_GATE_TEMPLATES wherever they stand (the time limit: with the
#: maintenance phase the script outgrew its 1200 s, and twice again with
#: the fuse phase, 1,377 s on a slow host with 20, and past 1,200 s on
#: one with 10; a stream's time is mostly catalog loads at first touch, a
#: few templates (query5, query2, query4, query10) most of it: 40
#: templates kept ~80% of it on an H100's host, and query5 alone took 16
#: to 26 s of each leg's 55 to 68 s with 10).
#: tools/torch_stream_phase.py runs all 99
STREAM_TEMPLATES = 2
#: per leg, the templates a gate needs: query96 launches sort_perm,
#: query23's two statements are leg B's only segment_extreme launches, and
#: LAKE_FORMAT_QUERIES are checked against leg B's parquet answers
STREAM_GATE_TEMPLATES = {"A": ("query96",),
                         "B": ("query96", "query23", "query3", "query12",
                               "query15")}
#: the per-query watchdog of every stream run (engine.query_timeout, s)
STREAM_QUERY_TIMEOUT = 300
#: the threads of leg B's CPU run, which runs beside leg A on the host
STREAM_CPU_THREADS = 4
#: the statements a run may leave not completed: run -> {query name:
#: failureKind}. Only a budget refusal (planner), a device_oom after the
#: whole device ladder or a timeout may stand here, each with its entry in
#: ROADMAP.md queue 3; the observed set must equal this in both directions
STREAM_EXPECTED_FAILURES = {"A_on": {}, "A_off": {}, "B_card": {},
                            "B_cpu": {}, "L_on": {}}
STREAM_ALLOWED_KINDS = ("planner", "device_oom", "timeout")
#: the kernels each leg's card runs must launch: leg A's decimal
#: aggregates never reach the f32 segment kernels
STREAM_KERNELS = {"A_on": ("dense_build", "sort_perm"),
                  "B_card": ("segment_sums", "segment_extreme",
                             "dense_build", "sort_perm"),
                  "L_on": ("dense_build", "sort_perm")}


def spec_dim_rows(sf):
    """Row counts of the generator's dimension tables at `sf`, read from the
    port's rowcounts.hpp: the fixed-size tables at any SF, and the tables of
    the spec's scale points where `sf` is one of them (1, 10, 100, ...) or
    below 1."""
    native = os.path.join(ROOT, "nds_tpu_torch", "datagen", "native")
    with open(os.path.join(native, "rowcounts.hpp")) as f:
        text = f.read()
    with open(os.path.join(native, "ndsgen.hpp")) as f:
        date_rows = int(re.search(r"kDateDimRows = (\d+);", f.read()).group(1))
    out = {}
    for name, value in re.findall(
            r'if \(table == "(\w+)"\) return (\w+);', text):
        out[name] = date_rows if value == "kDateDimRows" else int(value)
    knots = (1, 10, 100, 1000, 3000, 10000, 100000)
    for name, at in re.findall(r'\{"(\w+)", \{\{([\d, ]+)\}\}\}', text):
        at = [int(v) for v in at.split(",")]
        if sf in knots:
            out[name] = at[knots.index(sf)]
        elif sf < 1:
            out[name] = max(int(np.ceil(at[0] * sf)), min(at[0], 2))
    return out


def count_dat_rows(raw):
    """Rows per table of a generated data directory (lines of its .dat
    files), counted by 8 threads."""
    from concurrent.futures import ThreadPoolExecutor

    files = [(t, os.path.join(raw, t, f)) for t in sorted(os.listdir(raw))
             for f in os.listdir(os.path.join(raw, t))]

    def lines(job):
        n = 0
        with open(job[1], "rb") as fh:
            while True:
                b = fh.read(1 << 24)
                if not b:
                    return job[0], n
                n += b.count(b"\n")

    rows = {}
    with ThreadPoolExecutor(8) as ex:
        for t, n in ex.map(lines, files):
            rows[t] = rows.get(t, 0) + n
    return rows


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, names in os.walk(path) for f in names)


def run_cli(log, module, *args, env=None, background=False):
    """Run `python -m <module> <args>` from the repo's root with its output
    in `log`; a failure fails the phase with the log's tail. With
    `background`, returns the process (the caller waits for it)."""
    cmd = [sys.executable, "-m", module, *[str(a) for a in args]]
    fh = open(log, "w")
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT,
                            env={**os.environ, **(env or {})})
    fh.close()
    if background:
        return proc
    return wait_cli(proc, log)


def wait_cli(proc, log):
    if proc.wait() != 0:
        with open(log) as fh:
            tail = fh.read()[-3000:]
        fail(f"{' '.join(proc.args[2:4])} exited {proc.returncode}:\n{tail}")
    return proc


def generate(leg, root, sf):
    """Step 1 of a leg: generate SF `sf` with one process per core; check
    the tables whose row counts rowcounts.hpp fixes at `sf`. Emits
    `stream_data`. Returns the data directory and its rows per table."""
    raw = os.path.join(root, "raw")
    os.makedirs(root)
    cores = os.cpu_count()
    t0 = time.perf_counter()
    run_cli(os.path.join(root, "gen_data.log"), "nds_tpu_torch.cli.gen_data",
            "--scale", sf, "--parallel", max(2, cores), "--data_dir", raw)
    gen_s = time.perf_counter() - t0
    rows = count_dat_rows(raw)
    spec = spec_dim_rows(sf)
    wrong = {t: (rows.get(t), n) for t, n in spec.items() if rows.get(t) != n}
    emit({"phase": "stream_data", "leg": leg, "sf": sf, "rows": rows,
          "total_rows": sum(rows.values()), "seconds": gen_s,
          "dat_bytes": dir_bytes(raw), "cores": cores,
          "spec_checked": sorted(spec), "spec_mismatch": wrong})
    if wrong:
        fail(f"stream leg {leg}: row counts against rowcounts.hpp: {wrong}")
    return raw, rows


def start_load(root, raw, floats):
    """Step 2 of a leg, started: the Load Test (transcode to parquet) in a
    process of its own. Returns what finish_load takes."""
    report = os.path.join(root, "load.report")
    t0 = time.perf_counter()
    proc = run_cli(os.path.join(root, "transcode.log"),
                   "nds_tpu_torch.cli.transcode", raw,
                   os.path.join(root, "warehouse"), report,
                   *(["--floats"] if floats else []), background=True)
    return proc, t0, exit_time(proc)


def finish_load(leg, root, sf, raw, rows, load, keep_raw=False, procs=None):
    """Steps 2-3 of a leg, ended: wait for the Load Test, delete the .dat
    files (unless `keep_raw`: the lakehouse phase loads them again), emit
    `stream_load`, generate stream 0 from the Load Test's RNGSEED (a
    process joining `procs` where given). Returns (warehouse, stream file,
    query names)."""
    from nds_tpu_torch import power as TP

    proc, t0, end = load
    wait_cli(proc, os.path.join(root, "transcode.log"))
    end.join()
    load_s = end.at - t0
    if not keep_raw:
        shutil.rmtree(raw)
    wh = os.path.join(root, "warehouse")
    with open(os.path.join(root, "load.report")) as fh:
        text = fh.read()
    seed = re.search(r"^RNGSEED used: (\d{11})$", text, re.M).group(1)
    converted = int(re.search(r"^Total rows converted: (\d+)$", text,
                              re.M).group(1))
    if converted != sum(rows.values()):
        fail(f"stream leg {leg}: transcode converted {converted} rows of "
             f"{sum(rows.values())}")
    parts = os.listdir(os.path.join(wh, "store_sales"))
    per_table = {t: float(x) for t, x in re.findall(
        r"^Time to convert '(\w+)' was ([\d.]+)s$", text, re.M)}
    emit({"phase": "stream_load", "leg": leg, "seconds": load_s,
          "per_table_s": per_table,
          "load_test_s": float(re.search(r"^Load Test Time: ([\d.]+)",
                                         text, re.M).group(1)),
          "rows_per_s": converted / load_s, "parquet_bytes": dir_bytes(wh),
          "rngseed": seed, "store_sales_partitions": len(parts),
          "null_partition": "ss_sold_date_sk=__HIVE_DEFAULT_PARTITION__"
          in parts})

    streams = os.path.join(root, "streams")
    log = os.path.join(root, "gen_query_stream.log")
    proc = run_cli(log, "nds_tpu_torch.cli.gen_query_stream", "--streams", 1,
                   "--scale", sf, "--rngseed", seed, "--output_dir", streams,
                   background=True)
    if procs is not None:
        procs.append(proc)
    wait_cli(proc, log)
    stream = os.path.join(streams, "query_0.sql")
    names = list(TP.gen_sql_from_stream(stream))
    if len(names) != STREAM_STATEMENTS:
        fail(f"stream leg {leg}: {len(names)} statements, not "
             f"{STREAM_STATEMENTS}")
    return wh, stream, names


def check_stream_run(run, names, summaries, log, tables, expected=None):
    """The gates of one stream run: every statement Completed or
    CompletedWithTaskFailures but those `expected` names (by default
    STREAM_EXPECTED_FAILURES' entry for the run), with their failureKind;
    the time log's rows. Returns the names of the completed statements."""
    if expected is None:
        expected = STREAM_EXPECTED_FAILURES[run]
    if sorted(summaries) != sorted(names):
        fail(f"stream {run}: summaries for {sorted(set(names) ^ set(summaries))}")
    failed = {q: s.get("failureKind") for q, s in summaries.items()
              if s["queryStatus"][0] not in ("Completed",
                                              "CompletedWithTaskFailures")}
    if failed != expected:
        fail(f"stream {run}: failed {failed}, expected "
             f"{expected}: " + "; ".join(
                 f"{q}: {summaries[q]['exceptions'][-1][:300]}"
                 for q in failed))
    bad = {q: k for q, k in failed.items() if k not in STREAM_ALLOWED_KINDS}
    if bad:
        fail(f"stream {run}: failures of a kind that may not be listed: {bad}")
    want_rows = ([f"CreateTempView {t}" for t in tables] + names
                 + ["Power Start Time", "Power End Time", "Power Test Time",
                    "Total Time"])
    if [r for r, _ in log] != want_rows:
        fail(f"stream {run}: time log rows {[r for r, _ in log]}")
    return [q for q in names if q not in failed]


def stream_queries(run, summaries, per_query):
    """One `stream_query` line per statement of a run."""
    for name, s in summaries.items():
        pq_ = per_query.get(name, {})
        emit({"phase": "stream_query", "run": run, "query": name,
              "status": s["queryStatus"][0],
              "failure_kind": s.get("failureKind"), "retries": s["retries"],
              "rungs": [r["rung"] for r in s.get("ladder", [])],
              "cold_ms": s["queryTimes"][0],
              "load_ms": pq_.get("load_ms"), "peak_gib": pq_.get("peak_gib"),
              "verdict": (pq_.get("budget") or {}).get("verdict"),
              "launches": pq_.get("launches")})


def stream_card_run(torch, GK, TP, dev, run, root, wh, stream, names, conf,
                    floats, input_format="parquet", json_dir=None):
    """A Power Run of the stream on the card through the port's CLI
    (nds_tpu_torch.cli.power) over `wh` in `input_format`, with `conf` in
    its property file. Launch counts are zeroed just before the stream and
    read just after. The JSON summaries go to `json_dir` as they are
    written where given, else beside the outputs. Returns (summaries, time
    log, per-query records, launches, seconds)."""
    from nds_tpu_torch.cli import power as TCLI
    from nds_tpu_torch.schema import get_schemas

    d = os.path.join(root, run)
    os.makedirs(d)
    json_dir = json_dir or os.path.join(d, "json")
    prop = property_file(os.path.join(d, "power.properties"), {
        **conf, "engine.query_timeout": STREAM_QUERY_TIMEOUT})
    per_query = {}
    restore = instrument_stream(torch, GK, TP, dev, per_query)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        GK.reset_launches()
        t0 = time.perf_counter()
        TCLI.main([wh, stream, os.path.join(d, "time.csv"),
                   "--property_file", prop, "--input_format", input_format,
                   "--output_prefix", os.path.join(d, "out"),
                   "--json_summary_folder", json_dir]
                  + (["--floats"] if floats else []))
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = dict(GK.LAUNCHES)
    finally:
        restore()
    gc.collect()
    torch.cuda.empty_cache()
    summaries = read_summaries(json_dir)
    log = read_time_log(os.path.join(d, "time.csv"))
    check_stream_run(run, names, summaries, log, get_schemas(not floats))
    for k in STREAM_KERNELS.get(run, ()):
        if launches[k] == 0:
            fail(f"stream {run}: kernel {k} was not launched")
    return summaries, log, per_query, launches, seconds


def stream_validate(run, left, right, names, completed, floats,
                    summary_folder):
    """The port's validate (nds_tpu_torch.validate, the reference's
    epsilon and carve-outs) of the completed statements' outputs, then
    update_summary of queryValidationStatus in `summary_folder` (a
    statement that did not complete counts as unmatched: NotAttempted).
    Fails the phase on an unmatched query. Returns the seconds."""
    from nds_tpu_torch import validate as TV

    t0 = time.perf_counter()
    unmatched = TV.iterate_queries(
        os.path.join(left, "out"), os.path.join(right, "out"), completed,
        is_float=floats)
    TV.update_summary(summary_folder, unmatched + [
        q for q in names if q not in completed], names)
    seconds = time.perf_counter() - t0
    if unmatched:
        fail(f"stream {run}: validate found unmatched queries {unmatched}")
    return seconds


def stream_line(leg, run, log, summaries, per_query, launches, seconds,
                validated, validate_s, reduced):
    timings = dict(log)
    statuses = [s["queryStatus"][0] for s in summaries.values()]
    return emit({"phase": "stream", "leg": leg, "run": run,
          "power_test_ms": timings["Power Test Time"],
          "total_ms": timings["Total Time"],
          "completed": statuses.count("Completed"),
          "completed_with_task_failures":
              statuses.count("CompletedWithTaskFailures"),
          "failed": statuses.count("Failed"),
          "peak_gib": max((r.get("peak_gib", 0.0) for r in
                           per_query.values()), default=None),
          "load_ms": sum(r.get("load_ms", 0.0) for r in per_query.values()),
          "launches": launches, "validated_against": validated,
          "unmatched": [], "validate_s": validate_s, "seconds": seconds,
          "reduced": reduced})


def exit_time(proc):
    """A started daemon thread that waits for `proc`; its `at` holds
    time.perf_counter() at the exit, once it is joined."""
    def wait():
        proc.wait()
        waiter.at = time.perf_counter()

    waiter = threading.Thread(target=wait, daemon=True)
    waiter.start()
    return waiter


def stream_start(scale):
    """Steps 1-2 of both legs, started ahead of the stream phase: leg A
    generated and its Load Test started in a process of its own, then leg
    B the same (host work only: the script starts them before the joins
    phase, whose queries keep the card busy, and stream_phase waits for
    the Load Tests). Returns what stream_phase takes as `started`; the
    processes are stopped and the directory removed by stop_started, at
    the latest when the interpreter exits."""
    sf_a = STREAM_SF_A * min(1.0, scale)
    sf_b = STREAM_SF_B * min(1.0, scale)
    root = tempfile.mkdtemp(prefix="nds_stream_")
    st = {"root": root, "sf_a": sf_a, "sf_b": sf_b, "procs": Procs()}
    atexit.register(stop_started, st)
    for leg, sf, floats in (("A", sf_a, False), ("B", sf_b, True)):
        d = os.path.join(root, leg)
        st[f"raw_{leg}"], st[f"rows_{leg}"] = generate(leg, d, sf)
        st[f"load_{leg}"] = start_load(d, st[f"raw_{leg}"], floats)
        st["procs"].append(st[f"load_{leg}"][0])
    return st


def finish_legs(st):
    """Steps 2-3 of both legs, ended (finish_load, their .dat files kept
    for the lakehouse phase): the script runs this on a thread beside the
    SF100 phases and hands its result to stream_phase as `st["legs"]`.
    Returns {leg: (warehouse, stream file, query names)}."""
    return {leg: finish_load(leg, os.path.join(st["root"], leg),
                             st[f"sf_{leg.lower()}"], st[f"raw_{leg}"],
                             st[f"rows_{leg}"], st[f"load_{leg}"],
                             keep_raw=True, procs=st["procs"])
            for leg in ("B", "A")}


def stop_started(st, remove=True):
    """Stop what stream_start (and the stream and lakehouse phases after
    it) started and, with `remove`, remove its directory."""
    st["procs"].stop()
    if remove:
        shutil.rmtree(st["root"], ignore_errors=True)


def stream_phase(torch, GK, dev, on, off, scale, then=None, lake=None,
                 templates=None, started=None):
    """The whole NDS chain on the card over a generated stream 0, in a
    temporary directory removed at the end. Leg A at SF STREAM_SF_A,
    decimals: kernels on, then off, validated against each other. Leg B at
    SF STREAM_SF_B, --floats: the card with the kernels on against the CPU
    (power with --device cpu, a process of its own). Leg B runs while leg
    A's Load Test does, and its CPU run beside leg A's card runs. `then`,
    where given, is called with leg A's directory, warehouse, SF and its
    `A_on` stream line, before the directory goes and while leg B's CPU
    run goes on (the throughput phase);
    `lake`, where given, last with a dict of both legs (their .dat files
    kept for it: the lakehouse phase). With `templates`, each leg runs the
    first `templates` entries of its stream 0 and its STREAM_GATE_TEMPLATES
    (truncate_stream). `started` is stream_start's, where the legs' Load
    Tests were started earlier; its directory is then the caller's to
    remove; where it holds `legs` (a Beside of finish_legs), the legs' Load
    Tests were finished there. Returns the launches of leg A's `on` run and
    of leg B's card run."""
    from nds_tpu_torch import power as TP
    from nds_tpu_torch.schema import get_schemas

    t_phase = time.perf_counter()
    st = started or stream_start(scale)
    sf_a, sf_b = st["sf_a"], st["sf_b"]
    reduced = [f"leg {leg} at SF{sf:g} of SF{STREAM_SF_MADE_FOR[leg]:g}"
               + (" (--scale)" if scale < 1.0 else " (the time limit)")
               for leg, sf in (("A", sf_a), ("B", sf_b))
               if sf < STREAM_SF_MADE_FOR[leg]]
    if templates is not None:
        reduced.append(
            f"stream 0 cut to its first {templates} templates and "
            f"{', '.join(sorted(set(sum(STREAM_GATE_TEMPLATES.values(), ()))))}"
            f" (the time limit)")

    def cut(leg, stream, names):
        if templates is None:
            return names
        return truncate_stream(stream, templates,
                               STREAM_GATE_TEMPLATES[leg])[1]

    ra, rb = os.path.join(st["root"], "A"), os.path.join(st["root"], "B")
    raw_a, rows_a, raw_b, rows_b = (st["raw_A"], st["rows_A"], st["raw_B"],
                                    st["rows_B"])
    procs = st["procs"]
    try:
        legs = st["legs"].join() if "legs" in st else {}
        wh_b, stream_b, names_b = legs.get("B") or finish_load(
            "B", rb, sf_b, raw_b, rows_b, st["load_B"],
            keep_raw=lake is not None)
        names_b = cut("B", stream_b, names_b)
        cpu_dir = os.path.join(rb, "B_cpu")
        t_cpu = time.perf_counter()
        cpu = run_cli(
            os.path.join(rb, "B_cpu.log"), "nds_tpu_torch.cli.power", wh_b,
            stream_b, os.path.join(cpu_dir, "time.csv"), "--floats",
            "--device", "cpu", "--property_file", property_file(
                os.path.join(rb, "cpu.properties"),
                {**on, "engine.query_timeout": STREAM_QUERY_TIMEOUT}),
            "--output_prefix", os.path.join(cpu_dir, "out"),
            "--json_summary_folder", os.path.join(cpu_dir, "json"),
            env={"OMP_NUM_THREADS": str(STREAM_CPU_THREADS)},
            background=True)
        procs.append(cpu)
        cpu_end = exit_time(cpu)
        card_b = stream_card_run(torch, GK, TP, dev, "B_card", rb, wh_b,
                                 stream_b, names_b, on, True)
        stream_queries("B_card", card_b[0], card_b[2])

        wh_a, stream_a, names_a = legs.get("A") or finish_load(
            "A", ra, sf_a, raw_a, rows_a, st["load_A"],
            keep_raw=lake is not None)
        names_a = cut("A", stream_a, names_a)
        runs = {}
        # the kernels-on run traced: its event files and the flight
        # recorder's bundles under trace_a (obs_stream reads them)
        trace_a = os.path.join(ra, "trace_A_on")
        traced = {**on, "engine.trace_dir": trace_a,
                  "engine.flight_recorder": "on"}
        for run, conf in (("A_on", traced), ("A_off", off)):
            runs[run] = stream_card_run(torch, GK, TP, dev, run, ra, wh_a,
                                        stream_a, names_a, conf, False)
            stream_queries(run, runs[run][0], runs[run][2])
        completed = [q for q in names_a
                     if q not in STREAM_EXPECTED_FAILURES["A_on"]
                     and q not in STREAM_EXPECTED_FAILURES["A_off"]]
        v_s = stream_validate("A", os.path.join(ra, "A_on"),
                              os.path.join(ra, "A_off"), names_a,
                              completed, False,
                              os.path.join(ra, "A_on", "json"))
        a_on = None
        for run in ("A_on", "A_off"):
            s, log, pq_, launches, secs = runs[run]
            line = stream_line("A", run, log, s, pq_, launches, secs,
                               "A_off" if run == "A_on" else "A_on", v_s,
                               reduced)
            a_on = a_on or line
        obs_stream(trace_a, runs["A_on"][0], names_a,
                   torch.cuda.get_device_properties(dev).total_memory)
        if then is not None:
            # beside the rest of leg B's CPU run, which is the longer
            gc.collect()
            torch.cuda.empty_cache()
            then(ra, wh_a, sf_a, a_on)

        wait_cli(cpu, os.path.join(rb, "B_cpu.log"))
        cpu_end.join()
        cpu_s = cpu_end.at - t_cpu
        cpu_sum = read_summaries(os.path.join(cpu_dir, "json"))
        cpu_log = read_time_log(os.path.join(cpu_dir, "time.csv"))
        check_stream_run("B_cpu", names_b, cpu_sum, cpu_log,
                         get_schemas(False))
        stream_queries("B_cpu", cpu_sum, {})
        completed = [q for q in names_b
                     if q not in STREAM_EXPECTED_FAILURES["B_card"]
                     and q not in STREAM_EXPECTED_FAILURES["B_cpu"]]
        v_s = stream_validate("B", os.path.join(rb, "B_card"), cpu_dir,
                              names_b, completed, True,
                              os.path.join(rb, "B_card", "json"))
        s, log, pq_, launches_b, secs = card_b
        stream_line("B", "B_card", log, s, pq_, launches_b, secs, "B_cpu",
                    v_s, reduced)
        stream_line("B", "B_cpu", cpu_log, cpu_sum, {}, None, cpu_s,
                    "B_card", v_s, reduced)
        if lake is not None:
            gc.collect()
            torch.cuda.empty_cache()
            lake({"root_a": ra, "raw_a": raw_a, "sf_a": sf_a, "wh_a": wh_a,
                  "stream_a": stream_a, "names_a": names_a,
                  "a_on_dir": os.path.join(ra, "A_on"), "a_on": a_on,
                  "rows_a": rows_a, "root_b": rb, "raw_b": raw_b,
                  "sf_b": sf_b, "stream_b": stream_b, "names_b": names_b,
                  "b_card_dir": os.path.join(rb, "B_card"),
                  "reduced": reduced})
    finally:
        stop_started(st, remove=started is None)
    emit({"phase": "stream_done", "seconds": time.perf_counter() - t_phase})
    return runs["A_on"][3], launches_b


#: the first Throughput Test of nds_tpu/bench.yml's `num_streams: 5`
#: (full_bench.get_stream_range(5, 1)); stream 0 is the Power Run's
THROUGHPUT_STREAMS = (1, 2)
#: the scale and stream count the phase was made for (Spec 4.3.2: S >= 4);
#: tools/torch_throughput_phase.py runs them
THROUGHPUT_MADE_FOR = {"sf": 10, "streams": 4}
#: statements of a concurrent run that may end not completed: stream ->
#: {query name: failureKind}, each with its ROADMAP.md queue 3 entry (as
#: for STREAM_EXPECTED_FAILURES)
THROUGHPUT_EXPECTED_FAILURES = {}
THROUGHPUT_KERNELS = ("dense_build", "sort_perm")
#: the statements of each stream that a run without concurrency (kernels
#: off, one session for both streams) re-runs for validate: those reading
#: the most fact rows (the whole re-run of both streams does not fit the
#: script's time limit, which the bench phase shares)
THROUGHPUT_VALIDATE = 1
#: the templates of each stream the script's throughput phase runs: the
#: first THROUGHPUT_TEMPLATES entries of each generated stream, in its own
#: order, and STREAM_GATE_TEMPLATES' wherever they stand (the time limit;
#: None runs all 99, as tools/torch_throughput_phase.py does; the
#: maintenance and bench phases share that limit; a stream's templates
#: follow its RNGSEED, and one query23 or query83 took 17 to 27 s of a
#: run's 48 s Ttt with 5)
THROUGHPUT_TEMPLATES = 2


def truncate_stream(path, templates, keep=()):
    """Keep the first `templates` entries of a generated stream file, and
    the later entries of the templates named in `keep` (e.g. "query23"), in
    place and in the stream's order. Returns its statement names before
    and after."""
    from nds_tpu_torch import power as TP

    before = list(TP.gen_sql_from_stream(path))
    with open(path) as fh:
        pieces = fh.read().split("-- start")
    kept = [p for i, p in enumerate(pieces[1:])
            if i < templates or p[p.find("template") + 9:p.find(".tpl")]
            in keep]
    with open(path, "w") as fh:
        fh.write("-- start".join([pieces[0], *kept]))
    return before, list(TP.gen_sql_from_stream(path))


def throughput_conf(B, dev, n_streams, conf):
    """The property-file conf of a throughput run on one card, and the
    catalog line each stream's session gets (NDS_CATALOG_BUDGET_BYTES,
    process-wide): the card's catalog and working-set lines divided
    between the streams (budget.budget_lines)."""
    lines = B.budget_lines(dev)
    return ({**conf, "engine.query_timeout": STREAM_QUERY_TIMEOUT,
             "engine.verify_plans": "final",
             "engine.plan_budget_bytes": lines.working_set // n_streams},
            lines.catalog // n_streams)


def fact_rows_read(dev, sf, queries):
    """Per statement of `queries` ({name: SQL}), the fact-table rows its
    scans read at `sf` under the budgeter's scaling model
    (budget.spec_table_rows), planned on a schema-only session."""
    from nds_tpu_torch.analysis import budget as B
    from nds_tpu_torch.engine import plan as P
    from nds_tpu_torch.engine.session import Session, _Entry
    from nds_tpu_torch.schema import TABLE_PARTITIONING, get_schemas

    s = Session(conf={"engine.plan_budget": "off"}, device=dev)
    for name, schema in get_schemas(True).items():
        s.catalog.entries[name] = _Entry(schema=schema)
    out = {}
    for q, sql in queries.items():
        plan = s.run_script(sql).plan
        out[q] = sum(B.spec_table_rows(v.table, sf) for v in
                     P.walk_plan(plan) if isinstance(v, P.Scan)
                     and v.table in TABLE_PARTITIONING)
    return out


def stream_loads(TP, TS):
    """Wrap Catalog.load to add its wall ms to the stream whose session
    loads (the session's setup_tables ran in the stream's thread, named
    `stream-<n>`): the watchdog runs each query in a worker thread of its
    own, so the session, not the thread, names the stream. Returns
    ({stream name: load ms}, restore)."""
    orig_load, orig_setup = TS.Catalog.load, TP.setup_tables
    owner, ms = {}, {}
    lock = threading.Lock()

    def setup_tables(session, *a, **k):
        with lock:
            owner[id(session)] = threading.current_thread().name
            ms.setdefault(owner[id(session)], 0.0)
        return orig_setup(session, *a, **k)

    def load(self, name, columns=None, **lake):
        t0 = time.perf_counter()
        try:
            return orig_load(self, name, columns, **lake)
        finally:
            who = owner.get(id(self.session))
            if who is not None:
                with lock:
                    ms[who] += (time.perf_counter() - t0) * 1e3

    TP.setup_tables, TS.Catalog.load = setup_tables, load

    def restore():
        TP.setup_tables, TS.Catalog.load = orig_setup, orig_load
    return ms, restore


def throughput_phase(torch, GK, dev, root, wh, sf, on, off, a_on, reduced,
                     streams=THROUGHPUT_STREAMS, log_dir=None,
                     templates=None):
    """The Throughput Run on the card: `streams`, generated with the port's
    cli/gen_query_stream from the Load Test's RNGSEED (all 103 statements
    each, or with `templates` each stream's first `templates` entries and
    STREAM_GATE_TEMPLATES' "A" entries: truncate_stream), run at once
    through cli/throughput.py in thread mode over the
    warehouse `wh`, with the kernels on, the stream phase's watchdog and
    engine.verify_plans=final, the card's catalog and working-set lines
    divided between the streams (throughput_conf). Launch counts are
    zeroed and the peak reset just before the run and read just after
    (for the phase as a whole: the streams share the card and its
    counters); catalog-load ms per stream. Gates: every statement
    Completed but those THROUGHPUT_EXPECTED_FAILURES lists, the reference's
    time-log rows in each log, the printed Ttt equal to _ttt_from_logs of
    those logs, the streams' [start, end] windows overlapping,
    THROUGHPUT_KERNELS launched, no PlanVerifyError; then each stream's
    THROUGHPUT_VALIDATE statements that read the most fact rows, run again
    stream after stream in one session with the kernels off, and validate
    finding no unmatched query. Emits `throughput_query` lines and a
    `throughput` line; returns the launches. The run's log
    (line-buffered), time logs and JSON summaries go to `log_dir` where
    given, else beside the outputs under `root`. With `templates`, each
    stream runs its first `templates` entries (truncate_stream), and the
    statements validated are among those every stream ran."""
    from nds_tpu_torch import power as TP
    from nds_tpu_torch import throughput as TT
    from nds_tpu_torch import validate as TV
    from nds_tpu_torch.analysis import budget as B
    from nds_tpu_torch.cli import throughput as TTCLI
    from nds_tpu_torch.engine import session as TS
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.schema import get_schemas

    t_phase = time.perf_counter()
    d = os.path.join(root, "throughput")
    os.makedirs(d)
    with open(os.path.join(root, "load.report")) as fh:
        seed = re.search(r"^RNGSEED used: (\d{11})$", fh.read(),
                         re.M).group(1)
    sdir = os.path.join(d, "streams")
    run_cli(os.path.join(d, "gen_query_stream.log"),
            "nds_tpu_torch.cli.gen_query_stream", "--streams",
            max(streams) + 1, "--scale", sf, "--rngseed", seed,
            "--output_dir", sdir)
    names = {}
    for n in streams:
        path = os.path.join(sdir, f"query_{n}.sql")
        full = names[n] = list(TP.gen_sql_from_stream(path))
        if templates is not None:
            full, names[n] = truncate_stream(path, templates,
                                             STREAM_GATE_TEMPLATES["A"])
        if len(full) != STREAM_STATEMENTS:
            fail(f"throughput stream {n}: {len(full)} statements")
    conf, catalog_bytes = throughput_conf(B, dev, len(streams), on)
    prop = property_file(os.path.join(d, "throughput.properties"), conf)
    log_root = log_dir or d
    os.makedirs(log_root, exist_ok=True)
    base = os.path.join(log_root, "time")
    log_path = os.path.join(log_root, "throughput.log")
    old_env = os.environ.get("NDS_CATALOG_BUDGET_BYTES")
    os.environ["NDS_CATALOG_BUDGET_BYTES"] = str(catalog_bytes)
    load_ms, restore = stream_loads(TP, TS)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        GK.reset_launches()
        t0 = time.perf_counter()
        with open(log_path, "w", buffering=1) as fh, \
                contextlib.redirect_stdout(fh):
            TTCLI.main([wh, sdir, ",".join(map(str, streams)), base,
                        "--property_file", prop,
                        "--output_prefix", os.path.join(d, "out"),
                        "--json_summary_folder", os.path.join(log_root, "json")])
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = dict(GK.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
    finally:
        restore()
        if old_env is None:
            os.environ.pop("NDS_CATALOG_BUDGET_BYTES", None)
        else:
            os.environ["NDS_CATALOG_BUDGET_BYTES"] = old_env
    gc.collect()
    torch.cuda.empty_cache()
    with open(log_path) as fh:
        printed = re.findall(
            r"^====== Throughput Test Time: ([\d.]+) seconds ======$",
            fh.read(), re.M)
    ttt = TT._ttt_from_logs(streams, base)
    windows = {n: TT._read_start_end(f"{base}_{n}.csv") for n in streams}
    per_stream, summaries, logs = {}, {}, {}
    for n in streams:
        summaries[n] = read_summaries(os.path.join(log_root, "json",
                                                   f"stream_{n}"))
        logs[n] = read_time_log(f"{base}_{n}.csv")
        for name, s in summaries[n].items():
            emit({"phase": "throughput_query", "stream": n, "query": name,
                  "status": s["queryStatus"][0],
                  "failure_kind": s.get("failureKind"),
                  "retries": s["retries"],
                  "rungs": [r["rung"] for r in s.get("ladder", [])],
                  "cold_ms": s["queryTimes"][0]})
        statuses = [s["queryStatus"][0] for s in summaries[n].values()]
        per_stream[n] = {
            "power_test_ms": dict(logs[n]).get("Power Test Time"),
            "load_ms": load_ms.get(f"stream-{n}"),
            "start": windows[n][0], "end": windows[n][1],
            "completed": statuses.count("Completed"),
            "completed_with_task_failures":
                statuses.count("CompletedWithTaskFailures"),
            "failed": statuses.count("Failed")}
    single = a_on["power_test_ms"]
    made_for = THROUGHPUT_MADE_FOR
    cut = [f"SF{sf:g} and {len(streams)} streams of SF{made_for['sf']} and "
           f"{made_for['streams']} (the time limit; "
           f"tools/torch_throughput_phase.py runs them)"
           ] if (sf < made_for["sf"]
                 or len(streams) < made_for["streams"]) else []
    if templates is not None:
        cut.append(f"{len(names[streams[0]])} statements a stream (its first "
                   f"{templates} templates) of {STREAM_STATEMENTS} (the time "
                   f"limit)")
    emit({"phase": "throughput", "sf": sf, "streams": list(streams),
          "statements": {n: len(names[n]) for n in streams}, "ttt_s": ttt, "printed_ttt_s": printed, "per_stream": per_stream,
          "single_stream_power_test_ms": single,
          "single_stream_load_ms": a_on["load_ms"],
          "ttt_over_single": ttt * 1e3 / single,
          "ttt_over_sum_of_singles": ttt * 1e3 / (single * len(streams)),
          "peak_gib": peak, "catalog_line_bytes": catalog_bytes,
          "working_set_line_bytes": conf["engine.plan_budget_bytes"],
          "completed": sum(p["completed"] for p in per_stream.values()),
          "failed": sum(p["failed"] for p in per_stream.values()),
          "launches": launches, "run_s": seconds,
          "reduced": reduced + cut})

    if printed != [str(ttt)]:
        fail(f"throughput: printed Ttt {printed}, the time logs give {ttt}")
    if max(s for s, _ in windows.values()) > min(
            e for _, e in windows.values()):
        fail(f"throughput: the streams' windows do not overlap: {windows}")
    for k in THROUGHPUT_KERNELS:
        if launches[k] == 0:
            fail(f"throughput: kernel {k} was not launched")
    tables = get_schemas(True)
    for n in streams:
        check_stream_run(f"T{n}", names[n], summaries[n], logs[n], tables,
                         expected=THROUGHPUT_EXPECTED_FAILURES.get(n, {}))
        bad = {q: s["exceptions"][-1][:300] for q, s in summaries[n].items()
               if any("PlanVerifyError" in x for x in s["exceptions"])}
        if bad:
            fail(f"throughput stream {n}: plan verification failed: {bad}")

    # validate: the statements reading the most fact rows, re-run without
    # concurrency and with the kernels off
    t_val = time.perf_counter()
    first = TP.gen_sql_from_stream(os.path.join(sdir,
                                                f"query_{streams[0]}.sql"))
    rows = fact_rows_read(dev, sf, first)
    failed = {q for n in streams for q in THROUGHPUT_EXPECTED_FAILURES.get(
        n, {})}
    ran = set.intersection(*(set(names[n]) for n in streams))
    subset = sorted((q for q in rows if q not in failed and q in ran),
                    key=lambda q: (-rows[q], names[streams[0]].index(q))
                    )[:THROUGHPUT_VALIDATE]
    # one session for both streams: the second reads the columns the
    # first loaded
    ref = Session(conf=dict(off), device=dev)
    ref.register_nds_tables(wh)
    unmatched = {}
    for n in streams:
        queries = TP.gen_sql_from_stream(os.path.join(sdir,
                                                      f"query_{n}.sql"))
        out = os.path.join(d, f"reference_{n}")
        with open(os.path.join(d, f"reference_{n}.log"), "w") as fh, \
                contextlib.redirect_stdout(fh):
            for q in subset:
                TP.run_one_query(ref, queries[q], q, out, "parquet")
        unmatched[n] = TV.iterate_queries(
            os.path.join(d, f"out_{n}"), out, subset, is_float=False)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "throughput_validate", "validated": subset,
          "fact_rows": {q: rows[q] for q in subset}, "unmatched": unmatched,
          "seconds": time.perf_counter() - t_val,
          "phase_seconds": time.perf_counter() - t_phase,
          "reduced": [f"{len(subset)} statements of {STREAM_STATEMENTS} a "
                      f"stream, those reading the most fact rows that every "
                      f"stream ran (the time limit)"]})
    if any(unmatched.values()):
        fail(f"throughput: validate found unmatched queries {unmatched}")
    return launches


#: the lakehouse phase: the decode workers of its Load Test
LAKE_WORKERS = 4
#: the ingest's target bytes per data file (NDS_INGEST_FILE_BYTES) at SF1
#: and above: transcode.py's default
LAKE_FILE_BYTES = 64 << 20


def lake_env(sf):
    """The environment of leg A's lakehouse Load Test at SF `sf`: below SF1
    the target file size shrinks with the SF, so that a generator chunk of
    store_sales splits into as many files as at SF1 and zone maps have
    files to prune (an NDS_INGEST_FILE_BYTES already set is kept)."""
    if sf >= 1 or "NDS_INGEST_FILE_BYTES" in os.environ:
        return None
    return {"NDS_INGEST_FILE_BYTES": str(int(LAKE_FILE_BYTES * sf))}

#: the scale the phase was made for (leg A's, at which its stream runs);
#: tools/torch_lakehouse_phase.py runs it
LAKE_MADE_FOR = {"A": 10, "B": 1}
#: the pruning check: a date-range aggregate over store_sales, filtered
#: directly on its date key (a month of 1999)
LAKE_PRUNE_SQL = (
    "select ss_store_sk, count(*) c, sum(ss_ext_sales_price) s, "
    "sum(ss_quantity) q from store_sales "
    "where ss_sold_date_sk between 2451180 and 2451210 "
    "group by ss_store_sk order by ss_store_sk")
#: the isolation check: an order-insensitive decimal aggregate (exact)
LAKE_ISO_SQL = (
    "select ss_sold_date_sk, count(*) c, sum(ss_ext_sales_price) s "
    "from store_sales group by ss_sold_date_sk")
#: a statement per sales channel of leg B's stream, over csv and over orc
LAKE_FORMAT_QUERIES = ("query3", "query15", "query12")


def start_lake_load(name, root, raw, *args, env=None, procs=None):
    """Start a Load Test of the lakehouse phase, a cli/transcode.py process
    of its own, to `--output_format name` (the lakehouse, csv or orc) in
    `root`/warehouse_<name>; the process joins `procs` where given.
    Returns (process, log, warehouse, report) for finish_lake_load."""
    wh = os.path.join(root, f"warehouse_{name}")
    log = os.path.join(root, f"transcode_{name}.log")
    report = os.path.join(root, f"load_{name}.report")
    proc = run_cli(log, "nds_tpu_torch.cli.transcode", raw, wh, report,
                   "--output_format", name, *args, env=env, background=True)
    if procs is not None:
        procs.append(proc)
    return proc, log, wh, report


def finish_lake_load(load):
    """Wait for a start_lake_load process. Returns (warehouse, the Load
    Test's own seconds, rows converted), read from its report."""
    proc, log, wh, report = load
    wait_cli(proc, log)
    with open(report) as fh:
        text = fh.read()
    return (wh, float(re.search(r"^Load Test Time: ([\d.]+)", text,
                                re.M).group(1)),
            int(re.search(r"^Total rows converted: (\d+)$", text,
                          re.M).group(1)))


def lake_files_per_table(wh):
    """{fact table: (data files at the head, manifest versions)} of a
    lakehouse warehouse."""
    from nds_tpu_torch.lakehouse.table import LakehouseTable
    from nds_tpu_torch.schema import TABLE_PARTITIONING

    out = {}
    for t in sorted(TABLE_PARTITIONING):
        path = os.path.join(wh, t)
        if LakehouseTable.is_table(path):
            lt = LakehouseTable(path)
            out[t] = (len(lt.snapshot().rel_files), len(lt.versions()))
    return out


def timed_loads(TS):
    """Wrap Catalog.load to sum its wall ms. Returns (ms box, restore)."""
    orig = TS.Catalog.load
    box = [0.0]

    def load(self, name, columns=None, **lake):
        t0 = time.perf_counter()
        try:
            return orig(self, name, columns, **lake)
        finally:
            box[0] += (time.perf_counter() - t0) * 1e3

    TS.Catalog.load = load

    def restore():
        TS.Catalog.load = orig
    return box, restore


def _lake_scan(P, plan):
    return next(n for n in P.walk_plan(plan)
                if isinstance(n, P.Scan) and n.table == "store_sales")


def lake_prune_check(torch, dev, on, wh_lake, wh_pq):
    """The zone-map pruning gate on the card: LAKE_PRUNE_SQL through a
    fresh session with pruning on, one with engine.lake_prune=off, and one
    over the parquet warehouse. The pruned scan must keep a strict subset
    of store_sales' files and all three answers must be equal. Returns the
    `lakehouse_prune` record."""
    from nds_tpu_torch.analysis import budget as B
    from nds_tpu_torch.engine import plan as P
    from nds_tpu_torch.engine import session as TS
    from nds_tpu_torch.engine.session import Session

    got = {}
    for tag, wh, fmt, prune in (("pruned", wh_lake, "lakehouse", "on"),
                                ("unpruned", wh_lake, "lakehouse", "off"),
                                ("parquet", wh_pq, "parquet", "on")):
        s = Session(conf={**on, "engine.lake_prune": prune}, device=dev)
        s.register_nds_tables(wh, fmt)
        box, restore = timed_loads(TS)
        try:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            r = s.sql(LAKE_PRUNE_SQL)
            out = r.collect()
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            restore()
        scan = _lake_scan(P, r.plan)
        pb = B.analyze_plan(r.plan, s.catalog, budget_bytes=1 << 40,
                            reject_bytes=1 << 41)
        got[tag] = {"out": out, "ms": ms, "load_ms": box[0],
                    "lake_files": scan.lake_files,
                    "prune_rows": scan.prune_rows,
                    "scan_rows": next(n.rows for n in pb.nodes
                                      if n.desc.startswith("Scan")
                                      and "store_sales" in n.desc),
                    "table_rows": B.CatalogStats(s.catalog).table_rows(
                        "store_sales")}
        del s, r
        gc.collect()
        torch.cuda.empty_cache()
    from nds_tpu_torch.lakehouse.table import LakehouseTable

    total = len(LakehouseTable(os.path.join(wh_lake, "store_sales"))
                .snapshot().rel_files)
    kept = got["pruned"]["lake_files"]
    rec = {"phase": "lakehouse_prune", "sql": LAKE_PRUNE_SQL,
           "files_kept": None if kept is None else len(kept),
           "files_total": total,
           "rows": got["pruned"]["out"].num_rows,
           "prune_rows": got["pruned"]["prune_rows"],
           "table_rows": got["pruned"]["table_rows"],
           "budget_scan_rows": got["pruned"]["scan_rows"],
           "budget_scan_rows_unpruned": got["unpruned"]["scan_rows"],
           **{f"{tag}_ms": g["ms"] for tag, g in got.items()},
           **{f"{tag}_load_ms": g["load_ms"] for tag, g in got.items()}}
    emit(rec)
    if kept is None or not 0 < len(kept) < total:
        fail(f"lakehouse prune: kept {rec['files_kept']} of {total} files")
    if got["unpruned"]["lake_files"] is not None:
        fail("lakehouse prune: engine.lake_prune=off still pruned")
    if got["pruned"]["scan_rows"] != got["pruned"]["prune_rows"]:
        fail(f"lakehouse prune: the budgeter modeled "
             f"{got['pruned']['scan_rows']} scan rows, not the clamp "
             f"{got['pruned']['prune_rows']}")
    for tag in ("unpruned", "parquet"):
        if not got["pruned"]["out"].equals(got[tag]["out"]):
            fail(f"lakehouse prune: the pruned answer differs from {tag}'s")
    return rec


def lake_isolation_check(torch, dev, on, wh_lake):
    """Snapshot isolation on the card: session S pins store_sales and runs
    LAKE_ISO_SQL; a second thread compacts store_sales and then vacuums it
    with retain_last=1 while S re-executes its pinned plan from disk (its
    column cache dropped). S's answer must equal the one before, bit for
    bit; vacuum must remove none of the pinned files; a fresh statement
    then reads the compacted head and gets the same answer. Returns the
    `lakehouse_isolation` record."""
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.lakehouse.table import LakehouseTable

    path = os.path.join(wh_lake, "store_sales")
    s = Session(conf=dict(on), device=dev)
    s.register_nds_tables(wh_lake, "lakehouse")

    def answer(res):
        return res.collect().sort_by("ss_sold_date_sk")

    before = answer(s.sql(LAKE_ISO_SQL))
    r = s.sql(LAKE_ISO_SQL)  # plans: pins the snapshot S reads
    pinned = s.catalog.entries["store_sales"].pinned_version
    pinned_files = LakehouseTable(path).snapshot(pinned).files()
    compacted = threading.Event()
    box = {}

    def maintenance():
        try:
            lt = LakehouseTable(path)
            t0 = time.perf_counter()
            box["compact"] = lt.compact()
            box["compact_s"] = time.perf_counter() - t0
            compacted.set()
            t0 = time.perf_counter()
            res = lt.vacuum(retain_last=1)
            box["vacuum_s"] = time.perf_counter() - t0
            box["vacuum"] = {k: v for k, v in res.items() if k != "removed"}
            box["removed"] = res["removed"]
        except BaseException as e:  # surfaced below
            box["error"] = repr(e)
            compacted.set()

    th = threading.Thread(target=maintenance, name="lake-maintenance")
    th.start()
    compacted.wait()
    s.recover_memory("lakehouse isolation: re-read the pin from disk")
    r._table = None
    t0 = time.perf_counter()
    during = answer(r)
    torch.cuda.synchronize(dev)
    read_s = time.perf_counter() - t0
    th.join()
    if "error" in box:
        fail(f"lakehouse isolation: maintenance failed: {box['error']}")
    after_res = s.sql(LAKE_ISO_SQL)
    head = s.catalog.entries["store_sales"].pinned_version
    after = answer(after_res)
    lost = [f for f in pinned_files if not os.path.exists(f)]
    pinned_rel = {os.path.relpath(f, path) for f in pinned_files}
    rec = emit({"phase": "lakehouse_isolation", "pinned_version": pinned,
                "head_version": head, "pinned_files": len(pinned_files),
                "head_files": len(LakehouseTable(path).snapshot()
                                  .rel_files),
                "compact": box["compact"], "compact_s": box["compact_s"],
                "vacuum": box["vacuum"], "vacuum_s": box["vacuum_s"],
                "pinned_read_s": read_s, "groups": before.num_rows,
                "pinned_files_removed": len(pinned_rel & set(
                    box["removed"])), "pinned_files_lost": len(lost)})
    del s, r, after_res
    gc.collect()
    torch.cuda.empty_cache()
    if box["compact"]["version"] is None:
        fail("lakehouse isolation: compaction rewrote nothing")
    if lost or rec["pinned_files_removed"]:
        fail(f"lakehouse isolation: vacuum deleted pinned files {lost}")
    if not during.equals(before):
        fail("lakehouse isolation: the pinned answer changed under "
             "compaction and vacuum")
    if head <= pinned or not after.equals(before):
        fail(f"lakehouse isolation: the fresh statement read v{head} "
             f"(pinned v{pinned}) and its answer "
             f"{'matches' if after.equals(before) else 'differs'}")
    return rec


def lake_format_runs(torch, GK, TP, dev, ctx, on, loads):
    """Leg B's csv and orc warehouses (`loads`: format -> finish_lake_load
    of its Load Test), then LAKE_FORMAT_QUERIES (a statement per sales
    channel) of leg B's stream through cli/power.py --input_format csv and
    orc on the card, validated against leg B's parquet answers. Returns
    the `lakehouse_formats` record."""
    from nds_tpu_torch import validate as TV
    from nds_tpu_torch.cli import power as TCLI

    rb = ctx["root_b"]
    rec = {"phase": "lakehouse_formats", "queries": list(LAKE_FORMAT_QUERIES)}
    for fmt in ("csv", "orc"):
        wh, load_test_s, converted = loads[fmt]
        d = os.path.join(rb, f"F_{fmt}")
        prop = property_file(os.path.join(rb, f"{fmt}.properties"), {
            **on, "engine.query_timeout": STREAM_QUERY_TIMEOUT})
        GK.reset_launches()
        t0 = time.perf_counter()
        with open(os.path.join(rb, f"F_{fmt}.log"), "w") as fh, \
                contextlib.redirect_stdout(fh):
            TCLI.main([wh, ctx["stream_b"], os.path.join(d, "time.csv"),
                       "--property_file", prop, "--input_format", fmt,
                       "--floats", "--sub_queries",
                       ",".join(LAKE_FORMAT_QUERIES),
                       "--output_prefix", os.path.join(d, "out"),
                       "--json_summary_folder", os.path.join(d, "json")])
        torch.cuda.synchronize(dev)
        run_s = time.perf_counter() - t0
        summaries = read_summaries(os.path.join(d, "json"))
        status = {q: s["queryStatus"][0] for q, s in summaries.items()}
        unmatched = TV.iterate_queries(
            os.path.join(ctx["b_card_dir"], "out"), os.path.join(d, "out"),
            list(LAKE_FORMAT_QUERIES), is_float=True)
        rec[fmt] = {"load_test_s": load_test_s, "rows": converted,
                    "bytes": dir_bytes(wh), "run_s": run_s, "status": status,
                    "launches": dict(GK.LAUNCHES), "unmatched": unmatched}
        gc.collect()
        torch.cuda.empty_cache()
        if sorted(status) != sorted(LAKE_FORMAT_QUERIES) or any(
                v != "Completed" for v in status.values()):
            emit(rec)
            fail(f"lakehouse formats: {fmt} statements {status}")
        if unmatched:
            emit(rec)
            fail(f"lakehouse formats: {fmt} answers differ from parquet's: "
                 f"{unmatched}")
    return emit(rec)


def lake_loads(ctx, after_load=None, procs=None):
    """Step (1) of the lakehouse phase, host work only: leg A's data
    through cli/transcode.py --output_format lakehouse --workers
    LAKE_WORKERS, then the same command with --resume, while leg B's data
    goes to a csv and an orc warehouse (--floats) in two more processes.
    `after_load`, where given, is called when leg A's Load Test has ended
    (the script starts the maintenance phase's Load Test there) and its
    result kept as `after_load`; each process joins `procs` where given.
    Returns what lakehouse_phase takes as `loaded`."""
    ra = ctx["root_a"]
    env = lake_env(ctx["sf_a"])
    wh, load_test_s, converted = finish_lake_load(start_lake_load(
        "lakehouse", ra, ctx["raw_a"], "--workers", LAKE_WORKERS, env=env,
        procs=procs))
    after = after_load() if after_load is not None else None
    started = {fmt: start_lake_load(fmt, ctx["root_b"], ctx["raw_b"],
                                    "--floats", procs=procs)
               for fmt in ("csv", "orc")}
    try:
        t0 = time.perf_counter()
        resume = run_cli(os.path.join(ra, "transcode_resume.log"),
                         "nds_tpu_torch.cli.transcode", ctx["raw_a"], wh,
                         os.path.join(ra, "load_resume.report"),
                         "--output_format", "lakehouse", "--workers",
                         LAKE_WORKERS, "--resume", env=env, background=True)
        if procs is not None:
            procs.append(resume)
        wait_cli(resume, os.path.join(ra, "transcode_resume.log"))
        resume_s = time.perf_counter() - t0
        loads = {fmt: finish_lake_load(load)
                 for fmt, load in started.items()}
    finally:
        for proc, *_ in started.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    with open(os.path.join(ra, "load_resume.report")) as fh:
        resumed = int(re.search(r"^Total rows converted: (\d+)$", fh.read(),
                                re.M).group(1))
    return {"wh": wh, "env": env, "load_test_s": load_test_s,
            "converted": converted, "resume_s": resume_s, "resumed": resumed,
            "loads": loads, "after_load": after}


def lakehouse_phase(torch, GK, dev, ctx, on, log_dir=None, after_load=None,
                    loaded=None):
    """The lakehouse, csv and orc entries on the card, over the stream
    phase's legs (`ctx`, stream_phase's `lake` argument; their .dat files
    kept). (1) lake_loads, or its result `loaded` where the caller ran it
    ahead (the script does, beside its earlier phases): `lakehouse_load`
    (the Load Test's seconds and rows/s, data files and manifest versions
    per fact table); --resume must convert 0 rows. (2)
    Leg A's stream 0 (as the stream phase cut it) cold through
    cli/power.py --input_format
    lakehouse with the kernels on and the stream watchdog (run `L_on`):
    every statement Completed, validate against A_on finding no unmatched
    query, dense_build and sort_perm launched; Power Test Time, catalog
    load ms and peak beside A_on's. (3) lake_prune_check, (4)
    lake_isolation_check, (5) lake_format_runs. The JSON summaries of the
    stream go to `log_dir` as they are written, where given; `after_load`
    is lake_loads'. Returns the stream's launches."""
    from nds_tpu_torch import power as TP

    from pyarrow import orc  # noqa: F401  (a host without ORC fails here)

    t_phase = time.perf_counter()
    ra, sf = ctx["root_a"], ctx["sf_a"]
    reduced = list(ctx["reduced"])
    if loaded is None:
        loaded = lake_loads(ctx, after_load)
    wh, env, loads = loaded["wh"], loaded["env"], loaded["loads"]
    load_test_s, converted = loaded["load_test_s"], loaded["converted"]
    resume_s, resumed = loaded["resume_s"], loaded["resumed"]
    files = lake_files_per_table(wh)
    emit({"phase": "lakehouse_load", "sf": sf, "workers": LAKE_WORKERS,
          "file_bytes": int((env or os.environ).get(
              "NDS_INGEST_FILE_BYTES", LAKE_FILE_BYTES)),
          "load_test_s": load_test_s,
          "rows": converted, "rows_per_s": converted / load_test_s,
          "bytes": dir_bytes(wh),
          "files_per_fact_table": {t: f for t, (f, _) in files.items()},
          "versions_per_fact_table": {t: v for t, (_, v) in files.items()},
          "resume_rows": resumed, "resume_s": resume_s})
    if converted != sum(ctx["rows_a"].values()):
        fail(f"lakehouse load: converted {converted} rows of "
             f"{sum(ctx['rows_a'].values())}")
    if resumed != 0:
        fail(f"lakehouse load: --resume converted {resumed} rows, not 0")

    json_dir = None
    if log_dir:
        json_dir = os.path.join(log_dir, "L_on_json")
        os.makedirs(json_dir, exist_ok=True)
    summaries, log, per_query, launches, secs = stream_card_run(
        torch, GK, TP, dev, "L_on", ra, wh, ctx["stream_a"],
        ctx["names_a"], on, False, input_format="lakehouse",
        json_dir=json_dir)
    stream_queries("L_on", summaries, per_query)
    names = ctx["names_a"]
    v_s = stream_validate("L", os.path.join(ra, "L_on"), ctx["a_on_dir"],
                          names, names, False,
                          json_dir or os.path.join(ra, "L_on", "json"))
    line = stream_line("L", "L_on", log, summaries, per_query, launches,
                       secs, "A_on", v_s, reduced)
    a_on = ctx["a_on"]
    emit({"phase": "lakehouse_stream", "sf": sf,
          "power_test_ms": line["power_test_ms"], "load_ms": line["load_ms"],
          "peak_gib": line["peak_gib"],
          "a_on_power_test_ms": a_on["power_test_ms"],
          "a_on_load_ms": a_on["load_ms"], "a_on_peak_gib": a_on["peak_gib"],
          "completed": line["completed"], "launches": launches})

    prune = lake_prune_check(torch, dev, on, wh, ctx["wh_a"])
    iso = lake_isolation_check(torch, dev, on, wh)
    formats = lake_format_runs(torch, GK, TP, dev, ctx, on, loads)
    cut = [f"leg {leg} at SF{s:g} of SF{LAKE_MADE_FOR[leg]:g} (the time "
           f"limit; tools/torch_lakehouse_phase.py runs it)"
           for leg, s in (("A", sf), ("B", ctx["sf_b"]))
           if s < LAKE_MADE_FOR[leg]]
    if env is not None:
        cut.append(f"leg A's lakehouse files at "
                   f"{env['NDS_INGEST_FILE_BYTES']} bytes of {LAKE_FILE_BYTES}"
                   f" (a store_sales chunk splits as at SF1)")
    emit({"phase": "lakehouse", "sf": sf, "load_test_s": load_test_s,
          "power_test_ms": line["power_test_ms"],
          "a_on_power_test_ms": a_on["power_test_ms"],
          "files_kept": prune["files_kept"],
          "files_total": prune["files_total"],
          "isolation_groups": iso["groups"],
          "csv_load_test_s": formats["csv"]["load_test_s"],
          "orc_load_test_s": formats["orc"]["load_test_s"],
          "seconds": time.perf_counter() - t_phase,
          # the maintenance phase's Load Test ran beside this phase's after
          # leg A's (the time limit): its times are not this phase's alone
          "maintenance_load_beside": loaded["after_load"] is not None,
          "reduced": cut})
    return launches


# ---------------------------------------------------------------------------
# maintenance: the Data Maintenance phase over leg A's lakehouse
# ---------------------------------------------------------------------------

#: the kernels the maintenance path launches: a CPU run of the 11 refresh
#: functions with branch_spy and engine.pallas_*=on reaches these wrappers
#: and no other (tests/test_torch_maintenance.py holds the list to it)
MAINTENANCE_KERNELS = ("dense_build", "sort_perm")
#: the scale the phase was made for (tools/torch_maintenance_phase.py)
MAINTENANCE_MADE_FOR = 10
#: the under-load pass runs stream 0's first templates (the time limit,
#: which the bench phase shares)
MAINTENANCE_TEMPLATES = 20
#: the fact tables the refresh functions write (maintenance.FACT_TABLES)
DM_FACT_TABLES = ("catalog_sales", "catalog_returns", "inventory",
                  "store_returns", "store_sales", "web_returns", "web_sales")
#: each DF_* function: (fact table, its date key, its order key, the
#: returns table, its order key), the DELETE statements of
#: nds_tpu_torch/data_maintenance/DF_*.sql
DF_TABLES = {
    "DF_CS": ("catalog_sales", "cs_sold_date_sk", "cs_order_number",
              "catalog_returns", "cr_order_number"),
    "DF_SS": ("store_sales", "ss_sold_date_sk", "ss_ticket_number",
              "store_returns", "sr_ticket_number"),
    "DF_WS": ("web_sales", "ws_sold_date_sk", "ws_order_number",
              "web_returns", "wr_order_number"),
    "DF_I": ("inventory", "inv_date_sk", None, None, None),
}
#: step 6's delete-date range: the first pair of the `delete` table that
#: gen_data --update 1 makes (the same at every SF)
MAINTENANCE_SF100_RANGE = ("1998-01-01", "1998-01-31")


def dm_time_log_rows(funcs, optimize=False, vacuum=False):
    """The rows of a Data Maintenance time log, as the reference names
    them (nds_tpu/maintenance.py _run_maintenance_body)."""
    return (list(funcs) + (["Optimize Time"] if optimize else [])
            + (["Vacuum Time"] if vacuum else [])
            + ["Data Maintenance Start Time", "Data Maintenance End Time",
               "Data Maintenance Time", "Total Time"])


def read_dm_time_log(path):
    """[(row name, value)] of a Data Maintenance time log."""
    import csv

    with open(path) as f:
        rows = list(csv.reader(f))
    if rows[0] != ["application_id", "query", "time/s"]:
        fail(f"maintenance time log header {rows[0]}")
    return [(r[1], r[2]) for r in rows[1:]]


def delete_ranges(refresh):
    """{"delete": [(DATE1, DATE2)], "inventory_delete": [...]} of a refresh
    data directory, read from its .dat files in file order, each pair
    ordered so that DATE1 <= DATE2 (ISO dates order as strings)."""
    out = {}
    for t in ("delete", "inventory_delete"):
        d = os.path.join(refresh, t)
        pairs = []
        for f in sorted(os.listdir(d)):
            with open(os.path.join(d, f)) as fh:
                for line in fh:
                    if line.strip():
                        pairs.append(tuple(sorted(line.split("|")[:2])))
        out[t] = pairs
    return out


def _int_column(tb, name):
    """(int64 values with NULLs as 0, validity) of an Arrow column."""
    import pyarrow as pa
    import pyarrow.compute as pc

    col = tb.column(name)
    if pa.types.is_date(col.type):
        col = col.cast(pa.int32())
    valid = pc.is_valid(col).to_numpy(zero_copy_only=False)
    data = pc.fill_null(col.cast(pa.int64()), 0).to_numpy(
        zero_copy_only=False)
    return np.asarray(data, dtype=np.int64), np.asarray(valid, dtype=bool)


def pre_delete_versions(wh):
    """{fact table: the manifest version before its first `delete` commit}
    (None where the table has none)."""
    from nds_tpu_torch.lakehouse.table import LakehouseTable

    out = {}
    for t in DM_FACT_TABLES:
        vs = LakehouseTable(os.path.join(wh, t)).versions()
        first = [v for v, _, op in vs if op == "delete"]
        out[t] = (max(v for v, _, _ in vs if v < first[0]) if first
                  else None)
    return out


def expected_dm_deletes(wh, refresh, versions):
    """The rows each DF_* statement deletes, counted with pyarrow and numpy
    apart from the engine: each function's DELETEs applied in turn, in the
    order maintenance.get_maintenance_queries gives them (per date pair the
    returns delete, then the fact delete), to the fact tables at `versions`
    (pre_delete_versions) and date_dim at its head. A returns row goes when
    its order key is among those of the fact rows sold in the range; a
    fact row when its date key lies between the range's first and last
    d_date_sk (none when the range holds no date); a NULL key never
    matches. Returns {function: [rows per statement]}."""
    from nds_tpu_torch.lakehouse.table import LakehouseTable

    def read(t, cols):
        snap = LakehouseTable(os.path.join(wh, t)).snapshot(versions.get(t))
        tb = snap.dataset().to_table(columns=cols)
        return [_int_column(tb, c) for c in cols]

    (dsk, dsk_ok), (day, day_ok) = read("date_dim", ["d_date_sk", "d_date"])
    ranges = delete_ranges(refresh)
    out = {}
    for fn, (fact, f_date, f_key, ret, r_key) in DF_TABLES.items():
        cols = read(fact, [f_date] + ([f_key] if f_key else []))
        (f_dt, f_dt_ok) = cols[0]
        live_f = np.ones(f_dt.shape[0], dtype=bool)
        if ret:
            (f_k, f_k_ok) = cols[1]
            [(r_k, r_k_ok)] = read(ret, [r_key])
            live_r = np.ones(r_k.shape[0], dtype=bool)
        counts = []
        for d1, d2 in ranges["inventory_delete" if fn == "DF_I"
                             else "delete"]:
            lo, hi = (np.datetime64(d, "D").astype(np.int64)
                      for d in (d1, d2))
            sks = dsk[dsk_ok & day_ok & (day >= lo) & (day <= hi)]
            if ret:
                sold = live_f & f_dt_ok & np.isin(f_dt, sks)
                keys = np.unique(f_k[sold & f_k_ok])
                gone = live_r & r_k_ok & np.isin(r_k, keys)
                counts.append(int(gone.sum()))
                live_r &= ~gone
            gone = (live_f & f_dt_ok & (f_dt >= sks.min())
                    & (f_dt <= sks.max()) if sks.size
                    else np.zeros_like(live_f))
            counts.append(int(gone.sum()))
            live_f &= ~gone
        out[fn] = counts
    return out


def _column_words(col):
    """The values of an Arrow column as a numpy array of machine words
    (uint64; a decimal128 two words a value), NULL slots zeroed, and its
    validity. Integers, dates, decimals, floats and booleans."""
    import pyarrow as pa
    import pyarrow.compute as pc

    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    valid = np.asarray(pc.is_valid(arr).to_numpy(zero_copy_only=False),
                       dtype=bool)
    t = arr.type
    if pa.types.is_decimal128(t):
        raw = np.frombuffer(arr.buffers()[1], dtype=np.uint64)
        words = raw[2 * arr.offset:2 * (arr.offset + len(arr))].reshape(-1, 2)
        words = np.where(valid[:, None], words, 0)
    elif pa.types.is_date(t) or pa.types.is_integer(t) or \
            pa.types.is_floating(t) or pa.types.is_boolean(t):
        if pa.types.is_date(t):
            arr = arr.cast(pa.int32() if pa.types.is_date32(t)
                           else pa.int64())
        filled = pc.fill_null(arr, pa.scalar(0, arr.type)
                              if not pa.types.is_boolean(arr.type)
                              else False)
        vals = np.asarray(filled.to_numpy(zero_copy_only=False))
        if vals.dtype.kind == "f":
            vals = vals.astype(np.float64).view(np.uint64)
        words = vals.astype(np.int64).view(np.uint64)
    else:
        fail(f"fact_digests: no word form for a {t} column")
    return words, valid


def _table_digest(path):
    import hashlib

    import pyarrow.compute as pc

    from nds_tpu_torch.lakehouse.table import LakehouseTable

    tb = LakehouseTable(path).dataset().to_table()
    order = pc.sort_indices(tb, sort_keys=[(c, "ascending")
                                           for c in tb.column_names])
    tb = tb.take(order)
    h = hashlib.sha256(str(tb.schema).encode())
    for name in tb.column_names:
        words, valid = _column_words(tb.column(name))
        h.update(np.ascontiguousarray(words).tobytes())
        h.update(np.packbits(valid).tobytes())
    return [tb.num_rows, h.hexdigest()]


def fact_digests(wh, tables=DM_FACT_TABLES):
    """{table: [rows, sha256 of its schema and of its rows sorted by every
    column, NULLs apart]} at each table's head, four tables at a time:
    equal digests mean equal multisets of rows, exactly, and an equal
    schema."""
    from concurrent.futures import ThreadPoolExecutor

    from nds_tpu_torch.report import use_system_arrow_pool

    # Arrow's mimalloc pool crashes under reads from several threads
    use_system_arrow_pool()
    with ThreadPoolExecutor(4) as ex:
        got = list(ex.map(_table_digest,
                          [os.path.join(wh, t) for t in tables]))
    return dict(zip(tables, got))


def head_timestamp_ms(wh, tables=DM_FACT_TABLES):
    """The latest commit timestamp (epoch ms) of the tables' heads: a
    rollback to it restores every one of them to its head now."""
    from nds_tpu_torch.lakehouse.table import LakehouseTable

    return max(LakehouseTable(os.path.join(wh, t)).versions()[-1][1]
               for t in tables)


class _Statements(list):
    """recorded_dm_statements' list, with `cached_after_commit`: per DML
    statement (a result with rows affected), (function, the session's
    plan / result cache entries and join orders just after it)."""

    def __init__(self):
        super().__init__()
        self.cached_after_commit = []


@contextlib.contextmanager
def recorded_dm_statements(TM):
    """Record each refresh statement the port runs: (function, seconds,
    rows affected or None) appended to the yielded list, and the caches a
    commit left (`cached_after_commit`)."""
    from nds_tpu_torch import faults as TF

    orig = TM._run_dm_statement
    got = _Statements()

    def run(session, q):
        t0 = time.perf_counter()
        res = orig(session, q)
        n = getattr(res, "rows_affected", None)
        got.append((TF.current_scope(), time.perf_counter() - t0, n))
        if n is not None:
            got.cached_after_commit.append((
                TF.current_scope(),
                len(session.plan_cache.map) + len(session.plan_cache.scalars),
                len(session.join_order_cache)))
        return res

    TM._run_dm_statement = run
    try:
        yield got
    finally:
        TM._run_dm_statement = orig


@contextlib.contextmanager
def audited_vacuums(TT):
    """Record each vacuum of a lakehouse table: (table, files removed, the
    removed files that a live reader lease held just before it)."""
    orig = TT.LakehouseTable.vacuum
    got = []

    def vacuum(self, *a, **kw):
        held = self._held_files()
        res = orig(self, *a, **kw)
        got.append((self.name, res["files_removed"],
                    sorted(set(res["removed"]) & held)))
        return res

    TT.LakehouseTable.vacuum = vacuum
    try:
        yield got
    finally:
        TT.LakehouseTable.vacuum = orig


def maintenance_run(torch, GK, TM, dev, root, wh, refresh, on):
    """Step 2: the 11 refresh functions through cli/maintenance.py on the
    card with --optimize (no vacuum). Launch counts are zeroed just before
    and read just after. Returns (time log rows, summaries, statements,
    files per fact table after the functions and after the optimize,
    launches, peak GiB, seconds)."""
    from nds_tpu_torch.cli import maintenance as TCLI

    d = os.path.join(root, "M_card")
    os.makedirs(d)
    prop = property_file(os.path.join(d, "card.properties"), on)
    files = {}
    orig_opt = TM.optimize_warehouse

    def optimize(*a, **kw):
        files["before"] = lake_files_per_table(wh)
        out = orig_opt(*a, **kw)
        files["after"] = lake_files_per_table(wh)
        return out

    TM.optimize_warehouse = optimize
    try:
        with recorded_dm_statements(TM) as stmts, \
                open(os.path.join(d, "maintenance.log"), "w") as fh, \
                contextlib.redirect_stdout(fh):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            GK.reset_launches()
            t0 = time.perf_counter()
            TCLI.main([wh, refresh, os.path.join(d, "time.csv"),
                       "--property_file", prop, "--optimize",
                       "--json_summary_folder", os.path.join(d, "json")])
            torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
            launches = dict(GK.LAUNCHES)
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
    finally:
        TM.optimize_warehouse = orig_opt
    gc.collect()
    torch.cuda.empty_cache()
    return (read_dm_time_log(os.path.join(d, "time.csv")),
            read_summaries(os.path.join(d, "json")), stmts, files, launches,
            peak, seconds)


def check_dm_run(run, funcs, log, summaries, optimize=True):
    """The gates of a Data Maintenance run: every function Completed and
    the time log's rows as the reference names them."""
    status = {q: s["queryStatus"][0] for q, s in summaries.items()}
    if status != {q: "Completed" for q in funcs}:
        fail(f"maintenance {run}: statuses {status}: " + "; ".join(
            f"{q}: {summaries[q]['exceptions'][-1][:300]}"
            for q, v in status.items() if v != "Completed"
            and summaries[q]["exceptions"]))
    want = dm_time_log_rows(funcs, optimize=optimize)
    if [r for r, _ in log] != want:
        fail(f"maintenance {run}: time log rows {[r for r, _ in log]}, "
             f"not {want}")


def maintenance_under_load(torch, GK, TM, TT, B, dev, root, wh, refresh,
                           stream, on, templates):
    """Step 5: maintenance.run_maintenance_under_load with stream 0's first
    `templates` templates and the 11 functions and a vacuum, the reader's
    and the writer's sessions each with half the card's catalog and
    working-set lines (throughput_conf for two streams). Returns the
    `maintenance_under_load` record."""
    d = os.path.join(root, "M_load")
    os.makedirs(d)
    cut = os.path.join(d, "stream.sql")
    shutil.copyfile(stream, cut)
    before, after = truncate_stream(cut, templates)
    conf, catalog_bytes = throughput_conf(B, dev, 2, on)
    prop = property_file(os.path.join(d, "load.properties"), conf)
    statuses = []
    Report = TM.BenchReport

    class Recorded(Report):
        def report_on(self, fn, *args, **kw):
            s = super().report_on(fn, *args, **kw)
            # args[2]: the statement's or the function's name
            statuses.append((fn.__name__, args[2], s["queryStatus"][-1]))
            return s

    old_env = os.environ.get("NDS_CATALOG_BUDGET_BYTES")
    os.environ["NDS_CATALOG_BUDGET_BYTES"] = str(catalog_bytes)
    TM.BenchReport = Recorded
    err = None
    try:
        with audited_vacuums(TT) as vacuums, \
                open(os.path.join(d, "under_load.log"), "w") as fh, \
                contextlib.redirect_stdout(fh):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            GK.reset_launches()
            t0 = time.perf_counter()
            try:
                report = TM.run_maintenance_under_load(
                    wh, refresh, cut, os.path.join(d, "time.csv"),
                    report_path=os.path.join(d, "report.json"),
                    property_file=prop, device=dev)
            except RuntimeError as exc:  # the DM thread failed: reported
                err = str(exc)
                with open(os.path.join(d, "report.json")) as rf:
                    report = json.load(rf)
            torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
            launches = dict(GK.LAUNCHES)
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
    finally:
        TM.BenchReport = Report
        if old_env is None:
            os.environ.pop("NDS_CATALOG_BUDGET_BYTES", None)
        else:
            os.environ["NDS_CATALOG_BUDGET_BYTES"] = old_env
    gc.collect()
    torch.cuda.empty_cache()
    n_q = len(after)
    not_done = [(k, q, st) for k, q, st in statuses if st != "Completed"]
    leased = [(t, f) for t, _, f in vacuums if f]
    rec = emit({
        "phase": "maintenance_under_load", "statements": n_q,
        "templates": templates, "stream_statements": len(before),
        "catalog_bytes_per_session": catalog_bytes,
        "plan_budget_bytes_per_session": conf["engine.plan_budget_bytes"],
        "p99_solo_ms": report["query_p99_ms_solo"],
        "p99_under_load_ms": report["query_p99_ms_under_load"],
        "p99_degradation": report["query_p99_degradation"],
        "dm_functions": report["dm_functions"],
        "dm_failed": report["dm_failed"],
        "dm_elapsed_s": report["dm_elapsed_s"],
        "dm_functions_per_s": report["dm_functions_per_s"],
        "vacuums": report["vacuums"],
        "vacuum_files_removed": report["vacuum_files_removed"],
        "vacuum_removed_leased": leased,
        "overlap_wall_s": report["overlap_wall_s"],
        "dm_error": report.get("dm_error"), "not_completed": not_done,
        "reports": len(statuses), "launches": launches, "peak_gib": peak,
        "seconds": seconds})
    if err is not None or report.get("dm_error"):
        fail(f"maintenance under load: {err or report['dm_error']}")
    if len(statuses) != 3 * n_q + 11 or not_done:
        fail(f"maintenance under load: {len(statuses)} reports of "
             f"{3 * n_q + 11}; not completed {not_done}")
    if report["dm_functions"] != 11 or report["dm_failed"] != 0:
        fail(f"maintenance under load: {report['dm_functions']} functions "
             f"completed, {report['dm_failed']} failed")
    if report["vacuum_files_removed"] < 1 or leased:
        fail(f"maintenance under load: the vacuum removed "
             f"{report['vacuum_files_removed']} files, leased ones {leased}")
    return rec


def maintenance_phase(torch, GK, dev, root, wh, sf, stream, on,
                      reduced=()):
    """The Data Maintenance phase on the card over a lakehouse warehouse
    `wh` at SF `sf`, in `root`, with `stream` for the under-load pass.
    (1) gen_data --update 1 (`maintenance_refresh`: seconds, rows per
    staging table). (3, started first) The warehouse and the refresh data
    copied, and the 11 refresh functions run on the copy through
    cli/maintenance.py --device cpu in a process of its own. (2) The 11
    functions through cli/maintenance.py on the card with --optimize
    (`maintenance_function` lines: ms, status, rows affected per
    statement; `maintenance` line: Tdm from the time log, files per fact
    table before and after the optimize, peak GiB, launches). Gates:
    every function Completed, the time log's rows as the reference names
    them, each DF_* statement's deleted rows equal to expected_dm_deletes,
    MAINTENANCE_KERNELS launched. (3) Every fact table equal between the
    card and the CPU, as multisets of rows (fact_digests). (4) Rollback
    (cli/rollback.py) to the heads before step 2: every fact table's rows
    and digest as before. (5) maintenance_under_load. Returns the
    launches of step 2."""
    from nds_tpu_torch import maintenance as TM
    from nds_tpu_torch.analysis import budget as B
    from nds_tpu_torch.cli import rollback as TRB
    from nds_tpu_torch.lakehouse import table as TT

    t_phase = time.perf_counter()
    funcs = list(TM.DM_FUNCS)
    refresh = os.path.join(root, "refresh")
    t0 = time.perf_counter()
    run_cli(os.path.join(root, "gen_update.log"),
            "nds_tpu_torch.cli.gen_data", "--scale", sf, "--parallel",
            max(2, os.cpu_count()), "--data_dir", refresh, "--update", 1)
    gen_s = time.perf_counter() - t0
    emit({"phase": "maintenance_refresh", "sf": sf, "seconds": gen_s,
          "rows": count_dat_rows(refresh),
          "delete_ranges": delete_ranges(refresh)})

    pre = fact_digests(wh)
    pre_ts = head_timestamp_ms(wh)
    t0 = time.perf_counter()
    wh_cpu = os.path.join(root, "warehouse_maintenance_cpu")
    refresh_cpu = os.path.join(root, "refresh_cpu")
    shutil.copytree(wh, wh_cpu)
    shutil.copytree(refresh, refresh_cpu)
    copy_s = time.perf_counter() - t0
    d_cpu = os.path.join(root, "M_cpu")
    os.makedirs(d_cpu)
    t_cpu = time.perf_counter()
    cpu = run_cli(os.path.join(d_cpu, "maintenance.log"),
                  "nds_tpu_torch.cli.maintenance", wh_cpu, refresh_cpu,
                  os.path.join(d_cpu, "time.csv"), "--device", "cpu",
                  "--property_file", property_file(
                      os.path.join(d_cpu, "cpu.properties"), on),
                  "--json_summary_folder", os.path.join(d_cpu, "json"),
                  env={"OMP_NUM_THREADS": str(STREAM_CPU_THREADS)},
                  background=True)
    try:
        log, summaries, stmts, files, launches, peak, seconds = \
            maintenance_run(torch, GK, TM, dev, root, wh, refresh, on)
        wait_cli(cpu, os.path.join(d_cpu, "maintenance.log"))
    finally:
        if cpu.poll() is None:
            cpu.kill()
        cpu.wait()
    cpu_s = time.perf_counter() - t_cpu
    times = dict(log)
    per_fn = {}
    for fn, secs, n in stmts:
        per_fn.setdefault(fn, []).append((secs, n))
    for fn in funcs:
        s = summaries.get(fn, {})
        emit({"phase": "maintenance_function", "function": fn,
              "ms": (s.get("queryTimes") or [None])[0],
              "status": (s.get("queryStatus") or [None])[0],
              "statement_ms": [secs * 1e3 for secs, _ in per_fn.get(fn, [])],
              "rows_affected": [n for _, n in per_fn.get(fn, [])]})
    check_dm_run("card", funcs, log, summaries)
    deletes = expected_dm_deletes(wh, refresh, pre_delete_versions(wh))
    got_deletes = {fn: [n for _, n in per_fn.get(fn, [])] for fn in deletes}
    tdm = float(times["Data Maintenance Time"])
    emit({"phase": "maintenance", "sf": sf, "tdm_s": tdm,
          "optimize_s": float(times["Optimize Time"]),
          "functions_ms": {fn: summaries[fn]["queryTimes"][0]
                           for fn in funcs},
          "deleted": got_deletes, "deleted_expected": deletes,
          "files_before_optimize": {t: f for t, (f, _) in
                                    files["before"].items()},
          "files_after_optimize": {t: f for t, (f, _) in
                                   files["after"].items()},
          "peak_gib": peak, "launches": launches,
          "seconds": seconds, "copy_s": copy_s,
          "refresh_gen_s": gen_s})
    if got_deletes != deletes:
        fail(f"maintenance: DF_* deleted {got_deletes}, pyarrow counts "
             f"{deletes}")
    # a DML commit empties the session's plan / result and join-order
    # caches (Catalog.invalidate -> Session._catalog_changed)
    left = [c for c in stmts.cached_after_commit if c[1] or c[2]]
    emit({"phase": "maintenance_caches",
          "commits": len(stmts.cached_after_commit),
          "left_after_commit": left})
    if not stmts.cached_after_commit or left:
        fail(f"maintenance: caches after a commit "
             f"{stmts.cached_after_commit}")
    for k in MAINTENANCE_KERNELS:
        if launches[k] == 0:
            fail(f"maintenance: kernel {k} was not launched")

    # (3) the card against the CPU
    cpu_sum = read_summaries(os.path.join(d_cpu, "json"))
    cpu_log = read_dm_time_log(os.path.join(d_cpu, "time.csv"))
    check_dm_run("cpu", funcs, cpu_log, cpu_sum, optimize=False)
    card = fact_digests(wh)
    on_cpu = fact_digests(wh_cpu)
    differ = sorted(t for t in card if card[t] != on_cpu[t])
    emit({"phase": "maintenance_cpu",
          "tdm_s": float(dict(cpu_log)["Data Maintenance Time"]),
          "seconds": cpu_s,
          "rows": {t: [card[t][0], on_cpu[t][0]] for t in card},
          "differ": differ})
    shutil.rmtree(wh_cpu, ignore_errors=True)
    if differ:
        fail(f"maintenance: fact tables {differ} differ between the card "
             f"and the CPU")

    # (4) rollback to the heads before step 2
    t0 = time.perf_counter()
    with open(os.path.join(root, "rollback.log"), "w") as fh, \
            contextlib.redirect_stdout(fh):
        TRB.main([wh, str(pre_ts), "--device", str(dev)])
    rollback_s = time.perf_counter() - t0
    back = fact_digests(wh)
    emit({"phase": "maintenance_rollback", "timestamp_ms": pre_ts,
          "seconds": rollback_s,
          "rows": {t: [pre[t][0], back[t][0]] for t in pre},
          "restored": sorted(t for t in pre if back[t] == pre[t])})
    if back != pre:
        fail(f"maintenance: rollback left "
             f"{sorted(t for t in pre if back[t] != pre[t])} unlike before")

    # (5) under load
    load = maintenance_under_load(torch, GK, TM, TT, B, dev, root, wh,
                                  refresh, stream, on, MAINTENANCE_TEMPLATES)
    cut = list(reduced) + (
        [f"SF{sf:g} of SF{MAINTENANCE_MADE_FOR} (the time limit; "
         f"tools/torch_maintenance_phase.py runs it)"]
        if sf < MAINTENANCE_MADE_FOR else []) + [
        f"the under-load stream cut to stream 0's first "
        f"{MAINTENANCE_TEMPLATES} templates (the time limit)"]
    emit({"phase": "maintenance_done", "sf": sf, "tdm_s": tdm,
          "p99_degradation": load["p99_degradation"],
          "dm_functions_per_s": load["dm_functions_per_s"],
          "seconds": time.perf_counter() - t_phase, "reduced": cut})
    return launches


def start_maintenance_load(ctx, procs=None):
    """Start the maintenance phase's Load Test: leg B's .dat files (kept by
    the stream phase) through cli/transcode.py to a lakehouse with decimals
    (LAKE_WORKERS workers), the process joining `procs` where given.
    Returns start_lake_load's tuple."""
    return start_lake_load("lakehouse", ctx["root_b"], ctx["raw_b"],
                           "--workers", LAKE_WORKERS, procs=procs)


def maintenance_over_leg_b(torch, GK, dev, ctx, on, load=None):
    """The script's maintenance phase: leg B's data loaded to a lakehouse
    with decimals (`load`, a start_maintenance_load already started, or one
    started here; `maintenance_load`), then maintenance_phase over it with
    leg B's stream 0. Leg A's lakehouse would make the phase several times
    longer than the time limit leaves (each DF_* DELETE rewrites its whole
    fact table), so the cut is listed in `reduced`. Returns the launches of
    the phase's card run."""
    rb, sf = ctx["root_b"], ctx["sf_b"]
    wh, load_test_s, converted = finish_lake_load(
        load or start_maintenance_load(ctx))
    emit({"phase": "maintenance_load", "sf": sf, "load_test_s": load_test_s,
          "rows": converted,
          "files_per_fact_table": {t: f for t, (f, _) in
                                   lake_files_per_table(wh).items()}})
    return maintenance_phase(
        torch, GK, dev, rb, wh, sf, ctx["stream_b"], on,
        reduced=[f"leg B's data (SF{sf:g}) loaded to a lakehouse with "
                 f"decimals, in place of leg A's SF{ctx['sf_a']:g} "
                 f"lakehouse (the time limit)"])


def maintenance_sf100(torch, GK, TX, B, Session, star, tables, dev, on):
    """Step 6: the heaviest device statement of the maintenance path at
    SF100, DF_SS's returns delete as lakehouse/dml.py runs it on the
    engine: its survivor query (select * from store_returns where not
    coalesce(<the DELETE's predicate>, false)), built from DF_SS.sql's
    first statement with MAINTENANCE_SF100_RANGE, over the SF100 device
    tables. A refusal at the card's lines is shown, and the query then runs
    under REFUSED_MODE. Cold run with branch_spy, STEADY_RUNS steady runs;
    the survivor count must equal numpy's. Returns the
    `maintenance_sf100` record."""
    from nds_tpu_torch import maintenance as TM
    from nds_tpu_torch.engine import expr as E
    from nds_tpu_torch.engine.sql import ast as A
    from nds_tpu_torch.engine.sql.parser import parse_sql

    with open(os.path.join(TM.MAINTENANCE_SQL_DIR, "DF_SS.sql")) as fh:
        first = next(
            s for s in fh.read().split(";") if s.strip() and not all(
                ln.strip().startswith("--") or not ln.strip()
                for ln in s.splitlines()))
    first = "\n".join(ln for ln in first.strip().splitlines()
                      if not ln.strip().startswith("--"))
    delete_sql = TM.replace_date([first], [MAINTENANCE_SF100_RANGE])[0]
    stmt = parse_sql(delete_sql)
    query = A.SelectStmt(
        select_items=[("*", None)], from_items=[A.TableRef(stmt.table)],
        where=E.UnaryOp("not", E.Func("coalesce",
                                      (stmt.where, E.Lit(False)))))
    s = Session(conf=dict(on), device=dev)
    for name, t in tables.items():
        s.register_table(name, t)
    refused = None
    try:
        s.run_stmt(query)
    except B.PlanBudgetError as exc:
        rec = s.last_plan_budget
        refused = {"modeled_peak_gib": rec["peak_bytes"] / 2**30,
                   "reject_gib": B.resolve_reject_bytes(s.conf, dev) / 2**30,
                   "error": str(exc)}

    def run():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with admitted(s, refused):
            res = s.run_stmt(query).collect()
        torch.cuda.synchronize(dev)
        return res, (time.perf_counter() - t0) * 1e3

    ev = []
    restore = branch_spy(TX.Executor, ev)
    GK.reset_launches()
    try:
        res, cold_ms = run()
    finally:
        restore()
    launches = dict(GK.LAUNCHES)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    steady = [run()[1] for _ in range(STEADY_RUNS)]
    working = torch.cuda.max_memory_allocated(dev) - before
    budget = budget_record(B, s, working, dev, refused)
    # numpy: the returns whose ticket was sold in the range survive not
    dd, ss, sr = star["date_dim"], star["store_sales"], star["store_returns"]
    lo, hi = (np.datetime64(d, "D").astype(np.int64)
              for d in MAINTENANCE_SF100_RANGE)
    sks = dd["d_date_sk"][(dd["d_date"] >= lo) & (dd["d_date"] <= hi)]
    sold = ss["ss_sold_date_sk__valid"] & np.isin(ss["ss_sold_date_sk"], sks)
    tickets = np.unique(ss["ss_ticket_number"][sold])
    gone = int(np.isin(sr["sr_ticket_number"], tickets).sum())
    n_ret = sr["sr_ticket_number"].shape[0]
    rec = emit({"phase": "maintenance_sf100", "sql": delete_sql,
                "rows": res.num_rows, "numpy_survivors": n_ret - gone,
                "deleted": gone, "store_returns_rows": n_ret,
                "cold_ms": cold_ms, "steady_ms": float(np.median(steady)),
                "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                "branches": ev, "launches": launches, "budget": budget,
                "refusal": refused, "steady_runs": STEADY_RUNS})
    del s, res
    gc.collect()
    torch.cuda.empty_cache()
    if rec["rows"] != rec["numpy_survivors"]:
        fail(f"maintenance sf100: {rec['rows']} survivors, numpy "
             f"{rec['numpy_survivors']}")
    return rec


#: the whole benchmark in the script: SF and streams (3: each Throughput
#: Test one stream, each Maintenance Test one refresh set), cut from
#: BENCH_MADE_FOR (tools/torch_bench_phase.py)
BENCH_SF = 0.1
BENCH_STREAMS = 3
BENCH_MADE_FOR = {"sf": 10, "streams": 3}
#: the Power and Throughput Tests' sub_queries in the script (the time limit)
BENCH_TEMPLATES = ("query3", "query7", "query15", "query42", "query55",
                   "query96")
#: gen_data's processes in the bench's config
BENCH_PARALLEL = 4
BENCH_CRASH = "crash:power_test"
#: the orchestrator's phases the crash leaves checkpointed: host work
BENCH_HOST_PHASES = ("data_gen", "load_test", "gen_streams")
#: full_bench.PHASES, in order
BENCH_PHASES = BENCH_HOST_PHASES + (
    "power_test", "throughput_test_1", "maintenance_test_1",
    "throughput_test_2", "maintenance_test_2", "maintenance_under_load")


def template_names(n):
    """The statement names of templates 1..n as a stream file names them
    (the two-part templates as _part1 and _part2)."""
    out = []
    for t in range(1, n + 1):
        out += ([f"query{t}_part1", f"query{t}_part2"]
                if t in (14, 23, 24, 39) else [f"query{t}"])
    return out


def bench_config(root, sf, streams, on, templates=None, under_load=None,
                 parallel=BENCH_PARALLEL):
    """The whole benchmark's config (bench.yml's keys, written as JSON, a
    subset of YAML) for a run in `root`: gen_data with its refresh sets, a
    lakehouse warehouse, the power_test property file with `on`, the
    Power and Throughput Tests over `templates` (None: whole streams), all
    11 refresh functions, every device phase's JSON summaries, and
    maintenance under load when `under_load` is a list of stream 1's
    statements (or "all"). Returns (path, params)."""
    os.makedirs(root, exist_ok=True)
    sub = ",".join(templates) if templates else None
    j = functools.partial(os.path.join, root)
    params = {
        "data_gen": {"scale_factor": sf, "parallel": parallel,
                     "raw_data_path": j("raw"), "skip": False},
        "load_test": {"output_path": j("warehouse"),
                      "warehouse_format": "lakehouse",
                      "report_path": j("load.report"), "skip": False},
        "generate_query_stream": {"num_streams": streams,
                                  "query_template_dir": None,
                                  "stream_output_path": j("streams"),
                                  "skip": False},
        "power_test": {"report_path": j("power.csv"),
                       # the orchestrator's tracer reads its trace dir here
                       "property_path": property_file(
                           j("bench.properties"),
                           {**on, "engine.trace_dir": j("trace")}),
                       "output_path": None, "sub_queries": sub,
                       "json_summary_folder": j("json", "power"),
                       "skip": False},
        "throughput_test": {"report_base_path": j("throughput"),
                            "sub_queries": sub,
                            "json_summary_folder": j("json", "throughput"),
                            "skip": False},
        "maintenance_test": {"maintenance_report_base_path": j("maintenance"),
                             "maintenance_queries": None,
                             "json_summary_folder": j("json", "maintenance"),
                             "skip": False},
        "maintenance_under_load": {
            "enabled": bool(under_load), "maintenance_queries": None,
            "sub_queries": (",".join(under_load)
                            if under_load and under_load != "all" else None),
            "report_path": None},
        "metrics_report_path": j("metrics.csv"),
    }
    with open(j("bench.yml"), "w") as f:
        json.dump(params, f, indent=2)
    return j("bench.yml"), params


def bench_start(root, sf, streams, on, templates=None, under_load=None,
                device=None):
    """Step 1 of the bench phase, started: the config written, then
    `python -m nds_tpu_torch.cli.bench <yml> --fault_spec crash:power_test`
    in a process of its own. It runs data_gen, load_test and gen_streams
    (host work: it touches no CUDA) and dies at power_test. Returns what
    bench_phase takes; stop_bench stops it and removes `root`."""
    yml, params = bench_config(root, sf, streams, on, templates, under_load)
    log = os.path.join(root, "bench_crash.log")
    t0_ms = time.time() * 1000
    proc = run_cli(log, "nds_tpu_torch.cli.bench", yml, "--fault_spec",
                   BENCH_CRASH, *(["--device", device] if device else []),
                   background=True)
    procs = Procs()
    procs.append(proc)
    return {"root": root, "yml": yml, "params": params, "proc": proc,
            "procs": procs, "t0_ms": t0_ms, "log": log, "sf": sf,
            "streams": streams, "templates": templates, "device": device}


def stop_bench(st):
    """Stop both steps' processes (step 2's too, where it runs on a thread
    beside the script) and remove the bench's directory."""
    st["procs"].stop()
    shutil.rmtree(st["root"], ignore_errors=True)


def bench_state(params):
    path = os.path.join(os.path.dirname(params["metrics_report_path"]),
                        "bench_state.json")
    with open(path) as f:
        return json.load(f)["phases"]


def bench_orchestrator_events(trace):
    """[(event file, its events)] of the orchestrator runs that wrote to
    `trace`: the files whose events hold `phase` events (the phases'
    processes write files of their own there too)."""
    from nds_tpu_torch.obs import reader as TR

    out = []
    for f in TR.discover_event_files(trace):
        events = TR.read_events([f], strict=False)
        if any(e["kind"] == "phase" for e in events):
            out.append((f, events))
    return out


def bench_phase_lines(step, phases, t0_ms, log):
    """One `bench_phase` line per phase a step ran: its seconds (from the
    previous checkpoint, or the step's start, to its own) and attempts.
    Returns {phase: seconds}."""
    out = {}
    for name in sorted(phases, key=lambda p: phases[p]["completed_at_ms"]):
        end = phases[name]["completed_at_ms"]
        out[name] = (end - t0_ms) / 1e3
        emit({"phase": "bench_phase", "step": step, "name": name,
              "seconds": out[name],
              "attempts": 1 + log.count(f"phase {name}: attempt ")})
        t0_ms = end
    return out


def _round_up_tenth(x):
    return math.ceil(x * 10) / 10


def bench_rederive(params, streams):
    """Tload, Tpower, Ttt1, Ttt2, Tdm1, Tdm2 from the phases' own report
    files and the composite metric of TPC-DS Spec 7.6.3 over them, read
    here (not by full_bench)."""
    with open(params["load_test"]["report_path"]) as f:
        tload = float(re.search(r"^Load Test Time: (\S+) seconds$", f.read(),
                                re.M).group(1))
    power = dict(read_time_log(params["power_test"]["report_path"]))
    tpower = _round_up_tenth(float(power["Power Test Time"]) / 1000)
    tests = {1: range(1, streams // 2 + 1), 2: range(streams // 2 + 1,
                                                      streams)}
    ttt, tdm = {}, {}
    for k, nums in tests.items():
        starts, ends = [], []
        for n in nums:
            log = dict(read_time_log(
                f"{params['throughput_test']['report_base_path']}_{n}.csv"))
            starts.append(float(log["Power Start Time"]))
            ends.append(float(log["Power End Time"]))
        ttt[k] = max(_round_up_tenth(max(ends) - min(starts)), 0.1)
        total = 0.0
        for n in nums:
            total += float(dict(read_dm_time_log(
                f"{params['maintenance_test']['maintenance_report_base_path']}"
                f"_{n}.csv"))["Data Maintenance Time"])
        tdm[k] = _round_up_tenth(total)
    sq = streams // 2
    metric = int(float(params["data_gen"]["scale_factor"]) * (sq * 99) / (
        ((tpower * sq) / 3600) * ((ttt[1] + ttt[2]) / 3600)
        * ((tdm[1] + tdm[2]) / 3600) * ((0.01 * sq * tload) / 3600))
        ** (1 / 4))
    return {"Tload": tload, "Tpower": tpower, "Ttt1": ttt[1], "Ttt2": ttt[2],
            "Tdm1": tdm[1], "Tdm2": tdm[2], "perf_metric": metric}


def bench_summaries(label, folder, names, device):
    """The gates of a device phase's JSON summaries: one per statement of
    `names`, every one Completed, each session on `device` ((type, card
    name); name None on the CPU). Returns the count."""
    got = read_summaries(folder)
    if sorted(got) != sorted(names):
        fail(f"bench {label}: summaries for {sorted(set(names) ^ set(got))}")
    bad = {q: (s["queryStatus"], s["exceptions"][-1:])
           for q, s in got.items() if s["queryStatus"] != ["Completed"]}
    if bad:
        fail(f"bench {label}: not Completed: {bad}")
    ran_on = {(s["env"]["engineConf"]["torch.device"].split(":")[0],
               s["env"]["engineConf"].get("torch.cuda.device_name"))
              for s in got.values()}
    if ran_on != {device}:
        fail(f"bench {label}: ran on {ran_on}, not {device}")
    return len(got)


class PeakSampler:
    """The card's memory in use (nvidia-smi, every process on it), sampled
    every second on a thread while it runs: `peak_mib` is the largest."""

    def __init__(self):
        self.peak_mib = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            r = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                                "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, timeout=60)
            if r.returncode == 0:
                used = int(r.stdout.split()[0])
                self.peak_mib = max(self.peak_mib or 0, used)
            self._stop.wait(1.0)

    def stop(self):
        self._stop.set()
        self._thread.join()
        return self.peak_mib


def bench_phase(st, device, reduced, sample=True, beside=None):
    """Steps 1 (ended) and 2 of the bench phase: wait for the crashed run
    and hold it to its gates (a non-zero exit, exactly BENCH_HOST_PHASES
    checkpointed, no metrics.csv), then `python -m nds_tpu_torch.cli.bench
    <yml> --resume` (its device phases on the card, or on `--device` where
    bench_start named one): the three skipped from the checkpoint, the
    other phases run, metrics.csv equal to bench_rederive, every statement
    and refresh function Completed on `device`. Emits the `bench_phase`
    lines and the `bench` line (`beside`: what ran beside step 2, which
    the card's memory in use includes); returns the latter."""
    from nds_tpu_torch import faults as TF
    from nds_tpu_torch import power as TP
    from nds_tpu_torch.maintenance import DM_FUNCS
    from nds_tpu_torch.obs import reader as TR

    params, root = st["params"], st["root"]
    rc = st["proc"].wait()
    with open(st["log"]) as f:
        crash_log = f.read()
    if rc == 0 or "InjectedCrash" not in crash_log:
        fail(f"bench: the crashed run exited {rc}:\n{crash_log[-3000:]}")
    phases = bench_state(params)
    if sorted(phases) != sorted(BENCH_HOST_PHASES):
        fail(f"bench: the crash left {sorted(phases)} checkpointed")
    if os.path.exists(params["metrics_report_path"]):
        fail("bench: the crashed run wrote metrics.csv")
    seconds = bench_phase_lines("crash", phases, st["t0_ms"], crash_log)
    trace = os.path.join(root, "trace")
    crashed = bench_orchestrator_events(trace)
    if len(crashed) != 1:
        fail(f"bench: {len(crashed)} orchestrator event files after the "
             f"crash")
    crash_file, crash_events = crashed[0]
    crash_kind = TR.failure_kind_from_files([crash_file])
    crash_line = next((ln for ln in crash_log.splitlines()
                       if "InjectedCrash" in ln), "")
    if crash_kind != TF.classify(crash_line.strip()):
        fail(f"bench: the crash's events say {crash_kind}, its log "
             f"{TF.classify(crash_line.strip())} ({crash_line!r})")
    begun = [e["phase"] for e in crash_events
             if e["kind"] == "phase" and e["event"] == "begin"]
    if begun != list(BENCH_HOST_PHASES) + ["power_test"]:
        fail(f"bench: the crashed orchestrator began {begun}")
    # step 2, with no fault spec
    log = os.path.join(root, "bench_resume.log")
    t0_ms = time.time() * 1000
    sampler = PeakSampler() if sample else None
    try:
        proc = st["procs"].append(run_cli(
            log, "nds_tpu_torch.cli.bench", st["yml"], "--resume",
            *(["--device", st["device"]] if st["device"] else []),
            env={"NDS_FAULT_SPEC": ""}, background=True))
        rc = proc.wait()
    finally:
        peak = sampler.stop() if sampler else None
    resume_s = (time.time() * 1000 - t0_ms) / 1e3
    with open(log) as f:
        text = f.read()
    if rc != 0:
        fail(f"bench: --resume exited {rc}:\n{text[-3000:]}")
    resumed = [(f, e) for f, e in bench_orchestrator_events(trace)
               if f != crash_file]
    if len(resumed) != 1:
        fail(f"bench: {len(resumed)} orchestrator event files of --resume")
    ends = {e["phase"]: e["status"] for e in resumed[0][1]
            if e["kind"] == "phase" and e["event"] == "end"}
    if sorted(ends) != sorted(BENCH_PHASES) or set(ends.values()) - {
            "ok", "skipped"}:
        fail(f"bench: --resume's phase events {ends}")
    skipped = re.findall(r"phase (\w+): skipped \(checkpoint\)", text)
    if sorted(skipped) != sorted(BENCH_HOST_PHASES):
        fail(f"bench: --resume skipped {skipped} from the checkpoint")
    ran = [p for p in bench_state(params) if p not in phases]
    want = [p for p in BENCH_PHASES if p not in BENCH_HOST_PHASES
            and (p != "maintenance_under_load"
                 or params["maintenance_under_load"]["enabled"])]
    if sorted(ran) != sorted(want):
        fail(f"bench: --resume completed {ran}, not {want}")
    modules = re.findall(r"^====== \S+ -m (\S+)", text, re.M)
    sq = st["streams"] // 2
    want = ["power"] + (["throughput"] + ["maintenance"] * sq) * 2 + (
        ["maintenance"] if params["maintenance_under_load"]["enabled"]
        else [])
    if modules != [f"nds_tpu_torch.cli.{m}" for m in want]:
        fail(f"bench: --resume ran {modules}")
    seconds.update(bench_phase_lines(
        "resume", {p: v for p, v in bench_state(params).items()
                   if p not in phases}, t0_ms, text))
    with open(params["metrics_report_path"]) as f:
        got = dict(line.split(",", 1) for line in f.read().splitlines())
    derived = bench_rederive(params, st["streams"])
    # the trace directory adds the plan-feedback headline, at its default
    # until cardinality feedback (ROADMAP.md queue 1 item 14)
    feedback = ["feedback_hit_rate", "budget_err_median"]
    if list(got) != ["scale_factor", "num_streams", *derived, *feedback] \
            or {got[k] for k in feedback} != {"None"}:
        fail(f"bench: metrics.csv {got}")
    for k, v in derived.items():
        if (int if k == "perf_metric" else float)(got[k]) != v:
            fail(f"bench: metrics.csv {k}={got[k]}, re-derived {v}")
    if derived["perf_metric"] <= 0:
        fail(f"bench: perf_metric {derived['perf_metric']}")
    stream = functools.partial(os.path.join,
                               params["generate_query_stream"][
                                   "stream_output_path"])

    def names(n):
        all_ = list(TP.gen_sql_from_stream(stream(f"query_{n}.sql")))
        return [q for q in all_ if not st["templates"]
                or q in st["templates"]]

    counts = {"power": bench_summaries(
        "power", params["power_test"]["json_summary_folder"], names(0),
        device)}
    for n in range(1, st["streams"]):
        counts[f"stream_{n}"] = bench_summaries(
            f"stream {n}", os.path.join(
                params["throughput_test"]["json_summary_folder"],
                f"stream_{n}"), names(n), device)
        folder = f"{params['maintenance_test']['json_summary_folder']}_{n}"
        counts[f"refresh_{n}"] = bench_summaries(
            f"refresh set {n}", folder, list(DM_FUNCS), device)
        log_rows = [r for r, _ in read_dm_time_log(
            f"{params['maintenance_test']['maintenance_report_base_path']}"
            f"_{n}.csv")]
        if log_rows != dm_time_log_rows(DM_FUNCS):
            fail(f"bench: refresh set {n}'s time log rows {log_rows}")
    under_load = None
    if params["maintenance_under_load"]["enabled"]:
        with open(params["maintenance_test"]["maintenance_report_base_path"]
                  + "_under_load.json") as f:
            under_load = json.load(f)
        if (under_load["solo_failed"] or under_load["under_load_failed"]
                or under_load["dm_failed"]
                or under_load["dm_functions"] != len(DM_FUNCS)):
            fail(f"bench: maintenance under load {under_load}")
    rec = {"phase": "bench", "sf": st["sf"], "num_streams": st["streams"],
           "streams_per_throughput_test": sq, **derived,
           "metrics_csv": got, "phase_seconds": seconds,
           "resume_seconds": resume_s, "peak_used_mib": peak,
           "beside": beside,
           "crash_failure_kind": crash_kind,
           "crash_events": len(crash_events),
           "resume_phase_events": ends,
           "trace_files": len(TR.discover_event_files(trace)),
           "summaries": counts, "ran_on": list(device),
           "under_load": under_load, "reduced": reduced}
    emit(rec)
    return rec


#: the explain phase's scale: the SF100 the earlier phases model
EXPLAIN_SF = 100
#: the statements the card's lines refused at SF100 in the earlier phases
#: (PERF.md §5, ROADMAP.md queue 3 item 1)
KNOWN_REFUSALS = ("query93", "query16", "query36", "query67")


def explain_phase(dev):
    """cli/explain.py --budget --scale EXPLAIN_SF over all 99 templates
    (each instantiated from stream 0's seed sequence, explain's own), on
    the card's lines, with NDS_VERIFY_PLANS=all: the plan verifier after
    binding and after each rewrite pass of every statement. Gate: no
    verifier violation. The verdicts are printed, not gated: one
    `explain` line with each statement's verdict and modeled peak and the
    count per verdict."""
    from nds_tpu_torch.analysis import budget as B
    from nds_tpu_torch.analysis.verifier import PlanVerifyError
    from nds_tpu_torch.cli import explain as TE
    from nds_tpu_torch.datagen.query_streams import available_templates

    t0 = time.perf_counter()
    old = os.environ.get("NDS_VERIFY_PLANS")
    os.environ["NDS_VERIFY_PLANS"] = "all"
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = TE.main(["--query", ",".join(
                str(q) for q in available_templates()), "--budget",
                "--scale", str(EXPLAIN_SF), "--device", str(dev)])
    except PlanVerifyError as exc:
        fail(f"explain: plan verification failed: {exc}")
    finally:
        if old is None:
            os.environ.pop("NDS_VERIFY_PLANS", None)
        else:
            os.environ["NDS_VERIFY_PLANS"] = old
    found, label = [], None
    for line in out.getvalue().splitlines():
        m = re.match(r"^== (query\d+)#\d+$", line)
        if m:
            label = m.group(1)
            continue
        m = re.match(r"^verdict: (\w+)  peak=(\S+)", line)
        if m:
            found.append((label, [m.group(1), m.group(2)]))
    # two-statement templates (14, 23, 24, 39) as the stream names them
    parts = {q: sum(1 for k, _ in found if k == q) for q, _ in found}
    verdicts, seen = {}, {}
    for q, v in found:
        seen[q] = seen.get(q, 0) + 1
        verdicts[q if parts[q] == 1 else f"{q}_part{seen[q]}"] = v
    counts = {}
    for v, _ in verdicts.values():
        counts[v] = counts.get(v, 0) + 1
    lines = B.budget_lines(dev)
    emit({"phase": "explain", "sf": EXPLAIN_SF, "verify_plans": "all",
          "statements": len(verdicts), "counts": counts, "rc": rc,
          "lines_gib": {k: v / 2**30 for k, v in vars(lines).items()},
          "known_refusals": {q: [v for k, v in verdicts.items()
                                 if k.split("_")[0] == q]
                             for q in KNOWN_REFUSALS},
          "verdicts": verdicts, "seconds": time.perf_counter() - t0})
    if len(verdicts) != STREAM_STATEMENTS:
        fail(f"explain: {len(verdicts)} verdicts, not {STREAM_STATEMENTS}")


#: whether torch.profiler has traced the card once in this process
_PROFILER_STARTED = []


def profile_query(torch, run_once, q, top=10, match=None):
    """Where one steady run's time goes: torch.profiler's device time by
    kernel, the device's busy share of the wall time, and the launches;
    `match_ms` sums the device time of the kernels whose name holds
    `match`. The process's first call profiles one run more and discards
    it: the profiler's start-up (about 1.9 s on the H100) would otherwise
    land in the first query's wall time."""
    from torch.profiler import ProfilerActivity, profile

    if not _PROFILER_STARTED:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            run_once()
        _PROFILER_STARTED.append(True)
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
    match_ms = (None if match is None or not rows else
                sum(ms for ms, _, k in rows if match in k))
    return {
        "phase": "profile", "query": q, "wall_ms": wall_ms,
        "device_ms": device_ms if rows else None,
        "device_busy_share": device_ms / wall_ms if rows else None,
        "device_launches": sum(r[1] for r in rows) if rows else None,
        "match_ms": match_ms,
        "top": [{"kernel": k[:80], "ms": ms, "calls": c}
                for ms, c, k in rows[:top]],
    }


# ---------------------------------------------------------------------------
# obs: the observability layer (nds_tpu_torch/obs/, cli/profile.py), on
# the card inside runs the script already makes
# ---------------------------------------------------------------------------

#: steady q3 runs of each session in the obs step's alternated rounds
OBS_RUNS = 3
#: the entry points of ops/kernels.py that emit `kernel_span` events
KTRACED = ("compact_indices", "sort_by_words", "group_by_words",
           "build_sort_words", "segment_reduce", "segment_reduce_with_count",
           "batched_min_max", "join_candidates", "member_lookup",
           "verify_pairs", "dense_build", "dense_probe", "direct_gid",
           "occupancy_map")
#: the `auto` A/B's measurements q3 must leave in its trace, under the
#: reference's names (`:pallas` is the hand-written CUDA kernel, `:jnp`
#: the plain torch route)
OBS_AB_SPANS = ("segment_sum:jnp", "segment_sum:pallas", "dense_build:jnp",
                "dense_build:pallas")


def _lead_len(args):
    """The leading input's length: the first argument, or the first
    element of a list or tuple argument, that has a shape."""
    for a in args:
        if isinstance(a, (list, tuple)) and a:
            a = a[0]
        shape = getattr(a, "shape", None)
        if shape:
            return int(shape[0])
    return 0


def lead_recorder(K, calls):
    """Wrap each KTRACED entry point at ops/kernels.py's module attribute
    (the executor's calls and the module's own calls both look it up
    there) to append (name, leading length) for every call made outside a
    fused chain. Returns the function that restores them."""
    originals = {n: getattr(K, n) for n in KTRACED}

    def wrap(name, fn):
        def wrapped(*a, **kw):
            if not K._in_fused_chain():
                calls.append((name, _lead_len(a)))
            return fn(*a, **kw)
        return wrapped

    for n, fn in originals.items():
        setattr(K, n, wrap(n, fn))

    def restore():
        for n, fn in originals.items():
            setattr(K, n, fn)
    return restore


def scrape(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.read().decode("utf-8")


def metric_totals(text):
    """{metric family: the sum of its series} of a Prometheus text
    exposition."""
    out = collections.Counter()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        out[name.split("{", 1)[0]] += float(value)
    return out


def obs_q3(torch, Session, tables, dev, on, refused):
    """The observability layer on the main path's SF100 q3. One session
    with engine.trace_dir, engine.metrics_port=0, engine.trace_kernels=on
    and engine.pallas_agg / pallas_join `auto` (no persistent cache, so
    the A/B is measured) runs q3 once: its trace must hold a kernel_span
    for every call of a KTRACED entry point outside a fused chain, with
    `n` the call's leading length, and OBS_AB_SPANS. Then, in one call,
    OBS_RUNS steady runs each (after one warm-up each) of four sessions
    of the main path's conf, alternated: untraced (the flight recorder
    off: no tracer), the default (the flight recorder's ring only),
    traced (trace dir and metrics port) and traced with kernel spans,
    each run a BenchReport as the Power Run makes it. Their
    answers must equal the untraced one's exactly. /metrics and /statusz
    are scraped over HTTP from the process's endpoint: each event
    family's counter must equal its kind's count in the trace. Emits the
    `obs` line (medians, the ring's, the tracer's and the kernel spans'
    cost against untraced, emit_costs, the trace's event and span counts)
    and returns it."""
    from nds_tpu_torch import report as TREP
    from nds_tpu_torch.obs import metrics as TM
    from nds_tpu_torch.obs import reader as TR
    from nds_tpu_torch.obs import trace as TOT
    from nds_tpu_torch.ops import kernels as K

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="nds_obs_")
    # the endpoint serves this host only
    os.environ["NDS_METRICS_HOST"] = "127.0.0.1"
    trace = os.path.join(root, "trace")
    obs = {"engine.trace_dir": trace, "engine.metrics_port": "0"}
    sql = QUERIES["q3"]

    def report_run(s):
        box = []
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        with TOT.bind(s.tracer), admitted(s, refused):
            summary = TREP.BenchReport(s).report_on(
                lambda: box.append(s.sql(sql).collect()), retry_oom=True,
                name="q3")
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t) * 1e3
        if summary["queryStatus"] != ["Completed"]:
            fail(f"obs: q3 ended {brief(summary)}")
        return ms, box[0]

    try:
        # -- the A/B session: kernel spans and the :jnp / :pallas pairs --
        s_ab = Session(conf={**on, **obs, "engine.trace_kernels": "on",
                             "engine.pallas_agg": "auto",
                             "engine.pallas_join": "auto",
                             "engine.aot_cache_dir": ""})
        for name, t in tables.items():
            s_ab.register_table(name, t)
        calls = []
        restore = lead_recorder(K, calls)
        try:
            report_run(s_ab)
        finally:
            restore()
        ab_app = s_ab.tracer.app_id
        promotions = {"/".join(str(x) for x in k): v
                      for k, v in s_ab.pallas_promotions.items()}
        s_ab.tracer.close()
        del s_ab

        # -- untraced / the default ring / traced / kernel spans ----------
        sessions = {
            "untraced": Session(conf={**on, "engine.flight_recorder": "off"}),
            # the default: no trace dir, the flight recorder's ring only
            "ring": Session(conf=dict(on)),
            "traced": Session(conf={**on, **obs}),
            "kernel_spans": Session(conf={**on, **obs,
                                          "engine.trace_kernels": "on"}),
        }
        if sessions["untraced"].tracer is not None:
            fail("obs: the untraced session has a tracer")
        for s in sessions.values():
            for name, t in tables.items():
                s.register_table(name, t)
            report_run(s)  # warm-up: the fused builds of this session
        times = {k: [] for k in sessions}
        ref = None
        for _ in range(OBS_RUNS):
            for k, s in sessions.items():
                ms, res = report_run(s)
                times[k].append(ms)
                if ref is None:
                    ref = res
                elif not res.equals(ref):
                    fail(f"obs: q3's answer {k} differs from untraced")
        port = TM.active_server().port
        metrics_text = scrape(port, "/metrics")
        statusz = json.loads(scrape(port, "/statusz"))
        emit_us, sample_us = emit_costs(root)
        for s in sessions.values():
            if s.tracer is not None:
                s.tracer.close()
        del sessions

        # -- the trace against the recorder and the endpoint --------------
        events = TR.read_events(trace, strict=True)
        problems = TR.validate_events(events)
        if problems:
            fail(f"obs: the trace breaks the schema: {problems[:3]}")
        kinds = collections.Counter(e["kind"] for e in events)
        ab = [e for e in events
              if e["kind"] == "kernel_span" and e["app"] == ab_app]
        got = collections.Counter((e["kernel"], e["n"]) for e in ab
                                  if e["kernel"] in KTRACED)
        want = collections.Counter(calls)
        if not want or got != want:
            fail(f"obs: kernel spans {sorted(got.items())[:8]} against the "
                 f"calls {sorted(want.items())[:8]}")
        names = {e["kernel"] for e in ab}
        missing = [k for k in OBS_AB_SPANS if k not in names]
        if missing:
            fail(f"obs: q3's auto A/B left no {missing} span")
        totals = metric_totals(metrics_text)
        checked = {}
        for kind, n in kinds.items():
            family = f"nds_{kind}_total"
            if TM.METRIC_KINDS.get(family) != kind:
                continue
            checked[family] = totals.get(family, 0.0)
            if checked[family] != n:
                fail(f"obs: /metrics {family} {checked[family]} against "
                     f"{n} {kind} events in the trace")
        completed = sum(1 for e in events if e["kind"] == "query_span"
                        and e["status"] == "Completed")
        if statusz.get("queries_completed") != completed:
            fail(f"obs: /statusz counts {statusz.get('queries_completed')} "
                 f"completed queries, the trace {completed}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    med = {k: float(np.median(v)) for k, v in times.items()}
    base = med["untraced"]
    return emit({
        "phase": "obs", "query": "q3", "runs": OBS_RUNS,
        "untraced_ms": base, "ring_ms": med["ring"],
        "traced_ms": med["traced"], "kernel_spans_ms": med["kernel_spans"],
        "ring_cost_ms": med["ring"] - base,
        "ring_cost_pct": 100.0 * (med["ring"] - base) / base,
        "tracer_cost_ms": med["traced"] - base,
        "tracer_cost_pct": 100.0 * (med["traced"] - base) / base,
        "kernel_span_cost_ms": med["kernel_spans"] - base,
        "kernel_span_cost_pct": 100.0 * (med["kernel_spans"] - base) / base,
        "times_ms": times, "events": len(events), "span_counts": dict(kinds),
        "ab_spans": sorted(names - set(KTRACED)),
        "ab_kernel_spans": len(ab), "promotions": promotions,
        "emit_us": emit_us, "sample_us": sample_us,
        "metrics_checked": checked,
        "statusz_queries_completed": statusz.get("queries_completed"),
        "seconds": time.perf_counter() - t_phase})


def emit_costs(root, n=2000):
    """Host microseconds per `Tracer.emit` of one small event, for each
    shape a session's tracer takes (a file tracer with no sink, a private
    metrics sink alone, a private flight ring alone), and per memory
    sample (`memwatch.device_bytes_per_device`, the allocator's stats):
    where the tracer's cost on a query comes from."""
    from nds_tpu_torch.obs import flight as FL
    from nds_tpu_torch.obs import metrics as TM
    from nds_tpu_torch.obs import memwatch as MW
    from nds_tpu_torch.obs import trace as TOT

    shapes = {
        "file": TOT.Tracer(os.path.join(root, "emit_cost"), ring=False),
        "sink": TOT.Tracer(None, sink=TM.MetricsSink(), collect=False,
                           ring=False),
        "ring": TOT.Tracer(None, collect=False,
                           ring=FL.FlightRecorder()),
    }
    out = {}
    for name, tr in shapes.items():
        t = time.perf_counter()
        for _ in range(n):
            tr.emit("plan_cache", node="Aggregate", hit=False)
        out[name] = (time.perf_counter() - t) / n * 1e6
        tr.close()
    t = time.perf_counter()
    for _ in range(n // 10):
        MW.device_bytes_per_device()
    return out, (time.perf_counter() - t) / (n // 10) * 1e6


def obs_stream(trace, summaries, names, card_bytes):
    """Leg A's kernels-on stream, traced (engine.trace_dir and
    engine.flight_recorder=on in its property file): cli/profile.py's
    `main`, in this process, over its trace directory with --json, with
    --critical-path --json and with --check must each exit 0; every
    completed statement must have a `query_span` Completed and at least
    one `op_span`; every summary a memoryHighWater above 0 and at most the
    card's memory. Emits the `obs_stream` line with each statement's
    critical-path attributed share (printed, not gated: op_span wall is
    host dispatch time on CUDA, ROADMAP.md queue 3) and returns it."""
    from nds_tpu_torch.cli import profile as TPROF
    from nds_tpu_torch.obs import reader as TR

    t0 = time.perf_counter()

    def cli(*args):
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                TPROF.main([trace, *args])
        except SystemExit as exc:
            if exc.code:
                fail(f"obs_stream: profile {' '.join(args)} exited "
                     f"{exc.code}: {buf.getvalue()[-2000:]}")
        return buf.getvalue()

    prof = json.loads(cli("--json"))
    crit = json.loads(cli("--critical-path", "--json"))
    cli("--check")
    events = TR.read_events(trace, strict=True)
    spans = collections.Counter(e.get("query") for e in events
                                if e["kind"] == "op_span")
    status = {e["query"]: e["status"] for e in events
              if e["kind"] == "query_span"}
    completed = [q for q in names if summaries[q]["queryStatus"][0]
                 in ("Completed", "CompletedWithTaskFailures")]
    for q in completed:
        if status.get(q) != summaries[q]["queryStatus"][0]:
            fail(f"obs_stream: {q}'s query_span {status.get(q)} against "
                 f"its summary {summaries[q]['queryStatus']}")
        if not spans[q]:
            fail(f"obs_stream: {q} has no op_span")
    hw = {q: s.get("memoryHighWater", {}).get("bytes")
          for q, s in summaries.items()}
    bad = {q: b for q, b in hw.items() if not b or b > card_bytes}
    if bad:
        fail(f"obs_stream: memoryHighWater outside (0, {card_bytes}]: {bad}")
    return emit({
        "phase": "obs_stream", "run": "A_on",
        "statements": len(names), "completed": len(completed),
        "events": len(events),
        "span_counts": dict(collections.Counter(e["kind"] for e in events)),
        "attributed_share": {q: r.get("attributed_frac")
                             for q, r in crit["queries"].items()},
        "profile_queries": sorted(prof["queries"]),
        "memory_high_water_gib": {q: b / 2**30 for q, b in hw.items()},
        "memory_source": sorted({s.get("memoryHighWater", {}).get("source")
                                 for s in summaries.values()}),
        "seconds": time.perf_counter() - t0})


def flight_bundle_check(flight_dir, query, kind):
    """The failure bundle of `query` in `flight_dir`: `cli/profile.py
    --check <bundle>` must exit 0, its ring hold a `ladder_rung` of
    `kind` for the query and its plan section the query's plan note.
    Returns a summary for the caller's line."""
    from nds_tpu_torch.cli import profile as TPROF
    from nds_tpu_torch.obs import flight as FL

    paths = sorted(os.path.join(flight_dir, f) for f in os.listdir(flight_dir)
                   if FL.is_bundle_path(f)) if os.path.isdir(flight_dir) \
        else []
    mine = [p for p in paths if FL.read_bundle(p).get("query") == query]
    if not mine:
        fail(f"flight: no failure bundle of {query} in {paths}")
    path = mine[-1]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            TPROF.main(["--check", path])
    except SystemExit as exc:
        if exc.code:
            fail(f"flight: profile --check {path} exited {exc.code}: "
                 f"{buf.getvalue()[-2000:]}")
    bundle = FL.read_bundle(path)
    rungs = [e for e in bundle["events"] if e["kind"] == "ladder_rung"
             and e.get("query") == query]
    if not any(e.get("failure_kind") == kind for e in rungs):
        fail(f"flight: {query}'s bundle has no {kind} ladder_rung")
    plan = bundle.get("plan")
    if not plan or "Scan" not in json.dumps(plan):
        fail(f"flight: {query}'s bundle holds no plan note: {plan!r:.300}")
    return {"bundle": os.path.basename(path), "reason": bundle["reason"],
            "events": len(bundle["events"]),
            "rungs": [e["rung"] for e in rungs],
            "failure_kinds": sorted({e.get("failure_kind") for e in rungs})}


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# serve: the query service, the fleet router and the tcp catalog
# ---------------------------------------------------------------------------

#: the client threads of the serve step, and what they send: each query of
#: the main path SERVE_REPEATS times (then once more alone, warm)
SERVE_CLIENTS = 4
SERVE_REPEATS = 2
#: the refused query answered 429 with its modeled peak
SERVE_REFUSED = "q93"
#: rows of the lakehouse table committed through the tcp catalog
SERVE_LAKE_ROWS = 4096
#: rows the INSERT through the service appends (v < SERVE_INSERT_ROWS)
SERVE_INSERT_ROWS = 100
#: every client call's timeout, seconds
SERVE_TIMEOUT_S = 120


def http_post(port, payload, path="/query", tenant="chip", headers=None):
    """POST JSON to 127.0.0.1:port; (status, body, headers, ms)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", "X-NDS-Tenant": tenant,
                 **(headers or {})}, method="POST")
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as r:
            status, data, hdrs = r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        status, data, hdrs = e.code, e.read(), dict(e.headers)
    ms = (time.perf_counter() - t) * 1e3
    try:
        body = json.loads(data.decode())
    except ValueError:
        body = {}
    return status, body, hdrs, ms


def served_table(body, ref):
    """A served page as an Arrow table of `ref`'s types: JSON carries
    decimals and dates as strings, ints and float64s as numbers."""
    import datetime
    import decimal

    import pyarrow as pa

    cols = list(zip(*body["rows"])) if body["rows"] else [
        () for _ in body["columns"]]
    arrays = []
    for name, vals in zip(body["columns"], cols):
        typ = ref.schema.field(name).type
        if pa.types.is_decimal(typ):
            vals = [None if v is None else decimal.Decimal(v) for v in vals]
        elif pa.types.is_date(typ):
            vals = [None if v is None else datetime.date.fromisoformat(v)
                    for v in vals]
        arrays.append(pa.array(list(vals), type=typ))
    return pa.table(arrays, names=list(body["columns"]))


def check_served(q, status, body, ref):
    """A served answer against the main path's in-process one: the page
    equals the first rows of `ref` (ints, decimals, dates and strings
    exactly; q3's sums within check_q3's rtol, minmax's extremes within
    the slice's), and the total row count is `ref`'s."""
    if status != 200 or body.get("status") != "completed":
        fail(f"serve: {q} answered {status}: {body.get('error')}")
    if body["total_rows"] != ref.num_rows:
        fail(f"serve: {q} total_rows {body['total_rows']} against "
             f"{ref.num_rows} in process")
    if body["columns"] != ref.schema.names:
        fail(f"serve: {q} columns {body['columns']}")
    for row in body["rows"]:
        for v in row:
            # every float of the envelope comes from a float64
            if isinstance(v, float) and float(np.float64(v)) != v:
                fail(f"serve: {q} float {v!r} is not a float64")
    got = served_table(body, ref)
    want = ref.slice(0, got.num_rows)
    if q == "q3":
        if body["truncated"]:
            fail("serve: q3's page is truncated")
        ref_groups = q3_groups(ref)
        if not ref_groups:
            fail("serve: q3 has no groups to serve")
        rtol = f32_sum_rtol(max(n for _, n in ref_groups.values()))
        return same_groups(q3_groups(got), ref_groups, rtol, "served")
    return same_result(got, want, 2.0**-23 if q == "minmax" else 0.0,
                       f"serve: {q} against in process")


def serve_step(torch, GK, Session, tables, dev, on, answers, seed):
    """The query service, the fleet router and the tcp catalog over the
    main path's SF100 tables (no new load), each on a listener of its own
    on 127.0.0.1:

    * a QueryService (engine.serve_workers=2) over a session of `on` that
      registers the device `tables`: SERVE_CLIENTS client threads POST
      q3, minmax and order SERVE_REPEATS times each, then each query goes
      once more alone (warm); every answer must equal the main path's
      in-process one (`answers`, check_served).
      SERVE_REFUSED must answer 429 with its modeled peak and never run;
      with both slots held a third request must shed with Retry-After; a
      /stream job of the three statements must complete (GET /jobs/<id>),
      and its re-submission re-run none of them; /drain ends the service;
    * a CatalogCoordinator over a lakehouse table of SERVE_LAKE_ROWS rows
      written here: the service's writer session
      (engine.lake_catalog=http://...) INSERTs through /query;
    * a QueryRouter over two replicas (each its own session over the same
      tables, engine.serve_workers=1): q3 x4 through the router, one
      replica drained after the first two, so a request fails over to
      the other; SERVE_REFUSED shed at the edge with 429; the other
      replica reads the inserted rows back, and its pinned lease keeps
      its files through a vacuum until it is released.

    Kernel launches are zeroed at the step's start and read at its end:
    each kernel must have launched. Emits the `serve` line and returns
    the launches."""
    import pyarrow as pa

    from nds_tpu_torch.lakehouse import catalog as TC
    from nds_tpu_torch.lakehouse.leases import LEASES
    from nds_tpu_torch.lakehouse.table import LakehouseTable
    from nds_tpu_torch.obs import httpserv as THS
    from nds_tpu_torch.obs import metrics as TM
    from nds_tpu_torch.serve.router import QueryRouter
    from nds_tpu_torch.serve.service import QueryService

    t_phase = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    GK.reset_launches()
    root = tempfile.mkdtemp(prefix="nds_serve_")
    servers, services, routers = [], [], []
    statuses = collections.Counter()
    labels = collections.Counter()  # the envelopes' `status`
    served_ms = collections.defaultdict(list)
    worst = {}
    out = {"phase": "serve", "query_sql": sorted(QUERIES),
           "clients": SERVE_CLIENTS, "repeats": SERVE_REPEATS}

    def listen(app):
        srv = THS.MetricsServer(TM.shared_sink(), 0, host="127.0.0.1")
        srv.attach_app(app)
        srv.start()
        servers.append(srv)
        return srv.port

    def session(conf, lake):
        s = Session(conf=conf, device=dev)
        for name, t in tables.items():
            s.register_table(name, t)
        s.register_lakehouse("lake_t", lake)
        return s

    def count(status, body=None):
        statuses[str(status)] += 1
        if body is not None:
            labels[str(body.get("status"))] += 1
        return status

    try:
        # -- the tcp catalog over a lakehouse table written here ---------
        lake = os.path.join(root, "lake_t")
        rng = np.random.default_rng(seed)
        LakehouseTable.create(lake, pa.table({
            "k": pa.array(np.arange(SERVE_LAKE_ROWS) % 16, type=pa.int64()),
            "v": pa.array(np.arange(SERVE_LAKE_ROWS), type=pa.int64()),
            "w": pa.array(rng.integers(0, 1000, SERVE_LAKE_ROWS),
                          type=pa.int64())}))
        coord = TC.CatalogCoordinator()
        cat_url = f"http://127.0.0.1:{listen(coord)}"
        TC.reset_clients()
        lake_conf = {**on, "engine.lake_catalog": cat_url}

        # -- the query service --------------------------------------------
        svc = QueryService(
            session({**lake_conf, "engine.serve_workers": 2}, lake),
            writer_session=session(lake_conf, lake),
            job_dir=os.path.join(root, "jobs"))
        services.append(svc)
        if svc.workers != 2:
            fail(f"serve: {svc.workers} workers, not 2")
        port = listen(svc)
        peak_in_flight = [0]
        enter = svc._enter

        def counted_enter(tenant, rid=None):
            enter(tenant, rid)
            peak_in_flight[0] = max(peak_in_flight[0], svc.in_flight())

        svc._enter = counted_enter
        work = [q for q in QUERIES for _ in range(SERVE_REPEATS)]
        lock = threading.Lock()

        def client(i):
            while True:
                with lock:
                    if not work:
                        return
                    q = work.pop(0)
                status, body, _, ms = http_post(
                    port, {"sql": QUERIES[q]}, tenant=f"client{i}")
                with lock:
                    count(status, body)
                    served_ms[q].append(ms)
                    worst[q] = max(worst.get(q, 0.0),
                                   check_served(q, status, body, answers[q]))

        threads = [Beside(client, i) for i in range(SERVE_CLIENTS)]
        for t in threads:
            t.join()
        out["in_flight_peak"] = peak_in_flight[0]
        # the client threads' walls hold the session's first statements
        # and the admission queue; then one warm request at a time
        for q in QUERIES:
            status, body, _, ms = http_post(port, {"sql": QUERIES[q]},
                                            tenant="warm")
            count(status, body)
            served_ms[f"{q}_warm"].append(ms)
            worst[q] = max(worst[q], check_served(q, status, body,
                                                  answers[q]))

        # the refused query: 429 with its modeled peak, planned in its
        # slot and never run
        before = dict(GK.LAUNCHES)
        status, body, _, _ = http_post(port, {
            "sql": phase_sql(SERVE_REFUSED)})
        count(status, body)
        if status != 429 or body.get("verdict") != "reject":
            fail(f"serve: {SERVE_REFUSED} answered {status} {body}")
        if dict(GK.LAUNCHES) != before or svc.in_flight():
            fail(f"serve: the refused {SERVE_REFUSED} ran")
        out["refused"] = {"query": SERVE_REFUSED, "status": status,
                          "modeled_peak_gib": body["peak_bytes"] / 2**30,
                          "budget_gib": body["budget_bytes"] / 2**30}

        # a third request while both slots are held: shed, Retry-After
        svc._enter("hold-1")
        svc._enter("hold-2")
        admit_s, svc.admit_timeout_s = svc.admit_timeout_s, 0.05
        try:
            status, body, hdrs, _ = http_post(port, {"sql": QUERIES["q3"]},
                                              tenant="third")
        finally:
            svc.admit_timeout_s = admit_s
            svc._leave("hold-1")
            svc._leave("hold-2")
        count(status, body)
        if status != 429 or body.get("status") != "shed" or not hdrs.get(
                "Retry-After"):
            fail(f"serve: the third concurrent request answered {status} "
                 f"{body} {hdrs.get('Retry-After')}")
        out["shed"] = {"status": status, "retry_after": hdrs["Retry-After"],
                       "error": body["error"]}

        # DML through /query: the writer session commits through the tcp
        # catalog
        status, body, _, _ = http_post(port, {
            "sql": f"insert into lake_t select k, v + {SERVE_LAKE_ROWS}, w "
                   f"from lake_t where v < {SERVE_INSERT_ROWS}"},
            tenant="writer")
        count(status, body)
        if status != 200 or body.get("rows_affected") != SERVE_INSERT_ROWS:
            fail(f"serve: the INSERT answered {status} {body}")
        with open(os.path.join(lake, "_manifests",
                               f"v{body['version']:06d}.json")) as f:
            txid = json.load(f).get("txid")
        if not txid:
            fail("serve: the INSERT's manifest carries no coordinator txid")
        out["insert"] = {"version": body["version"],
                         "rows_affected": body["rows_affected"]}

        # a stream job of the three statements, then its re-submission
        stream = stream_file(os.path.join(root, "query_0.sql"),
                             [(q, [QUERIES[q]]) for q in QUERIES])

        def job(job_id):
            status, body, _, _ = http_post(
                port, {"stream": stream, "job_id": job_id}, path="/stream")
            if status != 202:
                fail(f"serve: /stream answered {status} {body}")
            deadline = time.monotonic() + SERVE_TIMEOUT_S
            while True:
                state = json.loads(scrape(port, f"/jobs/{job_id}"))
                if state["state"] in ("completed", "failed", "paused"):
                    return state
                if time.monotonic() > deadline:
                    fail(f"serve: job {job_id} still {state['state']}")
                time.sleep(0.05)

        first = job("chip")
        if first["state"] != "completed" or first["completed"] != len(
                QUERIES):
            fail(f"serve: the stream job ended {first}")
        launched = dict(GK.LAUNCHES)
        second = job("chip")
        if second["queries"] != first["queries"] or (
                dict(GK.LAUNCHES) != launched):
            fail("serve: the re-submitted job re-ran statements")
        out["job"] = {"state": first["state"], "completed":
                      first["completed"], "resumed_state": second["state"],
                      "ms": {n: r["ms"] for n, r in first["queries"].items()}}

        status, body, _, _ = http_post(port, {}, path="/drain")
        after, after_body, _, _ = http_post(port, {"sql": QUERIES["q3"]})
        if status != 200 or not body.get("drained") or after != 503:
            fail(f"serve: /drain answered {status} {body}, then {after}")
        out["drain"] = {"drained": body["drained"],
                        "in_flight": body["in_flight"], "after": after}
        count(after, after_body)
        svc.session.catalog.invalidate("lake_t")
        svc.writer_session.catalog.invalidate("lake_t")
        services.remove(svc)
        del svc

        # -- the fleet router over two replicas ---------------------------
        reps = []
        for _ in range(2):
            s = QueryService(session({**lake_conf,
                                      "engine.serve_workers": 1}, lake))
            services.append(s)
            reps.append((s, listen(s)))
        router = QueryRouter(
            [f"127.0.0.1:{p}" for _, p in reps],
            conf={"engine.route_health_interval_s": 0})
        routers.append(router)
        rport = listen(router)
        routed = []

        def route_q3():
            status, body, _, ms = http_post(rport, {"sql": QUERIES["q3"]},
                                            tenant="fleet")
            check_served("q3", status, body, answers["q3"])
            with lock:
                count(status, body)
                routed.append(body["route"])
                served_ms["q3_routed"].append(ms)

        pair = [Beside(route_q3) for _ in range(2)]
        for t in pair:
            t.join()
        # the first replica drains; the router still picks it next
        drained_port = reps[0][1]
        status, body, _, _ = http_post(drained_port, {}, path="/drain")
        if status != 200 or not body.get("drained"):
            fail(f"serve: replica drain answered {status} {body}")
        router._rr = [r.name for r in router.replicas].index(
            f"127.0.0.1:{drained_port}")
        for _ in range(2):
            route_q3()
        failovers = sum(1 for r in routed if r["attempts"] > 1)
        if failovers < 1 or any(
                r["replica"] == f"127.0.0.1:{drained_port}"
                for r in routed[2:]):
            fail(f"serve: no failover from the drained replica: {routed}")
        out["router"] = {"routed": len(routed), "failovers": failovers,
                         "attempts": [r["attempts"] for r in routed]}

        status, body, hdrs, _ = http_post(rport, {
            "sql": phase_sql(SERVE_REFUSED)}, tenant="fleet")
        count(status, body)
        if status != 429 or body.get("verdict") != "reject" or not hdrs.get(
                "Retry-After"):
            fail(f"serve: the router answered {SERVE_REFUSED} {status}")
        if "route" in body:
            fail("serve: the refused query reached a replica")
        out["router"]["refused"] = {
            "status": status, "at": "edge",
            "modeled_peak_gib": body["peak_bytes"] / 2**30}

        # the other replica reads the inserted rows back
        read = {"sql": "select count(*) c, sum(v) s from lake_t"}
        status, body, _, _ = http_post(rport, read, tenant="reader")
        count(status, body)
        n = SERVE_LAKE_ROWS + SERVE_INSERT_ROWS
        want = sum(range(SERVE_LAKE_ROWS)) + sum(
            v + SERVE_LAKE_ROWS for v in range(SERVE_INSERT_ROWS))
        if status != 200 or body["rows"] != [[n, want]] or (
                body["route"]["replica"] == f"127.0.0.1:{drained_port}"):
            fail(f"serve: read-back answered {status} {body}")
        reader = reps[1][0].session
        lease = reader.catalog.entries["lake_t"].lease_id
        held = TC.resolve_catalog(lake_conf).held_files(
            LakehouseTable(lake))
        if lease is None or not held:
            fail("serve: the reader's pin registered no lease at the "
                 "coordinator")
        # a replace and a vacuum: the pinned reader's files stay
        lt = LakehouseTable(lake, conf=lake_conf)
        lt.replace(pa.table({"k": pa.array([0], type=pa.int64()),
                             "v": pa.array([0], type=pa.int64()),
                             "w": pa.array([0], type=pa.int64())}))
        kept = lt.vacuum(retain_last=1)["files_removed"]
        reader.catalog.invalidate("lake_t")  # releases the lease
        if lease in LEASES._leases:
            fail("serve: the reader's lease outlived its pin")
        removed = lt.vacuum(retain_last=1)["files_removed"]
        if kept != 0 or removed < 1:
            fail(f"serve: vacuum removed {kept} files under the lease, "
                 f"{removed} after it")
        status, body, _, _ = http_post(rport, read, tenant="reader")
        count(status, body)
        if status != 200 or body["rows"] != [[1, 0]]:
            fail(f"serve: the replaced table read {status} {body}")
        out["catalog"] = {"insert_version": out.pop("insert"),
                          "txid": txid, "read_back_rows": n,
                          "lease_files": len(held),
                          "vacuum_removed_leased": kept,
                          "vacuum_removed_released": removed}
        router.close()
        for s, _ in reps:
            s.session.catalog.invalidate("lake_t")
    finally:
        for r in routers:
            r.close()
        for s in services:
            s.close()
        stops = [Beside(srv.stop) for srv in servers]
        for t in stops:
            t.join()
        TC.reset_clients()
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(GK.LAUNCHES)
    for name, n_launch in launches.items():
        if n_launch == 0:
            fail(f"serve: kernel {name} was not launched")
    if cuda:
        torch.cuda.synchronize(dev)
    out.update({
        "served_ms": {q: float(np.median(v)) for q, v in served_ms.items()},
        "served_runs": {q: len(v) for q, v in served_ms.items()},
        "max_rel_vs_in_process": worst, "statuses": dict(statuses),
        "envelopes": dict(labels), "sheds": labels["shed"],
        "http_429": statuses["429"],
        "launches": launches,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                     if cuda else None),
        "seconds": time.perf_counter() - t_phase})
    emit(out)
    return launches



def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of SF100 row counts (1.0 = SF100)")
    args = ap.parse_args(argv)
    # every line goes to this stdout, also one emitted on a thread while a
    # step redirects stdout to a CLI's log
    _OUT[:] = [sys.stdout]

    # a plan-budgeter fault fails the statement instead of being recorded
    # as verdict "error"
    os.environ["NDS_PLAN_BUDGET_STRICT"] = "1"
    # one persistent cache of fused builds and promotion verdicts for this
    # process and every process it starts, in a directory of its own
    aot_dir = tempfile.mkdtemp(prefix="nds_aot_")
    atexit.register(shutil.rmtree, aot_dir, True)
    os.environ["NDS_AOT_CACHE_DIR"] = aot_dir
    # the flight recorder's failure bundles of this process and its
    # children, where no conf names a directory: one of the script's own
    flight_dir = tempfile.mkdtemp(prefix="nds_flight_")
    atexit.register(shutil.rmtree, flight_dir, True)
    os.environ["NDS_FLIGHT_DIR"] = flight_dir
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    if not os.path.isdir(os.path.join(ROOT, "nds_tpu_torch")):
        fail(f"no nds_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    from nds_tpu_torch.analysis import budget as B
    from nds_tpu_torch.engine.session import Session, resolve_device
    from nds_tpu_torch.ops import _build
    from nds_tpu_torch.ops import gpu_kernels as GK

    # the package makes the allocator's expandable segments hold (SF100
    # leaves little room for fragmentation): before any other CUDA call
    dev = resolve_device("cuda:0")

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
    probe = torch.empty(1 << 20, device=dev)
    expandable = [seg.get("is_expandable")
                  for seg in torch.cuda.memory_snapshot()]
    del probe
    print(smi_line, flush=True)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi_line,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "pyarrow": has_pyarrow,
          "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"),
          "segments_expandable": expandable})
    if not expandable or False in expandable:
        fail(f"the allocator's segments are not expandable: {expandable}")
    lines = B.budget_lines(dev)
    emit({"phase": "budget_lines",
          "total_memory": torch.cuda.get_device_properties(dev).total_memory,
          "working_set_bytes": B.resolve_budget_bytes({}, dev),
          "reject_bytes": B.resolve_reject_bytes({}, dev),
          "catalog_bytes": B.resolve_catalog_bytes(dev),
          "card_lines_gib": {k: v / 2**30 for k, v in
                             vars(lines).items()}})

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
    rows = {k: next(iter(v.values())).shape[0] for k, v in star.items()}
    reduced = [] if args.scale >= 1.0 else [
        f"row counts x{args.scale} of SF100 (--scale)"]
    resident = torch.cuda.memory_allocated(dev) / 2**30
    window_gib = window_columns_bytes(star) / 2**30
    emit({"phase": "data", "scale": "TPC-DS SF100", "rows": rows,
          "reduced": reduced, "seed": args.seed, "numpy_s": gen_s,
          "load_s": time.perf_counter() - t0, "resident_gib": resident,
          "window_columns_gib": window_gib,
          "resident_with_window_columns_gib": resident + window_gib})

    # -- slice -----------------------------------------------------------
    on = {f"engine.pallas_{k}": "on" for k in ("agg", "join", "sort")}
    off = {f"engine.pallas_{k}": "off" for k in ("agg", "join", "sort")}
    # the in-process SF100 phases measure steady time: their sessions run
    # with the plan cache off (STEADY); the CLI phases keep every default
    on_steady = {**on, **STEADY}
    off_steady = {**off, **STEADY}
    s_on = Session(conf=on_steady)
    s_off = Session(conf=off_steady, device="cuda")
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

    refused = {q: refusal(B, s_on, QUERIES[q]) for q in QUERIES}

    def run(session, q):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with admitted(session, refused[q]):
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
    # per query, the check of a result with the kernels on against the
    # phase's references, to the phase's tolerance (the power phase holds
    # its results to them)
    checks = {}
    for q in QUERIES:
        res, cold_ms = cold[q]
        torch.cuda.synchronize()
        # the allocator gap of budget_record is read from an emptied cache
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        steady = [run(s_on, q)[1] for _ in range(STEADY_RUNS)]
        budget = budget_record(
            B, s_on, torch.cuda.max_memory_allocated(dev) - before, dev,
            refused[q])
        got_off, off_ms = run(s_off, q)
        if q == "q3":
            ref_off = q3_groups(got_off)
            rtol = f32_sum_rtol(max(n for _, n in ref_off.values()))
            ref_np = q3_reference(star)

            def check(r, ref_off=ref_off, rtol=rtol, ref_np=ref_np):
                check_q3(r, ref_np, "vs numpy")
                return same_groups(q3_groups(r), ref_off, rtol, "on vs off")
        else:
            # minmax: f64 -> f32 rounding of the extreme value; order: exact
            rtol = 2.0**-23 if q == "minmax" else 0.0
            check = functools.partial(same_result, b=got_off, rtol=rtol,
                                      tag=f"{q} on vs off")
        worst = check(res)
        checks[q] = check
        rec = {"phase": "query", "query": q, "rows": res.num_rows,
               "cold_ms": cold_ms, "steady_ms": float(np.median(steady)),
               "off_ms": off_ms,
               "fact_rows_per_s": n_fact / (float(np.median(steady)) / 1e3),
               "launches": per_query[q], "max_rel_vs_off": worst,
               "rtol": rtol, "budget": budget, "refusal": refused[q]}
        if q == "q3":
            rec["max_rel_vs_numpy"], rec["rtol_numpy"] = check_q3(
                res, ref_np, "vs numpy")
            if res.num_rows == 0:
                fail("q3 returned no groups")
        if q == "order" and res.num_rows == 0:
            fail("the ORDER BY query returned no rows")
        results[q] = rec
        emit(rec)
    emit({"phase": "slice", "launches": launches, "peak_gib": peak,
          "steady_runs": STEADY_RUNS, "reduced": STEADY_CUT})

    # -- obs (the observability layer over q3) ----------------------------
    obs_q3(torch, Session, tables, dev, on_steady, refused["q3"])
    gc.collect()
    torch.cuda.empty_cache()

    # -- serve (the query service, the fleet router, the tcp catalog) -----
    serve_launches = serve_step(torch, GK, Session, tables, dev, on_steady,
                                {q: cold[q][0] for q in QUERIES}, args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    # -- profile ---------------------------------------------------------
    for q in QUERIES:
        emit(profile_query(torch, lambda q=q: run(s_on, q), q))

    # -- kernels ---------------------------------------------------------
    kernels = kernel_rows(torch, GK, captured, launches)
    for rec in kernels:
        rec["serve_launches"] = serve_launches[rec["name"]]

    del captured
    torch.cuda.empty_cache()

    # -- joins -------------------------------------------------------------
    from nds_tpu_torch.engine import exec as TX

    # (the registration loop's variables hold s_off and a table too)
    del s_on, s_off, s, t
    # the stream legs' data and Load Tests (host processes) from here on,
    # beside the SF100 phases, whose queries keep the card busy
    started = stream_start(args.scale)
    # the lakehouse phase's Load Tests (host processes) from the end of leg
    # A's, beside the SF100 phases: lake_loads on a thread, which starts the
    # maintenance phase's Load Test once leg A's lakehouse is written
    lake_ctx = {"root_a": os.path.join(started["root"], "A"),
                "raw_a": started["raw_A"], "sf_a": started["sf_a"],
                "root_b": os.path.join(started["root"], "B"),
                "raw_b": started["raw_B"]}

    def lake_prep():
        started["load_A"][0].wait()
        return lake_loads(lake_ctx, after_load=lambda: start_maintenance_load(
            lake_ctx, started["procs"]), procs=started["procs"])

    lake_loaded = Beside(lake_prep)
    # and each leg's Load Test finished (its stream 0 generated) there too
    started["legs"] = Beside(finish_legs, started)
    joined, join_launches = joins_phase(torch, GK, TX, B, Session, star,
                                        tables, dev, on_steady, off_steady,
                                        rows, checks)
    for rec in kernels:
        rec["joins_launches"] = join_launches[rec["name"]]
    # the whole benchmark's host phases from here on, beside the SF100
    # phases: a process of its own that dies at power_test (bench_phase)
    bench_sf = max(0.01, BENCH_SF * min(1.0, args.scale))
    bench_st = bench_start(tempfile.mkdtemp(prefix="nds_bench_"), bench_sf,
                           BENCH_STREAMS, on, BENCH_TEMPLATES)
    atexit.register(stop_bench, bench_st)

    # -- windows -----------------------------------------------------------
    torch.cuda.empty_cache()
    windowed, window_launches, fuse_q5_rec = windows_phase(
        torch, GK, TX, B, Session, star, tables, dev, on_steady, off_steady,
        rows, args.scale, checks)
    for rec in kernels:
        rec["windows_launches"] = window_launches[rec["name"]]

    # -- fuse ----------------------------------------------------------------
    torch.cuda.empty_cache()
    emit(fuse_q5_rec)
    fuse_phase(torch, TX, B, Session, star, tables, dev, on, rows, checks,
               fuse_q5_rec)

    # -- spill -------------------------------------------------------------
    torch.cuda.empty_cache()
    spill_launches = spill_phase(torch, GK, TX, B, Session, tables, dev,
                                 on_steady)
    for rec in kernels:
        rec["spill_launches"] = spill_launches[rec["name"]]

    # -- maintenance_sf100 (DF_SS's survivor query over the SF100 tables) --
    torch.cuda.empty_cache()
    maintenance_sf100(torch, GK, TX, B, Session, star, tables, dev,
                      on_steady)

    # -- budget_refusals / device_memory -----------------------------------
    lines_all = {**results, **joined, **windowed}
    emit({"phase": "budget_refusals",
          "refused": {q: r["refusal"] for q, r in lines_all.items()
                      if r["refusal"]},
          "admitted": sorted(q for q, r in lines_all.items()
                             if not r["refusal"]),
          "ran_refused_under": f"engine.plan_budget={REFUSED_MODE}"})
    gaps = {q: r["budget"]["allocator_gap_gib"] for q, r in lines_all.items()}
    free, total = torch.cuda.mem_get_info(dev)
    emit({"phase": "device_memory", "total_memory": total,
          # what the CUDA runtime holds outside the caching allocator (the
          # context, the loaded kernels): budget_lines' runtime headroom
          "runtime_bytes": total - free - torch.cuda.memory_reserved(dev),
          # the allocator's largest gap (peak reserved less peak allocated)
          # at a query's steady runs: budget_lines' allocator headroom
          "allocator_gap_max_gib": max(gaps.values()),
          "allocator_gap_gib": gaps})

    # -- power -------------------------------------------------------------
    # the stream reads the star back from parquet: the device tables and,
    # once it is written, the numpy star go (the earlier phases' sessions
    # hold them in reference cycles until the collector runs)
    del tables
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="nds_power_")
    try:
        wh = os.path.join(root, "warehouse")
        emit({"phase": "warehouse", "reduced": reduced,
              **write_warehouse(star, wh)})
        del star
        power_launches = power_phase(torch, GK, dev, root, wh, checks,
                                     lines_all, on, reduced)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for rec in kernels:
        rec["power_launches"] = power_launches[rec["name"]]

    # -- bench (the whole benchmark, resumed after its crash) and the fuse
    # phase's cache round trip, on threads beside the stream phase: their
    # processes hold a few GiB of the card at most ---------------------------
    gc.collect()
    torch.cuda.empty_cache()
    bench = Beside(bench_phase, bench_st, ("cuda", kind), reduced + [
        f"SF{bench_sf} with {BENCH_STREAMS} streams (made for SF"
        f"{BENCH_MADE_FOR['sf']} with {BENCH_MADE_FOR['streams']}: "
        "tools/torch_bench_phase.py)",
        f"the Power and Throughput Tests over {','.join(BENCH_TEMPLATES)} "
        "(sub_queries; the time limit)",
        "maintenance under load off (the maintenance phase runs it)"],
        True, "the stream phase and the fuse phase's cache round trip")
    trip_root = tempfile.mkdtemp(prefix="nds_fuse_")
    atexit.register(shutil.rmtree, trip_root, True)
    trip_procs = Procs()
    atexit.register(trip_procs.stop)
    trip = Beside(fuse_cache_round_trip, trip_root,
                  *fuse_cache_warehouse(trip_root, args.seed), trip_procs)

    # -- stream ------------------------------------------------------------
    # -- throughput (over leg A's warehouse, before it goes) --------------
    throughput = {}

    def then(root_a, wh_a, sf_a, a_on):
        throughput.update(throughput_phase(
            torch, GK, dev, root_a, wh_a, sf_a, on, off, a_on, reduced,
            templates=THROUGHPUT_TEMPLATES))

    # -- lakehouse (over both legs, after the throughput phase) -----------
    lakehouse = {}
    # -- maintenance (over leg B's data, after the lakehouse phase) -------
    maintenance = {}

    def lake(ctx):
        # the Load Tests ran beside the earlier phases (lake_prep); the
        # stream phase stops what still runs if a gate fails
        loaded = lake_loaded.join()
        lakehouse.update(lakehouse_phase(torch, GK, dev, ctx, on,
                                         loaded=loaded))
        gc.collect()
        torch.cuda.empty_cache()
        maintenance.update(maintenance_over_leg_b(
            torch, GK, dev, ctx, on, load=loaded["after_load"]))

    stream_a, stream_b = stream_phase(
        torch, GK, dev, on, off, args.scale, then=then, lake=lake,
        templates=STREAM_TEMPLATES, started=started)
    # the stream phase's directory (GBs) goes beside the last phases
    removal = Beside(shutil.rmtree, started["root"], True)
    for rec in kernels:
        rec["stream_a_launches"] = stream_a[rec["name"]]
        rec["stream_b_launches"] = stream_b[rec["name"]]
        rec["throughput_launches"] = throughput[rec["name"]]
        rec["lakehouse_launches"] = lakehouse[rec["name"]]
        rec["maintenance_launches"] = maintenance[rec["name"]]

    # -- bench and the cache round trip, ended ----------------------------
    bench.join()
    stop_bench(bench_st)
    emit(trip.join())
    shutil.rmtree(trip_root, ignore_errors=True)

    # -- explain -----------------------------------------------------------
    explain_phase(dev)

    # -- kernel_sweep ------------------------------------------------------
    torch.cuda.empty_cache()
    kernel_sweep(torch, GK, dev, args.seed, min(1.0, args.scale))
    removal.join()

    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
