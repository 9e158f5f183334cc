"""Throughput Test CLI of the port (reference: nds/nds-throughput:18-23;
the arguments of nds_tpu/cli/throughput.py):

    python -m nds_tpu_torch.cli.throughput <input_prefix> <stream_dir>
        <streams> <time_log_base> [--input_format parquet|csv|orc|lakehouse] [--floats]
        [--mode thread|process] [--sub_queries q1,q2] [--query_timeout S]
        [--device DEV] ...

`streams` is a comma-separated list of stream numbers, e.g. "1,2,3,4";
stream n reads <stream_dir>/query_<n>.sql and writes <time_log_base>_<n>.csv.
The streams' sessions run on the card (`--device` names another, e.g.
`cpu`).
"""

import argparse
import os

from ..check import check_version
from ..throughput import run_throughput


def main(argv=None):
    check_version()
    parser = argparse.ArgumentParser()
    parser.add_argument("input_prefix", help="warehouse root path")
    parser.add_argument("stream_dir", help="directory with query_<n>.sql files")
    parser.add_argument(
        "streams",
        help="comma separated stream numbers to run concurrently, e.g. 1,2",
    )
    parser.add_argument(
        "time_log_base",
        help="per-stream time logs are written to <base>_<n>.csv",
    )
    parser.add_argument(
        "--input_format",
        choices=["parquet", "csv", "orc", "lakehouse"],
        default="parquet",
        help="type of the input data source",
    )
    parser.add_argument("--property_file")
    parser.add_argument("--json_summary_folder")
    parser.add_argument("--output_prefix")
    parser.add_argument("--output_format", default="parquet")
    parser.add_argument("--floats", action="store_true")
    parser.add_argument(
        "--mode", choices=["thread", "process"], default="thread",
        help="stream concurrency: threads over independent sessions in one "
        "process, or one Power Run process per stream (the reference "
        "nds-throughput shape)",
    )
    parser.add_argument(
        "--sub_queries", type=lambda s: [x.strip() for x in s.split(",")],
        help="comma separated subset of queries to run in each stream",
    )
    parser.add_argument(
        "--query_timeout",
        type=float,
        help="per-query watchdog budget in seconds (a hung query becomes a "
        "classified 'timeout' failure instead of stalling the stream's Ttt "
        "window); also bounds process-mode child waits",
    )
    parser.add_argument(
        "--device",
        help="every stream session's device (default: the card, cuda)",
    )
    args = parser.parse_args(argv)
    nums = [int(s) for s in args.streams.split(",") if s.strip()]
    stream_paths = {
        n: os.path.join(args.stream_dir, f"query_{n}.sql") for n in nums
    }
    ttt = run_throughput(
        args.input_prefix,
        stream_paths,
        args.time_log_base,
        input_format=args.input_format,
        use_decimal=not args.floats,
        property_file=args.property_file,
        json_summary_folder=args.json_summary_folder,
        output_path=args.output_prefix,
        output_format=args.output_format,
        mode=args.mode,
        sub_queries=args.sub_queries,
        query_timeout=args.query_timeout,
        device=args.device,
    )
    print(f"====== Throughput Test Time: {ttt} seconds ======")


if __name__ == "__main__":
    main()
