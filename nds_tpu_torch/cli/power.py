"""Power Run CLI of the port (reference: nds/nds_power.py __main__
:309-384; the arguments of nds_tpu/cli/power.py):

    python -m nds_tpu_torch.cli.power <input_prefix> <query_stream_file> <time_log>
        [--input_format parquet|csv|orc|lakehouse] [--output_prefix DIR]
        [--output_format parquet|csv] [--property_file F] [--floats]
        [--json_summary_folder DIR] [--sub_queries q1,q2,...]
        [--extra_time_log F] [--query_timeout S] [--fault_spec SPEC]
        [--device DEV]

The session runs on the card (`--device` names another, e.g. `cpu`).
"""

import argparse

from ..check import check_version
from ..power import gen_sql_from_stream, run_query_stream


def main(argv=None):
    check_version()
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "input_prefix",
        help="text to prepend to every input file path (warehouse root)",
    )
    parser.add_argument(
        "query_stream_file",
        help="query stream file that contains NDS queries in specific order",
    )
    parser.add_argument(
        "time_log",
        help="path to execution time log (CSV), only local path supported",
        default="",
    )
    parser.add_argument(
        "--input_format",
        choices=["parquet", "csv", "orc", "lakehouse"],
        default="parquet",
        help="type of the input data source",
    )
    parser.add_argument(
        "--output_prefix",
        help="text to prepend to every output file; if absent, results are "
        "collected to host memory instead of written",
    )
    parser.add_argument(
        "--output_format", default="parquet", help="type of query output"
    )
    parser.add_argument(
        "--property_file", help="property file for engine configuration"
    )
    parser.add_argument(
        "--floats",
        action="store_true",
        help="use double instead of decimal for decimal-typed columns",
    )
    parser.add_argument(
        "--json_summary_folder",
        help="empty folder (created if missing) for per-query JSON summaries",
    )
    parser.add_argument(
        "--extra_time_log",
        help="extra path to save a copy of the time log",
    )
    parser.add_argument(
        "--mesh_devices",
        type=int,
        help="execute over an N-device mesh (not ported yet: raises)",
    )
    parser.add_argument(
        "--sub_queries",
        type=lambda s: [x.strip() for x in s.split(",")],
        help="comma separated list of queries to run, e.g. 'query1,query2'. "
        "Use _part1/_part2 suffixes for queries 14, 23, 24, 39.",
    )
    parser.add_argument(
        "--query_timeout",
        type=float,
        help="per-query watchdog budget in seconds: a query still running "
        "after this long is recorded as a classified 'timeout' failure and "
        "the stream moves on (conf engine.query_timeout; env "
        "NDS_QUERY_TIMEOUT)",
    )
    parser.add_argument(
        "--fault_spec",
        help="fault-injection spec (conf engine.fault_spec; env "
        "NDS_FAULT_SPEC), e.g. 'oom:query5:1;hang:query9:30'",
    )
    parser.add_argument(
        "--device",
        help="the session's device (default: the card, cuda)",
    )
    args = parser.parse_args(argv)
    if args.fault_spec:
        from .. import faults

        faults.install(args.fault_spec)
    query_dict = gen_sql_from_stream(args.query_stream_file)
    run_query_stream(
        input_prefix=args.input_prefix,
        property_file=args.property_file,
        query_dict=query_dict,
        time_log_output_path=args.time_log,
        extra_time_log_output_path=args.extra_time_log,
        sub_queries=args.sub_queries,
        input_format=args.input_format,
        use_decimal=not args.floats,
        output_path=args.output_prefix,
        output_format=args.output_format,
        json_summary_folder=args.json_summary_folder,
        mesh_devices=args.mesh_devices,
        query_timeout=args.query_timeout,
        device=args.device,
    )


if __name__ == "__main__":
    main()
