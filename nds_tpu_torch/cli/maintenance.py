"""Data Maintenance CLI of the port (reference: nds/nds_maintenance.py
__main__ :273-316; the arguments of nds_tpu/cli/maintenance.py):

    python -m nds_tpu_torch.cli.maintenance <warehouse_path>
        <refresh_data_path> <time_log> [--maintenance_queries LF_CS,DF_CS]
        [--property_file F] [--json_summary_folder DIR] [--floats]
        [--vacuum] [--optimize] [--device DEV]

Maintenance-under-load mode: with `--under_load_stream <query_N.sql>` the
refresh functions run in a racing thread against that query stream,
measured as maintenance throughput and query p99 degradation
(`--under_load_report` gets the JSON). The sessions run on the card
(`--device` names another, e.g. `cpu`).
"""

import argparse

from ..check import check_version
from ..maintenance import run_maintenance, run_maintenance_under_load


def main(argv=None):
    check_version()
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "warehouse_path", help="lakehouse warehouse root to apply refreshes to"
    )
    parser.add_argument(
        "refresh_data_path", help="path to the generated refresh (--update) data"
    )
    parser.add_argument(
        "time_log", help="path to execution time log (CSV)", default=""
    )
    parser.add_argument(
        "--maintenance_queries",
        type=lambda s: s.split(","),
        help="comma separated maintenance function names, e.g. 'LF_CS,DF_CS'",
    )
    parser.add_argument(
        "--property_file", help="property file for engine configuration"
    )
    parser.add_argument(
        "--json_summary_folder",
        help="empty folder (created if missing) for per-function JSON summaries",
    )
    parser.add_argument(
        "--floats",
        action="store_true",
        help="use double instead of decimal for decimal-typed columns",
    )
    parser.add_argument(
        "--vacuum",
        action="store_true",
        help="expire old snapshots + delete unreferenced data files after "
        "the refresh functions (reader-lease safe)",
    )
    parser.add_argument(
        "--optimize",
        action="store_true",
        help="compact small data files after the refresh functions "
        "(bin-pack toward engine.lake_compact_target_bytes, zone maps "
        "regenerated; snapshot-isolated from concurrent readers)",
    )
    parser.add_argument(
        "--under_load_stream",
        help="query stream file to run CONCURRENTLY with the refresh "
        "functions (maintenance-under-load mode)",
    )
    parser.add_argument(
        "--under_load_report",
        help="JSON report path for maintenance-under-load metrics",
    )
    parser.add_argument(
        "--under_load_queries",
        type=lambda s: s.split(","),
        help="comma separated stream-query subset for under-load mode",
    )
    parser.add_argument(
        "--device",
        help="the sessions' device (default: the card, cuda)",
    )
    args = parser.parse_args(argv)
    if args.under_load_stream:
        run_maintenance_under_load(
            warehouse_path=args.warehouse_path,
            refresh_data_path=args.refresh_data_path,
            stream_file=args.under_load_stream,
            time_log_output_path=args.time_log,
            report_path=args.under_load_report,
            property_file=args.property_file,
            spec_queries=args.maintenance_queries,
            sub_queries=args.under_load_queries,
            use_decimal=not args.floats,
            device=args.device,
        )
        return
    run_maintenance(
        warehouse_path=args.warehouse_path,
        refresh_data_path=args.refresh_data_path,
        time_log_output_path=args.time_log,
        json_summary_folder=args.json_summary_folder,
        property_file=args.property_file,
        spec_queries=args.maintenance_queries,
        use_decimal=not args.floats,
        vacuum_after=args.vacuum,
        optimize_after=args.optimize,
        device=args.device,
    )


if __name__ == "__main__":
    main()
