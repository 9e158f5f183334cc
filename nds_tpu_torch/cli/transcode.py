"""Transcode / Load Test CLI of the port (the arguments of
nds_tpu/cli/transcode.py; reference: nds/nds_transcode.py __main__ :218-290).

    python -m nds_tpu_torch.cli.transcode <input_prefix> <output_prefix> <report_file>
        [--output_format parquet|csv|orc|json|avro|lakehouse]
        [--output_mode overwrite|...] [--tables t1,t2] [--floats] [--update]
        [--compression codec] [--workers N] [--resume]
"""

import argparse
import os

from ..check import check_version
from ..transcode import transcode


def main(argv=None):
    check_version()
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "input_prefix", help="text to prepend to every input file path"
    )
    parser.add_argument(
        "output_prefix", help="text to prepend to every output file path"
    )
    parser.add_argument(
        "report_file", help="location to store the performance report (local)"
    )
    parser.add_argument(
        "--output_mode",
        choices=["overwrite", "append", "ignore", "error", "errorifexists"],
        default="errorifexists",
        help="behavior when the output table directory already exists",
    )
    parser.add_argument(
        "--output_format",
        choices=["parquet", "csv", "orc", "json", "avro", "lakehouse"],
        default="parquet",
        help="output data format when converting CSV data sources",
    )
    parser.add_argument(
        "--tables",
        type=lambda s: s.split(","),
        help="comma separated table names, e.g. 'catalog_page,catalog_sales'",
    )
    parser.add_argument(
        "--floats",
        action="store_true",
        help="replace decimal with double when saving files",
    )
    parser.add_argument(
        "--update",
        action="store_true",
        help="transcode the maintenance/refresh data instead of source data",
    )
    parser.add_argument(
        "--compression",
        help="compression codec, e.g. snappy (default), zstd, gzip, none",
    )
    parser.add_argument(
        "--workers",
        type=int,
        default=int(os.environ.get("NDS_TRANSCODE_WORKERS", "1")),
        help="decode worker processes for lakehouse ingest "
             "(default NDS_TRANSCODE_WORKERS or 1; other formats ignore it)",
    )
    parser.add_argument(
        "--resume",
        action="store_true",
        help="lakehouse only: continue a killed ingest: replay chunks "
             "missing from the manifest's ingest ledger, skip the rest",
    )
    args = parser.parse_args(argv)
    transcode(args)


if __name__ == "__main__":
    main()
