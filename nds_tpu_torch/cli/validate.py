"""Validation CLI of the port (the arguments of nds_tpu/cli/validate.py;
reference: nds/nds_validate.py __main__ :266-330). The query names come
from the stream file through the port's power.gen_sql_from_stream.

    python -m nds_tpu_torch.cli.validate <input1> <input2> <query_stream_file>
        [--input1_format parquet] [--input2_format parquet]
        [--ignore_ordering] [--epsilon E] [--max_errors N] [--floats]
        [--json_summary_folder DIR]
"""

import argparse

from ..check import check_version
from ..power import gen_sql_from_stream
from ..validate import iterate_queries, update_summary


def main(argv=None):
    check_version()
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "input1", help="path of the first input data (e.g. the card's run output)"
    )
    parser.add_argument(
        "input2", help="path of the second input data (e.g. CPU run output)"
    )
    parser.add_argument(
        "query_stream_file", help="query stream file used for the runs"
    )
    parser.add_argument("--input1_format", default="parquet")
    parser.add_argument("--input2_format", default="parquet")
    parser.add_argument(
        "--max_errors", type=int, default=10, help="Maximum number of differences to report."
    )
    parser.add_argument(
        "--epsilon",
        type=float,
        default=0.00001,
        help="Allow for differences in precision when comparing floating point values.",
    )
    parser.add_argument(
        "--ignore_ordering",
        action="store_true",
        help="Ignore ordering of output (sort the data collected before comparison)",
    )
    parser.add_argument(
        "--floats",
        action="store_true",
        help="the dataset was loaded as float instead of decimal",
    )
    parser.add_argument(
        "--json_summary_folder",
        help="path of a folder that contains json summary files to update "
        "with queryValidationStatus",
    )
    args = parser.parse_args(argv)
    query_names = list(gen_sql_from_stream(args.query_stream_file).keys())
    unmatch = iterate_queries(
        args.input1,
        args.input2,
        query_names,
        input1_format=args.input1_format,
        input2_format=args.input2_format,
        ignore_ordering=args.ignore_ordering,
        max_errors=args.max_errors,
        epsilon=args.epsilon,
        is_float=args.floats,
    )
    if args.json_summary_folder:
        update_summary(args.json_summary_folder, unmatch, query_names)
    print(f"{len(query_names) - len(unmatch)}/{len(query_names)} queries matched")
    return 1 if unmatch else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
