"""Differential validator, row-by-row comparison of two Power Run outputs:
the port of nds_tpu/validate.py (pyarrow imported inside the functions
that read).

Counterpart of the reference validator (reference: nds/nds_validate.py
compare_results :47-111, collect_results :113-141, rowEqual :143-164,
compare :166-187, iterate_queries :189-227, update_summary :229-263), with
the reference's exact semantics:

  * float/decimal compare with relative epsilon; NaN == NaN;
  * optional order-insensitive compare sorting on non-float columns first;
  * query78's rounded 4th column compared with absolute tolerance 0.01;
  * query65 always skipped, query67 skipped under float mode;
  * queryValidationStatus in {Pass, Fail, NotAttempted} written back into
    the per-query JSON summaries.

The reference compares CPU-Spark against GPU-Spark runs of the same
frontend; here the same differential applies between any two runs of the
port (the card against the CPU, the kernels on against off) or between the
port and another engine's output folders.
"""

from __future__ import annotations

import glob
import json
import math
import os
from decimal import Decimal

from .io.fs import fs_open_atomic


def load_output(path: str, fmt: str):
    """Load one query's written output (power --output_prefix layout)."""
    import pyarrow.dataset as pads

    return pads.dataset(path, format=fmt).to_table()


def collect_results(table, ignore_ordering: bool, batch_rows: int = 8192):
    """Rows as python lists, optionally sorted on non-float columns first
    (reference: collect_results :113-141, which streams via
    toLocalIterator). Python row objects are materialized one record batch
    at a time, so memory stays bounded at SF>=100 validation scale; the
    sort (when requested) happens in compact Arrow columnar form, never as
    Python lists."""

    import pyarrow.types as pat

    if ignore_ordering:
        non_float = [
            f.name for f in table.schema if not pat.is_floating(f.type)
        ]
        floats = [f.name for f in table.schema if pat.is_floating(f.type)]
        table = table.sort_by([(c, "ascending") for c in non_float + floats])

    def gen():
        for batch in table.to_batches(max_chunksize=batch_rows):
            cols = [
                batch.column(i).to_pylist()
                for i in range(batch.num_columns)
            ]
            if not cols:
                continue
            for row in zip(*cols):
                yield list(row)

    return gen()


def compare(expected, actual, epsilon=0.00001) -> bool:
    if isinstance(expected, float) and isinstance(actual, float):
        if math.isnan(expected) and math.isnan(actual):
            return True
        return math.isclose(expected, actual, rel_tol=epsilon)
    if isinstance(expected, str) and isinstance(actual, str):
        return expected == actual
    if expected is None and actual is None:
        return True
    if expected is None or actual is None:
        return False
    if isinstance(expected, Decimal) and isinstance(actual, Decimal):
        return math.isclose(expected, actual, rel_tol=epsilon)
    if isinstance(expected, (int, float, Decimal)) and isinstance(
        actual, (int, float, Decimal)
    ):
        # cross-type numeric (e.g. decimal vs float between engines)
        return math.isclose(float(expected), float(actual), rel_tol=epsilon)
    return expected == actual


def row_equal(row1, row2, epsilon, is_q78) -> bool:
    if is_q78:
        # q78's 4th column is round(ss_qty/(ws_qty+cs_qty), 2): allow 0.01
        # absolute difference (reference: rowEqual :143-162)
        row1, row2 = list(row1), list(row2)
        v1 = row1.pop(3)
        v2 = row2.pop(3)
        if v1 is None and v2 is None:
            fourth_eq = True
        elif v1 is None or v2 is None:
            fourth_eq = False
        else:
            fourth_eq = abs(float(v1) - float(v2)) <= 0.01
        return fourth_eq and all(
            compare(a, b, epsilon) for a, b in zip(row1, row2)
        )
    return all(compare(a, b, epsilon) for a, b in zip(row1, row2))


def compare_results(
    input1: str,
    input2: str,
    input1_format: str = "parquet",
    input2_format: str = "parquet",
    ignore_ordering: bool = False,
    is_q78: bool = False,
    max_errors: int = 10,
    epsilon: float = 0.00001,
) -> bool:
    """Row-by-row comparison of two query output dirs."""
    t1 = load_output(input1, input1_format)
    t2 = load_output(input2, input2_format)
    if t1.num_rows != t2.num_rows:
        print(f"DataFrame row counts do not match: {t1.num_rows} != {t2.num_rows}")
        return False
    r1 = collect_results(t1, ignore_ordering)
    r2 = collect_results(t2, ignore_ordering)
    errors = 0
    i = 0
    while i < t1.num_rows and errors < max_errors:
        lhs = next(r1)
        rhs = next(r2)
        if not row_equal(lhs, rhs, epsilon, is_q78):
            print(f"Row {i}: \n{lhs}\n{rhs}\n")
            errors += 1
        i += 1
    print(f"Processed {i} rows")
    if errors == max_errors:
        print(f"Aborting comparison after reaching maximum of {max_errors} errors")
        return False
    if errors == 0:
        print("Results match")
        return True
    print(f"There were {errors} errors")
    return False


def iterate_queries(
    input1: str,
    input2: str,
    queries: list,
    input1_format: str = "parquet",
    input2_format: str = "parquet",
    ignore_ordering: bool = False,
    max_errors: int = 10,
    epsilon: float = 0.00001,
    is_float: bool = False,
) -> list:
    """Compare every query's output dir; returns the unmatched query names."""
    unmatch_queries = []
    for query in queries:
        if query == "query65":
            # ambiguous ordering inside q65 (reference carve-out)
            continue
        if query == "query67" and is_float:
            continue
        print(f"=== Comparing Query: {query} ===")
        ok = compare_results(
            os.path.join(input1, query),
            os.path.join(input2, query),
            input1_format,
            input2_format,
            ignore_ordering,
            is_q78=query == "query78",
            max_errors=max_errors,
            epsilon=epsilon,
        )
        if not ok:
            unmatch_queries.append(query)
    if unmatch_queries:
        print(f"=== Unmatch Queries: {unmatch_queries} ===")
    return unmatch_queries


def update_summary(prefix: str, unmatch_queries: list, query_names: list):
    """Write queryValidationStatus into each query's JSON summary
    (reference: update_summary :229-263)."""
    if not os.path.exists(prefix):
        raise Exception("The json summary folder doesn't exist.")
    print(f"Updating queryValidationStatus in folder {prefix}.")
    for query_name in query_names:
        file_glob = glob.glob(os.path.join(prefix, f"*{query_name}-*.json"))
        if len(file_glob) > 1:
            raise Exception(
                f"More than one summary file found for query {query_name} in folder {prefix}."
            )
        if not file_glob:
            raise Exception(
                f"No summary file found for query {query_name} in folder {prefix}."
            )
        filename = file_glob[0]
        with open(filename) as f:
            summary = json.load(f)
        if query_name in unmatch_queries:
            if (
                "Completed" in summary["queryStatus"]
                or "CompletedWithTaskFailures" in summary["queryStatus"]
            ):
                summary["queryValidationStatus"] = ["Fail"]
            else:
                summary["queryValidationStatus"] = ["NotAttempted"]
        else:
            summary["queryValidationStatus"] = ["Pass"]
        # atomic rewrite: this is the query's ONLY summary JSON; a crash
        # mid-dump must leave the previous complete file, not a torn one
        with fs_open_atomic(filename, "w") as f:
            json.dump(summary, f, indent=2)
