"""The Power Run: execute a query stream sequentially with full
reporting — the port of nds_tpu/power.py.

Counterpart of the reference Power Run (reference: nds/nds_power.py:50-77
stream parsing, :79-106 table setup, :125-135 per-query execution,
:184-299 the timed loop and CSV time log). A Session replaces the
SparkSession; the per-query JSON summaries and the time log keep the
reference's fields. The session runs on the card unless the caller passes
`device="cpu"`.
"""

from __future__ import annotations

import csv
import os
import re
import time
from collections import OrderedDict

from . import faults
from .check import check_json_summary_folder, check_query_subset_exists
from .engine.session import Session
from .io.fs import fs_open, fs_open_atomic
from .report import BenchReport
from .schema import get_schemas

_ITEM9 = "ROADMAP.md queue 1 item 9 (harness entry points)"


def split_special_query(q: str):
    """Split a two-statement stream entry (templates 14/23/24/39) into
    _part1/_part2 pieces, renaming the .tpl tag in each header (a copy of
    nds_tpu/datagen/query_streams.py's; reference:
    nds/nds_gen_query_stream.py:91-103)."""
    pieces = q.split(";")
    part_1 = pieces[0].replace(".tpl", "_part1.tpl") + ";"
    head = pieces[0].split("\n")[0]
    part_2 = head.replace(".tpl", "_part2.tpl") + "\n" + pieces[1] + ";"
    return part_1, part_2


def gen_sql_from_stream(query_stream_file_path: str) -> "OrderedDict[str, str]":
    """Split a generated stream file into {query_name: sql} on the
    `-- start query N in stream S using template queryK.tpl` markers.
    Two-statement entries (templates 14/23/24/39) become `_part1`/`_part2`."""
    with fs_open(query_stream_file_path) as f:
        stream = f.read()
    queries = OrderedDict()
    for q in stream.split("-- start")[1:]:
        name = q[q.find("template") + 9 : q.find(".tpl")]
        parts = q.split(";")
        if len(parts) < 2:
            raise ValueError(
                f"malformed stream file {query_stream_file_path}: entry "
                f"{name or q.splitlines()[0].strip()!r} has no ';'-terminated "
                f"statement"
            )
        # a second statement before the end marker => two-part template
        if "select" in parts[1]:
            part_1, part_2 = split_special_query(q)
            queries[name + "_part1"] = "-- start" + part_1
            queries[name + "_part2"] = "-- start" + part_2
        else:
            queries[name] = "-- start" + q
    return queries


def get_query_subset(query_dict, subset):
    """Select a run subset (reference: nds/nds_power.py:176-181)."""
    check_query_subset_exists(query_dict, subset)
    return OrderedDict((k, query_dict[k]) for k in subset)


def setup_tables(session, input_prefix, input_format, use_decimal,
                 execution_time_list, app_id):
    """Register every source table on the session, timing each
    registration (reference: per-table temp-view creation,
    nds/nds_power.py:79-106). Parquet is the format ported; csv, orc and
    lakehouse raise. Durations use the monotonic clock."""
    if input_format in ("csv", "orc", "lakehouse"):
        raise NotImplementedError(
            f"input format {input_format!r} is not ported to nds_tpu_torch "
            f"yet (parquet is): {_ITEM9}"
        )
    if input_format != "parquet":
        raise ValueError(f"unsupported input format {input_format}")
    for table_name, schema in get_schemas(use_decimal).items():
        start = time.perf_counter()
        session.register_parquet(
            table_name, os.path.join(input_prefix, table_name), schema)
        dur_ms = int((time.perf_counter() - start) * 1000)
        print(f"====== Creating TempView for table {table_name} ======")
        print(f"Time taken: {dur_ms} millis for table {table_name}")
        execution_time_list.append(
            (app_id, f"CreateTempView {table_name}", dur_ms)
        )
    return execution_time_list


def ensure_valid_column_names(arrow_table):
    """Sanitize result column names before writing: invalid characters
    become underscores and duplicates get a positional suffix (reference:
    nds/nds_power.py:137-174; parquet writers reject ` ,;{}()\\n\\t=`)."""
    invalid = re.compile(r"[ ,;{}()\n\t=]")
    names, seen = [], {}
    for n in arrow_table.column_names:
        clean = invalid.sub("_", n)
        if clean in seen:
            seen[clean] += 1
            clean = f"{clean}_{seen[clean]}"
        else:
            seen[clean] = 0
        names.append(clean)
    return arrow_table.rename_columns(names)


def run_one_query(session, query, query_name, output_path, output_format):
    """Execute one stream entry; collect to the host, or write it for
    validation (reference: nds/nds_power.py:125-135). The `<query_name>`
    injection site fires inside the report's attempt, so an injected fault
    walks the same classification and ladder a real failure would."""
    with faults.scope(query_name):
        faults.maybe_fire(query_name)
        result = session.run_script(query)
        if result is None:
            return
        if not output_path:
            result.collect()
        else:
            dest = os.path.join(output_path, query_name)
            result.write(dest, output_format, transform=ensure_valid_column_names)


def load_properties(filename: str) -> dict:
    props = {}
    with fs_open(filename) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            name, _, value = line.partition("=")
            props[name.strip()] = value.strip()
    return props


def run_query_stream(
    input_prefix,
    property_file,
    query_dict,
    time_log_output_path,
    extra_time_log_output_path=None,
    sub_queries=None,
    input_format="parquet",
    use_decimal=True,
    output_path=None,
    output_format="parquet",
    json_summary_folder=None,
    keep_session=False,
    mesh_devices=None,
    query_timeout=None,
    device=None,
    start_gate=None,
):
    """Run the stream sequentially with per-query timing and reports.

    Mirrors the reference loop (nds/nds_power.py:184-299): a session built
    with the property file's conf, table setup, a BenchReport per query
    with Failed-and-continue semantics, the CSV time log and its optional
    copy. `device` is the session's (None: the card). `start_gate` (the
    Throughput Run's rendezvous, throughput._StartGate.wait) is called
    after table setup; the epoch time it returns becomes the stream's
    `Power Start Time`. Returns the session when `keep_session`, else
    None."""
    if mesh_devices:
        raise NotImplementedError(
            "mesh_devices is not ported to nds_tpu_torch yet: ROADMAP.md "
            "queue 1 item 13 (parallel/)"
        )
    execution_time_list = []
    total_time_start = time.time()  # epoch: app-id stamp only
    total_start_mono = time.perf_counter()  # elapsed measurements
    app_name = (
        "NDS - " + next(iter(query_dict)) if len(query_dict) == 1 else "NDS - Power Run"
    )
    conf = {"app.name": app_name}
    if property_file:
        conf.update(load_properties(property_file))
    if query_timeout is not None:
        # the CLI tier wins over the property file (an explicit 0 disables
        # a property-file watchdog)
        conf["engine.query_timeout"] = query_timeout
    check_json_summary_folder(json_summary_folder)
    session = Session(use_decimal=use_decimal, conf=conf, device=device)
    app_id = f"nds-tpu-torch-{os.getpid()}-{int(total_time_start)}"
    execution_time_list = setup_tables(
        session, input_prefix, input_format, use_decimal, execution_time_list,
        app_id
    )
    if sub_queries:
        query_dict = get_query_subset(query_dict, sub_queries)
    if start_gate is not None:
        # concurrent streams: every stream finishes setup before any
        # stream's Power clock starts, and the gate's shared release time
        # is each stream's start, so the [start, end] windows overlap by
        # construction
        gate_t = start_gate()
        power_start = int(gate_t) if gate_t is not None else int(time.time())
    else:
        power_start = int(time.time())
    # the epoch Power Start/End rows are the time log's contract; elapsed
    # figures are monotonic
    power_start_mono = time.perf_counter()
    for query_name, q_content in query_dict.items():
        print(f"====== Run {query_name} ======")
        q_report = BenchReport(session)
        summary = q_report.report_on(
            run_one_query, session, q_content, query_name, output_path,
            output_format, retry_oom=True,  # read-only: idempotent
        )
        print(f"Time taken: {summary['queryTimes']} millis for {query_name}")
        execution_time_list.append((app_id, query_name, summary["queryTimes"][0]))
        if json_summary_folder:
            if property_file:
                summary_prefix = os.path.join(
                    json_summary_folder, os.path.basename(property_file).split(".")[0]
                )
            else:
                summary_prefix = os.path.join(json_summary_folder, "")
            q_report.write_summary(query_name, prefix=summary_prefix)
    power_end = int(time.time())
    power_elapse = int((time.perf_counter() - power_start_mono) * 1000)
    total_elapse = int((time.perf_counter() - total_start_mono) * 1000)
    print(f"====== Power Test Time: {power_elapse} milliseconds ======")
    print(f"====== Total Time: {total_elapse} milliseconds ======")
    execution_time_list.append((app_id, "Power Start Time", power_start))
    execution_time_list.append((app_id, "Power End Time", power_end))
    execution_time_list.append((app_id, "Power Test Time", power_elapse))
    execution_time_list.append((app_id, "Total Time", total_elapse))

    header = ["application_id", "query", "time/milliseconds"]
    print(header)
    for row in execution_time_list:
        print(row)
    for path in (time_log_output_path, extra_time_log_output_path):
        if path:
            # atomic: a crash mid-write leaves no log or a complete one
            with fs_open_atomic(path, "w", encoding="UTF8", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(header)
                writer.writerows(execution_time_list)
    return session if keep_session else None
