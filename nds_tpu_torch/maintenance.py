"""The Data Maintenance phase: the 11 TPC-DS refresh functions over the
lakehouse — the port of nds_tpu/maintenance.py.

Counterpart of the reference's maintenance script (reference:
nds/nds_maintenance.py — function lists :45-58, get_delete_date :60-73,
replace_date :75-96, get_maintenance_queries :118-144, run_query :204-265,
register_temp_views :267-271). The warehouse is the snapshot-manifest
lakehouse (lakehouse/table.py); the refresh staging tables register from
the generated `--update` data. The sessions run on the card unless the
caller passes `device="cpu"`. Each session's tracer is bound around the
timed loops (so the lakehouse commit and vacuum events, fault injections
and fs retries reach its stream) and closed at the end.
"""

from __future__ import annotations

import csv
import math
import os
import threading
import time
from datetime import datetime

from . import faults
from .check import check_json_summary_folder
from .engine.session import Session
from .io.fs import fs_open_atomic
from .obs import trace as obs_trace
from .power import load_properties
from .report import BenchReport, use_system_arrow_pool
from .schema import get_maintenance_schemas

INSERT_FUNCS = ["LF_CR", "LF_CS", "LF_I", "LF_SR", "LF_SS", "LF_WR", "LF_WS"]
DELETE_FUNCS = ["DF_CS", "DF_SS", "DF_WS"]
INVENTORY_DELETE_FUNC = ["DF_I"]
DM_FUNCS = INSERT_FUNCS + DELETE_FUNCS + INVENTORY_DELETE_FUNC

#: the refresh functions' SQL, byte-identical copies of the JAX package's
MAINTENANCE_SQL_DIR = os.path.join(os.path.dirname(__file__), "data_maintenance")

#: the fact tables the refresh functions write, which rollback restores
FACT_TABLES = [
    "catalog_sales",
    "catalog_returns",
    "inventory",
    "store_returns",
    "store_sales",
    "web_returns",
    "web_sales",
]


def get_valid_query_names(spec_queries):
    if spec_queries:
        for q in spec_queries:
            if q not in DM_FUNCS:
                raise Exception(
                    f"invalid Data Maintenance query: {q}. Valid are: {DM_FUNCS}"
                )
        return spec_queries
    return list(DM_FUNCS)


def get_delete_date(session):
    """The delete-date pairs of the generated delete tables (3 per
    function, TPC-DS spec 5.3.11)."""
    date_dict = {}
    for table in ("delete", "inventory_delete"):
        rows = session.sql(f"select * from {table}").collect().to_pylist()
        date_dict[table] = [(r["date1"], r["date2"]) for r in rows]
    return date_dict


def replace_date(query_list, date_tuple_list):
    """Apply every (DATE1, DATE2) pair to the statement list, ordering each
    pair so that DATE1 <= DATE2."""
    q_updated = []
    for date1, date2 in date_tuple_list:
        d1 = datetime.strptime(str(date1), "%Y-%m-%d")
        d2 = datetime.strptime(str(date2), "%Y-%m-%d")
        earlier, later = (date1, date2) if d1 <= d2 else (date2, date1)
        for q in query_list:
            q_updated.append(
                q.replace("DATE1", str(earlier)).replace("DATE2", str(later))
            )
    return q_updated


def get_maintenance_queries(session, folder, valid_queries):
    """{function name: [statements]} with the delete dates substituted."""
    delete_date_dict = get_delete_date(session)
    q_dict = {}
    for q in valid_queries:
        with open(os.path.join(folder, q + ".sql")) as f:
            text = f.read()
        stmts = [
            s.strip() + ";"
            for s in text.split(";")
            if s.strip() and not all(
                line.strip().startswith("--") or not line.strip()
                for line in s.splitlines()
            )
        ]
        if q in DELETE_FUNCS:
            stmts = replace_date(stmts, delete_date_dict["delete"])
        if q in INVENTORY_DELETE_FUNC:
            stmts = replace_date(stmts, delete_date_dict["inventory_delete"])
        q_dict[q] = stmts
    return q_dict


def run_dm_query(session, query_list, query_name):
    """Run one refresh function's statements in order, under the function's
    fault scope (its `exec:<name>` injection sites)."""
    with faults.scope(query_name):
        for q in query_list:
            _run_dm_statement(session, q)


def _run_dm_statement(session, q):
    """One refresh statement with bounded re-runs after a commit conflict.

    The retry lives at statement granularity: a refresh function is a list
    of statements, and re-running the whole function after its Nth
    statement's commit aborted would apply statements 1..N-1 twice. An
    aborted statement published nothing (its staged files are discarded),
    so re-running it derives its writes again from the new head. The budget
    and backoff are the report ladder's knobs (NDS_LAKE_CONFLICT_RETRIES /
    NDS_LAKE_COMMIT_BACKOFF), parsed in lakehouse/table.py."""
    from .lakehouse.table import (
        CommitConflictError,
        commit_backoff_base,
        resolve_conflict_retries,
    )

    delays = faults.backoff_delays(
        resolve_conflict_retries(), commit_backoff_base()
    )
    while True:
        try:
            return session.run_script(q)
        except CommitConflictError as exc:
            delay = next(delays, None)
            if delay is None:
                raise
            print(
                f"maintenance: commit conflict ({exc}); re-running the "
                f"statement against the new head in {delay:.2f}s"
            )
            time.sleep(delay)


#: the staging tables each refresh function reads (spec 5.3.11); the
#: delete-date tables are always needed for the DATE1 / DATE2 substitution
_FUNC_STAGING = {
    "LF_SS": ["s_purchase", "s_purchase_lineitem"],
    "LF_SR": ["s_store_returns"],
    "LF_CS": ["s_catalog_order", "s_catalog_order_lineitem"],
    "LF_CR": ["s_catalog_returns"],
    "LF_WS": ["s_web_order", "s_web_order_lineitem"],
    "LF_WR": ["s_web_returns"],
    "LF_I": ["s_inventory"],
}


def register_refresh_views(session, refresh_data_path, valid_queries=None):
    """Register the s_* staging tables and the delete tables from the raw
    refresh data (reference: nds_maintenance.register_temp_views
    :267-271). Only the staging tables the selected functions read are
    read."""
    needed = {"delete", "inventory_delete"}
    for q in valid_queries or DM_FUNCS:
        needed.update(_FUNC_STAGING.get(q, []))
    schemas = get_maintenance_schemas(session.use_decimal)
    for table in sorted(needed):
        path = os.path.join(refresh_data_path, table)
        if not os.path.isdir(path):
            # fail now with the expected path, not inside the timed window
            # as a binder's "unknown table"
            raise FileNotFoundError(
                f"staging table {table!r} required by the selected "
                f"maintenance functions is missing: expected directory "
                f"{path} (generate it with gen_data --update)"
            )
        session.register_csv_dir(table, path, schemas[table])


def _warehouse_tables(warehouse_path, tables):
    from .lakehouse.table import LakehouseTable

    names = tables
    if names is None:
        try:
            names = sorted(os.listdir(warehouse_path))
        except OSError:
            names = []
    for name in names:
        path = os.path.join(str(warehouse_path), name)
        if LakehouseTable.is_table(path):
            yield name, path


def vacuum_warehouse(warehouse_path, tables=None, retain_last=None,
                     conf=None):
    """Expire old snapshots and delete unreferenced data files across the
    warehouse's lakehouse tables (Iceberg's expire_snapshots and orphan
    cleanup). A file under a live reader lease is never deleted, so vacuum
    may run while query streams read (the maintenance-under-load phase
    does). Returns the per-table vacuum result dicts."""
    from .lakehouse.table import LakehouseTable

    results = []
    for name, path in _warehouse_tables(warehouse_path, tables):
        res = LakehouseTable(path, conf=conf).vacuum(retain_last=retain_last)
        if res["files_removed"] or res["manifests_removed"]:
            print(
                f"vacuum {name}: removed {res['files_removed']} data "
                f"file(s), {res['manifests_removed']} manifest(s)"
                + (
                    f", kept {res['files_leased']} leased file(s)"
                    if res["files_leased"] else ""
                )
            )
        results.append(res)
    return results


def optimize_warehouse(warehouse_path, tables=None, target_bytes=None,
                       min_input_files=None, conf=None):
    """Compact small files across the warehouse's lakehouse tables (Delta's
    OPTIMIZE, Iceberg's rewrite_data_files). Parallel ingest and the
    per-statement refresh commits fragment tables into many small files;
    compaction bin-packs them toward `engine.lake_compact_target_bytes`
    through the same optimistic commit as any writer, with fresh zone maps
    for the rewritten files. Pinned readers keep the pre-compaction
    manifest, and a racing commit aborts the compaction (re-planned after
    the shared conflict backoff), never the other writer. Returns the
    per-table result dicts."""
    from .lakehouse.table import (
        CommitConflictError,
        LakehouseTable,
        commit_backoff_base,
        resolve_conflict_retries,
    )

    results = []
    for name, path in _warehouse_tables(warehouse_path, tables):
        lt = LakehouseTable(path, conf=conf)
        delays = faults.backoff_delays(
            resolve_conflict_retries(), commit_backoff_base()
        )
        while True:
            try:
                res = lt.compact(
                    target_bytes=target_bytes,
                    min_input_files=min_input_files,
                )
                break
            except CommitConflictError as exc:
                delay = next(delays, None)
                if delay is None:
                    raise
                print(
                    f"optimize {name}: commit conflict ({exc}); "
                    f"re-planning against the new head in {delay:.2f}s"
                )
                time.sleep(delay)
        if res["version"] is not None:
            print(
                f"optimize {name}: compacted {res['files_in']} file(s) "
                f"into {res['files_out']} "
                f"({res['bytes_in']} bytes rewritten) "
                f"-> v{res['version']}"
            )
        results.append(res)
    return results


def _write_time_log(path, rows):
    # atomic: the whole benchmark re-reads this log for Tdm, so a crash
    # mid-write must never leave a torn CSV
    with fs_open_atomic(path, "w", encoding="UTF8", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["application_id", "query", "time/s"])
        writer.writerows(rows)


def run_maintenance(
    warehouse_path,
    refresh_data_path,
    time_log_output_path,
    json_summary_folder=None,
    property_file=None,
    spec_queries=None,
    use_decimal=True,
    maintenance_sql_dir=None,
    vacuum_after=False,
    optimize_after=False,
    device=None,
):
    """Run the refresh functions with per-function timing and reports.

    Returns the Data Maintenance Time in seconds (Tdm). `optimize_after`
    compacts the small files the per-statement commits made (target:
    `engine.lake_compact_target_bytes` / NDS_LAKE_COMPACT_TARGET_BYTES);
    `vacuum_after` then expires old snapshots and sweeps unreferenced data
    files (retention: `engine.lake_vacuum_retain` / NDS_LAKE_VACUUM_RETAIN,
    default 2). Compaction runs first, so its superseded inputs age into
    the same vacuum horizon as every other dead snapshot. `device` is the
    session's (None: the card)."""
    valid_queries = get_valid_query_names(spec_queries)
    app_name = (
        "NDS - Data Maintenance - " + valid_queries[0]
        if len(valid_queries) == 1
        else "NDS - Data Maintenance"
    )
    conf = {"app.name": app_name, "lakehouse.warehouse": warehouse_path}
    if property_file:
        conf.update(load_properties(property_file))
    check_json_summary_folder(json_summary_folder)
    session = Session(use_decimal=use_decimal, conf=conf, device=device)
    try:
        return _run_maintenance_body(
            session, warehouse_path, refresh_data_path,
            time_log_output_path, json_summary_folder, property_file,
            valid_queries, maintenance_sql_dir, vacuum_after,
            optimize_after,
        )
    finally:
        # this run is its tracer's only emitter: closing here (success or
        # crash) flushes the final line, as power.run_query_stream does
        if session.tracer is not None:
            session.tracer.close()


def _run_maintenance_body(
    session, warehouse_path, refresh_data_path, time_log_output_path,
    json_summary_folder, property_file, valid_queries, maintenance_sql_dir,
    vacuum_after, optimize_after=False,
):
    app_id = f"nds-tpu-torch-dm-{os.getpid()}-{int(time.time())}"

    # the warehouse's tables (lakehouse) and the refresh staging tables
    session.register_nds_tables(warehouse_path, fmt="lakehouse")
    register_refresh_views(session, refresh_data_path, valid_queries)

    query_dict = get_maintenance_queries(
        session, maintenance_sql_dir or MAINTENANCE_SQL_DIR, valid_queries
    )

    execution_time_list = []
    total_time_start = datetime.now()
    dm_start = datetime.now()
    # bind the session tracer to this thread: session-less layers (the
    # lakehouse commit and vacuum events, fault registry, fs retries) find
    # it through the thread-local binding
    with obs_trace.bind(session.tracer):
        for query_name, q_content in query_dict.items():
            print(f"====== Run {query_name} ======")
            q_report = BenchReport(session)
            summary = q_report.report_on(
                run_dm_query, session, q_content, query_name, name=query_name
            )
            print(f"Time taken: {summary['queryTimes']} millis for {query_name}")
            execution_time_list.append((app_id, query_name, summary["queryTimes"]))
            if json_summary_folder:
                if property_file:
                    summary_prefix = os.path.join(
                        json_summary_folder,
                        os.path.basename(property_file).split(".")[0],
                    )
                else:
                    summary_prefix = os.path.join(json_summary_folder, "")
                q_report.write_summary(query_name, prefix=summary_prefix)
    if optimize_after:
        o_start = time.perf_counter()
        optimize_warehouse(warehouse_path, conf=session.conf)
        execution_time_list.append(
            (app_id, "Optimize Time", round(time.perf_counter() - o_start, 3))
        )
    if vacuum_after:
        v_start = time.perf_counter()
        vacuum_warehouse(warehouse_path, conf=session.conf)
        execution_time_list.append(
            (app_id, "Vacuum Time", round(time.perf_counter() - v_start, 3))
        )
    dm_end = datetime.now()
    dm_elapse = (dm_end - dm_start).total_seconds()
    total_elapse = (dm_end - total_time_start).total_seconds()
    print(f"====== Data Maintenance Start Time: {dm_start}")
    print(f"====== Data Maintenance Time: {dm_elapse} s ======")
    print(f"====== Total Time: {total_elapse} s ======")
    execution_time_list.append((app_id, "Data Maintenance Start Time", dm_start))
    execution_time_list.append((app_id, "Data Maintenance End Time", dm_end))
    execution_time_list.append((app_id, "Data Maintenance Time", dm_elapse))
    execution_time_list.append((app_id, "Total Time", total_elapse))
    _write_time_log(time_log_output_path, execution_time_list)
    return dm_elapse


# ---------------------------------------------------------------------------
# maintenance under load: refresh commits racing a live query stream
# ---------------------------------------------------------------------------


def _p99_ms(times):
    """The p99 of per-query milliseconds (nearest rank); None when empty. A
    short stream's p99 is its maximum: the right tail either way."""
    if not times:
        return None
    ts = sorted(times)
    idx = max(int(math.ceil(0.99 * len(ts))) - 1, 0)
    return round(float(ts[idx]), 3)


def run_maintenance_under_load(
    warehouse_path,
    refresh_data_path,
    stream_file,
    time_log_output_path,
    report_path=None,
    property_file=None,
    spec_queries=None,
    sub_queries=None,
    use_decimal=True,
    vacuum_retain=None,
    device=None,
):
    """Maintenance under load: the refresh functions (and a vacuum) commit
    to the warehouse while a query stream reads it.

    The stream runs three times on one session: a warmup (recorded, not
    measured), a solo baseline, and then again while a thread runs the
    refresh functions and the vacuum on a second session on the same
    device. Reported as maintenance throughput (functions/s) and the
    stream's p99 degradation (under-load p99 / solo p99). Snapshot pins
    keep every in-flight query on one manifest version across the racing
    commits, and the vacuum respects the readers' leases. Returns the
    report dict (also written to `report_path` atomically, where given).
    A failure of the maintenance thread is raised after the report is
    written."""
    from .power import gen_sql_from_stream, get_query_subset

    valid_queries = get_valid_query_names(spec_queries)
    conf = {
        "app.name": "NDS - Maintenance Under Load",
        "lakehouse.warehouse": warehouse_path,
    }
    if property_file:
        conf.update(load_properties(property_file))
    query_dict = gen_sql_from_stream(stream_file)
    if sub_queries:
        query_dict = get_query_subset(query_dict, sub_queries)
    app_id = f"nds-tpu-torch-mul-{os.getpid()}-{int(time.time())}"

    # the reader and the writer run on separate sessions (each with its own
    # snapshot pins) but share the process-wide reader-lease table, which
    # is what makes the writer's vacuum safe while the reader is mid-query
    qconf = dict(conf)
    qconf["app.name"] = "NDS - MUL query stream"
    qsession = Session(use_decimal=use_decimal, conf=qconf, device=device)
    msession = Session(use_decimal=use_decimal, conf=dict(conf),
                       device=device)
    try:
        return _run_under_load_body(
            qsession, msession, warehouse_path, refresh_data_path,
            valid_queries, query_dict, app_id, vacuum_retain,
            time_log_output_path, report_path,
        )
    finally:
        # both sessions own their tracers: close them on any exit
        for s in (qsession, msession):
            if s.tracer is not None:
                s.tracer.close()


def _run_under_load_body(qsession, msession, warehouse_path,
                         refresh_data_path, valid_queries, query_dict, app_id,
                         vacuum_retain, time_log_output_path, report_path):
    from .power import run_one_query

    qsession.register_nds_tables(warehouse_path, fmt="lakehouse")
    msession.register_nds_tables(warehouse_path, fmt="lakehouse")
    register_refresh_views(msession, refresh_data_path, valid_queries)
    dm_queries = get_maintenance_queries(
        msession, MAINTENANCE_SQL_DIR, valid_queries
    )
    rows = []

    def run_stream(tag):
        times, failed = [], 0
        with obs_trace.bind(qsession.tracer):
            for qname, qtext in query_dict.items():
                rep = BenchReport(qsession)
                s = rep.report_on(
                    run_one_query, qsession, qtext, qname, None, "parquet",
                    retry_oom=True, name=qname,
                )
                ms = s["queryTimes"][0]
                rows.append((app_id, f"{tag}:{qname}", ms))
                if s["queryStatus"][-1] == "Failed":
                    failed += 1
                else:
                    times.append(float(ms))
        return times, failed

    dm_stats = {"functions": 0, "failed": 0, "elapsed_s": None,
                "vacuums": 0, "vacuum_files_removed": 0, "error": None}

    def run_dm():
        # an escape here would die silently on the daemon thread and the
        # phase would read as clean: record it, finish the report, and let
        # the caller raise
        t0 = time.perf_counter()
        try:
            with obs_trace.bind(msession.tracer):
                for fname, stmts in dm_queries.items():
                    rep = BenchReport(msession)
                    s = rep.report_on(run_dm_query, msession, stmts, fname,
                                      name=fname)
                    rows.append((app_id, f"dm:{fname}", s["queryTimes"][0]))
                    if s["queryStatus"][-1] == "Failed":
                        dm_stats["failed"] += 1
                    else:
                        dm_stats["functions"] += 1
                # vacuum while the stream still reads: the reader leases
                # are the safety contract under test
                for res in vacuum_warehouse(
                    warehouse_path, conf=msession.conf,
                    retain_last=vacuum_retain,
                ):
                    dm_stats["vacuums"] += 1
                    dm_stats["vacuum_files_removed"] += res["files_removed"]
        except BaseException as exc:
            dm_stats["error"] = f"{type(exc).__name__}: {exc}"
        finally:
            dm_stats["elapsed_s"] = round(time.perf_counter() - t0, 3)

    # the warmup pass keeps first-use costs (kernel builds, cold caches)
    # out of the solo p99, which would otherwise make the degradation ratio
    # read as a speedup
    print("====== maintenance_under_load: warmup stream ======")
    run_stream("warmup")
    print("====== maintenance_under_load: solo baseline stream ======")
    solo_times, solo_failed = run_stream("solo")
    print("====== maintenance_under_load: stream + racing DM_* ======")
    # Arrow's default mimalloc pool crashes when two threads read datasets
    # at once (report.use_system_arrow_pool): the stream and the refresh
    # functions do here
    use_system_arrow_pool()
    dm_thread = threading.Thread(
        target=run_dm, name="nds-maintenance-under-load", daemon=True
    )
    overlap_start = time.perf_counter()
    dm_thread.start()
    load_times, load_failed = run_stream("under_load")
    dm_thread.join()
    overlap_s = round(time.perf_counter() - overlap_start, 3)

    solo_p99 = _p99_ms(solo_times)
    load_p99 = _p99_ms(load_times)
    report = {
        "queries": len(query_dict),
        "solo_failed": solo_failed,
        "under_load_failed": load_failed,
        "query_p99_ms_solo": solo_p99,
        "query_p99_ms_under_load": load_p99,
        # the headline: how much the racing maintenance hurt the stream's
        # tail (1.0 = not at all)
        "query_p99_degradation": (
            round(load_p99 / solo_p99, 3) if solo_p99 and load_p99 else None
        ),
        "dm_functions": dm_stats["functions"],
        "dm_failed": dm_stats["failed"],
        "dm_elapsed_s": dm_stats["elapsed_s"],
        "dm_functions_per_s": (
            round(dm_stats["functions"] / dm_stats["elapsed_s"], 4)
            if dm_stats["elapsed_s"] else None
        ),
        "vacuums": dm_stats["vacuums"],
        "vacuum_files_removed": dm_stats["vacuum_files_removed"],
        "overlap_wall_s": overlap_s,
    }
    if dm_stats["error"]:
        report["dm_error"] = dm_stats["error"]
    rows.append((app_id, "Maintenance Under Load Time", overlap_s))
    _write_time_log(time_log_output_path, rows)
    if report_path:
        import json

        with fs_open_atomic(report_path, "w") as f:
            json.dump(report, f, indent=2)
    print(f"====== maintenance_under_load: {report} ======")
    if dm_stats["error"]:
        # the evidence is on disk; now fail loudly: a broken maintenance
        # thread must not read as a clean completion
        raise RuntimeError(
            f"maintenance-under-load DM thread failed: "
            f"{dm_stats['error']} (report written to "
            f"{report_path or time_log_output_path})"
        )
    return report


def rollback(warehouse_path, timestamp, tables=None, device=None):
    """Roll the refresh functions' fact tables back to a pre-maintenance
    snapshot (reference: nds/nds_rollback.py:37-51)."""
    from .lakehouse.table import LakehouseTable

    tables = tables or FACT_TABLES
    session = Session(conf={"lakehouse.warehouse": warehouse_path},
                      device=device)
    session.register_nds_tables(warehouse_path, fmt="lakehouse")
    for table in tables:
        if not LakehouseTable.is_table(os.path.join(warehouse_path, table)):
            continue
        print(f"Rolling back {table} to {timestamp}")
        session.sql(
            f"call system.rollback_to_timestamp('{table}', timestamp '{timestamp}')"
        )
