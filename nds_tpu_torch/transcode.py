"""Transcode (Load Test) phase, raw pipe-delimited .dat -> parquet: the port
of nds_tpu/transcode.py's parquet path.

Counterpart of the reference load test (reference: nds/nds_transcode.py:45-53
fact-table partitioning, :56-58 CSV scan with schema, :61-144 store with
repartition/coalesce, :146-215 timed loop + report):

  * ingestion streams bounded-memory Arrow morsels (io/csv.iter_dat_batches);
  * fact tables are hive-partitioned on their date surrogate key at write
    (the reference's `repartition(date_sk).sortWithinPartitions.partitionBy`),
    the null key in `__HIVE_DEFAULT_PARTITION__`; dimensions land as one
    file (the reference's `coalesce(1)`);
  * the load report keeps the reference's exact line format, including the
    TPC-DS 4.3.1 RNGSEED = load-end timestamp the stream generator consumes.

The other output formats (csv, orc, json, avro, lakehouse), remote output
paths and the lakehouse's `workers` / `resume` raise NotImplementedError.
pyarrow is imported inside the functions that read and write.
"""

from __future__ import annotations

import os
import shutil
import time
from datetime import datetime
from types import SimpleNamespace

from .io.csv import iter_dat_batches, iter_dat_chunk_tables
from .io.fs import fs_open_atomic, is_remote
from .schema import TABLE_PARTITIONING, get_maintenance_schemas, get_schemas

_ITEM9_3 = "ROADMAP.md queue 1 item 9.3 (lakehouse, csv and orc entries)"

#: the output formats of the reference's transcode that the port lacks
UNPORTED_FORMATS = ("csv", "orc", "json", "avro", "lakehouse")


def _refuse_unported(output_prefix, output_format, workers, resume):
    if output_format in UNPORTED_FORMATS:
        raise NotImplementedError(
            f"output format {output_format!r} is not ported to nds_tpu_torch "
            f"yet (parquet is): {_ITEM9_3}"
        )
    if output_format != "parquet":
        raise ValueError(f"unsupported output format {output_format}")
    if int(workers or 1) != 1 or resume:
        raise NotImplementedError(
            f"--workers and --resume belong to the lakehouse ingest, which is "
            f"not ported to nds_tpu_torch yet: {_ITEM9_3}"
        )
    if is_remote(output_prefix):
        raise NotImplementedError(
            f"remote output {output_prefix!r} is not ported to nds_tpu_torch "
            f"yet: {_ITEM9_3}"
        )


def transcode_table(
    input_prefix: str,
    output_prefix: str,
    table: str,
    schema,
    output_format: str = "parquet",
    use_decimal: bool = True,
    compression: str | None = None,
    output_mode: str = "errorifexists",
    partition: bool = True,
    workers: int = 1,
    resume: bool = False,
) -> int:
    """Convert one table; returns rows written."""
    import pyarrow as pa
    import pyarrow.dataset as pads

    _refuse_unported(output_prefix, output_format, workers, resume)
    src = os.path.join(input_prefix, table)
    dst = os.path.join(output_prefix, table)
    if table == "dbgen_version" and not os.path.isdir(src):
        # audit table only emitted by newer generator runs; a raw dataset
        # generated before it existed must still transcode
        print(f"WARNING: skipping {table!r}: no source directory at {src}")
        return 0
    basename = "part-{i}." + output_format
    if os.path.exists(dst):
        if output_mode in ("errorifexists", "error"):
            raise FileExistsError(f"{dst} exists (use --output_mode overwrite)")
        if output_mode == "ignore":
            return 0
        if output_mode == "overwrite":
            shutil.rmtree(dst)
        elif output_mode == "append":
            # unique file names so new parts never clobber existing ones
            basename = f"part-{int(time.time() * 1000)}-{{i}}.{output_format}"

    arrow_schema = pa.schema(
        [(f.name, f.dtype.to_arrow(use_decimal)) for f in schema]
    )
    part_col = TABLE_PARTITIONING.get(table) if partition else None
    if part_col is not None:
        # hive layout <col>=<value>/, one directory per date key: the
        # reference's partitionBy(date_sk) warehouse layout
        return _write_hive_partitioned_parquet(
            src, dst, schema, arrow_schema, part_col, use_decimal,
            compression or "snappy", basename,
        )

    rows = 0

    def batches():
        nonlocal rows
        for b in iter_dat_batches(src, schema, use_decimal):
            rows += b.num_rows
            yield b

    fmt = pads.ParquetFileFormat()
    pads.write_dataset(
        batches(),
        base_dir=dst,
        format=fmt,
        file_options=fmt.make_write_options(compression=compression or "snappy"),
        schema=arrow_schema,
        basename_template=basename,
        existing_data_behavior="overwrite_or_ignore",
    )
    return rows


def _write_hive_partitioned_parquet(
    src, dst, schema, arrow_schema, part_col, use_decimal, compression,
    basename,
):
    """Fact-table hive-partitioned write. Each generator chunk is sorted by
    the key once and sliced into zero-copy runs; runs accumulate in
    per-partition buffers that flush as ONE parquet write each (at a bytes
    threshold, a global cap, and at the end), so that at SF1 every
    partition directory gets exactly one file with one row group, the
    reference's one-shuffle-partition-per-date layout. Only one file is
    open at any moment. Returns rows written."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    FLUSH_BYTES = 32 << 20     # per-partition flush threshold
    GLOBAL_BYTES = 1 << 30     # total buffered bound (SF100+ fact tables)
    buffers = {}   # dirname -> [table slices]
    buf_bytes = {}  # dirname -> approx buffered bytes
    fileno = {}    # dirname -> next file sequence number
    total_buffered = 0
    rows = 0

    def flush(dirname):
        nonlocal total_buffered
        parts = buffers.pop(dirname, None)
        if not parts:
            return
        total_buffered -= buf_bytes.pop(dirname)
        pdir = os.path.join(dst, f"{part_col}={dirname}")
        os.makedirs(pdir, exist_ok=True)
        seq = fileno.get(dirname, 0)
        fileno[dirname] = seq + 1
        merged = pa.concat_tables(parts).combine_chunks()
        pq.write_table(
            merged, os.path.join(pdir, basename.format(i=seq)),
            compression=compression,
        )

    for chunk in iter_dat_chunk_tables(src, schema, use_decimal):
        if chunk.num_rows == 0:
            continue
        rows += chunk.num_rows
        order = pc.sort_indices(chunk, sort_keys=[(part_col, "ascending")])
        chunk = chunk.take(order)
        keys = chunk.column(part_col)
        vals = keys.to_numpy(zero_copy_only=False)
        # run boundaries over the sorted key; nulls sort last, and every
        # null (NaN here) "changes", so their runs are merged below
        fv = vals.astype(np.float64)
        change = np.nonzero(np.diff(fv) != 0)[0] + 1
        starts = np.concatenate([[0], change])
        null_start = None
        if keys.null_count:
            null_start = len(vals) - keys.null_count
            starts = starts[starts <= null_start]
            if starts[-1] != null_start:
                starts = np.concatenate([starts, [null_start]])
        bounds = np.concatenate([starts, [len(vals)]])
        body = chunk.drop_columns([part_col])
        row_bytes = max(1, body.nbytes // max(1, body.num_rows))
        for s, e2 in zip(bounds[:-1], bounds[1:]):
            if null_start is not None and s == null_start:
                dirname = "__HIVE_DEFAULT_PARTITION__"
            else:
                dirname = str(int(vals[s]))
            buffers.setdefault(dirname, []).append(body.slice(s, e2 - s))
            nb = (e2 - s) * row_bytes
            buf_bytes[dirname] = buf_bytes.get(dirname, 0) + nb
            total_buffered += nb
            if buf_bytes[dirname] >= FLUSH_BYTES:
                flush(dirname)
        if total_buffered >= GLOBAL_BYTES:
            # flush everything: the buffered parts are zero-copy slices
            # that pin their whole source chunk, so only releasing every
            # reference to the chunks bounds host memory
            for d in list(buffers):
                flush(d)
    for d in list(buffers):
        flush(d)
    return rows


def transcode(args) -> dict:
    """Run the full load test; writes the report file; returns timing dict."""
    _refuse_unported(args.output_prefix, args.output_format,
                     getattr(args, "workers", 1), getattr(args, "resume", False))
    schemas = (
        get_maintenance_schemas(not args.floats)
        if args.update
        else get_schemas(not args.floats)
    )
    if args.tables:
        for t in args.tables:
            if t not in schemas:
                raise Exception(
                    f"invalid table name: {t}. Valid tables are: {list(schemas)}"
                )
        schemas = {t: schemas[t] for t in args.tables}

    results = {}
    row_counts = {}
    start_time = datetime.now()
    print(f"Load Test Start Time: {start_time}")
    for table, schema in schemas.items():
        t0 = time.perf_counter()
        row_counts[table] = transcode_table(
            args.input_prefix,
            args.output_prefix,
            table,
            schema,
            output_format=args.output_format,
            use_decimal=not args.floats,
            compression=args.compression,
            output_mode=args.output_mode,
        )
        results[table] = time.perf_counter() - t0
    end_time = datetime.now()
    delta = (end_time - start_time).total_seconds()
    print(f"Load Test Finished at: {end_time}")
    print(f"Load Test Time: {delta} seconds")
    # RNGSEED format required at TPC-DS Spec 4.3.1 (mmddhhmmsss)
    end_time_formatted = end_time.strftime("%m%d%H%M%S%f")[:-5]
    print(f"RNGSEED used :{end_time_formatted}")

    report_text = f"Load Test Time: {delta} seconds\n"
    report_text += f"Load Test Finished at: {end_time}\n"
    report_text += f"RNGSEED used: {end_time_formatted}\n"
    for table, duration in results.items():
        report_text += "Time to convert '%s' was %.04fs\n" % (table, duration)
    total_rows = sum(row_counts.values())
    report_text += f"Total rows converted: {total_rows}\n"
    report_text += "\n\n\nSpark configuration follows:\n\n"
    conf_src = SimpleNamespace(
        use_decimal=not args.floats,
        conf={
            "transcode.output_format": args.output_format,
            "transcode.output_mode": args.output_mode,
            "transcode.compression": args.compression or "snappy",
            "transcode.update": bool(args.update),
        },
    )
    # the report module pulls in torch: imported only where the report is
    # written
    from .report import engine_conf

    # atomic: the transcode report is a phase artifact downstream tooling
    # parses; a crash mid-write must not publish a torn file
    with fs_open_atomic(args.report_file, "w") as report:
        report.write(report_text)
        print(report_text)
        for item in sorted(engine_conf(conf_src).items()):
            report.write(str(item) + "\n")
            print(item)
    return {
        "load_time_s": delta,
        "per_table_s": results,
        "rows": row_counts,
        "rngseed": end_time_formatted,
    }
