"""Transcode (Load Test) phase, raw pipe-delimited .dat -> a columnar
warehouse: the port of nds_tpu/transcode.py.

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

The other outputs are the reference's: csv (hive-partitioned facts),
orc and json and avro (one file a table), and the lakehouse. Lakehouse
ingest is parallel and resumable: generator chunk files shard round-robin
over a spawn pool of decode processes (`--workers`); each worker holds its
own epoch-fenced writer lease and commits chunk by chunk, recording the
chunk id in the manifest's ingest ledger. The ledger is the checkpoint: a
killed run re-invoked with `--resume` replays only unledgered chunks, and
the commit point skips ids already ledgered (exactly-once even if two
resumers race). Each worker decodes chunk i+1 on a thread while chunk i
stages and commits. Fact chunks are sorted by their date surrogate key and
split into bounded files, so each file covers a narrow key range and its
zone map (lakehouse/zonemap.py) prunes. The workers decode and write on
the host; nothing here touches CUDA. Only the lakehouse may go to a remote
(fsspec) output. Each committed (or skipped) chunk emits an
`ingest_chunk` trace event. pyarrow is imported inside the functions that
read and write.
"""

from __future__ import annotations

import os
import queue
import shutil
import threading
import time
from datetime import datetime
from time import perf_counter as _perf
from types import SimpleNamespace

from .io.csv import iter_dat_batches, iter_dat_chunk_tables
from .io.fs import fs_open_atomic
from .schema import TABLE_PARTITIONING, get_maintenance_schemas, get_schemas


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
    """Convert one table; returns rows written (for the lakehouse, the rows
    this run committed)."""
    import pyarrow as pa
    import pyarrow.dataset as pads

    from .io.fs import get_fs, is_remote, join as fs_join

    src = os.path.join(input_prefix, table)
    dst = fs_join(output_prefix, table)
    if table == "dbgen_version" and not os.path.isdir(src):
        # audit table only emitted by newer generator runs; a raw dataset
        # generated before it existed must still transcode
        print(f"WARNING: skipping {table!r}: no source directory at {src}")
        return 0
    basename = "part-{i}." + output_format
    if is_remote(dst) and output_format != "lakehouse":
        # checked before any overwrite branch can delete: only the
        # lakehouse carries the shared-filesystem seam
        raise ValueError(
            f"remote output {dst!r} requires --output_format lakehouse"
        )
    dst_fs, dst_path = get_fs(dst)
    if resume and output_format == "lakehouse":
        # resuming a killed ingest: the existing table is the checkpoint,
        # which the output_mode handling below must neither refuse nor wipe
        pass
    elif dst_fs.exists(dst_path):
        if output_mode in ("errorifexists", "error"):
            raise FileExistsError(f"{dst} exists (use --output_mode overwrite)")
        if output_mode == "ignore":
            return 0
        if output_mode == "overwrite":
            if is_remote(dst):
                dst_fs.rm(dst_path, recursive=True)
            else:
                shutil.rmtree(dst)
        elif output_mode == "append":
            # unique file names so new parts never clobber existing ones
            basename = f"part-{int(time.time() * 1000)}-{{i}}.{output_format}"

    arrow_schema = pa.schema(
        [(f.name, f.dtype.to_arrow(use_decimal)) for f in schema]
    )
    rows = 0

    def batches():
        nonlocal rows
        for b in iter_dat_batches(src, schema, use_decimal):
            rows += b.num_rows
            yield b

    if output_format == "lakehouse":
        return _lakehouse_ingest(
            src, dst, table, schema, arrow_schema, use_decimal, workers
        )
    if output_format not in ("parquet", "csv", "orc", "json", "avro"):
        raise ValueError(f"unsupported output format {output_format}")

    if output_format == "avro":
        # the container-file writer of io/avro.py (the reference offers
        # avro through the external spark-avro plugin:
        # nds/nds_transcode.py:241-249)
        from .io.avro import write_avro

        os.makedirs(dst, exist_ok=True)
        write_avro(batches(), os.path.join(dst, basename.format(i=0)),
                   schema=arrow_schema, record_name=table)
        return rows

    if output_format == "json":
        # line-delimited JSON (nds/nds_transcode.py:61-144); a bulk data
        # part, re-made by re-running the table's transcode, so written in
        # place rather than through a temp rename
        import json as _json

        os.makedirs(dst, exist_ok=True)
        # nds-lint: disable=atomic-write
        with open(os.path.join(dst, basename.format(i=0)), "w") as f:
            for b in batches():
                for row in b.to_pylist():
                    f.write(_json.dumps(row, default=str) + "\n")
        return rows

    if output_format == "orc":
        # pyarrow's dataset writer has no ORC backend: stream the batches
        # through an ORCWriter (one file, no hive partitioning:
        # nds/nds_transcode.py:100-112)
        from pyarrow import orc as paorc

        os.makedirs(dst, exist_ok=True)
        writer = paorc.ORCWriter(os.path.join(dst, basename.format(i=0)))
        try:
            for b in batches():
                writer.write(pa.Table.from_batches([b], schema=arrow_schema))
        finally:
            writer.close()
        return rows

    part_col = TABLE_PARTITIONING.get(table) if partition else None
    if part_col is not None and output_format == "parquet":
        # hive layout <col>=<value>/, one directory per date key: the
        # reference's partitionBy(date_sk) warehouse layout
        return _write_hive_partitioned_parquet(
            src, dst, schema, arrow_schema, part_col, use_decimal,
            compression or "snappy", basename,
        )

    write_opts = None
    if output_format == "parquet":
        fmt = pads.ParquetFileFormat()
        write_opts = fmt.make_write_options(compression=compression or "snappy")
    else:
        fmt = pads.CsvFileFormat()
    kwargs = {}
    if part_col is not None:
        kwargs["partitioning"] = pads.partitioning(
            pa.schema([arrow_schema.field(part_col)]), flavor="hive"
        )
        kwargs["max_partitions"] = 1 << 16
        kwargs["max_open_files"] = 1 << 14
    pads.write_dataset(
        batches(),
        base_dir=dst,
        format=fmt,
        file_options=write_opts,
        schema=arrow_schema,
        basename_template=basename,
        existing_data_behavior="overwrite_or_ignore",
        **kwargs,
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


# ---------------------------------------------------------------------------
# parallel resumable lakehouse ingest
# ---------------------------------------------------------------------------


def _ingest_file_bytes() -> int:
    """Target bytes per committed data file (NDS_INGEST_FILE_BYTES, default
    64 MiB): clustered chunks split at this size, so each file covers a
    narrow key range its zone map can prune."""
    return int(os.environ.get("NDS_INGEST_FILE_BYTES", 64 << 20))


def _chunk_id(table: str, path: str) -> str:
    """Ledger id of one generator chunk file. Basename only, so a dataset
    moved between hosts (another input_prefix) still resumes."""
    return f"{table}:{os.path.basename(path)}"


def _chunk_files(src: str) -> list:
    """The generator chunk files of a table in ledger order (the listing
    io/csv reads, so chunk ids are stable across runs)."""
    import glob

    if os.path.isfile(src):
        return [src]
    return sorted(glob.glob(os.path.join(src, "*.dat")))


class _Prefetch:
    """Depth-1 decode-ahead: a daemon thread parses chunk i+1 while the
    consumer stages and commits chunk i. Queue depth 1 bounds the buffer
    to two decoded chunks (one queued, one consumed) plus the one being
    decoded."""

    _END = object()

    def __init__(self, paths, schema, use_decimal):
        self._q = queue.Queue(maxsize=1)
        self._t = threading.Thread(
            target=self._run, args=(list(paths), schema, use_decimal),
            daemon=True,
        )
        self._t.start()

    def _run(self, paths, schema, use_decimal):
        from .io.csv import read_dat_file

        try:
            for p in paths:
                t0 = _perf()
                tbl = read_dat_file(p, schema, use_decimal)
                self._q.put((p, tbl, (_perf() - t0) * 1000.0))
        except BaseException as e:  # surfaced to the consumer thread
            self._q.put(e)
        else:
            self._q.put(self._END)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


def _ingest_chunks(dst, table, schema, use_decimal, chunk_files, part_col):
    """Ingest a shard of chunk files into the table at `dst`, one ledgered
    commit per chunk, in the calling process (each pool worker calls this
    over its shard; its LakehouseTable carries the process's own writer
    lease). Returns (rows_committed, chunks_committed); chunks already in
    the ledger count toward neither."""
    from .lakehouse.table import LakehouseTable
    from .obs import trace as obs_trace

    lt = LakehouseTable(dst)
    tracer = obs_trace.current()
    ctx = owned = None
    if tracer is None:
        # CLI / pool-worker path: no session bound a tracer in this
        # thread, so build one from the environment (NDS_TRACE_DIR etc.)
        # and bind it: fault hooks and ingest events land in the stream
        # that profile --critical-path reads
        tracer = owned = obs_trace.tracer_from_conf(None)
        if tracer is not None:
            ctx = obs_trace.bind(tracer)
            ctx.__enter__()
    rows = committed = 0
    try:
        for path, tbl, decode_ms in _Prefetch(chunk_files, schema,
                                              use_decimal):
            chunk = _chunk_id(table, path)
            t0 = _perf()
            version = lt.ingest_chunk(
                tbl, chunk, cluster_by=part_col,
                max_file_bytes=_ingest_file_bytes(),
            )
            commit_ms = (_perf() - t0) * 1000.0
            if tracer is not None:
                tracer.emit(
                    "ingest_chunk", table=table, chunk=chunk,
                    rows=tbl.num_rows, decode_ms=round(decode_ms, 3),
                    commit_ms=round(commit_ms, 3),
                    skipped=version is None, version=version,
                )
            if version is not None:
                rows += tbl.num_rows
                committed += 1
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
        if owned is not None:
            owned.close()
    return rows, committed


def _ingest_worker(payload):
    """Top-level (spawn-picklable) pool entry point."""
    return _ingest_chunks(*payload)


def _lakehouse_ingest(src, dst, table, schema, arrow_schema, use_decimal,
                      workers) -> int:
    """Parallel resumable ingest of one table: chunk files shard
    round-robin over a spawn pool of `workers` processes; the manifest's
    ingest ledger is the only checkpoint. Returns the rows this run
    committed: a re-run over a complete table returns 0, and the
    manifest's num_rows is the durable total."""
    from .lakehouse.table import LakehouseTable

    if not LakehouseTable.is_table(dst):
        LakehouseTable.create(dst, schema=arrow_schema)
    done = LakehouseTable(dst).snapshot().ingest_chunks()
    pending = [p for p in _chunk_files(src)
               if _chunk_id(table, p) not in done]
    if not pending:
        return 0
    part_col = TABLE_PARTITIONING.get(table)
    workers = max(1, min(int(workers or 1), len(pending)))
    if workers == 1:
        rows, _ = _ingest_chunks(
            dst, table, schema, use_decimal, pending, part_col
        )
        return rows
    import multiprocessing as mp

    payloads = [
        (dst, table, schema, use_decimal, pending[i::workers], part_col)
        for i in range(workers)
    ]
    # spawn, not fork: a forked worker would inherit the parent's Arrow and
    # CUDA state; a spawned one imports the package afresh, decodes on the
    # host and registers its own catalog writer lease
    with mp.get_context("spawn").Pool(processes=workers) as pool:
        results = pool.map(_ingest_worker, payloads)
    return sum(r for r, _ in results)


def transcode(args) -> dict:
    """Run the full load test; writes the report file; returns timing dict."""
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
            workers=getattr(args, "workers", 1),
            resume=getattr(args, "resume", False),
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
    # the report module pulls in the engine: imported only where the report
    # is written, so the spawn workers of the lakehouse ingest never load it
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
