"""Raw data ingestion, pipe-delimited .dat files -> Arrow: the port of
nds_tpu/io/csv.py (pyarrow imported inside the functions that read).

Counterpart of the reference's CSV scan (reference: nds/nds_transcode.py:56-58
`session.read.option(delimiter='|').option('header','false').csv(path, schema)`).
Generator rows end with a trailing '|' so a phantom empty column is appended
during parse and dropped here; empty strings are nulls. `use_decimal`
converts decimal columns to decimal128, or to float64 (`--floats`).
"""

from __future__ import annotations

import glob
import os


def _read_options(schema):
    import pyarrow.csv as pacsv

    names = [f.name for f in schema] + ["_trailing"]
    return pacsv.ReadOptions(column_names=names)


def _parse_options():
    import pyarrow.csv as pacsv

    return pacsv.ParseOptions(delimiter="|")


def _convert_options(schema, use_decimal):
    import pyarrow as pa
    import pyarrow.csv as pacsv

    types = {f.name: f.dtype.to_arrow(use_decimal) for f in schema}
    types["_trailing"] = pa.string()
    return pacsv.ConvertOptions(
        column_types=types,
        strings_can_be_null=True,
        quoted_strings_can_be_null=True,
    )


def _empty_table(schema, use_decimal):
    import pyarrow as pa

    return pa.table(
        {f.name: pa.array([], type=f.dtype.to_arrow(use_decimal)) for f in schema}
    )


def _chunk_files(path):
    """The .dat file `path`, or the chunk files of a per-table directory in
    name order."""
    if os.path.isfile(path):
        return [path]
    files = sorted(glob.glob(os.path.join(path, "*.dat")))
    if not files:
        raise FileNotFoundError(f"no .dat files under {path}")
    return files


def read_dat_file(path, schema, use_decimal=True):
    """One .dat file as an Arrow table of `schema`."""
    import pyarrow.csv as pacsv

    if os.path.getsize(path) == 0:
        # small scale factors legitimately produce empty refresh chunks
        return _empty_table(schema, use_decimal)
    t = pacsv.read_csv(
        path,
        read_options=_read_options(schema),
        parse_options=_parse_options(),
        convert_options=_convert_options(schema, use_decimal),
    )
    return t.drop_columns(["_trailing"])


def read_dat_dir(path, schema, use_decimal=True):
    """Read a per-table directory of chunk files (or a single file)."""
    import pyarrow as pa

    parts = [read_dat_file(f, schema, use_decimal) for f in _chunk_files(path)]
    return parts[0] if len(parts) == 1 else pa.concat_tables(parts)


def iter_dat_chunk_tables(path, schema, use_decimal=True):
    """Yield one whole Arrow table per generator chunk file (or the single
    file). Host memory is bounded by the chunk size, which generation
    parallelism keeps roughly constant across scale factors; the
    partitioned transcode writer sorts each chunk by its partition key, so
    it needs chunk granularity rather than fixed-byte morsels."""
    for f in _chunk_files(path):
        yield read_dat_file(f, schema, use_decimal)


def iter_dat_batches(path, schema, use_decimal=True, block_size=64 << 20):
    """Stream a .dat file or chunk directory as Arrow record batches of
    about `block_size` bytes each, so that a fact table streams through a
    fixed host-memory footprint (reference analogue: Spark's partitioned
    CSV scan, nds/nds_transcode.py:56-58)."""
    import pyarrow.csv as pacsv

    ropts = _read_options(schema)
    ropts.block_size = block_size
    for f in _chunk_files(path):
        if os.path.getsize(f) == 0:
            continue
        with pacsv.open_csv(
            f,
            read_options=ropts,
            parse_options=_parse_options(),
            convert_options=_convert_options(schema, use_decimal),
        ) as reader:
            for batch in reader:
                yield batch.drop_columns(["_trailing"])
