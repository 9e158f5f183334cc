"""Read-back of a transcoded table in every warehouse format, for the format
parity tests (tests/test_torch_formats.py, test_torch_transcode.py,
test_torch_power.py, test_torch_throughput.py). jax-free: the readers are
pyarrow's and the port's, so a file either package wrote reads the same
way.
"""

import json
import os

import pyarrow as pa
import pyarrow.dataset as pads

#: the formats of the Load Test besides parquet
OTHER_FORMATS = ("csv", "orc", "json", "avro", "lakehouse")


def _sorted(t):
    return t.sort_by([(c, "ascending") for c in t.column_names])


def read_back(fmt, path, arrow_schema):
    """The rows of one transcoded table directory as an Arrow table of
    `arrow_schema`'s columns, sorted: parquet and csv through pyarrow
    datasets with hive partitioning (csv columns typed by the schema), orc
    through pyarrow.orc, json line by line, avro through the port's
    reader, the lakehouse through the port's table at its head."""
    path = str(path)
    if fmt == "lakehouse":
        from nds_tpu_torch.lakehouse.table import LakehouseTable

        t = LakehouseTable(path).dataset().to_table()
    elif fmt in ("parquet", "csv"):
        names = set(arrow_schema.names)
        part = [d.split("=", 1)[0] for d in os.listdir(path) if "=" in d]
        partitioning = pads.partitioning(
            pa.schema([arrow_schema.field(part[0])]), flavor="hive"
        ) if part else None
        file_format = "parquet"
        if fmt == "csv":
            import pyarrow.csv as pacsv

            file_format = pads.CsvFileFormat(
                convert_options=pacsv.ConvertOptions(
                    column_types={f.name: f.type for f in arrow_schema
                                  if f.name in names and f.name not in part},
                    strings_can_be_null=True))
        t = pads.dataset(path, format=file_format,
                         partitioning=partitioning).to_table()
    elif fmt == "orc":
        from pyarrow import orc

        t = pa.concat_tables(orc.read_table(os.path.join(path, f))
                             for f in sorted(os.listdir(path)))
    elif fmt == "json":
        rows = []
        for f in sorted(os.listdir(path)):
            with open(os.path.join(path, f)) as fh:
                rows.extend(json.loads(line) for line in fh)
        return sorted(json.dumps(r, sort_keys=True) for r in rows)
    elif fmt == "avro":
        from nds_tpu_torch.io.avro import read_avro

        rows = []
        for f in sorted(os.listdir(path)):
            rows.extend(read_avro(os.path.join(path, f)))
        return rows
    else:
        raise ValueError(fmt)
    return _sorted(t.select(arrow_schema.names))
