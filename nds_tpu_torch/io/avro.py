"""Minimal Avro Object Container File writer/reader for Arrow tables: the
port of nds_tpu/io/avro.py (pyarrow imported inside the functions that
use it).

The reference's transcode offers avro output through an external Spark
plugin jar (reference: nds/nds_transcode.py:241-249 `--output_format avro`,
README note that it needs `spark-avro`). This environment has no avro
library, so the subset of the 1.11 spec the NDS schemas need is implemented
directly:

  * container layout: magic `Obj\\x01`, metadata map (schema JSON + codec
    null), 16-byte sync marker, then blocks of (record count, byte size,
    records, sync)
  * encodings: zigzag-varint longs/ints, IEEE-754 LE doubles, length-prefixed
    utf8 strings/bytes, union index for nullable fields
  * logical types: date as int (days since epoch), decimal as big-endian
    two's-complement bytes with precision/scale in the schema

Reader included so round-trips are testable without external tooling.
"""

from __future__ import annotations

import io
import json
import struct

MAGIC = b"Obj\x01"
SYNC = bytes(range(16))  # deterministic marker: files are reproducible


# ---------------------------------------------------------------------------
# primitive encoders / decoders
# ---------------------------------------------------------------------------


def _zigzag(n: int) -> bytes:
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_zigzag(buf: io.BytesIO) -> int:
    shift = 0
    u = 0
    while True:
        b = buf.read(1)[0]
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (u >> 1) ^ -(u & 1)


def _enc_bytes(b: bytes) -> bytes:
    return _zigzag(len(b)) + b


def _read_bytes(buf: io.BytesIO) -> bytes:
    return buf.read(_read_zigzag(buf))


def _decimal_bytes(unscaled: int) -> bytes:
    length = max(1, (unscaled.bit_length() + 8) // 8)
    return unscaled.to_bytes(length, "big", signed=True)


# ---------------------------------------------------------------------------
# schema mapping
# ---------------------------------------------------------------------------


def _avro_field_type(f: pa.Field):
    import pyarrow as pa

    t = f.type
    if pa.types.is_int64(t):
        base = "long"
    elif pa.types.is_int32(t):
        # spark-avro maps IntegerType to avro "int"; keep schema parity so
        # downstream consumers see 32-bit fields (reference: transcode avro
        # output consumed by nds_validate)
        base = "int"
    elif pa.types.is_floating(t):
        base = "double"
    elif pa.types.is_boolean(t):
        base = "boolean"
    elif pa.types.is_date32(t):
        base = {"type": "int", "logicalType": "date"}
    elif pa.types.is_decimal(t):
        base = {
            "type": "bytes",
            "logicalType": "decimal",
            "precision": t.precision,
            "scale": t.scale,
        }
    elif pa.types.is_string(t) or pa.types.is_large_string(t):
        base = "string"
    else:
        raise ValueError(f"unsupported arrow type for avro: {t}")
    if f.nullable:
        return ["null", base]
    return base


def arrow_to_avro_schema(schema: pa.Schema, name: str) -> dict:
    return {
        "type": "record",
        "name": name,
        "fields": [
            {"name": f.name, "type": _avro_field_type(f)} for f in schema
        ],
    }


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _encode_value(out: bytearray, t: pa.DataType, v):
    import pyarrow as pa

    if pa.types.is_int64(t) or pa.types.is_int32(t):
        out += _zigzag(int(v))
    elif pa.types.is_floating(t):
        out += struct.pack("<d", float(v))
    elif pa.types.is_boolean(t):
        out.append(1 if v else 0)
    elif pa.types.is_date32(t):
        out += _zigzag(
            v.toordinal() - 719163 if hasattr(v, "toordinal") else int(v)
        )
    elif pa.types.is_decimal(t):
        unscaled = int(v.scaleb(t.scale).to_integral_value())
        out += _enc_bytes(_decimal_bytes(unscaled))
    else:  # string
        out += _enc_bytes(str(v).encode("utf-8"))


def write_avro(batches, path: str, schema: pa.Schema = None,
               record_name: str = "row", rows_per_block: int = 4096):
    """Write a pa.Table or an iterable of record batches. Batch iterables
    stream block-by-block (one container block per slice), keeping memory
    bounded by a single batch — the same morsel contract as the other
    transcode formats."""
    import pyarrow as pa

    if isinstance(batches, pa.Table):
        schema = batches.schema
        batches = batches.to_batches(max_chunksize=rows_per_block)
    elif schema is None:
        raise ValueError("schema is required when streaming batches")
    schema_json = json.dumps(arrow_to_avro_schema(schema, record_name))
    fields = list(schema)
    with open(path, "wb") as f:
        f.write(MAGIC)
        meta = {
            "avro.schema": schema_json.encode("utf-8"),
            "avro.codec": b"null",
        }
        f.write(_zigzag(len(meta)))
        for k, v in meta.items():
            f.write(_enc_bytes(k.encode("utf-8")))
            f.write(_enc_bytes(v))
        f.write(_zigzag(0))  # end of metadata map
        f.write(SYNC)
        for batch in batches:
            for start in range(0, batch.num_rows, rows_per_block):
                rows = batch.slice(start, rows_per_block).to_pylist()
                if not rows:
                    continue
                out = bytearray()
                for row in rows:
                    for fld in fields:
                        v = row[fld.name]
                        if fld.nullable:
                            if v is None:
                                out += _zigzag(0)  # union branch: null
                                continue
                            out += _zigzag(1)
                        _encode_value(out, fld.type, v)
                f.write(_zigzag(len(rows)))
                f.write(_zigzag(len(out)))
                f.write(out)
                f.write(SYNC)


# ---------------------------------------------------------------------------
# reader (round-trip verification)
# ---------------------------------------------------------------------------


def _decode_value(buf: io.BytesIO, ftype):
    if isinstance(ftype, dict):
        lt = ftype.get("logicalType")
        if lt == "date":
            import datetime

            return datetime.date.fromordinal(_read_zigzag(buf) + 719163)
        if lt == "decimal":
            import decimal

            raw = _read_bytes(buf)
            unscaled = int.from_bytes(raw, "big", signed=True)
            return decimal.Decimal(unscaled).scaleb(-ftype["scale"])
        ftype = ftype["type"]
    if ftype == "long" or ftype == "int":
        return _read_zigzag(buf)
    if ftype == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if ftype == "boolean":
        return buf.read(1)[0] == 1
    if ftype == "string":
        return _read_bytes(buf).decode("utf-8")
    raise ValueError(f"unsupported avro type {ftype}")


def read_avro(path: str):
    """Read an avro container file written by write_avro -> list of dicts."""
    with open(path, "rb") as f:
        data = f.read()
    buf = io.BytesIO(data)
    assert buf.read(4) == MAGIC, "not an avro container file"
    meta = {}
    while True:
        n = _read_zigzag(buf)
        if n == 0:
            break
        if n < 0:
            # spec: a negative map block count is followed by the block's
            # byte size, then |n| entries
            _read_zigzag(buf)
            n = -n
        for _ in range(n):
            k = _read_bytes(buf).decode("utf-8")
            meta[k] = _read_bytes(buf)
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    sync = buf.read(16)
    rows = []
    while buf.tell() < len(data):
        count = _read_zigzag(buf)
        _size = _read_zigzag(buf)
        for _ in range(count):
            row = {}
            for fld in schema["fields"]:
                ftype = fld["type"]
                if isinstance(ftype, list):  # nullable union
                    if _read_zigzag(buf) == 0:
                        row[fld["name"]] = None
                        continue
                    ftype = ftype[1]
                row[fld["name"]] = _decode_value(buf, ftype)
            rows.append(row)
        assert buf.read(16) == sync, "sync marker mismatch"
    return rows
