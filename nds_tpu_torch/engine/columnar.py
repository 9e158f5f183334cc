"""Columnar data model of the PyTorch/CUDA engine.

Port of nds_tpu/engine/columnar.py over torch tensors. The device-resident
unit of work is a `Table`: named `Column`s whose buffers are dense tensors
padded to a shared *capacity* (a power-of-two bucket >= the live row count),
plus an optional live mask for deferred compaction. The executor's logic
depends on both throughout, so they are kept exactly as the JAX package has
them; dropping the padding is a later performance change.

Representation (see nds_tpu_torch/dtypes.py):
  - integers / dates        -> int32 / int64 tensors
  - decimal(p,s)            -> scaled int64 (value * 10^s), float64 in float mode
  - char/varchar/string     -> int32 dictionary codes on device; the distinct
                               values live host-side in a pyarrow array
  - NULLs                   -> separate bool validity tensor (None == all valid)

pyarrow is imported only inside the functions that convert to or from Arrow
and inside the string-dictionary helpers: `table_from_numpy` and the whole
numeric device path need numpy and torch alone.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..dtypes import DType, parse_dtype

# Minimum capacity bucket (the JAX package's _MIN_CAP).
_MIN_CAP = 1024

#: numpy dtype -> torch dtype for the device buffers this engine uses
_TORCH_DTYPE = {
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.bool_): torch.bool,
}


def torch_dtype(dtype: DType):
    """torch dtype of the dense device buffer for a logical type."""
    return _TORCH_DTYPE[np.dtype(dtype.device_np_dtype())]


def bucket_cap(n: int) -> int:
    """Smallest power-of-two capacity >= n (>= _MIN_CAP)."""
    cap = _MIN_CAP
    while cap < n:
        cap *= 2
    return cap


@dataclass(frozen=True)
class ColStats:
    """Host-side column statistics captured once at catalog load.

    Bounds are over the column's *base-table* non-null values, so they stay
    conservatively valid through any row subset and any gather. `unique`
    means the base column's non-null values are pairwise distinct. The
    dense star-join and the direct aggregation gate on these, so choosing a
    physical strategy costs no device round trip."""

    vmin: int
    vmax: int
    unique: bool
    base_rows: int  # live rows of the base table the bounds came from


@dataclass(frozen=True)
class Column:
    """One column: device buffer + optional validity + optional dictionary.

    `data` and `valid` are padded to the owning Table's capacity; entries at
    index >= nrows (or outside the live mask) are garbage and must never
    influence results."""

    data: torch.Tensor
    dtype: DType
    valid: Optional[torch.Tensor] = None  # bool; None == all valid
    dictionary: Optional[object] = None  # pa.Array of distinct strings
    stats: Optional[ColStats] = None

    def subset_stats(self) -> Optional[ColStats]:
        """Stats valid for any row-subset/permutation of this column."""
        return self.stats

    def gather_stats(self) -> Optional[ColStats]:
        """Stats valid after a gather with possible repeats (join output):
        bounds survive, uniqueness does not."""
        if self.stats is None:
            return None
        return replace(self.stats, unique=False)


class Table:
    """A named collection of equal-capacity columns with a live row count.

    Deferred compaction: `live` (when set) is a per-row liveness mask, and
    `nrows` may be a 0-d device tensor that only crosses to the host on
    first access (`.item()`)."""

    __slots__ = ("columns", "_nrows", "live", "_packed", "unique_key")

    def __init__(self, columns: dict, nrows, live=None, unique_key=None):
        self.columns = columns  # name -> Column (insertion-ordered)
        self._nrows = nrows  # host int or 0-d device tensor (lazy)
        self.live = live  # None (first nrows rows live) or bool[cap]
        self._packed = None  # memoized compacted() result
        self.unique_key = unique_key

    @property
    def nrows(self) -> int:
        if not isinstance(self._nrows, int):
            self._nrows = int(self._nrows.item())  # device sync on first need
        return self._nrows

    @property
    def nrows_known(self):
        """The live row count if already on the host, else None."""
        return self._nrows if isinstance(self._nrows, int) else None

    @property
    def nrows_lazy(self):
        """The live row count without forcing a device sync."""
        return self._nrows

    @property
    def cap(self) -> int:
        for c in self.columns.values():
            return int(c.data.shape[0])
        return bucket_cap(self.nrows) if self.nrows > 0 else 0

    @property
    def names(self):
        return list(self.columns.keys())

    def row_mask(self, device=None) -> torch.Tensor:
        """Bool mask of live rows. `device` is needed only for a table
        without columns (whose device cannot be read off a buffer)."""
        if self.live is not None:
            return self.live
        for c in self.columns.values():
            device = c.data.device
            break
        return torch.arange(self.cap, device=device) < self._nrows

    def compacted(self) -> "Table":
        """Pack live rows to the front (drops the mask); memoized."""
        if self.live is None:
            return self
        if self._packed is not None:
            return self._packed
        from ..ops import kernels as K

        count = self.nrows
        cap = bucket_cap(max(count, 1))
        idx = K.compact_indices(self.live, cap)
        cols = {}
        for name, c in self.columns.items():
            cols[name] = Column(
                c.data[idx], c.dtype,
                None if c.valid is None else c.valid[idx],
                c.dictionary, c.subset_stats(),
            )
        self._packed = Table(cols, count, unique_key=self.unique_key)
        return self._packed

    def select(self, names) -> "Table":
        uk = self.unique_key
        if uk is not None and not uk <= set(names):
            uk = None
        return Table(
            {n: self.columns[n] for n in names}, self._nrows, self.live,
            unique_key=uk,
        )


def table_device_bytes(table: Table) -> int:
    """Device bytes held by a table's buffers (data + validity masks;
    capacity-padded shapes are static, so this never syncs the device).
    The one byte-estimation rule: the catalog's residency budget reads
    it."""
    total = 0
    for c in table.columns.values():
        total += int(c.data.nbytes)
        if c.valid is not None:
            total += int(c.valid.nbytes)
    return total


# ---------------------------------------------------------------------------
# Bounded row windows (blocked union aggregation)
# ---------------------------------------------------------------------------


def window_slice(table: Table, start: int, cap: int) -> Table:
    """Rows [start, start+cap) of a compacted table as a Table of capacity
    `cap`: a view of each buffer, never a gather or a copy (the JAX
    package's per-column dynamic slices).

    `cap` must be a power-of-two bucket <= table.cap and `start` a multiple
    of `cap`, so the slice never runs past the end (both caps are
    power-of-two buckets, hence table.cap is a multiple of cap)."""
    if table.live is not None:
        raise ValueError("window_slice requires a compacted table")
    if cap >= table.cap:
        return table
    if start % cap:
        raise ValueError(f"window start {start} not aligned to cap {cap}")
    nrows = min(max(table.nrows - start, 0), cap)
    cols = {}
    for name, c in table.columns.items():
        cols[name] = Column(
            c.data[start:start + cap],
            c.dtype,
            None if c.valid is None else c.valid[start:start + cap],
            c.dictionary,
            c.subset_stats(),
        )
    return Table(cols, nrows, unique_key=table.unique_key)


# ---------------------------------------------------------------------------
# Host -> device from numpy (the port's state hand-over)
# ---------------------------------------------------------------------------


def _to_device_padded(arr: np.ndarray, cap: int, device, fill=0):
    """Upload a host array into a fresh capacity-padded device buffer (the
    JAX package's _pad_to after the upload). The padding is written on the
    device, so the host never holds a padded copy of a fact-sized
    column."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # Arrow buffers are read-only
        arr = arr.copy()
    out = torch.full(
        (cap,), fill, dtype=_TORCH_DTYPE[arr.dtype], device=device
    )
    out[: arr.shape[0]] = torch.from_numpy(arr).to(device)
    return out


def _numpy_stats(data: np.ndarray, valid, dtype: DType, nrows: int):
    """ColStats of an integer-like column from its host values (the numpy
    counterpart of arrow_column_stats)."""
    if dtype.kind not in ("int32", "int64", "date") or nrows == 0:
        return None
    vals = data[:nrows]
    if valid is not None:
        vals = vals[np.asarray(valid[:nrows], dtype=bool)]
    if vals.size == 0:
        return None
    unique = False
    if nrows <= _UNIQUE_STATS_MAX_ROWS:
        unique = np.unique(vals).size == vals.size
    return ColStats(int(vals.min()), int(vals.max()), unique, nrows)


def table_from_numpy(columns: dict, nrows: int, stats=None,
                     device="cuda") -> Table:
    """Build a port Table from the numpy form of a JAX `Table`.

    `columns` maps name -> (data, valid, dtype_str, dictionary): `data` the
    device buffer as a numpy array (its length may be the JAX capacity or
    just nrows), `valid` a bool array or None, `dtype_str` the logical type
    (`str(DType)`), `dictionary` the host string dictionary (a pa.Array or
    a list of str) or None. `stats` maps name -> ColStats (or a
    (vmin, vmax, unique, base_rows) tuple); where it is None the stats of
    integer-like columns are computed from the host values, as a catalog
    load does."""
    cap = bucket_cap(nrows)
    cols = {}
    for name, (data, valid, dtype_str, dictionary) in columns.items():
        dtype = parse_dtype(dtype_str)
        data = np.asarray(data)[:nrows].astype(
            dtype.device_np_dtype(), copy=False
        )
        v = None
        if valid is not None:
            valid = np.asarray(valid, dtype=bool)[:nrows]
            if not valid.all():
                v = _to_device_padded(valid, cap, device, fill=False)
        if dictionary is not None and not hasattr(dictionary, "cast"):
            import pyarrow as pa

            dictionary = pa.array(list(dictionary), type=pa.string())
        if stats is None:
            st = _numpy_stats(data, valid, dtype, nrows)
        else:
            st = stats.get(name)
            if st is not None and not isinstance(st, ColStats):
                st = ColStats(*st)
        cols[name] = Column(
            _to_device_padded(data, cap, device), dtype, v, dictionary, st
        )
    return Table(cols, nrows)


# ---------------------------------------------------------------------------
# Host <-> device via Arrow (pyarrow imported inside each function)
# ---------------------------------------------------------------------------


def _np_valid(arr) -> Optional[np.ndarray]:
    import pyarrow.compute as pc

    if arr.null_count == 0:
        return None
    return pc.is_valid(arr).to_numpy(zero_copy_only=False)


def column_from_arrow(arr, dtype: DType, cap: int, device) -> Column:
    """Decode one Arrow column into the device representation."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    valid_np = _np_valid(arr)
    if dtype.is_string:
        if not pa.types.is_dictionary(arr.type):
            arr = pc.dictionary_encode(arr)
        np_vals = np.asarray(
            arr.indices.fill_null(0).to_numpy(zero_copy_only=False),
            dtype=np.int32,
        )
        dictionary = arr.dictionary
    else:
        dictionary = None
        if dtype.is_decimal:
            if pa.types.is_decimal(arr.type):
                import decimal

                shift = pa.scalar(decimal.Decimal(10**dtype.scale))
                scaled = pc.multiply(
                    arr.cast(pa.decimal128(18, arr.type.scale)), shift
                )
                np_vals = scaled.fill_null(0).cast(pa.int64()).to_numpy(
                    zero_copy_only=False
                )
            else:
                scale = 10 ** dtype.scale
                f = arr.cast(pa.float64()).fill_null(0.0).to_numpy(
                    zero_copy_only=False
                )
                np_vals = np.round(f * scale).astype(np.int64)
            np_vals = np.asarray(np_vals, dtype=np.int64)
        elif dtype.kind == "date":
            np_vals = arr.cast(pa.int32()).fill_null(0).to_numpy(
                zero_copy_only=False
            )
        else:
            npdt = dtype.device_np_dtype()
            filled = arr.fill_null(0) if arr.null_count else arr
            np_vals = np.asarray(
                filled.to_numpy(zero_copy_only=False), dtype=npdt
            )
    data = _to_device_padded(np.asarray(np_vals), cap, device)
    valid = None
    if valid_np is not None:
        valid = _to_device_padded(valid_np, cap, device, fill=False)
    return Column(data, dtype, valid, dictionary)


# Above this many rows, per-column uniqueness is skipped at load (only
# dimension-sized build sides benefit).
_UNIQUE_STATS_MAX_ROWS = 1 << 22


def arrow_column_stats(arr, dtype: DType, nrows: int) -> Optional[ColStats]:
    """Host-side min/max/uniqueness of an integer-like Arrow column."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if dtype.kind not in ("int32", "int64", "date"):
        return None
    if nrows == 0:
        return None
    if isinstance(arr, pa.ChunkedArray) and arr.num_chunks == 0:
        return None
    if dtype.kind == "date":
        arr = arr.cast(pa.int32())
    mm = pc.min_max(arr)
    vmin, vmax = mm["min"], mm["max"]
    if not vmin.is_valid:  # all-null column
        return None
    vmin = vmin.cast(pa.int64()).as_py()
    vmax = vmax.cast(pa.int64()).as_py()
    unique = False
    if nrows <= _UNIQUE_STATS_MAX_ROWS:
        n_valid = nrows - arr.null_count
        unique = pc.count_distinct(arr, mode="only_valid").as_py() == n_valid
    return ColStats(vmin, vmax, unique, nrows)


def table_from_arrow(batch, schema=None, with_stats: bool = False,
                     device="cuda") -> Table:
    """Build a device Table from an Arrow table (`schema` supplies logical
    types; `with_stats` captures per-column ColStats)."""
    import pyarrow as pa

    nrows = batch.num_rows
    cap = bucket_cap(nrows)
    cols = {}
    if isinstance(batch, pa.RecordBatch):
        batch = pa.Table.from_batches([batch])
    for i, name in enumerate(batch.column_names):
        if schema is not None and name in schema:
            dtype = schema.field(name).dtype
        else:
            dtype = _infer_dtype(batch.schema.field(i).type)
        col = column_from_arrow(batch.column(i), dtype, cap, device)
        if with_stats:
            stats = arrow_column_stats(batch.column(i), dtype, nrows)
            if stats is not None:
                col = replace(col, stats=stats)
        cols[name] = col
    return Table(cols, nrows)


def _infer_dtype(t) -> DType:
    import pyarrow as pa

    if pa.types.is_int32(t) or pa.types.is_int16(t) or pa.types.is_int8(t):
        return parse_dtype("int32")
    if pa.types.is_int64(t):
        return parse_dtype("int64")
    if pa.types.is_floating(t):
        return parse_dtype("float64")
    if pa.types.is_decimal(t):
        return DType("decimal", t.precision, t.scale)
    if pa.types.is_date(t):
        return parse_dtype("date")
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return parse_dtype("string")
    if pa.types.is_dictionary(t):
        return parse_dtype("string")
    if pa.types.is_boolean(t):
        return parse_dtype("int32")
    raise ValueError(f"unsupported arrow type {t}")


def column_to_arrow(col: Column, nrows: int, host=None):
    """Materialize a device column back into Arrow. `host`: optional
    pre-fetched (data, valid) numpy pair."""
    import pyarrow as pa

    if host is not None:
        data, valid = host
        data = data[:nrows]
        valid = None if valid is None else valid[:nrows]
    else:
        data = col.data[:nrows].cpu().numpy()
        valid = (
            None if col.valid is None else col.valid[:nrows].cpu().numpy()
        )
    mask = None if valid is None else ~valid
    dt = col.dtype
    if dt.is_string:
        codes = pa.array(data.astype(np.int32), mask=mask)
        return pa.DictionaryArray.from_arrays(codes, col.dictionary).cast(
            pa.string()
        )
    if dt.is_decimal:
        ints = data.astype("<i8")
        buf = np.empty((len(ints), 2), dtype="<i8")
        buf[:, 0] = ints
        buf[:, 1] = ints >> 63
        validity = None
        if mask is not None:
            validity = pa.array(~mask).buffers()[1]
        return pa.Array.from_buffers(
            pa.decimal128(dt.precision, dt.scale), len(ints),
            [validity, pa.py_buffer(buf.tobytes())],
        )
    if dt.kind == "date":
        return pa.array(data.astype(np.int32), mask=mask).cast(pa.date32())
    if dt.kind == "bool":
        return pa.array(data.astype(bool), mask=mask)
    return pa.array(data, mask=mask)


def table_to_numpy(table: Table) -> dict:
    """Live rows of a table as host numpy: name -> (data, valid|None), one
    device->host copy per buffer."""
    table = table.compacted()
    n = table.nrows
    out = {}
    for name, c in table.columns.items():
        data = c.data[:n].cpu().numpy()
        valid = None if c.valid is None else c.valid[:n].cpu().numpy()
        out[name] = (data, valid)
    return out


def table_to_arrow(table: Table):
    import pyarrow as pa

    table = table.compacted()  # deferred-compaction tables pack here
    host = table_to_numpy(table)
    arrays = [
        column_to_arrow(c, table.nrows, host=host[name])
        for name, c in table.columns.items()
    ]
    return pa.table(arrays, names=table.names)


# ---------------------------------------------------------------------------
# Dictionary utilities (string kernels run on the host over distinct values)
# ---------------------------------------------------------------------------


# Host-side dictionary work is a function of dictionaries and literals
# alone. A fused pipeline (engine/fuse.py) records each product once at
# build time on a tape and replays it on every call, so a call does tensor
# work only: every helper below and the Evaluator's string paths take
# their host products through `host_product`.
_HOST = threading.local()


class HostRead(Exception):
    """A fused chain read device values on the host (a number formatted as
    a string, a concat too large for a pairwise dictionary). The JAX
    package's trace fails on exactly these, and its executable cache pins
    the chain's input signature to the eager path; the port pins the same
    signatures."""


def host_product(compute):
    """compute(), or, under an active fused-pipeline tape, the product the
    tape recorded at build time (recorded now while the tape builds)."""
    tape = getattr(_HOST, "tape", None)
    if tape is None:
        return compute()
    return tape.product(compute)


def host_read_guard(what: str):
    """Raise HostRead inside a fused chain: `what` reads device values."""
    if getattr(_HOST, "tape", None) is not None:
        raise HostRead(what)


@contextmanager
def host_tape(tape):
    """Route this thread's host products through `tape`."""
    prev = getattr(_HOST, "tape", None)
    _HOST.tape = tape
    try:
        yield tape
    finally:
        _HOST.tape = prev


def device_lut(lut: np.ndarray, device) -> torch.Tensor:
    """A host lookup table on `device`."""
    return torch.from_numpy(np.ascontiguousarray(lut)).to(device)


def lut_take(t: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """t[clip(codes)] (jnp gathers clamp; torch raises on an out-of-range
    index, so the clamp is explicit). An empty table (the empty dictionary
    of a column with no value, e.g. a lakehouse scan whose zone maps pruned
    every file) gives zeros: no row reads them. The JAX package's gather
    raises there (ROADMAP.md queue 3)."""
    if t.numel() == 0:
        return torch.zeros(codes.shape, dtype=t.dtype, device=codes.device)
    return t[codes.clamp(0, max(t.shape[0] - 1, 0)).long()]


def unify_dictionaries(a: Column, b: Column):
    """Remap two string columns onto one shared dictionary. Returns
    (codes_a, codes_b, unified_dictionary)."""
    if a.dictionary is not None and a.dictionary is b.dictionary:
        return a.data, b.data, a.dictionary
    dev = a.data.device

    def build():
        import pyarrow as pa
        import pyarrow.compute as pc

        empty = pa.array([], type=pa.string())
        da = a.dictionary if a.dictionary is not None else empty
        db = b.dictionary if b.dictionary is not None else empty
        da = da.cast(pa.string())
        db = db.cast(pa.string())
        unified = pc.unique(pa.concat_arrays([da, db]))

        def remap(d):
            if not len(d):
                return None
            r = pc.index_in(d, unified).to_numpy(zero_copy_only=False)
            return device_lut(r.astype(np.int32), dev)
        return remap(da), remap(db), unified

    la, lb, unified = host_product(build)
    codes_a = lut_take(la, a.data) if la is not None else a.data
    codes_b = lut_take(lb, b.data) if lb is not None else b.data
    return codes_a, codes_b, unified


def sort_dictionary(col: Column):
    """Codes remapped so that code order == lexicographic value order."""
    d = col.dictionary
    if d is None or len(d) == 0:
        return col.data, d
    dev = col.data.device

    def build():
        import pyarrow as pa
        import pyarrow.compute as pc

        s = d.cast(pa.string())
        order = pc.array_sort_indices(s)
        rank = np.empty(len(s), dtype=np.int32)
        rank[order.to_numpy(zero_copy_only=False)] = np.arange(
            len(s), dtype=np.int32
        )
        return device_lut(rank, dev), s.take(order)

    rank, sorted_dict = host_product(build)
    return lut_take(rank, col.data), sorted_dict
