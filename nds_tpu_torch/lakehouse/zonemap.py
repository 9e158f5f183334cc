"""Zone maps: per-file column statistics and the predicate logic that
prunes files against them; the port of nds_tpu/lakehouse/zonemap.py
(pyarrow imported inside the functions that use it).

Two halves, both deliberately dumb:

* **Write side** — `StatsAccumulator` streams over the Arrow batches a
  staged file is built from and reduces each column to
  ``{"min": v, "max": v, "nulls": n}``. The committer
  (`table.LakehouseTable._commit`) records the per-file result under the
  manifest's ``stats`` key, so the statistics travel WITH the snapshot:
  pruning against a pinned version uses that version's stats, never the
  head's (the same property that makes snapshot reads consistent makes
  zone-map pruning consistent).

* **Read side** — `prune_files` evaluates a conjunction of simple
  single-column predicates (extracted by the planner; this module never
  sees an expression tree) against those stats and returns the files
  that MAY contain matching rows. Every rule errs toward keeping: a
  file with no stats (old-format manifest), a column with no bounds, a
  type mismatch between bound and literal — all read as "may match".
  Pruning is an optimization, never a filter: the engine re-applies the
  full predicate to every surviving row, so a too-conservative zone map
  costs IO, a too-aggressive one would cost correctness. Only the
  conservative direction is reachable by construction.

Bounds are recorded only for JSON-safe, totally-ordered types (ints,
floats, bools, strings). Floats with a NaN min/max drop their bounds
entirely — NaN poisons interval reasoning (Iceberg records NaN counts
for the same reason). String bounds are truncated to
`_STR_BOUND_LIMIT` chars: a truncated *min* is already a valid lower
bound (a prefix sorts <= the full string); a truncated *max* must be
rounded UP past every string sharing the prefix, and when rounding up
is impossible (all chars at the codepoint ceiling) the max is dropped.
Null counts are always recorded: an all-null file (``nulls == rows``)
can be pruned by ANY null-rejecting predicate even when the column has
no bounds.

Predicates arrive as plain tuples so the evaluation stays import-light
and unit-testable without the planner:

    ("cmp", col, op, value)      op in =, <, <=, >, >=
    ("between", col, lo, hi)     inclusive both ends
    ("in", col, (v, ...))        non-empty literal list
    ("notnull", col)             IS NOT NULL
"""

from __future__ import annotations

import math

# string min/max stored in the manifest are capped at this many chars;
# long bounds buy almost no pruning power and bloat every manifest
_STR_BOUND_LIMIT = 64

_MAX_CODEPOINT = 0x10FFFF


def _trunc_min(s: str) -> str:
    """A safe lower bound for a possibly-long string: its prefix (a
    prefix always sorts <= the full string)."""
    return s[:_STR_BOUND_LIMIT]


def _trunc_max(s: str):
    """A safe upper bound: round the truncated prefix UP so every string
    sharing it stays covered; None when no finite bound exists."""
    if len(s) <= _STR_BOUND_LIMIT:
        return s
    prefix = s[:_STR_BOUND_LIMIT]
    chars = list(prefix)
    while chars:
        cp = ord(chars[-1])
        if cp < _MAX_CODEPOINT:
            chars[-1] = chr(cp + 1)
            return "".join(chars)
        chars.pop()
    return None  # every char at the ceiling: unbounded above


def _boundable(typ: pa.DataType) -> bool:
    import pyarrow as pa

    return (
        pa.types.is_integer(typ)
        or pa.types.is_floating(typ)
        or pa.types.is_boolean(typ)
        or pa.types.is_string(typ)
        or pa.types.is_large_string(typ)
    )


def _bad_bound(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


class StatsAccumulator:
    """Streaming per-column min/max/null reduction over record batches.
    One accumulator per staged FILE; `finish()` emits the manifest
    fragment for that file."""

    def __init__(self):
        self.rows = 0
        self._cols = {}  # name -> {"min","max","nulls","dead"}

    def update(self, batch):
        import pyarrow.compute as pc

        self.rows += batch.num_rows
        for i, field in enumerate(batch.schema):
            col = batch.column(i)
            st = self._cols.setdefault(
                field.name, {"min": None, "max": None, "nulls": 0,
                             "dead": not _boundable(field.type)}
            )
            st["nulls"] += col.null_count
            if st["dead"] or col.null_count == len(col):
                continue
            try:
                mm = pc.min_max(col)
                lo, hi = mm["min"].as_py(), mm["max"].as_py()
            except Exception:
                lo = hi = None
            try:
                inverted = lo > hi  # all-NaN floats reduce to (inf, -inf)
            except TypeError:
                inverted = True
            if _bad_bound(lo) or _bad_bound(hi) or inverted:
                # NaN (or an unreducible column) poisons the interval:
                # drop bounds for the whole file, keep counting nulls
                st["dead"] = True
                st["min"] = st["max"] = None
                continue
            if isinstance(lo, str):
                lo, hi = _trunc_min(lo), _trunc_max(hi)
                if hi is None:
                    st["dead"] = True
                    st["min"] = st["max"] = None
                    continue
            if st["min"] is None or lo < st["min"]:
                st["min"] = lo
            if st["max"] is None or hi > st["max"]:
                st["max"] = hi

    def finish(self) -> dict:
        """{"rows": n, "columns": {name: {"min","max","nulls"}}} with
        min/max omitted for unboundable columns (nulls always kept)."""
        cols = {}
        for name, st in self._cols.items():
            ent = {"nulls": int(st["nulls"])}
            if not st["dead"] and st["min"] is not None:
                ent["min"] = st["min"]
                ent["max"] = st["max"]
            cols[name] = ent
        return {"rows": int(self.rows), "columns": cols}


# ---------------------------------------------------------------------------
# read side: conjunct evaluation
# ---------------------------------------------------------------------------

def _comparable(bound, value) -> bool:
    """Bound/literal pairs we trust to compare with Python's < — both
    numeric (bool excluded: True == 1 is a trap) or both strings."""
    num = (int, float)
    if isinstance(bound, bool) or isinstance(value, bool):
        return isinstance(bound, bool) and isinstance(value, bool)
    if isinstance(bound, num) and isinstance(value, num):
        return True
    return isinstance(bound, str) and isinstance(value, str)


def _may_match_one(colstats: dict | None, rows: int, pred) -> bool:
    """May any row of a file with `colstats` for the predicate's column
    satisfy the predicate? Missing information always reads True."""
    if colstats is None:
        return True
    all_null = rows > 0 and int(colstats.get("nulls", 0)) >= rows
    kind = pred[0]
    if kind == "notnull":
        return not all_null
    # the remaining kinds are null-rejecting comparisons: an all-null
    # file cannot satisfy them whether or not bounds exist
    if all_null:
        return False
    lo, hi = colstats.get("min"), colstats.get("max")
    if lo is None or hi is None:
        return True
    if kind == "cmp":
        _, _, op, v = pred
        if not _comparable(lo, v):
            return True
        if op == "=":
            return lo <= v <= hi
        if op == "<":
            return lo < v
        if op == "<=":
            return lo <= v
        if op == ">":
            return hi > v
        if op == ">=":
            return hi >= v
        return True
    if kind == "between":
        _, _, plo, phi = pred
        if not (_comparable(lo, plo) and _comparable(lo, phi)):
            return True
        return not (hi < plo or lo > phi)
    if kind == "in":
        values = pred[2]
        if not values:
            return True
        for v in values:
            if not _comparable(lo, v):
                return True
            if lo <= v <= hi:
                return True
        return False
    return True


def file_may_match(file_stats: dict | None, preds) -> bool:
    """Evaluate a conjunction against one file's manifest stats entry
    (None = file has no stats = always keep)."""
    if not file_stats:
        return True
    rows = int(file_stats.get("rows", 0))
    cols = file_stats.get("columns") or {}
    for pred in preds:
        col = pred[1]
        if not _may_match_one(cols.get(col), rows, pred):
            return False
    return True


def prune_files(rel_files, stats: dict, preds):
    """Split a snapshot's file list against a conjunction of predicates.

    Returns ``(surviving_rel_files, pruned_rows)`` where pruned_rows is
    the EXACT row count of the pruned files (every prunable file has
    stats, so the count is known, which is what lets the budgeter turn
    it into a hard surviving-row upper bound)."""
    if not preds or not stats:
        return list(rel_files), 0
    keep, pruned_rows = [], 0
    for rel in rel_files:
        fstats = stats.get(rel)
        if file_may_match(fstats, preds):
            keep.append(rel)
        else:
            pruned_rows += int(fstats.get("rows", 0))
    return keep, pruned_rows
