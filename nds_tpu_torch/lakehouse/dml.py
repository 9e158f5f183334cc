"""DML over lakehouse tables: INSERT, DELETE, CREATE TABLE AS and CALL — the
port of nds_tpu/lakehouse/dml.py.

The Data Maintenance phase issues these against the warehouse (reference:
nds/nds_maintenance.py:188-202 run_dm_query,
nds/data_maintenance/LF_SS.sql:31-68, DF_SS.sql:30-33,
nds/nds_rollback.py:46-51). Each statement's reads run through the engine
on the session's device and its writes commit a snapshot to the table's
manifest log. DELETE keeps the rows whose predicate is not TRUE (SQL
three-valued logic: a row whose predicate is NULL survives), as a
copy-on-write rewrite of the survivors.
"""

from __future__ import annotations

import os

from ..engine import expr as E
from ..engine.sql import ast as A
from .table import LakehouseError, LakehouseTable


class DmlResult:
    """The part of engine.session.Result's surface the harness uses."""

    def __init__(self, rows_affected: int, version: int | None = None):
        self.rows_affected = rows_affected
        self.version = version

    def collect(self):
        import pyarrow as pa

        return pa.table({"rows_affected": [self.rows_affected]})

    def num_rows(self):
        return 1


def _lake_table(session, name: str) -> LakehouseTable:
    entry = session.catalog.entries.get(name.lower())
    if entry is None or entry.path is None:
        raise LakehouseError(
            f"{name!r} is not a lakehouse table registered on this session"
        )
    # the session conf carries the engine.lake_* knobs the table's commit
    # loop and vacuum retention read
    return LakehouseTable(entry.path, conf=getattr(session, "conf", None))


def run_dml(session, stmt):
    if isinstance(stmt, A.InsertStmt):
        return _run_insert(session, stmt)
    if isinstance(stmt, A.DeleteStmt):
        return _run_delete(session, stmt)
    if isinstance(stmt, A.CreateTableStmt):
        return _run_ctas(session, stmt)
    if isinstance(stmt, A.CallStmt):
        return _run_call(session, stmt)
    raise TypeError(f"unsupported DML statement {type(stmt).__name__}")


def _cast_to_schema(rows, target):
    """Positional insert cast with Spark's leniency: a decimal rescale and a
    float narrowing truncate instead of raising."""
    import pyarrow as pa
    import pyarrow.compute as pc

    cols = []
    for i, field in enumerate(target):
        col = rows.column(i)
        if col.type != field.type:
            col = pc.cast(
                col,
                options=pc.CastOptions(
                    target_type=field.type,
                    allow_decimal_truncate=True,
                    allow_float_truncate=True,
                ),
            )
        cols.append(col)
    return pa.table(cols, schema=target)


def _run_insert(session, stmt: A.InsertStmt):
    table = _lake_table(session, stmt.table)
    rows = session.run_stmt(stmt.query).collect()
    target = table.schema()
    if target is not None:
        rows = _cast_to_schema(rows, target)
    version = table.append(rows, operation="insert")
    session.catalog.invalidate(stmt.table.lower())
    return DmlResult(rows.num_rows, version)


def _run_delete(session, stmt: A.DeleteStmt):
    table = _lake_table(session, stmt.table)
    # one snapshot for the whole statement: the row count and the survivor
    # scan (Arrow or engine path) read the same manifest version. The final
    # replace() aborts with CommitConflictError when a commit races its own
    # publish (an overwrite never rebases: lakehouse/table.py's conflict
    # matrix); it does not compare the head with this snapshot, so an
    # append committed before it starts is overwritten, as in the JAX
    # package (ROADMAP.md queue 3 item 12). Pinning the catalog entry
    # leases this snapshot's files up front, so a concurrent vacuum cannot
    # delete them mid-scan on any path below.
    snap = table.snapshot()
    name = stmt.table.lower()
    session.catalog.pin_lakehouse(name, version=snap.version)
    before = snap.dataset().count_rows()
    if stmt.where is None:
        # DELETE FROM t: truncate
        target = snap.schema()
        if target is None:
            raise LakehouseError(f"{stmt.table}: table has no schema")
        version = table.replace(target.empty_table(), operation="delete")
        session.catalog.invalidate(name)
        return DmlResult(before, version)

    arrow_pred = _to_arrow_predicate(session, stmt.where)
    if arrow_pred is not None:
        # streaming copy-on-write: scan file by file with the predicate
        # pushed down and stage the survivors' batches as they come, so the
        # survivor set never materialises on the host
        keep = arrow_pred.is_null() | ~arrow_pred  # a NULL predicate survives
        scanner = snap.dataset().scanner(filter=keep, batch_size=1 << 20)
        deleted = 0

        def batches():
            nonlocal deleted
            survived = 0
            for b in scanner.to_batches():
                survived += b.num_rows
                yield b
            deleted = before - survived

        version = table.replace(batches(), operation="delete")
        session.catalog.invalidate(name)
        return DmlResult(deleted, version)

    # the engine path, for predicates the Arrow translation cannot express
    # (an IN subquery: DF_SS's, DF_CS's and DF_WS's returns deletes): the
    # survivors are the rows whose predicate is FALSE or NULL. The pin is
    # held, so the nested SELECT and its subqueries over the target read
    # the version the row count came from.
    keep = E.UnaryOp("not", E.Func("coalesce", (stmt.where, E.Lit(False))))
    query = A.SelectStmt(
        select_items=[("*", None)],
        from_items=[A.TableRef(stmt.table)],
        where=keep,
    )
    with session.catalog.hold_pins([name]):
        survivors = session.run_stmt(query).collect()
    target = snap.schema()
    if target is not None:
        survivors = _cast_to_schema(survivors, target)
    version = table.replace(survivors, operation="delete")
    session.catalog.invalidate(name)
    return DmlResult(before - survivors.num_rows, version)


def _to_arrow_predicate(session, e):
    """Translate a DELETE predicate into a pyarrow dataset expression,
    evaluating scalar subqueries through the engine first (the DF_*
    predicates are ranges against date-keyed scalar subqueries; reference:
    nds/data_maintenance/DF_SS.sql:30-33). None when the predicate uses
    something the translation does not cover (the caller takes the engine
    path)."""
    import datetime

    import pyarrow.dataset as pads

    class _Unsupported(Exception):
        pass

    def scalar_value(sub):
        t = session.run_stmt(sub.query).collect()
        if t.num_rows == 0:
            raise _Unsupported()  # a NULL scalar: the engine path's 3VL
        v = t.column(0)[0].as_py()
        if v is None:
            raise _Unsupported()
        return v

    def date_of(text):
        y, m, d = text.split("-")
        return datetime.date(int(y), int(m), int(d))

    def lit_value(x):
        if (x.dtype is not None and x.dtype.kind == "date"
                and isinstance(x.value, str)):
            return date_of(x.value)
        return x.value

    def rec(x):
        if isinstance(x, E.Lit):
            return lit_value(x)
        if isinstance(x, E.Col):
            return pads.field(x.name)
        if isinstance(x, E.SubqueryExpr):
            if x.kind != "scalar":
                raise _Unsupported()
            return scalar_value(x)
        if isinstance(x, E.Cast):
            # only a date cast of a string literal translates exactly; any
            # other cast would change the comparison's meaning
            if x.target.kind == "date":
                inner = x.operand
                if isinstance(inner, E.Lit) and isinstance(inner.value, str):
                    return date_of(inner.value)
            raise _Unsupported()
        if isinstance(x, E.Between):
            op = as_expr(rec(x.operand))
            lo, hi = rec(x.low), rec(x.high)
            out = (op >= lo) & (op <= hi)
            return ~out if x.negated else out
        if isinstance(x, E.InList):
            op = as_expr(rec(x.operand))
            vals = [rec(v) for v in x.values]
            if any(v is None for v in vals):
                # a NULL in the list: Arrow's isin is two-valued, SQL's IN
                # three-valued
                raise _Unsupported()
            out = op.isin(vals)
            return ~out if x.negated else out
        if isinstance(x, E.UnaryOp):
            if x.op == "not":
                return ~as_expr(rec(x.operand))
            if x.op == "isnull":
                return as_expr(rec(x.operand)).is_null()
            if x.op == "isnotnull":
                return as_expr(rec(x.operand)).is_valid()
            raise _Unsupported()
        if isinstance(x, E.BinOp):
            a, b = rec(x.left), rec(x.right)
            if x.op in ("and", "or"):
                a, b = as_expr(a), as_expr(b)
                return a & b if x.op == "and" else a | b
            if not isinstance(a, pads.Expression) and not isinstance(
                b, pads.Expression
            ):
                # a literal-to-literal comparison folds to a Python bool,
                # which an Arrow filter cannot take
                raise _Unsupported()
            ops = {
                "=": lambda: a == b, "<>": lambda: a != b,
                "<": lambda: a < b, "<=": lambda: a <= b,
                ">": lambda: a > b, ">=": lambda: a >= b,
            }
            if x.op not in ops:
                raise _Unsupported()
            return ops[x.op]()
        raise _Unsupported()

    def as_expr(v):
        if not isinstance(v, pads.Expression):
            raise _Unsupported()
        return v

    try:
        return as_expr(rec(e))
    except _Unsupported:
        return None


def _run_ctas(session, stmt: A.CreateTableStmt):
    rows = session.run_stmt(stmt.query).collect()
    location = stmt.location
    if location is None:
        root = session.conf.get("lakehouse.warehouse")
        if root is None:
            raise LakehouseError(
                "CREATE TABLE needs a LOCATION or session conf "
                "'lakehouse.warehouse'"
            )
        location = os.path.join(root, stmt.name.lower())
    LakehouseTable.create(location, rows)
    session.register_lakehouse(stmt.name, location)
    return DmlResult(rows.num_rows, 1)


def _run_call(session, stmt: A.CallStmt):
    proc = stmt.procedure.rsplit(".", 1)[-1].lower()
    if proc != "rollback_to_timestamp":
        raise LakehouseError(f"unknown procedure {stmt.procedure}")

    def unwrap(a):
        return a.value if isinstance(a, E.Lit) else a

    table_name, ts = unwrap(stmt.args[0]), unwrap(stmt.args[1])
    table = _lake_table(session, str(table_name))
    version = table.rollback_to_timestamp(_to_ts_ms(ts))
    session.catalog.invalidate(str(table_name).lower())
    return DmlResult(0, version)


def _to_ts_ms(ts) -> int:
    """A rollback timestamp in epoch ms: a number (epoch seconds, or ms when
    at least 1e12), a string of one (a CLI argument), or a local-time
    'YYYY-mm-dd[ HH:MM:SS[.f]]'."""
    if isinstance(ts, str):
        try:
            v = float(ts)
        except ValueError:
            v = None
        # only plausible epoch magnitudes: seconds in [1e9, 1e10) (~2001 to
        # 2286) or milliseconds in [1e12, 1e13) (the same era). Anything
        # else, such as a dash-less date '20240101' (8 digits),
        # '202401011200' (12 digits, ~2e11) or '20240101120000' (14 digits,
        # ~2e13), goes to the date parser and raises there, instead of
        # being read as an epoch in 1970, 8383 or 2611
        if v is not None and (10**9 <= v < 10**10 or 10**12 <= v < 10**13):
            ts = v
    if isinstance(ts, (int, float)):
        return int(ts if ts >= 10**12 else ts * 1000)
    from datetime import datetime

    s = str(ts).strip()
    for fmt in ("%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d"):
        try:
            # a naive timestamp is local time, as the snapshot log prints it
            return int(datetime.strptime(s, fmt).timestamp() * 1000)
        except ValueError:
            continue
    raise LakehouseError(f"cannot parse timestamp {ts!r}")
