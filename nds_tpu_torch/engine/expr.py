"""Scalar expression IR + columnar evaluator over torch tensors.

Port of nds_tpu/engine/expr.py. The IR dataclasses are a verbatim copy (the
parser, binder and plan build them); the `Evaluator`, `_cast_column`,
`_share_dictionary` and the date helpers are ported to torch. SQL
three-valued logic is carried as a (data, valid) pair; string functions run
on the host over the column's dictionary (pyarrow, imported inside them)
and reach the device as one gather.

Dtype promotion differs between the two frameworks: JAX with x64 gives
float64 for int/int `/` and for int32 + Python float, torch gives float32
for both. Every division, decimal rescale and float arithmetic below casts
to float64 explicitly.
"""

from __future__ import annotations

import datetime
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..dtypes import BOOL, DATE, DType, FLOAT64, INT32, INT64, STRING
from .columnar import (
    Column,
    Table,
    device_lut,
    host_product,
    host_read_guard,
    lut_take,
    sort_dictionary,
    torch_dtype,
    unify_dictionaries,
)

_EPOCH = datetime.date(1970, 1, 1)
F64 = torch.float64


def _civil_from_days(days):
    """Vectorized days-since-epoch -> (year, month, day) on device
    (Hinnant's civil calendar algorithm, integer floor arithmetic)."""
    z = days.to(torch.int64) + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def date_to_days(s: str) -> int:
    y, m, d = s.split("-")
    return (datetime.date(int(y), int(m), int(d)) - _EPOCH).days


def days_to_date(n: int) -> str:
    return (_EPOCH + datetime.timedelta(days=int(n))).isoformat()


# ---------------------------------------------------------------------------
# IR nodes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Expr:
    def children(self) -> tuple:
        return ()


@dataclass(frozen=True)
class Col(Expr):
    name: str
    table: Optional[str] = None  # qualifier, resolved during binding

    def __str__(self):
        return f"{self.table}.{self.name}" if self.table else self.name


@dataclass(frozen=True)
class Lit(Expr):
    value: object  # python int/float/str/bool/None
    dtype: DType = None  # inferred when None

    def __str__(self):
        return repr(self.value)


@dataclass(frozen=True)
class Interval(Expr):
    """INTERVAL n DAYS — only the day unit appears in the NDS dialect
    (reference: nds/tpcds-gen/patches/templates.patch date arithmetic)."""

    days: int


@dataclass(frozen=True)
class BinOp(Expr):
    op: str  # + - * / and or = <> < <= > >= ||
    left: Expr
    right: Expr

    def children(self):
        return (self.left, self.right)


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # neg, not, isnull, isnotnull
    operand: Expr

    def children(self):
        return (self.operand,)


@dataclass(frozen=True)
class Between(Expr):
    operand: Expr
    low: Expr
    high: Expr
    negated: bool = False

    def children(self):
        return (self.operand, self.low, self.high)


@dataclass(frozen=True)
class InList(Expr):
    operand: Expr
    values: tuple  # of Lit
    negated: bool = False

    def children(self):
        return (self.operand,) + self.values


@dataclass(frozen=True)
class Like(Expr):
    operand: Expr
    pattern: str
    negated: bool = False

    def children(self):
        return (self.operand,)


@dataclass(frozen=True)
class Case(Expr):
    branches: tuple  # of (cond, value)
    default: Optional[Expr]

    def children(self):
        out = []
        for c, v in self.branches:
            out += [c, v]
        if self.default is not None:
            out.append(self.default)
        return tuple(out)


@dataclass(frozen=True)
class Cast(Expr):
    operand: Expr
    target: DType

    def children(self):
        return (self.operand,)


@dataclass(frozen=True)
class Func(Expr):
    """Scalar function call: substr, coalesce, abs, round, concat, ..."""

    name: str
    args: tuple

    def children(self):
        return self.args


@dataclass(frozen=True)
class Agg(Expr):
    """Aggregate function; consumed by the Aggregate operator, never by the
    scalar evaluator."""

    fn: str  # sum avg count min max stddev_samp count_distinct sum_distinct avg_distinct grouping
    arg: Optional[Expr]  # None for count(*)
    distinct: bool = False

    def children(self):
        return () if self.arg is None else (self.arg,)


@dataclass(frozen=True)
class WindowFn(Expr):
    """Window function; consumed by the Window operator."""

    fn: str  # rank dense_rank row_number sum avg min max count
    arg: Optional[Expr]
    partition_by: tuple = ()
    order_by: tuple = ()  # of (Expr, ascending)
    frame: Optional[tuple] = None  # ((lo, unit), (hi, unit)) ROWS frame

    def children(self):
        out = list(self.partition_by) + [e for e, _ in self.order_by]
        if self.arg is not None:
            out.append(self.arg)
        return tuple(out)


@dataclass(frozen=True)
class SubqueryExpr(Expr):
    """Scalar / IN / EXISTS subquery; replaced during planning."""

    query: object  # ast.SelectStmt
    kind: str  # scalar | in | exists
    operand: Optional[Expr] = None  # for IN
    negated: bool = False


@dataclass(frozen=True)
class ScalarSubquery(Expr):
    """Bound uncorrelated scalar subquery: the executor runs `plan` once
    (cached by identity) and broadcasts the single value."""

    plan: object = field(hash=False, compare=False, default=None)
    out_name: str = ""


def walk(e: Expr):
    yield e
    for c in e.children():
        yield from walk(c)


def contains_agg(e: Expr) -> bool:
    return any(isinstance(x, Agg) for x in walk(e))


def contains_window(e: Expr) -> bool:
    return any(isinstance(x, WindowFn) for x in walk(e))



# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _lit_dtype(v) -> DType:
    if isinstance(v, bool):
        return BOOL
    if isinstance(v, int):
        return INT32 if -(2**31) <= v < 2**31 else INT64
    if isinstance(v, float):
        return FLOAT64
    if isinstance(v, str):
        return STRING
    if v is None:
        return INT32
    raise TypeError(f"bad literal {v!r}")


_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}$")


class Evaluator:
    """Evaluates an Expr over a Table, returning a Column of equal capacity.
    `device` places constants of a table without columns."""

    def __init__(self, table: Table, device=None):
        self.table = table
        for c in table.columns.values():
            device = c.data.device
            break
        self.device = device

    def eval(self, e: Expr) -> Column:
        m = getattr(self, f"_eval_{type(e).__name__.lower()}", None)
        if m is None:
            raise NotImplementedError(f"eval of {type(e).__name__}")
        return m(e)

    def _ones(self):
        return torch.ones(self.table.cap, dtype=torch.bool, device=self.device)

    def _zeros_bool(self):
        return torch.zeros(self.table.cap, dtype=torch.bool,
                           device=self.device)

    # ---- leaves ---------------------------------------------------------
    def _eval_col(self, e: Col) -> Column:
        key = f"{e.table}.{e.name}" if e.table else e.name
        if key in self.table.columns:
            return self.table.columns[key]
        if e.name in self.table.columns:
            return self.table.columns[e.name]
        raise KeyError(f"unknown column {key}; have {self.table.names[:8]}...")

    def _const(self, value, dtype: DType) -> Column:
        cap = self.table.cap
        dev = self.device
        if value is None:
            data = torch.zeros(cap, dtype=torch_dtype(dtype), device=dev)
            return Column(data, dtype, self._zeros_bool())
        if dtype.is_string:
            import pyarrow as pa

            d = host_product(lambda: pa.array([value], type=pa.string()))
            return Column(torch.zeros(cap, dtype=torch.int32, device=dev),
                          STRING, None, d)
        if dtype.kind == "date":
            v = date_to_days(value) if isinstance(value, str) else int(value)
            return Column(torch.full((cap,), v, dtype=torch.int32,
                                     device=dev), DATE)
        if dtype.is_decimal:
            v = int(round(float(value) * 10**dtype.scale))
            return Column(torch.full((cap,), v, dtype=torch.int64,
                                     device=dev), dtype)
        return Column(
            torch.full((cap,), value, dtype=torch_dtype(dtype), device=dev),
            dtype,
        )

    def _eval_lit(self, e: Lit) -> Column:
        dtype = e.dtype or _lit_dtype(e.value)
        return self._const(e.value, dtype)

    # ---- arithmetic / comparison ---------------------------------------
    def _numeric_pair(self, a: Column, b: Column):
        """Align two numeric columns onto a common computational dtype:
        decimals to a common scale (exact int64), unless mixed with float,
        which demotes both to float64."""
        da, db = a.dtype, b.dtype
        if da.is_decimal and db.is_decimal:
            s = max(da.scale, db.scale)
            xa = a.data * (10 ** (s - da.scale))
            xb = b.data * (10 ** (s - db.scale))
            return xa, xb, DType("decimal", 38, s)
        if da.is_decimal and db.is_numeric:
            if db.kind == "float64":
                return a.data.to(F64) / 10**da.scale, b.data, FLOAT64
            return a.data, b.data.to(torch.int64) * 10**da.scale, da
        if db.is_decimal:
            xb, xa, dt = self._numeric_pair(b, a)[0:3]
            return xa, xb, dt
        if da.kind == "float64" or db.kind == "float64":
            return a.data.to(F64), b.data.to(F64), FLOAT64
        if da.kind == "date" and db.kind == "date":
            return a.data, b.data, DATE
        if da.kind == "int64" or db.kind == "int64":
            return a.data.to(torch.int64), b.data.to(torch.int64), INT64
        return a.data, b.data, INT32

    def _eval_binop(self, e: BinOp) -> Column:
        op = e.op
        if op in ("and", "or"):
            return self._eval_logical(e)
        if op == "||":
            return self._eval_concat(e)
        a = self.eval(e.left)
        b = self.eval(e.right)
        valid = _and_valid(a.valid, b.valid)
        if isinstance(e.right, Interval) or b.dtype.kind == "interval":
            raise AssertionError("interval handled via Func below")
        sign = 1 if op == "+" else -1
        if op in ("+", "-") and a.dtype.kind == "date" and b.dtype.is_integer:
            return Column(a.data + b.data.to(torch.int32) * sign, DATE, valid)
        if op in ("+", "-") and b.dtype.kind == "date" and a.dtype.is_integer:
            return Column(b.data + a.data.to(torch.int32) * sign, DATE, valid)
        if op in ("=", "<>", "<", "<=", ">", ">="):
            return self._compare(op, a, b, valid)
        if a.dtype.is_string or b.dtype.is_string:
            raise TypeError(f"arith {op} on strings")
        if op == "*" and (a.dtype.is_decimal or b.dtype.is_decimal):
            # products multiply *unscaled* operands: scale s1+s2
            s1 = a.dtype.scale if a.dtype.is_decimal else 0
            s2 = b.dtype.scale if b.dtype.is_decimal else 0
            if a.dtype.kind == "float64" or b.dtype.kind == "float64":
                fa = a.data.to(F64) / 10**s1
                fb = b.data.to(F64) / 10**s2
                return Column(fa * fb, FLOAT64, valid)
            da = a.data.to(torch.int64)
            db = b.data.to(torch.int64)
            return Column(da * db, DType("decimal", 38, s1 + s2), valid)
        xa, xb, dt = self._numeric_pair(a, b)
        if op == "+":
            return Column(xa + xb, dt, valid)
        if op == "-":
            dtr = INT32 if dt.kind == "date" else dt
            return Column(xa - xb, dtr, valid)
        if op == "*":
            return Column(xa * xb, dt, valid)
        if op == "/":
            fa = xa.to(F64)
            fb = xb.to(F64)
            if dt.is_decimal:
                fa = fa / 10**dt.scale
                fb = fb / 10**dt.scale
            zero = fb == 0
            data = torch.where(zero, float("nan"),
                               fa / torch.where(zero, 1.0, fb))
            valid = _and_valid(valid, ~zero)  # SQL: x/0 is NULL
            return Column(data, FLOAT64, valid)
        raise NotImplementedError(f"binop {op}")

    def _compare(self, op, a: Column, b: Column, valid) -> Column:
        if a.dtype.is_string or b.dtype.is_string:
            xa, xb = self._string_cmp_codes(a, b, op)
        else:
            xa, xb, _ = self._numeric_pair(a, b)
        fn = {
            "=": torch.eq,
            "<>": torch.ne,
            "<": torch.lt,
            "<=": torch.le,
            ">": torch.gt,
            ">=": torch.ge,
        }[op]
        return Column(fn(xa, xb), BOOL, valid)

    def _string_cmp_codes(self, a: Column, b: Column, op):
        """Map both string operands to comparable integer keys."""
        if a.dtype.is_string and b.dtype.is_string:
            if op in ("=", "<>"):
                ca, cb, _ = unify_dictionaries(a, b)
                return ca, cb
            # ordering across two dictionaries needs a shared ranking
            ca, cb, ud = unify_dictionaries(a, b)
            ra, _ = sort_dictionary(Column(ca, STRING, a.valid, ud))
            rb, _ = sort_dictionary(Column(cb, STRING, b.valid, ud))
            return ra, rb
        # string vs non-string: cast the string side
        s, o = (a, b) if a.dtype.is_string else (b, a)
        sc = _cast_column(s, o.dtype if o.dtype.kind != "date" else DATE,
                          self.table.cap)
        xa = sc.data if a.dtype.is_string else a.data
        xb = b.data if a.dtype.is_string else sc.data
        return (xa, xb)

    # ---- boolean logic (Kleene) ----------------------------------------
    def _eval_logical(self, e: BinOp) -> Column:
        a = self.eval(e.left)
        b = self.eval(e.right)
        av = a.valid if a.valid is not None else self._ones()
        bv = b.valid if b.valid is not None else self._ones()
        ad = a.data.bool()
        bd = b.data.bool()
        if e.op == "and":
            data = (ad & av) & (bd & bv)
            false_ = (av & ~ad) | (bv & ~bd)
            valid = av & bv | false_
        else:
            data = (ad & av) | (bd & bv)
            true_ = (av & ad) | (bv & bd)
            valid = av & bv | true_
        return Column(data, BOOL, valid)

    def _eval_unaryop(self, e: UnaryOp) -> Column:
        a = self.eval(e.operand)
        if e.op == "neg":
            return Column(-a.data, a.dtype, a.valid)
        if e.op == "not":
            return Column(~a.data.bool(), BOOL, a.valid)
        if e.op == "isnull":
            v = self._zeros_bool() if a.valid is None else ~a.valid
            return Column(v, BOOL, None)
        if e.op == "isnotnull":
            v = self._ones() if a.valid is None else a.valid
            return Column(v, BOOL, None)
        raise NotImplementedError(e.op)

    # ---- predicates -----------------------------------------------------
    def _eval_between(self, e: Between) -> Column:
        lo = BinOp(">=", e.operand, e.low)
        hi = BinOp("<=", e.operand, e.high)
        out = self._eval_logical(BinOp("and", lo, hi))
        if e.negated:
            return Column(~out.data, BOOL, out.valid)
        return out

    def _eval_inlist(self, e: InList) -> Column:
        a = self.eval(e.operand)
        values = [v.value for v in e.values]
        if a.dtype.is_string:
            import pyarrow as pa
            import pyarrow.compute as pc

            d = a.dictionary
            lut = host_product(lambda: device_lut(
                pc.is_in(d.cast(pa.string()),
                         value_set=pa.array(values, pa.string())
                         ).to_numpy(zero_copy_only=False),
                a.data.device))
            data = lut_take(lut, a.data)
        else:
            data = self._zeros_bool()
            for v in values:
                cmp = self._compare("=", a, self._lit_like(v, a.dtype), None)
                data = data | cmp.data
        data = data if not e.negated else ~data
        return Column(data, BOOL, a.valid)

    def _lit_like(self, v, dtype: DType) -> Column:
        if dtype.kind == "date" and isinstance(v, str):
            return self._const(v, DATE)
        if dtype.is_decimal:
            return self._const(v, dtype)
        return self._const(v, dtype if not dtype.is_string else STRING)

    def _eval_like(self, e: Like) -> Column:
        import pyarrow as pa
        import pyarrow.compute as pc

        a = self.eval(e.operand)
        if not a.dtype.is_string:
            raise TypeError("LIKE on non-string")
        lut = host_product(lambda: device_lut(
            pc.match_like(a.dictionary.cast(pa.string()), e.pattern)
            .to_numpy(zero_copy_only=False).astype(bool),
            a.data.device))
        data = lut_take(lut, a.data)
        if e.negated:
            data = ~data
        return Column(data, BOOL, a.valid)

    # ---- case / cast / functions ----------------------------------------
    def _eval_case(self, e: Case) -> Column:
        branches = [(self.eval(c), self.eval(v)) for c, v in e.branches]
        default = self.eval(e.default) if e.default is not None else None
        vals = [v for _, v in branches] + ([default] if default else [])
        out_dtype = _common_dtype([v.dtype for v in vals])
        vals = [_cast_column(v, out_dtype, self.table.cap) for v in vals]
        if out_dtype.is_string:
            vals, shared = _share_dictionary(vals)
        else:
            shared = None
        n = len(branches)
        if default is not None:
            data = vals[n].data
            valid = vals[n].valid if vals[n].valid is not None else self._ones()
        else:
            data = torch.zeros(self.table.cap, dtype=torch_dtype(out_dtype),
                               device=self.device)
            valid = self._zeros_bool()
        decided = self._zeros_bool()
        for (cond, _), val in zip(branches, vals[:n]):
            cv = cond.valid if cond.valid is not None else self._ones()
            take = cond.data.bool() & cv & ~decided
            data = torch.where(take, val.data, data)
            vv = val.valid if val.valid is not None else self._ones()
            valid = torch.where(take, vv, valid)
            decided = decided | take
        return Column(data, out_dtype, valid, shared)

    def _eval_cast(self, e: Cast) -> Column:
        return _cast_column(self.eval(e.operand), e.target, self.table.cap)

    def _eval_interval(self, e: Interval) -> Column:
        return self._const(e.days, INT32)

    def _eval_func(self, e: Func) -> Column:
        name = e.name
        if name == "coalesce":
            cols = [self.eval(a) for a in e.args]
            dt = _common_dtype([c.dtype for c in cols])
            cols = [_cast_column(c, dt, self.table.cap) for c in cols]
            if dt.is_string:
                cols, shared = _share_dictionary(cols)
            else:
                shared = None
            data = cols[-1].data
            valid = cols[-1].valid
            for c in reversed(cols[:-1]):
                cv = c.valid if c.valid is not None else self._ones()
                data = torch.where(cv, c.data, data)
                pv = valid if valid is not None else self._ones()
                valid = torch.where(cv, True, pv)
            return Column(data, dt, valid, shared)
        if name == "abs":
            a = self.eval(e.args[0])
            return Column(torch.abs(a.data), a.dtype, a.valid)
        if name == "round":
            a = self.eval(e.args[0])
            nd = e.args[1].value if len(e.args) > 1 else 0
            if a.dtype.is_decimal:
                s = a.dtype.scale
                if nd >= s:
                    return a
                q = 10 ** (s - nd)
                half = q // 2
                data = torch.where(
                    a.data >= 0, (a.data + half) // q, -((-a.data + half) // q)
                ) * q
                return Column(data, a.dtype, a.valid)
            f = 10.0**nd
            return Column(torch.round(a.data.to(F64) * f) / f, FLOAT64,
                          a.valid)
        if name in ("substr", "substring"):
            import pyarrow.compute as pc

            return self._string_transform(
                e.args[0],
                lambda d: pc.utf8_slice_codeunits(
                    d,
                    start=e.args[1].value - 1,
                    stop=e.args[1].value - 1 + e.args[2].value,
                ),
            )
        if name in ("upper", "lower", "trim"):
            import pyarrow.compute as pc

            fn = {"upper": pc.utf8_upper, "lower": pc.utf8_lower,
                  "trim": pc.utf8_trim_whitespace}[name]
            return self._string_transform(e.args[0], fn)
        if name in ("year", "month", "day"):
            a = self.eval(e.args[0])
            y, m, d = _civil_from_days(a.data)
            out = y if name == "year" else (m if name == "month" else d)
            return Column(out.to(torch.int32), INT32, a.valid)
        if name in ("date_add", "date_sub"):
            a = self.eval(e.args[0])
            b = self.eval(e.args[1])
            sign = 1 if name == "date_add" else -1
            return Column(a.data + sign * b.data.to(torch.int32), DATE,
                          _and_valid(a.valid, b.valid))
        if name == "nullif":
            a = self.eval(e.args[0])
            b = self.eval(e.args[1])
            eq = self._compare("=", a, b, None)
            nulled = eq.data if b.valid is None else eq.data & b.valid
            av = a.valid if a.valid is not None else self._ones()
            return Column(a.data, a.dtype, av & ~nulled, a.dictionary)
        if name == "concat":
            out = self.eval(e.args[0])
            for arg in e.args[1:]:
                out = self._concat_cols(out, self.eval(arg))
            return out
        raise NotImplementedError(f"function {name}")

    def _string_transform(self, arg: Expr, fn) -> Column:
        import pyarrow as pa
        import pyarrow.compute as pc

        a = self.eval(arg)
        if not a.dtype.is_string:
            raise TypeError("string function on non-string")

        def build():
            enc = pc.dictionary_encode(fn(a.dictionary.cast(pa.string())))
            remap = enc.indices.to_numpy(zero_copy_only=False)
            return device_lut(remap.astype(np.int32), a.data.device), \
                enc.dictionary

        remap, dictionary = host_product(build)
        return Column(lut_take(remap, a.data), STRING, a.valid, dictionary)

    def _eval_concat(self, e: BinOp) -> Column:
        return self._concat_cols(self.eval(e.left), self.eval(e.right))

    def _concat_cols(self, a: Column, b: Column) -> Column:
        import pyarrow as pa
        import pyarrow.compute as pc

        valid = _and_valid(a.valid, b.valid)
        if a.dtype.is_string and b.dictionary is None and not b.dtype.is_string:
            raise TypeError("concat with non-string")
        dev = a.data.device
        na, nb = len(a.dictionary), len(b.dictionary)
        if na * nb <= 65536:
            # small cross-product: build the pairwise dictionary on host
            def build():
                da = np.asarray(a.dictionary.cast(pa.string()))
                db = np.asarray(b.dictionary.cast(pa.string()))
                cross = pc.binary_join_element_wise(
                    pa.array(np.repeat(da, nb)), pa.array(np.tile(db, na)),
                    "",
                )
                enc = pc.dictionary_encode(cross)
                idx = enc.indices.to_numpy(zero_copy_only=False)
                return device_lut(idx.astype(np.int32), dev), enc.dictionary

            remap, dictionary = host_product(build)
            ia = a.data.clamp(0, na - 1).long()
            ib = b.data.clamp(0, nb - 1).long()
            return Column(remap[ia * nb + ib], STRING, valid, dictionary)
        # large: materialize row-wise on host (rare path)
        host_read_guard("string concat past the pairwise dictionary")
        da = a.dictionary.cast(pa.string())
        db = b.dictionary.cast(pa.string())
        ha = a.data.cpu().numpy()
        hb = b.data.cpu().numpy()
        av = np.asarray(da)[np.clip(ha, 0, len(da) - 1)]
        bv = np.asarray(db)[np.clip(hb, 0, len(db) - 1)]
        joined = pc.binary_join_element_wise(
            pa.array(av.astype(object)), pa.array(bv.astype(object)), ""
        )
        enc = pc.dictionary_encode(joined)
        codes = torch.from_numpy(
            enc.indices.to_numpy(zero_copy_only=False).astype(np.int32)
        ).to(dev)
        return Column(codes, STRING, valid, enc.dictionary)


# ---------------------------------------------------------------------------
# Casting / type unification
# ---------------------------------------------------------------------------


def _common_dtype(dtypes) -> DType:
    out = dtypes[0]
    for d in dtypes[1:]:
        out = _promote(out, d)
    return out


def _promote(a: DType, b: DType) -> DType:
    if a == b:
        return a
    if a.is_string or b.is_string:
        return STRING
    if a.kind == "float64" or b.kind == "float64":
        return FLOAT64
    if a.is_decimal and b.is_decimal:
        return DType("decimal", 38, max(a.scale, b.scale))
    if a.is_decimal:
        return a
    if b.is_decimal:
        return b
    if a.kind == "date" or b.kind == "date":
        return DATE
    if a.kind == "int64" or b.kind == "int64":
        return INT64
    if a.is_bool and b.is_bool:
        return BOOL
    return INT32


def _cast_column(c: Column, target: DType, cap: int) -> Column:
    src = c.dtype
    if src == target or (src.is_string and target.is_string):
        return c
    dev = c.data.device
    if target.is_string:
        # non-string -> string: format on host via dictionary of distinct vals
        import pyarrow as pa
        import pyarrow.compute as pc

        host_read_guard(f"cast of {src} to a string")
        arr = c.data.cpu().numpy()
        if src.is_decimal:
            vals = arr / 10**src.scale
            strs = np.array([f"{v:.{src.scale}f}" for v in vals], dtype=object)
        elif src.kind == "date":
            strs = np.array([days_to_date(v) for v in arr], dtype=object)
        else:
            strs = arr.astype(str).astype(object)
        enc = pc.dictionary_encode(pa.array(strs, pa.string()))
        codes = enc.indices.to_numpy(zero_copy_only=False).astype(np.int32)
        return Column(torch.from_numpy(codes).to(dev), STRING, c.valid,
                      enc.dictionary)
    if src.is_string:
        # string -> numeric/date: parse the dictionary on host, gather codes.
        # Unparseable entries become NULL (Spark cast semantics), not 0.
        prod = host_product(lambda: _parse_dictionary(c.dictionary, target,
                                                      dev))
        if prod is None:
            n = c.data.shape[0]
            return Column(
                torch.zeros(n, dtype=torch_dtype(target), device=dev),
                target, torch.zeros(n, dtype=torch.bool, device=dev),
            )
        lut, lut_ok = prod
        data = lut_take(lut, c.data)
        parsed = lut_take(lut_ok, c.data) if lut_ok is not None else None
        return Column(data, target, _and_valid(c.valid, parsed))
    if target.is_decimal:
        if src.is_decimal:
            shift = target.scale - src.scale
            data = c.data * 10**shift if shift >= 0 else c.data // 10 ** (-shift)
            return Column(data, target, c.valid)
        if src.kind == "float64":
            data = torch.round(c.data.to(F64) * 10**target.scale).to(
                torch.int64
            )
            return Column(data, target, c.valid)
        return Column(c.data.to(torch.int64) * 10**target.scale, target,
                      c.valid)
    if src.is_decimal:
        if target.kind == "float64":
            return Column(c.data.to(F64) / 10**src.scale, target, c.valid)
        return Column(
            (c.data // 10**src.scale).to(torch_dtype(target)), target,
            c.valid,
        )
    return Column(c.data.to(torch_dtype(target)), target, c.valid)


def _parse_dictionary(dictionary, target: DType, dev):
    """(value table, parsed-ok table or None) of a string dictionary cast to
    a number or date on `dev`, or None for an empty dictionary.
    Unparseable entries become NULL (Spark cast semantics), not 0."""
    import pyarrow as pa

    entries = np.asarray(dictionary.cast(pa.string())).tolist()
    if not entries:
        return None
    npdt = (
        np.int32
        if target.kind == "date"
        else np.int64 if target.is_decimal else target.device_np_dtype()
    )
    lut = []
    lut_ok = []
    for s in entries:
        try:
            if s is None or (isinstance(s, str) and not s.strip()):
                raise ValueError
            s = s.strip() if isinstance(s, str) else s
            if target.kind == "date":
                if not _DATE_RE.match(s):
                    raise ValueError
                v = date_to_days(s)
            elif target.is_decimal:
                v = int(round(float(s) * 10**target.scale))
            else:
                v = target.device_np_dtype()(float(s))
            lut.append(v)
            lut_ok.append(True)
        except (ValueError, TypeError):
            lut.append(0)
            lut_ok.append(False)
    lut_ok = np.asarray(lut_ok, dtype=bool)
    return (device_lut(np.asarray(lut, dtype=npdt), dev),
            None if lut_ok.all() else device_lut(lut_ok, dev))


def _share_dictionary(cols):
    """Remap string columns onto one merged dictionary (CASE/COALESCE)."""
    dev = cols[0].data.device

    def build():
        import pyarrow as pa
        import pyarrow.compute as pc

        dicts = [
            (c.dictionary if c.dictionary is not None
             else pa.array([], pa.string())).cast(pa.string())
            for c in cols
        ]
        unified = pc.unique(pa.concat_arrays(dicts))
        luts = [
            None if len(d) == 0 else device_lut(
                pc.index_in(d, unified).to_numpy(zero_copy_only=False)
                .astype(np.int32), dev)
            for d in dicts
        ]
        return luts, unified

    luts, unified = host_product(build)
    out = [
        Column(c.data if lut is None else lut_take(lut, c.data), STRING,
               c.valid, unified)
        for c, lut in zip(cols, luts)
    ]
    return out, unified
