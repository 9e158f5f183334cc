"""Static schema inference over bound plans: the part of the JAX package's
plan verifier (nds_tpu/analysis/verifier.py) that the plan budgeter needs.

`PlanVerifier._schema_of` resolves every plan node's output schema (column
name -> DType) with the evaluator's promotion rules, memoized per node id.
The port builds no fused Pipeline node, so neither its schema rule nor the
reference counts the verifier's fusion rules read are here (ROADMAP.md
queue 1 item 11). The budgeter
(analysis/budget.py) sizes rows by these schemas, so the byte model and
the executor agree on every node's columns and types.

What stays with ROADMAP.md queue 1 item 9 (harness entry points): the
verifier's rules (Pipeline chains, blocked-union soundness, join-key
scoping, LEFT->INNER promotion evidence, annotation placement, sharding)
and `engine.verify_plans`, which the port's Session refuses. A node or an
expression that does not resolve gives no schema here (the budgeter then
counts its row as one byte wide) and a note in `violations`.
"""

from __future__ import annotations

from ..dtypes import BOOL, DATE, DType, FLOAT64, INT32, INT64, STRING
from ..engine import expr as E
from ..engine import plan as P
from ..engine.expr import _lit_dtype, _promote


class _Unres(Exception):
    """Internal: expression dtype resolution failed."""


#: scalar string functions the evaluator implements
_STRING_FUNCS = ("substr", "substring", "upper", "lower", "trim")


class PlanVerifier:
    """Resolves plan node schemas against a catalog (an object with
    .schema(name) -> Schema | None). Memoized per plan node id, so shared
    subtrees (CTE plans, cached scalar subqueries) resolve once."""

    def __init__(self, catalog=None):
        self.catalog = catalog
        self.violations: list[str] = []
        self._schemas: dict[int, dict | None] = {}

    def _viol(self, rule: str, node, msg: str):
        where = f" [{type(node).__name__}]" if node is not None else ""
        self.violations.append(f"{rule}: {msg}{where}")

    # ------------------------------------------------------------------
    # schema resolution (memoized; None == this subtree did not resolve)
    # ------------------------------------------------------------------
    def _schema_of(self, node) -> dict | None:
        if node is None:
            self._viol("schema", None, "missing child plan node")
            return None
        key = id(node)
        if key in self._schemas:
            return self._schemas[key]
        # pre-insert None: a (never-expected) cycle ends as a failure
        # instead of recursing forever
        self._schemas[key] = None
        m = getattr(self, f"_schema_{type(node).__name__.lower()}", None)
        if m is None:
            self._viol(
                "schema", node, f"unknown plan node {type(node).__name__}"
            )
            return None
        sch = m(node)
        self._schemas[key] = sch
        return sch

    def _schema_scan(self, node: P.Scan):
        if self.catalog is None:
            self._viol("schema", node, "no catalog to resolve Scan against")
            return None
        sch = self.catalog.schema(node.table)
        if sch is None:
            self._viol("schema", node, f"unknown table {node.table!r}")
            return None
        by_name = {f.name: f.dtype for f in sch}
        cols = node.columns if node.columns is not None else list(by_name)
        out = {}
        for c in cols:
            if c not in by_name:
                self._viol(
                    "schema", node,
                    f"scan of {node.table!r} selects unknown column {c!r}",
                )
                return None
            out[f"{node.alias}.{c}"] = by_name[c]
        return out

    def _schema_materializedscan(self, node: P.MaterializedScan):
        if node.name == "__dual__":
            return {}
        if node.table is None:
            self._viol(
                "schema", node,
                f"materialized scan {node.name!r} is not populated",
            )
            return None
        return {n: c.dtype for n, c in node.table.columns.items()}

    def _schema_project(self, node: P.Project):
        child = self._schema_of(node.child)
        if child is None:
            return None
        return self._project_over(node, node.items, child)

    def _project_over(self, node, items, child):
        out = {}
        for e, name in items:
            dt = self._try_expr(e, child, node, f"projection item {name!r}")
            if dt is None:
                return None
            if name in out:
                self._viol(
                    "schema", node, f"duplicate output column {name!r}"
                )
                return None
            out[name] = dt
        return out

    def _schema_filter(self, node: P.Filter):
        child = self._schema_of(node.child)
        if child is None:
            return None
        dt = self._try_expr(node.predicate, child, node, "filter predicate")
        if dt is None:
            return None
        if dt.is_string:
            self._viol(
                "schema", node,
                f"filter predicate has string dtype {dt} (not boolean)",
            )
            return None
        return child

    def _schema_join(self, node: P.Join):
        left = self._schema_of(node.left)
        right = self._schema_of(node.right)
        if left is None or right is None:
            return None
        if len(node.left_keys) != len(node.right_keys):
            self._viol(
                "join-keys", node,
                f"{len(node.left_keys)} left keys vs "
                f"{len(node.right_keys)} right keys",
            )
            return None
        ok = True
        for lk in node.left_keys:
            if self._try_expr(lk, left, node, "left join key") is None:
                ok = False
        for rk in node.right_keys:
            if self._try_expr(rk, right, node, "right join key") is None:
                ok = False
        if not ok:
            return None
        merged = dict(left)
        for n, dt in right.items():
            if n in merged:
                self._viol(
                    "schema", node, f"join output has duplicate column {n!r}"
                )
                return None
            merged[n] = dt
        if node.residual is not None:
            # residuals evaluate over the pair table where both sides'
            # columns coexist, semi/anti included
            if self._try_expr(
                node.residual, merged, node, "join residual"
            ) is None:
                return None
        if node.kind in ("semi", "anti"):
            return dict(left)
        if node.kind == "mark":
            if not node.mark_name:
                self._viol("schema", node, "mark join without mark_name")
                return None
            if node.mark_name in left:
                self._viol(
                    "schema", node,
                    f"mark column {node.mark_name!r} collides with an "
                    f"existing left column",
                )
                return None
            out = dict(left)
            out[node.mark_name] = BOOL
            return out
        return merged

    def _schema_multijoin(self, node: P.MultiJoin):
        rels = [self._schema_of(r) for r in node.relations]
        if any(r is None for r in rels):
            return None
        merged = {}
        for sch in rels:
            for n, dt in sch.items():
                if n in merged:
                    self._viol(
                        "schema", node,
                        f"multijoin output has duplicate column {n!r}",
                    )
                    return None
                merged[n] = dt
        ok = True
        for i, j, le, re_ in node.edges:
            if not (0 <= i < len(rels) and 0 <= j < len(rels)):
                self._viol(
                    "join-keys", node,
                    f"edge endpoints ({i}, {j}) outside the "
                    f"{len(rels)}-relation list",
                )
                ok = False
                continue
            if self._try_expr(le, rels[i], node, "multijoin edge") is None:
                ok = False
            if self._try_expr(re_, rels[j], node, "multijoin edge") is None:
                ok = False
        if node.residual is not None:
            if self._try_expr(
                node.residual, merged, node, "multijoin residual"
            ) is None:
                ok = False
        return merged if ok else None

    def _schema_aggregate(self, node: P.Aggregate):
        child = self._schema_of(node.child)
        if child is None:
            return None
        return self._agg_schema(node, node, child)

    def _agg_schema(self, node, agg, child):
        out = {}
        for g, name in agg.keys:
            dt = self._try_expr(g, child, node, f"group key {name!r}")
            if dt is None:
                return None
            if name in out:
                self._viol(
                    "schema", node, f"duplicate output column {name!r}"
                )
                return None
            out[name] = dt
        for a, name in agg.aggs:
            dt = self._agg_dtype(a, child, agg)
            if dt is None:
                return None
            if name in out:
                self._viol(
                    "schema", node, f"duplicate output column {name!r}"
                )
                return None
            out[name] = dt
        if agg.grouping_sets is not None:
            nkeys = len(agg.keys)
            for s in agg.grouping_sets:
                if any(not (0 <= i < nkeys) for i in s):
                    self._viol(
                        "schema", node,
                        f"grouping set {s} indexes outside the "
                        f"{nkeys}-key list",
                    )
                    return None
        return out

    def _schema_window(self, node: P.Window):
        child = self._schema_of(node.child)
        if child is None:
            return None
        out = dict(child)
        for wf, name in node.fns:
            dt = self._window_dtype(wf, child, node)
            if dt is None:
                return None
            if name in out:
                self._viol(
                    "schema", node, f"duplicate output column {name!r}"
                )
                return None
            out[name] = dt
        return out

    def _schema_sort(self, node: P.Sort):
        child = self._schema_of(node.child)
        if child is None:
            return None
        for e, _asc, _nf in node.keys:
            if self._try_expr(e, child, node, "sort key") is None:
                return None
        return child

    def _schema_limit(self, node: P.Limit):
        child = self._schema_of(node.child)
        if child is None:
            return None
        if not isinstance(node.n, int) or node.n < 0:
            self._viol(
                "schema", node,
                f"LIMIT count must be a non-negative int, got {node.n!r}",
            )
            return None
        return child

    def _schema_distinct(self, node: P.Distinct):
        return self._schema_of(node.child)

    def _schema_setop(self, node: P.SetOp):
        left = self._schema_of(node.left)
        right = self._schema_of(node.right)
        if left is None or right is None:
            return None
        if len(left) != len(right):
            self._viol(
                "setop", node,
                f"{node.op} sides have {len(left)} vs {len(right)} columns",
            )
            return None
        if list(left) != list(right):
            # the binder aligns rhs output names to the lhs via a Project
            self._viol(
                "setop", node,
                f"{node.op} sides have misaligned column names: "
                f"{list(left)[:4]} vs {list(right)[:4]}",
            )
            return None
        out = {}
        for (n, lt), rt in zip(left.items(), right.values()):
            if lt.is_string != rt.is_string:
                self._viol(
                    "setop", node,
                    f"{node.op} column {n!r} mixes string and non-string "
                    f"({lt} vs {rt})",
                )
                return None
            out[n] = _promote(lt, rt)
        return out

    # ------------------------------------------------------------------
    # aggregate / window dtype rules (mirror exec._eval_agg/_eval_window)
    # ------------------------------------------------------------------
    def _agg_dtype(self, a: E.Agg, child, node):
        fn = a.fn
        if fn == "grouping":
            # the arg is the raw key expr or the key's output Col
            if a.arg is not None:
                key_cols = {E.Col(kn) for _, kn in node.keys}
                key_exprs = [ke for ke, _ in node.keys]
                if a.arg not in key_cols and not any(
                    a.arg == ke for ke in key_exprs
                ):
                    if self._try_expr(
                        a.arg, child, node, "grouping() argument"
                    ) is None:
                        return None
            return INT32
        if fn == "count":
            if a.arg is not None:
                if self._try_expr(a.arg, child, node, "count() arg") is None:
                    return None
            return INT64
        if a.arg is None:
            self._viol("schema", node, f"aggregate {fn} needs an argument")
            return None
        d = self._try_expr(a.arg, child, node, f"{fn}() argument")
        if d is None:
            return None
        if fn == "sum":
            if d.is_string:
                self._viol("schema", node, "sum over a string column")
                return None
            return INT64 if d.kind in ("int32", "bool") else d
        if fn in ("min", "max"):
            return d
        if fn in ("avg", "stddev_samp", "var_samp"):
            if d.is_string:
                self._viol("schema", node, f"{fn} over a string column")
                return None
            return FLOAT64
        self._viol("schema", node, f"unknown aggregate function {fn!r}")
        return None

    def _window_dtype(self, wf: E.WindowFn, child, node):
        for pe in wf.partition_by:
            if self._try_expr(pe, child, node, "window partition key") is None:
                return None
        for oe, _asc in wf.order_by:
            if self._try_expr(oe, child, node, "window order key") is None:
                return None
        fn = wf.fn
        if fn in ("rank", "dense_rank", "row_number"):
            return INT64
        if fn == "count":
            if wf.arg is not None:
                if self._try_expr(wf.arg, child, node, "window arg") is None:
                    return None
            return INT64
        if fn in ("sum", "avg", "min", "max"):
            if wf.arg is None:
                self._viol("schema", node, f"window {fn} needs an argument")
                return None
            d = self._try_expr(wf.arg, child, node, f"window {fn} arg")
            if d is None:
                return None
            if fn == "avg":
                return FLOAT64
            if fn == "sum":
                return INT64 if d.kind in ("int32", "bool") else d
            return d
        self._viol("schema", node, f"unknown window function {fn!r}")
        return None

    # ------------------------------------------------------------------
    # scalar expression dtype inference
    # ------------------------------------------------------------------
    def _try_expr(self, e, sch, node, what) -> DType | None:
        try:
            return self._expr_dtype(e, sch)
        except _Unres as exc:
            self._viol("schema", node, f"{what}: {exc}")
            return None

    def _expr_dtype(self, e, sch) -> DType:
        if isinstance(e, E.Col):
            key = f"{e.table}.{e.name}" if e.table else e.name
            if key in sch:
                return sch[key]
            if e.name in sch:  # bare-name fallback, mirrors _eval_col
                return sch[e.name]
            raise _Unres(f"unresolved column {key!r} (have {list(sch)[:6]})")
        if isinstance(e, E.Lit):
            return e.dtype or _lit_dtype(e.value)
        if isinstance(e, E.Interval):
            return INT32
        if isinstance(e, E.BinOp):
            return self._binop_dtype(e, sch)
        if isinstance(e, E.UnaryOp):
            d = self._expr_dtype(e.operand, sch)
            if e.op == "neg":
                return d
            if e.op in ("not", "isnull", "isnotnull"):
                return BOOL
            raise _Unres(f"unknown unary op {e.op!r}")
        if isinstance(e, E.Between):
            for c in (e.operand, e.low, e.high):
                self._expr_dtype(c, sch)
            return BOOL
        if isinstance(e, E.InList):
            self._expr_dtype(e.operand, sch)
            return BOOL
        if isinstance(e, E.Like):
            d = self._expr_dtype(e.operand, sch)
            if not d.is_string:
                raise _Unres(f"LIKE over non-string dtype {d}")
            return BOOL
        if isinstance(e, E.Case):
            vals = []
            for c, v in e.branches:
                self._expr_dtype(c, sch)
                vals.append(self._expr_dtype(v, sch))
            if e.default is not None:
                vals.append(self._expr_dtype(e.default, sch))
            out = vals[0]
            for d in vals[1:]:
                out = _promote(out, d)
            return out
        if isinstance(e, E.Cast):
            self._expr_dtype(e.operand, sch)
            return e.target
        if isinstance(e, E.Func):
            return self._func_dtype(e, sch)
        if isinstance(e, E.ScalarSubquery):
            sub = self._schema_of(e.plan)
            if sub is None:
                raise _Unres("scalar subquery plan failed to resolve")
            if e.out_name not in sub:
                raise _Unres(
                    f"scalar subquery output {e.out_name!r} missing from "
                    f"its plan's schema {list(sub)[:4]}"
                )
            return sub[e.out_name]
        raise _Unres(f"unresolvable expression {type(e).__name__}")

    def _binop_dtype(self, e: E.BinOp, sch) -> DType:
        op = e.op
        a = self._expr_dtype(e.left, sch)
        b = self._expr_dtype(e.right, sch)
        if op in ("and", "or", "=", "<>", "!=", "<", "<=", ">", ">="):
            return BOOL
        if op == "||":
            if not (a.is_string and b.is_string):
                raise _Unres(f"|| over non-string dtypes {a}, {b}")
            return STRING
        if op in ("+", "-", "*", "/"):
            if a.is_string or b.is_string:
                raise _Unres(f"arithmetic {op} over string dtype")
            if op in ("+", "-") and a.kind == "date" and b.is_integer:
                return DATE
            if op in ("+", "-") and b.kind == "date" and a.is_integer:
                return DATE
            if op == "-" and a.kind == "date" and b.kind == "date":
                return INT32
            if op == "/":
                return FLOAT64
            if op == "*" and (a.is_decimal or b.is_decimal):
                if a.kind == "float64" or b.kind == "float64":
                    return FLOAT64
                s1 = a.scale if a.is_decimal else 0
                s2 = b.scale if b.is_decimal else 0
                return DType("decimal", 38, s1 + s2)
            # +/-/* promotion, mirrors Evaluator._numeric_pair
            if a.is_decimal and b.is_decimal:
                return DType("decimal", 38, max(a.scale, b.scale))
            if a.is_decimal:
                return FLOAT64 if b.kind == "float64" else a
            if b.is_decimal:
                return FLOAT64 if a.kind == "float64" else b
            if a.kind == "float64" or b.kind == "float64":
                return FLOAT64
            if a.kind == "int64" or b.kind == "int64":
                return INT64
            return INT32
        raise _Unres(f"unknown binary op {op!r}")

    def _func_dtype(self, e: E.Func, sch) -> DType:
        name = e.name.lower()
        args = [self._expr_dtype(a, sch) for a in e.args]
        if name == "coalesce":
            out = args[0]
            for d in args[1:]:
                out = _promote(out, d)
            return out
        if name in ("abs", "nullif"):
            return args[0]
        if name == "round":
            return args[0] if args[0].is_decimal else FLOAT64
        if name in _STRING_FUNCS:
            if not args[0].is_string:
                raise _Unres(f"{name} over non-string dtype {args[0]}")
            return STRING
        if name in ("year", "month", "day"):
            return INT32
        if name in ("date_add", "date_sub"):
            return DATE
        if name == "concat":
            return STRING
        raise _Unres(f"unknown scalar function {e.name!r}")
