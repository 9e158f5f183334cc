"""Plan-IR verifier: structural invariant checks over bound logical plans —
the port of nds_tpu/analysis/verifier.py.

The binder and the rewrite passes (prune_columns -> mark_blocked_union_aggs
-> the plan budgeter's annotations) carry invariants the executor relies
on. `PlanVerifier.verify` walks the whole plan (subquery plans riding
inside expressions included) and checks, with the reference's rule names
and messages:

* every node's output schema is resolvable with stable dtypes and no
  duplicate column names (static expression-dtype inference mirroring the
  evaluator's promotion rules; the plan budgeter sizes rows by it);
* `blocked_union` annotations sit only on Aggregates whose shape AND
  aggregate set decompose over row windows (`plan.union_agg_shape` +
  `plan.aggs_decomposable`);
* join conditions reference only bound child columns (Join keys against
  their own side, MultiJoin edges against their endpoint relations);
* the binder's LEFT->INNER promotions are each backed by a re-derived
  null-rejecting conjunct shape (`binder._null_rejecting_shape`);
* ORDER BY .. LIMIT top-k nodes keep the single-consumer contract;
* SetOp sides agree on arity and aligned output names;
* physical-choice annotations sit only where their consumer reads them
  (`_topk_safe` on Sorts, `donate_ok` on Pipelines, `budget_window_rows`
  on blocked-union Aggregates, `spill_partitions` on spillable nodes with
  a power-of-two count).

One family stays behind: the sharding rules run only over a mesh, and a
mesh raises NotImplementedError (ROADMAP.md queue 1 item 13). The Pipeline
rules check engine/fuse.py's rewrite: detached, unshared, fusible stages,
maximal chains, the donation clearance and the fused aggregate tail.

Gating: conf `engine.verify_plans` / env `NDS_VERIFY_PLANS` = off (default)
| final (verify the finished plan once) | all (verify after binding and
after each rewrite pass). Violations raise `PlanVerifyError`, which
`faults.classify` maps to the `planner` failure kind. Host-side tree
walking only: no device work.
"""

from __future__ import annotations

import dataclasses
import os

from ..dtypes import BOOL, DATE, DType, FLOAT64, INT32, INT64, STRING
from ..engine import expr as E
from ..engine import plan as P
from ..engine.binder import _null_rejecting_shape
from ..engine.expr import _lit_dtype, _promote
from ..engine.fuse import _NO_DONATE_CHILD, _expr_fusible
from .budget import SPILL_MAX_PARTITIONS, spillable_node


class PlanVerifyError(Exception):
    """A plan failed structural verification. Deterministic (the same plan
    re-verifies to the same violations), so faults.classify maps this to
    the `planner` kind and the report ladder fails fast instead of
    retrying."""

    def __init__(self, stage: str, violations):
        self.stage = stage
        self.violations = list(violations)
        head = "; ".join(self.violations[:3])
        more = (
            f" (+{len(self.violations) - 3} more)"
            if len(self.violations) > 3
            else ""
        )
        super().__init__(
            f"plan verification failed after {stage!r}: "
            f"{len(self.violations)} violation(s): {head}{more}"
        )


LEVELS = ("off", "final", "all")


def resolve_level(conf: dict | None = None) -> str:
    """Verification strictness: conf `engine.verify_plans` wins over the
    NDS_VERIFY_PLANS env knob; default off (zero cost)."""
    v = None
    if conf:
        v = conf.get("engine.verify_plans")
    v = v or os.environ.get("NDS_VERIFY_PLANS") or "off"
    v = str(v).lower()
    if v not in LEVELS:
        raise ValueError(
            f"engine.verify_plans must be one of {LEVELS}, got {v!r}"
        )
    return v


class _Unres(Exception):
    """Internal: expression dtype resolution failed (becomes a violation)."""


#: scalar functions the evaluator implements, mapped to a result-dtype rule
#: (arg dtypes list -> DType). Kept in lockstep with Evaluator._eval_func.
_STRING_FUNCS = ("substr", "substring", "upper", "lower", "trim")


def _count_plan_refs(root) -> dict:
    """Reference count per plan node id over the whole tree (stage lists
    and subquery plans included) — mirrors fuse._count_refs. A Pipeline
    stage with more than one reference is a shared wrapper absorbed by
    mistake."""
    refs = {}
    seen = set()

    def visit(v):
        if isinstance(v, (P.PlanNode, E.Expr)):
            if isinstance(v, P.PlanNode):
                refs[id(v)] = refs.get(id(v), 0) + 1
            if id(v) in seen:
                return
            seen.add(id(v))
            for f in dataclasses.fields(v):
                visit(getattr(v, f.name))
        elif isinstance(v, (list, tuple)):
            for x in v:
                visit(x)

    visit(root)
    return refs


class PlanVerifier:
    """Walks a bound plan and collects invariant violations (strings).

    One instance per verification: schema resolution is memoized per plan
    node id, so shared subtrees (CTE plans, cached scalar subqueries)
    resolve once and the walk stays linear in plan size."""

    def __init__(self, catalog=None):
        self.catalog = catalog  # object with .schema(name) -> Schema | None
        self.violations: list[str] = []
        self._schemas: dict[int, dict | None] = {}
        self._refs: dict[int, int] = {}

    # ------------------------------------------------------------------
    def verify(self, root: P.PlanNode, promotions=(), mesh=None) -> list[str]:
        self._refs = _count_plan_refs(root)
        self._schema_of(root)
        self._check_promotions(promotions)
        self._check_annotations(root)
        if mesh is not None:
            self._check_sharding(root, mesh)
        return list(self.violations)

    # ------------------------------------------------------------------
    # physical-annotation coverage: dynamic annotations (`_topk_safe`,
    # `donate_ok`, `budget_window_rows`) are load-bearing across passes —
    # one landing on the wrong node class silently changes execution, so
    # placement itself is verified, not just the annotated nodes' shape
    # ------------------------------------------------------------------
    def _check_annotations(self, root: P.PlanNode):
        nodes = [v for v in P.walk_plan(root) if isinstance(v, P.PlanNode)]
        for n in nodes:
            if getattr(n, "_topk_safe", False) and not isinstance(n, P.Sort):
                # fuse annotates every single-consumer Sort (the Limit
                # executor is the only reader); the annotation on any
                # other node class means a rewrite copied it somewhere a
                # future top-k check could mis-trust
                self._viol(
                    "physical-annotation", n,
                    "_topk_safe set on a non-Sort node (only ORDER BY "
                    "sorts own the top-k single-consumer contract)",
                )
            if getattr(n, "donate_ok", False) and not isinstance(
                n, P.Pipeline
            ):
                self._viol(
                    "physical-annotation", n,
                    "donate_ok set on a non-Pipeline node (only fused "
                    "pipelines own the donation contract)",
                )
            if getattr(n, "budget_window_rows", None) is not None:
                if not (
                    isinstance(n, P.Aggregate) and n.blocked_union
                ):
                    self._viol(
                        "physical-annotation", n,
                        "budget_window_rows set on a node that is not a "
                        "blocked-union Aggregate (the windowed executor "
                        "is the only consumer of static window sizing)",
                    )
            sp = getattr(n, "spill_partitions", None)
            if sp is not None:
                # out-of-core annotation coverage (registered ahead of the
                # spilled-executor rewrite per the PR-5 contract): the
                # annotation may only land on operators whose rewrite
                # DECOMPOSES over hash partitions / sorted runs, and the
                # statically chosen partition count must be sane
                if not spillable_node(n):
                    self._viol(
                        "spill", n,
                        "spill_partitions set on a node whose operator "
                        "does not decompose over hash partitions/sorted "
                        "runs (only inner/left joins, MultiJoins, Sorts, "
                        "Distinct and UNION own the out-of-core rewrite)",
                    )
                elif not (
                    isinstance(sp, int)
                    and 2 <= sp <= SPILL_MAX_PARTITIONS
                    and sp & (sp - 1) == 0
                ):
                    self._viol(
                        "spill", n,
                        f"spill_partitions={sp!r} is not a power of two "
                        f"in [2, {SPILL_MAX_PARTITIONS}] (hash "
                        f"partitioning and capacity buckets both need "
                        f"pow2 alignment)",
                    )

    # ------------------------------------------------------------------
    # sharding invariants: the mesh path is not ported
    # ------------------------------------------------------------------
    def _check_sharding(self, root: P.PlanNode, mesh):
        """The reference's sharding family (PartitionSpec axis consistency,
        exchange arity, replicated-dim legality) runs only over a mesh, and
        the port has none yet."""
        raise NotImplementedError(
            "plan verification over a mesh is not ported to nds_tpu_torch "
            "yet: ROADMAP.md queue 1 item 13 (parallel/)"
        )

    def _viol(self, rule: str, node, msg: str):
        where = f" [{type(node).__name__}]" if node is not None else ""
        self.violations.append(f"{rule}: {msg}{where}")

    # ------------------------------------------------------------------
    # schema resolution (memoized; None == this subtree already violated)
    # ------------------------------------------------------------------
    def _schema_of(self, node) -> dict | None:
        if node is None:
            self._viol("schema", None, "missing child plan node")
            return None
        key = id(node)
        if key in self._schemas:
            return self._schemas[key]
        # pre-insert None: a (never-expected) cycle terminates as a failure
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
            if self._try_expr(
                lk, left, node, "left join key (must bind to left child)"
            ) is None:
                ok = False
        for rk in node.right_keys:
            if self._try_expr(
                rk, right, node, "right join key (must bind to right child)"
            ) is None:
                ok = False
        if not ok:
            return None
        merged = dict(left)
        for n, dt in right.items():
            if n in merged:
                self._viol(
                    "schema", node,
                    f"join output has duplicate column {n!r}",
                )
                return None
            merged[n] = dt
        if node.residual is not None:
            # residuals evaluate over the pair table where both sides'
            # columns coexist (exec._apply_residual) — semi/anti included
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
            if self._try_expr(
                le, rels[i], node,
                f"multijoin edge left expr (must bind to relation {i})",
            ) is None:
                ok = False
            if self._try_expr(
                re_, rels[j], node,
                f"multijoin edge right expr (must bind to relation {j})",
            ) is None:
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
        self._check_blocked_union(node)
        out = {}
        for g, name in node.keys:
            dt = self._try_expr(g, child, node, f"group key {name!r}")
            if dt is None:
                return None
            if name in out:
                self._viol(
                    "schema", node, f"duplicate output column {name!r}"
                )
                return None
            out[name] = dt
        for a, name in node.aggs:
            dt = self._agg_dtype(a, child, node)
            if dt is None:
                return None
            if name in out:
                self._viol(
                    "schema", node, f"duplicate output column {name!r}"
                )
                return None
            out[name] = dt
        if node.grouping_sets is not None:
            nkeys = len(node.keys)
            for s in node.grouping_sets:
                if any(not (0 <= i < nkeys) for i in s):
                    self._viol(
                        "schema", node,
                        f"grouping set {s} indexes outside the "
                        f"{nkeys}-key list",
                    )
                    return None
        return out

    def _check_blocked_union(self, node: P.Aggregate):
        if not node.blocked_union:
            return
        if P.union_agg_shape(node) is None:
            self._viol(
                "blocked-union", node,
                "blocked_union annotation on an Aggregate whose input is "
                "not a union_all chain",
            )
        if not P.aggs_decomposable(node.aggs):
            self._viol(
                "blocked-union", node,
                "blocked_union annotation on a non-decomposable aggregate "
                "set (distinct/stddev/grouping do not merge over row "
                "windows)",
            )

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
                "schema", node, f"LIMIT count must be a non-negative int, "
                f"got {node.n!r}"
            )
            return None
        if isinstance(node.child, P.Sort):
            # sort-key resolution over the Sort input (which the top-k
            # gather reads) was already checked by _schema_sort; the
            # cross-pass invariant left to verify is the single-consumer
            # annotation: a SHARED Sort marked _topk_safe would execute
            # top-k for one parent and starve the other (fuse's rewrite
            # must only set it when the Sort has exactly one reference)
            if (
                getattr(node.child, "_topk_safe", False)
                and self._refs.get(id(node.child), 1) > 1
            ):
                self._viol(
                    "topk", node,
                    "Sort under LIMIT is marked _topk_safe but has "
                    "multiple consumers; the top-k gather would truncate "
                    "the other parent's input",
                )
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
            # the binder aligns rhs output names to the lhs via a Project;
            # a mismatch means a rewrite re-ordered or renamed one side
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

    def _schema_pipeline(self, node: P.Pipeline):
        child = self._schema_of(node.child)
        self._check_donate_ok(node)
        if not node.stages and node.agg is None:
            # an agg-tail Pipeline may have an empty chain (the Aggregate
            # sat directly on its input); a plain one must not
            self._viol("pipeline", node, "Pipeline with no stages")
            return child
        if isinstance(node.child, P.Pipeline) and node.child.agg is None:
            # an agg-tail Pipeline child is legitimate (a HAVING chain's
            # pipeline sits over the fused aggregate it filters; the
            # aggregate terminates the lower chain, so the two can never
            # merge) — only plain-over-plain means a non-maximal chain
            self._viol(
                "pipeline", node,
                "Pipeline child is itself a Pipeline (chain not maximal)",
            )
        cur = child
        for s in node.stages:
            if not isinstance(s, (P.Filter, P.Project)):
                self._viol(
                    "pipeline", node,
                    f"stage {type(s).__name__} is not Filter/Project",
                )
                return None
            if s.child is not None:
                self._viol(
                    "pipeline", node,
                    f"stage {type(s).__name__} still has an attached child "
                    f"(stages must be detached copies)",
                )
                return None
            if self._refs.get(id(s), 1) > 1:
                self._viol(
                    "pipeline", node,
                    f"stage {type(s).__name__} is referenced elsewhere in "
                    f"the plan (Pipeline wraps a shared node, defeating "
                    f"by-identity result reuse)",
                )
                return None
            exprs = (
                [s.predicate]
                if isinstance(s, P.Filter)
                else [e for e, _ in s.items]
            )
            for e in exprs:
                if not _expr_fusible(e):
                    self._viol(
                        "pipeline", node,
                        f"stage expression {e} is not fusible (subquery/"
                        f"aggregate/window must never enter a Pipeline)",
                    )
            if cur is None:
                continue
            if isinstance(s, P.Filter):
                dt = self._try_expr(
                    s.predicate, cur, node, "pipeline filter predicate"
                )
                if dt is None:
                    cur = None
            else:
                cur = self._project_over(node, s.items, cur)
        if node.agg is not None:
            return self._check_pipeline_agg(node, cur)
        return cur

    def _check_donate_ok(self, node: P.Pipeline):
        """`donate_ok` is fuse's clearance to reuse the child's live mask
        in place — provably wrong whenever another plan node (or a
        cross-statement cache) can still observe it. Mirrors
        fuse._donate_ok_child; a rewrite that sets the flag outside these
        bounds corrupts live memory, so the verifier re-derives it."""
        if not node.donate_ok:
            return
        if self._refs.get(id(node.child), 1) > 1:
            self._viol(
                "donate", node,
                "donate_ok set but the pipeline child has multiple "
                "consumers; donating its buffers would invalidate the "
                "other consumer's input",
            )
        elif isinstance(node.child, _NO_DONATE_CHILD) or (
            isinstance(node.child, P.Pipeline)
            and node.child.agg is not None
        ):
            self._viol(
                "donate", node,
                f"donate_ok set on a {type(node.child).__name__} child "
                f"whose result a cache or base table retains beyond this "
                f"call",
            )

    def _check_pipeline_agg(self, node: P.Pipeline, cur):
        """The fused aggregate tail: detached, unshared, plain-shaped,
        fully decomposable — the exact eligibility fuse._agg_fusible
        proved at rewrite time, re-derived here so a later pass that
        mutates the plan cannot leave a stale (now-wrong) fusion."""
        agg = node.agg
        if agg.child is not None:
            self._viol(
                "pipeline-agg", node,
                "aggregate tail still has an attached child (must be a "
                "detached copy)",
            )
            return None
        if self._refs.get(id(agg), 1) > 1:
            self._viol(
                "pipeline-agg", node,
                "aggregate tail is referenced elsewhere in the plan "
                "(Pipeline wraps a shared Aggregate)",
            )
            return None
        if agg.grouping_sets is not None or agg.blocked_union:
            self._viol(
                "pipeline-agg", node,
                "aggregate tail must be plain-shaped (no grouping sets — "
                "the rollup cascade re-aggregates across levels; no "
                "blocked_union — the windowed executor owns those)",
            )
            return None
        if not P.aggs_decomposable(agg.aggs):
            self._viol(
                "pipeline-agg", node,
                "non-decomposable aggregate set fused into a Pipeline "
                "tail (distinct/stddev/grouping cannot run as a direct "
                "partial-aggregate scatter)",
            )
            return None
        for e, name in agg.keys:
            if not _expr_fusible(e):
                self._viol(
                    "pipeline-agg", node,
                    f"group key {name!r} is not fusible into one call",
                )
                return None
        for a, name in agg.aggs:
            if a.arg is not None and not _expr_fusible(a.arg):
                self._viol(
                    "pipeline-agg", node,
                    f"aggregate argument of {name!r} is not fusible "
                    f"into one call",
                )
                return None
        if cur is None:
            return None
        out = {}
        for g, name in agg.keys:
            dt = self._try_expr(g, cur, node, f"group key {name!r}")
            if dt is None:
                return None
            if name in out:
                self._viol(
                    "schema", node, f"duplicate output column {name!r}"
                )
                return None
            out[name] = dt
        for a, name in agg.aggs:
            dt = self._agg_dtype(a, cur, agg)
            if dt is None:
                return None
            if name in out:
                self._viol(
                    "schema", node, f"duplicate output column {name!r}"
                )
                return None
            out[name] = dt
        return out

    # ------------------------------------------------------------------
    # aggregate / window dtype rules (mirror exec._eval_agg/_eval_window)
    # ------------------------------------------------------------------
    def _agg_dtype(self, a: E.Agg, child, node):
        fn = a.fn
        if fn == "grouping":
            # the arg is the raw key expr or the key's output Col (the
            # executor matches either form against the node's key items)
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
        if fn == "avg":
            if d.is_string:
                self._viol("schema", node, "avg over a string column")
                return None
            return FLOAT64
        if fn in ("stddev_samp", "var_samp"):
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
                self._viol(
                    "schema", node, f"window {fn} needs an argument"
                )
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
            have = list(sch)[:6]
            raise _Unres(f"unresolved column {key!r} (have {have}...)")
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
        if isinstance(e, E.SubqueryExpr):
            raise _Unres(
                "unplanned SubqueryExpr survived binding (must be lowered "
                "to a join or ScalarSubquery)"
            )
        if isinstance(e, E.Agg):
            raise _Unres(
                f"aggregate {e.fn} in scalar context (must be rewritten to "
                f"an Aggregate output column)"
            )
        if isinstance(e, E.WindowFn):
            raise _Unres(
                f"window function {e.fn} in scalar context (must be "
                f"extracted to a Window node)"
            )
        raise _Unres(f"unknown expression {type(e).__name__}")

    def _binop_dtype(self, e: E.BinOp, sch) -> DType:
        op = e.op
        a = self._expr_dtype(e.left, sch)
        b = self._expr_dtype(e.right, sch)
        if op in ("and", "or"):
            return BOOL
        if op in ("=", "<>", "!=", "<", "<=", ">", ">="):
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
            # ifnull/nvl deliberately NOT accepted: the evaluator does not
            # implement them (Evaluator._eval_func), and a plan that
            # verifies clean must not crash at execution
            out = args[0]
            for d in args[1:]:
                out = _promote(out, d)
            return out
        if name == "abs":
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
        if name == "nullif":
            return args[0]
        if name == "concat":
            return STRING
        raise _Unres(f"unknown scalar function {e.name!r}")

    # ------------------------------------------------------------------
    # binder LEFT->INNER promotion cross-check
    # ------------------------------------------------------------------
    def _check_promotions(self, promotions):
        for rec in promotions or ():
            conj = rec.get("conjunct")
            refs = rec.get("refs")
            if conj is None or not _null_rejecting_shape(conj):
                self._viol(
                    "left-inner-promotion", None,
                    f"LEFT JOIN promoted to INNER from a conjunct that is "
                    f"NOT null-rejecting: {conj} (would drop the outer "
                    f"join's null-extended rows incorrectly)",
                )
            if not refs:
                self._viol(
                    "left-inner-promotion", None,
                    f"LEFT JOIN promotion recorded without any reference "
                    f"into the promoted relation: {conj}",
                )


def verify_plan(
    plan: P.PlanNode,
    catalog=None,
    stage: str = "final",
    promotions=(),
    mesh=None,
) -> None:
    """Run the PlanVerifier; raise PlanVerifyError (classified `planner` by
    faults.classify) on any violation. A `mesh` raises NotImplementedError
    (the sharding family is ROADMAP.md queue 1 item 13)."""
    violations = PlanVerifier(catalog).verify(plan, promotions, mesh=mesh)
    # the reference emits a `plan_verify` trace event here: tracing is
    # ROADMAP.md queue 1 item 12, and the port emits none
    if violations:
        raise PlanVerifyError(stage, violations)
