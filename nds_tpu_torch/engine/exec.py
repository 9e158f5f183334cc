"""Plan executor over device Tables: the single-device subset of
nds_tpu/engine/exec.py.

Eager, operator-at-a-time execution over power-of-two-bucketed torch
buffers, with the JAX executor's plan choices kept as they are: deferred
compaction, the dense star-join, sort-free direct aggregation, the packed
sort words, and the `engine.pallas_*` kernel routes. The routes choose by
the tensor's device, never by a platform probe: on a CUDA tensor they
launch the hand-written kernels of ops/gpu_kernels.py, on a CPU tensor the
kernels' plain versions run.

Ported: scan, filter, project, fused Filter/Project pipelines and
aggregate tails (engine/fuse.py), limit with the Limit-over-Sort top-k,
sort, MultiJoin/Join (the dense star-join, the packed-word join and the
hash-candidate join for inner, left, right, full, semi, anti and mark
joins, with residuals, and the cross join; join orders replayed across
statements), DISTINCT, the set operations (UNION [ALL], INTERSECT,
EXCEPT), aggregate (direct and sort-based, distinct aggregates included),
ROLLUP / grouping sets with grouping(), blocked union aggregation,
windows, scalar subqueries, the session's plan / result cache, and the
out-of-core paths (the spilled join, sort and distinct, staged through
the session's host-RAM spill pool). What is left is a path the JAX
executor declines on one device (the mesh's exchange join and its spill
fallback); none returns a different answer.
"""

from __future__ import annotations

import itertools
from dataclasses import replace as _dc_replace
from time import perf_counter as _perf

import numpy as np
import torch

from .. import faults
from ..dtypes import BOOL, DType, FLOAT64, INT32, INT64
from ..ops import gpu_kernels as GK
from ..ops import kernels as K
from . import aotcache as AOTC
from . import arrowlib
from . import expr as E
from . import fuse
from . import plan as P
from . import spill as SP
from .columnar import (
    Column,
    Table,
    bucket_cap,
    sort_dictionary,
    table_device_bytes,
    torch_dtype,
    unify_dictionaries,
    window_slice,
)
from .expr import Evaluator, _cast_column, _common_dtype, _share_dictionary

#: op_span exec ids: one per traced executor (statement) in the process
_EXEC_IDS = itertools.count(1)


class ExecError(Exception):
    pass


def _cascade_agg_items(agg_items):
    """Re-aggregation exprs for the rollup cascade, or None when any
    aggregate does not decompose over partial results. sum/min/max compose
    with themselves; any count becomes a sum of the level below's counts."""
    out = []
    for a, name in agg_items:
        if a.distinct or a.fn not in ("sum", "min", "max", "count"):
            return None
        fn = "sum" if a.fn == "count" else a.fn
        out.append((E.Agg(fn, E.Col(name)), name))
    return out


def _rollup_base_aggs(agg_items):
    """(base agg list, avg items) for grouping-sets execution: every plain
    avg splits into hidden sum (__cs_<name>) and count (__cc_<name>)
    columns so that the cascade can compose it; _derive_rollup_avgs derives
    the visible avg per part with the direct avg path's semantics (float64,
    decimal descale, NULL on empty). (None, []) when an aggregate rules the
    rewrite out."""
    if not P.aggs_decomposable(agg_items):
        return None, []
    avg_items = [(a, n) for a, n in agg_items if a.fn == "avg"]
    if not avg_items:
        return list(agg_items), []
    base = []
    for a, name in agg_items:
        if a.fn == "avg":
            base.append((E.Agg("sum", a.arg), f"__cs_{name}"))
            base.append((E.Agg("count", a.arg), f"__cc_{name}"))
        else:
            base.append((a, name))
    return base, avg_items


def _derive_rollup_avgs(part: Table, avg_items):
    if not avg_items:
        return part
    cols = dict(part.columns)
    for _, name in avg_items:
        cs = cols[f"__cs_{name}"]
        n = cols[f"__cc_{name}"].data
        val = cs.data.to(torch.float64) / n.clamp(min=1)
        if cs.dtype.is_decimal:
            val = val / 10**cs.dtype.scale
        cols[name] = Column(val, FLOAT64, n > 0)
    return Table(cols, part.nrows_lazy, live=part.live)


def _segment_cumsum(x, gid):
    """Cumulative sum within segments (gid sorted ascending): the global
    prefix sum less its value just before each row's segment head. The
    head-1 read is clamped and masked where the head is row 0."""
    total = K.fast_cumsum(x)
    idx = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    seg_start = K.fast_cummax(torch.where(K.segment_heads(gid), idx, 0))
    before = total[(seg_start - 1).clamp(min=0).long()]
    return total - torch.where(seg_start > 0, before, 0)


def _resolve_bounds(datas, valids, stats_list, wanted, live):
    """(vmin, vmax) per column: from cached ColStats when present, else one
    batched min/max + a single device->host transfer for ALL missing
    ranges. `wanted[i]=False` slots return None."""
    bounds, need = [], []
    for i, (st, w) in enumerate(zip(stats_list, wanted)):
        if not w:
            bounds.append(None)
            continue
        if st is not None and st.vmin is not None and st.vmax is not None:
            bounds.append((int(st.vmin), int(st.vmax)))
        else:
            bounds.append(None)
            need.append(i)
    if need:
        fetched = K.batched_min_max(
            [datas[i].to(torch.int64) for i in need],
            [valids[i] for i in need],
            live,
        ).tolist()
        for i, mm in zip(need, fetched):
            bounds[i] = (int(mm[0]), int(mm[1]))
    return bounds


def _plain_col_names(exprs, table):
    """Column names referenced by plain Col exprs, resolved the way the
    evaluator resolves them against `table`."""
    out = set()
    for e in exprs:
        if isinstance(e, E.Col):
            key = f"{e.table}.{e.name}" if e.table else e.name
            if key not in table.columns and e.name in table.columns:
                key = e.name
            out.add(key)
    return out


def _active_key_names(key_items, key_cols):
    return frozenset(
        name for (_, name), c in zip(key_items, key_cols) if c is not None
    )


def _group_key_stats(c: Column, n_active_keys: int):
    st = c.subset_stats()
    if st is None:
        return None
    return _dc_replace(st, unique=(n_active_keys == 1))


class _DictStats:
    """Static bounds facade for dictionary-coded columns."""

    __slots__ = ("vmin", "vmax", "unique", "base_rows")

    def __init__(self, vmin, vmax):
        self.vmin = vmin
        self.vmax = vmax
        self.unique = False
        self.base_rows = 0


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _pad_to(x, n):
    """`x` zero-padded at the end to length `n` (the JAX code's jnp.pad)."""
    return torch.cat([x, x.new_zeros(n - x.shape[0])])


def _stack(x, y, nx, ny, n):
    """x[:nx] then y[:ny], zero-padded to length `n`, in one allocation."""
    out = x.new_zeros(n)
    out[:nx] = x[:nx]
    out[nx:nx + ny] = y[:ny]
    return out


class _ExecEvaluator(Evaluator):
    """The executor's Evaluator: scalar subqueries run through it. A class
    of the module, not one made per call: a class made per call would hold
    the executor in a reference cycle, and with it every table of the
    statement on the device until the cyclic collector ran."""

    def __init__(self, table: Table, device, ex):
        super().__init__(table, device)
        self.ex = ex

    def _eval_scalarsubquery(self, e):
        val, dtype, dictionary = self.ex._scalar_value(e)
        cap = self.table.cap
        dev = self.device
        if val is None:
            return Column(
                torch.zeros(cap, dtype=torch_dtype(dtype), device=dev),
                dtype, torch.zeros(cap, dtype=torch.bool, device=dev),
                dictionary,
            )
        return Column(
            torch.full((cap,), val, dtype=torch_dtype(dtype), device=dev),
            dtype, None, dictionary,
        )


class Executor:
    def __init__(self, catalog, device, tracer=None):
        """catalog: object with .load(table_name, columns) -> Table and a
        `.session` (conf, promotion memo, tracer). device: where constants
        and column-less tables live. tracer: overrides the session's (serve
        mode's per-request forwarder).

        With the session's tracer every executed plan node records an
        `op_span` event with inclusive wall time, output rows and
        estimated output bytes. On a CUDA device the wall time is host
        dispatch time, not device time: a span ends when its node's
        launches are queued (and any host sync inside it has waited).
        Span state (exec id, seq, depth) is per executor, and every
        statement builds its own."""
        self.catalog = catalog
        self.device = torch.device(device)
        self._cte_cache = {}  # id(plan) -> Table
        self._scalar_cache = {}  # id(plan) -> python value
        self._fp_cache = {}  # id(plan) -> structural fingerprint
        # the running aggregation's keys (grouping()), live mask and count
        # (distinct aggregates)
        self._current_agg_keys = None
        self._current_agg_live = None
        self._current_agg_nlive = None
        # stats of the most recent blocked union aggregation (tests/tools)
        self.last_blocked_union = None
        # stats of this statement's out-of-core (spilled) operators: ops,
        # partitions, pool bytes in / out, evictions
        self.last_spill = None
        self._fault_checked = False
        if tracer is None:
            tracer = getattr(getattr(catalog, "session", None), "tracer",
                             None)
        self.tracer = tracer
        self._span_depth = 0
        self._span_seq = 0
        self._exec_id = next(_EXEC_IDS) if tracer is not None else 0

    # pipeline breakers whose actual row count is worth a forced host sync
    # when it is not already there: a handful per plan, and their consumers
    # are about to sync anyway. Row-preserving nodes record only when the
    # count is already on the host: feedback must not add a device round
    # trip per executed node (on CUDA `Table.nrows` of a queued count is a
    # host sync)
    _FEEDBACK_SYNC = (P.Join, P.MultiJoin, P.Aggregate, P.Distinct,
                      P.SetOp, P.Window, P.Sort)

    def _record_feedback(self, node, out):
        """Record this node's measured cardinality into the session's
        FeedbackStore (buffered; Result.table flushes per statement). Only
        called for nodes budget_plan annotated with `node_fp`, i.e.
        engine.plan_feedback is record / on and a store exists."""
        session = getattr(self.catalog, "session", None)
        store = getattr(session, "feedback_store", None)
        if store is None:
            return
        rows = out.nrows_known
        if rows is None and (
            isinstance(node, self._FEEDBACK_SYNC)
            or (isinstance(node, P.Pipeline) and node.agg is not None)
        ):
            rows = out.nrows
        if rows is None:
            return
        est_rows = getattr(node, "est_rows", None)
        with session.cache_lock:
            err = store.record(
                node.node_fp, rows=rows, nbytes=table_device_bytes(out),
                est_rows=est_rows,
            )
        if self.tracer is not None:
            ev = dict(op="record", result="ok",
                      node=type(node).__name__, actual_rows=int(rows))
            if est_rows is not None:
                ev["est_rows"] = int(est_rows)
            if err is not None:
                ev["abs_log_err"] = round(err, 4)
            self.tracer.emit("plan_feedback", **ev)

    # ------------------------------------------------------------------
    def execute(self, node: P.PlanNode) -> Table:
        if not self._fault_checked:
            # the `exec:<query>` injection site, once per executor (one
            # statement): past parse and bind, inside the engine proper,
            # so the report ladder sees what a failure mid-execution looks
            # like
            self._fault_checked = True
            if faults.active():
                scope = faults.current_scope()
                if scope is not None:
                    faults.maybe_fire(f"exec:{scope}")
        key = id(node)
        if key in self._cte_cache:
            return self._cte_cache[key]
        # agg-tail Pipelines are the fused form of a (cacheable) Aggregate:
        # they keep the cross-statement reuse the raw node had
        cacheable = isinstance(node, self._CACHEABLE) or (
            isinstance(node, P.Pipeline) and node.agg is not None
        )
        cache = self._session_cache() if cacheable else None
        tracer = self.tracer
        if cache is not None:
            with self.catalog.session.cache_lock:
                hit = cache.get(self._fp(node))
            if tracer is not None:
                tracer.emit(
                    "plan_cache", node=type(node).__name__,
                    hit=hit is not None,
                )
            if hit is not None:
                self._cte_cache[key] = hit
                return hit
        m = getattr(self, f"_exec_{type(node).__name__.lower()}")
        if tracer is not None:
            # INCLUSIVE wall time (children execute inside this frame);
            # repeated visits are cte-cache hits, so each node records once
            # per executor. Spans emit in completion (post-) order with
            # (exec_id, seq, depth), from which the profiler rebuilds the
            # tree and derives exclusive times.
            depth = self._span_depth
            self._span_depth = depth + 1
            t0 = _perf()
            try:
                out = m(node)
            finally:
                self._span_depth = depth
            dur_ms = (_perf() - t0) * 1000.0
            # estimate-vs-actual accounting BEFORE the span emit: a
            # pipeline breaker's record may force the queued count onto
            # the host, and the span's actual_rows should see it
            fp = getattr(node, "node_fp", None)
            if fp is not None:
                self._record_feedback(node, out)
            self._span_seq += 1
            span = dict(
                exec_id=self._exec_id,
                seq=self._span_seq,
                depth=depth,
                node=type(node).__name__,
                explain=P.node_desc(node)[:90],
                dur_ms=round(dur_ms, 3),
                # nrows_known only: forcing a queued count would add a
                # device sync to every traced node
                rows=out.nrows_known,
                est_bytes=table_device_bytes(out),
            )
            if fp is not None:
                # budgeter accounting (analysis/feedback.py annotations):
                # est_rows / est_live_bytes are the static model's numbers,
                # actual_* what this execution measured; `est_bytes` above
                # keeps its meaning (realized device bytes)
                span["node_fp"] = fp
                span["est_rows"] = getattr(node, "est_rows", None)
                span["est_live_bytes"] = getattr(
                    node, "est_live_bytes", None
                )
                span["actual_rows"] = out.nrows_known
                span["actual_bytes"] = table_device_bytes(out)
            tracer.emit("op_span", **span)
        else:
            out = m(node)
            if getattr(node, "node_fp", None) is not None:
                self._record_feedback(node, out)
        self._cte_cache[key] = out
        if cache is not None:
            with self.catalog.session.cache_lock:
                cache.put(self._fp(node), out)
        return out

    # plan-node types worth caching across statements: the expensive
    # pipeline breakers (a CTE body virtually always ends in one)
    _CACHEABLE = (P.Aggregate, P.Distinct, P.SetOp, P.Window)

    def _session_cache(self):
        """The session's plan / result cache, or None (no session, or
        `engine.plan_cache=off`)."""
        session = getattr(self.catalog, "session", None)
        if session is None:
            return None
        if session.conf.get("engine.plan_cache", "on") == "off":
            return None
        return session.plan_cache

    def _fp(self, node) -> str:
        key = id(node)
        fp = self._fp_cache.get(key)
        if fp is None:
            fp = self._fp_cache[key] = P.fingerprint(node)
        return fp

    # ------------------------------------------------------------------
    def _exec_scan(self, node: P.Scan) -> Table:
        # lake_version: the plan-time snapshot pin (Session._pin_lake_scans),
        # which keeps the scan on its statement's snapshot even when another
        # stream sharing the session has re-pinned the entry; lake_files:
        # the zone-map pruned file subset (Session._prune_lake_scans), so
        # the load opens only the surviving files
        t = self.catalog.load(
            node.table, node.columns, lake_version=node.lake_version,
            lake_files=node.lake_files,
        )
        uk = t.unique_key
        if uk is not None:
            uk = frozenset(f"{node.alias}.{n}" for n in uk)
        return Table(
            {f"{node.alias}.{n}": c for n, c in t.columns.items()}, t.nrows,
            unique_key=uk,
        )

    def _exec_materializedscan(self, node: P.MaterializedScan) -> Table:
        if node.name == "__dual__":
            return Table({}, 1)
        if node.table is None:
            raise ExecError(f"materialized scan {node.name} not populated")
        return node.table

    def _exec_project(self, node: P.Project) -> Table:
        return self._project_table(self.execute(node.child), node.items)

    def _project_table(self, child: Table, items) -> Table:
        ev = self._evaluator(child)
        cols = {}
        renames = {}  # child column name -> output name (plain Col items)
        for e, name in items:
            cols[name] = ev.eval(e)
            if isinstance(e, E.Col):
                key = f"{e.table}.{e.name}" if e.table else e.name
                if key not in child.columns and e.name in child.columns:
                    key = e.name
                renames.setdefault(key, name)
        if not cols:
            return Table({}, child.nrows)
        uk = child.unique_key
        if uk is not None and all(k in renames for k in uk):
            uk = frozenset(renames[k] for k in uk)
        else:
            uk = None
        return Table(cols, child.nrows_lazy, live=child.live, unique_key=uk)

    def _exec_filter(self, node: P.Filter) -> Table:
        child = self.execute(node.child)
        return self._masked(child, self._predicate_mask(child, node.predicate))

    # -- fused Filter/Project pipelines -----------------------------------
    # A Pipeline node (fuse.mark_pipelines) runs its whole chain through
    # one entry of the session's ExecutableCache (engine/fuse.py): the
    # host-side dictionary work was done once at the entry's build, masks
    # fold into one deferred live mask, and no Table is made per stage.
    # Entries are reused across reruns AND structurally identical queries
    # (stage fingerprint + input signature). Signatures whose build reads
    # device values on the host are pinned to the exact eager per-stage
    # path, the signatures the JAX package pins.

    def _aot_build_args(self, session):
        """(AotCache | None, conf signature) for a fused build: the
        session's persistent cache plus the engine conf values that change
        the build's products and so join the stored entry's key."""
        aot = getattr(session, "aot_cache", None) if session else None
        if aot is None:
            return None, ()
        return aot, (
            str(session.conf.get("engine.fuse_agg", "on")),
            str(session.conf.get("engine.pallas_agg", "off")),
        )

    def _exec_pipeline(self, node: P.Pipeline) -> Table:
        child = self.execute(node.child)
        session = getattr(self.catalog, "session", None)
        tracer = self.tracer
        t0 = _perf() if tracer is not None else 0.0
        out = None
        fused = False
        has_agg = node.agg is not None
        if (
            session is not None
            and session.conf.get("engine.fuse", "on") != "off"
            and child.columns
            and child.cap > 0
            # backstop only: the plan rewrite already keeps the aggregate
            # out under a kernel mode (Session._finish_plan); this fires
            # for a plan made before the conf turned pallas_agg on, whose
            # fused scatter would bypass the per-aggregate kernel route
            and not (
                has_agg
                and session.conf.get("engine.pallas_agg", "off") != "off"
            )
        ):
            fp = getattr(node, "_stage_fp", None)
            if fp is None:
                fp = node._stage_fp = P.fingerprint(
                    P.Pipeline(stages=node.stages, child=None, agg=node.agg)
                )
            sig = fuse.input_signature(child, with_stats=has_agg)
            aot, conf_sig = self._aot_build_args(session)
            with session.cache_lock:
                entry, hit = session.exec_cache.lookup(
                    fp, sig, child.cap,
                    lambda: fuse.build_entry(node.stages, node.agg, child,
                                             aot, fp, conf_sig),
                )
            if tracer is not None:
                tracer.emit(
                    "exec_cache", pipeline=fp[:12], bucket=child.cap,
                    hit=hit, fused=entry is not None,
                )
            if entry is not None:
                donate = (
                    node.donate_ok
                    and session.conf.get("engine.fuse_donate", "off") == "on"
                )
                out = entry.call(child, donate)
                fused = True
        if out is None:
            # eager per-stage path (_apply_wrappers wants top-down order)
            out = self._apply_wrappers(child, list(reversed(node.stages)))
            if has_agg:
                out = self._aggregate_once(
                    node.agg.keys, node.agg.aggs, None, out,
                    out.row_mask(self.device), out.nrows_known,
                )
        if tracer is not None:
            tracer.emit(
                "pipeline_span",
                stages=len(node.stages),
                fused=fused,
                agg=has_agg,
                dur_ms=round((_perf() - t0) * 1000.0, 3),
                rows=out.nrows_known,
            )
        return out

    def _exec_limit(self, node: P.Limit) -> Table:
        # top-k: ORDER BY .. LIMIT n computes the sort order but gathers
        # only the first bucket_cap(n) sorted rows of each column, not the
        # whole permutation. Needs the rewrite pass's single-consumer
        # annotation (fuse.mark_pipelines sets _topk_safe): a shared Sort's
        # full result must compute once and serve every consumer.
        if (
            isinstance(node.child, P.Sort)
            and getattr(node.child, "_topk_safe", False)
            and id(node.child) not in self._cte_cache
        ):
            sort = node.child
            child = self._pack_sparse(self.execute(sort.child))
            n = min(node.n, child.nrows)
            cap = bucket_cap(max(n, 1))
            if child.nrows_known != 0:
                order = self._sort_perm_route(
                    self._sort_order_words(sort, child))
                return self._take(child, order[:cap], n)
            return Table(
                {
                    name: Column(
                        c.data[:cap], c.dtype,
                        None if c.valid is None else c.valid[:cap],
                        c.dictionary, c.subset_stats(),
                    )
                    for name, c in child.compacted().columns.items()
                },
                n,
            )
        child = self.execute(node.child).compacted()
        n = min(node.n, child.nrows)
        cap = bucket_cap(n)
        cols = {
            name: Column(
                c.data[:cap], c.dtype,
                None if c.valid is None else c.valid[:cap],
                c.dictionary, c.subset_stats(),
            )
            for name, c in child.columns.items()
        }
        return Table(cols, n)

    def _exec_sort(self, node: P.Sort) -> Table:
        child = self._pack_sparse(self.execute(node.child))
        if child.nrows_known == 0:
            return child
        words = self._sort_order_words(node, child)
        order = self._sort_perm_route(words)
        parts = self._spill_parts_for(node)
        if parts > 1:
            # external sort: the same permutation, but the output gather
            # runs in bounded windows staged through the host spill pool
            # (bit-identical to the direct path)
            out = self._spilled_take(child, order, parts, op="sort")
            if out is not None:
                return out
        return self._take(child, order, child.nrows_lazy)

    def _sort_order_words(self, node: P.Sort, child: Table):
        ev = self._evaluator(child)
        keys = []
        cols = []
        for e, asc, nf in node.keys:
            col = ev.eval(e)
            cols.append(col)
            data = col.data
            if col.dtype.is_string:
                data, _ = sort_dictionary(col)
            if col.dtype.kind == "bool":
                data = data.to(torch.int32)
            if nf is None:
                nf = asc  # Spark: NULLS FIRST for ASC, NULLS LAST for DESC
            keys.append((data, col.valid, asc, nf))
        return self._sort_words(keys, cols, child.row_mask())

    # -- sort-key word encoding (see the JAX executor's _sort_words) -------

    def _sort_words(self, keys, cols, live, include_live=True):
        packable = [not d.is_floating_point() for d, _, _, _ in keys]
        stats_list = []
        for (d, v, _, _), c, pk in zip(keys, cols, packable):
            if c is not None and c.dictionary is not None:
                stats_list.append(
                    _DictStats(0, max(len(c.dictionary) - 1, 0))
                )
            else:
                stats_list.append(c.stats if c is not None else None)
        bounds = _resolve_bounds(
            [k[0] for k in keys], [k[1] for k in keys], stats_list, packable,
            live,
        )
        spec = []
        arrays = []
        if include_live:
            spec.append(("L",))
        for (d, v, asc, nf), pk, b in zip(keys, packable, bounds):
            if nf is None:
                nf = asc
            hv = v is not None
            if d.dtype == torch.bool:
                d = d.to(torch.int32)
            if pk:
                vmin, vmax = b
                if vmax < vmin:  # empty/all-null: constant key, skip
                    continue
                span = vmax - vmin + 3  # codes 1..span-2; 0, top for NULL
                width = K.quantize_width(max(1, int(span - 1).bit_length()))
                if width <= 62:
                    spec.append(("i", width, asc, nf, hv))
                    arrays += [d, vmin, vmax]
                    if hv:
                        arrays.append(v)
                    continue
                spec.append(("I", asc, nf, hv))
            else:
                spec.append(("f", asc, nf, hv))
            arrays.append(d)
            if hv:
                arrays.append(v)
        if not spec:  # every key constant: one trivial live word
            spec.append(("L",))
        return list(K.build_sort_words(tuple(spec), live, *arrays))

    def _group_words(self, active_cols, live):
        keys = []
        for c in active_cols:
            d = c.data
            if d.dtype == torch.bool:
                d = d.to(torch.int32)
            keys.append((d, c.valid, True, True))
        return self._sort_words(keys, active_cols, live)

    def _exec_distinct(self, node: P.Distinct) -> Table:
        child = self.execute(node.child)
        if child.nrows_known == 0:
            return child
        return self._distinct_table(
            child, spill_parts=self._spill_parts_for(node)
        )

    # ------------------------------------------------------------------
    def _exec_setop(self, node: P.SetOp) -> Table:
        left = self.execute(node.left)
        right = self.execute(node.right)
        if node.op == "union_all":
            return self._concat(left, right)
        if node.op == "union":
            return self._distinct_table(
                self._concat(left, right),
                spill_parts=self._spill_parts_for(node),
            )
        # intersect / except: set semantics over whole rows
        dl = self._distinct_table(left)
        lkeys, lvalids, rkeys, rvalids = [], [], [], []
        for ln, rn in zip(dl.columns, right.columns):
            for lk, rk in zip(
                *self._join_key_pair(dl.columns[ln], right.columns[rn])
            ):
                lkeys.append(lk.data)
                lvalids.append(lk.valid)
                rkeys.append(rk.data)
                rvalids.append(rk.valid)
        # NULLs compare equal in set ops: fold validity into the key and add
        # one null-flag key per column on BOTH sides (the sides can differ
        # in nullability; the flag lists must stay aligned)
        keys_l = [d if v is None else torch.where(v, d, 0)
                  for d, v in zip(lkeys, lvalids)]
        keys_r = [d if v is None else torch.where(v, d, 0)
                  for d, v in zip(rkeys, rvalids)]
        llive = dl.row_mask(self.device)
        rlive = right.row_mask(self.device)
        for lv, rv in zip(lvalids, rvalids):
            keys_l.append(~lv if lv is not None else torch.zeros_like(llive))
            keys_r.append(~rv if rv is not None else torch.zeros_like(rlive))
        nones = [None] * len(keys_l)
        li, ri, pl, _ = K.join_candidates(keys_l, nones, llive,
                                          keys_r, nones, rlive)
        ok = K.verify_pairs(li, ri, pl, keys_l, nones, llive,
                            keys_r, nones, rlive)
        present = K.matched_mask(li, ok, dl.cap)
        if node.op == "intersect":
            mask = present & llive
        else:
            mask = ~present & llive
        return self._masked(dl, mask)

    # ------------------------------------------------------------------
    def _exec_join(self, node: P.Join) -> Table:
        left = self.execute(node.left)
        right = self.execute(node.right)
        return self._join(
            left, right, node.kind, node.left_keys, node.right_keys,
            node.residual, node.mark_name,
            spill_parts=self._spill_parts_for(node),
        )

    def _exec_multijoin(self, node: P.MultiJoin) -> Table:
        tables = self._execute_relations_batched(node.relations)
        # join-order replay ACROSS statements: the greedy cost scan reads
        # joined-intermediate row counts, one blocking device->host sync
        # per join step after the first. Reruns and repeated stream queries
        # replay the recorded order instead (same fingerprint => same query
        # text and literals; any order is correct regardless).
        trace = None
        session = getattr(self.catalog, "session", None)
        if (
            session is not None
            and session.conf.get("engine.join_order_cache", "on") != "off"
        ):
            with session.cache_lock:
                trace = session.join_order_cache.setdefault(
                    self._fp(node), {}
                )
        return self._multijoin_over_tables(
            tables, node.edges, trace=trace,
            spill_parts=self._spill_parts_for(node),
        )

    def _multijoin_over_tables(self, tables, edges, trace=None,
                               spill_parts=0) -> Table:
        """Greedy N-way inner join over already-executed relation tables
        (shared by _exec_multijoin and blocked union aggregation, which
        joins each union window against the other relations). `trace`: an
        optional dict; the first call records its join order in it and
        later calls replay that order, skipping the greedy cost scan, whose
        row-count reads are device->host syncs."""
        n = len(tables)
        if n == 1:
            return tables[0]
        edges = list(edges)
        merged = list(range(n))

        def group(i):
            while merged[i] != i:
                i = merged[i]
            return i

        current = {i: tables[i] for i in range(n)}
        return self._multijoin_greedy(current, edges, merged, group, n,
                                      trace, spill_parts)

    def _execute_relations_batched(self, relations):
        """Execute a MultiJoin's relations and bring every still-lazy live
        count to the host in ONE device->host transfer."""
        tables = [self.execute(r) for r in relations]
        lazy = [t for t in tables if t.nrows_known is None]
        if lazy:
            counts = torch.stack(
                [t.nrows_lazy.to(torch.int64) for t in lazy]
            ).tolist()
            for t, v in zip(lazy, counts):
                t._nrows = int(v)
        return tables

    def _multijoin_greedy(self, current, edges, merged, group, n,
                          trace=None, spill_parts=0):
        # greedy: repeatedly take the connecting edge whose joined inputs
        # are smallest (sum of live rows) and execute that join. When
        # `trace` carries recorded steps, replay them instead (replay never
        # reads .nrows: the blocked union path joins every window with no
        # count syncs)
        replay = trace is not None and "steps" in trace
        steps = trace["steps"] if replay else []
        step_i = 0
        while True:
            groups = {group(i) for i in range(n)}
            if len(groups) == 1:
                break
            if replay:
                kind, gi, gj = steps[step_i]
                step_i += 1
            else:
                best = None
                for k, (i, j, le, re_) in enumerate(edges):
                    gi, gj = group(i), group(j)
                    if gi == gj:
                        continue
                    cost = current[gi].nrows + current[gj].nrows
                    if best is None or cost < best[0]:
                        best = (cost, k, gi, gj)
                if best is None:
                    kind, gi, gj = "cross", *sorted(
                        groups, key=lambda g: current[g].nrows
                    )[:2]
                else:
                    kind, gi, gj = "edge", best[2], best[3]
                steps.append((kind, gi, gj))
            if kind == "cross":
                # disconnected components: cross join the smallest two
                joined = self._join(
                    current[gi], current[gj], "cross", [], [], None
                )
                merged[gj] = gi
                current[gi] = joined
                continue
            lkeys, rkeys = [], []
            rest = []
            for (i, j, le, re_) in edges:
                if {group(i), group(j)} == {gi, gj}:
                    if group(i) == gi:
                        lkeys.append(le)
                        rkeys.append(re_)
                    else:
                        lkeys.append(re_)
                        rkeys.append(le)
                else:
                    rest.append((i, j, le, re_))
            edges = rest
            joined = self._join(
                current[gi], current[gj], "inner", lkeys, rkeys, None,
                spill_parts=spill_parts,
            )
            merged[gj] = gi
            current[gi] = joined
        if trace is not None and not replay:
            # `trace` may be a join_order_cache entry (steady replays read
            # it from other statements' threads) or a blocked-union
            # context's private memo; both callers guarantee a session
            with self.catalog.session.cache_lock:
                trace["steps"] = steps
        return current[group(0)]

    # ------------------------------------------------------------------
    def _pack_sparse(self, t: Table) -> Table:
        """Compact a deferred-compaction table whose live fraction is small
        (sort/hash consumers scale with CAP)."""
        if t.live is None:
            return t
        if t.nrows < max(t.cap // 8, 1024):
            return t.compacted()
        return t

    def _join(self, left, right, kind, left_keys, right_keys, residual,
              mark_name=None, spill_parts=0):
        if kind == "cross":
            return self._cross_join(left, right)
        left = self._pack_sparse(left)
        right = self._pack_sparse(right)
        if kind == "right":
            # swap before any matching so the residual is preserved
            return self._join(right, left, "left", right_keys, left_keys,
                              residual, spill_parts=spill_parts)
        lev = self._evaluator(left)
        rev = self._evaluator(right)
        lcols = [lev.eval(e) for e in left_keys]
        rcols = [rev.eval(e) for e in right_keys]
        lk, lv, rk, rv = [], [], [], []
        aligned = []  # (left Column, right Column) pairs, dtype-unified
        for a, b in zip(lcols, rcols):
            for ca, cb in zip(*self._join_key_pair(a, b)):
                aligned.append((ca, cb))
                lk.append(ca.data)
                lv.append(ca.valid)
                rk.append(cb.data)
                rv.append(cb.valid)
        llive = left.row_mask()
        rlive = right.row_mask()
        fast = self._try_dense_join(
            left, right, kind, lcols, rcols, lk, lv, rk, rv, llive, rlive,
            residual, mark_name,
        )
        if fast is not None:
            return fast
        # (the JAX executor's exchange join comes here: a mesh path, which
        # declines off-mesh, with its fallback through the spill pool;
        # ROADMAP.md queue 1 item 13)
        fast = self._try_packed_join(
            left, right, kind, aligned, right_keys, llive, rlive, residual,
            mark_name,
        )
        if fast is not None:
            return fast
        if spill_parts > 1 and kind in ("inner", "left"):
            # out-of-core tier: the hash join's pair expansion and its
            # full-width pair-table gathers are the additive device memory
            # of a build side too big to fit; join hash partitions one pair
            # at a time and stage each output in the host spill pool
            return self._spilled_join(
                left, right, kind, left_keys, right_keys, residual,
                lk, lv, llive, rk, rv, rlive, spill_parts,
            )
        li, ri, pl, total = K.join_candidates(lk, lv, llive, rk, rv, rlive)
        ok = K.verify_pairs(li, ri, pl, lk, lv, llive, rk, rv, rlive)

        if kind in ("semi", "anti", "mark"):
            if residual is not None:
                ok = self._apply_residual(ok, li, ri, left, right, residual)
            present = K.matched_mask(li, ok, left.cap)
            if kind == "mark":
                out_cols = dict(left.columns)
                out_cols[mark_name] = Column(present, BOOL)
                return Table(out_cols, left.nrows_lazy, live=left.live)
            mask = (present if kind == "semi" else ~present) & llive
            return self._masked(left, mask)

        count = K.mask_count(ok)
        out_cap = bucket_cap(max(count, 1))
        sel = K.compact_indices(ok, out_cap)
        pli = li[sel]
        pri = ri[sel]
        if residual is not None:
            # build the pair table first, filter, recompact
            pair = self._pair_table(left, right, pli, pri, count, rnull=None)
            pmask = self._predicate_mask(pair, residual)
            if kind == "inner":
                return self._masked(pair, pmask)
            # outer joins: surviving pairs only count as matches. A
            # max-scatter: sel's padding duplicates index 0
            ok = ok & K.matched_mask(sel, pmask, ok.shape[0])
            count = K.mask_count(ok)
            out_cap = bucket_cap(max(count, 1))
            sel = K.compact_indices(ok, out_cap)
            pli = li[sel]
            pri = ri[sel]

        if kind == "inner":
            return self._pair_table(left, right, pli, pri, count, rnull=None)

        dev = li.device
        if kind == "left":
            present = K.matched_mask(li, ok, left.cap)
            unmatched = ~present & llive
            n_un = K.mask_count(unmatched)
            total_rows = count + n_un
            cap2 = bucket_cap(max(total_rows, 1))
            un_idx = K.compact_indices(unmatched, bucket_cap(max(n_un, 1)))
            all_li = _pad_to(torch.cat([pli[:count], un_idx[:n_un]]), cap2)
            all_ri = _pad_to(
                torch.cat([pri[:count], pri.new_zeros(n_un)]), cap2
            )
            # right side null for the appended rows
            rnull = torch.arange(cap2, device=dev) >= count
            return self._pair_table(left, right, all_li, all_ri, total_rows,
                                    rnull)

        if kind == "full":
            lpresent = K.matched_mask(li, ok, left.cap)
            rpresent = K.matched_mask(ri, ok, right.cap)
            lun = ~lpresent & llive
            run = ~rpresent & rlive
            n_lu = K.mask_count(lun)
            n_ru = K.mask_count(run)
            total_rows = count + n_lu + n_ru
            cap2 = bucket_cap(max(total_rows, 1))
            lu_idx = K.compact_indices(lun, bucket_cap(max(n_lu, 1)))[:n_lu]
            ru_idx = K.compact_indices(run, bucket_cap(max(n_ru, 1)))[:n_ru]
            all_li = _pad_to(
                torch.cat([pli[:count], lu_idx, lu_idx.new_zeros(n_ru)]), cap2
            )
            all_ri = _pad_to(
                torch.cat([pri[:count], ru_idx.new_zeros(n_lu), ru_idx]), cap2
            )
            pos = torch.arange(cap2, device=dev)
            rnull = (pos >= count) & (pos < count + n_lu)
            lnull = pos >= count + n_lu
            return self._pair_table(left, right, all_li, all_ri, total_rows,
                                    rnull, lnull)
        raise ExecError(f"join kind {kind}")

    # -- dense-domain star-join fast path --------------------------------
    _DENSE_MAX_DOMAIN = 1 << 22

    def _try_dense_join(
        self, left, right, kind, lcols, rcols, lk, lv, rk, rv, llive, rlive,
        residual, mark_name,
    ):
        if len(lk) != 1:
            return None
        if kind not in ("inner", "left", "semi", "anti", "mark"):
            return None
        if kind in ("semi", "anti", "mark") and residual is not None:
            return None
        if kind == "left" and residual is not None:
            return None
        for c in (lcols[0], rcols[0]):
            if c.dtype.kind not in ("int32", "int64", "date"):
                return None
        rst = rcols[0].stats
        if rst is None:
            return None
        if kind in ("inner", "left") and not rst.unique:
            return None
        rmin, rmax = rst.vmin, rst.vmax
        domain = rmax - rmin + 1
        if domain > min(
            self._DENSE_MAX_DOMAIN, max(1 << 14, 8 * max(rst.base_rows, right.cap))
        ):
            return None
        rnn = K._all_valid([rv[0]], rlive)
        rkey = rk[0].to(torch.int64)
        table_cap = bucket_cap(domain)
        presence, rows = self._dense_build_route(rkey, rnn, rmin, table_cap)
        lnn = K._all_valid([lv[0]], llive)
        matched, ri = K.dense_probe(
            lk[0].to(torch.int64), lnn, rmin, presence, rows, table_cap
        )
        return self._augment_join_output(
            left, right, kind, matched, ri, llive, residual, mark_name
        )

    def _augment_join_output(
        self, left, right, kind, matched, ri, llive, residual, mark_name,
    ):
        """Left-aligned join output for probe-style paths: matched rows
        live in place, right columns gathered alongside."""
        if kind in ("semi", "anti", "mark"):
            if kind == "mark":
                out_cols = dict(left.columns)
                out_cols[mark_name] = Column(matched, BOOL)
                return Table(
                    out_cols, left.nrows_lazy, live=left.live,
                    unique_key=left.unique_key,
                )
            mask = (matched if kind == "semi" else ~matched) & llive
            return self._masked(left, mask)
        ri_safe = torch.where(matched, ri, 0).long()
        out_cols = dict(left.columns)
        if kind == "inner":
            for name, c in right.columns.items():
                valid = None if c.valid is None else c.valid[ri_safe]
                out_cols[name] = Column(
                    c.data[ri_safe], c.dtype, valid, c.dictionary,
                    c.gather_stats(),
                )
            pair = Table(
                out_cols, matched.sum(dtype=torch.int32), live=matched,
                unique_key=left.unique_key,
            )
            if residual is not None:
                return self._masked(pair, self._predicate_mask(pair, residual))
            return pair
        # left join: left-aligned output, unmatched rows null on the right
        for name, c in right.columns.items():
            valid = (
                c.valid[ri_safe] if c.valid is not None
                else torch.ones(left.cap, dtype=torch.bool, device=matched.device)
            )
            out_cols[name] = Column(
                c.data[ri_safe], c.dtype, valid & matched, c.dictionary,
                c.gather_stats(),
            )
        return Table(
            out_cols, left.nrows_lazy, live=left.live,
            unique_key=left.unique_key,
        )

    # -- packed-word sort-lookup join ------------------------------------
    # Exact int64 packing of the (possibly composite) join key from host-
    # known bounds (ColStats on the columns, dictionary sizes for strings):
    # collision-free by construction, so membership needs no verification
    # and no candidate expansion. semi/anti/mark become a sort + lookup
    # whatever the right side's multiplicity; inner/left take the dense
    # path's left-aligned output when the right side is known-unique on the
    # join key from plan metadata (Table.unique_key). No device sync.

    def _pack_key_words(self, aligned):
        """Exact int64 word per side for aligned join-key Column pairs, or
        None when bounds are unknown or exceed 62 bits."""
        bounds = []
        for ca, cb in aligned:
            if ca.dtype.is_string and cb.dtype.is_string:
                if ca.dictionary is None or cb.dictionary is None:
                    return None
                if ca.dictionary is not cb.dictionary:
                    return None  # _join_key_pair unifies; anything else bails
                bounds.append((0, max(len(ca.dictionary) - 1, 0)))
            elif ca.dtype.kind in ("int32", "int64", "date") and cb.dtype.kind in (
                "int32", "int64", "date",
            ):
                sa, sb = ca.subset_stats(), cb.subset_stats()
                if sa is None or sb is None:
                    return None
                bounds.append((min(sa.vmin, sb.vmin), max(sa.vmax, sb.vmax)))
            else:
                return None
        return K.pack_key_words(
            [
                [(ca.data, ca.valid) for ca, _ in aligned],
                [(cb.data, cb.valid) for _, cb in aligned],
            ],
            bounds,
        )

    def _try_packed_join(
        self, left, right, kind, aligned, right_keys, llive, rlive,
        residual, mark_name,
    ):
        if not aligned:
            return None
        if kind not in ("inner", "left", "semi", "anti", "mark"):
            return None
        if kind in ("semi", "anti", "mark", "left") and residual is not None:
            return None
        if kind in ("inner", "left"):
            # one output row per left row: the right side must be known
            # unique on the join key, from metadata, never probed
            uk = right.unique_key
            if uk is None or not uk <= _plain_col_names(right_keys, right):
                return None
        words = self._pack_key_words(aligned)
        if words is None:
            return None
        lwords, rwords = words
        lnn = K._all_valid([c.valid for c, _ in aligned], llive)
        rnn = K._all_valid([c.valid for _, c in aligned], rlive)
        found, ri = K.member_lookup(lwords, lnn, rwords, rnn)
        return self._augment_join_output(
            left, right, kind, found, ri, llive, residual, mark_name
        )

    def _apply_residual(self, ok, li, ri, left, right, residual):
        count = K.mask_count(ok)
        cap = bucket_cap(max(count, 1))
        sel = K.compact_indices(ok, cap)
        pair = self._pair_table(left, right, li[sel], ri[sel], count, None)
        pmask = self._predicate_mask(pair, residual)
        # max-scatter: sel's padding duplicates index 0 (see _join)
        return ok & K.matched_mask(sel, pmask, ok.shape[0])

    def _predicate_mask(self, table: Table, predicate) -> torch.Tensor:
        """SQL WHERE semantics: TRUE rows only, restricted to live rows."""
        pr = self._evaluator(table).eval(predicate)
        mask = pr.data.bool()
        if pr.valid is not None:
            mask = mask & pr.valid
        return mask & table.row_mask(self.device)

    def _join_key_pair(self, a: Column, b: Column):
        """Align join key dtypes (incl. cross-dictionary string
        unification); float64 keys expand to an exact (exponent, mantissa)
        word pair."""
        if a.dtype.is_string != b.dtype.is_string:
            if a.dtype.is_string:
                a = _cast_column(a, b.dtype, a.data.shape[0])
            else:
                b = _cast_column(b, a.dtype, b.data.shape[0])
        if a.dtype.is_string or b.dtype.is_string:
            ca, cb, uni = unify_dictionaries(a, b)
            return (
                [Column(ca, a.dtype, a.valid, uni)],
                [Column(cb, b.dtype, b.valid, uni)],
            )
        if a.dtype.is_decimal or b.dtype.is_decimal:
            s = max(a.dtype.scale if a.dtype.is_decimal else 0,
                    b.dtype.scale if b.dtype.is_decimal else 0)
            target = DType("decimal", 38, s)
            return (
                [_cast_column(a, target, a.data.shape[0])],
                [_cast_column(b, target, b.data.shape[0])],
            )
        if a.dtype.kind == "float64" or b.dtype.kind == "float64":
            def as_keys(c):
                f = _cast_column(c, FLOAT64, c.data.shape[0])
                ew, mw = K.float_key_words(f.data)
                return [Column(ew, INT64, f.valid), Column(mw, INT64, f.valid)]

            return as_keys(a), as_keys(b)

        def as_i64(c):
            out = _cast_column(c, INT64, c.data.shape[0])
            if (
                out.stats is None
                and c.stats is not None
                and c.dtype.kind in ("int32", "int64", "date", "bool")
            ):
                out = _dc_replace(out, stats=c.subset_stats())
            return out

        return [as_i64(a)], [as_i64(b)]

    def _pair_table(self, left, right, li, ri, nrows, rnull, lnull=None):
        # a join-output gather can repeat rows: bounds survive, uniqueness
        # dies. `rnull` / `lnull` null the right / left side of the rows an
        # outer join appends.
        cols = {}
        for side, idx, null in ((left, li, lnull), (right, ri, rnull)):
            for name, c in side.columns.items():
                valid = None if c.valid is None else c.valid[idx]
                if null is not None:
                    v = valid if valid is not None else torch.ones(
                        idx.shape[0], dtype=torch.bool, device=idx.device)
                    valid = v & ~null
                cols[name] = Column(c.data[idx], c.dtype, valid,
                                    c.dictionary, c.gather_stats())
        return Table(cols, nrows)

    def _cross_join(self, left, right):
        # position arithmetic below assumes packed rows
        left = left.compacted()
        right = right.compacted()
        ln, rn = left.nrows, right.nrows
        total = ln * rn
        cap = bucket_cap(max(total, 1))
        p = torch.arange(cap, device=self.device)
        li = (p // max(rn, 1)).clamp(0, max(left.cap - 1, 0))
        ri = p % max(rn, 1)
        return self._pair_table(left, right, li, ri, total, None)

    # ------------------------------------------------------------------
    def _exec_aggregate(self, node: P.Aggregate) -> Table:
        blocked = self._blocked_union_ctx(node) if node.blocked_union else None
        if node.grouping_sets is None:
            if blocked is not None:
                return self._finish_blocked_union(node, blocked)
            t = self.execute(node.child)
            return self._aggregate_once(
                node.keys, node.aggs, None, t, t.row_mask(self.device),
                t.nrows_known,
            )
        return self._grouping_sets(node, blocked)

    def _grouping_sets(self, node: P.Aggregate, blocked) -> Table:
        """ROLLUP / GROUPING SETS: one aggregation per set, concatenated as
        it goes (the parts are never all held at once). When every
        aggregate decomposes (sum/min/max/count, avg as hidden sum+count)
        and the sets chain by inclusion, as ROLLUP prefixes do, each coarser
        set re-aggregates the previous set's output (the cascade): one pass
        over the input instead of one per set. Otherwise each set is
        aggregated from scratch. Over a blocked union the from-scratch sets
        run window by window."""
        if blocked is not None:
            child = live = nlive = None
        else:
            child = self.execute(node.child)
            live, nlive = child.row_mask(self.device), child.nrows_known
        base_aggs, avg_items = _rollup_base_aggs(node.aggs)
        casc_aggs = _cascade_agg_items(base_aggs) if base_aggs else None
        out = prev = prev_set = None
        for s in sorted(node.grouping_sets, key=len, reverse=True):
            if (
                prev is not None
                and casc_aggs is not None
                and set(s) <= set(prev_set)
            ):
                key_items2 = [(E.Col(name), name) for _, name in node.keys]
                part = self._aggregate_once(
                    key_items2, casc_aggs, s, prev,
                    prev.row_mask(self.device), prev.nrows_known,
                )
            elif blocked is not None:
                part = self._blocked_union_once(node, blocked, s)
            else:
                part = self._aggregate_once(
                    node.keys, base_aggs or node.aggs, s, child, live, nlive
                )
            part = _derive_rollup_avgs(part, avg_items)
            prev, prev_set = part, s
            out = part if out is None else self._concat_rows(out, part)
        if avg_items:
            out = Table(
                {n: c for n, c in out.columns.items()
                 if not n.startswith("__cs_") and not n.startswith("__cc_")},
                out.nrows_lazy, live=out.live,
            )
        if blocked is not None:
            self._annotate_blocked(node, blocked)
        return out.compacted()

    # -- blocked union aggregation ---------------------------------------
    # A union_all feeding an aggregate (directly, through Project/Filter
    # wrappers, or as one relation of an inner MultiJoin) never
    # materializes the whole concat: each branch is cut into row windows,
    # every window is joined against the other relations and partially
    # aggregated with the rollup cascade's decomposable aggregates, and the
    # partials merge as they come. Peak device memory is O(window + groups)
    # instead of O(union rows).

    def _blocked_union_ctx(self, node: P.Aggregate):
        """Prepare windowed execution of a blocked-union aggregate: execute
        and align the union branches, execute the join's other relations
        once, size the window. None when the shape, the aggregates or the
        size rule the blocked path out (the caller takes the plain path).
        The window comes from Session.union_agg_window_rows:
        `engine.union_agg_window_rows`, NDS_UNION_AGG_WINDOW_ROWS, the plan
        budgeter's static `budget_window_rows`, else the catalog's device
        budget."""
        shape = P.union_agg_shape(node)
        if shape is None:
            return None
        session = getattr(self.catalog, "session", None)
        if session is None:
            return None
        base_aggs, avg_items = _rollup_base_aggs(node.aggs)
        if base_aggs is None:
            return None  # non-decomposable aggregate (distinct, stddev...)
        casc_aggs = _cascade_agg_items(base_aggs)
        if casc_aggs is None:
            return None
        outer, join, inner, branch_plans = shape
        branches = self._execute_relations_batched(branch_plans)
        total_rows = sum(t.nrows for t in branches)
        row_bytes = max(
            sum(c.data.element_size() + 1  # data + validity byte
                for c in branches[0].columns.values()),
            1,
        )
        wrows = session.union_agg_window_rows(
            row_bytes, getattr(node, "budget_window_rows", None)
        )
        if total_rows <= wrows:
            # one window: the plain path is the same. The branch tables
            # just executed are cached by id, so the SetOp reuses them
            return None
        join_ctx = None
        if join is not None:
            mj, uidx = join
            # the other relations execute once and join every window
            others = iter(self._execute_relations_batched(
                [r for i, r in enumerate(mj.relations) if i != uidx]
            ))
            tables = [None if i == uidx else next(others)
                      for i in range(len(mj.relations))]
            join_ctx = (mj.edges, uidx, tables)
        branches = [t.compacted() for t in branches]
        stats = {
            "windows": 0,
            "window_rows": wrows,
            "window_cap": bucket_cap(wrows),
            "total_rows": total_rows,
            "max_table_cap": 0,
        }
        # marked as entered before any window runs, so that a failure
        # mid-window is attributable to a blocked plan
        self.last_blocked_union = session.last_blocked_union = dict(stats)
        return {
            **stats,
            "outer_wrappers": outer,
            "join": join_ctx,
            "join_trace": {},  # the first window records, the rest replay
            "inner_wrappers": inner,
            "branches": branches,
            "aligners": self._union_branch_aligners(branches),
            "base_aggs": base_aggs,
            "avg_items": avg_items,
            "casc_aggs": casc_aggs,
        }

    def _apply_wrappers(self, t: Table, wrappers) -> Table:
        """Apply a top-down Filter/Project wrapper list, innermost first."""
        for w in reversed(wrappers):
            if isinstance(w, P.Filter):
                t = self._masked(t, self._predicate_mask(t, w.predicate))
            else:
                t = self._project_table(t, w.items)
        return t

    def _apply_wrappers_fused(self, t: Table, wrappers, memo) -> Table:
        """Apply a top-down wrapper list through ONE fused entry: the
        blocked union aggregation's per-window path. Every window of a
        branch has the same input signature, so the first window builds
        the entry and the others ride it instead of an eager pass per
        wrapper per window. `memo` (per blocked context) keeps the detached
        stage list and fingerprint per wrapper chain. The exact eager
        per-wrapper path runs when fusion is off, a stage is unfusible, or
        the signature is pinned."""
        if not wrappers:
            return t
        session = getattr(self.catalog, "session", None)
        if (
            session is None
            or session.conf.get("engine.fuse", "on") == "off"
            or not t.columns
            or t.cap == 0
        ):
            return self._apply_wrappers(t, wrappers)
        key = tuple(id(w) for w in wrappers)
        info = memo.get(key)
        if info is None:
            stages = []
            for w in reversed(wrappers):  # execution order
                if not fuse._stage_fusible(w):
                    stages = None
                    break
                if isinstance(w, P.Filter):
                    stages.append(P.Filter(predicate=w.predicate, child=None))
                else:
                    stages.append(P.Project(items=list(w.items), child=None))
            if stages and not fuse._chain_worth_fusing(stages):
                # pure rename/subset wrappers: the eager path reuses the
                # window's column objects outright (mark_pipelines' gate)
                stages = None
            fp = (
                P.fingerprint(P.Pipeline(stages=stages, child=None))
                if stages
                else None
            )
            info = memo[key] = (fp, stages)
        fp, stages = info
        if fp is None:
            return self._apply_wrappers(t, wrappers)
        sig = fuse.input_signature(t)
        aot, conf_sig = self._aot_build_args(session)
        with session.cache_lock:
            entry, hit = session.exec_cache.lookup(
                fp, sig, t.cap,
                lambda: fuse.build_entry(stages, None, t, aot, fp, conf_sig),
            )
        if self.tracer is not None:
            self.tracer.emit(
                "exec_cache", pipeline=fp[:12], bucket=t.cap, hit=hit,
                fused=entry is not None,
            )
        if entry is None:
            return self._apply_wrappers(t, wrappers)
        return entry.call(t, False)  # windows alias the branch's buffers

    def _blocked_union_once(self, node: P.Aggregate, ctx, subset):
        """One aggregation level (grouping-set `subset`, or None for the
        plain shape) over the union input, window by window with the
        partials merged as they come. Returns the table an unblocked
        _aggregate_once would (hidden avg sum/count columns included)."""
        key_merge = [(E.Col(name), name) for _, name in node.keys]
        merged = None
        empty_partial = None
        session = getattr(self.catalog, "session", None)
        for b, aligner in zip(ctx["branches"], ctx["aligners"]):
            start = 0
            while start < b.nrows:
                wcap = ctx["window_cap"]
                if (
                    session is not None
                    and getattr(session, "_mem_pressure", False)
                    and wcap > 4096
                ):
                    # host-RSS watermark pre-emption (report.py through
                    # obs.memwatch): shrink the remaining windows before
                    # the allocator fails. Halving a power-of-two cap
                    # keeps `start` aligned (a multiple of every earlier
                    # cap, all powers of two at least the new one).
                    session._mem_pressure = False
                    wcap = ctx["window_cap"] = max(wcap // 2, 4096)
                    session.notify_failure(
                        f"host memory watermark: blocked-union window "
                        f"shrunk to {wcap} rows mid-query"
                    )
                w = window_slice(b, start, wcap)
                start += wcap
                ctx["windows"] += 1
                ctx["max_table_cap"] = max(ctx["max_table_cap"], w.cap)
                # branch-to-union alignment (rename, cast, dictionary
                # remap) per window: only window-sized copies exist
                wcols = list(w.columns.values())
                t = Table(
                    {name: fn(wcols[ci])
                     for ci, (name, fn) in enumerate(aligner)},
                    w.nrows_lazy, live=w.live,
                )
                t = self._apply_wrappers_fused(
                    t, ctx["inner_wrappers"],
                    ctx.setdefault("wrapper_memo", {}),
                )
                if ctx["join"] is not None:
                    edges, uidx, others = ctx["join"]
                    t = self._multijoin_over_tables(
                        [t if i == uidx else o for i, o in enumerate(others)],
                        edges, trace=ctx["join_trace"],
                    )
                    ctx["max_table_cap"] = max(ctx["max_table_cap"], t.cap)
                t = self._apply_wrappers_fused(
                    t, ctx["outer_wrappers"],
                    ctx.setdefault("wrapper_memo", {}),
                )
                part = self._aggregate_once(
                    node.keys, ctx["base_aggs"], subset, t,
                    t.row_mask(self.device), t.nrows_known,
                )
                if part.nrows_known == 0:
                    # keep one empty partial: its columns carry the stub
                    # dtypes the unblocked empty aggregate has
                    empty_partial = part
                    continue
                if merged is None:
                    merged = part
                    continue
                cat = self._concat(merged, part)
                ctx["max_table_cap"] = max(ctx["max_table_cap"], cat.cap)
                merged = self._aggregate_once(
                    key_merge, ctx["casc_aggs"], None, cat,
                    cat.row_mask(self.device), cat.nrows_known,
                )
        return empty_partial if merged is None else merged

    def _finish_blocked_union(self, node: P.Aggregate, ctx) -> Table:
        """The plain (no grouping sets) blocked aggregate: one windowed
        level, visible avgs derived, the declared column order restored
        and the hidden avg columns dropped."""
        out = _derive_rollup_avgs(
            self._blocked_union_once(node, ctx, None), ctx["avg_items"]
        )
        out = out.select([n for _, n in node.keys]
                         + [n for _, n in node.aggs if n in out.columns])
        self._annotate_blocked(node, ctx)
        return out

    def _annotate_blocked(self, node: P.Aggregate, ctx):
        # plan-introspection aids: the window count and the largest table
        # capacity a window touched, which the window bucket bounds
        node.blocked_windows = ctx["windows"]
        node.blocked_stats = self.last_blocked_union = {
            k: ctx[k] for k in ("windows", "window_rows", "window_cap",
                                "total_rows", "max_table_cap")
        }
        self.catalog.session.last_blocked_union = self.last_blocked_union
        if self.tracer is not None:
            self.tracer.emit("blocked_union", **self.last_blocked_union)

    def _union_branch_aligners(self, tables):
        """Per-branch window aligners: unify column names (the leftmost
        branch's, as in the SetOp output), dtypes (common promotion) and
        string dictionaries across union branches, as _concat does pair by
        pair. The cast or remap runs on each window; only dictionary-sized
        remap tables are built here. One [(out_name, fn(Column) -> Column)]
        list per branch, aligned with the branch's columns."""
        pa = arrowlib.pa
        pc = arrowlib.pc

        names = list(tables[0].columns)
        per_table = [list(t.columns.values()) for t in tables]
        aligners = [[] for _ in tables]
        for ci, name in enumerate(names):
            cols = [cols_t[ci] for cols_t in per_table]
            if any(c.dtype.is_string for c in cols):
                dicts = [
                    (c.dictionary if c.dictionary is not None
                     else pa.array([], pa.string())).cast(pa.string())
                    for c in cols
                ]
                unified = pc.unique(pa.concat_arrays(dicts))
                for bi, d in enumerate(dicts):
                    if len(d) == 0:
                        def fn(col, _u=unified):
                            return Column(col.data, col.dtype, col.valid, _u)
                    else:
                        remap = torch.from_numpy(
                            pc.index_in(d, unified)
                            .to_numpy(zero_copy_only=False)
                            .astype(np.int32)
                        ).to(self.device)

                        def fn(col, _r=remap, _u=unified, _n=len(d)):
                            return Column(
                                _r[col.data.clamp(0, _n - 1).long()],
                                col.dtype, col.valid, _u,
                            )
                    aligners[bi].append((name, fn))
            else:
                dt = _common_dtype([c.dtype for c in cols])

                def fn(col, _dt=dt):
                    return _cast_column(col, _dt, col.data.shape[0])

                for bi in range(len(tables)):
                    aligners[bi].append((name, fn))
        return aligners

    def _aggregate_once(self, key_items, agg_items, subset, child, live,
                        nlive):
        # stash the grouping state for grouping() and the distinct-aggregate
        # helper, saving the previous values: a scalar subquery inside an
        # aggregate argument re-enters _aggregate_once and must not clobber
        # them
        prev = (self._current_agg_keys, self._current_agg_live,
                self._current_agg_nlive)
        self._current_agg_keys = key_items
        self._current_agg_live = live
        self._current_agg_nlive = nlive
        try:
            return self._aggregate_once_inner(
                key_items, agg_items, subset, child, live, nlive
            )
        finally:
            (self._current_agg_keys, self._current_agg_live,
             self._current_agg_nlive) = prev

    def _aggregate_once_inner(self, key_items, agg_items, subset, child,
                              live, nlive):
        ev = self._evaluator(child)
        key_cols = []
        for i, (e, name) in enumerate(key_items):
            if subset is not None and i not in subset:
                key_cols.append(None)
            else:
                key_cols.append(ev.eval(e))
        active = [c for c in key_cols if c is not None]

        if active and (nlive is None or nlive > 0):
            direct = self._try_direct_agg(
                child, key_items, key_cols, agg_items, subset, ev, live
            )
            if direct is not None:
                return direct

        words = None
        if active:
            words = self._group_words(active, live)
            order, gid, ngroups = K.group_by_words(words, live, nlive)
        else:
            # single global group: reductions are order-independent, so no
            # sort at all; SQL yields one row even over empty input
            order = None
            gid = torch.zeros(child.cap, dtype=torch.int64, device=live.device)
            ngroups = 1
        if ngroups == 0:
            if active:
                return self._agg_output(
                    child, key_items, key_cols, agg_items, subset,
                    None, None, 0, ev,
                )
            ngroups = 1
        gcap = bucket_cap(ngroups)
        live_sorted = live if order is None else live[order]
        return self._agg_output(
            child, key_items, key_cols, agg_items, subset,
            order, gid, ngroups, ev, gcap, live_sorted, words,
        )

    # -- direct (sort-free) aggregation ----------------------------------
    _DIRECT_AGG_MAX_DOMAIN = 1 << 22

    def _try_direct_agg(
        self, child, key_items, key_cols, agg_items, subset, ev, live
    ):
        if any(agg.distinct for agg, _ in agg_items):
            return None
        active = [(i, c) for i, c in enumerate(key_cols) if c is not None]
        datas, valids, mins, ranges = [], [], [], []
        domain = 1
        for _, c in active:
            if c.dtype.is_string:
                if c.dictionary is None or len(c.dictionary) == 0:
                    return None
                kmin, kmax = 0, len(c.dictionary) - 1
            elif c.dtype.kind == "bool":
                kmin, kmax = 0, 1
            elif c.dtype.kind in ("int32", "int64", "date"):
                if c.stats is None:
                    return None
                kmin, kmax = c.stats.vmin, c.stats.vmax
            else:
                return None
            data = c.data
            if data.dtype == torch.bool:
                data = data.to(torch.int32)
            krange = kmax - kmin + 1 + (1 if c.valid is not None else 0)
            domain *= krange
            if domain > self._DIRECT_AGG_MAX_DOMAIN:
                return None
            datas.append(data)
            valids.append(c.valid)
            mins.append(kmin)
            ranges.append(krange)
        domain_cap = bucket_cap(domain)
        gid = K.direct_gid(datas, valids, mins, ranges, live)
        occ, dense = K.occupancy_map(gid, live, domain_cap)
        ngroups = K.mask_count(occ)
        if ngroups == 0:
            return None
        gcap = bucket_cap(ngroups)
        gid_dense = dense[gid.clamp(0, domain_cap - 1)].clamp(min=0)
        occ_cells = K.compact_indices(occ, gcap)

        # reconstruct key columns from the occupied cell codes (reverse
        # mixed-radix decomposition; last key is least significant)
        codes = []
        rem = occ_cells
        for krange in reversed(ranges):
            codes.append(rem % krange)
            rem = rem // krange
        codes.reverse()
        cols = {}
        ai = 0
        for i, ((e, name), c) in enumerate(zip(key_items, key_cols)):
            if c is None:
                base = ev.eval(key_items[i][0])
                cols[name] = Column(
                    torch.zeros(gcap, dtype=torch_dtype(base.dtype),
                                device=live.device),
                    base.dtype,
                    torch.zeros(gcap, dtype=torch.bool, device=live.device),
                    base.dictionary,
                )
                continue
            code = codes[ai]
            kmin = mins[ai]
            ai += 1
            if c.valid is not None:
                valid = code != 0
                value = torch.where(valid, kmin + code - 1, 0)
            else:
                valid = None
                value = kmin + code
            cols[name] = Column(
                value.to(torch_dtype(c.dtype)), c.dtype, valid, c.dictionary,
                _group_key_stats(c, len(active)),
            )
        for agg, name in agg_items:
            cols[name] = self._eval_agg(
                agg, ev, None, gid_dense, gcap, live, ngroups, child, subset,
                key_cols,
            )
        return Table(cols, ngroups,
                     unique_key=_active_key_names(key_items, key_cols))

    def _agg_output(
        self, child, key_items, key_cols, agg_items, subset,
        order, gid, ngroups, ev, gcap=None, live_sorted=None,
        key_words=None,
    ):
        dev = self.device
        if ngroups == 0:
            cols = {}
            for (e, name), c in zip(key_items, key_cols):
                dtype = c.dtype if c is not None else INT64
                cols[name] = Column(
                    torch.zeros(1, dtype=torch_dtype(dtype), device=dev),
                    dtype, torch.zeros(1, dtype=torch.bool, device=dev),
                    c.dictionary if c is not None else None,
                )
            for agg, name in agg_items:
                cols[name] = Column(
                    torch.zeros(1, dtype=torch.int64, device=dev), INT64,
                    torch.zeros(1, dtype=torch.bool, device=dev),
                )
            return Table(cols, 0)
        first_rows = None
        if order is not None:
            first_idx = K.segment_starts(gid, gcap)
            first_rows = order[first_idx.clamp(0, child.cap - 1)]
        cols = {}
        n_active = sum(1 for kc in key_cols if kc is not None)
        for i, ((e, name), c) in enumerate(zip(key_items, key_cols)):
            if c is None:
                base = ev.eval(key_items[i][0])
                cols[name] = Column(
                    torch.zeros(gcap, dtype=torch_dtype(base.dtype), device=dev),
                    base.dtype, torch.zeros(gcap, dtype=torch.bool, device=dev),
                    base.dictionary,
                )
            else:
                data = c.data[first_rows]
                valid = None if c.valid is None else c.valid[first_rows]
                cols[name] = Column(
                    data, c.dtype, valid, c.dictionary,
                    _group_key_stats(c, n_active),
                )
        for agg, name in agg_items:
            cols[name] = self._eval_agg(
                agg, ev, order, gid, gcap, live_sorted, ngroups, child,
                subset, key_cols, key_words,
            )
        return Table(cols, ngroups,
                     unique_key=_active_key_names(key_items, key_cols))

    def _eval_agg(self, agg: E.Agg, ev, order, gid, gcap, live_sorted,
                  ngroups, child, subset, key_cols,
                  key_words=None) -> Column:
        fn = agg.fn
        if fn == "grouping":
            # grouping(key) = 1 where the key is rolled away in this set.
            # The arg is the raw key expr or, after the post-aggregate
            # rewrite, the key's output Col: match either form
            idx = None
            for i, (ke, kn) in enumerate(self._current_agg_keys):
                if agg.arg == ke or agg.arg == E.Col(kn):
                    idx = i
                    break
            rolled = subset is not None and idx is not None and idx not in subset
            return Column(
                torch.full((gcap,), 1 if rolled else 0, dtype=torch.int32,
                           device=self.device),
                INT32,
            )
        if agg.distinct:
            return self._eval_distinct_agg(agg, ev, child, key_words)
        if fn == "count" and agg.arg is None:
            counts = K.segment_reduce(
                live_sorted.to(torch.int64), gid, live_sorted, gcap, "count"
            )
            return Column(counts, INT64)
        c = ev.eval(agg.arg)
        weight = live_sorted
        # order=None: direct (unsorted) aggregation — gid/live row-aligned
        sdata = c.data if order is None else c.data[order]
        if c.valid is not None:
            weight = weight & (c.valid if order is None else c.valid[order])
        if c.dtype.is_string:
            rank, sorted_dict = sort_dictionary(c)
            sdata = rank if order is None else rank[order]
            if fn in ("min", "max"):
                red, counts = K.segment_reduce_with_count(
                    sdata, gid, weight, gcap, fn
                )
                return Column(red.to(torch.int32), c.dtype, counts > 0,
                              sorted_dict)
            raise ExecError(f"agg {fn} on string column")
        if fn == "count":
            counts = K.segment_reduce(sdata, gid, weight, gcap, "count")
            return Column(counts, INT64)
        if fn in ("sum", "min", "max"):
            pall = self._pallas_segment_route(fn, c, sdata, gid, weight, gcap)
            if pall is not None:
                return pall
            red, counts = K.segment_reduce_with_count(
                sdata, gid, weight, gcap, fn
            )
            dtype = c.dtype
            if fn == "sum" and dtype.kind == "int32":
                dtype = INT64
                red = red.to(torch.int64)
            return Column(red, dtype, counts > 0)
        if fn == "avg":
            s, n = K.segment_reduce_with_count(
                sdata, gid, weight, gcap, "sum"
            )
            nz = n.clamp(min=1)
            if c.dtype.is_decimal:
                val = s.to(torch.float64) / (10**c.dtype.scale) / nz
            else:
                val = s.to(torch.float64) / nz
            return Column(val, FLOAT64, n > 0)
        if fn in ("stddev_samp", "var_samp"):
            x = sdata.to(torch.float64)
            if c.dtype.is_decimal:
                x = x / 10**c.dtype.scale
            s = K.segment_reduce(x, gid, weight, gcap, "sum")
            sq = K.segment_reduce(x, gid, weight, gcap, "sumsq")
            n = K.segment_reduce(x, gid, weight, gcap, "count").to(
                torch.float64
            )
            nz = n.clamp(min=2)
            var = (sq - s * s / n.clamp(min=1)) / (nz - 1)
            var = var.clamp(min=0.0)
            out = torch.sqrt(var) if fn == "stddev_samp" else var
            return Column(out, FLOAT64, n > 1)
        raise ExecError(f"aggregate {fn}")

    def _eval_distinct_agg(self, agg, ev, child, key_words=None):
        """count / sum / avg (distinct x): two-level grouping.

        Null values of x stay live through both passes (so every outer group
        survives and positions align with the main aggregation pass, which
        enumerates groups in the same sorted-key order) but carry zero
        weight in the final reduction (distinct aggs ignore nulls)."""
        c = ev.eval(agg.arg)
        live = self._current_agg_live
        d = c.data
        if d.dtype == torch.bool:
            d = d.to(torch.int32)
        # the main pass's outer-key words: monotone codes keep the group
        # enumeration order identical across passes, so positions align
        gwords = list(key_words) if key_words else []
        if gwords:
            vwords = self._sort_words(
                [(d, c.valid, True, True)], [c], live, include_live=False
            )
            words2 = gwords + vwords
        else:
            words2 = self._sort_words([(d, c.valid, True, True)], [c], live)
        order2, gid2, ng2 = K.group_by_words(
            words2, live, self._current_agg_nlive
        )
        g2cap = bucket_cap(max(ng2, 1))
        first2 = K.segment_starts(gid2, g2cap)
        rows2 = order2[first2.clamp(0, child.cap - 1)]
        live2 = torch.arange(g2cap, device=live.device) < ng2
        cvalid2 = None if c.valid is None else c.valid[rows2]
        # re-group the distinct rows by the outer keys only. A fresh live2
        # word leads: the gathered words' embedded live bit reflects the
        # ORIGINAL rows' liveness, not the distinct slots'
        if gwords:
            okeys = [torch.where(live2, 0, 1).to(torch.int64)]
            okeys += [w[rows2] for w in gwords]
            order3, gid3, ng3 = K.group_by_words(okeys, live2)
        else:
            # global distinct: reductions are order-independent
            order3 = torch.arange(g2cap, device=live.device)
            gid3 = torch.zeros(g2cap, dtype=torch.int64, device=live.device)
            ng3 = 1 if ng2 > 0 else 0
        if ng3 == 0:
            ng3 = 1
        g3cap = bucket_cap(ng3)
        w3 = live2[order3]
        if cvalid2 is not None:
            w3 = w3 & cvalid2[order3]
        vals = c.data[rows2][order3]
        if agg.fn == "count":
            out = K.segment_reduce(vals, gid3, w3, g3cap, "count")
            return Column(out, INT64)
        if agg.fn == "sum":
            out, n = K.segment_reduce_with_count(vals, gid3, w3, g3cap, "sum")
            if c.dtype.kind == "int32":
                return Column(out.to(torch.int64), INT64, n > 0)
            return Column(out, c.dtype, n > 0)
        if agg.fn == "avg":
            s, n = K.segment_reduce_with_count(vals, gid3, w3, g3cap, "sum")
            v = s.to(torch.float64) / n.clamp(min=1)
            if c.dtype.is_decimal:
                v = v / 10**c.dtype.scale
            return Column(v, FLOAT64, n > 0)
        raise ExecError(f"distinct agg {agg.fn}")

    # ------------------------------------------------------------------
    def _exec_window(self, node: P.Window) -> Table:
        # windows sort and scan several word / rank arrays at the input cap:
        # pack masked inputs first
        child = self.execute(node.child).compacted()
        out_cols = dict(child.columns)
        for wf, name in node.fns:
            out_cols[name] = self._eval_window(child, wf)
        return Table(out_cols, child.nrows_lazy, live=child.live)

    def _eval_window(self, child: Table, wf: E.WindowFn) -> Column:
        """One window function over a compacted table: sort by partition
        then order words, number the partitions (int32 ids, as the JAX
        scan keeps them), compute over the sorted rows and scatter back
        through the inverse permutation. Every gather by a partition or
        peer-group id is clamped to its table: dead rows sort last and may
        carry ids past the live groups."""
        ev = self._evaluator(child)
        live = child.row_mask(self.device)
        cap = child.cap
        dev = live.device
        pkeys, pcols = [], []
        for e in wf.partition_by:
            c = ev.eval(e)
            d = c.data.to(torch.int32) if c.data.dtype == torch.bool else c.data
            pkeys.append((d, c.valid, True, True))
            pcols.append(c)
        okeys, ocols = [], []
        for e, asc in wf.order_by:
            c = ev.eval(e)
            d = c.data
            if c.dtype.is_string:
                d, _ = sort_dictionary(c)
            if d.dtype == torch.bool:
                d = d.to(torch.int32)
            okeys.append((d, c.valid, asc, asc))
            ocols.append(c)
        # partition words carry the live bit (dead rows last); the order
        # words are a separate list, so partition boundaries read off the
        # sorted partition words alone
        pwords = self._sort_words(pkeys, pcols, live)
        owords = self._sort_words(okeys, ocols, live, include_live=False)
        order = K.sort_by_words(pwords + owords)
        sorted_ow = [w[order] for w in owords]
        nlive = child.nrows
        if pkeys:
            flags = K._word_flags([w[order] for w in pwords])
            gid = K.fast_cumsum(flags.to(torch.int32)) - 1
            ng = int(gid[nlive - 1].item()) + 1 if nlive else 0
        else:
            gid = torch.zeros(cap, dtype=torch.int32, device=dev)
            ng = 1 if nlive else 0
        gcap = bucket_cap(max(ng, 1))
        gi = gid.long().clamp(0, gcap - 1)  # the gather index of gid
        inv = torch.empty(cap, dtype=torch.int64, device=dev)
        inv[order] = torch.arange(cap, device=dev)

        def peer_groups():
            """(peer-group id, group count): order-key ties within a
            partition."""
            oflags = K._word_flags([gid] + sorted_ow)
            ogid = K.fast_cumsum(oflags.to(torch.int32)) - 1
            n_og = int(ogid[nlive - 1].item()) + 1 if nlive else 1
            return ogid, oflags, bucket_cap(max(n_og, 1))

        def peer_group_end():
            """Sorted position of the last row of each row's peer group
            (the RANGE frame's end), clamped to the table."""
            ogid, _, ogcap = peer_groups()
            og_first = K.segment_starts(ogid, ogcap)
            og_count = K.segment_reduce(
                torch.ones(cap, dtype=torch.int64, device=dev), ogid,
                torch.ones(cap, dtype=torch.bool, device=dev), ogcap, "count",
            )
            og_end = (og_first + og_count - 1)[ogid.long().clamp(0, ogcap - 1)]
            return og_end.clamp(0, cap - 1)

        fn = wf.fn
        if fn in ("rank", "dense_rank", "row_number"):
            if fn == "row_number":
                vals = K.running_position(gid) + 1
            else:
                ogid, oflags, ogcap = peer_groups()
                part_first = K.segment_starts(gid, gcap)
                if fn == "dense_rank":
                    # count of peer-group starts since the partition start
                    cums = K.fast_cumsum(oflags.to(torch.int32))
                    base = cums[part_first.clamp(0, cap - 1)]
                    vals = cums - base[gi] + 1
                else:
                    # rank: 1 + rows before the first row of the peer group
                    og_first = K.segment_starts(ogid, ogcap)
                    vals = (og_first[ogid.long().clamp(0, ogcap - 1)]
                            - part_first[gi] + 1)
            return Column(vals.to(torch.int64)[inv], INT64, None)

        # aggregate-over-partition functions
        if fn not in ("sum", "avg", "min", "max", "count"):
            raise ExecError(f"window fn {fn}")
        w = live[order]
        if wf.arg is None and fn == "count":
            c = None
            sdata = torch.ones(cap, dtype=torch.int64, device=dev)
            dtype = INT64
        else:
            c = ev.eval(wf.arg)
            if c.dtype.is_string and fn in ("min", "max"):
                # rank-transform codes so that min/max compare
                # lexicographically (raw codes are in encounter order)
                ranks, sorted_dict = sort_dictionary(c)
                c = Column(ranks, c.dtype, c.valid, sorted_dict)
            sdata = c.data[order]
            if c.valid is not None:
                w = w & c.valid[order]
            dtype = c.dtype

        # the frame. SQL default: the whole partition without ORDER BY,
        # RANGE UNBOUNDED PRECEDING..CURRENT ROW (peers included) with it
        frame = wf.frame
        running = (("unbounded", "preceding"), ("current", None))
        whole = (not wf.order_by and frame is None) or frame == (
            ("unbounded", "preceding"), ("unbounded", "following"))
        if whole:
            red_map = {"sum": "sum", "min": "min", "max": "max",
                       "count": "count", "avg": "sum"}
            red, counts = K.segment_reduce_with_count(
                sdata, gid, w, gcap, red_map[fn]
            )
            return self._window_result(fn, red[gi][inv], counts[gi][inv], c,
                                       dtype)

        if fn in ("min", "max"):
            # running min/max by rank transform and a prefix max (exact)
            if frame not in (running, None):
                raise ExecError(f"window {fn} over frame {frame}")
            sorted_vals, rank = K.value_rank(sdata)
            scanned = K.segmented_running_extreme(
                sorted_vals, rank, gid, w, fn == "max"
            )
            cnt_run = _segment_cumsum(w.to(torch.int64), gid)
            if frame is None:
                # RANGE: the current row's peers are in the frame, so read
                # the running value at the end of the peer group
                og_end = peer_group_end()
                scanned = scanned[og_end]
                cnt_run = cnt_run[og_end]
            return self._window_result(fn, scanned[inv], cnt_run[inv], c,
                                       dtype)

        x = torch.where(w, sdata, torch.zeros((), dtype=sdata.dtype,
                                              device=dev))
        if not x.is_floating_point():
            x = x.to(torch.int64)
        csum = _segment_cumsum(x, gid)
        cnt = _segment_cumsum(w.to(torch.int64), gid)

        if frame is None or frame == running:
            if frame is None:
                og_end = peer_group_end()
                csum = csum[og_end]
                cnt = cnt[og_end]
            return self._window_result(fn, csum[inv], cnt[inv], c, dtype)

        # bounded ROWS frame: the sum over [lo, hi] by prefix-sum
        # differences
        (lo_n, lo_u), (hi_n, hi_u) = frame
        part_first = K.segment_starts(gid, gcap)
        pos = torch.arange(cap, dtype=torch.int64, device=dev)
        start_of_part = part_first[gi]
        part_count = K.segment_reduce(
            torch.ones(cap, dtype=torch.int64, device=dev), gid, live[order],
            gcap, "count",
        )
        end_of_part = start_of_part + part_count[gi] - 1

        def bound(n, unit, unbounded):
            if (n, unit) == ("current", None):
                return pos
            if n == "unbounded":
                return unbounded
            return pos - int(n) if unit == "preceding" else pos + int(n)

        lo_raw = bound(lo_n, lo_u, start_of_part)
        hi_raw = bound(hi_n, hi_u, end_of_part)
        # the true frame is [lo_raw, hi_raw] within the partition; it can
        # be EMPTY (`2 preceding and 1 preceding` at a partition's first
        # row), where a clamp alone would fake a one-row frame
        empty = ((hi_raw < lo_raw) | (hi_raw < start_of_part)
                 | (lo_raw > end_of_part))
        lo = torch.maximum(lo_raw, start_of_part).clamp(0, cap - 1)
        hi = torch.minimum(hi_raw, end_of_part).clamp(0, cap - 1)
        # the prefix sums restart at each partition head: where lo is the
        # head, lo - 1 lies in the previous partition and the baseline is
        # 0. The lo - 1 read is clamped (and masked at row 0)
        before = (lo - 1).clamp(min=0)
        base_zero = (lo == 0) | (lo == start_of_part)
        zs = torch.zeros((), dtype=csum.dtype, device=dev)
        s_lo = torch.where(base_zero, zs, csum[before])
        c_lo = torch.where(base_zero, 0, cnt[before])
        s_out = torch.where(empty, zs, csum[hi] - s_lo)
        c_out = torch.where(empty, 0, cnt[hi] - c_lo)
        return self._window_result(fn, s_out[inv], c_out[inv], c, dtype)

    def _window_result(self, fn, red, counts, c, dtype):
        if fn == "count":
            return Column(counts.to(torch.int64), INT64)
        if fn == "avg":
            vals = red.to(torch.float64) / counts.clamp(min=1)
            if c is not None and c.dtype.is_decimal:
                vals = vals / 10**c.dtype.scale
            return Column(vals, FLOAT64, counts > 0)
        if fn in ("min", "max"):
            return Column(red, dtype, counts > 0,
                          None if c is None else c.dictionary)
        # sum
        return Column(red, INT64 if dtype.kind == "int32" else dtype,
                      counts > 0)

    # -- the engine.pallas_* kernel routes --------------------------------

    def _conf_mode(self, key: str) -> str:
        session = getattr(self.catalog, "session", None)
        if session is None:
            return "off"
        return str(session.conf.get(key, "off")).lower()

    def _pallas_mode(self) -> str:
        return self._conf_mode("engine.pallas_agg")

    def _pallas_segment_route(self, fn, c, sdata, gid, weight, gcap):
        """Kernel promotion for float64 sum/min/max (`engine.pallas_agg`):
        `off` (default) — the torch scatter path; `on` — always the
        segment kernels of ops/gpu_kernels.py (the values as f32: sums
        added in f64 and rounded once to f32, extremes exact in f32); `auto` — a measured per-shape A/B,
        memoized on the session."""
        mode = self._pallas_mode()
        if mode not in ("on", "auto") or c.dtype.kind != "float64":
            return None
        pgid = torch.where(weight, gid, -1).to(torch.int32)
        # mask dead/null lanes: NaN garbage must not reach a live group
        pvals = torch.where(weight, sdata, 0.0).to(torch.float32)
        if mode == "auto" and not self._pallas_promoted(
            fn, sdata, gid, weight, gcap, pvals, pgid
        ):
            return None
        if fn == "sum":
            s, n = GK.segment_sums(pvals, pgid, gcap)
        else:
            s, n = GK.segment_extreme(pvals, pgid, gcap, fn == "max")
        return Column(s.to(torch.float64), c.dtype, n > 0)

    def _sort_perm_route(self, words):
        """ORDER BY permutation with counting-sort promotion
        (`engine.pallas_sort`): eligible when there is exactly one sort word
        whose value span fits the counting domain (one span probe, one host
        sync, paid only in on/auto modes)."""
        mode = self._conf_mode("engine.pallas_sort")
        if mode not in ("on", "auto") or len(words) != 1:
            return K.sort_by_words(words)
        if int(words[0].shape[0]) > GK.SORT_MAX_ROWS:
            return K.sort_by_words(words)
        w = words[0]
        lo, hi = (int(x) for x in K.word_span(w).tolist())
        if lo < 0 or hi >= GK.SORT_MAX_DOMAIN:
            return K.sort_by_words(words)
        domain = -(-(hi + 1) // 128) * 128
        if mode == "auto":
            key = ("sort_perm", int(w.shape[0]), int(domain))
            rec = self._promotion_rec(key)
            if rec is None:
                rec = self._measure_promotion(
                    key,
                    lambda: K.sort_by_words(words),
                    lambda: GK.sort_perm(w, domain),
                    "sort_perm",
                )
            if not rec["use"]:
                return K.sort_by_words(words)
        return GK.sort_perm(w, domain)

    def _dense_build_route(self, rkey, rnn, rmin, table_cap):
        """Dense-join build tables (`engine.pallas_join`): `off` — the torch
        scatter pair; `on` — the dense_build kernel; `auto` — measured A/B."""
        mode = self._conf_mode("engine.pallas_join")
        if mode not in ("on", "auto"):
            return K.dense_build(rkey, rnn, rmin, table_cap)
        if mode == "auto":
            key = ("dense_build", int(rkey.shape[0]), int(table_cap))
            rec = self._promotion_rec(key)
            if rec is None:
                rec = self._measure_promotion(
                    key,
                    lambda: K.dense_build(rkey, rnn, rmin, table_cap),
                    lambda: GK.dense_build(rkey, rnn, rmin, table_cap),
                    "dense_build",
                )
            if not rec["use"]:
                return K.dense_build(rkey, rnn, rmin, table_cap)
        return GK.dense_build(rkey, rnn, rmin, table_cap)

    def _promotion_rec(self, key):
        """The memoized promotion verdict for `key`: the session memo
        first, then the persistent store (engine/aotcache.py
        PromotionStore: verdicts any earlier process measured in this
        environment), loaded into the memo on a hit. None = unmeasured."""
        session = self.catalog.session
        rec = session.pallas_promotions.get(key)
        if rec is not None:
            return rec
        store = getattr(session, "promotion_store", None)
        if store is None:
            return None
        rec = store.get(AOTC.promotion_key_str(key, self.device))
        if rec is not None and "use" in rec:
            with session.cache_lock:
                session.pallas_promotions[key] = rec
            return rec
        return None

    def _measure_promotion(self, key, run_plain, run_kernel, kname):
        """One-time measured A/B for a (kernel, shape) slot: warm both
        paths, time one synchronized call each, memoize the winner, and
        emit both measurements as `kernel_span` events under the
        reference's names: `<kname>:jnp` is the plain torch route and
        `<kname>:pallas` the hand-written CUDA kernel (`n` is the slot's
        row count). A kernel failure propagates: on a CUDA tensor a broken
        kernel must raise, never lose the A/B quietly."""
        session = self.catalog.session

        def timed(run):
            run()  # warm-up: excludes first-use builds
            _sync(self.device)
            t0 = _perf()
            run()
            _sync(self.device)
            return (_perf() - t0) * 1000.0

        plain_ms = timed(run_plain)
        kernel_ms = timed(run_kernel)
        with session.cache_lock:
            rec = session.pallas_promotions[key] = {
                "plain_ms": round(plain_ms, 3),
                "kernel_ms": round(kernel_ms, 3),
                "use": kernel_ms < plain_ms,
            }
            store = getattr(session, "promotion_store", None)
            if store is not None:
                # measured once per environment: the verdict outlives
                # this process
                store.record(AOTC.promotion_key_str(key, self.device), rec)
        if self.tracer is not None:
            self.tracer.emit(
                "kernel_span", kernel=f"{kname}:jnp",
                dur_ms=rec["plain_ms"], n=key[1],
            )
            self.tracer.emit(
                "kernel_span", kernel=f"{kname}:pallas",
                dur_ms=rec["kernel_ms"], n=key[1],
            )
        return rec

    def _pallas_promoted(self, fn, sdata, gid, weight, gcap, pvals,
                         pgid) -> bool:
        key = (fn, int(sdata.shape[0]), int(gcap))
        rec = self._promotion_rec(key)
        if rec is None:
            def run_plain():
                return K.segment_reduce_with_count(
                    sdata, gid, weight, gcap, fn
                )

            if fn == "sum":
                def run_kernel():
                    return GK.segment_sums(pvals, pgid, gcap)
            else:
                def run_kernel():
                    return GK.segment_extreme(pvals, pgid, gcap, fn == "max")

            rec = self._measure_promotion(key, run_plain, run_kernel,
                                          f"segment_{fn}")
        return rec["use"]

    # ------------------------------------------------------------------
    def _evaluator(self, table: Table) -> Evaluator:
        return _ExecEvaluator(table, self.device, self)

    def _scalar_value(self, e: E.ScalarSubquery):
        key = id(e.plan)
        if key not in self._scalar_cache:
            cache = self._session_cache()
            if cache is not None:
                with self.catalog.session.cache_lock:
                    hit = cache.scalars.get(self._fp(e.plan) + ":" +
                                            e.out_name)
                if hit is not None:
                    self._scalar_cache[key] = hit
                    return hit
            t = self.execute(e.plan).compacted()
            col = t.columns[e.out_name]
            if t.nrows == 0:
                self._scalar_cache[key] = (None, col.dtype, col.dictionary)
            else:
                v = col.data[:1].cpu().numpy()[0]
                valid = True if col.valid is None else bool(col.valid[0].item())
                self._scalar_cache[key] = (
                    v.item() if valid else None, col.dtype, col.dictionary,
                )
            if cache is not None:
                with self.catalog.session.cache_lock:
                    cache.scalars[self._fp(e.plan) + ":" + e.out_name] = (
                        self._scalar_cache[key]
                    )
        return self._scalar_cache[key]

    def _masked(self, table: Table, mask) -> Table:
        """Deferred compaction: rows stay in place under a live mask, with
        the count kept on the device until someone needs it."""
        return Table(
            dict(table.columns), mask.sum(dtype=torch.int32), live=mask,
            unique_key=table.unique_key,
        )

    def _take(self, table: Table, idx, nrows) -> Table:
        # idx is a permutation or de-duplicated subset of live rows, so
        # base-table stats stay valid
        idx = idx.long()
        cols = {}
        for name, c in table.columns.items():
            cols[name] = Column(
                c.data[idx], c.dtype,
                None if c.valid is None else c.valid[idx],
                c.dictionary, c.subset_stats(),
            )
        return Table(cols, nrows)

    def _distinct_table(self, t: Table, spill_parts=0) -> Table:
        t = self._pack_sparse(t)
        if spill_parts > 1 and t.columns:
            out = self._spilled_distinct(t, spill_parts)
            if out is not None:
                return out
        live = t.row_mask(self.device)
        words = self._group_words(list(t.columns.values()), live)
        order, gid, ng = K.group_by_words(words, live, t.nrows)
        gcap = bucket_cap(max(ng, 1))
        first = K.segment_starts(gid, gcap)
        rows = order[first.clamp(0, t.cap - 1)]
        out = self._take(t, rows, ng)
        out.unique_key = frozenset(out.columns)
        return out

    def _compact(self, table: Table, mask) -> Table:
        count = K.mask_count(mask)
        idx = K.compact_indices(mask, bucket_cap(max(count, 1)))
        return self._take(table, idx, count)

    # -- out-of-core (spilled) execution --------------------------------
    # When a plan's peak materialization cannot fit the card, the three
    # shapes whose memory adds up (a hash join whose build side is too big,
    # a full-table sort, a whole-input distinct) run partitioned or
    # windowed, with their intermediates staged in the session's host-RAM
    # spill pool (engine/spill.py; disk-backed past its budget).
    # `engine.spill` = off | auto | force: `auto` (the default) spills the
    # nodes the plan budgeter annotated with `spill_partitions` (verdict
    # `spill`); `force` spills every eligible node. The results are the
    # direct paths': the external sort reuses the direct permutation, and
    # hash partitioning is value-exact for joins and distinct (whose row
    # order SQL leaves open: partition-major here, as in the JAX engine).
    # Partition ids are hash_columns' int64 hash modulo the partition
    # count, floor-wise as jnp's `%` takes it on the JAX engine's int64
    # hash, so both engines put every row in the same partition for every
    # partition count.

    def _spill_parts_for(self, node) -> int:
        """Partition/run count for out-of-core execution of `node`, or 0
        for the direct path."""
        session = getattr(self.catalog, "session", None)
        if session is None:
            return 0
        mode = str(session.conf.get("engine.spill", "auto")).lower()
        if mode == "off":
            return 0
        if mode == "force":
            try:
                p = int(session.conf.get("engine.spill_partitions", 0) or 0)
            except (TypeError, ValueError):
                p = 0
            return p if p > 1 else SP.DEFAULT_FORCE_PARTITIONS
        try:
            return int(getattr(node, "spill_partitions", 0) or 0)
        except (TypeError, ValueError):
            return 0

    def _spill_finish(self, op, parts, pool, before, segments,
                      t0=None) -> Table:
        """Assemble a spilled operator's segments into one table on the
        session's device, record the statement's spill evidence (the
        executor's and the session's `last_spill`, and a `spill` trace
        event with the out-of-core step's wall when the caller timed it,
        the critical path's spill-io cause) and release the segments."""
        try:
            out = SP.assemble_segments(pool, segments, self.device)
        finally:
            pool.release(segments)
        delta = {
            k: pool.stats[k] - before.get(k, 0)
            for k in ("bytes_in", "bytes_out", "evictions")
        }
        note = self.last_spill or {
            "ops": 0, "partitions": 0, "bytes_in": 0, "bytes_out": 0,
            "evictions": 0,
        }
        note["ops"] += 1
        note["partitions"] = max(note["partitions"], parts)
        for k in ("bytes_in", "bytes_out", "evictions"):
            note[k] += delta[k]
        self.last_spill = self.catalog.session.last_spill = note
        if self.tracer is not None:
            self.tracer.emit(
                "spill", op=op, partitions=parts,
                bytes_in=delta["bytes_in"], bytes_out=delta["bytes_out"],
                evictions=delta["evictions"], rows=out.nrows_known,
                **({"dur_ms": round((_perf() - t0) * 1000.0, 3)}
                   if t0 is not None else {}),
            )
        return out

    def _spilled_join(self, left, right, kind, left_keys, right_keys,
                      residual, lk, lv, llive, rk, rv, rlive, parts) -> Table:
        """Partitioned (Grace) hash join through the spill pool: both sides
        hash-partition on the join key, each partition pair joins with the
        regular paths (keys and residual evaluated again over the compacted
        partitions), and each partition's output goes to the host pool, so
        only one partition's pair table is live on the device. Exact: equal
        keys share a partition, so the partitions' results together are the
        direct join's (null-keyed left rows land in some partition, never
        match, and are null-extended under LEFT as the direct path does)."""
        session = self.catalog.session
        pool = session.spill_pool
        before = dict(pool.stats)
        sp_t0 = _perf()
        lp = K.hash_columns(lk, lv) % parts
        rp = K.hash_columns(rk, rv) % parts
        segments = []
        try:
            for p in range(parts):
                lpart = self._compact(left, (lp == p) & llive)
                if lpart.nrows == 0 and segments:
                    continue  # empty probe side: an empty partition
                rpart = self._compact(right, (rp == p) & rlive)
                if kind == "inner" and rpart.nrows == 0 and segments:
                    continue  # (LEFT must still null-extend its rows)
                out = self._join(
                    lpart, rpart, kind, left_keys, right_keys, residual
                )
                segments.append(pool.put(out))
                session.spill_progress()
            return self._spill_finish("join", parts, pool, before, segments,
                                      t0=sp_t0)
        except BaseException:
            pool.release(segments)
            raise

    def _spilled_take(self, child: Table, order, parts, op="sort"):
        """External sort tail: gather the sorted output in bounded windows
        of the direct path's own permutation, staging each sorted run in
        the host pool, then upload the assembled result once per column:
        the device transient is O(window x width) instead of every
        column's full-capacity gather at once. None when the input is too
        small to window (the caller takes the direct gather). Bit-identical
        to the direct path: the same `order`, the same row order."""
        wcap = bucket_cap(max(child.cap // parts, 1))
        if wcap >= child.cap:
            return None
        session = self.catalog.session
        pool = session.spill_pool
        before = dict(pool.stats)
        sp_t0 = _perf()
        nrows = child.nrows
        segments = []
        try:
            # the capacity is a multiple of the window (powers of two), so
            # every window is a full slice of the permutation
            for start in range(0, child.cap, wcap):
                n_w = min(max(nrows - start, 0), wcap)
                if n_w <= 0 and segments:
                    break
                idx = order[start:start + wcap].long()
                cols = {
                    name: Column(
                        c.data[idx], c.dtype,
                        None if c.valid is None else c.valid[idx],
                        c.dictionary,
                    )
                    for name, c in child.columns.items()
                }
                segments.append(pool.put(Table(cols, n_w)))
                session.spill_progress()
            return self._spill_finish(op, parts, pool, before, segments,
                                      t0=sp_t0)
        except BaseException:
            pool.release(segments)
            raise

    def _spilled_distinct(self, t: Table, parts):
        """Spilling distinct: partition-hash dedup. Rows hash-partition
        over all columns (validity folded in, so NULLs, which distinct
        treats as equal, share a partition), each partition dedups with the
        direct path, and the partitions' results stage in the host pool.
        Exact as a row set: equal rows share a partition and partitions are
        disjoint. None for an empty input (the direct path takes it)."""
        t = t.compacted()
        if t.nrows == 0:
            return None
        session = self.catalog.session
        pool = session.spill_pool
        before = dict(pool.stats)
        sp_t0 = _perf()
        live = t.row_mask(self.device)
        h = K.hash_columns(
            [c.data for c in t.columns.values()],
            [c.valid for c in t.columns.values()],
        ) % parts
        segments = []
        try:
            for p in range(parts):
                part = self._compact(t, (h == p) & live)
                if part.nrows == 0:
                    if not segments:
                        segments.append(pool.put(part))  # schema carrier
                    continue
                segments.append(pool.put(self._distinct_table(part)))
                session.spill_progress()
            out = self._spill_finish("distinct", parts, pool, before,
                                     segments, t0=sp_t0)
        except BaseException:
            pool.release(segments)
            raise
        out.unique_key = frozenset(out.columns)
        return out

    def _concat(self, a: Table, b: Table) -> Table:
        """Masked concatenation: columns append at full capacity (padded to
        a power-of-two bucket) under a combined live mask, with no
        repacking gathers and no count syncs."""
        cap = bucket_cap(max(a.cap + b.cap, 1))
        live = _stack(a.row_mask(self.device), b.row_mask(self.device),
                      a.cap, b.cap, cap)
        return self._stacked(a, b, a.cap, b.cap, cap, a.nrows_lazy
                             + b.nrows_lazy, live)

    def _concat_rows(self, a: Table, b: Table) -> Table:
        """Packed concatenation of two packed tables whose row counts the
        host holds: a's rows then b's at the bucket of their sum, the table
        _concat gives once compacted. A chain of masked concatenations adds
        capacities: over ROLLUP's sets, whose first part holds a fact-sized
        bucket of groups, the JAX executor's chain doubles per set (query67
        at SF100: 2^26 groups, then 2^27 .. 2^31 lanes)."""
        na, nb = a.nrows_known, b.nrows_known
        if a.live is not None or b.live is not None or na is None or nb is None:
            raise ExecError("_concat_rows needs packed tables with known counts")
        return self._stacked(a, b, na, nb, bucket_cap(max(na + nb, 1)),
                             na + nb, None)

    def _stacked(self, a, b, na, nb, cap, nrows, live):
        """a's first na rows, then b's first nb, in buffers of `cap` rows:
        dtypes promoted and string dictionaries shared as a union does."""
        cols = {}
        for an, bn in zip(a.columns, b.columns):
            ca, cb = a.columns[an], b.columns[bn]
            if ca.dtype.is_string or cb.dtype.is_string:
                (da, db), dictionary = _share_dictionary([ca, cb])
                dtype = ca.dtype
            else:
                dtype = _common_dtype([ca.dtype, cb.dtype])
                da = _cast_column(ca, dtype, ca.data.shape[0])
                db = _cast_column(cb, dtype, cb.data.shape[0])
                dictionary = None
            data = _stack(da.data, db.data, na, nb, cap)
            if da.valid is None and db.valid is None:
                valid = None
            else:
                ones = torch.ones(max(na, nb), dtype=torch.bool,
                                  device=data.device)
                valid = _stack(
                    ones if da.valid is None else da.valid,
                    ones if db.valid is None else db.valid, na, nb, cap)
            cols[an] = Column(data, dtype, valid, dictionary)
        return Table(cols, nrows, live=live)
