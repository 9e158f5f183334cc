"""Pipeline fusion: one call per Filter/Project chain, and per chain with
its partial-aggregate tail.

The port of nds_tpu/engine/fuse.py. A plan-rewrite pass (`mark_pipelines`,
the JAX package's rewrite as it is) replaces every maximal linear
Filter/Project chain with one `plan.Pipeline` node, and the executor runs
that chain through one entry of the session's `ExecutableCache`.

The JAX package traces the chain into one jitted executable. The port runs
eager PyTorch, with no compilation (torch.compile of the plain version is
not a kernel of this repository), so an entry splits the same work
between build and call:

  * Build, once per (stage fingerprint, input signature): the chain runs
    once over a one-row probe of the sample table with this thread's
    host-product tape recording (engine/columnar.host_product). Every
    piece of host-side dictionary work — the LIKE and IN lookup tables,
    dictionary unification, string-function remaps, string casts, the
    `sort_dictionary` ranks of a string min/max — lands on the tape as
    device tensors and dictionaries, which is what the JAX trace bakes in
    as constants. A chain that reads device values on the host (a number
    cast to a string, a concat past the pairwise dictionary) raises
    HostRead, and a fused aggregate whose keys have no static bounds
    raises Unfusible: the cache pins that signature to the eager path,
    exactly the signatures the JAX package pins.
  * Call: the tape replays, so the evaluator does tensor work only. Every
    filter folds into one live mask and the count stays queued on the
    device (exec._masked's deferred compaction); no Table is made per plan
    node. Outputs that pass an input through are the caller's own column
    objects (the evaluator returns them by identity), so their stats
    survive exactly where the JAX package's _StatsMarker lets them.
  * Memory: an entry keeps metadata, dictionaries and the tape's lookup
    tables, never the sample's columns (the probe is a view the build
    drops).

Donation (`engine.fuse_donate=on`, opt-in as in the JAX package): the
first filter of a chain whose child the rewrite cleared (`donate_ok`) ANDs
its predicate into the consumed live mask's own storage instead of
allocating a new mask. Nothing else is donated: the port's columns carry
no ownership flag, and an eager tensor's storage cannot be handed to an
output of another shape.

A fused call is never retried on the eager path: an error in it (a CUDA
error included) propagates.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from ..dtypes import FLOAT64, INT64
from ..ops import kernels as K
from . import expr as E
from . import plan as P
from .columnar import (
    Column,
    HostRead,
    Table,
    bucket_cap,
    host_tape,
    sort_dictionary,
    torch_dtype,
)
from .expr import Evaluator


# ---------------------------------------------------------------------------
# plan rewrite: absorb Filter/Project chains into Pipeline nodes
# ---------------------------------------------------------------------------

# a pipeline child whose live mask may be donated must be a single-consumer
# intermediate no cache retains AND whose mask it owns: scans alias catalog
# buffers; Aggregate/Distinct/SetOp/Window results live in the session plan
# cache across statements; binary Join outputs alias their LEFT input's
# live mask on the left/mark augment paths (exec._augment_join_output), so
# donating their mask would invalidate a buffer the left table still
# references. MultiJoin stays eligible: its inner/cross steps always mint a
# fresh mask (matched / compacted / residual) owned by the output alone.
_NO_DONATE_CHILD = (P.Scan, P.MaterializedScan, P.Join, P.Aggregate,
                    P.Distinct, P.SetOp, P.Window)


def _expr_fusible(e) -> bool:
    """True when an expression can run inside one fused call: anything
    except subqueries (they execute whole plans and fetch scalars to the
    host) and aggregate/window functions (never scalar-evaluated).
    Host-side dictionary work (LIKE, IN, string functions) is fine — it
    runs once at build time over the concrete dictionaries. Chains that
    read device values on the host (numeric->string casts, large concats)
    raise HostRead at build time and are pinned to the eager path, the
    signatures the JAX package's trace fails on."""
    for x in E.walk(e):
        if isinstance(
            x, (E.SubqueryExpr, E.ScalarSubquery, E.Agg, E.WindowFn)
        ):
            return False
    return True


def _stage_fusible(n) -> bool:
    if isinstance(n, P.Filter):
        return _expr_fusible(n.predicate)
    if isinstance(n, P.Project):
        return bool(n.items) and all(_expr_fusible(e) for e, _ in n.items)
    return False


def _agg_fusible(n: P.Aggregate) -> bool:
    """True when an Aggregate can become a Pipeline's fused tail: plain
    shape only (no grouping sets — the rollup cascade re-aggregates across
    levels; no blocked_union — the windowed path owns those), every
    aggregate decomposable (sum/min/max/count/avg, no distinct — the same
    predicate the blocked-union path gates on), and every key/argument
    expression fusible. Whether the key DOMAIN is small enough for the
    direct scatter is a data property checked at build time (column stats);
    ineligible inputs pin to the eager path per input signature."""
    if n.grouping_sets is not None or n.blocked_union:
        return False
    if not P.aggs_decomposable(n.aggs):
        return False
    for e, _ in n.keys:
        if not _expr_fusible(e):
            return False
    for a, _ in n.aggs:
        if a.arg is not None and not _expr_fusible(a.arg):
            return False
    return True


def _chain_worth_fusing(stages) -> bool:
    """A pure-rename/subset chain gains nothing from fusion (the eager path
    reuses the input column objects outright); fuse only when the chain
    filters or computes something."""
    for s in stages:
        if isinstance(s, P.Filter):
            return True
        if any(not isinstance(e, E.Col) for e, _ in s.items):
            return True
    return False


def _count_refs(node) -> dict:
    """Plan-node reference counts (subquery plans riding in expressions
    included). A shared wrapper must not be absorbed into a pipeline: the
    detached copy would defeat the executor's by-identity result reuse."""
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

    visit(node)
    return refs


def _donate_ok_child(cur, refs) -> bool:
    """Plan-level donation clearance for a pipeline's child: the child's
    result must be single-consumer, never retained by a cross-statement
    cache (Aggregate/Distinct/SetOp/Window AND agg-tail Pipelines live in
    the session plan cache), and never an aliasing producer
    (_NO_DONATE_CHILD). WHICH buffers are then actually donatable is a
    runtime property (Column.owned + passthrough analysis in the fused
    call); this gate only proves no OTHER plan node can observe them."""
    if refs.get(id(cur), 1) > 1:
        return False
    if isinstance(cur, _NO_DONATE_CHILD):
        return False
    if isinstance(cur, P.Pipeline) and cur.agg is not None:
        return False  # plan-cached, same as a raw Aggregate
    return True


def mark_pipelines(node: P.PlanNode, fuse_aggs: bool = True):
    """Rewrite every maximal linear Filter/Project chain (anywhere in the
    tree, subquery plans included) into one `plan.Pipeline` node; with
    `fuse_aggs` (conf `engine.fuse_agg`, on by default), a plain
    decomposable Aggregate additionally absorbs the chain FEEDING it and
    becomes the Pipeline's fused aggregate tail — the whole
    scan→filter→project→partial-aggregate run is then one fused call
    (FusedAggPipeline).

    Returns (root, count): the root itself may head a chain, so callers
    must adopt the returned root; `count` is the number of pipelines
    created (plan-introspection aid for tests/tools)."""
    refs = _count_refs(node)
    made = 0
    seen = set()

    def chain_under(n):
        """(detached stages in execution order, chain input) for the
        maximal fusible single-consumer Filter/Project chain headed at
        `n` (possibly empty)."""
        topdown = []
        cur = n
        while isinstance(cur, (P.Filter, P.Project)) and _stage_fusible(cur):
            # shared nodes keep their identity (the executor caches results
            # by id): a chain stops at the first node with a second parent
            if refs.get(id(cur), 1) > 1:
                break
            topdown.append(cur)
            cur = cur.child
        stages = []
        for s in reversed(topdown):  # execution (innermost-first) order
            if isinstance(s, P.Filter):
                stages.append(P.Filter(predicate=s.predicate, child=None))
            else:
                stages.append(P.Project(items=list(s.items), child=None))
        return stages, cur

    def absorb(n):
        """The Pipeline replacing chain head `n`, or `n` unchanged."""
        nonlocal made
        if (
            fuse_aggs
            and isinstance(n, P.Aggregate)
            and refs.get(id(n), 1) <= 1
            and _agg_fusible(n)
        ):
            # the aggregate tail + the chain feeding it fuse into ONE node;
            # a detached copy keeps the executor's by-identity caches away
            # from the original (which this rewrite discards)
            stages, cur = chain_under(n.child)
            made += 1
            return P.Pipeline(
                stages=stages,
                child=cur,
                donate_ok=_donate_ok_child(cur, refs),
                agg=P.Aggregate(
                    keys=list(n.keys), aggs=list(n.aggs), child=None
                ),
            )
        topdown_stages, cur = chain_under(n)
        if not topdown_stages or not _chain_worth_fusing(topdown_stages):
            return n
        made += 1
        return P.Pipeline(
            stages=topdown_stages,
            child=cur,
            donate_ok=_donate_ok_child(cur, refs),
        )

    def visit(v):
        if isinstance(v, (P.PlanNode, E.Expr)):
            if id(v) in seen:
                return
            seen.add(id(v))
            if isinstance(v, P.Sort):
                # single-consumer annotation for the Limit-over-Sort top-k
                # gather (exec._exec_limit): a shared Sort must execute in
                # full once, not top-k for one parent and again in full
                # for the other
                v._topk_safe = refs.get(id(v), 1) <= 1
            if isinstance(v, P.Pipeline):
                # stages/agg are detached (child=None) fragments: never
                # re-absorb them; only the real child subtree recurses —
                # and that child may itself head an absorbable shape (a
                # HAVING chain's pipeline sits over a fusible Aggregate)
                nv = absorb(v.child)
                if nv is not v.child:
                    v.child = nv
                    v.donate_ok = _donate_ok_child(nv, refs)
                visit(v.child)
                return
            for f in dataclasses.fields(v):
                cv = getattr(v, f.name)
                if isinstance(cv, P.PlanNode):
                    nv = absorb(cv)
                    if nv is not cv:
                        # Expr dataclasses are frozen; the plan field of a
                        # ScalarSubquery is excluded from hash/compare, so
                        # in-place rewrite is safe
                        object.__setattr__(v, f.name, nv)
                        cv = nv
                elif isinstance(cv, list):
                    for i, x in enumerate(cv):
                        if isinstance(x, P.PlanNode):
                            nx = absorb(x)
                            if nx is not x:
                                cv[i] = nx
                visit(cv)
        elif isinstance(v, (list, tuple)):
            for x in v:
                visit(x)

    root = absorb(node)
    visit(root)
    return root, made



# ---------------------------------------------------------------------------
# fused evaluation
# ---------------------------------------------------------------------------


class Unfusible(ValueError):
    """A fused aggregate's input the direct scatter cannot take (a key
    without static bounds, a domain past the direct cap, a string sum): the
    JAX package's build raises on the same inputs and pins them."""


#: the build failures that pin a signature to the eager path; anything else
#: (a CUDA error included) propagates
_PIN = (HostRead, Unfusible)


class _Tape:
    """The host products of one chain: recorded in evaluation order by the
    build, replayed in the same order by every call (the order is fixed by
    the stages and the input signature — dtypes, validity and dictionary
    identity — alone)."""

    __slots__ = ("items", "_pos", "_recording")

    def __init__(self, items=None):
        self._recording = items is None
        self.items = [] if items is None else items
        self._pos = 0

    def product(self, compute):
        if self._recording:
            v = compute()
            self.items.append(v)
            return v
        v = self.items[self._pos]
        self._pos += 1
        return v

    def replay(self) -> "_Tape":
        """A cursor of its own for one call (a session's cache may serve
        two threads' statements)."""
        return _Tape(self.items)


class _Frame:
    """The columns an Evaluator reads within a fused call (no Table)."""

    __slots__ = ("columns", "cap")

    def __init__(self, columns, cap):
        self.columns = columns
        self.cap = cap

    @property
    def names(self):
        return list(self.columns)


def _device_of(table: Table):
    for c in table.columns.values():
        return c.data.device
    return torch.device("cpu")


def _probe(sample: Table) -> Table:
    """A one-row view of `sample` with its metadata: the build's input.
    Host products depend on dictionaries alone, so one row records them
    all; the view is dropped with the build."""
    cols = {
        name: Column(c.data[:1], c.dtype,
                     None if c.valid is None else c.valid[:1],
                     c.dictionary, c.stats)
        for name, c in sample.columns.items()
    }
    live = None if sample.live is None else sample.live[:1]
    return Table(cols, 1, live=live)


class _HostArray:
    """A tape tensor as numpy, for the persistent cache's pickle."""

    __slots__ = ("array",)

    def __init__(self, array):
        self.array = array


def _to_host(v):
    if isinstance(v, torch.Tensor):
        return _HostArray(v.cpu().numpy())
    if isinstance(v, (tuple, list)):
        return type(v)(_to_host(x) for x in v)
    return v


def _to_device(v, device):
    if isinstance(v, _HostArray):
        return torch.from_numpy(np.ascontiguousarray(v.array)).to(device)
    if isinstance(v, (tuple, list)):
        return type(v)(_to_device(x, device) for x in v)
    return v


class _FusedBase:
    """Stage application shared by both fused callables."""

    def _init_common(self, stages):
        self.stages = stages
        self.has_filter = any(isinstance(s, P.Filter) for s in stages)

    def _apply_stages(self, table: Table, donate: bool, need_live: bool):
        """(columns, live mask or None) after every stage. Filters fold
        into one mask; with `donate` the first one ANDs into the consumed
        input mask's storage (the plan proved the child single-consumer).
        A mask minted inside the call is ours to update in place."""
        cap = table.cap
        dev = _device_of(table)
        cols = table.columns
        live = table.live
        own = False
        if live is None and (self.has_filter or need_live):
            live = torch.arange(cap, device=dev) < table.nrows_lazy
            own = True
        elif live is not None and donate and self.has_filter:
            own = True
        for s in self.stages:
            ev = Evaluator(_Frame(cols, cap), dev)
            if isinstance(s, P.Filter):
                pr = ev.eval(s.predicate)
                mask = pr.data.bool()
                if pr.valid is not None:
                    mask = mask & pr.valid
                if own:
                    live &= mask
                else:
                    live = mask & live
                    own = True
            else:
                cols = {name: ev.eval(e) for e, name in s.items}
        return cols, live

    def products(self) -> dict:
        """What a fresh process would otherwise rebuild (engine/aotcache.py
        stores it): the tape as host arrays plus the class's own meta."""
        return {"tape": _to_host(self.tape.items), **self._meta()}

    @classmethod
    def from_products(cls, stages, agg, rec: dict, device):
        self = cls.__new__(cls)
        self._load(stages, agg, rec)
        self.tape = _Tape(_to_device(rec["tape"], device))
        return self


class FusedPipeline(_FusedBase):
    """One Filter/Project chain for one input signature."""

    def __init__(self, stages, sample: Table):
        self._init_common(stages)
        probe = _probe(sample)
        self.tape = _Tape()
        with host_tape(self.tape):
            self._apply_stages(probe, donate=False, need_live=False)
        self.tape = self.tape.replay()

    def _meta(self) -> dict:
        return {"has_filter": self.has_filter}

    def _load(self, stages, agg, rec):
        self.stages = stages
        self.has_filter = rec["has_filter"]

    def call(self, table: Table, donate: bool) -> Table:
        with host_tape(self.tape.replay()):
            cols, live = self._apply_stages(table, donate, need_live=False)
        if self.has_filter:
            nrows = live.sum(dtype=torch.int32)  # queued count
        else:
            nrows, live = table.nrows_lazy, table.live
        return Table(
            dict(cols), nrows, live=live,
            unique_key=self._out_unique_key(table),
        )

    def _out_unique_key(self, table: Table):
        """Replay name flow host-side: filters preserve the input's unique
        key; projections keep it only when every key column survives as a
        plain rename (mirrors exec._project_table)."""
        uk = table.unique_key
        names = set(table.columns)
        for s in self.stages:
            if uk is None:
                return None
            if isinstance(s, P.Filter):
                continue
            renames = {}
            for e, name in s.items:
                if isinstance(e, E.Col):
                    key = f"{e.table}.{e.name}" if e.table else e.name
                    if key not in names and e.name in names:
                        key = e.name
                    renames.setdefault(key, name)
            uk = (
                frozenset(renames[k] for k in uk)
                if all(k in renames for k in uk)
                else None
            )
            names = {n for _, n in s.items}
        return uk


_DIRECT_AGG_MAX_DOMAIN = 1 << 22  # mirrors exec._DIRECT_AGG_MAX_DOMAIN


class FusedAggPipeline(_FusedBase):
    """A Filter/Project chain PLUS its decomposable aggregate tail in one
    call.

    The call runs the chain, folds filters into the live mask, computes
    mixed-radix group codes with the build's bounds (the executor's direct
    sort-free aggregation, exec._try_direct_agg), and reduces every
    aggregate into domain-sized cells through ops/kernels.py's segment
    routines, which send dead and NULL lanes to spare slots rather than to
    one cell (the JAX package parks them at cell 0, where a GPU's atomics
    would serialise). Then ONE host sync for the occupied-group count,
    compaction of the occupied cells, key reconstruction from the cell
    codes, and a gather of each aggregate: gcap-sized work after the one
    fact-sized pass.

    Build raises Unfusible (and the cache pins the signature) when a key
    lacks static bounds, the combined domain exceeds the direct cap, or an
    aggregate cannot scatter: the inputs the eager path routes to its
    sort-based aggregation."""

    def __init__(self, stages, agg: P.Aggregate, sample: Table):
        self._init_common(stages)
        self.agg = agg
        probe = _probe(sample)
        self.tape = _Tape()
        self.mins = None
        with host_tape(self.tape):
            self._run(probe, donate=False)
        self.tape = self.tape.replay()

    def _meta(self) -> dict:
        return {
            "has_filter": self.has_filter,
            "key_meta": self.key_meta, "mins": self.mins,
            "ranges": self.ranges, "domain_cap": self.domain_cap,
            "agg_meta": self.agg_meta,
        }

    def _load(self, stages, agg, rec):
        self.stages = stages
        self.agg = agg
        for k in ("has_filter", "key_meta", "mins", "ranges", "domain_cap",
                  "agg_meta"):
            setattr(self, k, rec[k])

    def _resolve_bounds(self, key_cols):
        """Mixed-radix bounds from the keys' static sources, the ones the
        eager direct path accepts: dictionary codes and bools span
        statically, integer-like keys need ColStats that survived the
        chain (a key that is an input column as it is)."""
        mins, ranges, meta = [], [], []
        domain = 1
        for c in key_cols:
            if c.dtype.is_string:
                if c.dictionary is None or len(c.dictionary) == 0:
                    raise Unfusible("string key without a dictionary")
                kmin, kmax = 0, len(c.dictionary) - 1
            elif c.dtype.kind == "bool":
                kmin, kmax = 0, 1
            elif c.dtype.kind in ("int32", "int64", "date"):
                if c.stats is None:
                    raise Unfusible("key without static bounds")
                kmin, kmax = int(c.stats.vmin), int(c.stats.vmax)
            else:
                raise Unfusible(f"key dtype {c.dtype} not direct-aggable")
            krange = kmax - kmin + 1 + (1 if c.valid is not None else 0)
            domain *= krange
            if domain > _DIRECT_AGG_MAX_DOMAIN:
                raise Unfusible("group-key domain exceeds the direct cap")
            mins.append(kmin)
            ranges.append(krange)
            meta.append((c.dtype, c.dictionary, c.valid is not None))
        self.mins = mins
        self.ranges = ranges
        self.key_meta = meta
        self.domain_cap = bucket_cap(domain)

    def _run(self, table: Table, donate: bool):
        """The fact-sized pass: (key columns, occupied cells, reduced
        arrays). The build runs it over the probe to record the tape and
        the layout (`agg_meta`)."""
        building = self.mins is None
        cols, live = self._apply_stages(table, donate, need_live=True)
        cap = table.cap
        ev = Evaluator(_Frame(cols, cap), _device_of(table))
        key_cols = [ev.eval(e) for e, _ in self.agg.keys]
        if building:
            self._resolve_bounds(key_cols)
        dc = self.domain_cap
        datas = [
            c.data.to(torch.int32) if c.data.dtype == torch.bool else c.data
            for c in key_cols
        ]
        gid = K.direct_gid(datas, [c.valid for c in key_cols], self.mins,
                           self.ranges, live)
        occ = K.occupied(gid, live, dc)
        out = [occ]
        meta = []
        for a, name in self.agg.aggs:
            fn = a.fn
            if fn == "count" and a.arg is None:
                meta.append(("count", name, INT64, None, len(out), None))
                out.append(K.segment_reduce(live.to(torch.int64), gid, live,
                                            dc, "count"))
                continue
            c = ev.eval(a.arg)
            weight = live if c.valid is None else live & c.valid
            sdata = c.data
            dictionary = None
            if c.dtype.is_string:
                if fn not in ("min", "max"):
                    raise Unfusible(f"agg {fn} on string column")
                # the rank transform's tables are tape products; comparing
                # rank codes is comparing strings (exec._eval_agg)
                sdata, dictionary = sort_dictionary(c)
            if fn == "count":
                meta.append(("count", name, INT64, None, len(out), None))
                out.append(K.segment_reduce(sdata, gid, weight, dc, "count"))
            elif fn in ("sum", "min", "max"):
                red, counts = K.segment_reduce_with_count(
                    sdata, gid, weight, dc, fn
                )
                dtype = c.dtype
                if c.dtype.is_string:
                    red = red.to(torch.int32)
                elif fn == "sum" and dtype.kind == "int32":
                    dtype = INT64
                    red = red.to(torch.int64)
                meta.append(("valcnt", name, dtype, dictionary, len(out),
                             len(out) + 1))
                out += [red, counts]
            elif fn == "avg":
                # raw (sum, count); the division runs after the gather with
                # the eager path's exact op sequence
                s, n = K.segment_reduce_with_count(sdata, gid, weight, dc,
                                                   "sum")
                scale = c.dtype.scale if c.dtype.is_decimal else None
                meta.append(("avg", name, FLOAT64, scale, len(out),
                             len(out) + 1))
                out += [s, n]
            else:
                raise Unfusible(f"aggregate {fn} not fusible")
        if building:
            self.agg_meta = meta
        return key_cols, out

    def call(self, table: Table, donate: bool) -> Table:
        with host_tape(self.tape.replay()):
            key_cols, out = self._run(table, donate)
        if not self.agg.keys:
            # global aggregate: exactly one output row (cell 0), over an
            # empty input too
            cols = {}
            for meta in self.agg_meta:
                cols.update(self._agg_column(meta, out, None))
            return Table(cols, 1, unique_key=frozenset())
        occ = out[0]
        # the ONE host sync of the fused path: the occupied-group count
        # the eager direct aggregation fetches as well
        ngroups = K.mask_count(occ)
        if ngroups == 0:
            return self._empty_output(occ.device)
        gcap = bucket_cap(ngroups)
        cells = K.compact_indices(occ, gcap).to(torch.int64)
        # key columns from the occupied cell codes (reverse mixed-radix
        # decomposition; the last key is least significant)
        codes = []
        rem = cells
        for krange in reversed(self.ranges):
            codes.append(rem % krange)
            rem = rem // krange
        codes.reverse()
        n_keys = len(self.agg.keys)
        cols = {}
        for (e, name), c, code, kmin in zip(self.agg.keys, key_cols, codes,
                                            self.mins):
            if c.valid is not None:
                valid = code != 0
                value = torch.where(valid, kmin + code - 1, 0)
            else:
                valid = None
                value = kmin + code
            stats = c.subset_stats()
            if stats is not None:
                stats = dataclasses.replace(stats, unique=(n_keys == 1))
            cols[name] = Column(value.to(torch_dtype(c.dtype)), c.dtype,
                                valid, c.dictionary, stats)
        for meta in self.agg_meta:
            cols.update(self._agg_column(meta, out, cells))
        return Table(cols, ngroups,
                     unique_key=frozenset(n for _, n in self.agg.keys))

    @staticmethod
    def _agg_column(meta, out, cells):
        # 4th slot: dictionary for valcnt kinds, decimal scale for avg
        kind, name, dtype, dictionary, s1, s2 = meta

        def gather(slot):
            arr = out[slot]
            if cells is None:
                return arr[: bucket_cap(1)]
            return arr[cells]

        if kind == "count":
            return {name: Column(gather(s1).to(torch.int64), INT64)}
        if kind == "avg":
            s, n = gather(s1), gather(s2)
            nz = n.clamp(min=1)
            # the eager _eval_agg's exact division sequence
            if dictionary is not None:
                val = s.to(torch.float64) / (10**dictionary) / nz
            else:
                val = s.to(torch.float64) / nz
            return {name: Column(val, FLOAT64, n > 0)}
        return {name: Column(gather(s1), dtype, gather(s2) > 0, dictionary)}

    def _empty_output(self, device) -> Table:
        """The eager empty grouped aggregate (exec._agg_output with
        ngroups=0): 1-capacity columns, zero rows, every aggregate a null
        INT64."""
        cols = {}
        for (e, name), (dtype, dic, _) in zip(self.agg.keys, self.key_meta):
            cols[name] = Column(
                torch.zeros(1, dtype=torch_dtype(dtype), device=device),
                dtype, torch.zeros(1, dtype=torch.bool, device=device), dic,
            )
        for meta in self.agg_meta:
            cols[meta[1]] = Column(
                torch.zeros(1, dtype=torch.int64, device=device), INT64,
                torch.zeros(1, dtype=torch.bool, device=device),
            )
        return Table(cols, 0)


class _Same:
    """A dictionary in a signature: equal only to itself, hashed by id().
    Holding the object keeps that id truthful for as long as the key
    lives (a freed dictionary's recycled address must not alias a new
    one, whose codes the entry's tape would misread)."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __eq__(self, other):
        return isinstance(other, _Same) and other.obj is self.obj

    def __hash__(self):
        return id(self.obj)


def input_signature(table: Table, with_stats: bool = False):
    """Hashable identity of an input table's device layout: liveness mode,
    column names, dtypes, validity presence, dictionary identity (codes
    mean something only relative to their dictionary, and the tape's
    lookup tables are built from it; the signature holds each dictionary,
    see _Same). Capacity is deliberately absent: an entry serves every
    capacity bucket.

    `with_stats` (aggregate tails) folds each column's host-side (vmin,
    vmax) in: the fused aggregate's mixed-radix bounds come from them, so a
    dataset with different bounds builds its own entry."""
    sig = [table.live is not None]
    for name, c in table.columns.items():
        entry = (
            name,
            repr(c.dtype),
            c.valid is not None,
            _Same(c.dictionary) if c.dictionary is not None else None,
        )
        if with_stats:
            entry = entry + (
                (int(c.stats.vmin), int(c.stats.vmax))
                if c.stats is not None
                else None,
            )
        sig.append(entry)
    return tuple(sig)


def build_entry(stages, agg, sample: Table, aot=None, fp=None, conf_sig=()):
    """(entry, loaded): a FusedPipeline (agg None) or FusedAggPipeline for
    `sample`'s signature. With a persistent cache (engine/aotcache.py) a stored
    entry loads instead of building, a stored pin raises Unfusible, and a
    fresh build or pin is stored for the next process."""
    cls = FusedPipeline if agg is None else FusedAggPipeline
    key = None
    if aot is not None:
        key = aot.entry_key(
            "pipeline" if agg is None else "agg_pipeline", fp,
            aot.content_signature(sample, with_stats=agg is not None),
            [(["cap"], str(c.data.dtype)) for c in sample.columns.values()],
            (), conf_sig,
        )
        rec = aot.load(key)
        if rec is not None:
            if rec["verdict"] == "pin":
                raise Unfusible("pinned by the persistent cache")
            return cls.from_products(stages, agg, rec,
                                     _device_of(sample)), True
    try:
        entry = cls(stages, sample) if agg is None else cls(stages, agg,
                                                             sample)
    except _PIN:
        if key is not None:
            aot.store(key, {"verdict": "pin"})
        raise
    if key is not None:
        aot.store(key, {"verdict": "fuse", **entry.products()})
    return entry, False


class ExecutableCache:
    """Session-level cache of fused entries keyed by (stage fingerprint,
    input signature), with per-(key, bucket) hit/miss accounting (the JAX
    package's bucket level, where XLA compiles; the port's entries serve
    every bucket, so a miss costs nothing past the entry's first call).
    Keys hold their dictionaries (see input_signature); a signature
    whose build raised HostRead or Unfusible is pinned as None so the
    executor stops re-attempting it. LRU by entry count. `builds` counts
    probe builds run here, `loads` entries taken from the persistent
    cache, `pins` pinned signatures."""

    def __init__(self, max_entries: int = 512):
        self.max_entries = max_entries
        self.map = OrderedDict()  # (fp, sig) -> fused entry | None
        self.buckets = set()  # (fp, sig, cap) already called
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self.loads = 0
        self.pins = 0

    def lookup(self, fp, sig, cap, build):
        """(fused entry | None, hit: bool). `build()` returns (entry,
        loaded) and raises HostRead / Unfusible for a signature to pin."""
        key = (fp, sig)
        if key in self.map:
            entry = self.map[key]
            self.map.move_to_end(key)
        else:
            try:
                entry, loaded = build()
                if loaded:
                    self.loads += 1
                else:
                    self.builds += 1
            except _PIN:
                entry = None  # unfusible chain: pin to the eager path
                self.pins += 1
            self.map[key] = entry
            while len(self.map) > self.max_entries:
                old_key, _ = self.map.popitem(last=False)
                self.buckets = {
                    b for b in self.buckets if b[:2] != old_key
                }
        if entry is None:
            return None, False
        bkey = (fp, sig, cap)
        hit = bkey in self.buckets
        if hit:
            self.hits += 1
        else:
            self.misses += 1
            self.buckets.add(bkey)
        return entry, hit

    def clear(self):
        self.map.clear()
        self.buckets.clear()
