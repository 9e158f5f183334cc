"""Session: the user-facing entry point of the PyTorch/CUDA SQL engine — the
single-device subset of nds_tpu/engine/session.py.

A Session owns a catalog of named tables (in-memory Arrow tables, or device
tables built with `table_from_numpy`), parses + binds + prunes SQL, executes
it with the unfused operator path (whatever `engine.fuse` says: fusion is
not ported), and returns Arrow tables.

It runs on the card unless the caller asks for the CPU: `device=None`
resolves to `cuda` and raises when no GPU is present; nothing moves to the
CPU on its own. The conf keys keep the JAX package's names, defaults and
meanings (`engine.pallas_agg`, `engine.pallas_join`, `engine.pallas_sort`:
off | on | auto, default off). Conf keys and environment knobs of layers not
ported yet (tracing, plan verification, fault injection, forced spill)
raise NotImplementedError rather than being ignored.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import torch

from ..schema import Field, Schema, TABLE_PRIMARY_KEYS
from . import expr as E
from . import plan as P
from .binder import Binder
from .columnar import Table, _infer_dtype, table_from_arrow, table_to_arrow
from .exec import Executor
from .sql import ast as A
from .sql.parser import parse_sql

#: (conf key, environment knob) of layers the port has not ported, with the
#: ROADMAP.md item that ports them
_UNPORTED_KNOBS = (
    ("engine.trace_dir", "NDS_TRACE_DIR", "queue 1 item 12 (serve/obs)"),
    ("engine.metrics_port", "NDS_METRICS_PORT", "queue 1 item 12 (serve/obs)"),
    ("engine.verify_plans", "NDS_VERIFY_PLANS", "queue 1 item 9 (harness entry points)"),
    ("engine.fault_spec", "NDS_FAULT_SPEC", "queue 1 item 9 (harness entry points)"),
)


def resolve_device(device=None) -> torch.device:
    """`device` as given, or `cuda` when None. Raises when CUDA is asked
    for (explicitly or by default) and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nds_tpu_torch runs on a CUDA GPU and none is available; pass "
            "device='cpu' to run the engine's plain PyTorch path on the CPU"
        )
    return dev


class _Entry:
    def __init__(self, schema=None, arrow=None, table=None):
        self.schema = schema  # Schema or None (infer)
        self.arrow = arrow  # pa.Table (in-memory), or None
        self.table = table  # device Table (register_table), or None
        self.device_cols = {}  # per-column device cache: name -> Column
        self.nrows = None
        self.pk_verified = None  # declared-PK verification memo


class Catalog:
    def __init__(self, session):
        self.session = session
        self.entries = {}  # name -> _Entry

    def schema(self, name):
        e = self.entries.get(name)
        if e is None:
            return None
        if e.schema is not None:
            return e.schema
        if e.table is not None:
            return Schema(tuple(
                Field(n, c.dtype) for n, c in e.table.columns.items()
            ))
        return Schema(
            tuple(Field(f.name, _infer_dtype(f.type)) for f in e.arrow.schema)
        )

    def load(self, name, columns=None) -> Table:
        """Load (a projection of) a table to the device, caching per column
        so repeated queries never re-upload what is already resident."""
        e = self.entries.get(name)
        if e is None:
            raise KeyError(f"unknown table {name}")
        if columns is None:
            columns = self.schema(name).names
        if e.table is not None:
            e.device_cols = e.table.columns
            e.nrows = e.table.nrows
        missing = [c for c in columns if c not in e.device_cols]
        if missing:
            t = self._to_device(e.arrow.select(missing), e)
            e.nrows = t.nrows
            e.device_cols.update(t.columns)
        if e.nrows is None:
            e.nrows = 0
        out = Table({c: e.device_cols[c] for c in columns}, e.nrows)
        pk = TABLE_PRIMARY_KEYS.get(name)
        if pk is not None and all(c in columns for c in pk):
            if e.pk_verified is None:
                st = out.columns[pk[0]].stats if len(pk) == 1 else None
                if st is not None and st.unique:
                    e.pk_verified = True
                else:
                    e.pk_verified = _pk_holds(out, pk)
            if e.pk_verified:
                out.unique_key = frozenset(pk)
        return out

    def _to_device(self, arrow, e: _Entry):
        return table_from_arrow(arrow, e.schema, with_stats=True,
                                device=self.session.device)


class Result:
    """Executed query result."""

    def __init__(self, session, plan_node):
        self.session = session
        self.plan = plan_node
        self._table = None

    def table(self) -> Table:
        """Execute (memoized)."""
        if self._table is None:
            self._table = self.session._executor().execute(self.plan)
        return self._table

    def collect(self):
        return table_to_arrow(self.table())

    def to_pylist(self):
        return self.collect().to_pylist()

    def num_rows(self):
        return self.table().nrows

    def explain(self) -> str:
        return P.explain(self.plan)


class Session:
    def __init__(self, use_decimal: bool = True, conf: Optional[dict] = None,
                 device=None):
        self.use_decimal = use_decimal
        self.conf = dict(conf or {})
        for key, env, item in _UNPORTED_KNOBS:
            v = self.conf.get(key) or os.environ.get(env)
            if v and str(v).lower() != "off":
                raise NotImplementedError(
                    f"{key} / {env} is not ported to nds_tpu_torch yet: "
                    f"ROADMAP.md {item}"
                )
        if str(self.conf.get("engine.spill", "auto")).lower() == "force":
            raise NotImplementedError(
                "engine.spill=force is not ported to nds_tpu_torch yet: "
                "ROADMAP.md queue 1 item 10 (spill)"
            )
        self.device = resolve_device(device)
        self.catalog = Catalog(self)
        # kernel promotion memo (engine.pallas_*=auto): per (kernel, shape)
        # the measured plain-vs-kernel A/B and the winning route
        self.pallas_promotions = {}
        self.cache_lock = threading.RLock()
        # stats of the most recent blocked union aggregation (windows,
        # window rows and cap, total rows, largest table cap), or None
        self.last_blocked_union = None

    def union_agg_window_rows(self, row_bytes: int) -> int:
        """Rows per window of blocked union aggregation, as the JAX session
        derives them: `engine.union_agg_window_rows`, then the
        NDS_UNION_AGG_WINDOW_ROWS knob, else 1/16 of the catalog's device
        budget (NDS_CATALOG_BUDGET_BYTES, 6 GiB) in `row_bytes`-wide rows,
        rounded down to a power of two and clamped to [2^16, 2^24]."""
        v = self.conf.get("engine.union_agg_window_rows") or os.environ.get(
            "NDS_UNION_AGG_WINDOW_ROWS"
        )
        if v:
            return max(int(v), 1)
        budget = int(os.environ.get("NDS_CATALOG_BUDGET_BYTES", 6 << 30))
        rows = max(budget // 16 // max(row_bytes, 1), 1)
        return int(min(max(1 << (rows.bit_length() - 1), 1 << 16), 1 << 24))

    # ---- registration ----------------------------------------------------
    def register_arrow(self, name, arrow, schema=None):
        self.catalog.entries[name.lower()] = _Entry(schema=schema, arrow=arrow)

    def register_table(self, name, table: Table):
        """Register a device Table (e.g. from `table_from_numpy`); its
        buffers must live on this session's device."""
        for c in table.columns.values():
            if c.data.device.type != self.device.type:
                raise ValueError(
                    f"table {name!r} lives on {c.data.device}, the session "
                    f"on {self.device}"
                )
        self.catalog.entries[name.lower()] = _Entry(table=table)

    def drop(self, name):
        self.catalog.entries.pop(name.lower(), None)

    # ---- SQL -------------------------------------------------------------
    def _executor(self):
        return Executor(self.catalog, self.device)

    def sql(self, text: str) -> Result:
        return self.run_stmt(parse_sql(text))

    def run_stmt(self, stmt) -> Optional[Result]:
        if isinstance(stmt, A.SelectStmt):
            binder = Binder(self.catalog)
            plan = prune_columns(binder.bind(stmt), self.catalog)
            P.mark_blocked_union_aggs(plan)
            return Result(self, plan)
        raise NotImplementedError(
            f"{type(stmt).__name__} is not ported to nds_tpu_torch yet: "
            f"ROADMAP.md queue 1 item 9 (harness entry points)"
        )


def _pk_holds(t, pk) -> bool:
    """One-time device check that the declared primary key is unique in
    this table's data (exact packed words, sort, adjacent compare; one host
    sync). Conservative False when columns aren't packable ints."""
    from ..ops import kernels as K

    cols = [t.columns[c] for c in pk]
    if any(
        c.dtype.is_string or c.dtype.is_decimal or c.stats is None
        for c in cols
    ):
        return False
    words = K.pack_key_words(
        [[(c.data, c.valid) for c in cols]],
        [(c.stats.vmin, c.stats.vmax) for c in cols],
    )
    if words is None:
        return False
    big = torch.iinfo(torch.int64).max
    w = torch.where(t.row_mask(), words[0], big)
    ws = w[K.kv_sort_perm(w)]
    return not bool(((ws[1:] == ws[:-1]) & (ws[1:] != big)).any().item())


# ---------------------------------------------------------------------------
# Projection pruning: annotate Scans with the minimal column set (a copy of
# the JAX package's prune_columns)
# ---------------------------------------------------------------------------


def prune_columns(node: P.PlanNode, catalog=None) -> P.PlanNode:
    """Top-down required-column propagation; sets Scan.columns so the IO layer
    only reads/transfers what the query touches (the columnar-format win the
    reference gets from parquet + Spark column pruning)."""

    def expr_refs(e):
        return {c.name for c in E.walk(e) if isinstance(c, E.Col)}

    def visit(n, req):
        if isinstance(n, P.Scan):
            if req is None:
                n.columns = None
            else:
                bare = sorted({r.split(".", 1)[1] for r in req if r.startswith(n.alias + ".")})
                if not bare and catalog is not None:
                    # a pure row-count consumer (e.g. bare count(*)) still
                    # needs one physical column to carry the row count
                    sch = catalog.schema(n.table)
                    if sch is not None:
                        bare = [sch.names[0]]
                n.columns = bare or None
            return
        if isinstance(n, P.Project):
            child_req = set()
            for e, _ in n.items:
                child_req |= expr_refs(e)
            visit(n.child, child_req)
            return
        if isinstance(n, P.Filter):
            if req is None:
                visit(n.child, None)
            else:
                visit(n.child, req | expr_refs(n.predicate))
            return
        if isinstance(n, P.Join):
            extra = set()
            for e in n.left_keys + n.right_keys:
                extra |= expr_refs(e)
            if n.residual is not None:
                extra |= expr_refs(n.residual)
            sub = None if req is None else req | extra
            visit(n.left, sub)
            visit(n.right, sub)
            return
        if isinstance(n, P.MultiJoin):
            extra = set()
            for _, _, le, re_ in n.edges:
                extra |= expr_refs(le) | expr_refs(re_)
            if n.residual is not None:
                extra |= expr_refs(n.residual)
            sub = None if req is None else req | extra
            for r in n.relations:
                visit(r, sub)
            return
        if isinstance(n, P.Aggregate):
            child_req = set()
            for e, _ in n.keys:
                child_req |= expr_refs(e)
            for a, _ in n.aggs:
                if a.arg is not None:
                    child_req |= expr_refs(a.arg)
            visit(n.child, child_req)
            return
        if isinstance(n, P.Window):
            child_req = set() if req is None else set(req)
            for wf, _ in n.fns:
                for c in wf.children():
                    child_req |= expr_refs(c)
            visit(n.child, None if req is None else child_req)
            return
        if isinstance(n, P.Sort):
            child_req = None
            if req is not None:
                child_req = set(req)
                for e, _, _ in n.keys:
                    child_req |= expr_refs(e)
            visit(n.child, child_req)
            return
        if isinstance(n, (P.Limit, P.Distinct)):
            visit(n.child, req)
            return
        if isinstance(n, P.SetOp):
            visit(n.left, None)
            visit(n.right, None)
            return
        if isinstance(n, P.MaterializedScan):
            return
        for c in n.children():
            if c is not None:
                visit(c, None)

    visit(node, None)
    return node
