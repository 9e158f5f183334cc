"""Session: the user-facing entry point of the PyTorch/CUDA SQL engine — the
single-device subset of nds_tpu/engine/session.py.

A Session owns a catalog of named tables (parquet datasets read lazily
column by column, in-memory Arrow tables, or device tables built with
`table_from_numpy`), parses + binds + prunes SQL, executes it with the
unfused operator path (whatever `engine.fuse` says: fusion is not ported),
and returns Arrow tables.

It runs on the card unless the caller asks for the CPU: `device=None`
resolves to `cuda` and raises when no GPU is present; nothing moves to the
CPU on its own. The conf keys keep the JAX package's names, defaults and
meanings (`engine.pallas_agg`, `engine.pallas_join`, `engine.pallas_sort`:
off | on | auto, default off). Every statement goes through the static plan
budgeter (analysis/budget.py) on the device's own budget lines, and the
executor's out-of-core paths stage through the session's host-RAM spill
pool (engine/spill.py; `engine.spill` = off | auto | force). The failure
domain of the Power Run's harness is the reference's: fault injection
(`engine.fault_spec` / NDS_FAULT_SPEC, faults.py), `recover_memory` and
the task-failure listeners that report.py's degradation ladder drives,
and the catalog's load-time retry after a device OOM (a CUDA OOM as well
as an XLA RESOURCE_EXHAUSTED text). Conf keys and environment knobs of
layers not ported yet (tracing, metrics, plan verification, the host-RSS
watermark, cardinality feedback) raise NotImplementedError rather than
being ignored.

A CUDA session needs the caching allocator's expandable segments (the
SF100 working sets leave little room for fragmentation): the first one
sets PYTORCH_CUDA_ALLOC_CONF before torch's first CUDA allocation, and a
session refuses to start on a CUDA runtime already initialised without it.
"""

from __future__ import annotations

import gc
import os
import threading
from time import monotonic as _monotonic
from typing import Optional

import torch

from .. import faults
from ..io.fs import local_path
from ..analysis import budget as B
from ..schema import (
    Field,
    Schema,
    TABLE_PARTITIONING,
    TABLE_PRIMARY_KEYS,
    get_schemas,
)
from . import expr as E
from . import plan as P
from . import spill as SP
from .binder import Binder
from .columnar import Table, _infer_dtype, table_from_arrow, table_to_arrow
from .exec import Executor
from .sql import ast as A
from .sql.parser import parse_script, parse_sql

#: (conf key, environment knob, values that leave the layer off) of layers
#: the port has not ported, with the ROADMAP.md item that ports them. "0" is
#: off only for the watermark: a metrics port of 0 binds an ephemeral port,
#: and a trace_dir of 0 names a directory.
_UNPORTED_KNOBS = (
    ("engine.trace_dir", "NDS_TRACE_DIR", ("off",),
     "queue 1 item 12 (serve/obs)"),
    ("engine.metrics_port", "NDS_METRICS_PORT", ("off",),
     "queue 1 item 12 (serve/obs)"),
    # the watermark's sampler is obs/memwatch
    ("engine.host_rss_watermark", "NDS_HOST_RSS_WATERMARK", ("off", "0"),
     "queue 1 item 12 (serve/obs)"),
    ("engine.verify_plans", "NDS_VERIFY_PLANS", ("off",),
     "queue 1 item 9 (harness entry points)"),
)

_ITEM9 = "ROADMAP.md queue 1 item 9 (harness entry points)"


_ALLOC_CONF = "PYTORCH_CUDA_ALLOC_CONF"


def ensure_expandable_segments():
    """Make `expandable_segments:True` hold for torch's CUDA caching
    allocator: set it in PYTORCH_CUDA_ALLOC_CONF while CUDA is not yet
    initialised (the allocator reads it at initialisation), and raise when
    CUDA already runs without it, or when the variable asks against it.
    The port's SF100 queries peak within about 10 GiB of an 80 GB card
    (PERF.md), where segments that grow in place keep fragmentation from
    failing an allocation."""
    conf = os.environ.get(_ALLOC_CONF, "")
    opts = dict(
        kv.split(":", 1) for kv in conf.split(",") if kv.count(":") == 1
    )
    if opts.get("expandable_segments") == "True":
        return
    if "expandable_segments" in opts or torch.cuda.is_initialized():
        raise RuntimeError(
            f"nds_tpu_torch needs {_ALLOC_CONF} to hold "
            f"expandable_segments:True before CUDA starts; it is {conf!r}"
            f" and CUDA is {'' if torch.cuda.is_initialized() else 'not '}"
            f"initialised: create the first CUDA Session, or call "
            f"resolve_device(), before any other CUDA work"
        )
    os.environ[_ALLOC_CONF] = ",".join(
        ([conf] if conf else []) + ["expandable_segments:True"]
    )


def resolve_device(device=None) -> torch.device:
    """`device` as given, or `cuda` when None. Raises when CUDA is asked
    for (explicitly or by default) and no GPU is present. For CUDA it makes
    the allocator's expandable segments hold (ensure_expandable_segments)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "nds_tpu_torch runs on a CUDA GPU and none is available; "
                "pass device='cpu' to run the engine's plain PyTorch path "
                "on the CPU"
            )
        ensure_expandable_segments()
    return dev


class _Entry:
    def __init__(self, schema=None, arrow=None, table=None, path=None,
                 fmt=None):
        self.schema = schema  # Schema or None (infer)
        self.arrow = arrow  # pa.Table (in-memory), or None
        self.table = table  # device Table (register_table), or None
        self.path = path  # dataset directory (fmt "parquet"), or None
        self.fmt = fmt
        self.device_cols = {}  # per-column device cache: name -> Column
        self.nrows = None
        self.pk_verified = None  # declared-PK verification memo
        # the budgeter's metadata row count of a dataset (-1: probe failed)
        self.budget_est_rows = None
        self.last_use = 0  # recency tick of the residency LRU


class Catalog:
    def __init__(self, session):
        self.session = session
        self.entries = {}  # name -> _Entry
        # the catalog's device residency budget (NDS_CATALOG_BUDGET_BYTES,
        # else the device's line: analysis/budget.py budget_lines): loads
        # past it evict the least recently used entries' columns, and the
        # blocked union windows are sized against it
        self.DEVICE_BUDGET_BYTES = B.resolve_catalog_bytes(session.device)
        # recency tick of the residency LRU (a lost increment only perturbs
        # the eviction order)
        self._use_tick = 0
        # entries whose columns the budget evicted, over the session's life
        self.evictions = 0

    @staticmethod
    def _cached_bytes(e) -> int:
        total = 0
        for c in e.device_cols.values():
            total += int(c.data.nbytes)
            if c.valid is not None:
                total += int(c.valid.nbytes)
        return total

    def resident_bytes(self) -> int:
        """Device bytes of every entry's cached columns."""
        return sum(self._cached_bytes(e) for e in self.entries.values())

    def _evict_to_budget(self, keep_name):
        """Drop the least recently used entries' device columns until the
        resident bytes fit DEVICE_BUDGET_BYTES. Only entries with a host
        source (parquet, Arrow) can be dropped: a `register_table` table
        has none and stays resident. Routine budget management, not a task
        failure: it does not reach the listeners."""
        total = self.resident_bytes()
        if total <= self.DEVICE_BUDGET_BYTES:
            return
        victims = sorted(
            (
                (name, e)
                for name, e in self.entries.items()
                if name != keep_name and e.device_cols and e.table is None
            ),
            key=lambda kv: kv[1].last_use,
        )
        for name, e in victims:
            total -= self._cached_bytes(e)
            e.device_cols = {}
            self.evictions += 1
            print(f"catalog: evicted device columns of {name!r} (budget)")
            if total <= self.DEVICE_BUDGET_BYTES:
                return

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
        at = e.arrow.schema if e.arrow is not None else self._dataset(e).schema
        return Schema(tuple(Field(f.name, _infer_dtype(f.type)) for f in at))

    def _dataset(self, e: _Entry):
        """The entry's pyarrow dataset, with hive partitioning discovery:
        a fact table written as <date_sk>=<value>/ directories declares its
        partition field's type from the table schema, so keys round-trip
        with the right dtype."""
        import pyarrow as pa
        import pyarrow.dataset as pads

        part = "hive"
        if e.schema is not None:
            use_decimal = self.session.use_decimal
            names = {f.name for f in e.schema}
            pcols = [c for c in TABLE_PARTITIONING.values() if c in names]
            if pcols:
                part = pads.partitioning(
                    pa.schema([
                        (c, e.schema.field(c).dtype.to_arrow(use_decimal))
                        for c in pcols
                    ]),
                    flavor="hive",
                )
        return pads.dataset(e.path, format=e.fmt, partitioning=part)

    def load(self, name, columns=None) -> Table:
        """Load (a projection of) a table to the device, caching per column
        so repeated queries never re-read or re-upload what is resident.

        Injection sites `load:<name>` and `<name>` fire first. A device OOM
        while loading (a CUDA OOM, or an error whose text carries
        RESOURCE_EXHAUSTED) drops every cached column through
        `Session.recover_memory` and reloads the requested columns once,
        reporting a task failure to the listeners."""
        e = self.entries.get(name)
        if e is None:
            raise KeyError(f"unknown table {name}")
        self._use_tick += 1
        e.last_use = self._use_tick
        if columns is None:
            columns = self.schema(name).names
        if faults.active():
            faults.maybe_fire(f"load:{name}")
            faults.maybe_fire(name)
        if e.table is not None:
            e.device_cols = e.table.columns
            e.nrows = e.table.nrows
        missing = [c for c in columns if c not in e.device_cols]
        if missing:

            def _load(cols):
                if e.arrow is not None:
                    arrow = e.arrow.select(cols)
                else:
                    arrow = self._dataset(e).to_table(columns=cols)
                return self._to_device(arrow, e)

            t = None
            try:
                t = _load(missing)
            except Exception as exc:
                if faults.classify(exc) != faults.DEVICE_OOM:
                    raise
            # the retry runs outside the handler, so no live traceback
            # pins the failed load's partial device columns
            if t is None:
                self.session.recover_memory(
                    f"device memory exhausted loading {name!r}")
                # the wipe dropped this entry's columns too: reload the
                # whole requested set
                t = _load(columns)
                self.session.notify_failure(
                    f"task retry: device memory exhausted loading {name!r}; "
                    f"dropped cached tables and reloaded"
                )
            e.nrows = t.nrows
            e.device_cols.update(t.columns)
            self._evict_to_budget(keep_name=name)
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

    def write(self, path, fmt="parquet", transform=None):
        """Write the result as a single-file dataset directory
        `path/part-0.parquet`, the layout the reference's validator reads
        back. `transform(arrow) -> arrow` hooks a caller's step in before
        the write (the Power Run's column-name sanitizer)."""
        if fmt != "parquet":
            raise NotImplementedError(
                f"output format {fmt!r} is not ported to nds_tpu_torch yet "
                f"(parquet is): {_ITEM9}"
            )
        import pyarrow.parquet as pq

        os.makedirs(path, exist_ok=True)
        arrow = self.collect()
        if transform is not None:
            arrow = transform(arrow)
        pq.write_table(arrow, os.path.join(path, "part-0.parquet"))


class Session:
    def __init__(self, use_decimal: bool = True, conf: Optional[dict] = None,
                 device=None):
        self.use_decimal = use_decimal
        self.conf = dict(conf or {})
        for key, env, off, item in _UNPORTED_KNOBS:
            v = self.conf.get(key) or os.environ.get(env)
            if v and str(v).lower() not in off:
                raise NotImplementedError(
                    f"{key} / {env} is not ported to nds_tpu_torch yet: "
                    f"ROADMAP.md {item}"
                )
        fb = self.conf.get("engine.plan_feedback") or os.environ.get(
            "NDS_PLAN_FEEDBACK")
        if fb and str(fb).lower() == "on":
            # `record` and `off` are accepted: nothing is recorded yet
            raise NotImplementedError(
                "engine.plan_feedback=on / NDS_PLAN_FEEDBACK is not ported "
                "to nds_tpu_torch yet: ROADMAP.md queue 1 item 14 "
                "(cardinality feedback)"
            )
        self.device = resolve_device(device)
        # arm the fault-injection points (conf engine.fault_spec, else
        # NDS_FAULT_SPEC); idempotent for an unchanged spec, so the sessions
        # of one run share one fire budget
        faults.install_from_env(self.conf)
        self.catalog = Catalog(self)
        # task-failure observers (report.BenchReport registers one per
        # query)
        self._listeners = []
        # kernel promotion memo (engine.pallas_*=auto): per (kernel, shape)
        # the measured plain-vs-kernel A/B and the winning route
        self.pallas_promotions = {}
        self.cache_lock = threading.RLock()
        # stats of the most recent blocked union aggregation (windows,
        # window rows and cap, total rows, largest table cap), or None
        self.last_blocked_union = None
        # the plan budgeter's record of the most recent statement
        # (analysis/budget.py budget_plan: the JAX session's keys)
        self.last_plan_budget = None
        # stats of the most recent statement that took an out-of-core
        # path (ops, partitions, pool bytes in / out, evictions), or None
        self.last_spill = None
        # the host-RAM spill pool, built on first use; session start sweeps
        # the segment files a crashed process left in the spill dir (once
        # per process and directory)
        self._spill_pool = None
        SP.sweep_at_session_start(SP.resolve_spill_dir(self.conf))
        # (thread id, monotonic seconds) of the last out-of-core partition
        # or run: a watchdog tells a slow spill from a hang by it
        self._progress_ts = None

    @property
    def spill_pool(self) -> SP.SpillPool:
        """The session's host-RAM spill pool, built on first use. Knobs:
        `engine.spill_pool_bytes` / NDS_SPILL_POOL_BYTES (the host budget
        before segments tier to disk), `engine.spill_dir` / NDS_SPILL_DIR
        (the disk tier; "" disables it)."""
        if self._spill_pool is None:
            with self.cache_lock:
                if self._spill_pool is None:
                    self._spill_pool = SP.SpillPool(
                        budget_bytes=SP.resolve_pool_bytes(self.conf),
                        spill_dir=SP.resolve_spill_dir(self.conf),
                    )
        return self._spill_pool

    def spill_progress(self):
        """Stamp out-of-core progress (the executor's spill paths call it
        per partition or run), with the calling thread's identity."""
        self._progress_ts = (threading.get_ident(), _monotonic())

    def union_agg_window_rows(self, row_bytes: int,
                              static_rows: Optional[int] = None) -> int:
        """Rows per window of blocked union aggregation, resolved as the
        JAX session does: `engine.union_agg_window_rows`, then the
        NDS_UNION_AGG_WINDOW_ROWS knob, then `static_rows` (the plan
        budgeter's `budget_window_rows` annotation), else
        budget.default_window_rows against the catalog's device budget."""
        v = self.conf.get("engine.union_agg_window_rows") or os.environ.get(
            "NDS_UNION_AGG_WINDOW_ROWS"
        )
        if v:
            return max(int(v), 1)
        if static_rows:
            return max(int(static_rows), 1)
        return B.default_window_rows(row_bytes,
                                     self.catalog.DEVICE_BUDGET_BYTES)

    # ---- registration ----------------------------------------------------
    def register_arrow(self, name, arrow, schema=None):
        self.catalog.entries[name.lower()] = _Entry(schema=schema, arrow=arrow)

    def register_parquet(self, name, path, schema=None):
        """A parquet dataset directory (hive-partitioned or not), read
        lazily: each column is read and uploaded on first use."""
        self.catalog.entries[name.lower()] = _Entry(
            schema=schema, path=local_path(path), fmt="parquet"
        )

    def register_nds_tables(self, data_root, fmt="parquet"):
        """Register every source table found under a warehouse
        directory."""
        if fmt != "parquet":
            raise NotImplementedError(
                f"input format {fmt!r} is not ported to nds_tpu_torch yet "
                f"(parquet is): {_ITEM9}"
            )
        root = local_path(data_root)
        for tname, schema in get_schemas(self.use_decimal).items():
            path = os.path.join(root, tname)
            if os.path.exists(path):
                self.catalog.entries[tname] = _Entry(
                    schema=schema, path=path, fmt=fmt
                )

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

    # ---- memory recovery -------------------------------------------------
    def recover_memory(self, reason: str = "device OOM"):
        """Drop every recoverable device allocation: the cached columns of
        every catalog entry with a host source (parquet, Arrow), which the
        next scan reloads. A `register_table` entry has no host source and
        keeps its columns: dropping them would lose the table. Then collect
        garbage (a failed attempt's cycles), return the caching allocator's
        free blocks to the device on a CUDA session (with expandable
        segments a retry would otherwise still see the old reservation),
        and notify the listeners. The report ladder calls it after a device
        OOM mid-execution, and the catalog after one while loading."""
        for e in self.catalog.entries.values():
            if e.table is None:
                e.device_cols = {}
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.notify_failure(f"task retry: {reason}; dropped device caches")

    # ---- listeners (reference: python_listener/PythonListener.py) --------
    def register_listener(self, cb):
        with self.cache_lock:
            self._listeners.append(cb)

    def unregister_listener(self, cb):
        with self.cache_lock:
            try:
                self._listeners.remove(cb)
            except ValueError:
                pass

    def notify_failure(self, reason: str):
        """Fan a recoverable task-failure event out to the listeners."""
        with self.cache_lock:
            listeners = list(self._listeners)
        for cb in listeners:
            cb(reason)

    # ---- SQL -------------------------------------------------------------
    def _executor(self):
        return Executor(self.catalog, self.device)

    def sql(self, text: str) -> Result:
        return self.run_stmt(parse_sql(text))

    def run_script(self, text: str) -> Optional[Result]:
        """Run every statement of a script; the last one's result."""
        out = None
        for stmt in parse_script(text):
            out = self.run_stmt(stmt)
        return out

    def run_stmt(self, stmt) -> Optional[Result]:
        if isinstance(stmt, A.SelectStmt):
            binder = Binder(self.catalog)
            plan = prune_columns(binder.bind(stmt), self.catalog)
            P.mark_blocked_union_aggs(plan)
            B.budget_plan(plan, self)
            return Result(self, plan)
        raise NotImplementedError(
            f"{type(stmt).__name__} is not ported to nds_tpu_torch yet: "
            f"{_ITEM9}"
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
