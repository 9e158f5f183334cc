"""Session: the user-facing entry point of the PyTorch/CUDA SQL engine — the
single-device subset of nds_tpu/engine/session.py.

A Session owns a catalog of named tables (parquet, orc and transcoded csv
datasets read lazily column by column, lakehouse tables pinned to one
snapshot per statement and pruned file by file by their zone maps,
in-memory Arrow tables, or device tables built with `table_from_numpy`),
parses + binds + prunes SQL, executes it, and returns Arrow tables. As
in the JAX package, Filter/Project chains and plain aggregates run fused
(engine/fuse.py; `engine.fuse`, `engine.fuse_agg`), ORDER BY .. LIMIT
gathers only its top k, repeated subtrees and scalar subqueries come from
a cross-statement plan / result cache (`engine.plan_cache`,
`engine.plan_cache_bytes`), MultiJoins replay their recorded join order
(`engine.join_order_cache`), and fused entries and kernel promotion
verdicts persist in an AOT directory (engine/aotcache.py;
`engine.aot_cache_dir` / NDS_AOT_CACHE_DIR), and so do the measured
cardinalities the plan budgeter learns from (analysis/feedback.py;
`engine.plan_feedback`, `engine.feedback_dir`). CREATE / DROP (TEMP) VIEW
registers or drops an Arrow entry;
INSERT, DELETE, CREATE TABLE AS and CALL rollback_to_timestamp run over
lakehouse tables through lakehouse/dml.py (the Data Maintenance phase).

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
as an XLA RESOURCE_EXHAUSTED text). With `engine.verify_plans` the plan
verifier (analysis/verifier.py) re-checks each plan, and with
`engine.lock_debug` every named lock asserts the pinned lock order
(engine/lockdebug.py). Conf keys of the layer not ported yet (the mesh)
raise NotImplementedError rather than being ignored.
`plan_stmt` plans one SELECT and reads its budget verdict under one lock,
for serve/service.py's admission.

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
from time import perf_counter as _perf
from typing import Optional

import torch

from .. import faults
from ..analysis import budget as B
from ..analysis import feedback as FB
from ..schema import (
    Field,
    Schema,
    TABLE_PARTITIONING,
    TABLE_PRIMARY_KEYS,
    get_maintenance_schemas,
    get_schemas,
)
from . import aotcache as AOTC
from . import expr as E
from . import plan as P
from . import spill as SP
from .binder import Binder
from .columnar import (
    Table,
    _infer_dtype,
    table_device_bytes,
    table_from_arrow,
    table_to_arrow,
)
from .exec import Executor
from .lockdebug import make_lock
from .sql import ast as A
from .sql.parser import parse_script, parse_sql


def _mesh_devices_on(conf):
    # read from conf only (nds_tpu/analysis/budget.py session_mesh_devices)
    try:
        return int(conf.get("engine.mesh_devices") or 0) > 0
    except (TypeError, ValueError):
        return False


#: (conf key, environment knob, resolver of conf -> on, the ROADMAP.md item
#: that ports the layer) of layers the port has not ported: a knob that
#: turns its layer on, by the reference's own resolver, raises. The mesh's
#: own tuning knobs (engine.exchange_min_rows, engine.dist_sort_min_rows)
#: act only on a mesh, as in the reference, so they need no entry.
_UNPORTED_KNOBS = (
    ("engine.mesh_devices", None, _mesh_devices_on,
     "queue 1 item 13 (parallel/)"),
)

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


class _PlanResultCache:
    """Byte-budgeted LRU of executed plan subtrees, keyed by structural
    fingerprint (plan.fingerprint): repeated CTE / subquery text reuses its
    device tables ACROSS statements (query14_part1 and _part2 share their
    cross_items / avg_sales CTEs), and scalar subquery values ride along.
    Cleared whenever the catalog changes (any registration, drop or
    invalidation)."""

    def __init__(self, budget_bytes: int):
        from collections import OrderedDict

        self.budget = budget_bytes
        self.map = OrderedDict()  # fp -> (table, nbytes)
        self.nbytes = 0
        self.scalars = {}  # fp -> (value, dtype, dictionary)

    def get(self, fp):
        hit = self.map.get(fp)
        if hit is None:
            return None
        self.map.move_to_end(fp)
        return hit[0]

    def put(self, fp, table):
        if fp in self.map:
            self.map.move_to_end(fp)
            return
        nb = table_device_bytes(table)
        if nb > self.budget:
            return
        self.map[fp] = (table, nb)
        self.nbytes += nb
        while self.nbytes > self.budget and len(self.map) > 1:
            _, (_, old_nb) = self.map.popitem(last=False)
            self.nbytes -= old_nb

    def clear(self):
        self.map.clear()
        self.scalars.clear()
        self.nbytes = 0


class _Entry:
    def __init__(self, schema=None, arrow=None, table=None, path=None,
                 fmt=None):
        self.schema = schema  # Schema or None (infer)
        self.arrow = arrow  # pa.Table (in-memory), or None
        self.table = table  # device Table (register_table), or None
        self.path = path  # dataset directory or lakehouse table, or None
        self.fmt = fmt  # parquet | csv | orc | lakehouse
        self.device_cols = {}  # per-column device cache: name -> Column
        # lakehouse snapshot pin (fmt "lakehouse" only): the manifest
        # version this entry's reads resolve against, the TableSnapshot
        # handle, and the reader lease registered for it
        # (lakehouse/leases.py) so vacuum never deletes pinned files
        self.pinned_version = None
        self.pinned_snapshot = None
        self.lease_id = None
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
        self._use_tick = 0  # nds-guarded-by: none
        # entries whose columns the budget evicted, over the session's life
        # (a statistic: a lost increment only undercounts it)
        self.evictions = 0  # nds-guarded-by: none
        # per thread, the lakehouse names whose pins a DML statement holds
        # for its nested reads (hold_pins)
        self._pin_holds = threading.local()

    @staticmethod
    def _cached_bytes(e) -> int:
        return table_device_bytes(Table(e.device_cols, 0))

    def resident_bytes(self) -> int:
        """Device bytes of every entry's cached columns."""
        return sum(self._cached_bytes(e) for e in self.entries.values())

    def _evict_to_budget(self, keep_name):
        """Drop the least recently used entries' device columns until the
        resident bytes fit DEVICE_BUDGET_BYTES. Only entries with a host
        source (a dataset, a lakehouse table, Arrow) can be dropped: a
        `register_table` table has none and stays resident. A pruned or
        detached lakehouse read never enters the cache, so it is neither
        counted nor evicted here. Routine budget management, not a task
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

    def _dataset(self, e: _Entry, snapshot=None, files=None):
        """The entry's pyarrow dataset. A lakehouse entry reads its pinned
        snapshot (or `snapshot`, the handle a load captured, or else the
        head, resolved once), over `files` where given: a zone-map pruned
        subset of the snapshot's file list (Scan.lake_files), the point
        where pruning becomes skipped IO. Other formats get hive
        partitioning discovery: a fact table written as <date_sk>=<value>/
        directories declares its partition field's type from the table
        schema, so keys round-trip with the right dtype; a transcoded csv
        warehouse parses its columns to the declared types."""
        import pyarrow as pa
        import pyarrow.dataset as pads

        if e.fmt == "lakehouse":
            from ..lakehouse.table import LakehouseTable

            snap = snapshot if snapshot is not None else e.pinned_snapshot
            if snap is None:
                snap = LakehouseTable(e.path).snapshot()
            return snap.dataset(files=files)
        part = "hive"
        fmt = e.fmt
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
            if e.fmt == "csv":
                # transcoded csv warehouse (comma-delimited, with header)
                import pyarrow.csv as pacsv

                fmt = pads.CsvFileFormat(
                    convert_options=pacsv.ConvertOptions(
                        column_types={
                            f.name: f.dtype.to_arrow(use_decimal)
                            for f in e.schema
                            if f.name not in pcols
                        },
                        strings_can_be_null=True,
                    )
                )
        return pads.dataset(e.path, format=fmt, partitioning=part)

    # ---- lakehouse snapshot pins ----------------------------------------
    def pin_lakehouse(self, name, version=None):
        """Resolve (or restore) a lakehouse entry's snapshot pin.

        `version=None` resolves the current head once and pins it, unless
        this thread holds the name (hold_pins: a DML statement froze it for
        its nested reads), which keeps the pin where it is. When the
        pin moves (the table advanced, or a plan carries an explicit older
        pin), every cached device column of the old snapshot is dropped
        first. The pin is registered in the process-wide reader-lease table
        (and, with `engine.lake_catalog=fs`, in the table's catalog), so a
        concurrent vacuum can never delete the pinned snapshot's files.
        Returns the pinned version, or None for other entries."""
        e = self.entries.get(name)
        if e is None or e.fmt != "lakehouse":
            return None
        from ..lakehouse.leases import LEASES, resolve_lease_ttl
        from ..lakehouse.table import LakehouseTable

        held = getattr(self._pin_holds, "names", None)
        if version is None and held and name in held:
            return e.pinned_version
        lt = LakehouseTable(e.path, conf=self.session.conf)
        snap = lt.snapshot(version)
        ttl = resolve_lease_ttl(self.session.conf)
        if e.pinned_version != snap.version:
            # the pin moves: the columns cached from the old snapshot are
            # stale
            self.invalidate(name)
            e.pinned_version = snap.version
            e.pinned_snapshot = snap
            e.lease_id = lt.acquire_reader_lease(snap, ttl)
        else:
            if e.pinned_snapshot is None:
                e.pinned_snapshot = snap
            if e.lease_id is None or not LEASES.renew(e.lease_id, ttl):
                e.lease_id = lt.acquire_reader_lease(snap, ttl)
        return e.pinned_version

    def hold_pins(self, names):
        """A context manager that freezes the named tables' pins for this
        thread: nested statements (a DML's survivor scan, its scalar
        subqueries) keep reading the transaction's snapshot instead of
        re-resolving the head mid-transaction."""
        import contextlib

        holds = self._pin_holds

        @contextlib.contextmanager
        def _hold():
            prev = getattr(holds, "names", None)
            holds.names = frozenset(prev or ()) | {
                str(n).lower() for n in names
            }
            try:
                yield
            finally:
                holds.names = prev

        return _hold()

    def load(self, name, columns=None, lake_version=None,
             lake_files=None) -> Table:
        """Load (a projection of) a table to the device, caching per column
        so repeated queries never re-read or re-upload what is resident.

        `lake_version`: the plan-time snapshot pin this scan reads
        (Scan.lake_version). A plan ahead of the entry's pin moves the pin
        forward; a plan behind it (another statement of a shared session
        advanced the entry) reads its own older snapshot detached, under a
        lease of its own, and never touches the entry's cache.

        `lake_files`: a zone-map pruned subset of the pinned snapshot's
        files (Scan.lake_files). A subset read never touches the entry's
        cache either (cached columns are the full table's): it reads
        exactly those files and serves the plan directly. A pruned scan
        with no columns reads the subset's row count.

        Injection sites `load:<name>` and `<name>` fire first. A device OOM
        while loading (a CUDA OOM, or an error whose text carries
        RESOURCE_EXHAUSTED) drops every cached column through
        `Session.recover_memory` and reloads the requested columns once,
        reporting a task failure to the listeners."""
        e = self.entries.get(name)
        if e is None:
            raise KeyError(f"unknown table {name}")
        if (
            lake_version is not None
            and e.fmt == "lakehouse"
            and e.pinned_version != lake_version
            # forward-only re-pin (see the docstring)
            and (e.pinned_version is None or lake_version > e.pinned_version)
        ):
            self.pin_lakehouse(name, version=lake_version)
        self._use_tick += 1
        e.last_use = self._use_tick
        if columns is None:
            columns = self.schema(name).names
        if faults.active():
            faults.maybe_fire(f"load:{name}")
            faults.maybe_fire(name)
        # the thread-bound tracer wins over the session's: a caller that
        # binds a forwarding tracer around the execution (obs_trace.bind)
        # gets this load's event on its stream
        from ..obs import trace as _obs_trace

        tracer = _obs_trace.current() or getattr(self.session, "tracer", None)
        t0 = _perf() if tracer is not None else 0.0
        if e.table is not None:
            e.device_cols = e.table.columns
            e.nrows = e.table.nrows
        # capture this load's snapshot handle: a concurrent stream re-pinning
        # the shared entry must not swap the manifest (or the column cache)
        # out from under an in-flight read
        snap = e.pinned_snapshot
        subset = e.fmt == "lakehouse" and lake_files is not None
        detached = (
            e.fmt == "lakehouse"
            and lake_version is not None
            and (snap is None or snap.version != lake_version)
        )
        if detached:
            from ..lakehouse.leases import resolve_lease_ttl
            from ..lakehouse.table import LakehouseTable

            lt = LakehouseTable(e.path, conf=self.session.conf)
            snap = lt.snapshot(lake_version)
            # the entry's lease covers the entry's pin, not this version:
            # lease this snapshot before reading it (the TTL ends it)
            lt.acquire_reader_lease(
                snap, resolve_lease_ttl(self.session.conf))
        if subset and not columns:
            # zero-projection pruned scan: the row count of the subset,
            # never the entry's full-table nrows
            ds = self._dataset(e, snapshot=snap, files=list(lake_files))
            return Table({}, ds.count_rows())
        missing = (
            list(columns) if detached or subset
            else [c for c in columns if c not in e.device_cols]
        )
        if missing:

            def _load(cols):
                if e.arrow is not None:
                    arrow = e.arrow.select(cols)
                else:
                    arrow = self._dataset(
                        e, snapshot=snap,
                        files=list(lake_files) if subset else None,
                    ).to_table(columns=cols)
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
            if detached or subset or (
                snap is not None and e.pinned_snapshot is not snap
            ):
                # detached, pruned, or re-pinned by a concurrent stream
                # mid-load: serve this plan's snapshot and leave the cache
                # alone (its columns belong to the entry's pin)
                if set(missing) != set(columns):
                    t = _load(columns)
                if tracer is not None:
                    tracer.emit(
                        "catalog_load", table=name, columns=len(columns),
                        loaded=len(columns), rows=t.nrows,
                        dur_ms=round((_perf() - t0) * 1000.0, 3),
                        cache="miss",
                    )
                return Table({c: t.columns[c] for c in columns}, t.nrows)
            e.nrows = t.nrows
            e.device_cols.update(t.columns)
            self._evict_to_budget(keep_name=name)
        if e.nrows is None:
            e.nrows = 0
        if tracer is not None:
            tracer.emit(
                "catalog_load",
                table=name,
                columns=len(columns),
                loaded=len(missing),
                rows=e.nrows,
                dur_ms=round((_perf() - t0) * 1000.0, 3),
                cache=(
                    "hit" if not missing
                    else "miss" if len(missing) == len(columns)
                    else "partial"
                ),
            )
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

    def renew_lake_leases(self) -> int:
        """Renew every lakehouse entry's reader lease (the report's
        heartbeat calls this while a statement runs), so a statement that
        outlives `engine.lake_lease_ttl_s` never has its pinned snapshot
        vacuumed mid-read. Returns the number renewed. Best-effort: an
        expired lease is left for the next pin_lakehouse to re-acquire."""
        from ..lakehouse.leases import LEASES, resolve_lease_ttl

        ttl = resolve_lease_ttl(self.session.conf)
        renewed = 0
        for e in list(self.entries.values()):
            if e.fmt == "lakehouse" and e.lease_id is not None:
                try:
                    if LEASES.renew(e.lease_id, ttl):
                        renewed += 1
                except Exception:
                    continue  # renewal must never take a query down
        return renewed

    def invalidate(self, name):
        """Clear the session's plan / result and join-order caches, then
        drop an entry's cached columns, row count, PK memo and snapshot
        pin, releasing its reader lease: the next statement re-resolves
        (and re-leases) the head at its own plan time. A DML commit calls
        it (lakehouse/dml.py)."""
        self.session._catalog_changed()
        e = self.entries.get(name)
        if e is None:
            return
        e.device_cols = {}
        e.nrows = None
        e.pk_verified = None
        e.pinned_version = None
        e.pinned_snapshot = None
        if e.lease_id is not None:
            from ..lakehouse.leases import LEASES

            LEASES.release(e.lease_id)
            e.lease_id = None

    def _to_device(self, arrow, e: _Entry):
        return table_from_arrow(arrow, e.schema, with_stats=True,
                                device=self.session.device)


class Result:
    """Executed query result."""

    def __init__(self, session, plan_node):
        self.session = session
        self.plan = plan_node
        self._table = None
        # this execution's executor: its per-statement stats
        # (last_blocked_union, last_spill) read without racing other
        # threads' statements on the session
        self.executor = None

    def table(self, tracer=None) -> Table:
        """Execute (memoized). `tracer` overrides the executor's event
        sink: serve mode passes a per-request forwarding tracer, so every
        op_span and exec_cache event carries the request's id and
        tenant."""
        if self._table is None:
            self.executor = self.session._executor(tracer=tracer)
            self._table = self.executor.execute(self.plan)
            # commit this statement's buffered cardinality records (one
            # merge and write per touched key, not per executed node), so
            # a second run, or another process sharing the store dir,
            # plans from what this one measured
            store = self.session.feedback_store
            if store is not None:
                with self.session.cache_lock:
                    store.flush()
        return self._table

    def collect(self, tracer=None):
        return table_to_arrow(self.table(tracer=tracer))

    def to_pylist(self):
        return self.collect().to_pylist()

    def num_rows(self):
        return self.table().nrows

    def explain(self) -> str:
        return P.explain(self.plan)

    def write(self, path, fmt="parquet", transform=None):
        """Write the result as a single-file dataset directory
        `path/part-0.<fmt>` (parquet or csv), the layout the reference's
        validator reads back. `transform(arrow) -> arrow` hooks a caller's
        step in before the write (the Power Run's column-name
        sanitizer)."""
        import pyarrow.csv as pacsv
        import pyarrow.parquet as pq

        os.makedirs(path, exist_ok=True)
        arrow = self.collect()
        if transform is not None:
            arrow = transform(arrow)
        if fmt == "parquet":
            pq.write_table(arrow, os.path.join(path, "part-0.parquet"))
        elif fmt == "csv":
            pacsv.write_csv(arrow, os.path.join(path, "part-0.csv"))
        else:
            raise ValueError(f"unsupported output format {fmt}")


class Session:
    def __init__(self, use_decimal: bool = True, conf: Optional[dict] = None,
                 device=None):
        self.use_decimal = use_decimal
        self.conf = dict(conf or {})
        for key, env, on, item in _UNPORTED_KNOBS:
            if on(self.conf):
                raise NotImplementedError(
                    f"{key}{f' / {env}' if env else ''} is not ported to "
                    f"nds_tpu_torch yet: ROADMAP.md {item}"
                )
        self.device = resolve_device(device)
        # arm the fault-injection points (conf engine.fault_spec, else
        # NDS_FAULT_SPEC); idempotent for an unchanged spec, so the sessions
        # of one run share one fire budget
        faults.install_from_env(self.conf)
        # observability (obs/trace.py): a trace dir (engine.trace_dir /
        # NDS_TRACE_DIR) gives this session its own events-<appid>.jsonl
        # (rotating at engine.trace_rotate_bytes); a metrics port alone a
        # tracer that feeds the /metrics + /statusz endpoint; neither, the
        # flight recorder's ring-only tracer; engine.flight_recorder=off
        # with neither, None (every event site one `is None` check)
        from ..obs.trace import tracer_from_conf

        self.tracer = tracer_from_conf(self.conf)
        # live telemetry: tracer_from_conf started the process-wide
        # endpoint and attached its MetricsSink to the tracer, so
        # session.metrics and tracer.sink never disagree
        self.metrics = getattr(self.tracer, "sink", None)
        self.catalog = Catalog(self)
        # task-failure observers (report.BenchReport registers one per
        # query)
        self._listeners = []  # nds-guarded-by: cache_lock
        # kernel promotion memo (engine.pallas_*=auto): per (kernel, shape)
        # the measured plain-vs-kernel A/B and the winning route
        self.pallas_promotions = {}
        # one lock guards every session-level cache mutation (plan_cache,
        # exec_cache, join_order_cache, pallas_promotions, feedback_store,
        # the spill pool). Reentrant: the recovery path clears caches from
        # inside already-locked regions
        self.cache_lock = make_lock(
            "Session.cache_lock", self.conf, reentrant=True
        )
        self.plan_cache = _PlanResultCache(  # nds-guarded-by: cache_lock
            int(self.conf.get("engine.plan_cache_bytes", 1 << 30))
        )
        # fused entries (engine/fuse.py): they survive catalog changes on
        # purpose — keyed by stage structure, dtypes and dictionary
        # identity, a stale entry can never be hit, and a power stream's
        # per-query view churn must not evict them
        from .fuse import ExecutableCache

        self.exec_cache = ExecutableCache(  # nds-guarded-by: cache_lock
            int(self.conf.get("engine.exec_cache_entries", 512))
        )
        # MultiJoin greedy-order memo: fingerprint -> recorded join steps
        # (exec._multijoin_greedy); a replay skips the cost scan's row
        # count syncs
        self.join_order_cache = {}  # nds-guarded-by: cache_lock
        # the persistent cache (engine/aotcache.py): fused entries' build
        # products and pins, and the kernel promotion verdicts, shared on
        # disk by every process of the directory. Off with
        # NDS_AOT_CACHE_DIR=0 / engine.aot_cache_dir="".
        self.aot_cache = None
        self.promotion_store = None
        aot_dir = AOTC.resolve_aot_cache_dir(self.conf)
        if aot_dir:
            AOTC.sweep_at_session_start(aot_dir)
            self.promotion_store = AOTC.PromotionStore(aot_dir)
            self.aot_cache = AOTC.AotCache(
                aot_dir, AOTC.resolve_aot_cache_bytes(self.conf, aot_dir),
                self.device, tracer=lambda: self.tracer,
            )
        # estimate-vs-actual cardinality feedback (analysis/feedback.py):
        # persistent (node_fp, scale)-keyed actuals shared across processes
        # and serve replicas. Rides the AOT cache dir by default
        # (<dir>/feedback), so one shared dir shares learned cardinalities
        # as it shares fused entries. Disable with NDS_FEEDBACK_DIR=0 /
        # engine.plan_feedback=off.
        self.feedback_store = None  # nds-guarded-by: cache_lock
        fb_dir = FB.resolve_feedback_dir(self.conf)
        if fb_dir:
            AOTC.sweep_at_session_start(fb_dir)  # same .tmp-<pid> naming
            self.feedback_store = FB.FeedbackStore(
                fb_dir, FB.resolve_feedback_bytes(self.conf, fb_dir)
            )
        # stats of the most recent blocked union aggregation (windows,
        # window rows and cap, total rows, largest table cap), or None
        self.last_blocked_union = None
        # host-RSS watermark pre-emption flag (obs.memwatch -> report.py):
        # the blocked-union window loop polls it between windows and
        # shrinks the remaining windows when set
        self._mem_pressure = False
        # watermark hysteresis latch (report.py): True while the RSS
        # excursion that last fired the watermark is still above it, so one
        # crossing shrinks the window once, not once per query
        self._rss_above_watermark = False
        # the plan budgeter's record of the most recent statement
        # (analysis/budget.py budget_plan: the JAX session's keys)
        self.last_plan_budget = None
        # stats of the most recent statement that took an out-of-core
        # path (ops, partitions, pool bytes in / out, evictions), or None
        self.last_spill = None
        # the host-RAM spill pool, built on first use; session start sweeps
        # the segment files a crashed process left in the spill dir (once
        # per process and directory)
        self._spill_pool = None  # nds-guarded-by: cache_lock
        SP.sweep_at_session_start(SP.resolve_spill_dir(self.conf))
        # (thread id, monotonic seconds) of the last out-of-core partition
        # or run: a watchdog tells a slow spill from a hang by it
        self._progress_ts = None  # nds-guarded-by: none

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
                        app_id=getattr(self.tracer, "app_id", None),
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

    def _catalog_changed(self):
        """Any registration, drop or invalidation: cached plan results
        may now be stale, and a recorded join order may have turned
        pathological — drop them all."""
        with self.cache_lock:
            self.plan_cache.clear()
            self.join_order_cache.clear()

    # ---- registration ----------------------------------------------------
    def register_arrow(self, name, arrow, schema=None):
        self._catalog_changed()
        self.catalog.entries[name.lower()] = _Entry(schema=schema, arrow=arrow)

    def register_parquet(self, name, path, schema=None):
        """A parquet dataset directory (hive-partitioned or not), read
        lazily: each column is read and uploaded on first use."""
        self._catalog_changed()
        self.catalog.entries[name.lower()] = _Entry(
            schema=schema, path=path, fmt="parquet"
        )

    def register_orc(self, name, path, schema=None):
        self._catalog_changed()
        self.catalog.entries[name.lower()] = _Entry(
            schema=schema, path=path, fmt="orc"
        )

    def register_csv_dir(self, name, path, schema):
        """A raw pipe-delimited .dat directory (the generator's layout),
        read whole into Arrow at registration."""
        from ..io.csv import read_dat_dir

        arrow = read_dat_dir(path, schema, self.use_decimal)
        self.register_arrow(name, arrow, schema)

    def register_csv_warehouse(self, name, path, schema):
        """A transcoded csv warehouse directory (comma-delimited part files
        with a header, possibly hive-partitioned), read lazily like
        parquet."""
        self._catalog_changed()
        self.catalog.entries[name.lower()] = _Entry(
            schema=schema, path=path, fmt="csv"
        )

    def register_lakehouse(self, name, path, schema=None):
        """A snapshot-manifest (ACID) table. Registration runs the
        once-per-process crash-hygiene sweep: a crashed writer's staged but
        uncommitted data files and torn manifest temps go before any query
        reads the table."""
        from ..lakehouse.table import sweep_table_at_session_start

        sweep_table_at_session_start(path)
        self._catalog_changed()
        self.catalog.entries[name.lower()] = _Entry(
            schema=schema, path=path, fmt="lakehouse"
        )

    def register_nds_tables(self, data_root, fmt="parquet", maintenance=False):
        """Register every source table (or, with `maintenance`, every
        refresh staging table) found under a warehouse directory (a local
        path or an fsspec URL) in format `fmt`: parquet, orc, csv (a
        transcoded csv warehouse) or lakehouse."""
        import posixpath

        from ..io.fs import get_fs, join as fs_join

        schemas = (
            get_maintenance_schemas(self.use_decimal)
            if maintenance
            else get_schemas(self.use_decimal)
        )
        fs, root = get_fs(data_root)
        if fmt == "lakehouse":
            from ..lakehouse.table import sweep_table_at_session_start
        self._catalog_changed()
        for tname, schema in schemas.items():
            if fs.exists(posixpath.join(root, tname)):
                path = fs_join(data_root, tname)
                if fmt == "lakehouse":
                    sweep_table_at_session_start(path)
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
        self._catalog_changed()
        self.catalog.entries[name.lower()] = _Entry(table=table)

    def drop(self, name):
        self._catalog_changed()
        self.catalog.entries.pop(name.lower(), None)

    # ---- memory recovery -------------------------------------------------
    def recover_memory(self, reason: str = "device OOM"):
        """Drop every recoverable device allocation: the plan / result
        cache, the fused entries (their lookup tables live on the device),
        the join-order memo, and the cached columns of
        every catalog entry with a host source (parquet, Arrow), which the
        next scan reloads. A `register_table` entry has no host source and
        keeps its columns: dropping them would lose the table. Then collect
        garbage (a failed attempt's cycles), return the caching allocator's
        free blocks to the device on a CUDA session (with expandable
        segments a retry would otherwise still see the old reservation),
        and notify the listeners. The report ladder calls it after a device
        OOM mid-execution, and the catalog after one while loading."""
        with self.cache_lock:
            self.plan_cache.clear()
            self.exec_cache.clear()
            self.join_order_cache.clear()
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
    def _executor(self, tracer=None):
        return Executor(self.catalog, self.device, tracer=tracer)

    def _finish_plan(self, plan, promotions=()):
        """The post-bind rewrites: prune scans, pin each lakehouse scan's
        snapshot and prune its files by zone maps (before the budgeter, so
        pruning, budgeting and execution see one manifest version),
        annotate blocked union aggregates, fuse Filter/Project chains and
        plain aggregates into Pipelines (`engine.fuse`, `engine.fuse_agg`),
        then the static plan budgeter.

        With `engine.verify_plans` / NDS_VERIFY_PLANS set (off by default,
        one dict lookup when off) the PlanVerifier re-checks the plan's
        invariants, at the reference's stages: `final` verifies the
        finished plan once, `all` after binding and after each rewrite
        pass. A violation raises PlanVerifyError, which faults.classify
        makes a `planner` failure."""
        level = self.conf.get("engine.verify_plans") or os.environ.get(
            "NDS_VERIFY_PLANS")
        verify = None
        if level and str(level).lower() != "off":
            from ..analysis import verifier as _verifier

            level = _verifier.resolve_level(self.conf)

            def verify(p, stage):
                _verifier.verify_plan(p, self.catalog, stage=stage,
                                      promotions=promotions,
                                      tracer=self.tracer)

        every = verify is not None and level == "all"
        if every:
            verify(plan, "bind")
        plan = prune_columns(plan, self.catalog)
        if every:
            verify(plan, "prune_columns")
        self._pin_lake_scans(plan)
        self._prune_lake_scans(plan)
        P.mark_blocked_union_aggs(plan)
        if every:
            verify(plan, "mark_blocked_union_aggs")
        if self.conf.get("engine.fuse", "on") != "off":
            from .fuse import mark_pipelines

            plan, _ = mark_pipelines(
                plan,
                # a kernel route for aggregates (on / auto) hooks the eager
                # per-aggregate seam, so the aggregate stays a separate
                # node and the segment kernels launch; its feeding chain
                # still fuses
                fuse_aggs=(
                    self.conf.get("engine.fuse_agg", "on") != "off"
                    and self.conf.get("engine.pallas_agg", "off") == "off"
                ),
            )
            if every:
                verify(plan, "mark_pipelines")
        B.budget_plan(plan, self)
        if every:
            verify(plan, "plan_budget")
        if verify is not None and level == "final":
            verify(plan, "final")
        return plan

    def _pin_lake_scans(self, plan):
        """Snapshot-isolate this statement: resolve each lakehouse scan's
        manifest version once at plan time, annotate the Scan nodes with it
        (the executor threads it into catalog.load), and register the pins
        as reader leases. A query that scans a table twice, or re-runs
        after a device-OOM recovery wiped the column cache, reads one
        snapshot even while a concurrent replace or append commits."""
        if not any(
            e.fmt == "lakehouse" for e in self.catalog.entries.values()
        ):
            return plan
        pinned = {}
        for n in P.walk_plan(plan):
            if isinstance(n, P.Scan):
                if n.table not in pinned:
                    pinned[n.table] = self.catalog.pin_lakehouse(n.table)
                if pinned[n.table] is not None:
                    n.lake_version = pinned[n.table]
        return plan

    def _prune_lake_scans(self, plan):
        """Zone-map file pruning: for each Filter directly over a pinned
        lakehouse Scan, evaluate the filter's simple single-column
        conjuncts against the pinned manifest's per-file stats and annotate
        the Scan with the surviving files (Scan.lake_files: the load opens
        only those) and the surviving-row upper bound (Scan.prune_rows:
        the budgeter clamps its scan estimate with it). The filter still
        runs over every surviving row, so a conservative zone map costs
        IO, never correctness. `engine.lake_prune=off` turns it off."""
        if str(self.conf.get("engine.lake_prune", "on")).lower() == "off":
            return plan
        from ..lakehouse.zonemap import prune_files

        for n in P.walk_plan(plan):
            if not (isinstance(n, P.Filter) and isinstance(n.child, P.Scan)):
                continue
            scan = n.child
            if scan.lake_version is None:
                continue
            e = self.catalog.entries.get(scan.table)
            snap = e.pinned_snapshot if e is not None else None
            if snap is None or snap.version != scan.lake_version:
                continue  # detached pin: skip rather than re-resolve
            stats = snap.file_stats()
            if not stats:
                continue  # manifest without stats: nothing known
            preds = _zone_preds(n.predicate, scan.alias)
            if not preds:
                continue
            t0 = _perf()
            keep, pruned_rows = prune_files(snap.rel_files, stats, preds)
            n_total = len(snap.rel_files)
            if len(keep) < n_total:
                scan.lake_files = tuple(keep)
                total = snap.num_rows()
                if total >= 0:
                    scan.prune_rows = max(total - pruned_rows, 0)
            if self.tracer is not None:
                self.tracer.emit(
                    "scan_prune", table=scan.table, files_total=n_total,
                    files_pruned=n_total - len(keep),
                    rows_bound=scan.prune_rows,
                    dur_ms=round((_perf() - t0) * 1000.0, 3),
                )
        return plan

    def sql(self, text: str) -> Result:
        return self.run_stmt(parse_sql(text))

    def plan_stmt(self, stmt):
        """Plan one parsed SELECT atomically with respect to every other
        planner of this session: `(Result, plan-budget record)`.

        Serve mode's admission needs the budgeter's verdict of this
        statement, and `last_plan_budget` is one field of a session that
        concurrent tenants share: planning and reading the verdict are one
        critical section under `cache_lock`. Execution stays outside it. A
        `reject` verdict raises PlanBudgetError from here, before anything
        runs (serve's 429)."""
        if not isinstance(stmt, A.SelectStmt):
            raise ValueError(
                f"plan_stmt wants a SELECT, got {type(stmt).__name__}"
            )
        with self.cache_lock:
            res = self.run_stmt(stmt)
            rec = self.last_plan_budget
            return res, (dict(rec) if isinstance(rec, dict) else None)

    def run_script(self, text: str) -> Optional[Result]:
        """Run every statement of a script; the last one's result."""
        out = None
        for stmt in parse_script(text):
            out = self.run_stmt(stmt)
        return out

    def run_stmt(self, stmt):
        """Run one parsed statement: a SELECT's Result; None for CREATE /
        DROP VIEW (the view is materialised to Arrow at creation); a
        lakehouse/dml.py DmlResult for INSERT, DELETE, CREATE TABLE AS and
        CALL."""
        if isinstance(stmt, A.SelectStmt):
            binder = Binder(self.catalog)
            plan = self._finish_plan(binder.bind(stmt), binder.promotions)
            if self.tracer is not None:
                # flight-recorder context: this statement's plan, so that a
                # failure bundle carries the failing query's plan. Noted as
                # a lazy thunk: P.explain renders only if a bundle flushes
                from ..obs import flight as _obs_flight

                rec = _obs_flight.recorder(self.conf)
                if rec is not None:
                    rec.note_plan(
                        faults.current_scope(),
                        lambda p=plan: P.explain(p),
                    )
            return Result(self, plan)
        if isinstance(stmt, A.CreateViewStmt):
            binder = Binder(self.catalog)
            plan = self._finish_plan(
                binder.bind(stmt.query), binder.promotions
            )
            self.register_arrow(stmt.name, Result(self, plan).collect())
            return None
        if isinstance(stmt, A.DropViewStmt):
            self.drop(stmt.name)
            return None
        if isinstance(stmt, (A.InsertStmt, A.DeleteStmt, A.CreateTableStmt,
                             A.CallStmt)):
            from ..lakehouse.dml import run_dml

            return run_dml(self, stmt)
        raise TypeError(f"unsupported statement {type(stmt).__name__}")


# ---------------------------------------------------------------------------
# Zone-map pruning: the prunable conjuncts of a scan's filter
# ---------------------------------------------------------------------------

#: the mirror of each comparison (a literal-on-left comparison flips);
#: never mutated
_ZONE_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}  # nds-lint: disable=mutable-module-global


def _zone_preds(pred, alias):
    """Reduce a filter predicate to the conjuncts zone maps can act on, as
    the plain tuples lakehouse/zonemap.py evaluates: column-vs-literal
    comparisons, BETWEEN, IN lists and IS NOT NULL over this scan's
    columns. Anything else (OR trees, expressions over the column, NULL
    literals, negated forms) is not extracted: less pruning, never wrong
    pruning."""
    prefix = alias + "."
    out = []

    def col(e):
        if isinstance(e, E.Col) and e.name.startswith(prefix):
            return e.name.split(".", 1)[1]
        return None

    def lit(e):
        if isinstance(e, E.Lit) and e.value is not None:
            return e.value
        return None

    def walk(e):
        if isinstance(e, E.BinOp):
            if e.op == "and":
                walk(e.left)
                walk(e.right)
                return
            if e.op in _ZONE_FLIP:
                c, v = col(e.left), lit(e.right)
                if c is not None and v is not None:
                    out.append(("cmp", c, e.op, v))
                    return
                c, v = col(e.right), lit(e.left)
                if c is not None and v is not None:
                    out.append(("cmp", c, _ZONE_FLIP[e.op], v))
            return
        if isinstance(e, E.Between) and not e.negated:
            c = col(e.operand)
            lo, hi = lit(e.low), lit(e.high)
            if c is not None and lo is not None and hi is not None:
                out.append(("between", c, lo, hi))
            return
        if isinstance(e, E.InList) and not e.negated and e.values:
            c = col(e.operand)
            if c is not None:
                vals = tuple(lit(v) for v in e.values)
                if all(v is not None for v in vals):
                    out.append(("in", c, vals))
            return
        if isinstance(e, E.UnaryOp) and e.op == "isnotnull":
            c = col(e.operand)
            if c is not None:
                out.append(("notnull", c))

    walk(pred)
    return out



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
