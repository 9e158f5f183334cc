"""Snapshot-manifest table layer: the Iceberg/Delta-equivalent ACID
surface; the port of nds_tpu/lakehouse/table.py. The on-disk format (data
files, manifests, zone maps, the ingest ledger, catalog state) is the
reference's, so either package reads the other's tables. pyarrow is
imported inside the functions that use it. A publish attempt's outcome
and a vacuum emit `lake_commit` and `lake_vacuum` into the thread-bound
tracer.

The reference runs Data Maintenance against Iceberg or Delta Lake warehouses
(reference: nds/nds_maintenance.py:118-202, nds/nds_rollback.py:46-51). The
engine needs the same capabilities — atomic INSERT/DELETE, snapshot
history, timestamp rollback — without a JVM catalog service. This layer
provides them with immutable parquet data files plus a JSON manifest log:

    <table>/
      data/part-<pid>-<n>.parquet          (immutable)
      _manifests/v000001.json ...          (one per snapshot)

A snapshot lists the data files that constitute the table at that version.
Writers stage data files first, then commit by publishing the next manifest
(create-exclusive), so readers always see a consistent snapshot. Rollback
appends a new manifest replaying an older file list — history is never
rewritten, matching Iceberg's rollback_to_timestamp semantics.

Fleet concurrency: with `engine.lake_catalog` configured the publish,
reader-lease registration, and vacuum fence route through the catalog
service (lakehouse/catalog.py: fs CAS, or the tcp coordinator), giving
multi-HOST writers commit arbitration, cross-host lease visibility, and
epoch fencing (a stale zombie writer can never publish). Off by default:
everything below then describes the process-concurrent behavior exactly.

Concurrency (the Iceberg optimistic-concurrency model, in-process scale):

* **Snapshot-isolated reads** — `snapshot(version)` returns a TableSnapshot
  read handle resolved ONCE; every read through it (dataset/schema/files)
  sees exactly that manifest, immune to racing commits. The engine pins one
  snapshot per query at plan time (engine/session.py) and registers the pin
  in the process-wide reader-lease table (lakehouse/leases.py) so vacuum
  can never delete a file under a live reader.
* **OCC commit with rebase** — `_commit` claims the next version with a
  create-exclusive publish. A loser whose transaction is append-only
  (base = current head) REBASES: it re-reads the new head and retries with
  the new base file list (bounded by `engine.lake_commit_retries`, jittered
  backoff), so append/append conflicts converge with both row sets present.
  A loser that replaces the file set (overwrite/delete/rollback/create)
  aborts with CommitConflictError — its writes were derived from a snapshot
  that is no longer the head — and the report ladder's `commit_rebase_retry`
  rung re-runs the whole transaction against the fresh snapshot.
* **Vacuum + crash hygiene** — `expire_snapshots` drops old manifests
  (never the head, never a leased version); `vacuum` deletes data files
  referenced by no retained manifest, no live reader lease, and no live
  writer's in-flight stage. Staged files and manifest temps embed the
  writer pid, so `sweep_orphans` (run once per process at session start)
  can remove a crashed writer's staged-but-uncommitted files and torn
  `.tmp-*` manifests without ever touching a live or foreign file — the
  same pid-manifest pattern as engine/spill.py's pool sweep.

Failure domain: `stage:<table>`, `manifest:<table>` and `vacuum:<table>`
are io/crash fault-injection sites, and `commit:<table>` fires before the
manifest publish (a crash there leaves staged orphans but a fully readable
previous snapshot — the all-or-nothing guarantee).

All IO routes through the filesystem seam (io/fs.py), so a table may live
on a local path, memory:// (tests), or any fsspec URL — the reference reaches
HDFS/S3/GS in every phase and a multi-host run needs a shared warehouse.
"""

from __future__ import annotations

import json
import os
import posixpath
import re
import time
import uuid

from ..io.fs import arrow_filesystem, get_fs, put_if_absent
from .catalog import CatalogFencedError, resolve_catalog, resolve_writer_ttl
from .leases import LEASES
from .zonemap import StatsAccumulator

_MANIFEST_DIR = "_manifests"
_DATA_DIR = "data"

#: staged data files / manifest temps embed the writer pid so crash
#: hygiene can liveness-check the owner (spill.py's pid-manifest pattern);
#: with a catalog configured they ALSO embed the writer's fencing epoch
#: (`part-<pid>-e<epoch>-<hex>.parquet`) so vacuum can attribute stages
#: across hosts without pids. Pre-existing tables' `part-<hex>.parquet`
#: files still read fine through their manifests — the sweep just never
#: attributes (or touches) them
_STAGED_RE = re.compile(r"^part-(\d+)(?:-e(\d+))?-[0-9a-f]{12}\.parquet$")
_TMP_MANIFEST_RE = re.compile(r"^\.tmp-(\d+)-[0-9a-f]+\.json$")
_DATA_FILE_RE = re.compile(r"^part-[0-9a-f-]+\.parquet$")

#: bounded rebase budget for append/append commit conflicts
#: (conf `engine.lake_commit_retries` / env NDS_LAKE_COMMIT_RETRIES)
DEFAULT_COMMIT_RETRIES = 5

#: backoff base (seconds) between rebase attempts — full jitter via
#: faults.backoff_delays; 0 makes tests deterministic
COMMIT_BACKOFF_ENV = "NDS_LAKE_COMMIT_BACKOFF"

#: test seam for the interleaving harness: when set, called as
#: hook(table_basename, operation, version) right before every publish
#: attempt — deterministic schedule control over commit points (barriers
#: force two writers onto one version, or land a commit between a pinned
#: reader's two scans). None in production: one attribute check per commit.
_COMMIT_HOOK = None


class LakehouseError(Exception):
    pass


class CommitConflictError(LakehouseError):
    """An optimistic commit lost the publish race and could not (or must
    not) be rebased. Classified `commit_conflict` (faults._COMMIT_PAT):
    the transaction never published, so re-running it against the fresh
    head is safe — the report ladder's `commit_rebase_retry` rung does
    exactly that with jittered backoff."""


class _ChunkAlreadyIngested(LakehouseError):
    """Internal commit-point signal: every chunk id this transaction
    carries is already in the head's ingest ledger, so publishing would
    duplicate rows. Carries the head version; callers discard their
    staged files and treat the chunk as done (exactly-once)."""

    def __init__(self, version: int):
        super().__init__(f"chunk already ingested at v{version}")
        self.version = int(version)


def resolve_commit_retries(conf: dict | None = None) -> int:
    v = None
    if conf:
        v = conf.get("engine.lake_commit_retries")
    if v is None:
        v = os.environ.get("NDS_LAKE_COMMIT_RETRIES")
    try:
        return max(int(v), 0) if v is not None and v != "" else (
            DEFAULT_COMMIT_RETRIES
        )
    except (TypeError, ValueError):
        return DEFAULT_COMMIT_RETRIES


def commit_backoff_base() -> float:
    """Jittered-backoff base seconds for commit-conflict retries — the ONE
    parse shared by the in-table rebase loop, the report ladder's
    `commit_rebase_retry` rung, and maintenance's statement-level re-run."""
    try:
        return max(float(os.environ.get(COMMIT_BACKOFF_ENV, "0.05")), 0.0)
    except ValueError:
        return 0.05


def resolve_compact_target_bytes(conf: dict | None = None) -> int:
    """Compaction size goal: files below this are rewrite candidates and
    groups are packed up to roughly this size (conf
    `engine.lake_compact_target_bytes` / env
    NDS_LAKE_COMPACT_TARGET_BYTES, default 128 MiB)."""
    v = None
    if conf:
        v = conf.get("engine.lake_compact_target_bytes")
    if v is None:
        v = os.environ.get("NDS_LAKE_COMPACT_TARGET_BYTES")
    try:
        return max(int(v), 1) if v not in (None, "") else 128 << 20
    except (TypeError, ValueError):
        return 128 << 20


def resolve_compact_min_files(conf: dict | None = None) -> int:
    """Minimum small-file count before a compaction rewrite is worth a
    commit (conf `engine.lake_compact_min_files` / env
    NDS_LAKE_COMPACT_MIN_FILES, default 4)."""
    v = None
    if conf:
        v = conf.get("engine.lake_compact_min_files")
    if v is None:
        v = os.environ.get("NDS_LAKE_COMPACT_MIN_FILES")
    try:
        return max(int(v), 2) if v not in (None, "") else 4
    except (TypeError, ValueError):
        return 4


def resolve_conflict_retries() -> int:
    """How many times an aborted overwrite TRANSACTION may re-run (env
    NDS_LAKE_CONFLICT_RETRIES, default 2) — shared by the report ladder
    and maintenance's statement-level retry (the rebase loop inside
    `_commit` has its own budget, resolve_commit_retries)."""
    try:
        return max(
            int(os.environ.get("NDS_LAKE_CONFLICT_RETRIES", "2")), 0
        )
    except ValueError:
        return 2


def _tracer():
    # lazy import: the thread-local binding is how session-less layers find
    # their stream's tracer (as faults.FaultRegistry.fire does)
    from ..obs import trace as _obs_trace

    return _obs_trace.current()


class TableSnapshot:
    """Immutable read handle pinned at one manifest version. Every read
    resolves against the captured manifest — never the (possibly moved)
    table head — which is what makes a query scanning a table twice
    mid-`replace()` see ONE consistent snapshot."""

    def __init__(self, table: "LakehouseTable", manifest: dict):
        self.table = table
        self.manifest = manifest
        self.version = int(manifest["version"])
        self.timestamp_ms = int(manifest["timestamp_ms"])
        self.operation = manifest.get("operation")

    @property
    def rel_files(self):
        """Manifest-relative data file paths (the lease currency)."""
        return list(self.manifest["files"])

    def files(self):
        return [
            posixpath.join(self.table.root, f) for f in self.manifest["files"]
        ]

    def num_rows(self) -> int:
        return self.manifest.get("num_rows", -1)

    def schema(self) -> pa.Schema | None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        files = self.files()
        if files:
            with self.table.fs.open(files[0], "rb") as fh:
                return pq.read_schema(fh)
        if self.manifest.get("schema_hex"):
            # an all-rows DELETE leaves zero data files; the manifest still
            # carries the schema so the table stays readable
            import pyarrow.ipc as ipc

            return ipc.read_schema(
                pa.BufferReader(bytes.fromhex(self.manifest["schema_hex"]))
            )
        return None

    def file_stats(self) -> dict:
        """Per-file zone maps recorded at commit time:
        {relpath: {"rows": n, "columns": {col: {"min","max","nulls"}}}}.
        Empty for manifests written before the stats schema (back-compat:
        a file absent from stats is simply never pruned)."""
        return self.manifest.get("stats") or {}

    def ingest_chunks(self) -> set:
        """Chunk ids the ingest ledger records as committed — the
        exactly-once resume checkpoint (see LakehouseTable.ingest_chunk)."""
        return set(self.manifest.get("ingest_chunks") or [])

    def dataset(self, files=None) -> pads.Dataset:
        """Dataset over the snapshot's files — or, with `files` (an
        iterable of manifest-relative paths, e.g. a zone-map pruned
        subset), over exactly those files in manifest order."""
        import pyarrow.dataset as pads

        if files is not None:
            subset = set(files)
            paths = [
                posixpath.join(self.table.root, f)
                for f in self.manifest["files"]
                if f in subset
            ]
        else:
            paths = self.files()
        if not paths:
            # empty snapshot: in-memory empty dataset over the stored schema
            schema = self.schema()
            if schema is None:
                raise LakehouseError(
                    f"{self.table.path}: empty table with no schema"
                )
            return pads.dataset(schema.empty_table())
        return pads.dataset(paths, format="parquet",
                            filesystem=arrow_filesystem(self.table.fs))


class LakehouseTable:
    def __init__(self, path: str, conf: dict | None = None):
        self.path = str(path)
        self.conf = conf  # optional engine conf tier (commit/vacuum knobs)
        self.fs, self.root = get_fs(path)
        self.manifest_dir = posixpath.join(self.root, _MANIFEST_DIR)
        self.data_dir = posixpath.join(self.root, _DATA_DIR)
        # fleet catalog (lakehouse/catalog.py): when configured, commits,
        # reader leases and the vacuum fence route through it — cross-host
        # arbitration. None (the default) keeps the process-concurrent
        # behaviour.
        self.catalog = resolve_catalog(conf)
        self._writer_token = None  # lazy catalog writer registration
        if not self.fs.isdir(self.manifest_dir):
            raise LakehouseError(f"{path} is not a lakehouse table")

    @property
    def name(self) -> str:
        return posixpath.basename(self.root)

    def _is_local(self) -> bool:
        """True for local-POSIX tables, where a pid embedded in a staged
        file name can be liveness-checked. Remote/shared stores (s3, gs,
        memory, ...) get the conservative path: never attribute by pid."""
        proto = (
            self.fs.protocol
            if isinstance(self.fs.protocol, str)
            else self.fs.protocol[0]
        )
        return proto in ("file", "local")

    # -- fleet catalog -----------------------------------------------------
    def _writer_epoch(self) -> int | None:
        """This instance's catalog writer epoch (registering a TTL-bounded
        writer lease on first use); None with no catalog configured."""
        if self.catalog is None:
            return None
        if self._writer_token is None:
            self._writer_token = self.catalog.writer_register(
                self, resolve_writer_ttl(self.conf)
            )
        return int(self._writer_token["epoch"])

    def _release_writer(self):
        """Drop this instance's writer lease after its transaction ends
        (published or aborted-and-discarded): the fence can then advance
        past the epoch at the next vacuum instead of waiting out the TTL.
        The next transaction on this instance re-registers."""
        token, self._writer_token = self._writer_token, None
        if token is None or self.catalog is None:
            return
        try:
            # a writer lease is a writer-epoch record in the same store;
            # the catalog expires it immediately by zeroing its TTL
            self.catalog.writer_renew(self, token, 0.0)
        except Exception:
            pass  # TTL expiry is the backstop

    def acquire_reader_lease(self, snapshot, ttl_s: float) -> int:
        """Register a reader lease over a snapshot's files: in the
        process-wide lease table ALWAYS, and — with a catalog configured
        — written through to the catalog so vacuum on ANY host sees it
        (the in-process table is then the local cache of catalog state).
        Returns the local lease id (renew/release forward to the remote
        half automatically)."""
        remote = None
        if self.catalog is not None:
            remote = self.catalog.lease_acquire(
                self, snapshot.version, snapshot.rel_files, ttl_s
            )
        return LEASES.acquire(
            self.root, snapshot.version, snapshot.rel_files, ttl_s,
            remote=remote,
        )

    def _held_files(self) -> set:
        """Files protected by live reader leases: the local table merged
        with the catalog's cross-host view."""
        out = LEASES.held_files(self.root)
        if self.catalog is not None:
            out |= self.catalog.held_files(self)
        return out

    def _held_versions(self) -> set:
        out = LEASES.held_versions(self.root)
        if self.catalog is not None:
            out |= self.catalog.held_versions(self)
        return out

    # -- creation ----------------------------------------------------------
    @classmethod
    def create(cls, path: str, batches=None, schema: pa.Schema | None = None):
        """Create an empty table (or one seeded from an iterable of record
        batches / a pa.Table)."""
        import pyarrow.parquet as pq

        fs, root = get_fs(path)
        fs.makedirs(posixpath.join(root, _MANIFEST_DIR), exist_ok=True)
        fs.makedirs(posixpath.join(root, _DATA_DIR), exist_ok=True)
        t = cls(path)
        staged = t._stage(batches, schema) if batches is not None else []
        if schema is None and staged:
            with t.fs.open(posixpath.join(t.root, staged[0][0]), "rb") as fh:
                schema = pq.read_schema(fh)
        try:
            t._commit(staged, "create", base_files=[], schema=schema)
        except CommitConflictError:
            t._discard_staged(staged)
            raise
        return t

    @classmethod
    def is_table(cls, path: str) -> bool:
        fs, root = get_fs(path)
        return fs.isdir(posixpath.join(root, _MANIFEST_DIR))

    # -- snapshot log ------------------------------------------------------
    def _version_numbers(self):
        """Snapshot version numbers ascending, from manifest FILENAMES
        alone (v%06d.json encodes the version) — no manifest is opened,
        so head resolution stays O(1 listing) however long the history
        grows (per-statement pins would otherwise read every manifest)."""
        out = []
        for f in self.fs.ls(self.manifest_dir, detail=False):
            name = posixpath.basename(f)
            if name.startswith("v") and name.endswith(".json"):
                try:
                    out.append(int(name[1:-5]))
                except ValueError:
                    pass
        return sorted(out)

    def versions(self):
        """[(version, timestamp_ms, operation)] ascending. Tolerates a
        manifest vanishing between the listing and the read: a concurrent
        `expire_snapshots` (the maintenance-under-load phase runs vacuum
        WHILE streams re-resolve heads) deletes old manifests, and a
        reader racing it must see the post-expiry log, not crash."""
        out = []
        for f in sorted(self.fs.ls(self.manifest_dir, detail=False)):
            name = posixpath.basename(f)
            if name.startswith("v") and name.endswith(".json"):
                try:
                    with self.fs.open(f, "r") as fh:
                        m = json.load(fh)
                except FileNotFoundError:
                    continue  # expired under us: same as never listed
                out.append((m["version"], m["timestamp_ms"], m["operation"]))
        return out

    def _manifest(self, version: int) -> dict:
        from .. import faults

        if faults.active():
            # io/crash injection site for manifest reads: a flaky store
            # failing a head re-read mid-rebase must walk the io ladder
            faults.maybe_fire(f"manifest:{self.name}", kinds=("io", "crash"))
        p = posixpath.join(self.manifest_dir, f"v{version:06d}.json")
        try:
            with self.fs.open(p, "r") as fh:
                return json.load(fh)
        except FileNotFoundError:
            raise LakehouseError(f"{self.path}: no snapshot v{version}")

    def current_version(self) -> int:
        vs = self._version_numbers()
        if not vs:
            raise LakehouseError(f"{self.path}: no snapshots")
        return max(vs)

    def snapshot(self, version: int | None = None) -> TableSnapshot:
        """Pinned read handle: resolve (current or explicit) version ONCE;
        all reads through the handle see exactly that manifest."""
        if version is None:
            version = self.current_version()
        return TableSnapshot(self, self._manifest(version))

    def current_files(self):
        return self.snapshot().files()

    def num_rows(self) -> int:
        return self.snapshot().num_rows()

    # -- reads -------------------------------------------------------------
    def dataset(self) -> pads.Dataset:
        return self.snapshot().dataset()

    def schema(self) -> pa.Schema | None:
        return self.snapshot().schema()

    # -- writes ------------------------------------------------------------
    def _stage(self, batches, schema=None):
        """Write data files; returns [(relpath, num_rows, stats)] where
        stats is the file's zone map ({"rows", "columns": {...min/max/
        nulls...}}), computed from the same batch stream that built the
        file — no second read. Not yet visible. File names embed this
        process's pid (crash-hygiene attribution)."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        from .. import faults

        if faults.active():
            # io/crash injection site for staged-data writes: a crash here
            # leaves orphaned data files and NO manifest — the sweep's food
            faults.maybe_fire(f"stage:{self.name}", kinds=("io", "crash"))
        if isinstance(batches, pa.Table):
            batches = batches.to_batches(max_chunksize=1 << 20)
        staged = []
        writer = None
        out = None
        relpath = None
        acc = StatsAccumulator()
        # with a catalog, staged names carry the writer's fencing epoch so
        # a vacuum on ANY host can attribute the stage (pids are host-local)
        epoch_tag = (
            f"-e{self._writer_epoch()}" if self.catalog is not None else ""
        )
        try:
            for b in batches:
                if writer is None:
                    relpath = posixpath.join(
                        _DATA_DIR,
                        f"part-{os.getpid()}{epoch_tag}"
                        f"-{uuid.uuid4().hex[:12]}.parquet",
                    )
                    out = self.fs.open(
                        posixpath.join(self.root, relpath), "wb"
                    )
                    writer = pq.ParquetWriter(
                        out, schema or b.schema, compression="snappy"
                    )
                writer.write_batch(b)
                acc.update(b)
        finally:
            if writer is not None:
                writer.close()
            if out is not None:
                out.close()
        if relpath is not None:
            staged.append((relpath, acc.rows, acc.finish()))
        return staged

    def stage_clustered(self, tbl: pa.Table, cluster_by=None,
                        max_file_bytes=None):
        """Stage a table as one or more files CLUSTERED on `cluster_by`:
        rows are sorted by the key and split into ~`max_file_bytes`
        slices, so each staged file covers a narrow, mostly-disjoint key
        range and its zone map actually prunes (an unsorted split gives
        every file the full key range — zone maps that never exclude
        anything). Returns the combined staged list for one `_commit`."""
        if max_file_bytes is None:
            max_file_bytes = resolve_compact_target_bytes(self.conf)
        if tbl.num_rows == 0:
            return []
        if cluster_by and cluster_by in tbl.schema.names:
            import pyarrow.compute as pc

            tbl = tbl.take(
                pc.sort_indices(tbl, sort_keys=[(cluster_by, "ascending")])
            )
        n_files = max(1, -(-tbl.nbytes // max(int(max_file_bytes), 1)))
        per = -(-tbl.num_rows // n_files)
        staged = []
        for off in range(0, tbl.num_rows, per):
            staged.extend(self._stage(tbl.slice(off, per)))
        return staged

    def _discard_staged(self, staged):
        """Best-effort cleanup of staged files after an aborted commit (the
        orphan sweep is the backstop for anything missed)."""
        for s in staged:
            try:
                self.fs.rm_file(posixpath.join(self.root, s[0]))
            except OSError:
                pass
        self._release_writer()  # the aborted transaction's epoch is done

    def _commit(self, staged, operation, base_files=None, num_rows=None,
                schema=None, base_stats=None, base_chunks=None,
                new_chunks=None):
        """Publish the next manifest: base file list + staged files.

        Optimistic concurrency with bounded rebase: each attempt reads the
        head, claims head+1 with a create-exclusive publish, and on losing
        the race either REBASES (base_files is None — the transaction is
        append-only, so replaying it onto the new head's file list is
        exactly Iceberg's fast-append retry) or ABORTS with
        CommitConflictError (an explicit base file list means the writes
        were derived from a snapshot that is no longer the head; publishing
        would silently drop the winner's rows).

        Zone maps ride along: staged entries carry their file's stats,
        base files inherit the stats of whichever manifest supplied the
        base list (the rebased-onto head for appends, `base_stats` for
        explicit-base transactions), so the `stats` key stays exactly in
        sync with `files` through every rebase. Same story for the ingest
        ledger (`ingest_chunks` + `new_chunks`): appends union the head's
        ledger with this commit's chunk ids — and when every new chunk id
        is ALREADY in the head's ledger the publish is skipped with
        _ChunkAlreadyIngested, which is what makes chunk replay after a
        mid-commit kill exactly-once at the commit point, not merely
        at the (racy) pre-flight ledger check."""
        from .. import faults

        if faults.active():
            # failure-domain injection site: a fault here lands BEFORE the
            # manifest publish, so staged data files exist but no snapshot
            # references them — proving commits are all-or-nothing under
            # io/crash faults (Iceberg's commit-point guarantee)
            faults.maybe_fire(f"commit:{self.name}")
            faults.maybe_fire_path(self.root)
        schema_hex = None
        if schema is not None:
            schema_hex = bytes(schema.serialize()).hex()
        retries = resolve_commit_retries(self.conf)
        delays = faults.backoff_delays(retries, commit_backoff_base())
        attempts = 0
        while True:
            attempts += 1
            try:
                cur = self._manifest(self.current_version())
                version = cur["version"] + 1
                base = cur["files"] if base_files is None else base_files
                base_rows = (
                    cur.get("num_rows", 0) if base_files is None else 0
                )
                if base_files is None:
                    bstats = cur.get("stats") or {}
                    bchunks = set(cur.get("ingest_chunks") or [])
                else:
                    bstats = base_stats or {}
                    bchunks = set(base_chunks or [])
                prev_ts = cur["timestamp_ms"]
                if schema_hex is None:
                    schema_hex = cur.get("schema_hex")
            except LakehouseError:
                version, base, base_rows, prev_ts = 1, base_files or [], 0, 0
                bstats = base_stats or {}
                bchunks = set(base_chunks or [])
            if new_chunks and set(new_chunks) <= bchunks:
                # a concurrent (or previous, pre-kill) replay of the same
                # chunk already published: adding our staged copy would
                # double the rows
                raise _ChunkAlreadyIngested(cur["version"])
            files = list(base) + [s[0] for s in staged]
            total = (
                num_rows
                if num_rows is not None
                else base_rows + sum(s[1] for s in staged)
            )
            stats = {f: bstats[f] for f in base if f in bstats}
            for s in staged:
                if len(s) > 2 and s[2]:
                    stats[s[0]] = s[2]
            chunks = sorted(bchunks | set(new_chunks or []))
            manifest = {
                "version": version,
                # strictly monotonic so timestamp rollback can never tie
                # between adjacent snapshots (Iceberg's same guarantee)
                "timestamp_ms": max(int(time.time() * 1000), prev_ts + 1),
                "operation": operation,
                "files": files,
                "num_rows": total,
                "schema_hex": schema_hex,
            }
            if stats:
                manifest["stats"] = stats
            if chunks:
                manifest["ingest_chunks"] = chunks
            if _COMMIT_HOOK is not None:
                _COMMIT_HOOK(self.name, operation, version)
            # optimistic concurrency: publish is create-exclusive, so a
            # concurrent writer that claimed the same version fails loudly
            # instead of silently last-writer-winning (Iceberg's
            # commit-conflict guarantee). With a catalog the publish routes
            # through it, fence-checked; without one it is the direct path
            # (see io/fs.py put_if_absent for the local-atomic vs
            # remote-best-effort split).
            if self.catalog is not None:
                try:
                    epoch = self._writer_epoch()
                    # keep the writer lease live across the rebase loop so
                    # a long conflict storm can't expire us into the fence
                    self.catalog.writer_renew(
                        self, self._writer_token,
                        resolve_writer_ttl(self.conf),
                    )
                    published = self.catalog.commit(
                        self, manifest, epoch=epoch
                    )
                except CatalogFencedError as exc:
                    # a vacuum fenced this writer (lease expired — zombie
                    # presumption) and may have reclaimed its stage: the
                    # whole transaction must re-run with a fresh epoch and
                    # fresh staged files. CommitConflictError routes it to
                    # the ladder's commit_rebase_retry rung.
                    self._release_writer()
                    raise CommitConflictError(
                        f"{self.path}: {exc} (re-run the transaction)"
                    ) from exc
            else:
                tmp = posixpath.join(
                    self.manifest_dir,
                    f".tmp-{os.getpid()}-{uuid.uuid4().hex}.json",
                )
                with self.fs.open(tmp, "w") as fh:
                    json.dump(manifest, fh)
                dest = posixpath.join(
                    self.manifest_dir, f"v{version:06d}.json"
                )
                published = put_if_absent(self.fs, tmp, dest)
            if published:
                self._release_writer()
                tracer = _tracer()
                if tracer is not None:
                    tracer.emit(
                        "lake_commit", table=self.name, operation=operation,
                        version=version, attempts=attempts,
                        rebased=attempts > 1,
                    )
                return version
            # lost the race. Overwrite-style transactions (explicit base
            # file list) abort: their writes no longer describe the head.
            delay = (
                next(delays, None) if base_files is None else None
            )
            if delay is None:
                tracer = _tracer()
                if tracer is not None:
                    tracer.emit(
                        "lake_commit", table=self.name, operation=operation,
                        version=version, attempts=attempts, conflict=True,
                    )
                why = (
                    f"rebase budget ({retries}) exhausted"
                    if base_files is None
                    else "overwrite transactions cannot rebase"
                )
                # drop the writer lease HERE, not only in _discard_staged:
                # rollback transactions reach this raise with no staged
                # files and would otherwise pin the fence for the full
                # writer TTL (idempotent — the discard path re-calls it)
                self._release_writer()
                raise CommitConflictError(
                    f"{self.path}: concurrent commit conflict at version "
                    f"{version} after {attempts} attempt(s) ({why}); "
                    f"retry the transaction"
                )
            if delay:
                time.sleep(delay)

    def append(self, table, operation="append") -> int:
        """INSERT: add rows (pa.Table or batch iterable) as new immutable
        files; returns the new version. Concurrent appends converge via
        commit rebase (both row sets present)."""
        staged = self._stage(table)
        try:
            return self._commit(staged, operation)
        except CommitConflictError:
            self._discard_staged(staged)
            raise

    def replace(self, table: pa.Table, operation="overwrite") -> int:
        """Replace the full file set (copy-on-write DELETE/UPDATE). Aborts
        on ANY concurrent commit — the replacement rows were derived from a
        snapshot that is no longer the head."""
        staged = self._stage(table)
        try:
            return self._commit(
                staged, operation, base_files=[],
                num_rows=sum(s[1] for s in staged),
            )
        except CommitConflictError:
            self._discard_staged(staged)
            raise

    def ingest_chunk(self, tbl, chunk_id: str, cluster_by=None,
                     max_file_bytes=None):
        """Exactly-once chunk append for parallel ingest: stage `tbl`
        clustered on `cluster_by`, then commit with `chunk_id` recorded
        in the manifest's ingest ledger. The ledger IS the checkpoint —
        a killed worker's resume replays its chunks, the commit point
        skips any id already in the head ledger, and staged files from
        the un-published attempt are below-fence debris for vacuum.
        Returns the published version, or None when the chunk was
        already ingested (nothing committed, stage discarded)."""
        if chunk_id in self.snapshot().ingest_chunks():
            return None  # cheap pre-flight; the commit point re-checks
        staged = self.stage_clustered(tbl, cluster_by, max_file_bytes)
        try:
            return self._commit(staged, "ingest", new_chunks=[chunk_id])
        except _ChunkAlreadyIngested:
            self._discard_staged(staged)
            return None
        except CommitConflictError:
            self._discard_staged(staged)
            raise

    # -- time travel -------------------------------------------------------
    def rollback_to_version(self, version: int) -> int:
        m = self._manifest(version)
        return self._commit(
            [], f"rollback-to-v{version}", base_files=m["files"],
            num_rows=m.get("num_rows"), base_stats=m.get("stats"),
            base_chunks=m.get("ingest_chunks"),
        )

    def rollback_to_timestamp(self, ts_ms: int) -> int:
        """Roll back to the last snapshot at or before ts_ms (reference:
        CALL spark_catalog.system.rollback_to_timestamp, nds_rollback.py:46-51).
        A ts_ms exactly equal to a snapshot's (strictly monotonic)
        timestamp selects that snapshot."""
        candidates = [v for v, t, _ in self.versions() if t <= ts_ms]
        if not candidates:
            raise LakehouseError(
                f"{self.path}: no snapshot at or before {ts_ms}"
            )
        return self.rollback_to_version(max(candidates))

    # -- maintenance: compaction (OPTIMIZE) --------------------------------
    def compact(self, target_bytes=None, min_input_files=None) -> dict:
        """Small-file rewrite (Iceberg's rewrite_data_files / OPTIMIZE):
        coalesce files below `target_bytes` into ~target-sized ones so
        parallel ingest's per-chunk commits don't permanently fragment
        the layout. Logical content is untouched — num_rows, the ingest
        ledger, and untouched files' stats carry over; the rewritten
        files get FRESH zone maps from `_stage` (the merged file's real
        bounds, not a union of its inputs').

        Runs as an explicit-base transaction: the commit publishes only
        if the head is still the snapshot the rewrite read, otherwise it
        aborts with CommitConflictError (a concurrent append's rows must
        not be dropped) — callers retry the whole pass, as in
        maintenance._run_dm_statement. Concurrent snapshot-pinned readers
        are unaffected: the input files stay referenced by retained
        manifests (and reader leases) until vacuum.

        Returns {"files_in", "files_out", "bytes_in", "version"};
        version None means nothing worth rewriting."""
        target_bytes = (
            resolve_compact_target_bytes(self.conf)
            if target_bytes is None else int(target_bytes)
        )
        if min_input_files is None:
            min_input_files = resolve_compact_min_files(self.conf)
        snap = self.snapshot()
        sizes = {}
        for rel in snap.rel_files:
            try:
                info = self.fs.info(posixpath.join(self.root, rel))
                sizes[rel] = int(info.get("size") or target_bytes)
            except OSError:
                sizes[rel] = target_bytes  # unreadable: never a candidate
        small = [r for r in snap.rel_files if sizes[r] < target_bytes]
        if len(small) < max(int(min_input_files), 2):
            return {"table": self.name, "files_in": 0, "files_out": 0,
                    "bytes_in": 0, "version": None}
        # bin-pack in manifest order — ingest commits append key-clustered
        # files in arrival order, so neighbors usually share a key range
        # and the merged file keeps a tight zone map
        groups, cur_group, cur_bytes = [], [], 0
        for rel in small:
            cur_group.append(rel)
            cur_bytes += sizes[rel]
            if cur_bytes >= target_bytes:
                groups.append(cur_group)
                cur_group, cur_bytes = [], 0
        if len(cur_group) >= 2:
            groups.append(cur_group)
        groups = [g for g in groups if len(g) >= 2]
        if not groups:
            return {"table": self.name, "files_in": 0, "files_out": 0,
                    "bytes_in": 0, "version": None}
        staged, inputs = [], []
        try:
            for g in groups:
                merged = snap.dataset(files=g).to_table()
                staged.extend(self._stage(merged, schema=merged.schema))
                inputs.extend(g)
            replaced = set(inputs)
            base = [r for r in snap.rel_files if r not in replaced]
            stats = snap.file_stats()
            version = self._commit(
                staged, "optimize", base_files=base,
                num_rows=snap.manifest.get("num_rows"),
                base_stats={r: stats[r] for r in base if r in stats},
                base_chunks=snap.manifest.get("ingest_chunks"),
            )
        except Exception:
            self._discard_staged(staged)
            raise
        return {
            "table": self.name,
            "files_in": len(inputs),
            "files_out": len(staged),
            "bytes_in": sum(sizes[r] for r in inputs),
            "version": version,
        }

    # -- maintenance: snapshot expiry + vacuum -----------------------------
    def _retain_last(self, retain_last) -> int:
        if retain_last is None and self.conf:
            retain_last = self.conf.get("engine.lake_vacuum_retain")
        if retain_last is None:
            retain_last = os.environ.get("NDS_LAKE_VACUUM_RETAIN")
        try:
            return max(int(retain_last), 1) if retain_last else 2
        except (TypeError, ValueError):
            return 2

    def expire_snapshots(self, retain_last=None, older_than_ms=None):
        """Drop old manifests (Iceberg's expire_snapshots). The head and
        the newest `retain_last` versions always survive, as does any
        version a live reader lease pins (its manifest stays resolvable
        for rollback while the reader works; the lease's own FILE list
        protects data either way). Returns the expired version numbers."""
        vs = self.versions()
        retain_last = self._retain_last(retain_last)
        keep = {v for v, _, _ in vs[-retain_last:]}
        leased = self._held_versions()
        expired = []
        for v, ts, _ in vs:
            if v in keep or v in leased:
                continue
            if older_than_ms is not None and ts > older_than_ms:
                continue
            try:
                self.fs.rm_file(
                    posixpath.join(self.manifest_dir, f"v{v:06d}.json")
                )
            except OSError:
                continue  # already gone / transient: next vacuum retries
            expired.append(v)
        return expired

    def vacuum(self, retain_last=None, older_than_ms=None) -> dict:
        """Expire old snapshots, then delete data files that no retained
        manifest references — EXCEPT files covered by a live reader lease
        (a pinned query may still be scanning an expired snapshot) or
        staged by a live writer pid (an in-flight commit's files are not
        orphans). Crash-safe by ordering: manifests are removed before
        their files, so an interrupted vacuum leaves only sweepable
        unreferenced files, never a manifest pointing at deleted data."""
        from .. import faults

        if faults.active():
            # io/crash injection site: a crash mid-vacuum must never lose
            # a committed snapshot (retained manifests + their files are
            # untouched by construction)
            faults.maybe_fire(f"vacuum:{self.name}", kinds=("io", "crash"))
        # capture the pre-expiry referenced set FIRST: a file some manifest
        # references was committed, so once its manifest expires it is
        # collectable even though its writer pid is still alive — the
        # live-pid guard below is only for never-referenced in-flight
        # stages (a commit racing this vacuum)
        committed = self._all_referenced_files()
        expired = self.expire_snapshots(retain_last, older_than_ms)
        referenced = self._all_referenced_files()
        leased = self._held_files()
        # epoch fencing (catalog mode): advance the fence to the minimum
        # LIVE writer epoch BEFORE collecting. Any never-referenced stage
        # with epoch < fence belongs to a writer whose publish is now
        # refused at the catalog, so deleting it can never tear a commit —
        # the cross-host replacement for pid-liveness attribution, and the
        # close of the publish-vs-unlink window (rename-narrowed on fs).
        fence = None
        if self.catalog is not None:
            fence = self.catalog.bump_fence(self)
            self.catalog.sweep_expired(self)
        removed, leased_kept, bytes_removed = [], 0, 0
        try:
            entries = self.fs.ls(self.data_dir, detail=True)
        except OSError:
            entries = []
        # re-read the manifest log AFTER the fence bump and the data-dir
        # listing: a commit that published between the first referenced-set
        # read and the listing (a racing writer that then exited, defeating
        # the pid-liveness guard) must land in `referenced` before anything
        # is deleted. Without a catalog the residual publish-vs-unlink
        # window is the one Iceberg closes with a catalog service —
        # configure `engine.lake_catalog` to close it here too.
        referenced |= self._all_referenced_files()
        for ent in entries:
            full = ent["name"] if isinstance(ent, dict) else str(ent)
            base = posixpath.basename(full)
            if not _DATA_FILE_RE.match(base):
                continue  # never touch files outside our naming scheme
            rel = posixpath.join(_DATA_DIR, base)
            if rel in referenced:
                continue
            if rel in leased:
                leased_kept += 1
                continue
            m = _STAGED_RE.match(base)
            if rel not in committed and m is not None:
                if fence is not None and m.group(2) is not None:
                    # epoch-attributed stage: protected while its epoch is
                    # at/above the fence (a live writer's in-flight commit);
                    # below it the writer is fenced — collectable anywhere
                    if int(m.group(2)) >= fence:
                        continue
                elif not self._is_local() or _pid_alive(int(m.group(1))):
                    # pid attribution is host-local, so without a catalog a
                    # REMOTE (shared) warehouse protects every never-
                    # referenced stage unconditionally — deleting a live
                    # remote writer's stage would corrupt the commit it is
                    # about to publish.
                    continue
            if faults.active():
                faults.maybe_fire_path(full)
            try:
                self.fs.rm_file(posixpath.join(self.data_dir, base))
            except OSError:
                continue
            removed.append(rel)
            if isinstance(ent, dict):
                bytes_removed += int(ent.get("size") or 0)
        tracer = _tracer()
        if tracer is not None:
            tracer.emit(
                "lake_vacuum", table=self.name, files_removed=len(removed),
                manifests_removed=len(expired), files_leased=leased_kept,
                bytes_removed=bytes_removed,
            )
        return {
            "table": self.name,
            "files_removed": len(removed),
            "manifests_removed": len(expired),
            "files_leased": leased_kept,
            "bytes_removed": bytes_removed,
            "removed": removed,
            "expired_versions": expired,
        }

    def _all_referenced_files(self) -> set:
        """Union of every live manifest's file list; a manifest expiring
        between the listing and its read is skipped (post-expiry view)."""
        out = set()
        for v in self._version_numbers():
            try:
                out.update(self._manifest(v)["files"])
            except LakehouseError:
                continue  # expired under us
        return out

    # -- crash hygiene: orphaned-stage sweep -------------------------------
    def sweep_orphans(self) -> int:
        """Remove a crashed writer's leavings: staged data files that no
        manifest references and whose embedded writer pid is dead, plus
        torn `.tmp-<pid>-*.json` manifest temps with dead pids. Files the
        naming scheme cannot attribute (foreign files, pre-pid-format
        parts) are never touched — the same never-touch-foreign contract
        as spill.sweep_orphans. Pid liveness is host-local, so WITHOUT a
        catalog a REMOTE (shared) warehouse sweep is a no-op — a live
        writer on another host would read as dead and lose its in-flight
        stage. With `engine.lake_catalog` configured, epoch-stamped
        stages below the table's fence are sweepable on ANY store (their
        writers can never publish), which is how remote deployments get
        crash hygiene back. Returns the number of files removed."""
        fence = self.catalog.read_fence(self) if self.catalog else None
        if not self._is_local() and fence is None:
            return 0
        referenced = self._all_referenced_files()
        removed = 0
        try:
            data_names = [
                posixpath.basename(f)
                for f in self.fs.ls(self.data_dir, detail=False)
            ]
        except OSError:
            data_names = []
        for base in data_names:
            m = _STAGED_RE.match(base)
            if m is None:
                continue
            if posixpath.join(_DATA_DIR, base) in referenced:
                continue
            if fence is not None and m.group(2) is not None:
                # fence attribution works cross-host: below the fence the
                # writer is refused at publish, so its stage is debris
                if int(m.group(2)) >= fence:
                    continue
            elif not self._is_local():
                continue  # unattributable remotely without an epoch
            else:
                pid = int(m.group(1))
                if pid == os.getpid() or _pid_alive(pid):
                    continue
            try:
                self.fs.rm_file(posixpath.join(self.data_dir, base))
                removed += 1
            except OSError:
                pass
        try:
            man_names = [
                posixpath.basename(f)
                for f in self.fs.ls(self.manifest_dir, detail=False)
            ]
        except OSError:
            man_names = []
        for base in man_names:
            m = _TMP_MANIFEST_RE.match(base)
            if m is None:
                continue
            if not self._is_local():
                # tmp manifests carry no epoch: pid attribution only, and
                # only where pids mean something (they are tiny debris on
                # remote stores, never a correctness hazard)
                continue
            pid = int(m.group(1))
            if pid == os.getpid() or _pid_alive(pid):
                continue
            try:
                self.fs.rm_file(posixpath.join(self.manifest_dir, base))
                removed += 1
            except OSError:
                pass
        if removed:
            print(
                f"lakehouse: swept {removed} orphaned file(s) from "
                f"{self.path}"
            )
        return removed


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True  # exists but owned elsewhere: treat as alive
    return True


# one sweep per (process, table root): sessions are per-stream in
# throughput runs, and re-listing every table per session buys nothing.
# Process-lifetime once-latch; worst case under a race is a second,
# idempotent sweep.
_SWEPT_TABLES = set()


def sweep_table_at_session_start(path: str):
    """Session-start crash hygiene for one lakehouse table (called by the
    catalog when a lakehouse entry is registered): remove a dead writer's
    staged-but-uncommitted data files and torn manifest temps, once per
    process per table."""
    key = str(path)
    if key in _SWEPT_TABLES:
        return 0
    _SWEPT_TABLES.add(key)
    try:
        if not LakehouseTable.is_table(path):
            return 0
        return LakehouseTable(path).sweep_orphans()
    except Exception:
        return 0  # hygiene is best-effort; never block a session build
