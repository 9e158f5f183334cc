"""Fleet catalog, fs backend: cross-host commit arbitration, reader leases
and vacuum fencing; the port of nds_tpu/lakehouse/catalog.py's error
classes, resolvers and `FsCatalog`.

`engine.lake_catalog=fs` (or NDS_LAKE_CATALOG=fs) keeps catalog state
(fence, writer epochs, reader leases) as JSON files in `<table>/_catalog/`
next to the manifests, on any io/fs.py filesystem, every write an atomic
tmp + rename. Arbitration is airtight where `put_if_absent` is atomic
(local POSIX); on remote stores the commit CAS stays best-effort, narrowed
by a fence re-check just before the publish rename. The reference's tcp
backend (`engine.lake_catalog=http://host:port`, its coordinator and
`cli/catalog.py`) rides the serve layer's HTTP server and is not ported:
such a value raises NotImplementedError (ROADMAP.md queue 1 item 12b).

**Epoch fencing (the zombie-writer contract).** Every writer registers a
TTL-bounded writer lease and receives a monotone *epoch*; its staged data
files embed the epoch (`part-<pid>-e<epoch>-<hex>.parquet`) and its
commits carry it. Vacuum advances the table's *fence* to the minimum epoch
among live writer leases (or past every epoch issued when none is live),
then collects never-referenced stages with `epoch < fence`: safe, because
a commit carrying a fenced epoch is refused at publish. A stale writer
(crashed host, paused VM, expired lease) can therefore never publish a
manifest referencing files vacuum reclaimed.

Fault sites `catalog:commit`, `catalog:lease` and `catalog:fence`
(io/hang/crash) are the reference's, and so are the `catalog_commit` and
`catalog_lease` events emitted into the thread-bound tracer.
"""

from __future__ import annotations

import json
import os
import posixpath
import socket
import threading
import time
import uuid

from .. import faults
from ..io.fs import get_fs, put_if_absent

#: catalog state directory inside a table root, sibling of _manifests/
CATALOG_DIR = "_catalog"
_LEASE_DIR = "leases"
_WRITER_DIR = "writers"
_FENCE_FILE = "fence.json"
_EPOCH_FILE = "epoch.json"

#: default writer-lease TTL seconds (engine.lake_writer_ttl_s /
#: NDS_LAKE_WRITER_TTL_S): how long a registered writer stays unfenced
#: without renewing; commits renew per attempt, so only a crashed or
#: wedged writer ever expires
DEFAULT_WRITER_TTL_S = 300.0

_ITEM12 = "ROADMAP.md queue 1 item 12b (serve: the tcp catalog)"


class CatalogError(Exception):
    pass


class CatalogFencedError(CatalogError):
    """This writer's epoch is below the table's fence: a vacuum decided it
    was a zombie (writer lease expired) and may have reclaimed its staged
    files. The commit was refused, since republishing would reference
    deleted data. The transaction re-runs with a fresh epoch (new stage,
    new registration); table.py converts this to CommitConflictError so
    the ladder's `commit_rebase_retry` rung owns the re-run."""


def resolve_writer_ttl(conf: dict | None = None) -> float:
    v = None
    if conf:
        v = conf.get("engine.lake_writer_ttl_s")
    if v is None:
        v = os.environ.get("NDS_LAKE_WRITER_TTL_S")
    try:
        return max(float(v), 0.0) if v is not None and v != "" else (
            DEFAULT_WRITER_TTL_S
        )
    except (TypeError, ValueError):
        return DEFAULT_WRITER_TTL_S


def catalog_spec(conf: dict | None = None):
    """The `engine.lake_catalog` / NDS_LAKE_CATALOG value, or None when
    unset or off."""
    v = None
    if conf:
        v = conf.get("engine.lake_catalog")
    if v is None:
        v = os.environ.get("NDS_LAKE_CATALOG")
    if v is None:
        return None
    v = str(v).strip()
    return v if v and v.lower() not in ("off", "none", "0", "false") else None


def is_tcp_spec(spec) -> bool:
    """True for a coordinator URL, the backend the port lacks."""
    return spec is not None and spec.startswith(("http://", "https://"))


#: one client per backend spec; the fs client is stateless
_CLIENTS = {}
_CLIENTS_LOCK = threading.Lock()


def resolve_catalog(conf: dict | None = None):
    """The configured catalog client (`engine.lake_catalog` /
    NDS_LAKE_CATALOG: `fs`, or off/None, the default: the process-
    concurrent behaviour). An http(s) coordinator URL raises
    NotImplementedError; any other value CatalogError."""
    spec = catalog_spec(conf)
    if spec is None:
        return None
    if is_tcp_spec(spec):
        raise NotImplementedError(
            f"engine.lake_catalog={spec!r}: the tcp catalog coordinator is "
            f"not ported to nds_tpu_torch yet: {_ITEM12}"
        )
    with _CLIENTS_LOCK:
        client = _CLIENTS.get(spec)
        if client is None:
            if spec != "fs":
                raise CatalogError(
                    f"bad engine.lake_catalog value {spec!r} "
                    f"(want 'off', 'fs', or an http://host:port URL)"
                )
            client = _CLIENTS[spec] = FsCatalog()
    return client


def reset_clients():
    """Drop cached backend clients (test isolation)."""
    with _CLIENTS_LOCK:
        _CLIENTS.clear()


def _tracer():
    # lazy import, as lakehouse/table.py: the thread-local binding is how
    # session-less layers find their stream's tracer
    from ..obs import trace as _obs_trace

    return _obs_trace.current()


def _now_ms() -> int:
    return int(time.time() * 1000)


class _TableRef:
    """Lightweight table handle for catalog ops on a bare path
    (LakehouseTable duck-types this shape)."""

    def __init__(self, path: str):
        self.path = str(path)
        self.fs, self.root = get_fs(path)
        self.name = posixpath.basename(self.root)
        self.manifest_dir = posixpath.join(self.root, "_manifests")


class RemoteLease:
    """Handle to a catalog-registered reader lease; the in-process lease
    table (lakehouse/leases.py) stores one per write-through record and
    forwards renew/release, making it the local cache of catalog state."""

    def __init__(self, catalog, ref, lease_id: str):
        self.catalog = catalog
        self.ref = ref
        self.lease_id = lease_id

    def renew(self, ttl_s: float) -> bool:
        return self.catalog.lease_renew(self.ref, self.lease_id, ttl_s)

    def release(self) -> bool:
        return self.catalog.lease_release(self.ref, self.lease_id)


class FsCatalog:
    """Catalog state as JSON files under `<root>/_catalog/`, every write
    an atomic tmp + rename. No process to run; works on any io/fs.py
    filesystem; arbitration strength is `put_if_absent`'s."""

    backend = "fs"

    # -- state files -----------------------------------------------------
    def _cdir(self, t, sub: str | None = None) -> str:
        d = posixpath.join(t.root, CATALOG_DIR)
        return posixpath.join(d, sub) if sub else d

    def _read_json(self, t, relpath: str):
        try:
            with t.fs.open(posixpath.join(self._cdir(t), relpath), "r") as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def _write_json(self, t, relpath: str, obj):
        dest = posixpath.join(self._cdir(t), relpath)
        parent = posixpath.dirname(dest)
        t.fs.makedirs(parent, exist_ok=True)
        tmp = posixpath.join(
            parent, f".tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        )
        with t.fs.open(tmp, "w") as fh:
            json.dump(obj, fh)
        t.fs.mv(tmp, dest)

    def _rm(self, t, relpath: str) -> bool:
        try:
            t.fs.rm_file(posixpath.join(self._cdir(t), relpath))
            return True
        except OSError:
            return False

    def _ls(self, t, sub: str):
        try:
            return [
                posixpath.basename(f)
                for f in t.fs.ls(self._cdir(t, sub), detail=False)
            ]
        except OSError:
            return []

    # -- fence + writer epochs -------------------------------------------
    def read_fence(self, t) -> int:
        rec = self._read_json(t, _FENCE_FILE)
        try:
            return int(rec["fence"]) if rec else 0
        except (KeyError, TypeError, ValueError):
            return 0

    def _next_epoch(self, t) -> int:
        rec = self._read_json(t, _EPOCH_FILE)
        try:
            return int(rec["next"]) if rec else 1
        except (KeyError, TypeError, ValueError):
            return 1

    def writer_register(self, t, ttl_s: float) -> dict:
        """Register a TTL-bounded writer lease; returns the token
        {"id", "epoch"}. The epoch is monotone (>= fence, >= every epoch
        issued before); concurrent registrations may share an epoch, which
        only delays fencing, never breaks it (the fence is the minimum
        over live epochs)."""
        if faults.active():
            faults.maybe_fire("catalog:lease", kinds=("io", "hang", "crash"))
        epoch = max(self.read_fence(t), self._next_epoch(t))
        self._write_json(t, _EPOCH_FILE, {"next": epoch + 1})
        wid = uuid.uuid4().hex[:12]
        self._write_json(t, f"{_WRITER_DIR}/{wid}.json", {
            "epoch": epoch,
            "expires_ms": _now_ms() + int(float(ttl_s) * 1000),
            "pid": os.getpid(),
            "host": socket.gethostname(),
        })
        tr = _tracer()
        if tr is not None:
            tr.emit(
                "catalog_lease", op="writer_register", backend=self.backend,
                outcome="ok", table=t.name, epoch=epoch,
            )
        return {"id": wid, "epoch": epoch}

    def writer_renew(self, t, token: dict, ttl_s: float) -> bool:
        rel = f"{_WRITER_DIR}/{token['id']}.json"
        rec = self._read_json(t, rel)
        if rec is None:
            return False
        rec["expires_ms"] = _now_ms() + int(float(ttl_s) * 1000)
        self._write_json(t, rel, rec)
        return True

    def _live_writer_epochs(self, t):
        now = _now_ms()
        out = []
        for base in self._ls(t, _WRITER_DIR):
            if not base.endswith(".json"):
                continue
            rec = self._read_json(t, f"{_WRITER_DIR}/{base}")
            if rec is None:
                continue
            if int(rec.get("expires_ms") or 0) <= now:
                self._rm(t, f"{_WRITER_DIR}/{base}")  # expired: prune
                continue
            try:
                out.append(int(rec["epoch"]))
            except (KeyError, TypeError, ValueError):
                continue
        return out

    def bump_fence(self, t) -> int:
        """Advance the fence to min(live writer epochs), or past every
        epoch ever issued when none is live, and return it. Vacuum calls
        this before collecting: any stage with epoch < the returned fence
        belongs to a writer whose publish is now refused, so deleting it
        can never tear a commit. Monotone: the fence is never lowered."""
        if faults.active():
            faults.maybe_fire("catalog:fence", kinds=("io", "hang", "crash"))
        cur = self.read_fence(t)
        live = self._live_writer_epochs(t)
        new = max(cur, min(live) if live else self._next_epoch(t))
        if new != cur:
            self._write_json(t, _FENCE_FILE, {"fence": new})
        tr = _tracer()
        if tr is not None:
            tr.emit(
                "catalog_lease", op="fence_bump", backend=self.backend,
                outcome="ok", table=t.name, fence=new,
                live_writers=len(live),
            )
        return new

    # -- commit -----------------------------------------------------------
    def commit(self, t, manifest: dict, epoch: int | None = None) -> bool:
        """Fence-checked create-exclusive publish of `manifest` as the next
        version. True = published; False = lost the version race (the
        caller rebases or aborts by its transaction type); raises
        CatalogFencedError when this writer's epoch is below the fence."""
        if faults.active():
            # the mid-commit chaos site: io walks the backoff ladder, hang
            # holds the publish open for a kill, crash dies between intent
            # and publish
            faults.maybe_fire("catalog:commit", kinds=("io", "hang", "crash"))
        t0 = time.perf_counter()
        version = int(manifest["version"])
        if epoch is not None and epoch < self.read_fence(t):
            self._emit_commit(t, version, "fenced", t0)
            raise CatalogFencedError(
                f"{t.path}: writer epoch {epoch} fenced by catalog "
                f"(fence {self.read_fence(t)}); the transaction must "
                f"re-run with a fresh registration"
            )
        tmp = posixpath.join(
            t.manifest_dir, f".tmp-{os.getpid()}-{uuid.uuid4().hex}.json"
        )
        with t.fs.open(tmp, "w") as fh:
            json.dump(manifest, fh)
        # final fence re-check just before the rename: narrows the check-
        # to-publish window to microseconds
        if epoch is not None and epoch < self.read_fence(t):
            try:
                t.fs.rm_file(tmp)
            except OSError:
                pass
            self._emit_commit(t, version, "fenced", t0)
            raise CatalogFencedError(
                f"{t.path}: writer epoch {epoch} fenced by catalog "
                f"mid-publish; the transaction must re-run"
            )
        dest = posixpath.join(t.manifest_dir, f"v{version:06d}.json")
        ok = put_if_absent(t.fs, tmp, dest)
        self._emit_commit(t, version, "ok" if ok else "conflict", t0)
        return ok

    def _emit_commit(self, t, version, outcome, t0):
        tr = _tracer()
        if tr is not None:
            tr.emit(
                "catalog_commit", table=t.name, backend=self.backend,
                version=version, outcome=outcome,
                dur_ms=round((time.perf_counter() - t0) * 1000.0, 3),
            )

    # -- reader leases -----------------------------------------------------
    def lease_acquire(self, t, version: int, files, ttl_s: float):
        """Register a cross-host reader lease; returns a RemoteLease, or
        None when registration failed (reads keep serving; the local lease
        still protects in-process)."""
        if faults.active():
            faults.maybe_fire("catalog:lease", kinds=("io", "hang", "crash"))
        lid = uuid.uuid4().hex[:12]
        try:
            self._write_json(t, f"{_LEASE_DIR}/{lid}.json", {
                "version": int(version),
                "files": sorted(str(f) for f in files),
                "expires_ms": _now_ms() + int(float(ttl_s) * 1000),
                "pid": os.getpid(),
                "host": socket.gethostname(),
            })
        except OSError:
            return None
        tr = _tracer()
        if tr is not None:
            tr.emit(
                "catalog_lease", op="acquire", backend=self.backend,
                outcome="ok", table=t.name, version=int(version),
            )
        return RemoteLease(self, _TableRef(t.path), lid)

    def lease_renew(self, ref, lease_id: str, ttl_s: float) -> bool:
        rel = f"{_LEASE_DIR}/{lease_id}.json"
        rec = self._read_json(ref, rel)
        if rec is None or int(rec.get("expires_ms") or 0) <= _now_ms():
            return False
        rec["expires_ms"] = _now_ms() + int(float(ttl_s) * 1000)
        try:
            self._write_json(ref, rel, rec)
        except OSError:
            return False
        return True

    def lease_release(self, ref, lease_id: str) -> bool:
        ok = self._rm(ref, f"{_LEASE_DIR}/{lease_id}.json")
        tr = _tracer()
        if tr is not None:
            tr.emit(
                "catalog_lease", op="release", backend=self.backend,
                outcome="ok" if ok else "gone", table=ref.name,
            )
        return ok

    def _live_leases(self, t):
        now = _now_ms()
        for base in self._ls(t, _LEASE_DIR):
            if not base.endswith(".json"):
                continue
            rec = self._read_json(t, f"{_LEASE_DIR}/{base}")
            if rec is None or int(rec.get("expires_ms") or 0) <= now:
                continue
            yield rec

    def held_files(self, t) -> set:
        """Manifest-relative paths any live lease, from any host, covers:
        the cross-host half of vacuum's never-delete-leased contract."""
        out = set()
        for rec in self._live_leases(t):
            out.update(rec.get("files") or ())
        return out

    def held_versions(self, t) -> set:
        return {
            int(rec["version"]) for rec in self._live_leases(t)
            if rec.get("version") is not None
        }

    def sweep_expired(self, t) -> int:
        """Remove expired lease files (vacuum-time hygiene); live leases and
        every non-lease file are untouched."""
        now = _now_ms()
        removed = 0
        for base in self._ls(t, _LEASE_DIR):
            if not base.endswith(".json"):
                continue
            rec = self._read_json(t, f"{_LEASE_DIR}/{base}")
            if rec is not None and int(rec.get("expires_ms") or 0) <= now:
                if self._rm(t, f"{_LEASE_DIR}/{base}"):
                    removed += 1
        if removed:
            tr = _tracer()
            if tr is not None:
                tr.emit(
                    "catalog_lease", op="sweep", backend=self.backend,
                    outcome="ok", table=t.name, removed=removed,
                )
        return removed
