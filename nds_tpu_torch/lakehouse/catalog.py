"""Fleet catalog: cross-host commit arbitration, reader leases and vacuum
fencing; the port of nds_tpu/lakehouse/catalog.py. Two backends sit behind
one client API (`resolve_catalog`):

* **fs** (`engine.lake_catalog=fs`, or NDS_LAKE_CATALOG=fs) keeps catalog
  state (fence, writer epochs, reader leases) as JSON files in
  `<table>/_catalog/` next to the manifests, on any io/fs.py filesystem,
  every write an atomic tmp + rename. Arbitration is airtight where
  `put_if_absent` is atomic (local POSIX); on remote stores the commit CAS
  stays best-effort, narrowed by a fence re-check just before the publish
  rename.
* **tcp** (`engine.lake_catalog=http://host:port`): a coordinator process
  (`cli/catalog.py`, `CatalogCoordinator`) runs every commit, lease and
  fence operation of a warehouse under one lock, on the process-wide
  listener of obs/httpserv.py (its /catalog/* routes ride `attach_app`).
  Fence check, WAL intent and manifest publish are one critical section,
  so there is no CAS window. `HttpCatalog` is its client: a commit cut off
  mid-flight polls the manifest log for its txid before it gives up, and
  the coordinator refuses a publish past the deadline the client sent. An
  unreachable coordinator raises CatalogUnreachableError (classified
  `io_transient`): writes back off, pinned reads keep serving, and vacuum
  refuses to delete what it cannot see leased.

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

import contextlib
import json
import os
import posixpath
import socket
import time
import uuid

from .. import faults
from ..engine.lockdebug import make_lock
from ..io.fs import get_fs, put_if_absent

#: catalog state directory inside a table root, sibling of _manifests/
CATALOG_DIR = "_catalog"
_LEASE_DIR = "leases"
_WRITER_DIR = "writers"
_WAL_DIR = "wal"
_FENCE_FILE = "fence.json"
_EPOCH_FILE = "epoch.json"

#: default writer-lease TTL seconds (engine.lake_writer_ttl_s /
#: NDS_LAKE_WRITER_TTL_S): how long a registered writer stays unfenced
#: without renewing; commits renew per attempt, so only a crashed or
#: wedged writer ever expires
DEFAULT_WRITER_TTL_S = 300.0

#: how long an ambiguous tcp commit (connection cut mid-flight) polls the
#: manifest dir for its txid before it fails classified-retryable
CATALOG_POLL_ENV = "NDS_LAKE_CATALOG_POLL_S"

#: tcp client connect / read timeout seconds
CATALOG_TIMEOUT_ENV = "NDS_LAKE_CATALOG_TIMEOUT_S"


class CatalogError(Exception):
    pass


class CatalogFencedError(CatalogError):
    """This writer's epoch is below the table's fence: a vacuum decided it
    was a zombie (writer lease expired) and may have reclaimed its staged
    files. The commit was refused, since republishing would reference
    deleted data. The transaction re-runs with a fresh epoch (new stage,
    new registration); table.py converts this to CommitConflictError so
    the ladder's `commit_rebase_retry` rung owns the re-run."""


class CatalogUnreachableError(CatalogError, ConnectionError):
    """The tcp coordinator did not answer. A ConnectionError, so that
    faults.classify makes it `io_transient`: writes walk the io backoff
    ladder while pinned reads, which never need the coordinator, keep
    serving."""


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
    """True for a coordinator URL (the tcp backend)."""
    return spec is not None and spec.startswith(("http://", "https://"))


#: one client per backend spec: the fs client is stateless and the tcp
#: client holds its (host, port)
_CLIENTS = {}
_CLIENTS_LOCK = make_lock("lakehouse/catalog.py:_CLIENTS_LOCK")


def resolve_catalog(conf: dict | None = None):
    """The configured catalog client (`engine.lake_catalog` /
    NDS_LAKE_CATALOG: `fs`, an `http://host:port` coordinator URL, or
    off/None, the default: the process-concurrent behaviour); any other
    value raises CatalogError."""
    spec = catalog_spec(conf)
    if spec is None:
        return None
    with _CLIENTS_LOCK:
        client = _CLIENTS.get(spec)
        if client is None:
            if is_tcp_spec(spec):
                client = HttpCatalog(spec)
            elif spec == "fs":
                client = FsCatalog()
            else:
                raise CatalogError(
                    f"bad engine.lake_catalog value {spec!r} "
                    f"(want 'off', 'fs', or an http://host:port URL)"
                )
            _CLIENTS[spec] = client
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
    def commit(self, t, manifest: dict, epoch: int | None = None,
               txid: str | None = None,
               deadline_ms: int | None = None) -> bool:
        """Fence-checked create-exclusive publish of `manifest` as the next
        version. True = published; False = lost the version race (the
        caller rebases or aborts by its transaction type); raises
        CatalogFencedError when this writer's epoch is below the fence.

        `deadline_ms` (the tcp path): the client's give-up stamp. A
        coordinator that was slow past it must not publish: the client has
        classified the commit failed-retryable and re-runs the
        transaction, which a late publish would apply twice. It is checked
        just before the rename, after any hang spent inside the critical
        section."""
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
        if deadline_ms is not None and _now_ms() > deadline_ms:
            # the client gave up already (and may be re-running the
            # transaction): publishing now would apply it twice
            try:
                t.fs.rm_file(tmp)
            except OSError:
                pass
            self._emit_commit(t, version, "expired", t0, txid)
            return False
        dest = posixpath.join(t.manifest_dir, f"v{version:06d}.json")
        ok = put_if_absent(t.fs, tmp, dest)
        self._emit_commit(t, version, "ok" if ok else "conflict", t0, txid)
        return ok

    def _emit_commit(self, t, version, outcome, t0, txid=None):
        tr = _tracer()
        if tr is not None:
            tr.emit(
                "catalog_commit", table=t.name, backend=self.backend,
                version=version, outcome=outcome,
                dur_ms=round((time.perf_counter() - t0) * 1000.0, 3),
                **({"txid": txid} if txid else {}),
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


# ---------------------------------------------------------------------------
# tcp backend: coordinator app + client
# ---------------------------------------------------------------------------


class CatalogCoordinator:
    """The single-writer commit log as a process: every /catalog/* op runs
    under one lock over an FsCatalog, so fence check, WAL intent and
    manifest publish are one critical section. It attaches to the
    process-wide listener through `MetricsServer.attach_app`
    (obs/httpserv.py), as serve mode does: one port carries /metrics,
    /statusz and the catalog."""

    def __init__(self, tracer=None):
        self._fs = FsCatalog()
        self._lock = make_lock("CatalogCoordinator._lock")
        self.tracer = tracer
        # nds-guarded-by: _lock
        self._refs = {}  # path -> _TableRef, under _lock
        self.started_ts_ms = _now_ms()
        #: kept False so obs/httpserv.py's /healthz answers 200
        self.draining = False

    def _ref(self, path: str) -> _TableRef:
        # under the lock: two listener threads racing one path must not
        # each publish their own _TableRef
        with self._lock:
            ref = self._refs.get(path)
            if ref is None:
                ref = self._refs[path] = _TableRef(path)
            return ref

    def _bind(self):
        from ..obs import trace as obs_trace

        return obs_trace.bind(self.tracer) if self.tracer is not None else (
            contextlib.nullcontext()
        )

    # -- startup recovery --------------------------------------------------
    def recover(self, path: str) -> dict:
        """Replay the WAL against the manifest log after a crash: published
        entries are pruned (the commit completed), unpublished ones are
        rolled back: never acknowledged, and replaying them forward would
        apply them twice against the client's own retry. The manifest log
        is whole either way: publishes are atomic renames."""
        t = self._ref(path)
        pruned, rolled_back = 0, 0
        with self._lock, self._bind():
            for base in self._fs._ls(t, _WAL_DIR):
                if not base.endswith(".json"):
                    # a torn WAL temp (crash mid-rename): debris
                    self._fs._rm(t, f"{_WAL_DIR}/{base}")
                    continue
                rec = self._fs._read_json(t, f"{_WAL_DIR}/{base}")
                if rec is None:
                    self._fs._rm(t, f"{_WAL_DIR}/{base}")
                    continue
                version = int(rec.get("version") or 0)
                dest = posixpath.join(
                    t.manifest_dir, f"v{version:06d}.json"
                )
                published = t.fs.exists(dest)
                self._fs._rm(t, f"{_WAL_DIR}/{base}")
                if published:
                    pruned += 1
                else:
                    rolled_back += 1
                    tr = _tracer()
                    if tr is not None:
                        tr.emit(
                            "catalog_commit", table=t.name, backend="tcp",
                            version=version, outcome="rolled_back",
                        )
        return {
            "table": t.name, "pruned": pruned, "rolled_back": rolled_back,
        }

    def recover_warehouse(self, warehouse: str) -> list:
        """Startup recovery over every lakehouse table under a warehouse
        root (a directory owning `_manifests/` is a table)."""
        from ..io.fs import join as fs_join

        fs, root = get_fs(warehouse)
        out = []
        try:
            entries = fs.ls(root, detail=False)
        except OSError:
            return out
        for entry in sorted(entries):
            if fs.isdir(posixpath.join(entry, "_manifests")):
                out.append(self.recover(fs_join(warehouse,
                                                posixpath.basename(entry))))
        return out

    # -- HTTP seam ---------------------------------------------------------
    def handle_http(self, method, path, headers, body):
        """(status, ctype, body, extra_headers) for /catalog/* routes,
        None for anything else (the listener answers 404)."""
        if method == "GET" and path == "/catalog/state":
            return self._reply(200, {"tables": sorted(self._refs)})
        if method != "POST" or not path.startswith("/catalog/"):
            return None
        try:
            payload = json.loads(body.decode("utf-8")) if body else {}
        except (ValueError, UnicodeDecodeError) as exc:
            return self._reply(400, {"error": f"malformed body: {exc}"})
        if not isinstance(payload, dict) or not payload.get("root"):
            return self._reply(400, {"error": "body needs 'root'"})
        try:
            if path == "/catalog/commit":
                return self._reply(200, self._do_commit(payload))
            if path == "/catalog/lease":
                return self._reply(200, self._do_lease(payload))
            if path == "/catalog/fence":
                return self._reply(200, self._do_fence(payload))
        except CatalogFencedError as exc:
            return self._reply(409, {"fenced": True, "error": str(exc)})
        except (KeyError, TypeError, ValueError) as exc:
            return self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
        return None

    @staticmethod
    def _reply(status, obj):
        return (status, "application/json", json.dumps(obj, default=str), ())

    def _do_commit(self, payload) -> dict:
        t = self._ref(str(payload["root"]))
        manifest = dict(payload["manifest"])
        epoch = payload.get("epoch")
        txid = str(payload.get("txid") or uuid.uuid4().hex)
        manifest["txid"] = txid
        version = int(manifest["version"])
        with self._lock, self._bind():
            # idempotency: a client that retries an ambiguous send must
            # not publish twice; the WAL remembers acknowledged txids
            # until recovery or pruning
            prior = self._fs._read_json(t, f"{_WAL_DIR}/{txid}.json")
            if prior is not None:
                dest = posixpath.join(
                    t.manifest_dir, f"v{int(prior['version']):06d}.json"
                )
                if t.fs.exists(dest):
                    return {"published": True,
                            "version": int(prior["version"])}
            if epoch is not None and epoch < self._fs.read_fence(t):
                raise CatalogFencedError(
                    f"{t.path}: writer epoch {epoch} fenced "
                    f"(fence {self._fs.read_fence(t)})"
                )
            # intent before publish: a crash between the two leaves a WAL
            # entry that recovery rolls back (never acknowledged)
            self._fs._write_json(t, f"{_WAL_DIR}/{txid}.json", {
                "version": version, "txid": txid,
            })
            deadline = payload.get("deadline_ms")
            published = self._fs.commit(
                t, manifest, epoch=epoch, txid=txid,
                deadline_ms=int(deadline) if deadline else None,
            )
            if not published:
                # lost to a writer outside the coordinator (a mixed-mode
                # warehouse): drop the intent, the client rebases
                self._fs._rm(t, f"{_WAL_DIR}/{txid}.json")
            else:
                self._prune_wal(t, version)
        return {"published": published, "version": version}

    #: published WAL entries kept for idempotent-retry detection before
    #: pruning (a retry older than this many commits is settled)
    WAL_KEEP = 128

    def _prune_wal(self, t, head_version: int):
        """Bound the journal: entries WAL_KEEP commits behind the head are
        settled and removed. The caller holds the lock."""
        entries = self._fs._ls(t, _WAL_DIR)
        if len(entries) <= self.WAL_KEEP:
            return
        for base in entries:
            if not base.endswith(".json"):
                continue
            rec = self._fs._read_json(t, f"{_WAL_DIR}/{base}")
            if rec is None or (
                int(rec.get("version") or 0) <= head_version - self.WAL_KEEP
            ):
                self._fs._rm(t, f"{_WAL_DIR}/{base}")

    def _do_lease(self, payload) -> dict:
        t = self._ref(str(payload["root"]))
        op = str(payload.get("op") or "")
        with self._lock, self._bind():
            if op == "acquire":
                lease = self._fs.lease_acquire(
                    t, int(payload["version"]), payload.get("files") or (),
                    float(payload.get("ttl_s") or 0.0),
                )
                return {"lease_id": lease.lease_id if lease else None}
            if op == "renew":
                return {"ok": self._fs.lease_renew(
                    t, str(payload["lease_id"]),
                    float(payload.get("ttl_s") or 0.0),
                )}
            if op == "release":
                return {"ok": self._fs.lease_release(
                    t, str(payload["lease_id"])
                )}
            if op == "held":
                return {
                    "files": sorted(self._fs.held_files(t)),
                    "versions": sorted(self._fs.held_versions(t)),
                }
            if op == "sweep":
                return {"removed": self._fs.sweep_expired(t)}
        raise ValueError(f"unknown lease op {op!r}")

    def _do_fence(self, payload) -> dict:
        t = self._ref(str(payload["root"]))
        op = str(payload.get("op") or "")
        with self._lock, self._bind():
            # ttl 0.0 means release now (table._release_writer): only an
            # absent ttl takes the default
            ttl = payload.get("ttl_s")
            ttl = DEFAULT_WRITER_TTL_S if ttl is None else float(ttl)
            if op == "writer_register":
                return self._fs.writer_register(t, ttl)
            if op == "writer_renew":
                return {"ok": self._fs.writer_renew(
                    t, {"id": str(payload["id"])}, ttl,
                )}
            if op == "read":
                return {"fence": self._fs.read_fence(t)}
            if op == "bump":
                return {"fence": self._fs.bump_fence(t)}
        raise ValueError(f"unknown fence op {op!r}")


class HttpCatalog:
    """Client of a CatalogCoordinator, with FsCatalog's API; all state
    lives with the coordinator and, through it, the warehouse, so this
    object is an address."""

    backend = "tcp"

    def __init__(self, url: str):
        from urllib.parse import urlsplit

        parts = urlsplit(url)
        if not parts.hostname or not parts.port:
            raise CatalogError(
                f"bad catalog URL {url!r} (want http://host:port)"
            )
        self.url = url
        self.host = parts.hostname
        self.port = int(parts.port)
        try:
            self.timeout_s = float(
                os.environ.get(CATALOG_TIMEOUT_ENV, "5.0")
            )
        except ValueError:
            self.timeout_s = 5.0
        self._warned_lease = False

    # -- transport ---------------------------------------------------------
    def _post(self, route: str, payload: dict,
              timeout_s: float | None = None) -> dict:
        import http.client

        if faults.active():
            # an injected io fault here makes the coordinator unreachable
            # without killing its process: the CatalogUnreachableError a
            # killed coordinator gives (degraded-mode drills in-process)
            try:
                faults.maybe_fire("catalog:unreachable", kinds=("io", "hang"))
            except faults.FaultError as exc:
                raise CatalogUnreachableError(
                    f"catalog unreachable at {self.url} (injected: {exc})"
                ) from exc
        body = json.dumps(payload).encode("utf-8")
        conn = http.client.HTTPConnection(
            self.host, self.port,
            timeout=self.timeout_s if timeout_s is None else timeout_s,
        )
        try:
            conn.request(
                "POST", route, body=body,
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            data = resp.read()
        except (OSError, http.client.HTTPException) as exc:
            raise CatalogUnreachableError(
                f"catalog unreachable at {self.url} "
                f"({type(exc).__name__}: {exc})"
            ) from exc
        finally:
            conn.close()
        try:
            obj = json.loads(data.decode("utf-8")) if data else {}
        except (ValueError, UnicodeDecodeError):
            obj = {}
        if resp.status == 409 and obj.get("fenced"):
            raise CatalogFencedError(
                obj.get("error") or "writer fenced by catalog"
            )
        if resp.status >= 400:
            raise CatalogError(
                f"catalog {route} failed ({resp.status}): "
                f"{obj.get('error') or data[:200]!r}"
            )
        return obj

    # -- API ---------------------------------------------------------------
    def writer_register(self, t, ttl_s: float) -> dict:
        if faults.active():
            faults.maybe_fire("catalog:lease", kinds=("io", "hang"))
        return self._post(
            "/catalog/fence",
            {"op": "writer_register", "root": t.path, "ttl_s": ttl_s},
        )

    def writer_renew(self, t, token: dict, ttl_s: float) -> bool:
        try:
            return bool(self._post("/catalog/fence", {
                "op": "writer_renew", "root": t.path, "id": token["id"],
                "ttl_s": ttl_s,
            }).get("ok"))
        except CatalogUnreachableError:
            return False  # renewal is best-effort; the commit re-arbitrates

    def read_fence(self, t) -> int:
        return int(self._post(
            "/catalog/fence", {"op": "read", "root": t.path}
        ).get("fence") or 0)

    def bump_fence(self, t) -> int:
        if faults.active():
            faults.maybe_fire("catalog:fence", kinds=("io", "hang"))
        return int(self._post(
            "/catalog/fence", {"op": "bump", "root": t.path}
        ).get("fence") or 0)

    def commit(self, t, manifest: dict, epoch: int | None = None,
               txid: str | None = None) -> bool:
        if faults.active():
            faults.maybe_fire("catalog:commit", kinds=("io", "hang"))
        t0 = time.perf_counter()
        txid = txid or uuid.uuid4().hex
        version = int(manifest["version"])
        try:
            # the publish deadline: how long this client waits (the post's
            # timeout and the ambiguity poll) before it declares the commit
            # failed-retryable; a coordinator slower than that must refuse
            # the late publish, or the client's re-run would apply twice
            deadline_ms = _now_ms() + int(
                (self.timeout_s + self._poll_budget()) * 1000
            )
            resp = self._post("/catalog/commit", {
                "root": t.path, "manifest": manifest, "epoch": epoch,
                "txid": txid, "deadline_ms": deadline_ms,
            })
        except CatalogFencedError:
            self._emit_commit(t, version, "fenced", t0, txid)
            raise
        except CatalogUnreachableError:
            # ambiguous: the coordinator may have published just before it
            # died. The manifest log is shared storage: poll it for this
            # txid before the write counts as failed-retryable (recovery
            # rolls an unpublished intent back, so a retry never applies
            # twice)
            outcome = self._poll_published(t, version, txid)
            if outcome is not None:
                self._emit_commit(
                    t, version, "ok" if outcome else "conflict", t0, txid
                )
                return outcome
            self._emit_commit(t, version, "unreachable", t0, txid)
            raise
        published = bool(resp.get("published"))
        self._emit_commit(
            t, version, "ok" if published else "conflict", t0, txid
        )
        return published

    @staticmethod
    def _poll_budget() -> float:
        try:
            return float(os.environ.get(CATALOG_POLL_ENV, "2.0"))
        except ValueError:
            return 2.0

    def _poll_published(self, t, version: int, txid: str):
        """True: this txid owns the version; False: another does (a lost
        race); None: the version is still unpublished after the window,
        and stays so (the coordinator refuses publishes past the deadline
        this client sent; restart recovery rolls the intent back)."""
        budget = self._poll_budget()
        deadline = time.perf_counter() + budget
        dest = posixpath.join(t.manifest_dir, f"v{version:06d}.json")
        while True:
            try:
                with t.fs.open(dest, "r") as fh:
                    rec = json.load(fh)
                return rec.get("txid") == txid
            except (OSError, ValueError):
                pass
            if time.perf_counter() >= deadline:
                return None
            time.sleep(min(0.05, budget))

    def _emit_commit(self, t, version, outcome, t0, txid):
        tr = _tracer()
        if tr is not None:
            tr.emit(
                "catalog_commit", table=t.name, backend=self.backend,
                version=version, outcome=outcome, txid=txid,
                dur_ms=round((time.perf_counter() - t0) * 1000.0, 3),
            )

    # -- leases ------------------------------------------------------------
    def lease_acquire(self, t, version: int, files, ttl_s: float):
        if faults.active():
            faults.maybe_fire("catalog:lease", kinds=("io", "hang"))
        try:
            lid = self._post("/catalog/lease", {
                "op": "acquire", "root": t.path, "version": int(version),
                "files": sorted(str(f) for f in files), "ttl_s": ttl_s,
            }).get("lease_id")
        except CatalogUnreachableError:
            # reads degrade gracefully: the pin still holds in the
            # process's lease table; only other hosts lose sight of it
            # until the coordinator returns
            if not self._warned_lease:
                self._warned_lease = True
                print(
                    f"catalog: coordinator {self.url} unreachable; reader "
                    f"leases degrade to process-local until it returns"
                )
            return None
        if not lid:
            return None
        tr = _tracer()
        if tr is not None:
            tr.emit(
                "catalog_lease", op="acquire", backend=self.backend,
                outcome="ok", table=t.name, version=int(version),
            )
        return RemoteLease(self, _TableRef(t.path), str(lid))

    def lease_renew(self, ref, lease_id: str, ttl_s: float) -> bool:
        try:
            # renewal runs on the memory sampler's heartbeat thread: a
            # short cap keeps a slow coordinator from stalling it
            return bool(self._post("/catalog/lease", {
                "op": "renew", "root": ref.path, "lease_id": lease_id,
                "ttl_s": ttl_s,
            }, timeout_s=min(self.timeout_s, 1.0)).get("ok"))
        except CatalogUnreachableError:
            return False

    def lease_release(self, ref, lease_id: str) -> bool:
        try:
            return bool(self._post("/catalog/lease", {
                "op": "release", "root": ref.path, "lease_id": lease_id,
            }).get("ok"))
        except CatalogUnreachableError:
            return False  # TTL expiry is the backstop

    def held_files(self, t) -> set:
        # no fallback when unreachable, on purpose: vacuum asks this, and
        # a vacuum that cannot see remote leases must fail, not delete
        return set(self._post(
            "/catalog/lease", {"op": "held", "root": t.path}
        ).get("files") or ())

    def held_versions(self, t) -> set:
        return {int(v) for v in self._post(
            "/catalog/lease", {"op": "held", "root": t.path}
        ).get("versions") or ()}

    def sweep_expired(self, t) -> int:
        try:
            return int(self._post(
                "/catalog/lease", {"op": "sweep", "root": t.path}
            ).get("removed") or 0)
        except CatalogUnreachableError:
            return 0
