"""In-process reader-lease table: the snapshot pins vacuum must respect;
the port of nds_tpu/lakehouse/leases.py.

Iceberg/Delta get reader safety from their catalogs: `expire_snapshots`
never deletes a data file a live reader's snapshot still references,
because readers resolve snapshots through the same catalog service
(reference: nds/nds_maintenance.py:118-202 runs snapshot expiry against
exactly such a catalog). This engine has no catalog service — readers pin
manifest versions in-process (engine/session.py resolves each lake scan's
version once at plan time), so the equivalent safety record lives here: a
process-wide table of (table root, version, file list) leases with a TTL.

`LakehouseTable.vacuum` consults `held_files` and never deletes a file a
live lease covers; `expire_snapshots` keeps leased versions' manifests.
Leases record the snapshot's FILE LIST at acquire time, so even a lease
whose manifest has since been expired keeps protecting its files.

The TTL (conf `engine.lake_lease_ttl_s` / env NDS_LAKE_LEASE_TTL_S,
default 300 s) bounds leakage: a crashed or abandoned reader's lease
expires instead of pinning files forever. Pins renew on re-resolution, so
a healthy long query stream never loses its lease mid-run. The table is
process-wide on purpose — concurrent streams (thread-mode throughput,
the maintenance-under-load phase) share one lease table exactly like
they share one fault registry; cross-process vacuum safety is the TTL's
job (vacuum only races readers inside the maintenance window, and the
reference's single-catalog deployments have the same process scope).
"""

from __future__ import annotations

import itertools
import os
from time import monotonic as _monotonic

from ..engine.lockdebug import make_lock

#: default reader-lease TTL in seconds (engine.lake_lease_ttl_s /
#: NDS_LAKE_LEASE_TTL_S): long enough for any benchmarked query, short
#: enough that a crashed reader never blocks vacuum for more than one
#: maintenance window
DEFAULT_LEASE_TTL_S = 300.0


def resolve_lease_ttl(conf: dict | None = None) -> float:
    v = None
    if conf:
        v = conf.get("engine.lake_lease_ttl_s")
    if v is None:
        v = os.environ.get("NDS_LAKE_LEASE_TTL_S")
    try:
        return max(float(v), 0.0) if v is not None and v != "" else (
            DEFAULT_LEASE_TTL_S
        )
    except (TypeError, ValueError):
        return DEFAULT_LEASE_TTL_S


class ReaderLeases:
    """Thread-safe lease table. Leases are cheap dict records; expired
    entries are pruned lazily on every read/write, so an idle process
    holds at most the leases of its last activity burst."""

    def __init__(self):
        self._lock = make_lock("ReaderLeases._lock")
        self._ids = itertools.count(1)
        # nds-guarded-by: _lock
        self._leases = {}  # id -> lease record, under _lock

    def acquire(self, root: str, version: int, files, ttl_s: float,
                remote=None) -> int:
        """Register a pin of `version` over `files` (manifest-relative
        paths) of the table at `root`; returns the lease id. `remote` is
        an optional catalog lease handle (lakehouse/catalog.py
        RemoteLease): when present, renew/release forward to it — this
        table is then the local cache of catalog state, and vacuum on
        OTHER hosts sees the catalog half."""
        lease_id = next(self._ids)
        rec = {
            "root": str(root),
            "version": int(version),
            "files": frozenset(str(f) for f in files),
            "expires": _monotonic() + float(ttl_s),
            "remote": remote,
        }
        with self._lock:
            self._prune_locked(_monotonic())
            self._leases[lease_id] = rec
        return lease_id

    def renew(self, lease_id: int, ttl_s: float) -> bool:
        """Extend a live lease; False when it already expired/was released
        (caller should re-acquire). Forwards to the catalog half when the
        lease was written through — THROTTLED to once per ttl/3 (with a
        short failure backoff), because renew() runs on the report's
        heartbeat thread and a blocking remote call every beat would
        stall the beat. A missed
        remote renewal falls back to the remote TTL, never blocks the
        local pin."""
        now = _monotonic()
        with self._lock:
            self._prune_locked(now)
            rec = self._leases.get(lease_id)
            if rec is None:
                return False
            rec["expires"] = now + float(ttl_s)
            remote = rec.get("remote")
            if remote is not None and now < rec.get("remote_next", 0.0):
                remote = None  # remote half renewed recently enough
            if remote is not None:
                # claim the slot BEFORE the (unlocked) network call so
                # concurrent renewers don't pile onto a slow coordinator
                rec["remote_next"] = now + max(float(ttl_s) / 3.0, 0.05)
        if remote is not None:
            try:
                if not remote.renew(ttl_s):
                    raise OSError("remote lease renewal refused")
            except Exception:
                # remote TTL is the backstop; back off so a down
                # coordinator costs at most one short timeout per 5s
                with self._lock:
                    rec = self._leases.get(lease_id)
                    if rec is not None:
                        rec["remote_next"] = _monotonic() + 5.0
        return True

    def release(self, lease_id: int) -> bool:
        with self._lock:
            rec = self._leases.pop(lease_id, None)
        if rec is not None and rec.get("remote") is not None:
            try:
                rec["remote"].release()
            except Exception:
                pass  # remote TTL expiry is the backstop
        return rec is not None

    def _prune_locked(self, now: float):
        dead = [i for i, r in self._leases.items() if r["expires"] <= now]
        for i in dead:
            del self._leases[i]

    # -- vacuum-side reads -------------------------------------------------
    def held_versions(self, root: str) -> set:
        root = str(root)
        with self._lock:
            self._prune_locked(_monotonic())
            return {
                r["version"] for r in self._leases.values()
                if r["root"] == root
            }

    def held_files(self, root: str) -> set:
        """Manifest-relative file paths any live lease on `root` covers."""
        root = str(root)
        out = set()
        with self._lock:
            self._prune_locked(_monotonic())
            for r in self._leases.values():
                if r["root"] == root:
                    out |= r["files"]
        return out

    def live_count(self, root: str | None = None) -> int:
        with self._lock:
            self._prune_locked(_monotonic())
            if root is None:
                return len(self._leases)
            root = str(root)
            return sum(
                1 for r in self._leases.values() if r["root"] == root
            )


#: the process-wide lease table (module singleton, like faults._registry):
#: every session's pins and every table's vacuum meet here
LEASES = ReaderLeases()
