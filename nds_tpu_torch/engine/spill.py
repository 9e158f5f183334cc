"""Host-RAM spill pool: the device -> host tier of the out-of-core paths
(the port of nds_tpu/engine/spill.py).

The executor's out-of-core paths (exec._spilled_join / _spilled_take /
_spilled_distinct) stage their partitioned join outputs, sorted runs and
distinct partitions here instead of on the card, and assemble them back
onto the session's device once.

Tiering: a spilled segment lands in host RAM first (its live rows only,
copied blocking: a `non_blocking` copy into pageable memory could be read
before it lands). When the pool's host budget (`engine.spill_pool_bytes` /
NDS_SPILL_POOL_BYTES) is exceeded, or `SpillPool.evict_host` pre-empts,
the least recently used segments are written to `engine.spill_dir` /
NDS_SPILL_DIR as atomic `.npz` files (temp name + rename) and their RAM
buffers dropped; reads reload them. String dictionaries stay in RAM: they
are host-side arrays shared by reference with live device tables.

Crash hygiene: each pool writes one `spill-manifest-<pid>.json` (atomic,
fingerprint-guarded) before its first disk segment. `sweep_orphans`
removes segment and temp files whose owning process is dead; a Session
runs it once per process and directory.

Failure domain: segment eviction, write and read are the `spill:evict`,
`spill:write` and `spill:read` fault-injection points (io and crash rules
only; an injected fault keeps its own classifiable identity, as in the
reference). Real disk errors wrap into SpillIOError, which faults.classify
maps to `io_transient`, so the report ladder's io_backoff_retry rung owns
them.
This module imports no pyarrow: only re-unifying differing string
dictionaries in `assemble_segments` does, inside that branch.
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import time
import uuid
from collections import OrderedDict

import numpy as np
import torch

from .. import faults
from .lockdebug import make_lock

#: default host-RAM budget for spilled segments; beyond it segments tier
#: down to spill_dir
DEFAULT_POOL_BYTES = 4 << 30

#: partition/run count when out-of-core execution is forced without an
#: explicit `engine.spill_partitions` (the budgeter's `spill` verdict
#: sizes partitions itself)
DEFAULT_FORCE_PARTITIONS = 8

#: manifest fingerprint: sweep_orphans only touches files whose manifest
#: carries this magic (a shared temp dir may hold foreign files)
_MANIFEST_MAGIC = "nds-tpu-spill-pool-v1"

_SEG_PREFIX = "spill-"


class SpillError(Exception):
    pass


class SpillIOError(SpillError, OSError):
    """A spill segment write or read failed at the filesystem tier."""


def resolve_spill_dir(conf: dict | None = None) -> str | None:
    """Disk tier directory: conf `engine.spill_dir`, env NDS_SPILL_DIR,
    else a directory under the system temp dir. An explicit "" or "0"
    disables the disk tier (RAM-only pool)."""
    v = conf.get("engine.spill_dir") if conf else None
    if v is None:
        v = os.environ.get("NDS_SPILL_DIR")
    if v is None:
        return os.path.join(tempfile.gettempdir(), "nds-tpu-spill")
    v = str(v)
    return v if v not in ("", "0") else None


#: `auto` pool sizing: 1/4 of physical host RAM, power of two, clamped
_AUTO_POOL_FRACTION = 4
_AUTO_POOL_LO = 1 << 30
_AUTO_POOL_HI = 64 << 30


def resolve_pool_bytes(conf: dict | None = None) -> int:
    v = conf.get("engine.spill_pool_bytes") if conf else None
    v = v if v is not None else os.environ.get("NDS_SPILL_POOL_BYTES")
    if v is not None and str(v).lower() == "auto":
        from ..analysis.budget import derive_share_bytes, host_ram_bytes

        return derive_share_bytes(
            host_ram_bytes(), _AUTO_POOL_FRACTION,
            _AUTO_POOL_LO, _AUTO_POOL_HI,
        )
    try:
        return max(int(v), 0) if v is not None and v != "" else DEFAULT_POOL_BYTES
    except (TypeError, ValueError):
        return DEFAULT_POOL_BYTES


def _host(x: torch.Tensor, n: int) -> np.ndarray:
    """The first `n` entries of `x` as a numpy array of their own: a
    blocking copy off the card, or a copy of a CPU tensor (so that the pool
    never aliases a live device buffer)."""
    x = x[:n]
    if x.device.type == "cpu":
        return x.numpy().copy()
    return x.cpu().numpy()


class SpillSegment:
    """One spilled table: per-column host buffers (or a disk path once
    evicted) and the metadata to rebuild a device Table exactly."""

    __slots__ = (
        "sid", "nrows", "nbytes", "names", "dtypes", "dictionaries",
        "datas", "valids", "path",
    )

    def __init__(self, sid, nrows, names, dtypes, dictionaries, datas, valids):
        self.sid = sid
        self.nrows = nrows
        self.names = names
        self.dtypes = dtypes
        self.dictionaries = dictionaries  # always host-resident
        self.datas = datas  # list[np.ndarray] | None when on disk
        self.valids = valids  # list[np.ndarray | None] | None when on disk
        self.path = None
        self.nbytes = sum(a.nbytes for a in datas) + sum(
            v.nbytes for v in valids if v is not None
        )


class SpillPool:
    """Budgeted host-side pool of spilled segments with an LRU disk tier.

    Thread-safe (one lock around segment bookkeeping); device transfers and
    file IO run outside the lock. `stats` counts bytes into and out of the
    pool, evictions and segments, and the bytes the disk tier wrote and
    read back."""

    def __init__(self, budget_bytes: int | None = None,
                 spill_dir: str | None = None, app_id: str | None = None):
        self.budget = (
            budget_bytes if budget_bytes is not None else DEFAULT_POOL_BYTES
        )
        self.dir = spill_dir
        self.app = app_id or f"pid{os.getpid()}-{uuid.uuid4().hex[:6]}"
        self._seq = itertools.count()
        self._lock = make_lock("SpillPool._lock")
        # nds-guarded-by: _lock
        self._host = OrderedDict()  # sid -> RAM-resident segment, LRU order
        # nds-guarded-by: _lock
        self._all = {}  # sid -> segment
        self.host_bytes = 0  # nds-guarded-by: _lock
        self.stats = {  # nds-guarded-by: _lock
            "bytes_in": 0, "bytes_out": 0, "evictions": 0, "segments": 0,
            "disk_bytes_written": 0, "disk_bytes_read": 0,
        }
        # set once by the disk-tier writer; a repeated manifest write is
        # an atomic replace of identical content
        self._manifest_written = False  # nds-guarded-by: none
        self._ram_only_warned = False  # nds-guarded-by: _lock

    # ------------------------------------------------------------------
    def put(self, table) -> SpillSegment:
        """Spill a device Table's live rows to the host tier, trimmed to
        the live row count (one host sync for the count when it is still
        on the device) so the pool never holds capacity padding."""
        table = table.compacted()
        nrows = table.nrows
        names = list(table.columns)
        cols = list(table.columns.values())
        datas = [_host(c.data, nrows) for c in cols]
        valids = [None if c.valid is None else _host(c.valid, nrows)
                  for c in cols]
        seg = SpillSegment(
            next(self._seq), nrows, names,
            [c.dtype for c in cols], [c.dictionary for c in cols],
            datas, valids,
        )
        with self._lock:
            self._all[seg.sid] = seg
            self._host[seg.sid] = seg
            self.host_bytes += seg.nbytes
            self.stats["bytes_in"] += seg.nbytes
            self.stats["segments"] += 1
        self._enforce_budget()
        return seg

    def read(self, seg: SpillSegment):
        """[(name, data, valid, dtype, dictionary)] for one segment,
        reloading from the disk tier when evicted. The RAM-or-disk decision
        is taken under the lock: an eviction nulls the RAM buffers only
        after the disk file is committed and only under the same lock, so a
        reader sees live arrays or a readable path."""
        with self._lock:
            self.stats["bytes_out"] += seg.nbytes
            if seg.sid in self._host:
                self._host.move_to_end(seg.sid)
            datas, valids = seg.datas, seg.valids
        if datas is None:
            datas, valids = self._read_segment_file(seg)
            with self._lock:
                self.stats["disk_bytes_read"] += seg.nbytes
        return [
            (n, d, v, dt, dic)
            for n, d, v, dt, dic in zip(
                seg.names, datas, valids, seg.dtypes, seg.dictionaries
            )
        ]

    def release(self, segments):
        """Drop segments (RAM and disk alike); disk files are unlinked best
        effort, and sweep_orphans is the backstop."""
        with self._lock:
            for seg in segments:
                if self._all.pop(seg.sid, None) is None:
                    continue
                if self._host.pop(seg.sid, None) is not None:
                    self.host_bytes -= seg.nbytes
        for seg in segments:
            if seg.path is not None:
                try:
                    os.unlink(seg.path)
                except OSError:
                    pass
                seg.path = None

    def evict_host(self) -> int:
        """Move every RAM-resident segment to the disk tier (relieve host
        memory before the allocator fails). Returns the number of segments
        evicted; 0 when the disk tier is disabled."""
        if self.dir is None:
            return 0
        n = 0
        while True:
            with self._lock:
                if not self._host:
                    return n
                sid, seg = next(iter(self._host.items()))
                self._host.pop(sid)
                self.host_bytes -= seg.nbytes
            self._evict_checked(seg)
            n += 1

    def close(self):
        self.release(list(self._all.values()))
        if self._manifest_written:
            try:
                os.unlink(_manifest_path(self.dir, os.getpid()))
            except OSError:
                pass
            self._manifest_written = False

    # ------------------------------------------------------------------
    def _enforce_budget(self):
        while True:
            with self._lock:
                if self.host_bytes <= self.budget or len(self._host) <= 1:
                    return
                if self.dir is None:
                    # no disk tier: the budget is advisory; warn once and
                    # keep the segments (data is never dropped)
                    if not self._ram_only_warned:
                        self._ram_only_warned = True
                        print(
                            "spill: pool over budget "
                            f"({self.host_bytes} > {self.budget}B) with no "
                            "engine.spill_dir; keeping segments in host RAM"
                        )
                    return
                sid, seg = next(iter(self._host.items()))  # LRU victim
                self._host.pop(sid)
                self.host_bytes -= seg.nbytes
            self._evict_checked(seg)

    def _evict_checked(self, seg: SpillSegment):
        """Evict one segment; on any failure the segment is re-registered
        in RAM before the error propagates, so no data is dropped."""
        try:
            faults.maybe_fire("spill:evict", kinds=("io", "crash"))
            dest = self._write_segment_file(seg)
        except BaseException:
            with self._lock:
                if seg.sid in self._all:
                    self._host[seg.sid] = seg
                    self.host_bytes += seg.nbytes
            raise
        unlink_now = False
        with self._lock:
            # publish the tier change atomically with respect to read():
            # the path first, the RAM buffers nulled in the same section
            seg.path = dest
            seg.datas = None
            seg.valids = None
            self.stats["evictions"] += 1
            self.stats["disk_bytes_written"] += seg.nbytes
            if seg.sid not in self._all:
                # released mid-eviction: nobody reads or releases this
                # file again, so it goes now
                unlink_now = True
                seg.path = None
        if unlink_now:
            try:
                os.unlink(dest)
            except OSError:
                pass

    # -- disk tier ------------------------------------------------------
    def _seg_path(self, seg: SpillSegment) -> str:
        return os.path.join(self.dir, f"{_SEG_PREFIX}{self.app}-{seg.sid}.npz")

    def _write_segment_file(self, seg: SpillSegment) -> str:
        """Atomic segment write: a temp sibling + os.replace, so a crash
        mid-write leaves only a `.tmp-*` file the orphan sweep removes.
        Returns the committed path; the caller publishes the tier change
        under the pool lock."""
        faults.maybe_fire("spill:write", kinds=("io", "crash"))
        dest = self._seg_path(seg)
        tmp = f"{dest}.tmp-{uuid.uuid4().hex[:8]}"
        arrays = {}
        for i, (d, v) in enumerate(zip(seg.datas, seg.valids)):
            arrays[f"d{i}"] = d
            if v is not None:
                arrays[f"v{i}"] = v
        try:
            self._ensure_manifest()
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, dest)
        except faults.FaultError:
            raise  # injected faults keep their own (classifiable) identity
        except OSError as exc:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise SpillIOError(
                f"spill segment write failed ({dest}): {exc}"
            ) from exc
        return dest

    def _read_segment_file(self, seg: SpillSegment):
        faults.maybe_fire("spill:read", kinds=("io", "crash"))
        try:
            with np.load(seg.path) as z:
                datas = [z[f"d{i}"] for i in range(len(seg.names))]
                valids = [
                    z[f"v{i}"] if f"v{i}" in z.files else None
                    for i in range(len(seg.names))
                ]
        except faults.FaultError:
            raise
        except (OSError, KeyError, ValueError) as exc:
            raise SpillIOError(
                f"spill segment read failed ({seg.path}): {exc}"
            ) from exc
        return datas, valids

    def _ensure_manifest(self):
        """Write this process's pool manifest (atomic) before the first
        disk segment: the liveness record sweep_orphans keys on."""
        if self._manifest_written:
            return
        os.makedirs(self.dir, exist_ok=True)
        path = _manifest_path(self.dir, os.getpid())
        tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
        rec = {
            "magic": _MANIFEST_MAGIC,
            "pid": os.getpid(),
            "app": self.app,
            "created": int(time.time()),
        }
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(rec, f)
        os.replace(tmp, path)
        self._manifest_written = True


# ---------------------------------------------------------------------------
# crash hygiene: orphaned-segment sweep
# ---------------------------------------------------------------------------


def _manifest_path(spill_dir: str, pid: int) -> str:
    return os.path.join(spill_dir, f"spill-manifest-{pid}.json")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True  # exists but owned elsewhere: treat as alive
    return True


def sweep_orphans(spill_dir: str) -> int:
    """Remove spill segments (and manifests, and torn `.tmp-*` files) left
    behind by a crashed process. Only files of the pool's own naming scheme
    are touched, and only when their manifest carries the pool magic with
    a dead pid (or no manifest claims them): a shared temp directory's
    foreign files are never at risk. Returns the number of files removed."""
    if not spill_dir or not os.path.isdir(spill_dir):
        return 0
    try:
        entries = os.listdir(spill_dir)
    except OSError:
        return 0
    live_apps = set()
    removed = 0
    for name in entries:
        if not (name.startswith("spill-manifest-") and name.endswith(".json")):
            continue
        path = os.path.join(spill_dir, name)
        try:
            with open(path, encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue  # torn or foreign manifest: leave it alone
        if rec.get("magic") != _MANIFEST_MAGIC:
            continue  # fingerprint guard: not ours
        pid = rec.get("pid")
        if pid == os.getpid() or (isinstance(pid, int) and _pid_alive(pid)):
            live_apps.add(rec.get("app"))
            continue
        try:
            os.unlink(path)
            removed += 1
        except OSError:
            pass
    for name in entries:
        if not name.startswith(_SEG_PREFIX):
            continue
        base = name
        if ".tmp-" in base:
            base = base.split(".tmp-", 1)[0]
        if name.startswith("spill-manifest-"):
            # a torn manifest write (.tmp-*) of a crashed process: the
            # owning pid is in the name (committed manifests were handled
            # above)
            if ".tmp-" not in name or not base.endswith(".json"):
                continue
            try:
                pid = int(base[len("spill-manifest-"):-len(".json")])
            except ValueError:
                continue
            if pid != os.getpid() and not _pid_alive(pid):
                try:
                    os.unlink(os.path.join(spill_dir, name))
                    removed += 1
                except OSError:
                    pass
            continue
        if not base.endswith(".npz"):
            continue
        # name format: spill-<app>-<sid>.npz; app may itself hold dashes
        stem = base[len(_SEG_PREFIX):-len(".npz")]
        app = stem.rsplit("-", 1)[0] if "-" in stem else stem
        if app in live_apps:
            continue
        try:
            os.unlink(os.path.join(spill_dir, name))
            removed += 1
        except OSError:
            pass
    if removed:
        print(f"spill: swept {removed} orphaned file(s) from {spill_dir}")
    return removed


# one sweep per (process, directory): re-listing the spill dir for every
# session buys nothing; a race costs at most a second, idempotent sweep.
# A process-lifetime once-latch, not per-stream state.
# nds-lint: disable=mutable-module-global
_SWEPT_DIRS = set()


def sweep_at_session_start(spill_dir: str | None):
    if not spill_dir or spill_dir in _SWEPT_DIRS:
        return
    _SWEPT_DIRS.add(spill_dir)
    sweep_orphans(spill_dir)


# ---------------------------------------------------------------------------
# segment reassembly (executor side)
# ---------------------------------------------------------------------------


def _unify_dictionaries(dicts, datas):
    """(one dictionary, codes remapped into it) for segments whose string
    dictionaries are different objects."""
    import pyarrow as pa
    import pyarrow.compute as pc

    casted = [
        (d if d is not None else pa.array([], pa.string())).cast(pa.string())
        for d in dicts
    ]
    dictionary = pc.unique(pa.concat_arrays(casted))
    remapped = []
    for d, arr in zip(casted, datas):
        if len(d) == 0:
            remapped.append(arr)
            continue
        remap = (
            pc.index_in(d, dictionary)
            .to_numpy(zero_copy_only=False)
            .astype(np.int32)
        )
        remapped.append(remap[np.clip(arr, 0, len(d) - 1)])
    return dictionary, remapped


def assemble_segments(pool: SpillPool, segments, device):
    """One Table on `device` from an ordered list of spilled segments:
    per-column host concatenation (string dictionaries re-unified when
    segments carry different ones), padded to a capacity bucket and
    uploaded once per column. Row order is the segment order: the
    out-of-core paths choose segment boundaries so that this matches the
    direct path (sort) or is a row order SQL leaves open (join, distinct)."""
    from .columnar import Column, Table, bucket_cap

    if not segments:
        raise SpillError("assemble_segments needs at least one segment")
    reads = [pool.read(s) for s in segments]
    names = [n for n, *_ in reads[0]]
    total = sum(s.nrows for s in segments)
    cap = bucket_cap(max(total, 1))
    cols = {}
    for ci, name in enumerate(names):
        dtype = reads[0][ci][3]
        dicts = [r[ci][4] for r in reads]
        datas = [r[ci][1] for r in reads]
        dictionary = None
        if any(d is not None for d in dicts):
            first = dicts[0]
            if all(d is first for d in dicts):
                # partitions of one input share the dictionary object:
                # the codes compare directly
                dictionary = first
            else:
                dictionary, datas = _unify_dictionaries(dicts, datas)
        data = np.concatenate(datas) if len(datas) > 1 else datas[0]
        buf = np.zeros(cap, dtype=data.dtype)
        buf[:total] = data
        valids = [r[ci][2] for r in reads]
        valid = None
        if any(v is not None for v in valids):
            vbuf = np.zeros(cap, dtype=bool)
            off = 0
            for seg, v in zip(segments, valids):
                vbuf[off:off + seg.nrows] = True if v is None else v
                off += seg.nrows
            valid = torch.from_numpy(vbuf).to(device)
        cols[name] = Column(torch.from_numpy(buf).to(device), dtype, valid,
                            dictionary)
    return Table(cols, total)
