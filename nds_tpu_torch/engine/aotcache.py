"""Persistent cache of fused-pipeline builds and kernel promotion
verdicts: build each pipeline once per environment, not once per process.

The port of nds_tpu/engine/aotcache.py. The JAX package serializes each
compiled XLA executable here; eager PyTorch compiles nothing, so an entry
holds what a fresh process would otherwise redo: a fused entry's build
products (engine/fuse.py: the host-product tape as arrays and
dictionaries, the aggregate tail's bounds and layout) and its
fuse-or-pin verdict. A fresh process's first call of a pipeline loads
them instead of building.

Key discipline (a wrong load is impossible, a mismatch is a clean miss):
every entry is keyed by the full dict of everything that changes the
products — pipeline kind + stage fingerprint (plan.fingerprint, stable
across processes), a CONTENT-stable input signature (dtypes, validity,
dictionary content hashes, aggregate-key stats bounds), the input
buffers' dtypes, donation slots (always none: donation changes no
product), torch + CUDA + nds_tpu_torch versions, the device platform,
name, capability and count, and the relevant engine conf (fuse_agg /
pallas_agg). The key hashes into the entry filename, but `load`
re-verifies the FULL key dict recorded in the entry header (a filename
hash collision reads as a miss, never a wrong load) and the payload
checksum (a torn or corrupt body quarantines the file and reads as a
miss, never a crash).

Entry format: `aot-<sha256[:40]>.bin` = 8-byte magic "NDSTAOT1",
8-byte big-endian header length, canonical-JSON header (full key +
payload sha256 + sizes), then the pickled payload dict. Pickle carries
the trust of the user-owned cache directory it lives in.

Production treatment (the spill pool / lakehouse patterns):
  * atomic writes — pid-tempfile sibling + os.replace, so a concurrent
    two-process warm has one winner and a crash leaves only a `.tmp-<pid>-`
    file the orphan sweep removes once the pid is dead;
  * byte budget with LRU eviction — `engine.aot_cache_bytes` /
    NDS_AOT_CACHE_BYTES, default a power-of-two share of the cache
    volume's free disk (analysis/budget.derive_share_bytes); hits refresh
    mtime so eviction is least-recently-USED; a handle scans the
    directory when its own count of the committed bytes passes the
    budget, not on every store (other processes' stores count at its
    next scan);
  * crash-orphan sweep at session start (once per process per directory);
  * hit / miss / store / quarantine counters on the cache object
    (`stats`), and an `aot_cache` trace event for each load, store,
    eviction and vacuum (a `load` / `hit` in a fresh process is the trace's
    evidence that a build came from disk);
  * `aot:write` / `aot:read` fault-injection sites (io/crash kinds):
    injected faults keep their classifiable identity, while REAL
    filesystem errors degrade the cache (stores disabled / entry
    quarantined) and never fail a query.

The same directory persists the kernel promotion verdicts
(`PromotionStore`): the measured plain-vs-kernel A/B of
engine.pallas_agg / pallas_join / pallas_sort `auto`, keyed by (kernel,
shape, environment), so each shape is measured once per environment.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import time
from collections import OrderedDict

from .. import faults
from .. import __version__ as _NDS_VERSION
from .lockdebug import make_lock

_MAGIC = b"NDSTAOT1"
_ENTRY_PREFIX = "aot-"
_ENTRY_SUFFIX = ".bin"
_QUARANTINE_PREFIX = "quarantine-"
_PROMO_FILE = "promotions.json"

#: auto-budget derivation: 1/16 of the cache volume's free disk, clamped —
#: the union-window / spill-pool share-of-a-resource sizing
_BUDGET_FRACTION = 16
_BUDGET_LO = 256 << 20
_BUDGET_HI = 32 << 30


def resolve_aot_cache_dir(conf: dict | None = None) -> str | None:
    """Cache directory: conf `engine.aot_cache_dir`, env NDS_AOT_CACHE_DIR,
    else a user-owned XDG default of the port's own. Explicit "" / "0"
    disables the cache."""
    v = None
    if conf:
        v = conf.get("engine.aot_cache_dir")
    if v is None:
        v = os.environ.get("NDS_AOT_CACHE_DIR")
    if v is None:
        return os.path.join(
            os.environ.get("XDG_CACHE_HOME")
            or os.path.join(os.path.expanduser("~"), ".cache"),
            "nds_torch_aot",
        )
    v = str(v)
    return v if v not in ("", "0") else None


def resolve_aot_cache_bytes(conf: dict | None = None,
                            cache_dir: str | None = None) -> int:
    """Entry byte budget: conf `engine.aot_cache_bytes` /
    NDS_AOT_CACHE_BYTES; unset or "auto" derives a power-of-two share of
    the cache volume's free disk (budget.derive_share_bytes, the formula
    the union window and the spill pool use)."""
    v = None
    if conf:
        v = conf.get("engine.aot_cache_bytes")
    if v is None:
        v = os.environ.get("NDS_AOT_CACHE_BYTES")
    if v is not None and str(v).lower() not in ("", "auto"):
        try:
            return max(int(v), 0)
        except (TypeError, ValueError):
            pass
    import shutil

    from ..analysis.budget import derive_share_bytes

    free = None
    try:
        probe = cache_dir
        while probe and not os.path.isdir(probe):
            parent = os.path.dirname(probe)
            if parent == probe:
                break
            probe = parent
        if probe:
            free = shutil.disk_usage(probe).free
    except OSError:
        free = None
    if not free:
        free = _BUDGET_HI * _BUDGET_FRACTION  # unknown volume: cap at HI
    return derive_share_bytes(free, _BUDGET_FRACTION, _BUDGET_LO, _BUDGET_HI)


def environment_key(device=None) -> dict:
    """The environment half of every entry key: everything OUTSIDE the
    pipeline that changes (or invalidates) the stored products. A mismatch
    in any field is a clean miss — a directory shared across torch
    upgrades or card generations never serves a stale entry."""
    import torch

    dev = torch.device(device if device is not None else "cpu")
    env = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nds": _NDS_VERSION,
        "platform": dev.type,
        "device_name": "cpu",
        "capability": None,
        "device_count": 0,
    }
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else 0
        env["device_name"] = torch.cuda.get_device_name(index)
        env["capability"] = list(torch.cuda.get_device_capability(index))
        env["device_count"] = torch.cuda.device_count()
    return env


def dictionary_hash(dictionary) -> str:
    """Content hash of a column dictionary (host-side Arrow string array):
    the in-process signature keys dictionaries by id(), truthful only
    while the object lives; an on-disk key must survive the process, so it
    hashes the VALUES — each entry's byte length (-1 for a NULL), then
    their bytes end to end, read from the Arrow buffers without a Python
    loop. Runs at build-resolution time only, never per call."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc

    h = hashlib.sha256()
    try:
        a = dictionary.cast(pa.large_string())
        h.update(pc.binary_length(a).fill_null(-1).to_numpy(
            zero_copy_only=False).astype("<i8").tobytes())
        a = pa.concat_arrays([a.fill_null("")])
        if len(a):
            offs = np.frombuffer(a.buffers()[1], dtype="<i8")[
                a.offset:a.offset + len(a) + 1]
            h.update(memoryview(a.buffers()[2])[offs[0]:offs[-1]])
    except Exception:
        # a foreign dictionary object: key on its repr — at worst a
        # conservative extra miss, never a wrong load
        h.update(repr(dictionary).encode("utf-8", "replace"))
    return h.hexdigest()[:24]


def canonical_key_bytes(key: dict) -> bytes:
    return json.dumps(key, sort_keys=True, default=str).encode("utf-8")


def _entry_name(key: dict) -> str:
    digest = hashlib.sha256(canonical_key_bytes(key)).hexdigest()[:40]
    return f"{_ENTRY_PREFIX}{digest}{_ENTRY_SUFFIX}"


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True
    return True


def _tmp_name(dest: str) -> str:
    return (f"{dest}.tmp-{os.getpid()}-"
            f"{hashlib.sha256(os.urandom(8)).hexdigest()[:6]}")


class AotCache:
    """One process's handle on a shared on-disk cache of fused builds.

    Thread-safe (one lock around the stats and the dictionary-hash memo;
    file IO runs unlocked — atomicity comes from tempfile + rename, and
    concurrent writers of the SAME key are idempotent last-writer-wins).
    Across processes no lock is needed: readers only ever see fully
    renamed entries, and an eviction's unlink reads as a miss."""

    def __init__(self, cache_dir: str, budget_bytes: int, device=None,
                 tracer=None):
        self.dir = str(cache_dir)
        self.budget = int(budget_bytes)
        # callable returning the live tracer (a session's tracer may be
        # closed and replaced; a captured object would emit into a closed
        # file)
        self._tracer = tracer if callable(tracer) else (lambda: tracer)
        self._lock = make_lock("AotCache._lock")
        self._env = environment_key(device)
        # bounded LRU: the tuple's strong dictionary ref keeps the id()
        # key truthful, and the cap keeps a long-lived session that
        # rotates datasets from pinning every dictionary it ever hashed
        # nds-guarded-by: _lock
        self._dict_hashes = OrderedDict()  # id(dic) -> (dic, hash)
        self._dict_hash_cap = 512
        self.stats = {  # nds-guarded-by: _lock
            "lookups": 0, "disk_hits": 0, "misses": 0, "stores": 0,
            "store_failures": 0, "quarantined": 0, "evictions": 0,
        }
        self._store_disabled = False  # nds-guarded-by: _lock
        # committed bytes as of this handle's last scan plus its own stores
        # since: the budget is enforced (a scan of the directory) only
        # when this passes it, not on every store
        self._usage = None  # nds-guarded-by: _lock

    def _count(self, name: str, n: int = 1):
        with self._lock:
            self.stats[name] += n

    def _emit(self, op: str, result: str, **extra):
        from ..obs import trace as obs_trace

        tracer = obs_trace.current() or self._tracer()
        if tracer is not None:
            tracer.emit("aot_cache", op=op, result=result, **extra)

    # -- keying ----------------------------------------------------------
    def entry_key(self, kind: str, fp: str, content_sig, avals,
                  donate_slots, conf_sig) -> dict:
        """The full key dict of one entry: pipeline identity + input
        layout + buffer dtypes + donation + environment + relevant engine
        conf (see the module docstring for why each field is there)."""
        return {
            "kind": kind,
            "fp": fp,
            "sig": list(content_sig),
            "avals": [[list(shape), str(dtype)] for shape, dtype in avals],
            "donate": list(donate_slots),
            "conf": list(conf_sig),
            "env": self._env,
        }

    def content_signature(self, table, with_stats: bool = False):
        """The process-independent analogue of fuse.input_signature: the
        same fields, with each dictionary's id() replaced by a content
        hash (memoized per object)."""
        sig = [("live", table.live is not None)]
        for name, c in table.columns.items():
            dh = None
            if c.dictionary is not None:
                with self._lock:
                    hit = self._dict_hashes.get(id(c.dictionary))
                    if hit is not None:
                        self._dict_hashes.move_to_end(id(c.dictionary))
                if hit is not None and hit[0] is c.dictionary:
                    dh = hit[1]
                else:
                    dh = dictionary_hash(c.dictionary)
                    with self._lock:
                        self._dict_hashes[id(c.dictionary)] = (
                            c.dictionary, dh,
                        )
                        while len(self._dict_hashes) > self._dict_hash_cap:
                            self._dict_hashes.popitem(last=False)
            entry = (name, repr(c.dtype), c.valid is not None, dh)
            if with_stats:
                entry = entry + (
                    (int(c.stats.vmin), int(c.stats.vmax))
                    if c.stats is not None
                    else None,
                )
            sig.append(entry)
        return tuple(sig)

    # -- load / store ----------------------------------------------------
    def load(self, key: dict):
        """The stored payload dict for `key`, or None (a miss: absent,
        foreign, corrupt, torn, checksum-failed, or environment-mismatched
        entry — corrupt entries are quarantined). Injected `aot:read`
        faults propagate (the report ladder classifies them); real read
        errors are a miss."""
        path = os.path.join(self.dir, _entry_name(key))
        self._count("lookups")
        t0 = time.perf_counter()
        faults.maybe_fire("aot:read", kinds=("io", "crash"))
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            self._count("misses")
            self._emit("load", "miss")
            return None
        body = self._parse_entry(raw, key, path)
        if body is None:
            self._count("misses")
            return None
        try:
            payload = pickle.loads(body)
            if not (isinstance(payload, dict)
                    and payload.get("verdict") in ("fuse", "pin")):
                raise ValueError("not a fused-build payload")
        except Exception as exc:
            self._quarantine(path, f"unpickle failed: {exc}")
            self._count("misses")
            return None
        try:
            os.utime(path)  # LRU: a hit refreshes recency
        except OSError:
            pass
        self._count("disk_hits")
        self._emit(
            "load", "hit", bytes=len(raw),
            dur_ms=round((time.perf_counter() - t0) * 1000.0, 3),
            key=_entry_name(key),
        )
        return payload

    def _parse_entry(self, raw: bytes, key: dict, path: str):
        """The validated payload bytes of one raw entry, or None
        (quarantined unless the key merely differs). Full-key equality —
        not just the filename hash — and a payload checksum stand between
        a bad file and a wrong load."""
        try:
            if not raw.startswith(_MAGIC):
                raise ValueError("bad magic")
            off = len(_MAGIC)
            hlen = int.from_bytes(raw[off:off + 8], "big")
            off += 8
            header = json.loads(raw[off:off + hlen].decode("utf-8"))
            off += hlen
            body = raw[off:]
            if header.get("key") != json.loads(
                canonical_key_bytes(key).decode("utf-8")
            ):
                # a filename-hash collision or a foreign entry: a clean
                # miss and NOT a quarantine (it may be someone else's
                # perfectly valid entry)
                self._emit("load", "key_mismatch")
                return None
            if len(body) != int(header.get("body_bytes", -1)) or (
                hashlib.sha256(body).hexdigest() != header.get("body_sha256")
            ):
                raise ValueError("payload checksum mismatch")
            return body
        except Exception as exc:
            self._quarantine(path, str(exc))
            return None

    def _quarantine(self, path: str, reason: str):
        """Move a corrupt / torn / unloadable entry aside (the evidence
        survives; `cache vacuum` removes quarantines). A rename race with
        another process's quarantine or eviction is fine — the file is gone
        either way."""
        dest = os.path.join(
            self.dir,
            f"{_QUARANTINE_PREFIX}{os.path.basename(path)}.{os.getpid()}",
        )
        try:
            os.replace(path, dest)
        except OSError:
            pass
        self._count("quarantined")
        self._emit("load", "quarantined", error=reason[:160])

    def store(self, key: dict, payload: dict) -> bool:
        """Pickle and atomically publish one payload. Injected `aot:write`
        faults propagate (io kinds walk the report ladder's backoff rung;
        crash kinds simulate death mid-write and leave a `.tmp-<pid>-`
        orphan for the sweep). A REAL filesystem failure disables further
        stores for this process (one message): a full or broken cache disk
        costs rebuilds, never queries."""
        if self._store_disabled:
            return False
        faults.maybe_fire("aot:write", kinds=("io", "crash"))
        t0 = time.perf_counter()
        body = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        header = canonical_key_bytes({
            "key": json.loads(canonical_key_bytes(key).decode("utf-8")),
            "body_bytes": len(body),
            "body_sha256": hashlib.sha256(body).hexdigest(),
            "created": int(time.time()),
            "pid": os.getpid(),
        })
        dest = os.path.join(self.dir, _entry_name(key))
        tmp = _tmp_name(dest)
        try:
            os.makedirs(self.dir, exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(_MAGIC)
                f.write(len(header).to_bytes(8, "big"))
                f.write(header)
                f.write(body)
            os.replace(tmp, dest)
        except faults.FaultError:
            raise  # injected faults keep their classifiable identity
        except OSError as exc:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            with self._lock:
                self.stats["store_failures"] += 1
                disabled_now = not self._store_disabled
                self._store_disabled = True
            if disabled_now:
                print(f"aot: disabling stores ({exc})")
            self._emit("store", "io_error", error=str(exc)[:160])
            return False
        self._count("stores")
        size = len(_MAGIC) + 8 + len(header) + len(body)
        self._emit(
            "store", "stored", bytes=size,
            dur_ms=round((time.perf_counter() - t0) * 1000.0, 3),
            key=_entry_name(key),
        )
        with self._lock:
            scan = self._usage is None or self._usage + size > self.budget
            if not scan:
                self._usage += size
        if scan:
            self._enforce_budget(keep=os.path.basename(dest))
        return True

    # -- budget / hygiene ------------------------------------------------
    def _entries(self):
        """[(path, size, mtime)] of committed entries (temps, quarantines
        and the promotion store are not budget-accounted)."""
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            if not (name.startswith(_ENTRY_PREFIX)
                    and name.endswith(_ENTRY_SUFFIX)):
                continue
            path = os.path.join(self.dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            out.append((path, st.st_size, st.st_mtime))
        return out

    def usage(self):
        """(entry count, total bytes) of committed entries."""
        entries = self._entries()
        return len(entries), sum(s for _, s, _ in entries)

    def _enforce_budget(self, keep: str | None = None):
        """LRU eviction to the byte budget: oldest-mtime entries go first
        (hits refresh mtime). The entry just written is never a victim — a
        budget smaller than one entry must not evict what it just
        stored."""
        entries = self._entries()
        total = sum(s for _, s, _ in entries)
        if total <= self.budget:
            with self._lock:
                self._usage = total
            return
        victims = sorted(
            (e for e in entries if os.path.basename(e[0]) != keep),
            key=lambda e: e[2],
        )
        evicted = 0
        for path, size, _ in victims:
            if total <= self.budget:
                break
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= size
            evicted += 1
        with self._lock:
            self._usage = total
        if evicted:
            self._count("evictions", evicted)
            self._emit("evict", "evicted", entries=evicted)

    def vacuum(self, drop_all: bool = False):
        """Hygiene pass: dead-pid temp orphans and quarantine files go,
        then the budget is enforced (`drop_all` removes every committed
        entry too — the operator reset). Returns the files removed."""
        removed = sweep_orphans(self.dir)
        try:
            names = os.listdir(self.dir)
        except OSError:
            names = []
        for name in names:
            if name.startswith(_QUARANTINE_PREFIX) or (
                drop_all
                and name.startswith(_ENTRY_PREFIX)
                and name.endswith(_ENTRY_SUFFIX)
            ):
                try:
                    os.unlink(os.path.join(self.dir, name))
                    removed += 1
                except OSError:
                    pass
        if not drop_all:
            self._enforce_budget()
        self._emit("vacuum", "done", removed=removed)
        return removed


# ---------------------------------------------------------------------------
# crash hygiene: orphaned pid-tempfile sweep (the spill-pool pattern)
# ---------------------------------------------------------------------------


def sweep_orphans(cache_dir: str) -> int:
    """Remove `.tmp-<pid>-*` staging files whose owning process is dead.
    Only files of the cache's own naming scheme are touched; a temp whose
    pid is alive (an in-flight store) is left alone."""
    if not cache_dir or not os.path.isdir(cache_dir):
        return 0
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return 0
    removed = 0
    for name in names:
        if not name.startswith((_ENTRY_PREFIX, _PROMO_FILE)):
            continue
        if ".tmp-" not in name:
            continue
        pid_s = name.split(".tmp-", 1)[1].split("-", 1)[0]
        try:
            pid = int(pid_s)
        except ValueError:
            continue
        if pid == os.getpid() or _pid_alive(pid):
            continue
        try:
            os.unlink(os.path.join(cache_dir, name))
            removed += 1
        except OSError:
            pass
    if removed:
        print(f"aot: swept {removed} orphaned temp(s) from {cache_dir}")
    return removed


# one sweep per (process, directory): per-stream Session construction must
# not re-list the cache dir (worst case under a race: a second, idempotent
# sweep). A process-lifetime once-latch, not per-stream state.
# nds-lint: disable=mutable-module-global
_SWEPT_DIRS = set()


def sweep_at_session_start(cache_dir: str | None):
    if not cache_dir or cache_dir in _SWEPT_DIRS:
        return
    _SWEPT_DIRS.add(cache_dir)
    sweep_orphans(cache_dir)


# ---------------------------------------------------------------------------
# promotion-verdict persistence: measure each (kernel, shape) once
# ---------------------------------------------------------------------------


def promotion_key_str(key, device=None) -> str:
    """The persistent form of a session promotion-memo key: the in-memory
    tuple (kernel, shape dims...) plus the environment, because a verdict
    measured on one card or torch version says nothing about another."""
    env = environment_key(device)
    parts = [str(p) for p in key] + [
        env["platform"], env["device_name"], env["torch"],
    ]
    return "|".join(parts)


class PromotionStore:
    """Shared JSON store of measured promotion verdicts
    (`promotions.json` in the cache dir): `get` returns a verdict record
    or None; `record` merges one verdict in atomically (read, merge,
    tempfile, rename; a lost race between two writers drops at most one
    record, which the next session measures again). All IO is best-effort
    — a broken store costs a measurement, never a query."""

    def __init__(self, cache_dir: str):
        self.path = os.path.join(str(cache_dir), _PROMO_FILE)
        self._lock = make_lock("PromotionStore._lock")
        # nds-guarded-by: _lock
        self._cache = None  # last-read snapshot (refreshed on record)

    def _read(self) -> dict:
        try:
            with open(self.path, encoding="utf-8") as f:
                data = json.load(f)
            return data if isinstance(data, dict) else {}
        except (OSError, ValueError):
            return {}

    def get(self, key_str: str):
        with self._lock:
            if self._cache is None:
                self._cache = self._read()
            rec = self._cache.get(key_str)
        if rec is not None and not isinstance(rec, dict):
            return None
        return rec

    def record(self, key_str: str, rec: dict):
        with self._lock:
            data = self._read()
            data[key_str] = rec
            self._cache = data
        # file IO outside the lock: `get` is on the planning path
        tmp = _tmp_name(self.path)
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(data, f, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def count(self) -> int:
        return len(self._read())
