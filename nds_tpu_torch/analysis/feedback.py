"""Estimate-vs-actual cardinality feedback (the measure->record->consume
loop that makes budgeter error a measured, shrinking number), the port of
nds_tpu/analysis/feedback.py: the same modes, keys, entry layout and
FORMAT_VERSION, so a store written by either package reads as hits in the
other.

The budgeter (analysis/budget.py) plans from static heuristics: table
stats, FK shapes, a conjunction selectivity floor. The executor measures
everything the model guessed — op_span actual rows/bytes, per-device
exchange skew — and until now threw the measurements away. This module
is the persistent middle: a `FeedbackStore` (the PromotionStore/aotcache
persistence pattern — atomic pid-staged writes, checksum-verified loads,
corrupt entries quarantine as misses, an LRU byte budget derived via
`budget.derive_share_bytes`, dead-pid temp sweeps) keyed by
`(node_fp, scale_tag)`:

  node_fp    sha256 of the node's structural fingerprint
             (engine/plan.py:fingerprint — operator shape, input
             relations, pushed predicates) — stable across processes
  scale_tag  the data the fingerprint ran against: the declared budget
             SF plus each scanned table's lake snapshot version (or
             registered row count). A lake-version advance changes the
             tag, so stale cardinalities invalidate into clean misses.

Modes (`engine.plan_feedback` / NDS_PLAN_FEEDBACK, default `record`):

  off      no annotations, no recording, no lookups — the static model,
           byte-identical to the pre-feedback engine
  record   plan nodes are annotated (`node_fp`, `est_rows`,
           `est_live_bytes`), the executor records actuals + exchange
           skew into the store; estimates stay static
  on       record, PLUS a recorded actual overrides the static per-node
           row estimate (clamped: never below the observed maximum) so
           verdicts/windows/spill-partition counts re-derive from
           measurements. (The reference's exchange layer also seeds
           hot-key capacity from recorded skew; the port's exchange is
           the mesh's, ROADMAP.md queue 1 item 13, so `record_skew` is
           a store method only until then.)

The store directory rides the AOT cache dir by default
(`<aot_cache_dir>/feedback`), so `cache warm --fleet`-style shared-dir
wiring shares learned cardinalities across processes and serve replicas
exactly like compiled executables; `engine.feedback_dir` /
NDS_FEEDBACK_DIR override, ""/"0" disables.
"""

import hashlib
import json
import math
import os
import time

from ..engine import plan as P
from ..engine.lockdebug import make_lock

#: plan_feedback modes (parallel to budget.MODES)
FEEDBACK_MODES = ("off", "record", "on")

#: store entry format version: bump on layout change so old entries read
#: as clean key mismatches (misses), never as corrupt data
FORMAT_VERSION = 1

_ENTRY_PREFIX = "fb-"
_ENTRY_SUFFIX = ".json"

#: auto byte budget for the store dir: 1/64 of the filesystem's free
#: bytes, clamped to [4 MiB, 1 GiB] — entries are ~300 B JSON documents,
#: so even the floor holds ~10k learned plan nodes
_BUDGET_FRACTION = 64
_BUDGET_LO = 4 << 20
_BUDGET_HI = 1 << 30

#: bounded in-process |log(est/actual)| sample reservoir (bench/statusz
#: medians); oldest samples age out ring-style
_ERR_SAMPLES_CAP = 4096

#: log2-bucketed actual-row histogram width kept per entry
_HIST_CAP = 24


def resolve_feedback_mode(conf=None) -> str:
    v = None
    if conf:
        v = conf.get("engine.plan_feedback")
    v = v or os.environ.get("NDS_PLAN_FEEDBACK") or "record"
    v = str(v).lower()
    if v not in FEEDBACK_MODES:
        raise ValueError(
            f"engine.plan_feedback must be one of {FEEDBACK_MODES}, "
            f"got {v!r}"
        )
    return v


def resolve_feedback_dir(conf=None):
    """The feedback store directory, or None when disabled: explicit conf
    / env win (""/"0" disables); otherwise a `feedback/` namespace under
    the resolved AOT cache dir — one shared dir therefore shares BOTH
    compiled executables and learned cardinalities across processes and
    serve replicas (the `--aot_cache_dir` fleet wiring), and disabling
    the AOT dir disables feedback with it."""
    v = None
    if conf:
        v = conf.get("engine.feedback_dir")
    if v is None:
        v = os.environ.get("NDS_FEEDBACK_DIR")
    if v is not None:
        v = str(v)
        if v in ("", "0"):
            return None
        return os.path.expanduser(v)
    from ..engine.aotcache import resolve_aot_cache_dir

    base = resolve_aot_cache_dir(conf)
    if not base:
        return None
    return os.path.join(base, "feedback")


def resolve_feedback_bytes(conf=None, dirpath=None) -> int:
    """Store byte budget: explicit conf/env, else an `auto` share of the
    store filesystem's free bytes through the one derivation every auto
    budget in the engine uses (budget.derive_share_bytes)."""
    v = None
    if conf:
        v = conf.get("engine.feedback_bytes")
    if v is None:
        v = os.environ.get("NDS_FEEDBACK_BYTES")
    if v is not None and str(v).lower() not in ("", "auto"):
        return int(v)
    from .budget import derive_share_bytes

    total = 0
    probe = dirpath or "."
    while probe:
        try:
            import shutil

            total = shutil.disk_usage(probe).free
            break
        except OSError:
            parent = os.path.dirname(probe)
            if parent == probe:
                break
            probe = parent
    if not total:
        return _BUDGET_LO
    return derive_share_bytes(total, _BUDGET_FRACTION, _BUDGET_LO,
                              _BUDGET_HI)


# ---------------------------------------------------------------------------
# keys: structural fingerprint x data scale
# ---------------------------------------------------------------------------


def plan_scale_tag(plan, session) -> str:
    """The data-scale half of a feedback key: the declared budget SF plus
    one `table@version` component per scanned relation — the lake
    snapshot version when the scan is pinned to one, else the registered
    row count when the catalog knows it cheaply. Advancing a lake version
    (or re-registering a table with different data) changes the tag, so
    every learned cardinality under the old tag becomes a clean miss
    instead of a stale override."""
    sf = None
    entries = {}
    if session is not None:
        sf = session.conf.get("engine.plan_budget_sf")
        entries = getattr(getattr(session, "catalog", None), "entries", {})
    parts = [f"sf={sf}" if sf else "sf=?"]
    seen = set()
    for v in P.walk_plan(plan):
        if not isinstance(v, P.Scan) or v.table in seen:
            continue
        seen.add(v.table)
        ver = getattr(v, "lake_version", None)
        if ver is None:
            e = entries.get(v.table)
            arrow = getattr(e, "arrow", None)
            ver = arrow.num_rows if arrow is not None else "?"
        parts.append(f"{v.table}@{ver}")
    parts.sort()
    return ";".join(parts)


def node_fp(structural_fp: str, scale_tag: str) -> str:
    """One store key: content fingerprint of (operator subtree, data
    scale) — 40 hex chars, the same truncation the aot cache uses."""
    h = hashlib.sha256()
    h.update(str(structural_fp).encode("utf-8"))
    h.update(b"|")
    h.update(str(scale_tag).encode("utf-8"))
    return h.hexdigest()[:40]


def _mscan_tainted(plan) -> set:
    """Ids of nodes whose subtree contains a MaterializedScan: those
    fingerprints embed a per-process serial (deliberately — the scanned
    table is not reconstructible), so they can never hit across
    processes and would only pollute the store with unique keys. Plans
    without one (the overwhelmingly common case) pay a single walk."""
    if not any(
        isinstance(v, P.MaterializedScan) for v in P.walk_plan(plan)
    ):
        return set()
    out = set()
    for v in P.walk_plan(plan):
        if isinstance(v, P.PlanNode) and any(
            isinstance(w, P.MaterializedScan) for w in P.walk_plan(v)
        ):
            out.add(id(v))
    return out


def plan_node_fps(plan, session, scale_tag=None) -> dict:
    """{id(node): store key} for every feedback-eligible plan node (plus
    scalar-subquery plans — the budgeter models them too). Computed once
    per statement at plan time; budget_plan annotates the winners onto
    the nodes so the executor never recomputes a fingerprint."""
    if scale_tag is None:
        scale_tag = plan_scale_tag(plan, session)
    tainted = _mscan_tainted(plan)
    out = {}
    for v in P.walk_plan(plan):
        if isinstance(v, P.PlanNode) and id(v) not in tainted:
            out[id(v)] = node_fp(P.fingerprint(v), scale_tag)
    return out


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def _entry_name(fp: str) -> str:
    return f"{_ENTRY_PREFIX}{fp}{_ENTRY_SUFFIX}"


def _merge_component(dst: dict, rows) -> dict:
    """Fold one observation into a {n,last,min,max,hist} component."""
    rows = int(rows)
    dst["n"] = int(dst.get("n", 0)) + 1
    dst["last"] = rows
    dst["min"] = rows if dst.get("min") is None else min(dst["min"], rows)
    dst["max"] = rows if dst.get("max") is None else max(dst["max"], rows)
    hist = dst.setdefault("hist", {})
    bucket = str(min(rows.bit_length(), _HIST_CAP))
    hist[bucket] = int(hist.get(bucket, 0)) + 1
    return dst


class FeedbackStore:
    """Persistent (node_fp, scale)-keyed actual-cardinality records.

    One tiny JSON document per key under `dirpath`, written with the
    aot-cache discipline: stage to a `.tmp-<pid>-<rand>` sibling, fsync,
    `os.replace` into place (readers see whole documents or nothing),
    re-verify the FULL embedded key and a payload checksum on load — a
    filename-hash collision is a clean miss, a corrupt document is
    quarantined (renamed aside, once) and treated as a miss. Mutations
    buffer in `_pending` and land on `flush()` (one merge+write per
    touched key per statement, not per recorded node), after which the
    LRU byte budget is re-enforced by mtime — lookups refresh an entry's
    mtime so hot plan nodes survive eviction.

    In-process state is guarded by an internal lock; session-level call
    sites additionally hold `Session.cache_lock` (the guarded-by lint
    enforces it for `feedback_store`, as for every other session
    cache)."""

    def __init__(self, dirpath: str, budget_bytes: int):
        self.dir = dirpath
        self.budget = int(budget_bytes)
        self._lock = make_lock("FeedbackStore._lock")
        self._mem = {}  # fp -> record dict (None = known miss)  # nds-guarded-by: _lock
        self._pending = {}  # fp -> record delta awaiting flush  # nds-guarded-by: _lock
        self._disabled = False  # first write error disables stores  # nds-guarded-by: _lock
        self._err_samples = []  # |log(est/actual)| ring  # nds-guarded-by: _lock
        self.stats = {  # nds-guarded-by: _lock
            "lookups": 0, "hits": 0, "misses": 0, "records": 0,
            "skew_records": 0, "flushes": 0, "stores": 0, "evictions": 0,
            "quarantined": 0, "overrides": 0,
        }

    # -- reads ----------------------------------------------------------
    def lookup(self, fp: str):
        """The record for one key, or None. First disk read per key is
        cached (hits AND misses) for the life of the session; a hit
        refreshes the entry's mtime (LRU recency)."""
        with self._lock:
            self.stats["lookups"] += 1
            if fp in self._mem:
                rec = self._mem[fp]
                self.stats["hits" if rec is not None else "misses"] += 1
                return dict(rec) if rec is not None else None
            rec = self._load_locked(fp)
            self._mem[fp] = rec
            self.stats["hits" if rec is not None else "misses"] += 1
            return dict(rec) if rec is not None else None

    def _load_locked(self, fp: str):
        path = os.path.join(self.dir, _entry_name(fp))
        try:
            with open(path, "rb") as f:
                doc = json.loads(f.read().decode("utf-8"))
        except FileNotFoundError:
            return None
        except (OSError, ValueError, UnicodeDecodeError):
            self._quarantine_locked(path)
            return None
        body = doc.get("body") if isinstance(doc, dict) else None
        key = doc.get("key") if isinstance(doc, dict) else None
        if not isinstance(body, dict) or not isinstance(key, dict):
            self._quarantine_locked(path)
            return None
        want = hashlib.sha256(
            json.dumps(body, sort_keys=True).encode("utf-8")
        ).hexdigest()
        if doc.get("sha256") != want:
            self._quarantine_locked(path)
            return None
        if key != self._key(fp):
            # full-key mismatch after a filename-hash collision or a
            # format-version bump: valid foreign data, a clean miss
            return None
        try:
            os.utime(path, None)
        except OSError:
            pass
        return body

    def _key(self, fp: str) -> dict:
        return {"node_fp": fp, "v": FORMAT_VERSION}

    # -- buffered writes ------------------------------------------------
    def record(self, fp: str, rows=None, nbytes=None, est_rows=None):
        """Fold one executed node's actuals into the pending delta for
        `fp`. Returns the |log(est/actual)| error sample when the static
        estimate was annotated (the caller's plan_feedback event carries
        it), else None."""
        err = None
        if est_rows is not None and rows is not None:
            err = abs(math.log(max(int(est_rows), 1))
                      - math.log(max(int(rows), 1)))
        with self._lock:
            self.stats["records"] += 1
            rec = self._pending.setdefault(fp, {})
            if rows is not None:
                _merge_component(rec.setdefault("rows", {}), rows)
            if nbytes is not None:
                _merge_component(rec.setdefault("bytes", {}), nbytes)
            if err is not None:
                self._err_samples.append(err)
                if len(self._err_samples) > _ERR_SAMPLES_CAP:
                    del self._err_samples[: _ERR_SAMPLES_CAP // 4]
        return err

    def record_skew(self, fp: str, skew: float, retries: int = 0):
        """Fold one exchange's measured received-row skew (max/mean) and
        its overflow-retry count into the pending delta for `fp` — the
        seed the next execution's capacity guess consumes."""
        with self._lock:
            self.stats["skew_records"] += 1
            rec = self._pending.setdefault(fp, {})
            sk = rec.setdefault("skew", {})
            sk["n"] = int(sk.get("n", 0)) + 1
            sk["last"] = round(float(skew), 3)
            sk["max"] = round(max(float(sk.get("max", 0.0)), float(skew)), 3)
            sk["retries"] = max(int(sk.get("retries", 0)), int(retries))

    def flush(self) -> int:
        """Merge every pending delta with its on-disk record and commit
        (tempfile + rename per key), then re-enforce the byte budget.
        Returns the number of keys written; write errors disable further
        stores for this process (the cache must never take down a
        query)."""
        with self._lock:
            pending, self._pending = self._pending, {}
            if not pending or self._disabled:
                return 0
            self.stats["flushes"] += 1
            written = []
            for fp, delta in pending.items():
                base = self._mem.get(fp)
                if base is None:
                    base = self._load_locked(fp) or {}
                merged = self._merge(dict(base), delta)
                merged["updated"] = int(time.time())
                if self._write_locked(fp, merged):
                    self._mem[fp] = merged
                    written.append(_entry_name(fp))
                    self.stats["stores"] += 1
                if self._disabled:
                    break
            if written:
                self._enforce_budget_locked(keep=set(written))
            return len(written)

    @staticmethod
    def _merge(base: dict, delta: dict) -> dict:
        for comp in ("rows", "bytes"):
            d = delta.get(comp)
            if not d:
                continue
            b = base.setdefault(comp, {})
            b["n"] = int(b.get("n", 0)) + int(d.get("n", 0))
            b["last"] = d.get("last", b.get("last"))
            for agg, fold in (("min", min), ("max", max)):
                vals = [x for x in (b.get(agg), d.get(agg)) if x is not None]
                if vals:
                    b[agg] = fold(vals)
            hist = b.setdefault("hist", {})
            for k, n in (d.get("hist") or {}).items():
                hist[k] = int(hist.get(k, 0)) + int(n)
        d = delta.get("skew")
        if d:
            b = base.setdefault("skew", {})
            b["n"] = int(b.get("n", 0)) + int(d.get("n", 0))
            b["last"] = d.get("last", b.get("last"))
            b["max"] = max(float(b.get("max", 0.0)), float(d.get("max", 0.0)))
            b["retries"] = max(int(b.get("retries", 0)),
                               int(d.get("retries", 0)))
        return base

    def _write_locked(self, fp: str, body: dict) -> bool:
        doc = {
            "key": self._key(fp),
            "body": body,
            "sha256": hashlib.sha256(
                json.dumps(body, sort_keys=True).encode("utf-8")
            ).hexdigest(),
        }
        dest = os.path.join(self.dir, _entry_name(fp))
        tmp = (f"{dest}.tmp-{os.getpid()}-"
               f"{hashlib.sha256(os.urandom(8)).hexdigest()[:6]}")
        try:
            os.makedirs(self.dir, exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(json.dumps(doc, sort_keys=True).encode("utf-8"))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, dest)
            return True
        except OSError as exc:
            self._disabled = True
            import warnings

            warnings.warn(
                f"feedback store disabled: cannot write {dest!r}: {exc}"
            )
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False

    def _quarantine_locked(self, path: str):
        self.stats["quarantined"] += 1
        dest = os.path.join(
            os.path.dirname(path),
            f"quarantine-{os.path.basename(path)}.{os.getpid()}",
        )
        try:
            os.replace(path, dest)
        except OSError:
            pass

    # -- maintenance ----------------------------------------------------
    def _entries(self):
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        out = []
        for n in names:
            if not (n.startswith(_ENTRY_PREFIX)
                    and n.endswith(_ENTRY_SUFFIX)):
                continue
            path = os.path.join(self.dir, n)
            try:
                st = os.stat(path)
            except OSError:
                continue
            out.append((st.st_mtime, st.st_size, n, path))
        return out

    def _enforce_budget_locked(self, keep=frozenset()):
        entries = self._entries()
        total = sum(e[1] for e in entries)
        if total <= self.budget:
            return
        for mtime, size, name, path in sorted(entries):
            if total <= self.budget:
                break
            if name in keep:
                continue
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= size
            self.stats["evictions"] += 1

    def usage(self):
        entries = self._entries()
        return len(entries), sum(e[1] for e in entries)

    def vacuum(self, drop_all: bool = False) -> int:
        """Sweep dead-pid temps + quarantined entries and re-enforce the
        budget; `drop_all` also forgets every learned cardinality (the
        operator reset after a data regeneration). Returns files
        removed."""
        # aotcache.sweep_orphans filters on ITS entry prefixes, so the
        # fb-* temps need their own dead-pid sweep (same liveness rule:
        # a temp whose owning pid is alive is an in-flight store)
        from ..engine.aotcache import _pid_alive

        removed = 0
        try:
            names = os.listdir(self.dir)
        except OSError:
            names = []
        for n in list(names):
            if not (n.startswith(_ENTRY_PREFIX) and ".tmp-" in n):
                continue
            pid_s = n.split(".tmp-", 1)[1].split("-", 1)[0]
            try:
                pid = int(pid_s)
            except ValueError:
                continue
            if pid == os.getpid() or _pid_alive(pid):
                continue
            try:
                os.unlink(os.path.join(self.dir, n))
                removed += 1
                names.remove(n)
            except OSError:
                pass
        for n in names:
            drop = n.startswith("quarantine-") or (
                drop_all
                and n.startswith(_ENTRY_PREFIX)
                and n.endswith(_ENTRY_SUFFIX)
            )
            if not drop:
                continue
            try:
                os.unlink(os.path.join(self.dir, n))
                removed += 1
            except OSError:
                continue
        with self._lock:
            if drop_all:
                self._mem.clear()
                self._pending.clear()
            before = self.stats["evictions"]
            self._enforce_budget_locked()
            removed += self.stats["evictions"] - before
        return removed

    # -- in-process accuracy accounting (bench/statusz) -----------------
    def err_stats(self):
        """(median, max, n) over the bounded |log(est/actual)| sample
        reservoir — the bench OUT line's `budget_err_median` and the
        statusz accuracy block read this without touching disk."""
        with self._lock:
            s = sorted(self._err_samples)
        if not s:
            return None, None, 0
        mid = len(s) // 2
        med = s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2.0
        return med, s[-1], len(s)

    def hit_rate(self):
        """lookup hit fraction, or None before any lookup."""
        n = self.stats["lookups"]
        return (self.stats["hits"] / n) if n else None
