"""The port's persistent cache of fused builds (nds_tpu_torch/engine/
aotcache.py): the cases of the JAX package's tests/test_aotcache.py, each
in a private `tmp_path` directory. The contract is the reference's: a
mismatched or damaged cache can cost a rebuild, never a wrong result or a
crash; plus the fleet behaviours (two-process warm, orphan sweep, LRU
eviction, persisted promotion verdicts). Where a case runs queries, the
JAX package's session answers the same query with its own cache in its
own private directory.

The reference's `test_aot_events_ride_the_trace` runs through the port in
tests/test_torch_obs.py, with the other cases that needed the tracer.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow as pa
import pytest

from nds_tpu.engine.session import Session as JaxSession
from nds_tpu_torch import faults
from nds_tpu_torch.engine import aotcache as AC
from nds_tpu_torch.engine.session import Session

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import assert_same, strict_budget  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _table(n=2000, seed=1):
    r = np.random.default_rng(seed)
    ks = r.integers(0, 12, n)
    return pa.table({
        "k": pa.array(
            [None if i % 9 == 0 else int(x) for i, x in enumerate(ks)],
            pa.int32(),
        ),
        "k2": pa.array(r.integers(0, 6, n), pa.int32()),
        "v": pa.array(r.integers(-90, 90, n), pa.int64()),
        "cat": pa.array(
            [["Books", "Music", "Shoes"][int(x) % 3] for x in ks],
            pa.string(),
        ),
    })


def _session(tmp_path, **conf):
    sess = Session(conf={"engine.aot_cache_dir": str(tmp_path / "aot"),
                         **conf}, device="cpu")
    sess.register_arrow("t", _table())
    return sess


def _jax_session(tmp_path, **conf):
    sess = JaxSession(conf={"engine.aot_cache_dir": str(tmp_path / "jax"),
                            **conf})
    sess.register_arrow("t", _table())
    return sess


def _payload(mul=2.0):
    return {"verdict": "fuse", "tape": [], "mul": mul}


def _cache(tmp_path, budget=1 << 30):
    return AC.AotCache(str(tmp_path / "aot"), budget)


def _key(cache, tag="a"):
    return cache.entry_key(
        "pipeline", f"fp-{tag}", [("live", False)],
        [(("cap",), "torch.float32")], (), ("on", "off"),
    )


# a string predicate (a LIKE table on the tape) feeding a two-key fused
# aggregate, and a string-keyed one whose tape holds the ranks of a
# string min/max
QUERY = (
    "select k, k2, sum(v) s, count(*) c from t "
    "where v > -50 and cat like 'B%' group by k, k2 order by k, k2"
)
STRING_QUERY = ("select cat, min(cat) mn, count(*) c from t where v > 0 "
                "group by cat order by cat")


# ---------------------------------------------------------------------------
# roundtrip + key discipline
# ---------------------------------------------------------------------------


def test_roundtrip_equality_vs_in_process_build(tmp_path):
    """A fresh session loading from disk returns EXACTLY what the building
    session returned, without building."""
    for q in (QUERY, STRING_QUERY):
        s1 = _session(tmp_path)
        ref = s1.sql(q).collect()
        assert s1.aot_cache.stats["stores"] >= 1
        assert s1.exec_cache.builds >= 1
        assert_same(_jax_session(tmp_path).sql(q).collect(), ref, q,
                    ordered=True)

        s2 = _session(tmp_path)
        assert s2.sql(q).collect().equals(ref)
        assert s2.aot_cache.stats["disk_hits"] >= 1
        assert s2.aot_cache.stats["misses"] == 0
        assert s2.exec_cache.builds == 0 and s2.exec_cache.loads >= 1


def test_environment_key_mismatch_is_clean_miss(tmp_path):
    """Any environment drift — torch version, card name, conf flip — is a
    MISS, and the mismatched (valid) entry stays, never quarantined."""
    cache = _cache(tmp_path)
    key = _key(cache)
    assert cache.store(key, _payload())
    assert cache.load(key) == _payload()
    for mutate in (
        lambda k: k["env"].__setitem__("torch", "0.0.1"),
        lambda k: k["env"].__setitem__("device_name", "NVIDIA B200"),
        lambda k: k.__setitem__("conf", ["off", "off"]),
        lambda k: k.__setitem__("fp", "fp-other"),
    ):
        skew = json.loads(json.dumps(key))
        mutate(skew)
        assert cache.load(skew) is None
    assert cache.load(key) == _payload()
    assert cache.stats["quarantined"] == 0


def test_filename_collision_reads_as_miss_not_wrong_load(tmp_path):
    """A file whose NAME matches but whose recorded key differs must read
    as a miss: load verifies the full key dict, not the filename."""
    cache = _cache(tmp_path)
    key = _key(cache, "a")
    other = _key(cache, "b")
    assert cache.store(other, _payload())
    os.replace(
        os.path.join(cache.dir, AC._entry_name(other)),
        os.path.join(cache.dir, AC._entry_name(key)),
    )
    assert cache.load(key) is None
    assert cache.stats["quarantined"] == 0


# ---------------------------------------------------------------------------
# corruption: clean miss + quarantine, never a crash
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("damage", ["truncate", "flip", "garbage", "empty"])
def test_corrupt_entry_is_quarantined_miss(tmp_path, damage):
    cache = _cache(tmp_path)
    key = _key(cache)
    assert cache.store(key, _payload())
    path = os.path.join(cache.dir, AC._entry_name(key))
    raw = open(path, "rb").read()
    if damage == "truncate":
        blob = raw[: len(raw) // 2]  # a torn write
    elif damage == "flip":
        mid = len(raw) - 5  # inside the pickled body: the checksum trips
        blob = raw[:mid] + bytes([raw[mid] ^ 0xFF]) + raw[mid + 1:]
    elif damage == "garbage":
        blob = b"not an entry at all"
    else:
        blob = b""
    with open(path, "wb") as f:
        f.write(blob)
    assert cache.load(key) is None  # never a crash
    assert cache.stats["quarantined"] == 1
    assert not os.path.exists(path)
    assert len([n for n in os.listdir(cache.dir)
                if n.startswith("quarantine-")]) == 1
    assert cache.store(key, _payload())  # the slot is reusable at once
    assert cache.load(key) == _payload()


def test_poisoned_entry_end_to_end_recompiles_correctly(tmp_path):
    """Corrupt every stored entry behind a warm directory: a fresh session
    still returns identical results (it builds again), the damage visible
    only in the quarantine count."""
    s1 = _session(tmp_path)
    ref = s1.sql(QUERY).collect()
    entries = [n for n in os.listdir(s1.aot_cache.dir)
               if n.startswith("aot-")]
    assert entries
    for n in entries:
        path = os.path.join(s1.aot_cache.dir, n)
        with open(path, "r+b") as f:
            f.seek(max(os.path.getsize(path) - 30, 0))
            f.write(b"\xde\xad\xbe\xef")
    s2 = _session(tmp_path)
    assert s2.sql(QUERY).collect().equals(ref)
    assert s2.aot_cache.stats["quarantined"] >= 1
    assert s2.aot_cache.stats["disk_hits"] == 0
    assert s2.exec_cache.builds >= 1


def test_pinned_verdict_persists(tmp_path):
    """A chain the build pins (a number cast to a string) stores its pin:
    a fresh session pins it from disk without building, and answers as the
    eager path and the JAX package do."""
    q = ("select cast(v as varchar(10)) sv, k from t where v > 80 "
         "order by k, sv")
    s1 = _session(tmp_path)
    ref = s1.sql(q).collect()
    assert s1.exec_cache.pins == 1
    s2 = _session(tmp_path)
    assert s2.sql(q).collect().equals(ref)
    assert s2.exec_cache.pins == 1 and s2.exec_cache.builds == 0
    assert s2.aot_cache.stats["disk_hits"] >= 1
    assert_same(_jax_session(tmp_path).sql(q).collect(), ref, q,
                ordered=True)


def test_vacuum_removes_quarantines_and_enforces_budget(tmp_path):
    cache = _cache(tmp_path)
    key = _key(cache)
    assert cache.store(key, _payload())
    with open(os.path.join(cache.dir, AC._entry_name(key)), "wb") as f:
        f.write(b"junk")
    assert cache.load(key) is None  # quarantines
    assert any(n.startswith("quarantine-") for n in os.listdir(cache.dir))
    cache.vacuum()
    assert not any(n.startswith("quarantine-")
                   for n in os.listdir(cache.dir))
    assert cache.store(key, _payload())
    cache.vacuum(drop_all=True)
    assert cache.usage() == (0, 0)


# ---------------------------------------------------------------------------
# concurrency + crash hygiene
# ---------------------------------------------------------------------------

_WARM_SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    from nds_tpu_torch.engine import aotcache as AC

    cache = AC.AotCache({cache_dir!r}, 1 << 30)
    key = cache.entry_key(
        "pipeline", "fp-shared", [("live", False)],
        [(("cap",), "torch.float32")], (), ("on", "off"),
    )
    payload = {{"verdict": "fuse", "tape": [b"x" * 4096] * 64}}
    for _ in range(8):
        cache.store(key, payload)
    assert cache.load(key) is not None
    print("WARMED")
""")


def test_concurrent_two_process_warm_one_winner_no_torn_files(tmp_path):
    cache_dir = str(tmp_path / "aot")
    script = _WARM_SCRIPT.format(repo=REPO, cache_dir=cache_dir)
    procs = [
        subprocess.Popen([sys.executable, "-c", script],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for _ in range(2)
    ]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        assert "WARMED" in out
    names = os.listdir(cache_dir)
    assert len([n for n in names
                if n.startswith("aot-") and n.endswith(".bin")]) == 1
    assert not any(".tmp-" in n for n in names)
    cache = AC.AotCache(cache_dir, 1 << 30)
    key = cache.entry_key("pipeline", "fp-shared", [("live", False)],
                          [(("cap",), "torch.float32")], (), ("on", "off"))
    assert cache.load(key) is not None


def test_orphan_sweep_removes_dead_pid_temps_only(tmp_path):
    cache_dir = tmp_path / "aot"
    cache_dir.mkdir()
    dead = cache_dir / "aot-abc.bin.tmp-999999-aa"
    dead.write_bytes(b"torn")
    live = cache_dir / f"aot-def.bin.tmp-{os.getpid()}-bb"
    live.write_bytes(b"in-flight")
    committed = cache_dir / "aot-abc.bin"
    committed.write_bytes(b"committed")
    foreign = cache_dir / "something-else.tmp-999999-cc"
    foreign.write_bytes(b"foreign")
    assert AC.sweep_orphans(str(cache_dir)) == 1
    assert not dead.exists()
    assert live.exists() and committed.exists() and foreign.exists()


def test_eviction_accounting_lru_to_budget(tmp_path):
    cache = _cache(tmp_path)
    k1, k2, k3 = (_key(cache, t) for t in ("e1", "e2", "e3"))
    assert cache.store(k1, _payload(1.0))
    size = cache.usage()[1]
    # room for about two entries: the third store evicts the LRU one
    cache.budget = int(size * 2.5)
    assert cache.store(k2, _payload(2.0))
    path1 = os.path.join(cache.dir, AC._entry_name(k1))
    path2 = os.path.join(cache.dir, AC._entry_name(k2))
    # k2 strictly older than k1's refresh below, whatever the clock's grain
    os.utime(path2, (1, 1))
    assert cache.load(k1) is not None  # refresh k1: k2 becomes LRU
    assert os.path.getmtime(path1) > os.path.getmtime(path2)
    assert cache.store(k3, _payload(3.0))
    assert cache.usage()[1] <= cache.budget
    assert cache.stats["evictions"] >= 1
    assert cache.load(k2) is None  # the LRU victim
    assert cache.load(k1) is not None
    assert cache.load(k3) is not None


# ---------------------------------------------------------------------------
# fault sites: aot:write / aot:read through the registry
# ---------------------------------------------------------------------------


def test_injected_io_fault_keeps_classifiable_identity(tmp_path):
    cache = _cache(tmp_path)
    key = _key(cache)
    try:
        faults.install("io:aot:write:1")
        with pytest.raises(faults.TransientIOError) as ei:
            cache.store(key, _payload())
        assert faults.classify(ei.value) == faults.IO_TRANSIENT
        assert cache.store(key, _payload())  # the rule fired once
        faults.install("io:aot:read:1")
        with pytest.raises(faults.TransientIOError):
            cache.load(key)
        assert cache.load(key) is not None
    finally:
        faults.reset()


def test_crash_mid_write_leaves_no_committed_entry(tmp_path):
    cache = _cache(tmp_path)
    key = _key(cache)
    try:
        faults.install("crash:aot:write")
        with pytest.raises(faults.InjectedCrash):
            cache.store(key, _payload())
    finally:
        faults.reset()
    assert cache.load(key) is None  # nothing half-published
    torn = os.path.join(cache.dir, f"{AC._entry_name(key)}.tmp-999999-zz")
    os.makedirs(cache.dir, exist_ok=True)
    with open(torn, "wb") as f:
        f.write(b"half a header")
    assert AC.sweep_orphans(cache.dir) == 1
    assert cache.load(key) is None
    assert cache.store(key, _payload())


def test_real_store_failure_degrades_never_raises(tmp_path, monkeypatch):
    cache = AC.AotCache(str(tmp_path / "missing" / "deep"), 1 << 30)
    monkeypatch.setattr(
        AC.os, "makedirs",
        lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")),
    )
    assert cache.store(_key(cache), _payload()) is False
    assert cache.stats["store_failures"] == 1
    assert cache._store_disabled


# ---------------------------------------------------------------------------
# promotion-verdict persistence
# ---------------------------------------------------------------------------


def test_promotion_store_roundtrip(tmp_path):
    store = AC.PromotionStore(str(tmp_path / "aot"))
    key = AC.promotion_key_str(("sort_perm", 4096, 128))
    assert store.get(key) is None
    rec = {"plain_ms": 1.0, "kernel_ms": 0.5, "use": True}
    store.record(key, rec)
    assert store.get(key) == rec
    assert AC.PromotionStore(str(tmp_path / "aot")).get(key) == rec


def test_promotion_store_tolerates_corruption(tmp_path):
    d = tmp_path / "aot"
    d.mkdir()
    (d / "promotions.json").write_text("{torn json")
    store = AC.PromotionStore(str(d))
    assert store.get("anything") is None
    store.record("k", {"use": False})
    assert AC.PromotionStore(str(d)).get("k") == {"use": False}


def test_persisted_promotion_verdict_skips_remeasure(tmp_path,
                                                     monkeypatch):
    """A fresh session reading a persisted verdict does not measure
    again: one A/B per (kernel, shape, environment)."""
    from nds_tpu_torch.engine import exec as EX

    conf = {"engine.pallas_sort": "auto"}
    s1 = _session(tmp_path, **conf)
    sort_q = "select k, v from t where v > 0 order by k"
    ref = s1.sql(sort_q).collect()
    assert any(k[0] == "sort_perm" for k in s1.pallas_promotions)
    s2 = _session(tmp_path, **conf)

    def boom(*a, **kw):
        raise AssertionError("re-measured a persisted promotion verdict")
    monkeypatch.setattr(EX.Executor, "_measure_promotion", boom)
    assert s2.sql(sort_q).collect().equals(ref)
    assert any(k[0] == "sort_perm" for k in s2.pallas_promotions)


# ---------------------------------------------------------------------------
# the default directory and the budget derivation
# ---------------------------------------------------------------------------


def test_default_dir_and_disable(monkeypatch, tmp_path):
    monkeypatch.delenv("NDS_AOT_CACHE_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert AC.resolve_aot_cache_dir() == str(tmp_path / "nds_torch_aot")
    assert AC.resolve_aot_cache_dir({"engine.aot_cache_dir": ""}) is None
    monkeypatch.setenv("NDS_AOT_CACHE_DIR", "0")
    assert AC.resolve_aot_cache_dir() is None
    s = Session(device="cpu")
    assert s.aot_cache is None and s.promotion_store is None


def test_auto_budget_derivations_share_one_formula():
    from nds_tpu_torch.analysis.budget import derive_share_bytes

    aot = AC.resolve_aot_cache_bytes({"engine.aot_cache_bytes": "auto"}, "/")
    assert aot & (aot - 1) == 0  # a power of two
    assert AC._BUDGET_LO <= aot <= AC._BUDGET_HI
    assert AC.resolve_aot_cache_bytes(
        {"engine.aot_cache_bytes": 4096}, "/") == 4096
    assert aot == derive_share_bytes(
        __import__("shutil").disk_usage("/").free, AC._BUDGET_FRACTION,
        AC._BUDGET_LO, AC._BUDGET_HI)
