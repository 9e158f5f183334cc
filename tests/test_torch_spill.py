"""The port's out-of-core paths (nds_tpu_torch/engine/spill.py and the
executor's _spilled_join / _spilled_take / _spilled_distinct) against the
JAX package's, after the JAX package's tests/test_spill.py.

Small tables built from a numpy seed go through both engines with
`engine.spill=force` at 2, 3 and 8 partitions, chip_smoke.branch_spy on both
executors: each engine must take the same spilled paths (the same
partition counts), and the port's result must EQUAL the JAX engine's and
the port's own direct result: integers, decimals, strings and floats
exactly (both engines sum the same partitions in the same order), sorts in
exact row order, and, without an ORDER BY, the same partition-major row
order at 3 partitions. Then the pool: disk eviction round trips and
cleanup, accounting, a RAM-only pool over budget, the orphan sweep of a
dead process and the sweep at session start. JAX sessions run with no AOT
cache and a private feedback directory; every spill directory is a
tmp_path.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

from nds_tpu.engine import exec as JX
from nds_tpu.engine.session import Session as JaxSession
from nds_tpu_torch.analysis.budget import _annotate_spill
from nds_tpu_torch.dtypes import INT64, parse_dtype
from nds_tpu_torch.engine import exec as TX
from nds_tpu_torch.engine import spill as SP
from nds_tpu_torch.engine.columnar import Column, Table
from nds_tpu_torch.engine.session import Session as TorchSession

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import CS, strict_budget  # noqa: E402,F401
from torch_spill_cases import CASES, tables  # noqa: E402

torch.set_num_threads(1)

TABLES = tables()


def _jax(tmp_path, **conf):
    s = JaxSession(conf={"engine.aot_cache_dir": "",
                         "engine.feedback_dir": str(tmp_path / "feedback"),
                         "engine.spill_dir": str(tmp_path / "jax_spill"),
                         **conf})
    for name, t in TABLES.items():
        s.register_arrow(name, t)
    return s


def _torch(tmp_path, **conf):
    s = TorchSession(conf={"engine.spill_dir": str(tmp_path / "spill"),
                           "engine.feedback_dir":
                               str(tmp_path / "torch_feedback"),
                           **conf}, device="cpu")
    for name, t in TABLES.items():
        s.register_arrow(name, t)
    return s


def _run(session, executor_cls, sql):
    events = []
    restore = CS.branch_spy(executor_cls, events)
    try:
        return session.sql(sql).collect().to_pylist(), events
    finally:
        restore()


def _spill_events(events):
    return [e for e in events if e.startswith("spilled ")]


@pytest.mark.parametrize("parts", [2, 3, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forced_spill_matches_jax(tmp_path, case, parts):
    sql, op = CASES[case]
    conf = {"engine.spill": "force", "engine.spill_partitions": parts}
    want, ev_j = _run(_jax(tmp_path, **conf), JX.Executor, sql)
    t = _torch(tmp_path, **conf)
    got, ev_t = _run(t, TX.Executor, sql)
    assert got == want, (case, want[:3], got[:3])
    assert ev_t == ev_j
    if op is None:
        assert not _spill_events(ev_t) and t.last_spill is None
    else:
        assert f"spilled {op}, {parts} partitions" in ev_t
        assert t.last_spill["ops"] >= 1
        assert t.last_spill["partitions"] == parts
        assert t.last_spill["bytes_in"] == t.last_spill["bytes_out"]
        assert (t.last_spill["bytes_in"] > 0) == bool(got)
    direct, ev_d = _run(_torch(tmp_path, **{"engine.spill": "off"}),
                        TX.Executor, sql)
    assert not _spill_events(ev_d)
    if "order by" in sql:
        assert got == direct
    else:
        key = lambda r: tuple((v is None, v) for v in r.values())  # noqa
        assert sorted(got, key=key) == sorted(direct, key=key)


@pytest.mark.parametrize("parts", [2, 3, 7, 8])
def test_partition_ids_match_jax(parts):
    """Each engine puts every row in the same partition for every partition
    count: hash_columns' int64 hash modulo the count, floor-wise as the
    JAX engine's `%` takes it."""
    import jax.numpy as jnp
    from nds_tpu.ops import kernels as JK
    from nds_tpu_torch.ops import kernels as TK

    rng = np.random.default_rng(parts)
    a = rng.integers(-2**40, 2**40, 4096)
    b = rng.integers(0, 9, 4096).astype(np.int32)
    valid = rng.random(4096) < 0.9
    j = JK.hash_columns([jnp.asarray(a), jnp.asarray(b)],
                        [None, jnp.asarray(valid)]) % parts
    t = TK.hash_columns([torch.from_numpy(a), torch.from_numpy(b)],
                        [None, torch.from_numpy(valid)]) % parts
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert set(t.tolist()) == set(range(parts))


def test_disk_eviction_roundtrip_and_cleanup(tmp_path):
    """A 1-byte pool tiers every segment but the newest to disk: the result
    is the direct one, and the released segment files are unlinked."""
    sql = CASES["inner_join"][0]
    conf = {"engine.spill": "force", "engine.spill_partitions": 4,
            "engine.spill_pool_bytes": 1}
    want, _ = _run(_jax(tmp_path, **conf), JX.Executor, sql)
    t = _torch(tmp_path, **conf)
    got, _ = _run(t, TX.Executor, sql)
    assert got == want
    assert t.last_spill["evictions"] > 0
    stats = t.spill_pool.stats
    assert stats["disk_bytes_written"] > 0
    assert stats["disk_bytes_read"] == stats["disk_bytes_written"]
    assert not glob.glob(str(tmp_path / "spill" / "spill-*.npz"))


def test_annotation_driven_auto_mode(tmp_path):
    """`auto` (the default) spills exactly the nodes the budgeter
    annotated, and an unannotated plan never touches the pool."""
    sql = CASES["inner_join"][0]
    want, _ = _run(_torch(tmp_path, **{"engine.spill": "off"}),
                   TX.Executor, sql)
    auto = _torch(tmp_path)
    res = auto.sql(sql)
    assert auto.last_spill is None
    _annotate_spill(res.plan, 4)  # what a `spill` verdict would do
    assert res.collect().to_pylist() == want
    assert auto.last_spill["ops"] >= 1 and auto.last_spill["partitions"] == 4
    jax = _jax(tmp_path)
    jres = jax.sql(sql)
    from nds_tpu.analysis.budget import _annotate_spill as jax_annotate

    jax_annotate(jres.plan, 4)
    assert jres.collect().to_pylist() == want
    assert jax.last_spill["ops"] == auto.last_spill["ops"]
    auto.last_spill = None
    assert auto.sql(sql).collect().to_pylist() == want
    assert auto.last_spill is None


def test_spill_verdict_drives_auto_mode(tmp_path):
    """A working-set line below the modeled peak gives both session hooks
    the `spill` verdict with the same partition count, and the port's
    `auto` mode spills the annotated nodes."""
    sql = CASES["left_join_partition_order"][0]
    conf = {"engine.plan_budget_bytes": 1 << 16}
    t = _torch(tmp_path, **conf)
    got, ev_t = _run(t, TX.Executor, sql)
    j = _jax(tmp_path, **{"engine.fuse": "off", **conf})
    want, ev_j = _run(j, JX.Executor, sql)
    # both sessions record cardinality feedback into private directories
    assert t.last_plan_budget == j.last_plan_budget
    assert t.last_plan_budget["feedback_mode"] == "record"
    parts = t.last_plan_budget["spill_partitions"]
    assert t.last_plan_budget["verdict"] == "spill" and parts >= 2
    assert got == want and ev_t == ev_j
    assert f"spilled join, {parts} partitions" in ev_t
    assert t.last_spill["ops"] >= 1


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


def _int_table(n, cap=1024, valid=None):
    return Table({"x": Column(torch.arange(cap, dtype=torch.int64), INT64,
                              valid)}, n)


def test_pool_put_read_release_accounting(tmp_path):
    pool = SP.SpillPool(budget_bytes=1 << 20, spill_dir=str(tmp_path))
    seg = pool.put(_int_table(1000))
    assert seg.nrows == 1000
    assert pool.stats["bytes_in"] == seg.nbytes == 8 * 1000
    out = SP.assemble_segments(pool, [seg, seg], torch.device("cpu"))
    assert out.nrows == 2000 and out.cap == 2048
    np.testing.assert_array_equal(out.columns["x"].data[:2000].numpy(),
                                  np.tile(np.arange(1000), 2))
    assert pool.stats["bytes_out"] == 2 * seg.nbytes
    pool.release([seg])
    assert pool.host_bytes == 0


def test_pool_ram_only_over_budget_keeps_data():
    pool = SP.SpillPool(budget_bytes=1, spill_dir=None)  # no disk tier
    segs = [pool.put(_int_table(64)) for _ in range(3)]
    assert pool.stats["evictions"] == 0  # nowhere to evict to
    out = SP.assemble_segments(pool, segs, torch.device("cpu"))
    assert out.nrows == 192  # no data dropped


def test_pool_segments_keep_validity_and_dictionaries(tmp_path):
    """Segments of one input share its dictionary object; segments with
    different dictionaries are unified into one on assembly. Validity
    survives the disk tier."""
    from nds_tpu_torch.engine.columnar import column_from_arrow

    dt = parse_dtype("string")
    a = column_from_arrow(pa.array(["pear", None, "fig"]).dictionary_encode(),
                          dt, 1024, "cpu")
    b = column_from_arrow(pa.array(["kiwi", "fig"]).dictionary_encode(),
                          dt, 1024, "cpu")
    pool = SP.SpillPool(budget_bytes=1, spill_dir=str(tmp_path))
    sa = pool.put(Table({"s": a}, 3))
    sb = pool.put(Table({"s": b}, 2))
    assert pool.stats["evictions"] == 1 and sa.path is not None
    out = SP.assemble_segments(pool, [sa, sb], torch.device("cpu"))
    col = out.columns["s"]
    vals = [None if not v else col.dictionary[int(c)].as_py()
            for c, v in zip(col.data[:5].tolist(), col.valid[:5].tolist())]
    assert vals == ["pear", None, "fig", "kiwi", "fig"]
    same = SP.assemble_segments(pool, [sa, sa], torch.device("cpu"))
    assert same.columns["s"].dictionary is a.dictionary
    pool.close()
    assert not os.listdir(tmp_path)


def test_pool_never_aliases_a_device_buffer():
    x = torch.arange(1024, dtype=torch.int64)
    pool = SP.SpillPool(spill_dir=None)
    seg = pool.put(Table({"x": Column(x, INT64)}, 10))
    x.zero_()
    assert seg.datas[0].tolist() == list(range(10))


# ---------------------------------------------------------------------------
# crash hygiene: the orphan sweep
# ---------------------------------------------------------------------------


def _write_manifest(d, pid, app):
    with open(os.path.join(d, f"spill-manifest-{pid}.json"), "w") as f:
        json.dump({"magic": SP._MANIFEST_MAGIC, "pid": pid, "app": app}, f)


def _dead_pid():
    p = subprocess.Popen(["sleep", "0"])
    p.wait()
    return p.pid


def test_sweep_removes_dead_process_segments(tmp_path):
    d = str(tmp_path)
    dead = _dead_pid()
    _write_manifest(d, dead, "deadapp-abc")
    open(os.path.join(d, "spill-deadapp-abc-0.npz"), "wb").close()
    open(os.path.join(d, "spill-deadapp-abc-1.npz.tmp-1234"), "wb").close()
    _write_manifest(d, os.getpid(), "liveapp-xyz")
    open(os.path.join(d, "spill-liveapp-xyz-0.npz"), "wb").close()
    open(os.path.join(d, "unrelated.txt"), "w").close()
    # a foreign manifest (wrong magic) protects nothing and is untouched
    with open(os.path.join(d, "spill-manifest-99999999.json"), "w") as f:
        json.dump({"magic": "something-else", "pid": 1}, f)
    # a torn manifest write of the dead process goes; a live one's stays
    open(os.path.join(d, f"spill-manifest-{dead}.json.tmp-abcd1234"),
         "w").close()
    open(os.path.join(d, f"spill-manifest-{os.getpid()}.json.tmp-ef567890"),
         "w").close()
    assert SP.sweep_orphans(d) == 4
    left = sorted(os.listdir(d))
    assert "spill-liveapp-xyz-0.npz" in left
    assert "unrelated.txt" in left
    assert "spill-manifest-99999999.json" in left
    assert f"spill-manifest-{os.getpid()}.json.tmp-ef567890" in left
    assert not any("deadapp" in x for x in left)
    assert not any(f"manifest-{dead}" in x for x in left)


def test_session_start_sweeps_orphans(tmp_path, monkeypatch):
    d = str(tmp_path / "spill")
    os.makedirs(d)
    _write_manifest(d, _dead_pid(), "crashed-run")
    open(os.path.join(d, "spill-crashed-run-0.npz"), "wb").close()
    monkeypatch.setattr(SP, "_SWEPT_DIRS", set())  # a fresh process
    TorchSession(conf={"engine.spill_dir": d}, device="cpu")
    assert not glob.glob(os.path.join(d, "spill-crashed-run-*"))
    # a pool of the restarted session reuses the swept dir (write and read
    # back through the disk tier)
    s = _torch(tmp_path, **{"engine.spill": "force",
                            "engine.spill_partitions": 4,
                            "engine.spill_pool_bytes": 1,
                            "engine.spill_dir": d})
    out = s.sql("select distinct k from t1 order by k").collect()
    assert out.num_rows > 0
    assert s.last_spill["evictions"] > 0


def test_spill_progress_beats():
    s = TorchSession(device="cpu")
    assert s._progress_ts is None
    s.spill_progress()
    import threading

    assert s._progress_ts[0] == threading.get_ident()
