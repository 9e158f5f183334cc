"""The port's static plan budgeter (nds_tpu_torch/analysis/budget.py)
against the JAX package's (nds_tpu/analysis/budget.py).

All 99 TPC-DS templates bind in both packages on schema-only sessions
(both with fusion off, and both with fusion on: Pipeline nodes and their
aggregate tails) and go through both budgeters at SF 1, 10 and 100 with
the reference's 4 GiB
working-set and 14 GiB reject lines: the verdict, both peaks, the window,
the partition count, the spillable flag and every node's rows, width,
capacity and bytes must be EQUAL (the byte model is copied unchanged;
there is no tolerance). Then the cases of the JAX package's
tests/test_budget.py: the row and width models, the window clamps, q5
blocked at SF10 and direct at SF1, the SF10 device-OOM set flagged, reject
raising through the session hook, unknown tables, the static window equal
to the runtime sizing, and the card's lines.
"""

import os
import sys
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest

from nds_tpu.analysis import budget as JB
from nds_tpu.datagen.query_streams import available_templates, instantiate
from nds_tpu.engine.session import Session as JaxSession
from nds_tpu.engine.session import _Entry as JaxEntry
from nds_tpu.engine.sql.parser import parse_script as jax_parse
from nds_tpu.schema import get_schemas as jax_schemas
from nds_tpu_torch.analysis import budget as TB
from nds_tpu_torch.dtypes import parse_dtype
from nds_tpu_torch.engine import plan as TP
from nds_tpu_torch.engine.session import Session as TorchSession
from nds_tpu_torch.engine.session import _Entry as TorchEntry
from nds_tpu_torch.engine.sql.parser import parse_script as torch_parse
from nds_tpu_torch.schema import get_schemas as torch_schemas

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401

LINES = {"budget_bytes": 4 << 30, "reject_bytes": 14 << 30}


def _jax_schema_session(**conf):
    s = JaxSession(conf={"engine.plan_budget": "off", "engine.fuse": "off",
                         "engine.plan_cache": "off",
                         "engine.aot_cache_dir": "", **conf})
    for name, schema in jax_schemas(True).items():
        s.catalog.entries[name] = JaxEntry(schema=schema)
    return s


def _torch_schema_session(**conf):
    s = TorchSession(conf={"engine.plan_budget": "off", "engine.fuse": "off",
                           **conf}, device="cpu")
    for name, schema in torch_schemas(True).items():
        s.catalog.entries[name] = TorchEntry(schema=schema)
    return s


def _plans(session, parse, qnum, sf):
    rng = np.random.default_rng(np.random.SeedSequence([0, 0]))
    return [session.run_stmt(s).plan
            for s in parse(instantiate(qnum, rng, sf))]


def _same_budget(jb, tb, tag):
    for key in ("verdict", "peak_bytes", "peak_blocked_bytes",
                "budget_bytes", "window_rows", "spill_partitions",
                "spillable", "unknown_tables"):
        assert getattr(tb, key) == getattr(jb, key), (tag, key)
    assert len(tb.nodes) == len(jb.nodes), tag
    for jn, tn in zip(jb.nodes, tb.nodes):
        for key in ("desc", "rows", "width", "cap", "alloc_bytes",
                    "live_bytes", "peak_bytes", "blocked"):
            assert getattr(tn, key) == getattr(jn, key), (tag, jn.desc, key)


@pytest.fixture(scope="module")
def schema_sessions():
    return _jax_schema_session(), _torch_schema_session()


@pytest.fixture(scope="module")
def fused_schema_sessions():
    return (_jax_schema_session(**{"engine.fuse": "on"}),
            _torch_schema_session(**{"engine.fuse": "on"}))


def _same_template_budget(sessions, qnum, sf):
    j, t = sessions
    jplans = _plans(j, jax_parse, qnum, sf)
    tplans = _plans(t, torch_parse, qnum, sf)
    assert len(jplans) == len(tplans)
    for i, (jp, tp) in enumerate(zip(jplans, tplans)):
        jb = JB.analyze_plan(jp, j.catalog, scale_factor=sf, **LINES)
        tb = TB.analyze_plan(tp, t.catalog, scale_factor=sf, **LINES)
        _same_budget(jb, tb, f"query{qnum}[{i}] at SF{sf:g}")
    return tplans


@pytest.mark.parametrize("sf", [1.0, 10.0, 100.0])
@pytest.mark.parametrize("qnum", available_templates())
def test_template_budget_matches_jax(schema_sessions, qnum, sf):
    _same_template_budget(schema_sessions, qnum, sf)


@pytest.mark.parametrize("sf", [1.0, 10.0, 100.0])
@pytest.mark.parametrize("qnum", available_templates())
def test_template_budget_matches_jax_fused(fused_schema_sessions, qnum, sf):
    """The JAX package's defaults: every template plans Pipelines (PERF.md:
    all 99 have one), and the verdicts and modeled peaks stay exact."""
    tplans = _same_template_budget(fused_schema_sessions, qnum, sf)
    assert any(isinstance(n, TP.Pipeline)
               for p in tplans for n in TP.walk_plan(p))


# ---------------------------------------------------------------------------
# row / width models and window clamps
# ---------------------------------------------------------------------------


def test_spec_table_rows_match_jax():
    names = list(torch_schemas(True)) + ["not_a_table"]
    for sf in (0.01, 1.0, 3.0, 10.0, 100.0, 1000.0, 100000.0):
        for name in names:
            assert TB.spec_table_rows(name, sf) == JB.spec_table_rows(
                name, sf), (name, sf)
    assert TB.spec_table_rows("store_sales", 100.0) == 288_000_000
    assert TB.spec_table_rows("item", 100.0) == 204_000


def test_width_model_matches_jax():
    from nds_tpu.dtypes import parse_dtype as jax_dtype

    for spec in ("int32", "date", "string", "char(16)", "varchar(50)",
                 "bool", "int64", "float64", "decimal(7,2)"):
        assert TB.column_row_bytes(parse_dtype(spec)) == (
            JB.column_row_bytes(jax_dtype(spec))), spec
    for name in ("store_sales", "item", "date_dim"):
        tsch = {f.name: f.dtype for f in torch_schemas(True)[name]}
        jsch = {f.name: f.dtype for f in jax_schemas(True)[name]}
        assert TB.schema_row_bytes(tsch) == JB.schema_row_bytes(jsch)
    for n in (0, 1, 1024, 1025, 288_000_000):
        assert TB.bucket_cap(n) == JB.bucket_cap(n)


def test_window_clamps_and_shares_match_jax():
    for budget in (4 << 30, 6 << 30, 20 << 30, 30 << 30):
        for row_bytes in (1, 9, 45, 54, 1 << 40):
            w = TB.default_window_rows(row_bytes, budget)
            assert w == JB.default_window_rows(row_bytes, budget)
            assert w & (w - 1) == 0 and 1 << 16 <= w <= 1 << 24
    for peak in (1, 5 << 30, 9 << 30, 100 << 30, 1 << 50):
        assert TB.choose_spill_partitions(peak, 4 << 30) == (
            JB.choose_spill_partitions(peak, 4 << 30))
    assert TB.derive_share_bytes(96 << 30, 4, 1 << 30, 64 << 30) == (
        JB.derive_share_bytes(96 << 30, 4, 1 << 30, 64 << 30))
    for col in ("store.s_store_id", "ss_item_sk", "x.ss_quantity",
                "web_site.web_name", "made_up"):
        assert TB.column_domain_table(col) == JB.column_domain_table(col)


# ---------------------------------------------------------------------------
# verdicts (the reference's calibration points)
# ---------------------------------------------------------------------------


def test_query5_blocked_at_sf10_direct_at_sf1():
    t = _torch_schema_session()
    (plan,) = _plans(t, torch_parse, 5, 10.0)
    pb = TB.analyze_plan(plan, t.catalog, scale_factor=10.0)
    assert pb.verdict == "blocked"
    assert pb.window_rows and pb.window_rows & (pb.window_rows - 1) == 0
    assert pb.peak_bytes > pb.budget_bytes >= pb.peak_blocked_bytes
    (plan1,) = _plans(t, torch_parse, 5, 1.0)
    pb1 = TB.analyze_plan(plan1, t.catalog, scale_factor=1.0)
    assert pb1.verdict == "direct" and pb1.window_rows is None


def test_sf10_device_oom_set_flagged():
    """The JAX engine's SF10 device-OOM queries are never `direct`: q5
    blocked, q6 and q7 spill (a power-of-two partition count), q14
    rejected."""
    t = _torch_schema_session()
    for q, want in ((5, ["blocked"]), (6, ["spill"]), (7, ["spill"]),
                    (14, ["reject", "reject"])):
        pbs = [TB.analyze_plan(p, t.catalog, scale_factor=10.0)
               for p in _plans(t, torch_parse, q, 10.0)]
        assert [pb.verdict for pb in pbs] == want, q
        for pb in pbs:
            assert pb.spillable
            if pb.verdict == "spill":
                sp = pb.spill_partitions
                assert sp and sp & (sp - 1) == 0 and 2 <= sp <= 256


def _hook_sessions(**conf):
    conf = {"engine.plan_budget": "on", **conf}
    return _jax_schema_session(**conf), _torch_schema_session(**conf)


def test_session_hook_records_and_annotates_as_jax():
    """The Session's budget_plan hook: the same last_plan_budget record
    (every key) and the same annotations, for a blocked and a spill
    verdict and under an explicit window."""
    for q, conf in ((5, {}), (6, {}),
                    (5, {"engine.union_agg_window_rows": 1 << 23})):
        conf = {"engine.plan_budget_sf": 10.0,
                "engine.plan_budget_bytes": LINES["budget_bytes"],
                "engine.plan_budget_reject_bytes": LINES["reject_bytes"],
                **conf}
        j, t = _hook_sessions(**conf)
        (jp,) = _plans(j, jax_parse, q, 10.0)
        (tp,) = _plans(t, torch_parse, q, 10.0)
        assert t.last_plan_budget == j.last_plan_budget, q
        ann = [[(type(v).__name__, getattr(v, "budget_window_rows", None),
                 getattr(v, "spill_partitions", None))
                for v in P.walk_plan(p) if isinstance(v, P.PlanNode)]
               for P, p in ((TP, tp), (JB.P, jp))]
        assert ann[0] == ann[1], q
        assert any(a[1] or a[2] for a in ann[0]), q
    assert t.last_plan_budget["annotated"] is False


def test_reject_raises_warn_records():
    conf = {"engine.plan_budget_sf": 10.0,
            "engine.plan_budget_bytes": LINES["budget_bytes"],
            "engine.plan_budget_reject_bytes": LINES["reject_bytes"]}
    _, t = _hook_sessions(**conf)
    with pytest.raises(TB.PlanBudgetError):
        _plans(t, torch_parse, 14, 10.0)
    t = _torch_schema_session(**{**conf, "engine.plan_budget": "warn"})
    assert _plans(t, torch_parse, 14, 10.0)
    assert t.last_plan_budget["verdict"] == "reject"
    assert not t.last_plan_budget["annotated"]


def test_chip_smoke_runs_a_refused_statement_under_warn():
    """chip_smoke.py's handling of a statement the budgeter refuses at the
    session's lines: the refusal is checked (PlanBudgetError, verdict
    `reject`), the statement then runs under the reference's observe-only
    mode and gives the budgeter-off session's result, and the session's
    own mode, which still refuses, is restored after it."""
    from torch_join_cases import CS

    sql = "select k, sum(v) sv, count(*) n from t1 group by k order by k"
    s = _union_session(**{"engine.plan_budget_bytes": 1,
                          "engine.plan_budget_reject_bytes": 1})
    refused = CS.refusal(TB, s, sql)
    assert refused and refused["reject_gib"] == 1 / 2**30
    assert refused["modeled_peak_gib"] > refused["reject_gib"]
    with CS.admitted(s, refused):
        got = s.sql(sql).collect()
    assert "engine.plan_budget" not in s.conf
    assert s.last_plan_budget["verdict"] == "reject"
    assert not s.last_plan_budget["annotated"]
    with pytest.raises(TB.PlanBudgetError):
        s.sql(sql)
    off = _union_session(**{"engine.plan_budget": "off"})
    assert got.equals(off.sql(sql).collect())
    assert CS.refusal(TB, _union_session(), sql) is None


def test_unknown_tables_disable_enforcement():
    """A schema-only entry with no scale factor has no cardinality: the
    verdict is `unknown` in both engines, and the statement is admitted."""
    j, t = _hook_sessions()
    for s, parse in ((j, jax_parse), (t, torch_parse)):
        (stmt,) = parse("select count(*) c from date_dim")
        assert s.run_stmt(stmt) is not None
        assert s.last_plan_budget["verdict"] == "unknown"


def test_default_lines_of_a_cpu_session():
    t = TorchSession(device="cpu")
    assert TB.budget_lines(t.device) == TB.BudgetLines(
        JB.DEFAULT_BUDGET_BYTES, JB.DEFAULT_REJECT_BYTES, 6 << 30)
    assert TB.resolve_budget_bytes(t.conf, t.device) == 4 << 30
    assert TB.resolve_reject_bytes({}, t.device) == 14 << 30
    assert t.catalog.DEVICE_BUDGET_BYTES == 6 << 30
    assert TB.resolve_budget_bytes({"engine.plan_budget_bytes": 123}) == 123


def test_card_lines_follow_the_card(monkeypatch):
    """On a CUDA device the lines come from the card's memory M: catalog
    3M/8, working set M less the catalog less the allocator's headroom,
    reject M less the runtime's headroom; never above the card."""
    import torch

    class Props:
        total_memory = 85_000_000_000

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    m = Props.total_memory
    lines = TB.budget_lines("cuda:0")
    assert lines == TB.BudgetLines(
        m - 3 * m // 8 - TB.CARD_ALLOCATOR_HEADROOM_BYTES,
        m - TB.CARD_RUNTIME_HEADROOM_BYTES, 3 * m // 8)
    assert lines.working_set < lines.reject < m
    monkeypatch.setenv("NDS_PLAN_BUDGET_REJECT_BYTES", "777")
    monkeypatch.setenv("NDS_CATALOG_BUDGET_BYTES", "555")
    assert TB.resolve_reject_bytes({}, "cuda:0") == 777
    assert TB.resolve_catalog_bytes("cuda:0") == 555


# ---------------------------------------------------------------------------
# static window annotation vs the runtime sizing
# ---------------------------------------------------------------------------


def _channel(n, seed):
    r = np.random.default_rng(seed)
    ks = r.integers(1, 6, n)
    vs = r.integers(-50, 50, n)
    return pa.table({
        "k": pa.array([None if i % 13 == 0 else int(v)
                       for i, v in enumerate(ks)], pa.int32()),
        "v": pa.array([None if i % 7 == 0 else int(v)
                       for i, v in enumerate(vs)], pa.int32()),
        "amt": pa.array([Decimal(int(v) * 7) / 100 for v in vs],
                        pa.decimal128(7, 2)),
    })


UNION_AGG = """
select k, sum(v) sv, min(v) mn, max(v) mx, count(v) cv, avg(v) av,
       sum(amt) sa
from (select k, v, amt from t1
      union all
      select k, v, amt from t2 where v > -40
      union all
      select k, v, amt from t3) u
where v < 45
group by k
order by k
"""


def _union_session(**conf):
    s = TorchSession(conf=conf, device="cpu")
    for i, name in enumerate(("t1", "t2", "t3")):
        s.register_arrow(name, _channel(3000, seed=100 + i))
    return s


def test_static_window_annotation_matches_runtime_sizing():
    jax = JaxSession(conf={"engine.aot_cache_dir": ""})
    for i, name in enumerate(("t1", "t2", "t3")):
        jax.register_arrow(name, _channel(3000, seed=100 + i))
    oracle = jax.sql(UNION_AGG).to_pylist()
    assert _union_session().sql(UNION_AGG).to_pylist() == oracle
    runtime = _union_session(**{"engine.union_agg_window_rows": 512})
    assert runtime.sql(UNION_AGG).to_pylist() == oracle
    rt_stats = runtime.last_blocked_union
    assert rt_stats and rt_stats["window_rows"] == 512
    # the budgeter's annotation, placed as a blocked verdict places it,
    # routes through the same windowed executor with the same window
    static = _union_session()
    res = static.sql(UNION_AGG)
    TB._annotate_blocked_windows(res.plan, 512)
    assert res.to_pylist() == oracle
    st_stats = static.last_blocked_union
    assert st_stats["window_rows"] == 512
    assert st_stats["windows"] == rt_stats["windows"]
    assert st_stats["max_table_cap"] == rt_stats["max_table_cap"]
    # an explicit conf window still wins over the annotation
    both = _union_session(**{"engine.union_agg_window_rows": 1024})
    res2 = both.sql(UNION_AGG)
    TB._annotate_blocked_windows(res2.plan, 512)
    assert res2.to_pylist() == oracle
    assert both.last_blocked_union["window_rows"] == 1024


def test_over_budget_verdict_drives_the_window():
    """A working-set line below the union's modeled peak gives the JAX
    session's verdict and record in the session hook (`spill` here: at
    this size the smallest window models no less than the whole union),
    and the executor windows the union by the annotated size."""
    conf = {"engine.plan_budget_bytes": 1 << 16}
    s = TorchSession(conf=conf, device="cpu")
    jax = JaxSession(conf={"engine.aot_cache_dir": "", "engine.fuse": "off",
                           **conf})
    for i, name in enumerate(("t1", "t2", "t3")):
        for sess in (s, jax):
            sess.register_arrow(name, _channel(25_000, seed=100 + i))
    want = jax.sql(UNION_AGG).to_pylist()
    assert s.sql(UNION_AGG).to_pylist() == want
    assert s.last_plan_budget == jax.last_plan_budget
    rec = s.last_plan_budget
    assert rec["verdict"] == "spill" and rec["annotated"], rec
    stats = s.last_blocked_union
    assert stats["window_rows"] == rec["window_rows"] == 1 << 16
    assert stats["windows"] == jax.last_blocked_union["windows"] >= 2
