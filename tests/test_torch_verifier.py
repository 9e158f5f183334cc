"""The port's plan verifier (nds_tpu_torch.analysis.verifier) and its
Session hook (`engine.verify_plans`) against the JAX package's.

Each ported rule gets a hand-built violating plan, made by one function
from each package's own plan and expression classes, and both packages'
`verify_plan` must raise PlanVerifyError with the same stage, the same
violations (rule names and messages, in order) and the same text. Then
every TPC-DS template goes through both Sessions with
`engine.verify_plans=all` (the verifier after binding and after each
rewrite pass): schema-only catalogs, plans only, no execution; at SF0.01,
and at SF100 with the budgeter on so that its window and spill
annotations are in the plans the verifier checks. The JAX Session runs
as it ships (fusion on: its Pipeline rules run too) and raises nowhere;
neither does the port.

Tolerance: exact (the violations are strings).
"""

import os
import sys

import numpy as np
import pytest

from nds_tpu.analysis import verifier as JV
from nds_tpu.datagen.query_streams import available_templates, instantiate
from nds_tpu.engine import expr as JE
from nds_tpu.engine import plan as JPL
from nds_tpu.engine.session import Session as JaxSession
from nds_tpu.engine.session import _Entry as JaxEntry
from nds_tpu.schema import get_schemas as jax_schemas
from nds_tpu_torch import faults as TF
from nds_tpu_torch.analysis import verifier as TV
from nds_tpu_torch.engine import expr as TE
from nds_tpu_torch.engine import plan as TPL
from nds_tpu_torch.engine.session import Session as TorchSession
from nds_tpu_torch.engine.session import _Entry as TorchEntry
from nds_tpu_torch.schema import get_schemas as torch_schemas

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401

JAX = (JPL, JE, JV, jax_schemas)
TORCH = (TPL, TE, TV, torch_schemas)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("NDS_VERIFY_PLANS", "NDS_PLAN_BUDGET_BYTES",
                "NDS_PLAN_BUDGET_REJECT_BYTES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NDS_FLIGHT_RECORDER", "off")


class _Catalog:
    """The verifier's catalog interface over a package's table schemas."""

    def __init__(self, schemas):
        self._schemas = schemas(True)
        self.entries = {}

    def schema(self, name):
        return self._schemas.get(name)


def _scan(P, table="store_sales", alias="ss",
          cols=("ss_item_sk", "ss_quantity")):
    return P.Scan(table, alias, list(cols))


def _col(E, name):
    return E.Col(name)


# ---------------------------------------------------------------------------
# violating plans, one per rule: make(P, E) -> (plan, promotions)
# ---------------------------------------------------------------------------

def _topk_on_filter(P, E):
    n = P.Filter(E.BinOp(">", _col(E, "ss.ss_quantity"), E.Lit(5)),
                 _scan(P))
    n._topk_safe = True
    return n, ()


def _donate_on_project(P, E):
    n = P.Project([(_col(E, "ss.ss_item_sk"), "k")], _scan(P))
    n.donate_ok = True
    return n, ()


def _window_rows_on_plain_agg(P, E):
    n = P.Aggregate([(_col(E, "ss.ss_item_sk"), "k")],
                    [(E.Agg("sum", _col(E, "ss.ss_quantity")), "s")],
                    _scan(P))
    n.budget_window_rows = 1 << 20
    return n, ()


def _spill_on_aggregate(P, E):
    n = P.Aggregate([(_col(E, "ss.ss_item_sk"), "k")],
                    [(E.Agg("count", None), "c")], _scan(P))
    n.spill_partitions = 4
    return n, ()


def _spill_partitions(count):
    def build(P, E):
        n = P.Sort([(_col(E, "ss.ss_quantity"), True, None)], _scan(P))
        n.spill_partitions = count
        return n, ()
    return build


def _union(P, E):
    return P.SetOp(
        "union_all",
        P.Project([(_col(E, "ss.ss_item_sk"), "k"),
                   (_col(E, "ss.ss_quantity"), "q")], _scan(P)),
        P.Project([(_col(E, "cs.cs_item_sk"), "k"),
                   (_col(E, "cs.cs_quantity"), "q")],
                  _scan(P, "catalog_sales", "cs",
                        ("cs_item_sk", "cs_quantity"))))


def _blocked_over_scan(P, E):
    return P.Aggregate([(_col(E, "ss.ss_item_sk"), "k")],
                       [(E.Agg("sum", _col(E, "ss.ss_quantity")), "s")],
                       _scan(P), blocked_union=True), ()


def _blocked_distinct(P, E):
    return P.Aggregate([(_col(E, "k"), "k")],
                       [(E.Agg("count", _col(E, "q"), True), "c"),
                        (E.Agg("stddev_samp", _col(E, "q")), "sd")],
                       _union(P, E), blocked_union=True), ()


def _blocked_window_rows(P, E):
    n, _ = _blocked_distinct(P, E)
    n.budget_window_rows = 1 << 16
    n.spill_partitions = 2
    return n, ()


def _promotion_not_null_rejecting(P, E):
    return _scan(P), ({"conjunct": E.UnaryOp("isnull",
                                             _col(E, "i.i_brand_id")),
                       "refs": set()},)


def _promotion_without_refs(P, E):
    return _scan(P), ({"conjunct": E.BinOp("=", _col(E, "i.i_brand_id"),
                                           E.Lit(3)), "refs": set()},)


def _left_key_on_the_right(P, E):
    return P.Join("inner", _scan(P),
                  _scan(P, "item", "i", ("i_item_sk", "i_brand_id")),
                  [_col(E, "i.i_item_sk")], [_col(E, "i.i_item_sk")]), ()


def _right_key_on_the_left(P, E):
    return P.Join("left", _scan(P),
                  _scan(P, "item", "i", ("i_item_sk", "i_brand_id")),
                  [_col(E, "ss.ss_item_sk")], [_col(E, "ss.ss_item_sk")]), ()


def _key_counts(P, E):
    return P.Join("inner", _scan(P),
                  _scan(P, "item", "i", ("i_item_sk", "i_brand_id")),
                  [_col(E, "ss.ss_item_sk")],
                  [_col(E, "i.i_item_sk"), _col(E, "i.i_brand_id")]), ()


def _multijoin_edge(P, E):
    rels = [_scan(P), _scan(P, "item", "i", ("i_item_sk", "i_brand_id"))]
    return P.MultiJoin(rels, [(0, 1, _col(E, "i.i_item_sk"),
                               _col(E, "ss.ss_item_sk")),
                              (0, 5, _col(E, "ss.ss_item_sk"),
                               _col(E, "i.i_item_sk"))]), ()


def _shared_topk_sort(P, E):
    s = P.Sort([(_col(E, "ss.ss_quantity"), False, None)], _scan(P))
    s._topk_safe = True
    return P.SetOp("union_all", P.Limit(10, s), P.Limit(5, s)), ()


def _setop_names(P, E):
    u = _union(P, E)
    u.right.items[1] = (u.right.items[1][0], "quantity")
    return u, ()


def _qty_filter(P, E):
    return P.Filter(E.BinOp(">", _col(E, "ss.ss_quantity"), E.Lit(1)), None)


def _pipeline_no_stages(P, E):
    return P.Pipeline([], _scan(P)), ()


def _pipeline_over_pipeline(P, E):
    inner = P.Pipeline([_qty_filter(P, E)], _scan(P))
    return P.Pipeline([_qty_filter(P, E)], inner), ()


def _pipeline_attached_stage(P, E):
    stage = P.Filter(E.BinOp(">", _col(E, "ss.ss_quantity"), E.Lit(1)),
                     _scan(P))
    return P.Pipeline([stage], _scan(P)), ()


def _pipeline_unfusible(P, E):
    sub = E.ScalarSubquery(P.Aggregate(
        [], [(E.Agg("max", _col(E, "i.i_item_sk")), "m")],
        _scan(P, "item", "i", ("i_item_sk", "i_brand_id"))), "m")
    stage = P.Filter(E.BinOp(">", _col(E, "ss.ss_item_sk"), sub), None)
    return P.Pipeline([stage], _scan(P)), ()


def _pipeline_donate_scan(P, E):
    return P.Pipeline([_qty_filter(P, E)], _scan(P), donate_ok=True), ()


def _pipeline_donate_shared(P, E):
    mj = P.MultiJoin(
        [_scan(P), _scan(P, "item", "i", ("i_item_sk", "i_brand_id"))],
        [(0, 1, _col(E, "ss.ss_item_sk"), _col(E, "i.i_item_sk"))])
    a = P.Pipeline([_qty_filter(P, E)], mj, donate_ok=True)
    b = P.Pipeline([_qty_filter(P, E)], mj)
    return P.SetOp("union_all", a, b), ()


def _pipeline_agg_distinct(P, E):
    agg = P.Aggregate([(_col(E, "ss.ss_item_sk"), "k")],
                      [(E.Agg("count", _col(E, "ss.ss_quantity"), True),
                        "c")], None)
    return P.Pipeline([_qty_filter(P, E)], _scan(P), agg=agg), ()


def _pipeline_agg_attached(P, E):
    agg = P.Aggregate([(_col(E, "ss.ss_item_sk"), "k")],
                      [(E.Agg("sum", _col(E, "ss.ss_quantity")), "s")],
                      _scan(P))
    return P.Pipeline([], _scan(P), agg=agg), ()


RULES = {
    "pipeline-no-stages": (_pipeline_no_stages, "pipeline"),
    "pipeline-not-maximal": (_pipeline_over_pipeline, "pipeline"),
    "pipeline-attached-stage": (_pipeline_attached_stage, "pipeline"),
    "pipeline-unfusible": (_pipeline_unfusible, "pipeline"),
    "pipeline-donate-scan": (_pipeline_donate_scan, "donate"),
    "pipeline-donate-shared": (_pipeline_donate_shared, "donate"),
    "pipeline-agg-distinct": (_pipeline_agg_distinct, "pipeline-agg"),
    "pipeline-agg-attached": (_pipeline_agg_attached, "pipeline-agg"),
    "annotation-topk": (_topk_on_filter, "physical-annotation"),
    "annotation-donate": (_donate_on_project, "physical-annotation"),
    "annotation-window-rows": (_window_rows_on_plain_agg,
                               "physical-annotation"),
    "spill-not-spillable": (_spill_on_aggregate, "spill"),
    "spill-not-pow2": (_spill_partitions(3), "spill"),
    "spill-out-of-range": (_spill_partitions(512), "spill"),
    "spill-not-int": (_spill_partitions(2.0), "spill"),
    "blocked-union-shape": (_blocked_over_scan, "blocked-union"),
    "blocked-union-aggs": (_blocked_distinct, "blocked-union"),
    "blocked-union-annotations": (_blocked_window_rows, "blocked-union"),
    "promotion-not-null-rejecting": (_promotion_not_null_rejecting,
                                     "left-inner-promotion"),
    "promotion-without-refs": (_promotion_without_refs,
                               "left-inner-promotion"),
    "join-key-left-scope": (_left_key_on_the_right, "schema"),
    "join-key-right-scope": (_right_key_on_the_left, "schema"),
    "join-key-counts": (_key_counts, "join-keys"),
    "multijoin-edge-scope": (_multijoin_edge, "join-keys"),
    "topk-shared-sort": (_shared_topk_sort, "topk"),
    "setop-names": (_setop_names, "setop"),
}


def _verify(pkg, build, stage="final"):
    P, E, V, schemas = pkg
    plan, promotions = build(P, E)
    with pytest.raises(V.PlanVerifyError) as info:
        V.verify_plan(plan, _Catalog(schemas), stage=stage,
                      promotions=promotions)
    return info.value


@pytest.mark.parametrize("rule", sorted(RULES))
def test_violation_matches_jax(rule):
    build, name = RULES[rule]
    j = _verify(JAX, build, stage=f"after-{rule}")
    t = _verify(TORCH, build, stage=f"after-{rule}")
    assert t.violations == j.violations
    assert t.stage == j.stage == f"after-{rule}"
    assert str(t) == str(j)
    assert any(v.startswith(f"{name}: ") for v in t.violations), t.violations
    assert TF.classify(t) == TF.PLANNER


@pytest.mark.parametrize("rule", sorted(RULES))
def test_verifier_collects_the_same_violations(rule):
    """The PlanVerifier's own list, without the raise."""
    build, _ = RULES[rule]
    out = []
    for P, E, V, schemas in (JAX, TORCH):
        plan, promotions = build(P, E)
        out.append(V.PlanVerifier(_Catalog(schemas)).verify(plan,
                                                            promotions))
    assert out[0] == out[1] and out[1]


def test_clean_plan_verifies_in_both():
    for P, E, V, schemas in (JAX, TORCH):
        plan = P.Limit(10, P.Sort([(_col(E, "k"), True, None)],
                                  _union(P, E)))
        V.verify_plan(plan, _Catalog(schemas))


@pytest.mark.parametrize("conf,env", [
    ({}, None), ({"engine.verify_plans": "final"}, None),
    ({"engine.verify_plans": "ALL"}, None), ({}, "all"), ({}, "final"),
    ({"engine.verify_plans": "off"}, "all"),
    ({"engine.verify_plans": "bogus"}, None), ({}, "1"),
])
def test_levels_match_jax(conf, env, monkeypatch):
    if env is not None:
        monkeypatch.setenv("NDS_VERIFY_PLANS", env)
    assert TV.LEVELS == JV.LEVELS
    try:
        want = JV.resolve_level(conf)
    except ValueError as exc:
        with pytest.raises(ValueError) as info:
            TV.resolve_level(conf)
        assert str(info.value) == str(exc)
        return
    assert TV.resolve_level(conf) == want


def test_mesh_raises_naming_item_13():
    with pytest.raises(NotImplementedError, match="item 13"):
        TV.verify_plan(_union(TPL, TE), _Catalog(torch_schemas),
                       mesh=object())


def test_clean_pipelines_verify_in_both():
    """A fused chain and a fused aggregate tail over it pass both."""
    for P, E, V, schemas in (JAX, TORCH):
        agg = P.Aggregate([(_col(E, "ss.ss_item_sk"), "k")],
                          [(E.Agg("sum", _col(E, "ss.ss_quantity")), "s")],
                          None)
        plan = P.Pipeline([_qty_filter(P, E)], _scan(P), agg=agg)
        V.verify_plan(plan, _Catalog(schemas))


def test_count_plan_refs_matches_jax():
    counts = []
    for P, E, V, _ in (JAX, TORCH):
        plan, _ = _shared_topk_sort(P, E)
        counts.append(sorted(V._count_plan_refs(plan).values()))
    assert counts[0] == counts[1] and 2 in counts[1]


# ---------------------------------------------------------------------------
# the Session hook: every template through both sessions at `all`
# ---------------------------------------------------------------------------

def _jax_session(**conf):
    s = JaxSession(conf={"engine.aot_cache_dir": "",
                         "engine.plan_cache": "off", **conf})
    for name, schema in jax_schemas(True).items():
        s.catalog.entries[name] = JaxEntry(schema=schema)
    return s


def _torch_session(**conf):
    s = TorchSession(conf=conf, device="cpu")
    for name, schema in torch_schemas(True).items():
        s.catalog.entries[name] = TorchEntry(schema=schema)
    return s


#: (scale factor, conf): the budgeter annotates at SF100 (its reject line
#: lifted past every model, so no plan is refused before its last check)
SCALES = (
    (0.01, {"engine.plan_budget": "off"}),
    (100, {"engine.plan_budget": "on", "engine.plan_budget_sf": 100.0,
           "engine.plan_budget_reject_bytes": 1 << 50}),
)


@pytest.mark.parametrize("qnum", available_templates())
def test_template_verifies_at_all_in_both(qnum, monkeypatch):
    """Plans only, no execution."""
    from nds_tpu.engine.sql.parser import parse_script as jax_parse
    from nds_tpu_torch.engine.sql.parser import parse_script as torch_parse

    stages = {"jax": [], "torch": []}
    for tag, mod in (("jax", JV), ("torch", TV)):
        orig = mod.verify_plan

        def spy(plan, catalog=None, stage="final", *a, _o=orig, _t=tag,
                **k):
            stages[_t].append(stage)
            return _o(plan, catalog, stage, *a, **k)
        monkeypatch.setattr(mod, "verify_plan", spy)
    for sf, conf in SCALES:
        conf = {**conf, "engine.verify_plans": "all"}
        text = instantiate(qnum, np.random.default_rng(
            np.random.SeedSequence([0, 0])), sf)
        j, t = _jax_session(**conf), _torch_session(**conf)
        jplans = [j.run_stmt(s).plan for s in jax_parse(text)]
        tplans = [t.run_stmt(s).plan for s in torch_parse(text)]
        assert len(jplans) == len(tplans) > 0
    # the port's stages are the reference's, the fusion pass included
    assert stages["torch"] == stages["jax"]
    assert set(stages["torch"]) == {"bind", "prune_columns",
                                    "mark_blocked_union_aggs",
                                    "mark_pipelines", "plan_budget"}


@pytest.mark.parametrize("qnum", available_templates())
def test_template_verifies_at_all_unfused(qnum):
    """`engine.fuse=off` in both: the same plans less the fusion pass."""
    from nds_tpu.engine.sql.parser import parse_script as jax_parse
    from nds_tpu_torch.engine.sql.parser import parse_script as torch_parse

    for sf, conf in SCALES:
        conf = {**conf, "engine.verify_plans": "all", "engine.fuse": "off"}
        text = instantiate(qnum, np.random.default_rng(
            np.random.SeedSequence([0, 0])), sf)
        j, t = _jax_session(**conf), _torch_session(**conf)
        jplans = [j.run_stmt(s).plan for s in jax_parse(text)]
        tplans = [t.run_stmt(s).plan for s in torch_parse(text)]
        assert [JPL.explain(p) for p in jplans] == [
            TPL.explain(p) for p in tplans]
        assert not any(isinstance(n, TPL.Pipeline)
                       for p in tplans for n in TPL.walk_plan(p))


def _corrupting(mod):
    """mark_blocked_union_aggs that also puts a spill count on a Limit."""
    orig = mod.mark_blocked_union_aggs

    def mark(plan):
        out = orig(plan)
        for v in mod.walk_plan(plan):
            if isinstance(v, mod.Limit):
                v.spill_partitions = 4
        return out
    return mark


@pytest.mark.parametrize("level,stage", [("all", "mark_blocked_union_aggs"),
                                         ("final", "final")])
def test_session_raises_at_the_reference_stage(level, stage, monkeypatch):
    monkeypatch.setattr(JPL, "mark_blocked_union_aggs", _corrupting(JPL))
    monkeypatch.setattr(TPL, "mark_blocked_union_aggs", _corrupting(TPL))
    sql = ("select i_brand_id, count(*) c from item group by i_brand_id "
           "order by c limit 5")
    errs = []
    for make, mod in ((_jax_session, JV), (_torch_session, TV)):
        s = make(**{"engine.verify_plans": level,
                    "engine.plan_budget": "off"})
        with pytest.raises(mod.PlanVerifyError) as info:
            s.sql(sql)
        errs.append(info.value)
    assert errs[1].stage == errs[0].stage == stage
    assert errs[1].violations == errs[0].violations


def test_session_off_never_calls_the_verifier(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("verifier called with verify_plans off")
    monkeypatch.setattr(TV, "verify_plan", boom)
    for conf in ({}, {"engine.verify_plans": "off"}):
        s = _torch_session(**conf, **{"engine.plan_budget": "off"})
        s.sql("select count(*) c from item")
    monkeypatch.setenv("NDS_VERIFY_PLANS", "off")
    _torch_session(**{"engine.plan_budget": "off"}).sql(
        "select count(*) c from item")
