"""The hand-written kernels of nds_tpu_torch/ops/csrc/ against their plain
PyTorch versions, on the card. Every test here needs a CUDA card and skips
without one (a CUDA kernel has no CPU mode). The file imports no jax, so
it runs on a machine that has only torch:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

The observability layer's card-only behaviour is here too: a kernel span
waits for its CUDA result, the memory sampler reads the caching
allocator (and creates no CUDA context in a spawn child), and
/debug/jaxprof writes a torch.profiler trace.

Tolerance: EXACT. Measures are integers small enough that f32 sums are
exact in any accumulation order; counts, extremes, dense tables, ranks,
histograms and permutations are integers or exact selections.
"""

import json
import os

import numpy as np
import pytest
import torch

from nds_tpu_torch.ops import gpu_kernels as GK

torch.set_num_threads(1)

SEG_CASES = [(1000, 10), (4096, 300), (2048, 700), (100, 1)]


def _seg_inputs(n, g, seed, lo=0, hi=1000):
    rng = np.random.default_rng(seed)
    vals = rng.integers(lo, hi, n).astype(np.float32)  # exact in f32
    gid = rng.integers(-1, g, n).astype(np.int32)  # -1 = dead
    return vals, gid


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from nds_tpu_torch.engine.session import resolve_device

    # the package's entry point, before the first CUDA allocation: it
    # makes the allocator's expandable segments hold, as a CUDA Session
    # requires
    return resolve_device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,g", SEG_CASES + [(1 << 20, 4096), (1 << 20, 9000)])
def test_segment_kernels_match_plain_on_card(cuda, n, g):
    vals, gid = _seg_inputs(n, g, n + g)
    for gg in (gid, np.sort(gid)):  # sorted ids: whole warps on one group
        v, i = torch.from_numpy(vals).to(cuda), torch.from_numpy(gg).to(cuda)
        ks, kc = GK.segment_sums(v, i, g)
        ps, pc = GK.segment_sums_plain(v, i, g)
        assert torch.equal(kc, pc) and torch.equal(ks, ps)
        for is_max in (False, True):
            ke, kc = GK.segment_extreme(v, i, g, is_max)
            pe, pc = GK.segment_extreme_plain(v, i, g, is_max)
            assert torch.equal(kc, pc) and torch.equal(ke, pe)


@pytest.mark.gpu
def test_dense_build_and_sort_match_plain_on_card(cuda):
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(rng.integers(-5, 70000, 50000)).to(cuda)
    live = torch.from_numpy(rng.random(50000) > 0.1).to(cuda)
    kp, kr = GK.dense_build(keys, live, 3, 65536)
    pp, pr = GK.dense_build_plain(keys, live, 3, 65536)
    assert torch.equal(kp, pp) and torch.equal(kr, pr)
    for n, dom in [(1, 128), (5000, 2048), (3_000_000, 384)]:
        w = torch.from_numpy(rng.integers(0, dom, n)).to(cuda)
        assert torch.equal(GK.sort_perm(w, dom), GK.sort_perm_plain(w, dom))
        r, h = GK.sort_rank(w.int(), dom)
        pr_, ph = GK.sort_rank_plain(w.int(), dom)
        assert torch.equal(r, pr_) and torch.equal(h, ph)


# ---------------------------------------------------------------------------
# The shapes on which the redesigned segment_extreme and dense_build kernels
# branch: 16-byte chunks and their ragged tail, unaligned heads, the plan's
# shared-memory limits, single-group warps, NaN, the owner and cooperative
# paths of dense_build. Kernel against plain version, exactly.
# ---------------------------------------------------------------------------

_TWO_PER_SM = (GK.SMEM_PER_SM - 2 * 1024) // 2
G_TWO = _TWO_PER_SM // 12
G_ONE = GK.SMEM_PER_BLOCK // 12


def _same_extreme(v, i, g):
    for is_max in (False, True):
        ke, kc = GK.segment_extreme(v, i, g, is_max)
        pe, pc = GK.segment_extreme_plain(v, i, g, is_max)
        assert torch.equal(kc, pc)
        # NaN where the plain version has NaN, equal values elsewhere
        assert torch.equal(torch.isnan(ke), torch.isnan(pe))
        assert torch.equal(torch.nan_to_num(ke), torch.nan_to_num(pe))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 5, 4097])
@pytest.mark.parametrize(
    "g", [10, G_TWO, G_TWO + 1, G_ONE, G_ONE + 1])
def test_segment_extreme_tail_and_table_limits_on_card(cuda, n, g):
    vals, gid = _seg_inputs(n, g, n + g, -500, 500)
    _same_extreme(torch.from_numpy(vals).to(cuda),
                  torch.from_numpy(gid).to(cuda), g)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one_group", "one_of_many", "sorted",
                                  "dead_tail"])
def test_segment_extreme_uniform_runs_on_card(cuda, case):
    n = (1 << 20) + 3
    vals, gid = _seg_inputs(n, 300, 5, -500, 500)
    g = 300
    if case == "one_group":  # 2^20 rows, one group: no 32-way contention
        g, gid = 1, np.zeros_like(gid)
    elif case == "one_of_many":
        gid = np.full_like(gid, 7)
    elif case == "sorted":
        gid = np.sort(gid)
    else:  # live rows, then padding lanes, as at fact width
        gid[n // 2:] = -1
    _same_extreme(torch.from_numpy(vals).to(cuda),
                  torch.from_numpy(gid).to(cuda), g)


@pytest.mark.gpu
@pytest.mark.parametrize("ids", ["random", "one_group"])
def test_segment_extreme_nan_on_card(cuda, ids):
    g = 8
    vals, gid = _seg_inputs(4099, g, 11, -50, 50)
    if ids == "one_group":
        gid = np.where(gid >= 0, 5, gid).astype(np.int32)
    vals[:2], gid[:2] = np.nan, [-1, g]  # dead lanes: no effect
    v, i = torch.from_numpy(vals).to(cuda), torch.from_numpy(gid).to(cuda)
    _same_extreme(v, i, g)
    assert not torch.isnan(GK.segment_extreme(v, i, g, True)[0]).any()
    vals[4098], gid[4098] = np.nan, 5  # the last row (the ragged tail), live
    vals[2000], gid[2000] = np.nan, 3  # a row of a 16-byte chunk, live
    v, i = torch.from_numpy(vals).to(cuda), torch.from_numpy(gid).to(cuda)
    _same_extreme(v, i, g)
    ext = GK.segment_extreme(v, i, g, False)[0]
    assert bool(torch.isnan(ext[5])) and bool(torch.isnan(ext[3]))


@pytest.mark.gpu
@pytest.mark.parametrize("off_v,off_g", [(1, 1), (2, 2), (3, 3), (1, 0),
                                         (0, 3)])
def test_segment_extreme_unaligned_slices_on_card(cuda, off_v, off_g):
    n = 100_003
    vals, gid = _seg_inputs(n + 3, 50, off_v * 4 + off_g, -500, 500)
    v = torch.from_numpy(vals).to(cuda)[off_v:off_v + n]
    i = torch.from_numpy(gid).to(cuda)[off_g:off_g + n]
    assert v.is_contiguous() and i.is_contiguous()
    _same_extreme(v, i, 50)


def _same_dense(keys, live, rmin, cap, plan=None):
    kp, kr = GK.dense_build(keys, live, rmin, cap, plan=plan)
    pp, pr = GK.dense_build_plain(keys, live, rmin, cap)
    assert torch.equal(kp, pp) and torch.equal(kr, pr)


def _dense_inputs(cuda, n, rmin, cap, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(rmin - 50, rmin + cap + 50, n).astype(np.int64)
    live = rng.random(n) > 0.2
    return (torch.from_numpy(keys).to(cuda), torch.from_numpy(live).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 3, 5, 4097])
@pytest.mark.parametrize("rmin", [-100, 0, 2_450_815])
def test_dense_build_small_on_card(cuda, n, rmin):
    keys, live = _dense_inputs(cuda, n, rmin, 1 << 18, n + rmin % 997)
    if n >= 3:  # a duplicate key (the larger row wins) and the last slot
        keys[:3] = torch.tensor([rmin, rmin, rmin + (1 << 18) - 1])
        live[:3] = True
    _same_dense(keys, live, rmin, 1 << 18)
    _same_dense(keys, live, rmin, 1000)  # a table not a multiple of 16


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [1 << 18, 1 << 21, 1 << 23])
@pytest.mark.parametrize("side", [0, 1])
def test_dense_build_across_owner_threshold_on_card(cuda, cap, side):
    n = GK.dense_owner_max_rows(cap) + side
    keys, live = _dense_inputs(cuda, n, -3, cap, cap + side)
    _same_dense(keys, live, -3, cap)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["owner", "cooperative"])
def test_dense_build_every_path_on_card(cuda, path):
    for n, cap in [(0, 64), (5000, 1 << 18), (70_000, 100_000)]:
        plan = GK.dense_build_plan(0, cap)  # the owner layout
        if path != "owner":
            plan = GK.DensePlan(path, 0, 0)
        keys, live = _dense_inputs(cuda, n, 7, cap, n)
        _same_dense(keys, live, 7, cap, plan)


@pytest.mark.gpu
@pytest.mark.parametrize("off_k,off_l", [(1, 1), (1, 3), (0, 2)])
@pytest.mark.parametrize("n", [4097, 300_001])
def test_dense_build_unaligned_slices_on_card(cuda, n, off_k, off_l):
    keys, live = _dense_inputs(cuda, n + 3, -9, 1 << 18, n + off_l)
    _same_dense(keys[off_k:off_k + n], live[off_l:off_l + n], -9, 1 << 18)


@pytest.mark.gpu
def test_dense_build_customer_scale_on_card(cuda):
    """2^21 build rows into 2^21 slots (customer at SF100): the
    cooperative path, a unique permuted key per row."""
    rng = np.random.default_rng(21)
    n = 1 << 21
    keys = torch.from_numpy(rng.permutation(n).astype(np.int64) + 1).to(cuda)
    live = torch.from_numpy(rng.random(n) > 0.04).to(cuda)
    _same_dense(keys, live, 1, n)


# ---------------------------------------------------------------------------
# The shapes on which the redesigned sort_perm and segment_sums kernels
# branch: one and several CTAs, whole and ragged 4,096-row tiles and CTA
# row ranges, domains 1..2048, one key,
# sorted and reverse-sorted words, -1 lanes, int32 and int64 words,
# unaligned slices; segment_sums' shared tables on both sides of their
# limits, sorted ids with dead lanes, one group, the global path.
# Kernel against plain version, exactly.
# ---------------------------------------------------------------------------

SORT_NS = [0, 1, 3, 4095, 4096, 4097, 2 * GK.SORT_TILE,
           2 * GK.SORT_TILE + 1, 65536, (1 << 20) + 3]


def _same_sort(w, dom):
    got = GK.sort_perm(w, dom)
    assert got.dtype == torch.int32
    assert torch.equal(got, GK.sort_perm_plain(w, dom))


@pytest.mark.gpu
@pytest.mark.parametrize("dom", [1, 128, 129, 2048])
@pytest.mark.parametrize("n", SORT_NS)
def test_sort_perm_matches_plain_on_card(cuda, n, dom):
    rng = np.random.default_rng(n + dom)
    w = torch.from_numpy(rng.integers(0, dom, n)).to(cuda)
    _same_sort(w, dom)
    _same_sort(w.int(), dom)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4097, 65536, 300_001])
def test_sort_perm_odd_sizes_on_card(cuda, n):
    """Sizes whose last CTA owns a ragged range (300,001 rows: 74 whole
    tiles and a partial one over the plan's grid)."""
    rng = np.random.default_rng(n)
    for dom in (1, 384, 2048):
        w = torch.from_numpy(rng.integers(0, dom, n)).to(cuda)
        _same_sort(w, dom)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one_key", "sorted", "reverse", "runs"])
@pytest.mark.parametrize("n", [4097, (1 << 20) + 3])
def test_sort_perm_patterns_on_card(cuda, case, n):
    rng = np.random.default_rng(3)
    dom = 2048
    w = rng.integers(0, dom, n)
    if case == "one_key":
        w[:] = dom - 1
    elif case == "sorted":
        w.sort()
    elif case == "reverse":
        w = np.sort(w)[::-1].copy()
    else:  # runs of a few keys, as an ORDER BY over a filtered fact
        w = rng.integers(96, 101, n)
    _same_sort(torch.from_numpy(w).to(cuda), dom)


@pytest.mark.gpu
@pytest.mark.parametrize("off", [1, 2, 3])
@pytest.mark.parametrize("n", [4097, 100_003])
def test_sort_perm_unaligned_slices_on_card(cuda, off, n):
    rng = np.random.default_rng(off + n)
    w = torch.from_numpy(rng.integers(0, 384, n + 3)).to(cuda)
    for word in (w, w.int()):
        s = word[off:off + n]
        assert s.is_contiguous()
        _same_sort(s, 384)


@pytest.mark.gpu
@pytest.mark.parametrize("dom", [1, 129, 2048])
@pytest.mark.parametrize("n", [3, 4097, 2 * GK.SORT_TILE + 1,
                               (1 << 20) + 3])
def test_sort_rank_padding_lanes_on_card(cuda, n, dom):
    rng = np.random.default_rng(n * 3 + dom)
    v = rng.integers(0, dom, n).astype(np.int32)
    v[::17] = -1  # padding lanes: counted nowhere, rank unspecified
    v[5::23] = dom  # past the domain: the same
    vals = torch.from_numpy(v).to(cuda)
    live = torch.from_numpy((v >= 0) & (v < dom)).to(cuda)
    r, h = GK.sort_rank(vals, dom)
    pr, ph = GK.sort_rank_plain(vals, dom)
    assert torch.equal(h, ph)
    assert torch.equal(r[live], pr[live])


@pytest.mark.gpu
def test_sort_perm_tail_is_zero_and_counts_launches(cuda):
    """A word with keys past the domain: in-domain rows sorted first, the
    rest of perm zero (the contract the TPU kernel's scatter leaves)."""
    w = torch.tensor([5, 1, 9, 1, 0], dtype=torch.int64, device=cuda)
    GK.reset_launches()
    got = GK.sort_perm(w, 8)
    assert got.tolist() == [4, 1, 3, 0, 0]
    assert GK.LAUNCHES["sort_perm"] == 1


_SUMS_TWO, _SUMS_ONE = GK._sums_table_limits()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 3, 5, 4097, 262_147])
@pytest.mark.parametrize("g", [1, 4096, _SUMS_TWO, _SUMS_TWO + 1, _SUMS_ONE,
                               _SUMS_ONE + 1, 65536])
def test_segment_sums_tables_and_tails_on_card(cuda, n, g):
    vals, gid = _seg_inputs(n, g, n + g, 0, 100)
    v, i = torch.from_numpy(vals).to(cuda), torch.from_numpy(gid).to(cuda)
    ks, kc = GK.segment_sums(v, i, g)
    ps, pc = GK.segment_sums_plain(v, i, g)
    assert torch.equal(kc, pc) and torch.equal(ks, ps)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["sorted_dead", "one_group", "all_dead",
                                  "nan_dead"])
def test_segment_sums_runs_on_card(cuda, case):
    n, g = (1 << 20) + 3, 4096
    vals, gid = _seg_inputs(n, g, 17, 0, 4)
    if case == "sorted_dead":  # sorted ids, dead lanes in between
        gid = np.sort(gid)
        gid[np.random.default_rng(1).random(n) < 0.3] = -1
    elif case == "one_group":  # 2^20 rows of one group: sums < 2^24, exact
        g, gid = 1, np.zeros_like(gid)
    elif case == "all_dead":
        gid[:] = -1
    else:  # NaN in dead lanes only: must not reach a sum
        vals[gid < 0] = np.nan
    v, i = torch.from_numpy(vals).to(cuda), torch.from_numpy(gid).to(cuda)
    GK.reset_launches()
    ks, kc = GK.segment_sums(v, i, g)
    assert GK.LAUNCHES["segment_sums"] == 1
    ps, pc = GK.segment_sums_plain(v, i, g)
    assert torch.equal(kc, pc) and torch.equal(ks, ps)


@pytest.mark.gpu
@pytest.mark.parametrize("off_v,off_g", [(1, 1), (2, 2), (3, 3), (1, 0),
                                         (0, 3)])
def test_segment_sums_unaligned_slices_on_card(cuda, off_v, off_g):
    n = 100_003
    vals, gid = _seg_inputs(n + 3, 50, off_v * 4 + off_g)
    v = torch.from_numpy(vals).to(cuda)[off_v:off_v + n]
    i = torch.from_numpy(gid).to(cuda)[off_g:off_g + n]
    ks, kc = GK.segment_sums(v, i, 50)
    ps, pc = GK.segment_sums_plain(v, i, 50)
    assert torch.equal(kc, pc) and torch.equal(ks, ps)


# ---------------------------------------------------------------------------
# The joins and set operators on the card: every join branch, DISTINCT, the
# set operations and the distinct aggregates (tests/torch_join_cases.py),
# and chip_smoke's joins-phase queries cut to size, through
# Session(device="cuda") against the same port session on the CPU, with
# the kernels off and on. Tolerance as in torch_join_cases: floats within
# 1e-5 relative (f32 kernel sums in another order), the rest exactly.
# ---------------------------------------------------------------------------


def _join_cases():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_join_cases

    return torch_join_cases


def _port_sessions(device, tables, mode, conf=None):
    from nds_tpu_torch.engine.session import Session

    s = Session(conf={**(conf or {}), **{f"engine.pallas_{k}": mode
                                        for k in ("agg", "join", "sort")}},
                device=device)
    for name, t in tables.items():
        s.register_arrow(name, t)
    return s


def _same_on_card_and_cpu(cuda, tables, sql, mode, ordered=False,
                          conf=None):
    from nds_tpu_torch.engine import exec as TX

    C = _join_cases()
    out, events = [], []
    for dev in (cuda, "cpu"):
        ev = []
        restore = C.CS.branch_spy(TX.Executor, ev)
        try:
            out.append(_port_sessions(dev, tables, mode, conf)
                       .sql(sql).collect())
        finally:
            restore()
        events.append(ev)
    assert events[0] == events[1]
    C.assert_same(out[0], out[1], (sql, mode), ordered=ordered)
    return events[0]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("case", sorted(_join_cases().CASES))
def test_join_branch_on_card_matches_cpu(cuda, case, mode):
    C = _join_cases()
    sql, wanted = C.CASES[case]
    events = _same_on_card_and_cpu(cuda, C.tables(), sql, mode)
    assert not C.CS.missing_branches(events, wanted), (wanted, events)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_join_cases().EDGE_CASES))
def test_join_edge_case_on_card_matches_cpu(cuda, case):
    C = _join_cases()
    _same_on_card_and_cpu(cuda, C.tables(), C.EDGE_CASES[case], "on")


@pytest.mark.gpu
@pytest.mark.parametrize("q", sorted(_join_cases().CS.JOIN_QUERIES))
def test_chip_join_query_on_card_matches_cpu(cuda, q):
    C = _join_cases()
    star = C.CS.make_star(0, 1e-4)
    tables = {n: C.arrow_table(c) for n, c in star.items()}
    _same_on_card_and_cpu(cuda, tables, C.CS.JOIN_QUERIES[q], "on",
                          ordered=q == "q78")


# ---------------------------------------------------------------------------
# Windows, ROLLUP / grouping sets, grouping() and blocked union aggregation
# on the card (tests/torch_window_cases.py), and chip_smoke's windows-phase
# queries cut to size, through Session(device="cuda") against the same port
# session on the CPU. Tolerance as in torch_window_cases.
# ---------------------------------------------------------------------------


def _window_cases():
    _join_cases()  # puts tests/ on the path
    import torch_window_cases

    return torch_window_cases


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("case", sorted(_window_cases().WINDOW_CASES))
def test_window_on_card_matches_cpu(cuda, case, mode):
    W = _window_cases()
    sql, kinds = W.WINDOW_CASES[case]
    events = _same_on_card_and_cpu(cuda, W.window_tables(), sql, mode)
    assert not W.missing_kinds(events, kinds), (kinds, events)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("case", sorted(_window_cases().ROLLUP_CASES))
def test_grouping_sets_on_card_match_cpu(cuda, case, mode):
    W = _window_cases()
    sql, wanted = W.ROLLUP_CASES[case]
    events = _same_on_card_and_cpu(cuda, W.window_tables(), sql, mode,
                                   ordered="order by" in sql)
    assert not W.CS.missing_branches(events, wanted), (wanted, events)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("case", sorted(_window_cases().BLOCKED_CASES))
def test_blocked_union_on_card_matches_cpu(cuda, case, mode):
    W = _window_cases()
    sql, wanted = W.BLOCKED_CASES[case]
    events = _same_on_card_and_cpu(
        cuda, W.channel_tables(), sql, mode, ordered="order by" in sql,
        conf={"engine.union_agg_window_rows": W.SMALL_WINDOW})
    assert not W.CS.missing_branches(events, wanted), (wanted, events)


@pytest.mark.gpu
@pytest.mark.parametrize("q", sorted(_window_cases().CS.WINDOW_QUERIES))
def test_chip_window_query_on_card_matches_cpu(cuda, q):
    """q36's margins divide a net-profit sum whose terms have both signs:
    its f32 sums are held to chip_smoke's cancellation bound (check_q36)
    against the CPU session, the other queries to EPS."""
    from nds_tpu_torch.engine import exec as TX

    W = _window_cases()
    C = _join_cases()
    star = C.CS.make_star(0, W.CHIP_SCALE)
    tables = {n: C.arrow_table(c) for n, c in star.items()}
    sql = W.chip_window_sql(q, star)
    if q != "q36":
        events = _same_on_card_and_cpu(cuda, tables, sql, "on",
                                       conf=W.CHIP_CONF)
        assert not W.CS.missing_branches(events, W.CS.WINDOW_BRANCHES[q])
        return
    out, events = [], []
    for dev in (cuda, "cpu"):
        ev = []
        restore = C.CS.branch_spy(TX.Executor, ev)
        try:
            out.append(_port_sessions(dev, tables, "on").sql(sql).collect())
        finally:
            restore()
        events.append(ev)
    assert events[0] == events[1]
    assert not W.CS.missing_branches(events[0], W.CS.WINDOW_BRANCHES[q])
    states = tuple(sorted({C.CS.STATES[i] for i in star["store"]["s_state"]}))
    ref = C.CS.q36_reference(star, states=states)

    def rtol_of(r):
        _, n, a, p, _ = ref[(r["lochierarchy"], r["i_category"],
                             r["i_class"])]
        return C.CS.f32_cancel_rtol(n, a, p) + C.CS.f32_sum_rtol(n)

    C.CS.same_ranked(
        out[0], out[1], ["lochierarchy", "i_category", "i_class"],
        "gross_margin", "rank_within_parent",
        lambda r: (r["lochierarchy"],
                   r["i_category"] if r["lochierarchy"] == 0 else None),
        rtol_of, "q36 card vs cpu")


# ---------------------------------------------------------------------------
# Out-of-core execution on the card (tests/torch_spill_cases.py): the host
# spill pool's round trip of CUDA tables through RAM and disk, and each
# spilled path through Session(device="cuda") against the same port session
# on the CPU. Tolerance as in torch_join_cases.
# ---------------------------------------------------------------------------


def _spill_cases():
    _join_cases()  # puts tests/ on the path
    import torch_spill_cases

    return torch_spill_cases


@pytest.fixture(autouse=True)
def _strict_budget(monkeypatch):
    monkeypatch.setenv("NDS_PLAN_BUDGET_STRICT", "1")


@pytest.mark.gpu
def test_reject_verdict_refuses_on_card(cuda):
    """A CUDA session refuses a `reject` verdict as the reference does
    (PlanBudgetError under the default engine.plan_budget=on) and records
    it; `warn` runs the statement, unannotated. The card's default lines
    lie below its memory."""
    from nds_tpu_torch.analysis import budget as B

    C = _join_cases()
    sql = "select f_grp, sum(f_qty) s from fact group by f_grp"
    lines = {"engine.plan_budget_bytes": 1,
             "engine.plan_budget_reject_bytes": 1}
    s = _port_sessions(cuda, C.tables(), "on", lines)
    with pytest.raises(B.PlanBudgetError):
        s.sql(sql)
    assert s.last_plan_budget["verdict"] == "reject"
    w = _port_sessions(cuda, C.tables(), "on",
                       {**lines, "engine.plan_budget": "warn"})
    got = w.sql(sql).collect()
    assert w.last_plan_budget["verdict"] == "reject"
    assert not w.last_plan_budget["annotated"]
    C.assert_same(got, _port_sessions("cpu", C.tables(), "on")
                  .sql(sql).collect(), sql)
    card = B.budget_lines(cuda)
    m = torch.cuda.get_device_properties(cuda).total_memory
    assert 0 < card.working_set < card.reject < m
    assert card.catalog < m


@pytest.mark.gpu
@pytest.mark.parametrize("budget", [1 << 30, 1])
def test_spill_pool_round_trip_of_cuda_tables(cuda, tmp_path, budget):
    """CUDA tables through the pool's RAM tier (a 1 GiB budget) and its disk
    tier (a 1-byte budget evicts all but the newest segment): the assembled
    table lies on the card and holds the live rows, validity and
    dictionaries exactly."""
    import pyarrow as pa

    from nds_tpu_torch.dtypes import FLOAT64, INT64, parse_dtype
    from nds_tpu_torch.engine import spill as SP
    from nds_tpu_torch.engine.columnar import Column, Table, column_from_arrow

    rng = np.random.default_rng(7)
    pool = SP.SpillPool(budget_bytes=budget, spill_dir=str(tmp_path))
    segs, want = [], []
    for n in (3000, 1, 4096):
        ints = rng.integers(-2**40, 2**40, 4096)
        vals = rng.random(4096)
        valid = rng.random(4096) < 0.8
        words = pa.array(rng.choice(["a", "bb", None], 4096).tolist())
        strings = column_from_arrow(words.dictionary_encode(),
                                    parse_dtype("string"), 4096, cuda)
        t = Table({
            "i": Column(torch.from_numpy(ints).to(cuda), INT64,
                        torch.from_numpy(valid).to(cuda)),
            "f": Column(torch.from_numpy(vals).to(cuda), FLOAT64),
            "s": strings,
        }, n)
        segs.append(pool.put(t))
        want.append((ints[:n], valid[:n], vals[:n],
                     words.to_pylist()[:n]))
    if budget == 1:
        assert pool.stats["evictions"] == 2
        assert pool.stats["disk_bytes_written"] > 0
    out = SP.assemble_segments(pool, segs, cuda)
    total = sum(len(w[0]) for w in want)
    assert out.nrows == total
    cols = out.columns
    assert all(c.data.device.type == cuda.type for c in cols.values())
    i = cols["i"].data[:total].cpu().numpy()
    v = cols["i"].valid[:total].cpu().numpy()
    np.testing.assert_array_equal(i, np.concatenate([w[0] for w in want]))
    np.testing.assert_array_equal(v, np.concatenate([w[1] for w in want]))
    np.testing.assert_array_equal(cols["f"].data[:total].cpu().numpy(),
                                  np.concatenate([w[2] for w in want]))
    s = cols["s"]
    got = [None if not ok else s.dictionary[int(c)].as_py() for c, ok in
           zip(s.data[:total].tolist(), s.valid[:total].tolist())]
    assert got == [x for w in want for x in w[3]]
    pool.release(segs)
    pool.close()
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".npz")]


@pytest.mark.gpu
@pytest.mark.parametrize("parts", [3, 8])
@pytest.mark.parametrize("case", sorted(_spill_cases().CASES))
def test_spilled_path_on_card_matches_cpu(cuda, tmp_path, case, parts):
    S = _spill_cases()
    sql, op = S.CASES[case]
    events = _same_on_card_and_cpu(
        cuda, S.tables(), sql, "on", ordered="order by" in sql,
        conf={"engine.spill": "force", "engine.spill_partitions": parts,
              "engine.spill_dir": str(tmp_path)})
    if op is not None:
        assert f"spilled {op}, {parts} partitions" in events, events


# ---------------------------------------------------------------------------
# The Power Run's failure domain on the card: a real CUDA OOM is a device
# OOM and walks the device ladder, recover_memory returns the catalog's
# bytes to the allocator, and a stream over a parquet warehouse runs on the
# card as on the CPU (results as in torch_join_cases).
# ---------------------------------------------------------------------------


def _wide_tables(n):
    import pyarrow as pa

    rng = np.random.default_rng(3)
    return {"big": pa.table({"k": rng.integers(0, 1 << 20, n),
                             "v": rng.random(n)})}


def _free_bytes(cuda):
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(cuda)
    return (free + torch.cuda.memory_reserved(cuda)
            - torch.cuda.memory_allocated(cuda))


@pytest.mark.gpu
def test_real_cuda_oom_is_a_device_oom(cuda):
    from nds_tpu_torch import faults, report

    total = torch.cuda.get_device_properties(cuda).total_memory

    def alloc():
        torch.empty(2 * total, dtype=torch.uint8, device=cuda)

    with pytest.raises(torch.OutOfMemoryError) as err:
        alloc()
    assert faults.classify(err.value) == faults.DEVICE_OOM
    text = report.BenchReport(None)._attempt(alloc, (), 0)
    assert text.startswith("OutOfMemoryError: CUDA out of memory")
    assert faults.classify(text) == faults.DEVICE_OOM


@pytest.mark.gpu
def test_bench_report_walks_the_device_ladder_under_a_ballast(cuda):
    """A query whose columns cannot load beside a ballast dies of a real
    CUDA OOM on every attempt: the ladder walks only device_oom rungs, in
    the reference's order for its budget record, and the query runs (and
    matches the CPU) once the ballast goes."""
    from nds_tpu_torch import faults, report

    C = _join_cases()
    tables = _wide_tables(1 << 24)  # 256 MiB of columns on the card
    sql = "select k, v from big where k < 4096 order by v"
    s = _port_sessions(cuda, tables, "on")
    ballast = torch.empty(_free_bytes(cuda) - (64 << 20), dtype=torch.uint8,
                          device=cuda)
    try:
        summary = report.BenchReport(s).report_on(
            lambda: s.sql(sql).collect(), retry_oom=True)
    finally:
        del ballast
        torch.cuda.empty_cache()
    rungs = [r["rung"] for r in summary["ladder"]]
    assert summary["queryStatus"] == ["Failed"]
    assert summary["failureKind"] == faults.DEVICE_OOM
    assert {r["kind"] for r in summary["ladder"]} == {faults.DEVICE_OOM}
    assert rungs == C.CS.expected_device_ladder(s.last_plan_budget, {})
    assert rungs[-1] == "spill_retry"
    assert all(faults.classify(e) == faults.DEVICE_OOM
               for e in summary["exceptions"])
    assert summary["exceptions"][0].startswith("OutOfMemoryError")
    C.assert_same(s.sql(sql).collect(),
                  _port_sessions("cpu", tables, "on").sql(sql).collect(),
                  sql, ordered=True)


@pytest.mark.gpu
def test_recover_memory_returns_the_catalog_bytes(cuda):
    s = _port_sessions(cuda, _wide_tables(1 << 22), "on")
    _free_bytes(cuda)  # earlier tests' garbage goes first
    before = torch.cuda.memory_allocated(cuda)
    s.catalog.load("big", ["k", "v"])
    resident = s.catalog.resident_bytes()
    assert resident == (1 << 22) * 16
    assert torch.cuda.memory_allocated(cuda) - before == resident
    reserved = torch.cuda.memory_reserved(cuda)
    s.recover_memory("device memory exhausted")
    assert s.catalog.resident_bytes() == 0
    assert torch.cuda.memory_allocated(cuda) <= before
    assert torch.cuda.memory_reserved(cuda) <= reserved - resident


@pytest.mark.gpu
def test_watchdog_worker_runs_the_kernels_on_card(cuda):
    """With engine.query_timeout set the attempt runs on a worker thread:
    its kernels launch there and its result equals the CPU's."""
    from nds_tpu_torch import report

    C = _join_cases()
    sql, _ = C.CASES[sorted(C.CASES)[0]]
    s = _port_sessions(cuda, C.tables(), "on", {"engine.query_timeout": 60})
    box = {}
    GK.reset_launches()
    summary = report.BenchReport(s).report_on(
        lambda: box.setdefault("res", s.sql(sql).collect()), retry_oom=True)
    assert summary["queryStatus"] == ["Completed"]
    C.assert_same(box["res"], _port_sessions("cpu", C.tables(), "on")
                  .sql(sql).collect(), sql)


@pytest.mark.gpu
def test_power_stream_on_card_matches_cpu(cuda, tmp_path):
    """chip_smoke's power stream (its slice and joins queries) over a
    parquet warehouse of the star at a cut scale, through
    power.run_query_stream on the card and on the CPU: the same time-log
    rows, statuses and results, and the kernels launched on the card."""
    import pyarrow.parquet as pq

    from nds_tpu_torch import power as TP

    C = _join_cases()
    CS = C.CS
    star = CS.make_star(0, 1e-4)
    wh = str(tmp_path / "warehouse")
    CS.write_warehouse(star, wh)
    entries = [(tag, qs) for tag, qs in CS.POWER_STREAM
               if all(q in CS.QUERIES or q in CS.JOIN_QUERIES for q in qs)]
    stream = CS.stream_file(str(tmp_path / "query_0.sql"), [
        (tag, [CS.phase_sql(q) for q in qs]) for tag, qs in entries])
    on = {f"engine.pallas_{k}": "on" for k in ("agg", "join", "sort")}
    runs = []
    for dev in (cuda, torch.device("cpu")):
        out = tmp_path / f"run{len(runs)}"
        GK.reset_launches()
        TP.run_query_stream(
            wh, CS.property_file(str(tmp_path / "p.properties"), on),
            TP.gen_sql_from_stream(stream), str(out / "time.csv"),
            use_decimal=False, output_path=str(out / "results"),
            json_summary_folder=str(out / "json"), device=dev)
        runs.append((CS.read_summaries(str(out / "json")),
                     [r for r, _ in CS.read_time_log(str(out / "time.csv"))],
                     dict(GK.LAUNCHES)))
    (s_gpu, log_gpu, launches), (s_cpu, log_cpu, _) = runs
    assert log_gpu == log_cpu
    assert all(n > 0 for n in launches.values()), launches
    for name in CS.stream_names(entries):
        assert s_gpu[name]["queryStatus"] == ["Completed"], s_gpu[name]
        assert s_cpu[name]["queryStatus"] == ["Completed"], s_cpu[name]
        a, b = (pq.read_table(tmp_path / d / "results" / name
                              / "part-0.parquet") for d in ("run0", "run1"))
        C.assert_same(a, b, name)


@pytest.mark.gpu
@pytest.mark.parametrize("floats", [False, True])
def test_generated_stream_on_card_validates_against_cpu(cuda, tmp_path,
                                                        floats):
    """The port's whole chain at SF0.1: gen_data, transcode (decimals, or
    --floats), gen_query_stream from the Load Test's RNGSEED, the Power Run
    of all 103 statements on the card (kernels on) and on the CPU, and the
    port's validate of the card's outputs against the CPU's: every
    statement completes in both, and no query is unmatched."""
    import re

    from nds_tpu_torch import power as TP
    from nds_tpu_torch import validate as TV
    from nds_tpu_torch.cli import gen_data, gen_query_stream
    from nds_tpu_torch.cli import power as power_cli
    from nds_tpu_torch.cli import transcode

    flag = ["--floats"] if floats else []
    gen_data.main(["--scale", "0.1", "--parallel", str(max(2, os.cpu_count())),
                   "--data_dir", str(tmp_path / "raw")])
    transcode.main([str(tmp_path / "raw"), str(tmp_path / "wh"),
                    str(tmp_path / "load.report")] + flag)
    seed = re.search(r"^RNGSEED used: (\d{11})$",
                     (tmp_path / "load.report").read_text(), re.M).group(1)
    gen_query_stream.main(["--scale", "0.1", "--rngseed", seed,
                           "--output_dir", str(tmp_path / "streams")])
    stream = str(tmp_path / "streams" / "query_0.sql")
    names = list(TP.gen_sql_from_stream(stream))
    assert len(names) == 103
    prop = tmp_path / "p.properties"
    prop.write_text("".join(f"engine.pallas_{k}=on\n"
                            for k in ("agg", "join", "sort"))
                    + "engine.query_timeout=300\n")
    for run, dev in (("card", []), ("cpu", ["--device", "cpu"])):
        GK.reset_launches()
        power_cli.main([str(tmp_path / "wh"), stream,
                        str(tmp_path / run / "time.csv"), "--property_file",
                        str(prop), "--output_prefix", str(tmp_path / run / "out"),
                        "--json_summary_folder", str(tmp_path / run / "json")]
                       + flag + dev)
        if run == "card":
            launches = dict(GK.LAUNCHES)
        for f in os.listdir(tmp_path / run / "json"):
            s = json.load(open(tmp_path / run / "json" / f))
            assert s["queryStatus"][0] in (
                "Completed", "CompletedWithTaskFailures"), (run, s["query"],
                                                             s["exceptions"])
    assert launches["dense_build"] > 0 and launches["sort_perm"] > 0, launches
    if floats:
        assert launches["segment_sums"] > 0, launches
    assert TV.iterate_queries(str(tmp_path / "card" / "out"),
                              str(tmp_path / "cpu" / "out"), names,
                              is_float=floats) == []


@pytest.mark.gpu
def test_insert_and_delete_on_card_match_cpu(cuda, tmp_path):
    """A small INSERT ... SELECT with a join and a decimal product, a
    DELETE through the Arrow path and one through the engine path (an IN
    subquery: a mark join on the card) over a lakehouse table: the rows
    affected and the table left on the card equal those on the CPU."""
    from decimal import Decimal

    import pyarrow as pa

    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.lakehouse.table import LakehouseTable

    rng = np.random.default_rng(7)
    n = 5000
    fact = pa.table({
        "k": pa.array(rng.integers(1, 200, n), type=pa.int64()),
        "d": pa.array(rng.integers(0, 90, n), type=pa.int32()),
        "amt": pa.array([Decimal(int(c)) / 100 for c in
                         rng.integers(-50_000, 50_000, n)],
                        type=pa.decimal128(7, 2)),
    })
    dim = pa.table({"k": pa.array(np.arange(1, 200), type=pa.int64()),
                    "rate": pa.array([Decimal(int(r)) / 100 for r in
                                      rng.integers(0, 20, 199)],
                                     type=pa.decimal128(5, 2))})
    stmts = ["insert into f (select f.k, f.d + 100, f.amt * (1 + rate) "
             "from f join dim on f.k = dim.k where f.d < 30)",
             "delete from f where d between 10 and 19",
             "delete from f where k in (select k from dim where rate > 0.1)"]
    out = {}
    for dev in ("cuda", "cpu"):
        path = str(tmp_path / dev / "f")
        LakehouseTable.create(path, fact)
        s = Session(conf={f"engine.pallas_{k}": "on"
                          for k in ("agg", "join", "sort")},
                    device=cuda if dev == "cuda" else "cpu")
        s.register_arrow("dim", dim)
        s.register_lakehouse("f", path)
        affected = [s.sql(q).rows_affected for q in stmts]
        left = LakehouseTable(path).dataset().to_table()
        out[dev] = (affected, left.sort_by([(c, "ascending")
                                            for c in left.column_names]))
    assert out["cuda"][0] == out["cpu"][0]
    assert all(a > 0 for a in out["cuda"][0]), out["cuda"][0]
    assert out["cuda"][1].equals(out["cpu"][1])


@pytest.mark.gpu
def test_bench_cli_on_card(cuda, tmp_path):
    """The whole benchmark through `python -m nds_tpu_torch.cli.bench` with
    the device phases on the card, at SF0.01 with 3 streams: gen_data with
    two refresh sets, the Load Test to a lakehouse, gen_query_stream, the
    Power Test and both Throughput Tests over a 3-template subset, and both
    Maintenance Tests (LF_SS, DF_SS). Every statement is Completed on the
    card, and the composite metric is positive."""
    import subprocess
    import sys

    subset = ["query3", "query7", "query96"]
    j = tmp_path.joinpath
    params = {
        "data_gen": {"scale_factor": 0.01, "parallel": 2,
                     "raw_data_path": str(j("raw"))},
        "load_test": {"output_path": str(j("wh")),
                      "warehouse_format": "lakehouse",
                      "report_path": str(j("load.txt"))},
        "generate_query_stream": {"num_streams": 3,
                                  "stream_output_path": str(j("streams"))},
        "power_test": {"report_path": str(j("power.csv")),
                       "sub_queries": ",".join(subset),
                       "json_summary_folder": str(j("json_power"))},
        "throughput_test": {"report_base_path": str(j("tt")),
                            "sub_queries": ",".join(subset),
                            "json_summary_folder": str(j("json_tt"))},
        "maintenance_test": {"maintenance_report_base_path": str(j("dm")),
                             "maintenance_queries": "LF_SS,DF_SS",
                             "json_summary_folder": str(j("json_dm"))},
        "metrics_report_path": str(j("metrics.csv")),
    }
    yml = j("bench.yml")
    yml.write_text(json.dumps(params))  # JSON is YAML
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "nds_tpu_torch.cli.bench",
                        str(yml)], cwd=repo, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    metrics = dict(line.split(",", 1)
                   for line in j("metrics.csv").read_text().splitlines())
    assert int(metrics["perf_metric"]) > 0, metrics
    folders = {j("json_power"): subset, j("json_tt", "stream_1"): subset,
               j("json_tt", "stream_2"): subset,
               j("json_dm_1"): ["LF_SS", "DF_SS"],
               j("json_dm_2"): ["LF_SS", "DF_SS"]}
    for folder, names in folders.items():
        summaries = [json.load(open(folder / f)) for f in os.listdir(folder)]
        assert sorted(s["query"] for s in summaries) == sorted(names)
        for s in summaries:
            assert s["queryStatus"] == ["Completed"], (folder, s["query"])
            assert s["env"]["engineConf"]["torch.device"].startswith("cuda")


# ---------------------------------------------------------------------------
# Fused pipelines, top-k and the persistent cache (engine/fuse.py,
# engine/aotcache.py) on the card against the same port session on the CPU
# ---------------------------------------------------------------------------

FUSE_SQL = {
    "order": None, "minmax": None, "q3": None,
    "topk": ("select ss_item_sk, ss_quantity from store_sales where "
             "ss_quantity > 50 order by ss_quantity desc, ss_item_sk "
             "limit 10"),
}


def _fuse_sql(q):
    return FUSE_SQL[q] or _join_cases().CS.QUERIES[q]


@pytest.mark.gpu
@pytest.mark.parametrize("q", sorted(FUSE_SQL))
def test_fused_paths_on_card_match_cpu(cuda, q, tmp_path):
    """With the kernel routes off (so aggregates fuse): the same fused
    paths (chains, aggregate tails, top-k), pins and answers on both
    devices."""
    from nds_tpu_torch.engine import exec as TX
    from nds_tpu_torch.engine import fuse as TF
    from nds_tpu_torch.engine import plan as TP

    C = _join_cases()
    star = C.CS.make_star(0, 1e-4)
    tables = {n: C.arrow_table(c) for n, c in star.items()}
    out, kinds, pins = [], [], []
    for dev in (cuda, "cpu"):
        s = _port_sessions(dev, tables, "off", {
            "engine.aot_cache_dir": str(tmp_path / str(dev))})
        events, restore = C.CS.fuse_spy(TF, TX, TP)
        try:
            out.append(s.sql(_fuse_sql(q)).collect())
        finally:
            restore()
        kinds.append(sorted(e["kind"] for e in events))
        pins.append(s.exec_cache.pins)
    assert kinds[0] == kinds[1] and pins[0] == pins[1]
    assert any(k in ("chain", "agg", "topk") for k in kinds[0])
    C.assert_same(out[0], out[1], q, ordered=q in ("order", "topk"))


@pytest.mark.gpu
def test_persistent_cache_round_trip_on_card(cuda, tmp_path):
    """A second CUDA session loads every entry the first built (no
    builds) and answers the same (floats within the epsilon: the card's
    float sums add in no fixed order)."""
    C = _join_cases()
    star = C.CS.make_star(0, 1e-4)
    tables = {n: C.arrow_table(c) for n, c in star.items()}
    conf = {"engine.aot_cache_dir": str(tmp_path / "aot")}
    res = []
    for _ in range(2):
        s = _port_sessions(cuda, tables, "off", conf)
        res.append([s.sql(_fuse_sql(q)).collect() for q in sorted(FUSE_SQL)])
        res[-1].append((s.exec_cache.builds, s.exec_cache.loads))
    (b0, l0), (b1, l1) = res[0][-1], res[1][-1]
    assert b0 > 0 and l0 == 0 and b1 == 0 and l1 == b0
    for q, a, b in zip(sorted(FUSE_SQL), res[0][:-1], res[1][:-1]):
        C.assert_same(a, b, q, ordered=q in ("order", "topk"))


# ---------------------------------------------------------------------------
# the observability layer on the card (nds_tpu_torch/obs/)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_kernel_span_measures_a_cuda_call_to_completion(cuda):
    """A traced kernel entry point whose output is a CUDA tensor waits for
    it: queued behind ~50 ms of device sleep, its span covers the sleep,
    while the untraced call returns before the device is done."""
    from nds_tpu_torch.obs import trace as OT
    from nds_tpu_torch.ops import kernels as K

    mask = torch.rand(1 << 20, device=cuda) < 0.5
    K.compact_indices(mask, 1 << 20)  # warm-up
    torch.cuda.synchronize(cuda)
    cycles = 100_000_000  # device sleep; its length is measured below
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    torch.cuda._sleep(cycles)
    t1.record()
    torch.cuda.synchronize(cuda)
    sleep_ms = t0.elapsed_time(t1)
    assert sleep_ms > 5.0
    tr = OT.Tracer(kernel_spans=True)
    with OT.bind(tr):
        torch.cuda._sleep(cycles)
        K.compact_indices(mask, 1 << 20)
        done = torch.cuda.current_stream(cuda).query()
    (span,) = [e for e in tr.events if e["kind"] == "kernel_span"]
    assert done  # nothing left queued when the traced call returned
    assert span["kernel"] == "compact_indices" and span["n"] == 1 << 20
    assert span["dur_ms"] >= 0.8 * sleep_ms
    torch.cuda._sleep(cycles)
    K.compact_indices(mask, 1 << 20)  # untraced: no wait
    assert not torch.cuda.current_stream(cuda).query()
    torch.cuda.synchronize(cuda)


@pytest.mark.gpu
def test_device_bytes_per_device_reads_the_allocator(cuda):
    from nds_tpu_torch.obs import memwatch as MW

    before = MW.device_bytes_per_device()
    x = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)
    per = MW.device_bytes_per_device()
    assert len(per) == torch.cuda.device_count()
    assert per[cuda.index or 0] == torch.cuda.memory_stats(cuda)[
        "allocated_bytes.all.current"]
    assert per[cuda.index or 0] - (before or [0])[cuda.index or 0] >= 256 << 20
    with MW.MemorySampler(interval_s=0.005) as ms:
        torch.cuda.synchronize(cuda)
    assert ms.source == "device" and ms.peak_bytes >= 256 << 20
    del x


def _memwatch_child(q):
    import torch as t

    from nds_tpu_torch.obs import memwatch as MW

    per = MW.device_bytes_per_device()
    with MW.MemorySampler(interval_s=0.005, heartbeat_s=0.0):
        pass
    q.put((per, t.cuda.is_initialized()))


@pytest.mark.gpu
def test_memwatch_leaves_a_spawn_child_off_the_card(cuda):
    """A spawn worker that has not touched the card (a Load Test worker, a
    process-mode throughput child before its session) gets no CUDA context
    from the memory sampler."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_memwatch_child, args=(q,))
    p.start()
    per, initialised = q.get(timeout=120)
    p.join(timeout=60)
    assert p.exitcode == 0
    assert per is None and initialised is False


@pytest.mark.gpu
def test_debug_jaxprof_writes_a_torch_profiler_trace(cuda, tmp_path):
    """/debug/jaxprof keeps the reference's route and payload; behind it
    torch.profiler writes a Chrome trace with the card's kernels."""
    import urllib.request

    from nds_tpu_torch.obs import metrics as M
    from nds_tpu_torch.obs.httpserv import MetricsServer

    def post(port, obj):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/debug/jaxprof",
            data=json.dumps(obj).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    server = MetricsServer(M.MetricsSink(), port=0, host="127.0.0.1").start()
    try:
        d = str(tmp_path / "prof")
        assert post(server.port, {"action": "start", "dir": d}) == {
            "running": True, "dir": d}
        x = torch.randn(1 << 22, device=cuda)
        (x * 2).sum().item()
        assert post(server.port, {"action": "stop"}) == {
            "running": False, "dir": d}
    finally:
        server.stop()
    trace = json.load(open(os.path.join(d, "trace.json")))
    cats = {e.get("cat") for e in trace["traceEvents"]}
    assert "kernel" in cats, sorted(c for c in cats if c)
