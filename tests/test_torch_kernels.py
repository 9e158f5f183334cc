"""nds_tpu_torch/ops/gpu_kernels.py against nds_tpu/ops/pallas_kernels.py.

Each kernel's plain PyTorch version (what a wrapper runs for a CPU tensor)
is held against the JAX Pallas function run with interpret=True, on the
same numpy inputs made from a seed. Tolerances: counts, dense tables,
ranks, histograms and permutations EXACT; float sums and extremes exact
too, because the measures are integers small enough that f32 accumulation
in any order is exact (the cases of tests/test_pallas.py). The kernels
themselves run only on the card: tests/test_torch_gpu.py holds each one
against its plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nds_tpu.ops import kernels as JK
from nds_tpu.ops import pallas_kernels as PK
from nds_tpu_torch.ops import gpu_kernels as GK

torch.set_num_threads(1)

SEG_CASES = [(1000, 10), (4096, 300), (2048, 700), (100, 1)]


def _seg_inputs(n, g, seed, lo=0, hi=1000):
    rng = np.random.default_rng(seed)
    vals = rng.integers(lo, hi, n).astype(np.float32)  # exact in f32
    gid = rng.integers(-1, g, n).astype(np.int32)  # -1 = dead
    return vals, gid


@pytest.mark.parametrize("n,g", SEG_CASES)
def test_segment_sums_plain_matches_pallas(n, g):
    vals, gid = _seg_inputs(n, g, n + g)
    js, jc = PK.segment_sums_pallas(jnp.asarray(vals), jnp.asarray(gid), g,
                                    interpret=True)
    ts, tc = GK.segment_sums(torch.from_numpy(vals), torch.from_numpy(gid), g)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int32))


def test_segment_sums_accumulate_in_f64():
    """The port's sums add the f32 values in f64 and round each sum once to
    f32; the Pallas kernel adds in f32. Past f32's 2^24 integer range the
    f32 adds drop the units, and 10^5 rows of 0.1 drift from the exact sum
    of the f32 values by more than the validator's 1e-5; the port's sums
    are the exact ones rounded once."""
    vals = np.array([2.0**24, 1.0, 1.0, 0.5], np.float32)
    gid = np.zeros(4, np.int32)
    js, _ = PK.segment_sums_pallas(jnp.asarray(vals), jnp.asarray(gid), 1,
                                   interpret=True)
    ts, tc = GK.segment_sums(torch.from_numpy(vals), torch.from_numpy(gid), 1)
    assert ts.dtype == torch.float32 and tc.dtype == torch.int32
    assert ts.item() == np.float32(2.0**24 + 2.5) == 2.0**24 + 2
    assert float(np.asarray(js)[0]) == 2.0**24  # f32 adds lost the units
    tenth = np.full(100_000, 0.1, np.float32)
    exact = float(np.float32(0.1)) * 100_000
    got, _ = GK.segment_sums(torch.from_numpy(tenth),
                             torch.zeros(100_000, dtype=torch.int32), 1)
    assert got.item() == np.float32(exact)
    f32 = torch.zeros(1).index_add_(0, torch.zeros(100_000, dtype=torch.long),
                                    torch.from_numpy(tenth)).item()
    assert abs(f32 - exact) > 1e-5 * exact


@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("n,g", SEG_CASES)
def test_segment_extreme_plain_matches_pallas(n, g, is_max):
    vals, gid = _seg_inputs(n, g, n + g + is_max, -500, 500)
    je, jc = PK.segment_extreme_pallas(jnp.asarray(vals), jnp.asarray(gid),
                                       g, is_max, interpret=True)
    te, tc = GK.segment_extreme(torch.from_numpy(vals),
                                torch.from_numpy(gid), g, is_max)
    # empty groups hold the same +-inf identity in both
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int32))


@pytest.mark.parametrize("is_max", [False, True])
def test_segment_extreme_nan_in_live_lane_propagates(is_max):
    vals, gid = _seg_inputs(512, 8, 3, -50, 50)
    gid[:4] = [2, 2, 5, -1]
    vals[1] = np.nan  # live lane of group 2
    vals[3] = np.nan  # dead lane: must not poison anything
    je, _ = PK.segment_extreme_pallas(jnp.asarray(vals), jnp.asarray(gid), 8,
                                      is_max, interpret=True)
    te, _ = GK.segment_extreme(torch.from_numpy(vals), torch.from_numpy(gid),
                               8, is_max)
    je = np.asarray(je)
    assert np.isnan(je[2]) and np.isnan(te[2].item())
    np.testing.assert_array_equal(te.numpy(), je)


def test_segment_kernels_empty_and_all_dead():
    for n in (0, 256):
        vals = np.ones(n, np.float32)
        gid = np.full(n, -1, np.int32)
        js, jc = PK.segment_sums_pallas(jnp.asarray(vals), jnp.asarray(gid),
                                        8, interpret=True)
        ts, tc = GK.segment_sums(torch.from_numpy(vals),
                                 torch.from_numpy(gid), 8)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        je, _ = PK.segment_extreme_pallas(jnp.asarray(vals), jnp.asarray(gid),
                                          4, False, interpret=True)
        te, tc = GK.segment_extreme(torch.from_numpy(vals),
                                    torch.from_numpy(gid), 4, False)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        assert int(tc.sum()) == 0


@pytest.mark.parametrize(
    "n,table_cap,dups",
    [(500, 128, False), (4096, 1024, False), (100, 2048, False),
     (0, 256, False), (3000, 512, True)],
)
def test_dense_build_plain_matches_pallas_and_xla(n, table_cap, dups):
    rng = np.random.default_rng(n + table_cap)
    rmin = 10
    if dups:  # duplicate keys: the largest row index wins everywhere
        keys = rng.integers(rmin - 20, rmin + table_cap + 20, n)
    else:
        keys = rng.permutation(6 * max(table_cap, 64))[:n] + rmin - 8
    keys = keys.astype(np.int64)
    live = rng.random(n) > 0.2
    jp, jr = PK.dense_build_pallas(jnp.asarray(keys), jnp.asarray(live), rmin,
                                   table_cap, interpret=True)
    xp, xr = JK.dense_build(jnp.asarray(keys), jnp.asarray(live), rmin,
                            table_cap)
    tp, tr = GK.dense_build(torch.from_numpy(keys), torch.from_numpy(live),
                            rmin, table_cap)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(xp))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(xr))


@pytest.mark.parametrize(
    "n,dom", [(1, 4), (700, 1), (1000, 129), (4096, 2000)]
)
def test_sort_perm_plain_matches_pallas_and_canonical(n, dom):
    rng = np.random.default_rng(n + dom)
    w = rng.integers(0, dom, n).astype(np.int64)
    jperm = PK.sort_perm_pallas(jnp.asarray(w), dom, interpret=True)
    canon = JK.sort_by_words([jnp.asarray(w)])
    tperm = GK.sort_perm(torch.from_numpy(w), dom)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(canon))


@pytest.mark.parametrize("n,dom", [(1000, 129), (2500, 384)])
def test_sort_rank_plain_matches_pallas(n, dom):
    rng = np.random.default_rng(7 + n)
    v = rng.integers(0, dom, n).astype(np.int32)
    v[::17] = -1  # padded lanes: counted nowhere, rank unspecified
    jr, jh = PK.sort_rank_pallas(jnp.asarray(v), dom, interpret=True)
    tr, th = GK.sort_rank(torch.from_numpy(v), dom)
    live = v >= 0
    np.testing.assert_array_equal(tr.numpy()[live],
                                  np.asarray(jr).astype(np.int32)[live])
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh).astype(np.int32))


def test_wrapper_rejects_a_device_with_no_kernel():
    """A tensor that is neither on the CPU (plain version) nor on CUDA
    (kernel) must raise — never run some other path."""
    vals = torch.zeros(8, dtype=torch.float32, device="meta")
    gid = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        GK.segment_sums(vals, gid, 4)
    with pytest.raises(ValueError, match="no kernel"):
        GK.segment_extreme(vals, gid, 4, True)
    with pytest.raises(ValueError, match="no kernel"):
        GK.dense_build(torch.zeros(8, dtype=torch.int64, device="meta"),
                       torch.zeros(8, dtype=torch.bool, device="meta"), 0, 16)
    with pytest.raises(ValueError, match="no kernel"):
        GK.sort_perm(torch.zeros(8, dtype=torch.int64, device="meta"), 128)


def test_plain_path_launches_no_kernel():
    GK.reset_launches()
    GK.segment_sums(torch.ones(4), torch.zeros(4, dtype=torch.int32), 2)
    GK.sort_perm(torch.zeros(4, dtype=torch.int64), 128)
    assert all(v == 0 for v in GK.LAUNCHES.values())


# ---------------------------------------------------------------------------
# The shapes on which the redesigned segment_extreme and dense_build kernels
# branch (csrc/segment_extreme.cu, csrc/dense_build.cu): the plain versions
# the wrappers run on the CPU, held against the TPU kernels there. The
# kernels themselves meet the same cases on the card (test_torch_gpu.py).
# ---------------------------------------------------------------------------

_TWO_PER_SM = (GK.SMEM_PER_SM - 2 * 1024) // 2
#: largest n_groups whose table lets two blocks share an SM, and largest
#: whose table fits one block (past it: the global-atomic path)
G_TWO = _TWO_PER_SM // 12
G_ONE = GK.SMEM_PER_BLOCK // 12


def _extreme_vs_pallas(vals, gid, g, is_max):
    je, jc = PK.segment_extreme_pallas(jnp.asarray(vals), jnp.asarray(gid),
                                       g, is_max, interpret=True)
    te, tc = GK.segment_extreme(torch.from_numpy(vals),
                                torch.from_numpy(gid), g, is_max)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int32))
    return te


@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("n", [1, 3, 5, 4097])
def test_segment_extreme_plain_matches_pallas_vector_tail(n, is_max):
    """n not a multiple of 4: the kernel's 16-byte chunks leave a tail."""
    vals, gid = _seg_inputs(n, 10, 40 + n, -500, 500)
    _extreme_vs_pallas(vals, gid, 10, is_max)


@pytest.mark.parametrize(
    "g,is_max",
    [(G_TWO, True), (G_TWO + 1, False), (G_ONE, False), (G_ONE + 1, True)],
)
def test_segment_extreme_plain_matches_pallas_at_table_limits(g, is_max):
    """n_groups on both sides of each shared-memory limit of the plan."""
    vals, gid = _seg_inputs(4097, g, g, -500, 500)
    gid[:2] = [g - 1, 0]  # the last and first slot both live
    _extreme_vs_pallas(vals, gid, g, is_max)


@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("case", ["one_group", "one_of_many", "sorted"])
def test_segment_extreme_plain_matches_pallas_uniform_runs(case, is_max):
    """Runs of one id: the kernel's single-group warp reduction."""
    vals, gid = _seg_inputs(4097, 300, 9, -500, 500)
    g = 300
    if case == "one_group":
        g, gid = 1, np.zeros_like(gid)
    elif case == "one_of_many":
        gid = np.full_like(gid, 7)
        gid[-3:] = -1  # a dead tail after the run
    else:
        gid = np.sort(gid)
    _extreme_vs_pallas(vals, gid, g, is_max)


@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("ids", ["random", "one_group"])
def test_segment_extreme_nan_dead_lanes_ignored_live_propagates(ids, is_max):
    g = 8
    vals, gid = _seg_inputs(1030, g, 11, -50, 50)
    if ids == "one_group":
        gid = np.where(gid >= 0, 5, gid).astype(np.int32)
    vals[0] = np.nan
    gid[0] = -1  # dead: padding lane
    vals[1] = np.nan
    gid[1] = g  # dead: id past the last group
    te = _extreme_vs_pallas(vals, gid, g, is_max)
    assert not np.isnan(te.numpy()).any()
    vals[1029] = np.nan  # the last row, live
    gid[1029] = 5
    te = _extreme_vs_pallas(vals, gid, g, is_max)
    assert np.isnan(te[5].item())
    assert np.isnan(te.numpy()).sum() == 1


def _dense_vs_tpu(keys, live, rmin, cap, pallas=True):
    tp, tr = GK.dense_build(torch.from_numpy(keys), torch.from_numpy(live),
                            rmin, cap)
    xp, xr = JK.dense_build(jnp.asarray(keys), jnp.asarray(live), rmin, cap)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(xp))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(xr))
    if pallas:
        jp, jr = PK.dense_build_pallas(jnp.asarray(keys), jnp.asarray(live),
                                       rmin, cap, interpret=True)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    return tp, tr


@pytest.mark.parametrize("n", [1, 3, 5, 4097])
def test_dense_build_plain_matches_tpu_negative_rmin_dups_out_of_range(n):
    rng = np.random.default_rng(70 + n)
    rmin, cap = -100, 1024
    keys = rng.integers(rmin - 60, rmin + cap + 60, n).astype(np.int64)
    live = rng.random(n) > 0.25
    if n >= 3:
        keys[:3] = [rmin, rmin, rmin + cap - 1]  # a duplicate and the last slot
        live[:3] = True
    tp, tr = _dense_vs_tpu(keys, live, rmin, cap)
    if n >= 3:
        assert tp[0] and tp[cap - 1]
        assert int(tr[0]) >= 1  # the larger duplicate row wins


@pytest.mark.parametrize("cap", [1 << 18, 1 << 21, 1 << 23])
@pytest.mark.parametrize("side", [0, 1])
def test_dense_build_plain_matches_xla_across_owner_threshold(cap, side):
    n = GK.dense_owner_max_rows(cap) + side
    assert GK.dense_build_plan(n, cap).path == (
        "owner" if side == 0 else "cooperative")
    rng = np.random.default_rng(cap + side)
    rmin = -3
    keys = rng.integers(rmin - 10, rmin + cap + 10, n).astype(np.int64)
    live = rng.random(n) > 0.1
    _dense_vs_tpu(keys, live, rmin, cap, pallas=False)


@pytest.mark.parametrize("n_sm", [1, 132])
@pytest.mark.parametrize("n", [0, 1, 4097, 1 << 29])
@pytest.mark.parametrize(
    "g", [1, 2, 1024, G_TWO, G_TWO + 1, G_ONE, G_ONE + 1, 65536, 1 << 20])
def test_segment_extreme_plan_fits_hopper(g, n, n_sm):
    plan = GK.segment_extreme_plan(n, g, n_sm)
    assert 1 <= plan.blocks <= 2 * n_sm
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.smem == 12 * g * plan.tables <= GK.SMEM_PER_BLOCK
    assert 0 <= plan.tables <= plan.threads // 32
    # every n_groups has a path: shared tables while one fits a block
    assert (plan.tables > 0) == (12 * g <= GK.SMEM_PER_BLOCK)
    if plan.smem > _TWO_PER_SM:  # one block per SM: the grid says so
        assert plan.blocks <= n_sm


@pytest.mark.parametrize("cap", [1, 16, 1000, 1 << 18, 1 << 21, 1 << 26])
@pytest.mark.parametrize("n", [0, 1, 4096, 8193, 1 << 21])
def test_dense_build_plan_fits_hopper(n, cap):
    plan = GK.dense_build_plan(n, cap)
    if plan.path == "owner":
        assert plan.slots % 16 == 0 and plan.slots > 0
        assert plan.grid >= 1 and plan.grid * plan.slots >= cap
        assert n <= GK.DENSE_OWNER_MAX_ROWS
        assert n * plan.grid <= GK.DENSE_OWNER_MAX_READS
        assert plan.slots * 4 <= 48 * 1024  # no shared-memory attribute
    else:
        assert plan.path == "cooperative" and n > 0


def test_dense_build_plan_q3_shape_takes_owner_path():
    """q3 at SF100 builds 4,096 item rows into 2^18 slots: the owner path;
    customer at SF100 (2^21 rows and slots) the cooperative one."""
    plan = GK.dense_build_plan(4096, 1 << 18)
    assert plan.path == "owner" and plan.grid == 64
    assert GK.dense_build_plan(1 << 21, 1 << 21).path == "cooperative"


# ---------------------------------------------------------------------------
# The shapes on which the redesigned sort_perm and segment_sums kernels
# branch (csrc/sort_perm.cu, csrc/segment_sums.cu): whole and ragged
# 4,096-row tiles, domains 1..2048, one key, sorted
# and reverse-sorted words, -1 lanes, int32 and int64 words; segment_sums'
# sorted ids with dead lanes and n_groups on both sides of its shared-memory
# limits. The plain versions the wrappers run on the CPU, held against the
# TPU kernels there; the kernels meet the same cases on the card
# (test_torch_gpu.py).
# ---------------------------------------------------------------------------

SORT_EDGE_NS = [1, 3, GK.SORT_TILE - 1, GK.SORT_TILE, GK.SORT_TILE + 1]


def _sort_vs_pallas(w, dom):
    jperm = PK.sort_perm_pallas(jnp.asarray(w), dom, interpret=True)
    tperm = GK.sort_perm(torch.from_numpy(w), dom)
    assert tperm.dtype == torch.int32
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    return tperm


@pytest.mark.parametrize("dom", [1, 128, 129, 2048])
@pytest.mark.parametrize("n", SORT_EDGE_NS)
def test_sort_perm_plain_matches_pallas_at_tile_edges(n, dom):
    rng = np.random.default_rng(n * 7 + dom)
    _sort_vs_pallas(rng.integers(0, dom, n).astype(np.int64), dom)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", ["one_key", "sorted", "reverse", "runs"])
def test_sort_perm_plain_matches_pallas_patterns(case, dtype):
    rng = np.random.default_rng(11)
    n, dom = GK.SORT_TILE + 1, 2048
    w = rng.integers(0, dom, n)
    if case == "one_key":
        w[:] = dom - 1
    elif case == "sorted":
        w.sort()
    elif case == "reverse":
        w = np.sort(w)[::-1].copy()
    else:  # runs of five keys, as the ORDER BY over a filtered fact
        w = rng.integers(96, 101, n)
    tperm = _sort_vs_pallas(w.astype(dtype), dom)
    canon = JK.sort_by_words([jnp.asarray(w.astype(np.int64))])
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(canon))


@pytest.mark.parametrize("dom", [1, 129, 2048])
@pytest.mark.parametrize("n", [3, GK.SORT_TILE + 1])
def test_sort_rank_plain_matches_pallas_padding_lanes(n, dom):
    rng = np.random.default_rng(n + 3 * dom)
    v = rng.integers(0, dom, n).astype(np.int32)
    v[::17] = -1  # padding lanes: counted nowhere, rank unspecified
    jr, jh = PK.sort_rank_pallas(jnp.asarray(v), dom, interpret=True)
    tr, th = GK.sort_rank(torch.from_numpy(v), dom)
    live = v >= 0
    np.testing.assert_array_equal(tr.numpy()[live],
                                  np.asarray(jr).astype(np.int32)[live])
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh).astype(np.int32))


_SUMS_TWO, _SUMS_ONE = GK._sums_table_limits()


def _sums_vs_pallas(vals, gid, g):
    js, jc = PK.segment_sums_pallas(jnp.asarray(vals), jnp.asarray(gid), g,
                                    interpret=True)
    ts, tc = GK.segment_sums(torch.from_numpy(vals), torch.from_numpy(gid), g)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int32))


@pytest.mark.parametrize("n", [1, 3, 5, 4097])
def test_segment_sums_plain_matches_pallas_sorted_dead_lanes(n):
    """Sorted ids with dead lanes in between (the sort-based aggregation's
    input): the kernel's segmented warp reduction."""
    vals, gid = _seg_inputs(n, 300, 50 + n)
    gid = np.sort(gid)
    gid[np.random.default_rng(n).random(n) < 0.3] = -1
    _sums_vs_pallas(vals, gid, 300)


@pytest.mark.parametrize("g", [_SUMS_TWO, _SUMS_TWO + 1, _SUMS_ONE,
                               _SUMS_ONE + 1])
def test_segment_sums_plain_matches_pallas_at_table_limits(g):
    """n_groups on both sides of each shared-memory limit of the plan."""
    vals, gid = _seg_inputs(4097, g, g)
    gid[:2] = [g - 1, 0]  # the last and first slot both live
    _sums_vs_pallas(vals, gid, g)


@pytest.mark.parametrize("n_sm", [1, 132])
@pytest.mark.parametrize(
    "n", [0, 1, 100, 4095, 4096, 4097, 65536, 14_398_885, (1 << 24) - 1,
          1 << 24])
def test_sort_perm_plan_fits_hopper(n, n_sm):
    """Every domain in 1..2048 has a plan at every n: a grid of whole
    tiles that covers n, at most two CTAs per SM and none without rows,
    each with pass 2's shared memory inside one block's."""
    for dom in range(1, GK.SORT_MAX_DOMAIN + 1):
        plan = GK.sort_perm_plan(n, dom, n_sm)
        assert plan.smem == GK.sort_rank_smem(dom) <= GK.SMEM_PER_BLOCK
        assert 2 * (plan.smem + 1024 + 64) <= GK.SMEM_PER_SM
        assert plan.rows_per_block % GK.SORT_TILE == 0
        assert plan.blocks >= 1 and plan.blocks * plan.rows_per_block >= n
        assert plan.blocks <= 2 * n_sm
        assert plan.blocks == 1 or (plan.blocks - 1) * plan.rows_per_block < n
    GK.sort_perm_plan.cache_clear()


def test_sort_perm_plan_rejects_domains_past_the_cap():
    for dom in (0, GK.SORT_MAX_DOMAIN + 1):
        with pytest.raises(ValueError, match="domain"):
            GK.sort_perm_plan(100, dom, 132)


def test_sort_perm_plan_order_shape_takes_grid_path():
    """The ORDER BY query hands the sort 2^24 int64 keys over domain 384:
    a grid of two CTAs per SM on 132 SMs, 16 tiles each; a grouped result
    of a few hundred rows one CTA of one tile."""
    plan = GK.sort_perm_plan(1 << 24, 384, 132)
    assert plan.blocks == 256 and plan.rows_per_block == 16 * GK.SORT_TILE
    small = GK.sort_perm_plan(300, 384, 132)
    assert small.blocks == 1 and small.rows_per_block == GK.SORT_TILE


@pytest.mark.parametrize("n_sm", [1, 132])
@pytest.mark.parametrize("n", [0, 1, 4097, 262_144, 1 << 26])
@pytest.mark.parametrize(
    "g", [1, 2, 1024, 4096, _SUMS_TWO, _SUMS_TWO + 1, _SUMS_ONE,
          _SUMS_ONE + 1, 65536, 1 << 20])
def test_segment_sums_plan_fits_hopper(g, n, n_sm):
    plan = GK.segment_sums_plan(n, g, n_sm)
    assert plan.threads == GK.SUMS_THREADS
    assert plan.smem == GK._SUMS_GROUP_BYTES * g * plan.tables
    assert GK._SUMS_GROUP_BYTES == 12  # an f64 sum and an int32 count
    assert plan.smem + 16 <= GK.SMEM_PER_BLOCK
    assert plan.tables in (0, 1)
    # every n_groups has a path: shared tables while one fits a block
    assert (plan.tables > 0) == (g <= _SUMS_ONE)
    # the grid is co-resident (the kernel grid.sync()s): two blocks per SM
    # only where two blocks' shared memory fits one SM
    per_sm = 2 if 2 * (plan.smem + 16 + 1024) <= GK.SMEM_PER_SM else 1
    assert 1 <= plan.blocks <= per_sm * n_sm
    assert plan.blocks <= max(1, -(-n // (GK.SUMS_THREADS *
                                         GK.SUMS_ROWS_PER_THREAD)))


def test_segment_sums_plan_q3_shape_takes_shared_path():
    """q3 at SF100 aggregates 2^18 rows into 4,096 groups: one shared table
    per block (no more table entries to zero than rows), 64 blocks; 2^26
    ids over 65,536 groups take the global path."""
    plan = GK.segment_sums_plan(262_144, 4096, 132)
    assert plan.tables == 1 and plan.blocks == 64
    assert GK.segment_sums_plan(1 << 26, 65536, 132).tables == 0
    assert GK.segment_sums_plan(1 << 26, 1024, 132).tables == 1
