"""nds_tpu_torch/ops/kernels.py against nds_tpu/ops/kernels.py.

Every ported relational primitive gets the same numpy inputs (from a seed)
as its JAX counterpart, including dead rows, nulls and empty input.
Tolerance: EXACT everywhere — these are integer/bool computations, sorts,
or float reductions over integer-valued data.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nds_tpu.ops import kernels as JK
from nds_tpu_torch.ops import kernels as TK

torch.set_num_threads(1)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("n,p,out_cap", [(2048, 0.3, 1024), (1024, 0.0, 1024),
                                         (1024, 1.0, 2048), (0, 0.5, 1024)])
def test_compact_indices_and_mask_count(n, p, out_cap):
    mask = np.random.default_rng(n).random(n) < p
    jm, tm = _both(mask)
    _eq(TK.compact_indices(tm, out_cap), JK.compact_indices(jm, out_cap))
    assert TK.mask_count(tm) == JK.mask_count(jm)


def test_sort_by_words_word_span_and_kv_sort():
    rng = np.random.default_rng(1)
    w1 = rng.integers(0, 5, 3000)
    w2 = rng.integers(-50, 50, 3000)
    (j1, t1), (j2, t2) = _both(w1), _both(w2)
    _eq(TK.sort_by_words([t1, t2]), JK.sort_by_words([j1, j2]))
    _eq(TK.kv_sort_perm(t2), JK.kv_sort_perm(j2))
    _eq(TK.word_span(t2), JK.word_span(j2))
    _eq(TK.sort_by_words([t1[:0]]), JK.sort_by_words([j1[:0]]))


def test_float_key_words_specials():
    # no subnormals: XLA on the CPU flushes them to zero, torch keeps them
    x = np.array([0.0, -0.0, 1.5, -2.25, np.nan, np.inf, -np.inf, 1e-300,
                  3.0e300, 7.0])
    jx, tx = _both(x)
    for t, j in zip(TK.float_key_words(tx), JK.float_key_words(jx)):
        _eq(t, j)


def _sort_key_inputs(n=2000, seed=3):
    rng = np.random.default_rng(seed)
    live = rng.random(n) > 0.1
    a = rng.integers(0, 40, n).astype(np.int32)
    av = rng.random(n) > 0.2
    f = rng.random(n) * 10
    f[rng.random(n) < 0.1] = np.nan
    f[::97] = -0.0
    fv = rng.random(n) > 0.1
    big = rng.integers(-2**40, 2**40, n)
    return live, a, av, f, fv, big


@pytest.mark.parametrize("asc,nf", [(True, True), (False, False),
                                    (True, False), (False, True)])
def test_key_words_sort_indices_group_rows(asc, nf):
    live, a, av, f, fv, big = _sort_key_inputs()
    (jl, tl), (ja, ta), (jav, tav) = _both(live), _both(a), _both(av)
    (jf, tf), (jfv, tfv), (jb, tb) = _both(f), _both(fv), _both(big)
    jkeys = [(ja, jav, asc, nf), (jf, jfv, not asc, nf), (jb, None, asc, None)]
    tkeys = [(ta, tav, asc, nf), (tf, tfv, not asc, nf), (tb, None, asc, None)]
    for t, j in zip(TK.key_words(tkeys, tl), JK.key_words(jkeys, jl)):
        _eq(t, j)
    _eq(TK.sort_indices(tkeys, tl), JK.sort_indices(jkeys, jl))
    to, tg, tn = TK.group_rows([ta, tb], [tav, None], tl)
    jo, jg, jn = JK.group_rows([ja, jb], [jav, None], jl)
    assert tn == jn
    _eq(to, jo)
    _eq(tg, jg)
    for t, j in zip(TK.fold_sort_key(tf, tfv, asc, nf),
                    JK.fold_sort_key(jf, jfv, asc, nf)):
        _eq(t, j)


def test_build_sort_words_spec_fields():
    live, a, av, f, fv, big = _sort_key_inputs(1500, 5)
    (jl, tl), (ja, ta), (jav, tav) = _both(live), _both(a), _both(av)
    (jf, tf), (jfv, tfv), (jb, tb) = _both(f), _both(fv), _both(big)
    spec = (("L",), ("i", 6, True, True, True), ("i", 8, False, False, False),
            ("I", False, True, False), ("f", True, False, True))
    jw = JK.build_sort_words(spec, jl, ja, jnp.int64(0), jnp.int64(39), jav,
                             ja, jnp.int64(0), jnp.int64(39), jb, jf, jfv)
    tw = TK.build_sort_words(spec, tl, ta, 0, 39, tav, ta, 0, 39, tb, tf, tfv)
    assert len(tw) == len(jw)
    for t, j in zip(tw, jw):
        _eq(t, j)
    assert [TK.quantize_width(w) for w in range(1, 70)] == [
        JK.quantize_width(w) for w in range(1, 70)
    ]
    ow, gw, nw = TK.group_by_words(list(tw), tl)
    oj, gj, nj = JK.group_by_words(list(jw), jl)
    assert nw == nj
    _eq(ow, oj)
    _eq(gw, gj)


@pytest.mark.parametrize("op", ["sum", "min", "max", "count", "sumsq"])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_segment_reduce(op, dtype):
    rng = np.random.default_rng(11)
    n, g = 3000, 64
    vals = rng.integers(-100, 100, n).astype(dtype)
    gid = rng.integers(0, g + 8, n)  # ids past num_segments are dropped
    weight = rng.random(n) > 0.3
    (jv, tv), (jg, tg), (jw, tw) = _both(vals), _both(gid), _both(weight)
    _eq(TK.segment_reduce(tv, tg, tw, g, op),
        JK.segment_reduce(jv, jg, jw, g, op))
    if op != "count":
        for t, j in zip(TK.segment_reduce_with_count(tv, tg, tw, g, op),
                        JK.segment_reduce_with_count(jv, jg, jw, g, op)):
            _eq(t, j)


@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_reduce_nan_propagates(op):
    vals = np.array([1.0, np.nan, 3.0, 4.0, np.nan])
    gid = np.array([0, 0, 1, 1, 2])
    weight = np.array([True, True, True, True, False])
    (jv, tv), (jg, tg), (jw, tw) = _both(vals), _both(gid), _both(weight)
    _eq(TK.segment_reduce(tv, tg, tw, 4, op),
        JK.segment_reduce(jv, jg, jw, 4, op))


def test_batched_min_max_and_all_valid():
    rng = np.random.default_rng(2)
    d1 = rng.integers(-1000, 1000, 500)
    v1 = rng.random(500) > 0.5
    live = rng.random(500) > 0.5
    empty = np.zeros(500, bool)
    (j1, t1), (jv, tv), (jl, tl), (je, te) = (
        _both(d1), _both(v1), _both(live), _both(empty))
    _eq(TK.batched_min_max([t1, t1], [tv, te], tl),
        JK.batched_min_max([j1, j1], [jv, je], jl))
    _eq(TK._all_valid([tv, None, te], tl), JK._all_valid([jv, None, je], jl))


def test_dense_build_and_probe():
    rng = np.random.default_rng(4)
    rkey = rng.permutation(3000)[:1500].astype(np.int64) + 100
    rlive = rng.random(1500) > 0.1
    lkey = rng.integers(0, 3300, 5000).astype(np.int64)
    llive = rng.random(5000) > 0.2
    (jr, tr), (jrl, trl), (jk, tk), (jll, tll) = (
        _both(rkey), _both(rlive), _both(lkey), _both(llive))
    jp, jrows = JK.dense_build(jr, jrl, 100, 4096)
    tp, trows = TK.dense_build(tr, trl, 100, 4096)
    _eq(tp, jp)
    _eq(trows, jrows)
    jm, jri = JK.dense_probe(jk, jll, 100, jp, jrows, 4096)
    tm, tri = TK.dense_probe(tk, tll, 100, tp, trows, 4096)
    _eq(tm, jm)
    _eq(tri, jri)


def test_direct_gid_occupancy_and_segment_starts():
    rng = np.random.default_rng(6)
    n = 4000
    k1 = rng.integers(5, 15, n)
    k2 = rng.integers(0, 7, n)
    v2 = rng.random(n) > 0.2
    live = rng.random(n) > 0.1
    (j1, t1), (j2, t2), (jv, tv), (jl, tl) = (
        _both(k1), _both(k2), _both(v2), _both(live))
    jg = JK.direct_gid([j1, j2], [None, jv], [5, 0], [10, 8], jl)
    tg = TK.direct_gid([t1, t2], [None, tv], [5, 0], [10, 8], tl)
    _eq(tg, jg)
    jo, jd = JK.occupancy_map(jg, jl, 128)
    to, td = TK.occupancy_map(tg, tl, 128)
    _eq(to, jo)
    _eq(td, jd)
    sg = np.sort(rng.integers(0, 40, 600))
    js, ts = _both(sg)
    # empty segments: jax's segment_min identity is the dtype max
    ref = np.asarray(JK.segment_starts(js, 48)).astype(np.int64)
    got = TK.segment_starts(ts, 48).numpy()
    present = np.isin(np.arange(48), sg)
    np.testing.assert_array_equal(got[present], ref[present])
    assert (got[~present] == np.iinfo(np.int64).max).all()


def test_hash_columns_bits_match_uint64():
    rng = np.random.default_rng(8)
    a = rng.integers(-2**62, 2**62, 1000)
    b = rng.integers(0, 50, 1000).astype(np.int32)
    bv = rng.random(1000) > 0.3
    (ja, ta), (jb, tb), (jbv, tbv) = _both(a), _both(b), _both(bv)
    _eq(TK.hash_columns([ta, tb], [None, tbv]),
        JK.hash_columns([ja, jb], [None, jbv]))


def test_join_candidates_and_verify_pairs():
    rng = np.random.default_rng(9)
    lk = rng.integers(0, 300, 2000)
    lv = rng.random(2000) > 0.05
    ll = rng.random(2000) > 0.1
    rk = rng.integers(0, 300, 700)
    rl = rng.random(700) > 0.1
    (jlk, tlk), (jlv, tlv), (jll, tll), (jrk, trk), (jrl, trl) = (
        _both(lk), _both(lv), _both(ll), _both(rk), _both(rl))

    def pairs(mod, lk_, lv_, ll_, rk_, rl_):
        li, ri, pl, total = mod.join_candidates([lk_], [lv_], ll_, [rk_],
                                                [None], rl_)
        ok = mod.verify_pairs(li, ri, pl, [lk_], [lv_], ll_, [rk_], [None],
                              rl_)
        li, ri, ok = (np.asarray(x) for x in (li, ri, ok))
        return total, sorted(zip(li[ok].tolist(), ri[ok].tolist()))

    jt, jp = pairs(JK, jlk, jlv, jll, jrk, jrl)
    tt, tp = pairs(TK, tlk, tlv, tll, trk, trl)
    assert tt == jt and tp == jp and len(tp) > 0
    packed_t = TK.pack_key_words([[(tlk, tlv)], [(trk, None)]], [(0, 299)])
    packed_j = JK.pack_key_words([[(jlk, jlv)], [(jrk, None)]], [(0, 299)])
    for t, j in zip(packed_t, packed_j):
        _eq(t, j)


@pytest.mark.parametrize("case", ["duplicated_right", "dead_probes",
                                  "all_dead_right", "one_right_word"])
def test_member_lookup(case):
    """Packed-word membership: found flags exactly, and the matched right
    row exactly (the first duplicate in sorted order: both sorts are
    stable). Duplicated right words, dead left probes, a right side whose
    rows are all dead (the executor's empty side) and a single word."""
    rng = np.random.default_rng(11)
    n_l, n_r = 3000, 800
    rw = rng.integers(0, 400, n_r)  # ~2 rows per word: duplicates
    rnn = rng.random(n_r) > 0.1
    lw = rng.integers(0, 600, n_l)
    lnn = rng.random(n_l) > (0.5 if case == "dead_probes" else 0.05)
    if case == "all_dead_right":
        rnn[:] = False
    if case == "one_right_word":
        rw, rnn = rw[:1], np.ones(1, dtype=bool)
    (jl, tl), (jln, tln), (jr, tr), (jrn, trn) = (
        _both(lw), _both(lnn), _both(rw), _both(rnn))
    tf, tri = TK.member_lookup(tl, tln, tr, trn)
    jf, jri = JK.member_lookup(jl, jln, jr, jrn)
    _eq(tf, jf)
    _eq(tri, jri)
    if case != "all_dead_right":
        assert bool(tf.any())
    assert not bool(tf[~tln].any())


def test_member_lookup_empty_right_side():
    """A right side of no rows at all: nothing matches. (The JAX function
    refuses the gather from an empty array; the executor never hands it
    one, every table having at least one bucket of 1,024 rows.)"""
    lw = torch.arange(10, dtype=torch.int64)
    found, ri = TK.member_lookup(lw, torch.ones(10, dtype=torch.bool),
                                 lw[:0], torch.ones(0, dtype=torch.bool))
    assert not bool(found.any()) and ri.shape == (10,)


@pytest.mark.parametrize("case", ["random", "padded_index0", "all_false",
                                  "out_of_range"])
def test_matched_mask(case):
    """The max-scatter: a row is matched when ANY of its candidates is ok,
    whatever the order of duplicates, including the compaction padding that
    repeats index 0 with ok False after a True."""
    rng = np.random.default_rng(12)
    cap = 1024
    li = rng.integers(0, cap, 5000).astype(np.int32)
    ok = rng.random(5000) > 0.7
    if case == "padded_index0":
        li[100:] = 0  # padding duplicates of index 0 ...
        ok[100:] = False
        li[50], ok[50] = 0, True  # ... after a real match of row 0
    elif case == "all_false":
        ok[:] = False
    elif case == "out_of_range":
        li[::7] = cap + 3  # dropped, as the jnp scatter drops them
    (jli, tli), (jok, tok) = _both(li), _both(ok)
    t = TK.matched_mask(tli, tok, cap)
    _eq(t, JK.matched_mask(jli, jok, cap))
    if case == "padded_index0":
        assert bool(t[0])


# ---------------------------------------------------------------------------
# window helpers (the window library functions of ROADMAP queue 2 item B)
# ---------------------------------------------------------------------------


def _sorted_gid(n, groups, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, groups, n)).astype(np.int32)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
@pytest.mark.parametrize("n", [0, 1, 1000, 4096])
def test_fast_cumsum_and_cummax(dtype, n):
    """Blocked (n a multiple of 512, n >= 1024) and flat JAX scans; the
    result keeps the input's width (torch.cumsum alone widens int32)."""
    rng = np.random.default_rng(n)
    x = (rng.integers(-100, 100, n) if dtype != np.float64
         else rng.integers(-100, 100, n) / 4.0).astype(dtype)
    jx, tx = _both(x)
    out = TK.fast_cumsum(tx)
    assert out.dtype == tx.dtype
    _eq(out, JK.fast_cumsum(jx))
    if n:
        _eq(TK.fast_cummax(tx), JK.fast_cummax(jx))


@pytest.mark.parametrize("case", ["random", "one_segment", "singletons",
                                  "one_row"])
def test_running_position(case):
    n = 1 if case == "one_row" else 5000
    gid = {"random": _sorted_gid(n, 300, 1),
           "one_segment": np.zeros(n, np.int32),
           "singletons": np.arange(n, dtype=np.int32),
           "one_row": np.zeros(1, np.int32)}[case]
    jg, tg = _both(gid)
    out = TK.running_position(tg)
    assert out.dtype == torch.int32
    _eq(out, JK.running_position(jg))


@pytest.mark.parametrize("kind", ["int32", "int64", "float", "float_specials"])
def test_value_rank(kind):
    """Stable ranks exactly, ties by position; floats as f64 with -0.0
    equal to 0.0 and NaN last."""
    rng = np.random.default_rng(5)
    n = 3000
    if kind == "int32":
        x = rng.integers(-40, 40, n).astype(np.int32)
    elif kind == "int64":
        x = rng.integers(-(1 << 40), 1 << 40, n)
    else:
        x = (rng.integers(-30, 30, n) / 8.0).astype(np.float64)
        if kind == "float_specials":
            x[::11] = -0.0
            x[::13] = 0.0
            x[::17] = np.nan
            x[::19] = np.inf
            x[::23] = -np.inf
    jx, tx = _both(x)
    tv, tr = TK.value_rank(tx)
    jv, jr = JK.value_rank(jx)
    assert tr.dtype == torch.int32
    _eq(tr, jr)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("case", ["random", "zero_weight_heads", "floats",
                                  "one_segment"])
def test_segmented_running_extreme(case, is_max):
    """Exact running min / max within segments, zero-weight rows never
    winning; rows whose segment prefix has no weight are excluded (they
    gather an arbitrary value, masked by the callers)."""
    rng = np.random.default_rng(7)
    n = 4000
    gid = (np.zeros(n, np.int32) if case == "one_segment"
           else _sorted_gid(n, 200, 8))
    vals = (rng.integers(-1000, 1000, n) / 10.0 if case == "floats"
            else rng.integers(-1000, 1000, n))
    weight = rng.random(n) > 0.2
    if case == "zero_weight_heads":
        weight[np.flatnonzero(np.r_[True, gid[1:] != gid[:-1]])] = False
    (jg, tg), (jv, tv), (jw, tw) = _both(gid), _both(vals), _both(weight)
    t_sorted, t_rank = TK.value_rank(tv)
    j_sorted, j_rank = JK.value_rank(jv)
    t = TK.segmented_running_extreme(t_sorted, t_rank, tg, tw, is_max)
    j = JK.segmented_running_extreme(j_sorted, j_rank, jg, jw, is_max)
    # the running weight count of each row's segment prefix
    seen = np.zeros(n, bool)
    for i in range(n):
        head = i == 0 or gid[i] != gid[i - 1]
        seen[i] = weight[i] or (not head and seen[i - 1])
    np.testing.assert_array_equal(t.numpy()[seen], np.asarray(j)[seen])
    # against numpy: the running extreme of the weighted rows
    want = np.empty(n)
    for i in range(n):
        head = i == 0 or gid[i] != gid[i - 1]
        cur = vals[i] if weight[i] else None
        prev = None if head else want[i - 1]
        if head or not seen[i - 1]:
            prev = None
        cands = [c for c in (cur, prev) if c is not None]
        want[i] = (max if is_max else min)(cands) if cands else np.nan
    np.testing.assert_array_equal(t.numpy()[seen].astype(float), want[seen])
