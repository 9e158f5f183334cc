"""Relational primitives over torch tensors: the subset of
nds_tpu/ops/kernels.py that the single-device main path reaches.

In the JAX package these are XLA ops (not Pallas kernels), so plain torch
ops serve for them on the card as well; the hand-written Hopper kernels live
in gpu_kernels.py. Every function keeps its JAX counterpart's name, argument
order and output contract, with two deliberate differences of idiom:

  * jnp scatters with mode="drop" drop out-of-range writes and jnp gathers
    clamp; torch raises (and on CUDA fires a device assert). Each scatter
    below therefore routes its out-of-range lanes to spare slots past the
    end of the output and slices them away, and each gather is clamped.
    The reducing scatters spread the lanes they drop (and the segment
    reductions their dead lanes, which add nothing) over SPARE_SLOTS
    slots: on the card, hundreds of millions of padding lanes whose
    atomics all hit one address serialise (seconds at 2^29 lanes).
  * Permutations and row indices are int64 (torch's index type); counts
    that cross to the host use `.item()` / `.tolist()` at exactly the
    places where the JAX code calls `int(...)` / `device_get`.
"""

from __future__ import annotations

import torch

I64 = torch.int64
I32 = torch.int32
_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min


#: spare slots past the end of a reducing scatter for the lanes it drops
SPARE_SLOTS = 1024


def _iota(n: int, device, dtype=I64) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=device)


def _spare(n: int, base: int, device) -> torch.Tensor:
    """Lane i's spare slot: base + i mod SPARE_SLOTS."""
    return base + (_iota(n, device) & (SPARE_SLOTS - 1))


# ---------------------------------------------------------------------------
# Hashing (hash-candidate join). torch lacks uint64 `+` and `>>`, so the
# splitmix64 finalizer runs in int64: wrapping add/multiply give the same
# bits as uint64, and each right shift masks off the sign extension.
# ---------------------------------------------------------------------------


def _s64(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    x = x + _s64(0x9E3779B97F4A7C15)
    x = (x ^ _lsr(x, 30)) * _s64(0xBF58476D1CE4E5B9)
    x = (x ^ _lsr(x, 27)) * _s64(0x94D049BB133111EB)
    return x ^ _lsr(x, 31)


def hash_columns(cols, valids) -> torch.Tensor:
    """Combine N key columns (+ their null flags) into one int64 hash, bit
    for bit the JAX package's uint64 hash."""
    h = None
    for data, valid in zip(cols, valids):
        k = _splitmix64(data.to(I64))
        if valid is not None:
            k = torch.where(valid, k, _s64(0xA5A5A5A5A5A5A5A5))
        if h is None:
            h = torch.full_like(k, _s64(0x243F6A8885A308D3))
        h = _splitmix64(h * 31 + k)
    return h


# ---------------------------------------------------------------------------
# Compaction (filter)
# ---------------------------------------------------------------------------


def _compact_full(mask: torch.Tensor) -> torch.Tensor:
    """Indices of True entries, packed to the front, 0-padded, full length
    (cumsum + scatter; dead lanes write the spare slot n)."""
    n = mask.shape[0]
    pos = torch.where(mask, torch.cumsum(mask.to(I64), 0) - 1, n)
    out = torch.zeros(n + 1, dtype=I64, device=mask.device)
    out.scatter_(0, pos, _iota(n, mask.device))
    return out[:n]


def compact_indices(mask: torch.Tensor, out_cap: int) -> torch.Tensor:
    """Indices of True entries, padded with 0 to out_cap."""
    full = _compact_full(mask)
    n = mask.shape[0]
    if out_cap <= n:
        return full[:out_cap]
    return torch.cat([full, full.new_zeros(out_cap - n)])


def mask_count(mask: torch.Tensor) -> int:
    return int(mask.sum().item())


# ---------------------------------------------------------------------------
# Sorting
# ---------------------------------------------------------------------------


def kv_sort_perm(key: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort of one key (the canonical kv-sort)."""
    return torch.sort(key, stable=True).indices


def word_span(word: torch.Tensor) -> torch.Tensor:
    """(min, max) over ONE sort word, padding included — the span probe of
    the counting-sort route; the caller pays the single host sync."""
    w = word.to(I64)
    return torch.stack([w.min(), w.max()])


def sort_by_words(words) -> torch.Tensor:
    """Stable lexicographic argsort by a list of words (most significant
    first): LSD passes over the stable kv-sort."""
    perm = None
    for w in reversed(words):
        k = w if perm is None else w[perm]
        p = kv_sort_perm(k)
        perm = p if perm is None else perm[p]
    return perm


def float_key_words(x: torch.Tensor):
    """Exact injective float64 -> (exponent, mantissa) int64 word pair for
    join-key equality (-0.0 == 0.0, NaN == NaN, +-inf reserved codes)."""
    x = x.to(torch.float64)
    x = torch.where(x == 0.0, 0.0, x)  # -0.0 -> +0.0
    special = torch.isnan(x) | torch.isinf(x)
    m, e = torch.frexp(torch.where(special, 0.0, x))
    ew = e.to(I64)
    mw = (m * float(1 << 53)).to(I64)
    ew = torch.where(torch.isnan(x), 99999, ew)
    ew = torch.where(torch.isinf(x) & (x > 0), 99998, ew)
    ew = torch.where(torch.isinf(x) & (x < 0), -99999, ew)
    mw = torch.where(special, 0, mw)
    return ew, mw


def group_by_words(words, live_mask, nlive=None):
    """Sort, flag group boundaries and number them: (order, gid over the
    sorted rows, live group count). Words must place live rows first."""
    order = sort_by_words(words)
    sorted_words = [w[order] for w in words]
    flags = _word_flags(sorted_words)
    gid = torch.cumsum(flags.to(I64), 0) - 1
    if nlive is None:
        nlive = mask_count(live_mask)
    if nlive == 0:
        return order, gid, 0
    ngroups = int(gid[nlive - 1].item()) + 1
    return order, gid, ngroups


def _word_flags(sorted_words):
    """Group-boundary flags from adjacent word inequality."""
    n = sorted_words[0].shape[0]
    flag = torch.zeros(n, dtype=torch.bool, device=sorted_words[0].device)
    flag[0] = True
    for w in sorted_words:
        flag[1:] |= w[1:] != w[:-1]
    return flag


def fold_sort_key(data, valid, ascending: bool, nulls_first: bool):
    """Direction/null folding for ONE sort key ([null_rank, value] when the
    key is nullable, else [value])."""
    d = data
    if not d.is_floating_point():
        d = d.to(I64)
    if not ascending:
        d = -d
    if valid is None:
        return [d]
    null_rank = torch.where(
        valid, torch.zeros((), dtype=I32, device=d.device),
        torch.full((), -1 if nulls_first else 1, dtype=I32, device=d.device),
    )
    return [null_rank, torch.where(valid, d, torch.zeros((), dtype=d.dtype,
                                                        device=d.device))]


_WIDTH_LADDER = (2, 3, 4, 6, 8, 11, 16, 22, 32, 44, 62)


def quantize_width(w: int) -> int:
    for q in _WIDTH_LADDER:
        if w <= q:
            return q
    return 63  # force standalone


def build_sort_words(spec, live, *arrays):
    """Encode sort keys into words under a static spec (see the JAX
    package's build_sort_words for the field grammar):
      ("L",)                            live bit (dead rows last)
      ("i", width, asc, nf, has_valid)  bounded int, mixed-radix packed;
                                        consumes data, vmin, vmax [, valid]
      ("I", asc, nf, has_valid)         unbounded int, standalone word
      ("f", asc, nf, has_valid)         float: NaN-rank bit + f64 word
    vmin/vmax are host ints here (0-d device arrays in the JAX package)."""
    it = iter(arrays)
    words = []
    cur = {"w": None, "bits": 0}

    def flush():
        if cur["w"] is not None:
            words.append(cur["w"])
        cur["w"] = None
        cur["bits"] = 0

    def add(code, width):
        if cur["bits"] + width > 62:
            flush()
        code = code & ((1 << width) - 1)  # clamp dead-row garbage
        cur["w"] = code if cur["w"] is None else (cur["w"] << width) | code
        cur["bits"] += width

    for field in spec:
        kind = field[0]
        if kind == "L":
            add(torch.where(live, 0, 1).to(I64), 1)
            continue
        if kind == "i":
            _, width, asc, nf, hv = field
            d = next(it).to(I64)
            vmin = int(next(it))
            vmax = int(next(it))
            v = next(it) if hv else None
            code = (d - vmin + 1) if asc else (vmax - d + 1)
            if v is not None:
                code = torch.where(v, code, 0 if nf else (1 << width) - 1)
            add(code, width)
            continue
        _, asc, nf, hv = field
        d = next(it)
        v = next(it) if hv else None
        if v is not None:
            add(torch.where(v, 1 if nf else 0, 0 if nf else 1).to(I64), 1)
        if kind == "I":
            w = d.to(I64)
            if not asc:
                w = ~w
            if v is not None:
                w = torch.where(v, w, 0)
        else:  # float
            w = d.to(torch.float64)
            if v is not None:
                w = torch.where(v, w, 0.0)  # mask nulls BEFORE the NaN rank
            w = torch.where(w == 0.0, 0.0, w)  # -0.0 == 0.0
            nan = torch.isnan(w)
            add(torch.where(nan, 1 if asc else 0, 0 if asc else 1).to(I64), 1)
            w = torch.where(nan, 0.0, w)
            if not asc:
                w = -w
        flush()
        words.append(w)
    flush()
    return tuple(words)


def key_words(keys, live_mask):
    """Bounds-free word encoding for (data, valid, ascending, nulls_first)
    key tuples: a leading live word, then per key a null-rank word when
    nullable, a NaN-rank word for floats, and the direction-folded value."""
    words = [torch.where(live_mask, 0, 1).to(I64)]
    for data, valid, asc, nf in keys:
        if nf is None:
            nf = asc
        if valid is not None:
            words.append(torch.where(valid, 1 if nf else 0,
                                     0 if nf else 1).to(I64))
        if data.is_floating_point():
            w = data.to(torch.float64)
            if valid is not None:
                w = torch.where(valid, w, 0.0)
            w = torch.where(w == 0.0, 0.0, w)
            nan = torch.isnan(w)
            words.append(torch.where(nan, 1 if asc else 0,
                                     0 if asc else 1).to(I64))
            w = torch.where(nan, 0.0, w)
            if not asc:
                w = -w
        else:
            w = data.to(I64)
            if not asc:
                w = ~w
            if valid is not None:
                w = torch.where(valid, w, 0)
        words.append(w)
    return words


def sort_indices(keys, live_mask):
    """Stable multi-key sort; returns row order with live rows first."""
    return sort_by_words(key_words(keys, live_mask))


def group_rows(keys, valids, live_mask, nlive=None):
    """Sort rows so equal keys are adjacent and assign group ids."""
    tuples = [(d, v, True, True) for d, v in zip(keys, valids)]
    return group_by_words(key_words(tuples, live_mask), live_mask, nlive)


# ---------------------------------------------------------------------------
# Segment reductions
# ---------------------------------------------------------------------------


def _extreme(dtype, is_max):
    if dtype.is_floating_point:
        return float("inf") if is_max else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if is_max else info.min


def _seg_index(gid, num_segments, keep=None):
    """gid with out-of-range segments (jax's segment ops drop them) and,
    where `keep` is given, the lanes it rules out routed to the spare
    slots."""
    ok = (gid >= 0) & (gid < num_segments)
    if keep is not None:
        ok = ok & keep
    spare = _spare(gid.shape[0], num_segments, gid.device)
    return torch.where(ok, gid.to(I64), spare)


def segment_reduce(vals, gid, weight, num_segments, op):
    """Segment reduction with a live/validity weight mask.
    op: sum | min | max | count | sumsq. Lanes of weight False add nothing
    (the identity), so they go to the spare slots."""
    idx = _seg_index(gid, num_segments, weight)
    dev = gid.device
    size = num_segments + SPARE_SLOTS
    if op == "count":
        out = torch.zeros(size, dtype=I64, device=dev)
        return out.index_add_(0, idx, weight.to(I64))[:num_segments]
    if op == "sum":
        v = torch.where(weight, vals, torch.zeros((), dtype=vals.dtype,
                                                  device=dev))
        out = torch.zeros(size, dtype=vals.dtype, device=dev)
        return out.index_add_(0, idx, v)[:num_segments]
    if op == "sumsq":
        v = torch.where(weight, vals.to(torch.float64) ** 2, 0.0)
        out = torch.zeros(size, dtype=torch.float64, device=dev)
        return out.index_add_(0, idx, v)[:num_segments]
    if op in ("min", "max"):
        is_max = op == "max"
        ident = _extreme(vals.dtype, not is_max)  # max starts at the lowest
        v = torch.where(weight, vals, torch.full((), ident, dtype=vals.dtype,
                                                 device=dev))
        out = torch.full((size,), ident, dtype=vals.dtype, device=dev)
        out.scatter_reduce_(0, idx, v, "amax" if is_max else "amin")
        if vals.is_floating_point():
            # jax.ops.segment_max/min propagate NaN; torch's scatter
            # reductions need not — mark NaN groups explicitly
            nan = torch.zeros(size, dtype=I64, device=dev)
            nan.index_add_(0, idx, (torch.isnan(v)).to(I64))
            out = torch.where(nan > 0, float("nan"), out)
        return out[:num_segments]
    raise ValueError(op)


def segment_reduce_with_count(vals, gid, weight, num_segments, op):
    """(reduction, live count) per segment."""
    return (
        segment_reduce(vals, gid, weight, num_segments, op),
        segment_reduce(vals, gid, weight, num_segments, "count"),
    )


def batched_min_max(datas, valids, live):
    """Masked (min, max) of several int64 columns, stacked [k, 2]; an empty
    or all-null column yields (0, -1)."""
    outs = []
    for d, v in zip(datas, valids):
        m = live if v is None else (live & v)
        mn = torch.where(m, d, _I64_MAX).min()
        mx = torch.where(m, d, _I64_MIN).max()
        nonempty = m.any()
        outs.append(torch.stack([torch.where(nonempty, mn, 0),
                                 torch.where(nonempty, mx, -1)]))
    return torch.stack(outs)


def _all_valid(valids, live):
    m = live
    for v in valids:
        if v is not None:
            m = m & v
    return m


def pack_key_words(sides, bounds):
    """Pack N aligned integer key columns into one exact int64 word per
    side (layout per key: value - vmin + 1 in its bit field, 0 for NULL).
    Returns one word per side, or None past 62 bits."""
    shift = 0
    words = [None] * len(sides)
    for ki, (vmin, vmax) in enumerate(bounds):
        span = vmax - vmin + 2  # +1 for the NULL slot
        bits = max(1, (span - 1).bit_length())
        if shift + bits > 62:
            return None
        for si, side in enumerate(sides):
            data, valid = side[ki]
            v = data.to(I64) - vmin + 1
            if valid is not None:
                v = torch.where(valid, v, 0)
            part = v << shift
            words[si] = part if words[si] is None else words[si] + part
        shift += bits
    return words


# ---------------------------------------------------------------------------
# Hash-candidate equi-join (inner)
# ---------------------------------------------------------------------------


def _join_prepare(rhash, rlive):
    rh = torch.where(rlive, rhash, _I64_MAX)
    order = kv_sort_perm(rh)
    return rh[order], order


def _join_counts(rh_sorted, lhash, llive):
    lh = torch.where(llive, lhash, _I64_MIN)
    lo = torch.searchsorted(rh_sorted, lh, side="left")
    hi = torch.searchsorted(rh_sorted, lh, side="right")
    counts = torch.where(llive, hi - lo, 0)
    return lo, counts


def _join_expand(lo, counts, rorder, out_cap):
    """Expand (row, count) pairs into candidate (li, ri) index pairs: each
    contributing row's index lands at its output-range start and a prefix
    max fills the range."""
    dev = lo.device
    offs = torch.cumsum(counts, 0) - counts  # exclusive
    total = counts.sum()
    rows = _iota(lo.shape[0], dev)
    starts = torch.where(counts > 0, offs,
                         _spare(lo.shape[0], out_cap, dev))
    owner = torch.full((out_cap + SPARE_SLOTS,), -1, dtype=I64, device=dev)
    owner.scatter_reduce_(0, starts, rows, "amax")
    owner = owner[:out_cap]
    li = torch.cummax(owner, 0).values.clamp(0, lo.shape[0] - 1)
    p = _iota(out_cap, dev)
    j = p - offs[li]
    ri_pos = (lo[li] + j).clamp(0, rorder.shape[0] - 1)
    ri = rorder[ri_pos]
    pair_live = p < total
    return li, ri, pair_live


def _check_pair_count(total: int):
    if total > 1 << 30:
        raise ValueError(
            f"join candidate count {total} exceeds the expansion capacity "
            f"(2^30); refusing to expand"
        )


def join_candidates(lkeys, lvalids, llive, rkeys, rvalids, rlive):
    """Hash-match candidate pairs; caller MUST verify real key equality.
    Returns (li, ri, pair_live, total_candidates)."""
    from ..engine.columnar import bucket_cap

    lh = hash_columns(lkeys, lvalids)
    rh = hash_columns(rkeys, rvalids)
    lnn = _all_valid(lvalids, llive)
    rnn = _all_valid(rvalids, rlive)
    rh_sorted, rorder = _join_prepare(rh, rnn)
    lo, counts = _join_counts(rh_sorted, lh, lnn)
    total = int(counts.sum().item())
    _check_pair_count(total)
    out_cap = bucket_cap(max(total, 1))
    li, ri, pair_live = _join_expand(lo, counts, rorder, out_cap)
    return li, ri, pair_live, total


def verify_pairs(li, ri, pair_live, lkeys, lvalids, llive, rkeys, rvalids,
                 rlive):
    """AND real key equality into the candidate mask (collision shield)."""
    ok = pair_live & llive[li] & rlive[ri]
    for (ld, lv), (rd, rv) in zip(zip(lkeys, lvalids), zip(rkeys, rvalids)):
        eq = ld[li].to(I64) == rd[ri].to(I64)
        if lv is not None:
            eq = eq & lv[li]
        if rv is not None:
            eq = eq & rv[ri]
        ok = ok & eq
    return ok


def matched_mask(li, ok, cap):
    """Per-left-row flag: does the row have at least one verified match?
    A max-scatter: `li` may repeat a row (padding duplicates index 0), so a
    plain set could write a padded False over a True. Out-of-range lanes
    go to the spare slot (the jnp drop)."""
    idx = torch.where((li >= 0) & (li < cap), li, cap).to(I64)
    hits = torch.zeros(cap + 1, dtype=I32, device=li.device)
    hits.index_add_(0, idx, ok.to(I32))
    return hits[:cap] > 0


# ---------------------------------------------------------------------------
# Packed-word membership (exact-key join)
# ---------------------------------------------------------------------------


def member_lookup(lwords, lnn, rwords, rnn):
    """Exact-word membership probe: for each left row, is its packed key
    word present among the live right words, and at which right row (the
    first duplicate in sorted order)? The words must be collision-free
    (exact packing, not hashing), so presence needs no verification."""
    rw = torch.where(rnn, rwords, _I64_MAX)
    order = kv_sort_perm(rw)
    return _member_probe(rw[order], order, lwords, lnn)


def _member_probe(rw_sorted, order, lwords, lnn):
    n = rw_sorted.shape[0]
    if n == 0:
        # JAX clips into an empty array and gathers (clamped); torch refuses
        # the gather, and no probe can match an empty side
        return torch.zeros_like(lnn), torch.zeros(
            lwords.shape[0], dtype=I64, device=lwords.device)
    probe = torch.where(lnn, lwords, -1)
    lo = torch.searchsorted(rw_sorted, probe, side="left").clamp(0, n - 1)
    # packed words are non-negative, so the -1 dead-left probe never hits
    found = lnn & (rw_sorted[lo] == probe)
    return found, order[lo]


# ---------------------------------------------------------------------------
# Dense-domain join (star-join fast path)
# ---------------------------------------------------------------------------


def dense_build(rkey, rlive, rmin, table_cap):
    """Presence/row-index tables over the key domain [rmin, rmin+table_cap);
    out-of-range and dead rows go to the spare slot (the jnp drop)."""
    dev = rkey.device
    slot = torch.where(rlive, rkey.to(I64) - rmin, table_cap)
    slot = torch.where((slot >= 0) & (slot <= table_cap), slot, table_cap)
    presence = torch.zeros(table_cap + 1, dtype=torch.bool, device=dev)
    presence.index_put_((slot,), rlive)
    presence[table_cap] = False
    rows = torch.zeros(table_cap + 1, dtype=I32, device=dev)
    rows.scatter_reduce_(0, slot, _iota(rkey.shape[0], dev, I32), "amax")
    return presence[:table_cap], rows[:table_cap]


def dense_probe(lkey, llive, rmin, presence, rows, table_cap):
    """Per left row: matched flag + matching right row (valid iff matched)."""
    slot = lkey.to(I64) - rmin
    inb = (slot >= 0) & (slot < table_cap) & llive
    slot = slot.clamp(0, table_cap - 1)
    matched = inb & presence[slot]
    return matched, rows[slot]


# ---------------------------------------------------------------------------
# Direct (sort-free) grouping
# ---------------------------------------------------------------------------


def direct_gid(keys, valids, mins, ranges, live):
    """Mixed-radix group code per row (code 0 reserved for NULL when the
    key is nullable); dead rows get 0 and are excluded by weights."""
    gid = torch.zeros(live.shape[0], dtype=I64, device=live.device)
    for data, valid, kmin, krange in zip(keys, valids, mins, ranges):
        code = data.to(I64) - kmin
        if valid is not None:
            code = torch.where(valid, code + 1, 0)
        gid = gid * krange + code
    return torch.where(live, gid, 0)


def occupied(gid, live, domain_cap):
    """Occupied cell mask. Dead and out-of-range lanes write to the spare
    slots, not to one shared cell: on a GPU, stores that all land on one
    address serialise."""
    idx = _seg_index(gid, domain_cap, live)
    occ = torch.zeros(domain_cap + SPARE_SLOTS, dtype=torch.bool,
                      device=gid.device)
    occ[idx] = True  # every write stores True: races are harmless
    return occ[:domain_cap]


def occupancy_map(gid, live, domain_cap):
    """Occupied cell mask + dense renumbering (cell -> 0..ngroups-1)."""
    occ = occupied(gid, live, domain_cap)
    dense = torch.cumsum(occ.to(I64), 0) - 1
    return occ, dense


def segment_starts(gid, num_segments):
    """Index of the first sorted row of each segment (int64 max where the
    segment is empty, as jax.ops.segment_min's identity)."""
    n = gid.shape[0]
    idx = _seg_index(gid, num_segments)
    out = torch.full((num_segments + SPARE_SLOTS,), _I64_MAX, dtype=I64,
                     device=gid.device)
    out.scatter_reduce_(0, idx, _iota(n, gid.device), "amin")
    return out[:num_segments]


# ---------------------------------------------------------------------------
# Cumulative ops and window helpers. The JAX package blocks its cumulative
# ops for TPU compile time (fast_cumsum / fast_cummax); torch's cumsum and
# cummax are one kernel each, so the counterparts below are the plain scans
# with the JAX result widths kept: torch.cumsum widens int32 to int64 unless
# told otherwise, the JAX scan does not.
# ---------------------------------------------------------------------------


def fast_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exact inclusive prefix sum in x's own dtype."""
    return torch.cumsum(x, 0, dtype=x.dtype)


def fast_cummax(x: torch.Tensor) -> torch.Tensor:
    """Exact inclusive prefix max."""
    return torch.cummax(x, 0).values


def segment_heads(gid: torch.Tensor) -> torch.Tensor:
    """True at the first row of each run of equal ids (row 0 included)."""
    first = torch.ones(gid.shape[0], dtype=torch.bool, device=gid.device)
    if gid.shape[0] > 1:
        first[1:] = gid[1:] != gid[:-1]
    return first


def running_position(gid: torch.Tensor) -> torch.Tensor:
    """0-based int32 position of each sorted row within its segment: each
    head's own index carried forward by a prefix max."""
    idx = _iota(gid.shape[0], gid.device, I32)
    seg_start = fast_cummax(torch.where(segment_heads(gid), idx, 0))
    return idx - seg_start


def value_rank(x: torch.Tensor):
    """(sorted_values, rank): each row's int32 position in the ascending
    stable sort of its value. Floats sort as float64 with -0.0 normalised
    to 0.0; torch's sort puts NaN last (Spark's NaN-greatest)."""
    if x.is_floating_point():
        key = x.to(torch.float64)
        key = torch.where(key == 0.0, 0.0, key)
    else:
        key = x.to(I64)
    p = kv_sort_perm(key)
    n = x.shape[0]
    rank = torch.empty(n, dtype=I32, device=x.device)
    rank[p] = _iota(n, x.device, I32)
    return x[p], rank


def segmented_running_extreme(vals_sorted_by_rank, rank, gid, weight,
                              is_max: bool):
    """Running min/max within contiguous segments (gid ascending), exact for
    any dtype. `rank` / `vals_sorted_by_rank` come from value_rank. The
    prefix max runs over y = gid * n + rank, which is gid-major monotone, so
    no earlier segment's entry can win (rank < n); the winning rank maps
    back through the sorted values. Zero-weight rows take rank -1 (never
    win); a row whose segment prefix has no weight gathers an arbitrary
    value, which callers mask by the running weight count. The gather is
    clamped to [0, n), as the JAX clip."""
    n = rank.shape[0]
    r = rank.to(I64)
    if not is_max:
        r = n - 1 - r  # running min == running max of reversed ranks
    r = torch.where(weight, r, -1)
    g = gid.to(I64) * n
    win = fast_cummax(g + r) - g
    if not is_max:
        win = n - 1 - win
    return vals_sorted_by_rank[win.clamp(0, max(n - 1, 0))]
