"""Hand-written Hopper kernels, their wrappers and their plain versions:
the port of nds_tpu/ops/pallas_kernels.py.

  TPU kernel (pallas_kernels.py)          port (this module)   CUDA source
  _seg_kernel / segment_sums_pallas       segment_sums         csrc/segment_sums.cu
  _seg_extreme_kernel /
    segment_extreme_pallas                segment_extreme      csrc/segment_extreme.cu
  _dense_build_kernel / dense_build_pallas dense_build         csrc/dense_build.cu
  _sort_rank_kernel / sort_rank_pallas,
    sort_perm_pallas                      sort_rank, sort_perm csrc/sort_perm.cu
  segment_sums (platform dispatcher)      segment_sums (the wrapper's own
                                          CPU -> plain / CUDA -> kernel choice)

Every wrapper chooses by the device of the tensor it is given: a CPU tensor
runs the plain PyTorch version beside it (`*_plain`, the function the tests
hold against the JAX package), a CUDA tensor launches the kernel, and any
other device raises. There is no fallback: a CUDA tensor gets the kernel or
an error. Before a launch the wrapper checks device, dtype, shape and
contiguity, allocates the outputs, launches on the current stream, raises
when the launch reports an error, and adds one to its entry of `LAUNCHES`.

Contracts differ from the TPU kernels in two ways: counts, ranks and
histograms come back as exact int32 (the TPU kernels return them as f32),
and segment sums of the f32 values accumulate in f64 before one rounding
to f32 (the TPU kernel accumulates in f32, whose error at TPC-DS SF1 group
sizes fails the NDS validator's 1e-5 epsilon).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from . import _build

#: counting-sort routing caps (exec._sort_perm_route gates on them; the
#: same values as the JAX package's, so both engines route alike)
SORT_MAX_DOMAIN = 2048
SORT_MAX_ROWS = 1 << 24

#: launches of each kernel since the last reset_launches(); a wrapper adds
#: one where it launches its kernel, and nowhere else
LAUNCHES = {
    "segment_sums": 0,
    "segment_extreme": 0,
    "dense_build": 0,
    "sort_perm": 0,
}


#: guards LAUNCHES: concurrent streams launch from several threads
_LAUNCHES_LOCK = threading.Lock()


def reset_launches():
    with _LAUNCHES_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _launched(name: str):
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    ("segment_sums", "seg_sums_launch"):
        [_P, _P, _I64, _INT, _P, _P, _P, _INT, _INT, _P],
    ("segment_extreme", "seg_extreme_launch"):
        [_P, _P, _I64, _INT, _INT, _P, _P, _P, _INT, _INT, _INT, _P],
    ("dense_build", "dense_build_launch"):
        [_P, _P, _I64, _I64, _I64, _I64, _P, _P, _INT, _INT, _INT, _P],
    ("sort_perm", "sort_perm_launch"):
        [_P, _INT, _I64, _INT, _I64, _INT, _P, _P, _P, _P, _P],
}


_FNS = {}  # (source, symbol) -> ctypes function, argtypes set


def _fn(source: str, symbol: str):
    fn = _FNS.get((source, symbol))
    if fn is None:
        fn = getattr(_build.load(source), symbol)
        fn.argtypes = _SIGNATURES[(source, symbol)]
        fn.restype = ctypes.c_int
        _FNS[(source, symbol)] = fn
    return fn


def _on_card(t: torch.Tensor, what: str) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA tensor
    (kernel); anything else raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{what}: no kernel and no plain path for device "
                     f"{t.device}")


def _check(what: str, t: torch.Tensor, dtype, n=None):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != 1 or (n is not None and t.shape[0] != n):
        raise ValueError(f"{what}: expected shape ({n},), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


_SM_COUNT = {}  # device index -> streaming multiprocessors


def _launch_args(t: torch.Tensor):
    dev = t.device
    n_sm = _SM_COUNT.get(dev.index)
    if n_sm is None:
        n_sm = _SM_COUNT[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    # the raw cudaStream_t of the current stream, without building a
    # torch.cuda.Stream object on every launch (what torch's own generated
    # kernels call)
    return n_sm, torch._C._cuda_getCurrentRawStream(dev.index)


#: cudaError_t of an allocation the CUDA runtime refused; named in the
#: launch check's text, so that faults.classify calls it a device OOM
_CUDA_ERROR_MEMORY_ALLOCATION = 2


def _raise_if(rc: int, what: str):
    if rc != 0:
        name = (" (cudaErrorMemoryAllocation: out of memory)"
                if rc == _CUDA_ERROR_MEMORY_ALLOCATION else "")
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}{name}")


# ---------------------------------------------------------------------------
# 1. Segment sum + count
# ---------------------------------------------------------------------------


def _seg_slot(gid: torch.Tensor, n_groups: int):
    live = (gid >= 0) & (gid < n_groups)
    return live, torch.where(live, gid, n_groups).to(torch.int64)


def segment_sums_plain(vals, gid, n_groups: int):
    """Per-group (f32 sum, int32 count) of f32 `vals` by int32 `gid`, each
    sum accumulated in f64 and rounded once to f32; a gid outside
    [0, n_groups) is a dead row."""
    live, slot = _seg_slot(gid, n_groups)
    v = torch.where(live, vals.to(torch.float32), 0.0).to(torch.float64)
    sums = torch.zeros(n_groups + 1, dtype=torch.float64, device=vals.device)
    sums.index_add_(0, slot, v)
    counts = torch.zeros(n_groups + 1, dtype=torch.int32, device=vals.device)
    counts.index_add_(0, slot, live.to(torch.int32))
    return sums[:n_groups].to(torch.float32), counts[:n_groups]


#: segment_sums' launch shape (csrc/segment_sums.cu): 512 threads, two
#: 16-byte loads of four rows each in flight per thread and array
SUMS_THREADS = 512
SUMS_ROWS_PER_THREAD = 8
_SUMS_STATIC_SMEM = 16  # the block's smallest and largest id seen
#: a shared table's bytes per group: an f64 sum and an int32 count
_SUMS_GROUP_BYTES = 12


def _sums_table_limits():
    """(largest n_groups whose table lets two blocks share an SM, largest
    whose table fits one block) of segment_sums' shared path."""
    two = (SMEM_PER_SM - 2 * (_SMEM_RESERVED + _SUMS_STATIC_SMEM)) // 2
    return (two // _SUMS_GROUP_BYTES,
            (SMEM_PER_BLOCK - _SUMS_STATIC_SMEM) // _SUMS_GROUP_BYTES)


@functools.lru_cache(maxsize=256)
def segment_sums_plan(n: int, n_groups: int, n_sm: int) -> SegPlan:
    """Launch plan of the segment_sums kernel: one co-resident grid (the
    kernel grid.sync()s), never more blocks than rows need, at least one;
    one private shared-memory table per block (12 bytes per group) while it
    fits a block, two blocks per SM while two tables fit an SM; beyond one
    block's shared memory the global-atomic path (tables 0)."""
    g = max(1, n_groups)
    g_two, g_one = _sums_table_limits()
    tables = 1 if g <= g_one else 0
    per_sm = 1 if g_two < g <= g_one else 2
    need = -(-n // (SUMS_THREADS * SUMS_ROWS_PER_THREAD))
    return SegPlan(tables, SUMS_THREADS, max(1, min(per_sm * n_sm, need)),
                   tables * _SUMS_GROUP_BYTES * g)


def segment_sums(vals, gid, n_groups: int):
    """segment_sums_pallas's counterpart (and the platform dispatcher's).
    One device operation per call: the kernel writes every entry of two
    uninitialised outputs."""
    if not _on_card(vals, "segment_sums"):
        return segment_sums_plain(vals, gid, n_groups)
    return _segment_sums_launch(vals, gid, n_groups)


def _segment_sums_launch(vals, gid, n_groups: int, plan=None):
    """segment_sums' launch on CUDA tensors. `plan` (a SegPlan) overrides
    segment_sums_plan's choice, to time one plan against another."""
    n = vals.shape[0]
    _check("segment_sums vals", vals, torch.float32)
    _check("segment_sums gid", gid, torch.int32, n)
    sums = torch.empty(n_groups, dtype=torch.float32, device=vals.device)
    counts = torch.empty(n_groups, dtype=torch.int32, device=vals.device)
    if n_groups <= 0:
        return sums, counts
    acc = torch.empty(n_groups, dtype=torch.float64, device=vals.device)
    n_sm, stream = _launch_args(vals)
    if plan is None:
        plan = segment_sums_plan(n, n_groups, n_sm)
    rc = _fn("segment_sums", "seg_sums_launch")(
        vals.data_ptr(), gid.data_ptr(), n, n_groups, sums.data_ptr(),
        counts.data_ptr(), acc.data_ptr(), plan.tables, plan.blocks, stream,
    )
    _raise_if(rc, "segment_sums")
    _launched("segment_sums")
    return sums, counts


# ---------------------------------------------------------------------------
# 2. Segment min/max + count
# ---------------------------------------------------------------------------


def segment_extreme_plain(vals, gid, n_groups: int, is_max: bool):
    """Per-group (f32 min or max, int32 count). An empty group holds the
    -inf (max) / +inf (min) identity with count 0; a NaN in a live lane
    makes its group NaN (jnp.max/jnp.min propagate it)."""
    live, slot = _seg_slot(gid, n_groups)
    fill = float("-inf") if is_max else float("inf")
    v = vals.to(torch.float32)
    nan = live & torch.isnan(v)
    v = torch.where(live & ~nan, v, fill)
    ext = torch.full((n_groups + 1,), fill, dtype=torch.float32,
                     device=vals.device)
    ext.scatter_reduce_(0, slot, v, "amax" if is_max else "amin")
    nan_cnt = torch.zeros(n_groups + 1, dtype=torch.int32, device=vals.device)
    nan_cnt.index_add_(0, slot, nan.to(torch.int32))
    ext = torch.where(nan_cnt > 0, float("nan"), ext)
    counts = torch.zeros(n_groups + 1, dtype=torch.int32, device=vals.device)
    counts.index_add_(0, slot, live.to(torch.int32))
    return ext[:n_groups], counts[:n_groups]


def _order_key(f: float) -> int:
    """The kernel's order-preserving int32 key of a float32 value."""
    b = int(torch.tensor([f], dtype=torch.float32).view(torch.int32).item())
    return b if b >= 0 else b ^ 0x7FFFFFFF


#: shared memory of one Hopper SM and the most one block may use (H100:
#: 228 KB and 227 KB; the runtime keeps 1 KB of the SM per resident block)
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK = 232_448
_SMEM_RESERVED = 1024

#: segment_extreme's launch shape (csrc/segment_extreme.cu): 512 threads,
#: two 16-byte loads of four rows each in flight per thread and array
SEG_THREADS = 512
SEG_ROWS_PER_THREAD = 8


class SegPlan(NamedTuple):
    tables: int  # private shared-memory tables per block; 0 = global path
    threads: int
    blocks: int
    smem: int  # dynamic shared memory per block, bytes


@functools.lru_cache(maxsize=256)
def segment_extreme_plan(n: int, n_groups: int, n_sm: int) -> SegPlan:
    """Launch plan of the segment_extreme kernel: private shared-memory
    tables (12 bytes per group each) while they fit, one per warp where
    room allows and else one per group of warps, two blocks per SM while
    the tables leave room for both; beyond one block's shared memory the
    global-atomic path (tables 0). One persistent grid: at most two blocks
    per SM, never more blocks than rows need, at least one."""
    warps = SEG_THREADS // 32
    table = 12 * max(1, n_groups)
    two_per_sm = (SMEM_PER_SM - 2 * _SMEM_RESERVED) // 2
    if table <= two_per_sm:
        per_sm, tables = 2, min(warps, two_per_sm // table)
    elif table <= SMEM_PER_BLOCK:
        per_sm, tables = 1, min(warps, SMEM_PER_BLOCK // table)
    else:
        per_sm, tables = 2, 0
    need = -(-n // (SEG_THREADS * SEG_ROWS_PER_THREAD))
    blocks = max(1, min(per_sm * n_sm, need))
    return SegPlan(tables, SEG_THREADS, blocks, tables * table)


def segment_extreme(vals, gid, n_groups: int, is_max: bool):
    """segment_extreme_pallas's counterpart."""
    if not _on_card(vals, "segment_extreme"):
        return segment_extreme_plain(vals, gid, n_groups, is_max)
    n = vals.shape[0]
    _check("segment_extreme vals", vals, torch.float32)
    _check("segment_extreme gid", gid, torch.int32, n)
    dev = vals.device
    ident = _order_key(float("-inf") if is_max else float("inf"))
    keys = torch.full((n_groups,), ident, dtype=torch.int32, device=dev)
    counts = torch.zeros(n_groups, dtype=torch.int32, device=dev)
    nan_flag = torch.zeros(n_groups, dtype=torch.int32, device=dev)
    if n > 0 and n_groups > 0:
        n_sm, stream = _launch_args(vals)
        plan = segment_extreme_plan(n, n_groups, n_sm)
        rc = _fn("segment_extreme", "seg_extreme_launch")(
            vals.data_ptr(), gid.data_ptr(), n, n_groups, int(bool(is_max)),
            keys.data_ptr(), counts.data_ptr(), nan_flag.data_ptr(),
            plan.tables, plan.threads, plan.blocks, stream,
        )
        _raise_if(rc, "segment_extreme")
        _launched("segment_extreme")
    bits = torch.where(keys >= 0, keys, keys ^ 0x7FFFFFFF)
    ext = torch.where(nan_flag != 0, float("nan"), bits.view(torch.float32))
    return ext, counts


# ---------------------------------------------------------------------------
# 3. Dense-domain join build
# ---------------------------------------------------------------------------


def dense_build_plain(rkey, rlive, rmin: int, table_cap: int):
    """(presence bool[table_cap], max build-row index int32[table_cap]) over
    slots key - rmin in [0, table_cap); dead and out-of-range rows never
    match; empty slots hold (False, 0)."""
    dev = rkey.device
    slot = rkey.to(torch.int64) - rmin
    ok = rlive & (slot >= 0) & (slot < table_cap)
    slot = torch.where(ok, slot, table_cap)
    presence = torch.zeros(table_cap + 1, dtype=torch.bool, device=dev)
    presence[slot] = True
    rows = torch.zeros(table_cap + 1, dtype=torch.int32, device=dev)
    rows.scatter_reduce_(
        0, slot, torch.arange(rkey.shape[0], dtype=torch.int32, device=dev),
        "amax",
    )
    return presence[:table_cap], rows[:table_cap]


#: dense_build's owner path (csrc/dense_build.cu): slots one CTA owns (16 KB
#: of shared memory), and the largest build side it takes: at most this
#: many rows, and at most this many key reads over all its CTAs. Past
#: either, the cooperative path is faster (chip_smoke.py's kernel_sweep).
DENSE_OWNER_SLOTS = 4096
DENSE_OWNER_MAX_ROWS = 8192
DENSE_OWNER_MAX_READS = 1 << 22
_DENSE_PATHS = {"owner": 0, "cooperative": 1}


class DensePlan(NamedTuple):
    path: str  # "owner" or "cooperative"
    slots: int  # slots per owner CTA (0 otherwise)
    grid: int  # owner CTAs (0: the launch sizes the grid)


def _dense_owner_shape(table_cap: int):
    slots = min(DENSE_OWNER_SLOTS, -(-table_cap // 16) * 16)
    return slots, max(1, -(-table_cap // slots))


def dense_owner_max_rows(table_cap: int) -> int:
    """The most build rows dense_build's owner path takes for a table of
    `table_cap` slots."""
    _, grid = _dense_owner_shape(table_cap)
    return min(DENSE_OWNER_MAX_ROWS, DENSE_OWNER_MAX_READS // grid)


@functools.lru_cache(maxsize=256)
def dense_build_plan(n: int, table_cap: int) -> DensePlan:
    """Launch plan of the dense_build kernel for `n` build rows and
    `table_cap` slots: the owner path (CTAs of up to DENSE_OWNER_SLOTS
    slots, a multiple of 16) up to dense_owner_max_rows, else the
    cooperative init + scatter kernel, whose grid the launch sizes from the
    occupancy."""
    if n <= dense_owner_max_rows(table_cap):
        return DensePlan("owner", *_dense_owner_shape(table_cap))
    return DensePlan("cooperative", 0, 0)


def dense_build(rkey, rlive, rmin: int, table_cap: int, plan=None):
    """dense_build_pallas's counterpart. One device operation per call: the
    kernel writes every slot of two uninitialised tables (two allocations
    cost less host time than views into one). `plan` (a DensePlan)
    overrides dense_build_plan's choice, to time one path against
    another."""
    if not _on_card(rkey, "dense_build"):
        return dense_build_plain(rkey, rlive, rmin, table_cap)
    n = rkey.shape[0]
    _check("dense_build rkey", rkey, torch.int64)
    _check("dense_build rlive", rlive, torch.bool, n)
    if n >= 1 << 31 or table_cap <= 0:
        raise ValueError(f"dense_build: {n} build rows (int32 row indices) "
                         f"or table_cap {table_cap} out of range")
    n_sm, stream = _launch_args(rkey)
    if plan is None:
        plan = dense_build_plan(n, table_cap)
    cap_pad = -(-table_cap // 16) * 16  # whole 16-byte stores
    dev = rkey.device
    rows = torch.empty(cap_pad, dtype=torch.int32, device=dev)
    presence = torch.empty(cap_pad, dtype=torch.bool, device=dev)
    rc = _fn("dense_build", "dense_build_launch")(
        rkey.data_ptr(), rlive.data_ptr(), n, int(rmin), int(table_cap),
        cap_pad, rows.data_ptr(), presence.data_ptr(),
        _DENSE_PATHS[plan.path], plan.slots, n_sm, stream,
    )
    _raise_if(rc, "dense_build")
    _launched("dense_build")
    if cap_pad != table_cap:
        return presence[:table_cap], rows[:table_cap]
    return presence, rows


# ---------------------------------------------------------------------------
# 4. Counting sort: stable rank + histogram + permutation
# ---------------------------------------------------------------------------


def sort_rank_plain(vals, domain: int):
    """(stable within-key rank int32[n], key histogram int32[domain]) of
    int32 `vals` in [0, domain); a key outside the domain (the -1 padding
    lane) counts nowhere and its rank is unspecified."""
    dev = vals.device
    n = vals.shape[0]
    valid = (vals >= 0) & (vals < domain)
    key = torch.where(valid, vals.to(torch.int64), domain)
    hist = torch.bincount(key, minlength=domain + 1)
    offsets = torch.cumsum(hist, 0) - hist
    order = torch.sort(key, stable=True).indices
    pos = torch.empty(n, dtype=torch.int64, device=dev)
    pos[order] = torch.arange(n, dtype=torch.int64, device=dev)
    rank = pos - offsets[key]
    return rank.to(torch.int32), hist[:domain].to(torch.int32)


def sort_perm_plain(word, domain: int):
    """Stable ascending argsort (int32) of one small-domain word."""
    return torch.sort(word.to(torch.int32), stable=True).indices.to(
        torch.int32
    )


#: sort_perm's launch shape (csrc/sort_perm.cu): CTAs of 512 threads that
#: walk whole tiles of 4,096 rows; a 16-bit count per (key, warp), three
#: int tables per key and a staged tile in pass 2's shared memory
SORT_THREADS = 512
SORT_TILE = 4096


def sort_rank_smem(domain: int) -> int:
    """Dynamic shared memory (bytes) of sort_perm's pass 2 for `domain`
    keys."""
    return domain * ((SORT_THREADS // 32) * 2 + 12) + SORT_TILE * 6


class SortPlan(NamedTuple):
    blocks: int  # CTAs of passes 1 and 2
    rows_per_block: int  # contiguous rows each CTA owns: whole tiles
    smem: int  # pass 2's dynamic shared memory per block, bytes


@functools.lru_cache(maxsize=256)
def sort_perm_plan(n: int, domain: int, n_sm: int) -> SortPlan:
    """Launch plan of the counting sort of `n` keys in [0, `domain`): a
    persistent grid of two CTAs per SM (pass 2's shared memory lets two
    share an SM for every domain up to SORT_MAX_DOMAIN), each owning a
    contiguous run of whole tiles, never more CTAs than tiles."""
    if not 0 < domain <= SORT_MAX_DOMAIN:
        raise ValueError(f"sort_perm: domain {domain} outside "
                         f"(0, {SORT_MAX_DOMAIN}]")
    smem = sort_rank_smem(domain)
    tiles = max(1, -(-n // SORT_TILE))
    per_sm = 2 if 2 * (smem + _SMEM_RESERVED + 64) <= SMEM_PER_SM else 1
    blocks = min(per_sm * n_sm, tiles)
    rows_per_block = -(-tiles // blocks) * SORT_TILE
    return SortPlan(-(-max(1, n) // rows_per_block), rows_per_block, smem)


def _sort_pipeline(keys, domain: int, want_rank: bool):
    """(rank or None, hist, perm) from one call of the counting sort."""
    n = keys.shape[0]
    if keys.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"sort_perm: expected an int32 or int64 word, got "
                        f"{keys.dtype}")
    _check("sort_perm keys", keys, keys.dtype)
    if n > SORT_MAX_ROWS:
        raise ValueError(f"sort_perm: {n} rows exceed {SORT_MAX_ROWS}")
    n_sm, stream = _launch_args(keys)
    plan = sort_perm_plan(n, domain, n_sm)
    dev = keys.device
    scratch = plan.blocks * domain  # block_hist: per-block key counts
    hist = torch.empty(scratch + domain, dtype=torch.int32, device=dev)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    rank = torch.empty(n, dtype=torch.int32, device=dev) if want_rank else None
    rc = _fn("sort_perm", "sort_perm_launch")(
        keys.data_ptr(), keys.element_size(), n, domain,
        plan.rows_per_block, plan.blocks,
        hist.data_ptr(), hist.data_ptr() + 4 * scratch,
        rank.data_ptr() if want_rank else None, perm.data_ptr(), stream,
    )
    _raise_if(rc, "sort_perm")
    _launched("sort_perm")
    return rank, hist[scratch:], perm


def sort_rank(vals, domain: int):
    """sort_rank_pallas's counterpart."""
    if not _on_card(vals, "sort_rank"):
        return sort_rank_plain(vals, domain)
    _check("sort_rank vals", vals, torch.int32)
    rank, hist, _ = _sort_pipeline(vals, domain, True)
    return rank, hist


def sort_perm(word, domain: int):
    """sort_perm_pallas's counterpart: the stable ascending argsort of one
    small-domain sort word, identical to kernels.sort_by_words([word]). The
    kernel reads an int32 or int64 word as it is (no conversion pass) in
    three launches, with no memset."""
    if not _on_card(word, "sort_perm"):
        return sort_perm_plain(word, domain)
    return _sort_pipeline(word.contiguous(), domain, False)[2]
