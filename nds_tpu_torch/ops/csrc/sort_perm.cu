// Stable counting sort of small-domain integer keys: the ascending stable
// permutation, the key histogram, and (on request) the stable within-key
// rank of every row.
//
// Replaces the Pallas TPU kernel `_sort_rank_kernel` / `sort_rank_pallas`
// and its consumer `sort_perm_pallas` (nds_tpu/ops/pallas_kernels.py:248,
// :293, :326). The TPU kernel carries a running histogram across a
// SEQUENTIAL grid of row tiles and ranks rows with two one-hot MXU matmuls
// per tile. GPU blocks run in no order, so nothing can be carried from one
// block to the next; a scan between two passes takes the carry's place.
//
// What bounds it on Hopper: device-memory bytes. The key word is read
// twice and perm written once: at the ORDER BY shape (2^24 int64 keys) 335
// MB, ~0.10 ms at 3.35 TB/s (the byte bound counts one read: 0.06 ms).
// What kept the first port far from it: a dtype-conversion pass and a
// memset before the kernels, a scan with one serial thread per key, one
// warp per block ranking 32 rows at a time, and 32 scattered 4-byte stores
// per warp. The design:
//   * keys are read as they come (int32 or int64: one instantiation each);
//     no conversion, no memset: every entry of perm is written here (the
//     tail [in-domain rows, n) with 0), rank only when asked for;
//   * one persistent grid from the host-side plan
//     (gpu_kernels.sort_perm_plan): CTAs of 512 threads, two per SM, each
//     owning a contiguous range of whole 4,096-row tiles. A warp takes 256
//     consecutive rows of a tile as 8 coalesced loads (row = j*32 + lane),
//     so lane order is row order;
//   * pass 1 (hist): the range's histogram in 8 shared tables, 16 loads in
//     flight per thread (a warp's 512 rows of one key make one atomic,
//     detected with two redux instructions), merged once into
//     block_hist[k][b];
//   * scan: one warp per key scans its column over the blocks with
//     shuffles, in parallel: exclusive block offsets in place, the key
//     total to hist[k];
//   * pass 2 (rank + scatter): each CTA turns hist into key bases with a
//     block scan, then walks its tiles with the next tile's keys already in
//     flight. A row's stable rank in its warp is
//     popc(match_any(key) & lanemask_lt) plus a 16-bit per-(key, warp)
//     counter in shared memory; a per-key scan over the 16 warps and a scan
//     over keys give each row its slot in the tile's destination order
//     (a thread owns keys tid, tid + 512, ..., so at domain 384 the per-key
//     steps run on 384 threads, not on 96 with four keys each: the rank
//     pass measured 101.5 -> 91.8 us at the ORDER BY shape). The
//     tile's row ids are staged there in shared memory, then written out as
//     one contiguous run of perm per key (coalesced stores, not scatter).
//     One path for every n: three launches, 8.5 us of device time at
//     n = 100 on an H100 (a one-CTA kernel took 5.5 us there, but no query
//     of the port sorts so few rows with this kernel, so it was not kept).
// Keys outside [0, domain) (the -1 padding lanes of the TPU contract) are
// counted nowhere and ranked nowhere; their rank entries are left as they
// were.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                  // rows per thread per tile
constexpr int kTile = kThreads * kRows;   // 4,096 rows
constexpr int kWarpRows = 32 * kRows;     // 256 consecutive rows per warp
constexpr int kMaxDomain = 2048;
constexpr int kKeysPerThread = kMaxDomain / kThreads;  // 4
constexpr int kHistTables = 8;            // pass 1: two warps per table
constexpr int kHistRows = 16;             // pass 1: loads in flight per thread
constexpr int kScanThreads = 256;
constexpr int kScanPer = 8;               // block offsets per lane per step

// Shared memory of pass 2, in bytes:
//   cnt    uint16 [domain][kWarps]
//   start  int [domain]  tile-local first slot of each key
//   delta  int [domain]  perm position minus tile-local slot, per key
//   base   int [domain]  first perm position of each key
//   stage_row int [kTile], stage_key uint16 [kTile]
__host__ __device__ constexpr int64_t rank_smem(int domain) {
  return (int64_t)domain * (kWarps * 2 + 12) + (int64_t)kTile * 6;
}

struct RankSmem {
  uint16_t* cnt;
  int* start;
  int* delta;
  int* base;
  int* stage_row;
  uint16_t* stage_key;
};

__device__ __forceinline__ RankSmem carve(unsigned char* p, int domain) {
  RankSmem s;
  s.cnt = reinterpret_cast<uint16_t*>(p);
  s.start = reinterpret_cast<int*>(p + (size_t)domain * kWarps * 2);
  s.delta = s.start + domain;
  s.base = s.delta + domain;
  s.stage_row = s.base + domain;
  s.stage_key = reinterpret_cast<uint16_t*>(s.stage_row + kTile);
  return s;
}

template <typename K>
__device__ __forceinline__ int valid_key(K k, int domain) {
  return (k >= 0 && k < (K)domain) ? (int)k : -1;
}

// Exclusive block-wide prefix of one value per thread; `total` gets the
// sum. All threads call it; `wsum` (kWarps ints) must not be in use by an
// earlier call that some thread has not yet passed a barrier after.
__device__ __forceinline__ int block_excl_scan(int s, int* wsum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int pre = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = wsum[w];
    tot += v;
    if (w < warp) pre += v;
  }
  total = tot;
  return pre + incl - s;
}

// The keys a thread owns in the per-key steps: key i * kThreads + tid for
// i < kKeysPerThread, so that every thread has one while domain allows.
__device__ __forceinline__ int owned_key(int i) {
  return i * kThreads + threadIdx.x;
}

// Exclusive prefix over keys (in key order) of v[i], the value of owned
// key i; returns the total. One block scan per round of kThreads keys.
__device__ __forceinline__ int keys_excl_scan(const int (&v)[kKeysPerThread],
                                              int (&excl)[kKeysPerThread],
                                              int domain, int* wsum) {
  int carry = 0;
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    if (i * kThreads >= domain) break;  // uniform
    if (i > 0) __syncthreads();  // the last round's wsum reads are done
    int tot;
    excl[i] = carry + block_excl_scan(v[i], wsum, tot);
    carry += tot;
  }
  return carry;
}

// Histogram of rows [start, end) into kHistTables zeroed int tables of
// `domain` entries at `tables` (two warps per table).
template <typename K>
__device__ __forceinline__ void histogram_range(const K* __restrict__ keys,
                                                int64_t start, int64_t end,
                                                int domain, int* tables) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* h = tables + (warp % kHistTables) * domain;
  constexpr int kStep = kThreads * kHistRows;
  for (int64_t t0 = start; t0 < end; t0 += kStep) {
    const int64_t seg = t0 + warp * 32 * kHistRows + lane;
    int k[kHistRows];
    int lo = INT_MAX, hi = -1;
#pragma unroll
    for (int j = 0; j < kHistRows; ++j) {
      const int64_t i = seg + j * 32;
      k[j] = i < end ? valid_key(keys[i], domain) : -1;
    }
#pragma unroll
    for (int j = 0; j < kHistRows; ++j) {
      if (k[j] >= 0) {
        lo = min(lo, k[j]);
        hi = max(hi, k[j]);
      }
    }
    const int whi = __reduce_max_sync(kFull, hi);
    if (whi < 0) continue;  // no in-domain row in these 512
    const int wlo = __reduce_min_sync(kFull, lo);
    if (wlo == whi) {  // one key: one atomic for the warp
      int c = 0;
#pragma unroll
      for (int j = 0; j < kHistRows; ++j) c += k[j] == wlo;
      c = __reduce_add_sync(kFull, c);
      if (lane == 0) atomicAdd(&h[wlo], c);
      continue;
    }
#pragma unroll
    for (int j = 0; j < kHistRows; ++j)
      if (k[j] >= 0) atomicAdd(&h[k[j]], 1);
  }
}

// Sum of the kHistTables tables for the keys this thread owns.
__device__ __forceinline__ void merge_tables(const int* tables, int domain,
                                             int (&h)[kKeysPerThread]) {
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int k = owned_key(i);
    h[i] = 0;
    if (k < domain) {
#pragma unroll
      for (int t = 0; t < kHistTables; ++t) h[i] += tables[t * domain + k];
    }
  }
}

__device__ __forceinline__ void zero_cnt(const RankSmem& s, int domain) {
  uint4* c = reinterpret_cast<uint4*>(s.cnt);
  for (int q = threadIdx.x; q < domain * 2; q += kThreads)
    c[q] = make_uint4(0, 0, 0, 0);
}

template <typename K>
__device__ __forceinline__ void load_tile(const K* __restrict__ keys,
                                          int64_t t0, int64_t end,
                                          K (&raw)[kRows]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t seg = t0 + warp * kWarpRows + lane;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int64_t i = seg + j * 32;
    raw[j] = i < end ? keys[i] : (K)-1;
  }
}

// Rank and scatter rows [start, end) (whole tiles from `start`). run[i] is
// the next perm position of key owned_key(i); s.base holds the
// key bases and s.cnt is zero. Ends with a barrier.
template <typename K>
__device__ __forceinline__ void rank_scatter_range(
    const K* __restrict__ keys, int64_t start, int64_t end, int domain,
    int (&run)[kKeysPerThread], const RankSmem& s, int* wsum,
    int32_t* __restrict__ rank, int32_t* __restrict__ perm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  K raw[kRows];
  if (start < end) load_tile(keys, start, end, raw);
  for (int64_t t0 = start; t0 < end; t0 += kTile) {
    int key[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) key[j] = valid_key(raw[j], domain);
    if (t0 + kTile < end) load_tile(keys, t0 + kTile, end, raw);  // in flight

    // 1. stable rank within the warp, and per-(key, warp) counts
    int r[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int k = key[j];
      const unsigned peers = __match_any_sync(kFull, k);
      int c = 0;
      if (k >= 0) c = s.cnt[k * kWarps + warp];
      __syncwarp();
      if (k >= 0 && (peers >> lane) == 1u)  // the highest lane of its peers
        s.cnt[k * kWarps + warp] = (uint16_t)(c + __popc(peers));
      __syncwarp();
      r[j] = c + __popc(peers & lt);
    }
    __syncthreads();

    // 2. per owned key: exclusive prefix over the warps (in place) and the
    // tile's total; then the exclusive prefix over keys
    int tot[kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int k = owned_key(i);
      tot[i] = 0;
      if (k < domain) {
        uint4* p = reinterpret_cast<uint4*>(s.cnt + k * kWarps);
        uint4 a = p[0], b = p[1];
        uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        int acc = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int lo = w[q] & 0xffff, hi = w[q] >> 16;
          w[q] = (uint32_t)acc | ((uint32_t)(acc + lo) << 16);
          acc += lo + hi;
        }
        p[0] = make_uint4(w[0], w[1], w[2], w[3]);
        p[1] = make_uint4(w[4], w[5], w[6], w[7]);
        tot[i] = acc;
      }
    }
    int excl[kKeysPerThread];
    const int tile_valid = keys_excl_scan(tot, excl, domain, wsum);
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int k = owned_key(i);
      if (k < domain) {
        s.start[k] = excl[i];
        s.delta[k] = run[i] - excl[i];
        run[i] += tot[i];
      }
    }
    __syncthreads();

    // 3. stage row ids in destination order (and write rank if asked)
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int k = key[j];
      if (k >= 0) {
        const int d = s.start[k] + s.cnt[k * kWarps + warp] + r[j];
        const int row = (int)(t0 + warp * kWarpRows + j * 32 + lane);
        s.stage_row[d] = row;
        s.stage_key[d] = (uint16_t)k;
        if (rank != nullptr) rank[row] = s.delta[k] + d - s.base[k];
      }
    }
    __syncthreads();

    // 4. one contiguous run of perm per key; clear the counters
    for (int d = threadIdx.x; d < tile_valid; d += kThreads)
      perm[s.delta[s.stage_key[d]] + d] = s.stage_row[d];
    zero_cnt(s, domain);
    __syncthreads();
  }
}

// perm[from, n) = 0, spread over the grid.
__device__ __forceinline__ void zero_tail(int32_t* __restrict__ perm,
                                          int64_t from, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = from + (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    perm[i] = 0;
}

// Pass 1. Dynamic shared memory: int [kHistTables][domain].
template <typename K>
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const K* __restrict__ keys, int64_t n, int64_t rows_per_block,
                int domain, int32_t* __restrict__ block_hist) {
  extern __shared__ __align__(16) int tables[];
  for (int q = threadIdx.x; q < kHistTables * domain; q += kThreads)
    tables[q] = 0;
  __syncthreads();
  const int64_t start = (int64_t)blockIdx.x * rows_per_block;
  const int64_t end = min(n, start + rows_per_block);
  histogram_range(keys, start, end, domain, tables);
  __syncthreads();
  int h[kKeysPerThread];
  merge_tables(tables, domain, h);
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int k = owned_key(i);
    if (k < domain) block_hist[(int64_t)k * gridDim.x + blockIdx.x] = h[i];
  }
}

// Per key (one warp each): exclusive prefix of its column of block_hist
// over the blocks, in block order, in place; the total to hist[k].
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(int32_t* __restrict__ block_hist, int n_blocks, int domain,
                int32_t* __restrict__ hist) {
  const int key = (blockIdx.x * kScanThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (key >= domain) return;  // whole warps leave together
  int32_t* col = block_hist + (int64_t)key * n_blocks;
  int carry = 0;
  for (int b0 = 0; b0 < n_blocks; b0 += 32 * kScanPer) {
    int v[kScanPer];
    int s = 0;
#pragma unroll
    for (int i = 0; i < kScanPer; ++i) {
      const int b = b0 + lane * kScanPer + i;
      v[i] = b < n_blocks ? col[b] : 0;
      s += v[i];
    }
    int incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    int run = carry + incl - s;
#pragma unroll
    for (int i = 0; i < kScanPer; ++i) {
      const int b = b0 + lane * kScanPer + i;
      if (b < n_blocks) col[b] = run;
      run += v[i];
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) hist[key] = carry;
}

// Pass 2. Dynamic shared memory: rank_smem(domain).
template <typename K>
__global__ void __launch_bounds__(kThreads, 2)
    rank_kernel(const K* __restrict__ keys, int64_t n, int64_t rows_per_block,
                int domain, const int32_t* __restrict__ block_off,
                const int32_t* __restrict__ hist, int32_t* __restrict__ rank,
                int32_t* __restrict__ perm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wsum[kWarps];
  const RankSmem s = carve(smem, domain);
  int h[kKeysPerThread];
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int k = owned_key(i);
    h[i] = k < domain ? hist[k] : 0;
  }
  // key bases: s.base, run[] = base + this block's offset
  int excl[kKeysPerThread], run[kKeysPerThread];
  const int total = keys_excl_scan(h, excl, domain, wsum);
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int k = owned_key(i);
    run[i] = 0;
    if (k < domain) {
      s.base[k] = excl[i];
      run[i] = excl[i] + block_off[(int64_t)k * gridDim.x + blockIdx.x];
    }
  }
  zero_cnt(s, domain);
  __syncthreads();
  const int64_t start = (int64_t)blockIdx.x * rows_per_block;
  const int64_t end = min(n, start + rows_per_block);
  rank_scatter_range(keys, start, end, domain, run, s, wsum, rank, perm);
  zero_tail(perm, total, n);
}

template <typename F>
int allow_smem(F* kernel, int64_t bytes, int& granted) {
  if (bytes > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    granted = (int)bytes;
  }
  return 0;
}

template <typename K>
int launch(const K* keys, int64_t n, int domain, int64_t rows_per_block,
           int n_blocks, int32_t* block_hist, int32_t* hist, int32_t* rank,
           int32_t* perm, cudaStream_t s) {
  static int granted_hist = 48 * 1024,
             granted_rank = 48 * 1024;  // per instantiation; raise only
  const int64_t rsmem = rank_smem(domain);
  int rc;
  if (n_blocks <= 0 || rows_per_block <= 0 || rows_per_block % kTile != 0 ||
      (int64_t)n_blocks * rows_per_block < n)
    return (int)cudaErrorInvalidValue;
  const int64_t hsmem = (int64_t)kHistTables * domain * 4;
  if ((rc = allow_smem(hist_kernel<K>, hsmem, granted_hist))) return rc;
  if ((rc = allow_smem(rank_kernel<K>, rsmem, granted_rank))) return rc;
  hist_kernel<K><<<n_blocks, kThreads, hsmem, s>>>(keys, n, rows_per_block,
                                                   domain, block_hist);
  const int scan_blocks = (domain * 32 + kScanThreads - 1) / kScanThreads;
  scan_kernel<<<scan_blocks, kScanThreads, 0, s>>>(block_hist, n_blocks,
                                                    domain, hist);
  rank_kernel<K><<<n_blocks, kThreads, rsmem, s>>>(
      keys, n, rows_per_block, domain, block_hist, hist, rank, perm);
  return (int)cudaGetLastError();
}

}  // namespace

// keys: int32 (key_bytes 4) or int64 (key_bytes 8), n <= 2^31 - 1 rows.
// hist + scan + rank over n_blocks blocks of rows_per_block rows (a
// multiple of 4,096). Scratch: block_hist int32[n_blocks * domain]. Outputs: hist
// int32[domain], perm int32[n] (every entry written), rank int32[n] or
// null (in-domain rows written). Returns cudaGetLastError() or the refused
// attribute's error.
extern "C" int sort_perm_launch(const void* keys, int key_bytes, int64_t n,
                                int domain, int64_t rows_per_block,
                                int n_blocks, int32_t* block_hist,
                                int32_t* hist, int32_t* rank, int32_t* perm,
                                void* stream) {
  if (domain <= 0 || domain > kMaxDomain || n < 0 || n > INT_MAX ||
      (key_bytes != 4 && key_bytes != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 4)
    return launch(static_cast<const int32_t*>(keys), n, domain,
                  rows_per_block, n_blocks, block_hist, hist, rank, perm, s);
  return launch(static_cast<const int64_t*>(keys), n, domain, rows_per_block,
                n_blocks, block_hist, hist, rank, perm, s);
}
