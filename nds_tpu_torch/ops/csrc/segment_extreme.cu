// Per-group (min or max, count) of float32 values by int32 group id.
//
// Replaces the Pallas TPU kernel `_seg_extreme_kernel` /
// `segment_extreme_pallas` (nds_tpu/ops/pallas_kernels.py:96, :133), which
// folds a one-hot masked min/max per row tile in VMEM.
//
// What bounds it on Hopper: 8 bytes read per row (value + group id), so at
// fact width (2^29 lanes) 4.3 GB, 1.28 ms at 3.35 TB/s. Reaching that needs
// many bytes in flight per SM and few instructions per row: over ids in
// random order nearly every warp holds several groups, and a warp-level
// peer reduction (match + a 32-step shuffle sweep) costs ~45 warp
// instructions per 32 rows, which made the kernel instruction-bound.
//
// Design:
//   * streaming: one persistent grid (a few blocks per SM, from the host-side
//     plan gpu_kernels.segment_extreme_plan); seg_stream.cuh's 16-byte
//     loads, two of each array in flight per thread before it reduces any,
//     with the streaming cache hint; an unaligned head and the ragged tail
//     go row by row;
//   * reduction: floats map to order-preserving int32 keys (non-negative:
//     the bits; negative: the bits with the magnitude flipped), so min/max
//     is an integer atomic. Per 128 rows (four per lane) a warp takes the
//     smallest and largest live id with two redux instructions:
//       - no live row (the dead tail of padding lanes): nothing;
//       - one group (sorted ids, a single-group input): the keys and counts
//         reduce with __reduce_{max,min,add}_sync and lane 0 performs one
//         atomic of each kind;
//       - several groups: no peer sweep; each live row goes straight to an
//         integer atomic on its group's count and, only when its key beats
//         the value read from the table, on its group's key (for random
//         data almost no row beats the running extreme after the first few,
//         so most rows cost one table read and one atomic);
//   * tables: while 12 bytes per group fit, each block keeps private tables
//     in dynamic shared memory (one per warp when they fit, else one per
//     group of warps; above 48 KB after cudaFuncSetAttribute), merges them
//     and flushes one global atomic per touched group at the end. Beyond
//     shared memory the same code updates the global arrays directly;
//   * NaN: integer atomics drop NaN while the TPU kernel's jnp.max/jnp.min
//     propagate it. A NaN in a live lane sets its group's NaN flag (and
//     counts as a row), and the wrapper writes NaN for flagged groups.
// An empty group keeps the +-inf identity with count 0 (callers mask via
// the count). A gid outside [0, n_groups) is a dead row.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "seg_stream.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t order_key(float f) {
  const int32_t b = __float_as_int(f);
  return b >= 0 ? b : (b ^ 0x7fffffff);
}

template <bool kMax>
__device__ __forceinline__ int32_t combine(int32_t a, int32_t b) {
  return kMax ? max(a, b) : min(a, b);
}

template <bool kMax>
__device__ __forceinline__ int32_t warp_combine(int32_t k) {
  return kMax ? __reduce_max_sync(kFull, k) : __reduce_min_sync(kFull, k);
}

template <bool kMax>
__device__ __forceinline__ void atomic_combine(int32_t* p, int32_t k) {
  if (kMax) atomicMax(p, k); else atomicMin(p, k);
}

struct Tables {
  int32_t* key;
  int32_t* cnt;
  int32_t* nan;
};

// Fold four rows per lane into the tables. Warp-collective: all 32 lanes
// call it together (a lane with no rows passes dead ids).
template <bool kMax, bool kShared>
__device__ __forceinline__ void fold4(const float4 v4, const int4 g4,
                                      int n_groups, int32_t ident,
                                      const Tables& t) {
  const float v[4] = {v4.x, v4.y, v4.z, v4.w};
  const int g[4] = {g4.x, g4.y, g4.z, g4.w};
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (static_cast<unsigned>(g[j]) < static_cast<unsigned>(n_groups)) {
      lo = min(lo, g[j]);
      hi = max(hi, g[j]);
    }
  }
  const int whi = __reduce_max_sync(kFull, hi);
  if (whi < 0) return;  // no live row in these 128
  const int wlo = __reduce_min_sync(kFull, lo);
  if (wlo == whi) {
    int32_t k = ident;
    unsigned c = 0;
    bool any_nan = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (g[j] == wlo) {
        ++c;
        if (isnan(v[j])) any_nan = true; else k = combine<kMax>(k, order_key(v[j]));
      }
    }
    k = warp_combine<kMax>(k);
    c = __reduce_add_sync(kFull, c);
    any_nan = __any_sync(kFull, any_nan);
    if ((threadIdx.x & 31) == 0) {
      atomic_combine<kMax>(&t.key[wlo], k);
      atomicAdd(&t.cnt[wlo], static_cast<int32_t>(c));
      if (any_nan) t.nan[wlo] = 1;  // every writer stores the same word
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gj = g[j];
    if (static_cast<unsigned>(gj) >= static_cast<unsigned>(n_groups)) continue;
    atomicAdd(&t.cnt[gj], 1);
    if (isnan(v[j])) {
      t.nan[gj] = 1;
      continue;
    }
    const int32_t k = order_key(v[j]);
    // The table only moves toward the extreme, so a stale read (shared
    // memory written by other warps, or a global line cached in L1) can
    // only let through an atomic that changes nothing, never skip one
    // that would.
    const int32_t cur = kShared
        ? *reinterpret_cast<volatile int32_t*>(&t.key[gj]) : t.key[gj];
    if (kMax ? k <= cur : k >= cur) continue;
    atomic_combine<kMax>(&t.key[gj], k);
  }
}

template <bool kMax, bool kShared>
__global__ void __launch_bounds__(kMaxThreads, 2)
    seg_extreme_kernel(const float* __restrict__ vals,
                       const int32_t* __restrict__ gid, int64_t n,
                       int n_groups, int n_tables, int32_t* __restrict__ keys,
                       int32_t* __restrict__ counts,
                       int32_t* __restrict__ nan_flag) {
  extern __shared__ __align__(16) int32_t smem[];
  const int32_t ident = kMax ? order_key(-__int_as_float(0x7f800000))
                             : order_key(__int_as_float(0x7f800000));
  const int warp = threadIdx.x >> 5;
  Tables t{keys, counts, nan_flag};
  if (kShared) {
    for (int i = threadIdx.x; i < n_tables * n_groups; i += blockDim.x) {
      const int tb = i / n_groups, g = i - tb * n_groups;
      int32_t* base = smem + 3 * tb * n_groups;
      base[g] = ident;
      base[n_groups + g] = 0;
      base[2 * n_groups + g] = 0;
    }
    __syncthreads();
    int32_t* mine = smem + 3 * (warp % n_tables) * n_groups;
    t = Tables{mine, mine + n_groups, mine + 2 * n_groups};
  }

  auto fold = [&](const float4 v, const int4 g) {
    fold4<kMax, kShared>(v, g, n_groups, ident, t);
  };
  seg_stream::for_each_chunk(vals, gid, n, fold);

  if (kShared) {
    __syncthreads();
    for (int g = threadIdx.x; g < n_groups; g += blockDim.x) {
      int32_t k = ident;
      int32_t c = 0, flag = 0;
      for (int tb = 0; tb < n_tables; ++tb) {
        const int32_t* base = smem + 3 * tb * n_groups;
        k = combine<kMax>(k, base[g]);
        c += base[n_groups + g];
        flag |= base[2 * n_groups + g];
      }
      if (c) {
        atomic_combine<kMax>(&keys[g], k);
        atomicAdd(&counts[g], c);
        if (flag) nan_flag[g] = 1;
      }
    }
  }
}

template <bool kMax, bool kShared>
int launch(const float* vals, const int32_t* gid, int64_t n, int n_groups,
           int n_tables, int32_t* keys, int32_t* counts, int32_t* nan_flag,
           int threads, int blocks, int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    static int granted = 48 * 1024;  // per instantiation; raise only
    if (smem > granted) {
      const cudaError_t e = cudaFuncSetAttribute(
          seg_extreme_kernel<kMax, kShared>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      granted = smem;
    }
  }
  seg_extreme_kernel<kMax, kShared><<<blocks, threads, smem, s>>>(
      vals, gid, n, n_groups, n_tables, keys, counts, nan_flag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The caller fills `keys` with the identity key (order_key(-inf) for max,
// order_key(+inf) for min) and zero-fills counts and nan_flag; it decodes
// keys back to floats. n_tables > 0 selects the shared-memory tables (smem
// = n_tables * 12 * n_groups bytes), 0 the global path. Returns
// cudaGetLastError() or the refused attribute's error.
extern "C" int seg_extreme_launch(const float* vals, const int32_t* gid,
                                  int64_t n, int n_groups, int is_max,
                                  int32_t* keys, int32_t* counts,
                                  int32_t* nan_flag, int n_tables,
                                  int threads, int blocks, void* stream) {
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0 ||
      blocks <= 0 || n_tables < 0 || n_groups <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem64 = static_cast<int64_t>(n_tables) * 12 * n_groups;
  if (smem64 > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem64);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tables > 0) {
    return is_max ? launch<true, true>(vals, gid, n, n_groups, n_tables, keys,
                                       counts, nan_flag, threads, blocks, smem, s)
                  : launch<false, true>(vals, gid, n, n_groups, n_tables, keys,
                                        counts, nan_flag, threads, blocks, smem, s);
  }
  return is_max ? launch<true, false>(vals, gid, n, n_groups, 0, keys, counts,
                                      nan_flag, threads, blocks, 0, s)
                : launch<false, false>(vals, gid, n, n_groups, 0, keys, counts,
                                       nan_flag, threads, blocks, 0, s);
}
