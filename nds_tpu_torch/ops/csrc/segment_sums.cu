// Per-group (sum, count) of float32 values by int32 group id, each sum
// accumulated in float64 and rounded once to float32.
//
// Replaces the Pallas TPU kernel `_seg_kernel` / `segment_sums_pallas`
// (nds_tpu/ops/pallas_kernels.py:36, :67). The TPU folds each row tile into
// a one-hot (8 x T) @ (T x G) MXU product because TPU scatters serialize; on
// Hopper the same work is a scatter that reads 8 bytes per row, so it is
// bound by device-memory bytes (n * 8 B over 3.35 TB/s), and atomics in
// shared memory are cheap.
//
// What kept the first port from that bound at the aggregation's shapes
// (2^18 rows, 4,096 groups: 0.6 us of bytes): two memsets before the
// kernel, each block zeroing and flushing a whole table for 2,048 rows, and
// a 32-step shuffle sweep in every mixed warp. The design:
//   * ONE device operation per call, no memset: a cooperative kernel
//     (cudaLaunchCooperativeKernel; the host-side plan
//     gpu_kernels.segment_sums_plan sizes a grid that is co-resident, two
//     blocks per SM at most) zeroes its slice of the outputs, and
//     grid.sync()s before its first global atomic: on the shared-table path
//     only after all its rows are folded, so the barrier's wait overlaps
//     with the streaming of the slower blocks;
//   * streaming shared with segment_extreme.cu (seg_stream.cuh): each thread
//     makes 16-byte loads (four values, four ids), two of each in flight,
//     with the streaming cache hint; an unaligned head and the ragged tail
//     go row by row, and vals and gid misaligned by different amounts load
//     row by row;
//   * per 128 rows a warp takes the smallest and largest live id with two
//     redux instructions: no live row (the dead padding lanes): skip; one
//     group (sorted ids: the aggregation's usual input): a butterfly sum, a
//     redux count and one atomic of each; several groups whose live ids
//     do not decrease along the rows (sorted ids with dead lanes between:
//     runs of ~100 rows, so most warps of the aggregation are mixed): per
//     row slot j, a max-scan over the lanes gives each lane its run's id
//     and a segmented shuffle reduction one atomic per run, because 32
//     lanes adding floats to one shared address serialise (this measured
//     15.9 us at 2^18 rows x 4,096 groups where one atomic per row was
//     left); the four slots' shuffle chains run side by side, since a
//     warp at that shape folds only 256 rows and waits on their latency;
//     ids in no order: each live row goes straight to an atomicAdd on its
//     group's sum and count (no peer sweep);
//   * tables: while 12 bytes per group fit, each block keeps one private
//     table in dynamic shared memory (four per block, one per group of
//     warps, measured no faster: 227.8 vs 232.0 us random, 185.4 vs 176.8
//     us sorted, at 2^26 ids x 1,024 groups on an H100), and flushes only
//     the groups between the smallest and largest id it saw, one global
//     atomic per touched group. Beyond shared memory the same code adds
//     straight into the global arrays.
// Numerics: every add is an f64 add (the warp's shuffles, the shared table,
// a global f64 accumulator); after a last grid barrier each sum is rounded
// once to f32, so two orders of the same rows give the same f32 sum but
// where the f64 sums straddle a rounding boundary (one f32 ulp), and a
// group of one child sums to its child's value (a ROLLUP's levels tie as
// the exact sums do). Counts exact. The TPU kernel accumulated in f32,
// whose error at TPC-DS SF1 group sizes (~1e5 rows) passed the NDS
// validator's 1e-5 epsilon neither against a second order of the same f32
// adds nor under cancellation: in a generated SF1 stream of 103
// statements, 3 failed validate between an H100 and the CPU. A gid outside
// [0, n_groups) is a dead row and contributes nothing (its value is never
// read into a sum, NaN or not).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "seg_stream.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kStaticSmem = 16;  // s_lo, s_hi (gpu_kernels._SUMS_STATIC_SMEM)
constexpr unsigned kFull = 0xffffffffu;

struct Tables {
  double* sum;
  int32_t* cnt;
};

// Fold four rows per lane into the tables; widen [lo, hi] to the live ids
// seen. Warp-collective: all 32 lanes call it together (a lane with no
// rows passes dead ids).
__device__ __forceinline__ void fold4(const float4 v4, const int4 g4,
                                      int n_groups, const Tables& t, int& lo,
                                      int& hi) {
  const float v[4] = {v4.x, v4.y, v4.z, v4.w};
  const int g[4] = {g4.x, g4.y, g4.z, g4.w};
  int l = INT_MAX, h = -1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (static_cast<unsigned>(g[j]) < static_cast<unsigned>(n_groups)) {
      l = min(l, g[j]);
      h = max(h, g[j]);
    }
  }
  const int wh = __reduce_max_sync(kFull, h);
  if (wh < 0) return;  // no live row in these 128
  const int wl = __reduce_min_sync(kFull, l);
  lo = min(lo, wl);
  hi = max(hi, wh);
  if (wl == wh) {
    double s = 0.0;
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (g[j] == wl) {
        s += v[j];
        ++c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    c = __reduce_add_sync(kFull, c);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(&t.sum[wl], s);
      atomicAdd(&t.cnt[wl], static_cast<int32_t>(c));
    }
    return;
  }
  // Several groups. Row j of every lane (rows 4 * lane + j) in order: where
  // their live ids do not decrease (sorted ids, dead lanes in between), a
  // segmented shuffle reduction leaves one atomic per run of one id; the
  // four row slots go through it side by side (independent shuffle chains).
  // Otherwise (ids in no order) each live row makes its own atomics.
  const int lane = threadIdx.x & 31;
  bool live[4];
  bool mono = true;  // first a lane-local test: ids in no order pay no scan
  int last = -1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    live[j] = static_cast<unsigned>(g[j]) < static_cast<unsigned>(n_groups);
    if (live[j]) {
      mono = mono && g[j] >= last;
      last = g[j];
    }
  }
  if (__all_sync(kFull, mono)) {
    // run id: the largest live id at or before this lane (-1 before any)
    int key[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) key[j] = live[j] ? g[j] : -1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = __shfl_up_sync(kFull, key[j], off);
        if (lane >= off) key[j] = max(key[j], k);
      }
    }
    bool sorted = true;
#pragma unroll
    for (int j = 0; j < 4; ++j) sorted = sorted && (!live[j] || key[j] == g[j]);
    if (__all_sync(kFull, sorted)) {
      double s[4];
      int c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = live[j] ? static_cast<double>(v[j]) : 0.0;
        c[j] = live[j] ? 1 : 0;
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const double ts = __shfl_down_sync(kFull, s[j], off);
          const int tc = __shfl_down_sync(kFull, c[j], off);
          const int tk = __shfl_down_sync(kFull, key[j], off);
          if (lane + off < 32 && tk == key[j]) {
            s[j] += ts;
            c[j] += tc;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int prev = __shfl_up_sync(kFull, key[j], 1);
        if (key[j] >= 0 && (lane == 0 || prev != key[j])) {  // run's first lane
          atomicAdd(&t.sum[key[j]], s[j]);
          atomicAdd(&t.cnt[key[j]], c[j]);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (live[j]) {
      atomicAdd(&t.sum[g[j]], static_cast<double>(v[j]));
      atomicAdd(&t.cnt[g[j]], 1);
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 2)
    seg_sums_kernel(const float* __restrict__ vals,
                    const int32_t* __restrict__ gid, int64_t n, int n_groups,
                    float* __restrict__ sums,
                    int32_t* __restrict__ counts,
                    double* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_lo, s_hi;
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  double* tsum = reinterpret_cast<double*>(smem);
  int32_t* tcnt = reinterpret_cast<int32_t*>(tsum + n_groups);

  // this block's slice of the accumulator and the counts
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = tid; g < n_groups; g += stride) {
    acc[g] = 0.0;
    counts[g] = 0;
  }
  Tables t{acc, counts};
  if (kShared) {
    for (int i = threadIdx.x; i < n_groups; i += kThreads) {
      tsum[i] = 0.0;
      tcnt[i] = 0;
    }
    if (threadIdx.x == 0) {
      s_lo = INT_MAX;
      s_hi = -1;
    }
    t = Tables{tsum, tcnt};
    __syncthreads();
  } else {
    grid.sync();  // every entry zeroed before the first global atomic
  }

  int lo = INT_MAX, hi = -1;
  auto fold = [&](const float4 v, const int4 g) {
    fold4(v, g, n_groups, t, lo, hi);
  };
  seg_stream::for_each_chunk(vals, gid, n, fold);

  if (kShared) {
    if (lane == 0 && hi >= 0) {
      atomicMin(&s_lo, lo);
      atomicMax(&s_hi, hi);
    }
    __syncthreads();
    grid.sync();  // every entry zeroed before the first global atomic
    const int g_lo = s_hi >= 0 ? s_lo : 0, g_hi = s_hi;  // none: no flush
    for (int g = g_lo + threadIdx.x; g <= g_hi; g += kThreads) {
      if (tcnt[g]) {
        atomicAdd(&acc[g], tsum[g]);
        atomicAdd(&counts[g], tcnt[g]);
      }
    }
  }
  grid.sync();  // every add in: round each sum once
  for (int64_t g = tid; g < n_groups; g += stride)
    sums[g] = static_cast<float>(acc[g]);
}

template <bool kShared>
int launch(const float* vals, const int32_t* gid, int64_t n, int n_groups,
           float* sums, int32_t* counts, double* acc, int blocks,
           int smem, cudaStream_t s) {
  // the 48 KB a block gets without the opt-in holds the static s_lo / s_hi
  // too: a 4,096-group table (48 KB of 12-byte entries) needs the opt-in
  if (smem + kStaticSmem > 48 * 1024) {
    static int granted = 48 * 1024 - kStaticSmem;  // per instantiation
    if (smem > granted) {
      const cudaError_t e = cudaFuncSetAttribute(
          seg_sums_kernel<kShared>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      granted = smem;
    }
  }
  void* args[] = {&vals, &gid, &n, &n_groups, &sums, &counts, &acc};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(seg_sums_kernel<kShared>), dim3(blocks),
      dim3(kThreads), args, static_cast<size_t>(smem), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sums/counts: any contents, every entry written; acc: n_groups doubles of
// scratch, any contents (the f64 sums before rounding). shared = 1 selects the
// shared-memory table (12 * n_groups bytes per block, beside 16 bytes of
// static shared memory), 0 the global path. `blocks` must be co-resident
// (the plan's grid); a grid that is not is refused by the runtime and its
// error returned. Returns cudaGetLastError() or the refused call's error.
extern "C" int seg_sums_launch(const float* vals, const int32_t* gid,
                               int64_t n, int n_groups, float* sums,
                               int32_t* counts, double* acc, int shared,
                               int blocks, void* stream) {
  if (n_groups <= 0 || blocks <= 0 || (shared != 0 && shared != 1) || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem64 = static_cast<int64_t>(shared) * 12 * n_groups;
  if (smem64 > 232448 - 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared)
    return launch<true>(vals, gid, n, n_groups, sums, counts, acc, blocks,
                        static_cast<int>(smem64), s);
  return launch<false>(vals, gid, n, n_groups, sums, counts, acc, blocks, 0,
                       s);
}
