// Dense-domain join build tables: per key slot in [0, table_cap), a presence
// flag and the maximum build-row index whose key - rmin lands there.
//
// Replaces the Pallas TPU kernel `_dense_build_kernel` / `dense_build_pallas`
// (nds_tpu/ops/pallas_kernels.py:169, :198), which builds a one-hot slot
// mask per row tile in VMEM and folds integer maxima per domain tile, because
// TPU scatter-max serializes.
//
// What bounds it on Hopper: at a star join's shapes (a few thousand filtered
// dimension rows, a table of 2^18 slots) the bytes are tiny (9 per build row
// read, 5 per slot written: ~0.4 us at 3.35 TB/s), so a call is bound by its
// launches and the host work around them, not by bandwidth. A zero-fill
// before a scatter doubles the launches. So every call is ONE device
// operation and no memset.
//
// Outputs (int32 rows[cap_pad] and uint8 presence[cap_pad], cap_pad =
// table_cap rounded up to 16, allocated by the wrapper with torch.empty and
// never zeroed by the caller): the kernel writes every slot. Empty slots
// hold (presence 0, row 0), as the TPU kernel returns them.
//
// The host-side plan (gpu_kernels.dense_build_plan) picks a path from
// (n, table_cap): the owner path while n <= DENSE_OWNER_MAX_ROWS and
// n * n_ctas (build keys read over all CTAs) <= DENSE_OWNER_MAX_READS, else
// the cooperative path. Both limits come from chip_smoke.py's kernel_sweep,
// which times the two paths on both sides of them.
//   * owner (path 0), for small build sides (q3's 4,096 item rows): each CTA
//     owns `slots` consecutive slots and keeps their row maxima in shared
//     memory (initialised to -1 = empty). It reads ALL build keys and live
//     flags, kBatch rows per thread in flight at once (straight into
//     registers: staging them through a cp.async ring in shared memory
//     measured slower on the card, its per-tile waits and barriers costing
//     more than the loads), and folds each live row whose slot is its own
//     with a shared-memory atomicMax. It then writes its whole range of rows
//     and presence, empty slots included, with 16-byte stores. No global
//     atomics; the result is exact and deterministic. Its cost grows with
//     n times the CTA count, hence the limits.
//   * cooperative (path 1), for large build sides: one persistent kernel
//     launched with cudaLaunchCooperativeKernel on a grid sized from
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor zeroes both tables with
//     16-byte stores, grid.sync()s, then scatters (global atomicMax of the
//     row index, presence byte store). A grid that cannot be co-resident is
//     refused by the runtime and the error is returned, never worked around.
//     (A memset before the same scatter measured no faster at 2^21 rows and
//     slots, in three device operations against one.)
// Duplicate keys keep the largest row index (both JAX formulations do);
// dead rows and keys outside [rmin, rmin + table_cap) never match. Keys and
// live flags are read one element at a time, so any slice is accepted.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 16;  // build rows per thread in flight (owner path)

// Path 0. Dynamic shared memory: int32 s_rows[slots].
__global__ void __launch_bounds__(kThreads)
    dense_build_owner_kernel(const int64_t* __restrict__ rkey,
                             const uint8_t* __restrict__ rlive, int64_t n,
                             int64_t rmin, int64_t table_cap, int slots,
                             int32_t* __restrict__ rows,
                             uint8_t* __restrict__ presence) {
  extern __shared__ __align__(16) int32_t s_rows[];
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * slots;
  const int64_t rem = table_cap - s0;
  const int span = static_cast<int>(rem < slots ? rem : slots);
  for (int j = threadIdx.x; j < slots; j += blockDim.x) s_rows[j] = -1;
  __syncthreads();

  const uint64_t base = static_cast<uint64_t>(rmin) + static_cast<uint64_t>(s0);
  for (int64_t b0 = 0; b0 < n; b0 += kBatch * kThreads) {
    int64_t key[kBatch];
    uint8_t live[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t i = b0 + u * kThreads + threadIdx.x;
      key[u] = 0;
      live[u] = 0;
      if (i < n) {
        key[u] = __ldg(rkey + i);
        live[u] = __ldg(rlive + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      // (key - rmin - s0) with int64 wrap-around, as the plain version's
      // torch arithmetic: below s0 wraps to a huge unsigned value
      const uint64_t slot = static_cast<uint64_t>(key[u]) - base;
      if (live[u] && slot < static_cast<uint64_t>(span))
        atomicMax(&s_rows[slot],
                  static_cast<int32_t>(b0 + u * kThreads + threadIdx.x));
    }
  }
  __syncthreads();

  // Whole range, empty slots included, rounded up to 16 slots (the tables
  // are cap_pad long, and s_rows past `span` still hold -1).
  const int pad = (span + 15) & ~15;
  int4* rows4 = reinterpret_cast<int4*>(rows + s0);
  for (int q = threadIdx.x; q < pad / 4; q += blockDim.x) {
    const int4 r = reinterpret_cast<const int4*>(s_rows)[q];
    rows4[q] = make_int4(max(r.x, 0), max(r.y, 0), max(r.z, 0), max(r.w, 0));
  }
  uint4* pres16 = reinterpret_cast<uint4*>(presence + s0);
  for (int q = threadIdx.x; q < pad / 16; q += blockDim.x) {
    uint32_t w[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int4 r = reinterpret_cast<const int4*>(s_rows)[4 * q + b];
      w[b] = (r.x >= 0 ? 1u : 0u) | (r.y >= 0 ? 1u << 8 : 0u) |
             (r.z >= 0 ? 1u << 16 : 0u) | (r.w >= 0 ? 1u << 24 : 0u);
    }
    pres16[q] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Path 1: zero both tables, grid.sync(), scatter.
__global__ void __launch_bounds__(kThreads)
    dense_build_coop_kernel(const int64_t* __restrict__ rkey,
                            const uint8_t* __restrict__ rlive, int64_t n,
                            int64_t rmin, int64_t table_cap, int64_t cap_pad,
                            int32_t* __restrict__ rows,
                            uint8_t* __restrict__ presence) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint4* zr = reinterpret_cast<uint4*>(rows);
  uint4* zp = reinterpret_cast<uint4*>(presence);
  for (int64_t i = tid; i < cap_pad / 4; i += stride)
    zr[i] = make_uint4(0, 0, 0, 0);
  for (int64_t i = tid; i < cap_pad / 16; i += stride)
    zp[i] = make_uint4(0, 0, 0, 0);
  cg::this_grid().sync();
  for (int64_t i = tid; i < n; i += stride) {
    if (!rlive[i]) continue;
    const uint64_t slot = static_cast<uint64_t>(rkey[i]) - static_cast<uint64_t>(rmin);
    if (slot >= static_cast<uint64_t>(table_cap)) continue;
    atomicMax(&rows[slot], static_cast<int32_t>(i));
    presence[slot] = 1;  // every writer stores the same byte
  }
}

}  // namespace

// rows (4 * cap_pad bytes) and presence (cap_pad bytes): 16-byte aligned,
// any contents. path 0 = owner (grid = ceil(table_cap / slots) CTAs), 1 =
// cooperative. Returns cudaGetLastError() or the refused launch's error.
extern "C" int dense_build_launch(const int64_t* rkey, const uint8_t* rlive,
                                  int64_t n, int64_t rmin, int64_t table_cap,
                                  int64_t cap_pad, int32_t* rows,
                                  uint8_t* presence, int path, int slots,
                                  int n_sm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_cap <= 0 || cap_pad % 16 != 0 || cap_pad < table_cap)
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 0) {
    // 48 KB of shared memory at most: no attribute to raise
    if (slots <= 0 || slots % 16 != 0 || slots > 48 * 1024 / 4)
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t grid = (table_cap + slots - 1) / slots;
    dense_build_owner_kernel<<<static_cast<unsigned>(grid), kThreads,
                               slots * 4, s>>>(
        rkey, rlive, n, rmin, table_cap, slots, rows, presence);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t work = n > cap_pad / 4 ? n : cap_pad / 4;
  const int64_t want = (work + kThreads - 1) / kThreads;
  if (path == 1) {
    static int per_sm = 0;  // the same for every call: cache it
    if (per_sm == 0) {
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dense_build_coop_kernel, kThreads, 0);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int64_t most = static_cast<int64_t>(per_sm) * n_sm;
    const int grid = static_cast<int>(want < most ? want : most);
    void* args[] = {&rkey, &rlive, &n, &rmin, &table_cap, &cap_pad, &rows,
                    &presence};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(dense_build_coop_kernel),
        dim3(grid > 0 ? grid : 1), dim3(kThreads), args, 0, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
