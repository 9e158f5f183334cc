// Streaming of (float32 value, int32 group id) rows over a persistent grid,
// shared by segment_sums.cu and segment_extreme.cu; only their folds differ.
//
// Each thread makes 16-byte loads (four values, four ids), kUnroll of each
// in flight before it folds any, with the streaming cache hint. Chunks of
// four rows are dealt to warps in turn, 32 * kUnroll chunks a warp, so a
// warp folds 128 consecutive rows per call. When vals and gid share their
// misalignment (both fresh, or both sliced alike) the 16-byte loads start
// after a head of up to three rows; the head and the ragged tail (< 4 rows)
// go row by row through warp 0 of block 0 at the end. When they are
// misaligned by different amounts, every chunk of four loads row by row.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace seg_stream {

constexpr int kUnroll = 2;  // 16-byte loads in flight per array per thread

// Calls fold(float4 v, int4 g) on every row of [0, n) exactly once, four
// rows per lane. fold is warp-collective: all 32 lanes of a warp call it
// together, and a lane with no rows (or fewer than four) passes dead ids
// (-1) in their place.
template <typename Fold>
__device__ __forceinline__ void for_each_chunk(const float* __restrict__ vals,
                                               const int32_t* __restrict__ gid,
                                               int64_t n, Fold& fold) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uintptr_t av = reinterpret_cast<uintptr_t>(vals);
  const uintptr_t ag = reinterpret_cast<uintptr_t>(gid);
  const bool vec = ((av ^ ag) & 15) == 0;
  int64_t head = vec ? static_cast<int64_t>(((16 - (av & 15)) & 15) >> 2) : 0;
  if (head > n) head = n;
  const int64_t n_chunks = vec ? (n - head) >> 2 : (n + 3) >> 2;
  const float4* v4 = reinterpret_cast<const float4*>(vals + head);
  const int4* g4 = reinterpret_cast<const int4*>(gid + head);

  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  const int64_t step = warps * 32 * kUnroll;
  for (int64_t c0 = (static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp) *
                    32 * kUnroll;
       c0 < n_chunks; c0 += step) {
    float4 v[kUnroll];
    int4 g[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t c = c0 + u * 32 + lane;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      g[u] = make_int4(-1, -1, -1, -1);
      if (c < n_chunks) {
        if (vec) {
          v[u] = __ldcs(v4 + c);
          g[u] = __ldcs(g4 + c);
        } else {
          const int64_t r = 4 * c;
          float* vp = &v[u].x;
          int* gp = &g[u].x;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (r + j < n) {
              vp[j] = __ldcs(vals + r + j);
              gp[j] = __ldcs(gid + r + j);
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) fold(v[u], g[u]);
  }

  // The rows the 16-byte chunks left out: the head before the first aligned
  // chunk (lanes 0..3) and the ragged tail after the last (lanes 4..7).
  if (vec && blockIdx.x == 0 && warp == 0) {
    const int64_t tail0 = head + 4 * n_chunks;
    int64_t r = -1;
    if (lane < 4 && lane < head) r = lane;
    else if (lane >= 4 && lane < 8 && tail0 + (lane - 4) < n) r = tail0 + (lane - 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    int4 g = make_int4(-1, -1, -1, -1);
    if (r >= 0) {
      v.x = vals[r];
      g.x = gid[r];
    }
    fold(v, g);
  }
}

}  // namespace seg_stream
