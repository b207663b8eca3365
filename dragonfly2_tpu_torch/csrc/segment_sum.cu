// Hand-written Hopper (sm_90a) segment sum: the GAT trainer's neighbor
// gather backward.
//
// Plain C interface, loaded with ctypes (ops/_build.py).  The entry
// launches on the caller's stream, allocates nothing (the wrapper passes
// the output and the partial-sum scratch), and returns cudaGetLastError()
// so a refused launch is reported at once.
//
// K3 segment_sum replaces dragonfly2_tpu/ops/pallas_segment.py:98
//    _segment_kernel (launched at :232 by _segment_sum_bucketed; entries
//    segment_sum_pallas :142 and the backward of make_neighbor_gather
//    :282).  It computes out[s, :] = sum over the edges e of segment s of
//    w[e] * values[perm[e], :], summed in f32, over the bucketed edge
//    stream of bucket_edges_by_block: edges sorted by destination, so one
//    segment's edges are one contiguous run.  A segment with no edges is
//    exactly zero.  bf16 values are summed as they are; f32 values are
//    first rounded to bf16 when round_bf16 is set (the exact=False mode)
//    and taken at full precision otherwise.
//
//    The TPU kernel turns the scatter into one-hot MXU matmuls over node
//    blocks; on this card it is a segmented sum, and what bounds it is
//    bytes: every gathered row is read once (values[E, D] through perm),
//    the output written once, ~0.14 ms of HBM time at [1.6M, 128] bf16.
//    The design:
//    - one warp per work item, a work item being a run of at most
//      max_run edges of ONE segment (host prep, ops/segment.py).  The
//      warp walks its run in order with the lanes over 128 columns
//      (grid.y tiles wider rows; any D >= 1 is masked), so no atomics
//      and the same result on every run;
//    - lanes load 32 perm/w entries at once and shuffle them out, and
//      each lane keeps kUnroll rows of loads in flight before it adds;
//    - a long run (the GAT's node 0 takes every padded neighbor slot,
//      ~158k edges at 100k nodes) is split into many work items that
//      write partial rows; a second small kernel sums each long
//      segment's partials in a fixed order (warps over partials, then a
//      shared-memory sum over warps).  Short segments are written by
//      pass 1 directly, so every output row is written exactly once and
//      the output needs no clearing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;             // work items per block in pass 1
constexpr int kColsPerLane = 4;
constexpr int kTileCols = 32 * kColsPerLane;   // 128 columns per grid.y tile
constexpr int kUnroll = 8;            // rows in flight per lane
constexpr int kCombineWarps = 16;     // warps per long segment in pass 2
constexpr unsigned kFull = 0xffffffffu;

template <typename T, bool kRound>
__device__ __forceinline__ float load_value(const T* p);

template <>
__device__ __forceinline__ float load_value<__nv_bfloat16, false>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <>
__device__ __forceinline__ float load_value<float, false>(const float* p) {
  return *p;
}

template <>
__device__ __forceinline__ float load_value<float, true>(const float* p) {
  return __bfloat162float(__float2bfloat16_rn(*p));
}

template <typename T, bool kRound>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_runs_kernel(
    const T* __restrict__ values, const int32_t* __restrict__ perm,
    const float* __restrict__ w, const int32_t* __restrict__ item_seg,
    const int32_t* __restrict__ item_lo, const int32_t* __restrict__ item_hi,
    const int32_t* __restrict__ item_slot, int n_items,
    float* __restrict__ partial, float* __restrict__ out, int d) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + warp;   // warp-uniform
  if (item >= n_items) return;
  const int col0 = blockIdx.y * kTileCols;
  const int lo = item_lo[item];
  const int hi = item_hi[item];

  float acc[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) acc[j] = 0.0f;

  for (int base = lo; base < hi; base += 32) {
    const int n = min(32, hi - base);
    int my_row = 0;
    float my_w = 0.0f;
    if (lane < n) {
      my_row = perm != nullptr ? perm[base + lane] : base + lane;
      my_w = w[base + lane];
    }
    int k = 0;
    for (; k + kUnroll <= n; k += kUnroll) {
      float v[kUnroll][kColsPerLane];
      float wk[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = __shfl_sync(kFull, my_row, k + u);
        wk[u] = __shfl_sync(kFull, my_w, k + u);
        const T* row = values + r * d;
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          const int c = col0 + j * 32 + lane;
          v[u][j] = c < d ? load_value<T, kRound>(row + c) : 0.0f;
        }
      }
      // Added in edge order: the sum does not depend on the schedule.
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) acc[j] = fmaf(wk[u], v[u][j], acc[j]);
      }
    }
    for (; k < n; ++k) {
      const long long r = __shfl_sync(kFull, my_row, k);
      const float wk = __shfl_sync(kFull, my_w, k);
      const T* row = values + r * d;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int c = col0 + j * 32 + lane;
        if (c < d) acc[j] = fmaf(wk, load_value<T, kRound>(row + c), acc[j]);
      }
    }
  }

  const int slot = item_slot[item];
  float* dst = slot < 0 ? out + static_cast<long long>(item_seg[item]) * d
                        : partial + static_cast<long long>(slot) * d;
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    const int c = col0 + j * 32 + lane;
    if (c < d) dst[c] = acc[j];
  }
}

// Pass 2: out[long_seg[b]] = sum of partial rows long_first[b] ..
// long_first[b + 1] - 1.  Warp q sums rows q, q + kCombineWarps, ... in
// order; warp 0 then adds the warps' sums in warp order.
__global__ void __launch_bounds__(kCombineWarps * 32)
segment_sum_combine_kernel(
    const float* __restrict__ partial, const int32_t* __restrict__ long_seg,
    const int32_t* __restrict__ long_first, float* __restrict__ out, int d) {
  __shared__ float s_sum[kCombineWarps][kTileCols];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int col0 = blockIdx.y * kTileCols;
  const int p0 = long_first[b];
  const int p1 = long_first[b + 1];

  float acc[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) acc[j] = 0.0f;
#pragma unroll 4
  for (int p = p0 + warp; p < p1; p += kCombineWarps) {
    const float* row = partial + static_cast<long long>(p) * d;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int c = col0 + j * 32 + lane;
      if (c < d) acc[j] += row[c];
    }
  }
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) s_sum[warp][j * 32 + lane] = acc[j];
  __syncthreads();
  if (warp != 0) return;
  float* dst = out + static_cast<long long>(long_seg[b]) * d;
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    float t = 0.0f;
    for (int q = 0; q < kCombineWarps; ++q) t += s_sum[q][j * 32 + lane];
    const int c = col0 + j * 32 + lane;
    if (c < d) dst[c] = t;
  }
}

template <typename T, bool kRound>
cudaError_t launch_runs(const void* values, const int32_t* perm, const float* w,
                        const int32_t* item_seg, const int32_t* item_lo,
                        const int32_t* item_hi, const int32_t* item_slot,
                        int n_items, float* partial, float* out, int d,
                        cudaStream_t stream) {
  const dim3 grid((n_items + kWarps - 1) / kWarps, (d + kTileCols - 1) / kTileCols);
  segment_sum_runs_kernel<T, kRound><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(values), perm, w, item_seg, item_lo, item_hi,
      item_slot, n_items, partial, out, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// values: [rows, d] row-major, f32 (values_bf16 = 0) or bf16 (1); perm:
// [E_pad] row of each bucketed edge, or null when values are already in
// the bucketed layout; w: [E_pad] edge weights.  Work items (n_items,
// one per short segment or per run of a long one): segment, bucketed
// range [lo, hi), and partial row (-1: write the output row directly).
// Long segments (n_long): segment and partial-row range
// long_first[b] .. long_first[b + 1].  out: [num_segments, d] f32;
// partial: [n_partials, d] f32 scratch (null when n_long is 0).
int df_segment_sum(const void* values, int values_bf16, int round_bf16,
                   const int32_t* perm, const float* w,
                   const int32_t* item_seg, const int32_t* item_lo,
                   const int32_t* item_hi, const int32_t* item_slot,
                   int n_items, const int32_t* long_seg,
                   const int32_t* long_first, int n_long, float* partial,
                   float* out, int d, void* stream) {
  if (n_items < 1 || d < 1 || n_long < 0 || (n_long > 0 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (values_bf16) {
    e = launch_runs<__nv_bfloat16, false>(values, perm, w, item_seg, item_lo,
                                          item_hi, item_slot, n_items, partial,
                                          out, d, s);
  } else if (round_bf16) {
    e = launch_runs<float, true>(values, perm, w, item_seg, item_lo, item_hi,
                                 item_slot, n_items, partial, out, d, s);
  } else {
    e = launch_runs<float, false>(values, perm, w, item_seg, item_lo, item_hi,
                                  item_slot, n_items, partial, out, d, s);
  }
  if (e != cudaSuccess || n_long == 0) return static_cast<int>(e);
  const dim3 grid(n_long, (d + kTileCols - 1) / kTileCols);
  segment_sum_combine_kernel<<<grid, kCombineWarps * 32, 0, s>>>(
      partial, long_seg, long_first, out, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
