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
//    values[row(e), :], summed in f32, over the bucketed edge stream of
//    bucket_edges_by_block: edges sorted by destination, so one segment's
//    edges are one contiguous run.  A segment with no edges is exactly
//    zero.  bf16 values are summed as they are; f32 values are first
//    rounded to bf16 when round_bf16 is set (the exact=False mode) and
//    taken at full precision otherwise.
//
//    The TPU kernel turns the scatter into one-hot MXU matmuls over node
//    blocks; on this card it is a segmented sum, and what bounds it is
//    bytes: every gathered row is read once (values[E, D] through the row
//    ids), the output written once, ~0.14 ms of HBM time at [1.6M, 128]
//    bf16.  To reach that a warp needs many row loads in flight and wide
//    loads.  The design:
//    - the host prep (ops/segment.py kernel_chunks) lists the stream's real
//      edges in bucketed order (the bucketing's pads carry weight 0 and
//      add nothing, so the walk skips them and needs no weights) with each
//      edge's row and segment, and cuts the walk into CHUNKS of at most
//      256 edges made of whole consecutive segments (empty ones included);
//    - one warp per chunk.  It reads the row and segment ids of 32 edges
//      with one coalesced load each, across segment boundaries, keeps
//      kUnroll row loads a lane in flight, adds them in edge order, and
//      writes a segment's row (and zero rows for the empty segments before
//      the next) when the segment id changes;
//    - vector loads: a lane reads 4 consecutive values of a row at once
//      (8 bytes of bf16, 16 of f32), so 32 lanes cover 128 columns; at
//      D <= 64 each half-warp takes its own row, so one instruction reads
//      two rows and the halves' sums are added when a segment closes.  A
//      row that is not 4-value aligned (D % 4 != 0, or a misaligned base)
//      takes the same walk with scalar loads;
//    - a segment longer than 256 edges (the GAT's node 0 takes every padded
//      neighbor slot, ~158k edges at 100k nodes; they are real edges of
//      the function and are summed) is cut into runs of 256 that write
//      partial rows; a second small kernel adds each long segment's
//      partials in a fixed order, one block per 32-column tile so the sum
//      spreads over several SMs, launched as a programmatic dependent of
//      the first so its launch overlaps the first's tail.  No atomics: the
//      same result on every run, and every output row is written exactly
//      once, so it needs no clearing.
//
//    What still bounds it: at D 128 (256-byte rows) the first pass runs
//    near the HBM rate; at D 44 a gathered row is 88 bytes at a random
//    place, 3-4 sectors of 32 bytes, and the time follows the rows read
//    more than their bytes (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;             // chunks per block in pass 1
constexpr int kColsPerLane = 4;
constexpr int kUnroll = 8;            // row loads in flight per lane
constexpr int kCombineWarps = 32;     // warps per block in pass 2
constexpr int kCombineCols = 8 * kColsPerLane;    // pass 2's column tile
constexpr unsigned kFull = 0xffffffffu;

template <typename T, bool kRound>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16, false>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <>
__device__ __forceinline__ float to_f32<float, false>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float to_f32<float, true>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The four values of `row` this lane covers: columns c .. c + 3 with one
// vector load (kVec: c % 4 == 0, and 4 | d, so all four lie inside or none
// does), else columns c, c + cs, c + 2 cs, c + 3 cs with scalar loads.
template <typename T, bool kRound, bool kVec>
__device__ __forceinline__ void load4(const T* __restrict__ row, int c, int cs, int d,
                                      float v[kColsPerLane]) {
  if constexpr (kVec) {
    if (c < d) {
      if constexpr (sizeof(T) == 2) {
        // A bf16 is the high half of its f32: the lower column sits in
        // the low 16 bits of each word.
        const uint2 u = *reinterpret_cast<const uint2*>(row + c);
        v[0] = __uint_as_float(u.x << 16);
        v[1] = __uint_as_float(u.x & 0xffff0000u);
        v[2] = __uint_as_float(u.y << 16);
        v[3] = __uint_as_float(u.y & 0xffff0000u);
      } else {
        const float4 f = *reinterpret_cast<const float4*>(row + c);
        v[0] = to_f32<T, kRound>(f.x);
        v[1] = to_f32<T, kRound>(f.y);
        v[2] = to_f32<T, kRound>(f.z);
        v[3] = to_f32<T, kRound>(f.w);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) v[j] = 0.0f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int cj = c + j * cs;
      v[j] = cj < d ? to_f32<T, kRound>(row[cj]) : 0.0f;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ row, int c, int cs, int d,
                                       const float v[kColsPerLane]) {
  if constexpr (kVec) {
    if (c < d) *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int cj = c + j * cs;
      if (cj < d) row[cj] = v[j];
    }
  }
}

// Pass 1: one warp per chunk.  kHalf: D <= 64, each half-warp loads its own
// row (two rows an instruction); else the whole warp loads one row, and
// grid.y tiles rows wider than 128 columns.
template <typename T, bool kRound, bool kVec, bool kHalf>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_chunks_kernel(
    const T* __restrict__ values, const int32_t* __restrict__ edge_row,
    const int32_t* __restrict__ edge_seg, const int32_t* __restrict__ chunk_lo,
    const int32_t* __restrict__ chunk_hi, const int32_t* __restrict__ chunk_seg_lo,
    const int32_t* __restrict__ chunk_seg_hi, const int32_t* __restrict__ chunk_slot,
    int n_chunks, float* __restrict__ partial, float* __restrict__ out, int d) {
  constexpr int kLanes = kHalf ? 16 : 32;             // lanes over one row
  constexpr int kStep = 32 / kLanes;                  // rows per load instruction
  constexpr int kTile = kLanes * kColsPerLane;        // columns per grid.y tile
  constexpr int kEdges = kStep * kUnroll;             // edges per batch of loads
  constexpr int cs = kVec ? 1 : kLanes;               // column stride in a lane
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Pass 2 may be scheduled once every block of this grid has started; it
  // still waits for this grid's memory before it reads.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int chunk = blockIdx.x * kWarps + warp;       // warp-uniform
  if (chunk >= n_chunks) return;
  const int part = kHalf ? lane >> 4 : 0;             // which row of a step
  const int sub = kHalf ? lane & 15 : lane;
  const int c = blockIdx.y * kTile + (kVec ? sub * kColsPerLane : sub);
  const int lo = chunk_lo[chunk];
  const int hi = chunk_hi[chunk];
  const int seg_hi = chunk_seg_hi[chunk];
  const int slot = chunk_slot[chunk];
  int cur = chunk_seg_lo[chunk];

  float acc[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) acc[j] = 0.0f;

  // Write segment cur's row (a partial row for a run of a long segment),
  // zero rows for the empty segments up to `next`, and move to `next`.
  auto close = [&](int next) {
    if constexpr (kHalf) {
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], 16);
    }
    if (part == 0) {
      float* dst = slot < 0 ? out + static_cast<long long>(cur) * d
                            : partial + static_cast<long long>(slot) * d;
      store4<kVec>(dst, c, cs, d, acc);
    }
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[j] = 0.0f;
    for (int s = cur + 1 + part; s < next; s += kStep) {
      store4<kVec>(out + static_cast<long long>(s) * d, c, cs, d, acc);
    }
    cur = next;
  };

  for (int base = lo; base < hi; base += 32) {
    const int n = min(32, hi - base);
    int my_row = 0;
    int my_seg = 0;
    if (lane < n) {
      my_row = edge_row[base + lane];
      my_seg = edge_seg[base + lane];
    }
    int k = 0;
    for (; k + kEdges <= n; k += kEdges) {
      float v[kUnroll][kColsPerLane];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = __shfl_sync(kFull, my_row, k + u * kStep + part);
        load4<T, kRound, kVec>(values + r * d, c, cs, d, v[u]);
      }
      // Added in edge order (each half in its own order when kHalf): the
      // sum does not depend on the schedule.
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int p = 0; p < kStep; ++p) {
          const int s = __shfl_sync(kFull, my_seg, k + u * kStep + p);
          if (s != cur) close(s);                     // warp-uniform
          if (part == p) {
#pragma unroll
            for (int j = 0; j < kColsPerLane; ++j) acc[j] += v[u][j];
          }
        }
      }
    }
    for (; k < n; k += kStep) {                       // the batch's tail
      const int e = k + part;
      const long long r = __shfl_sync(kFull, my_row, min(e, n - 1));
      float v[kColsPerLane];
      load4<T, kRound, kVec>(values + r * d, c, cs, d, v);
#pragma unroll
      for (int p = 0; p < kStep; ++p) {
        if (k + p >= n) break;                        // warp-uniform
        const int s = __shfl_sync(kFull, my_seg, k + p);
        if (s != cur) close(s);
        if (part == p) {
#pragma unroll
          for (int j = 0; j < kColsPerLane; ++j) acc[j] += v[j];
        }
      }
    }
  }
  close(seg_hi);
}

// Pass 2: out[long_seg[b]] = sum of partial rows long_first[b] ..
// long_first[b + 1] - 1, one block per long segment and 32-column tile
// (so a long segment's sum spreads over several SMs).  A warp takes four
// rows an instruction (its quarter-warps) with kUnroll instructions in
// flight: lane (r, q) sums rows r, r + 4 kCombineWarps, ... after the
// warp's first, in order; the quarter-warps are then added (xor 8, then
// 16) and warp 0 adds the warps' sums in warp order.  Launched as a
// programmatic dependent of pass 1: it waits for pass 1's memory before
// reading a partial row.
template <bool kVec>
__global__ void __launch_bounds__(kCombineWarps * 32)
segment_sum_combine_kernel(
    const float* __restrict__ partial, const int32_t* __restrict__ long_seg,
    const int32_t* __restrict__ long_first, float* __restrict__ out, int d) {
  __shared__ float s_sum[kCombineWarps][kColsPerLane][8];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = lane >> 3;                        // row of the instruction
  const int q = lane & 7;
  const int b = blockIdx.x;
  const int c = blockIdx.y * kCombineCols + (kVec ? q * kColsPerLane : q);
  constexpr int cs = kVec ? 1 : 8;
  constexpr int kRows = 4 * kCombineWarps;        // rows a block instruction covers
  const int p1 = long_first[b + 1];

  float acc[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) acc[j] = 0.0f;
  for (int p = long_first[b] + 4 * warp + r; p < p1; p += kUnroll * kRows) {
    float v[kUnroll][kColsPerLane];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pu = p + u * kRows;
      if (pu < p1) {
        load4<float, false, kVec>(partial + static_cast<long long>(pu) * d, c, cs, d, v[u]);
      } else {
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) v[u][j] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[j] += v[u][j];
    }
  }
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    acc[j] += __shfl_xor_sync(kFull, acc[j], 8);
    acc[j] += __shfl_xor_sync(kFull, acc[j], 16);
    if (r == 0) s_sum[warp][j][q] = acc[j];
  }
  __syncthreads();
  if (warp != 0 || r != 0) return;
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    float t = 0.0f;
#pragma unroll 8
    for (int w = 0; w < kCombineWarps; ++w) t += s_sum[w][j][q];
    acc[j] = t;
  }
  store4<kVec>(out + static_cast<long long>(long_seg[b]) * d, c, cs, d, acc);
}

struct Chunks {
  const int32_t* edge_row;
  const int32_t* edge_seg;
  const int32_t* lo;
  const int32_t* hi;
  const int32_t* seg_lo;
  const int32_t* seg_hi;
  const int32_t* slot;
  int n;
};

template <typename T, bool kRound, bool kVec, bool kHalf>
cudaError_t launch_chunks(const void* values, const Chunks& ch, float* partial,
                          float* out, int d, cudaStream_t stream) {
  constexpr int kTile = (kHalf ? 16 : 32) * kColsPerLane;
  const dim3 grid((ch.n + kWarps - 1) / kWarps, (d + kTile - 1) / kTile);
  segment_sum_chunks_kernel<T, kRound, kVec, kHalf><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(values), ch.edge_row, ch.edge_seg, ch.lo, ch.hi,
      ch.seg_lo, ch.seg_hi, ch.slot, ch.n, partial, out, d);
  return cudaGetLastError();
}

template <typename T, bool kRound>
cudaError_t launch_for(const void* values, const Chunks& ch, float* partial,
                       float* out, int d, cudaStream_t stream) {
  const bool vec = d % kColsPerLane == 0 &&
                   reinterpret_cast<uintptr_t>(values) % (kColsPerLane * sizeof(T)) == 0;
  const bool half = d <= 16 * kColsPerLane;
  if (vec) {
    return half ? launch_chunks<T, kRound, true, true>(values, ch, partial, out, d, stream)
                : launch_chunks<T, kRound, true, false>(values, ch, partial, out, d, stream);
  }
  return half ? launch_chunks<T, kRound, false, true>(values, ch, partial, out, d, stream)
              : launch_chunks<T, kRound, false, false>(values, ch, partial, out, d, stream);
}

}  // namespace

extern "C" {

// values: [rows, d] row-major, f32 (values_bf16 = 0) or bf16 (1).  The
// walk (n_edges real edges in bucketed order): edge_row, the value row of
// each edge; edge_seg, its segment (non-decreasing).  Chunks (n_chunks):
// the walk's range [lo, hi), the segments [seg_lo, seg_hi) the chunk
// writes, and its partial row (slot, -1: it writes output rows).  Long
// segments (n_long): segment and partial-row range long_first[b] ..
// long_first[b + 1].  out: [num_segments, d] f32; partial: [n_partials, d]
// f32 scratch (null when n_long is 0).
int df_segment_sum(const void* values, int values_bf16, int round_bf16,
                   const int32_t* edge_row, const int32_t* edge_seg,
                   const int32_t* chunk_lo, const int32_t* chunk_hi,
                   const int32_t* chunk_seg_lo, const int32_t* chunk_seg_hi,
                   const int32_t* chunk_slot, int n_chunks,
                   const int32_t* long_seg, const int32_t* long_first, int n_long,
                   float* partial, float* out, int d, void* stream) {
  if (n_chunks < 1 || d < 1 || n_long < 0 || (n_long > 0 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Chunks ch{edge_row, edge_seg, chunk_lo, chunk_hi, chunk_seg_lo,
                  chunk_seg_hi, chunk_slot, n_chunks};
  cudaError_t e;
  if (values_bf16) {
    e = launch_for<__nv_bfloat16, false>(values, ch, partial, out, d, s);
  } else if (round_bf16) {
    e = launch_for<float, true>(values, ch, partial, out, d, s);
  } else {
    e = launch_for<float, false>(values, ch, partial, out, d, s);
  }
  if (e != cudaSuccess || n_long == 0) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_long, (d + kCombineCols - 1) / kCombineCols);
  cfg.blockDim = dim3(kCombineWarps * 32);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // Partial and output rows are fresh f32 allocations: 16-byte aligned
  // whenever 4 | d.
  e = d % kColsPerLane == 0
          ? cudaLaunchKernelEx(&cfg, segment_sum_combine_kernel<true>, partial, long_seg,
                               long_first, out, d)
          : cudaLaunchKernelEx(&cfg, segment_sum_combine_kernel<false>, partial, long_seg,
                               long_first, out, d);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
