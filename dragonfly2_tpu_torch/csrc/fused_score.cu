// Hand-written Hopper (sm_90a) kernels of the scheduler's scoring path.
//
// Plain C interface, loaded with ctypes (ops/_build.py).  Every entry
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported at once.
//
// K1 fused_gather_mlp_score replaces dragonfly2_tpu/ops/pallas_score.py:114
//    _fused_score_kernel (launched at :213 by _fused_score_call).  For each
//    row r it gathers child = M[dslots[r]] and parent = M[slots[r]] out of
//    the [S, 12] f32 slot matrix and runs the mask-folded 32->d1->d2->1
//    tanh-gelu MLP: h1 = gelu([child | parent | edge] @ W0 + b0),
//    h2 = gelu(h1 @ W1 + b1), out = h2 @ W2 + b2.
//
//    What bounds it on this card: nothing the card is short of.  At the
//    serving shape (<= 512 rows, d1 = d2 = 64) a call moves ~140 B and does
//    ~12.4 kFLOP a row, plus ~25 KB of weights: well under a microsecond of
//    memory or f32 time, so it is bound by launch latency.  The design
//    therefore keeps it to ONE launch that needs nothing else: the gather,
//    the split first layer (the [n, 32] concat is never built) and the gelu
//    stack all run in one block per tile of rows, and no scratch leaves the
//    SM.  Each block stages the weights in shared memory (one read of
//    ~25 KB from L2); each warp scores one row at a time with its lanes
//    over the hidden units and h1 in shared memory.  The ragged last tile
//    is masked, so the kernel takes any n >= 1 and does not depend on the
//    caller's padding.  An out-of-range slot id never reads outside the
//    matrix: its row scores NaN (callers check the ids on the host first).
//
// K2 rule_weighted_sum replaces dragonfly2_tpu/ops/pallas_score.py:364
//    _rule_sum_kernel (launched at :375): out[r] = components[r, :] . w for
//    the six rule-component weights.  One thread per row; bound by launch
//    latency at every serving size (24 B in, 4 B out a row).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHostDim = 12;                      // HOST_FEATURE_DIM
constexpr int kEdgeDim = 8;                       // EDGE_FEATURE_DIM
constexpr int kInDim = 2 * kHostDim + kEdgeDim;   // 32: one lane per input
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kInDim == 32, "the first layer maps one input feature per lane");

// gelu, tanh form, exactly the serving formula (trainer/export._np_gelu):
// x * x * x, never powf.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = x * x * x;
  return 0.5f * x * (1.0f + tanhf(0.7978845608f * (x + 0.044715f * x3)));
}

__global__ void __launch_bounds__(kWarps * 32)
fused_gather_mlp_score_kernel(
    const float* __restrict__ mat, long long n_slots,
    const int32_t* __restrict__ slots, const int32_t* __restrict__ dslots,
    const float* __restrict__ edge,
    const float* __restrict__ w0c, const float* __restrict__ w0p,
    const float* __restrict__ w0e, const float* __restrict__ b0,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ out, int n, int d1, int d2) {
  extern __shared__ float smem[];
  float* s_w0 = smem;                      // [32][d1]: child, parent, edge rows
  float* s_b0 = s_w0 + kInDim * d1;        // [d1]
  float* s_w1 = s_b0 + d1;                 // [d1][d2]
  float* s_b1 = s_w1 + d1 * d2;            // [d2]
  float* s_w2 = s_b1 + d2;                 // [d2]
  float* s_h1 = s_w2 + d2;                 // [kWarps][d1]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int i = tid; i < kHostDim * d1; i += nthreads) {
    s_w0[i] = w0c[i];
    s_w0[kHostDim * d1 + i] = w0p[i];
  }
  for (int i = tid; i < kEdgeDim * d1; i += nthreads) s_w0[2 * kHostDim * d1 + i] = w0e[i];
  for (int i = tid; i < d1; i += nthreads) s_b0[i] = b0[i];
  for (int i = tid; i < d1 * d2; i += nthreads) s_w1[i] = w1[i];
  for (int i = tid; i < d2; i += nthreads) {
    s_b1[i] = b1[i];
    s_w2[i] = w2[i];
  }
  __syncthreads();

  const float bias2 = b2[0];
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* h1 = s_h1 + warp * d1;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;

  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;            // warp-uniform from here on
    if (row >= n) break;
    const long long ps = slots[row];
    const long long cs = dslots[row];
    if (ps < 0 || ps >= n_slots || cs < 0 || cs >= n_slots) {
      if (lane == 0) out[row] = __int_as_float(0x7fc00000);  // NaN
      continue;
    }
    // Lane k holds input feature k of the [child | parent | edge] row.
    float x;
    if (lane < kHostDim) {
      x = mat[cs * kHostDim + lane];
    } else if (lane < 2 * kHostDim) {
      x = mat[ps * kHostDim + (lane - kHostDim)];
    } else {
      x = edge[static_cast<long long>(row) * kEdgeDim + (lane - 2 * kHostDim)];
    }
    float xs[kInDim];
#pragma unroll
    for (int k = 0; k < kInDim; ++k) xs[k] = __shfl_sync(kFull, x, k);

    // Layer 1, lanes over hidden units: the split first layer's three
    // partial products (child, parent, edge), summed in that order.
    for (int j = lane; j < d1; j += 32) {
      float part[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kInDim; ++k) {
        const int p = k < kHostDim ? 0 : (k < 2 * kHostDim ? 1 : 2);
        part[p] = fmaf(xs[k], s_w0[k * d1 + j], part[p]);
      }
      h1[j] = gelu_tanh(part[0] + part[1] + part[2] + s_b0[j]);
    }
    __syncwarp();

    // Layer 2 and the scalar head: each lane's units, then a warp sum.
    float part = 0.0f;
    for (int j = lane; j < d2; j += 32) {
      float acc = 0.0f;
      for (int k = 0; k < d1; ++k) acc = fmaf(h1[k], s_w1[k * d2 + j], acc);
      part = fmaf(gelu_tanh(acc + s_b1[j]), s_w2[j], part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
    if (lane == 0) out[row] = part + bias2;
    __syncwarp();                        // h1 is rewritten by the next row
  }
}

__global__ void rule_weighted_sum_kernel(
    const float* __restrict__ comp, float* __restrict__ out, int n,
    float w0, float w1, float w2, float w3, float w4, float w5) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* c = comp + static_cast<long long>(i) * 6;
  float acc = c[0] * w0;
  acc = fmaf(c[1], w1, acc);
  acc = fmaf(c[2], w2, acc);
  acc = fmaf(c[3], w3, acc);
  acc = fmaf(c[4], w4, acc);
  acc = fmaf(c[5], w5, acc);
  out[i] = acc;
}

}  // namespace

extern "C" {

// Shared memory K1 needs for hidden widths d1, d2 (bytes).
size_t df_fused_score_smem_bytes(int d1, int d2) {
  return sizeof(float) *
         (static_cast<size_t>(kInDim) * d1 + d1 + static_cast<size_t>(d1) * d2 +
          2 * static_cast<size_t>(d2) + static_cast<size_t>(kWarps) * d1);
}

int df_fused_gather_mlp_score(
    const float* mat, long long n_slots, const int32_t* slots,
    const int32_t* dslots, const float* edge, const float* w0c,
    const float* w0p, const float* w0e, const float* b0, const float* w1,
    const float* b1, const float* w2, const float* b2, float* out, int n,
    int d1, int d2, void* stream) {
  if (n < 1 || d1 < 1 || d2 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = df_fused_score_smem_bytes(d1, d2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_gather_mlp_score_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  fused_gather_mlp_score_kernel<<<blocks, kWarps * 32, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      mat, n_slots, slots, dslots, edge, w0c, w0p, w0e, b0, w1, b1, w2, b2,
      out, n, d1, d2);
  return static_cast<int>(cudaGetLastError());
}

int df_rule_weighted_sum(const float* comp, float* out, int n, float w0,
                         float w1, float w2, float w3, float w4, float w5,
                         void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  rule_weighted_sum_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      comp, out, n, w0, w1, w2, w3, w4, w5);
  return static_cast<int>(cudaGetLastError());
}

const char* df_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
