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
//    What bounds it on this card: latency, not bytes or operations.  At the
//    serving shape (128-512 rows, d1 = d2 = 64) a call moves ~140 B and does
//    ~12.4 kFLOP a row, plus ~27 KB of weights: well under a microsecond of
//    memory or f32 time.  Past the launch itself, a call's time is the
//    chain of dependent steps one row walks, so the design shortens that
//    chain:
//    - the weights are one 16-byte-aligned blob packed once on the host
//      (ServingMLP, ops/fused_score.py): part A = W0 (child, parent, edge
//      rows) | b0, part B = W1 | b1 | W2 | b2, widths padded to multiples
//      of 4 with zeros.  One thread starts two bulk asynchronous copies
//      (cp.async.bulk global->shared), each completing on its own
//      mbarrier; no thread stages weights by hand;
//    - each warp scores ONE row (4 warps a block, so 128 rows are 32
//      blocks).  Its slot ids and edge features are loaded before the
//      barrier setup and the host rows right after, while the weights are
//      in flight; it waits for part A only, runs layer 1 (part B is still
//      landing), then waits for part B;
//    - layer 1: lanes over hidden units, four independent partial sums a
//      unit over the 32 inputs;
//    - layer 2: lanes over quads of output units and slices of the input
//      units, h1 and W1 read as float4, two accumulators a quad, the
//      slices added by shuffles (with two slices each lane then takes two
//      units, so all 32 lanes run a gelu), the head and a warp sum;
//    - the serving widths 64 x 64 are compiled as their own instance, with
//      every shared-memory offset a constant and the loops unrolled (with
//      runtime widths the loads need address arithmetic and issue a few at
//      a time); other widths take the generic instance;
//    - no tensor cores: at <= 512 rows the whole call is ~6 MFLOP; TF32
//      would break the f32 tolerance and 3xTF32 would buy nothing at this
//      size.  Thread-block clusters (one weight copy multicast to several
//      blocks) and programmatic dependent launch were left out: at 128
//      rows the weights land before the row's inputs do, and on the
//      serving path K1 follows a host-to-device copy, not a kernel.
//    The ragged last block is masked (any n >= 1), any widths whose weights
//    fit in shared memory are taken, and an out-of-range slot id never
//    reads outside the matrix: its row scores NaN (callers check the ids on
//    the host first).
//
// K2 rule_weighted_sum replaces dragonfly2_tpu/ops/pallas_score.py:364
//    _rule_sum_kernel (launched at :375): out[r] = components[r, :] . w for
//    the six rule-component weights, [n, 6] f32 row-major -> [n] f32.
//
//    What bounds it on this card: bytes, 24 in and 4 out a row, against 11
//    operations.  Where the bytes are few the launch sets the time:
//    - 512 rows (the rule arm's candidate sets) and 65,536 rows (the
//      serving slot table, 1.8 MB, which stays in L2): the bound is 4 ns
//      and 0.55 us, under the launch floor (~2 us).  A call is the launch
//      plus one round trip, which the design keeps to one pass in which
//      every block of the grid is resident at once, spread over every SM;
//    - 16,777,216 rows (470 MB, nine times L2, cold on every launch): HBM
//      sets the pace, 0.140 ms at 3.35 TB/s.  It takes enough rows in
//      flight on every SM, read in whole sectors.
//    The design: a thread takes two rows, 48 bytes from a 16-byte
//    boundary, as three 16-byte loads and one 8-byte store, over a grid of
//    one thread a pair, so every SM holds as many pairs in flight as its
//    threads allow.  (A grid-stride loop over a few blocks an SM, with two
//    pairs a thread a step, read HBM slower: fewer rows in flight.)  Each
//    row's sum is one fmaf chain in term order, so the tolerance to the
//    plain version stands.  The weights are kernel arguments.  Alignment
//    and edges are the kernel's: a base 8 bytes off 16 (a view that starts
//    at an odd row, e.g. comp[1:]) takes its first row alone, a base 4 or
//    12 bytes off (a view from inside a row) takes every row alone, an odd
//    row left at the end is taken alone, and pairs whose outputs are not
//    8-byte aligned store two floats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHostDim = 12;                      // HOST_FEATURE_DIM
constexpr int kEdgeDim = 8;                       // EDGE_FEATURE_DIM
constexpr int kInDim = 2 * kHostDim + kEdgeDim;   // 32: one lane per input
constexpr int kWarps = 4;                         // rows per block, one a warp
constexpr unsigned kFull = 0xffffffffu;

static_assert(kInDim == 32, "the first layer maps one input feature per lane");

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// The blob's layout in floats (ops/fused_score.py pack_k1_weights writes
// it) and the shared memory around it.  Layer 2 splits the d1 inputs into
// `ks` slices of `kper` (a multiple of 4) for lanes over `per` quads of
// output units at a time; h1 is kept slice-major, each slice padded by 4
// floats, so it is read as float4 and the slices start on other banks.
struct BlobLayout {
  int d1, d2, d1p, d2p;
  int a_floats;   // part A: W0 [32][d1] | b0 [d1p]
  int b_floats;   // part B: W1 [d1p][d2p] | b1 [d2p] | W2 [d2p] | b2 [4]
  int nq, per, ks, kper, kstride;
  __host__ __device__ constexpr BlobLayout(int d1_, int d2_)
      : d1(d1_), d2(d2_), d1p(round4(d1_)), d2p(round4(d2_)),
        a_floats(kInDim * d1_ + round4(d1_)),
        b_floats(round4(d1_) * round4(d2_) + 2 * round4(d2_) + 4),
        nq(round4(d2_) / 4),
        per(round4(d2_) / 4 < 32 ? round4(d2_) / 4 : 32),
        ks(32 / (round4(d2_) / 4 < 32 ? round4(d2_) / 4 : 32)),
        kper(round4((d1_ + ks - 1) / ks)),
        kstride(round4((d1_ + ks - 1) / ks) + 4) {}
  __host__ __device__ constexpr int h1_floats() const { return ks * kstride; }
  __host__ __device__ size_t smem_bytes() const {
    return sizeof(float) * (static_cast<size_t>(a_floats) + b_floats + kWarps * 32 +
                            static_cast<size_t>(kWarps) * h1_floats());
  }
};

// gelu, tanh form, exactly the serving formula (trainer/export._np_gelu):
// x * x * x, never powf.  (The logistic form x / (1 + e^(-2u)) has no
// branches but measured slower on the card: expf plus a division.)
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = x * x * x;
  return 0.5f * x * (1.0f + tanhf(0.7978845608f * (x + 0.044715f * x3)));
}

__device__ __forceinline__ void fma4(float4& acc, float h, const float4& w) {
  acc.x = fmaf(h, w.x, acc.x);
  acc.y = fmaf(h, w.y, acc.y);
  acc.z = fmaf(h, w.z, acc.z);
  acc.w = fmaf(h, w.w, acc.w);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive once and expect `bytes` of asynchronous copy on `bar`, then copy
// `bytes` from global `src` to shared `dst`; completion lands on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Wait for the first phase of `bar` to complete.
__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(0u) : "memory");
  } while (!done);
}

// kD1, kD2 > 0: widths fixed at compile time (the serving 64 x 64), so
// every shared-memory offset is a constant and the loops unroll; 0: the
// widths come from d1_arg, d2_arg.
template <int kD1, int kD2>
__global__ void __launch_bounds__(kWarps * 32)
fused_gather_mlp_score_kernel(
    const float* __restrict__ mat, long long n_slots,
    const int32_t* __restrict__ slots, const int32_t* __restrict__ dslots,
    const float* __restrict__ edge, const float* __restrict__ blob,
    float* __restrict__ out, int n, int d1_arg, int d2_arg) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[2];
  const int d1 = kD1 > 0 ? kD1 : d1_arg;
  const BlobLayout L(d1, kD2 > 0 ? kD2 : d2_arg);
  float* s_w0 = smem;                                   // [32][d1]
  const float* s_b0 = s_w0 + kInDim * d1;               // [d1p]
  float* s_w1 = smem + L.a_floats;                      // [d1p][d2p]
  const float* s_b1 = s_w1 + L.d1p * L.d2p;             // [d2p]
  const float* s_w2 = s_b1 + L.d2p;                     // [d2p]
  const float* s_b2 = s_w2 + L.d2p;                     // [1]
  float* s_x = s_w1 + L.b_floats;                       // [kWarps][32]
  float* s_h1 = s_x + kWarps * 32;                      // [kWarps][ks][kstride]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // The row's own loads go out first: they do not wait for the weights.
  const int row = blockIdx.x * kWarps + warp;           // warp-uniform
  const bool live = row < n;
  float x = 0.0f;
  long long ps = 0;
  long long cs = 0;
  if (live) {
    if (lane >= 2 * kHostDim) {
      x = edge[static_cast<long long>(row) * kEdgeDim + (lane - 2 * kHostDim)];
    }
    ps = slots[row];
    cs = dslots[row];
  }
  // One thread sets up both barriers and starts both copies; the block
  // barrier then publishes the initialised mbarriers to the waiters.
  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bulk_load(s_w0, blob, sizeof(float) * L.a_floats, &bars[0]);
    bulk_load(s_w1, blob + L.a_floats, sizeof(float) * L.b_floats, &bars[1]);
  }
  __syncthreads();
  // Warp 0 always holds a row (the grid covers n exactly), so it waits for
  // both copies before the block can retire.
  if (!live) return;
  if (ps < 0 || ps >= n_slots || cs < 0 || cs >= n_slots) {
    if (lane == 0) out[row] = __int_as_float(0x7fc00000);  // NaN
    mbar_wait0(&bars[0]);
    mbar_wait0(&bars[1]);
    return;
  }
  // Lane k holds input feature k of the [child | parent | edge] row.
  if (lane < kHostDim) {
    x = mat[cs * kHostDim + lane];
  } else if (lane < 2 * kHostDim) {
    x = mat[ps * kHostDim + (lane - kHostDim)];
  }
  float* xw = s_x + warp * 32;
  xw[lane] = x;
  __syncwarp();
  float xs[kInDim];
#pragma unroll
  for (int k = 0; k < kInDim; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(xw + k);
    xs[k] = q.x;
    xs[k + 1] = q.y;
    xs[k + 2] = q.z;
    xs[k + 3] = q.w;
  }
  mbar_wait0(&bars[0]);

  // Layer 1, lane l over hidden units l, l + 32, ...: four independent
  // partial sums a unit (input k goes to sum k % 4), added in a fixed
  // order.  Units d1 .. d1p - 1 are written as 0 (h1's padding).
  float* h1 = s_h1 + warp * L.h1_floats();
#pragma unroll
  for (int t = 0; t < (L.d1p + 31) / 32; ++t) {
    const int j = lane + 32 * t;
    if (j >= L.d1p) break;
    float h = 0.0f;
    if (j < d1) {
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kInDim; ++k) a[k & 3] = fmaf(xs[k], s_w0[k * d1 + j], a[k & 3]);
      h = gelu_tanh(((a[0] + a[1]) + (a[2] + a[3])) + s_b0[j]);
    }
    h1[(j / L.kper) * L.kstride + j % L.kper] = h;
  }
  __syncwarp();
  mbar_wait0(&bars[1]);

  // Layer 2: lane = (slice, quad).  Each active lane sums its slice of the
  // inputs for its quad's four units, h1 and W1 read as float4, in two
  // accumulators (inputs k, k + 2 and k + 1, k + 3); the slices are then
  // added by shuffles, gelu'd, and folded into the head.  W1's padded rows
  // and h1's padding are zero, and padded units have zero W1 columns, b1
  // and W2: they add 0.
  const int slice = lane / L.per;
  const int k_lo = slice * L.kper;
  const int k_hi = min(k_lo + L.kper, L.d1p);
  const float4* w1q = reinterpret_cast<const float4*>(s_w1);
  const float4* h1q = reinterpret_cast<const float4*>(h1 + slice * L.kstride);
  float head = 0.0f;
  for (int qb = 0; qb < L.nq; qb += L.per) {             // warp-uniform
    const int q = qb + lane % L.per;
    const bool active = slice < L.ks && q < L.nq;
    float4 e = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 o = e;
    if (active) {
#pragma unroll
      for (int i = 0; i < L.kper; i += 4) {
        const int k = k_lo + i;
        if (k >= k_hi) break;
        const float4 h = h1q[i >> 2];
        fma4(e, h.x, w1q[k * L.nq + q]);
        fma4(o, h.y, w1q[(k + 1) * L.nq + q]);
        fma4(e, h.z, w1q[(k + 2) * L.nq + q]);
        fma4(o, h.w, w1q[(k + 3) * L.nq + q]);
      }
    }
    const float4 acc = make_float4(e.x + o.x, e.y + o.y, e.z + o.z, e.w + o.w);
    if (L.ks == 2) {
      // Two slices: each lane of a pair takes two of the quad's units, so
      // all 32 lanes run a gelu.
      const int partner = slice == 0 ? lane + L.per : (slice == 1 ? lane - L.per : lane);
      const float ga = __shfl_sync(kFull, slice == 0 ? acc.z : acc.x, partner);
      const float gb = __shfl_sync(kFull, slice == 0 ? acc.w : acc.y, partner);
      if (active) {
        const int u = 4 * q + 2 * slice;
        head = fmaf(gelu_tanh((slice == 0 ? acc.x : acc.z) + ga + s_b1[u]), s_w2[u], head);
        head = fmaf(gelu_tanh((slice == 0 ? acc.y : acc.w) + gb + s_b1[u + 1]), s_w2[u + 1],
                    head);
      }
    } else {
      float4 sum = acc;
      for (int s = 1; s < L.ks; ++s) {                   // warp-uniform
        const float ax = __shfl_down_sync(kFull, acc.x, s * L.per);
        const float ay = __shfl_down_sync(kFull, acc.y, s * L.per);
        const float az = __shfl_down_sync(kFull, acc.z, s * L.per);
        const float aw = __shfl_down_sync(kFull, acc.w, s * L.per);
        sum.x += ax;
        sum.y += ay;
        sum.z += az;
        sum.w += aw;
      }
      if (slice == 0 && q < L.nq) {
        const float4 b = reinterpret_cast<const float4*>(s_b1)[q];
        const float4 w = reinterpret_cast<const float4*>(s_w2)[q];
        head = fmaf(gelu_tanh(sum.x + b.x), w.x, head);
        head = fmaf(gelu_tanh(sum.y + b.y), w.y, head);
        head = fmaf(gelu_tanh(sum.z + b.z), w.z, head);
        head = fmaf(gelu_tanh(sum.w + b.w), w.w, head);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) head += __shfl_xor_sync(kFull, head, off);
  if (lane == 0) out[row] = head + s_b2[0];
}

constexpr int kRuleThreads = 256;

struct RuleWeights {
  float w0, w1, w2, w3, w4, w5;
};

__device__ __forceinline__ float rule_dot(float c0, float c1, float c2, float c3, float c4,
                                          float c5, const RuleWeights& w) {
  float acc = c0 * w.w0;
  acc = fmaf(c1, w.w1, acc);
  acc = fmaf(c2, w.w2, acc);
  acc = fmaf(c3, w.w3, acc);
  acc = fmaf(c4, w.w4, acc);
  acc = fmaf(c5, w.w5, acc);
  return acc;
}

__device__ __forceinline__ float rule_row(const float* __restrict__ c, const RuleWeights& w) {
  return rule_dot(__ldg(c), __ldg(c + 1), __ldg(c + 2), __ldg(c + 3), __ldg(c + 4),
                  __ldg(c + 5), w);
}

// Thread t takes row t while t < head, then pair p = t - head (rows
// head + 2p and head + 2p + 1, 48 bytes from a 16-byte boundary), then
// the last row alone when the rows after the head are odd.
__global__ void __launch_bounds__(kRuleThreads) rule_weighted_sum_kernel(
    const float* __restrict__ comp, float* __restrict__ out, long long n, long long head,
    RuleWeights w) {
  const long long t = static_cast<long long>(blockIdx.x) * kRuleThreads + threadIdx.x;
  if (t < head) {
    out[t] = rule_row(comp + 6 * t, w);
    return;
  }
  const long long p = t - head;
  const long long pairs = (n - head) >> 1;
  if (p < pairs) {
    const float4* src = reinterpret_cast<const float4*>(comp + 6 * head) + 3 * p;
    const float4 a0 = __ldg(src);
    const float4 a1 = __ldg(src + 1);
    const float4 a2 = __ldg(src + 2);
    const float ra = rule_dot(a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, w);
    const float rb = rule_dot(a1.z, a1.w, a2.x, a2.y, a2.z, a2.w, w);
    float* dst = out + head + 2 * p;
    if ((reinterpret_cast<uintptr_t>(out + head) & 7) == 0) {
      *reinterpret_cast<float2*>(dst) = make_float2(ra, rb);
    } else {
      dst[0] = ra;
      dst[1] = rb;
    }
  } else if (p == pairs && ((n - head) & 1) != 0) {
    out[n - 1] = rule_row(comp + 6 * (n - 1), w);
  }
}

}  // namespace

extern "C" {

// Shared memory K1 needs for hidden widths d1, d2 (bytes).
size_t df_fused_score_smem_bytes(int d1, int d2) {
  return BlobLayout(d1, d2).smem_bytes();
}

// Floats of K1's weight blob for widths d1, d2 (the packer must agree).
int df_fused_score_blob_floats(int d1, int d2) {
  const BlobLayout L(d1, d2);
  return L.a_floats + L.b_floats;
}

// blob: the packed weights (16-byte aligned, df_fused_score_blob_floats
// floats); out: [n] f32.
int df_fused_gather_mlp_score(
    const float* mat, long long n_slots, const int32_t* slots,
    const int32_t* dslots, const float* edge, const float* blob, float* out,
    int n, int d1, int d2, void* stream) {
  if (n < 1 || d1 < 1 || d2 < 1 || (reinterpret_cast<uintptr_t>(blob) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = BlobLayout(d1, d2).smem_bytes();
  const bool serving = d1 == 64 && d2 == 64;
  auto kernel = serving ? fused_gather_mlp_score_kernel<64, 64>
                        : fused_gather_mlp_score_kernel<0, 0>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + kWarps - 1) / kWarps;
  kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      mat, n_slots, slots, dslots, edge, blob, out, n, d1, d2);
  return static_cast<int>(cudaGetLastError());
}

int df_rule_weighted_sum(const float* comp, float* out, long long n, float w0,
                         float w1, float w2, float w3, float w4, float w5,
                         void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  // Rows taken alone before the first pair on a 16-byte boundary: none,
  // one (a base 8 bytes off), or all (no row starts on one).
  const uintptr_t off = reinterpret_cast<uintptr_t>(comp) & 15;
  const long long head = off == 0 ? 0 : (off == 8 ? 1 : n);
  const long long threads = head + ((n - head) >> 1) + ((n - head) & 1);
  const long long blocks = (threads + kRuleThreads - 1) / kRuleThreads;
  const RuleWeights w{w0, w1, w2, w3, w4, w5};
  rule_weighted_sum_kernel<<<static_cast<unsigned>(blocks), kRuleThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(comp, out, n, head, w);
  return static_cast<int>(cudaGetLastError());
}

const char* df_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
