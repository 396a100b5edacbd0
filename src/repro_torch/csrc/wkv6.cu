// K4: the RWKV-6 (Finch) WKV scan with data-dependent decay, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the reference's scan is a lax.scan over time
// inside src/repro/models/ssm.py::rwkv_time_mix (:141-152).  In eager
// torch that loop would launch a few kernels per token and layer (about
// 2 M for a 2 x 8192 rwkv6-1.6b prefill), so the port runs it as one
// kernel.
//
// Per batch row b and head h, with a (64 x 64) float32 state s[i][j] (i
// the key channel, j the value channel), at each step t in the
// reference's order and grouping:
//   kv[i][j] = k[i] * v[j]
//   y[j]     = sum over i of r[i] * (s[i][j] + u[i] * kv[i][j])
//   s[i][j]  = w[i] * s[i][j] + kv[i][j]
// r, k and v in the model's dtype are widened to float32.  The state's
// products and sums are rounded one at a time (__fmul_rn, __fadd_rn: no
// contraction into FMAs), so every element evolves with the plain
// version's bits; an element's chain never reads another element, so any
// split of the state across threads keeps them.  y is held to the plain
// version only by the float64 rule (its dot over i is a cuBLAS reduction
// there), so its bonus term is refolded:
//   y[j] = sum_i r[i] * s[i][j]  +  v[j] * (sum_i r[i] * u[i] * k[i]),
// the second sum one scalar a head and step, and the first summed in FMA
// partial sums, then across lanes by shuffles.  Layouts, all contiguous
// and 16-byte aligned: r, k, v (B, S, H, 64) float32 or bfloat16; w (B,
// S, H, 64), u (H, 64), s0, sT (B, H, 64, 64), y (B, S, H, 64) float32.
//
// Design.  Column j of a head's state needs only v[j] and the head's
// shared r, k, w rows, so a head's 64 columns are split across kSlices
// blocks of kCols columns, and a column group's 64 rows across kLanes
// neighbouring lanes of a warp: a thread holds kColsT columns of kRows
// rows (rows 4 l + 4 kLanes m + q, q < 4) in registers, and reads each
// row's r, k, w once for all its columns.  A state costs one multiply and
// one add a step, plus kv and one FMA of y's partial sum; each column's
// sum is finished by log2(kLanes) __shfl_xor_sync steps.  At rwkv6-1.6b's
// prefill (B 2, H 32) that is 128 blocks of 4 warps, 8 lanes a column
// group, 2 columns of 8 rows a thread (chosen by measurement over 4, 8 and
// 16 lanes and 1, 2 and 4 columns: PERF.md).  The time axis is staged in
// chunks of kChunk steps through a ring of kRing buffers filled by
// cp.async (16-byte copies of the raw rows, a fixed share a thread), each
// completing on its own mbarrier, so chunks c + 1 and c + 2 are in flight
// while chunk c is computed.  A prep pass widens a chunk's r, k, v to
// float32 and forms sum_i r u k once a step (double-buffered, one
// __syncthreads a chunk), so the scan reads a thread's rows as 16-byte
// shared-memory loads.  Decode (S = 1) issues one chunk of one step.
//
// Training.  With hs given, the forward also writes the state at every
// chunk's start (B, H, ceil(S / kChunk), 64, 64), and K4-bwd (below)
// takes it.  It replaces JAX's autodiff transpose of the same lax.scan
// (ssm.py:151), also no Pallas kernel.  With G_t = dL/ds_t (dsT at the
// end), i the key and j the value channel:
//   G_{t-1} = w_t G_t (by rows) + r_t dy_t^T,
//   dr_t[i] = sum_j dy_t[j] (s_{t-1}[i][j] + u[i] k_t[i] v_t[j]),
//   dw_t[i] = sum_j G_t[i][j] s_{t-1}[i][j],
//   dk_t = (G_t + (r_t u) dy_t^T) v_t,  dv_t = (G_t + (r_t u) dy_t^T)^T k_t,
//   du[i] = sum_{b,t} r_t[i] k_t[i] (dy_t . v_t),  ds0 = G_0.
// A head's rows are split over 8 blocks of 4 warps launched as one
// thread block cluster, and a thread keeps half a chunk of its states in
// registers (96 a thread, 5 blocks resident an SM: rwkv's 64 heads, 512
// blocks, run in one wave); w is never inverted to step a state back (it
// can be tiny).  Only dv sums across the head's blocks: a chunk's dv is
// added through distributed shared memory while the blocks walk the next
// chunk, so nothing but du (over batch rows) is left to a second kernel
// (no float atomics).  K4-bwd's bound at (2, 4096, 32, 64): 14 float32
// operations a state element and step (3 to recompute the state; dy s, G
// s, G v, G k each a product and a sum; G's update 3), 1.5e10, 0.224 ms;
// bytes 0.67 GB with the saved states, 0.200 ms.  This design issues
// about 25 instructions a state element and step (the state recomputed
// 22 steps a chunk of 16; a row's three sums and a column's sum folded
// across lanes by shuffles, a third of them): it is bound by instruction
// issue.
//
// Bound: operations.  7 float32 operations a state element and step in
// the reference's grouping: at (2, 8192, 32, 64) 1.5e10, 0.224 ms at 67
// TFLOP/s; r, k, v, w and y once each in bf16 are about 0.47 GB, 0.141
// ms at 3.35 TB/s.  This design issues 4 float32 instructions a state
// element and step (kv, the FMA of y, w * s, + kv) plus 3 16-byte shared
// loads a row group and the shuffles; with 2 warps an SM scheduler it is
// bound by instruction latency and the shared-memory pipe, not by the
// float32 rate.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kHead = 64;                    // RWKV_HEAD_DIM
constexpr int kThreads = 128;                // threads a block
constexpr int kLanes = 8;                    // lanes a column group
constexpr int kColsT = 2;                    // state columns a thread
constexpr int kRows = kHead / kLanes;        // state rows a thread
constexpr int kGroupsW = 32 / kLanes;        // column groups a warp
constexpr int kCols = kThreads / kLanes * kColsT;   // columns a block
constexpr int kSlices = kHead / kCols;       // blocks a head
constexpr int kChunk = 16;                   // time steps a ring buffer
constexpr int kRing = 3;                     // ring buffers
constexpr int kGroups = kHead / 4;           // 4-row groups of a step
static_assert(kRows % 4 == 0 && kCols * kLanes == kThreads * kColsT &&
                  kSlices * kCols == kHead && kColsT <= kLanes,
              "layout");
static_assert((kChunk * kGroups) % kThreads == 0 && kGroups == 16,
              "prep covers the chunk, a step a half warp");

// One ring buffer: a chunk's raw rows as cp.async left them.
template <typename T>
struct Stage {
  alignas(16) T r[kChunk][kHead];
  alignas(16) T k[kChunk][kHead];
  alignas(16) float w[kChunk][kHead];
  alignas(16) T v[kChunk][kCols];
};

// A chunk widened to float32 for the scan, with sum_i r u k a step.
struct Prep {
  alignas(16) float r[kChunk][kHead];
  alignas(16) float k[kChunk][kHead];
  alignas(16) float w[kChunk][kHead];
  float v[kChunk][kCols];
  float ruk[kChunk];
};

template <typename T>
struct Shared {
  Stage<T> ring[kRing];
  Prep prep[2];
  uint64_t bar[kRing];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// The mbarrier counts one arrival of this thread once all its earlier
// cp.async copies have landed (init count = the block's threads).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four consecutive elements of a staged row as float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// kSave: also write the state at every chunk's start to hs (training);
// the serving instance compiles without the store.
template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ sT,
                float* __restrict__ hs, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared<T>& sm = *reinterpret_cast<Shared<T>*>(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x / kSlices;               // b * H + h
  const int b = bh / H, hh = bh % H;
  const int j0 = (blockIdx.x % kSlices) * kCols;
  const int lane = tid % 32;
  const int l = lane % kLanes;                       // lane in the group
  // the thread's first column in the block; it owns kColsT of them
  const int jl = ((tid / 32) * kGroupsW + lane / kLanes) * kColsT;
  const int j = j0 + jl;
  const int n_chunks = (S + kChunk - 1) / kChunk;

  // prep: thread tid owns row group g of steps tid / kGroups + ...
  const int g = tid % kGroups;
  float ug[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) ug[q] = u[hh * kHead + 4 * g + q];

  float s[kColsT][kRows];
  const size_t sbase = static_cast<size_t>(bh) * kHead * kHead;
#pragma unroll
  for (int e = 0; e < kRows; ++e) {
    const int i = 4 * l + 4 * kLanes * (e / 4) + e % 4;
#pragma unroll
    for (int cc = 0; cc < kColsT; ++cc)
      s[cc][e] = s0[sbase + i * kHead + j + cc];
  }

  if (tid < kRing) mbar_init(&sm.bar[tid], kThreads);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // Start chunk c's copies into ring buffer c % kRing.
  // A thread copies pieces p = tid + i kThreads of each array's chunk,
  // the same in every chunk (fixed trip counts, hoisted offsets).
  constexpr int kPer = 16 / sizeof(T);                  // elements a piece
  constexpr int kRowP = kHead / kPer, kWP = kHead / 4, kVP = kCols / kPer;
  const size_t step_stride = static_cast<size_t>(H) * kHead;
  auto issue = [&](int c) {
    Stage<T>& st = sm.ring[c % kRing];
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
    const size_t base =
        ((static_cast<size_t>(b) * S + t0) * H + hh) * kHead;   // (b, t0, h)
#pragma unroll
    for (int i = 0; i < (kChunk * kRowP + kThreads - 1) / kThreads; ++i) {
      const int p = tid + i * kThreads, t = p / kRowP, q = p % kRowP;
      if (p < kChunk * kRowP && t < len) {
        const size_t off = base + t * step_stride + q * kPer;
        cp_async16(&st.r[t][q * kPer], r + off);
        cp_async16(&st.k[t][q * kPer], k + off);
      }
    }
#pragma unroll
    for (int i = 0; i < (kChunk * kWP + kThreads - 1) / kThreads; ++i) {
      const int p = tid + i * kThreads, t = p / kWP, q = p % kWP;
      if (p < kChunk * kWP && t < len)
        cp_async16(&st.w[t][q * 4], w + base + t * step_stride + q * 4);
    }
#pragma unroll
    for (int i = 0; i < (kChunk * kVP + kThreads - 1) / kThreads; ++i) {
      const int p = tid + i * kThreads, t = p / kVP, q = p % kVP;
      if (p < kChunk * kVP && t < len)
        cp_async16(&st.v[t][q * kPer],
                   v + base + t * step_stride + j0 + q * kPer);
    }
    cp_async_arrive(&sm.bar[c % kRing]);
  };

  issue(0);
  if (n_chunks > 1) issue(1);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 2 < n_chunks) issue(c + 2);
    mbar_wait(&sm.bar[c % kRing], (c / kRing) & 1);
    const Stage<T>& st = sm.ring[c % kRing];
    Prep& pp = sm.prep[c % 2];
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
    // for training: the state at the chunk's start (the backward's anchor)
    if constexpr (kSave) {
      float* hc = hs + (static_cast<size_t>(bh) * n_chunks + c) * kHead * kHead;
#pragma unroll
      for (int e = 0; e < kRows; ++e) {
        const int i = 4 * l + 4 * kLanes * (e / 4) + e % 4;
#pragma unroll
        for (int cc = 0; cc < kColsT; ++cc) hc[i * kHead + j + cc] = s[cc][e];
      }
    }

    // Prep, over the chunk's len steps: widen r, k, v, copy w, and sum_i
    // r u k a step by shuffles among the 16 lanes (a half warp) of a step
    const unsigned half = 0xffffu << (tid & 16);
#pragma unroll
    for (int it = 0; it < kChunk * kGroups / kThreads; ++it) {
      const int t = (tid + it * kThreads) / kGroups;
      if (t < len) {
        const float4 rr = load4(&st.r[t][4 * g]);
        const float4 kk = load4(&st.k[t][4 * g]);
        *reinterpret_cast<float4*>(&pp.r[t][4 * g]) = rr;
        *reinterpret_cast<float4*>(&pp.k[t][4 * g]) = kk;
        *reinterpret_cast<float4*>(&pp.w[t][4 * g]) = load4(&st.w[t][4 * g]);
        float ruk = rr.x * ug[0] * kk.x;
        ruk = fmaf(rr.y * ug[1], kk.y, ruk);
        ruk = fmaf(rr.z * ug[2], kk.z, ruk);
        ruk = fmaf(rr.w * ug[3], kk.w, ruk);
#pragma unroll
        for (int o = 1; o < kGroups; o <<= 1)
          ruk += __shfl_xor_sync(half, ruk, o);
        if (g == 0) pp.ruk[t] = ruk;
      }
    }
    for (int p = tid; p < len * kCols; p += kThreads)
      pp.v[p / kCols][p % kCols] = to_f32(st.v[p / kCols][p % kCols]);
    __syncthreads();

    // one step: each state's y term and update, then y's column sums
    auto step = [&](int t) {
      float vj[kColsT], acc[kColsT][2];
#pragma unroll
      for (int cc = 0; cc < kColsT; ++cc) {
        vj[cc] = pp.v[t][jl + cc];
        acc[cc][0] = acc[cc][1] = 0.f;
      }
#pragma unroll
      for (int m = 0; m < kRows / 4; ++m) {
        const int i = 4 * l + 4 * kLanes * m;
        const float4 rr = *reinterpret_cast<const float4*>(&pp.r[t][i]);
        const float4 kk = *reinterpret_cast<const float4*>(&pp.k[t][i]);
        const float4 ww = *reinterpret_cast<const float4*>(&pp.w[t][i]);
        const float rq[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kq[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wq[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int cc = 0; cc < kColsT; ++cc) {
            float& se = s[cc][4 * m + q];
            const float kv = __fmul_rn(kq[q], vj[cc]);
            acc[cc][q & 1] = fmaf(rq[q], se, acc[cc][q & 1]);
            se = __fadd_rn(__fmul_rn(wq[q], se), kv);
          }
        }
      }
      const float ruk = pp.ruk[t];
      const size_t row =
          ((static_cast<size_t>(b) * S + t0 + t) * H + hh) * kHead + j;
#pragma unroll
      for (int cc = 0; cc < kColsT; ++cc) {
        float sum = acc[cc][0] + acc[cc][1];
#pragma unroll
        for (int o = 1; o < kLanes; o <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (l == cc) y[row + cc] = fmaf(vj[cc], ruk, sum);
      }
    };
    if (len == kChunk) {
#pragma unroll
      for (int t = 0; t < kChunk; ++t) step(t);
    } else {
      for (int t = 0; t < len; ++t) step(t);
    }
  }
#pragma unroll
  for (int e = 0; e < kRows; ++e) {
    const int i = 4 * l + 4 * kLanes * (e / 4) + e % 4;
#pragma unroll
    for (int cc = 0; cc < kColsT; ++cc) sT[sbase + i * kHead + j + cc] = s[cc][e];
  }
}

// ---- K4's backward ---------------------------------------------------------

constexpr int kBSlices = 8;                   // blocks a head: one cluster
constexpr int kBRows = kHead / kBSlices;      // state rows a block
constexpr int kBWarps = kThreads / 32;
constexpr int kBColsW = kHead / kBWarps;      // columns a warp
constexpr int kBColsT = 4;                    // columns a thread
constexpr int kBQuads = kBColsW / kBColsT;    // lanes a row in a warp
constexpr int kBwdBlocksPerSm = 5;            // the launch bound: 96
                                              // registers a thread
constexpr int kHalf = kChunk / 2;             // states a thread keeps
static_assert(kBRows * kBQuads == 32 && kBQuads == 4 && kBRows == 8 &&
                  kChunk * kBRows == kThreads,
              "backward layout: a warp's lanes are 8 rows x 4 column quads; "
              "the finishing pass a (step, row) a thread");

// The thread block cluster: its barrier, whole or as its two halves (so
// that a block goes on with its own work while its peers still read its
// shared memory), and its peers' shared memory.
__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
__device__ __forceinline__ const float* peer(const float* p, int rank) {
  return cg::this_cluster().map_shared_rank(const_cast<float*>(p), rank);
}

// Lanes L and L ^ bit each hold a pair (a, b): the lane whose bit is
// clear returns its a plus its partner's a, the other lane its b plus its
// partner's b (one shuffle for two sums).
__device__ __forceinline__ float fold(float a, float b, int lane, int bit) {
  const bool hi = lane & bit;
  const float keep = hi ? b : a, send = hi ? a : b;
  return __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, bit));
}

// v[0..M) summed over the lanes that differ in the bits kBit, kBit / 2,
// ..., kLo, in that fixed order.  While more than one value is left, each
// round folds the upper half of v onto the lower (`fold`), so v[i] ends
// as the sum of the values first at index base + i, base from the lane's
// bits; a round with one value left adds it across the bit (both lanes
// then hold the sum).
template <int kLo, int kBit, int M, int kN>
__device__ __forceinline__ void fold_sum(float (&v)[kN], int lane,
                                         int& base) {
  if constexpr (kBit >= kLo) {
    if constexpr (M > 1) {
      constexpr int h = M / 2;
#pragma unroll
      for (int i = 0; i < h; ++i) v[i] = fold(v[i], v[i + h], lane, kBit);
      if (lane & kBit) base += h;
      fold_sum<kLo, kBit / 2, h>(v, lane, base);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], kBit));
      fold_sum<kLo, kBit / 2, 1>(v, lane, base);
    }
  }
}

// One ring buffer of K4-bwd: a chunk's inputs as cp.async left them, the
// block's rows of r, k, w and of the state at the chunk's start, and all
// the columns of v and dy.
template <typename T>
struct BwdStage {
  alignas(16) T r[kChunk][kBRows];
  alignas(16) T k[kChunk][kBRows];
  alignas(16) float w[kChunk][kBRows];
  alignas(16) T v[kChunk][kHead];
  alignas(16) float dy[kChunk][kHead];
  alignas(16) float s[kBRows][kHead];
};

template <typename T>
struct BwdShared {
  BwdStage<T> ring[2];
  // a warp's shares of each row's dr, dw, dk sums (its 16 columns) a step
  alignas(16) float rows[kChunk][kBWarps][kBRows][4];
  // the block's share of dv (its 8 rows) a step and its sum of r u k a
  // step, read by the cluster a chunk later: double-buffered by chunk
  alignas(16) float cols[2][kChunk][kHead];
  float ruk[2][kChunk];
  float dyv[kChunk];                          // dy . v a step
  uint64_t bar[2];
};

// K4's backward.  A head is one cluster of kBSlices blocks, a block 8 of
// its rows (key channels); a warp's lanes hold the block's 8 rows x 16
// columns, a thread 4 neighbouring columns of one row.  The chunks are
// walked from the last to the first, chunk c - 1's inputs staged by
// 16-byte cp.async into a ring of 2 while chunk c is walked.  A chunk's
// states are recomputed from the one the forward saved at its start (hs)
// with the forward's rounded operations, so with its bits, into a
// thread's registers, half a chunk at a time (8 steps x 4 elements, fully
// unrolled; the second half first, its start recomputed through the
// first: 22 steps recomputed a chunk of 16); then G = dL/ds is walked back
// in registers with plain's rounded update,
//   G_{t-1} = w_t G_t (by rows) + r_t dy_t^T.
// The sums, in fixed orders:
// - dr, dw, dk (over a row's 64 columns): a thread's 4 in FMA partial
//   sums, folded over the row's 4 lanes (`fold_sum`: 3 sums, 3 shuffles),
//   then the 4 warps in order after the chunk, one (step, row) a thread;
// - dv (over the head's 64 rows): a thread's column products folded over
//   the warp's 8 rows, then the cluster's blocks in rank order through
//   distributed shared memory, one (step, column) a thread of the
//   cluster, plus dy sum_i r u k (the blocks' sums of r u k added in rank
//   order), while the blocks walk the next chunk (the shares are
//   double-buffered, one split cluster barrier a chunk); nothing crosses
//   a cluster, so dv needs no second pass;
// - du: a row's sum over its steps (a chunk's first, descending), left
//   per batch row in du_part and added over batch rows by
//   wkv6_bwd_finish_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
    wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ hs,
                    const float* __restrict__ dy,
                    const float* __restrict__ dsT, T* __restrict__ dr,
                    T* __restrict__ dk, T* __restrict__ dv,
                    float* __restrict__ dw, float* __restrict__ ds0,
                    float* __restrict__ du_part, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdShared<T>& sm = *reinterpret_cast<BwdShared<T>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x / kBSlices, slice = blockIdx.x % kBSlices;
  const int b = bh / H, hh = bh % H;
  const int ir = lane / kBQuads, cq = lane % kBQuads;
  const int i0 = slice * kBRows, i = i0 + ir;          // the thread's row
  const int j0 = warp * kBColsW + cq * kBColsT;        // its first column
  // the finishing pass's step and row
  const int ft = tid / kBRows, fr = tid % kBRows;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const size_t sbase = static_cast<size_t>(bh) * kHead * kHead;
  const size_t step_stride = static_cast<size_t>(H) * kHead;
  const float uf = u[hh * kHead + i0 + fr];

  float G[kBColsT];                           // dL/ds after the step
#pragma unroll
  for (int e = 0; e < kBColsT; ++e)
    G[e] = dsT != nullptr ? dsT[sbase + i * kHead + j0 + e] : 0.f;
  float du_acc = 0.f;              // row i's du (warp 0's lanes cq == 0)

  if (tid < 2) mbar_init(&sm.bar[tid], kThreads);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // Start chunk c's copies into ring buffer `buf`: 16-byte pieces, a
  // fixed share a thread; steps past S are not copied (and never read).
  constexpr int kPer = 16 / sizeof(T);                  // elements a piece
  constexpr int kRowP = kBRows / kPer, kWP = kBRows / 4;
  constexpr int kVP = kHead / kPer, kDP = kHead / 4, kSP = kBRows * kHead / 4;
  auto issue = [&](int c, int buf) {
    BwdStage<T>& st = sm.ring[buf];
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
    const size_t base =
        ((static_cast<size_t>(b) * S + t0) * H + hh) * kHead;   // (b, t0, h)
#pragma unroll
    for (int x = 0; x < (kChunk * kRowP + kThreads - 1) / kThreads; ++x) {
      const int p = tid + x * kThreads, t = p / kRowP, q = p % kRowP;
      if (p < kChunk * kRowP && t < len) {
        const size_t off = base + t * step_stride + i0 + q * kPer;
        cp_async16(&st.r[t][q * kPer], r + off);
        cp_async16(&st.k[t][q * kPer], k + off);
      }
    }
#pragma unroll
    for (int x = 0; x < (kChunk * kWP + kThreads - 1) / kThreads; ++x) {
      const int p = tid + x * kThreads, t = p / kWP, q = p % kWP;
      if (p < kChunk * kWP && t < len)
        cp_async16(&st.w[t][q * 4], w + base + t * step_stride + i0 + q * 4);
    }
#pragma unroll
    for (int x = 0; x < (kChunk * kVP + kThreads - 1) / kThreads; ++x) {
      const int p = tid + x * kThreads, t = p / kVP, q = p % kVP;
      if (p < kChunk * kVP && t < len)
        cp_async16(&st.v[t][q * kPer], v + base + t * step_stride + q * kPer);
    }
#pragma unroll
    for (int x = 0; x < (kChunk * kDP + kThreads - 1) / kThreads; ++x) {
      const int p = tid + x * kThreads, t = p / kDP, q = p % kDP;
      if (p < kChunk * kDP && t < len)
        cp_async16(&st.dy[t][q * 4], dy + base + t * step_stride + q * 4);
    }
    const float* hc =
        hs + ((static_cast<size_t>(bh) * n_chunks + c) * kHead + i0) * kHead;
#pragma unroll
    for (int x = 0; x < kSP / kThreads; ++x) {
      const int p = tid + x * kThreads;
      cp_async16(&st.s[0][0] + 4 * p, hc + 4 * p);
    }
    cp_async_arrive(&sm.bar[buf]);
  };

  // dv of chunk `it` (its start t0, its steps len): one (step, column) a
  // thread of the cluster, its blocks' shares in rank order, then dy times
  // sum_i r u k (the blocks' sums in rank order); dyk is the thread's dy,
  // kept from the chunk's stage
  const int te = (slice * kThreads + tid) / kHead;
  const int je = (slice * kThreads + tid) % kHead;
  auto reduce_dv = [&](int it, int t0, int len, float dyk) {
    if (te < len) {
      float sum = -0.f, ruk = -0.f;
#pragma unroll
      for (int rk = 0; rk < kBSlices; ++rk) {
        sum = __fadd_rn(sum, peer(&sm.cols[it & 1][te][je], rk)[0]);
        ruk = __fadd_rn(ruk, peer(&sm.ruk[it & 1][te], rk)[0]);
      }
      store_out(dv + ((static_cast<size_t>(b) * S + t0 + te) * H + hh) *
                         kHead + je,
                __fadd_rn(sum, __fmul_rn(dyk, ruk)));
    }
  };
  int t0_prev = 0, len_prev = 0;
  float dy_prev = 0.f;

  issue(n_chunks - 1, 0);
  for (int it = 0; it < n_chunks; ++it) {
    const int c = n_chunks - 1 - it;
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
    const BwdStage<T>& st = sm.ring[it & 1];
    mbar_wait(&sm.bar[it & 1], (it >> 1) & 1);

    // The chunk's states again, from the saved one at its start, half a
    // chunk at a time: sp[t] is the state before step kHalf hf + t.  The
    // second half goes first (its start recomputed through the first).
    float sp[kHalf][kBColsT];
    auto step_state = [&](int t, float (&s_)[kBColsT], float (&o)[kBColsT]) {
      const float wt = st.w[t][ir], kt = to_f32(st.k[t][ir]);
      const float4 v4 = load4(&st.v[t][j0]);
      const float vq[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < kBColsT; ++e)
        o[e] = __fadd_rn(__fmul_rn(wt, s_[e]), __fmul_rn(kt, vq[e]));
    };
    // Steps past S (only in the last chunk) are skipped; a whole chunk
    // compiles without the tests (kWhole).
    auto recompute = [&](int hf, auto kWhole) {
      const float4 s4 = *reinterpret_cast<const float4*>(&st.s[ir][j0]);
      sp[0][0] = s4.x, sp[0][1] = s4.y, sp[0][2] = s4.z, sp[0][3] = s4.w;
      if (hf == 1) {
#pragma unroll
        for (int t = 0; t < kHalf; ++t) step_state(t, sp[0], sp[0]);
      }
#pragma unroll
      for (int t = 0; t + 1 < kHalf; ++t)
        if (decltype(kWhole)::value || kHalf * hf + t + 1 < len)
          step_state(kHalf * hf + t, sp[t], sp[t + 1]);
    };
    float du_chunk = 0.f;
    // walked back over half hf
    auto walk = [&](int hf, auto kWhole) {
#pragma unroll
      for (int tl = kHalf - 1; tl >= 0; --tl) {
        const int t = kHalf * hf + tl;
        if (decltype(kWhole)::value || t < len) {
          const float rq = to_f32(st.r[t][ir]), kq = to_f32(st.k[t][ir]);
          const float wq = st.w[t][ir];
          const float4 v4 = load4(&st.v[t][j0]);
          const float4 d4 = *reinterpret_cast<const float4*>(&st.dy[t][j0]);
          const float vq[4] = {v4.x, v4.y, v4.z, v4.w};
          const float dq[4] = {d4.x, d4.y, d4.z, d4.w};
          float rs[4] = {0.f, 0.f, 0.f, 0.f};   // dr, dw, dk terms of the row
          float colp[kBColsT];
#pragma unroll
          for (int e = 0; e < kBColsT; ++e) {
            const float s_ = sp[tl][e], g = G[e];
            rs[0] = fmaf(dq[e], s_, rs[0]);
            rs[1] = fmaf(g, s_, rs[1]);
            rs[2] = fmaf(g, vq[e], rs[2]);
            colp[e] = __fmul_rn(g, kq);
            G[e] = __fadd_rn(__fmul_rn(wq, g), __fmul_rn(rq, dq[e]));
          }
          // the row's terms over its 4 lanes: lane cq keeps term cq
          int rb = 0;
          fold_sum<1, kBQuads / 2, 4>(rs, lane, rb);
          if (rb < 3) sm.rows[t][warp][ir][rb] = rs[0];
          // the columns over the warp's 8 rows: one column a lane pair
          int cb = 0;
          fold_sum<kBQuads, 16, kBColsT>(colp, lane, cb);
          if ((lane & kBQuads) == 0) sm.cols[it & 1][t][j0 + cb] = colp[0];
          if (warp == 0 && cq == 0)
            du_chunk = __fadd_rn(du_chunk,
                                 __fmul_rn(__fmul_rn(rq, kq), sm.dyv[t]));
        }
      }
    };
    const int top = len > kHalf ? 1 : 0;
    const bool whole = len == kChunk;
    if (whole)
      recompute(1, std::true_type{});
    else
      recompute(top, std::false_type{});
    // the peers are done with the chunk before (their shares of it are in
    // place, they have read this block's shares of the one before that),
    // and so is every thread of this block (the other ring buffer is free)
    if (it > 0) cluster_wait();
    if (c > 0) issue(c - 1, (it + 1) & 1);

    // a step's dy . v (a warp a step, 2 columns a lane) and the block's
    // sum of r u k (a step's 8 rows on 8 neighbouring lanes)
#pragma unroll
    for (int m = 0; m < kChunk / kBWarps; ++m) {
      const int t = warp + kBWarps * m;
      if (t >= len) break;
      float dv_ = fmaf(st.dy[t][lane + 32], to_f32(st.v[t][lane + 32]),
                       __fmul_rn(st.dy[t][lane], to_f32(st.v[t][lane])));
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        dv_ = __fadd_rn(dv_, __shfl_xor_sync(0xffffffffu, dv_, o));
      if (lane == 0) sm.dyv[t] = dv_;
    }
    {
      float p = ft < len ? __fmul_rn(__fmul_rn(to_f32(st.r[ft][fr]), uf),
                                     to_f32(st.k[ft][fr]))
                         : 0.f;
#pragma unroll
      for (int o = 1; o < kBRows; o <<= 1)
        p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, o));
      if (fr == 0 && ft < len) sm.ruk[it & 1][ft] = p;
    }
    __syncthreads();

    // the halves from the top down (one copy of each walk in the code)
    if (whole) {
#pragma unroll 1
      for (int hf = 1; hf >= 0; --hf) {
        if (hf == 0) recompute(0, std::true_type{});
        walk(hf, std::true_type{});
      }
    } else {
#pragma unroll 1
      for (int hf = top; hf >= 0; --hf) {
        if (hf != top) recompute(0, std::false_type{});
        walk(hf, std::false_type{});
      }
    }
    du_acc = __fadd_rn(du_acc, du_chunk);
    const float dy_keep = te < len ? st.dy[te][je] : 0.f;
    __syncthreads();

    // dr, dw, dk of (step ft, row i0 + fr): the warps' shares in order,
    // with the bonus terms
    if (ft < len) {
      float a[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        a[q] = sm.rows[ft][0][fr][q];
#pragma unroll
        for (int wp = 1; wp < kBWarps; ++wp)
          a[q] = __fadd_rn(a[q], sm.rows[ft][wp][fr][q]);
      }
      const float rq = to_f32(st.r[ft][fr]), kq = to_f32(st.k[ft][fr]);
      const float dyv = sm.dyv[ft];
      const size_t off = ((static_cast<size_t>(b) * S + t0 + ft) * H + hh) *
                             kHead + i0 + fr;
      store_out(dr + off, __fadd_rn(a[0], __fmul_rn(__fmul_rn(uf, kq), dyv)));
      dw[off] = a[1];
      store_out(dk + off, __fadd_rn(a[2], __fmul_rn(__fmul_rn(rq, uf), dyv)));
    }
    // the chunk before's dv, while the peers may still be walking this one
    if (it > 0) reduce_dv(it - 1, t0_prev, len_prev, dy_prev);
    t0_prev = t0, len_prev = len, dy_prev = dy_keep;
    cluster_arrive();
  }
  cluster_wait();
  reduce_dv(n_chunks - 1, t0_prev, len_prev, dy_prev);
  // no block leaves while a peer may still read its shared memory
  cluster_sync();
#pragma unroll
  for (int e = 0; e < kBColsT; ++e) ds0[sbase + i * kHead + j0 + e] = G[e];
  if (warp == 0 && cq == 0)
    du_part[(static_cast<size_t>(b) * H + hh) * kHead + i] = du_acc;
}

constexpr int kFinishThreads = 256;

// du: each (h, i)'s batch rows added in order.
__global__ void __launch_bounds__(kFinishThreads)
    wkv6_bwd_finish_kernel(const float* __restrict__ du_part,
                           float* __restrict__ du, int batch, int H) {
  const size_t i =
      static_cast<size_t>(blockIdx.x) * kFinishThreads + threadIdx.x;
  const size_t plane = static_cast<size_t>(H) * kHead;
  if (i < plane) {
    float s = du_part[i];
    for (int bb = 1; bb < batch; ++bb) s = __fadd_rn(s, du_part[bb * plane + i]);
    du[i] = s;
  }
}

// ---- launches ----------------------------------------------------------------

template <typename T, bool kSave>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0, float* y,
                   float* sT, float* hs, int batch, int S, int H,
                   cudaStream_t stream) {
  constexpr size_t smem = sizeof(Shared<T>);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, kSave>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * H * kSlices);
  wkv6_kernel<T, kSave><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, y, sT, hs, S, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0, float* y,
                   float* sT, float* hs, int batch, int S, int H,
                   cudaStream_t stream) {
  return hs != nullptr
             ? launch<T, true>(r, k, v, w, u, s0, y, sT, hs, batch, S, H,
                               stream)
             : launch<T, false>(r, k, v, w, u, s0, y, sT, hs, batch, S, H,
                                stream);
}

template <typename T>
cudaLaunchConfig_t bwd_config(int batch, int H, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * H * kBSlices);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(BwdShared<T>);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kBSlices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
cudaError_t launch_bwd(const void* r, const void* k, const void* v,
                       const float* w, const float* u, const float* hs,
                       const float* dy, const float* dsT, void* dr, void* dk,
                       void* dv, float* dw, float* du, float* ds0,
                       float* du_part, int batch, int S, int H,
                       cudaStream_t stream) {
  auto kernel = wkv6_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(BwdShared<T>)));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = bwd_config<T>(batch, H, stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(r),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           w, u, hs, dy, dsT, static_cast<T*>(dr),
                           static_cast<T*>(dk), static_cast<T*>(dv), dw, ds0,
                           du_part, S, H);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = (H * kHead + kFinishThreads - 1) / kFinishThreads;
  wkv6_bwd_finish_kernel<<<blocks, kFinishThreads, 0, stream>>>(
      du_part, du, batch, H);
  return cudaGetLastError();
}

// out: registers a thread, resident blocks an SM, threads a block, shared
// memory bytes a block, lanes a column group (forward) or lanes a row in
// a warp (backward), local memory bytes a thread (spills); the
// backward's cluster size and clusters resident at once on the device
template <typename K>
cudaError_t occupancy_of(K kernel, size_t smem, int lanes, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = blocks;
  out[2] = kThreads;
  out[3] = static_cast<int>(smem);
  out[4] = lanes;
  out[5] = 0;
  out[6] = 0;
  out[7] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

template <typename T>
cudaError_t bwd_occupancy(int* out) {
  auto kernel = wkv6_bwd_kernel<T>;
  cudaError_t err = occupancy_of(kernel, sizeof(BwdShared<T>), kBQuads, out);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = bwd_config<T>(1, 1, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  out[5] = kBSlices;
  out[6] = clusters;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launch K4 on `stream`.  r, k, v: (B, S, H, 64) float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); w, y (B, S, H, 64), u (H, 64), s0, sT (B, H,
// 64, 64) float32; all contiguous, r, k, v and w 16-byte aligned (else
// cudaErrorMisalignedAddress, with nothing launched).  hs, if not null,
// receives the state at every chunk's start: (B, H, ceil(S / 16), 64, 64)
// float32, its chunk 0 s0.  Returns the cudaError_t of the launch (0 =
// success).
int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* sT, void* hs,
             int is_bf16, int batch, int s_len, int n_heads, int device,
             void* stream) {
  // the staging copies move 16 bytes at a time
  const auto addr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  if ((addr(r) | addr(k) | addr(v) | addr(w)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(sT);
  float* hso = static_cast<float*>(hs);
  if (is_bf16)
    err = launch<__nv_bfloat16>(r, k, v, f32(w), f32(u), f32(s0), yo, so,
                                hso, batch, s_len, n_heads, st);
  else
    err = launch<float>(r, k, v, f32(w), f32(u), f32(s0), yo, so, hso,
                        batch, s_len, n_heads, st);
  return static_cast<int>(err);
}

// Launch K4's backward on `stream` (two kernels: the reverse walk, a head
// a cluster of 8 blocks, then the sum of du over batch rows).  r, k, v,
// w, u as the forward took them; hs the states the forward saved; dy (B,
// S, H, 64) float32; dsT (B, H, 64, 64) float32 or null (zero).  Out: dr,
// dk, dv (B, S, H, 64) in r's dtype; dw (B, S, H, 64), du (H, 64), ds0
// (B, H, 64, 64) float32.  Scratch: du_part (B, H, 64) float32.  All
// contiguous; r, k, v, w, dy and hs 16-byte aligned (else
// cudaErrorMisalignedAddress, with nothing launched).  Returns the
// cudaError_t of the launches (0 = success; a cluster launch the device
// cannot schedule returns its error, nothing falls back).
int wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* hs, const void* dy, const void* dsT,
             void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
             void* du_part, int is_bf16, int batch, int s_len, int n_heads,
             int device, void* stream) {
  const auto addr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  if ((addr(r) | addr(k) | addr(v) | addr(w) | addr(dy) | addr(hs)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  auto out = [](void* p) { return static_cast<float*>(p); };
  if (is_bf16)
    err = launch_bwd<__nv_bfloat16>(
        r, k, v, f32(w), f32(u), f32(hs), f32(dy), f32(dsT), dr, dk, dv,
        out(dw), out(du), out(ds0), out(du_part), batch, s_len, n_heads, st);
  else
    err = launch_bwd<float>(r, k, v, f32(w), f32(u), f32(hs), f32(dy),
                            f32(dsT), dr, dk, dv, out(dw), out(du), out(ds0),
                            out(du_part), batch, s_len, n_heads, st);
  return static_cast<int>(err);
}

// The instance that wkv6_fwd (backward = 0; the one that saves no state)
// or the reverse walk of wkv6_bwd (backward = 1) launches for `is_bf16`,
// on `device`: out[0] registers a thread, out[1] resident blocks an SM,
// out[2] threads a block, out[3] shared memory bytes a block, out[4]
// lanes a column group (forward) or lanes a row in a warp (backward),
// out[7] local memory bytes a thread (spills); the backward's out[5]
// cluster size and out[6] clusters resident at once on the device.
int wkv6_occupancy(int is_bf16, int backward, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (backward)
    err = is_bf16 ? bwd_occupancy<__nv_bfloat16>(out)
                  : bwd_occupancy<float>(out);
  else
    err = is_bf16 ? occupancy_of(wkv6_kernel<__nv_bfloat16, false>,
                                 sizeof(Shared<__nv_bfloat16>), kLanes, out)
                  : occupancy_of(wkv6_kernel<float, false>,
                                 sizeof(Shared<float>), kLanes, out);
  return static_cast<int>(err);
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
