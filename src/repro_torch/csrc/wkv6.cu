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
// A chunk's 16 states of a head (256 KB) do not fit in shared memory, so
// a head's rows are split over 2 blocks and a block keeps its half (128
// KB) of the chunk's states; w is never inverted to step a state back
// (it can be tiny).  Only dv sums across the head's blocks: each leaves
// its share and a second kernel adds them in order (no float atomics).
// K4-bwd's bound at (2, 4096, 32, 64): 14 float32 operations a state
// element and step (3 to recompute the state; dy s, G s, G v, G k each a
// product and a sum; G's update 3), 1.5e10, 0.224 ms; bytes 0.67 GB with
// the saved states, 0.200 ms.  One block of 4 warps an SM: a first
// design, right before fast.
//
// Bound: operations.  7 float32 operations a state element and step in
// the reference's grouping: at (2, 8192, 32, 64) 1.5e10, 0.224 ms at 67
// TFLOP/s; r, k, v, w and y once each in bf16 are about 0.47 GB, 0.141
// ms at 3.35 TB/s.  This design issues 4 float32 instructions a state
// element and step (kv, the FMA of y, w * s, + kv) plus 3 16-byte shared
// loads a row group and the shuffles; with 2 warps an SM scheduler it is
// bound by instruction latency and the shared-memory pipe, not by the
// float32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

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

constexpr int kBRows = 32;                    // state rows a block
constexpr int kBSlices = kHead / kBRows;      // blocks a head
constexpr int kBLanes = 8;                    // lanes a row group
constexpr int kBCols = kHead / kBLanes;       // columns a thread: l + 8 m
constexpr int kBRowsT = 2;                    // rows a thread
constexpr int kBGroupsW = 32 / kBLanes;       // row groups a warp
constexpr int kBWarps = kThreads / 32;
constexpr int kBElems = kBRowsT * kBCols;     // state elements a thread
static_assert(kBWarps * kBGroupsW * kBRowsT == kBRows &&
                  kBSlices * kBRows == kHead,
              "backward layout");

struct BwdShared {
  // s_{t-1} of a thread's elements at step t of the chunk, in its own
  // slots [t][e][thread] (so its stores and loads never meet another's)
  float st[kChunk][kBElems][kThreads];
  float r[kChunk][kHead];                     // the chunk's rows, float32
  float k[kChunk][kHead];
  float w[kChunk][kHead];
  float v[kChunk][kHead];
  float dy[kChunk][kHead];
  float u[kHead];
  float dyv[kChunk];                          // dy . v a step
  float ruk[kChunk];                          // sum_i r u k a step
  float col[kChunk][kBWarps][kHead];          // a warp's sum of g k
};

// K4's backward.  A head's 64 rows (key channels) over kBSlices blocks of
// kBRows; a thread holds kBRowsT rows x kBCols columns (the columns l +
// 8 m of its row group's 8 lanes), so the sums over a row (dr, dw, dk)
// are a thread's own then 3 shuffles, and only the sum over a column
// (dv) crosses row groups (2 shuffles), warps (shared memory, in order)
// and the head's blocks (dv_part, summed by wkv6_bwd_finish_kernel).  The
// chunks are walked from the last to the first: the chunk's states
// recomputed from the one the forward saved at its start (hs), with the
// forward's rounded operations, so with its bits, into shared memory;
// then G = dL/ds walked back through them in registers:
//   G_{t-1} = w_t G_t (by rows) + r_t dy_t^T,
// rounded one operation at a time as the plain loop rounds it.  du is a
// thread's sum over its steps (a chunk's first), left per batch row in
// du_part.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ hs,
                    const float* __restrict__ dy,
                    const float* __restrict__ dsT, T* __restrict__ dr,
                    T* __restrict__ dk, float* __restrict__ dw,
                    float* __restrict__ ds0, float* __restrict__ dv_part,
                    float* __restrict__ du_part, int batch, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdShared& sm = *reinterpret_cast<BwdShared*>(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x / kBSlices, slice = blockIdx.x % kBSlices;
  const int b = bh / H, hh = bh % H;
  const int lane = tid % 32, warp = tid / 32;
  const int l = lane % kBLanes, rg = lane / kBLanes;
  // the thread's first row; element e = q kBCols + m is (i0 + q, l + 8 m)
  const int i0 = slice * kBRows + (warp * kBGroupsW + rg) * kBRowsT;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const size_t sbase = static_cast<size_t>(bh) * kHead * kHead;
  const size_t step_stride = static_cast<size_t>(H) * kHead;

  float G[kBElems];                           // dL/ds after the step
#pragma unroll
  for (int e = 0; e < kBElems; ++e) {
    const size_t at =
        sbase + (i0 + e / kBCols) * kHead + l + kBLanes * (e % kBCols);
    G[e] = dsT != nullptr ? dsT[at] : 0.f;
  }
  if (tid < kHead) sm.u[tid] = u[hh * kHead + tid];
  float du_acc = 0.f;            // row i0 + l's du, for lanes l < kBRowsT

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
    const size_t base =
        ((static_cast<size_t>(b) * S + t0) * H + hh) * kHead;   // (b, t0, h)
    for (int p = tid; p < len * kHead; p += kThreads) {
      const int t = p / kHead, e = p % kHead;
      const size_t off = base + t * step_stride + e;
      sm.r[t][e] = to_f32(r[off]);
      sm.k[t][e] = to_f32(k[off]);
      sm.v[t][e] = to_f32(v[off]);
      sm.w[t][e] = w[off];
      sm.dy[t][e] = dy[off];
    }
    __syncthreads();

    // a step's dy . v and sum_i r u k: a warp a step, 2 channels a lane
    for (int t = warp; t < kChunk; t += kBWarps) {
      float dv_ = 0.f, ruk = 0.f;
      if (t < len) {
        dv_ = fmaf(sm.dy[t][lane + 32], sm.v[t][lane + 32],
                   sm.dy[t][lane] * sm.v[t][lane]);
        ruk = fmaf(sm.r[t][lane + 32] * sm.u[lane + 32], sm.k[t][lane + 32],
                   sm.r[t][lane] * sm.u[lane] * sm.k[t][lane]);
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        dv_ += __shfl_xor_sync(0xffffffffu, dv_, o);
        ruk += __shfl_xor_sync(0xffffffffu, ruk, o);
      }
      if (lane == 0) {
        sm.dyv[t] = dv_;
        sm.ruk[t] = ruk;
      }
    }

    // the chunk's states again, from the saved one at its start
    {
      float s[kBElems];
      const float* hc =
          hs + (static_cast<size_t>(bh) * n_chunks + c) * kHead * kHead;
#pragma unroll
      for (int e = 0; e < kBElems; ++e)
        s[e] = hc[(i0 + e / kBCols) * kHead + l + kBLanes * (e % kBCols)];
      for (int t = 0; t < len; ++t) {
#pragma unroll
        for (int e = 0; e < kBElems; ++e) {
          const int i = i0 + e / kBCols, j = l + kBLanes * (e % kBCols);
          sm.st[t][e][tid] = s[e];
          s[e] = __fadd_rn(__fmul_rn(sm.w[t][i], s[e]),
                           __fmul_rn(sm.k[t][i], sm.v[t][j]));
        }
      }
    }
    __syncthreads();

    // walked back
    float du_chunk = 0.f;
    for (int t = len - 1; t >= 0; --t) {
      float vv[kBCols], dd[kBCols], colp[kBCols];
#pragma unroll
      for (int m = 0; m < kBCols; ++m) {
        vv[m] = sm.v[t][l + kBLanes * m];
        dd[m] = sm.dy[t][l + kBLanes * m];
        colp[m] = 0.f;
      }
      float rs[kBRowsT][3];                   // a row's dr, dw, dk terms
#pragma unroll
      for (int q = 0; q < kBRowsT; ++q) {
        const int i = i0 + q;
        const float rq = sm.r[t][i], kq = sm.k[t][i], wq = sm.w[t][i];
        float adr = 0.f, adw = 0.f, adk = 0.f;
#pragma unroll
        for (int m = 0; m < kBCols; ++m) {
          const int e = q * kBCols + m;
          const float sp = sm.st[t][e][tid], g = G[e];
          adr = fmaf(dd[m], sp, adr);
          adw = fmaf(g, sp, adw);
          adk = fmaf(g, vv[m], adk);
          colp[m] = fmaf(g, kq, colp[m]);
          G[e] = __fadd_rn(__fmul_rn(wq, g), __fmul_rn(rq, dd[m]));
        }
        rs[q][0] = adr;
        rs[q][1] = adw;
        rs[q][2] = adk;
      }
#pragma unroll
      for (int o = 1; o < kBLanes; o <<= 1)
#pragma unroll
        for (int q = 0; q < kBRowsT; ++q)
#pragma unroll
          for (int x = 0; x < 3; ++x)
            rs[q][x] += __shfl_xor_sync(0xffffffffu, rs[q][x], o);
      const float dyv = sm.dyv[t];
#pragma unroll
      for (int q = 0; q < kBRowsT; ++q) {
        if (l == q) {
          const int i = i0 + q;
          const float rq = sm.r[t][i], kq = sm.k[t][i], uq = sm.u[i];
          const size_t off = base + t * step_stride + i;
          store_out(dr + off,
                    __fadd_rn(rs[q][0], __fmul_rn(__fmul_rn(uq, kq), dyv)));
          dw[off] = rs[q][1];
          store_out(dk + off,
                    __fadd_rn(rs[q][2], __fmul_rn(__fmul_rn(rq, uq), dyv)));
          du_chunk = __fadd_rn(du_chunk, __fmul_rn(__fmul_rn(rq, kq), dyv));
        }
      }
#pragma unroll
      for (int m = 0; m < kBCols; ++m) {
        colp[m] += __shfl_xor_sync(0xffffffffu, colp[m], kBLanes);
        colp[m] += __shfl_xor_sync(0xffffffffu, colp[m], 2 * kBLanes);
      }
      if (rg == 0) {
#pragma unroll
        for (int m = 0; m < kBCols; ++m)
          sm.col[t][warp][l + kBLanes * m] = colp[m];
      }
    }
    du_acc = __fadd_rn(du_acc, du_chunk);
    __syncthreads();

    // this block's share of dv: the warps' sums in order; block 0 of the
    // head adds the bonus term dy ruk
    for (int p = tid; p < len * kHead; p += kThreads) {
      const int t = p / kHead, j = p % kHead;
      float x = sm.col[t][0][j];
#pragma unroll
      for (int wp = 1; wp < kBWarps; ++wp) x = __fadd_rn(x, sm.col[t][wp][j]);
      if (slice == 0) x = __fadd_rn(x, __fmul_rn(sm.dy[t][j], sm.ruk[t]));
      dv_part[((static_cast<size_t>(slice) * batch + b) * S + t0 + t) *
                  step_stride +
              hh * kHead + j] = x;
    }
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < kBElems; ++e)
    ds0[sbase + (i0 + e / kBCols) * kHead + l + kBLanes * (e % kBCols)] =
        G[e];
  if (l < kBRowsT)
    du_part[(static_cast<size_t>(b) * H + hh) * kHead + i0 + l] = du_acc;
}

constexpr int kFinishThreads = 256;

// dv: each element's block partials added in block order; du: each (h, i)'s
// batch rows added in order.
template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
    wkv6_bwd_finish_kernel(const float* __restrict__ dv_part,
                           const float* __restrict__ du_part,
                           T* __restrict__ dv, float* __restrict__ du,
                           int batch, int S, int H) {
  const size_t i =
      static_cast<size_t>(blockIdx.x) * kFinishThreads + threadIdx.x;
  const size_t n = static_cast<size_t>(batch) * S * H * kHead;
  if (i < n) {
    float x = dv_part[i];
#pragma unroll
    for (int sl = 1; sl < kBSlices; ++sl) x = __fadd_rn(x, dv_part[sl * n + i]);
    store_out(dv + i, x);
  }
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
cudaError_t launch_bwd(const void* r, const void* k, const void* v,
                       const float* w, const float* u, const float* hs,
                       const float* dy, const float* dsT, void* dr, void* dk,
                       void* dv, float* dw, float* du, float* ds0,
                       float* dv_part, float* du_part, int batch, int S,
                       int H, cudaStream_t stream) {
  constexpr size_t smem = sizeof(BwdShared);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  wkv6_bwd_kernel<T><<<batch * H * kBSlices, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, hs, dy, dsT, static_cast<T*>(dr),
      static_cast<T*>(dk), dw, ds0, dv_part, du_part, batch, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t work = std::max(static_cast<size_t>(batch) * S * H * kHead,
                               static_cast<size_t>(H) * kHead);
  const size_t blocks = (work + kFinishThreads - 1) / kFinishThreads;
  if (blocks > 0x7fffffffULL) return cudaErrorInvalidConfiguration;
  wkv6_bwd_finish_kernel<T>
      <<<static_cast<unsigned>(blocks), kFinishThreads, 0, stream>>>(
          dv_part, du_part, static_cast<T*>(dv), du, batch, S, H);
  return cudaGetLastError();
}

// out: registers a thread, resident blocks an SM, threads a block, shared
// memory bytes a block, lanes a column group (forward) or row group
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

// Launch K4's backward on `stream` (two kernels: the reverse walk, then
// the sums over a head's blocks and over batch rows).  r, k, v, w, u as
// the forward took them; hs the states the forward saved; dy (B, S, H,
// 64) float32; dsT (B, H, 64, 64) float32 or null (zero).  Out: dr, dk,
// dv (B, S, H, 64) in r's dtype; dw (B, S, H, 64), du (H, 64), ds0 (B, H,
// 64, 64) float32.  Scratch: dv_part (part_slices, B, S, H, 64) and
// du_part (B, H, 64) float32, part_slices = 2.  All contiguous.  Returns
// the cudaError_t of the launches (0 = success).
int wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* hs, const void* dy, const void* dsT,
             void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
             void* dv_part, void* du_part, int part_slices, int is_bf16,
             int batch, int s_len, int n_heads, int device, void* stream) {
  if (part_slices != kBSlices) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  auto out = [](void* p) { return static_cast<float*>(p); };
  if (is_bf16)
    err = launch_bwd<__nv_bfloat16>(
        r, k, v, f32(w), f32(u), f32(hs), f32(dy), f32(dsT), dr, dk, dv,
        out(dw), out(du), out(ds0), out(dv_part), out(du_part), batch, s_len,
        n_heads, st);
  else
    err = launch_bwd<float>(r, k, v, f32(w), f32(u), f32(hs), f32(dy),
                            f32(dsT), dr, dk, dv, out(dw), out(du), out(ds0),
                            out(dv_part), out(du_part), batch, s_len, n_heads,
                            st);
  return static_cast<int>(err);
}

// The instance that wkv6_fwd (backward = 0; the one that saves no state)
// or the reverse walk of
// wkv6_bwd (backward = 1) launches for `is_bf16`, on `device`: out[0]
// registers a thread, out[1] resident blocks an SM, out[2] threads a
// block, out[3] shared memory bytes a block, out[4] lanes a column group
// (forward) or a row group (backward).
int wkv6_occupancy(int is_bf16, int backward, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (backward)
    err = is_bf16 ? occupancy_of(wkv6_bwd_kernel<__nv_bfloat16>,
                                 sizeof(BwdShared), kBLanes, out)
                  : occupancy_of(wkv6_bwd_kernel<float>, sizeof(BwdShared),
                                 kBLanes, out);
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
