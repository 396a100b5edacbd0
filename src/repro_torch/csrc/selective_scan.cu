// K3: the selective scan of hymba's SSM heads, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference's recurrence is a lax.scan over
// time, src/repro/models/ssm.py::_ssm_recurrence (:39-57).  In eager torch
// that loop would launch a few kernels per token and layer (about 1.5 M
// for a 2 x 8192 hymba prefill), so the port runs it as one kernel.
//
// Per batch row b, channel d and state n, in the reference's order:
//   decay  = exp(dt[b,t,d] * A[d,n])
//   h[n]   = h[n] * decay + (dt[b,t,d] * x[b,t,d]) * B[b,t,n]
//   y      = sum over n = 0, 1, ... of h[n] * C[b,t,n]
// all in float32, each product and sum rounded on its own (__fmul_rn,
// __fadd_rn: no contraction into FMAs; expf is the CUDA math library's,
// as torch.exp's), so the state and y evolve with the plain version's
// bits; y is rounded once to x's dtype.  A state's chain never reads
// another state, so any split of the states across threads keeps them.
// Layouts, all contiguous: x, dt, y (B, S, Di); B, C (B, S, N); A (Di, N);
// h0, hT (B, Di, N).  x and y are float32 or bfloat16; the rest float32.
//
// Design.  One lane per (channel, state): N lanes a channel, 32 / N
// channels a warp, kThreads / N channels a block (N is a template
// parameter, 4, 8 or 16), each lane holding h[n] and A[d, n] in
// registers, so the h chain is one multiply and one add a step and the
// exponential, dt * x and u * B lie off it.  The time axis is staged in
// chunks of kChunk steps through a ring of kRing buffers filled by
// cp.async (4-byte copies, a fixed share a thread: any Di, any alignment;
// bf16 x as the 32-bit words that cover each row's channels), each
// completing on its own mbarrier, so chunk c + 1 is in flight while chunk
// c is computed.  The copies transpose dt, B and C to a row a channel or
// state, so a lane reads 4 steps with one 16-byte load.  Per chunk: u = dt
// * x once a (step, channel); the scan, which keeps each step's products
// h[n] * C[n] in shared memory (4 steps a 16-byte store); then a pass in
// which one thread a channel and 4 steps adds them in n order from 0
// upward (plain's order, without N serial shuffles a step) and writes y.
// At hymba's prefill (B 2, Di 3200, N 16) that is 800 blocks of 4 warps,
// 6 or 7 resident an SM.  Decode (S = 1) issues one chunk of one step.
//
// Training.  With hs given, the forward also writes the state at every
// chunk's start (B, ceil(S / kChunk), Di, N), and K3-bwd (below) takes
// it.  It replaces JAX's autodiff transpose of the same lax.scan (ssm.py
// :55), also no Pallas kernel; autograd through the per-token loop in
// torch would keep every step's state (~54 GB at hymba's 2 x 4096) and
// launch several kernels a token.  With a_t = exp(dt_t A), u_t = dt_t x_t
// and g_t = dL/dh_t (from dhT at the end):
//   g_t = dy_t C_t + a_{t+1} g_{t+1},  dC_t = sum_d dy_t h_t,
//   dB_t = sum_d g_t u_t,  du_t = sum_n g_t B_t,  z_t = g_t h_{t-1} a_t,
//   ddt_t = sum_n z_t A + du_t x_t,  dA = sum_{b,t} z_t dt_t,
//   dx_t = du_t dt_t (rounded once to x's dtype),  dh0 = a_1 g_1.
// The sums over channels (dB, dC) span 400 blocks a batch row at hymba's
// Di.  Each block of 4 warps keeps a chunk's recomputed h in 16.5 KB of
// shared memory (31 KB a block in all, so 7 blocks, 28 warps, are
// resident an SM and hymba's 800 blocks run in one wave), and the blocks
// of a row run in thread block clusters of 8: after each chunk a
// cluster's blocks add their shares of dB and dC through distributed
// shared memory, so only a cluster's share leaves the kernel (50 a batch
// row, 52 MB at the train shape), and a second kernel adds the clusters'
// shares in cluster order, compensated, so two runs give the same bits
// (no float atomics).  K3-bwd's bound at (2, 4096, 3200, 16): bytes, 0.42
// GB (x, dy, dx in bf16, dt, ddt, the saved states) 0.126 ms; 7.5e9
// float32 operations (18 a lane and step) 0.113 ms; the forward's
// exponentials again, 4.19e8, 0.100 ms.  This design issues about 60
// instructions a lane and step (two expf, the recomputed state's and
// the walk's; the walk's shuffle folds a quarter of them): it is bound by
// instruction issue and by the cluster's barrier after each chunk.
//
// Bound: the exponentials.  B S Di N of them, at 16 MUFU.EX2 results a
// clock an SM (132 SMs, 1.98 GHz boost): at (2, 8192, 3200, 16) 8.4e8,
// 0.203 ms; x, dt and y once each plus B and C are about 0.42 GB in bf16,
// 0.125 ms at 3.35 TB/s; the float32 operations (7 N + 1 a channel and
// step: 5.9e9) 0.088 ms at 67 TFLOP/s.  This design issues about 16
// instructions a state and step (expf's 9 of them, one MUFU.EX2) and the
// ordered sum about 1 more: it is bound by instruction issue, with the
// SFU about a quarter busy.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// kChunk and kRing chosen by measurement (PERF.md)
constexpr int kThreads = 128;            // threads a block
constexpr int kChunk = 32;               // time steps a ring buffer
constexpr int kRing = 2;                 // ring buffers
constexpr int kRow = kChunk + 4;         // a transposed row's floats: the
                                         // pad spreads 16-byte loads of
                                         // 8 rows over the 32 banks
static_assert(kChunk % 4 == 0, "steps are read 4 at a time");

template <int N>
struct Cfg {
  static constexpr int kCh = kThreads / N;        // channels a block
  static constexpr int kXw = kCh / 2 + 1;         // words of a bf16 x row
  // floats between the products of states n and n + 1: a channel's
  // kChunk products of one state are contiguous (a lane stores 4 steps at
  // once, a thread of the sum reads 4), and the pad of 4 puts the 8
  // states of a quarter warp's 16-byte stores on distinct banks
  static constexpr int kProd = kCh * kChunk + 4;
};

// One ring buffer: a chunk's inputs as cp.async left them, dt, B and C
// (and float32 x) transposed to a row a channel or state, so that a lane
// reads 4 steps with one 16-byte load.
template <int N>
struct Stage {
  alignas(16) float dt[Cfg<N>::kCh][kRow];
  alignas(16) float x[Cfg<N>::kCh][kRow];   // float32 x, or bf16 x as
                                            // kChunk rows of kXw words
  alignas(16) float B[N][kRow];
  alignas(16) float C[N][kRow];
};

template <int N>
struct Shared {
  Stage<N> ring[kRing];
  alignas(16) float u[Cfg<N>::kCh][kRow];      // dt * x
  alignas(16) float prod[N * Cfg<N>::kProd];   // h[n] * C[n]
  uint64_t bar[kRing];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (0..4) of `src` to `dst` and zero the rest of its 4 bytes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
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

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One step of a lane's state: h[n] and its product with C[n].
__device__ __forceinline__ float step(float& h, float a, float dt, float u,
                                      float b, float c) {
  const float decay = expf(__fmul_rn(dt, a));
  h = __fadd_rn(__fmul_rn(h, decay), __fmul_rn(u, b));
  return __fmul_rn(h, c);
}

// kSave: also write the state at every chunk's start to hs (training);
// the serving instance compiles without the store.
template <typename T, int N, bool kSave>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const T* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ Bc,
                          const float* __restrict__ Cc,
                          const float* __restrict__ A,
                          const float* __restrict__ h0, T* __restrict__ y,
                          float* __restrict__ hT, float* __restrict__ hs,
                          int S, int Di, int d_blocks) {
  using Cf = Cfg<N>;
  constexpr int kCh = Cf::kCh;
  constexpr bool kBf16 = sizeof(T) == 2;
  __shared__ __align__(16) Shared<N> sm;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / d_blocks;
  const int d0 = (blockIdx.x % d_blocks) * kCh;
  const int cl = tid / N, n = tid % N;          // the lane's channel, state
  const int d = d0 + cl;
  const bool live = d < Di;
  const size_t row0 = static_cast<size_t>(b) * S;   // row (b, t = 0)
  const int n_chunks = (S + kChunk - 1) / kChunk;
  // x's bytes, for bf16 rows staged as the aligned words that cover them
  const uintptr_t x_lo = reinterpret_cast<uintptr_t>(x);
  const uintptr_t x_hi = x_lo + sizeof(T) * static_cast<size_t>(gridDim.x /
                                  d_blocks) * S * Di;

  const float a = live ? A[static_cast<size_t>(d) * N + n] : 0.f;
  float h = live ? h0[(static_cast<size_t>(b) * Di + d) * N + n] : 0.f;

  if (tid < kRing) mbar_init(&sm.bar[tid], kThreads);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // A thread's share of a chunk's (step, channel) tile is the elements
  // p = tid + k kThreads, k < kTileK, the same in every chunk (so the
  // loops below have fixed trip counts and their offsets are hoisted).
  constexpr int kTile = kChunk * kCh;
  constexpr int kTileK = (kTile + kThreads - 1) / kThreads;
  constexpr int kBcK = (kChunk * N + kThreads - 1) / kThreads;
  constexpr int kXwK = (kChunk * Cf::kXw + kThreads - 1) / kThreads;

  // Start chunk c's copies into ring buffer c % kRing.  Channels past Di
  // are zero-filled; steps past S are not copied (and never read).
  auto issue = [&](int c) {
    Stage<N>& st = sm.ring[c % kRing];
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
    const size_t base = (row0 + t0) * Di + d0;          // (b, t0, d0)
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const int p = tid + k * kThreads, t = p / kCh, cc = p % kCh;
      if (p < kTile && t < len) {
        const bool ok = d0 + cc < Di;
        const size_t off = base + static_cast<size_t>(t) * Di + cc;
        cp_async4(&st.dt[cc][t], ok ? dt + off : dt, ok ? 4 : 0);
        if constexpr (!kBf16)
          cp_async4(&st.x[cc][t], ok ? x + off : dt, ok ? 4 : 0);
      }
    }
    if constexpr (kBf16) {
      float* words = &st.x[0][0];
#pragma unroll
      for (int k = 0; k < kXwK; ++k) {
        const int p = tid + k * kThreads;
        const int t = p / Cf::kXw, q = p % Cf::kXw;
        if (p < kChunk * Cf::kXw && t < len) {
          const uintptr_t start =
              x_lo + 2 * (base + static_cast<size_t>(t) * Di);
          const uintptr_t word = (start & ~uintptr_t{3}) + 4 * q;
          const int bytes = word >= x_hi       ? 0
                            : x_hi - word >= 4 ? 4
                                               : static_cast<int>(x_hi - word);
          cp_async4(words + p,
                    bytes ? reinterpret_cast<const void*>(word) : dt, bytes);
        }
      }
    }
    const size_t bc = (row0 + t0) * N;
#pragma unroll
    for (int k = 0; k < kBcK; ++k) {
      const int p = tid + k * kThreads;
      if (p < len * N) {
        cp_async4(&st.B[p % N][p / N], Bc + bc + p, 4);
        cp_async4(&st.C[p % N][p / N], Cc + bc + p, 4);
      }
    }
    cp_async_arrive(&sm.bar[c % kRing]);
  };

  // y of a chunk: its products added in n order from 0 upward, one
  // thread a channel and 4 steps
  constexpr int kQuads = kChunk / 4;
  constexpr int kSum = kCh * kQuads;
  constexpr int kSumK = (kSum + kThreads - 1) / kThreads;

  for (int c = 0; c < kRing - 1 && c < n_chunks; ++c) issue(c);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + kRing - 1 < n_chunks) issue(c + kRing - 1);
    mbar_wait(&sm.bar[c % kRing], (c / kRing) & 1);
    const Stage<N>& st = sm.ring[c % kRing];
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
    // for training: the state at the chunk's start (the backward's anchor)
    if constexpr (kSave) {
      if (live)
        hs[((static_cast<size_t>(b) * n_chunks + c) * Di + d) * N + n] = h;
    }

    // u = dt * x once a (step, channel)
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const int p = tid + k * kThreads, t = p / kCh, cc = p % kCh;
      if (p < kTile && t < len) {
        float xv;
        if constexpr (kBf16) {
          // a row's first channel sits in the low or high half of its
          // first word: the same in every chunk (t0 Di is even)
          const uintptr_t start = x_lo + 2 * ((row0 + t) * Di + d0);
          const int shift = static_cast<int>((start >> 1) & 1);
          xv = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
              &st.x[0][0] + t * Cf::kXw)[shift + cc]);
        } else {
          xv = st.x[cc][t];
        }
        sm.u[cc][t] = __fmul_rn(st.dt[cc][t], xv);
      }
    }
    __syncthreads();

    // the scan: h[n] through the chunk, its products with C[n] kept
    float* prod = sm.prod + n * Cf::kProd + cl * kChunk;
    if (len == kChunk) {
#pragma unroll
      for (int t = 0; t < kChunk; t += 4) {
        const float4 dt4 = *reinterpret_cast<const float4*>(&st.dt[cl][t]);
        const float4 u4 = *reinterpret_cast<const float4*>(&sm.u[cl][t]);
        const float4 b4 = *reinterpret_cast<const float4*>(&st.B[n][t]);
        const float4 c4 = *reinterpret_cast<const float4*>(&st.C[n][t]);
        float4 p4;
        p4.x = step(h, a, dt4.x, u4.x, b4.x, c4.x);
        p4.y = step(h, a, dt4.y, u4.y, b4.y, c4.y);
        p4.z = step(h, a, dt4.z, u4.z, b4.z, c4.z);
        p4.w = step(h, a, dt4.w, u4.w, b4.w, c4.w);
        *reinterpret_cast<float4*>(prod + t) = p4;
      }
    } else {
      for (int t = 0; t < len; ++t)
        prod[t] = step(h, a, st.dt[cl][t], sm.u[cl][t], st.B[n][t],
                       st.C[n][t]);
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kSumK; ++k) {
      const int p = tid + k * kThreads, cc = p / kQuads, q = p % kQuads;
      if (p < kSum && 4 * q < len) {
        const float* pr = sm.prod + cc * kChunk + 4 * q;
        float4 acc = *reinterpret_cast<const float4*>(pr);
#pragma unroll
        for (int m = 1; m < N; ++m) {
          const float4 v =
              *reinterpret_cast<const float4*>(pr + m * Cf::kProd);
          acc.x = __fadd_rn(acc.x, v.x);
          acc.y = __fadd_rn(acc.y, v.y);
          acc.z = __fadd_rn(acc.z, v.z);
          acc.w = __fadd_rn(acc.w, v.w);
        }
        if (d0 + cc < Di) {
          T* yo = y + (row0 + t0 + 4 * q) * Di + d0 + cc;
          const float out[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (4 * q + i < len)
              store_f32(yo + static_cast<size_t>(i) * Di, out[i]);
        }
      }
    }
  }
  if (live) hT[(static_cast<size_t>(b) * Di + d) * N + n] = h;
}

// ---- K3's backward ---------------------------------------------------------

// sum += v, compensated (Kahan), each operation rounded on its own
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float v) {
  const float y = __fsub_rn(v, comp);
  const float t = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

// The thread block cluster: a block's rank, its peers' shared memory, and
// the cluster's barrier, whole or as its two halves (so that a block goes
// on with its own work while its peers still read its shared memory).
__device__ __forceinline__ int cluster_size() {
  return static_cast<int>(cg::this_cluster().num_blocks());
}
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

__device__ __forceinline__ float pick(const float (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// K3-bwd: blocks resident an SM (the launch bound: 72 registers a thread)
constexpr int kBwdBlocksPerSm = 7;
constexpr int kMaxCluster = 8;           // the portable cluster size
constexpr int kWarps = kThreads / 32;

// a step quad's place in a B or C row: quad q of state n is stored at
// q ^ (n % 8), so that the 8 states of a 16-byte load phase read 8
// different bank groups
__device__ __forceinline__ int swz(int n, int t) {
  return (((t >> 2) ^ (n & 7)) << 2) | (t & 3);
}

// One ring buffer of K3-bwd: a chunk's inputs as cp.async left them; dt
// and float32 x and dy transposed to a row a channel, bf16 x and dy as
// the 32-bit words that cover each step's channels.
template <typename T, int N>
struct BwdStage {
  static constexpr int kXF = sizeof(T) == 4 ? Cfg<N>::kCh * kChunk
                                            : kChunk * Cfg<N>::kXw;
  alignas(16) float dt[Cfg<N>::kCh][kChunk];
  alignas(16) float x[kXF];
  alignas(16) float dy[kXF];
  alignas(16) float B[N][kChunk];        // quads swizzled (swz)
  alignas(16) float C[N][kChunk];
};

template <typename T, int N>
struct BwdShared {
  static constexpr int kWide = sizeof(T) == 2 ? Cfg<N>::kCh * kChunk : 4;
  BwdStage<T, N> ring[kRing];
  // a lane's h before step t at [t][thread].  The walk back reuses row t
  // + 1 once every lane of a warp has read it: the warp's shares of dB_t
  // and dC_t at [t + 1][warp * 32 + q N + n] (q 0: dB, 1: dC), then the
  // block's at [t + 1][q N + n], which the cluster's blocks read.
  alignas(16) float hist[kChunk + 1][kThreads];
  // bf16 x and dy of the chunk walked, widened and transposed to a row a
  // channel, each warp its own channels
  alignas(16) float xw[kWide];
  alignas(16) float dyw[kWide];
  uint64_t bar[kRing];
};

// Widen the warp's channels of a chunk's bf16 x (or dy) rows (`words`,
// from its stage) into `wide`, a row a channel; `par` is the parity of
// the bf16 index of the block's first channel at step 0, `odd` 1 when Di
// is odd.
template <int N>
__device__ __forceinline__ void widen(const float* words, float* wide,
                                      int warp, int lane, int len, int par,
                                      int odd) {
  constexpr int kChW = 32 / N;                  // channels a warp
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(words);
#pragma unroll
  for (int p = lane; p < kChW * kChunk; p += 32) {
    const int cc = warp * kChW + p / kChunk, t = p % kChunk;
    if (t < len)
      wide[cc * kChunk + t] = __bfloat162float(
          h[2 * Cfg<N>::kXw * t + (par ^ (t & odd)) + cc]);
  }
}

__device__ __forceinline__ void row_quad(const float* row, int q,
                                         float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(row + 4 * q);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}

// K3's backward.  The forward's layout (a lane a channel and state, kCh
// channels a block), its chunks walked from the last to the first, chunk
// c - 1's inputs staged by cp.async into a ring of 2 while chunk c is
// walked (bf16 x and dy widened by each warp for its own channels).  A
// chunk's states are recomputed from the one the forward saved at its
// start (hs, read into a register a chunk ahead) with the forward's
// rounded operations, so with its bits, into `hist`; then the chunk is
// walked back a quad of steps at a time, g_t = dy_t C_t + a_{t+1} g_{t+1}
// carried in a register (plain's rounded update), a_t recomputed.  Whole
// quads compile without the tests for steps past S.  The sums, in fixed
// orders:
// - du_t and sum_n z_t A over a channel's N lanes by `fold_sum` over 4
//   steps at once (a shuffle tree whose rounds fold 8 sums to one); the
//   lane left with du_t takes sum_n z A from its partner and writes ddt_t
//   = sum_n z A + du_t x_t and dx_t = du_t dt_t;
// - dB_t and dC_t over the block's channels: g u and dy h folded over a
//   warp's channels, the warps' shares left in `hist`, then added in warp
//   order after the chunk; the cluster's blocks (consecutive along the
//   channels of one batch row) add the blocks' shares in rank order
//   through distributed shared memory, one output a thread, into the
//   cluster's share (`part`); selective_scan_bwd_finish_kernel adds the
//   clusters' shares in order, compensated;
// - dA: a lane's sum over the chunk's steps (descending), then over the
//   chunks, left per batch row in dA_part.
// Each row of blocks is padded to a whole number of clusters; a padded
// block owns no channel and only joins the cluster's barriers.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
    selective_scan_bwd_kernel(
        const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ Bc, const float* __restrict__ Cc,
        const float* __restrict__ A, const float* __restrict__ hs,
        const T* __restrict__ dy, const float* __restrict__ dhT,
        T* __restrict__ dx, float* __restrict__ ddt,
        float* __restrict__ part, float* __restrict__ dA_part,
        float* __restrict__ dh0, int batch, int S, int Di, int d_pad) {
  using Cf = Cfg<N>;
  constexpr int kCh = Cf::kCh;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdShared<T, N>& sm = *reinterpret_cast<BwdShared<T, N>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / d_pad, blk = blockIdx.x % d_pad;
  const int cs = cluster_size();
  const int rank = blk % cs, blk0 = blk - rank;   // the cluster's first
  const int d0 = blk * kCh;
  const bool active = d0 < Di;                    // owns a channel
  const int cl = tid / N, n = tid % N;            // the lane's channel, state
  const int d = d0 + cl;
  const bool live = d < Di;
  const size_t row0 = static_cast<size_t>(b) * S;   // row (b, t = 0)
  const int n_chunks = (S + kChunk - 1) / kChunk;
  // the lane's element of a (B, Di, N) array, and of hs's chunk c
  auto lane_at = [&]() { return (static_cast<size_t>(b) * Di + d) * N + n; };
  auto hs_at = [&](int c) {
    return ((static_cast<size_t>(b) * n_chunks + c) * Di + d) * N + n;
  };
  const float a = live ? A[static_cast<size_t>(d) * N + n] : 0.f;
  // a_{t+1} g_{t+1}, from dL/dhT at the end
  float carry = (live && dhT != nullptr) ? dhT[lane_at()] : 0.f;
  float dA_acc = 0.f;
  // bf16 x and dy: the bytes of each tensor, for rows staged as the
  // aligned words that cover them
  const uintptr_t x_lo = reinterpret_cast<uintptr_t>(x);
  const uintptr_t dy_lo = reinterpret_cast<uintptr_t>(dy);
  const int odd = Di & 1;

  if (tid < kRing) mbar_init(&sm.bar[tid], kThreads);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  constexpr int kTile = kChunk * kCh;
  constexpr int kTileK = (kTile + kThreads - 1) / kThreads;
  constexpr int kBcK = (kChunk * N + kThreads - 1) / kThreads;
  constexpr int kXwK = (kChunk * Cf::kXw + kThreads - 1) / kThreads;

  // bf16 rows of one tensor as the aligned words that cover them
  auto copy_words = [&](float* words, uintptr_t lo, size_t base, int len) {
    const uintptr_t hi = lo + 2 * static_cast<size_t>(batch) * S * Di;
#pragma unroll
    for (int k = 0; k < kXwK; ++k) {
      const int p = tid + k * kThreads;
      const int t = p / Cf::kXw, q = p % Cf::kXw;
      if (p < kChunk * Cf::kXw && t < len) {
        const uintptr_t start = lo + 2 * (base + static_cast<size_t>(t) * Di);
        const uintptr_t word = (start & ~uintptr_t{3}) + 4 * q;
        const int bytes = word >= hi       ? 0
                          : hi - word >= 4 ? 4
                                           : static_cast<int>(hi - word);
        cp_async4(words + p, bytes ? reinterpret_cast<const void*>(word) : dt,
                  bytes);
      }
    }
  };
  // Start chunk c's copies into ring buffer `buf`.  Channels past Di are
  // zero-filled; steps past S are not copied (and never read).
  auto issue = [&](int c, int buf) {
    BwdStage<T, N>& st = sm.ring[buf];
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
    const size_t base = (row0 + t0) * Di + d0;          // (b, t0, d0)
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const int p = tid + k * kThreads, t = p / kCh, cc = p % kCh;
      if (p < kTile && t < len) {
        const bool ok = d0 + cc < Di;
        const size_t off = base + static_cast<size_t>(t) * Di + cc;
        cp_async4(&st.dt[cc][t], ok ? dt + off : dt, ok ? 4 : 0);
        if constexpr (!kBf16) {
          cp_async4(&st.x[cc * kChunk + t], ok ? x + off : dt, ok ? 4 : 0);
          cp_async4(&st.dy[cc * kChunk + t], ok ? dy + off : dt, ok ? 4 : 0);
        }
      }
    }
    if constexpr (kBf16) {
      copy_words(st.x, x_lo, base, len);
      copy_words(st.dy, dy_lo, base, len);
    }
    const size_t bc = (row0 + t0) * N;
#pragma unroll
    for (int k = 0; k < kBcK; ++k) {
      const int p = tid + k * kThreads;
      if (p < len * N) {
        const int t = p / N, m = p % N;
        cp_async4(&st.B[m][swz(m, t)], Bc + bc + p, 4);
        cp_async4(&st.C[m][swz(m, t)], Cc + bc + p, 4);
      }
    }
    cp_async_arrive(&sm.bar[buf]);
  };

  if (active) issue(n_chunks - 1, 0);
  // the state at the start of the chunk walked next
  float h_start =
      active && live ? hs[hs_at(n_chunks - 1)] : 0.f;

  for (int i = 0; i < n_chunks; ++i) {
    const int c = n_chunks - 1 - i;
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
    const int nq = (len + 3) / 4;
    const BwdStage<T, N>& st = sm.ring[i & 1];
    float h = h_start;
    if (active) {
      if (c > 0) issue(c - 1, (i + 1) & 1);
      if (c > 0 && live) h_start = hs[hs_at(c - 1)];
      mbar_wait(&sm.bar[i & 1], (i >> 1) & 1);
    }
    // bf16 rows: the parity of the lane's channel's first half at step 0
    const int px = static_cast<int>(
        ((x_lo >> 1) + (row0 + t0) * Di + d0) & 1);
    const int pd = static_cast<int>(
        ((dy_lo >> 1) + (row0 + t0) * Di + d0) & 1);
    // the peers have read this block's shares of the chunk before
    if (i > 0) cluster_wait();
    if (active) {
      // x and dy of the lane's channel, a row of float32
      const float* xs = st.x + cl * kChunk;
      const float* dys = st.dy + cl * kChunk;
      if constexpr (kBf16) {
        widen<N>(st.x, sm.xw, warp, lane, len, px, odd);
        widen<N>(st.dy, sm.dyw, warp, lane, len, pd, odd);
        __syncwarp();
        xs = sm.xw + cl * kChunk;
        dys = sm.dyw + cl * kChunk;
      }
      // Steps of a quad past S (only in the last chunk's last quad) are
      // skipped; a whole quad compiles without the tests (kWhole).
      // The chunk's states again, from the saved one at its start.
      auto recompute = [&](int q, auto kWhole) {
        float dtv[4], xv[4], bv[4];
        row_quad(st.dt[cl], q, dtv);
        row_quad(xs, q, xv);
        row_quad(&st.B[n][0], q ^ (n & 7), bv);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (decltype(kWhole)::value || 4 * q + s < len) {
            const float dec = expf(__fmul_rn(dtv[s], a));
            h = __fadd_rn(__fmul_rn(h, dec),
                          __fmul_rn(__fmul_rn(dtv[s], xv[s]), bv[s]));
            sm.hist[4 * q + s + 1][tid] = h;
          }
        }
      };
      sm.hist[0][tid] = h;
      for (int q = 0; q < nq; ++q) {
        if (4 * q + 4 <= len)
          recompute(q, std::true_type{});
        else
          recompute(q, std::false_type{});
      }

      // walked back, a quad of steps at a time
      float h_hi = h;                 // h after the step being walked
      float dA_chunk = 0.f;
      auto walk = [&](int q, auto kWhole) {
        float dtv[4], xv[4], dyv[4], bv[4], cv[4];
        row_quad(st.dt[cl], q, dtv);
        row_quad(xs, q, xv);
        row_quad(dys, q, dyv);
        row_quad(&st.B[n][0], q ^ (n & 7), bv);
        row_quad(&st.C[n][0], q ^ (n & 7), cv);
        float red[8], chs[8];   // (g B, z A) at 2 s + 0 / 1; (g u, dy h)
                                // at s + 0 / 4
#pragma unroll
        for (int s = 3; s >= 0; --s) {
          float gb = 0.f, za = 0.f, gu = 0.f, dyh = 0.f;
          if (decltype(kWhole)::value || 4 * q + s < len) {
            const float h_lo = sm.hist[4 * q + s][tid];
            const float dec = expf(__fmul_rn(dtv[s], a));
            const float g = __fadd_rn(__fmul_rn(dyv[s], cv[s]), carry);
            const float z = __fmul_rn(__fmul_rn(g, h_lo), dec);
            gb = __fmul_rn(g, bv[s]);
            za = __fmul_rn(z, a);
            gu = __fmul_rn(g, __fmul_rn(dtv[s], xv[s]));
            dyh = __fmul_rn(dyv[s], h_hi);
            dA_chunk = __fadd_rn(dA_chunk, __fmul_rn(z, dtv[s]));
            carry = __fmul_rn(dec, g);
            h_hi = h_lo;
          }
          red[2 * s] = gb;
          red[2 * s + 1] = za;
          chs[s] = gu;
          chs[4 + s] = dyh;
        }
        // du and sum_n z A over the channel's lanes: the lane left with
        // step s's du takes its partner's sum_n z A
        int base = 0;
        fold_sum<1, N / 2, 8>(red, lane, base);
        float du, zs;
        bool writer;
        if constexpr (N >= 8) {
          const float other = __shfl_xor_sync(0xffffffffu, red[0], N / 8);
          const bool is_du = (base & 1) == 0;
          du = is_du ? red[0] : other;
          zs = is_du ? other : red[0];
          // at N 16 the last round leaves each sum on two lanes
          writer = is_du && (N == 8 || (lane & 1) == 0);
        } else {
          du = red[0];
          zs = red[1];
          writer = true;
        }
        const int sw = base >> 1, tw = 4 * q + sw;
        if (writer && live && (decltype(kWhole)::value || tw < len)) {
          const size_t off = (row0 + t0 + tw) * Di + d;
          ddt[off] = __fadd_rn(zs, __fmul_rn(du, pick(xv, sw)));
          store_f32(dx + off, __fmul_rn(du, pick(dtv, sw)));
        }
        // g u and dy h over the warp's channels, into the rows read
        int cb = 0;
        fold_sum<N, 16, 8>(chs, lane, cb);
        constexpr int kLeft = N == 16 ? 4 : N == 8 ? 2 : 1;   // of 8
#pragma unroll
        for (int j = 0; j < kLeft; ++j) {
          const int idx = cb + j, t = 4 * q + (idx & 3);
          if (decltype(kWhole)::value || t < len)
            sm.hist[t + 1][warp * 32 + (idx >> 2) * N + n] = chs[j];
        }
      };
      for (int q = nq - 1; q >= 0; --q) {
        if (4 * q + 4 <= len)
          walk(q, std::true_type{});
        else
          walk(q, std::false_type{});
      }
      dA_acc = __fadd_rn(dA_acc, dA_chunk);
    }
    // the block's share: its warps' in order, in place of warp 0's
    if (active) {
      __syncthreads();
      for (int e = tid; e < len * 2 * N; e += kThreads) {
        float* row = &sm.hist[e / (2 * N) + 1][e % (2 * N)];
        float sum = row[0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) sum = __fadd_rn(sum, row[w * 32]);
        row[0] = sum;
      }
    }
    // every block's share of the chunk's dB and dC is in place
    cluster_sync();
    // the cluster's share: one (step, state) a thread, the blocks in rank
    // order
    for (int e = rank * kThreads + tid; e < len * 2 * N; e += cs * kThreads) {
      const int t = e / (2 * N), j = e % (2 * N);
      float sum = -0.f;
      for (int r = 0; r < cs && (blk0 + r) * kCh < Di; ++r)
        sum = __fadd_rn(sum, peer(&sm.hist[t + 1][j], r)[0]);
      // the cluster's share of dB and dC: part is (d_pad / cs, batch, S,
      // 2N)
      part[((static_cast<size_t>(blk / cs) * batch + b) * S + t0 + t) *
               (2 * N) + j] = sum;
    }
    cluster_arrive();
  }
  // no block leaves while a peer may still read its shared memory
  cluster_wait();
  if (live) {
    dh0[lane_at()] = carry;
    dA_part[lane_at()] = dA_acc;
  }
}

constexpr int kFinishThreads = 256;

// dB and dC: each (b, t, n)'s cluster shares added in cluster order,
// compensated; dA: each (d, n)'s batch rows added in order.
template <int N>
__global__ void __launch_bounds__(kFinishThreads)
    selective_scan_bwd_finish_kernel(const float* __restrict__ part,
                                     const float* __restrict__ dA_part,
                                     float* __restrict__ dB,
                                     float* __restrict__ dC,
                                     float* __restrict__ dA, int batch,
                                     int S, int Di, int parts) {
  const size_t i =
      static_cast<size_t>(blockIdx.x) * kFinishThreads + threadIdx.x;
  const size_t rows = static_cast<size_t>(batch) * S;     // (b, t)
  if (i < rows * N) {
    const size_t bt = i / N;
    const int m = static_cast<int>(i % N);
    const size_t stride = rows * (2 * N);                 // a cluster's
    const float* p = part + bt * (2 * N) + m;
    float sb = 0.f, eb = 0.f, sc = 0.f, ec = 0.f;
    for (int k = 0; k < parts; ++k, p += stride) {
      kahan_add(sb, eb, p[0]);
      kahan_add(sc, ec, p[N]);
    }
    dB[i] = sb;
    dC[i] = sc;
  }
  const size_t plane = static_cast<size_t>(Di) * N;
  if (i < plane) {
    float s = dA_part[i];
    for (int bb = 1; bb < batch; ++bb)
      s = __fadd_rn(s, dA_part[bb * plane + i]);
    dA[i] = s;
  }
}

// ---- launches ----------------------------------------------------------------

template <typename F>
cudaError_t by_state_dim(int n, F&& f) {
  switch (n) {
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

template <int N>
int d_blocks_of(int Di) {
  return (Di + Cfg<N>::kCh - 1) / Cfg<N>::kCh;
}

template <typename T, int N>
cudaError_t launch(const void* x, const float* dt, const float* Bc,
                   const float* Cc, const float* A, const float* h0, void* y,
                   float* hT, float* hs, int batch, int S, int Di,
                   cudaStream_t stream) {
  const int d_blocks = d_blocks_of<N>(Di);
  if (static_cast<long long>(batch) * d_blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  if (hs != nullptr)
    selective_scan_kernel<T, N, true>
        <<<batch * d_blocks, kThreads, 0, stream>>>(
            static_cast<const T*>(x), dt, Bc, Cc, A, h0, static_cast<T*>(y),
            hT, hs, S, Di, d_blocks);
  else
    selective_scan_kernel<T, N, false>
        <<<batch * d_blocks, kThreads, 0, stream>>>(
            static_cast<const T*>(x), dt, Bc, Cc, A, h0, static_cast<T*>(y),
            hT, hs, S, Di, d_blocks);
  return cudaGetLastError();
}

// K3-bwd's cluster: the blocks of one batch row's channels, 8 or, when
// the row has fewer blocks, the power of two that covers them
inline int bwd_cluster(int d_blocks) {
  int cs = 1;
  while (cs < d_blocks && cs < kMaxCluster) cs *= 2;
  return cs;
}

// K3-bwd's clusters along one batch row: the row's blocks padded to whole
// clusters, and the rows of its `part` scratch
inline int bwd_parts(int d_blocks) {
  const int cs = bwd_cluster(d_blocks);
  return (d_blocks + cs - 1) / cs;
}

template <typename T, int N>
cudaLaunchConfig_t bwd_config(int batch, int d_pad, int cs,
                              cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * d_pad);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(BwdShared<T, N>);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int N>
cudaError_t launch_bwd(const void* x, const float* dt, const float* Bc,
                       const float* Cc, const float* A, const float* hs,
                       const void* dy, const float* dhT, void* dx, float* ddt,
                       float* dB, float* dC, float* dA, float* dh0,
                       float* part, float* dA_part, int part_rows,
                       int batch, int S, int Di, cudaStream_t stream) {
  const int d_blocks = d_blocks_of<N>(Di);
  const int cs = bwd_cluster(d_blocks);
  const int d_pad = bwd_parts(d_blocks) * cs;
  if (d_pad / cs != part_rows) return cudaErrorInvalidValue;
  if (static_cast<long long>(batch) * d_pad > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  auto kernel = selective_scan_bwd_kernel<T, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(BwdShared<T, N>)));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      bwd_config<T, N>(batch, d_pad, cs, stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), dt, Bc,
                           Cc, A, hs, static_cast<const T*>(dy), dhT,
                           static_cast<T*>(dx), ddt, part, dA_part, dh0,
                           batch, S, Di, d_pad);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t work = std::max(static_cast<size_t>(batch) * S * N,
                               static_cast<size_t>(Di) * N);
  const size_t blocks = (work + kFinishThreads - 1) / kFinishThreads;
  if (blocks > 0x7fffffffULL) return cudaErrorInvalidConfiguration;
  selective_scan_bwd_finish_kernel<N>
      <<<static_cast<unsigned>(blocks), kFinishThreads, 0, stream>>>(
          part, dA_part, dB, dC, dA, batch, S, Di, part_rows);
  return cudaGetLastError();
}

// out: registers a thread, resident blocks an SM, threads a block, shared
// memory bytes a block, channels a block; for the backward also its
// cluster size at d_inner, the clusters resident at once on the device
// (cudaOccupancyMaxActiveClusters) and local memory bytes a thread
template <typename K>
cudaError_t occupancy_of(K kernel, size_t smem, int channels, int* out) {
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = blocks;
  out[2] = kThreads;
  out[3] = static_cast<int>(attr.sharedSizeBytes + smem);
  out[4] = channels;
  out[5] = 0;
  out[6] = 0;
  out[7] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

template <typename T, int N>
cudaError_t bwd_occupancy(int d_inner, int* out) {
  auto kernel = selective_scan_bwd_kernel<T, N>;
  cudaError_t err =
      occupancy_of(kernel, sizeof(BwdShared<T, N>), Cfg<N>::kCh, out);
  if (err != cudaSuccess) return err;
  const int cs = bwd_cluster(d_blocks_of<N>(d_inner));
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = bwd_config<T, N>(1, cs, cs, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  out[5] = cs;
  out[6] = clusters;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launch K3 on `stream`.  x, y: (B, S, Di) float32 (x_bf16 = 0) or
// bfloat16 (x_bf16 = 1); dt (B, S, Di), Bc, Cc (B, S, N), A (Di, N), h0,
// hT (B, Di, N) float32; all contiguous; N in {4, 8, 16}.  hs, if not
// null, receives the state at every chunk's start: (B, ceil(S / 32), Di,
// N) float32, its chunk 0 h0.  Returns the cudaError_t of the launch (0 =
// success).
int selective_scan_fwd(const void* x, const void* dt, const void* Bc,
                       const void* Cc, const void* A, const void* h0,
                       void* y, void* hT, void* hs, int x_bf16, int batch,
                       int s_len, int d_inner, int state_dim, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  float* ht = static_cast<float*>(hT);
  float* hsp = static_cast<float*>(hs);
  err = by_state_dim(state_dim, [&](auto nc) {
    constexpr int N = decltype(nc)::value;
    return x_bf16 ? launch<__nv_bfloat16, N>(x, f32(dt), f32(Bc), f32(Cc),
                                             f32(A), f32(h0), y, ht, hsp,
                                             batch, s_len, d_inner, s)
                  : launch<float, N>(x, f32(dt), f32(Bc), f32(Cc), f32(A),
                                     f32(h0), y, ht, hsp, batch, s_len,
                                     d_inner, s);
  });
  return static_cast<int>(err);
}

// Launch K3's backward on `stream` (two kernels: the reverse walk in
// clusters, then the sums over clusters and batch rows).  x, dt, Bc, Cc,
// A as the forward took them; hs the states the forward saved; dy (B, S,
// Di) in x's dtype; dhT (B, Di, N) float32 or null (zero).  Out: dx (B,
// S, Di) in x's dtype; ddt (B, S, Di), dB, dC (B, S, N), dA (Di, N), dh0
// (B, Di, N) float32.  Scratch: part (part_rows, B, S, 2N) and dA_part
// (B, Di, N) float32, part_rows the clusters of a batch row, as
// selective_scan_bwd_parts gives them.  All contiguous.  Returns the
// cudaError_t of the launches (0 = success; a cluster launch the device
// cannot schedule returns its error, nothing falls back).
int selective_scan_bwd(const void* x, const void* dt, const void* Bc,
                       const void* Cc, const void* A, const void* hs,
                       const void* dy, const void* dhT, void* dx, void* ddt,
                       void* dB, void* dC, void* dA, void* dh0, void* part,
                       void* dA_part, int part_rows, int x_bf16, int batch,
                       int s_len, int d_inner, int state_dim, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  auto out = [](void* p) { return static_cast<float*>(p); };
  err = by_state_dim(state_dim, [&](auto nc) {
    constexpr int N = decltype(nc)::value;
    auto go = [&](auto tag) {
      using T = decltype(tag);
      return launch_bwd<T, N>(x, f32(dt), f32(Bc), f32(Cc), f32(A), f32(hs),
                              dy, f32(dhT), dx, out(ddt), out(dB), out(dC),
                              out(dA), out(dh0), out(part), out(dA_part),
                              part_rows, batch, s_len, d_inner, s);
    };
    return x_bf16 ? go(__nv_bfloat16{}) : go(float{});
  });
  return static_cast<int>(err);
}

// The clusters of one batch row that selective_scan_bwd launches for
// (d_inner, state_dim), the rows of its `part` scratch: with blocks =
// ceil(d_inner / (128 / N)) and cs = min(8, the least power of two >=
// blocks), ceil(blocks / cs).  -1 for a state_dim without an instance.
int selective_scan_bwd_parts(int d_inner, int state_dim) {
  int parts = -1;
  by_state_dim(state_dim, [&](auto nc) {
    parts = bwd_parts(d_blocks_of<decltype(nc)::value>(d_inner));
    return cudaSuccess;
  });
  return parts;
}

// The instance that selective_scan_fwd (backward = 0; the one that saves
// no state) or the reverse walk of selective_scan_bwd (backward = 1)
// launches for (x_bf16, state_dim), on `device`: out[0] registers a
// thread, out[1] resident blocks an SM, out[2] threads a block, out[3]
// shared memory bytes a block, out[4] channels a block, out[7] local
// memory bytes a thread (spills); the backward's out[5] cluster size at
// d_inner and out[6] clusters resident at once on the device.
int selective_scan_occupancy(int x_bf16, int state_dim, int backward,
                             int d_inner, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = by_state_dim(state_dim, [&](auto nc) {
    constexpr int N = decltype(nc)::value;
    constexpr int ch = Cfg<N>::kCh;
    if (backward)
      return x_bf16 ? bwd_occupancy<__nv_bfloat16, N>(d_inner, out)
                    : bwd_occupancy<float, N>(d_inner, out);
    return x_bf16 ? occupancy_of(selective_scan_kernel<__nv_bfloat16, N, false>,
                                 0, ch, out)
                  : occupancy_of(selective_scan_kernel<float, N, false>, 0,
                                 ch, out);
  });
  return static_cast<int>(err);
}

const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
