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
// Di: each block leaves its share (its channels added in order), and a
// second kernel adds the blocks' shares in block order, compensated, so
// two runs give the same bits (no float atomics).  K3-bwd's bound at
// (2, 4096, 3200, 16): bytes, 0.42 GB (x, dy, dx in bf16, dt, ddt, the
// saved states) 0.126 ms; 7.5e9 float32 operations (18 a lane and step)
// 0.113 ms; the forward's exponentials again, 4.19e8, 0.100 ms.  It
// stages each chunk with plain loads and keeps the chunk's h, a and the
// walk's four products in shared memory (111 KB a block, 2 blocks an
// SM): a first design, right before fast.
//
// Bound: the exponentials.  B S Di N of them, at 16 MUFU.EX2 results a
// clock an SM (132 SMs, 1.98 GHz boost): at (2, 8192, 3200, 16) 8.4e8,
// 0.203 ms; x, dt and y once each plus B and C are about 0.42 GB in bf16,
// 0.125 ms at 3.35 TB/s; the float32 operations (7 N + 1 a channel and
// step: 5.9e9) 0.088 ms at 67 TFLOP/s.  This design issues about 16
// instructions a state and step (expf's 9 of them, one MUFU.EX2) and the
// ordered sum about 1 more: it is bound by instruction issue, with the
// SFU about a quarter busy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// sum += v, compensated (Kahan), each operation rounded on its own
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float v) {
  const float y = __fsub_rn(v, comp);
  const float t = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

template <int N>
struct BwdShared {
  static constexpr int kCh = Cfg<N>::kCh;
  // a step's per-lane products at [t][channel * (N + 1) + n] (the pad
  // keeps a warp's reads of 8 channels and 4 steps on distinct banks):
  // g B and z A are summed over n (du, ddt), g u and dy h over the
  // block's channels (its share of dB, dC)
  static constexpr int kRowP = kCh * (N + 1);
  float gb[kChunk][kRowP];
  float za[kChunk][kRowP];
  float gu[kChunk][kRowP];
  float dyh[kChunk][kRowP];
  float hist[kChunk + 1][kThreads];   // a lane's h before step t, at [t]
  float dec[kChunk][kThreads];        // a lane's exp(dt A) of step t
  float dt[kCh][kChunk + 1];          // rows padded: the 16 states' reads
  float x[kCh][kChunk + 1];           // of B and C fall on distinct banks
  float dy[kCh][kChunk + 1];
  float u[kCh][kChunk + 1];
  float B[N][kChunk + 1];
  float C[N][kChunk + 1];
};

// K3's backward.  The forward's layout (a lane a channel and state, kCh
// channels a block), its chunks walked from the last to the first: the
// chunk's h recomputed from the state the forward saved at its start
// (hs), with the forward's rounded operations, so with its bits; then the
// chunk walked back, g_t = dy_t C_t + a_{t+1} g_{t+1} carried in a
// register, each step's products kept in shared memory and summed after
// the chunk in fixed orders: over n (du, then ddt and dx), and over the
// block's channels into its partial of dB and dC (`part`, summed over the
// blocks by selective_scan_bwd_finish_kernel).  dA is a lane's sum over
// its steps (a chunk's steps first), left per batch row in dA_part.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_bwd_kernel(
        const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ Bc, const float* __restrict__ Cc,
        const float* __restrict__ A, const float* __restrict__ hs,
        const T* __restrict__ dy, const float* __restrict__ dhT,
        T* __restrict__ dx, float* __restrict__ ddt,
        float* __restrict__ part, float* __restrict__ dA_part,
        float* __restrict__ dh0, int batch, int S, int Di, int d_blocks) {
  constexpr int kCh = Cfg<N>::kCh;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdShared<N>& sm = *reinterpret_cast<BwdShared<N>*>(smem_raw);
  const int tid = threadIdx.x;
  const int b = blockIdx.x / d_blocks, blk = blockIdx.x % d_blocks;
  const int d0 = blk * kCh;
  const int cl = tid / N, n = tid % N;          // the lane's channel, state
  const int d = d0 + cl;
  const bool live = d < Di;
  const int q = cl * (N + 1) + n;               // the lane's product slot
  const size_t row0 = static_cast<size_t>(b) * S;   // row (b, t = 0)
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const size_t lane = (static_cast<size_t>(b) * Di + d) * N + n;
  const float a = live ? A[static_cast<size_t>(d) * N + n] : 0.f;
  // a_{t+1} g_{t+1}, from dL/dhT at the end
  float carry = (live && dhT != nullptr) ? dhT[lane] : 0.f;
  float dA_acc = 0.f;
  // this block's partials of dB and dC: part is (d_blocks, batch, S, 2N)
  float* const part_b =
      part + (static_cast<size_t>(blk) * batch + b) * S * (2 * N);

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
    // stage the chunk; channels past Di and steps past S are zeros
    for (int p = tid; p < kChunk * kCh; p += kThreads) {
      const int t = p / kCh, cc = p % kCh;
      float dtv = 0.f, xv = 0.f, dyv = 0.f;
      if (t < len && d0 + cc < Di) {
        const size_t off = (row0 + t0 + t) * Di + d0 + cc;
        dtv = dt[off];
        xv = to_f32(x[off]);
        dyv = to_f32(dy[off]);
      }
      sm.dt[cc][t] = dtv;
      sm.x[cc][t] = xv;
      sm.dy[cc][t] = dyv;
      sm.u[cc][t] = __fmul_rn(dtv, xv);
    }
    for (int p = tid; p < kChunk * N; p += kThreads) {
      const int t = p / N, m = p % N;
      const bool ok = t < len;
      const size_t off = (row0 + t0 + t) * N + m;
      sm.B[m][t] = ok ? Bc[off] : 0.f;
      sm.C[m][t] = ok ? Cc[off] : 0.f;
    }
    __syncthreads();

    // the chunk's states again, from the saved one at its start
    float h = live
        ? hs[((static_cast<size_t>(b) * n_chunks + c) * Di + d) * N + n]
        : 0.f;
    sm.hist[0][tid] = h;
    for (int t = 0; t < len; ++t) {
      const float dec = expf(__fmul_rn(sm.dt[cl][t], a));
      h = __fadd_rn(__fmul_rn(h, dec), __fmul_rn(sm.u[cl][t], sm.B[n][t]));
      sm.dec[t][tid] = dec;
      sm.hist[t + 1][tid] = h;
    }

    // walked back: g_t, then the step's products and a_t g_t
    float dA_chunk = 0.f;
    for (int t = len - 1; t >= 0; --t) {
      const float dyv = sm.dy[cl][t];
      const float g = __fadd_rn(__fmul_rn(dyv, sm.C[n][t]), carry);
      const float dec = sm.dec[t][tid];
      const float z = __fmul_rn(__fmul_rn(g, sm.hist[t][tid]), dec);
      sm.gb[t][q] = __fmul_rn(g, sm.B[n][t]);
      sm.za[t][q] = __fmul_rn(z, a);
      sm.gu[t][q] = __fmul_rn(g, sm.u[cl][t]);
      sm.dyh[t][q] = __fmul_rn(dyv, sm.hist[t + 1][tid]);
      dA_chunk = __fadd_rn(dA_chunk, __fmul_rn(z, sm.dt[cl][t]));
      carry = __fmul_rn(dec, g);
    }
    dA_acc = __fadd_rn(dA_acc, dA_chunk);
    __syncthreads();

    // du (n from 0 upward), then ddt = sum_n z A + du x and dx = du dt:
    // a thread a (channel, step)
    for (int p = tid; p < kCh * kChunk; p += kThreads) {
      const int cc = p % kCh, t = p / kCh;
      if (t < len && d0 + cc < Di) {
        const float* gb = &sm.gb[t][cc * (N + 1)];
        const float* za = &sm.za[t][cc * (N + 1)];
        float du = gb[0], zs = za[0];
#pragma unroll
        for (int m = 1; m < N; ++m) {
          du = __fadd_rn(du, gb[m]);
          zs = __fadd_rn(zs, za[m]);
        }
        const size_t off = (row0 + t0 + t) * Di + d0 + cc;
        ddt[off] = __fadd_rn(zs, __fmul_rn(du, sm.x[cc][t]));
        store_f32(dx + off, __fmul_rn(du, sm.dt[cc][t]));
      }
    }
    // the block's share of dB and dC: a thread a (state, step), the
    // channels in order
    for (int p = tid; p < N * kChunk; p += kThreads) {
      const int m = p % N, t = p / N;
      if (t < len) {
        float sb = sm.gu[t][m], sc = sm.dyh[t][m];
#pragma unroll
        for (int cc = 1; cc < kCh; ++cc) {
          sb = __fadd_rn(sb, sm.gu[t][cc * (N + 1) + m]);
          sc = __fadd_rn(sc, sm.dyh[t][cc * (N + 1) + m]);
        }
        float* pr = part_b + static_cast<size_t>(t0 + t) * (2 * N);
        pr[m] = sb;
        pr[N + m] = sc;
      }
    }
    __syncthreads();
  }
  if (live) {
    dh0[lane] = carry;
    dA_part[lane] = dA_acc;
  }
}

constexpr int kFinishThreads = 256;

// dB and dC: each (b, t, n)'s block partials added in block order,
// compensated; dA: each (d, n)'s batch rows added in order.
template <int N>
__global__ void __launch_bounds__(kFinishThreads)
    selective_scan_bwd_finish_kernel(const float* __restrict__ part,
                                     const float* __restrict__ dA_part,
                                     float* __restrict__ dB,
                                     float* __restrict__ dC,
                                     float* __restrict__ dA, int batch,
                                     int S, int Di, int d_blocks) {
  const size_t i =
      static_cast<size_t>(blockIdx.x) * kFinishThreads + threadIdx.x;
  const size_t rows = static_cast<size_t>(batch) * S;     // (b, t)
  if (i < rows * N) {
    const size_t bt = i / N;
    const int m = static_cast<int>(i % N);
    const size_t stride = rows * (2 * N);                 // a block's
    const float* p = part + bt * (2 * N) + m;
    float sb = 0.f, eb = 0.f, sc = 0.f, ec = 0.f;
    for (int k = 0; k < d_blocks; ++k, p += stride) {
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

template <typename T, int N>
cudaError_t launch_bwd(const void* x, const float* dt, const float* Bc,
                       const float* Cc, const float* A, const float* hs,
                       const void* dy, const float* dhT, void* dx, float* ddt,
                       float* dB, float* dC, float* dA, float* dh0,
                       float* part, float* dA_part, int part_blocks,
                       int batch, int S, int Di, cudaStream_t stream) {
  const int d_blocks = d_blocks_of<N>(Di);
  if (d_blocks != part_blocks) return cudaErrorInvalidValue;
  if (static_cast<long long>(batch) * d_blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  constexpr size_t smem = sizeof(BwdShared<N>);
  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<T, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  selective_scan_bwd_kernel<T, N>
      <<<batch * d_blocks, kThreads, smem, stream>>>(
          static_cast<const T*>(x), dt, Bc, Cc, A, hs,
          static_cast<const T*>(dy), dhT, static_cast<T*>(dx), ddt, part,
          dA_part, dh0, batch, S, Di, d_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t work = std::max(static_cast<size_t>(batch) * S * N,
                               static_cast<size_t>(Di) * N);
  const size_t blocks = (work + kFinishThreads - 1) / kFinishThreads;
  if (blocks > 0x7fffffffULL) return cudaErrorInvalidConfiguration;
  selective_scan_bwd_finish_kernel<N>
      <<<static_cast<unsigned>(blocks), kFinishThreads, 0, stream>>>(
          part, dA_part, dB, dC, dA, batch, S, Di, d_blocks);
  return cudaGetLastError();
}

// out: registers a thread, resident blocks an SM, threads a block, shared
// memory bytes a block, channels a block
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

// Launch K3's backward on `stream` (two kernels: the reverse walk, then
// the sums over blocks and batch rows).  x, dt, Bc, Cc, A as the forward
// took them; hs the states the forward saved; dy (B, S, Di) in x's dtype;
// dhT (B, Di, N) float32 or null (zero).  Out: dx (B, S, Di) in x's
// dtype; ddt (B, S, Di), dB, dC (B, S, N), dA (Di, N), dh0 (B, Di, N)
// float32.  Scratch: part (part_blocks, B, S, 2N) and dA_part (B, Di, N)
// float32, part_blocks = ceil(Di / (128 / N)).  All contiguous.  Returns
// the cudaError_t of the launches (0 = success).
int selective_scan_bwd(const void* x, const void* dt, const void* Bc,
                       const void* Cc, const void* A, const void* hs,
                       const void* dy, const void* dhT, void* dx, void* ddt,
                       void* dB, void* dC, void* dA, void* dh0, void* part,
                       void* dA_part, int part_blocks, int x_bf16, int batch,
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
                              part_blocks, batch, s_len, d_inner, s);
    };
    return x_bf16 ? go(__nv_bfloat16{}) : go(float{});
  });
  return static_cast<int>(err);
}

// The instance that selective_scan_fwd (backward = 0; the one that saves
// no state) or the reverse walk
// of selective_scan_bwd (backward = 1) launches for (x_bf16, state_dim),
// on `device`: out[0] registers a thread, out[1] resident blocks an SM,
// out[2] threads a block, out[3] shared memory bytes a block, out[4]
// channels a block.
int selective_scan_occupancy(int x_bf16, int state_dim, int backward,
                             int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = by_state_dim(state_dim, [&](auto nc) {
    constexpr int N = decltype(nc)::value;
    constexpr int ch = Cfg<N>::kCh;
    constexpr size_t smem = sizeof(BwdShared<N>);
    if (x_bf16)
      return backward
                 ? occupancy_of(selective_scan_bwd_kernel<__nv_bfloat16, N>,
                                smem, ch, out)
                 : occupancy_of(
                       selective_scan_kernel<__nv_bfloat16, N, false>, 0, ch,
                       out);
    return backward ? occupancy_of(selective_scan_bwd_kernel<float, N>, smem,
                                   ch, out)
                    : occupancy_of(selective_scan_kernel<float, N, false>, 0,
                                   ch, out);
  });
  return static_cast<int>(err);
}

const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
