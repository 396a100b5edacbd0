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

#include <cstddef>
#include <cstdint>

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

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const T* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ Bc,
                          const float* __restrict__ Cc,
                          const float* __restrict__ A,
                          const float* __restrict__ h0, T* __restrict__ y,
                          float* __restrict__ hT, int S, int Di,
                          int d_blocks) {
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

template <typename T, int N>
cudaError_t launch(const void* x, const float* dt, const float* Bc,
                   const float* Cc, const float* A, const float* h0, void* y,
                   float* hT, int batch, int S, int Di, cudaStream_t stream) {
  const int d_blocks = (Di + Cfg<N>::kCh - 1) / Cfg<N>::kCh;
  if (static_cast<long long>(batch) * d_blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  selective_scan_kernel<T, N><<<batch * d_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), dt, Bc, Cc, A, h0, static_cast<T*>(y), hT, S,
      Di, d_blocks);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t occupancy(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, selective_scan_kernel<T, N>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, selective_scan_kernel<T, N>, kThreads, 0);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = blocks;
  out[2] = kThreads;
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  out[4] = Cfg<N>::kCh;
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch_launch(int n, const void* x, const float* dt,
                            const float* Bc, const float* Cc, const float* A,
                            const float* h0, void* y, float* hT, int batch,
                            int S, int Di, cudaStream_t stream) {
  switch (n) {
    case 4:
      return launch<T, 4>(x, dt, Bc, Cc, A, h0, y, hT, batch, S, Di, stream);
    case 8:
      return launch<T, 8>(x, dt, Bc, Cc, A, h0, y, hT, batch, S, Di, stream);
    case 16:
      return launch<T, 16>(x, dt, Bc, Cc, A, h0, y, hT, batch, S, Di, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_occupancy(int n, int* out) {
  switch (n) {
    case 4: return occupancy<T, 4>(out);
    case 8: return occupancy<T, 8>(out);
    case 16: return occupancy<T, 16>(out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch K3 on `stream`.  x, y: (B, S, Di) float32 (x_bf16 = 0) or
// bfloat16 (x_bf16 = 1); dt (B, S, Di), Bc, Cc (B, S, N), A (Di, N), h0,
// hT (B, Di, N) float32; all contiguous; N in {4, 8, 16}.  Returns the
// cudaError_t of the launch (0 = success).
int selective_scan_fwd(const void* x, const void* dt, const void* Bc,
                       const void* Cc, const void* A, const void* h0,
                       void* y, void* hT, int x_bf16, int batch, int s_len,
                       int d_inner, int state_dim, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  float* ht = static_cast<float*>(hT);
  if (x_bf16)
    err = dispatch_launch<__nv_bfloat16>(state_dim, x, f32(dt), f32(Bc),
                                         f32(Cc), f32(A), f32(h0), y, ht,
                                         batch, s_len, d_inner, s);
  else
    err = dispatch_launch<float>(state_dim, x, f32(dt), f32(Bc), f32(Cc),
                                 f32(A), f32(h0), y, ht, batch, s_len,
                                 d_inner, s);
  return static_cast<int>(err);
}

// The instance that selective_scan_fwd launches for (x_bf16, state_dim),
// on `device`: out[0] registers a thread, out[1] resident blocks an SM,
// out[2] threads a block, out[3] shared memory bytes a block, out[4]
// channels a block.
int selective_scan_occupancy(int x_bf16, int state_dim, int device,
                             int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = x_bf16 ? dispatch_occupancy<__nv_bfloat16>(state_dim, out)
               : dispatch_occupancy<float>(state_dim, out);
  return static_cast<int>(err);
}

const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
