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
// __fadd_rn: no contraction into FMAs, so the state evolves with the
// plain version's bits), y rounded once to x's dtype.  Layouts, all
// contiguous: x, dt, y (B, S, Di); B, C (B, S, N); A (Di, N); h0, hT
// (B, Di, N).  x and y are float32 or bfloat16; the rest float32.
//
// Design (simple first): one thread per (b, d) channel holds its N <= 16
// states and A[d, :] in registers (N is a template parameter: 16 at
// hymba's full width, 8 at SMOKE).  A block of 128 channels of one batch
// row walks the time axis in chunks of 32 steps: the chunk's B and C
// rows (shared by every channel of the row) and its x and dt columns
// (coalesced along d) are staged in shared memory, then each thread runs
// the chunk's steps from there.  At hymba's prefill (B 2, Di 3200) that
// is 50 blocks of 128 threads, fewer than the card's 132 SMs could hold:
// accepted for now.  Decode runs the same kernel at S = 1.
//
// Bound: bytes.  x, dt and y once each plus B and C: at (2, 8192, 3200)
// in bf16 with N = 16 about 0.42 GB, 0.125 ms at 3.35 TB/s; the float32
// operations (7 N + 1 a channel and step: 5.9e9) need 0.088 ms at 67
// TFLOP/s.  This design is latency-bound on the serial time loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;   // channels a block
constexpr int kChunk = 32;      // time steps staged at a time

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const T* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ Bc,
                          const float* __restrict__ Cc,
                          const float* __restrict__ A,
                          const float* __restrict__ h0, T* __restrict__ y,
                          float* __restrict__ hT, int S, int Di) {
  __shared__ float sx[kChunk][kThreads];
  __shared__ float sdt[kChunk][kThreads];
  __shared__ float sb[kChunk][N];
  __shared__ float sc[kChunk][N];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + tid;
  const bool live = d < Di;
  const size_t row0 = static_cast<size_t>(b) * S;      // row (b, t = 0)

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[static_cast<size_t>(d) * N + n] : 0.f;
    h[n] = live ? h0[(static_cast<size_t>(b) * Di + d) * N + n] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int len = min(kChunk, S - t0);
    __syncthreads();                 // the previous chunk is consumed
    for (int i = tid; i < len * N; i += kThreads) {
      const size_t off = (row0 + t0) * N + i;
      sb[i / N][i % N] = Bc[off];
      sc[i / N][i % N] = Cc[off];
    }
#pragma unroll 8
    for (int j = 0; j < len; ++j) {
      const size_t off = (row0 + t0 + j) * Di + d;
      sx[j][tid] = live ? load_f32(x + off) : 0.f;
      sdt[j][tid] = live ? dt[off] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const float dtj = sdt[j][tid];
      const float u = __fmul_rn(dtj, sx[j][tid]);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float decay = expf(__fmul_rn(dtj, a[n]));
        h[n] = __fadd_rn(__fmul_rn(h[n], decay), __fmul_rn(u, sb[j][n]));
        acc = __fadd_rn(acc, __fmul_rn(h[n], sc[j][n]));
      }
      if (live) store_f32(y + (row0 + t0 + j) * Di + d, acc);
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n)
      hT[(static_cast<size_t>(b) * Di + d) * N + n] = h[n];
  }
}

template <typename T>
cudaError_t dispatch(int n, const void* x, const float* dt, const float* Bc,
                     const float* Cc, const float* A, const float* h0,
                     void* y, float* hT, int batch, int S, int Di,
                     cudaStream_t stream) {
  const dim3 grid((Di + kThreads - 1) / kThreads, batch);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (n) {
    case 4:
      selective_scan_kernel<T, 4><<<grid, kThreads, 0, stream>>>(
          xt, dt, Bc, Cc, A, h0, yt, hT, S, Di);
      break;
    case 8:
      selective_scan_kernel<T, 8><<<grid, kThreads, 0, stream>>>(
          xt, dt, Bc, Cc, A, h0, yt, hT, S, Di);
      break;
    case 16:
      selective_scan_kernel<T, 16><<<grid, kThreads, 0, stream>>>(
          xt, dt, Bc, Cc, A, h0, yt, hT, S, Di);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
    err = dispatch<__nv_bfloat16>(state_dim, x, f32(dt), f32(Bc), f32(Cc),
                                  f32(A), f32(h0), y, ht, batch, s_len,
                                  d_inner, s);
  else
    err = dispatch<float>(state_dim, x, f32(dt), f32(Bc), f32(Cc), f32(A),
                          f32(h0), y, ht, batch, s_len, d_inner, s);
  return static_cast<int>(err);
}

const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
