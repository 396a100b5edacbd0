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
// contraction into FMAs, and u * kv is not refolded as (u * k) * v), so
// it evolves with the plain version's bits.  y's dot over i runs in
// kAcc interleaved partial sums (i mod kAcc), each term added by one FMA,
// then summed pairwise: its rounding error is that of a 64 / kAcc-term
// sum, below plain's einsum's, and the step's chain of dependent adds is
// kAcc times shorter.  Layouts, all contiguous: r, k,
// v (B, S, H, 64) float32 or bfloat16; w (B, S, H, 64), u (H, 64), s0, sT
// (B, H, 64, 64), y (B, S, H, 64) float32.
//
// Design (simple first): one block of 64 threads per (b, h); thread j
// owns the state's column j, 64 floats in registers.  The block walks
// the time axis in chunks of 16 steps: the chunk's r, k, w and v rows are
// staged in shared memory (coalesced loads), then each step reads r[i],
// k[i], w[i] and u[i] as shared-memory broadcasts.  At rwkv6-1.6b's
// prefill (B 2, H 32) that is 64 blocks of two warps: accepted for now.
// Decode runs the same kernel at S = 1.
//
// Bound: operations.  7 float32 operations a state element and step: at
// (2, 8192, 32, 64) 1.5e10, 0.224 ms at 67 TFLOP/s; r, k, v, w and y once
// each in bf16 are about 0.47 GB, 0.141 ms at 3.35 TB/s.  This design is
// latency-bound on the serial time loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kHead = 64;       // RWKV_HEAD_DIM: threads a block
constexpr int kChunk = 16;      // time steps staged at a time
constexpr int kAcc = 8;         // partial sums of y's dot over i

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kHead)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ sT, int S,
                int H) {
  __shared__ float sr[kChunk][kHead];
  __shared__ float sk[kChunk][kHead];
  __shared__ float sv[kChunk][kHead];
  __shared__ float sw[kChunk][kHead];
  __shared__ float su[kHead];
  const int j = threadIdx.x;
  const int bh = blockIdx.x;                 // b * H + h
  const int b = bh / H, hh = bh % H;
  su[j] = u[hh * kHead + j];

  float s[kHead];
  const size_t sbase = static_cast<size_t>(bh) * kHead * kHead;
#pragma unroll
  for (int i = 0; i < kHead; ++i) s[i] = s0[sbase + i * kHead + j];

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int len = min(kChunk, S - t0);
    __syncthreads();                 // the previous chunk is consumed
#pragma unroll 4
    for (int q = 0; q < len; ++q) {
      const size_t off =
          ((static_cast<size_t>(b) * S + t0 + q) * H + hh) * kHead + j;
      sr[q][j] = load_f32(r + off);
      sk[q][j] = load_f32(k + off);
      sv[q][j] = load_f32(v + off);
      sw[q][j] = w[off];
    }
    __syncthreads();
    for (int q = 0; q < len; ++q) {
      const float vj = sv[q][j];
      float acc[kAcc];
#pragma unroll
      for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
#pragma unroll
      for (int i = 0; i < kHead; ++i) {
        const float kv = __fmul_rn(sk[q][i], vj);
        acc[i % kAcc] = __fmaf_rn(
            sr[q][i], __fadd_rn(s[i], __fmul_rn(su[i], kv)), acc[i % kAcc]);
        s[i] = __fadd_rn(__fmul_rn(sw[q][i], s[i]), kv);
      }
#pragma unroll
      for (int width = kAcc / 2; width > 0; width /= 2) {
#pragma unroll
        for (int a = 0; a < width; ++a)
          acc[a] = __fadd_rn(acc[a], acc[a + width]);
      }
      y[((static_cast<size_t>(b) * S + t0 + q) * H + hh) * kHead + j] =
          acc[0];
    }
  }
#pragma unroll
  for (int i = 0; i < kHead; ++i) sT[sbase + i * kHead + j] = s[i];
}

}  // namespace

extern "C" {

// Launch K4 on `stream`.  r, k, v: (B, S, H, 64) float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); w, y (B, S, H, 64), u (H, 64), s0, sT (B, H,
// 64, 64) float32; all contiguous.  Returns the cudaError_t of the launch
// (0 = success).
int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* y, void* sT, int is_bf16,
             int batch, int s_len, int n_heads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const dim3 grid(batch * n_heads);
  if (is_bf16) {
    using T = __nv_bfloat16;
    wkv6_kernel<T><<<grid, kHead, 0, st>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), f32(w), f32(u), f32(s0),
        static_cast<float*>(y), static_cast<float*>(sT), s_len, n_heads);
  } else {
    wkv6_kernel<float><<<grid, kHead, 0, st>>>(
        f32(r), f32(k), f32(v), f32(w), f32(u), f32(s0),
        static_cast<float*>(y), static_cast<float*>(sT), s_len, n_heads);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
