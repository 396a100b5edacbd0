// K1: fused multi-table embedding bag (pooled sum) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/embedding_bag/kernel.py::embedding_bag_fused
//   (pallas_call at :68, body _bag_kernel at :36).
// It computes out[n, :] = sum_p arena[idx[n, p], :] over a stacked
// multi-table arena, accumulated and written in float32 for float32 and
// bfloat16 arenas alike.  Row 0 of the arena is a zero row that padded
// pooling slots point at.
//
// Bound: memory.  The least traffic is every distinct row touched, read
// once (distinct rows x D x element bytes), plus the indices (N x P x 4)
// and the output (N x D x 4), at 3.35 TB/s on an H100 SXM.  The additions,
// one per non-padding slot and column, are far below the float32 rate.
//
// Design (simple and right first):
//   * one warp per bag and a grid-stride loop over bags.  The lanes of a
//     warp cover a row in 16-byte chunks (float4 for float32, 8 x bf16 for
//     bfloat16), so each row load is coalesced, and a loop over chunks
//     covers D = 128, 256, 384, ...;
//   * the pooling loop is unrolled by 4: four independent row loads are in
//     flight per lane before they are summed, to cover the gather latency;
//   * float32 accumulation in registers, slots added in the order
//     p = 0 .. P-1 (the plain version's order), one store per chunk;
//   * row offsets in 64 bits: the main path's arenas pass 2^31 elements;
//   * an index outside [0, R) traps, so the launch fails loudly instead of
//     reading another allocation.
// Later work: indices staged in shared memory, cp.async/TMA prefetch of
// rows, and keeping the hot zipf rows resident in L2.
//
// Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/embedding_bag/kernel.py.  The kernel allocates
// nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 256;
constexpr int kUnroll = 4;

// 16 bytes of a float32 row: 4 values.
struct F32Chunk {
  using Vec = float4;
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void add(float* acc, const Vec& v) {
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
};

// 16 bytes of a bfloat16 row: 8 values.  A bf16 value is the high half
// of a float32, and the lower address holds the lower half of each word.
struct Bf16Chunk {
  using Vec = uint4;
  static constexpr int kElems = 8;
  __device__ __forceinline__ static float lo(uint32_t w) {
    return __uint_as_float(w << 16);
  }
  __device__ __forceinline__ static float hi(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static void add(float* acc, const Vec& v) {
    acc[0] += lo(v.x);
    acc[1] += hi(v.x);
    acc[2] += lo(v.y);
    acc[3] += hi(v.y);
    acc[4] += lo(v.z);
    acc[5] += hi(v.z);
    acc[6] += lo(v.w);
    acc[7] += hi(v.w);
  }
};

template <class C>
__device__ __forceinline__ typename C::Vec load_chunk(
    const typename C::Vec* __restrict__ arena, int32_t row, int64_t n_rows,
    int chunks, int c) {
  if (row < 0 || static_cast<int64_t>(row) >= n_rows) __trap();
  return __ldg(arena + static_cast<int64_t>(row) * chunks + c);
}

template <class C>
__global__ void __launch_bounds__(kBlock)
    bag_kernel(const void* __restrict__ arena_v,
               const int32_t* __restrict__ idx, float* __restrict__ out,
               int64_t n_rows, int64_t n_bags, int pool, int dim) {
  using Vec = typename C::Vec;
  const Vec* __restrict__ arena = static_cast<const Vec*>(arena_v);
  const int lane = threadIdx.x % kWarp;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int64_t n_warps =
      static_cast<int64_t>(gridDim.x) * blockDim.x / kWarp;
  const int chunks = dim / C::kElems;  // 16-byte chunks per row

  for (int64_t bag = warp; bag < n_bags; bag += n_warps) {
    const int32_t* bag_idx = idx + bag * pool;
    float* bag_out = out + bag * dim;
    for (int c = lane; c < chunks; c += kWarp) {
      float acc[C::kElems];
#pragma unroll
      for (int e = 0; e < C::kElems; ++e) acc[e] = 0.0f;
      int p = 0;
      for (; p + kUnroll <= pool; p += kUnroll) {
        Vec v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          v[u] = load_chunk<C>(arena, bag_idx[p + u], n_rows, chunks, c);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) C::add(acc, v[u]);
      }
      for (; p < pool; ++p)
        C::add(acc, load_chunk<C>(arena, bag_idx[p], n_rows, chunks, c));
      float4* dst = reinterpret_cast<float4*>(bag_out + c * C::kElems);
#pragma unroll
      for (int e = 0; e < C::kElems / 4; ++e)
        dst[e] = make_float4(acc[4 * e], acc[4 * e + 1], acc[4 * e + 2],
                             acc[4 * e + 3]);
    }
  }
}

}  // namespace

extern "C" {

// Launch K1 on `stream`.  arena: (n_rows, dim) float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1), 16-byte aligned, dim a multiple of 128;
// idx: (n_bags, pool) int32; out: (n_bags, dim) float32.  Returns the
// cudaError_t of the launch (0 = success).
int embedding_bag_fwd(const void* arena, int is_bf16, const int32_t* idx,
                      float* out, long long n_rows, long long n_bags,
                      int pool, int dim, int grid, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    bag_kernel<Bf16Chunk><<<grid, kBlock, 0, s>>>(arena, idx, out, n_rows,
                                                  n_bags, pool, dim);
  else
    bag_kernel<F32Chunk><<<grid, kBlock, 0, s>>>(arena, idx, out, n_rows,
                                                 n_bags, pool, dim);
  return static_cast<int>(cudaGetLastError());
}

int embedding_bag_block_threads() { return kBlock; }

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
