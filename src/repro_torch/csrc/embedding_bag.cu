// K1: fused multi-table embedding bag (pooled sum) for Hopper (sm_90a),
// forward and backward.
//
// Forward.  Replaces the Pallas TPU kernel
//   src/repro/kernels/embedding_bag/kernel.py::embedding_bag_fused
//   (pallas_call at :68, body _bag_kernel at :36).
// It computes out[n, :] = sum_p arena[idx[n, p], :] over a stacked
// multi-table arena, accumulated and written in float32 for float32 and
// bfloat16 arenas alike, the slots added in the order p = 0 .. P-1 (the
// plain version's order: the two agree bit for bit).  Row 0 of the arena
// is the row that padded pooling slots point at.
//
// Backward.  Replaces the jnp gradient of the JAX op
//   src/repro/kernels/embedding_bag/ref.py::embedding_bag_grad_ref
//   (no Pallas kernel; called by ops.py::_bwd at :63).
// g = zeros(R, D); g[idx[n, p]] += grad_out[n] for every slot; g[0] = 0.
// The wrapper plans it (kernel.py::backward_plan): the slots of row 0 are
// dropped, the rest stably sorted by row and each run of equal rows cut
// into chunks.  Pass 1 sums each chunk's grad_out rows into a partial,
// pass 2 each run's partials into its row of g, both in a fixed order and
// without atomics, so two launches give the same bits.
//
// Bound: memory.  Forward: every distinct row touched read once, the
// indices and the output, at 3.35 TB/s on an H100 SXM.  Backward: the
// dense gradient written once, the indices and grad_out read once.  The
// additions are far below the float32 rate in both.
//
// Design.  One warp per bag (forward) or per segment (backward, a grid-
// stride loop in both); the lanes cover a row in 16-byte chunks (float4
// for float32, 8 x bf16 for bfloat16), so each row load is one coalesced
// 512-byte access at D = 128, and a loop over 32-chunk passes covers wider
// rows.
//   * Indices are read 32 slots at a time, one per lane (coalesced), and
//     handed out with __shfl_sync: no dependent index load in front of a
//     row load.  The forward stages kGroups such groups of a bag in shared
//     memory, their loads all in flight at once.
//   * Up to kFwdBatch / kBwdBatch row loads per lane are issued before any
//     is added; the adds then run in slot order.
//   * Forward: row 0 is read once per bag into registers, and a padding
//     slot (index 0) adds that copy instead of loading the row.  At the
//     main path's shapes ~90% of the slots are padding.  When row 0 is
//     all zeros (+0 or -0), adding it is idempotent (x + 0 is x, except
//     that -0 + +0 is +0, which a second add leaves alone), so of a run of
//     padding slots only the first is added, and none before the first
//     real slot (the sum starts at +0): the same bits, a tenth of the
//     work.  A non-zero row 0 is added at every padding slot.
//   * Forward: what is left is bound by instruction issue and latency,
//     not bytes: two loads in flight per lane ran faster than four or
//     eight, as more warps fit an SM in fewer registers.
//   * float32 accumulation in registers, one store per chunk.
//   * Row offsets in 64 bits: the main path's arenas and gradients pass
//     2^31 elements.
//   * An index outside [0, R) traps, so the launch fails loudly instead of
//     reading or writing another allocation.
//
// Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/embedding_bag/kernel.py.  The kernels allocate
// nothing and launch on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroups = 8;      // 32-slot index groups staged at once
constexpr int kFwdBatch = 2;    // row loads in flight per lane, forward
constexpr int kBwdBatch = 8;    // the same, backward

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
  // every value +0 or -0
  __device__ __forceinline__ static bool is_zero(const Vec& v) {
    return ((__float_as_uint(v.x) | __float_as_uint(v.y) |
             __float_as_uint(v.z) | __float_as_uint(v.w)) &
            0x7fffffffu) == 0;
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
  __device__ __forceinline__ static bool is_zero(const Vec& v) {
    return ((v.x | v.y | v.z | v.w) & 0x7fff7fffu) == 0;
  }
};

template <class Vec>
__device__ __forceinline__ Vec load_row_chunk(const Vec* __restrict__ rows,
                                              int64_t row, int chunks,
                                              int c) {
  return __ldg(rows + row * chunks + c);
}

template <int kElems>
__device__ __forceinline__ void store_chunk(float* dst, const float* acc) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int e = 0; e < kElems / 4; ++e)
    d[e] = make_float4(acc[4 * e], acc[4 * e + 1], acc[4 * e + 2],
                       acc[4 * e + 3]);
}

__device__ __forceinline__ int64_t warp_id() {
  return (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) /
         kWarp;
}

__device__ __forceinline__ int64_t warp_count() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x / kWarp;
}

// Adds one group of up to 32 slots of a bag to acc, in slot order: lane l
// holds the index of slot l in `my`, and `cl` is the lane's chunk (any
// chunk of the row on a lane past the row's end, whose sum is not
// stored).  With a zero row 0, `pad_before` says whether the slot before
// the group was padding (or the bag's start), and is updated.
template <class C>
__device__ __forceinline__ void add_group(
    float* acc, int32_t my, int n_here, bool zero_row, uint32_t& pad_before,
    const typename C::Vec& row0, const typename C::Vec* __restrict__ arena,
    int chunks, int cl) {
  using Vec = typename C::Vec;
  const uint32_t valid = n_here == kWarp ? kFull : (1u << n_here) - 1;
  uint32_t todo = valid;  // slots to add, in order
  if (zero_row) {
    const uint32_t pad = valid & ~__ballot_sync(kFull, my != 0);
    // real slots, and the first padding slot of each run: the rest add
    // nothing
    todo = (valid & ~pad) | (pad & ~((pad << 1) | pad_before));
    pad_before = pad >> 31;
  }
  while (todo) {
    Vec v[kFwdBatch];
    int n = 0;
#pragma unroll
    for (int u = 0; u < kFwdBatch; ++u) {
      if (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int32_t row = __shfl_sync(kFull, my, j);
        v[u] = row == 0 ? row0 : load_row_chunk(arena, row, chunks, cl);
        n = u + 1;
      }
    }
#pragma unroll
    for (int u = 0; u < kFwdBatch; ++u)
      if (u < n) C::add(acc, v[u]);
  }
}

template <class C>
__global__ void __launch_bounds__(kBlock)
    bag_kernel(const void* __restrict__ arena_v,
               const int32_t* __restrict__ idx, float* __restrict__ out,
               int64_t n_rows, int64_t n_bags, int pool, int dim) {
  using Vec = typename C::Vec;
  constexpr int kStage = kGroups * kWarp;  // slots staged at once
  __shared__ int32_t staged[kBlock / kWarp][kStage];
  const Vec* __restrict__ arena = static_cast<const Vec*>(arena_v);
  const int lane = threadIdx.x % kWarp;
  int32_t* my_staged = staged[threadIdx.x / kWarp];
  const int chunks = dim / C::kElems;  // 16-byte chunks per row

  for (int64_t bag = warp_id(); bag < n_bags; bag += warp_count()) {
    const int32_t* bag_idx = idx + bag * pool;
    for (int c0 = 0; c0 < chunks; c0 += kWarp) {
      const int c = c0 + lane;
      const bool on = c < chunks;     // bf16 at D = 128 uses 16 lanes
      const int cl = on ? c : c0;
      const Vec row0 = __ldg(arena + cl);
      const bool zero_row = __all_sync(kFull, C::is_zero(row0));
      float acc[C::kElems];
#pragma unroll
      for (int e = 0; e < C::kElems; ++e) acc[e] = 0.0f;
      // with a zero row 0, the bag's start counts as padding: the sum is
      // +0 there, and a zero row adds nothing to it
      uint32_t pad_before = 1;
      for (int p0 = 0; p0 < pool; p0 += kStage) {
        const int n_stage = min(kStage, pool - p0);
        // stage the next kStage indices: every load in flight at once
        int32_t r[kGroups];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const int q = g * kWarp + lane;
          r[g] = q < n_stage ? bag_idx[p0 + q] : 0;
        }
        __syncwarp();  // the previous stage is read
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          if (r[g] < 0 || static_cast<int64_t>(r[g]) >= n_rows) __trap();
          my_staged[g * kWarp + lane] = r[g];
        }
        __syncwarp();
#pragma unroll 1
        for (int q0 = 0; q0 < n_stage; q0 += kWarp)
          add_group<C>(acc, my_staged[q0 + lane], min(kWarp, n_stage - q0),
                       zero_row, pad_before, row0, arena, chunks, cl);
      }
      if (on) store_chunk<C::kElems>(out + bag * dim + c * C::kElems, acc);
    }
  }
}

// Segment s sums the src rows ids[bounds[s]] .. ids[bounds[s+1] - 1] (the
// rows bounds[s] .. bounds[s+1] - 1 themselves when kIds is false) in that
// order into row dst_rows[s] of dst (row s when dst_rows is null).
template <class C, bool kIds>
__global__ void __launch_bounds__(kBlock)
    segment_sum_kernel(const void* __restrict__ src_v,
                       const int32_t* __restrict__ ids,
                       const int64_t* __restrict__ bounds, int64_t n_segs,
                       int64_t n_src_rows, float* __restrict__ dst,
                       const int64_t* __restrict__ dst_rows,
                       int64_t n_dst_rows, int dim) {
  using Vec = typename C::Vec;
  const Vec* __restrict__ src = static_cast<const Vec*>(src_v);
  const int lane = threadIdx.x % kWarp;
  const int chunks = dim / C::kElems;

  for (int64_t seg = warp_id(); seg < n_segs; seg += warp_count()) {
    const int64_t begin = bounds[seg];
    const int64_t end = bounds[seg + 1];
    const int64_t drow = dst_rows == nullptr ? seg : dst_rows[seg];
    if (drow < 0 || drow >= n_dst_rows) __trap();
    if (!kIds && (begin < 0 || end > n_src_rows)) __trap();
    for (int c0 = 0; c0 < chunks; c0 += kWarp) {
      const int c = c0 + lane;
      const bool on = c < chunks;
      const int cl = on ? c : c0;
      float acc[C::kElems];
#pragma unroll
      for (int e = 0; e < C::kElems; ++e) acc[e] = 0.0f;
      for (int64_t k0 = begin; k0 < end; k0 += kWarp) {
        int32_t my = 0;
        if (kIds && k0 + lane < end) {
          my = ids[k0 + lane];
          if (my < 0 || static_cast<int64_t>(my) >= n_src_rows) __trap();
        }
        const int n_here =
            end - k0 < kWarp ? static_cast<int>(end - k0) : kWarp;
        for (int j0 = 0; j0 < n_here; j0 += kBwdBatch) {
          Vec v[kBwdBatch];
#pragma unroll
          for (int u = 0; u < kBwdBatch; ++u) {
            const int j = j0 + u;
            if (j < n_here) {
              const int64_t row = kIds ? __shfl_sync(kFull, my, j) : k0 + j;
              v[u] = load_row_chunk(src, row, chunks, cl);
            }
          }
#pragma unroll
          for (int u = 0; u < kBwdBatch; ++u)
            if (j0 + u < n_here) C::add(acc, v[u]);
        }
      }
      if (on) store_chunk<C::kElems>(dst + drow * dim + c * C::kElems, acc);
    }
  }
}

}  // namespace

extern "C" {

// Launch the forward on `stream`.  arena: (n_rows, dim) float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1), 16-byte aligned, dim a multiple
// of 128; idx: (n_bags, pool) int32; out: (n_bags, dim) float32.  Returns
// the cudaError_t of the launch (0 = success).
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

// Launch one pass of the backward on `stream`: for each of the n_segs
// segments, dst[dst_rows[s]] (dst[s] when dst_rows is null) = the float32
// sum, in order, of the src rows ids[bounds[s]] .. ids[bounds[s+1] - 1]
// (the src rows bounds[s] .. bounds[s+1] - 1 when ids is null).  src:
// (n_src_rows, dim) float32 (is_bf16 = 0) or, with ids, bfloat16
// (is_bf16 = 1), 16-byte aligned; ids int32; bounds (n_segs + 1) int64;
// dst (n_dst_rows, dim) float32; dst_rows int64.  Returns the cudaError_t
// of the launch.
int embedding_bag_segment_sum(const void* src, int is_bf16,
                              const int32_t* ids, const int64_t* bounds,
                              long long n_segs, long long n_src_rows,
                              float* dst, const int64_t* dst_rows,
                              long long n_dst_rows, int dim, int grid,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids == nullptr) {  // pass 2 sums float32 partials
    if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    segment_sum_kernel<F32Chunk, false><<<grid, kBlock, 0, s>>>(
        src, ids, bounds, n_segs, n_src_rows, dst, dst_rows, n_dst_rows, dim);
  } else if (is_bf16) {
    segment_sum_kernel<Bf16Chunk, true><<<grid, kBlock, 0, s>>>(
        src, ids, bounds, n_segs, n_src_rows, dst, dst_rows, n_dst_rows, dim);
  } else {
    segment_sum_kernel<F32Chunk, true><<<grid, kBlock, 0, s>>>(
        src, ids, bounds, n_segs, n_src_rows, dst, dst_rows, n_dst_rows, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

int embedding_bag_block_threads() { return kBlock; }

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
