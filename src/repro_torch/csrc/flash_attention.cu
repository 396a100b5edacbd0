// K2: flash attention forward (causal, optional sliding window, grouped
// KV heads) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd
//   (pallas_call at :96, body _flash_fwd_kernel at :31).
// It computes, for every query row, softmax(q . k^T * scale) . v over the
// keys the mask allows, with an online softmax: float32 running max m,
// denominator l and accumulator acc, the output acc / max(l, 1e-20)
// written in the input dtype.  Mask: key k < T (the TRUE key length: the
// TPU op attends to zero-padded keys when causal is off), q >= k when
// causal, q - k < window when a window is given.  Layout (B, S, H, hd) for
// q and the output, (B, T, Hkv, hd) for k and v, contiguous; query head h
// reads KV head h / (Hq / Hkv).  (b, h) bases are 64-bit: prefill_32k has
// 4.3e9 elements.  A row with no valid key at all (only when S > T +
// window) gives 0.  Key tiles wholly masked by causality or by the window
// are skipped: a row that has a valid key cannot be changed by them.
//
// Bound: operations.  4 * hd flops per unmasked (q, k) pair; at the
// prefill shapes (q 2 x 8192 x 32 x 80, k/v 8 heads, causal, window 4096)
// that is 5.15e11 flops, 0.52 ms at the H100's 989 TFLOP/s bf16 dense
// peak, against 0.06 ms for the bytes of q, k, v and o at 3.35 TB/s.
// Only the tensor cores can approach it: float32 on the CUDA cores (67
// TFLOP/s) needs at least 7.7 ms.
//
// Training also asks for each row's log-sum-exp of the scaled scores,
// lse = log(sum_k exp(q . k * scale)), (B, Hq, S) float32, which the
// backward (csrc/flash_attention_bwd.cu) reads instead of recomputing the
// softmax's statistics.  Both kernels store it after their last key tile
// where the caller passes an lse pointer (a null pointer stores nothing,
// as when serving); it changes no arithmetic of the output.  A row with no
// valid key stores +inf, so that the backward's P is 0 there.
//
// Which dtype takes which kernel:
//
// * bfloat16 -> flash_fwd_tc_kernel, on the tensor cores with wgmma
//   (m64nNk16, bf16 in, float32 accumulators):
//   - a block of four warpgroups (512 threads) at hd 80, two elsewhere,
//     per (b * Hq + h, q tile), each warpgroup owning 64 rows and sharing
//     the block's K/V tiles; the grid runs the q tiles heaviest first (the
//     last tiles of the causal triangle visit the most keys), so light
//     tiles fill the tail;
//   - S = Q . K^T: Q and the K tile (64 keys; 32 at hd 256, to stay
//     within the registers) in shared memory, both K-major;
//   - O += P . V: P in bf16 registers is wgmma's register A operand, so
//     it never goes through shared memory; the V tile is the shared B
//     operand, MN-major (hd contiguous);
//   - tiles stay bf16 in shared memory in the no-swizzle "core matrix"
//     layout (8 rows x 16 bytes contiguous), which takes any hd that is a
//     multiple of 16 -- hd 80's 160-byte rows fit no 128-byte swizzle atom
//     -- and which wgmma reads without bank conflicts;
//   - a two-stage ring of K/V tiles filled by cp.async 16-byte copies (the
//     next tile loads while this one is computed), one __syncthreads a
//     tile; the ragged tail (rows past S or T) is zero-filled by the copy
//     itself (src-size 0);
//   - softmax on the accumulator fragments: a row lives in the 4 lanes of
//     a quad, so its max takes two shuffles and its sum none until the
//     epilogue; the max is taken on the raw scores, p = exp2f(s * scale *
//     log2(e) - m) is one FFMA and an exp2, masked scores are -inf, and a
//     row whose max is still -inf exponentiates against 0; the row sum is
//     taken from the float32 p, before P is rounded to bf16;
//   - only tiles that cross the diagonal, the window's edge or the key
//     length are masked: at the prefill shape 2 of at most 65 visited;
//   - on those edge tiles P . V runs twice, on bf16(p) and on the bf16
//     remainder p - bf16(p): the rows with few keys -- the first rows of
//     the causal triangle, all in edge tiles -- have outputs as large as
//     v, where one bf16 step (7.8e-3 at |out| >= 1) is above the 4e-3
//     that the served shapes are held to, and P rounded once to bf16
//     moves such outputs across a rounding boundary (a CPU emulation of
//     these numerics is tests/test_torch_kernel_flash_attention.py).
//     Interior tiles round P once: every row there attends all of the
//     tile's keys, so its output is an average over at least 64 (32);
//   - registers: at most 128 a thread at hd 32 and 80 (launch bounds), so
//     four warpgroups fit an SM -- one register more halves them;
//     every branch around a wgmma is uniform to ptxas (the warpgroup index
//     comes from a shuffle), or ptxas serializes every wgmma of the kernel.
// * float32 -> flash_fwd_kernel, on the CUDA cores (the exact route that
//   the CPU-parity and cross-device checks use; TF32 would not meet their
//   limits):
//   - one block of 8 warps per (b * Hq + h, 64-query tile); each warp owns
//     8 query rows, so no row state crosses warps;
//   - 64-key tiles of k and v staged in shared memory (k rows padded by 4
//     floats so that lanes reading 16 bytes of different keys hit
//     distinct banks); the q tile stays in shared memory for the block's
//     life;
//   - scores: lane j computes keys j and j + 32 for the warp's 8 rows, a
//     2 x 8 register tile fed by 16-byte shared loads (q by broadcast);
//   - softmax: row max and row sum by warp shuffles, float32 throughout,
//     expf (no fast math), in the Pallas body's order of updates, scores
//     masked to -1e30;
//   - P . V: P goes through the warp's slice of shared memory; lane j
//     accumulates columns j, j + 32, ... of its 8 rows, so hd is split
//     across the lanes and no lane holds a whole row (hd 256 would spill).
//
// Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/flash_attention/kernel.py.  The kernels allocate
// nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kRows = 8;                  // query rows per warp
constexpr int kQTile = kWarps * kRows;    // 64 query rows per block
constexpr int kKTile = 64;                // keys per shared-memory tile
constexpr int kThreads = kWarps * kWarp;
constexpr float kNegInf = -1e30f;

template <int HD>
struct Smem {
  static constexpr int kKStride = HD + 4;
  static constexpr int kQ = kQTile * HD;
  static constexpr int kK = kKTile * kKStride;
  static constexpr int kV = kKTile * HD;
  static constexpr int kP = kWarps * kKTile * kRows;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kP);
};

// 16 bytes of float32: 4 values.
struct F32IO {
  using T = float;
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void load(const T* src, float* dst) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  }
  __device__ __forceinline__ static void zero(float* dst) {
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ static T from_float(float x) { return x; }
};

// Rows [0, n) of a (rows, HD) tile from global memory (row r at
// src + r * row_stride) into shared float32 rows of `stride` floats;
// rows [n, rows) are zero.
template <int HD, class IO>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const typename IO::T* src,
                                          int64_t row_stride, int rows,
                                          int n) {
  constexpr int kChunks = HD / IO::kVec;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * IO::kVec;
    if (r < n)
      IO::load(src + r * row_stride + c, dst + r * stride + c);
    else
      IO::zero(dst + r * stride + c);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD, class IO>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const typename IO::T* __restrict__ q,
                     const typename IO::T* __restrict__ k,
                     const typename IO::T* __restrict__ v,
                     typename IO::T* __restrict__ o,
                     float* __restrict__ lse, int S, int T, int Hq,
                     int Hkv, int causal, int window, float scale) {
  using Sm = Smem<HD>;
  constexpr int kCols = (HD + kWarp - 1) / kWarp;  // columns per lane
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + Sm::kQ;
  float* vs = ks + Sm::kK;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  float* ps = vs + Sm::kV + warp * kKTile * kRows;  // this warp's P, [key][row]

  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kQTile;
  const int64_t q_row = static_cast<int64_t>(Hq) * HD;
  const int64_t kv_row = static_cast<int64_t>(Hkv) * HD;
  const typename IO::T* qb = q + static_cast<int64_t>(b) * S * q_row +
                             static_cast<int64_t>(h) * HD;
  const typename IO::T* kb = k + static_cast<int64_t>(b) * T * kv_row +
                             static_cast<int64_t>(hk) * HD;
  const typename IO::T* vb = v + static_cast<int64_t>(b) * T * kv_row +
                             static_cast<int64_t>(hk) * HD;
  typename IO::T* ob = o + static_cast<int64_t>(b) * S * q_row +
                       static_cast<int64_t>(h) * HD;

  load_tile<HD, IO>(qs, HD, qb + static_cast<int64_t>(q0) * q_row, q_row,
                    kQTile, min(kQTile, S - q0));

  // keys some row of this tile may attend: the rest are masked for all
  const int q_last = min(q0 + kQTile, S) - 1;
  const int k_end = causal ? min(T, q_last + 1) : T;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  const int r0 = warp * kRows;
  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int kt = (k_begin / kKTile) * kKTile; kt < k_end; kt += kKTile) {
    __syncthreads();  // every warp is done with the previous k/v tile
    const int n_keys = min(kKTile, T - kt);
    load_tile<HD, IO>(ks, Sm::kKStride, kb + kt * kv_row, kv_row, kKTile,
                      n_keys);
    load_tile<HD, IO>(vs, HD, vb + kt * kv_row, kv_row, kKTile, n_keys);
    __syncthreads();

    // s[r][j] = q[r0 + r] . k[lane + 32 j]
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 k0 =
          *reinterpret_cast<const float4*>(ks + lane * Sm::kKStride + d);
      const float4 k1 = *reinterpret_cast<const float4*>(
          ks + (lane + kWarp) * Sm::kKStride + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (r0 + r) * HD + d);
        s[r][0] = fmaf(qv.x, k0.x, s[r][0]);
        s[r][0] = fmaf(qv.y, k0.y, s[r][0]);
        s[r][0] = fmaf(qv.z, k0.z, s[r][0]);
        s[r][0] = fmaf(qv.w, k0.w, s[r][0]);
        s[r][1] = fmaf(qv.x, k1.x, s[r][1]);
        s[r][1] = fmaf(qv.y, k1.y, s[r][1]);
        s[r][1] = fmaf(qv.z, k1.z, s[r][1]);
        s[r][1] = fmaf(qv.w, k1.w, s[r][1]);
      }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = kt + lane + j * kWarp;
        bool ok = kp < T;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && qp - kp < window;
        s[r][j] = ok ? s[r][j] * scale : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
      ps[lane * kRows + r] = p0;
      ps[(lane + kWarp) * kRows + r] = p1;
    }
    __syncwarp();

    // acc[r][c] += sum_kk p[r][kk] * v[kk][lane + 32 c]
#pragma unroll 4
    for (int kk = 0; kk < kKTile; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + kk * kRows);
      const float4 pb = *reinterpret_cast<const float4*>(ps + kk * kRows + 4);
      const float p[kRows] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + c * kWarp;
        if (d < HD) {
          const float vv = vs[kk * HD + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
        }
      }
    }
    __syncwarp();  // P is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
    typename IO::T* orow = ob + static_cast<int64_t>(qp) * q_row;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + c * kWarp;
      if (d < HD) orow[d] = IO::from_float(acc[r][c] * inv);
    }
    if (lse != nullptr && lane == 0)
      lse[static_cast<int64_t>(blockIdx.y) * S + qp] =
          l[r] > 0.f ? m[r] + logf(l[r]) : __int_as_float(0x7f800000);
  }
}

template <int HD, class IO>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int T, int Hq, int Hkv,
                   int causal, int window, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<HD, IO>;
  const int bytes = static_cast<int>(Smem<HD>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  using T_ = typename IO::T;
  dim3 grid((S + kQTile - 1) / kQTile, B * Hq);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T_*>(q), static_cast<const T_*>(k),
      static_cast<const T_*>(v), static_cast<T_*>(o), lse, S, T, Hq, Hkv,
      causal, window, scale);
  return cudaGetLastError();
}

template <class IO>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* o, float* lse, int B, int S, int T, int Hq,
                     int Hkv, int causal, int window, float scale,
                     cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<32, IO>(q, k, v, o, lse, B, S, T, Hq, Hkv,
                            causal, window, scale, stream);
    case 64:
      return launch<64, IO>(q, k, v, o, lse, B, S, T, Hq, Hkv,
                            causal, window, scale, stream);
    case 80:
      return launch<80, IO>(q, k, v, o, lse, B, S, T, Hq, Hkv,
                            causal, window, scale, stream);
    case 128:
      return launch<128, IO>(q, k, v, o, lse, B, S, T, Hq, Hkv,
                             causal, window, scale, stream);
    case 256:
      return launch<256, IO>(q, k, v, o, lse, B, S, T, Hq, Hkv,
                             causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel.

using bf16 = __nv_bfloat16;

// Tile sizes per head dim.  Each warpgroup owns 64 query rows; the K/V
// tiles are shared by the block's warpgroups -- four at hd 80 (the served
// shape), where 128 registers a thread suffice, two elsewhere (512 threads
// cap a thread at 128 registers, too few from hd 64 up).
template <int HD>
struct TcCfg {
  static constexpr int kWG = HD == 80 ? 4 : 2;       // warpgroups per block
  static constexpr int kKeys = HD == 256 ? 32 : 64;  // keys per tile
  static constexpr int kStages = 2;                  // K/V tiles in smem
  static constexpr int kRows = 64 * kWG;             // query rows per block
  static constexpr int kThreads = 128 * kWG;
  // four warpgroups per SM, so at most 128 registers a thread, where that
  // holds without a spill (one register more halves the blocks in flight)
  static constexpr int kMinBlocks = HD == 32 || HD == 80 ? 4 / kWG : 1;
  static constexpr int kRowBytes = HD * 2;
  // core-matrix layout: 8 rows x 16 bytes per 128-byte block; blocks of
  // one 8-row group are adjacent along hd (128 bytes apart), the groups
  // are 8 * kRowBytes apart
  static constexpr uint32_t kChunkStride = 128;
  static constexpr uint32_t kGroupStride = 8 * kRowBytes;
  static constexpr int kQBytes = kRows * kRowBytes;
  static constexpr int kTileBytes = kKeys * kRowBytes;
  static constexpr int kBytes = kQBytes + kStages * 2 * kTileBytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, n) of a (rows, HD) bf16 tile (row r at src + r * row_stride)
// into shared memory at `dst` in the core-matrix layout; rows [n, rows)
// are zero-filled by the copy.  Thread i's 16 bytes land at dst + 16 i:
// 8 neighbouring threads fill the 8 rows of one 128-byte block.
template <int HD, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src,
                                                int64_t row_stride, int rows,
                                                int n) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += THREADS) {
    const int w = i % (8 * kChunks);
    const int r = (i / (8 * kChunks)) * 8 + w % 8;
    const int c = w / 8;
    const bool ok = r < n;
    cp_async_16(dst + 16 * i, ok ? src + r * row_stride + c * 8 : src,
                ok ? 16 : 0);
  }
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, the
// leading (LBO) and stride (SBO) byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator or
// operand registers across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (*r)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D(64 x 32) (+)= A(64 x 16, shared, K-major) . B(16 x 32, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D(64 x 64) (+)= A(64 x 16, shared, K-major) . B(16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D(64 x 32) += A(64 x 16, registers) . B(16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64 x 64) += A(64 x 16, registers) . B(16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64 x 80) += A(64 x 16, registers) . B(16 x 80, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39 "
      "}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64 x 128) += A(64 x 16, registers) . B(16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64 x 256) += A(64 x 16, registers) . B(16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// S(64 x N) = Q . K^T over hd: HD / 16 k-steps.
template <int N>
__device__ __forceinline__ void mma_qk(float* d, uint64_t a, uint64_t b,
                                       int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32(d, a, b, scale_d);
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
}

// O(64 x HD) += P(64 x 16) . V(16 x HD).
template <int HD>
__device__ __forceinline__ void mma_pv(float* d, const uint32_t* a,
                                       uint64_t b) {
  if constexpr (HD == 32) wgmma_rs_n32(d, a, b);
  if constexpr (HD == 64) wgmma_rs_n64(d, a, b);
  if constexpr (HD == 80) wgmma_rs_n80(d, a, b);
  if constexpr (HD == 128) wgmma_rs_n128(d, a, b);
  if constexpr (HD == 256) wgmma_rs_n256(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Block i takes q tile n_qtiles - 1 - i / BH of head (b * Hq + h) = i % BH.
// Thread layout (wgmma's accumulator fragments): warp w of a warpgroup
// holds its rows 16 w + g and 16 w + g + 8 (g = lane / 4); for every
// 8-column block j it holds columns 8 j + 2 (lane % 4) + {0, 1} of both
// rows, at fragment index 4 j + 2 half + e.
template <int HD>
__global__ void __launch_bounds__(TcCfg<HD>::kThreads, TcCfg<HD>::kMinBlocks)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int S, int T, int Hq,
                        int Hkv, int causal, int window, float scale_log2,
                        int n_qtiles) {
  using C = TcCfg<HD>;
  constexpr int kKeys = C::kKeys;
  const float kInf = __int_as_float(0x7f800000);
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t qs = smem_u32(tc_smem);
  const uint32_t kv0 = qs + C::kQBytes;

  const int BH = gridDim.x / n_qtiles;
  const int bh = blockIdx.x % BH;
  const int blk_q0 = (n_qtiles - 1 - blockIdx.x / BH) * C::kRows;
  // warp-uniform to the compiler (a shuffle from lane 0), so that the
  // branches around wgmma below are not divergent paths to ptxas,
  // which would serialize every wgmma
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int q0 = blk_q0 + 64 * wg;  // this warpgroup's rows
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int64_t q_row = static_cast<int64_t>(Hq) * HD;
  const int64_t kv_row = static_cast<int64_t>(Hkv) * HD;
  const bf16* qb = q + static_cast<int64_t>(b) * S * q_row +
                   static_cast<int64_t>(h) * HD;
  const bf16* kb = k + static_cast<int64_t>(b) * T * kv_row +
                   static_cast<int64_t>(hk) * HD;
  const bf16* vb = v + static_cast<int64_t>(b) * T * kv_row +
                   static_cast<int64_t>(hk) * HD;
  bf16* ob = o + static_cast<int64_t>(b) * S * q_row +
             static_cast<int64_t>(h) * HD;

  // keys some row of this warpgroup (w) or block (b) may attend: the rest
  // are masked for all
  const int q_last = q0 + 63;
  auto first_tile = [&](int r0) {
    return (window > 0 ? max(0, r0 - window + 1) : 0) / kKeys;
  };
  auto end_tile = [&](int r1) {
    return ((causal ? min(T, r1 + 1) : T) + kKeys - 1) / kKeys;
  };
  const int t_begin = first_tile(blk_q0);
  const int t_end = end_tile(blk_q0 + C::kRows - 1);
  const int tw_begin = first_tile(q0);
  const int tw_end = end_tile(q_last);

  auto load_kv = [&](int t, int stage) {
    const int kt = t * kKeys;
    const uint32_t ks = kv0 + stage * 2 * C::kTileBytes;
    load_tile_async<HD, C::kThreads>(ks, kb + kt * kv_row, kv_row, kKeys,
                                     T - kt);
    load_tile_async<HD, C::kThreads>(ks + C::kTileBytes, vb + kt * kv_row,
                                     kv_row, kKeys, T - kt);
  };
  load_tile_async<HD, C::kThreads>(qs, qb + static_cast<int64_t>(blk_q0) *
                                               q_row,
                                   q_row, C::kRows, S - blk_q0);
  const uint32_t qw = qs + wg * 64 * C::kRowBytes;  // this warpgroup's Q
  // kStages - 1 tiles in flight, one cp.async group each (an empty group
  // where there is no tile keeps the count); Q rides in the first group
#pragma unroll
  for (int j = 0; j < C::kStages - 1; ++j) {
    if (t_begin + j < t_end) load_kv(t_begin + j, j);
    cp_async_commit();
  }

  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + 16 * warp + lane / 4;  // rows row0, row0 + 8
  const int col0 = 2 * (lane % 4);

  float acc[HD / 2];
  float s[kKeys / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
  float m[2] = {-kInf, -kInf};  // running max of score * scale * log2(e)
  float l[2] = {0.f, 0.f};      // this thread's share of the row sums

  // one key tile; compiled twice, for edge tiles (masked, P split into
  // hi + lo) and interior ones, so that the interior code carries neither
  auto tile = [&](uint32_t ks, int kt, auto edge_tag) {
    constexpr bool edge = decltype(edge_tag)::value;
    const uint32_t vs = ks + C::kTileBytes;

    // S = Q . K^T (both K-major: LBO steps along hd, SBO over 8 rows)
    fence_regs<kKeys / 2>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_qk<kKeys>(s,
                    make_desc(qw + kk * 2 * C::kChunkStride, C::kChunkStride,
                              C::kGroupStride),
                    make_desc(ks + kk * 2 * C::kChunkStride, C::kChunkStride,
                              C::kGroupStride),
                    kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs<kKeys / 2>(s);

    // the max of the raw scores (the scale is positive): p is then one
    // FFMA and an exp2 away
    float mx[2] = {-kInf, -kInf};
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      if constexpr (edge) {
        const int row = row0 + 8 * ((i / 2) % 2);
        const int key = kt + 8 * (i / 4) + col0 + i % 2;
        bool ok = key < T;
        if (causal) ok = ok && row >= key;
        if (window > 0) ok = ok && row - key < window;
        s[i] = ok ? s[i] : -kInf;
      }
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    }
    float corr[2], base[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf] * scale_log2);
      base[hf] = m_new == -kInf ? 0.f : m_new;  // no valid key yet
      corr[hf] = exp2f(m[hf] - base[hf]);
      m[hf] = m_new;
      l[hf] *= corr[hf];
    }
    // P in bf16; on edge tiles also the bf16 remainder p - bf16(p)
    uint32_t p[kKeys / 16][4];
    [[maybe_unused]] uint32_t p_lo[kKeys / 16][4];
#pragma unroll
    for (int i = 0; i < kKeys / 2; i += 2) {
      const int hf = (i / 2) % 2;
      const float p0 = exp2f(fmaf(s[i], scale_log2, -base[hf]));
      const float p1 = exp2f(fmaf(s[i + 1], scale_log2, -base[hf]));
      l[hf] += p0 + p1;
      // A fragment of k-step i / 8: {row g, row g + 8} x {cols 0-7, 8-15}
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      p[i / 8][(i / 2) % 4] = *reinterpret_cast<const uint32_t*>(&hi);
      if constexpr (edge) {
        const float2 r = __bfloat1622float2(hi);
        p_lo[i / 8][(i / 2) % 4] = pack_bf16(p0 - r.x, p1 - r.y);
      }
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i / 2) % 2];

    // O += P . V (V MN-major: LBO steps over 8 keys, SBO along hd)
    fence_regs<HD / 2>(acc);
    fence_frags<kKeys / 16>(p);
    if constexpr (edge) fence_frags<kKeys / 16>(p_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      mma_pv<HD>(acc, p[kk],
                 make_desc(vs + kk * 2 * C::kGroupStride, C::kGroupStride,
                           C::kChunkStride));
    if constexpr (edge) {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        mma_pv<HD>(acc, p_lo[kk],
                   make_desc(vs + kk * 2 * C::kGroupStride, C::kGroupStride,
                             C::kChunkStride));
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs<HD / 2>(acc);
  };

  for (int t = t_begin; t < t_end; ++t) {
    // tile t has landed once at most kStages - 2 later groups are pending
    cp_async_wait<C::kStages - 2>();
    // cp.async writes through the generic proxy, wgmma reads through the
    // async one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // tile t is in, and every warp is done with tile t - 1, whose stage
    // the next load fills
    __syncthreads();
    {
      const int next = t + C::kStages - 1;
      if (next < t_end) load_kv(next, (next - t_begin) % C::kStages);
      cp_async_commit();
    }
    if (t < tw_begin || t >= tw_end) continue;  // all masked for this group
    const uint32_t ks =
        kv0 + ((t - t_begin) % C::kStages) * 2 * C::kTileBytes;
    const int kt = t * kKeys;
    const bool edge = kt + kKeys > T || (causal && kt + kKeys - 1 > q0) ||
                      (window > 0 && q_last - kt >= window);
    if (edge)
      tile(ks, kt, std::true_type{});
    else
      tile(ks, kt, std::false_type{});
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = l[hf];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-20f);
    const int row = row0 + 8 * hf;
    if (row >= S) continue;
    if (lse != nullptr && lane % 4 == 0)  // m is in log2 units
      lse[static_cast<int64_t>(bh) * S + row] =
          m[hf] == -kInf ? kInf : (m[hf] + log2f(sum)) * 0.6931471805599453f;
    bf16* orow = ob + static_cast<int64_t>(row) * q_row + col0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hf] * inv,
                                acc[4 * j + 2 * hf + 1] * inv);
  }
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int S, int T, int Hq, int Hkv,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  // the row max is taken on the unscaled scores, which needs scale > 0
  if (!(scale > 0.f)) return cudaErrorInvalidValue;
  auto kern = flash_fwd_tc_kernel<HD>;
  const int bytes = TcCfg<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (S + TcCfg<HD>::kRows - 1) / TcCfg<HD>::kRows;
  const int64_t blocks = static_cast<int64_t>(n_qtiles) * B * Hq;
  if (blocks >= (int64_t{1} << 31)) return cudaErrorInvalidConfiguration;
  kern<<<static_cast<unsigned>(blocks), TcCfg<HD>::kThreads, bytes,
         stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S, T, Hq, Hkv,
      causal, window, scale * 1.4426950408889634f, n_qtiles);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(int hd, const void* q, const void* k, const void* v,
                        void* o, float* lse, int B, int S, int T, int Hq,
                        int Hkv, int causal, int window, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_tc<32>(q, k, v, o, lse, B, S, T, Hq, Hkv,
                           causal, window, scale, stream);
    case 64:
      return launch_tc<64>(q, k, v, o, lse, B, S, T, Hq, Hkv,
                           causal, window, scale, stream);
    case 80:
      return launch_tc<80>(q, k, v, o, lse, B, S, T, Hq, Hkv,
                           causal, window, scale, stream);
    case 128:
      return launch_tc<128>(q, k, v, o, lse, B, S, T, Hq, Hkv,
                            causal, window, scale, stream);
    case 256:
      return launch_tc<256>(q, k, v, o, lse, B, S, T, Hq, Hkv,
                            causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch K2 on `stream`.  q, o: (B, S, Hq, hd); k, v: (B, T, Hkv, hd);
// contiguous, 16-byte aligned, float32 (is_bf16 = 0: the CUDA-core
// kernel) or bfloat16 (is_bf16 = 1: the tensor-core kernel, which takes
// scale > 0 only); hd in {32, 64, 80, 128, 256}; Hq % Hkv == 0; window <= 0
// means none.  lse: (B, Hq, S) float32 for the row log-sum-exp, or null.
// Returns the cudaError_t of the launch (0 = success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, float* lse, int is_bf16, int head_dim,
                        int batch,
                        int s_len, int t_len, int n_q_heads, int n_kv_heads,
                        int causal, int window, float scale, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    err = dispatch_tc(head_dim, q, k, v, o, lse, batch, s_len, t_len,
                      n_q_heads, n_kv_heads, causal, window, scale, s);
  else
    err = dispatch<F32IO>(head_dim, q, k, v, o, lse, batch, s_len, t_len,
                          n_q_heads, n_kv_heads, causal, window, scale, s);
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
