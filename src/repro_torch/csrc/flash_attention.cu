// K2: flash attention forward (causal, optional sliding window, grouped
// KV heads) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd
//   (pallas_call at :96, body _flash_fwd_kernel at :31).
// It computes, for every query row, softmax(q . k^T * scale) . v over the
// keys the mask allows, with an online softmax: float32 running max m,
// denominator l and accumulator acc, scores masked to -1e30, the output
// acc / max(l, 1e-20) written in the input dtype.  Mask: key k < T (the
// TRUE key length: the TPU op attends to zero-padded keys when causal is
// off), q >= k when causal, q - k < window when a window is given.
// Layout (B, S, H, hd) for q and the output, (B, T, Hkv, hd) for k and v,
// contiguous; query head h reads KV head h / (Hq / Hkv).
//
// Bound: operations.  4 * hd flops per unmasked (q, k) pair; at the
// prefill shapes that is far above the bytes of q, k, v and o (one read
// each, one write) over 3.35 TB/s on an H100 SXM.
//
// Design (simple and right first; wgmma/TMA are later work):
//   * one block of 8 warps per (b * Hq + h, 64-query tile); each warp owns
//     8 query rows, so no row state crosses warps;
//   * 64-key tiles of k and v staged in shared memory as float32 (k rows
//     padded by 4 floats so that lanes reading 16 bytes of different keys
//     hit distinct banks); the q tile stays in shared memory for the
//     block's life;
//   * scores: lane j computes keys j and j + 32 for the warp's 8 rows, a
//     2 x 8 register tile fed by 16-byte shared loads (q by broadcast);
//   * softmax: row max and row sum by warp shuffles, float32 throughout,
//     expf (no fast math), in the Pallas body's order of updates;
//   * P . V: P goes through the warp's slice of shared memory; lane j
//     accumulates columns j, j + 32, ... of its 8 rows, so hd is split
//     across the lanes and no lane holds a whole row (hd 256 would spill);
//   * key tiles wholly masked by causality or by the window are skipped:
//     a row that has a valid key cannot be changed by them.  A row with no
//     valid key at all (only when S > T + window) gives 0;
//   * 64-bit offsets for the (b, h) bases: prefill_32k has 4.3e9 elements.
//
// Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/flash_attention/kernel.py.  The kernel allocates
// nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// 16 bytes of bfloat16: 8 values.
struct Bf16IO {
  using T = __nv_bfloat16;
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void load(const T* src, float* dst) {
    uint4 u = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    float2 a = __bfloat1622float2(h[0]);
    float2 b = __bfloat1622float2(h[1]);
    float2 c = __bfloat1622float2(h[2]);
    float2 d = __bfloat1622float2(h[3]);
    reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
    reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
  }
  __device__ __forceinline__ static void zero(float* dst) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(dst)[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ static T from_float(float x) {
    return __float2bfloat16(x);
  }
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
                     typename IO::T* __restrict__ o, int S, int T, int Hq,
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
  }
}

template <int HD, class IO>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int T, int Hq, int Hkv, int causal,
                   int window, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<HD, IO>;
  const int bytes = static_cast<int>(Smem<HD>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  using T_ = typename IO::T;
  dim3 grid((S + kQTile - 1) / kQTile, B * Hq);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T_*>(q), static_cast<const T_*>(k),
      static_cast<const T_*>(v), static_cast<T_*>(o), S, T, Hq, Hkv, causal,
      window, scale);
  return cudaGetLastError();
}

template <class IO>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* o, int B, int S, int T, int Hq, int Hkv,
                     int causal, int window, float scale,
                     cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<32, IO>(q, k, v, o, B, S, T, Hq, Hkv, causal, window,
                            scale, stream);
    case 64:
      return launch<64, IO>(q, k, v, o, B, S, T, Hq, Hkv, causal, window,
                            scale, stream);
    case 80:
      return launch<80, IO>(q, k, v, o, B, S, T, Hq, Hkv, causal, window,
                            scale, stream);
    case 128:
      return launch<128, IO>(q, k, v, o, B, S, T, Hq, Hkv, causal, window,
                             scale, stream);
    case 256:
      return launch<256, IO>(q, k, v, o, B, S, T, Hq, Hkv, causal, window,
                             scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch K2 on `stream`.  q, o: (B, S, Hq, hd); k, v: (B, T, Hkv, hd);
// contiguous, 16-byte aligned, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); hd in {64, 80, 128, 256}; Hq % Hkv == 0; window <= 0
// means none.  Returns the cudaError_t of the launch (0 = success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int is_bf16, int head_dim, int batch,
                        int s_len, int t_len, int n_q_heads, int n_kv_heads,
                        int causal, int window, float scale, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    err = dispatch<Bf16IO>(head_dim, q, k, v, o, batch, s_len, t_len,
                           n_q_heads, n_kv_heads, causal, window, scale, s);
  else
    err = dispatch<F32IO>(head_dim, q, k, v, o, batch, s_len, t_len,
                          n_q_heads, n_kv_heads, causal, window, scale, s);
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
