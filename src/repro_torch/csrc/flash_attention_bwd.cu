// K2-bwd: the backward of flash attention (causal, optional sliding
// window, grouped KV heads) for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference trains through its blockwise
// jnp scan (src/repro/models/layers.py::flash_attention) and lets JAX
// differentiate it, so this is the port's own kernel for that
// differentiation, beside K2 (csrc/flash_attention.cu, which replaces
// src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd).
// Its plain version is kernels/flash_attention/ref.py::attention_bwd_plain.
//
// It computes, from q, k, v, the forward's output o, its gradient do and
// the forward's row log-sum-exp lse (natural log of the scaled scores,
// (B, Hq, S) float32), the FA2 backward:
//   P  = exp(q . k^T * scale - lse)          (0 where the mask forbids)
//   dV = P^T . do             dP = do . v^T
//   D  = rowsum(do * o)       dS = P * (dP - D)
//   dQ = dS . k * scale       dK = dS^T . q * scale
// with the forward's mask (key < T, q >= k when causal, q - k < window
// when a window is given).  Layout (B, S, Hq, hd) for q, o, do and dq,
// (B, T, Hkv, hd) for k, v, dk and dv, contiguous; query head h reads KV
// head h / (Hq / Hkv), so dk and dv sum over the query heads of a group.
//
// Bound: operations.  10 * hd flops per unmasked (q, k) pair and query
// head (S and dP recomputed, dV, dQ, dK); at danube's train layer (q 2 x
// 4096 x 32 x 80, k/v 8 heads, causal, window 4096) 4.30e11 flops, 0.434
// ms at the H100's 989 TFLOP/s bf16 dense peak, against ~0.06 ms for the
// bytes.  This design recomputes S and dP in both of its main kernels
// (14 * hd flops a pair), and runs on mma.sync, not wgmma: a first,
// simple kernel.
//
// Three kernels a call, deterministic (no atomics; every output element
// is written once by one thread):
// * bwd_delta_kernel: D = rowsum(do * o) in float32, a warp a row.
// * dK/dV: one block per (batch row, KV head, 64-key tile, column chunk).
//   It walks the group's query heads and, for each, the query tiles that
//   can see its keys (causality and the window skip the rest), and keeps
//   dK and dV of its keys in float32 registers until it writes them once.
// * dQ: one block per (batch row, query head, 64-query tile, column
//   chunk), walking the key tiles its rows can see; dQ stays in float32
//   registers and is written once.
// Column chunks: the accumulators of hd 256 do not fit a thread's
// registers, so hd 256 runs as two blocks of 128 columns each, both
// recomputing S and dP over the whole head dim.
//
// Which dtype takes which kernels:
// * bfloat16: the tensor cores, mma.sync.m16n8k16 (bf16 in, float32
//   accumulators), four warps a block, a warp owning 16 rows (keys in
//   dK/dV, queries in dQ).  Tiles are bf16 in shared memory in rows
//   padded by 16 bytes (so the 8 rows that one ldmatrix reads fall in 32
//   distinct banks), filled by cp.async 16-byte copies, two stages of the
//   walked operand (the next tile loads while this one is computed).  S^T
//   and dP^T (dK/dV) or S and dP (dQ) come out in accumulator fragments,
//   which are exactly the A fragments of the next product once rounded to
//   bf16: P and dS are rounded to bf16 for their products, as FA2 does;
//   everything else is float32.  Only tiles crossing the diagonal, the
//   window's edge or the key length are masked.
// * float32: the CUDA cores, no TF32 (the CPU-parity checks need float32
//   arithmetic): blocks of 8 warps over 32-key (dK/dV) or 32-query (dQ)
//   tiles; a thread computes 4 (query, key) pairs' scores and dP as
//   hd-long dot products from shared memory (k and v rows padded by one
//   float, so the 32 lanes' rows fall in distinct banks), P and dS go
//   through shared memory, and a thread then accumulates hd / 8 columns
//   of its row's gradients.
//
// Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/flash_attention/kernel.py.  The kernels allocate
// nothing (D's scratch is the caller's) and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// D = rowsum(do * o): one warp a (b, s, h) row, float32, into (B, Hq, S).

template <class T>
__global__ void __launch_bounds__(256)
    bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ delta, int64_t rows, int S, int Hq,
                     int hd) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + row * hd;
  const T* drow = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(to_f(drow[d]), to_f(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t bs = row / Hq;  // b * S + s
    const int h = static_cast<int>(row % Hq);
    const int64_t b = bs / S;
    const int s = static_cast<int>(bs % S);
    delta[(b * Hq + h) * S + s] = acc;
  }
}

// The tile ranges the mask leaves.  Queries [q_lo, q_hi) may see some key
// of [k0, k1); keys [k_lo, k_hi) may be seen by some query of [q0, q1).
struct Mask {
  int S, T, causal, window;
  __device__ __forceinline__ bool ok(int qp, int kp) const {
    bool v = kp < T;
    if (causal) v = v && qp >= kp;
    if (window > 0) v = v && qp - kp < window;
    return v;
  }
  __device__ __forceinline__ int q_lo(int k0) const { return causal ? k0 : 0; }
  __device__ __forceinline__ int q_hi(int k1) const {
    return window > 0 ? min(S, k1 - 1 + window) : S;
  }
  __device__ __forceinline__ int k_lo(int q0) const {
    return window > 0 ? max(0, q0 - window + 1) : 0;
  }
  __device__ __forceinline__ int k_hi(int q1) const {
    return causal ? min(T, q1) : T;
  }
  // whether every pair of the tile [q0, q0 + nq) x [k0, k0 + nk) is valid
  __device__ __forceinline__ bool full(int q0, int nq, int k0, int nk) const {
    if (k0 + nk > T) return false;
    if (causal && q0 < k0 + nk - 1) return false;
    if (window > 0 && q0 + nq - 1 - k0 >= window) return false;
    return true;
  }
};

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernels.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// Four 8 x 8 bf16 matrices; lanes 8 i .. 8 i + 7 give the row addresses of
// matrix i, and register i of lane l holds (row l / 4, columns 2 (l % 4),
// 2 (l % 4) + 1) of matrix i (.trans: of its transpose).
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D(16 x 8) += A(16 x 16) . B(16 x 8), bf16 in, float32 accumulators.
// Lane l, g = l / 4, t = l % 4: A regs (row g, cols 2t..), (g + 8, 2t..),
// (g, 8 + 2t..), (g + 8, 8 + 2t..); B regs (rows 2t.., col g), (rows 8 +
// 2t.., col g); D (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A bf16 tile of rows of `kStride` elements in shared memory.  Addresses
// of lane l for ldmatrix:
// * a_addr: the A fragment (x4) of rows [r0, r0 + 16) x cols [c0, c0 + 16)
//   of a row-major [m][k] tile; with ldsm_x4_t the same addresses give the
//   B fragments of two 8-column tiles of a [k][n] tile (rows k, cols n).
// * bn_addr: the B fragments of two 8-wide n tiles at n0 (rows n) over
//   k [k0, k0 + 16) of an [n][k] tile: regs (b0, b1) of tile n0, then of
//   tile n0 + 8.
template <int kStride>
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int r0, int c0,
                                           int lane) {
  const int r = r0 + (lane % 8) + ((lane / 8) % 2) * 8;
  const int c = c0 + (lane / 16) * 8;
  return base + 2 * (r * kStride + c);
}

template <int kStride>
__device__ __forceinline__ uint32_t bn_addr(uint32_t base, int n0, int k0,
                                            int lane) {
  const int n = n0 + (lane / 16) * 8 + (lane % 8);
  const int k = k0 + ((lane / 8) % 2) * 8;
  return base + 2 * (n * kStride + k);
}

// Rows [0, n) of a (rows, HD) bf16 tile (row r at src + r * row_stride)
// into shared rows of kStride elements; rows [n, rows) are zero-filled by
// the copy.
template <int HD, int kStride, int THREADS>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src,
                                          int64_t row_stride, int rows,
                                          int n) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = r < n;
    cp_async_16(dst + 2 * (r * kStride + c),
                ok ? src + r * row_stride + c : src, ok ? 16 : 0);
  }
}

// [0, n) of `rows` floats; the rest zero-filled.
template <int THREADS>
__device__ __forceinline__ void load_floats(uint32_t dst, const float* src,
                                            int rows, int n) {
  for (int i = threadIdx.x; i < rows; i += THREADS) {
    const bool ok = i < n;
    cp_async_4(dst + 4 * i, ok ? src + i : src, ok ? 4 : 0);
  }
}

// S(16 x N) = A(16 x HD rows of a at r0) . B^T, B the [n][k] tile of N
// rows from n0: HD / 16 k-steps.
template <int HD, int kStride, int N>
__device__ __forceinline__ void mma_abt(float (*d)[4], uint32_t a, int r0,
                                        uint32_t b, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(a_addr<kStride>(a, r0, 16 * kk, lane), af);
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      uint32_t bf[4];
      ldsm_x4(bn_addr<kStride>(b, n0 + 16 * j, 16 * kk, lane), bf);
      mma16816(d[2 * j], af, bf[0], bf[1]);
      mma16816(d[2 * j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc(16 x HC) += P(16 x K, bf16 A fragments) . B, B the [k][n] tile of K
// rows, columns [c0, c0 + HC).
template <int kStride, int K, int HC>
__device__ __forceinline__ void mma_pb(float (*acc)[4], const uint32_t (*p)[4],
                                       uint32_t b, int c0, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < HC / 16; ++j) {
      uint32_t bf[4];
      ldsm_x4_t(a_addr<kStride>(b, 16 * kk, c0 + 16 * j, lane), bf);
      mma16816(acc[2 * j], p[kk], bf[0], bf[1]);
      mma16816(acc[2 * j + 1], p[kk], bf[2], bf[3]);
    }
  }
}

template <int HD>
struct BwdCfg {
  static constexpr int kHC = HD > 128 ? 128 : HD;     // columns a block
  static constexpr int kChunks = HD / kHC;
  static constexpr int kStride = HD + 8;              // bf16 a smem row
  static constexpr int kRowBytes = 2 * kStride;
  static constexpr int kThreads = 128;                // 4 warps
  // dK/dV: 64 keys a block, query tiles of kBr
  static constexpr int kKeys = 64;
  static constexpr int kBr = kHC > 80 ? 32 : 64;
  // dQ: 64 queries a block, key tiles of kBc
  static constexpr int kQueries = 64;
  static constexpr int kBc = HD > 128 ? 32 : 64;
  // dK/dV: K, V; two stages of {Q, dO, lse, D}
  static constexpr int kKVStage = kBr * kRowBytes * 2 + kBr * 8;
  static constexpr int kKVBytes = 2 * kKeys * kRowBytes + 2 * kKVStage;
  // dQ: Q, dO; two stages of {K, V}
  static constexpr int kQStage = 2 * kBc * kRowBytes;
  static constexpr int kQBytes = 2 * kQueries * kRowBytes + 2 * kQStage;
};

// dK, dV of one (b, hk, 64-key tile, column chunk).
template <int HD>
__global__ void __launch_bounds__(128)
    flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int S, int T, int Hq, int Hkv, int causal,
                             int window, float scale, int n_ktiles) {
  using C = BwdCfg<HD>;
  constexpr int kBr = C::kBr, kHC = C::kHC, kStride = C::kStride;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ks = smem_u32(smem);
  const uint32_t vs = ks + C::kKeys * C::kRowBytes;
  const uint32_t st0 = vs + C::kKeys * C::kRowBytes;

  const int BH = gridDim.x / (n_ktiles * C::kChunks);  // B * Hkv
  const int bh = blockIdx.x % BH;
  const int rest = blockIdx.x / BH;
  const int c0 = (rest % C::kChunks) * kHC;
  const int k0 = (rest / C::kChunks) * C::kKeys;
  const int b = bh / Hkv, hk = bh % Hkv, G = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const Mask mask{S, T, causal, window};

  const int64_t q_row = static_cast<int64_t>(Hq) * HD;
  const int64_t kv_row = static_cast<int64_t>(Hkv) * HD;
  const int64_t kv_base = (static_cast<int64_t>(b) * T + k0) * kv_row +
                          static_cast<int64_t>(hk) * HD;
  load_rows<HD, kStride, 128>(ks, k + kv_base, kv_row, C::kKeys, T - k0);
  load_rows<HD, kStride, 128>(vs, v + kv_base, kv_row, C::kKeys, T - k0);

  const int k1 = min(k0 + C::kKeys, T);
  const int qt_lo = mask.q_lo(k0) / kBr;
  const int qt_hi = (mask.q_hi(k1) + kBr - 1) / kBr;
  const int n_qt = max(0, qt_hi - qt_lo);
  const int n_it = G * n_qt;

  auto load_it = [&](int it, int stage) {
    const int h = hk * G + it / n_qt;
    const int q0 = (qt_lo + it % n_qt) * kBr;
    const uint32_t base = st0 + stage * C::kKVStage;
    const int64_t off = (static_cast<int64_t>(b) * S + q0) * q_row +
                        static_cast<int64_t>(h) * HD;
    load_rows<HD, kStride, 128>(base, q + off, q_row, kBr, S - q0);
    load_rows<HD, kStride, 128>(base + kBr * C::kRowBytes, dout + off, q_row,
                                kBr, S - q0);
    const int64_t r0 = (static_cast<int64_t>(b) * Hq + h) * S + q0;
    load_floats<128>(base + 2 * kBr * C::kRowBytes, lse + r0, kBr, S - q0);
    load_floats<128>(base + 2 * kBr * C::kRowBytes + 4 * kBr, delta + r0, kBr,
                     S - q0);
  };
  if (n_it > 0) load_it(0, 0);
  cp_async_commit();

  float dka[kHC / 8][4], dva[kHC / 8][4];
#pragma unroll
  for (int j = 0; j < kHC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const int r0 = 16 * warp;                 // this warp's keys in the tile
  const int key_a = k0 + r0 + g;            // rows key_a, key_a + 8

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_it(it + 1, (it + 1) % 2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int stage = it % 2;
    const uint32_t qs = st0 + stage * C::kKVStage;
    const uint32_t dos = qs + kBr * C::kRowBytes;
    const float* lse_s = reinterpret_cast<const float*>(
        smem + (st0 - ks) + stage * C::kKVStage + 2 * kBr * C::kRowBytes);
    const float* d_s = lse_s + kBr;
    const int q0 = (qt_lo + it % n_qt) * kBr;
    const bool full = mask.full(q0, kBr, k0, C::kKeys);

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x kBr queries a warp
    float sf[kBr / 8][4], pf[kBr / 8][4];
    mma_abt<HD, kStride, kBr>(sf, ks, r0, qs, 0, lane);
    mma_abt<HD, kStride, kBr>(pf, vs, r0, dos, 0, lane);

    // P^T and dS^T as bf16 A fragments (k = queries)
    uint32_t pa[kBr / 16][4], da[kBr / 16][4];
#pragma unroll
    for (int j = 0; j < kBr / 8; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t4 + (e % 2);
        const int key = key_a + 8 * (e / 2);
        const float l2 = lse_s[qi] * kLog2e;
        float pe = exp2f(fmaf(sf[j][e], scale_log2, -l2));
        if (!full && !mask.ok(q0 + qi, key)) pe = 0.f;
        p[e] = pe;
        ds[e] = pe * (pf[j][e] - d_s[qi]);
      }
      pa[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
      da[j / 2][2 * (j % 2)] = pack_bf16(ds[0], ds[1]);
      da[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dV += P^T dO, dK += dS^T Q over this chunk's columns
    mma_pb<kStride, kBr, kHC>(dva, pa, dos, c0, lane);
    mma_pb<kStride, kBr, kHC>(dka, da, qs, c0, lane);
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = key_a + 8 * hf;
    if (key >= T) continue;
    const int64_t off = (static_cast<int64_t>(b) * T + key) * kv_row +
                        static_cast<int64_t>(hk) * HD + c0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < kHC / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dka[j][2 * hf] * scale,
                                dka[j][2 * hf + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dva[j][2 * hf], dva[j][2 * hf + 1]);
    }
  }
}

// dQ of one (b, h, 64-query tile, column chunk).
template <int HD>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_tc_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dq, int S, int T, int Hq,
                           int Hkv, int causal, int window, float scale,
                           int n_qtiles) {
  using C = BwdCfg<HD>;
  constexpr int kBc = C::kBc, kHC = C::kHC, kStride = C::kStride;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_u32(smem);
  const uint32_t dos = qs + C::kQueries * C::kRowBytes;
  const uint32_t st0 = dos + C::kQueries * C::kRowBytes;

  const int BH = gridDim.x / (n_qtiles * C::kChunks);  // B * Hq
  const int bh = blockIdx.x % BH;
  const int rest = blockIdx.x / BH;
  const int c0 = (rest % C::kChunks) * kHC;
  // the heaviest query tiles (the causal triangle's last) first
  const int q0 = (n_qtiles - 1 - rest / C::kChunks) * C::kQueries;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const Mask mask{S, T, causal, window};

  const int64_t q_row = static_cast<int64_t>(Hq) * HD;
  const int64_t kv_row = static_cast<int64_t>(Hkv) * HD;
  const int64_t q_off = (static_cast<int64_t>(b) * S + q0) * q_row +
                        static_cast<int64_t>(h) * HD;
  load_rows<HD, kStride, 128>(qs, q + q_off, q_row, C::kQueries, S - q0);
  load_rows<HD, kStride, 128>(dos, dout + q_off, q_row, C::kQueries, S - q0);

  const int q_last = min(q0 + C::kQueries, S) - 1;
  const int kt_lo = mask.k_lo(q0) / kBc;
  const int kt_hi = (mask.k_hi(q_last + 1) + kBc - 1) / kBc;
  const int64_t kv_base = static_cast<int64_t>(b) * T * kv_row +
                          static_cast<int64_t>(hk) * HD;
  auto load_kt = [&](int t, int stage) {
    const int kt = t * kBc;
    const uint32_t base = st0 + stage * C::kQStage;
    load_rows<HD, kStride, 128>(base, k + kv_base + kt * kv_row, kv_row, kBc,
                                T - kt);
    load_rows<HD, kStride, 128>(base + kBc * C::kRowBytes,
                                v + kv_base + kt * kv_row, kv_row, kBc,
                                T - kt);
  };
  if (kt_lo < kt_hi) load_kt(kt_lo, 0);
  cp_async_commit();

  const int r0 = 16 * warp;
  const int row_a = q0 + r0 + g;  // rows row_a, row_a + 8
  float l2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row_a + 8 * hf;
    const int64_t r = (static_cast<int64_t>(b) * Hq + h) * S + row;
    l2[hf] = row < S ? lse[r] * kLog2e : 0.f;
    dl[hf] = row < S ? delta[r] : 0.f;
  }
  float dqa[kHC / 8][4];
#pragma unroll
  for (int j = 0; j < kHC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int t = kt_lo; t < kt_hi; ++t) {
    if (t + 1 < kt_hi) load_kt(t + 1, (t + 1 - kt_lo) % 2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t kst = st0 + ((t - kt_lo) % 2) * C::kQStage;
    const uint32_t vst = kst + kBc * C::kRowBytes;
    const int kt = t * kBc;
    const bool full = mask.full(q0, C::kQueries, kt, kBc);

    float sf[kBc / 8][4], pf[kBc / 8][4];
    mma_abt<HD, kStride, kBc>(sf, qs, r0, kst, 0, lane);
    mma_abt<HD, kStride, kBc>(pf, dos, r0, vst, 0, lane);

    uint32_t da[kBc / 16][4];
#pragma unroll
    for (int j = 0; j < kBc / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e / 2;
        const int key = kt + 8 * j + 2 * t4 + (e % 2);
        float pe = exp2f(fmaf(sf[j][e], scale_log2, -l2[hf]));
        if (!full && !mask.ok(row_a + 8 * hf, key)) pe = 0.f;
        ds[e] = pe * (pf[j][e] - dl[hf]);
      }
      da[j / 2][2 * (j % 2)] = pack_bf16(ds[0], ds[1]);
      da[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dQ += dS K over this chunk's columns
    mma_pb<kStride, kBc, kHC>(dqa, da, kst, c0, lane);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row_a + 8 * hf;
    if (row >= S) continue;
    bf16* out = dq + (static_cast<int64_t>(b) * S + row) * q_row +
                static_cast<int64_t>(h) * HD + c0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < kHC / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          dqa[j][2 * hf] * scale, dqa[j][2 * hf + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernels.

constexpr int kF32Tile = 32;     // keys (dK/dV) or queries (dQ) a block
constexpr int kF32Threads = 256;  // 8 warps

// rows [0, n) of a (kF32Tile, HD) float32 tile into shared rows of
// `stride` floats; rows [n, kF32Tile) are zero
template <int HD>
__device__ __forceinline__ void f32_rows(float* dst, int stride,
                                         const float* src, int64_t row_stride,
                                         int n) {
  for (int i = threadIdx.x; i < kF32Tile * HD; i += kF32Threads) {
    const int r = i / HD, c = i % HD;
    dst[r * stride + c] = r < n ? src[r * row_stride + c] : 0.f;
  }
}

// dK, dV of one (b, hk, 32-key tile).  Per query tile: thread (warp w,
// lane) computes the pairs (query w + 8 i, key lane), i < 4, into P and dS
// in shared memory; then accumulates columns w + 8 j of key lane's dK, dV.
template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int S, int T, int Hq, int Hkv, int causal,
                              int window, float scale) {
  constexpr int kTile = kF32Tile, kPad = HD + 1;
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;                     // [key][kPad]
  float* vs = ks + kTile * kPad;
  float* qs = vs + kTile * kPad;       // [query][HD]
  float* dos = qs + kTile * HD;
  float* ps = dos + kTile * HD;        // [query][key]
  float* dss = ps + kTile * kTile;
  float* lse_s = dss + kTile * kTile;
  float* d_s = lse_s + kTile;

  const int bh = blockIdx.y, b = bh / Hkv, hk = bh % Hkv, G = Hq / Hkv;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Mask mask{S, T, causal, window};
  const int64_t q_row = static_cast<int64_t>(Hq) * HD;
  const int64_t kv_row = static_cast<int64_t>(Hkv) * HD;
  const int64_t kv_base = (static_cast<int64_t>(b) * T + k0) * kv_row +
                          static_cast<int64_t>(hk) * HD;
  f32_rows<HD>(ks, kPad, k + kv_base, kv_row, T - k0);
  f32_rows<HD>(vs, kPad, v + kv_base, kv_row, T - k0);

  const int k1 = min(k0 + kTile, T);
  const int qt_lo = mask.q_lo(k0) / kTile;
  const int qt_hi = (mask.q_hi(k1) + kTile - 1) / kTile;
  constexpr int kCols = HD / 8;
  float dka[kCols], dva[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) dka[j] = dva[j] = 0.f;

  for (int h = hk * G; h < hk * G + G; ++h) {
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's readers are done
      const int64_t off = (static_cast<int64_t>(b) * S + q0) * q_row +
                          static_cast<int64_t>(h) * HD;
      f32_rows<HD>(qs, HD, q + off, q_row, S - q0);
      f32_rows<HD>(dos, HD, dout + off, q_row, S - q0);
      if (threadIdx.x < kTile) {
        const int r = threadIdx.x;
        const int64_t ri = (static_cast<int64_t>(b) * Hq + h) * S + q0 + r;
        lse_s[r] = q0 + r < S ? lse[ri] : 0.f;
        d_s[r] = q0 + r < S ? delta[ri] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i) {
        const int qi = warp + 8 * i;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          s = fmaf(qs[qi * HD + d], ks[lane * kPad + d], s);
          dp = fmaf(dos[qi * HD + d], vs[lane * kPad + d], dp);
        }
        const float p = mask.ok(q0 + qi, k0 + lane)
                            ? expf(s * scale - lse_s[qi]) : 0.f;
        ps[qi * kTile + lane] = p;
        dss[qi * kTile + lane] = p * (dp - d_s[qi]);
      }
      __syncthreads();
      for (int qi = 0; qi < kTile; ++qi) {
        const float p = ps[qi * kTile + lane];
        const float ds = dss[qi * kTile + lane];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int d = warp + 8 * j;
          dva[j] = fmaf(p, dos[qi * HD + d], dva[j]);
          dka[j] = fmaf(ds, qs[qi * HD + d], dka[j]);
        }
      }
    }
  }
  const int key = k0 + lane;
  if (key < T) {
    const int64_t off = (static_cast<int64_t>(b) * T + key) * kv_row +
                        static_cast<int64_t>(hk) * HD;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dk[off + warp + 8 * j] = dka[j] * scale;
      dv[off + warp + 8 * j] = dva[j];
    }
  }
}

// dQ of one (b, h, 32-query tile).  Per key tile: thread (warp w, lane)
// computes the pairs (query w + 8 i, key lane) into dS in shared memory;
// then accumulates columns w + 8 j of query lane's dQ.
template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int S, int T, int Hq,
                            int Hkv, int causal, int window, float scale) {
  constexpr int kTile = kF32Tile, kPad = HD + 1;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                     // [query][HD]
  float* dos = qs + kTile * HD;
  float* ks = dos + kTile * HD;        // [key][kPad]
  float* vs = ks + kTile * kPad;
  float* dss = vs + kTile * kPad;      // [query][kTile + 1]
  float* lse_s = dss + kTile * (kTile + 1);
  float* d_s = lse_s + kTile;

  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Mask mask{S, T, causal, window};
  const int64_t q_row = static_cast<int64_t>(Hq) * HD;
  const int64_t kv_row = static_cast<int64_t>(Hkv) * HD;
  const int64_t off = (static_cast<int64_t>(b) * S + q0) * q_row +
                      static_cast<int64_t>(h) * HD;
  f32_rows<HD>(qs, HD, q + off, q_row, S - q0);
  f32_rows<HD>(dos, HD, dout + off, q_row, S - q0);
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    const int64_t ri = (static_cast<int64_t>(b) * Hq + h) * S + q0 + r;
    lse_s[r] = q0 + r < S ? lse[ri] : 0.f;
    d_s[r] = q0 + r < S ? delta[ri] : 0.f;
  }
  const int q_last = min(q0 + kTile, S) - 1;
  const int kt_lo = mask.k_lo(q0) / kTile;
  const int kt_hi = (mask.k_hi(q_last + 1) + kTile - 1) / kTile;
  const int64_t kv_base = static_cast<int64_t>(b) * T * kv_row +
                          static_cast<int64_t>(hk) * HD;
  constexpr int kCols = HD / 8;
  float dqa[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) dqa[j] = 0.f;

  for (int t = kt_lo; t < kt_hi; ++t) {
    const int kt = t * kTile;
    __syncthreads();
    f32_rows<HD>(ks, kPad, k + kv_base + kt * kv_row, kv_row, T - kt);
    f32_rows<HD>(vs, kPad, v + kv_base + kt * kv_row, kv_row, T - kt);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const int qi = warp + 8 * i;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        s = fmaf(qs[qi * HD + d], ks[lane * kPad + d], s);
        dp = fmaf(dos[qi * HD + d], vs[lane * kPad + d], dp);
      }
      const float p = mask.ok(q0 + qi, kt + lane)
                          ? expf(s * scale - lse_s[qi]) : 0.f;
      dss[qi * (kTile + 1) + lane] = p * (dp - d_s[qi]);
    }
    __syncthreads();
    for (int kj = 0; kj < kTile; ++kj) {
      const float ds = dss[lane * (kTile + 1) + kj];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        dqa[j] = fmaf(ds, ks[kj * kPad + warp + 8 * j], dqa[j]);
    }
  }
  const int row = q0 + lane;
  if (row < S) {
    float* out = dq + (static_cast<int64_t>(b) * S + row) * q_row +
                 static_cast<int64_t>(h) * HD;
#pragma unroll
    for (int j = 0; j < kCols; ++j) out[warp + 8 * j] = dqa[j] * scale;
  }
}

// ---------------------------------------------------------------------------
// Launches.

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, S, T, Hq, Hkv, causal, window;
  float scale;
  cudaStream_t stream;
};

template <class T_>
cudaError_t launch_delta(const Args& a, int hd) {
  const int64_t rows = static_cast<int64_t>(a.B) * a.S * a.Hq;
  const int64_t blocks = (rows + 7) / 8;
  if (blocks >= (int64_t{1} << 31)) return cudaErrorInvalidConfiguration;
  bwd_delta_kernel<T_><<<static_cast<unsigned>(blocks), 256, 0, a.stream>>>(
      static_cast<const T_*>(a.o), static_cast<const T_*>(a.dout), a.delta,
      rows, a.S, a.Hq, hd);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_tc(const Args& a) {
  using C = BwdCfg<HD>;
  cudaError_t err = launch_delta<bf16>(a, HD);
  if (err != cudaSuccess) return err;
  const bf16 *q = static_cast<const bf16*>(a.q),
             *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v),
             *dout = static_cast<const bf16*>(a.dout);

  auto dkdv = flash_bwd_dkdv_tc_kernel<HD>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kKVBytes);
  if (err != cudaSuccess) return err;
  const int n_ktiles = (a.T + C::kKeys - 1) / C::kKeys;
  const int64_t kv_blocks =
      static_cast<int64_t>(n_ktiles) * a.B * a.Hkv * C::kChunks;
  if (kv_blocks >= (int64_t{1} << 31)) return cudaErrorInvalidConfiguration;
  dkdv<<<static_cast<unsigned>(kv_blocks), C::kThreads, C::kKVBytes,
         a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dk),
                     static_cast<bf16*>(a.dv), a.S, a.T, a.Hq, a.Hkv,
                     a.causal, a.window, a.scale, n_ktiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_tc_kernel<HD>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kQBytes);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (a.S + C::kQueries - 1) / C::kQueries;
  const int64_t q_blocks =
      static_cast<int64_t>(n_qtiles) * a.B * a.Hq * C::kChunks;
  if (q_blocks >= (int64_t{1} << 31)) return cudaErrorInvalidConfiguration;
  dqk<<<static_cast<unsigned>(q_blocks), C::kThreads, C::kQBytes,
        a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dq),
                    a.S, a.T, a.Hq, a.Hkv, a.causal, a.window, a.scale,
                    n_qtiles);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Args& a) {
  constexpr int kTile = kF32Tile, kPad = HD + 1;
  cudaError_t err = launch_delta<float>(a, HD);
  if (err != cudaSuccess) return err;
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v),
              *dout = static_cast<const float*>(a.dout);
  if (static_cast<int64_t>(a.B) * a.Hq > 65535)
    return cudaErrorInvalidConfiguration;

  auto dkdv = flash_bwd_dkdv_f32_kernel<HD>;
  const int kv_bytes = static_cast<int>(
      sizeof(float) * (2 * kTile * kPad + 2 * kTile * HD + 2 * kTile * kTile +
                       2 * kTile));
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((a.T + kTile - 1) / kTile, a.B * a.Hkv), kF32Threads, kv_bytes,
         a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk),
                     static_cast<float*>(a.dv), a.S, a.T, a.Hq, a.Hkv,
                     a.causal, a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_f32_kernel<HD>;
  const int q_bytes = static_cast<int>(
      sizeof(float) * (2 * kTile * HD + 2 * kTile * kPad +
                       kTile * (kTile + 1) + 2 * kTile));
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((a.S + kTile - 1) / kTile, a.B * a.Hq), kF32Threads, q_bytes,
        a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq),
                    a.S, a.T, a.Hq, a.Hkv, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const Args& a, int is_bf16) {
  return is_bf16 ? launch_tc<HD>(a) : launch_f32<HD>(a);
}

}  // namespace

extern "C" {

// Launch K2-bwd (three kernels) on `stream`.  q, o, do, dq: (B, S, Hq,
// hd); k, v, dk, dv: (B, T, Hkv, hd); lse and delta (scratch for D):
// (B, Hq, S) float32; contiguous, 16-byte aligned, all float32 (is_bf16 =
// 0: the CUDA-core kernels) or bfloat16 apart from lse and delta (is_bf16
// = 1: the tensor-core kernels); hd in {32, 64, 80, 128, 256}; Hq % Hkv ==
// 0; window <= 0 means none.  Returns the cudaError_t of the launches (0 =
// success).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv,
                        int is_bf16, int head_dim, int batch, int s_len,
                        int t_len, int n_q_heads, int n_kv_heads, int causal,
                        int window, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, batch, s_len, t_len,
               n_q_heads, n_kv_heads, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 32: err = launch<32>(a, is_bf16); break;
    case 64: err = launch<64>(a, is_bf16); break;
    case 80: err = launch<80>(a, is_bf16); break;
    case 128: err = launch<128>(a, is_bf16); break;
    case 256: err = launch<256>(a, is_bf16); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
