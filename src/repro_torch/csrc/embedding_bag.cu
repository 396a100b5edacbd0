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
// The kernels plan it on the card, on the caller's stream, with no count
// coming back to the host: every launch is sized from N, P, R and D, and
// reads the live counts (slots, runs, chunks, partials) from device memory.
//   1. compact: one read of idx keeps the slots that are not row 0, in slot
//      order, as (row << 32 | bag) pairs: each tile of 16384 slots writes
//      its own in place, and a scan of the tiles' counts gives their
//      offsets and the count of all (the first radix pass reads the pairs
//      where the tiles left them);
//   2. sort: a stable LSD radix sort of the pairs by row, 8 bits a pass
//      (3 passes below 2^24 rows); a pass is a per-block digit histogram,
//      a scan over (digit, block) and a stable scatter with block-local
//      ranks, so the bags of a row stay in slot order;
//   3. runs and chunks: look-back scans number the runs of equal rows, then
//      cut each run of L slots into chunks of max(64, ceil(sqrt(L))) slots
//      and number the chunks and the partials;
//   4. pass 1 sums each chunk's grad_out rows: a run of one chunk straight
//      into its row of g, the chunks of longer runs into partials;
//   5. the write pass stores zeros in every row of g that no run lands on
//      (row 0 always), then writes the row of each longer run as the
//      in-order sum of its partials.
// Every row of g is written once; g is never zeroed first.  The plan's
// arrays are kernel.py::backward_plan's and the sums are added in its
// order, so ref.py::embedding_bag_grad_replay repeats the kernels bit for
// bit.  No atomics on values (the only atomics count tiles and digits):
// two launches give the same bits.
// Scratch, from N, P and D: the two pair buffers (16 N P bytes), at most
// 2 N P / 65 partials of 4 D bytes (a run of L > 64 slots has at most
// 2L / 65 chunks), and the plan's int64 arrays (kernel.py::scratch_bytes).
//
// Bound: memory.  Forward: every distinct row touched read once, the
// indices and the output, at 3.35 TB/s on an H100 SXM.  Backward: the
// dense gradient written once, the indices and grad_out read once.  The
// additions are far below the float32 rate in both.
//
// Design.  One warp per bag (forward), per chunk (pass 1) or per long run
// (the write pass); the lanes cover a row in 16-byte chunks (float4
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
constexpr int kLongBatch = 16;  // the same, summing a long run's partials

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

// ---- Backward ------------------------------------------------------------

constexpr int kRounds = 16;               // items a thread of a scan tile
constexpr int kWideBlock = 1024;          // threads of a scan over slots
constexpr int kSlotTile = kRounds * kWideBlock;  // slots a compaction tile
constexpr int kWarps = kBlock / kWarp;    // 8
constexpr int kRadixBits = 8;
constexpr int kDigits = 1 << kRadixBits;  // 256
constexpr int kRadixRounds = 8;           // a radix tile: 8 warps x 8 x 32
constexpr int kRadixTile = kWarps * kRadixRounds * kWarp;  // 2048
constexpr int kHistBatch = 4;             // pair loads in flight a thread
constexpr unsigned long long kAggregate = 1;   // look-back flags
constexpr unsigned long long kInclusive = 2;
constexpr long long kSpinLimit = 1ll << 24;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

template <int V>
__device__ __forceinline__ void warp_sum(long long* v) {
#pragma unroll
  for (int c = 0; c < V; ++c)
#pragma unroll
    for (int o = kWarp / 2; o > 0; o /= 2)
      v[c] += __shfl_xor_sync(kFull, v[c], o);
}

// The exclusive prefix over the warp of each of v's V values.
template <int V>
__device__ __forceinline__ void warp_exclusive(const long long* v,
                                               long long* out) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    long long inc = v[c];
#pragma unroll
    for (int o = 1; o < kWarp; o *= 2) {
      const long long up = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += up;
    }
    out[c] = inc - v[c];
  }
}

// A tile's look-back status in one 64-bit word, written and read whole: a
// flag in the top 2 bits (0: not yet, kAggregate: the tile's own sums,
// kInclusive: the sums of tiles 0..t) and its V sums below (V = 1: 62
// bits; V = 2: 31 bits each, so the plan takes fewer than 2^31 slots).
template <int V>
__device__ __forceinline__ unsigned long long pack_status(
    unsigned long long flag, const long long* v) {
  static_assert(V == 1 || V == 2, "one or two sums a status word");
  const unsigned long long x =
      V == 1 ? static_cast<unsigned long long>(v[0])
             : static_cast<unsigned long long>(v[0]) |
                   (static_cast<unsigned long long>(v[V - 1]) << 31);
  return (flag << 62) | x;
}

template <int V>
__device__ __forceinline__ void unpack_status(unsigned long long word,
                                              long long* v) {
  if (V == 1) {
    v[0] = static_cast<long long>(word & ((1ull << 62) - 1));
  } else {
    v[0] = static_cast<long long>(word & ((1ull << 31) - 1));
    v[V - 1] = static_cast<long long>((word >> 31) & ((1ull << 31) - 1));
  }
}

// Decoupled look-back (a single-pass scan across tiles): tile t's status
// word is st[t].  Called by the whole block, whose thread 0 holds the
// tile's sums in agg; thread 0 gets the sums of tiles 0..t-1 in excl and
// publishes tile t's.  Each step reads the status of kThreads tiles, one
// a thread, nearest first, and stops at the nearest inclusive one.  A
// block takes its tile from an atomic counter, in the order blocks start,
// so every tile looked at belongs to a block that is running: the wait
// ends.  A wait that does not end traps instead of hanging the card.
template <int V, int kThreads>
__device__ void look_back(unsigned long long* st, long long t,
                          const long long* agg, long long* excl) {
  constexpr int kW = kThreads / kWarp;
  static_assert(kW <= kWarp, "warp 0 combines the warps");
  __shared__ long long warp_sums[kW][V];
  __shared__ bool warp_found[kW];
  __shared__ bool found;
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  volatile unsigned long long* status = st;
  if (threadIdx.x == 0) {
    for (int c = 0; c < V; ++c) excl[c] = 0;
    found = t == 0;
    if (t > 0) status[t] = pack_status<V>(kAggregate, agg);
  }
  __syncthreads();
  for (long long top = t - 1; !found; top -= kThreads) {
    const long long pt = top - threadIdx.x;  // thread 0: the nearest tile
    unsigned long long flag = kInclusive;    // before tile 0: inclusive 0
    long long val[V];
#pragma unroll
    for (int c = 0; c < V; ++c) val[c] = 0;
    if (pt >= 0) {
      unsigned long long word;
      long long spins = 0;
      while ((word = status[pt]) == 0)
        if (++spins > kSpinLimit) __trap();
      flag = word >> 62;
      unpack_status<V>(word, val);
    }
    const unsigned inc = __ballot_sync(kFull, flag == kInclusive);
    const int stop = inc ? __ffs(inc) - 1 : kWarp - 1;
#pragma unroll
    for (int c = 0; c < V; ++c)
      if (lane > stop) val[c] = 0;
    warp_sum<V>(val);
    if (lane == 0) {
      for (int c = 0; c < V; ++c) warp_sums[w][c] = val[c];
      warp_found[w] = inc != 0;
    }
    __syncthreads();
    if (w == 0) {   // the warps up to the nearest that found an inclusive
      const bool f = lane < kW && warp_found[lane];
      const unsigned any = __ballot_sync(kFull, f);
      const int last = any ? __ffs(any) - 1 : kW - 1;
      long long sum[V];
#pragma unroll
      for (int c = 0; c < V; ++c)
        sum[c] = lane <= last && lane < kW ? warp_sums[lane][c] : 0;
      warp_sum<V>(sum);
      if (lane == 0) {
        for (int c = 0; c < V; ++c) excl[c] += sum[c];
        found = any != 0;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    long long inc[V];
    for (int c = 0; c < V; ++c) inc[c] = excl[c] + agg[c];
    status[t] = pack_status<V>(kInclusive, inc);
  }
}

// Warp 0 turns the per-(round, warp) sums cnt[kRounds * kThreads / 32][V]
// (in item order) into exclusive prefixes in place and returns the tile's
// total on every lane of warp 0.
template <int V, int kThreads>
__device__ __forceinline__ void scan_tile_counts(long long (*cnt)[V],
                                                 long long* total) {
  constexpr int kPer = kRounds * kThreads / kWarp / kWarp;  // entries a lane
  const int lane = threadIdx.x % kWarp;
  long long own[V], before[V];
#pragma unroll
  for (int c = 0; c < V; ++c) {
    own[c] = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) own[c] += cnt[lane * kPer + e][c];
  }
  warp_exclusive<V>(own, before);
#pragma unroll
  for (int c = 0; c < V; ++c) {
    total[c] = __shfl_sync(kFull, before[c] + own[c], kWarp - 1);
    long long run = before[c];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const long long x = cnt[lane * kPer + e][c];
      cnt[lane * kPer + e][c] = run;
      run += x;
    }
  }
}

// A look-back scan's tile of kRounds * kThreads items, kThreads threads
// a block: the block takes the next tile number from the counter (one
// tile a block; blocks past the last tile return).  Item k * kThreads + x
// of the tile is thread x's round k.  After phase A has filled cnt with
// the tile's per-(round, warp) sums, `scan` turns cnt into offsets and
// leaves the sums of the tiles before in prefix[] and those of tiles 0..t
// in total[].
template <int V, int kThreads>
struct ScanTile {
  static constexpr int kItems = kRounds * kThreads;
  static constexpr int kW = kThreads / kWarp;
  long long cnt[kRounds * kW][V];
  long long agg[V], prefix[V], total[V];
  long long t;

  __device__ __forceinline__ long long take(unsigned long long* counter) {
    if (threadIdx.x == 0) t = static_cast<long long>(atomicAdd(counter, 1ull));
    __syncthreads();
    return t;
  }
  __device__ __forceinline__ void scan(unsigned long long* status) {
    __syncthreads();
    if (threadIdx.x < kWarp) {
      long long a[V];
      scan_tile_counts<V, kThreads>(cnt, a);
      if (threadIdx.x == 0)
        for (int c = 0; c < V; ++c) agg[c] = a[c];
    }
    look_back<V, kThreads>(status, t, agg, prefix);
    if (threadIdx.x == 0)
      for (int c = 0; c < V; ++c) total[c] = prefix[c] + agg[c];
    __syncthreads();
  }
};

// Stage 1, compact: the slots whose index is not row 0, as (row << 32 |
// bag), tile by tile: tile t of kSlotTile slots writes its live ones, in
// slot order, to pairs[t * kSlotTile ...] and their count to
// tile_off[t] (a scan then turns the counts into offsets).  One read of
// idx, and no tile waits for another.
__global__ void __launch_bounds__(kWideBlock, 2048 / kWideBlock)
    compact_kernel(const int32_t* __restrict__ idx, long long n_slots,
                   int pool, long long n_rows,
                   unsigned long long* __restrict__ pairs,
                   long long* __restrict__ tile_off) {
  constexpr int kW = kWideBlock / kWarp;
  __shared__ long long cnt[kRounds * kW][1];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const long long t = blockIdx.x;
  const long long base = t * kSlotTile + threadIdx.x;
  int32_t r[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const long long i = base + k * kWideBlock;
    r[k] = i < n_slots ? idx[i] : 0;
  }
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    if (r[k] < 0 || static_cast<long long>(r[k]) >= n_rows) __trap();
    const unsigned live = __ballot_sync(kFull, r[k] != 0);
    if (lane == 0) cnt[k * kW + w][0] = __popc(live);
  }
  __syncthreads();
  if (w == 0) {
    long long total[1];
    scan_tile_counts<1, kWideBlock>(cnt, total);
    if (lane == 0) tile_off[t] = total[0];
  }
  __syncthreads();
  // the bag of slot base + k * kWideBlock, by steps: one division a thread
  long long bag = base / pool;
  int rem = static_cast<int>(base - bag * pool);
  const int step_bags = kWideBlock / pool, step_rem = kWideBlock % pool;
  unsigned long long* out = pairs + t * kSlotTile;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const unsigned live = __ballot_sync(kFull, r[k] != 0);
    if (r[k] != 0)
      out[cnt[k * kW + w][0] + __popc(live & lanemask_lt())] =
          (static_cast<unsigned long long>(r[k]) << 32) |
          static_cast<unsigned long long>(bag);
    bag += step_bags;
    rem += step_rem;
    if (rem >= pool) {
      rem -= pool;
      ++bag;
    }
  }
}

// The pairs a radix pass reads: dense, or (the first pass) as the
// compaction left them, tile c's at c * kSlotTile, pair i of tile c at
// c * kSlotTile + i - tile_off[c].
struct Pairs {
  const unsigned long long* data;
  const long long* tile_off;   // null: dense
  long long n_tiles;

  // the tile of pair `lo`: the last c with tile_off[c] <= lo
  __device__ __forceinline__ long long first_tile(long long lo) const {
    if (tile_off == nullptr) return 0;
    long long a = 0, b = n_tiles;   // tile_off[a] <= lo < tile_off[b]
    while (b - a > 1) {
      const long long mid = a + (b - a) / 2;
      if (tile_off[mid] <= lo)
        a = mid;
      else
        b = mid;
    }
    return a;
  }
  // pair i; a thread's i only grow, and c follows them
  __device__ __forceinline__ unsigned long long at(long long i,
                                                   long long& c) const {
    if (tile_off == nullptr) return data[i];
    while (c + 1 < n_tiles && tile_off[c + 1] <= i) ++c;
    return data[c * kSlotTile + (i - tile_off[c])];
  }
};

// Block b of a radix pass owns the pairs [S * b / G, S * (b + 1) / G);
// *c is the tile of the first.
__device__ __forceinline__ void radix_range(const long long* counts,
                                            const Pairs& in, long long* lo,
                                            long long* hi, long long* c) {
  __shared__ long long first;
  const long long n = counts[0];
  *lo = n * blockIdx.x / gridDim.x;
  *hi = n * (blockIdx.x + 1) / gridDim.x;
  if (threadIdx.x == 0) first = in.first_tile(*lo);
  __syncthreads();
  *c = first;
}

// Stage 2a: the digit histogram of each block's pairs, into
// hist[digit * G + block].
__global__ void __launch_bounds__(kBlock)
    radix_hist_kernel(Pairs in, const long long* __restrict__ counts,
                      int shift, long long* __restrict__ hist) {
  __shared__ int h[kDigits];
  for (int d = threadIdx.x; d < kDigits; d += kBlock) h[d] = 0;
  long long lo, hi, c;
  radix_range(counts, in, &lo, &hi, &c);
  const int lane = threadIdx.x % kWarp;
  for (long long i0 = lo; i0 < hi; i0 += kHistBatch * kBlock) {
    int d[kHistBatch];
#pragma unroll
    for (int u = 0; u < kHistBatch; ++u) {
      const long long i = i0 + u * kBlock + threadIdx.x;
      d[u] = i < hi ? static_cast<int>((in.at(i, c) >> shift) & (kDigits - 1))
                    : kDigits;
    }
#pragma unroll
    for (int u = 0; u < kHistBatch; ++u) {
      // one shared add per distinct digit of the warp: a hot row is one
      const unsigned peers = __match_any_sync(kFull, d[u]);
      if (d[u] < kDigits && lane == __ffs(peers) - 1)
        atomicAdd(&h[d[u]], __popc(peers));
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kDigits; d += kBlock)
    hist[static_cast<long long>(d) * gridDim.x + blockIdx.x] = h[d];
}

// Stage 2b: exclusive prefix sums of hist (n entries, digit-major) in
// place: a look-back scan over tiles of 4096 entries.  The last tile
// writes the sum of all into *total when given (the compaction's tile
// counts: the number of pairs, counts[0]).
__global__ void __launch_bounds__(kBlock)
    radix_scan_kernel(long long* __restrict__ hist, long long n,
                      unsigned long long* status,
                      unsigned long long* __restrict__ counter,
                      long long* __restrict__ total) {
  using Tile = ScanTile<1, kBlock>;
  __shared__ Tile tile;
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const long long t = tile.take(counter);
  if (t * Tile::kItems >= n) return;
  const long long base = t * Tile::kItems + threadIdx.x;
  long long v[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const long long i = base + k * kBlock;
    v[k] = i < n ? hist[i] : 0;
  }
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    long long s[1] = {v[k]};
    warp_sum<1>(s);
    if (lane == 0) tile.cnt[k * Tile::kW + w][0] = s[0];
  }
  tile.scan(status);
  if (total != nullptr && t == (n - 1) / Tile::kItems && threadIdx.x == 0)
    *total = tile.total[0];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    long long before;
    warp_exclusive<1>(&v[k], &before);
    const long long i = base + k * kBlock;
    if (i < n)
      hist[i] = tile.prefix[0] + tile.cnt[k * Tile::kW + w][0] + before;
  }
}

// The exclusive prefix of v over a block of kBlock threads.
__device__ __forceinline__ int block_exclusive(int v) {
  __shared__ int warp_tot[kWarps];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  int inc = v;
#pragma unroll
  for (int o = 1; o < kWarp; o *= 2) {
    const int up = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += up;
  }
  if (lane == kWarp - 1) warp_tot[w] = inc;
  __syncthreads();
  if (w == 0) {
    const int x = lane < kWarps ? warp_tot[lane] : 0;
    int y = x;
#pragma unroll
    for (int o = 1; o < kWarp; o *= 2) {
      const int up = __shfl_up_sync(kFull, y, o);
      if (lane >= o) y += up;
    }
    if (lane < kWarps) warp_tot[lane] = y - x;
  }
  __syncthreads();
  const int out = warp_tot[w] + inc - v;
  __syncthreads();   // warp_tot is read before it is written again
  return out;
}

// Stage 2c: a stable scatter by digit.  Block b walks its pairs in tiles
// of kRadixTile; in a tile, warp w takes kRadixRounds rounds of 32
// consecutive pairs and ranks each among the warp's earlier pairs of its
// digit (__match_any_sync).  The tile is then sorted by digit in shared
// memory (digit, then warp, then rank: so equal digits keep their order)
// and written out from there, so that the pairs of a digit go to
// consecutive addresses together.  The last pass writes the sorted rows
// and bags as two int32 arrays.
__global__ void __launch_bounds__(kBlock)
    radix_scatter_kernel(Pairs in, unsigned long long* __restrict__ out,
                         int32_t* __restrict__ rows_out,
                         int32_t* __restrict__ bags_out,
                         const long long* __restrict__ counts, int shift,
                         const long long* __restrict__ offsets) {
  static_assert(kBlock == kDigits, "a thread a digit");
  __shared__ long long base[kDigits];   // the block's next place a digit
  __shared__ int start[kDigits];        // a digit's first place in the tile
  __shared__ int off[kWarps][kDigits];  // a (warp, digit)'s, after start
  __shared__ int cnt[kWarps][kDigits];
  __shared__ unsigned long long staged[kRadixTile];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int d = threadIdx.x;
  base[d] = offsets[static_cast<long long>(d) * gridDim.x + blockIdx.x];
  for (int v = 0; v < kWarps; ++v) cnt[v][d] = 0;
  __syncthreads();
  long long lo, hi, c;
  radix_range(counts, in, &lo, &hi, &c);
  for (long long t0 = lo; t0 < hi; t0 += kRadixTile) {
    unsigned long long e[kRadixRounds];
    int dg[kRadixRounds], rk[kRadixRounds];
#pragma unroll
    for (int k = 0; k < kRadixRounds; ++k) {
      const long long i = t0 + (w * kRadixRounds + k) * kWarp + lane;
      e[k] = i < hi ? in.at(i, c) : 0ull;
      dg[k] = i < hi ? static_cast<int>((e[k] >> shift) & (kDigits - 1))
                     : kDigits;
    }
#pragma unroll
    for (int k = 0; k < kRadixRounds; ++k) {
      const unsigned peers = __match_any_sync(kFull, dg[k]);
      rk[k] = 0;
      if (dg[k] < kDigits)
        rk[k] = cnt[w][dg[k]] + __popc(peers & lanemask_lt());
      __syncwarp();
      if (dg[k] < kDigits && lane == __ffs(peers) - 1)
        cnt[w][dg[k]] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    int total = 0;   // of digit d in the tile
    for (int v = 0; v < kWarps; ++v) {
      off[v][d] = total;
      total += cnt[v][d];
      cnt[v][d] = 0;
    }
    start[d] = block_exclusive(total);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRadixRounds; ++k)
      if (dg[k] < kDigits) staged[start[dg[k]] + off[w][dg[k]] + rk[k]] = e[k];
    __syncthreads();
    const int n_here = static_cast<int>(
        min(hi - t0, static_cast<long long>(kRadixTile)));
    for (int j = threadIdx.x; j < n_here; j += kBlock) {
      const unsigned long long x = staged[j];
      const int dj = static_cast<int>((x >> shift) & (kDigits - 1));
      const long long pos = base[dj] + (j - start[dj]);
      if (out != nullptr) {
        out[pos] = x;
      } else {
        rows_out[pos] = static_cast<int32_t>(x >> 32);
        bags_out[pos] = static_cast<int32_t>(x & 0xffffffffull);
      }
    }
    __syncthreads();
    base[d] += total;
  }
}

// Stage 3a, runs: over the sorted rows (counts[0] of them), the slots that
// start a run of equal rows, in order: run_slots[r] its first slot and
// run_rows[r] its row; the last tile writes counts[1] (runs) and
// run_slots[runs] = slots.
__global__ void __launch_bounds__(kWideBlock, 2048 / kWideBlock)
    runs_kernel(const int32_t* __restrict__ rows,
                unsigned long long* status,
                unsigned long long* __restrict__ counter,
                long long* __restrict__ counts,
                long long* __restrict__ run_slots,
                long long* __restrict__ run_rows) {
  using Tile = ScanTile<1, kWideBlock>;
  __shared__ Tile tile;
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const long long n = counts[0];
  if (n == 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) run_slots[0] = 0;
    return;
  }
  const long long n_tiles = (n + Tile::kItems - 1) / Tile::kItems;
  if (blockIdx.x >= n_tiles) return;   // the first n_tiles blocks take one
  const long long t = tile.take(counter);
  const long long base = t * Tile::kItems + threadIdx.x;
  int32_t row[kRounds];
  bool start[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const long long i = base + k * kWideBlock;
    row[k] = i < n ? rows[i] : 0;
    start[k] = i < n && (i == 0 || rows[i - 1] != row[k]);
  }
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const unsigned s = __ballot_sync(kFull, start[k]);
    if (lane == 0) tile.cnt[k * Tile::kW + w][0] = __popc(s);
  }
  tile.scan(status);
  if (t == n_tiles - 1 && threadIdx.x == 0) {
    counts[1] = tile.total[0];
    run_slots[tile.total[0]] = n;
  }
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const unsigned s = __ballot_sync(kFull, start[k]);
    if (start[k]) {
      const long long r = tile.prefix[0] + tile.cnt[k * Tile::kW + w][0] +
                          __popc(s & lanemask_lt());
      run_slots[r] = base + k * kWideBlock;
      run_rows[r] = row[k];
    }
  }
}

// Stage 3b, chunks: over the runs (counts[1] of them), each run's first
// chunk and first partial by look-back: run_bounds, run_partial (-1 for a
// run of one chunk), chunk_bounds and chunk_dest (where pass 1 puts each
// chunk's sum: partial q as q, or, for a run of one chunk, row x of the
// gradient as -x - 1); the last tile writes the closing bounds and
// counts[2] (chunks) and counts[3] (partials).  A run of L slots is cut
// into chunks of max(chunk, ceil(sqrt(L))) slots, the root correctly
// rounded, as torch's double().sqrt().ceil() is.  The chunks of a long run
// are written by the whole warp.
__global__ void __launch_bounds__(kBlock)
    chunks_kernel(const long long* __restrict__ run_slots,
                  const long long* __restrict__ run_rows, int chunk,
                  unsigned long long* status,
                  unsigned long long* __restrict__ counter,
                  long long* __restrict__ counts,
                  long long* __restrict__ run_bounds,
                  long long* __restrict__ run_partial,
                  long long* __restrict__ chunk_bounds,
                  long long* __restrict__ chunk_dest) {
  using Tile = ScanTile<2, kBlock>;
  __shared__ Tile tile;
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const long long n = counts[1];
  if (n == 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0)
      run_bounds[0] = chunk_bounds[0] = 0;
    return;
  }
  const long long n_tiles = (n + Tile::kItems - 1) / Tile::kItems;
  if (blockIdx.x >= n_tiles) return;   // the first n_tiles blocks take one
  const long long t = tile.take(counter);
  const long long base = t * Tile::kItems + threadIdx.x;
  long long first[kRounds];
  int size[kRounds], pieces[kRounds];   // slots a chunk, chunks a run
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const long long r = base + k * kBlock;
    first[k] = 0;
    size[k] = 1;
    pieces[k] = 0;
    if (r < n) {
      first[k] = run_slots[r];
      const long long len = run_slots[r + 1] - first[k];
      size[k] = static_cast<int>(max(static_cast<long long>(chunk),
          static_cast<long long>(ceil(sqrt(static_cast<double>(len))))));
      pieces[k] = static_cast<int>((len + size[k] - 1) / size[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    long long v[2] = {pieces[k], pieces[k] > 1 ? pieces[k] : 0};
    warp_sum<2>(v);
    if (lane == 0)
      for (int c = 0; c < 2; ++c) tile.cnt[k * Tile::kW + w][c] = v[c];
  }
  tile.scan(status);
  if (t == n_tiles - 1 && threadIdx.x == 0) {
    counts[2] = tile.total[0];
    counts[3] = tile.total[1];
    run_bounds[n] = tile.total[0];
    chunk_bounds[tile.total[0]] = run_slots[n];
  }
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const long long r = base + k * kBlock;
    const long long v[2] = {pieces[k], pieces[k] > 1 ? pieces[k] : 0};
    long long at[2];
    warp_exclusive<2>(v, at);
    for (int c = 0; c < 2; ++c)
      at[c] += tile.prefix[c] + tile.cnt[k * Tile::kW + w][c];
    if (r < n) {
      run_bounds[r] = at[0];
      run_partial[r] = v[1] ? at[1] : -1;
      if (!v[1]) {
        chunk_bounds[at[0]] = first[k];
        chunk_dest[at[0]] = -run_rows[r] - 1;
      }
    }
    // the chunks of the longer runs, a run at a time by the whole warp
    for (unsigned todo = __ballot_sync(kFull, v[1] != 0); todo;
         todo &= todo - 1) {
      const int l = __ffs(todo) - 1;
      const long long f = __shfl_sync(kFull, first[k], l);
      const int sz = __shfl_sync(kFull, size[k], l);
      const int m = __shfl_sync(kFull, pieces[k], l);
      const long long c0 = __shfl_sync(kFull, at[0], l);
      const long long q0 = __shfl_sync(kFull, at[1], l);
      for (int j = lane; j < m; j += kWarp) {
        chunk_bounds[c0 + j] = f + static_cast<long long>(j) * sz;
        chunk_dest[c0 + j] = q0 + j;
      }
    }
  }
}

// Adds the src rows ids[begin] .. ids[end - 1] (the rows begin .. end - 1
// themselves when kIds is false) in that order, from +0, and stores the
// float32 sum at dst (dim values).  One warp; the lanes cover the row in
// 16-byte chunks, up to kBatch row loads in flight per lane.
template <class C, bool kIds, int kBatch = kBwdBatch>
__device__ void sum_rows(const void* __restrict__ src_v,
                         const int32_t* __restrict__ ids, long long begin,
                         long long end, long long n_src_rows,
                         float* __restrict__ dst, int dim) {
  using Vec = typename C::Vec;
  const Vec* __restrict__ src = static_cast<const Vec*>(src_v);
  const int lane = threadIdx.x % kWarp;
  const int chunks = dim / C::kElems;
  if (!kIds && (begin < 0 || end > n_src_rows)) __trap();
  for (int c0 = 0; c0 < chunks; c0 += kWarp) {
    const int c = c0 + lane;
    const bool on = c < chunks;
    const int cl = on ? c : c0;
    float acc[C::kElems];
#pragma unroll
    for (int e = 0; e < C::kElems; ++e) acc[e] = 0.0f;
    for (long long k0 = begin; k0 < end; k0 += kWarp) {
      int32_t my = 0;
      if (kIds && k0 + lane < end) {
        my = ids[k0 + lane];
        if (my < 0 || static_cast<long long>(my) >= n_src_rows) __trap();
      }
      const int n_here = end - k0 < kWarp ? static_cast<int>(end - k0) : kWarp;
      for (int j0 = 0; j0 < n_here; j0 += kBatch) {
        Vec v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = j0 + u;
          if (j < n_here) {
            const long long row = kIds ? __shfl_sync(kFull, my, j) : k0 + j;
            v[u] = load_row_chunk(src, row, chunks, cl);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (j0 + u < n_here) C::add(acc, v[u]);
      }
    }
    if (on) store_chunk<C::kElems>(dst + c * C::kElems, acc);
  }
}

// Stage 4, pass 1: every chunk (counts[2] of them), a warp a chunk, summed
// over its bags' grad_out rows into its destination: a run of one chunk
// straight into its row of g (the same bits as pass 2 adding its one
// partial to +0: a float32 sum started from +0 is never -0), the chunks of
// longer runs into their partials.
template <class C>
__global__ void __launch_bounds__(kBlock)
    pass1_kernel(const void* __restrict__ grad_out,
                 const int32_t* __restrict__ bags,
                 const long long* __restrict__ chunk_bounds,
                 const long long* __restrict__ chunk_dest,
                 const long long* __restrict__ counts,
                 float* __restrict__ partials, float* __restrict__ g,
                 long long n_bags, int dim) {
  const long long n = counts[2];
  for (long long j = warp_id(); j < n; j += warp_count()) {
    const long long dest = chunk_dest[j];
    float* dst = dest >= 0 ? partials + dest * dim : g + (-dest - 1) * dim;
    sum_rows<C, true>(grad_out, bags, chunk_bounds[j], chunk_bounds[j + 1],
                      n_bags, dst, dim);
  }
}

constexpr int kSpanRuns = 4;              // run rows a thread marks a span
constexpr int kSpan = kSpanRuns * kBlock;  // rows a zero block marks at once

// Stage 5a, the write pass's zeros: block b owns a contiguous range of g's
// rows and walks it kSpan rows at a time beside the sorted run rows (found
// once by a binary search).  It marks the rows of the span that a run
// lands on, and warp w stores zeros, coalesced, in rows w, w + 8, ... of
// the span that are not marked (row 0 never is).
__global__ void __launch_bounds__(kBlock)
    zero_rows_kernel(const long long* __restrict__ run_rows,
                     const long long* __restrict__ counts,
                     float* __restrict__ g, long long n_rows, int dim) {
  __shared__ bool has_run[kSpan];
  __shared__ long long first_run;
  const long long n_runs = counts[1];
  const long long per = (n_rows + gridDim.x - 1) / gridDim.x;
  const long long first = blockIdx.x * per;
  const long long last = min(first + per, n_rows);
  if (first >= last) return;
  if (threadIdx.x == 0) {   // the first run at or past `first`
    long long lo = 0, hi = n_runs;
    while (lo < hi) {
      const long long mid = lo + (hi - lo) / 2;
      if (run_rows[mid] < first)
        lo = mid + 1;
      else
        hi = mid;
    }
    first_run = lo;
  }
  for (int u = 0; u < kSpanRuns; ++u)
    has_run[u * kBlock + threadIdx.x] = false;
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  long long r = first_run;
  for (long long s0 = first; s0 < last; s0 += kSpan) {
    const long long s1 = min(s0 + kSpan, last);
    // a span of kSpan rows holds at most kSpan runs
    int n_in = 0;
    for (int u = 0; u < kSpanRuns; ++u) {
      const long long j = r + u * kBlock + threadIdx.x;
      const long long row = j < n_runs ? run_rows[j] : n_rows;
      if (row < s1) has_run[row - s0] = true;
      n_in += __syncthreads_count(row < s1);
    }
    for (long long at = s0 + w; at < s1; at += kWarps) {
      if (has_run[at - s0]) continue;
      float4* dst = reinterpret_cast<float4*>(g + at * dim);
      for (int c = lane; c < dim / 4; c += kWarp) dst[c] = zero;
    }
    __syncthreads();
    for (int u = 0; u < kSpanRuns; ++u)
      has_run[u * kBlock + threadIdx.x] = false;
    __syncthreads();
    r += n_in;
  }
}

// Stage 5b, the write pass's long runs: warp w takes runs w, w + warps,
// ... and writes each of more than one chunk (run_partial >= 0) into its
// row of g as the in-order sum of its partials, kLongBatch loads in flight
// a lane: the hottest run's hundreds of partials are the kernel's tail.
// (The long runs are the hot rows, which sit side by side: a run a warp
// spreads them.)
__global__ void __launch_bounds__(kBlock)
    long_runs_kernel(const long long* __restrict__ run_rows,
                     const long long* __restrict__ run_bounds,
                     const long long* __restrict__ run_partial,
                     const long long* __restrict__ counts,
                     const float* __restrict__ partials,
                     float* __restrict__ g, int dim) {
  const long long n_runs = counts[1];
  const long long n_partials = counts[3];
  for (long long r = warp_id(); r < n_runs; r += warp_count()) {
    const long long p = run_partial[r];
    if (p < 0) continue;
    sum_rows<F32Chunk, false, kLongBatch>(
        partials, nullptr, p, p + run_bounds[r + 1] - run_bounds[r],
        n_partials, g + run_rows[r] * dim, dim);
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

#define LAUNCH_CHECK()                               \
  do {                                               \
    const cudaError_t e = cudaGetLastError();        \
    if (e != cudaSuccess) return static_cast<int>(e); \
  } while (0)

constexpr long long kRunTile = ScanTile<2, kBlock>::kItems;        // 4096
constexpr long long kHistTile = ScanTile<1, kBlock>::kItems;       // 4096

static long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Words of the plan's status: 8 tile counters, then a look-back status
// word a tile: of the scan of the compaction's tile counts (4096 a tile),
// of the runs (16384 slots), of the chunks (4096 runs) and of each pass's
// scan (4096 entries of the histogram).
static long long status_words(long long n_tiles, long long max_runs,
                              int radix_grid, int passes) {
  return 8 + cdiv(n_tiles, kHistTile) + n_tiles + cdiv(max_runs, kRunTile) +
         cdiv(static_cast<long long>(kDigits) * radix_grid, kHistTile) *
             passes;
}

// Plan the backward on `stream` (stages 1-3), sized from the host's N, P
// and R only: no count comes back to the host.  idx: (n_bags, pool) int32;
// counts: 4 int64 (slots kept, runs, chunks, partials); status: n_status
// int64 (status_words); n_tiles = ceil(n_bags * pool / 16384); tile_off:
// n_tiles int64; pairs: 2 x n_bags * pool uint64, the sort's two buffers
// (the compaction writes buffer 0 tile by tile, pass p buffer (p + 1) % 2;
// the last pass writes the sorted rows and their bags as the two int32
// halves of its buffer); hist: 256 x radix_grid int64; run_slots (+1),
// run_rows, run_bounds (+1), run_partial: max_runs; chunk_bounds (+1),
// chunk_dest: one a chunk.  The look-back kernels launch one block a tile
// that the counts could reach.  Returns the cudaError_t of the first
// launch that failed (0 = success); cudaErrorInvalidValue for 2^31 slots
// or more.
int embedding_bag_grad_plan(const int32_t* idx, long long n_bags, int pool,
                            long long n_rows, int chunk, int passes,
                            int radix_grid, long long* counts,
                            long long* status, long long n_status,
                            long long n_tiles, long long max_runs,
                            long long* tile_off, unsigned long long* pairs,
                            long long* hist, long long* run_slots,
                            long long* run_rows, long long* run_bounds,
                            long long* run_partial, long long* chunk_bounds,
                            long long* chunk_dest, int device, void* stream) {
  const long long n_slots = n_bags * pool;
  if (passes < 1 || passes > 4 || n_slots >= (1ll << 31) ||
      n_tiles != cdiv(n_slots, kSlotTile) ||
      n_status != status_words(n_tiles, max_runs, radix_grid, passes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long run_tiles = cdiv(max_runs, kRunTile);
  const long long n_hist = static_cast<long long>(kDigits) * radix_grid;
  const long long hist_tiles = cdiv(n_hist, kHistTile);
  const long long off_tiles = cdiv(n_tiles, kHistTile);
  const int slot_blocks = static_cast<int>(max(1ll, n_tiles));
  const int run_blocks = static_cast<int>(max(1ll, run_tiles));
  const int hist_blocks = static_cast<int>(hist_tiles);
  const int off_blocks = static_cast<int>(max(1ll, off_tiles));
  err = cudaMemsetAsync(counts, 0, 4 * sizeof(long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(status, 0, n_status * sizeof(long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long* counters = reinterpret_cast<unsigned long long*>(status);
  unsigned long long* off_st = counters + 8;
  unsigned long long* runs_st = off_st + off_tiles;
  unsigned long long* chunks_st = runs_st + n_tiles;
  unsigned long long* scan_st = chunks_st + run_tiles;
  if (n_tiles > 0) {
    compact_kernel<<<slot_blocks, kWideBlock, 0, s>>>(idx, n_slots, pool,
                                                      n_rows, pairs, tile_off);
    LAUNCH_CHECK();
  }
  radix_scan_kernel<<<off_blocks, kBlock, 0, s>>>(tile_off, n_tiles, off_st,
                                                  counters, counts);
  LAUNCH_CHECK();
  for (int p = 0; p < passes; ++p) {
    const Pairs in = {pairs + (p % 2) * n_slots, p == 0 ? tile_off : nullptr,
                      n_tiles};
    unsigned long long* out = pairs + ((p + 1) % 2) * n_slots;
    int32_t* rows_out = reinterpret_cast<int32_t*>(out);
    const int shift = 32 + kRadixBits * p;
    radix_hist_kernel<<<radix_grid, kBlock, 0, s>>>(in, counts, shift, hist);
    LAUNCH_CHECK();
    radix_scan_kernel<<<hist_blocks, kBlock, 0, s>>>(
        hist, n_hist, scan_st + hist_tiles * p, counters + 3 + p, nullptr);
    LAUNCH_CHECK();
    radix_scatter_kernel<<<radix_grid, kBlock, 0, s>>>(
        in, p == passes - 1 ? nullptr : out, rows_out, rows_out + n_slots,
        counts, shift, hist);
    LAUNCH_CHECK();
  }
  const int32_t* rows =
      reinterpret_cast<const int32_t*>(pairs + (passes % 2) * n_slots);
  runs_kernel<<<slot_blocks, kWideBlock, 0, s>>>(rows, runs_st, counters + 1,
                                                 counts, run_slots, run_rows);
  LAUNCH_CHECK();
  chunks_kernel<<<run_blocks, kBlock, 0, s>>>(
      run_slots, run_rows, chunk, chunks_st, counters + 2, counts, run_bounds,
      run_partial, chunk_bounds, chunk_dest);
  LAUNCH_CHECK();
  return 0;
}

// Pass 1 on `stream`: every chunk's sum of grad_out (n_bags, dim) float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1) over the plan's bags, into
// partials (counts[3] x dim float32) or, for a run of one chunk, into its
// row of g (n_rows, dim) float32, as chunk_dest says.
int embedding_bag_grad_pass1(const void* grad_out, int is_bf16,
                             const int32_t* bags,
                             const long long* chunk_bounds,
                             const long long* chunk_dest,
                             const long long* counts, float* partials,
                             float* g, long long n_bags, int dim, int grid,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    pass1_kernel<Bf16Chunk><<<grid, kBlock, 0, s>>>(
        grad_out, bags, chunk_bounds, chunk_dest, counts, partials, g, n_bags,
        dim);
  else
    pass1_kernel<F32Chunk><<<grid, kBlock, 0, s>>>(
        grad_out, bags, chunk_bounds, chunk_dest, counts, partials, g, n_bags,
        dim);
  return static_cast<int>(cudaGetLastError());
}

// The write pass on `stream`: zeros in every row of g (n_rows, dim)
// float32 that no run lands on, then the rows of the runs of more than one
// chunk from pass 1's partials (pass 1 wrote those of one chunk).
int embedding_bag_grad_write(const long long* run_rows,
                             const long long* run_bounds,
                             const long long* run_partial,
                             const long long* counts, const float* partials,
                             float* g, long long n_rows, int dim, int grid,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  zero_rows_kernel<<<grid, kBlock, 0, s>>>(run_rows, counts, g, n_rows, dim);
  LAUNCH_CHECK();
  long_runs_kernel<<<grid, kBlock, 0, s>>>(run_rows, run_bounds, run_partial,
                                           counts, partials, g, dim);
  return static_cast<int>(cudaGetLastError());
}

int embedding_bag_block_threads() { return kBlock; }

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
