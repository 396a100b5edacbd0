"""K1 on the GPU: ctypes binding of ``csrc/embedding_bag.cu``.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` at first use by
the port's shared build helper (``kernels/build.py``).  Nothing is compiled or
loaded when this module is imported.

``embedding_bag_cuda`` is the forward's wrapper: it checks its inputs,
allocates the output with ``torch.empty``, launches on the current stream
and adds one to ``embedding_bag_cuda.launches`` per launch.
``embedding_bag_grad_cuda`` is the backward's: it allocates its scratch
and the gradient with ``torch.empty``, sized from the shapes alone, plans
the gradient on the card (``plan``), sums every chunk (``pass1``) and
writes the zeros and the longer runs' rows (``write``), so that every
row of the gradient is written once, with no host sync, and adds one to
its ``launches`` per call.  Both take CUDA tensors only; the plain
versions for CPU tensors are in ``ref.py``, and ``backward_plan`` is the
plain version of the backward's plan.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels.build import CudaLibrary

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary("embedding_bag", {
    "embedding_bag_fwd": ([_P, _I, _P, _P, _LL, _LL, _I, _I, _I, _I, _P], _I),
    "embedding_bag_grad_plan": ([_P, _LL, _I, _LL, _I, _I, _I, _P, _P, _LL,
                                 _LL, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _P], _I),
    "embedding_bag_grad_pass1": ([_P, _I, _P, _P, _P, _P, _P, _P, _LL, _I,
                                  _I, _I, _P], _I),
    "embedding_bag_grad_write": ([_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I,
                                  _P], _I),
    "embedding_bag_block_threads": ([], _I),
    "embedding_bag_error_string": ([_I], ctypes.c_char_p),
})
CHUNK = 64              # the backward's least chunk of a run, in slots
SLOT_TILE = 16384       # slots a tile of the compaction and the runs
TILE = 4096             # runs, or counts, a tile of a scan
RADIX_TILE = 2048       # pairs a tile of a radix pass (kRadixTile)
RADIX_BITS = 8
BLOCKS_PER_SM = 8       # blocks of 256 threads a grid-stride launch puts
                        # on each SM (a radix pass, pass 1, the write pass)


class BackwardPlan(NamedTuple):
    """The index bookkeeping of the backward (no gradient arithmetic).

    The slots whose index is not the zero row, stably sorted by row, give
    ``bags`` (S,) int32: the bag of each.  Each run of equal rows is cut
    into chunks, so chunk ``j`` is ``bags[chunk_bounds[j]:chunk_bounds[j +
    1]]``, and run ``r`` (arena row ``run_rows[r]``) is the chunks
    ``run_bounds[r]`` .. ``run_bounds[r + 1] - 1``.
    """

    bags: torch.Tensor
    chunk_bounds: torch.Tensor  # (n_chunks + 1,) int64
    run_bounds: torch.Tensor    # (n_runs + 1,) int64
    run_rows: torch.Tensor      # (n_runs,) int64


def _with_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x.new_zeros(1), x])


def backward_plan(indices: torch.Tensor, chunk: int = CHUNK) -> BackwardPlan:
    """Plan the gradient of ``indices`` (N, P).  A run of L slots is cut
    into chunks of max(chunk, ceil(sqrt(L))) slots (the last one shorter),
    so neither pass sums more than that many rows in one warp: a zipf-hot
    row takes millions of slots."""
    flat = indices.reshape(-1)
    slots = torch.nonzero(flat).squeeze(1)     # in slot order
    rows, order = torch.sort(flat[slots], stable=True)
    bags = torch.div(slots[order], indices.shape[1],
                     rounding_mode="floor").to(torch.int32)
    run_rows, counts = torch.unique_consecutive(rows, return_counts=True)
    size = counts.double().sqrt().ceil().long().clamp(min=chunk)
    n_chunks = torch.div(counts + size - 1, size, rounding_mode="floor")
    run_bounds = _with_zero(torch.cumsum(n_chunks, 0))
    run_starts = _with_zero(torch.cumsum(counts, 0))
    run_of = torch.repeat_interleave(n_chunks)     # the run of each chunk
    k = torch.arange(run_of.numel(), device=flat.device) - run_bounds[run_of]
    starts = run_starts[run_of] + k * size[run_of]
    return BackwardPlan(bags, torch.cat([starts, run_starts[-1:]]),
                        run_bounds, run_rows.long())


def radix_passes(n_rows: int) -> int:
    """The LSD radix passes of RADIX_BITS bits that sort rows in [0,
    n_rows): 3 below 2^24 rows, 4 up to 2^32."""
    return max(1, -(-(n_rows - 1).bit_length() // RADIX_BITS))


def chunk_size(length: int, chunk: int = CHUNK) -> int:
    """Slots a chunk of a run of ``length`` slots: max(chunk,
    ceil(sqrt(length))), with the square root in double precision and
    correctly rounded, as in ``backward_plan`` and the CUDA source."""
    return max(chunk, math.ceil(math.sqrt(length)))


def partial_bound(n_slots: int, chunk: int = CHUNK) -> int:
    """At most this many chunks belong to runs of more than one chunk
    among ``n_slots`` slots: such a run of L > chunk slots has at most
    2L / (chunk + 1) chunks (the worst is L = chunk + 1, two chunks)."""
    return 2 * n_slots // (chunk + 1)


class GradSizes(NamedTuple):
    """The backward's launch and scratch sizes, from N, P and R alone."""

    slots: int          # N * P, the most pairs the plan can hold
    tiles: int          # look-back tiles of SLOT_TILE slots
    radix_grid: int     # blocks of a radix pass, each a contiguous range
    passes: int         # radix passes
    max_runs: int       # distinct non-zero rows: min(N * P, R - 1)
    max_partials: int   # chunks of runs of more than one chunk
    max_chunks: int     # every chunk: a run of one chunk, or a partial's
    status: int         # int64 words of the look-back counters and status


def grad_sizes(n_bags: int, pool: int, n_rows: int, sms: int,
               chunk: int = CHUNK) -> GradSizes:
    slots = n_bags * pool
    tiles = -(-slots // SLOT_TILE)
    max_runs = min(slots, n_rows - 1)
    max_partials = partial_bound(slots, chunk)
    radix_grid = max(1, min(-(-slots // RADIX_TILE), BLOCKS_PER_SM * sms))
    passes = radix_passes(n_rows)
    # as status_words in the CUDA source: 8 counters, then a word a tile:
    # of the scan of the compaction's tile counts (TILE a tile), of the
    # runs (SLOT_TILE slots), of the chunks (TILE runs) and of each pass's
    # scan (TILE entries of the histogram)
    status = (8 + -(-tiles // TILE) + tiles + -(-max_runs // TILE)
              + -(-256 * radix_grid // TILE) * passes)
    return GradSizes(slots, tiles, radix_grid, passes, max_runs,
                     max_partials, min(slots, max_runs + max_partials),
                     status)


def scratch_bytes(sizes: GradSizes, dim: int) -> int:
    """Bytes of the backward's scratch (the gradient not included): the
    sort's two pair buffers (16 N P), the partials (4 D of them each; at
    most 8 N P D / (CHUNK + 1) bytes) and the plan's int64 arrays."""
    words = (4 + sizes.status + sizes.tiles + 2 * sizes.slots
             + 256 * sizes.radix_grid
             + 4 * sizes.max_runs + 2 + 2 * sizes.max_chunks + 1)
    return 8 * words + 4 * sizes.max_partials * dim


class DevicePlan(NamedTuple):
    """The backward's plan on the card: buffers sized by ``GradSizes``,
    of which the counts (slots, runs, chunks, partials; on the card) say
    how much is live.  ``to_backward_plan`` reads it back (a host sync)
    as ``backward_plan`` gives it."""

    sizes: GradSizes
    counts: torch.Tensor        # (4,) int64
    status: torch.Tensor        # look-back counters and tile status
    tile_off: torch.Tensor      # (tiles,) the compaction's tile offsets
    pairs: torch.Tensor         # (2, N * P) int64, the sort's buffers
    hist: torch.Tensor          # (256 * radix_grid,) int64
    run_slots: torch.Tensor     # run r is the sorted slots [r], [r + 1]
    run_rows: torch.Tensor
    run_bounds: torch.Tensor
    run_partial: torch.Tensor   # a run's first partial, -1 for one chunk
    chunk_bounds: torch.Tensor
    chunk_dest: torch.Tensor    # partial q as q; row x of a one-chunk run
                                # as -x - 1

    def sorted_rows_and_bags(self):
        """The sorted rows and their bags: the two int32 halves of the
        pair buffer that the last radix pass wrote."""
        half = self.pairs[self.sizes.passes % 2].view(torch.int32)
        return half[:self.sizes.slots], half[self.sizes.slots:]

    def to_backward_plan(self) -> BackwardPlan:
        n_slots, n_runs, n_chunks, _ = (int(c) for c in self.counts.cpu())
        bags = self.sorted_rows_and_bags()[1]
        return BackwardPlan(bags[:n_slots], self.chunk_bounds[:n_chunks + 1],
                            self.run_bounds[:n_runs + 1],
                            self.run_rows[:n_runs])


def _device_and_stream(t: torch.Tensor):
    dev = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.embedding_bag_error_string(rc).decode()} ({rc})")


class EmbeddingBagKernel:
    """Callable handle on K1: ``embedding_bag_cuda(arena, indices)``."""

    def __init__(self):
        self.launches = 0          # kernel launches since the last reset

    def __call__(self, arena: torch.Tensor,
                 indices: torch.Tensor) -> torch.Tensor:
        """arena: (R, D) float32/bfloat16 with D % 128 == 0; indices:
        (N, P) int32 rows in [0, R) -> (N, D) float32 pooled sums."""
        _check(arena, indices)
        lib = LIBRARY.load()
        n_bags, pool = indices.shape
        n_rows, dim = arena.shape
        out = torch.empty((n_bags, dim), dtype=torch.float32,
                          device=arena.device)
        if n_bags == 0:
            return out
        dev, stream = _device_and_stream(arena)
        warps_per_block = lib.embedding_bag_block_threads() // 32
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = min(-(-n_bags // warps_per_block), 32 * sms)
        _raise_on(lib, lib.embedding_bag_fwd(
            arena.data_ptr(), int(arena.dtype == torch.bfloat16),
            indices.data_ptr(), out.data_ptr(), n_rows, n_bags, pool, dim,
            grid, dev, stream), "embedding_bag")
        self.launches += 1
        return out


class EmbeddingBagGradKernel:
    """Callable handle on K1's backward:
    ``embedding_bag_grad_cuda(arena_shape, indices, grad_out)``.

    A call is three steps on the current stream, none of which waits for
    the card: ``plan`` (compact, radix sort, runs and chunks), ``pass1``
    (every chunk's sum: a run of one chunk into its row, the others into
    partials) and ``write`` (zeros where no run lands, and the rows of the
    longer runs): every row of the gradient is written once.  The smoke
    times them one by one; only a call counts as a launch."""

    def __init__(self):
        self.launches = 0          # calls (each launches every stage)
        self._sms = {}

    def _sm_count(self, dev: int) -> int:
        if dev not in self._sms:
            self._sms[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        return self._sms[dev]

    def sizes(self, arena_shape, indices: torch.Tensor) -> GradSizes:
        return grad_sizes(indices.shape[0], indices.shape[1],
                          int(arena_shape[0]),
                          self._sm_count(_device_and_stream(indices)[0]),
                          CHUNK)

    def plan(self, arena_shape, indices: torch.Tensor) -> DevicePlan:
        """The backward's plan of ``indices`` on the card (no host sync)."""
        z = self.sizes(arena_shape, indices)
        dev, stream = _device_and_stream(indices)
        i64 = dict(dtype=torch.int64, device=indices.device)
        p = DevicePlan(
            z, torch.empty(4, **i64), torch.empty(z.status, **i64),
            torch.empty(z.tiles, **i64), torch.empty((2, z.slots), **i64),
            torch.empty(256 * z.radix_grid, **i64),
            torch.empty(z.max_runs + 1, **i64),
            torch.empty(z.max_runs, **i64), torch.empty(z.max_runs + 1, **i64),
            torch.empty(z.max_runs, **i64),
            torch.empty(z.max_chunks + 1, **i64),
            torch.empty(z.max_chunks, **i64))
        lib = LIBRARY.load()
        _raise_on(lib, lib.embedding_bag_grad_plan(
            indices.data_ptr(), indices.shape[0], indices.shape[1],
            int(arena_shape[0]), CHUNK, z.passes, z.radix_grid,
            p.counts.data_ptr(), p.status.data_ptr(), z.status, z.tiles,
            z.max_runs, p.tile_off.data_ptr(), p.pairs.data_ptr(),
            p.hist.data_ptr(),
            p.run_slots.data_ptr(), p.run_rows.data_ptr(),
            p.run_bounds.data_ptr(), p.run_partial.data_ptr(),
            p.chunk_bounds.data_ptr(), p.chunk_dest.data_ptr(), dev,
            stream), "embedding_bag backward (plan)")
        return p

    def pass1(self, g: torch.Tensor, plan: DevicePlan,
              grad_out: torch.Tensor) -> torch.Tensor:
        """Pass 1: every chunk's sum, a run of one chunk straight into its
        row of ``g`` (R, D); returns the partials of the longer runs,
        (max_partials, D) float32, of which counts[3] rows are live."""
        z, dim = plan.sizes, grad_out.shape[1]
        out = torch.empty((z.max_partials, dim), dtype=torch.float32,
                          device=grad_out.device)
        dev, stream = _device_and_stream(grad_out)
        lib = LIBRARY.load()
        _raise_on(lib, lib.embedding_bag_grad_pass1(
            grad_out.data_ptr(), int(grad_out.dtype == torch.bfloat16),
            plan.sorted_rows_and_bags()[1].data_ptr(),
            plan.chunk_bounds.data_ptr(), plan.chunk_dest.data_ptr(),
            plan.counts.data_ptr(), out.data_ptr(), g.data_ptr(),
            grad_out.shape[0], dim, BLOCKS_PER_SM * self._sm_count(dev), dev,
            stream), "embedding_bag backward (pass 1)")
        return out

    def write(self, g: torch.Tensor, plan: DevicePlan,
              partials: torch.Tensor) -> torch.Tensor:
        """The write pass: zeros in every row of ``g`` that no run lands
        on, and the rows of the longer runs from their partials (pass 1
        wrote the others); returns ``g``."""
        dev, stream = _device_and_stream(g)
        lib = LIBRARY.load()
        _raise_on(lib, lib.embedding_bag_grad_write(
            plan.run_rows.data_ptr(), plan.run_bounds.data_ptr(),
            plan.run_partial.data_ptr(), plan.counts.data_ptr(),
            partials.data_ptr(), g.data_ptr(), g.shape[0], g.shape[1],
            BLOCKS_PER_SM * self._sm_count(dev), dev, stream),
            "embedding_bag backward (write)")
        return g

    def __call__(self, arena_shape, indices: torch.Tensor,
                 grad_out: torch.Tensor) -> torch.Tensor:
        """indices: (N, P) int32 rows in [0, R); grad_out: (N, D)
        float32/bfloat16 -> the arena's gradient (R, D) float32, row 0
        zero."""
        n_rows, dim = (int(s) for s in arena_shape)
        _check_grad(n_rows, dim, indices, grad_out)
        g = torch.empty((n_rows, dim), dtype=torch.float32,
                        device=grad_out.device)
        plan = self.plan(arena_shape, indices)
        self.write(g, plan, self.pass1(g, plan, grad_out))
        self.launches += 1
        return g


def _check(arena: torch.Tensor, indices: torch.Tensor) -> None:
    if not (arena.is_cuda and indices.is_cuda):
        raise ValueError("embedding_bag_cuda takes CUDA tensors only")
    if arena.device != indices.device:
        raise ValueError(f"arena on {arena.device}, indices on "
                         f"{indices.device}")
    if arena.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"arena must be float32 or bfloat16, got "
                        f"{arena.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if arena.dim() != 2 or indices.dim() != 2:
        raise ValueError("arena must be (R, D) and indices (N, P)")
    if arena.shape[1] % 128:
        raise ValueError(f"arena width {arena.shape[1]} is not a multiple "
                         "of 128 (pad it, see ops.pad_dim)")
    if not (arena.is_contiguous() and indices.is_contiguous()):
        raise ValueError("arena and indices must be contiguous")
    if arena.data_ptr() % 16:
        raise ValueError("arena must be 16-byte aligned")


def _check_grad(n_rows: int, dim: int, indices: torch.Tensor,
                grad_out: torch.Tensor) -> None:
    if not (indices.is_cuda and grad_out.is_cuda):
        raise ValueError("embedding_bag_grad_cuda takes CUDA tensors only")
    if indices.device != grad_out.device:
        raise ValueError(f"indices on {indices.device}, grad_out on "
                         f"{grad_out.device}")
    if grad_out.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grad_out must be float32 or bfloat16, got "
                        f"{grad_out.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if indices.dim() != 2 or grad_out.dim() != 2:
        raise ValueError("indices must be (N, P) and grad_out (N, D)")
    if grad_out.shape != (indices.shape[0], dim) or n_rows < 1:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} does not match "
                         f"indices {tuple(indices.shape)} and an arena of "
                         f"({n_rows}, {dim})")
    if dim % 128:
        raise ValueError(f"arena width {dim} is not a multiple of 128")
    if indices.numel() >= 2 ** 31:
        raise ValueError("more than 2^31 - 1 slots")
    if not (indices.is_contiguous() and grad_out.is_contiguous()):
        raise ValueError("indices and grad_out must be contiguous")
    if grad_out.data_ptr() % 16:
        raise ValueError("grad_out must be 16-byte aligned")


embedding_bag_cuda = EmbeddingBagKernel()
embedding_bag_grad_cuda = EmbeddingBagGradKernel()
