"""K1 on the GPU: ctypes binding of ``csrc/embedding_bag.cu``.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` at first use by
the port's shared build helper (``kernels/build.py``).  Nothing is compiled or
loaded when this module is imported.

``embedding_bag_cuda`` is the forward's wrapper: it checks its inputs,
allocates the output with ``torch.empty``, launches on the current stream
and adds one to ``embedding_bag_cuda.launches`` per launch.
``embedding_bag_grad_cuda`` is the backward's: it plans the gradient with
torch index ops (``backward_plan``), allocates it with ``torch.zeros``,
launches the two passes and adds one to its ``launches`` per call that
launches them.  Both take CUDA tensors only; the plain versions for CPU
tensors are in ``ref.py``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels.build import CudaLibrary

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary("embedding_bag", {
    "embedding_bag_fwd": ([_P, _I, _P, _P, _LL, _LL, _I, _I, _I, _I, _P], _I),
    "embedding_bag_segment_sum": ([_P, _I, _P, _P, _LL, _LL, _P, _P, _LL, _I,
                                   _I, _I, _P], _I),
    "embedding_bag_block_threads": ([], _I),
    "embedding_bag_error_string": ([_I], ctypes.c_char_p),
})
CHUNK = 64              # the backward's least chunk of a run, in slots


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
    ``embedding_bag_grad_cuda(arena_shape, indices, grad_out)``."""

    def __init__(self):
        self.launches = 0          # calls that launched both passes

    def __call__(self, arena_shape, indices: torch.Tensor,
                 grad_out: torch.Tensor) -> torch.Tensor:
        """indices: (N, P) int32 rows in [0, R); grad_out: (N, D)
        float32/bfloat16 -> the arena's gradient (R, D) float32, row 0
        zero."""
        n_rows, dim = (int(s) for s in arena_shape)
        _check_grad(n_rows, dim, indices, grad_out)
        lib = LIBRARY.load()
        g = torch.zeros((n_rows, dim), dtype=torch.float32,
                        device=grad_out.device)
        plan = backward_plan(indices, CHUNK)
        n_chunks = plan.chunk_bounds.numel() - 1
        if n_chunks == 0:
            return g
        partial = torch.empty((n_chunks, dim), dtype=torch.float32,
                              device=grad_out.device)
        dev, stream = _device_and_stream(grad_out)
        warps_per_block = lib.embedding_bag_block_threads() // 32
        # pass 1: each chunk's grad_out rows into its partial
        _raise_on(lib, lib.embedding_bag_segment_sum(
            grad_out.data_ptr(), int(grad_out.dtype == torch.bfloat16),
            plan.bags.data_ptr(), plan.chunk_bounds.data_ptr(), n_chunks,
            grad_out.shape[0], partial.data_ptr(), None, n_chunks, dim,
            -(-n_chunks // warps_per_block), dev, stream),
            "embedding_bag backward (pass 1)")
        # pass 2: each run's partials into its row of g
        n_runs = plan.run_rows.numel()
        _raise_on(lib, lib.embedding_bag_segment_sum(
            partial.data_ptr(), 0, None, plan.run_bounds.data_ptr(), n_runs,
            n_chunks, g.data_ptr(), plan.run_rows.data_ptr(), n_rows, dim,
            -(-n_runs // warps_per_block), dev, stream),
            "embedding_bag backward (pass 2)")
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
    if indices.shape[0] >= 2 ** 31:
        raise ValueError("more than 2^31 - 1 bags")
    if not (indices.is_contiguous() and grad_out.is_contiguous()):
        raise ValueError("indices and grad_out must be contiguous")
    if grad_out.data_ptr() % 16:
        raise ValueError("grad_out must be 16-byte aligned")


embedding_bag_cuda = EmbeddingBagKernel()
embedding_bag_grad_cuda = EmbeddingBagGradKernel()
