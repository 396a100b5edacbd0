"""K1 on the GPU: ctypes binding of ``csrc/embedding_bag.cu``.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` at first use by
the port's shared build helper (``kernels/build.py``).  Nothing is compiled or
loaded when this module is imported.

``embedding_bag_cuda`` is the wrapper: it checks its inputs, allocates
the output with ``torch.empty``, launches on the current stream and adds
one to ``embedding_bag_cuda.launches`` per launch.  It takes CUDA tensors
only; the plain version for CPU tensors is in ``ref.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaLibrary

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary("embedding_bag", {
    "embedding_bag_fwd": ([_P, _I, _P, _P, _LL, _LL, _I, _I, _I, _I, _P], _I),
    "embedding_bag_block_threads": ([], _I),
    "embedding_bag_error_string": ([_I], ctypes.c_char_p),
})


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
        dev = arena.device.index if arena.device.index is not None \
            else torch.cuda.current_device()
        warps_per_block = lib.embedding_bag_block_threads() // 32
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = min(-(-n_bags // warps_per_block), 32 * sms)
        stream = torch.cuda.current_stream(arena.device).cuda_stream
        rc = lib.embedding_bag_fwd(
            arena.data_ptr(), int(arena.dtype == torch.bfloat16),
            indices.data_ptr(), out.data_ptr(), n_rows, n_bags, pool, dim,
            grid, dev, stream)
        if rc != 0:
            raise RuntimeError(
                "embedding_bag kernel launch failed: "
                f"{lib.embedding_bag_error_string(rc).decode()} ({rc})")
        self.launches += 1
        return out


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


embedding_bag_cuda = EmbeddingBagKernel()
