"""K1 on the GPU: ctypes binding of ``csrc/embedding_bag.cu``.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, under ``build/kernels/``
at the root of the checkout (the file name carries a hash of the source
and flags, so an edit rebuilds).  Nothing is compiled or loaded when this
module is imported.

``embedding_bag_cuda`` is the wrapper: it checks its inputs, allocates
the output with ``torch.empty``, launches on the current stream and adds
one to ``embedding_bag_cuda.launches`` per launch.  It takes CUDA tensors
only; the plain version for CPU tensors is in ``ref.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "embedding_bag.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: K1 builds only where the CUDA "
                           "toolkit is installed")
    return found


class EmbeddingBagKernel:
    """Callable handle on K1: ``embedding_bag_cuda(arena, indices)``."""

    def __init__(self):
        self.launches = 0          # kernel launches since the last reset
        self.build_log = ""        # nvcc/ptxas output of the last build
        self._lib = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(SOURCE.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"embedding_bag-{digest[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless this exact build exists; returns the
        library's path."""
        lib = self.library_path()
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True, check=False)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{self.build_log}")
        os.replace(tmp, lib)
        return lib

    def _load(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            lib.embedding_bag_fwd.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.embedding_bag_fwd.restype = ctypes.c_int
            lib.embedding_bag_block_threads.argtypes = []
            lib.embedding_bag_block_threads.restype = ctypes.c_int
            lib.embedding_bag_error_string.argtypes = [ctypes.c_int]
            lib.embedding_bag_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, arena: torch.Tensor,
                 indices: torch.Tensor) -> torch.Tensor:
        """arena: (R, D) float32/bfloat16 with D % 128 == 0; indices:
        (N, P) int32 rows in [0, R) -> (N, D) float32 pooled sums."""
        _check(arena, indices)
        lib = self._load()
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
