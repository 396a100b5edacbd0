"""K2 on the GPU: ctypes binding of ``csrc/flash_attention.cu``.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` at first use by
the port's shared build helper (``kernels/build.py``).  Nothing is compiled or
loaded when this module is imported.

``flash_attention_cuda`` is the wrapper: it checks its inputs, allocates
the output with ``torch.empty``, launches on the current stream and adds
one to ``flash_attention_cuda.launches`` per launch.  It takes CUDA
tensors only; the plain version for CPU tensors is in ``ref.py``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import CudaLibrary

HEAD_DIMS = (32, 64, 80, 128, 256)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = CudaLibrary("flash_attention", {
    "flash_attention_fwd": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _F, _I, _P], _I),
    "flash_attention_error_string": ([_I], ctypes.c_char_p),
})


class FlashAttentionKernel:
    """Callable handle on K2: ``flash_attention_cuda(q, k, v, ...)``."""

    def __init__(self):
        self.launches = 0          # kernel launches since the last reset

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int | None = None,
                 scale: float | None = None) -> torch.Tensor:
        """q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd); float32 or bfloat16,
        hd in ``HEAD_DIMS`` -> (B, S, Hq, hd) in q's dtype."""
        _check(q, k, v, window)
        lib = LIBRARY.load()
        B, S, Hq, hd = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
        out = torch.empty_like(q)
        if B * S == 0:
            return out
        dev = q.device.index if q.device.index is not None \
            else torch.cuda.current_device()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), hd, B, S, T, Hq, Hkv,
            int(causal), 0 if window is None else int(window), scale, dev,
            stream)
        if rc != 0:
            raise RuntimeError(
                "flash_attention kernel launch failed: "
                f"{lib.flash_attention_error_string(rc).decode()} ({rc})")
        self.launches += 1
        return out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors only")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (B, S, Hq, hd) and k, v (B, T, Hkv, hd)")
    B, S, Hq, hd = q.shape
    Bk, T, Hkv, hdk = k.shape
    if Bk != B or hdk != hd or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "match (same B and hd, Hq a multiple of Hkv)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of {HEAD_DIMS}")
    if T == 0:
        raise ValueError("attention over zero keys")
    if B * Hq > 65535 or max(S, T) >= 2 ** 31:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the launch grid")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")


flash_attention_cuda = FlashAttentionKernel()
