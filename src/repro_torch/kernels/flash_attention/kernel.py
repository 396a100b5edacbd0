"""K2 and K2-bwd on the GPU: ctypes bindings of ``csrc/flash_attention.cu``
and ``csrc/flash_attention_bwd.cu``.

Each CUDA source is compiled with ``nvcc`` for ``sm_90a`` at first use by
the port's shared build helper (``kernels/build.py``).  Nothing is compiled or
loaded when this module is imported.

``flash_attention_cuda`` (the forward, optionally with the rows'
log-sum-exp) and ``flash_attention_bwd_cuda`` (dq, dk, dv) are the
wrappers: each checks its inputs, allocates its outputs with
``torch.empty``, launches on the current stream and adds one to its
``launches`` per call that launches (K2-bwd's call is three kernels).
They take CUDA tensors only; the plain versions for CPU tensors are in
``ref.py``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import CudaLibrary

HEAD_DIMS = (32, 64, 80, 128, 256)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = CudaLibrary("flash_attention", {
    "flash_attention_fwd": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _F, _I, _P], _I),
    "flash_attention_error_string": ([_I], ctypes.c_char_p),
})
BWD_LIBRARY = CudaLibrary("flash_attention_bwd", {
    "flash_attention_bwd": ([_P] * 10 + [_I] * 9 + [_F, _I, _P], _I),
    "flash_attention_bwd_error_string": ([_I], ctypes.c_char_p),
})


class FlashAttentionKernel:
    """Callable handle on K2: ``flash_attention_cuda(q, k, v, ...)``."""

    def __init__(self):
        self.launches = 0          # kernel launches since the last reset

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int | None = None,
                 scale: float | None = None, lse: bool = False):
        """q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd); float32 or bfloat16,
        hd in ``HEAD_DIMS`` -> (B, S, Hq, hd) in q's dtype; with ``lse``
        also each row's log-sum-exp of the scaled scores, (B, Hq, S)
        float32 (+inf where a row has no valid key), which K2-bwd reads.
        Without it the kernel is handed a null pointer and stores
        none."""
        _check(q, k, v, window)
        lib = LIBRARY.load()
        B, S, Hq, hd = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        scale = _scale(hd, scale)
        out = torch.empty_like(q)
        rows = torch.empty((B, Hq, S), dtype=torch.float32,
                           device=q.device) if lse else None
        if B * S:
            rc = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if rows is None else rows.data_ptr(),
                int(q.dtype == torch.bfloat16), hd, B, S, T, Hq, Hkv,
                int(causal), 0 if window is None else int(window), scale,
                _device(q), torch.cuda.current_stream(q.device).cuda_stream)
            if rc != 0:
                raise RuntimeError(
                    "flash_attention kernel launch failed: "
                    f"{lib.flash_attention_error_string(rc).decode()} "
                    f"({rc})")
            self.launches += 1
        return (out, rows) if lse else out


class FlashAttentionBwdKernel:
    """Callable handle on K2-bwd: ``flash_attention_bwd_cuda(q, k, v, out,
    dout, lse, ...)``."""

    def __init__(self):
        self.launches = 0          # calls that launched, since the last reset

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
                 causal: bool = True, window: int | None = None,
                 scale: float | None = None):
        """q, out, dout: (B, S, Hq, hd); k, v: (B, T, Hkv, hd); lse: (B,
        Hq, S) float32 from K2's forward -> (dq, dk, dv) in the inputs'
        dtype (float32 or bfloat16); dk and dv sum over the query heads of
        their group."""
        _check(q, k, v, window)
        B, S, Hq, hd = q.shape
        for name, t in (("out", out), ("dout", dout)):
            if not t.is_cuda or t.device != q.device:
                raise ValueError(f"{name} must be on {q.device}")
            if t.dtype != q.dtype or t.shape != q.shape:
                raise ValueError(f"{name} must be {q.dtype} of shape "
                                 f"{tuple(q.shape)}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{name} must be contiguous and 16-byte "
                                 "aligned")
        if (not lse.is_cuda or lse.device != q.device
                or lse.dtype != torch.float32 or lse.shape != (B, Hq, S)
                or not lse.is_contiguous()):
            raise ValueError(f"lse must be contiguous float32 {(B, Hq, S)} "
                             f"on {q.device}")
        lib = BWD_LIBRARY.load()
        T, Hkv = k.shape[1], k.shape[2]
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        if B * S == 0:
            return dq, dk.zero_(), dv.zero_()
        delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            int(q.dtype == torch.bfloat16), hd, B, S, T, Hq, Hkv,
            int(causal), 0 if window is None else int(window),
            _scale(hd, scale), _device(q),
            torch.cuda.current_stream(q.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                "flash_attention_bwd kernel launch failed: "
                f"{lib.flash_attention_bwd_error_string(rc).decode()} ({rc})")
        self.launches += 1
        return dq, dk, dv


def _scale(hd: int, scale: float | None) -> float:
    return 1.0 / math.sqrt(hd) if scale is None else float(scale)


def _device(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None \
        else torch.cuda.current_device()


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
flash_attention_bwd_cuda = FlashAttentionBwdKernel()
