"""K4 on the GPU: ctypes binding of ``csrc/wkv6.cu``.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` at first use by
the port's shared build helper (``kernels/build.py``).  Nothing is
compiled or loaded when this module is imported.

``wkv6_cuda`` is the wrapper: it checks its inputs, allocates ``y`` and
``sT`` with ``torch.empty``, launches on the current stream and adds one
to ``wkv6_cuda.launches`` per launch.  It takes CUDA tensors only; the
plain version for CPU tensors is in ``ref.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaLibrary

HEAD_DIM = 64                      # RWKV_HEAD_DIM: the source's block

_P, _I = ctypes.c_void_p, ctypes.c_int
_MISALIGNED = 716                  # cudaErrorMisalignedAddress
LIBRARY = CudaLibrary("wkv6", {
    "wkv6_fwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                 _I),
    "wkv6_occupancy": ([_I, _I, ctypes.POINTER(_I)], _I),
    "wkv6_error_string": ([_I], ctypes.c_char_p),
})


class WKV6Kernel:
    """Callable handle on K4: ``wkv6_cuda(r, k, v, w, u, s0)``."""

    def __init__(self):
        self.launches = 0          # kernel launches since the last reset

    def __call__(self, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor,
                 s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """r, k, v: (B, S, H, 64) float32 or bfloat16; w: (B, S, H, 64),
        u: (H, 64), s0: (B, H, 64, 64), float32 -> (y (B, S, H, 64), sT
        (B, H, 64, 64)) float32."""
        _check(r, k, v, w, u, s0)
        lib = LIBRARY.load()
        B, S, H, _ = r.shape
        y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
        sT = torch.empty_like(s0)
        dev = r.device.index if r.device.index is not None \
            else torch.cuda.current_device()
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
            int(r.dtype == torch.bfloat16), B, S, H, dev, stream)
        if rc == _MISALIGNED:
            raise ValueError("r, k, v and w must be 16-byte aligned (the "
                             "kernel stages them with 16-byte cp.async)")
        if rc != 0:
            raise RuntimeError("wkv6 kernel launch failed: "
                               f"{lib.wkv6_error_string(rc).decode()} ({rc})")
        self.launches += 1
        return y, sT

    def occupancy(self, dtype: torch.dtype, device: int | None = None) -> dict:
        """The instance launched for r, k, v of ``dtype``: registers a
        thread and resident blocks and warps an SM
        (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
        lib = LIBRARY.load()
        dev = torch.cuda.current_device() if device is None else device
        out = (_I * 5)()
        rc = lib.wkv6_occupancy(int(dtype == torch.bfloat16), dev, out)
        if rc != 0:
            raise RuntimeError("wkv6 occupancy query failed: "
                               f"{lib.wkv6_error_string(rc).decode()} ({rc})")
        return {"registers": out[0], "blocks_per_sm": out[1],
                "threads": out[2], "warps_per_sm": out[1] * out[2] // 32,
                "smem_bytes": out[3], "lanes_per_column": out[4]}


def _check(r, k, v, w, u, s0) -> None:
    ts = (r, k, v, w, u, s0)
    if not all(t.is_cuda for t in ts):
        raise ValueError("wkv6_cuda takes CUDA tensors only")
    if any(t.device != r.device for t in ts):
        raise ValueError("inputs on more than one device")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"r must be float32 or bfloat16, got {r.dtype}")
    if not (k.dtype == v.dtype == r.dtype):
        raise TypeError(f"r, k, v dtypes differ: {r.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if any(t.dtype != torch.float32 for t in (w, u, s0)):
        raise TypeError("w, u and s0 must be float32")
    if r.dim() != 4 or r.shape[3] != HEAD_DIM:
        raise ValueError(f"r must be (B, S, H, {HEAD_DIM}), got "
                         f"{tuple(r.shape)}")
    B, S, H, hd = r.shape
    if (k.shape != r.shape or v.shape != r.shape or w.shape != r.shape
            or u.shape != (H, hd) or s0.shape != (B, H, hd, hd)):
        raise ValueError(
            f"shapes do not match: r {tuple(r.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)}, "
            f"s0 {tuple(s0.shape)}")
    if B * H == 0 or S == 0:
        raise ValueError(f"empty scan: r {tuple(r.shape)}")
    # the grid is B x H x (blocks a head), at most one a column
    if B * H * hd >= 2 ** 31 or S >= 2 ** 31:
        raise ValueError(f"shape {tuple(r.shape)} exceeds the launch grid")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("inputs must be contiguous")


wkv6_cuda = WKV6Kernel()
