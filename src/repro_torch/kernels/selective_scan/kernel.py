"""K3 on the GPU: ctypes binding of ``csrc/selective_scan.cu``.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` at first use by
the port's shared build helper (``kernels/build.py``).  Nothing is
compiled or loaded when this module is imported.

``selective_scan_cuda`` is the wrapper: it checks its inputs, allocates
``y`` and ``hT`` with ``torch.empty``, launches on the current stream and
adds one to ``selective_scan_cuda.launches`` per launch.  It takes CUDA
tensors only; the plain version for CPU tensors is in ``ref.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaLibrary

STATE_DIMS = (4, 8, 16)            # N: template instances in the source

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary("selective_scan", {
    "selective_scan_fwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _P], _I),
    "selective_scan_occupancy": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
    "selective_scan_error_string": ([_I], ctypes.c_char_p),
})


class SelectiveScanKernel:
    """Callable handle on K3: ``selective_scan_cuda(x, dt, Bc, Cc, A,
    h0)``."""

    def __init__(self):
        self.launches = 0          # kernel launches since the last reset

    def __call__(self, x: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                 Cc: torch.Tensor, A: torch.Tensor,
                 h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, Di) float32 or bfloat16; dt: (B, S, Di), Bc, Cc: (B,
        S, N), A: (Di, N), h0: (B, Di, N), float32, N in ``STATE_DIMS`` ->
        (y (B, S, Di) in x's dtype, hT (B, Di, N) float32)."""
        _check(x, dt, Bc, Cc, A, h0)
        lib = LIBRARY.load()
        B, S, Di = x.shape
        N = A.shape[1]
        y = torch.empty_like(x)
        hT = torch.empty_like(h0)
        dev = x.device.index if x.device.index is not None \
            else torch.cuda.current_device()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.selective_scan_fwd(
            x.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            A.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
            int(x.dtype == torch.bfloat16), B, S, Di, N, dev, stream)
        if rc != 0:
            raise RuntimeError(
                "selective_scan kernel launch failed: "
                f"{lib.selective_scan_error_string(rc).decode()} ({rc})")
        self.launches += 1
        return y, hT

    def occupancy(self, dtype: torch.dtype, state_dim: int,
                  device: int | None = None) -> dict:
        """The instance launched for x of ``dtype`` and N ``state_dim``:
        registers a thread and resident blocks and warps an SM
        (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
        lib = LIBRARY.load()
        dev = torch.cuda.current_device() if device is None else device
        out = (_I * 5)()
        rc = lib.selective_scan_occupancy(int(dtype == torch.bfloat16),
                                          state_dim, dev, out)
        if rc != 0:
            raise RuntimeError(
                "selective_scan occupancy query failed: "
                f"{lib.selective_scan_error_string(rc).decode()} ({rc})")
        return {"registers": out[0], "blocks_per_sm": out[1],
                "threads": out[2], "warps_per_sm": out[1] * out[2] // 32,
                "smem_bytes": out[3], "channels_per_block": out[4]}


def _check(x, dt, Bc, Cc, A, h0) -> None:
    ts = (x, dt, Bc, Cc, A, h0)
    if not all(t.is_cuda for t in ts):
        raise ValueError("selective_scan_cuda takes CUDA tensors only")
    if any(t.device != x.device for t in ts):
        raise ValueError("inputs on more than one device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if any(t.dtype != torch.float32 for t in ts[1:]):
        raise TypeError("dt, Bc, Cc, A and h0 must be float32")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError("x must be (B, S, Di) and A (Di, N)")
    B, S, Di = x.shape
    N = A.shape[1]
    if (dt.shape != x.shape or Bc.shape != (B, S, N) or Cc.shape != (B, S, N)
            or A.shape != (Di, N) or h0.shape != (B, Di, N)):
        raise ValueError(
            f"shapes do not match: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"Bc {tuple(Bc.shape)}, Cc {tuple(Cc.shape)}, A "
            f"{tuple(A.shape)}, h0 {tuple(h0.shape)}")
    if N not in STATE_DIMS:
        raise ValueError(f"state dim {N} is not one of {STATE_DIMS}")
    if B == 0 or S == 0 or Di == 0:
        raise ValueError(f"empty scan: x {tuple(x.shape)}")
    # the grid is B x (blocks a row of Di), one or more channels a block
    if B * Di >= 2 ** 31 or S >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the launch grid")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("inputs must be contiguous")


selective_scan_cuda = SelectiveScanKernel()
