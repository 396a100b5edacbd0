"""K3 and its backward on the GPU: ctypes binding of ``csrc/selective_scan.cu``.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` at first use by
the port's shared build helper (``kernels/build.py``).  Nothing is
compiled or loaded when this module is imported.

``selective_scan_cuda`` is the forward's wrapper: it checks its inputs,
allocates ``y`` and ``hT`` (and, to train, the state at every chunk's
start) with ``torch.empty``, launches on the current stream and adds one
to ``selective_scan_cuda.launches`` per launch.  ``selective_scan_grad_cuda``
is the backward's (K3-bwd: the reverse walk in thread block clusters and
the sums over clusters, one count a call), with its scratch allocated the
same way.  Both take CUDA tensors only; the plain versions for CPU
tensors are in ``ref.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.selective_scan.ref import CHUNK

STATE_DIMS = (4, 8, 16)            # N: template instances in the source
THREADS = 128                      # the source's kThreads: a lane a state,
                                   # THREADS // N channels a block

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary("selective_scan", {
    "selective_scan_fwd": ([_P] * 9 + [_I] * 6 + [_P], _I),
    "selective_scan_bwd": ([_P] * 16 + [_I] * 7 + [_P], _I),
    "selective_scan_bwd_parts": ([_I, _I], _I),
    "selective_scan_occupancy": ([_I] * 5 + [ctypes.POINTER(_I)], _I),
    "selective_scan_error_string": ([_I], ctypes.c_char_p),
})


def _device_stream(t: torch.Tensor) -> tuple[int, int]:
    dev = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(t.device).cuda_stream


def _raise(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} failed: "
            f"{lib.selective_scan_error_string(rc).decode()} ({rc})")


def _occupancy(dtype: torch.dtype, state_dim: int, backward: bool,
               device: int | None, shape=None) -> dict:
    lib = LIBRARY.load()
    dev = torch.cuda.current_device() if device is None else device
    out = (_I * 8)()
    d_inner = shape[2] if shape is not None else THREADS // state_dim
    rc = lib.selective_scan_occupancy(int(dtype == torch.bfloat16),
                                      state_dim, int(backward), d_inner, dev,
                                      out)
    _raise(lib, rc, "selective_scan occupancy query")
    occ = {"registers": out[0], "blocks_per_sm": out[1],
           "threads": out[2], "warps_per_sm": out[1] * out[2] // 32,
           "smem_bytes": out[3], "channels_per_block": out[4],
           "local_bytes": out[7]}
    if backward:
        occ.update(cluster_size=out[5], active_clusters=out[6])
        if shape is not None:
            clusters = shape[0] * lib.selective_scan_bwd_parts(shape[2],
                                                               state_dim)
            occ.update(clusters=clusters, waves=clusters / out[6])
    return occ


class SelectiveScanKernel:
    """Callable handle on K3: ``selective_scan_cuda(x, dt, Bc, Cc, A,
    h0)``."""

    def __init__(self):
        self.launches = 0          # kernel launches since the last reset

    def __call__(self, x: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                 Cc: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                 save_states: bool = False):
        """x: (B, S, Di) float32 or bfloat16; dt: (B, S, Di), Bc, Cc: (B,
        S, N), A: (Di, N), h0: (B, Di, N), float32, N in ``STATE_DIMS`` ->
        (y (B, S, Di) in x's dtype, hT (B, Di, N) float32), and with
        ``save_states`` also hs (B, ceil(S / CHUNK), Di, N) float32, the
        state at every chunk's start (``hs[:, 0]`` is h0), which
        ``selective_scan_grad_cuda`` takes."""
        _check(x, dt, Bc, Cc, A, h0)
        lib = LIBRARY.load()
        B, S, Di = x.shape
        N = A.shape[1]
        y = torch.empty_like(x)
        hT = torch.empty_like(h0)
        hs = torch.empty((B, -(-S // CHUNK), Di, N), dtype=torch.float32,
                         device=x.device) if save_states else None
        dev, stream = _device_stream(x)
        rc = lib.selective_scan_fwd(
            x.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            A.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
            None if hs is None else hs.data_ptr(),
            int(x.dtype == torch.bfloat16), B, S, Di, N, dev, stream)
        _raise(lib, rc, "selective_scan kernel launch")
        self.launches += 1
        return (y, hT) if hs is None else (y, hT, hs)

    def occupancy(self, dtype: torch.dtype, state_dim: int,
                  device: int | None = None) -> dict:
        """The instance launched for x of ``dtype`` and N ``state_dim``:
        registers a thread and resident blocks and warps an SM
        (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
        return _occupancy(dtype, state_dim, False, device)


class SelectiveScanGradKernel:
    """Callable handle on K3-bwd: ``selective_scan_grad_cuda(x, dt, Bc,
    Cc, A, hs, dy, dhT)``."""

    def __init__(self):
        self.launches = 0          # calls (each two launches: the reverse
                                   # walk, the sums) since the last reset

    def __call__(self, x: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                 Cc: torch.Tensor, A: torch.Tensor, hs: torch.Tensor,
                 dy: torch.Tensor, dhT: torch.Tensor | None = None):
        """x, dt, Bc, Cc, A as the forward took them; hs its saved states;
        dy (B, S, Di) in x's dtype; dhT (B, Di, N) float32 or None (zero)
        -> (dx (B, S, Di) in x's dtype; ddt (B, S, Di), dB, dC (B, S, N),
        dA (Di, N), dh0 (B, Di, N) float32)."""
        _check_grad(x, dt, Bc, Cc, A, hs, dy, dhT)
        lib = LIBRARY.load()
        B, S, Di = x.shape
        N = A.shape[1]
        # the clusters of a batch row, as the source lays them out
        parts = lib.selective_scan_bwd_parts(Di, N)
        f32 = dict(dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x)
        ddt, dB, dC = (torch.empty_like(t) for t in (dt, Bc, Cc))
        dA = torch.empty_like(A)
        dh0 = torch.empty((B, Di, N), **f32)
        part = torch.empty((parts, B, S, 2 * N), **f32)
        dA_part = torch.empty((B, Di, N), **f32)
        dev, stream = _device_stream(x)
        rc = lib.selective_scan_bwd(
            x.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            A.data_ptr(), hs.data_ptr(), dy.data_ptr(),
            None if dhT is None else dhT.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
            dh0.data_ptr(), part.data_ptr(), dA_part.data_ptr(), parts,
            int(x.dtype == torch.bfloat16), B, S, Di, N, dev, stream)
        _raise(lib, rc, "selective_scan backward launch")
        self.launches += 1
        return dx, ddt, dB, dC, dA, dh0

    def occupancy(self, dtype: torch.dtype, state_dim: int,
                  device: int | None = None, shape=None) -> dict:
        """The reverse walk's instance for x of ``dtype`` and N
        ``state_dim``, as ``SelectiveScanKernel.occupancy``, with its
        cluster size at x's ``shape`` (B, S, Di) (at one block a row
        without it), the clusters resident at once
        (``cudaOccupancyMaxActiveClusters``) and, given ``shape``, the
        grid's clusters and waves (clusters over resident clusters)."""
        return _occupancy(dtype, state_dim, True, device, shape)


def _check(x, dt, Bc, Cc, A, h0=None) -> None:
    ts = (x, dt, Bc, Cc, A) + (() if h0 is None else (h0,))
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
            or A.shape != (Di, N)
            or (h0 is not None and h0.shape != (B, Di, N))):
        raise ValueError(
            f"shapes do not match: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"Bc {tuple(Bc.shape)}, Cc {tuple(Cc.shape)}, A "
            f"{tuple(A.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)}")
    if N not in STATE_DIMS:
        raise ValueError(f"state dim {N} is not one of {STATE_DIMS}")
    if B == 0 or S == 0 or Di == 0:
        raise ValueError(f"empty scan: x {tuple(x.shape)}")
    # the grid is B x (blocks a row of Di), one or more channels a block
    if B * Di >= 2 ** 31 or S >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the launch grid")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("inputs must be contiguous")


def _check_grad(x, dt, Bc, Cc, A, hs, dy, dhT) -> None:
    _check(x, dt, Bc, Cc, A)
    B, S, Di = x.shape
    N = A.shape[1]
    more = (hs, dy) + (() if dhT is None else (dhT,))
    if not all(t.is_cuda and t.device == x.device for t in more):
        raise ValueError("selective_scan_grad_cuda takes CUDA tensors on "
                         "x's device only")
    if hs.dtype != torch.float32 or hs.shape != (B, -(-S // CHUNK), Di, N):
        raise ValueError(f"hs must be float32 (B, ceil(S / {CHUNK}), Di, N),"
                         f" got {hs.dtype} {tuple(hs.shape)}")
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"dy must be x's dtype and shape, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    if dhT is not None and (dhT.dtype != torch.float32
                            or dhT.shape != (B, Di, N)):
        raise ValueError(f"dhT must be float32 (B, Di, N), got {dhT.dtype} "
                         f"{tuple(dhT.shape)}")
    if not all(t.is_contiguous() for t in more):
        raise ValueError("hs, dy and dhT must be contiguous")


selective_scan_cuda = SelectiveScanKernel()
selective_scan_grad_cuda = SelectiveScanGradKernel()
