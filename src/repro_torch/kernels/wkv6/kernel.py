"""K4 and its backward on the GPU: ctypes binding of ``csrc/wkv6.cu``.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` at first use by
the port's shared build helper (``kernels/build.py``).  Nothing is
compiled or loaded when this module is imported.

``wkv6_cuda`` is the forward's wrapper: it checks its inputs, allocates
``y`` and ``sT`` (and, to train, the state at every chunk's start) with
``torch.empty``, launches on the current stream and adds one to
``wkv6_cuda.launches`` per launch.  ``wkv6_grad_cuda`` is the backward's
(K4-bwd: the reverse walk, a head a thread block cluster, and du's sum
over batch rows, one count a call), with its scratch allocated the same
way.  Both take CUDA tensors only; the plain versions for CPU tensors are
in ``ref.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.wkv6.ref import CHUNK

HEAD_DIM = 64                      # RWKV_HEAD_DIM: the source's block

_P, _I = ctypes.c_void_p, ctypes.c_int
_MISALIGNED = 716                  # cudaErrorMisalignedAddress
LIBRARY = CudaLibrary("wkv6", {
    "wkv6_fwd": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "wkv6_bwd": ([_P] * 15 + [_I] * 5 + [_P], _I),
    "wkv6_occupancy": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
    "wkv6_error_string": ([_I], ctypes.c_char_p),
})


def _device_stream(t: torch.Tensor) -> tuple[int, int]:
    dev = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(t.device).cuda_stream


def _raise(lib, rc: int, what: str) -> None:
    if rc == _MISALIGNED:
        raise ValueError("r, k, v and w (and the backward's dy and hs) must "
                         "be 16-byte aligned (the kernels stage them with "
                         "16-byte cp.async)")
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.wkv6_error_string(rc).decode()} ({rc})")


def _occupancy(dtype: torch.dtype, backward: bool, device: int | None,
               shape=None) -> dict:
    lib = LIBRARY.load()
    dev = torch.cuda.current_device() if device is None else device
    out = (_I * 8)()
    rc = lib.wkv6_occupancy(int(dtype == torch.bfloat16), int(backward), dev,
                            out)
    _raise(lib, rc, "wkv6 occupancy query")
    occ = {"registers": out[0], "blocks_per_sm": out[1],
           "threads": out[2], "warps_per_sm": out[1] * out[2] // 32,
           "smem_bytes": out[3], "local_bytes": out[7],
           ("lanes_per_row" if backward else "lanes_per_column"): out[4]}
    if backward:
        occ.update(cluster_size=out[5], active_clusters=out[6])
        if shape is not None:
            clusters = shape[0] * shape[2]
            occ.update(clusters=clusters, waves=clusters / out[6])
    return occ


class WKV6Kernel:
    """Callable handle on K4: ``wkv6_cuda(r, k, v, w, u, s0)``."""

    def __init__(self):
        self.launches = 0          # kernel launches since the last reset

    def __call__(self, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                 save_states: bool = False):
        """r, k, v: (B, S, H, 64) float32 or bfloat16; w: (B, S, H, 64),
        u: (H, 64), s0: (B, H, 64, 64), float32 -> (y (B, S, H, 64), sT
        (B, H, 64, 64)) float32, and with ``save_states`` also hs (B, H,
        ceil(S / CHUNK), 64, 64) float32, the state at every chunk's start
        (``hs[:, :, 0]`` is s0), which ``wkv6_grad_cuda`` takes."""
        _check(r, k, v, w, u, s0)
        lib = LIBRARY.load()
        B, S, H, _ = r.shape
        y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
        sT = torch.empty_like(s0)
        hs = torch.empty((B, H, -(-S // CHUNK), HEAD_DIM, HEAD_DIM),
                         dtype=torch.float32, device=r.device) \
            if save_states else None
        dev, stream = _device_stream(r)
        rc = lib.wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
            None if hs is None else hs.data_ptr(),
            int(r.dtype == torch.bfloat16), B, S, H, dev, stream)
        _raise(lib, rc, "wkv6 kernel launch")
        self.launches += 1
        return (y, sT) if hs is None else (y, sT, hs)

    def occupancy(self, dtype: torch.dtype, device: int | None = None) -> dict:
        """The instance launched for r, k, v of ``dtype``: registers a
        thread and resident blocks and warps an SM
        (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
        return _occupancy(dtype, False, device)


class WKV6GradKernel:
    """Callable handle on K4-bwd: ``wkv6_grad_cuda(r, k, v, w, u, hs, dy,
    dsT)``."""

    def __init__(self):
        self.launches = 0          # calls (each two launches: the reverse
                                   # walk, the sums) since the last reset

    def __call__(self, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, hs: torch.Tensor,
                 dy: torch.Tensor, dsT: torch.Tensor | None = None):
        """r, k, v, w, u as the forward took them; hs its saved states; dy
        (B, S, H, 64) float32; dsT (B, H, 64, 64) float32 or None (zero)
        -> (dr, dk, dv (B, S, H, 64) in r's dtype; dw (B, S, H, 64), du (H,
        64), ds0 (B, H, 64, 64) float32)."""
        _check_grad(r, k, v, w, u, hs, dy, dsT)
        lib = LIBRARY.load()
        B, S, H, hd = r.shape
        f32 = dict(dtype=torch.float32, device=r.device)
        dr, dk, dv = (torch.empty_like(r) for _ in range(3))
        dw = torch.empty(r.shape, **f32)
        du = torch.empty((H, hd), **f32)
        ds0 = torch.empty((B, H, hd, hd), **f32)
        du_part = torch.empty((B, H, hd), **f32)
        dev, stream = _device_stream(r)
        rc = lib.wkv6_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), hs.data_ptr(), dy.data_ptr(),
            None if dsT is None else dsT.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
            ds0.data_ptr(), du_part.data_ptr(),
            int(r.dtype == torch.bfloat16), B, S, H, dev, stream)
        _raise(lib, rc, "wkv6 backward launch")
        self.launches += 1
        return dr, dk, dv, dw, du, ds0

    def occupancy(self, dtype: torch.dtype, device: int | None = None,
                  shape=None) -> dict:
        """The reverse walk's instance for r, k, v of ``dtype``, as
        ``WKV6Kernel.occupancy``, with its cluster size (a head's 8
        blocks), the clusters resident at once
        (``cudaOccupancyMaxActiveClusters``) and, given r's ``shape`` (B,
        S, H, 64), the grid's clusters and waves (clusters over resident
        clusters)."""
        return _occupancy(dtype, True, device, shape)


def _check(r, k, v, w, u, s0=None) -> None:
    ts = (r, k, v, w, u) + (() if s0 is None else (s0,))
    if not all(t.is_cuda for t in ts):
        raise ValueError("wkv6_cuda takes CUDA tensors only")
    if any(t.device != r.device for t in ts):
        raise ValueError("inputs on more than one device")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"r must be float32 or bfloat16, got {r.dtype}")
    if not (k.dtype == v.dtype == r.dtype):
        raise TypeError(f"r, k, v dtypes differ: {r.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if any(t.dtype != torch.float32 for t in ts[3:]):
        raise TypeError("w, u and s0 must be float32")
    if r.dim() != 4 or r.shape[3] != HEAD_DIM:
        raise ValueError(f"r must be (B, S, H, {HEAD_DIM}), got "
                         f"{tuple(r.shape)}")
    B, S, H, hd = r.shape
    if (k.shape != r.shape or v.shape != r.shape or w.shape != r.shape
            or u.shape != (H, hd)
            or (s0 is not None and s0.shape != (B, H, hd, hd))):
        raise ValueError(
            f"shapes do not match: r {tuple(r.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)}, "
            f"s0 {None if s0 is None else tuple(s0.shape)}")
    if B * H == 0 or S == 0:
        raise ValueError(f"empty scan: r {tuple(r.shape)}")
    # the grid is B x H x (blocks a head), at most one a column
    if B * H * hd >= 2 ** 31 or S >= 2 ** 31:
        raise ValueError(f"shape {tuple(r.shape)} exceeds the launch grid")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("inputs must be contiguous")


def _check_grad(r, k, v, w, u, hs, dy, dsT) -> None:
    _check(r, k, v, w, u)
    B, S, H, hd = r.shape
    more = (hs, dy) + (() if dsT is None else (dsT,))
    if not all(t.is_cuda and t.device == r.device for t in more):
        raise ValueError("wkv6_grad_cuda takes CUDA tensors on r's "
                         "device only")
    if hs.dtype != torch.float32 or hs.shape != (B, H, -(-S // CHUNK),
                                                 hd, hd):
        raise ValueError(f"hs must be float32 (B, H, ceil(S / {CHUNK}), "
                         f"64, 64), got {hs.dtype} {tuple(hs.shape)}")
    if dy.dtype != torch.float32 or dy.shape != r.shape:
        raise ValueError(f"dy must be float32 of r's shape, got "
                         f"{dy.dtype} {tuple(dy.shape)}")
    if dsT is not None and (dsT.dtype != torch.float32
                            or dsT.shape != (B, H, hd, hd)):
        raise ValueError(f"dsT must be float32 (B, H, 64, 64), got "
                         f"{dsT.dtype} {tuple(dsT.shape)}")
    if not all(t.is_contiguous() for t in more):
        raise ValueError("hs, dy and dsT must be contiguous")


wkv6_cuda = WKV6Kernel()
wkv6_grad_cuda = WKV6GradKernel()
