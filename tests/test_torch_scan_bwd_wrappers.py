"""K3-bwd's and K4-bwd's wrappers on the CPU: the CUDA wrappers refuse
CPU tensors (no fallback to the plain backwards, nothing counted)."""

import pytest
import torch

from repro_torch.kernels.selective_scan import kernel as SS
from repro_torch.kernels.wkv6 import kernel as WK


def _scan_args(B=2, S=5, Di=24, N=16):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((B, S, Di), generator=g)
    dt = torch.rand((B, S, Di), generator=g)
    Bc, Cc = (torch.randn((B, S, N), generator=g) for _ in range(2))
    A = -torch.ones((Di, N))
    hs = torch.zeros((B, 1, Di, N))
    return x, dt, Bc, Cc, A, hs, torch.randn_like(x)


def _wkv_args(B=2, S=5, H=3):
    g = torch.Generator().manual_seed(0)
    r, k, v, w = (torch.rand((B, S, H, 64), generator=g) for _ in range(4))
    u = torch.randn((H, 64), generator=g)
    hs = torch.zeros((B, H, 1, 64, 64))
    return r, k, v, w, u, hs, torch.randn_like(r)


@pytest.mark.parametrize("which", ["selective_scan", "wkv6"])
def test_grad_wrappers_refuse_cpu_tensors(which):
    kern, args = ((SS.selective_scan_grad_cuda, _scan_args())
                  if which == "selective_scan"
                  else (WK.wkv6_grad_cuda, _wkv_args()))
    n0 = kern.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kern(*args)
    assert kern.launches == n0
