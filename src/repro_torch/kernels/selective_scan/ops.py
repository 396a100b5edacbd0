"""Public op: the selective scan (K3) of hymba's SSM heads.

The reference has no Pallas kernel here: its ``_ssm_recurrence``
(``repro/models/ssm.py``) is a ``lax.scan`` over time, differentiated by
JAX's autodiff.  In eager torch that loop would launch a few kernels per
token and layer, so the port runs it as one hand-written kernel on the
card (K3) and as the plain time loop (``ref.py``) on the CPU; neither
falls back to the other.

On a CUDA input that needs a gradient the op is ``_SelectiveScan``: K3's
forward also saves the state at every chunk's start, and the backward is
K3-bwd, which recomputes each chunk from its saved state and walks it
back (autograd through the per-token loop would keep every step's state
and launch several kernels a token).  On the CPU the plain loop is
ordinary differentiable torch, the reference's way of differentiating
its scan.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.selective_scan.kernel import (
    selective_scan_cuda, selective_scan_grad_cuda)
from repro_torch.kernels.selective_scan.ref import selective_scan_plain


class _SelectiveScan(torch.autograd.Function):
    """K3 with K3-bwd as its backward (CUDA tensors)."""

    @staticmethod
    def forward(ctx, x, dt, Bc, Cc, A, h0):
        ins = [t.contiguous() for t in (x, dt, Bc, Cc, A, h0)]
        y, hT, hs = selective_scan_cuda(*ins, save_states=True)
        ctx.save_for_backward(*ins[:5], hs)
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, Bc, Cc, A, hs = ctx.saved_tensors
        # training never reads hT: its gradient is None, and K3-bwd then
        # starts the walk from zero
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = selective_scan_grad_cuda(
            x, dt, Bc, Cc, A, hs, dy,
            None if dhT is None else dhT.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def selective_scan(x: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor, A: torch.Tensor,
                   h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, Di) in the model's dtype; dt: (B, S, Di), Bc and Cc: (B,
    S, N), A: (Di, N), h0: (B, Di, N), float32 -> (y (B, S, Di) in x's
    dtype, hT (B, Di, N) float32)."""
    ts = (x, dt, Bc, Cc, A, h0)
    if any(t.is_cuda for t in ts):
        if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
            return _SelectiveScan.apply(*ts)
        return selective_scan_cuda(*(t.contiguous() for t in ts))
    return selective_scan_plain(x, dt, Bc, Cc, A, h0)
