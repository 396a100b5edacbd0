"""Public op: the RWKV-6 WKV scan (K4) of rwkv6-1.6b's time mixing.

The reference has no Pallas kernel here: its scan is a ``lax.scan`` over
time inside ``rwkv_time_mix`` (``repro/models/ssm.py``), differentiated
by JAX's autodiff.  In eager torch that loop would launch a few kernels
per token and layer, so the port runs it as one hand-written kernel on
the card (K4) and as the plain time loop (``ref.py``) on the CPU; neither
falls back to the other.

On a CUDA input that needs a gradient the op is ``_WKV6``: K4's forward
also saves the state at every chunk's start, and the backward is K4-bwd,
which recomputes each chunk from its saved state and walks it back.  On
the CPU the plain loop is ordinary differentiable torch, the reference's
way of differentiating its scan.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.wkv6.kernel import wkv6_cuda, wkv6_grad_cuda
from repro_torch.kernels.wkv6.ref import wkv6_plain


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, copied where it starts off a 16-byte boundary of
    its storage: K4 stages r, k, v and w 16 bytes at a time.  The
    allocators' blocks start on wider boundaries, and the kernel refuses
    any other start."""
    t = t.contiguous()
    return t if t.storage_offset() * t.element_size() % 16 == 0 \
        else t.clone()


class _WKV6(torch.autograd.Function):
    """K4 with K4-bwd as its backward (CUDA tensors)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        rkvw = [_aligned(t) for t in (r, k, v, w)]
        uf = u.float().contiguous()
        y, sT, hs = wkv6_cuda(*rkvw, uf, s0.contiguous(), save_states=True)
        ctx.save_for_backward(*rkvw, uf, hs)
        ctx.u_dtype = u.dtype
        ctx.set_materialize_grads(False)
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        r, k, v, w, uf, hs = ctx.saved_tensors
        # training never reads sT: its gradient is None, and K4-bwd then
        # starts the walk from zero
        dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device) \
            if dy is None else _aligned(dy)
        dr, dk, dv, dw, du, ds0 = wkv6_grad_cuda(
            r, k, v, w, uf, hs, dy,
            None if dsT is None else dsT.contiguous())
        # u entered as u.float(): its gradient is cast back once
        grads = (dr, dk, dv, dw, du.to(ctx.u_dtype), ds0)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """r, k, v: (B, S, H, 64) in the model's dtype; w: (B, S, H, 64)
    float32; u: (H, 64), the per-head bonus (any float dtype, widened to
    float32); s0: (B, H, 64, 64) float32 -> (y (B, S, H, 64), sT (B, H,
    64, 64)), float32."""
    ts = (r, k, v, w, u, s0)
    if any(t.is_cuda for t in ts):
        if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
            return _WKV6.apply(*ts)
        return wkv6_cuda(*(_aligned(t) for t in (r, k, v, w)),
                         u.float().contiguous(), s0.contiguous())
    return wkv6_plain(r, k, v, w, u, s0)
