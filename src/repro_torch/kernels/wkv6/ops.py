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

from repro_torch.kernels import fake
from repro_torch.kernels.wkv6.kernel import wkv6_cuda, wkv6_grad_cuda
from repro_torch.kernels.wkv6.ref import CHUNK, wkv6_plain


def _k4_fake(r, k, v, w, u, s0, save_states):
    B, S, H, hd = r.shape
    hs = (B, H, -(-S // CHUNK), hd, hd) if save_states else (0,)
    f32 = dict(dtype=torch.float32)
    return (r.new_empty(r.shape, **f32), torch.empty_like(s0),
            r.new_empty(hs, **f32))


def _k4_grad_fake(r, k, v, w, u, hs, dy, dsT):
    B, S, H, hd = r.shape
    f32 = dict(dtype=torch.float32)
    return (*(torch.empty_like(r) for _ in range(3)),
            r.new_empty(r.shape, **f32), r.new_empty((H, hd), **f32),
            r.new_empty((B, H, hd, hd), **f32))


_k4_trace = fake.define(
    "wkv6(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor s0, "
    "bool save_states) -> (Tensor, Tensor, Tensor)", _k4_fake,
    # K4's bound's count: 7 float32 operations a state element and step
    lambda r, *_, out_shape=None: 7 * r[0] * r[1] * r[2] * r[3] * r[3])
_k4_grad_trace = fake.define(
    "wkv6_grad(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
    "Tensor hs, Tensor dy, Tensor? dsT) -> (Tensor, Tensor, Tensor, "
    "Tensor, Tensor, Tensor)", _k4_grad_fake,
    # K4-bwd's: 14
    lambda r, *_, out_shape=None: 14 * r[0] * r[1] * r[2] * r[3] * r[3])


def _wkv(ins, save_states=False):
    """K4, or its stand-in on a trace's tensors."""
    if fake.traced(*ins):
        out = _k4_trace(*ins, save_states)
        return out if save_states else out[:2]
    return wkv6_cuda(*ins, save_states=save_states)


def _wkv_grad(*args):
    """K4-bwd, or its stand-in on a trace's tensors."""
    if fake.traced(*args[:7]):
        return _k4_grad_trace(*args)
    return wkv6_grad_cuda(*args)


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
        y, sT, hs = _wkv((*rkvw, uf, s0.contiguous()), save_states=True)
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
        dr, dk, dv, dw, du, ds0 = _wkv_grad(
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
    if fake.traced(*ts) or any(t.is_cuda for t in ts):
        if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
            return _WKV6.apply(*ts)
        return _wkv((*(_aligned(t) for t in (r, k, v, w)),
                     u.float().contiguous(), s0.contiguous()))
    return wkv6_plain(r, k, v, w, u, s0)
