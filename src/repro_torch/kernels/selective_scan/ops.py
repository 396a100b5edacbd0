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
its scan.  On fake or meta tensors (a dry-run's trace) K3 and K3-bwd are
replaced by their stand-ins (``kernels/fake``) in the same places: each
gives its outputs' shapes and dtypes and the kernel's FLOP count, and
computes nothing.  That is not a fallback: such a tensor holds no data
to compute on, and the time loop is never traced.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fake
from repro_torch.kernels.selective_scan.kernel import (
    selective_scan_cuda, selective_scan_grad_cuda)
from repro_torch.kernels.selective_scan.ref import (CHUNK,
                                                    selective_scan_plain)


def _k3_fake(x, dt, Bc, Cc, A, h0, save_states):
    B, S, Di = x.shape
    hs = ((B, -(-S // CHUNK), Di, A.shape[1]) if save_states else (0,))
    return (torch.empty_like(x), torch.empty_like(h0),
            x.new_empty(hs, dtype=torch.float32))


def _k3_grad_fake(x, dt, Bc, Cc, A, hs, dy, dhT):
    B, _, Di = x.shape
    return (torch.empty_like(x), *(torch.empty_like(t) for t in (dt, Bc, Cc)),
            torch.empty_like(A),
            x.new_empty((B, Di, A.shape[1]), dtype=torch.float32))


_k3_trace = fake.define(
    "selective_scan(Tensor x, Tensor dt, Tensor Bc, Tensor Cc, Tensor A, "
    "Tensor h0, bool save_states) -> (Tensor, Tensor, Tensor)", _k3_fake,
    # K3's bound's count: 7 N + 1 float32 operations a (b, t, channel)
    lambda x, dt, Bc, Cc, A, h0, save_states, out_shape=None:
        x[0] * x[1] * x[2] * (7 * A[1] + 1))
_k3_grad_trace = fake.define(
    "selective_scan_grad(Tensor x, Tensor dt, Tensor Bc, Tensor Cc, "
    "Tensor A, Tensor hs, Tensor dy, Tensor? dhT) -> (Tensor, Tensor, "
    "Tensor, Tensor, Tensor, Tensor)", _k3_grad_fake,
    # K3-bwd's: 18 a (b, t, channel, state)
    lambda x, dt, Bc, Cc, A, hs, dy, dhT, out_shape=None:
        18 * x[0] * x[1] * x[2] * A[1])


def _scan(ins, save_states=False):
    """K3, or its stand-in on a trace's tensors."""
    if fake.traced(*ins):
        out = _k3_trace(*ins, save_states)
        return out if save_states else out[:2]
    return selective_scan_cuda(*ins, save_states=save_states)


def _scan_grad(*args):
    """K3-bwd, or its stand-in on a trace's tensors."""
    if fake.traced(*args[:7]):
        return _k3_grad_trace(*args)
    return selective_scan_grad_cuda(*args)


class _SelectiveScan(torch.autograd.Function):
    """K3 with K3-bwd as its backward (CUDA tensors)."""

    @staticmethod
    def forward(ctx, x, dt, Bc, Cc, A, h0):
        ins = [t.contiguous() for t in (x, dt, Bc, Cc, A, h0)]
        y, hT, hs = _scan(ins, save_states=True)
        ctx.save_for_backward(*ins[:5], hs)
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, Bc, Cc, A, hs = ctx.saved_tensors
        # training never reads hT: its gradient is None, and K3-bwd then
        # starts the walk from zero
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = _scan_grad(
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
    if fake.traced(*ts) or any(t.is_cuda for t in ts):
        if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
            return _SelectiveScan.apply(*ts)
        return _scan(tuple(t.contiguous() for t in ts))
    return selective_scan_plain(x, dt, Bc, Cc, A, h0)
