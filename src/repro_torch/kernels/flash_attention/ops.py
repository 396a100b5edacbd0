"""Public op: flash attention (K2) over the ``(B, S, H, hd)`` layout.

The counterpart of ``repro/kernels/flash_attention/ops.py``.  k and v may
have fewer heads than q (grouped-query attention: query head ``h`` reads
KV head ``h // (Hq // Hkv)``), so a caller passes them unexpanded.  The
scale defaults to ``1 / sqrt(hd)``.  Nothing is padded: the CUDA kernel
takes head_dim 32, 64, 80, 128 and 256 as they are, and keys are masked
by their true length.

The forward goes to the kernel for CUDA tensors, which launches or
raises, and to the plain version for CPU tensors; neither falls back to
the other.  On fake or meta tensors (a dry-run's trace) it goes to the
kernel's stand-in (``kernels/fake``), which gives the output's shape and
dtype, counts the kernel's FLOPs and computes nothing; that is not a
fallback either, since such a tensor holds no data to compute on.  The
op is differentiable.  The reference trains through its blockwise jnp
scan (``repro/models/layers.py::flash_attention``) and has no Pallas
backward; here the backward is FA2's, from what the forward saves: q, k,
v, the output and each row's log-sum-exp (which the forward computes
only where autograd records the op, so serving stores none).  It goes
the forward's way: K2-bwd (``flash_attention_bwd_cuda``) on CUDA
tensors, its plain version (``ref.attention_bwd_plain``, one query chunk
at a time) on CPU tensors, its stand-in on fake ones.  The gradients of
grouped KV heads sum over their query heads, as the transpose of the
reference's ``kv_map`` expansion does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import fake
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda, flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_plain,
                                                     attention_plain)


def attended_pairs(S: int, T: int, *, causal: bool,
                   window: int | None) -> int:
    """The (query, key) pairs that ``attention_mask(S, T, ...)`` lets
    through, counted without building it."""
    i = np.arange(S, dtype=np.int64)
    hi = np.minimum(i, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def _k2_flops(q, k, v, causal, window, scale, out_shape=None):
    """K2's bound's count: 4 hd a (query, key) pair and query head."""
    B, S, Hq, hd = q
    return 4 * hd * B * Hq * attended_pairs(S, k[1], causal=causal,
                                            window=window)


def _k2_bwd_flops(q, k, v, out, dout, lse, causal, window, scale,
                  out_shape=None):
    """K2-bwd's bound's count: 10 hd a (query, key) pair and query head
    (S and dP recomputed, dV, dQ, dK)."""
    B, S, Hq, hd = q
    return 10 * hd * B * Hq * attended_pairs(S, k[1], causal=causal,
                                             window=window)


_k2_trace = fake.define(
    "flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
    "int? window, float? scale) -> Tensor",
    lambda q, k, v, causal, window, scale: torch.empty_like(q), _k2_flops)
_k2_lse_trace = fake.define(
    "flash_attention_fwd_lse(Tensor q, Tensor k, Tensor v, bool causal, "
    "int? window, float? scale) -> (Tensor, Tensor)",
    lambda q, k, v, causal, window, scale: (
        torch.empty_like(q), q.new_empty((q.shape[0], q.shape[2],
                                          q.shape[1]), dtype=torch.float32)),
    _k2_flops)
_k2_bwd_trace = fake.define(
    "flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, "
    "Tensor dout, Tensor lse, bool causal, int? window, float? scale) -> "
    "(Tensor, Tensor, Tensor)",
    lambda q, k, v, out, dout, lse, causal, window, scale: (
        torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)),
    _k2_bwd_flops)


def _forward(q, k, v, causal, window, scale, lse=False):
    """The output, and with ``lse`` each row's log-sum-exp (B, Hq, S)."""
    if fake.traced(q, k, v):
        trace = _k2_lse_trace if lse else _k2_trace
        return trace(q, k, v, causal, window, scale)
    if q.is_cuda or k.is_cuda or v.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    scale=scale, lse=lse)
    if k.shape[1] == 0:
        raise ValueError("attention over zero keys")
    if k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads do not group over "
                         f"{k.shape[2]} KV heads")
    return attention_plain(q, k, v, causal=causal, window=window,
                           scale=scale, lse=lse)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_chunk, kv_chunk):
        out, lse = _forward(q, k, v, causal, window, scale, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale, q_chunk)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale, q_chunk = ctx.args
        dout = dout.contiguous()
        if fake.traced(q, k, v, dout):
            grads = _k2_bwd_trace(q, k, v, out, dout, lse, causal, window,
                                  scale)
        elif q.is_cuda:
            grads = flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                             causal=causal, window=window,
                                             scale=scale)
        else:
            grads = attention_bwd_plain(q, k, v, out, dout, lse,
                                        causal=causal, window=window,
                                        scale=scale, q_chunk=q_chunk)
        return (*grads, None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None, q_chunk: int = 1024,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd), Hq % Hkv == 0 ->
    (B, S, Hq, hd) in q's dtype.  ``q_chunk`` is the plain backward's
    block of queries; ``kv_chunk`` is taken as the reference's
    ``LM(q_chunk=, kv_chunk=)`` has it, and neither backward reads it
    (the kernel tiles the keys itself, the plain version takes every key
    a query chunk may attend)."""
    if q_chunk <= 0 or kv_chunk <= 0:
        raise ValueError(f"chunks must be positive: {q_chunk}, {kv_chunk}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale, q_chunk,
                                     kv_chunk)
    return _forward(q, k, v, causal, window, scale)
