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
scan (``repro/models/layers.py::flash_attention``) and has
no Pallas backward, so the backward here is that same differentiation:
it saves only q, k and v, and recomputes the scan (``models.layers.
chunk_attention``) one query chunk at a time under autograd, over the
keys that chunk may attend (``key_range``).  One chunk's ``(B, Hq,
q_chunk, keys)`` float32 scores are alive at a time, never ``S x T``.  The gradients of
grouped KV heads sum over their query heads, as the transpose of the
reference's ``kv_map`` expansion does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import fake
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_plain


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


_k2_trace = fake.define(
    "flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
    "int? window, float? scale) -> Tensor",
    lambda q, k, v, causal, window, scale: torch.empty_like(q), _k2_flops)


def _forward(q, k, v, causal, window, scale):
    if fake.traced(q, k, v):
        return _k2_trace(q, k, v, causal, window, scale)
    if q.is_cuda or k.is_cuda or v.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    scale=scale)
    if k.shape[1] == 0:
        raise ValueError("attention over zero keys")
    if k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads do not group over "
                         f"{k.shape[2]} KV heads")
    return attention_plain(q, k, v, causal=causal, window=window,
                           scale=scale)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_chunk, kv_chunk):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale, q_chunk, kv_chunk)
        return _forward(q, k, v, causal, window, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        # imported here: models.layers imports this module
        from repro_torch.models.layers import chunk_attention, key_range
        q, k, v = ctx.saved_tensors
        causal, window, scale, q_chunk, kv_chunk = ctx.args
        S, T = q.shape[1], k.shape[1]
        scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else scale
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for q0 in range(0, S, q_chunk):
            q1 = min(S, q0 + q_chunk)
            lo, hi = key_range(q0, q1, T, causal=causal, window=window,
                               kv_chunk=kv_chunk)
            with torch.enable_grad():
                qs = q[:, q0:q1].detach().requires_grad_(True)
                ks = k[:, lo:hi].detach().requires_grad_(True)
                vs = v[:, lo:hi].detach().requires_grad_(True)
                out = chunk_attention(
                    qs, ks, vs, q0, lo, causal=causal, window=window,
                    kv_chunk=kv_chunk, scale=scale).to(q.dtype)
                dqs, dks, dvs = torch.autograd.grad(
                    out, (qs, ks, vs), dout[:, q0:q1])
            dq[:, q0:q1] = dqs
            dk[:, lo:hi] += dks
            dv[:, lo:hi] += dvs
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, \
            None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None, q_chunk: int = 1024,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd), Hq % Hkv == 0 ->
    (B, S, Hq, hd) in q's dtype.  ``q_chunk``/``kv_chunk`` are the
    backward's blocks (the reference's ``LM(q_chunk=, kv_chunk=)``)."""
    if q_chunk <= 0 or kv_chunk <= 0:
        raise ValueError(f"chunks must be positive: {q_chunk}, {kv_chunk}")
    return _FlashAttention.apply(q, k, v, causal, window, scale, q_chunk,
                                 kv_chunk)
