"""Public op: flash attention (K2) over the ``(B, S, H, hd)`` layout.

The counterpart of ``repro/kernels/flash_attention/ops.py``.  k and v may
have fewer heads than q (grouped-query attention: query head ``h`` reads
KV head ``h // (Hq // Hkv)``), so a caller passes them unexpanded.  The
scale defaults to ``1 / sqrt(hd)``.  Nothing is padded: the CUDA kernel
takes head_dim 32, 64, 80, 128 and 256 as they are, and keys are masked
by their true length.

CUDA tensors go to the kernel, which launches or raises; CPU tensors go
to the plain version.  Neither falls back to the other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_plain


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd), Hq % Hkv == 0 ->
    (B, S, Hq, hd) in q's dtype."""
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
