"""Plain PyTorch version of flash attention (K2): materialized softmax.

The counterpart of ``repro/kernels/flash_attention/ref.py``, in the
``(B, S, H, hd)`` layout of the port's op, with grouped KV heads (query
head ``h`` reads KV head ``h // (Hq // Hkv)``) and an explicit ``scale``.
Keys are masked by their true length ``T``.  It loops over the batch so
that one ``(Hq, S, T)`` score matrix is alive at a time.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_mask(S: int, T: int, *, causal: bool, window: int | None,
                   device=None) -> torch.Tensor:
    """(S, T) bool, True where query ``q`` may attend key ``k``."""
    qp = torch.arange(S, device=device)[:, None]
    kp = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    return mask


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd) with Hq % Hkv == 0 ->
    (B, S, Hq, hd) in q's dtype, computed in float32."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    mask = attention_mask(S, T, causal=causal, window=window,
                          device=q.device)
    out = torch.empty_like(q)
    for b in range(B):
        qb = q[b].float().transpose(0, 1)                        # (Hq, S, hd)
        kb = k[b].float().repeat_interleave(Hq // Hkv, dim=1).transpose(0, 1)
        vb = v[b].float().repeat_interleave(Hq // Hkv, dim=1).transpose(0, 1)
        s = torch.matmul(qb, kb.transpose(1, 2)) * scale         # (Hq, S, T)
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out[b] = torch.matmul(p, vb).transpose(0, 1).to(q.dtype)
    return out
