"""Plain PyTorch version of the RWKV-6 WKV scan (K4): a time loop.

The scan inside the reference's ``rwkv_time_mix`` (``repro/models/
ssm.py``), which is a ``lax.scan`` there, written in its order and
grouping: at each step ``kv = k^T v``, then ``y = r (s + u * kv)``, then
``s = w * s + kv``, all in float32.  It is differentiable, so the CPU
path trains through it.
"""

from __future__ import annotations

import torch


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B, S, H, hd) in the model's dtype; w: (B, S, H, hd)
    float32; u: (H, hd); s0: (B, H, hd, hd) float32 (or all float64) ->
    (y (B, S, H, hd), sT (B, H, hd, hd)) in s0's dtype."""
    dt = s0.dtype
    s = s0
    bonus = u.to(dt)[None, :, :, None]                    # (1, H, hd, 1)
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t].to(dt)[..., :, None] * v[:, t].to(dt)[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].to(dt),
                               s + bonus * kv))
        s = w[:, t].to(dt)[..., None] * s + kv
    if not ys:
        return torch.zeros(r.shape, dtype=dt, device=r.device), s
    return torch.stack(ys, dim=1), s
