"""Plain PyTorch version of the selective scan (K3): a time loop.

The recurrence of the reference's ``_ssm_recurrence``
(``repro/models/ssm.py``), which is a ``lax.scan`` there, written in its
order: at each step ``decay = exp(dt * A)``, then ``h = h * decay + (dt *
x) * B``, then ``y = sum_n h * C`` added over n from 0 upward, one add at
a time, as K3 adds it.  Everything is float32; ``y`` is rounded to x's
dtype once, at the end.  It is differentiable, so the CPU
path trains through it.
"""

from __future__ import annotations

import torch


def selective_scan_plain(x: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                         Cc: torch.Tensor, A: torch.Tensor,
                         h0: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """x: (B, S, Di) in the model's dtype; dt: (B, S, Di), Bc and Cc: (B,
    S, N), A: (Di, N) and h0: (B, Di, N), float32 (or all float64) ->
    (y (B, S, Di) in x's dtype, hT (B, Di, N))."""
    h = h0
    ys = []
    for t in range(x.shape[1]):
        dt_t = dt[:, t]                                        # (B, Di)
        decay = torch.exp(dt_t[..., None] * A)                 # (B, Di, N)
        u = dt_t * x[:, t].to(dt.dtype)
        h = h * decay + u[..., None] * Bc[:, t, None, :]
        hc = h * Cc[:, t, None, :]
        y = hc[..., 0]
        for n in range(1, hc.shape[-1]):       # n from 0 upward, as K3
            y = y + hc[..., n]
        ys.append(y)
    if not ys:
        return torch.empty_like(x), h
    return torch.stack(ys, dim=1).to(x.dtype), h
