"""Public op: the RWKV-6 WKV scan (K4) of rwkv6-1.6b's time mixing.

The reference has no Pallas kernel here: its scan is a ``lax.scan`` over
time inside ``rwkv_time_mix`` (``repro/models/ssm.py``).  In eager torch
that loop would launch a few kernels per token and layer, so the port
runs it as one hand-written kernel on the card (K4) and as the plain
time loop (``ref.py``) on the CPU; neither falls back to the other.

K4 has no backward yet: on a CUDA tensor that needs a gradient the op
raises, so a train step of the RWKV block on the card fails loudly.  On
the CPU the plain loop is ordinary differentiable torch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.wkv6.kernel import wkv6_cuda
from repro_torch.kernels.wkv6.ref import wkv6_plain

NO_BACKWARD = ("K4 (the RWKV-6 WKV scan) has no backward kernel yet: "
               "training the hybrid SSM and RWKV blocks on the card is "
               "ROADMAP item 8's next entry (their scans' backward "
               "kernels, then make_train_step on the card)")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, copied where it starts off a 16-byte boundary of
    its storage: K4 stages r, k, v and w 16 bytes at a time.  The
    allocators' blocks start on wider boundaries, and the kernel refuses
    any other start."""
    t = t.contiguous()
    return t if t.storage_offset() * t.element_size() % 16 == 0 \
        else t.clone()


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
            raise NotImplementedError(NO_BACKWARD)
        return wkv6_cuda(*(_aligned(t) for t in (r, k, v, w)),
                         u.float().contiguous(), s0.contiguous())
    return wkv6_plain(r, k, v, w, u, s0)
