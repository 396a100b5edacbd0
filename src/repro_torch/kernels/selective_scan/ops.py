"""Public op: the selective scan (K3) of hymba's SSM heads.

The reference has no Pallas kernel here: its ``_ssm_recurrence``
(``repro/models/ssm.py``) is a ``lax.scan`` over time.  In eager torch
that loop would launch a few kernels per token and layer, so the port
runs it as one hand-written kernel on the card (K3) and as the plain
time loop (``ref.py``) on the CPU; neither falls back to the other.

K3 has no backward yet: on a CUDA tensor that needs a gradient the op
raises, so a train step of the hybrid block on the card fails loudly.
On the CPU the plain loop is ordinary differentiable torch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.selective_scan.kernel import selective_scan_cuda
from repro_torch.kernels.selective_scan.ref import selective_scan_plain

NO_BACKWARD = ("K3 (the selective scan) has no backward kernel yet: "
               "training the hybrid SSM and RWKV blocks on the card is "
               "ROADMAP item 8's next entry (their scans' backward "
               "kernels, then make_train_step on the card)")


def selective_scan(x: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor, A: torch.Tensor,
                   h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, Di) in the model's dtype; dt: (B, S, Di), Bc and Cc: (B,
    S, N), A: (Di, N), h0: (B, Di, N), float32 -> (y (B, S, Di) in x's
    dtype, hT (B, Di, N) float32)."""
    ts = (x, dt, Bc, Cc, A, h0)
    if any(t.is_cuda for t in ts):
        if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
            raise NotImplementedError(NO_BACKWARD)
        return selective_scan_cuda(*(t.contiguous() for t in ts))
    return selective_scan_plain(x, dt, Bc, Cc, A, h0)
