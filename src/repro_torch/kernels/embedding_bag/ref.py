"""Plain PyTorch versions of the fused embedding bag (K1).

The counterparts of ``repro/kernels/embedding_bag/ref.py``.  Both loop
over the pooling slots instead of materialising the ``(N, P, D)`` gather
(forward) or the ``(N * P, D)`` repeat (backward): at a device's full
batch those intermediates are tens of GB and would not fit beside the
arena.  The forward adds the slots in order ``p = 0 .. P-1`` in float32,
the same order as the CUDA kernel, so the two agree bit for bit.
"""

from __future__ import annotations

import torch


def embedding_bag_plain(arena: torch.Tensor,
                        indices: torch.Tensor) -> torch.Tensor:
    """arena: (R, D), indices: (N, P) arena rows (0 = zero row) -> (N, D)
    float32 pooled sums."""
    n, p = indices.shape
    out = torch.zeros((n, arena.shape[1]), dtype=torch.float32,
                      device=arena.device)
    for j in range(p):
        out += arena[indices[:, j]].float()
    return out


def embedding_bag_grad_plain(arena_shape, indices: torch.Tensor,
                             grad_out: torch.Tensor) -> torch.Tensor:
    """Row-wise scatter-add gradient w.r.t. the arena, float32, with the
    zero row's gradient zeroed."""
    g = torch.zeros(tuple(arena_shape), dtype=torch.float32,
                    device=grad_out.device)
    src = grad_out.float()
    for j in range(indices.shape[1]):
        g.index_add_(0, indices[:, j], src)
    g[0] = 0.0                                       # zero row stays zero
    return g
