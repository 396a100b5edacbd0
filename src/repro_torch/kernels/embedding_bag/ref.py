"""Plain PyTorch versions of the fused embedding bag (K1).

The counterparts of ``repro/kernels/embedding_bag/ref.py``.  Both loop
over the pooling slots instead of materialising the ``(N, P, D)`` gather
(forward) or the ``(N * P, D)`` repeat (backward): at a device's full
batch those intermediates are tens of GB and would not fit beside the
arena.  The forward adds the slots in order ``p = 0 .. P-1`` in float32,
the same order as the CUDA kernel, so the two agree bit for bit.  The
backward's kernel adds in another order (by row, in chunks: see
``kernel.backward_plan``); ``embedding_bag_grad_replay`` repeats that
order, so the tests can hold the kernel to it bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.kernel import CHUNK, backward_plan


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


def segment_sums_plain(src: torch.Tensor, ids, bounds: torch.Tensor):
    """The backward kernel's pass in plain torch: (S, D) float32 whose row
    s is ``src[ids[bounds[s]]] + ... + src[ids[bounds[s + 1] - 1]]`` (the
    rows ``bounds[s]`` .. themselves when ``ids`` is None), added in that
    order from +0, as the kernel adds them."""
    lengths = bounds[1:] - bounds[:-1]
    out = torch.zeros((lengths.numel(), src.shape[1]), dtype=torch.float32,
                      device=src.device)
    for k in range(int(lengths.max()) if lengths.numel() else 0):
        live = torch.nonzero(lengths > k).squeeze(1)
        at = bounds[live] + k
        out[live] += src[at if ids is None else ids[at].long()].float()
    return out


def embedding_bag_grad_replay(arena_shape, indices: torch.Tensor,
                              grad_out: torch.Tensor,
                              chunk: int = CHUNK) -> torch.Tensor:
    """The backward kernel's arithmetic in plain torch, in its order: its
    plan, then its two passes.  Equal to the kernel bit for bit."""
    plan = backward_plan(indices, chunk)
    g = torch.zeros(tuple(arena_shape), dtype=torch.float32,
                    device=grad_out.device)
    g[plan.run_rows] = segment_sums_plain(
        segment_sums_plain(grad_out, plan.bags, plan.chunk_bounds), None,
        plan.run_bounds)
    return g
