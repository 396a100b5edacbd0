"""Public op: fused multi-table embedding bag (K1) with its gradient.

The counterpart of ``repro/kernels/embedding_bag/ops.py``.
``fused_embedding_lookup`` packs per-table indices against a zero-row
arena (``build_arena``: tables stacked, feature dim padded to 128) and
runs ONE fused lookup for every (table, sample) bag.  ``embedding_bag``
is a ``torch.autograd.Function`` whose forward and backward each launch
their CUDA kernel for CUDA tensors and run the plain version for CPU
tensors.  The backward computes what the JAX op's plain jnp backward
computes (``embedding_bag_grad_ref``): the row-wise scatter-add with row
0's gradient zeroed; its plain version is the ``index_add_`` loop.
On fake or meta tensors (a dry-run's trace) both go to their kernel's
stand-in (``kernels/fake``): the output's shape and dtype, the kernel's
FLOP count, nothing computed and nothing launched.  That is not a
fallback: such a tensor holds no data to compute on.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch.kernels import fake
from repro_torch.kernels.embedding_bag.kernel import (embedding_bag_cuda,
                                                     embedding_bag_grad_cuda)
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_grad_plain,
                                                   embedding_bag_plain)


def _bag_flops(arena, indices, out_shape=None):
    """K1's bound's count: one add a slot and column (every slot, as a
    trace has no indices to skip the padded ones by)."""
    return indices[0] * indices[1] * arena[1]


def _bag_grad_flops(indices, grad_out, arena_shape, out_shape=None):
    """K1-bwd's: one add a slot and column of the gradient."""
    return indices[0] * indices[1] * grad_out[1]


_k1_trace = fake.define(
    "embedding_bag(Tensor arena, Tensor indices) -> Tensor",
    lambda arena, indices: arena.new_empty(
        (indices.shape[0], arena.shape[1]), dtype=torch.float32),
    _bag_flops)
_k1_grad_trace = fake.define(
    "embedding_bag_grad(Tensor indices, Tensor grad_out, int[] arena_shape)"
    " -> Tensor",
    lambda indices, grad_out, arena_shape: grad_out.new_empty(
        arena_shape, dtype=torch.float32),
    _bag_grad_flops)


def pad_dim(d: int) -> int:
    return int(np.ceil(d / 128) * 128)


def build_arena(tables: list[torch.Tensor]):
    """Stack tables into a zero-row arena. Returns (arena, base_rows)."""
    dp = pad_dim(max(t.shape[1] for t in tables))
    parts = [torch.zeros((1, dp), dtype=tables[0].dtype,
                         device=tables[0].device)]
    bases = []
    row = 1
    for t in tables:
        bases.append(row)
        parts.append(Fn.pad(t, (0, dp - t.shape[1])))
        row += t.shape[0]
    return torch.cat(parts, dim=0), np.asarray(bases)


def rebase_indices(indices: torch.Tensor,
                   base_rows: np.ndarray) -> torch.Tensor:
    """indices: (T, B, P) per-table rows, -1 = padded slot -> arena rows
    (same dtype as ``indices``)."""
    base = torch.as_tensor(np.asarray(base_rows), dtype=indices.dtype,
                           device=indices.device)[:, None, None]
    return torch.where(indices >= 0, indices + base,
                       torch.zeros((), dtype=indices.dtype,
                                   device=indices.device))


class _EmbeddingBag(torch.autograd.Function):

    @staticmethod
    def forward(ctx, arena, indices):
        ctx.arena_shape = tuple(arena.shape)
        ctx.save_for_backward(indices)
        if fake.traced(arena, indices):
            return _k1_trace(arena, indices)
        if arena.is_cuda:
            return embedding_bag_cuda(arena, indices)
        return embedding_bag_plain(arena, indices)

    @staticmethod
    def backward(ctx, grad_out):
        (indices,) = ctx.saved_tensors
        return embedding_bag_grad(ctx.arena_shape, indices, grad_out), None


def embedding_bag(arena: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """arena: (R, D128); indices: (N, P) int32 arena rows -> pooled sums
    (N, D128) float32."""
    return _EmbeddingBag.apply(arena, indices)


def embedding_bag_grad(arena_shape, indices: torch.Tensor,
                       grad_out: torch.Tensor) -> torch.Tensor:
    """The arena's gradient (R, D) float32 with row 0 zero: the backward
    kernel for CUDA tensors, the plain version for CPU tensors, the
    stand-in on fake or meta ones."""
    if fake.traced(indices, grad_out):
        return _k1_grad_trace(indices, grad_out, list(arena_shape))
    if grad_out.is_cuda:
        return embedding_bag_grad_cuda(arena_shape, indices,
                                       grad_out.contiguous())
    return embedding_bag_grad_plain(arena_shape, indices, grad_out)


def fused_embedding_lookup(arena, base_rows, indices):
    """Multi-table fused lookup.

    indices: (T, B, P) per-table row ids (-1 padding).
    Returns (T, B, D128) pooled embeddings.
    """
    T, B, P = indices.shape
    flat = rebase_indices(indices, base_rows).reshape(T * B, P)
    return embedding_bag(arena, flat).reshape(T, B, -1)


def fused_embedding_lookup_ref(arena, base_rows, indices):
    T, B, P = indices.shape
    flat = rebase_indices(indices, base_rows).reshape(T * B, P)
    return embedding_bag_plain(arena, flat).reshape(T, B, -1)
