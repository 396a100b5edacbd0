"""Table-wise model-parallel embedding bags with all-to-all redistribution.

The counterpart of ``repro/embedding/sharded.py`` (the DLRM distributed
embedding pattern of paper App. A.1): tables live on model-group shards,
grouped by a ``PlacementPlan`` (DreamShard's placement); each shard runs
one fused lookup (K1) for its tables over its data-parallel batch slice,
and an all-to-all over the model group trades batch rows for table
groups, so the data-parallel dense net sees every table's pooled
embedding for its rows -- the paper's forward all-to-all.  Its transpose
in the backward pass is the backward all-to-all, and K1's backward gives
each shard's arena gradient.

A column-sharded plan (``build_plan(sharding=)``) runs the same lookup:
a slot holds one column shard of its owner in lanes ``[0, width)`` of its
rows, K1 pools every lane, and ``combine_shard_outputs`` scatters each
slot's live lanes into its owner's ``[col_start, col_end)``; the gradient
flows back through that scatter to K1's backward per shard.

Layout: one arena per shard, ``(plan.shard_rows[s], D)`` with row 0 the
zero row -- what each rank of the distributed step holds -- not the
reference's ``(S, rows_max, D)`` stack, which pads every shard to the
fullest one (a ``shard_map`` artifact).

Reference quirk, not copied: the reference draws row 0 of each shard from
the normal and its autodiff lookup trains it by the padded slots.  Here
``init_arenas`` zeroes row 0 and K1's backward leaves its gradient 0 (the
op contract of ``repro/kernels/embedding_bag/ref.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.embedding.plan import PlacementPlan
from repro_torch.kernels.embedding_bag.ops import embedding_bag


def init_arenas(plan: PlacementPlan, *, generator: torch.Generator | None
                = None, device=None, dtype=torch.float32,
                scale: float = 0.01, shards=None) -> list[torch.Tensor]:
    """One ``(shard_rows[s], dim)`` arena per shard (each of ``shards``
    only, where given), normal times ``scale``, with row 0 zero.
    ``generator`` must live on ``device``."""
    arenas = []
    for rows in (plan.shard_rows if shards is None
                 else plan.shard_rows[list(shards)]):
        a = torch.randn((int(rows), plan.dim), generator=generator,
                        device=device, dtype=dtype)
        a.mul_(scale)
        a[0] = 0.0
        arenas.append(a)
    return arenas


def group_indices(plan: PlacementPlan, indices):
    """(B, M, P) per-table rows (-1 pad) -> (B, S*K, P) grouped by shard.

    numpy in, numpy out (bit for bit the reference's); a torch tensor is
    grouped on its own device."""
    order = plan.grouped_index_order()
    B, _, Pp = indices.shape
    live = order >= 0
    if isinstance(indices, np.ndarray):
        out = np.full((B, order.shape[0], Pp), -1, indices.dtype)
        out[:, live] = indices[:, order[live]]
        return out
    out = indices.new_full((B, order.shape[0], Pp), -1)
    slots = torch.as_tensor(np.flatnonzero(live), device=indices.device)
    tables = torch.as_tensor(order[live], device=indices.device)
    out[:, slots] = indices[:, tables]
    return out


def shard_rows_of(bases, idx):
    """bases: (K,); idx: (B, K, P) one shard's slots (-1 pad) -> (B*K, P)
    rows of its arena, padding at row 0: the indices K1 is given."""
    B, K, Pp = idx.shape
    bases = torch.as_tensor(bases, dtype=idx.dtype, device=idx.device)
    return torch.where(idx >= 0, idx + bases[None, :, None],
                       0).reshape(B * K, Pp)


def _local_lookup(arena, bases, idx):
    """arena: (R, D); bases: (K,); idx: (B, K, P) -> (B, K, D) with K1."""
    B, K, _ = idx.shape
    return embedding_bag(arena, shard_rows_of(bases, idx)).reshape(B, K, -1)


def lookup_unsharded(arenas, bases, indices, plan: PlacementPlan):
    """Every shard on one device: one K1 per shard over its slots of
    ``indices`` (B, S*K, P), -1 rebased to that shard's row 0.  Returns
    (B, S*K, D)."""
    K = plan.k_max
    return torch.cat([
        _local_lookup(arenas[s], bases[s], indices[:, s * K:(s + 1) * K])
        for s in range(plan.n_shards)], dim=1)


def table_slots(plan: PlacementPlan) -> np.ndarray:
    """The grouped slot of each placed item, in item order: ``(M,)`` one
    per table for a whole-table plan (the reference's ``inv``:
    ``grouped[:, table_slots(plan)]`` drops the padded slots), ``(S,)``
    one per column shard, in the spec's shard order, for a sharded one."""
    slots = np.empty(plan.assignment.shape[0], np.int64)
    for s, g in enumerate(plan.groups):
        slots[g] = s * plan.k_max + np.arange(len(g))
    return slots


def _column_map(plan: PlacementPlan) -> tuple[np.ndarray, np.ndarray]:
    """(dst, src) flat lane indices of a column-sharded plan: output lane
    ``dst[j]`` of the ``(M*D,)`` per-table row takes lane ``src[j]`` of
    the ``(S*K*D,)`` grouped row.  Shards tile their owner's columns, so
    ``dst`` has no repeats; lanes past a table's dim are in neither."""
    spec, D = plan.sharding, plan.dim
    slots = table_slots(plan)
    dst, src = [], []
    for i in range(spec.n_shards):
        c0, c1 = int(spec.col_start[i]), int(spec.col_end[i])
        dst.append(int(spec.table[i]) * D + np.arange(c0, c1))
        src.append(int(slots[i]) * D + np.arange(c1 - c0))
    return np.concatenate(dst), np.concatenate(src)


def combine_shard_outputs(plan: PlacementPlan, grouped: torch.Tensor):
    """(B, S*K, D) per-slot pooled outputs -> (B, M, D) indexed by table
    id.  For a whole-table plan each live slot IS its table (all D
    lanes); for a column-sharded plan a slot's lanes ``[0, width)``
    scatter into its owner's ``[col_start, col_end)`` and the lanes past
    a table's dim stay zero, as in the reference.  Differentiable: the
    gradient of each slot is its owner's columns (zero past its width)."""
    dev = grouped.device
    if plan.slot_cols is None:
        return grouped.index_select(1, torch.as_tensor(table_slots(plan),
                                                       device=dev))
    B, D = grouped.shape[0], plan.dim
    dst, src = (torch.as_tensor(x, device=dev) for x in _column_map(plan))
    lanes = grouped.reshape(B, -1).index_select(1, src)
    out = grouped.new_zeros((B, plan.n_tables * D)).index_copy(1, dst, lanes)
    return out.reshape(B, plan.n_tables, D)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over equal chunks of dim 0; its transpose, the
    backward all-to-all, is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        out = torch.empty_like(grad)
        dist.all_to_all_single(out, grad, group=ctx.group)
        return out, None


class _SumGradOver(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group`` (an
    arena replicated over the data group, as a ``shard_map`` transpose
    sums it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def grid_groups(n_data: int, n_model: int):
    """This rank's ``(model_group, data_group)`` on a ``(data, model)``
    grid of the world's ranks, rank ``d * n_model + m``.  Every rank must
    call it (``new_group`` is collective)."""
    world = dist.get_world_size()
    if world != n_data * n_model:
        raise ValueError(f"a {n_data} x {n_model} grid needs "
                         f"{n_data * n_model} ranks, the world has {world}")
    rank = dist.get_rank()
    model = data = None
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            model = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data = g
    return model, data


def mesh_groups(mesh, data_axes=("data",), model_axis="model"):
    """``(model_group, data_groups)`` of this rank on a ``DeviceMesh``:
    the process group along ``model_axis`` and one along each of
    ``data_axes`` (the axes the arenas are replicated over)."""
    return (mesh.get_group(model_axis),
            tuple(mesh.get_group(ax) for ax in data_axes))


def make_sharded_lookup(plan: PlacementPlan, *, model_group=None,
                        data_group=None, mesh=None, data_axes=("data",),
                        model_axis="model"):
    """The distributed lookup of one rank.

    ``fn(arenas, bases, indices)``: ``arenas`` holds this rank's one
    arena (the shard of its place ``m`` in ``model_group``), ``bases`` is
    the plan's (S, K) base rows and ``indices`` this rank's data slice
    (B_loc, S*K, P).  The rank looks up its own group ``[m*K, (m+1)*K)``
    with K1 and trades batch rows for table groups over ``model_group``;
    it returns (B_loc/S, S*K, D): batch sub-slice ``m`` of every table.
    Concatenated in rank order (rank = d * S + m), the outputs are the
    global batch.  With ``data_group`` the arena's gradient is summed
    over it.

    With ``mesh`` (a ``DeviceMesh``), as the reference's
    ``make_sharded_lookup(mesh, plan, data_axes=, model_axis=)``: the
    model group is the mesh's ``model_axis`` and the arena's gradient is
    summed over each of ``data_axes`` in turn (``mesh_groups``); ``m`` is
    the rank's place along ``model_axis``.
    """
    data_groups = () if data_group is None else (data_group,)
    if mesh is not None:
        model_group, data_groups = mesh_groups(mesh, data_axes, model_axis)
    S, K, D = plan.n_shards, plan.k_max, plan.dim
    if dist.get_world_size(model_group) != S:
        raise ValueError(f"the plan has {S} shards, the model group "
                         f"{dist.get_world_size(model_group)} ranks")
    m = (mesh.get_local_rank(model_axis) if mesh is not None
         else dist.get_rank(model_group))
    sum_over = [g for g in data_groups if dist.get_world_size(g) > 1]

    def fn(arenas, bases, indices):
        (arena,) = arenas
        for g in sum_over:
            arena = _SumGradOver.apply(arena, g)
        B_loc, _, Pp = indices.shape
        if B_loc % S:
            raise ValueError(f"the batch slice {B_loc} is not a multiple of "
                             f"the {S} shards")
        own = indices.reshape(B_loc, S, K, Pp)[:, m]
        out = _local_lookup(arena, bases[m], own)         # (B_loc, K, D)
        out = _AllToAll.apply(out.reshape(S, B_loc // S, K, D), model_group)
        # (S, B_loc/S, K, D) -> (B_loc/S, S*K, D)
        return out.transpose(0, 1).reshape(B_loc // S, S * K, D)

    return fn
