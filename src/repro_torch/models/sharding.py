"""Sharding rules: parameter PartitionSpecs + activation constraints.

The counterpart of ``repro/models/sharding.py`` over
``torch.distributed``'s ``DeviceMesh`` and DTensor.  The single-pod
production mesh is ``(data=16, model=16)``; multi-pod prepends a ``pod``
axis folded into data parallelism.  The model code is mesh-agnostic: it
receives a ``ShardingRules`` and calls ``constrain`` with logical axis
names; with rules disabled (one device, the CPU tests) everything is a
no-op.

Logical axes:
  batch  -> ('pod', 'data') or ('data',)
  model  -> 'model' (tensor/expert parallel)
  None   -> replicated

A ``PartitionSpec`` names, for each tensor dim, the mesh axis (or axes)
it is split over; ``placements`` turns it into DTensor's ``Shard`` /
``Replicate`` for each mesh dim.  A tensor dim over several mesh axes is
split major to minor, as JAX splits it: ``Shard`` on each of them, in
the mesh's own order.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map


class PartitionSpec(tuple):
    """One entry a tensor dim: a mesh axis name, a tuple of names, or
    None (replicated).  A tuple, so specs compare as tuples."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of any object whose
    ``shape`` maps names to sizes, as a JAX mesh's does)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return dict(zip(names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    batch_axes: tuple = ("data",)
    model_axis: str | None = "model"     # None = no tensor parallelism
    fsdp_axes: tuple = ("data",)         # axes weights are ZeRO-3-sharded on
    enabled: bool = True

    def spec(self, *logical) -> PartitionSpec:
        dims = []
        for ax in logical:
            if ax == "batch":
                if not self.batch_axes:          # batch too small to shard
                    dims.append(None)
                elif len(self.batch_axes) > 1:
                    dims.append(self.batch_axes)
                else:
                    dims.append(self.batch_axes[0])
            elif ax == "model":
                dims.append(self.model_axis)
            else:
                dims.append(None)
        return P(*dims)

    @property
    def fsdp_dim(self):
        """Mesh-axis entry for a weight dim sharded ZeRO-3 style."""
        if not self.fsdp_axes:
            return None
        return self.fsdp_axes if len(self.fsdp_axes) > 1 else self.fsdp_axes[0]

    def for_batch(self, global_batch: int, mesh) -> "ShardingRules":
        """Drop batch sharding when the global batch doesn't divide the
        data axes (e.g. the batch=1 long-context decode shape)."""
        sizes = mesh_axis_sizes(mesh)
        n = 1
        for ax in self.batch_axes:
            n *= sizes[ax]
        if global_batch % max(n, 1) == 0:
            return self
        return dataclasses.replace(self, batch_axes=())

    def placements(self, mesh, *logical) -> tuple:
        """DTensor placements on ``mesh`` of ``spec(*logical)``."""
        return placements(mesh, self.spec(*logical))

    def constrain(self, x, *logical):
        """``x`` redistributed to ``spec(*logical)`` on its own mesh (a
        pending sum is reduced, a split dim gathered or a replicated one
        sliced, as the placements ask); ``x`` itself when the rules are
        disabled."""
        if not self.enabled:
            return x
        if not isinstance(x, DTensor):
            raise TypeError("constrain under enabled rules takes a DTensor")
        want = self.placements(x.device_mesh, *logical)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)


NO_SHARDING = ShardingRules(enabled=False)


def placements(mesh, spec) -> tuple:
    """``Shard(dim)`` or ``Replicate()`` for each of ``mesh``'s dims, from
    a ``PartitionSpec``.  A tensor dim over several mesh axes must name
    them in the mesh's order (major to minor); an axis the mesh lacks, or
    one named twice, raises ``ValueError``."""
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for ax in axes:
            if ax not in names:
                raise ValueError(f"mesh {names} has no axis {ax!r}")
            i = names.index(ax)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {ax!r} named twice in {spec}")
            out[i] = Shard(dim)
            idx.append(i)
        if idx != sorted(idx):
            raise ValueError(f"spec {spec} splits dim {dim} over {axes}, "
                             f"out of the mesh's order {names}")
    return tuple(out)


def tree_named_shardings(mesh, spec_tree):
    """The placements tuple of every ``PartitionSpec`` leaf of a (nested
    dict) spec tree, on ``mesh``."""
    if isinstance(spec_tree, PartitionSpec):
        return placements(mesh, spec_tree)
    return {k: tree_named_shardings(mesh, v) for k, v in spec_tree.items()}


def distribute_tree(tree, spec_tree, mesh):
    """Each tensor leaf of ``tree`` distributed by its ``PartitionSpec``
    in ``spec_tree`` (the same nesting) over ``mesh``.  Every rank passes
    the same values; rank 0's are the ones kept."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, spec_tree[k], mesh)
                for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    return distribute_tensor(tree, mesh, placements(mesh, spec_tree))


@dataclasses.dataclass(frozen=True)
class Summed:
    """An output spec of ``local_apply``: each rank holds a partial sum
    (DTensor's ``Partial``) over the mesh axes of the logical axes
    ``over`` (by default the rules' model axis), split elsewhere as
    ``logical`` says."""
    logical: tuple
    over: tuple = ("model",)


def _mesh_dims(rules, mesh, logical) -> set:
    """The indices of ``mesh``'s dims that the logical axes name."""
    names = tuple(mesh.mesh_dim_names)
    axes = []
    for ax in logical:
        if ax == "batch":
            axes.extend(rules.batch_axes)
        elif ax == "model" and rules.model_axis is not None:
            axes.append(rules.model_axis)
    return {names.index(a) for a in axes}


def _out_placements(rules, mesh, spec):
    if spec is None:
        return None
    if isinstance(spec, Summed):
        out = list(rules.placements(mesh, *spec.logical))
        for i in _mesh_dims(rules, mesh, spec.over):
            out[i] = Partial()
        return tuple(out)
    return rules.placements(mesh, *spec)


def local_apply(rules, fn, out_specs, in_specs, *args, gathers=()):
    """``fn(*args)`` on each rank's local shards, the kernels' way into
    DTensor (``local_map``).  ``in_specs`` gives each argument's logical
    axes (None for a non-tensor argument); each DTensor argument is
    redistributed to them first and a plain tensor taken as replicated.
    ``out_specs`` gives each output's (a logical tuple, ``Summed`` or
    None).  With the rules disabled this is ``fn(*args)``.

    A gradient flowing back to an argument replicated over a mesh dim
    along which some argument is split is a partial sum over that dim
    (each rank's share of the work adds to it); over a mesh dim along
    which nothing is split every rank did the same work, and the
    gradient stays replicated.  So does it over the dims of the logical
    axes ``gathers``: ``fn`` gathers what its split arguments give along
    them itself, by a collective whose backward hands every rank the
    whole gradient, so every rank computes the replicated arguments'
    whole gradient."""
    if not rules.enabled:
        return fn(*args)
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    in_pl, moved = [], []
    for a, spec in zip(args, in_specs):
        if spec is None:
            in_pl.append(None)
            moved.append(a)
            continue
        want = rules.placements(mesh, *spec)
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if tuple(a.placements) != want:
            a = a.redistribute(mesh, want)
        in_pl.append(want)
        moved.append(a)
    whole = _mesh_dims(rules, mesh, gathers)
    split = [i not in whole and any(
        p is not None and isinstance(p[i], Shard) for p in in_pl)
        for i in range(mesh.ndim)]
    grad_pl = tuple(
        None if p is None else tuple(
            Partial() if isinstance(pi, Replicate) and split[i] else pi
            for i, pi in enumerate(p))
        for p in in_pl)
    out_pl = tuple(_out_placements(rules, mesh, s) for s in out_specs)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=grad_pl, device_mesh=mesh)(*moved)


def model_coords(rules, mesh) -> tuple:
    """(this rank's index along the rules' model axis, the axis' size,
    its process group or None): (0, 1, None) with the rules disabled or
    no model axis."""
    if not rules.enabled or rules.model_axis is None:
        return 0, 1, None
    ax = rules.model_axis
    return (mesh.get_local_rank(ax), mesh.size(mesh.mesh_dim_names.index(ax)),
            mesh.get_group(ax))


def shard_start(size: int, n: int, i: int) -> int:
    """Where shard ``i`` of ``n`` of a dim of ``size`` starts (DTensor's
    ``Shard``: chunks of ``ceil(size / n)``, the last ones short)."""
    return min(size, i * -(-size // n))
