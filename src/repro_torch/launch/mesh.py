"""Production mesh construction.

The counterpart of ``repro/launch/mesh.py`` over ``torch.distributed``:
each mesh is a ``DeviceMesh`` from ``init_device_mesh`` with named dims.
Single pod = 256 ranks as (data=16, model=16); multi-pod = 2 pods = 512
ranks as (pod=2, data=16, model=16) with the pod axis folded into data
parallelism.  The caller starts the process group
(``torch.distributed.init_process_group``) with a world size equal to the
mesh's; the mesh's device type is ``resolve_device``'s: the card unless
the caller names the CPU.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device
from repro_torch.models.sharding import ShardingRules


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    default process group, whose world size must be ``prod(shape)``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    dev = resolve_device(device)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_initialized():
        raise RuntimeError("start the process group first "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def production_rules(*, multi_pod: bool = False,
                     strategy: str = "tp") -> ShardingRules:
    """strategy: "tp" = 16-way tensor parallel x 16-way FSDP/data (default);
    "fsdp" = pure ZeRO-3 over all 256 ranks, no tensor parallelism."""
    if strategy == "fsdp":
        batch = (("pod", "data", "model") if multi_pod
                 else ("data", "model"))
        return ShardingRules(batch_axes=batch, model_axis=None,
                             fsdp_axes=("data", "model"))
    batch = ("pod", "data") if multi_pod else ("data",)
    return ShardingRules(batch_axes=batch, model_axis="model")
