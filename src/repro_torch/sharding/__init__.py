"""Column-wise table sharding: spec schema, feature expansion, and the
``ShardingPlacer`` wrapper that makes oversized tables placeable.

``repro_torch.sharding.spec`` is dependency-light (numpy + the feature
schema only) so the sim / oracle / digest layers can import it without
cycles; ``repro_torch.sharding.placer`` sits on top of
``repro_torch.api`` and is therefore re-exported lazily here (and from
``repro_torch.api``).
"""

from repro_torch.sharding.spec import (ShardSpec, project_assignment,
                                       shard_features, shard_sizes_gb)

_LAZY = {
    "ShardingPlacer": "repro_torch.sharding.placer",
    "ShardingConfig": "repro_torch.sharding.placer",
    "refine_sharded": "repro_torch.sharding.placer",
}

__all__ = ["ShardSpec", "shard_features", "shard_sizes_gb",
           "project_assignment", *sorted(_LAZY)]


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(__all__)
