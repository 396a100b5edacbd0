"""Public placement API of the port (the counterpart of ``repro.api``).

* ``CostOracle`` (protocol) with ``SimOracle`` / ``CachedOracle`` /
  ``MeasuredOracle`` / ``KernelOracle``, plus the batched
  ``evaluate_many`` / ``legal_batch`` helpers;
* column-wise sharding (``repro_torch.sharding``) -- ``ShardSpec`` +
  ``shard_features`` expand tables into per-shard pseudo-tables;
  ``evaluate_sharded`` / ``legal_sharded`` price and bound-check
  ``(P, S)`` shard assignments on every oracle (K = 1 bitwise-equal to
  the whole-table path); ``ShardingPlacer`` wraps any placer to split
  oversized/hottest tables, ``refine_sharded`` searches shard moves and
  splits;
* ``Placer`` (protocol) + ``Placement`` (assignment, physical
  ``PlacementPlan``, estimated cost, provenance) with adapters for
  DreamShard, the RNN baseline, the expert heuristics, random and a
  best-of-N portfolio;
* ``PlacementSession`` -- batched DreamShard serving: tasks bucketed by
  padded ``(M, D)`` shape, each bucket decoded in one batched call, with
  an optional post-decode ``refiner`` pass;
* ``SearchPlacer`` / ``SearchConfig`` (re-exported lazily from
  ``repro_torch.search``) -- anytime search refinement of any seed
  placer through the batched oracle;
* ``PlacementService`` / ``ServeConfig`` and the serving names (re-exported
  lazily from ``repro_torch.serve``) -- the placement cache, micro-batch
  admission, drift re-placement and fault tolerance over a session;
* blake2b digest helpers (``placement_key(s)`` /
  ``sharded_placement_key(s)`` / ``task_key``).
"""

import importlib

from repro_torch.api.digest import (placement_key, placement_keys,
                                    sharded_placement_key,
                                    sharded_placement_keys, task_key)
from repro_torch.api.oracle import (CachedOracle, CostOracle, KernelOracle,
                                    MeasuredOracle, SimOracle, ensure_oracle,
                                    evaluate_many, evaluate_sharded,
                                    legal_batch, legal_sharded)
from repro_torch.api.placement import (BasePlacer, Placement, Placer,
                                       evaluate_placements, evaluate_placer,
                                       measure_placements)
from repro_torch.api.placers import (DreamShardPlacer, ExpertPlacer,
                                     PortfolioPlacer, RandomPlacer,
                                     RNNPlacerAdapter, make_baseline_placers)
from repro_torch.api.session import PlacementSession
from repro_torch.sharding import (ShardSpec, project_assignment,
                                  shard_features, shard_sizes_gb)

# ``repro_torch.search`` / ``repro_torch.serve`` /
# ``repro_torch.sharding.placer`` import from this package, so their names
# are re-exported lazily (PEP 562) from this one registry to keep
# ``import repro_torch.api`` cycle-free.
_LAZY = {
    "SearchConfig": "repro_torch.search",
    "SearchPlacer": "repro_torch.search",
    "SearchScorer": "repro_torch.search",
    "CapacityError": "repro_torch.serve",
    "DecodeTimeout": "repro_torch.serve",
    "FaultEvent": "repro_torch.serve",
    "FaultInjector": "repro_torch.serve",
    "FaultSchedule": "repro_torch.serve",
    "IllegalTaskError": "repro_torch.serve",
    "PlacementCache": "repro_torch.serve",
    "PlacementService": "repro_torch.serve",
    "ServeConfig": "repro_torch.serve",
    "ServeError": "repro_torch.serve",
    "ServeResult": "repro_torch.serve",
    "TransientOracleError": "repro_torch.serve",
    "ShardingConfig": "repro_torch.sharding",
    "ShardingPlacer": "repro_torch.sharding",
    "refine_sharded": "repro_torch.sharding",
}

__all__ = sorted([
    "BasePlacer", "CachedOracle", "CostOracle", "DreamShardPlacer",
    "ExpertPlacer", "KernelOracle", "MeasuredOracle", "Placement",
    "PlacementSession", "Placer", "PortfolioPlacer", "RandomPlacer",
    "RNNPlacerAdapter", "ShardSpec", "SimOracle", "ensure_oracle",
    "evaluate_many", "evaluate_placements", "evaluate_placer",
    "evaluate_sharded",
    "legal_batch", "legal_sharded", "make_baseline_placers",
    "measure_placements", "placement_key", "placement_keys",
    "project_assignment", "shard_features", "shard_sizes_gb",
    "sharded_placement_key", "sharded_placement_keys", "task_key", *_LAZY,
])


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is not None:
        return getattr(importlib.import_module(module), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
