"""Public placement API of the port (the whole-table part of ``repro.api``).

* ``CostOracle`` (protocol) with ``SimOracle``, plus the batched
  ``evaluate_many`` / ``legal_batch`` helpers;
* ``Placer`` (protocol) + ``Placement`` (assignment, physical
  ``PlacementPlan``, estimated cost, provenance) with adapters for
  DreamShard, the expert heuristics, random and a best-of-N portfolio;
* ``PlacementSession`` -- batched DreamShard serving: tasks bucketed by
  padded ``(M, D)`` shape, each bucket decoded in one batched call;
* blake2b digest helpers (``placement_key`` / ``placement_keys`` /
  ``task_key``).
"""

from repro_torch.api.digest import placement_key, placement_keys, task_key
from repro_torch.api.oracle import (CostOracle, SimOracle, ensure_oracle,
                                    evaluate_many, legal_batch)
from repro_torch.api.placement import (BasePlacer, Placement, Placer,
                                       evaluate_placements, evaluate_placer,
                                       measure_placements)
from repro_torch.api.placers import (DreamShardPlacer, ExpertPlacer,
                                     PortfolioPlacer, RandomPlacer,
                                     make_baseline_placers)
from repro_torch.api.session import PlacementSession

__all__ = sorted([
    "BasePlacer", "CostOracle", "DreamShardPlacer", "ExpertPlacer",
    "Placement", "PlacementSession", "Placer", "PortfolioPlacer",
    "RandomPlacer", "SimOracle", "ensure_oracle", "evaluate_many",
    "evaluate_placements", "evaluate_placer", "legal_batch",
    "make_baseline_placers", "measure_placements", "placement_key",
    "placement_keys", "task_key",
])
