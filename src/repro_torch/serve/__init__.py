"""High-throughput placement serving.

``PlacementService`` fronts a ``PlacementSession`` with a digest-keyed
placement cache, micro-batch admission, drift-triggered incremental
re-placement, and a fault-tolerance layer (``FaultInjector`` schedules,
failover re-placement, degraded-mode fallbacks, typed ``ServeError``
results, warm-restart checkpoints).  See ``docs/api.md`` ("Placement
serving & drift re-placement", "Resilient serving") and
``examples/serve_workflow.py``.
"""

from repro_torch.serve.cache import CacheEntry, PlacementCache
from repro_torch.serve.drift import (DriftTracker, MigrationCostOracle,
                                     dist_divergence)
from repro_torch.serve.errors import (CapacityError, DecodeTimeout,
                                      IllegalTaskError, ServeError,
                                      TransientOracleError)
from repro_torch.serve.faults import (DegradedMeshOracle, FaultEvent,
                                      FaultInjector, FaultSchedule,
                                      FaultyOracle, repair_assignment)
from repro_torch.serve.ledger import LatencyReservoir
from repro_torch.serve.service import (PlacementService, ServeConfig,
                                       ServeResult)

__all__ = [
    "CacheEntry", "CapacityError", "DecodeTimeout", "DegradedMeshOracle",
    "DriftTracker", "FaultEvent", "FaultInjector", "FaultSchedule",
    "FaultyOracle", "IllegalTaskError", "LatencyReservoir",
    "MigrationCostOracle", "PlacementCache", "PlacementService",
    "ServeConfig", "ServeError", "ServeResult", "TransientOracleError",
    "dist_divergence", "repair_assignment",
]
