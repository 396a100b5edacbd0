"""Drift detection and the migration-aware re-placement objective.

RecShard's observation (PAPERS.md) is that *access-distribution
statistics* are the right trigger for re-sharding: a placement computed
against yesterday's table popularity degrades as the histogram moves,
and the moment to re-place is when the observed distribution has
diverged measurably from the one the placement was optimized for.

Two pieces implement that here:

* ``DriftTracker`` -- per-task EWMAs of the 17-bin per-table access
  histograms carried on every request, plus the total-variation
  divergence against the placed snapshot that the service compares to
  its threshold;
* ``MigrationCostOracle`` -- a ``CostOracle`` wrapper that adds a
  migration term (bytes moved off the incumbent placement x link cost)
  to every measured cost, so the re-placement search
  (``SearchPlacer.refine``) only accepts moves whose steady-state win
  pays for the transfer: a 10 GB table does not bounce between devices
  for a 1% win.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.api.oracle import ensure_oracle, evaluate_many, legal_batch
from repro_torch.core import features as F
from repro_torch.sim.costsim import check_assignment_batch


def dist_divergence(observed: np.ndarray, snapshot: np.ndarray) -> float:
    """Max per-table total-variation distance between two ``(M, 17)``
    histogram stacks -- the drift metric.

    TV distance is ``0.5 * |p - q|_1`` per table: bounded in [0, 1],
    symmetric, and zero iff the distributions match, so a threshold on
    it reads directly as "this much probability mass has moved".  The
    max over tables (rather than a mean) triggers on a single table
    going hot, which is exactly the case that unbalances a device.
    """
    observed = np.asarray(observed, dtype=np.float64)
    snapshot = np.asarray(snapshot, dtype=np.float64)
    return float(0.5 * np.abs(observed - snapshot).sum(axis=-1).max())


class DriftTracker:
    """Per-key EWMAs of observed per-table access histograms.

    ``observe`` folds one request's histograms into the key's running
    estimate (initialized to the first observation, the standard EWMA
    seed) and returns the current estimate.  With ``alpha=0`` the
    estimate never moves off the first observation -- useful for
    pinning zero-drift replays bitwise.
    """

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha
        self._ewma: dict[bytes, np.ndarray] = {}

    def observe(self, key: bytes, dist: np.ndarray) -> np.ndarray:
        dist = np.asarray(dist, dtype=np.float64)
        cur = self._ewma.get(key)
        if cur is None or self.alpha >= 1.0:
            cur = dist.copy()
        elif self.alpha > 0.0:
            cur = (1.0 - self.alpha) * cur + self.alpha * dist
        self._ewma[key] = cur
        return cur

    def estimate(self, key: bytes) -> np.ndarray | None:
        return self._ewma.get(key)


@dataclasses.dataclass(frozen=True)
class MigrationCostOracle:
    """``CostOracle`` adding bytes-moved x link cost to every result.

    ``incumbent`` is the currently-served assignment; a candidate's
    migration penalty is ``ms_per_gb`` times the total size of tables
    it places on a *different* device.  The incumbent itself (the seed
    of every ``SearchPlacer.refine``) pays zero penalty, so search
    under this oracle accepts a move only when the measured placement
    win exceeds the cost of actually performing it.  ``num_evaluations``
    and legality delegate to the wrapped oracle -- the penalty is pure
    arithmetic, never a hardware measurement.
    """

    inner: object
    incumbent: np.ndarray
    ms_per_gb: float

    @classmethod
    def wrap(cls, oracle, incumbent: np.ndarray,
             ms_per_gb: float) -> "MigrationCostOracle":
        return cls(inner=ensure_oracle(oracle),
                   incumbent=np.asarray(incumbent, dtype=np.int64),
                   ms_per_gb=float(ms_per_gb))

    @property
    def mem_capacity_gb(self) -> float:
        return self.inner.mem_capacity_gb

    @property
    def num_evaluations(self) -> int:
        return self.inner.num_evaluations

    def migration_gb(self, raw: np.ndarray,
                     assignments: np.ndarray) -> np.ndarray:
        """Bytes (GB) each candidate row moves off the incumbent -- (P,)."""
        sizes = np.asarray(raw, dtype=np.float64)[:, F.TABLE_SIZE_GB]
        moved = np.asarray(assignments, dtype=np.int64) != self.incumbent
        return (moved * sizes).sum(axis=-1)

    def evaluate_many(self, raw, assignments, n_devices):
        assignments = check_assignment_batch(assignments, n_devices)
        results = evaluate_many(self.inner, raw, assignments, n_devices)
        penalty = self.migration_gb(raw, assignments) * self.ms_per_gb
        return [r if p == 0.0 else
                dataclasses.replace(r, overall=r.overall + float(p))
                for r, p in zip(results, penalty)]

    def evaluate(self, raw, assignment, n_devices):
        return self.evaluate_many(
            raw, np.asarray(assignment)[None, :], n_devices)[0]

    def legal(self, raw, assignment, n_devices) -> bool:
        return bool(self.legal_batch(
            raw, np.asarray(assignment)[None, :], n_devices)[0])

    def legal_batch(self, raw, assignments, n_devices) -> np.ndarray:
        return legal_batch(self.inner, raw, assignments, n_devices)
