"""Cost oracles: the unified "how expensive is this placement?" seam.

The whole-table part of ``repro/api/oracle.py``: the ``CostOracle``
protocol, ``SimOracle`` over the analytic ``CostSimulator``, and the
batched ``evaluate_many`` / ``legal_batch`` helpers.  ``CachedOracle``,
``MeasuredOracle``, ``KernelOracle`` and the sharded variants wait for
later slices of the port.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch import telemetry as tele
from repro_torch.core import features as F
from repro_torch.sim.costsim import (CostSimulator, SimResult,
                                     assignments_legal,
                                     check_assignment_batch)


@runtime_checkable
class CostOracle(Protocol):
    """Protocol every cost backend implements."""

    @property
    def mem_capacity_gb(self) -> float:
        """Per-device memory budget a legal placement must respect."""
        ...

    @property
    def num_evaluations(self) -> int:
        """Hardware measurements consumed so far (sample-efficiency axis)."""
        ...

    def evaluate(self, raw: np.ndarray, assignment: np.ndarray,
                 n_devices: int) -> SimResult:
        """Measure one placement; the analogue of one benchmark run."""
        ...

    def evaluate_many(self, raw: np.ndarray, assignments: np.ndarray,
                      n_devices: int) -> list[SimResult]:
        """Measure P placements of ONE task (shared ``raw``/``n_devices``)
        in a single batched pass; bitwise-identical to P sequential
        ``evaluate`` calls."""
        ...


def ensure_oracle(sim_or_oracle) -> "CostOracle":
    """Accept a ``CostOracle`` or a bare ``CostSimulator`` (auto-wrap)."""
    if isinstance(sim_or_oracle, CostSimulator):
        return SimOracle(sim_or_oracle)
    if isinstance(sim_or_oracle, CostOracle):
        return sim_or_oracle
    # oracles without evaluate_many: `evaluate_many` consumers fall back
    # to a per-placement loop for them
    if all(hasattr(sim_or_oracle, a)
           for a in ("evaluate", "mem_capacity_gb", "num_evaluations")):
        return sim_or_oracle
    raise TypeError(
        f"expected a CostOracle or CostSimulator, got {type(sim_or_oracle)!r}")


def evaluate_many(oracle, raw: np.ndarray, assignments: np.ndarray,
                  n_devices: int) -> list[SimResult]:
    """Batched measurement through any oracle: uses the oracle's
    ``evaluate_many`` when it has one, else falls back to a sequential
    per-placement loop (identical results either way)."""
    assignments = check_assignment_batch(assignments, n_devices)
    fn = getattr(oracle, "evaluate_many", None)
    if fn is not None:
        return fn(raw, assignments, n_devices)
    return [oracle.evaluate(raw, a, n_devices) for a in assignments]


def legal_batch(oracle, raw: np.ndarray, assignments: np.ndarray,
                n_devices: int) -> np.ndarray:
    """Vectorized ``(P,)`` memory-legality check through any oracle: uses
    the oracle's own ``legal_batch`` when present, else the shared
    bincount check against ``oracle.mem_capacity_gb``."""
    fn = getattr(oracle, "legal_batch", None)
    if fn is not None:
        return fn(raw, assignments, n_devices)
    sizes = np.asarray(raw, dtype=np.float64)[:, F.TABLE_SIZE_GB]
    return assignments_legal(sizes, assignments, n_devices,
                             oracle.mem_capacity_gb)


class SimOracle:
    """``CostOracle`` view over the analytic ``CostSimulator``.

    Each call emits a telemetry span (``oracle.sim.evaluate[_many]``)
    and bumps the dispatch counters -- no-ops until
    ``repro_torch.telemetry.enable()``.
    """

    def __init__(self, sim: CostSimulator | None = None, **sim_kwargs):
        self.sim = sim if sim is not None else CostSimulator(**sim_kwargs)

    @property
    def mem_capacity_gb(self) -> float:
        return self.sim.spec.mem_capacity_gb

    @property
    def num_evaluations(self) -> int:
        return self.sim.num_evaluations

    def evaluate(self, raw, assignment, n_devices) -> SimResult:
        tele.count("oracle.sim.evaluate_calls")
        with tele.span("oracle.sim.evaluate", M=len(raw),
                       n_devices=n_devices):
            return self.sim.evaluate(raw, assignment, n_devices)

    def evaluate_many(self, raw, assignments, n_devices) -> list[SimResult]:
        P = len(assignments)
        tele.count("oracle.sim.evaluate_many_calls")
        tele.count("oracle.sim.rows", P)
        with tele.span("oracle.sim.evaluate_many", P=P, M=len(raw),
                       n_devices=n_devices):
            return self.sim.evaluate_batch(raw, assignments, n_devices)

    def legal(self, raw, assignment, n_devices) -> bool:
        return self.sim.legal(raw, assignment, n_devices)

    def legal_batch(self, raw, assignments, n_devices) -> np.ndarray:
        return self.sim.legal_batch(raw, assignments, n_devices)
