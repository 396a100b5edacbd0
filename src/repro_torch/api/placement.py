"""The unified placement interface: ``Placer`` protocol + ``Placement``.

A ``Placer`` turns a ``Task`` (table subset + device count) into a
``Placement``: the assignment vector, the physical ``PlacementPlan`` the
fused embedding op consumes, the strategy's own cost estimate (when it
has one), and provenance -- which strategy produced it, how many candidate
placements were ranked, and how many hardware oracle evaluations were
consumed.  Whole-table placements only; column sharding waits for a later
slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Protocol, runtime_checkable

import numpy as np

from repro_torch.api.digest import task_key
from repro_torch.api.oracle import evaluate_many
from repro_torch.data.tasks import Task
from repro_torch.embedding.plan import PlacementPlan, build_plan


@dataclasses.dataclass
class Placement:
    """One strategy's answer for one task, with provenance."""

    assignment: np.ndarray          # (M,) table -> device
    plan: PlacementPlan             # physical layout for the fused op
    n_devices: int
    strategy: str                   # producing Placer's name
    est_cost_ms: float | None = None   # strategy's own (hardware-free) estimate
    candidates: int = 1             # candidate placements ranked internally
    oracle_evals: int = 0           # hardware evaluations consumed producing it

    @property
    def n_tables(self) -> int:
        return self.assignment.shape[0]


@runtime_checkable
class Placer(Protocol):
    """Protocol every placement strategy implements."""

    name: str

    def place(self, task: Task) -> Placement:
        """Place one task."""
        ...

    def place_many(self, tasks: Iterable[Task]) -> list[Placement]:
        """Place a suite of tasks (batched/amortized where possible)."""
        ...


class BasePlacer:
    """Shared plumbing: subclasses implement ``_assign``.

    ``_assign(task) -> (assignment, est_cost_ms, candidates, oracle_evals)``
    """

    name = "base"

    def _assign(self, task: Task):
        raise NotImplementedError

    def _wrap(self, task: Task, assignment: np.ndarray,
              est_cost_ms: float | None = None, candidates: int = 1,
              oracle_evals: int = 0) -> Placement:
        assignment = np.asarray(assignment, dtype=np.int64)
        return Placement(assignment=assignment,
                         plan=build_plan(task.raw_features, assignment,
                                         task.n_devices),
                         n_devices=task.n_devices, strategy=self.name,
                         est_cost_ms=est_cost_ms, candidates=candidates,
                         oracle_evals=oracle_evals)

    def place(self, task: Task) -> Placement:
        return self._wrap(task, *self._assign(task))

    def place_many(self, tasks: Iterable[Task]) -> list[Placement]:
        return [self.place(t) for t in tasks]


def measure_placements(oracle, tasks: Iterable[Task],
                       placements: Iterable[Placement]) -> np.ndarray:
    """Measured cost (ms) of each placement over its task -- ``(N,)``.

    (task, placement) pairs that share raw features and a device count
    are measured through ONE ``evaluate_many`` pass (bitwise-identical to
    per-pair ``evaluate`` calls).
    """
    pairs = list(zip(tasks, placements))
    groups: dict[bytes, list[int]] = {}
    for i, (t, _) in enumerate(pairs):
        groups.setdefault(task_key(t.raw_features, t.n_devices),
                          []).append(i)
    costs = np.empty(len(pairs))
    for idxs in groups.values():
        task = pairs[idxs[0]][0]
        assignments = np.stack([pairs[i][1].assignment for i in idxs])
        results = evaluate_many(oracle, task.raw_features, assignments,
                                task.n_devices)
        for i, res in zip(idxs, results):
            costs[i] = res.overall
    return costs


def evaluate_placements(oracle, tasks: Iterable[Task],
                        placements: Iterable[Placement]) -> float:
    """Mean measured cost (ms) of placements over their tasks."""
    return float(np.mean(measure_placements(oracle, tasks, placements)))


def evaluate_placer(oracle, tasks: Iterable[Task], placer: Placer) -> float:
    """Place a suite through one ``Placer`` and return its mean cost (ms)."""
    tasks = list(tasks)           # survive generators: placed AND re-zipped
    return evaluate_placements(oracle, tasks, placer.place_many(tasks))
