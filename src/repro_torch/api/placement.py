"""The unified placement interface: ``Placer`` protocol + ``Placement``.

A ``Placer`` turns a ``Task`` (table subset + device count) into a
``Placement``: the assignment vector, the physical ``PlacementPlan`` the
fused embedding op consumes, the strategy's own cost estimate (when it
has one), and provenance -- which strategy produced it, how many candidate
placements were ranked, and how many hardware oracle evaluations were
consumed.  A placement may be column-sharded (``sharding``): then its
plan's slots hold column shards and the oracles price it shard by shard.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Protocol, runtime_checkable

import numpy as np

from repro_torch.api.digest import task_key
from repro_torch.api.oracle import evaluate_many, evaluate_sharded
from repro_torch.data.tasks import Task
from repro_torch.embedding.plan import PlacementPlan, build_plan
from repro_torch.sharding.spec import project_assignment


@dataclasses.dataclass
class Placement:
    """One strategy's answer for one task, with provenance.

    A placement may be *column-sharded*: ``sharding`` (a ``ShardSpec``)
    describes how tables split into contiguous column ranges and
    ``shard_assignment`` maps each shard to its device.  ``assignment``
    then holds the ``(M,)`` projection (each table's first shard's
    device) so whole-table consumers keep working; shard-aware consumers
    -- ``evaluate_sharded``, the plan builder, digests -- read the shard
    fields.  Whole-table placements (``sharding is None``) are unchanged.
    """

    assignment: np.ndarray          # (M,) table -> device
    plan: PlacementPlan             # physical layout for the fused op
    n_devices: int
    strategy: str                   # producing Placer's name
    est_cost_ms: float | None = None   # strategy's own (hardware-free) estimate
    candidates: int = 1             # candidate placements ranked internally
    oracle_evals: int = 0           # hardware evaluations consumed producing it
    sharding: object | None = None     # ShardSpec of a column-sharded answer
    shard_assignment: np.ndarray | None = None   # (S,) shard -> device

    @property
    def n_tables(self) -> int:
        return self.assignment.shape[0]

    @property
    def is_sharded(self) -> bool:
        return self.sharding is not None

    @property
    def n_shards(self) -> int:
        """Placed shard count (== ``n_tables`` when whole-table)."""
        return self.n_tables if self.sharding is None \
            else self.sharding.n_shards


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
              oracle_evals: int = 0, sharding=None) -> Placement:
        """With ``sharding``, ``assignment`` is the ``(S,)`` shard
        assignment; the stored ``(M,)`` assignment is its projection."""
        assignment = np.asarray(assignment, dtype=np.int64)
        plan = build_plan(task.raw_features, assignment, task.n_devices,
                          sharding=sharding)
        shard_assignment = None
        if sharding is not None:
            shard_assignment = assignment
            assignment = project_assignment(sharding, shard_assignment)
        return Placement(assignment=assignment, plan=plan,
                         n_devices=task.n_devices, strategy=self.name,
                         est_cost_ms=est_cost_ms, candidates=candidates,
                         oracle_evals=oracle_evals, sharding=sharding,
                         shard_assignment=shard_assignment)

    def place(self, task: Task) -> Placement:
        return self._wrap(task, *self._assign(task))

    def place_many(self, tasks: Iterable[Task]) -> list[Placement]:
        return [self.place(t) for t in tasks]


def measure_placements(oracle, tasks: Iterable[Task],
                       placements: Iterable[Placement]) -> np.ndarray:
    """Measured cost (ms) of each placement over its task -- ``(N,)``.

    (task, placement) pairs that share raw features, a device count and
    a sharding are measured through ONE ``evaluate_many`` /
    ``evaluate_sharded`` pass (bitwise-identical to per-pair calls).
    """
    pairs = list(zip(tasks, placements))
    groups: dict[bytes, list[int]] = {}
    for i, (t, p) in enumerate(pairs):
        key = task_key(t.raw_features, t.n_devices)
        # duck-typed placements (anything with .assignment) are
        # whole-table; only sharded Placements carry a spec
        spec = getattr(p, "sharding", None)
        if spec is not None:
            key += spec.to_bytes()
        groups.setdefault(key, []).append(i)
    costs = np.empty(len(pairs))
    for idxs in groups.values():
        task, first = pairs[idxs[0]]
        if getattr(first, "sharding", None) is None:
            assignments = np.stack([pairs[i][1].assignment for i in idxs])
            results = evaluate_many(oracle, task.raw_features, assignments,
                                    task.n_devices)
        else:
            assignments = np.stack([pairs[i][1].shard_assignment
                                    for i in idxs])
            results = evaluate_sharded(oracle, task.raw_features,
                                       first.sharding, assignments,
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
