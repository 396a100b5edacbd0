"""``Placer`` adapters for the placement strategies of this slice.

The trained DreamShard agent, the human-expert greedy heuristics, random
placement and the best-of-N portfolio, all behind the one ``Placer``
protocol.  The RNN baseline's adapter waits for its port.
"""

from __future__ import annotations

import numpy as np

from repro_torch.api.oracle import ensure_oracle, evaluate_many
from repro_torch.api.placement import BasePlacer, Placement
from repro_torch.api.session import PlacementSession
from repro_torch.core import baselines as B
from repro_torch.data.tasks import Task


class DreamShardPlacer(BasePlacer):
    """Trained DreamShard agent behind the ``Placer`` protocol.

    Both ``place`` and ``place_many`` route through a shared
    ``PlacementSession``, whose decoded assignments are identical to the
    agent's per-task Algorithm-2 path.
    """

    name = "dreamshard"

    def __init__(self, agent, n_candidates: int | None = None,
                 bucket_tables: int = 8):
        self.agent = agent
        self.session = PlacementSession(agent, n_candidates=n_candidates,
                                        bucket_tables=bucket_tables)

    def place(self, task: Task) -> Placement:
        return self.session.place(task)

    def place_many(self, tasks) -> list[Placement]:
        return self.session.place_many(list(tasks))


class ExpertPlacer(BasePlacer):
    """Greedy human-expert heuristic (paper App. D.1): one scalar cost per
    table, sorted descending, least-loaded legal device."""

    def __init__(self, oracle, strategy: str):
        if strategy not in B.EXPERT_STRATEGIES:
            raise ValueError(f"unknown expert strategy {strategy!r}")
        self.oracle = ensure_oracle(oracle)
        self.strategy = strategy
        self.name = strategy

    def place(self, task: Task) -> Placement:
        a = B.expert_place(task.raw_features, task.n_devices,
                           self.oracle.mem_capacity_gb, self.strategy)
        return self._wrap(task, a)


class RandomPlacer(BasePlacer):
    """Memory-legal random placement (stateful rng: successive calls
    consume the same stream as ``random_place`` with a shared generator).

    ``n_candidates > 1`` draws that many placements and keeps the
    oracle-measured best, scored in ONE ``evaluate_many`` batch.
    """

    name = "random"

    def __init__(self, oracle, seed: int = 0, n_candidates: int = 1):
        self.oracle = ensure_oracle(oracle)
        self.rng = np.random.default_rng(seed)
        self.n_candidates = max(1, n_candidates)

    def place(self, task: Task) -> Placement:
        cap = self.oracle.mem_capacity_gb
        A = np.stack([B.random_place(task.raw_features, task.n_devices,
                                     cap, self.rng)
                      for _ in range(self.n_candidates)])
        if self.n_candidates == 1:
            return self._wrap(task, A[0])
        evals0 = self.oracle.num_evaluations
        results = evaluate_many(self.oracle, task.raw_features, A,
                                task.n_devices)
        costs = np.array([r.overall for r in results])
        best = int(np.argmin(costs))
        return self._wrap(task, A[best], est_cost_ms=float(costs[best]),
                          candidates=self.n_candidates,
                          oracle_evals=self.oracle.num_evaluations - evals0)


class PortfolioPlacer(BasePlacer):
    """Best-of-N over member placers, scored through ONE batched oracle
    pass per task."""

    def __init__(self, oracle, placers: dict[str, BasePlacer],
                 name: str = "portfolio"):
        if not placers:
            raise ValueError("PortfolioPlacer needs at least one member")
        self.oracle = ensure_oracle(oracle)
        self.placers = dict(placers)
        self.name = name

    def place_many(self, tasks) -> list[Placement]:
        tasks = list(tasks)
        proposals = {k: p.place_many(tasks)          # members may batch
                     for k, p in self.placers.items()}
        out = []
        for i, task in enumerate(tasks):
            cands = [proposals[k][i] for k in self.placers]
            A = np.stack([c.assignment for c in cands])
            evals0 = self.oracle.num_evaluations
            results = evaluate_many(self.oracle, task.raw_features, A,
                                    task.n_devices)
            costs = np.array([r.overall for r in results])
            best = int(np.argmin(costs))
            out.append(Placement(
                assignment=cands[best].assignment, plan=cands[best].plan,
                n_devices=task.n_devices, strategy=self.name,
                est_cost_ms=float(costs[best]), candidates=len(cands),
                oracle_evals=self.oracle.num_evaluations - evals0))
        return out

    def place(self, task: Task) -> Placement:
        return self.place_many([task])[0]


def make_baseline_placers(oracle, seed: int = 0,
                          include_portfolio: bool = False
                          ) -> dict[str, BasePlacer]:
    """Random + the four expert heuristics, keyed by strategy name.

    ``include_portfolio=True`` adds ``"expert_best"``: the batched
    best-of-the-four-experts portfolio (one ``evaluate_many`` per task).
    """
    oracle = ensure_oracle(oracle)
    placers: dict[str, BasePlacer] = {"random": RandomPlacer(oracle, seed)}
    for s in B.EXPERT_STRATEGIES:
        placers[s] = ExpertPlacer(oracle, s)
    if include_portfolio:
        experts = {s: placers[s] for s in B.EXPERT_STRATEGIES}
        placers["expert_best"] = PortfolioPlacer(oracle, experts,
                                                 name="expert_best")
    return placers
