"""``SearchPlacer``: the first ``Placer`` that composes other placers.

The counterpart of ``repro/search/placer.py``.  It takes any seed
proposal -- a wrapped ``Placer`` (DreamShard, expert, random, portfolio)
or an already-built ``Placement`` via ``refine`` -- and improves it
purely through the batched oracle path under an anytime budget.
``SearchConfig`` selects and parameterizes the strategy; ``strategy``
accepts a single family (``"lns"``, ``"evolution"``, ``"beam"``) or a
``"+"``-composed pipeline (``"beam+lns"`` runs beam search, then polishes
its best leaf with LNS) sharing one budget.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

from repro_torch import telemetry as tele
from repro_torch.api.oracle import ensure_oracle
from repro_torch.api.placement import BasePlacer, Placement, Placer
from repro_torch.core.baselines import expert_place
from repro_torch.data.tasks import Task
from repro_torch.search import strategies as S
from repro_torch.search.scoring import SearchScorer
from repro_torch.sharding.spec import shard_features
from repro_torch.sim.costsim import placement_digest

STRATEGIES = ("lns", "evolution", "beam")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Knobs for one ``SearchPlacer``; defaults match the benchmarks.

    Budget: ``budget_ms`` is a per-task wall-clock deadline checked
    between rounds; ``max_evals`` caps oracle candidate rows (seed
    measurement included) -- a deterministic meter that makes runs
    reproducible and, by construction, anytime-monotone.  Either may be
    ``None``; with both ``None`` set ``max_rounds`` or the search never
    stops.  A zero budget returns the seed placement bitwise.
    """

    strategy: str = "lns"          # family or "+"-composed pipeline
    budget_ms: float | None = 50.0
    max_evals: int | None = None
    max_rounds: int | None = None  # per strategy stage; None = budget-bound
    seed: int = 0                  # rng stream; mixed with task+seed digest
    # lns
    neighborhood: int = 64         # candidate rows proposed per round
    swap_fraction: float = 0.25    # share of the round spent on swaps
    # evolution
    population: int = 32
    elites: int = 4
    mutations: int = 2             # k random reassignments per child
    crossover_rate: float = 0.5
    tournament: int = 3
    # beam
    beam_width: int = 8

    def stages(self) -> tuple[str, ...]:
        names = tuple(s.strip() for s in self.strategy.split("+") if s)
        for n in names:
            if n not in STRATEGIES:
                raise ValueError(
                    f"unknown search strategy {n!r}; "
                    f"expected one of {STRATEGIES} (optionally '+'-composed)")
        if not names:
            raise ValueError("SearchConfig.strategy selected no stages")
        return names


class SearchPlacer(BasePlacer):
    """Refine a seed placer's proposals through the batched oracle.

    ``seed_placer=None`` seeds from the greedy size-balance expert (the
    cheapest deterministic proposal).  ``agent`` (a trained
    ``DreamShard``) is required only by the ``"beam"`` strategy, which
    scores partial placements with the agent's cost network.
    """

    def __init__(self, oracle, seed_placer: Placer | None = None,
                 config: SearchConfig | None = None, agent=None,
                 name: str | None = None):
        self.oracle = ensure_oracle(oracle)
        self.seed_placer = seed_placer
        self.config = config if config is not None else SearchConfig()
        self.config.stages()           # validate eagerly, not per task
        if "beam" in self.config.stages() and agent is None:
            raise ValueError("strategy 'beam' needs a trained DreamShard "
                             "agent (its cost network scores the beam)")
        self.agent = agent
        seed_name = seed_placer.name if seed_placer is not None else "expert"
        self.name = name if name is not None else \
            f"search[{self.config.strategy}]({seed_name})"
        self.last_scorer: SearchScorer | None = None   # introspection

    # ---- seeding ------------------------------------------------------------

    def _seed_placement(self, task: Task) -> Placement:
        if self.seed_placer is not None:
            return self.seed_placer.place(task)
        a = expert_place(task.raw_features, task.n_devices,
                         self.oracle.mem_capacity_gb, "size")
        return self._wrap(task, a)

    # ---- refinement ---------------------------------------------------------

    def refine(self, task: Task, placement: Placement) -> Placement:
        """Improve one seed ``Placement`` within the anytime budget.

        Returns a placement whose measured cost is <= the seed's; with
        an exhausted-at-entry budget (``budget_ms=0`` / ``max_evals=0``)
        the seed comes back bitwise (same assignment and plan objects),
        relabeled with this placer's name.
        """
        sp = tele.span("search.refine", strategy=self.config.strategy,
                       M=len(task.raw_features),
                       n_devices=task.n_devices)
        with sp:
            out = self._refine_impl(task, placement)
            if self.last_scorer is not None:
                sp.set(cost_ms=out.est_cost_ms,
                       evals=self.last_scorer.evals,
                       hardware_evals=self.last_scorer.hardware_evals)
            return out

    def _refine_impl(self, task: Task, placement: Placement) -> Placement:
        cfg = self.config
        spec = placement.sharding
        if spec is None:
            a0 = np.asarray(placement.assignment, dtype=np.int64)
            features = task.raw_features
        else:
            # shard rows ARE table rows over the expanded pseudo-tables:
            # lns/evolution propose shard moves/swaps unchanged.  Beam is
            # a whole-table MDP (the agent's cost net consumes per-table
            # state), so it cannot refine a sharded placement.
            if "beam" in cfg.stages():
                raise ValueError(
                    "strategy 'beam' is whole-table only and cannot refine "
                    "a column-sharded placement; use 'lns'/'evolution'")
            a0 = np.asarray(placement.shard_assignment, dtype=np.int64)
            features = shard_features(task.raw_features, spec)
        scorer = SearchScorer(self.oracle, task, budget_ms=cfg.budget_ms,
                              max_evals=cfg.max_evals, sharding=spec)
        self.last_scorer = scorer
        if task.n_devices <= 1 or scorer.out_of_budget():
            return dataclasses.replace(placement, strategy=self.name)

        # one deterministic stream per (config seed, task, seed placement):
        # same seed + same budget replays identically, and a larger
        # max_evals replays the smaller run's rounds then keeps going
        # (for a sharded seed the digest runs over the expanded features,
        # which for K = 1 equal the raw features bitwise)
        rng = np.random.default_rng(
            [cfg.seed, placement_digest(features, a0, task.n_devices)])
        scorer.filter_new(a0[None])
        seed_costs, seed_results = scorer.score(a0[None])
        incumbent = S.Incumbent(assignment=a0, cost=float(seed_costs[0]),
                                result=seed_results[0])
        enforce_legal = bool(scorer.legal(a0[None])[0])

        for stage in cfg.stages():
            if scorer.out_of_budget():
                break
            if stage == "lns":
                S.refine_lns(scorer, rng, cfg, incumbent, enforce_legal)
            elif stage == "evolution":
                S.refine_evolution(scorer, rng, cfg, incumbent,
                                   enforce_legal)
            else:
                S.refine_beam(scorer, rng, cfg, incumbent, enforce_legal,
                              self.agent)

        if np.array_equal(incumbent.assignment, a0):
            # keep the seed's plan object: bitwise-stable when search
            # found nothing better (or the seed was already optimal)
            return dataclasses.replace(
                placement, strategy=self.name,
                est_cost_ms=incumbent.cost if np.isfinite(incumbent.cost)
                else placement.est_cost_ms,
                candidates=placement.candidates + scorer.evals - 1,
                oracle_evals=placement.oracle_evals + scorer.hardware_evals)
        return self._wrap(
            task, incumbent.assignment, est_cost_ms=incumbent.cost,
            candidates=placement.candidates + scorer.evals - 1,
            oracle_evals=placement.oracle_evals + scorer.hardware_evals,
            sharding=spec)

    # ---- Placer protocol ----------------------------------------------------

    def place(self, task: Task) -> Placement:
        return self.refine(task, self._seed_placement(task))

    def place_many(self, tasks: Iterable[Task]) -> list[Placement]:
        tasks = list(tasks)
        if self.seed_placer is not None:
            seeds = self.seed_placer.place_many(tasks)   # batched decode
        else:
            seeds = [self._seed_placement(t) for t in tasks]
        return [self.refine(t, s) for t, s in zip(tasks, seeds)]
