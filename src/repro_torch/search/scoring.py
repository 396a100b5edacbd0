"""Budget-tracked batched scoring: the one oracle seam every search
strategy shares.

The counterpart of ``repro/search/scoring.py``.  A ``SearchScorer``
binds a task to a ``CostOracle`` and meters an **anytime budget** over
it: a wall-clock deadline (``budget_ms``), an oracle-evaluation cap
(``max_evals``), or both.  Every candidate batch a strategy proposes goes
through ONE ``evaluate_many`` call, capped to the remaining eval budget
-- so the cost of a search round is vector width, not Python call count,
and a run with a larger ``max_evals`` scores a strict superset of the
placements a smaller one scores (the anytime-monotonicity guarantee
rests on this).

Budget semantics:

* ``max_evals`` counts candidate ROWS sent to the oracle -- a
  deterministic meter, independent of wall clock and of cache state, so
  eval-budgeted searches reproduce bit-for-bit across hosts.  Wrapping
  the scorer's oracle in a ``CachedOracle`` still pays fewer *hardware*
  measurements (``hardware_evals`` reports the inner count) and less
  wall time; it does not stretch the row budget.
* ``budget_ms`` is a wall-clock deadline checked between rounds (and
  before the first): a strategy never *starts* work past the deadline,
  but an in-flight batch runs to completion -- results already paid for
  are always consumed.
* A scorer with neither bound is infinite; strategies must then bound
  themselves (``SearchConfig.max_rounds`` does).
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch import telemetry as tele
from repro_torch.api.oracle import (ensure_oracle, evaluate_many,
                                    evaluate_sharded, legal_batch,
                                    legal_sharded)
from repro_torch.data.tasks import Task


class SearchScorer:
    """Meters one task's search budget over a ``CostOracle``.

    With a ``sharding`` (``repro_torch.sharding.ShardSpec``) candidate rows are
    ``(P, S)`` *shard* assignments, scored through ``evaluate_sharded`` /
    ``legal_sharded`` instead of the whole-table paths -- the strategies
    on top propose/dedup/adopt rows identically either way (a shard move
    IS a table move over the expanded items).
    """

    def __init__(self, oracle, task: Task,
                 budget_ms: float | None = None,
                 max_evals: int | None = None, sharding=None):
        self.oracle = ensure_oracle(oracle)
        self.task = task
        self.raw = task.raw_features
        self.n_devices = task.n_devices
        self.sharding = sharding
        self.max_evals = max_evals
        self._deadline = (None if budget_ms is None
                          else time.perf_counter() + budget_ms / 1e3)
        self.evals = 0            # candidate rows sent to the oracle
        self.batches = 0          # evaluate_many calls issued
        self._hardware_evals = 0  # inner-oracle measurements, this scorer
        self._seen: set[bytes] = set()

    # ---- budget -------------------------------------------------------------

    def out_of_budget(self) -> bool:
        """True once either bound is exhausted (checked between rounds)."""
        if self.max_evals is not None and self.evals >= self.max_evals:
            return True
        if self._deadline is not None and \
                time.perf_counter() >= self._deadline:
            return True
        return False

    def remaining_evals(self) -> int | None:
        """Eval-row headroom (``None`` = unmetered)."""
        if self.max_evals is None:
            return None
        return max(0, self.max_evals - self.evals)

    def remaining_ms(self) -> float | None:
        """Wall-clock headroom before the deadline (``None`` =
        undeadlined; clamped at 0 once past it)."""
        if self._deadline is None:
            return None
        return max(0.0, (self._deadline - time.perf_counter()) * 1e3)

    @property
    def hardware_evals(self) -> int:
        """Measurements the oracle actually performed *for this scorer* --
        under a ``CachedOracle`` this is the miss count, i.e. how much of
        the row budget the cache absorbed.

        Accumulated per ``score()`` call (delta of the oracle's
        ``num_evaluations`` across the batched pass), NOT as one delta
        since construction -- a shared oracle may serve other traffic
        (e.g. a benchmark's baseline sweep between searches), and that
        must not be billed to this scorer.
        """
        return self._hardware_evals

    # ---- candidate filtering ------------------------------------------------

    def legal(self, assignments: np.ndarray) -> np.ndarray:
        """Vectorized ``(P,)`` memory-legality -- free, no eval budget."""
        if self.sharding is not None:
            return legal_sharded(self.oracle, self.raw, self.sharding,
                                 assignments, self.n_devices)
        return legal_batch(self.oracle, self.raw, assignments,
                           self.n_devices)

    def filter_new(self, assignments: np.ndarray) -> np.ndarray:
        """Drop rows this scorer has already scored (or queued in this
        very batch) so near-duplicate neighborhoods don't burn budget;
        marks the survivors as seen.  Returns the filtered ``(P', M)``."""
        A = np.asarray(assignments, dtype=np.int64)
        keep = []
        for i, row in enumerate(A):
            key = row.tobytes()
            if key not in self._seen:
                self._seen.add(key)
                keep.append(i)
        return A[keep]

    # ---- scoring ------------------------------------------------------------

    def score(self, assignments: np.ndarray):
        """Measure up to ``remaining_evals`` rows in ONE batched pass.

        Returns ``(costs (P,), results list)``: rows beyond the eval
        budget get ``inf`` cost and ``None`` result (strategies treat
        them as unevaluated, never as cheap).  Row order is preserved, so
        deterministic proposal order + row-capped scoring keeps a larger
        budget's scored set a superset of a smaller one's.
        """
        A = np.asarray(assignments, dtype=np.int64)
        P = A.shape[0]
        costs = np.full(P, np.inf)
        results: list = [None] * P
        cap = P if self.max_evals is None else \
            min(P, max(0, self.max_evals - self.evals))
        if cap == 0:
            return costs, results
        hw0 = self.oracle.num_evaluations
        with tele.span("search.score", rows=cap,
                       n_devices=self.n_devices) as sp:
            if self.sharding is not None:
                res = evaluate_sharded(self.oracle, self.raw, self.sharding,
                                       A[:cap], self.n_devices)
            else:
                res = evaluate_many(self.oracle, self.raw, A[:cap],
                                    self.n_devices)
            sp.set(hardware_evals=self.oracle.num_evaluations - hw0)
        self._hardware_evals += self.oracle.num_evaluations - hw0
        self.evals += cap
        self.batches += 1
        tele.count("search.scored_rows", cap)
        for i, r in enumerate(res):
            costs[i] = r.overall
            results[i] = r
        return costs, results
