"""The three search strategy families behind ``SearchPlacer``.

The counterpart of ``repro/search/strategies.py``.  lns and evolution are
host numpy, line for line the reference's, drawing from the caller's
``rng`` in the same order, so over a numpy oracle they propose, score and
adopt the same rows bitwise.  Beam prices its partial placements with the
agent's torch cost network on the agent's device (one
``rollout.estimate_overall`` call per table step, under ``no_grad``, its
``(W*D,)`` estimates back on the host to rank).  The port has no jit, so
the reference's ``jit.retraces`` counter for the beam scorer has no
counterpart here; every other span and counter keeps its name.

All three refine a *seed* placement purely through the scorer's batched
oracle path -- every round proposes one ``(P, M)`` assignment matrix and
pays one ``evaluate_many`` call:

* ``refine_lns``       -- large-neighborhood search: batched single-table
  moves and pairwise swaps around the measured bottleneck device
  (device-imbalance-guided neighborhood selection);
* ``refine_evolution`` -- an evolutionary loop (mutation = k random
  reassignments, crossover = per-table device vote between elites,
  tournament selection) over a population seeded from the proposal;
* ``refine_beam``      -- beam search over the table-by-table MDP
  ordering (``core/mdp.py``'s one-table-per-step environment), scoring
  *partial* placements with the cost network's ``estimate_overall``
  (hardware-free) and finishing only the leaves through the oracle --
  the *Pre-train and Search* recipe.

Strategies only ever improve on the seed: the incumbent is replaced when
a candidate measures strictly cheaper, so the refined cost is <= the
seed cost on every task (``tests/test_search.py`` holds them to it).
Randomness comes exclusively from the caller's ``rng`` stream, consumed
in round order, which makes eval-budgeted runs nested: a larger
``max_evals`` replays the smaller run's rounds exactly and then keeps
going (anytime monotonicity).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import telemetry as tele
from repro_torch.core import networks as N
from repro_torch.core import rollout as R
from repro_torch.search.scoring import SearchScorer

# consecutive rounds allowed to produce zero new admissible candidates
# before a strategy declares its neighborhood exhausted and stops early
# (prevents unmetered spins when the reachable space is tiny)
STALL_LIMIT = 25


@dataclasses.dataclass
class Incumbent:
    """Best placement found so far (assignment in original table order)."""

    assignment: np.ndarray       # (M,)
    cost: float                  # oracle-measured overall ms
    result: object               # SimResult of the incumbent (or None)
    proposed: int = 0            # candidate placements proposed (pre-filter)

    def consider(self, assignments, costs, results) -> bool:
        """Adopt the cheapest strictly-improving row, if any."""
        if len(costs) == 0:
            return False
        i = int(np.argmin(costs))
        if costs[i] < self.cost:
            self.assignment = np.asarray(assignments[i], dtype=np.int64)
            self.cost = float(costs[i])
            self.result = results[i]
            return True
        return False


def _admissible(scorer: SearchScorer, A: np.ndarray,
                enforce_legal: bool) -> np.ndarray:
    """Legality filter (when the seed itself was legal -- refinement must
    never trade memory feasibility for speed) + already-scored dedup."""
    if A.shape[0] and enforce_legal:
        A = A[scorer.legal(A)]
    if A.shape[0]:
        A = scorer.filter_new(A)
    return A


def _device_loads(result, n_devices: int) -> np.ndarray:
    """Per-device busy time of the incumbent -- the neighborhood guide."""
    if result is None:
        return np.ones(n_devices)
    return np.asarray(result.fwd_comp) + np.asarray(result.bwd_comp) \
        + np.asarray(result.bwd_comm)


# ---- large-neighborhood search ----------------------------------------------


def _sample_pairs(rng, n_left: int, n_right: int, k: int):
    """Up to ``k`` distinct (i, j) index pairs from the n_left x n_right
    grid, drawn without replacement."""
    total = n_left * n_right
    if total == 0 or k <= 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    if total <= k:
        flat = np.arange(total)
    else:
        flat = rng.choice(total, size=k, replace=False)
    return flat // n_right, flat % n_right


def _lns_neighborhood(incumbent: Incumbent, rng, neighborhood: int,
                      swap_fraction: float, n_devices: int) -> np.ndarray:
    """One round's ``(P, M)`` candidate matrix around the incumbent.

    The source device is sampled proportionally to squared measured load
    (strongly biased toward the bottleneck -- the only device whose
    tables can lower the stage maxima -- but still exploring others so
    repeated rounds don't re-propose one exhausted neighborhood).
    Candidates are single-table moves off the source plus pairwise swaps
    between the source and the rest.
    """
    a = incumbent.assignment
    M, D = a.shape[0], n_devices
    loads = np.maximum(_device_loads(incumbent.result, D), 0.0) ** 2
    p = loads / loads.sum() if loads.sum() > 0 else np.full(D, 1.0 / D)
    src = int(rng.choice(D, p=p))
    on_src = np.flatnonzero(a == src)
    if on_src.size == 0:                      # idle device: nothing to move
        src = int(rng.choice(np.flatnonzero(
            np.bincount(a, minlength=D) > 0)))
        on_src = np.flatnonzero(a == src)
    off_src = np.flatnonzero(a != src)
    targets = np.array([d for d in range(D) if d != src])

    n_swaps = int(round(neighborhood * swap_fraction))
    n_moves = max(0, neighborhood - n_swaps)
    rows = []
    ti, di = _sample_pairs(rng, on_src.size, targets.size, n_moves)
    if ti.size:                                # single-table moves
        A = np.tile(a, (ti.size, 1))
        A[np.arange(ti.size), on_src[ti]] = targets[di]
        rows.append(A)
    ti, ui = _sample_pairs(rng, on_src.size, off_src.size, n_swaps)
    if ti.size:                                # pairwise swaps
        A = np.tile(a, (ti.size, 1))
        t, u = on_src[ti], off_src[ui]
        idx = np.arange(ti.size)
        A[idx, t] = a[u]
        A[idx, u] = src
        rows.append(A)
    if not rows:
        return np.empty((0, M), np.int64)
    return np.concatenate(rows)


def refine_lns(scorer: SearchScorer, rng, cfg, incumbent: Incumbent,
               enforce_legal: bool) -> Incumbent:
    stall = 0
    rounds = 0
    while not scorer.out_of_budget() and stall < STALL_LIMIT:
        if cfg.max_rounds is not None and rounds >= cfg.max_rounds:
            break
        rounds += 1
        with tele.span("search.round", strategy="lns",
                       round=rounds) as sp:
            A = _lns_neighborhood(incumbent, rng, cfg.neighborhood,
                                  cfg.swap_fraction, scorer.n_devices)
            incumbent.proposed += A.shape[0]
            A = _admissible(scorer, A, enforce_legal)
            if A.shape[0] == 0:
                stall += 1
                sp.set(stalled=True)
                continue
            stall = 0
            costs, results = scorer.score(A)
            incumbent.consider(A, costs, results)
            sp.set(incumbent_ms=incumbent.cost,
                   remaining_evals=scorer.remaining_evals(),
                   remaining_ms=scorer.remaining_ms())
    return incumbent


# ---- evolutionary search ----------------------------------------------------


def _mutate(a: np.ndarray, rng, k: int, n_devices: int) -> np.ndarray:
    """k random reassignments, each to a uniformly drawn OTHER device."""
    out = a.copy()
    k = min(max(1, k), a.shape[0])
    tables = rng.choice(a.shape[0], size=k, replace=False)
    out[tables] = (out[tables]
                   + rng.integers(1, n_devices, size=k)) % n_devices
    return out


def _crossover_vote(elites: np.ndarray, rng, n_devices: int) -> np.ndarray:
    """Per-table device vote between elites; ties break uniformly."""
    E, M = elites.shape
    counts = np.zeros((M, n_devices))
    for row in elites:
        counts[np.arange(M), row] += 1.0
    # sub-vote noise perturbs only ties, never a strict majority
    counts += rng.uniform(0.0, 0.5, size=counts.shape)
    return np.argmax(counts, axis=1).astype(np.int64)


def _tournament(rng, costs: np.ndarray, k: int) -> int:
    idx = rng.integers(costs.shape[0], size=max(1, k))
    return int(idx[np.argmin(costs[idx])])


def refine_evolution(scorer: SearchScorer, rng, cfg,
                     incumbent: Incumbent, enforce_legal: bool) -> Incumbent:
    D = scorer.n_devices
    pop_a = [incumbent.assignment]
    pop_c = [incumbent.cost]

    def admit(A):
        incumbent.proposed += A.shape[0]
        A = _admissible(scorer, A, enforce_legal)
        if A.shape[0] == 0:
            return False
        costs, results = scorer.score(A)
        incumbent.consider(A, costs, results)
        ok = np.isfinite(costs)
        pop_a.extend(A[ok])
        pop_c.extend(costs[ok])
        # survival of the fittest: trim back to the population size
        if len(pop_a) > cfg.population:
            order = np.argsort(pop_c, kind="stable")[:cfg.population]
            pop_a[:] = [pop_a[i] for i in order]
            pop_c[:] = [pop_c[i] for i in order]
        return True

    init = np.stack([_mutate(incumbent.assignment, rng, cfg.mutations, D)
                     for _ in range(cfg.population - 1)])
    if not scorer.out_of_budget():
        admit(init)

    stall = 0
    rounds = 0
    while not scorer.out_of_budget() and stall < STALL_LIMIT:
        if cfg.max_rounds is not None and rounds >= cfg.max_rounds:
            break
        rounds += 1
        with tele.span("search.round", strategy="evolution",
                       round=rounds) as sp:
            costs = np.asarray(pop_c)
            order = np.argsort(costs, kind="stable")
            elites = np.stack([pop_a[i]
                               for i in order[:max(1, cfg.elites)]])
            children = []
            for _ in range(cfg.population):
                if elites.shape[0] >= 2 and \
                        rng.random() < cfg.crossover_rate:
                    child = _crossover_vote(elites, rng, D)
                else:
                    child = pop_a[_tournament(rng, costs, cfg.tournament)]
                children.append(_mutate(child, rng, cfg.mutations, D))
            if not admit(np.stack(children)):
                stall += 1
                sp.set(stalled=True)
            else:
                stall = 0
            sp.set(incumbent_ms=incumbent.cost,
                   remaining_evals=scorer.remaining_evals(),
                   remaining_ms=scorer.remaining_ms())
    return incumbent


# ---- beam search over the placement MDP -------------------------------------

def refine_beam(scorer: SearchScorer, rng, cfg, incumbent: Incumbent,
                enforce_legal: bool, agent) -> Incumbent:
    """Beam search over the one-table-per-step MDP, cost-net guided.

    Tables are visited in the agent's descending predicted-cost order
    (the ``core/mdp.py`` / Algorithm-2 ordering).  Each step expands
    every beam entry to all devices, prices the partial placements with
    the cost network's ``estimate_overall`` over running device sums
    (zero oracle budget -- the estimated MDP), applies the memory
    legality mask with the rollout's no-legal-device fallback, breaks
    empty-device symmetry (a table may only open the lowest-indexed
    empty device), and keeps the ``beam_width`` cheapest.  Only the
    surviving leaves are measured through the oracle, best-estimate
    first, so a tiny eval budget still scores the most promising leaf.
    """
    task = scorer.task
    D = scorer.n_devices
    feats, sizes_gb, order = agent._inference_inputs(task.raw_features)
    feats_s, sizes_s = feats[order], sizes_gb[order]
    net, dev_t = agent.cost_net, agent.device
    with torch.no_grad():
        h = N.cost_table_reprs(net, torch.as_tensor(feats_s, device=dev_t))
    h = h.cpu().numpy().astype(np.float32)
    M, H = h.shape
    W = max(1, cfg.beam_width)
    cap = scorer.oracle.mem_capacity_gb

    def score_fn(partial):               # (B, D, H) device sums -> (B,)
        with torch.no_grad():
            est = R.estimate_overall(
                net, torch.as_tensor(partial, device=dev_t),
                agent.cfg.reward_mode, agent._log_targets)
        return est.cpu().numpy()

    assign = np.zeros((W, M), np.int64)
    dev = np.zeros((W, D, H), np.float32)
    mem = np.zeros((W, D), np.float64)
    used = np.zeros((W, D), bool)
    alive = np.zeros(W, bool)
    alive[0] = True
    leaf_est = np.full(W, np.inf)

    rows = np.arange(W)
    with tele.span("search.beam_expand", W=W, M=M, n_devices=D):
        for t in range(M):
            legal = (mem + sizes_s[t]) <= cap                # (W, D)
            none_legal = ~legal.any(axis=1)
            legal[none_legal] = True            # rollout's fallback rule
            # symmetry breaking: empty devices are interchangeable, so
            # only the lowest-indexed one may be opened by this table
            empty = ~used
            first_empty = np.argmax(empty, axis=1)
            allowed = used.copy()
            has_empty = empty.any(axis=1)
            allowed[rows[has_empty], first_empty[has_empty]] = True
            legal &= allowed

            cand = np.repeat(dev[:, None], D, axis=1)        # (W, D, D, H)
            cand[:, np.arange(D), np.arange(D), :] += h[t]
            est = score_fn(cand.reshape(W * D, D, H))
            est = est.reshape(W, D).astype(np.float64)
            est[~legal] = np.inf
            est[~alive] = np.inf
            sel = np.argsort(est, axis=None, kind="stable")[:W]
            w_idx, d_idx = np.unravel_index(sel, (W, D))

            leaf_est = est[w_idx, d_idx]
            new_alive = np.isfinite(leaf_est)
            assign = assign[w_idx]
            assign[new_alive, t] = d_idx[new_alive]
            dev = cand[w_idx, d_idx]
            mem = mem[w_idx]
            mem[new_alive, d_idx[new_alive]] += sizes_s[t]
            used = used[w_idx]
            used[new_alive, d_idx[new_alive]] = True
            alive = new_alive

    if not alive.any():
        return incumbent
    leaves_sorted = assign[alive][np.argsort(leaf_est[alive], kind="stable")]
    # back to original table order: sorted slot t holds table order[t]
    leaves = np.empty_like(leaves_sorted)
    leaves[:, order] = leaves_sorted
    incumbent.proposed += leaves.shape[0]
    leaves = _admissible(scorer, leaves, enforce_legal)
    if leaves.shape[0] and not scorer.out_of_budget():
        with tele.span("search.round", strategy="beam",
                       leaves=int(leaves.shape[0])) as sp:
            costs, results = scorer.score(leaves)
            incumbent.consider(leaves, costs, results)
            sp.set(incumbent_ms=incumbent.cost,
                   remaining_evals=scorer.remaining_evals(),
                   remaining_ms=scorer.remaining_ms())
    return incumbent
