"""``ShardingPlacer``: column-split tables so infeasible tasks place.

The counterpart of ``repro/sharding/placer.py`` (host numpy: the packing
and the spec moves draw no random numbers, so the port returns the
reference's placements over the same oracle).

A whole-table placer cannot place a task whose largest table exceeds one
device's HBM -- every assignment is illegal.  ``ShardingPlacer`` wraps
any inner placer (expert by default) and post-processes its proposal:
tables whose footprint exceeds ``headroom * mem_capacity_gb`` split
column-wise into K near-even ranges (K chosen so each shard fits), the
``split_hottest`` highest-traffic tables optionally split in two for
load spreading, and the resulting shards pack greedily
(tightest-fit-decreasing, a table's shards on distinct devices).  When
nothing needs splitting and the inner proposal is legal, the inner
placement comes back relabeled -- the K = 1 path stays the legacy path.

``refine_sharded`` adds the anytime loop on top: shard-move/swap
neighborhoods via ``SearchPlacer`` (lns/evolution operate on shard rows
unchanged) interleaved with split/merge mutations of the spec itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import telemetry as tele
from repro_torch.api.oracle import (ensure_oracle, evaluate_sharded,
                                    legal_batch, legal_sharded)
from repro_torch.api.placement import BasePlacer, Placement, Placer
from repro_torch.core import features as F
from repro_torch.core.baselines import expert_place
from repro_torch.data.tasks import Task
from repro_torch.search.placer import SearchConfig, SearchPlacer
from repro_torch.sharding.spec import (ShardSpec, project_assignment,
                                       shard_sizes_gb)


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Knobs for ``ShardingPlacer``.

    ``headroom`` is the fill fraction targeted when sizing K (a 10 GB
    table on 11 GB devices at 0.9 headroom splits into 2, not 1, so the
    shard leaves room for co-residents).  ``split_hottest`` additionally
    splits that many highest-traffic (``dim * pooling``) tables in two
    even when they fit.  ``max_retries`` bounds the split-and-repack
    rounds when greedy packing still comes back illegal.  ``refine``
    (a ``SearchConfig``) turns on shard-move search over the packed
    assignment; its ``"beam"`` stage is whole-table only and rejected.
    """

    headroom: float = 0.9
    split_hottest: int = 0
    max_retries: int = 8
    refine: SearchConfig | None = None

    def __post_init__(self):
        if not 0.0 < self.headroom <= 1.0:
            raise ValueError(f"headroom must be in (0, 1], "
                             f"got {self.headroom}")
        if self.refine is not None and "beam" in self.refine.stages():
            raise ValueError("ShardingConfig.refine cannot use the 'beam' "
                             "stage (whole-table only); use lns/evolution")


def pack_shards(raw: np.ndarray, spec: ShardSpec, n_devices: int,
                capacity_gb: float,
                table_seed: np.ndarray | None = None) -> np.ndarray:
    """Greedy tightest-fit-decreasing packing of a spec's shards.

    Shards go largest-first onto the most-loaded device that still fits
    them (classic best-fit: preserves large holes for large shards), a
    table's shards always on DISTINCT devices.  Unsplit (K = 1) tables
    keep ``table_seed``'s device when it fits, so a legal inner proposal
    survives the post-processing wherever possible.  Always returns a
    complete ``(S,)`` assignment; when the task genuinely does not fit
    the overflow lands on the least-loaded device (illegal, best-effort,
    detectable via ``legal_sharded``).
    """
    raw = np.asarray(raw, dtype=np.float64)
    sizes = shard_sizes_gb(raw, spec)
    counts = spec.shard_counts
    mem = np.zeros(n_devices)
    out = np.full(spec.n_shards, -1, np.int64)
    for s in np.argsort(-sizes, kind="stable"):
        t = int(spec.table[s])
        siblings = out[spec.table == t]
        used = set(int(d) for d in siblings[siblings >= 0])
        free = np.array([d for d in range(n_devices) if d not in used],
                        np.int64)
        if free.size == 0:                 # K > n_devices shouldn't happen,
            free = np.arange(n_devices)    # but never leave a shard unplaced
        fits = free[mem[free] + sizes[s] <= capacity_gb]
        pick = None
        if table_seed is not None and counts[t] == 1:
            d0 = int(table_seed[t])
            if d0 in fits:
                pick = d0
        if pick is None and fits.size:
            pick = int(fits[np.argmax(mem[fits])])       # tightest fit
        if pick is None:
            pick = int(free[np.argmin(mem[free])])       # overflow fallback
        out[s] = pick
        mem[pick] += sizes[s]
    return out


def _shard_limit(raw: np.ndarray, n_devices: int) -> np.ndarray:
    """Max K per table: can't exceed the column count, and siblings live
    on distinct devices so K <= n_devices."""
    dims = np.asarray(raw, np.float64)[:, F.DIM].astype(np.int64)
    return np.minimum(np.maximum(dims, 1), n_devices)


def _grow_spec(raw: np.ndarray, spec: ShardSpec,
               n_devices: int) -> ShardSpec | None:
    """Split the table owning the largest still-growable shard one step
    further (the move most likely to fix an illegal packing), or None
    when every table is at its shard limit."""
    sizes = shard_sizes_gb(raw, spec)
    k = spec.shard_counts
    limit = _shard_limit(raw, n_devices)
    growable = k[spec.table] < limit[spec.table]
    if not growable.any():
        return None
    s = int(np.flatnonzero(growable)[np.argmax(sizes[growable])])
    return spec.split(int(spec.table[s]))


class ShardingPlacer(BasePlacer):
    """Wrap any whole-table placer with column-wise sharding.

    ``inner=None`` seeds from the greedy size-balance expert.  The
    wrapped proposal is returned untouched (relabeled) when no table
    needs splitting and it is already legal; otherwise oversized /
    hottest tables split, shards repack, and packing retries with
    progressively finer splits until legal or out of retries.
    """

    def __init__(self, oracle, inner: Placer | None = None,
                 config: ShardingConfig | None = None):
        self.oracle = ensure_oracle(oracle)
        self.inner = inner
        self.config = config if config is not None else ShardingConfig()
        inner_name = inner.name if inner is not None else "expert"
        self.name = f"sharding({inner_name})"

    # ---- spec sizing --------------------------------------------------------

    def required_spec(self, task: Task) -> ShardSpec:
        """The split this placer would apply to a task: K =
        ceil(size / (headroom * capacity)) per table (1 for tables that
        fit), plus the ``split_hottest`` traffic leaders at K >= 2,
        clamped to each table's shard limit."""
        raw = np.asarray(task.raw_features, dtype=np.float64)
        cfg = self.config
        budget = max(self.oracle.mem_capacity_gb * cfg.headroom, 1e-12)
        k = np.ceil(raw[:, F.TABLE_SIZE_GB] / budget).astype(np.int64)
        k = np.maximum(k, 1)
        if cfg.split_hottest > 0:
            traffic = raw[:, F.DIM] * raw[:, F.POOLING]
            hot = np.argsort(-traffic, kind="stable")[:cfg.split_hottest]
            k[hot] = np.maximum(k[hot], 2)
        return ShardSpec.even(raw, np.minimum(
            k, _shard_limit(raw, task.n_devices)))

    # ---- placement ----------------------------------------------------------

    def _seed(self, task: Task) -> Placement:
        if self.inner is not None:
            return self.inner.place(task)
        a = expert_place(task.raw_features, task.n_devices,
                         self.oracle.mem_capacity_gb, "size")
        return self._wrap(task, a)

    def place(self, task: Task) -> Placement:
        with tele.span("sharding.place", M=task.n_tables,
                       n_devices=task.n_devices) as sp:
            out = self._place_impl(task)
            sp.set(n_shards=out.n_shards, sharded=out.is_sharded)
            return out

    def _place_impl(self, task: Task) -> Placement:
        raw = np.asarray(task.raw_features, dtype=np.float64)
        seed = self._seed(task)
        seed_a = np.asarray(seed.assignment, dtype=np.int64)
        spec = self.required_spec(task)
        if spec.is_trivial and bool(legal_batch(
                self.oracle, raw, seed_a[None], task.n_devices)[0]):
            return dataclasses.replace(seed, strategy=self.name)

        cap = self.oracle.mem_capacity_gb
        shard_a = pack_shards(raw, spec, task.n_devices, cap,
                              table_seed=seed_a)
        retries = 0
        while retries < self.config.max_retries and not bool(legal_sharded(
                self.oracle, raw, spec, shard_a[None], task.n_devices)[0]):
            finer = _grow_spec(raw, spec, task.n_devices)
            if finer is None:
                break                       # at the shard limit everywhere
            spec, retries = finer, retries + 1
            shard_a = pack_shards(raw, spec, task.n_devices, cap,
                                  table_seed=seed_a)
        tele.count("sharding.pack_retries", retries)

        hw0 = self.oracle.num_evaluations
        res = evaluate_sharded(self.oracle, raw, spec, shard_a[None],
                               task.n_devices)
        placement = self._wrap(
            task, shard_a, est_cost_ms=float(res[0].overall),
            candidates=seed.candidates + retries + 1,
            oracle_evals=seed.oracle_evals
            + (self.oracle.num_evaluations - hw0),
            sharding=spec)
        if self.config.refine is not None:
            searcher = SearchPlacer(self.oracle, config=self.config.refine,
                                    name=self.name)
            placement = searcher.refine(task, placement)
        return placement


def refine_sharded(oracle, task: Task, placement: Placement,
                   config: SearchConfig | None = None, *,
                   split_rounds: int = 2) -> Placement:
    """Anytime refinement over shard assignment AND split structure.

    Alternates ``SearchPlacer`` shard-move/swap search (lns/evolution on
    the ``(S,)`` rows) with split/merge mutations of the spec: each
    round proposes splitting the largest growable shard's table and
    merging the smallest split table, repacks, re-searches, and adopts a
    mutation only when it is strictly better (legality first, then
    cost).  A whole-table seed enters as the trivial (K = 1) spec, so
    this also upgrades legacy placements in place.
    """
    oracle = ensure_oracle(oracle)
    cfg = config if config is not None else SearchConfig()
    searcher = SearchPlacer(oracle, config=cfg,
                            name=f"refine_sharded[{cfg.strategy}]")
    raw = np.asarray(task.raw_features, dtype=np.float64)
    if placement.sharding is None:
        placement = searcher._wrap(
            task, np.asarray(placement.assignment, np.int64),
            est_cost_ms=placement.est_cost_ms,
            candidates=placement.candidates,
            oracle_evals=placement.oracle_evals,
            sharding=ShardSpec.trivial(raw))

    def measure(p: Placement) -> tuple[bool, float]:
        legal = bool(legal_sharded(oracle, raw, p.sharding,
                                   p.shard_assignment[None],
                                   task.n_devices)[0])
        res = evaluate_sharded(oracle, raw, p.sharding,
                               p.shard_assignment[None], task.n_devices)
        return legal, float(res[0].overall)

    best = searcher.refine(task, placement)
    best_legal, best_cost = measure(best)
    cap = oracle.mem_capacity_gb
    for _ in range(max(0, split_rounds)):
        spec = best.sharding
        candidates: list[ShardSpec] = []
        finer = _grow_spec(raw, spec, task.n_devices)
        if finer is not None:
            candidates.append(finer)
        split_tables = np.flatnonzero(spec.shard_counts > 1)
        if split_tables.size:
            t = int(split_tables[np.argmin(
                raw[split_tables, F.TABLE_SIZE_GB])])
            candidates.append(spec.merge(t))
        improved = False
        seed_tables = project_assignment(spec, best.shard_assignment)
        for cand_spec in candidates:
            a = pack_shards(raw, cand_spec, task.n_devices, cap,
                            table_seed=seed_tables)
            cand = searcher.refine(task, searcher._wrap(
                task, a, sharding=cand_spec))
            cand_legal, cand_cost = measure(cand)
            if (cand_legal, -cand_cost) > (best_legal, -best_cost):
                best, best_legal, best_cost = cand, cand_legal, cand_cost
                improved = True
        if not improved:
            break
    tele.count("sharding.refine_calls", 1)
    return best
