"""Placement plans: the bridge from DreamShard's assignment vector to the
physical table layout consumed by the fused embedding op.

A ``PlacementPlan`` groups tables per shard (padding groups to a uniform
K_max), builds one per-shard arena layout (tables vertically stacked,
row 0 = zero row), and records the permutation needed to regroup the
indices tensor -- everything static/host-side so the device step stays
shape-uniform across shards.

With a column ``sharding`` (``repro_torch.sharding.ShardSpec``) the
plan's slots hold *column shards* instead of whole tables: ``assignment``
is then ``(S,)`` over the spec's shards, each slot still records its
OWNING table id in ``slot_table`` (a column shard consumes its owner's
full index stream, so index grouping is unchanged) plus its column range
in ``slot_cols``, and it occupies the owner's full row count in its
arena, in lanes ``[0, width)``.  ``embedding.sharded.combine_shard_outputs``
scatters the per-slot outputs back into per-table columns.  Plans without
a sharding are what they were before the field existed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import features as F


@dataclasses.dataclass
class PlacementPlan:
    assignment: np.ndarray        # (M,) table -> shard ((S,) when sharded)
    n_shards: int
    dim: int                      # padded feature dim (128-lane multiple)
    k_max: int                    # tables per shard (padded)
    rows_max: int                 # arena rows per shard (padded, incl. zero row)
    groups: list[np.ndarray]      # table ids per shard (unpadded; column-shard
                                  # ids when sharded)
    base_rows: np.ndarray         # (n_shards, k_max) arena base row per slot
    slot_table: np.ndarray        # (n_shards, k_max) OWNING table id or -1
    table_rows: np.ndarray        # (M,) rows per table
    sharding: object | None = None   # ShardSpec behind a column-sharded plan
    slot_cols: np.ndarray | None = None  # (n_shards, k_max, 2) [start, end)

    @property
    def n_tables(self) -> int:
        if self.sharding is not None:
            return self.sharding.n_tables
        return self.assignment.shape[0]

    @property
    def is_sharded(self) -> bool:
        return self.sharding is not None

    @property
    def shard_rows(self) -> np.ndarray:
        """(n_shards,) rows of each shard's own arena: its zero row plus
        its slots' rows (``rows_max`` is the largest)."""
        return np.asarray([1 + int(self.table_rows[t[t >= 0]].sum())
                           for t in self.slot_table], np.int64)

    def grouped_index_order(self) -> np.ndarray:
        """(n_shards * k_max,) owning table id per grouped slot (-1 =
        padding).  Column shards repeat their owner: every shard of a
        table routes the SAME index stream."""
        return self.slot_table.reshape(-1)


def build_plan(raw_features: np.ndarray, assignment: np.ndarray,
               n_shards: int, pad_dim_to: int = 128,
               sharding=None) -> PlacementPlan:
    assignment = np.asarray(assignment)
    rows = raw_features[:, F.HASH_SIZE].astype(np.int64)
    dim = int(raw_features[:, F.DIM].max())
    dimp = int(np.ceil(dim / pad_dim_to) * pad_dim_to)
    # owner[i]: the table behind grouped item i (identity when unsharded)
    owner = np.arange(rows.shape[0]) if sharding is None else sharding.table
    if assignment.shape[0] != owner.shape[0]:
        raise ValueError(
            f"assignment covers {assignment.shape[0]} items, expected "
            f"{owner.shape[0]} "
            f"({'shards' if sharding is not None else 'tables'})")
    groups = [np.flatnonzero(assignment == s) for s in range(n_shards)]
    k_max = max(1, max(len(g) for g in groups))
    rows_max = 1 + max(int(rows[owner[g]].sum()) if len(g) else 0
                       for g in groups)

    base = np.zeros((n_shards, k_max), np.int64)
    slot = np.full((n_shards, k_max), -1, np.int64)
    cols = None
    if sharding is not None:
        cols = np.zeros((n_shards, k_max, 2), np.int64)
    for s, g in enumerate(groups):
        r = 1                                          # row 0 reserved zero
        for j, i in enumerate(g):
            base[s, j] = r
            slot[s, j] = owner[i]
            if cols is not None:
                cols[s, j] = (sharding.col_start[i], sharding.col_end[i])
            r += int(rows[owner[i]])
    return PlacementPlan(assignment=assignment, n_shards=n_shards, dim=dimp,
                         k_max=k_max, rows_max=rows_max, groups=groups,
                         base_rows=base, slot_table=slot, table_rows=rows,
                         sharding=sharding, slot_cols=cols)
