"""Placement plans: the bridge from DreamShard's assignment vector to the
physical table layout consumed by the fused embedding op.

A ``PlacementPlan`` groups tables per shard (padding groups to a uniform
K_max), builds one per-shard arena layout (tables vertically stacked,
row 0 = zero row), and records the permutation needed to regroup the
indices tensor -- everything static/host-side so the device step stays
shape-uniform across shards.

Whole-table plans only: column-sharded plans wait for the port of
``repro.sharding``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import features as F


@dataclasses.dataclass
class PlacementPlan:
    assignment: np.ndarray        # (M,) table -> shard
    n_shards: int
    dim: int                      # padded feature dim (128-lane multiple)
    k_max: int                    # tables per shard (padded)
    rows_max: int                 # arena rows per shard (padded, incl. zero row)
    groups: list[np.ndarray]      # table ids per shard (unpadded)
    base_rows: np.ndarray         # (n_shards, k_max) arena base row per slot
    slot_table: np.ndarray        # (n_shards, k_max) table id or -1
    table_rows: np.ndarray        # (M,) rows per table

    @property
    def n_tables(self) -> int:
        return self.assignment.shape[0]

    @property
    def shard_rows(self) -> np.ndarray:
        """(n_shards,) rows of each shard's own arena: its zero row plus
        its tables' rows (``rows_max`` is the largest)."""
        return np.asarray([1 + int(self.table_rows[g].sum())
                           for g in self.groups], np.int64)

    def grouped_index_order(self) -> np.ndarray:
        """(n_shards * k_max,) table id per grouped slot (-1 = padding)."""
        return self.slot_table.reshape(-1)


def build_plan(raw_features: np.ndarray, assignment: np.ndarray,
               n_shards: int, pad_dim_to: int = 128) -> PlacementPlan:
    assignment = np.asarray(assignment)
    rows = raw_features[:, F.HASH_SIZE].astype(np.int64)
    dim = int(raw_features[:, F.DIM].max())
    dimp = int(np.ceil(dim / pad_dim_to) * pad_dim_to)
    if assignment.shape[0] != rows.shape[0]:
        raise ValueError(
            f"assignment covers {assignment.shape[0]} items, expected "
            f"{rows.shape[0]} (tables)")
    groups = [np.flatnonzero(assignment == s) for s in range(n_shards)]
    k_max = max(1, max(len(g) for g in groups))
    rows_max = 1 + max(int(rows[g].sum()) if len(g) else 0 for g in groups)

    base = np.zeros((n_shards, k_max), np.int64)
    slot = np.full((n_shards, k_max), -1, np.int64)
    for s, g in enumerate(groups):
        r = 1                                          # row 0 reserved zero
        for j, i in enumerate(g):
            base[s, j] = r
            slot[s, j] = i
            r += int(rows[i])
    return PlacementPlan(assignment=assignment, n_shards=n_shards, dim=dimp,
                         k_max=k_max, rows_max=rows_max, groups=groups,
                         base_rows=base, slot_table=slot, table_rows=rows)
