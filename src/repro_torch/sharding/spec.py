"""Column-wise table sharding: the ``ShardSpec`` schema and the
expanded-features transform every shard-aware consumer shares.

The counterpart of ``repro/sharding/spec.py``, float64/int64 numpy as
there: the expanded bytes feed the digests and cache keys, and a torch
round trip would break the K = 1 identity below.

A ``ShardSpec`` describes how each of a task's M tables splits into K >= 1
contiguous column ranges ("shards").  The whole stack prices and places
shards through ONE transform: ``shard_features`` expands the task's
``(M, 21)`` raw feature matrix into an ``(S, 21)`` per-shard matrix where
each shard inherits its owner's row count / pooling / access histogram,
its ``dim`` becomes the column width, and its ``table_size_gb`` scales by
``width / dim``.  A shard then *is* a table as far as the cost models,
legality checks, digests, and caches are concerned -- the sharded problem
reduces to the whole-table problem over S pseudo-tables, and every
batched path (``evaluate_many`` / ``legal_batch`` / key machinery) works
unchanged on ``(P, S)`` shard-assignment matrices.

The K = 1 guarantee: a trivial spec (every table one shard spanning
``[0, dim)``) expands to the raw feature matrix BYTE-IDENTICALLY
(``width / dim == 1.0`` exactly in float64), so costs, noise digests,
cache keys, and legality verdicts are bitwise what the legacy whole-table
path produces.  Nothing special-cases K = 1 downstream; identity falls
out of the bytes.

Specs are canonical by construction (shards sorted by owning table, then
by ``col_start``; ranges tile ``[0, dim)`` exactly), so equal shardings
serialize to equal bytes -- the property the digest stability tests pin.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import features as F


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Column ranges for every shard of a task's tables (canonical form).

    ``table[s]`` is shard ``s``'s owning table; ``col_start[s]:col_end[s]``
    is the half-open column range it carries.  Shards are ordered by
    ``(table, col_start)``, each table owns at least one shard, and a
    table's shards tile ``[0, dim)`` contiguously -- validated against the
    ``dims`` recorded at construction.
    """

    table: np.ndarray       # (S,) shard -> owning table id
    col_start: np.ndarray   # (S,) first column (inclusive)
    col_end: np.ndarray     # (S,) last column (exclusive)
    dims: np.ndarray        # (M,) full column count per table

    def __post_init__(self):
        t = np.ascontiguousarray(np.asarray(self.table, np.int64))
        cs = np.ascontiguousarray(np.asarray(self.col_start, np.int64))
        ce = np.ascontiguousarray(np.asarray(self.col_end, np.int64))
        d = np.ascontiguousarray(np.asarray(self.dims, np.int64))
        object.__setattr__(self, "table", t)
        object.__setattr__(self, "col_start", cs)
        object.__setattr__(self, "col_end", ce)
        object.__setattr__(self, "dims", d)
        M = d.shape[0]
        if t.shape != cs.shape or t.shape != ce.shape or t.ndim != 1:
            raise ValueError("table/col_start/col_end must be 1-D and "
                             "equal length")
        if t.size < M or (np.diff(t) < 0).any():
            raise ValueError("shards must be sorted by owning table and "
                             "cover every table")
        if t.size and (t[0] != 0 or t[-1] != M - 1
                       or np.setdiff1d(np.arange(M), t).size):
            raise ValueError(f"shards must cover tables 0..{M - 1}, "
                             f"got owners {np.unique(t)}")
        if (ce <= cs).any():
            raise ValueError("every shard needs a positive column width")
        # per-table tiling: first shard starts at 0, ranges are contiguous
        # (next col_start == previous col_end), last shard ends at dim
        first = np.concatenate([[True], np.diff(t) > 0]) if t.size \
            else np.zeros(0, bool)
        if (cs[first] != 0).any():
            raise ValueError("each table's first shard must start at col 0")
        same = ~first[1:] if t.size > 1 else np.zeros(0, bool)
        if (cs[1:][same] != ce[:-1][same]).any():
            raise ValueError("a table's shards must be contiguous "
                             "(col_start == previous col_end)")
        last = np.concatenate([first[1:], [True]]) if t.size else first
        if (ce[last] != d[t[last]]).any():
            raise ValueError("each table's last shard must end at its dim")

    # ---- views --------------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return self.table.shape[0]

    @property
    def n_tables(self) -> int:
        return self.dims.shape[0]

    @property
    def widths(self) -> np.ndarray:
        """Column width per shard ``(S,)``."""
        return self.col_end - self.col_start

    @property
    def shard_counts(self) -> np.ndarray:
        """K per table ``(M,)``."""
        return np.bincount(self.table, minlength=self.n_tables)

    @property
    def first_shard(self) -> np.ndarray:
        """Index of each table's first shard ``(M,)`` (the shard whose
        device the legacy ``(M,)`` assignment projection reports)."""
        counts = self.shard_counts
        return np.concatenate([[0], np.cumsum(counts)[:-1]])

    @property
    def is_trivial(self) -> bool:
        """True when every table is whole (K = 1 everywhere) -- the case
        whose expansion is byte-identical to the raw features."""
        return self.n_shards == self.n_tables

    def to_bytes(self) -> bytes:
        """Canonical serialization (specs are canonical, so equal
        shardings -- same split points -- give equal bytes)."""
        return (self.table.tobytes() + self.col_start.tobytes()
                + self.col_end.tobytes() + self.dims.tobytes())

    # ---- construction -------------------------------------------------------

    @classmethod
    def trivial(cls, raw: np.ndarray) -> "ShardSpec":
        """One whole-table shard per table (the K = 1 identity spec)."""
        dims = np.asarray(raw, np.float64)[:, F.DIM].astype(np.int64)
        M = dims.shape[0]
        return cls(table=np.arange(M), col_start=np.zeros(M, np.int64),
                   col_end=dims, dims=dims)

    @classmethod
    def even(cls, raw: np.ndarray, k) -> "ShardSpec":
        """Split table ``t`` into ``k[t]`` near-equal contiguous column
        ranges (``k`` scalar or ``(M,)``; clamped to ``[1, dim]``)."""
        dims = np.asarray(raw, np.float64)[:, F.DIM].astype(np.int64)
        M = dims.shape[0]
        k = np.broadcast_to(np.asarray(k, np.int64), (M,))
        k = np.clip(k, 1, np.maximum(dims, 1))
        table, cs, ce = [], [], []
        for t in range(M):
            # deterministic near-even split via truncated linspace bounds
            bounds = np.linspace(0, dims[t], k[t] + 1).astype(np.int64)
            table.extend([t] * int(k[t]))
            cs.extend(bounds[:-1].tolist())
            ce.extend(bounds[1:].tolist())
        return cls(table=np.asarray(table, np.int64),
                   col_start=np.asarray(cs, np.int64),
                   col_end=np.asarray(ce, np.int64), dims=dims)

    def split(self, t: int) -> "ShardSpec":
        """One more shard for table ``t``: re-split it evenly into K + 1
        parts (no-op spec copy when already at ``dim`` shards)."""
        k = self.shard_counts.copy()
        if k[t] < self.dims[t]:
            k[t] += 1
        return self._resplit(k)

    def merge(self, t: int) -> "ShardSpec":
        """One fewer shard for table ``t`` (even re-split; no-op at 1)."""
        k = self.shard_counts.copy()
        if k[t] > 1:
            k[t] -= 1
        return self._resplit(k)

    def _resplit(self, k: np.ndarray) -> "ShardSpec":
        raw_like = np.zeros((self.n_tables, F.NUM_FEATURES))
        raw_like[:, F.DIM] = self.dims
        return ShardSpec.even(raw_like, k)


def shard_features(raw: np.ndarray, spec: ShardSpec) -> np.ndarray:
    """Expand ``(M, 21)`` raw table features into ``(S, 21)`` per-shard
    features -- THE transform behind every shard-aware code path.

    Each shard copies its owner's row (same hash size, pooling, access
    histogram: a column slice sees the identical index stream), with
    ``dim`` replaced by the column width and ``table_size_gb`` scaled by
    ``width / dim``.  Two shards of one table co-resident on a device
    then correctly occupy disjoint cache/memory bytes, and the simulator's
    cache-hit curve sees each shard's own (smaller) working set.

    For a trivial spec the result is byte-identical to
    ``np.asarray(raw, float64)`` (``width / dim == 1.0`` exactly), which
    is what makes K = 1 sharded costs, noise digests, and cache keys
    bitwise-equal to the legacy whole-table path.
    """
    raw = np.ascontiguousarray(np.asarray(raw, dtype=np.float64))
    if raw.shape[0] != spec.n_tables:
        raise ValueError(f"spec covers {spec.n_tables} tables, raw has "
                         f"{raw.shape[0]}")
    if spec.is_trivial:
        return raw
    out = raw[spec.table].copy()
    width = spec.widths.astype(np.float64)
    frac = width / raw[spec.table, F.DIM]
    out[:, F.DIM] = width
    out[:, F.TABLE_SIZE_GB] *= frac
    return np.ascontiguousarray(out)


def shard_sizes_gb(raw: np.ndarray, spec: ShardSpec) -> np.ndarray:
    """Memory footprint per shard ``(S,)`` -- what per-device legality
    sums.  A table's shard sizes sum to its ``table_size_gb`` (up to
    float rounding of the width fractions)."""
    return shard_features(raw, spec)[:, F.TABLE_SIZE_GB]


def project_assignment(spec: ShardSpec,
                       shard_assignment: np.ndarray) -> np.ndarray:
    """Legacy ``(M,)`` view of a ``(S,)`` shard assignment: each table
    reports its FIRST shard's device (exact for K = 1 tables; a
    documented projection for split ones)."""
    a = np.asarray(shard_assignment, dtype=np.int64)
    return a[..., spec.first_shard]
