"""Embedding-table feature schema (paper Appendix A.2).

Each table is described by 21 raw features:

  [0]      dim            -- embedding vector dimension (columns)
  [1]      hash_size      -- number of rows
  [2]      pooling_factor -- mean #indices per lookup
  [3]      table_size_gb  -- memory footprint in GB
  [4:21]   distribution   -- 17-bin normalized access-frequency histogram
                             over per-index access counts in a 65536 batch:
                             (0,1],(1,2],(2,4],...,(16384,32768],(32768,inf)

Raw features are what the simulator consumes; the networks consume a
normalized view (log-scaled magnitudes, distribution bins passed through).
"""

from __future__ import annotations

import numpy as np

NUM_FEATURES = 21
NUM_DIST_BINS = 17

DIM = 0
HASH_SIZE = 1
POOLING = 2
TABLE_SIZE_GB = 3
DIST_START = 4

# Geometric-mean access count per distribution bin; bin j covers
# (2^(j-1), 2^j] for j>=1 with bin 0 = (0,1].  Used by the simulator's cache
# model: mass in high bins means heavy index reuse.
BIN_MEAN_COUNT = np.array(
    [1.0] + [np.sqrt(2.0 ** (j - 1) * 2.0 ** j) for j in range(1, NUM_DIST_BINS)]
)


def table_size_gb(dim: np.ndarray, hash_size: np.ndarray,
                  bytes_per_elem: int = 2) -> np.ndarray:
    return dim * hash_size * bytes_per_elem / 1e9


def pack_features(dim, hash_size, pooling, dist) -> np.ndarray:
    """Assemble the (M, 21) raw feature matrix."""
    dim = np.asarray(dim, dtype=np.float64)
    hash_size = np.asarray(hash_size, dtype=np.float64)
    pooling = np.asarray(pooling, dtype=np.float64)
    dist = np.asarray(dist, dtype=np.float64)
    assert dist.shape == (dim.shape[0], NUM_DIST_BINS)
    out = np.zeros((dim.shape[0], NUM_FEATURES))
    out[:, DIM] = dim
    out[:, HASH_SIZE] = hash_size
    out[:, POOLING] = pooling
    out[:, TABLE_SIZE_GB] = table_size_gb(dim, hash_size)
    out[:, DIST_START:] = dist
    return out


def normalize_features(raw: np.ndarray) -> np.ndarray:
    """Network input normalization.

    dim is LINEAR (dim/256): both compute and all-to-all payload are linear
    in dim, and the networks' sum-reduction can then represent per-device
    dim sums exactly -- with log encoding the comm objective becomes
    sum-of-exp, which measurably hurts placement on diverse-dim (Prod)
    pools.  Heavy-tailed magnitudes (hash, pooling, size) stay log-scaled.
    """
    raw = np.asarray(raw, dtype=np.float64)
    out = raw.copy().astype(np.float32)
    out[..., DIM] = raw[..., DIM] / 256.0
    out[..., HASH_SIZE] = np.log2(np.maximum(raw[..., HASH_SIZE], 1.0)) / 25.0
    out[..., POOLING] = np.log2(1.0 + raw[..., POOLING]) / 8.0
    out[..., TABLE_SIZE_GB] = np.log2(1.0 + 100.0 * raw[..., TABLE_SIZE_GB]) / 12.0
    return out


def drop_feature_group(raw: np.ndarray, group: str) -> np.ndarray:
    """Zero out one feature group (for the Table 3/11 ablations)."""
    out = raw.copy()
    if group == "dim":
        out[..., DIM] = 16.0            # replace with a constant, not zero
    elif group == "hash_size":
        out[..., HASH_SIZE] = 1e6
    elif group == "pooling":
        out[..., POOLING] = 15.0
    elif group == "table_size":
        out[..., TABLE_SIZE_GB] = 0.032
    elif group == "distribution":
        out[..., DIST_START:] = 1.0 / NUM_DIST_BINS
    else:
        raise ValueError(f"unknown feature group {group!r}")
    return out
