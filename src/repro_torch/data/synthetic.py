"""Synthetic table pools matching the DLRM dataset statistics (App. C).

The open-sourced DLRM dataset has 856 tables with hash sizes around 1e6 (up
to ~1e7, Fig 15), power-law pooling factors with mean ~15 (Fig 16, up to
~200), fixed dim 16 (App. C.3), and heavy-tailed index access frequencies
(Fig 18).  The `prod` pool mimics the paper's production workload: same
scale but diverse dims in [4, 768].

Pools are (M, 21) raw feature matrices (see ``repro_torch.core.features``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import features as F

_PROD_DIMS = np.array([4, 8, 16, 24, 32, 48, 64, 96, 128, 160, 192,
                       256, 320, 384, 512, 640, 768], dtype=np.float64)


def _zipf_distribution(rng: np.random.Generator, hash_size: float,
                       pooling: float, batch: int = 65536) -> np.ndarray:
    """17-bin access-count histogram for a zipf(s) index stream (App. A.2)."""
    # wide exponent range: near-uniform (s<1, low reuse) through heavily
    # skewed (s~1.7, reuse-dominated) -- per-table access locality varies
    # strongly in production workloads (paper Fig 18)
    s = rng.uniform(0.35, 1.7)
    n = int(min(hash_size, 2e5))             # rank support (subsampled tail)
    ranks = np.unique(np.round(np.logspace(0, np.log10(n), 400)).astype(np.int64))
    weights = ranks.astype(np.float64) ** (-s)
    # each sampled rank bucket represents the ranks up to the next one
    widths = np.diff(np.concatenate([ranks, [n + 1]])).astype(np.float64)
    mass = weights * widths
    total_draws = batch * pooling
    # expected #accesses of an index at each sampled rank:
    counts = total_draws * weights / mass.sum()
    edges = np.concatenate([[0.0], 2.0 ** np.arange(F.NUM_DIST_BINS - 1), [np.inf]])
    hist = np.zeros(F.NUM_DIST_BINS)
    bin_idx = np.searchsorted(edges, counts, side="left") - 1
    bin_idx = np.clip(bin_idx, 0, F.NUM_DIST_BINS - 1)
    np.add.at(hist, bin_idx, mass)
    hist /= hist.sum()
    return hist


def make_pool(n_tables: int = 856, seed: int = 0,
              dim_mode: str = "dlrm") -> np.ndarray:
    """Generate a raw-feature table pool. dim_mode: 'dlrm' (16) or 'prod'."""
    rng = np.random.default_rng(seed)
    hash_size = np.clip(rng.lognormal(np.log(8e5), 1.2, n_tables), 1e4, 2e7)
    hash_size = np.round(hash_size)
    pooling = np.clip((rng.pareto(1.2, n_tables) + 1.0) * 3.0, 1.0, 200.0)
    if dim_mode == "dlrm":
        dim = np.full(n_tables, 16.0)
    elif dim_mode == "prod":
        dim = rng.choice(_PROD_DIMS, size=n_tables,
                         p=_dim_probs())
    else:
        raise ValueError(dim_mode)
    dist = np.stack([_zipf_distribution(rng, h, p)
                     for h, p in zip(hash_size, pooling)])
    return F.pack_features(dim, hash_size, pooling, dist)


def _dim_probs() -> np.ndarray:
    """Smaller dims are more common in production pools."""
    w = 1.0 / np.sqrt(_PROD_DIMS)
    return w / w.sum()


def make_dlrm_pool(seed: int = 0) -> np.ndarray:
    return make_pool(856, seed=seed, dim_mode="dlrm")


def make_prod_pool(seed: int = 0) -> np.ndarray:
    return make_pool(856, seed=seed, dim_mode="prod")
