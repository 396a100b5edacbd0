"""Human-expert greedy placement strategies (paper App. D.1) + random.

Each strategy assigns a per-table scalar cost, sorts tables descending, and
greedily places each on the least-loaded device that satisfies the memory
constraint.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import features as F


def _greedy_balance(costs: np.ndarray, sizes: np.ndarray, n_devices: int,
                    capacity_gb: float) -> np.ndarray:
    order = np.argsort(-costs, kind="stable")
    load = np.zeros(n_devices)
    mem = np.zeros(n_devices)
    assignment = np.zeros(costs.shape[0], dtype=np.int64)
    for t in order:
        legal = (mem + sizes[t]) <= capacity_gb
        if not legal.any():
            legal[:] = True
        cand = np.where(legal, load, np.inf)
        d = int(np.argmin(cand))
        assignment[t] = d
        load[d] += costs[t]
        mem[d] += sizes[t]
    return assignment


def _costs(raw: np.ndarray, strategy: str) -> np.ndarray:
    dim = raw[:, F.DIM]
    pool = raw[:, F.POOLING]
    size = raw[:, F.TABLE_SIZE_GB]
    if strategy == "size":
        return size
    if strategy == "dim":
        return dim
    if strategy == "lookup":
        return dim * pool
    if strategy == "size_lookup":
        return dim * pool * size
    raise ValueError(f"unknown strategy {strategy!r}")


def expert_place(raw: np.ndarray, n_devices: int, capacity_gb: float,
                 strategy: str) -> np.ndarray:
    return _greedy_balance(_costs(raw, strategy), raw[:, F.TABLE_SIZE_GB],
                           n_devices, capacity_gb)


def random_place(raw: np.ndarray, n_devices: int, capacity_gb: float,
                 rng: np.random.Generator) -> np.ndarray:
    sizes = raw[:, F.TABLE_SIZE_GB]
    assignment = np.zeros(raw.shape[0], dtype=np.int64)
    mem = np.zeros(n_devices)
    for t in rng.permutation(raw.shape[0]):
        legal = np.flatnonzero((mem + sizes[t]) <= capacity_gb)
        if legal.size == 0:
            legal = np.arange(n_devices)
        d = int(rng.choice(legal))
        assignment[t] = d
        mem[d] += sizes[t]
    return assignment


EXPERT_STRATEGIES = ("size", "dim", "lookup", "size_lookup")
