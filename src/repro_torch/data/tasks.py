"""Placement task construction (paper §4.1 / App. E).

A task T = (table subset, n_devices).  The pool is split in half into a
training pool and a disjoint testing pool; tasks sample tables from one
pool, so every table in a test task is unseen during training.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Task:
    raw_features: np.ndarray   # (M, 21)
    n_devices: int
    table_ids: np.ndarray      # indices into the originating pool
    name: str = ""

    @property
    def n_tables(self) -> int:
        return self.raw_features.shape[0]

    @classmethod
    def of(cls, raw_features: np.ndarray, n_devices: int,
           name: str = "") -> "Task":
        """Ad-hoc task over raw features not drawn from a pool (serving)."""
        raw = np.asarray(raw_features)
        return cls(raw_features=raw, n_devices=n_devices,
                   table_ids=np.arange(raw.shape[0]), name=name)


def split_pool(pool: np.ndarray, seed: int = 0):
    """Disjoint 50/50 train/test table pools (App. E)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(pool.shape[0])
    half = pool.shape[0] // 2
    return perm[:half], perm[half:]


def sample_tasks(pool: np.ndarray, pool_ids: np.ndarray, n_tables: int,
                 n_devices: int, n_tasks: int, seed: int = 0,
                 name: str = "") -> list[Task]:
    rng = np.random.default_rng(seed)
    tasks = []
    for i in range(n_tasks):
        ids = rng.choice(pool_ids, size=n_tables, replace=False)
        tasks.append(Task(raw_features=pool[ids], n_devices=n_devices,
                          table_ids=ids, name=f"{name}-{n_tables}({n_devices})#{i}"))
    return tasks


def make_benchmark_suite(pool: np.ndarray, n_tables: int, n_devices: int,
                         n_tasks: int = 50, seed: int = 0,
                         name: str = "DLRM"):
    """Train/test task suites like 'DLRM-50 (4)' with 50 tasks each."""
    train_ids, test_ids = split_pool(pool, seed=seed)
    train = sample_tasks(pool, train_ids, n_tables, n_devices, n_tasks,
                         seed=seed + 1, name=name + "-train")
    test = sample_tasks(pool, test_ids, n_tables, n_devices, n_tasks,
                        seed=seed + 2, name=name + "-test")
    return train, test
