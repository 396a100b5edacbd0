"""Bounded per-request latency ledger for ``PlacementService.stats()``.

A week-long replay submits millions of requests; keeping every latency
in a growing list is an OOM waiting to happen.  ``LatencyReservoir``
keeps a fixed-size uniform sample (Vitter's Algorithm R) with a seeded
generator, so memory is O(capacity) forever, quantiles over the sample
are unbiased estimates of the stream's, and two replays of the same
stream report identical numbers.

Semantics pinned by ``tests/test_resilience.py``:

* below ``capacity`` the reservoir holds *every* observation, so
  ``quantile`` is exact;
* ``quantile(q)`` is ``numpy.quantile`` (linear interpolation) over the
  current sample, ``nan`` when empty;
* ``count`` always reflects the full stream, not the sample size.
"""

from __future__ import annotations

import numpy as np


class LatencyReservoir:
    """Fixed-size uniform sample of a latency stream (Algorithm R)."""

    def __init__(self, capacity: int = 4096, seed: int = 0):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.seed = seed
        self.count = 0                     # stream length, not sample size
        self.total = 0.0
        self._sample = np.empty(capacity, dtype=np.float64)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return min(self.count, self.capacity)

    def record(self, value_ms: float) -> None:
        v = float(value_ms)
        if self.count < self.capacity:
            self._sample[self.count] = v
        else:
            # accept with probability capacity / (count + 1); evict uniform
            j = int(self._rng.integers(0, self.count + 1))
            if j < self.capacity:
                self._sample[j] = v
        self.count += 1
        self.total += v

    def values(self) -> np.ndarray:
        """Current sample (a copy), unordered."""
        return np.array(self._sample[:len(self)])

    def quantile(self, q: float) -> float:
        if len(self) == 0:
            return float("nan")
        return float(np.quantile(self._sample[:len(self)], q))

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def summary(self) -> dict:
        """The ``stats()`` cell: stream count/mean + sampled p50/p99
        (``None`` while empty -- the dict is written to JSON as-is)."""
        if self.count == 0:
            return {"count": 0, "mean_ms": None, "p50_ms": None,
                    "p99_ms": None}
        return {"count": self.count,
                "mean_ms": self.mean,
                "p50_ms": self.quantile(0.50),
                "p99_ms": self.quantile(0.99)}

    # ---- checkpointing -------------------------------------------------------

    def state_dict(self) -> dict:
        """Serializable state: sample buffer + generator state, so a
        restored reservoir continues the *same* sampling decisions."""
        return {"capacity": self.capacity, "seed": self.seed,
                "count": self.count, "total": self.total,
                "sample": self.values().tolist(),
                "rng": self._rng.bit_generator.state}

    def load_state_dict(self, state: dict) -> None:
        if int(state["capacity"]) != self.capacity:
            raise ValueError("reservoir capacity mismatch on restore")
        self.count = int(state["count"])
        self.total = float(state["total"])
        sample = np.asarray(state["sample"], dtype=np.float64)
        self._sample[:len(sample)] = sample
        self._rng.bit_generator.state = state["rng"]
