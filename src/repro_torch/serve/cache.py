"""Digest-keyed placement cache: repeat tasks skip decode entirely.

The serving analogue of ``CachedOracle``, but for *placements* rather
than costs: entries are keyed on a blake2b task digest
(``repro_torch.api.digest.task_key``) and evicted LRU, so a stream of repeat
or near-duplicate requests is served in dictionary time while cold
tasks still pay exactly one bucketed decode.

Each entry also carries the per-table access-histogram *snapshot* the
placement was computed against -- the reference the drift loop
(``repro_torch.serve.drift``) compares live traffic statistics to when
deciding whether a re-placement is due.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import telemetry as tele
from repro_torch.api.placement import Placement


@dataclasses.dataclass
class CacheEntry:
    """One cached placement plus the state the drift loop needs."""

    placement: Placement
    snapshot: np.ndarray    # (M, 17) access histograms at placement time
    requests: int = 0       # requests served from this entry
    replaces: int = 0       # drift-triggered re-placements applied
    raw: np.ndarray | None = None   # (M, 21) features at placement time
                                    # (failover re-places from these)


class PlacementCache:
    """LRU placement cache keyed on ``task_key`` digests.

    A ``get`` hit moves the entry to the back of the insertion order
    (LRU, matching ``CachedOracle``), so hot tasks survive past
    ``max_entries`` even under a long tail of one-off tasks.
    Hit/miss/eviction behaviour is surfaced both as instance counters
    and as ``serve.cache.*`` telemetry counters.
    """

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self._entries: dict[bytes, CacheEntry] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: bytes) -> CacheEntry | None:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            tele.count("serve.cache.misses")
            return None
        self.hits += 1
        tele.count("serve.cache.hits")
        del self._entries[key]                    # LRU: move to end
        self._entries[key] = entry
        entry.requests += 1
        return entry

    def put(self, key: bytes, entry: CacheEntry) -> None:
        if key in self._entries:                  # refresh keeps recency
            del self._entries[key]
        elif len(self._entries) >= self.max_entries:
            self._entries.pop(next(iter(self._entries)))
            self.evictions += 1
            tele.count("serve.cache.evictions")
        self._entries[key] = entry

    def entries(self) -> list[CacheEntry]:
        """Live entries in LRU -> MRU order (a snapshot, not a view)."""
        return list(self._entries.values())

    def items(self) -> list[tuple[bytes, CacheEntry]]:
        """(key, entry) pairs in LRU -> MRU order (a snapshot)."""
        return list(self._entries.items())

    def invalidate(self, predicate) -> int:
        """Drop every entry where ``predicate(key, entry)`` is true.

        Surviving entries keep their relative LRU order; dropped entries
        count as invalidations (NOT evictions -- they were removed for
        correctness, not capacity) and leave hit/miss counters untouched.
        Returns the number of entries dropped.
        """
        doomed = [k for k, e in self._entries.items() if predicate(k, e)]
        for k in doomed:
            del self._entries[k]
        self.invalidations += len(doomed)
        if doomed:
            tele.count("serve.cache.invalidations", len(doomed))
        return len(doomed)

    def invalidate_devices(self, lost) -> int:
        """Drop entries whose placement touches any device in ``lost``
        (the device-loss failover sweep).  Returns the count dropped."""
        lost = set(int(d) for d in lost)
        if not lost:
            return 0

        def touches(key, entry):
            return bool(np.isin(entry.placement.assignment,
                                sorted(lost)).any())

        return self.invalidate(touches)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
