"""Shared blake2b digest helpers: the one key machinery for every cache.

A copy of ``repro/api/digest.py``: placement keys hash the canonical
``repro_torch.sim.costsim.placement_bytes`` stream, sharded placement keys
the same stream over the expanded per-shard features, task keys the raw
features plus the device count.  All keys are
blake2b-128, stable across processes (unlike the salted built-in
``hash``).  Batched variants hash the shared ``raw`` prefix ONCE and fork
the hash state per row.
"""

from __future__ import annotations

import hashlib

import numpy as np

from repro_torch.core import features as F
from repro_torch.sharding.spec import shard_features
from repro_torch.sim.costsim import placement_bytes

DIGEST_SIZE = 16        # blake2b-128 everywhere


def placement_key(raw: np.ndarray, assignment: np.ndarray,
                  n_devices: int) -> bytes:
    """Digest of one *(task, placement)* query: the canonical
    ``placement_bytes`` stream (raw features + assignment + device
    count)."""
    return hashlib.blake2b(placement_bytes(raw, assignment, n_devices),
                           digest_size=DIGEST_SIZE).digest()


def placement_keys(raw: np.ndarray, assignments: np.ndarray,
                   n_devices: int) -> list[bytes]:
    """Row-wise ``placement_key`` over a ``(P, M)`` assignment batch
    (bitwise-identical to P independent calls)."""
    r = np.ascontiguousarray(np.asarray(raw, dtype=np.float64))
    a = np.ascontiguousarray(np.asarray(assignments, dtype=np.int64))
    h0 = hashlib.blake2b(r.tobytes(), digest_size=DIGEST_SIZE)
    suffix = int(n_devices).to_bytes(8, "little")
    keys = []
    for row in a:
        h = h0.copy()
        h.update(row.tobytes() + suffix)
        keys.append(h.digest())
    return keys


def sharded_placement_key(raw: np.ndarray, spec,
                          shard_assignment: np.ndarray,
                          n_devices: int) -> bytes:
    """Digest of one *(task, sharding, shard placement)* query.

    Hashes the expanded per-shard feature bytes (``shard_features``) plus
    the ``(S,)`` shard assignment -- so a trivial spec (K = 1 everywhere)
    produces the SAME key as ``placement_key`` (the expansion is
    byte-identical to ``raw``), while different split points change the
    expanded ``dim`` / ``table_size_gb`` bytes and therefore the key.
    """
    return placement_key(shard_features(raw, spec), shard_assignment,
                         n_devices)


def sharded_placement_keys(raw: np.ndarray, spec,
                           shard_assignments: np.ndarray,
                           n_devices: int) -> list[bytes]:
    """Row-wise ``sharded_placement_key`` over ``(P, S)`` assignments
    (shared expanded-prefix hashing, like ``placement_keys``)."""
    return placement_keys(shard_features(raw, spec), shard_assignments,
                          n_devices)


def task_key(raw: np.ndarray, n_devices: int, *,
             include_distribution: bool = True) -> bytes:
    """Digest of one *task* (raw features + device count).

    ``include_distribution=False`` drops the 17-bin access-histogram
    columns from the digest, keying only on the structural features
    (dim, hash size, pooling, table size).
    """
    r = np.ascontiguousarray(np.asarray(raw, dtype=np.float64))
    if not include_distribution:
        r = np.ascontiguousarray(r[:, :F.DIST_START])
    return hashlib.blake2b(
        r.tobytes() + int(n_devices).to_bytes(8, "little"),
        digest_size=DIGEST_SIZE).digest()
