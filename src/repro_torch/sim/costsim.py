"""Execution-cost simulator for sharded embedding lookups.

Stands in for the paper's GPU measurement harness (PARAM benchmark).  It
reproduces the phenomena the paper documents analytically:

* memory-bound gather cost with a cache model driven by the 17-bin access
  distribution and the table working set (App. A.3.1, Figs 10/11);
* operation fusion: a fused multi-table op costs
  ``c0 + sum_i m_i / pipeline_eff(k)`` while k single-table ops cost
  ``sum_i (c0 + m_i)`` -- the fused/unfused ratio lands in the paper's
  observed 1x-3x band and is non-linear in the table mix (Fig 12);
* all-to-all cost proportional to per-device dim-sums with a congestion
  penalty for imbalance (Table 4);
* the 4-stage cost decomposition (fwd comp, fwd comm, bwd comm, bwd comp)
  with the overall latency as the sum of per-stage bottlenecks, and the
  3-element per-device cost features q = [fwd_comp, bwd_comp, bwd_comm]
  (fwd comm excluded -- App. A.4);
* seeded multiplicative log-normal noise emulating measurement jitter.

Everything is vectorized numpy; one `evaluate` call is the analogue of one
PARAM benchmarking run on real hardware, and `evaluate_batch` measures all
P placements of a task in one pass over the ``(P, M)`` assignment matrix
(segment sums + an in-row rank sort instead of a per-device Python loop),
bitwise-identical to P sequential `evaluate` calls -- `evaluate` is its
P = 1 special case.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.core import features as F
from repro_torch.sharding.spec import shard_features, shard_sizes_gb
from repro_torch.sim.hardware import HardwareSpec, PAPER_GPU

DEFAULT_BATCH = 65536

# splitmix64: stateless counter-based hashing for the measurement-noise
# stream (vectorizes over whole evaluation batches, unlike Generator objects)
_SM64_GAMMA = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer: bijective uint64 avalanche hash."""
    x = np.asarray(x, dtype=np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def placement_bytes(raw: np.ndarray, assignment: np.ndarray,
                    n_devices: int) -> bytes:
    """Canonical byte serialization of one placement query -- the shared
    input to the simulator's noise digest and ``CachedOracle`` keys."""
    r = np.ascontiguousarray(np.asarray(raw, dtype=np.float64))
    a = np.ascontiguousarray(np.asarray(assignment, dtype=np.int64))
    return r.tobytes() + a.tobytes() + int(n_devices).to_bytes(8, "little")


def placement_digest(raw: np.ndarray, assignment: np.ndarray,
                     n_devices: int) -> int:
    """Deterministic 32-bit digest of one placement query.

    Unlike the built-in ``hash`` (salted per process by PYTHONHASHSEED),
    ``zlib.crc32`` is stable across processes, so it reproducibly seeds
    the simulator's measurement noise.  ``repro_torch.api.digest`` hashes
    the same ``placement_bytes`` stream (wide, collision-safe) for its
    keys.
    """
    return zlib.crc32(placement_bytes(raw, assignment, n_devices))


def per_device_sums(assignments: np.ndarray, n_devices: int,
                    weights: np.ndarray | None = None) -> np.ndarray:
    """Per-(placement, device) segment sum over a ``(P, M)`` assignment
    batch -> ``(P, D)``: one bincount over flattened group ids (no Python
    loop over placements or devices).  Within each group, accumulation
    follows table order -- the property the bitwise batch-vs-loop
    guarantee rests on.  ``weights`` is per-table ``(M,)`` or per-cell
    ``(P, M)``; ``None`` counts tables."""
    P, M = assignments.shape
    gid = assignments + n_devices * np.arange(P)[:, None]
    w = None if weights is None else \
        np.broadcast_to(weights, (P, M)).ravel()
    return np.bincount(gid.ravel(), weights=w,
                       minlength=P * n_devices).reshape(P, n_devices)


def check_assignment_batch(assignments: np.ndarray,
                           n_devices: int) -> np.ndarray:
    """Canonicalize + validate a batched assignment matrix: int64
    ``(P, M)`` with device ids in ``[0, n_devices)`` (out-of-range ids
    would alias into a neighboring row's groups in the flattened
    segment sums)."""
    a = np.asarray(assignments, dtype=np.int64)
    if a.ndim != 2:
        raise ValueError(f"assignments must be (P, M), got shape {a.shape}")
    if a.size and ((a < 0) | (a >= n_devices)).any():
        raise ValueError(f"assignment device ids must be in [0, {n_devices})")
    return a


def placement_digests(raw: np.ndarray, assignments: np.ndarray,
                      n_devices: int) -> np.ndarray:
    """Row-wise ``placement_digest`` over a ``(P, M)`` assignment batch.

    crc32 is a streaming checksum, so the shared ``raw`` prefix is hashed
    ONCE and each row only pays for its own assignment bytes -- the values
    are identical to P independent ``placement_digest`` calls.
    """
    r = np.ascontiguousarray(np.asarray(raw, dtype=np.float64))
    a = np.ascontiguousarray(np.asarray(assignments, dtype=np.int64))
    prefix = zlib.crc32(r.tobytes())
    suffix = int(n_devices).to_bytes(8, "little")
    return np.array([zlib.crc32(row.tobytes() + suffix, prefix)
                     for row in a], dtype=np.int64)


@dataclasses.dataclass
class SimResult:
    """Measured costs for one placement (all times in milliseconds)."""

    fwd_comp: np.ndarray   # (D,) fused forward computation per device
    bwd_comp: np.ndarray   # (D,) fused backward computation per device
    fwd_comm: np.ndarray   # (D,) forward all-to-all (incl. waiting; App A.4)
    bwd_comm: np.ndarray   # (D,) backward all-to-all
    overall: float         # end-to-end latency of the embedding stages

    @property
    def cost_features(self) -> np.ndarray:
        """Per-device q_{t,d} = [fwd_comp, bwd_comp, bwd_comm]  -> (D, 3)."""
        return np.stack([self.fwd_comp, self.bwd_comp, self.bwd_comm], axis=1)


class CostSimulator:
    """The 'hardware' the RL loop measures against."""

    def __init__(self, spec: HardwareSpec = PAPER_GPU,
                 batch_size: int = DEFAULT_BATCH,
                 noise_std: float = 0.01, seed: int = 0):
        self.spec = spec
        self.batch_size = batch_size
        self.noise_std = noise_std
        self.seed = seed
        self.num_evaluations = 0  # bookkeeping: "GPU measurements" consumed

    # ---- per-table primitives ------------------------------------------------

    # fraction of a table's touched rows that form its cache-resident "hot
    # head" (zipf head); shared-cache contention operates on these bytes
    HOT_HEAD = 0.08
    HIT_CAP = 0.6

    def _reuse_and_ws(self, raw: np.ndarray):
        """(reuse fraction, hot working-set bytes) per table (M,)."""
        dist = raw[:, F.DIST_START:]
        # Reuse fraction: an index accessed c times has (c-1)/c of its
        # accesses as repeats; weight by bin mass.
        reuse = dist @ (1.0 - 1.0 / F.BIN_MEAN_COUNT)
        touched = np.minimum(
            self.batch_size * raw[:, F.POOLING] * np.maximum(1e-3, 1.0 - reuse),
            raw[:, F.HASH_SIZE],
        )
        ws_bytes = (touched * raw[:, F.DIM] * self.spec.bytes_per_elem
                    * self.HOT_HEAD)
        return reuse, ws_bytes

    def _cache_hit_rate(self, raw: np.ndarray,
                        shared: bool = False) -> np.ndarray:
        """Fraction of gather traffic served by the cache, per table (M,).

        With ``shared=True`` the tables CO-RESIDE on one device and compete
        for the same cache: the capacity fraction uses the SUM of hot
        working sets.  This interaction is what makes fused multi-table
        costs combination-dependent (paper Fig 12) and single-table-cost
        greedy balancing systematically over-optimistic.
        """
        reuse, ws_bytes = self._reuse_and_ws(raw)
        denom = ws_bytes.sum() if shared else np.maximum(ws_bytes, 1.0)
        capacity_frac = np.minimum(1.0, self.spec.cache_bytes
                                   / np.maximum(denom, 1.0))
        return np.clip(reuse * capacity_frac, 0.0, self.HIT_CAP)

    def _marginals_from_hit(self, raw: np.ndarray, reuse: np.ndarray,
                            hit: np.ndarray
                            ) -> tuple[np.ndarray, np.ndarray]:
        """(marginal fwd ms, marginal bwd ms) given per-table cache hit
        rates.  THE cost-model formula: both the scalar ``_marginals``
        path (public ``fused_op_ms``/``marginal_*_ms`` surface) and the
        batched ``_grouped_marginals`` path (``hit`` of shape (P, M))
        price tables through this one function, so the model cannot
        fork."""
        bw = self.spec.gather_bw_gbs * 1e9
        # Blend cold and cached bandwidth.
        blend = (1.0 - hit) / bw + hit / (bw * self.spec.cache_speedup)
        pooled = self.batch_size * raw[:, F.POOLING]
        fwd_bytes = pooled * raw[:, F.DIM] * self.spec.bytes_per_elem
        # backward: read+write of unique rows, plus streaming the incoming
        # gradients
        touched = np.minimum(pooled * np.maximum(1e-3, 1.0 - reuse),
                             raw[:, F.HASH_SIZE])
        bwd_bytes = ((2.0 * touched + 0.25 * pooled)
                     * raw[:, F.DIM] * self.spec.bytes_per_elem)
        return (fwd_bytes * blend * 1e3,
                bwd_bytes * blend * 1e3 * self.spec.bwd_comp_scale)

    def _marginals(self, raw: np.ndarray,
                   shared: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """(marginal fwd ms, marginal bwd ms) per table (M,), computed in
        one pass: the reuse/working-set/cache-hit intermediates are shared
        between the two stages (the split helpers recomputed them four
        times per fused op, the hottest line of every ``evaluate``)."""
        reuse, ws_bytes = self._reuse_and_ws(raw)
        denom = ws_bytes.sum() if shared else np.maximum(ws_bytes, 1.0)
        capacity_frac = np.minimum(1.0, self.spec.cache_bytes
                                   / np.maximum(denom, 1.0))
        hit = np.clip(reuse * capacity_frac, 0.0, self.HIT_CAP)
        return self._marginals_from_hit(raw, reuse, hit)

    def marginal_fwd_ms(self, raw: np.ndarray,
                        shared: bool = False) -> np.ndarray:
        """Marginal (overhead-free) forward gather time per table (M,)."""
        return self._marginals(raw, shared=shared)[0]

    def marginal_bwd_ms(self, raw: np.ndarray,
                        shared: bool = False) -> np.ndarray:
        """Marginal backward (gradient apply) time per table (M,).

        The backward is a row-wise scatter-add over the UNIQUE rows touched
        (read + modify + write), so its cost tracks ``touched * dim``, not
        ``pooling * dim``: reuse-heavy tables have cheap backwards, uniform
        tables cost ~2x their forward.  fwd and bwd balance are therefore
        *different objectives* -- a single greedy cost function cannot
        satisfy both, which is exactly the multi-stage trade-off DreamShard
        learns (paper Fig 1: fwd- vs bwd-bottlenecked placements differ).
        """
        return self._marginals(raw, shared=shared)[1]

    def _pipeline_eff(self, k: np.ndarray) -> np.ndarray:
        k = np.maximum(k, 1)
        return np.minimum(self.spec.pipeline_cap,
                          1.0 + self.spec.pipeline_coef * np.log2(k))

    def fused_op_ms(self, raw_subset: np.ndarray) -> tuple[float, float]:
        """(fwd, bwd) time of ONE fused op over the given tables.

        Each table's marginal cost is divided by a per-rank pipeline factor
        (deeper fusion overlaps better), with tables sorted by cost so the
        model is monotone: adding a table always adds positive time, yet
        the fused/unfused ratio still lands in the paper's 1-3x band.
        """
        if raw_subset.shape[0] == 0:
            return 0.0, 0.0
        ranks = np.arange(1, raw_subset.shape[0] + 1)
        eff = self._pipeline_eff(ranks)
        mf, mb = self._marginals(raw_subset, shared=True)
        mf = np.sort(mf)[::-1]
        mb = np.sort(mb)[::-1]
        fwd = self.spec.comp_overhead_ms + float((mf / eff).sum())
        bwd = self.spec.comp_overhead_ms + float((mb / eff).sum())
        return fwd, bwd

    def single_table_ms(self, raw: np.ndarray) -> np.ndarray:
        """Unfused per-table forward cost c0 + m_i (M,) -- Fig 12 baseline."""
        return self.spec.comp_overhead_ms + self.marginal_fwd_ms(raw)

    # ---- placement evaluation ------------------------------------------------

    def comm_ms(self, dim_sums: np.ndarray, n_devices: int) -> np.ndarray:
        """Per-device all-to-all time given per-device output dim sums.

        Public model surface (measured oracles and the live measurement
        harness reuse it for the stages a single host cannot time)."""
        return self._comm_ms_batch(
            np.asarray(dim_sums, dtype=np.float64)[None, :], n_devices)[0]

    def _comm_ms_batch(self, dim_sums: np.ndarray,
                       n_devices: int) -> np.ndarray:
        """``comm_ms`` over a ``(P, D)`` batch of per-device dim sums."""
        if n_devices <= 1:
            return np.zeros_like(dim_sums)
        payload = (self.batch_size * dim_sums * self.spec.bytes_per_elem
                   * (n_devices - 1) / n_devices)
        bw = self.spec.a2a_bw_gbs * 1e9
        base = payload / bw * 1e3
        imbalance = np.maximum(
            0.0, base.max(axis=-1) - base.mean(axis=-1))[..., None]
        return np.where(dim_sums > 0,
                        self.spec.comm_overhead_ms + base
                        + self.spec.congestion * imbalance,
                        0.0)

    def _noise_batch(self, keys: np.ndarray, n_devices: int) -> np.ndarray:
        """``(P, 4, D)`` multiplicative log-normal noise for a whole batch.

        Counter-based: every (placement, stage, device) cell hashes its own
        uint64 word (splitmix64 of the row's placement digest + cell index)
        into two uniforms and one Box-Muller normal -- one vectorized pass,
        no generator objects.  The old ``_noise`` built a fresh
        ``np.random.default_rng`` four times per evaluate, which dominated
        batched evaluation cost.  Values are a pure function of
        ``(sim seed, placement digest, cell)``, so they are reproducible
        across processes and independent of batch composition (the
        batch-vs-loop bitwise guarantee).
        """
        P = len(keys)
        if self.noise_std <= 0:
            return np.ones((P, 4, n_devices))
        seed_word = _mix64(np.array([self.seed & 0xFFFFFFFFFFFFFFFF],
                                    dtype=np.uint64))
        base = _mix64(seed_word + keys.astype(np.uint64))
        cell = np.arange(4 * n_devices, dtype=np.uint64) + np.uint64(1)
        w1 = _mix64(base[:, None] + cell * _SM64_GAMMA)
        w2 = _mix64(w1 + _SM64_GAMMA)
        # 53-bit mantissa uniforms; u1 < 1 keeps the log argument positive
        u1 = (w1 >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)
        u2 = (w2 >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)
        z = np.sqrt(-2.0 * np.log1p(-u1)) * np.cos(2.0 * np.pi * u2)
        return np.exp(self.noise_std * z).reshape(P, 4, n_devices)

    def _grouped_marginals(self, raw: np.ndarray, assignments: np.ndarray,
                           n_devices: int):
        """Per-table fused marginal costs under each placement's co-residence
        pattern: ``(mf, mb)`` of shape ``(P, M)``.

        The cache-contention denominator (sum of hot working sets sharing a
        device) is the only placement-dependent input, so the per-table
        intermediates are computed once, only the group sums span the
        ``(P, M)`` batch, and the actual pricing shares
        ``_marginals_from_hit`` with the scalar path.
        """
        reuse, ws_bytes = self._reuse_and_ws(raw)
        P, _ = assignments.shape
        denom = per_device_sums(assignments, n_devices, ws_bytes)
        capacity_frac = np.minimum(1.0, self.spec.cache_bytes
                                   / np.maximum(denom, 1.0))
        hit = np.clip(reuse * capacity_frac[np.arange(P)[:, None],
                                            assignments],
                      0.0, self.HIT_CAP)
        return self._marginals_from_hit(raw, reuse, hit)

    def _fused_sum(self, marginal: np.ndarray, assignments: np.ndarray,
                   counts: np.ndarray, starts: np.ndarray,
                   n_devices: int) -> np.ndarray:
        """Pipeline-discounted per-device fused-op time ``(P, D)`` from
        per-table marginals ``(P, M)``: within every (placement, device)
        group tables are ranked by descending marginal cost and divided by
        the per-rank pipeline efficiency, exactly as ``fused_op_ms``."""
        P, M = assignments.shape
        rows = np.arange(P)[:, None]
        order = np.lexsort((-marginal, assignments), axis=-1)
        dev_sorted = assignments[rows, order]
        rank = np.arange(M)[None, :] - starts[rows, dev_sorted]
        contrib = marginal[rows, order] / self._pipeline_eff(rank + 1)
        sums = per_device_sums(dev_sorted, n_devices, contrib)
        return np.where(counts > 0, self.spec.comp_overhead_ms + sums, 0.0)

    def evaluate_batch(self, raw: np.ndarray, assignments: np.ndarray,
                       n_devices: int) -> list[SimResult]:
        """Measure P placements of one task in a single vectorized pass.

        ``assignments`` is ``(P, M)``; the result list follows row order and
        each row is bitwise-identical to ``evaluate(raw, assignments[p],
        n_devices)`` -- every per-row computation (group sums, rank sort,
        reductions, digest-seeded noise) is independent of the other rows,
        and ``evaluate`` itself is the ``P == 1`` special case of this
        path.  Counts ``P`` hardware measurements.
        """
        raw = np.asarray(raw, dtype=np.float64)
        assignments = check_assignment_batch(assignments, n_devices)
        P, M = assignments.shape
        if P == 0:
            return []
        self.num_evaluations += P

        counts = per_device_sums(assignments, n_devices)
        starts = np.concatenate(
            [np.zeros((P, 1), np.int64),
             np.cumsum(counts, axis=1)[:, :-1]], axis=1)
        mf, mb = self._grouped_marginals(raw, assignments, n_devices)
        fwd = self._fused_sum(mf, assignments, counts, starts, n_devices)
        bwd = self._fused_sum(mb, assignments, counts, starts, n_devices)
        dim_sums = per_device_sums(assignments, n_devices, raw[:, F.DIM])
        comm = self._comm_ms_batch(dim_sums, n_devices)

        keys = placement_digests(raw, assignments, n_devices) & 0x7FFFFFFF
        noise = self._noise_batch(keys, n_devices)
        fwd = fwd * noise[:, 0]
        bwd = bwd * noise[:, 1]
        bwd_comm = comm * noise[:, 2]
        # Forward comm as *reported* includes waiting for the slowest fwd
        # computation (App. A.4): every device's fwd-comm timer spans from
        # its own compute finish to the synced end of the all-to-all.
        fwd_comm = (fwd.max(axis=-1, keepdims=True) - fwd) + comm * noise[:, 3]
        overall = (fwd.max(axis=-1) + comm.max(axis=-1)
                   + bwd_comm.max(axis=-1) + bwd.max(axis=-1))
        return [SimResult(fwd_comp=fwd[p], bwd_comp=bwd[p],
                          fwd_comm=fwd_comm[p], bwd_comm=bwd_comm[p],
                          overall=float(overall[p])) for p in range(P)]

    def evaluate(self, raw: np.ndarray, assignment: np.ndarray,
                 n_devices: int) -> SimResult:
        """Measure a full placement: the analogue of one GPU benchmark run.

        Single-placement view of ``evaluate_batch`` (P = 1), so sequential
        loops and the batched path are bitwise-identical by construction.
        """
        return self.evaluate_batch(
            raw, np.asarray(assignment)[None, :], n_devices)[0]

    # ---- placement legality --------------------------------------------------

    def table_sizes_gb(self, raw: np.ndarray) -> np.ndarray:
        return raw[:, F.TABLE_SIZE_GB]

    def legal_batch(self, raw: np.ndarray, assignments: np.ndarray,
                    n_devices: int) -> np.ndarray:
        """Memory legality of a ``(P, M)`` assignment batch -> ``(P,)`` bool
        (bincount over the assignment matrix, no per-device loop)."""
        return assignments_legal(self.table_sizes_gb(np.asarray(raw)),
                                 assignments, n_devices,
                                 self.spec.mem_capacity_gb)

    def legal(self, raw: np.ndarray, assignment: np.ndarray,
              n_devices: int) -> bool:
        return bool(self.legal_batch(
            raw, np.asarray(assignment)[None, :], n_devices)[0])


    # ---- column-wise sharding ------------------------------------------------

    def evaluate_sharded_batch(self, raw: np.ndarray, spec,
                               assignments: np.ndarray,
                               n_devices: int) -> list[SimResult]:
        """Measure P *shard-level* placements: ``assignments`` is
        ``(P, S)`` over the shards of a ``repro_torch.sharding.ShardSpec``.

        Pricing is ``evaluate_batch`` over the expanded per-shard feature
        matrix (``shard_features``): each shard flows through the cache-hit
        curve at its own column width, and the comm payload sums shard
        widths per device.  A trivial spec expands byte-identically to
        ``raw``, so K = 1 sharded costs (noise digests included) are
        bitwise the whole-table costs.
        """
        return self.evaluate_batch(shard_features(raw, spec), assignments,
                                   n_devices)

    def evaluate_sharded(self, raw: np.ndarray, spec,
                         shard_assignment: np.ndarray,
                         n_devices: int) -> SimResult:
        """Single-placement view of ``evaluate_sharded_batch`` (P = 1)."""
        return self.evaluate_sharded_batch(
            raw, spec, np.asarray(shard_assignment)[None, :], n_devices)[0]

    def legal_sharded_batch(self, raw: np.ndarray, spec,
                            assignments: np.ndarray,
                            n_devices: int) -> np.ndarray:
        """Memory legality of ``(P, S)`` shard assignments: per-device
        sums of per-shard bytes (``table_size_gb`` scaled by column
        fraction) against capacity."""
        return assignments_legal(shard_sizes_gb(raw, spec), assignments,
                                 n_devices, self.spec.mem_capacity_gb)


def assignments_legal(sizes_gb: np.ndarray, assignments: np.ndarray,
                      n_devices: int, capacity_gb: float) -> np.ndarray:
    """Vectorized per-device memory check shared by every cost backend:
    ``(P,)`` bools for a ``(P, M)`` assignment batch over tables of
    ``sizes_gb`` ``(M,)``.  A legality probe answers for ANY input, so a
    row with device ids outside ``[0, n_devices)`` is reported illegal
    rather than raising (unlike measurement, where malformed ids are a
    programming error)."""
    assignments = np.asarray(assignments, dtype=np.int64)
    bad = (assignments < 0) | (assignments >= n_devices)
    per_dev = per_device_sums(np.where(bad, 0, assignments), n_devices,
                              sizes_gb)
    return (per_dev <= capacity_gb).all(axis=1) & ~bad.any(axis=1)
