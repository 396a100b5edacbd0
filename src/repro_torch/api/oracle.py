"""Cost oracles: the unified "how expensive is this placement?" seam.

The counterpart of ``repro/api/oracle.py``:

* ``SimOracle``    -- wraps the analytic ``CostSimulator``;
* ``CachedOracle`` -- memoizes repeated placement queries (LRU);
* ``MeasuredOracle`` -- measured hardware costs at simulator speed:
  interpolates per-table kernel times and alpha-beta comm costs from a
  persisted ``repro_torch.profiling.CalibrationTable``, zero kernel
  launches per ``evaluate``;
* ``KernelOracle`` -- calibrates once (lazily) by timing K1's forward and
  backward on the device it is given -- the CUDA kernels on ``cuda``, the
  plain versions only on ``device="cpu"`` -- then delegates every
  ``evaluate`` to a ``MeasuredOracle``.

Shard-level queries (``evaluate_sharded`` / ``legal_sharded``) take a
``repro_torch.sharding.ShardSpec`` and ``(P, S)`` shard assignments on
every oracle; for a trivial spec (K = 1) they are bitwise the whole-table
paths.  ``MeasuredOracle.evaluate_sharded`` splits each table's kernel
time across its shards through the ``ShardModel`` that
``calibrate_sharding`` fits to K1's sharded-gather sweep.
"""

from __future__ import annotations

import os
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch import telemetry as tele
from repro_torch.api.digest import (placement_key, placement_keys,
                                    sharded_placement_keys)
from repro_torch.core import features as F
from repro_torch.device import resolve_device
from repro_torch.sharding.spec import shard_features, shard_sizes_gb
from repro_torch.sim.costsim import (CostSimulator, SimResult,
                                     assignments_legal,
                                     check_assignment_batch,
                                     per_device_sums)
from repro_torch.sim.hardware import HardwareSpec, PAPER_GPU


@runtime_checkable
class CostOracle(Protocol):
    """Protocol every cost backend implements."""

    @property
    def mem_capacity_gb(self) -> float:
        """Per-device memory budget a legal placement must respect."""
        ...

    @property
    def num_evaluations(self) -> int:
        """Hardware measurements consumed so far (sample-efficiency axis)."""
        ...

    def evaluate(self, raw: np.ndarray, assignment: np.ndarray,
                 n_devices: int) -> SimResult:
        """Measure one placement; the analogue of one benchmark run."""
        ...

    def evaluate_many(self, raw: np.ndarray, assignments: np.ndarray,
                      n_devices: int) -> list[SimResult]:
        """Measure P placements of ONE task (shared ``raw``/``n_devices``)
        in a single batched pass; bitwise-identical to P sequential
        ``evaluate`` calls."""
        ...


def ensure_oracle(sim_or_oracle) -> "CostOracle":
    """Accept a ``CostOracle`` or a bare ``CostSimulator`` (auto-wrap)."""
    if isinstance(sim_or_oracle, CostSimulator):
        return SimOracle(sim_or_oracle)
    if isinstance(sim_or_oracle, CostOracle):
        return sim_or_oracle
    # oracles without evaluate_many: `evaluate_many` consumers fall back
    # to a per-placement loop for them
    if all(hasattr(sim_or_oracle, a)
           for a in ("evaluate", "mem_capacity_gb", "num_evaluations")):
        return sim_or_oracle
    raise TypeError(
        f"expected a CostOracle or CostSimulator, got {type(sim_or_oracle)!r}")


def evaluate_many(oracle, raw: np.ndarray, assignments: np.ndarray,
                  n_devices: int) -> list[SimResult]:
    """Batched measurement through any oracle: uses the oracle's
    ``evaluate_many`` when it has one, else falls back to a sequential
    per-placement loop (identical results either way)."""
    assignments = check_assignment_batch(assignments, n_devices)
    fn = getattr(oracle, "evaluate_many", None)
    if fn is not None:
        return fn(raw, assignments, n_devices)
    return [oracle.evaluate(raw, a, n_devices) for a in assignments]


def legal_batch(oracle, raw: np.ndarray, assignments: np.ndarray,
                n_devices: int) -> np.ndarray:
    """Vectorized ``(P,)`` memory-legality check through any oracle: uses
    the oracle's own ``legal_batch`` when present, else the shared
    bincount check against ``oracle.mem_capacity_gb``."""
    fn = getattr(oracle, "legal_batch", None)
    if fn is not None:
        return fn(raw, assignments, n_devices)
    sizes = np.asarray(raw, dtype=np.float64)[:, F.TABLE_SIZE_GB]
    return assignments_legal(sizes, assignments, n_devices,
                             oracle.mem_capacity_gb)


def evaluate_sharded(oracle, raw: np.ndarray, spec,
                     assignments: np.ndarray,
                     n_devices: int) -> list[SimResult]:
    """Batched *shard-level* measurement through any oracle.

    ``assignments`` is ``(P, S)`` over the shards of a ``ShardSpec``.
    Uses the oracle's own ``evaluate_sharded`` when it has one (the
    simulator's per-shard cache curve, ``MeasuredOracle``'s calibrated
    shard model); otherwise falls back to ``evaluate_many`` over the
    expanded per-shard features, pricing each shard as a table of its
    column width.  For a trivial spec every route is bitwise the
    whole-table ``evaluate_many``.
    """
    assignments = check_assignment_batch(assignments, n_devices)
    fn = getattr(oracle, "evaluate_sharded", None)
    if fn is not None:
        return fn(raw, spec, assignments, n_devices)
    return evaluate_many(oracle, shard_features(raw, spec), assignments,
                         n_devices)


def legal_sharded(oracle, raw: np.ndarray, spec,
                  assignments: np.ndarray, n_devices: int) -> np.ndarray:
    """Vectorized ``(P,)`` memory legality of shard-level assignments:
    per-device sums of per-shard bytes against the oracle's capacity."""
    fn = getattr(oracle, "legal_sharded", None)
    if fn is not None:
        return fn(raw, spec, assignments, n_devices)
    return assignments_legal(shard_sizes_gb(raw, spec), assignments,
                             n_devices, oracle.mem_capacity_gb)


class SimOracle:
    """``CostOracle`` view over the analytic ``CostSimulator``.

    Each call emits a telemetry span (``oracle.sim.evaluate[_many]``)
    and bumps the dispatch counters -- no-ops until
    ``repro_torch.telemetry.enable()``.
    """

    def __init__(self, sim: CostSimulator | None = None, **sim_kwargs):
        self.sim = sim if sim is not None else CostSimulator(**sim_kwargs)

    @property
    def mem_capacity_gb(self) -> float:
        return self.sim.spec.mem_capacity_gb

    @property
    def num_evaluations(self) -> int:
        return self.sim.num_evaluations

    def evaluate(self, raw, assignment, n_devices) -> SimResult:
        tele.count("oracle.sim.evaluate_calls")
        with tele.span("oracle.sim.evaluate", M=len(raw),
                       n_devices=n_devices):
            return self.sim.evaluate(raw, assignment, n_devices)

    def evaluate_many(self, raw, assignments, n_devices) -> list[SimResult]:
        P = len(assignments)
        tele.count("oracle.sim.evaluate_many_calls")
        tele.count("oracle.sim.rows", P)
        with tele.span("oracle.sim.evaluate_many", P=P, M=len(raw),
                       n_devices=n_devices):
            return self.sim.evaluate_batch(raw, assignments, n_devices)

    def legal(self, raw, assignment, n_devices) -> bool:
        return self.sim.legal(raw, assignment, n_devices)

    def legal_batch(self, raw, assignments, n_devices) -> np.ndarray:
        return self.sim.legal_batch(raw, assignments, n_devices)

    def evaluate_sharded(self, raw, spec, assignments,
                         n_devices) -> list[SimResult]:
        P = len(assignments)
        tele.count("oracle.sim.evaluate_sharded_calls")
        tele.count("oracle.sim.rows", P)
        with tele.span("oracle.sim.evaluate_sharded", P=P,
                       S=spec.n_shards, n_devices=n_devices):
            return self.sim.evaluate_sharded_batch(raw, spec, assignments,
                                                   n_devices)

    def legal_sharded(self, raw, spec, assignments,
                      n_devices) -> np.ndarray:
        return self.sim.legal_sharded_batch(raw, spec, assignments,
                                            n_devices)


class CachedOracle:
    """Memoizing wrapper: repeated placements are served from cache.

    Keys are the blake2b-128 digest of the raw features, the assignment
    and the device count (``repro_torch.api.digest``), so hit/miss
    behaviour is reproducible across processes and matches the
    reference's.  ``num_evaluations`` reports the *inner* oracle's count:
    cache hits consume no hardware budget.  Eviction is LRU (a hit moves
    its entry to the back of the insertion order); the ``hits`` /
    ``misses`` counters and the ``oracle.cache.*`` telemetry expose the
    cache's behaviour.

    Sharded queries (``evaluate_sharded``) share the same store under
    ``sharded_placement_keys``: for a trivial spec those keys EQUAL the
    whole-table keys, so K = 1 sharded lookups hit entries populated by
    ``evaluate_many`` and vice versa.
    """

    def __init__(self, inner, max_entries: int = 100_000):
        self.inner = ensure_oracle(inner)
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.batched_calls = 0
        self.batch_hits = 0
        self.batch_misses = 0
        self.last_batch: dict = {"rows": 0, "hits": 0, "misses": 0}
        self._cache: dict[bytes, SimResult] = {}

    @property
    def mem_capacity_gb(self) -> float:
        return self.inner.mem_capacity_gb

    @property
    def num_evaluations(self) -> int:
        return self.inner.num_evaluations

    def _store(self, key: bytes, res: SimResult):
        if len(self._cache) >= self.max_entries:      # evict least-recent
            self._cache.pop(next(iter(self._cache)))
            self.evictions += 1
            tele.count("oracle.cache.evictions")
        self._cache[key] = res

    def evaluate(self, raw, assignment, n_devices) -> SimResult:
        key = placement_key(raw, assignment, n_devices)
        hit = self._cache.get(key)
        if hit is not None:
            self.hits += 1
            tele.count("oracle.cache.hits")
            del self._cache[key]                      # LRU: move to end
            self._cache[key] = hit
            return hit
        self.misses += 1
        tele.count("oracle.cache.misses")
        with tele.span("oracle.cache.evaluate", M=len(raw),
                       n_devices=n_devices):
            res = self.inner.evaluate(raw, assignment, n_devices)
        self._store(key, res)
        return res

    def evaluate_many(self, raw, assignments, n_devices) -> list[SimResult]:
        """Batched evaluation with partial cache hits: only the rows that
        miss are forwarded (as one sub-batch) to the inner oracle.
        Duplicate rows within a batch are measured once and count as hits
        thereafter, as a sequential loop over ``evaluate`` would.  Results
        follow input row order."""
        assignments = check_assignment_batch(assignments, n_devices)
        sp = tele.span("oracle.cache.evaluate_many",
                       P=len(assignments), M=len(raw), n_devices=n_devices)
        with sp:
            keys = placement_keys(raw, assignments, n_devices)
            return self._serve_batch(
                keys, assignments, sp,
                lambda rows: evaluate_many(self.inner, raw, rows, n_devices))

    def evaluate_sharded(self, raw, spec, assignments,
                         n_devices) -> list[SimResult]:
        """Batched shard-level evaluation through the same LRU store:
        misses forward to the inner oracle through the module-level
        ``evaluate_sharded``, so a shard-aware inner backend prices them
        with its own shard model."""
        assignments = check_assignment_batch(assignments, n_devices)
        sp = tele.span("oracle.cache.evaluate_sharded",
                       P=len(assignments), S=spec.n_shards,
                       n_devices=n_devices)
        with sp:
            keys = sharded_placement_keys(raw, spec, assignments, n_devices)
            return self._serve_batch(
                keys, assignments, sp,
                lambda rows: evaluate_sharded(self.inner, raw, spec, rows,
                                              n_devices))

    def _serve_batch(self, keys, assignments, sp, miss_fn):
        hits0, misses0 = self.hits, self.misses
        out: list[SimResult | None] = [None] * len(keys)
        miss_slot: dict[bytes, int] = {}     # key -> index into miss batch
        miss_rows: list[int] = []
        for i, key in enumerate(keys):
            hit = self._cache.get(key)
            if hit is not None:
                self.hits += 1
                del self._cache[key]                  # LRU: move to end
                self._cache[key] = hit
                out[i] = hit
            elif key in miss_slot:                    # duplicate in batch
                self.hits += 1
            else:
                self.misses += 1
                miss_slot[key] = len(miss_rows)
                miss_rows.append(i)
        if miss_rows:
            fresh = miss_fn(assignments[miss_rows])
            for key, slot in miss_slot.items():
                self._store(key, fresh[slot])
            for i, key in enumerate(keys):
                if out[i] is None:
                    out[i] = fresh[miss_slot[key]]
        self.batched_calls += 1
        self.batch_hits += self.hits - hits0
        self.batch_misses += self.misses - misses0
        self.last_batch = {"rows": len(keys), "hits": self.hits - hits0,
                           "misses": self.misses - misses0}
        tele.count("oracle.cache.batched_calls")
        tele.count("oracle.cache.hits", self.hits - hits0)
        tele.count("oracle.cache.misses", self.misses - misses0)
        sp.set(hits=self.hits - hits0, misses=self.misses - misses0)
        return out

    def legal(self, raw, assignment, n_devices) -> bool:
        return bool(self.legal_batch(
            raw, np.asarray(assignment)[None, :], n_devices)[0])

    def legal_batch(self, raw, assignments, n_devices) -> np.ndarray:
        return legal_batch(self.inner, raw, assignments, n_devices)

    def legal_sharded(self, raw, spec, assignments,
                      n_devices) -> np.ndarray:
        return legal_sharded(self.inner, raw, spec, assignments, n_devices)


class MeasuredOracle:
    """Measured hardware costs at ``SimOracle`` speed.

    Wraps a ``repro_torch.profiling.CalibrationTable`` (``python -m
    repro_torch.profiling.calibrate``, or an artifact written by the JAX
    package) and prices a placement by pure interpolation, as the
    reference does:

    * per-table forward/backward kernel time is log2-multilinear
      interpolation of the measured ``(dim, rows, batch, pooling)`` grid
      (clamped at the grid edges);
    * a device's K co-resident tables are priced as ONE fused op through
      the artifact's fitted ``FusionModel`` (additive for a v1 artifact);
    * the all-to-all is the fitted alpha-beta model applied to each
      device's payload (``batch * dim_sum * bytes * (n-1)/n``).

    ``evaluate`` launches no kernel.  ``table`` may be a
    ``CalibrationTable``, a path to one, or ``None`` (the default
    artifact).  ``batch_size`` defaults to the table's largest calibrated
    batch; ``fusion=False`` forces the additive per-table model.
    """

    def __init__(self, table=None, *, batch_size: int | None = None,
                 spec: HardwareSpec = PAPER_GPU,
                 mem_capacity_gb: float | None = None, fusion: bool = True):
        from repro_torch.profiling.calibration import (CalibrationTable,
                                                       FusionModel,
                                                       ShardModel,
                                                       default_artifact_path)
        if table is None:
            path = default_artifact_path()
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"no calibration artifact at {path!r}; run `python -m "
                    "repro_torch.profiling.calibrate` (or pass a "
                    "CalibrationTable)")
            table = CalibrationTable.load(path)
        elif isinstance(table, (str, os.PathLike)):
            table = CalibrationTable.load(os.fspath(table))
        self.table = table
        self.spec = spec
        self.batch_size = int(table.batches[-1]) if batch_size is None \
            else batch_size
        if fusion:
            self.fusion_fwd = table.fusion_fwd
            self.fusion_bwd = table.fusion_bwd
        else:
            self.fusion_fwd = FusionModel.additive()
            self.fusion_bwd = FusionModel.additive()
        sf = getattr(table, "shard_fwd", None)
        sb = getattr(table, "shard_bwd", None)
        self.shard_fwd = sf if sf is not None else ShardModel.proportional()
        self.shard_bwd = sb if sb is not None else ShardModel.proportional()
        self._mem_capacity_gb = (spec.mem_capacity_gb
                                 if mem_capacity_gb is None
                                 else mem_capacity_gb)
        self._num_evaluations = 0

    @property
    def mem_capacity_gb(self) -> float:
        return self._mem_capacity_gb

    @property
    def num_evaluations(self) -> int:
        return self._num_evaluations

    def per_table_ms(self, raw) -> tuple[np.ndarray, np.ndarray]:
        """Interpolated (fwd, bwd) kernel ms per table -- (M,), (M,);
        duplicate table shapes interpolate once."""
        raw = np.asarray(raw, dtype=np.float64)
        q = raw[:, (F.DIM, F.HASH_SIZE, F.POOLING)]
        uniq, inverse = np.unique(q, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        fwd, bwd = self.table.lookup_ms(uniq[:, 0], uniq[:, 1],
                                        self.batch_size, uniq[:, 2])
        return fwd[inverse], bwd[inverse]

    def evaluate(self, raw, assignment, n_devices) -> SimResult:
        tele.count("oracle.measured.evaluate_calls")
        with tele.span("oracle.measured.evaluate", M=len(raw),
                       n_devices=n_devices):
            return self._evaluate_many_impl(
                raw, np.asarray(assignment)[None, :], n_devices)[0]

    def evaluate_many(self, raw, assignments, n_devices) -> list[SimResult]:
        """All P placements in one pass (bitwise P ``evaluate`` calls)."""
        P = len(assignments)
        tele.count("oracle.measured.evaluate_many_calls")
        tele.count("oracle.measured.rows", P)
        with tele.span("oracle.measured.evaluate_many", P=P, M=len(raw),
                       n_devices=n_devices):
            return self._evaluate_many_impl(raw, assignments, n_devices)

    def _evaluate_many_impl(self, raw, assignments,
                            n_devices) -> list[SimResult]:
        raw = np.asarray(raw, dtype=np.float64)
        assignments = check_assignment_batch(assignments, n_devices)
        if assignments.shape[0] == 0:
            return []
        per_fwd, per_bwd = self.per_table_ms(raw)
        return self._price(raw[:, F.DIM], per_fwd, per_bwd, assignments,
                           n_devices)

    def evaluate_sharded(self, raw, spec, assignments,
                         n_devices) -> list[SimResult]:
        """Shard-level pricing: each table's kernel time interpolates once
        at its full shape, then splits across its shards through the
        calibrated ``ShardModel`` (per-gather overhead + the column
        fraction of the streaming cost); fusion and comm then price the
        per-shard costs like per-table ones.  For a trivial spec the
        model returns the full-table times bitwise, so K = 1 results equal
        ``evaluate_many``."""
        P = len(assignments)
        tele.count("oracle.measured.evaluate_sharded_calls")
        tele.count("oracle.measured.rows", P)
        with tele.span("oracle.measured.evaluate_sharded", P=P,
                       S=spec.n_shards, n_devices=n_devices):
            raw = np.asarray(raw, dtype=np.float64)
            assignments = check_assignment_batch(assignments, n_devices)
            if assignments.shape[0] == 0:
                return []
            per_fwd, per_bwd = self.per_table_ms(raw)
            t = spec.table
            frac = spec.widths / raw[t, F.DIM]
            fwd = self.shard_fwd.shard_ms(per_fwd[t], frac)
            bwd = self.shard_bwd.shard_ms(per_bwd[t], frac)
            return self._price(spec.widths.astype(np.float64), fwd, bwd,
                               assignments, n_devices)

    def _price(self, dims, per_fwd, per_bwd, assignments,
               n_devices) -> list[SimResult]:
        """Fusion + comm pricing of per-item (table or shard) kernel
        times over a validated ``(P, S)`` assignment batch; ``dims`` is
        the per-item embedding width the all-to-all payload sums."""
        P, _ = assignments.shape
        self._num_evaluations += P
        counts = None \
            if self.fusion_fwd.is_additive and self.fusion_bwd.is_additive \
            else per_device_sums(assignments, n_devices)
        fwd = self.fusion_fwd.device_ms(per_fwd, assignments, n_devices,
                                        counts)
        bwd = self.fusion_bwd.device_ms(per_bwd, assignments, n_devices,
                                        counts)
        dim_sums = per_device_sums(assignments, n_devices, dims)
        payload_mb = (self.batch_size * dim_sums * self.spec.bytes_per_elem
                      * (n_devices - 1) / n_devices / 1e6)
        comm = self.table.comm_ms(payload_mb)
        # fwd comm spans from each device's compute finish to the synced
        # end of the all-to-all (the simulator's convention)
        fwd_comm = (fwd.max(axis=-1, keepdims=True) - fwd) + comm
        overall = fwd.max(axis=-1) + 2.0 * comm.max(axis=-1) + bwd.max(axis=-1)
        return [SimResult(fwd_comp=fwd[p], bwd_comp=bwd[p],
                          fwd_comm=fwd_comm[p], bwd_comm=comm[p],
                          overall=float(overall[p])) for p in range(P)]

    def legal(self, raw, assignment, n_devices) -> bool:
        return bool(self.legal_batch(
            raw, np.asarray(assignment)[None, :], n_devices)[0])

    def legal_batch(self, raw, assignments, n_devices) -> np.ndarray:
        sizes = np.asarray(raw, dtype=np.float64)[:, F.TABLE_SIZE_GB]
        return assignments_legal(sizes, assignments, n_devices,
                                 self.mem_capacity_gb)

    def legal_sharded(self, raw, spec, assignments,
                      n_devices) -> np.ndarray:
        return assignments_legal(shard_sizes_gb(raw, spec), assignments,
                                 n_devices, self.mem_capacity_gb)


class KernelOracle:
    """Measured-cost oracle backed by K1, the fused embedding bag.

    On first use it runs ONE calibration (``CalibrationTable.measure``:
    the kernel grid, the fused sweep and the sharded-gather sweep) at the
    configured ``(batch_size, pooling)`` operating point, timing K1's
    forward and backward on ``device`` -- the CUDA kernels on ``cuda``
    (the default; raises where there is no card), their plain versions
    only when the caller passes ``device="cpu"`` -- and builds a
    ``MeasuredOracle`` over the table; every ``evaluate`` is then pure
    interpolation.  The grid is the reference's kernel grid (``use_pallas
    =True``): 128-lane dims up to ``max_dim``, rows ``(64, max(128,
    max_rows))``.  Communication keeps the analytic alpha-beta model of
    ``spec``.  Pass ``table=`` to reuse a persisted artifact instead;
    ``batch_size`` then defaults to that table's largest calibrated
    batch, else to 64.
    """

    DEFAULT_SWEEP_BATCH = 64

    def __init__(self, spec: HardwareSpec = PAPER_GPU,
                 batch_size: int | None = None,
                 pooling: int = 4, max_rows: int = 4096, repeats: int = 2,
                 seed: int = 0, table=None, max_dim: int = 768,
                 device=None):
        self.spec = spec
        self.batch_size = batch_size
        self.pooling = pooling
        self.max_rows = max_rows
        self.repeats = repeats
        self.seed = seed
        self.table = table
        self.max_dim = max_dim
        self.device = resolve_device(device)
        self._measured: MeasuredOracle | None = None

    def _calibration_grid(self) -> dict:
        # the grid must reach the widest table the pools serve (prod dims
        # go to 768): interpolation clamps at the top dim.  Dims are
        # 128-multiples, the widths the kernel times.
        dims = (128, 256)
        if self.max_dim > dims[-1]:
            dims = dims + (int(np.ceil(self.max_dim / 128) * 128),)
        return {"dims": dims,
                "rows": (64, max(128, self.max_rows)),
                "batches": (self.batch_size if self.batch_size is not None
                            else self.DEFAULT_SWEEP_BATCH,),
                "poolings": (self.pooling,)}

    def measured(self) -> MeasuredOracle:
        """The underlying interpolating oracle (calibrates on first use)."""
        if self._measured is None:
            from repro_torch.profiling.calibration import CalibrationTable
            from repro_torch.profiling.collectives import CommModel
            table = self.table
            batch = self.batch_size
            if table is None:
                grid = self._calibration_grid()
                tele.count("oracle.kernel.calibrations")
                with tele.span("oracle.kernel.calibrate",
                               device=self.device.type,
                               dims=len(grid["dims"])):
                    table = CalibrationTable.measure(
                        **grid, warmup=1, repeats=self.repeats,
                        seed=self.seed, spec=self.spec,
                        comm=CommModel.from_spec(self.spec),
                        fused_ks=(2, 4), fused_per_k=3, device=self.device)
                batch = grid["batches"][0]
            elif isinstance(table, (str, os.PathLike)):
                table = CalibrationTable.load(os.fspath(table))
            self._measured = MeasuredOracle(table, batch_size=batch,
                                            spec=self.spec)
        return self._measured

    @property
    def mem_capacity_gb(self) -> float:
        return self.spec.mem_capacity_gb

    @property
    def num_evaluations(self) -> int:
        return 0 if self._measured is None else \
            self._measured.num_evaluations

    def evaluate(self, raw, assignment, n_devices) -> SimResult:
        tele.count("oracle.kernel.evaluate_calls")
        with tele.span("oracle.kernel.evaluate", M=len(raw),
                       n_devices=n_devices):
            return self.measured().evaluate(raw, assignment, n_devices)

    def evaluate_many(self, raw, assignments, n_devices) -> list[SimResult]:
        P = len(assignments)
        tele.count("oracle.kernel.evaluate_many_calls")
        tele.count("oracle.kernel.rows", P)
        with tele.span("oracle.kernel.evaluate_many", P=P, M=len(raw),
                       n_devices=n_devices):
            return self.measured().evaluate_many(raw, assignments, n_devices)

    def legal(self, raw, assignment, n_devices) -> bool:
        return bool(self.legal_batch(
            raw, np.asarray(assignment)[None, :], n_devices)[0])

    def legal_batch(self, raw, assignments, n_devices) -> np.ndarray:
        # spec arithmetic only: a memory probe must not run the lazy
        # calibration
        sizes = np.asarray(raw, dtype=np.float64)[:, F.TABLE_SIZE_GB]
        return assignments_legal(sizes, assignments, n_devices,
                                 self.spec.mem_capacity_gb)

    def evaluate_sharded(self, raw, spec, assignments,
                         n_devices) -> list[SimResult]:
        P = len(assignments)
        tele.count("oracle.kernel.evaluate_sharded_calls")
        tele.count("oracle.kernel.rows", P)
        with tele.span("oracle.kernel.evaluate_sharded", P=P,
                       S=spec.n_shards, n_devices=n_devices):
            return self.measured().evaluate_sharded(raw, spec, assignments,
                                                    n_devices)

    def legal_sharded(self, raw, spec, assignments,
                      n_devices) -> np.ndarray:
        # like legal_batch: spec arithmetic only, no lazy calibration
        return assignments_legal(shard_sizes_gb(raw, spec), assignments,
                                 n_devices, self.spec.mem_capacity_gb)
