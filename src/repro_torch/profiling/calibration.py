"""Persisted calibration artifact: measured kernel/collective costs.

The counterpart of ``repro/profiling/calibration.py``, reading and
writing the reference's artifact format, so an artifact written by one
package loads in the other.  On a CUDA device the sweeps time K1's
forward and backward kernels; the fingerprint names the torch and CUDA
versions, the device and the device count.

A ``CalibrationTable`` holds the micro-benchmark grids from
``repro_torch.profiling.microbench`` (per-shape forward/backward kernel
milliseconds over ``(dim, rows, batch, pooling)``), the fitted
``CommModel`` from ``repro_torch.profiling.collectives``, the fitted
``FusionModel`` pair from the fused multi-table sweep (format v2), a
hardware fingerprint, and a format version.  It persists as a single
``.npz`` (arrays raw, scalar metadata JSON-encoded) and answers
interpolation queries: per-table costs are *multilinear in log2-space*
over the grid, clamped to the grid's convex hull (out-of-range queries
snap to the nearest edge -- calibrate a wider grid if that matters).

The cost of a *fused* multi-table op is not the sum of its per-table
costs (the paper's core measurement insight, Fig 12): one launch is
paid instead of K, and co-scheduled tables pipeline.  A ``FusionModel``
captures that deviation parametrically -- a fitted per-launch overhead
``c0`` plus a per-rank pipelining efficiency ``eff(r) = min(cap,
1 + coef * log2(r))`` -- so measured oracles can price a device's K
tables as ``c0 + sum_r max(t_(r) - c0, 0) / eff(r)`` (tables ranked by
descending single-table time) instead of ``sum_i t_i``.  v1 artifacts
(no fused sweep) still load and fall back to the additive model with a
warning.

Format v3 adds the *sharded-gather* sweep behind column-wise table
sharding (the reference's ``repro.sharding``): a ``ShardModel`` pair
fitted to measured
partial-width lookups, pricing a shard covering column fraction ``f``
of a table as ``o + (t_full - o) * f**e`` -- the per-gather overhead
``o`` is NOT amortized by splitting, which is why K shards cost more
than the whole table.  v2 artifacts load with a warning and fall back
to proportional pricing (``t_full * f``, the overhead-free model).

``CalibrationTable.synthetic`` builds a deterministic table from the
analytic ``CostSimulator`` instead of measuring -- the bridge used by
tests and by sim-vs-measured comparisons where hardware timing noise
would make assertions flaky.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import warnings

import numpy as np

import torch

from repro_torch.core import features as F
from repro_torch.device import resolve_device
from repro_torch.profiling.collectives import CommModel, calibrate_comm
from repro_torch.sim.costsim import CostSimulator, per_device_sums
from repro_torch.sim.hardware import HardwareSpec, PAPER_GPU

CALIBRATION_VERSION = 3

# fused-sweep defaults: fusion depths K and heterogeneous draws per K
DEFAULT_FUSED_KS = (2, 4, 8)
DEFAULT_FUSED_PER_K = 4

# sharded-sweep defaults: column fractions and draws per fraction
DEFAULT_SHARD_FRACS = (0.25, 0.5, 0.75)
DEFAULT_SHARD_PER_FRAC = 3

# tiny CI-friendly grid (--smoke)
SMOKE_GRID = {
    "dims": (16, 64, 256),
    "rows": (256, 4096),
    "batches": (32,),
    "poolings": (2, 8),
}

# moderate default grid for a real offline calibration run
DEFAULT_GRID = {
    "dims": (16, 64, 128, 256, 512),
    "rows": (1024, 16384, 262144),
    "batches": (1024, 16384),
    "poolings": (2, 8, 32),
}


def default_artifact_path() -> str:
    """Artifact location: ``$REPRO_CALIBRATION`` or the scratch dir that
    CI caches between runs (gitignored)."""
    return os.environ.get("REPRO_CALIBRATION",
                          os.path.join("artifacts", "calibration",
                                       "calibration.npz"))


def hardware_fingerprint(device=None) -> dict:
    """What hardware produced a measurement (artifact staleness check):
    the torch and CUDA versions, the device's name and the number of such
    devices (``device`` defaults to ``cuda``)."""
    import platform
    dev = resolve_device(device)
    if dev.type == "cuda":
        kind, n = torch.cuda.get_device_name(dev), torch.cuda.device_count()
    else:
        kind, n = platform.processor() or platform.machine() or "cpu", 1
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_kind": kind,
        "n_devices": n,
        "platform": platform.platform(),
        "machine": platform.machine(),
    }


def _axis_weights(grid: np.ndarray, x: np.ndarray):
    """Per-query ``(lo, hi, w)`` along one log2-spaced axis, clamped to
    the grid range; a singleton axis contributes weight 0 at index 0."""
    g = np.asarray(grid, dtype=np.float64)
    x = np.clip(np.asarray(x, dtype=np.float64), g[0], g[-1])
    if g.size == 1:
        z = np.zeros(x.shape, dtype=np.int64)
        return z, z, np.zeros(x.shape)
    pos = np.interp(np.log2(np.maximum(x, 1e-9)), np.log2(g),
                    np.arange(g.size, dtype=np.float64))
    lo = np.minimum(pos.astype(np.int64), g.size - 2)
    return lo, lo + 1, pos - lo


@dataclasses.dataclass(frozen=True)
class FusionModel:
    """Parametric fused multi-table cost model for one kernel direction.

    Prices one fused op over K tables whose *single-table* calibrated
    times are ``t_1..t_K``:

        fused = c0 + sum_r max(t_(r) - c0, 0) / eff(r)
        eff(r) = min(cap, 1 + coef * log2(r))      (ranks sorted by
                                                    descending time)

    ``c0`` (``overhead_ms``) is the per-launch overhead every
    single-table measurement pays but a fused op amortizes across its K
    tables; ``eff`` is the pipelining discount deeper fusion earns.
    The model is a function of K and total work only -- by construction
    it is monotone in both (adding a table or growing any table's time
    never lowers the fused cost; see ``tests/test_fusion_properties``),
    it reduces to the exact single-table grid value at K = 1, and with
    ``overhead_ms == pipeline_coef == 0`` it IS the additive model
    (``is_additive``), which per-device pricing then computes via the
    plain table-order segment sum -- bitwise what pre-v2 oracles did.
    """

    overhead_ms: float       # c0: fitted per-launch overhead
    pipeline_coef: float     # eff(r) = min(cap, 1 + coef * log2(r))
    pipeline_cap: float      # >= 1
    source: str = "additive"           # "measured"|"synthetic"|"additive"
    n_samples: int = 0                 # fused sweep points behind the fit
    fit_mape: float = 0.0              # model MAPE on the sweep
    additive_mape: float = 0.0         # additive-baseline MAPE on the sweep

    def __post_init__(self):
        if self.overhead_ms < 0 or self.pipeline_coef < 0 \
                or self.pipeline_cap < 1.0:
            raise ValueError(
                f"need overhead_ms >= 0, pipeline_coef >= 0, "
                f"pipeline_cap >= 1, got {self}")

    @property
    def is_additive(self) -> bool:
        """True when the model degenerates to the plain per-table sum."""
        return self.overhead_ms == 0.0 and self.pipeline_coef == 0.0

    @classmethod
    def additive(cls, source: str = "additive") -> "FusionModel":
        """The identity correction: fused cost == sum of per-table costs
        (the only model a v1 artifact can support)."""
        return cls(overhead_ms=0.0, pipeline_coef=0.0, pipeline_cap=1.0,
                   source=source)

    def eff(self, ranks) -> np.ndarray:
        """Per-rank pipelining efficiency (rank 1 is always 1.0)."""
        r = np.maximum(np.asarray(ranks, dtype=np.float64), 1.0)
        return np.minimum(self.pipeline_cap,
                          1.0 + self.pipeline_coef * np.log2(r))

    def fused_ms(self, per_table_ms) -> float:
        """Fused-op time for one group of tables given their single-table
        calibrated times.  K = 0 costs nothing, K = 1 returns the
        single-table value bitwise (no correction to round-trip)."""
        t = np.atleast_1d(np.asarray(per_table_ms, dtype=np.float64))
        if t.size == 0:
            return 0.0
        if t.size == 1 or self.is_additive:
            return float(t.sum())
        m = np.sort(np.maximum(t - self.overhead_ms, 0.0))[::-1]
        ranks = np.arange(1, t.size + 1)
        return float(self.overhead_ms + (m / self.eff(ranks)).sum())

    def device_ms(self, per_table_ms: np.ndarray, assignments: np.ndarray,
                  n_devices: int, counts: np.ndarray | None = None
                  ) -> np.ndarray:
        """Per-(placement, device) fused compute time ``(P, D)`` over a
        ``(P, M)`` assignment batch -- the batched form of ``fused_ms``.

        Within every (placement, device) group tables are ranked by
        descending single-table time (ties broken by table index, fixed
        across batch compositions) and discounted by ``eff(rank)``; each
        row is independent of the others, so ``evaluate`` stays the
        P = 1 special case of ``evaluate_many`` bitwise.  Cells with one
        table take the plain segment sum (the exact grid value), and an
        additive model takes it for every cell -- table-order summation,
        bitwise identical to the pre-v2 oracle arithmetic.
        """
        per = np.asarray(per_table_ms, dtype=np.float64)
        P, M = assignments.shape
        sums = per_device_sums(assignments, n_devices, per)
        if self.is_additive:
            return sums                  # never needs the counts bincount
        if counts is None:
            counts = per_device_sums(assignments, n_devices)
        rows = np.arange(P)[:, None]
        starts = np.concatenate(
            [np.zeros((P, 1), np.int64),
             np.cumsum(counts, axis=1)[:, :-1]], axis=1)
        m = np.broadcast_to(np.maximum(per - self.overhead_ms, 0.0), (P, M))
        order = np.lexsort((-m, assignments), axis=-1)
        dev_sorted = assignments[rows, order]
        rank = np.arange(M)[None, :] - starts[rows, dev_sorted]
        contrib = m[rows, order] / self.eff(rank + 1)
        fused = (per_device_sums(dev_sorted, n_devices, contrib)
                 + self.overhead_ms)
        return np.where(counts > 1, fused, sums)

    @classmethod
    def fit(cls, singles: list, fused_ms: np.ndarray, *,
            source: str = "measured") -> "FusionModel":
        """Fit ``(c0, coef, cap)`` to a fused sweep.

        ``singles[k]`` holds sample k's per-table single-table times (as
        interpolated from the just-measured grid), ``fused_ms[k]`` the
        measured fused-op time.  For a fixed ``(coef, cap)`` the
        prediction is linear in ``c0`` (``c0 * (1 - sum_r 1/eff(r)) +
        sum_r t_(r)/eff(r)``), so ``c0`` has a closed-form relative
        least-squares solution and only ``(coef, cap)`` are grid
        searched -- deterministic, dependency-free, and a few thousand
        dot products.  ``c0`` is clamped to the smallest single-table
        time seen so fitted marginals stay non-negative.
        """
        y = np.asarray(fused_ms, dtype=np.float64)
        ts = [np.sort(np.asarray(t, np.float64))[::-1] for t in singles]
        if y.size == 0 or y.size != len(ts):
            raise ValueError("need one fused measurement per sample")
        c0_max = min(float(t.min()) for t in ts)
        additive = np.array([t.sum() for t in ts])
        additive_mape = float(np.mean(np.abs(additive - y) / y))
        best = None
        # bounded search: deep-fusion discounts beyond ~6x are not
        # physical for these kernels, and a wider box just lets timing
        # outliers pick absurd pipelining factors
        coefs = np.concatenate([[0.0], np.geomspace(0.02, 3.0, 24)])
        caps = (1.0, 1.25, 1.5, 2.0, 3.0, 4.0, 6.0)
        for coef in coefs:
            for cap in caps:
                if coef == 0.0 and cap != 1.0:
                    continue                  # eff is flat: caps all alias
                probe = cls(overhead_ms=0.0, pipeline_coef=float(coef),
                            pipeline_cap=float(cap), source=source)
                w = [1.0 / probe.eff(np.arange(1, t.size + 1)) for t in ts]
                a = np.array([1.0 - wk.sum() for wk in w])
                b = np.array([(wk * t).sum() for wk, t in zip(w, ts)])
                denom = ((a / y) ** 2).sum()
                c0 = 0.0 if denom <= 0 else \
                    float((a * (y - b) / y ** 2).sum() / denom)
                c0 = min(max(c0, 0.0), c0_max)
                pred = a * c0 + b
                mape = float(np.mean(np.abs(pred - y) / y))
                if best is None or mape < best[0]:
                    best = (mape, c0, float(coef), float(cap))
        mape, c0, coef, cap = best
        return cls(overhead_ms=c0, pipeline_coef=coef, pipeline_cap=cap,
                   source=source, n_samples=int(y.size),
                   fit_mape=round(mape, 6),
                   additive_mape=round(additive_mape, 6))

    @classmethod
    def from_spec(cls, spec: HardwareSpec = PAPER_GPU) -> "FusionModel":
        """Analytic model mirroring the simulator's fused-op pricing
        (same ``c0``/pipeline constants, no measurement)."""
        return cls(overhead_ms=spec.comp_overhead_ms,
                   pipeline_coef=spec.pipeline_coef,
                   pipeline_cap=spec.pipeline_cap, source="synthetic")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FusionModel":
        return cls(**d)

    def summary(self) -> str:
        return (f"{self.source}: c0={self.overhead_ms:.4f}ms "
                f"eff=min({self.pipeline_cap:g}, "
                f"1+{self.pipeline_coef:g}*log2(r)) "
                f"[{self.n_samples} pts, mape {self.fit_mape:.3f} "
                f"vs additive {self.additive_mape:.3f}]")


@dataclasses.dataclass(frozen=True)
class ShardModel:
    """Parametric partial-table (column-shard) cost model, one direction.

    Prices a shard that carries column fraction ``f`` of a table whose
    full single-table calibrated time is ``t``:

        shard = o + (t - o) * f ** e        (o clamped to t)

    ``o`` (``overhead_ms``) is the per-gather cost a column split does
    not shrink -- index decode, launch, per-row addressing all run at
    the FULL lookup count whatever the width -- so K shards of one table
    sum to ``K*o + (t - o) * sum(f_k**e)`` > ``t``: sharding buys
    feasibility and parallelism, never free compute.  ``e``
    (``exponent``) bends the streaming term for sub-linear column
    scaling (cache-line quantization at narrow widths).

    ``f >= 1`` returns ``t`` bitwise -- NOT via the arithmetic (in
    floats ``o + (t - o) != t`` in general) but via an explicit
    ``where``, which is what keeps K = 1 sharded pricing
    bitwise-identical to the whole-table path.  ``proportional()``
    (``o = 0, e = 1``) is the pure column-fraction model v2 artifacts
    fall back to.
    """

    overhead_ms: float       # o: per-gather floor a split cannot shrink
    exponent: float          # e: column-fraction exponent
    source: str = "proportional"   # "measured"|"synthetic"|"proportional"
    n_samples: int = 0             # sharded sweep points behind the fit
    fit_mape: float = 0.0          # model MAPE on the sweep
    proportional_mape: float = 0.0  # t*f baseline MAPE on the sweep

    def __post_init__(self):
        if self.overhead_ms < 0 or self.exponent <= 0:
            raise ValueError(f"need overhead_ms >= 0 and exponent > 0, "
                             f"got {self}")

    @property
    def is_proportional(self) -> bool:
        """True when the model degenerates to ``t * f``."""
        return self.overhead_ms == 0.0 and self.exponent == 1.0

    @classmethod
    def proportional(cls, source: str = "proportional") -> "ShardModel":
        """The overhead-free model: shard cost == column fraction of the
        table cost (the only model a pre-v3 artifact can support)."""
        return cls(overhead_ms=0.0, exponent=1.0, source=source)

    @classmethod
    def from_spec(cls, spec: HardwareSpec = PAPER_GPU) -> "ShardModel":
        """Analytic model matching the simulator's convention: the
        spec's per-op overhead is the unsplittable floor, streaming cost
        linear in columns."""
        return cls(overhead_ms=spec.comp_overhead_ms, exponent=1.0,
                   source="synthetic")

    def shard_ms(self, full_ms, frac) -> np.ndarray:
        """Per-shard kernel time given each shard's FULL-table time and
        column fraction (vectorized; ``frac == 1`` returns ``full_ms``
        bitwise)."""
        t = np.asarray(full_ms, dtype=np.float64)
        f = np.asarray(frac, dtype=np.float64)
        o = np.minimum(self.overhead_ms, t)
        pred = o + (t - o) * f ** self.exponent
        return np.where(f < 1.0, pred, t)

    @classmethod
    def fit(cls, full_ms, fracs, measured_ms, *,
            source: str = "measured") -> "ShardModel":
        """Fit ``(o, e)`` to a sharded sweep.

        For a fixed exponent the prediction is linear in ``o``
        (``o * (1 - f**e) + t * f**e``), so ``o`` has a closed-form
        relative least-squares solution and only ``e`` is grid
        searched -- the same deterministic scheme as
        ``FusionModel.fit``.  ``o`` is clamped to the smallest
        full-table time seen so fitted shard costs stay within
        ``[o, t]``.
        """
        t = np.asarray(full_ms, dtype=np.float64)
        f = np.asarray(fracs, dtype=np.float64)
        y = np.asarray(measured_ms, dtype=np.float64)
        if y.size == 0 or t.shape != y.shape or f.shape != y.shape:
            raise ValueError("need matching full/frac/measured arrays")
        o_max = float(t.min())
        prop_mape = float(np.mean(np.abs(t * f - y) / y))
        best = None
        # sub-linear exponents model cache-line quantization; above ~1.5
        # the streaming term would vanish faster than columns do, which
        # is not physical for a contiguous-row gather
        for e in np.concatenate([[1.0], np.linspace(0.5, 1.5, 21)]):
            g = f ** e
            a = 1.0 - g
            b = t * g
            denom = ((a / y) ** 2).sum()
            o = 0.0 if denom <= 0 else \
                float((a * (y - b) / y ** 2).sum() / denom)
            o = min(max(o, 0.0), o_max)
            pred = a * o + b
            mape = float(np.mean(np.abs(pred - y) / y))
            if best is None or mape < best[0]:
                best = (mape, o, float(e))
        mape, o, e = best
        return cls(overhead_ms=o, exponent=e, source=source,
                   n_samples=int(y.size), fit_mape=round(mape, 6),
                   proportional_mape=round(prop_mape, 6))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ShardModel":
        return cls(**d)

    def summary(self) -> str:
        return (f"{self.source}: o={self.overhead_ms:.4f}ms "
                f"e={self.exponent:g} [{self.n_samples} pts, "
                f"mape {self.fit_mape:.3f} vs proportional "
                f"{self.proportional_mape:.3f}]")


@dataclasses.dataclass
class CalibrationTable:
    """Measured (or synthetic) kernel/collective cost grids + provenance."""

    dims: np.ndarray        # (Nd,) strictly increasing
    rows: np.ndarray        # (Nr,)
    batches: np.ndarray     # (Nb,)
    poolings: np.ndarray    # (Np,)
    fwd_ms: np.ndarray      # (Nd, Nr, Nb, Np)
    bwd_ms: np.ndarray      # (Nd, Nr, Nb, Np)
    comm: CommModel
    fingerprint: dict
    version: int = CALIBRATION_VERSION
    meta: dict = dataclasses.field(default_factory=dict)
    # v2: fused multi-table correction (None -> additive fallback) and the
    # fused-sweep trace behind the fit (k, additive-vs-measured ms arrays)
    fusion_fwd: FusionModel | None = None
    fusion_bwd: FusionModel | None = None
    fusion_sweep: dict = dataclasses.field(default_factory=dict)
    # v3: partial-table (column-shard) pricing (None -> proportional
    # fallback) and the sharded-sweep trace behind the fit
    shard_fwd: ShardModel | None = None
    shard_bwd: ShardModel | None = None
    shard_sweep: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.fusion_fwd is None:
            self.fusion_fwd = FusionModel.additive()
        if self.fusion_bwd is None:
            self.fusion_bwd = FusionModel.additive()
        if self.shard_fwd is None:
            self.shard_fwd = ShardModel.proportional()
        if self.shard_bwd is None:
            self.shard_bwd = ShardModel.proportional()
        for name in ("dims", "rows", "batches", "poolings"):
            g = np.asarray(getattr(self, name), dtype=np.float64)
            if g.ndim != 1 or g.size == 0 or np.any(np.diff(g) <= 0) \
                    or g[0] <= 0:
                raise ValueError(f"{name} must be positive and strictly "
                                 f"increasing, got {g}")
            setattr(self, name, g)
        shape = (self.dims.size, self.rows.size, self.batches.size,
                 self.poolings.size)
        self.fwd_ms = np.asarray(self.fwd_ms, dtype=np.float64)
        self.bwd_ms = np.asarray(self.bwd_ms, dtype=np.float64)
        if self.fwd_ms.shape != shape or self.bwd_ms.shape != shape:
            raise ValueError(f"cost grids must have shape {shape}, got "
                             f"{self.fwd_ms.shape} / {self.bwd_ms.shape}")

    # ---- interpolation -----------------------------------------------------

    def _corner_weights(self, dim, rows, batch, pooling):
        """Per-query corner indices and axis weights, shared by every grid
        interpolated at the same query points."""
        q = np.broadcast_arrays(np.asarray(dim, np.float64),
                                np.asarray(rows, np.float64),
                                np.asarray(batch, np.float64),
                                np.asarray(pooling, np.float64))
        axes = (self.dims, self.rows, self.batches, self.poolings)
        los, his, ws = zip(*(_axis_weights(g, x) for g, x in zip(axes, q)))
        return q[0].shape, los, his, ws

    def _interp_grids(self, tables, shape, los, his, ws):
        """Multilinear blend of one or more grids over shared corner
        weights: the 16 corner weight products are computed once however
        many grids are queried."""
        outs = [np.zeros(shape) for _ in tables]
        for corner in itertools.product((0, 1), repeat=4):
            idx = tuple(his[i] if c else los[i]
                        for i, c in enumerate(corner))
            w = np.ones(shape)
            for i, c in enumerate(corner):
                w = w * (ws[i] if c else 1.0 - ws[i])
            for out, table in zip(outs, tables):
                out += w * table[idx]
        return outs

    def _interp(self, table: np.ndarray, dim, rows, batch, pooling):
        shape, los, his, ws = self._corner_weights(dim, rows, batch, pooling)
        return self._interp_grids((table,), shape, los, his, ws)[0]

    def fwd_lookup_ms(self, dim, rows, batch, pooling) -> np.ndarray:
        """Interpolated forward kernel time (ms) per query (vectorized)."""
        return self._interp(self.fwd_ms, dim, rows, batch, pooling)

    def bwd_lookup_ms(self, dim, rows, batch, pooling) -> np.ndarray:
        """Interpolated backward (scatter-add) time (ms) per query."""
        return self._interp(self.bwd_ms, dim, rows, batch, pooling)

    def lookup_ms(self, dim, rows, batch, pooling
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Interpolated ``(fwd, bwd)`` kernel times per query in ONE pass:
        both grids share the corner-weight computation (the batched
        ``MeasuredOracle`` hot path)."""
        shape, los, his, ws = self._corner_weights(dim, rows, batch, pooling)
        fwd, bwd = self._interp_grids((self.fwd_ms, self.bwd_ms),
                                      shape, los, his, ws)
        return fwd, bwd

    def comm_ms(self, payload_mb) -> np.ndarray:
        """Fitted alpha-beta all-to-all time per per-device payload."""
        return self.comm.comm_ms(payload_mb)

    # ---- persistence -------------------------------------------------------

    def save(self, path: str) -> str:
        if not path.endswith(".npz"):
            path += ".npz"                # np.savez appends it anyway
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        scalar = {"comm": self.comm.to_dict(),
                  "fingerprint": self.fingerprint,
                  "version": self.version,
                  "meta": self.meta,
                  "fusion": {"fwd": self.fusion_fwd.to_dict(),
                             "bwd": self.fusion_bwd.to_dict()},
                  "sharding": {"fwd": self.shard_fwd.to_dict(),
                               "bwd": self.shard_bwd.to_dict()}}
        sweep = {f"fusion_{k}": np.asarray(v, np.float64)
                 for k, v in self.fusion_sweep.items()}
        sweep.update({f"shard_{k}": np.asarray(v, np.float64)
                      for k, v in self.shard_sweep.items()})
        # atomic: an interrupted calibration must not leave a truncated
        # artifact behind for the next loader
        tmp = path + ".tmp.npz"
        np.savez(tmp, dims=self.dims, rows=self.rows,
                 batches=self.batches, poolings=self.poolings,
                 fwd_ms=self.fwd_ms, bwd_ms=self.bwd_ms,
                 scalar_json=np.array(json.dumps(scalar)), **sweep)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "CalibrationTable":
        with np.load(path, allow_pickle=False) as z:
            scalar = json.loads(str(z["scalar_json"]))
            if scalar["version"] > CALIBRATION_VERSION:
                raise ValueError(
                    f"calibration artifact {path} has version "
                    f"{scalar['version']} > supported {CALIBRATION_VERSION};"
                    " upgrade the code or re-calibrate")
            if "fusion" in scalar:
                fusion_fwd = FusionModel.from_dict(scalar["fusion"]["fwd"])
                fusion_bwd = FusionModel.from_dict(scalar["fusion"]["bwd"])
            else:
                # v1 artifact: no fused sweep was measured.  Load it --
                # interpolation grids are still good -- but per-device
                # pricing degrades to the additive per-table model.
                warnings.warn(
                    f"calibration artifact {path} is v{scalar['version']} "
                    "(pre-fusion): falling back to the ADDITIVE multi-table "
                    "model; re-run `python -m repro_torch.profiling.calibrate`"
                    " to measure the fused correction", stacklevel=2)
                fusion_fwd = FusionModel.additive(source="v1-fallback")
                fusion_bwd = FusionModel.additive(source="v1-fallback")
            if "sharding" in scalar:
                shard_fwd = ShardModel.from_dict(scalar["sharding"]["fwd"])
                shard_bwd = ShardModel.from_dict(scalar["sharding"]["bwd"])
            else:
                # pre-v3 artifact: no sharded-gather sweep was measured.
                # Whole-table pricing is unaffected; partial tables fall
                # back to the additive column-fraction model.
                warnings.warn(
                    f"calibration artifact {path} is v{scalar['version']} "
                    "(pre-sharding): partial-table costs use the "
                    "PROPORTIONAL column-fraction model; re-run `python -m "
                    "repro_torch.profiling.calibrate` to measure the "
                    "sharded-gather correction", stacklevel=2)
                shard_fwd = ShardModel.proportional(source="v2-fallback")
                shard_bwd = ShardModel.proportional(source="v2-fallback")
            fusion_sweep = {k[len("fusion_"):]: z[k] for k in z.files
                            if k.startswith("fusion_")}
            shard_sweep = {k[len("shard_"):]: z[k] for k in z.files
                           if k.startswith("shard_")}
            return cls(dims=z["dims"], rows=z["rows"], batches=z["batches"],
                       poolings=z["poolings"], fwd_ms=z["fwd_ms"],
                       bwd_ms=z["bwd_ms"],
                       comm=CommModel.from_dict(scalar["comm"]),
                       fingerprint=scalar["fingerprint"],
                       version=scalar["version"], meta=scalar["meta"],
                       fusion_fwd=fusion_fwd, fusion_bwd=fusion_bwd,
                       fusion_sweep=fusion_sweep,
                       shard_fwd=shard_fwd, shard_bwd=shard_bwd,
                       shard_sweep=shard_sweep)

    # ---- construction ------------------------------------------------------

    @classmethod
    def measure(cls, *, dims=None, rows=None, batches=None, poolings=None,
                warmup: int = 1, repeats: int = 5, seed: int = 0,
                spec: HardwareSpec = PAPER_GPU,
                comm: CommModel | None = None,
                fused: bool = True, fused_ks=None, fused_per_k: int | None = None,
                sharded: bool = True, shard_fracs=None,
                shard_per_frac: int | None = None,
                progress=None, meta: dict | None = None,
                device=None) -> "CalibrationTable":
        """Run the full offline calibration on ``device`` (``cuda`` by
        default: K1's kernels; ``"cpu"``: their plain versions): kernel
        sweep + comm fit + fused multi-table sweep + sharded-gather sweep
        (``fused=False`` / ``sharded=False`` skip a sweep and leave the
        additive / proportional fallback model, like a v1 / v2 artifact).

        The kernel pads dims to 128 lanes, so sub-128 dims would all time
        the same shape: the dim axis is collapsed to the padded dims
        actually measured (the reference's Pallas branch), keeping the
        artifact truthful about its grid."""
        from repro_torch.kernels.embedding_bag.ops import pad_dim
        from repro_torch.profiling import microbench
        dev = resolve_device(device)
        grid = {"dims": dims or DEFAULT_GRID["dims"],
                "rows": rows or DEFAULT_GRID["rows"],
                "batches": batches or DEFAULT_GRID["batches"],
                "poolings": poolings or DEFAULT_GRID["poolings"]}
        grid["dims"] = tuple(sorted({pad_dim(int(d)) for d in grid["dims"]}))
        fwd, bwd = microbench.sweep(grid["dims"], grid["rows"],
                                    grid["batches"], grid["poolings"],
                                    warmup=warmup, repeats=repeats,
                                    seed=seed, progress=progress, device=dev)
        if comm is None:
            comm = calibrate_comm(spec=spec, warmup=warmup,
                                  repeats=repeats, seed=seed, device=dev)
        table = cls(dims=np.asarray(grid["dims"], np.float64),
                    rows=np.asarray(grid["rows"], np.float64),
                    batches=np.asarray(grid["batches"], np.float64),
                    poolings=np.asarray(grid["poolings"], np.float64),
                    fwd_ms=fwd, bwd_ms=bwd, comm=comm,
                    fingerprint=hardware_fingerprint(dev),
                    meta={"warmup": warmup, "repeats": repeats, "seed": seed,
                          "device": dev.type, **(meta or {})})
        if fused:
            table.calibrate_fusion(
                ks=fused_ks or DEFAULT_FUSED_KS,
                per_k=fused_per_k or DEFAULT_FUSED_PER_K,
                warmup=warmup, repeats=repeats, seed=seed,
                progress=progress, device=dev)
        if sharded:
            table.calibrate_sharding(
                fracs=shard_fracs or DEFAULT_SHARD_FRACS,
                per_frac=shard_per_frac or DEFAULT_SHARD_PER_FRAC,
                warmup=warmup, repeats=repeats, seed=seed,
                progress=progress, device=dev)
        return table

    def calibrate_fusion(self, *, ks=DEFAULT_FUSED_KS,
                         per_k: int = DEFAULT_FUSED_PER_K, warmup: int = 1,
                         repeats: int = 5, seed: int = 0, progress=None,
                         device=None) -> None:
        """Measure the fused multi-table sweep over this table's grid and
        fit the forward/backward ``FusionModel`` pair in place.

        Each sweep point stacks K heterogeneous ``(dim, rows, pooling)``
        draws (grid points, so the single-table baseline is
        interpolation-exact) into ONE arena launch at the table's
        largest calibrated batch; the fit explains the measured
        deviation from the sum of the K single-table grid values.
        """
        from repro_torch.profiling import microbench
        batch = int(self.batches[-1])
        points = microbench.sweep_fused(
            self.dims, self.rows, self.poolings, batch, ks=ks,
            per_k=per_k, warmup=warmup, repeats=repeats, seed=seed,
            progress=progress, device=device)
        singles_fwd, singles_bwd = [], []
        for pt in points:
            f, b = self.lookup_ms(np.asarray(pt.dims), np.asarray(pt.rows),
                                  batch, np.asarray(pt.poolings))
            singles_fwd.append(f)
            singles_bwd.append(b)
        meas_fwd = np.array([pt.fwd_ms for pt in points])
        meas_bwd = np.array([pt.bwd_ms for pt in points])
        self.fusion_fwd = FusionModel.fit(singles_fwd, meas_fwd)
        self.fusion_bwd = FusionModel.fit(singles_bwd, meas_bwd)
        self.fusion_sweep = {
            "k": np.array([pt.k for pt in points], np.float64),
            "fwd_additive_ms": np.array([f.sum() for f in singles_fwd]),
            "fwd_ms": meas_fwd,
            "bwd_additive_ms": np.array([b.sum() for b in singles_bwd]),
            "bwd_ms": meas_bwd,
        }
        self.meta = {**self.meta, "fused_ks": [int(k) for k in ks],
                     "fused_per_k": int(per_k), "fused_batch": batch}

    def calibrate_sharding(self, *, fracs=DEFAULT_SHARD_FRACS,
                           per_frac: int = DEFAULT_SHARD_PER_FRAC,
                           warmup: int = 1, repeats: int = 5, seed: int = 0,
                           progress=None, device=None) -> None:
        """Measure the sharded-gather sweep over this table's grid and
        fit the forward/backward ``ShardModel`` pair in place (the v3
        field behind ``MeasuredOracle.evaluate_sharded``).

        Each sweep point times one shape at a partial column width AND
        at its full width (same index stream), so the fit sees exactly
        the ratio the oracle will apply to interpolated full-table
        times.
        """
        from repro_torch.profiling import microbench
        batch = int(self.batches[-1])
        points = microbench.sweep_sharded(
            self.dims, self.rows, self.poolings, batch, fracs=fracs,
            per_frac=per_frac, warmup=warmup, repeats=repeats, seed=seed,
            progress=progress, device=device)
        frac = np.array([pt.frac for pt in points])
        self.shard_fwd = ShardModel.fit(
            np.array([pt.full_fwd_ms for pt in points]), frac,
            np.array([pt.fwd_ms for pt in points]))
        self.shard_bwd = ShardModel.fit(
            np.array([pt.full_bwd_ms for pt in points]), frac,
            np.array([pt.bwd_ms for pt in points]))
        self.shard_sweep = {
            "frac": frac,
            "fwd_full_ms": np.array([pt.full_fwd_ms for pt in points]),
            "fwd_ms": np.array([pt.fwd_ms for pt in points]),
            "bwd_full_ms": np.array([pt.full_bwd_ms for pt in points]),
            "bwd_ms": np.array([pt.bwd_ms for pt in points]),
        }
        self.meta = {**self.meta,
                     "shard_fracs": [float(f) for f in fracs],
                     "shard_per_frac": int(per_frac),
                     "shard_batch": batch}

    @classmethod
    def synthetic(cls, spec: HardwareSpec = PAPER_GPU, *, dims=None,
                  rows=None, batches=None, poolings=None
                  ) -> "CalibrationTable":
        """Deterministic table from the analytic ``CostSimulator``: grid
        cells are the simulator's noise-free per-table fused-op cost at
        that shape (uniform access distribution).  No kernels run."""
        grid = {"dims": dims or SMOKE_GRID["dims"],
                "rows": rows or SMOKE_GRID["rows"],
                "batches": batches or SMOKE_GRID["batches"],
                "poolings": poolings or SMOKE_GRID["poolings"]}
        g = {k: np.asarray(v, np.float64) for k, v in grid.items()}
        shape = tuple(g[k].size for k in ("dims", "rows", "batches",
                                          "poolings"))
        fwd = np.zeros(shape)
        bwd = np.zeros(shape)
        dist = np.full((1, F.NUM_DIST_BINS), 1.0 / F.NUM_DIST_BINS)
        for k, b in enumerate(g["batches"]):
            sim = CostSimulator(spec, batch_size=int(b), noise_std=0.0)
            for i, d in enumerate(g["dims"]):
                for j, r in enumerate(g["rows"]):
                    for n, p in enumerate(g["poolings"]):
                        raw = F.pack_features([d], [r], [p], dist)
                        fwd[i, j, k, n] = (spec.comp_overhead_ms
                                           + sim.marginal_fwd_ms(raw)[0])
                        bwd[i, j, k, n] = (spec.comp_overhead_ms
                                           + sim.marginal_bwd_ms(raw)[0])
        return cls(dims=g["dims"], rows=g["rows"], batches=g["batches"],
                   poolings=g["poolings"], fwd_ms=fwd, bwd_ms=bwd,
                   comm=CommModel.from_spec(spec),
                   fingerprint={"backend": "synthetic", "device_kind": spec.name,
                                "n_devices": 0, "platform": "analytic",
                                "machine": "analytic"},
                   meta={"source": "costsim", "spec": spec.name},
                   # the grid cells are the simulator's c0 + marginal, so
                   # the spec's own pipeline constants ARE the matching
                   # fused correction: pricing K co-resident tables
                   # through this model reproduces fused_op_ms modulo the
                   # placement-dependent shared-cache term
                   fusion_fwd=FusionModel.from_spec(spec),
                   fusion_bwd=FusionModel.from_spec(spec),
                   # same reasoning for partial tables: the spec's c0 is
                   # the unsplittable per-gather floor, streaming cost
                   # proportional to columns
                   shard_fwd=ShardModel.from_spec(spec),
                   shard_bwd=ShardModel.from_spec(spec))

    def summary(self) -> str:
        n_pts = self.fwd_ms.size
        return (f"CalibrationTable v{self.version}: {n_pts} kernel points "
                f"(dims {self.dims.astype(int).tolist()}, "
                f"rows {self.rows.astype(int).tolist()}, "
                f"batches {self.batches.astype(int).tolist()}, "
                f"poolings {self.poolings.astype(int).tolist()}), "
                f"comm {self.comm.source} alpha={self.comm.alpha_ms:.4f}ms "
                f"beta={self.comm.beta_ms_per_mb:.4f}ms/MB, "
                f"fusion fwd {self.fusion_fwd.source}"
                f" c0={self.fusion_fwd.overhead_ms:.4f}ms"
                f"/bwd c0={self.fusion_bwd.overhead_ms:.4f}ms, "
                f"shard fwd {self.shard_fwd.source}"
                f" o={self.shard_fwd.overhead_ms:.4f}ms"
                f"/bwd o={self.shard_bwd.overhead_ms:.4f}ms, "
                f"hw={self.fingerprint.get('device_kind')} "
                f"(torch {self.fingerprint.get('torch')}, "
                f"CUDA {self.fingerprint.get('cuda')})")


def load_or_none(path: str | None = None) -> CalibrationTable | None:
    """Load the artifact if present and readable, else ``None`` (a
    corrupt/stale artifact means "re-measure", never a crash)."""
    import zipfile
    path = default_artifact_path() if path is None else path
    if not os.path.exists(path):
        return None
    try:
        return CalibrationTable.load(path)
    except (ValueError, OSError, KeyError, json.JSONDecodeError,
            zipfile.BadZipFile):
        return None
