"""Kernel micro-benchmark harness for the fused embedding bag (K1).

The counterpart of ``repro/profiling/microbench.py``: times the fused
forward (``ops.embedding_bag``) and its backward
(``ops.embedding_bag_grad``), each the CUDA kernel on CUDA tensors and
the plain version on CPU tensors, at one ``(dim, rows, batch, pooling)``
shape or one fused multi-table shape, and ``measure_placement`` times a
whole placement, one fused forward and backward per device.  Inputs are
drawn with the same numpy streams as the reference, so the indices are
bitwise the JAX harness's.

Times come from CUDA events on CUDA tensors (after warmup, median of
repeats) and from the host clock on CPU tensors; a CPU time is a CPU
time, never a device metric.  ``sweep``, ``sweep_fused`` and
``sweep_sharded`` time grids of such shapes for the calibration artifact
(``repro_torch.profiling.calibration``), with the reference's numpy
streams: the same shapes, seeds and indices.  The kernel times the
feature dim padded to its 128 lanes, so the sweeps follow the reference's
padded (Pallas) branch.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import features as F
from repro_torch.device import resolve_device
from repro_torch.kernels.embedding_bag.ops import (embedding_bag,
                                                  embedding_bag_grad, pad_dim)
from repro_torch.sim.costsim import CostSimulator, SimResult, placement_digest
from repro_torch.sim.hardware import HardwareSpec, PAPER_GPU


def _on_cuda(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def median_time_ms(fn, args, *, warmup: int = 1, repeats: int = 5) -> float:
    """Median time (ms) of ``fn(*args)`` over ``repeats`` runs after
    ``warmup`` untimed calls.  With a CUDA tensor among ``args`` each run
    is timed by CUDA events on the current stream; otherwise by the host
    clock."""
    if not _on_cuda(args):
        for _ in range(max(1, warmup)):
            fn(*args)
        times = []
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    for _ in range(max(1, warmup)):
        fn(*args)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(max(1, repeats))]
    for start, end in events:
        start.record()
        fn(*args)
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


@dataclasses.dataclass(frozen=True)
class BenchPoint:
    """One measured grid point (times in milliseconds)."""

    dim: int
    rows: int
    batch: int
    pooling: int
    fwd_ms: float
    bwd_ms: float


def kernel_name(key: str) -> str:
    """A profiler kernel key without ``void``, the anonymous namespace,
    template arguments and parameters."""
    return key.replace("void ", "").replace(
        "(anonymous namespace)::", "").split("<")[0].split("(")[0]


def kernel_ms(fn, args, calls: int) -> dict:
    """Each CUDA kernel's device ms a launch over ``calls`` calls of
    ``fn(*args)``, by ``torch.profiler``, keyed by the kernel's name
    without its template arguments; empty when the profiler recorded no
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count:
            name = kernel_name(e.key)
            out[name] = out.get(name, 0.0) + \
                e.self_device_time_total / 1e3 / e.count
    return out


def make_inputs(dim: int, rows: int, batch: int, pooling: int,
                seed: int = 0, *, device=None):
    """(arena, indices, grad_out) for one benchmark shape.

    Arena row 0 is the zero row (never indexed here); indices follow a
    zipf-ish reuse pattern like real lookup streams, seeded for
    reproducible index working sets.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    arena = torch.zeros((rows + 1, dim), dtype=torch.float32, device=dev)
    draws = rng.zipf(1.5, size=(batch, pooling))
    idx = torch.as_tensor((1 + draws % rows).astype(np.int32), device=dev)
    g = torch.ones((batch, dim), dtype=torch.float32, device=dev)
    return arena, idx, g


def _time_fwd_bwd(arena, idx, g, *, warmup: int, repeats: int):
    with torch.no_grad():
        fwd_ms = median_time_ms(embedding_bag, (arena, idx),
                                warmup=warmup, repeats=repeats)
        bwd_ms = median_time_ms(embedding_bag_grad, (arena.shape, idx, g),
                                warmup=warmup, repeats=repeats)
    return fwd_ms, bwd_ms


def bench_shape(dim: int, rows: int, batch: int, pooling: int, *,
                warmup: int = 1, repeats: int = 5, seed: int = 0,
                device=None) -> BenchPoint:
    """Time the forward kernel and the backward at one grid point (the
    feature dim padded to the kernel's 128 lanes)."""
    dim = pad_dim(dim)
    arena, idx, g = make_inputs(dim, rows, batch, pooling, seed=seed,
                                device=device)
    fwd_ms, bwd_ms = _time_fwd_bwd(arena, idx, g, warmup=warmup,
                                   repeats=repeats)
    return BenchPoint(dim=int(dim), rows=int(rows), batch=int(batch),
                      pooling=int(pooling), fwd_ms=fwd_ms, bwd_ms=bwd_ms)


def sweep(dims, rows, batches, poolings, *, warmup: int = 1,
          repeats: int = 5, seed: int = 0, progress=None,
          device=None) -> tuple[np.ndarray, np.ndarray]:
    """Dense grid sweep -> ``(fwd_ms, bwd_ms)`` arrays of shape
    ``(len(dims), len(rows), len(batches), len(poolings))``.

    ``progress`` (optional) is called with each finished ``BenchPoint``.
    """
    shape = (len(dims), len(rows), len(batches), len(poolings))
    fwd = np.zeros(shape)
    bwd = np.zeros(shape)
    for i, d in enumerate(dims):
        for j, r in enumerate(rows):
            for k, b in enumerate(batches):
                for n, p in enumerate(poolings):
                    pt = bench_shape(int(d), int(r), int(b), int(p),
                                     warmup=warmup, repeats=repeats,
                                     seed=seed, device=device)
                    fwd[i, j, k, n] = pt.fwd_ms
                    bwd[i, j, k, n] = pt.bwd_ms
                    if progress is not None:
                        progress(pt)
    return fwd, bwd


@dataclasses.dataclass(frozen=True)
class FusedBenchPoint:
    """One measured fused multi-table op (times in milliseconds)."""

    dims: tuple
    rows: tuple
    poolings: tuple
    batch: int
    fwd_ms: float
    bwd_ms: float

    @property
    def k(self) -> int:
        return len(self.dims)


def fused_arena_dim(dims) -> int:
    """Arena width of a fused op over heterogeneous tables: the widest
    table, padded to 128 lanes."""
    return max(128, int(np.ceil(max(dims) / 128) * 128))


def fused_indices(rng: np.random.Generator, rows, batch: int, poolings):
    """Indices of ONE fused op over tables stacked back to back in an
    arena (row 0 = zero row): ``batch`` zipf-ish lookups per table at its
    own pooling factor, padded to the widest pooling with the zero row.
    Returns ``(n_arena_rows, idx (batch * K, P_max) int32)``.  Shared by
    ``make_fused_inputs`` and ``measure_placement``; the draws are those
    of the reference harness."""
    rows = np.asarray(rows, dtype=np.int64)
    bases = np.concatenate([[1], 1 + np.cumsum(rows)[:-1]])
    p_max = int(max(poolings))
    idx = np.zeros((batch * len(rows), p_max), np.int32)
    for k, (b, r, p) in enumerate(zip(bases, rows, poolings)):
        draws = rng.zipf(1.5, size=(batch, int(p)))
        idx[k * batch:(k + 1) * batch, :int(p)] = b + draws % r
    return 1 + int(rows.sum()), idx


def make_fused_inputs(dims, rows, batch: int, poolings, seed: int = 0, *,
                      device=None):
    """(arena, indices, grad_out) for ONE fused op over K stacked tables
    at ``fused_arena_dim`` width (see ``fused_indices``)."""
    dev = resolve_device(device)
    n_rows, idx = fused_indices(np.random.default_rng(seed), rows, batch,
                                poolings)
    dim = fused_arena_dim(dims)
    arena = torch.zeros((n_rows, dim), dtype=torch.float32, device=dev)
    g = torch.ones((idx.shape[0], dim), dtype=torch.float32, device=dev)
    return arena, torch.as_tensor(idx, device=dev), g


def bench_fused_shape(dims, rows, batch: int, poolings, *, warmup: int = 1,
                      repeats: int = 5, seed: int = 0,
                      device=None) -> FusedBenchPoint:
    """Time ONE fused forward + backward op over K heterogeneous tables."""
    arena, idx, g = make_fused_inputs(dims, rows, batch, poolings,
                                      seed=seed, device=device)
    fwd_ms, bwd_ms = _time_fwd_bwd(arena, idx, g, warmup=warmup,
                                   repeats=repeats)
    return FusedBenchPoint(dims=tuple(int(d) for d in dims),
                           rows=tuple(int(r) for r in rows),
                           poolings=tuple(int(p) for p in poolings),
                           batch=int(batch), fwd_ms=fwd_ms, bwd_ms=bwd_ms)


def sweep_fused(dims, rows, poolings, batch: int, *, ks=(2, 4, 8),
                per_k: int = 4, warmup: int = 1, repeats: int = 5,
                seed: int = 0, progress=None,
                device=None) -> list[FusedBenchPoint]:
    """Fused multi-table sweep: for each fusion depth K, time ``per_k``
    ops over heterogeneous ``(rows, pooling)`` draws from the grid axes
    (with replacement, seeded), so the single-table baseline each op is
    compared to is interpolation-exact.  Each op's K tables share ONE dim
    (drawn per op): a mixed-dim group would fold arena-padding inflation
    into the ``FusionModel`` fit."""
    rng = np.random.default_rng(seed)
    dims = np.asarray(dims)
    rows = np.asarray(rows)
    poolings = np.asarray(poolings)
    points = []
    for k in ks:
        for _ in range(per_k):
            dim = dims[rng.integers(0, dims.size)]
            pt = bench_fused_shape(
                np.full(k, dim),
                rows[rng.integers(0, rows.size, size=k)],
                batch, poolings[rng.integers(0, poolings.size, size=k)],
                warmup=warmup, repeats=repeats,
                seed=int(rng.integers(0, 2**31)), device=device)
            points.append(pt)
            if progress is not None:
                progress(pt)
    return points


@dataclasses.dataclass(frozen=True)
class ShardBenchPoint:
    """One measured partial-width (column-shard) gather vs its full table.

    ``frac`` is the measured column fraction ``width / dim``, both after
    the kernel's lane padding, so the ratio describes the shapes timed."""

    dim: int            # full table width
    width: int          # shard width actually timed
    rows: int
    batch: int
    pooling: int
    frac: float         # width / dim
    fwd_ms: float       # shard gather time
    bwd_ms: float
    full_fwd_ms: float  # same shape at full width (the K=1 baseline)
    full_bwd_ms: float


def sweep_sharded(dims, rows, poolings, batch: int, *,
                  fracs=(0.25, 0.5, 0.75), per_frac: int = 3,
                  warmup: int = 1, repeats: int = 5, seed: int = 0,
                  progress=None, device=None) -> list[ShardBenchPoint]:
    """Sharded-gather sweep: time partial-width lookups against their
    full-width baselines.

    For each column fraction, ``per_frac`` heterogeneous ``(dim, rows,
    pooling)`` draws from the grid axes are timed twice -- at the shard
    width ``max(1, round(dim * frac))`` and at the full ``dim`` (a grid
    point), with the same index stream.  The pairs feed
    ``ShardModel.fit``.  Both widths go through the kernel's 128-lane
    padding, and ``frac`` reports the padded ratio.
    """
    rng = np.random.default_rng(seed)
    dims = np.asarray(dims)
    rows = np.asarray(rows)
    poolings = np.asarray(poolings)
    # only dims wide enough to split are worth drawing
    wide = dims[dims >= 2] if (dims >= 2).any() else dims
    points = []
    for frac in fracs:
        for _ in range(per_frac):
            d = int(wide[rng.integers(0, wide.size)])
            r = int(rows[rng.integers(0, rows.size)])
            p = int(poolings[rng.integers(0, poolings.size)])
            width = max(1, int(round(d * float(frac))))
            s = int(rng.integers(0, 2**31))
            part = bench_shape(width, r, batch, p, warmup=warmup,
                               repeats=repeats, seed=s, device=device)
            full = bench_shape(d, r, batch, p, warmup=warmup,
                               repeats=repeats, seed=s, device=device)
            pt = ShardBenchPoint(
                dim=full.dim, width=part.dim, rows=r, batch=batch,
                pooling=p, frac=part.dim / full.dim,
                fwd_ms=part.fwd_ms, bwd_ms=part.bwd_ms,
                full_fwd_ms=full.fwd_ms, full_bwd_ms=full.bwd_ms)
            points.append(pt)
            if progress is not None:
                progress(pt)
    return points


def device_tables(raw: np.ndarray, max_rows: int, pooling: int | None):
    """(rows, poolings) of the tables of one device as
    ``measure_placement`` builds them: rows capped at ``max_rows``, each
    table's own rounded pooling factor (``pooling=None``) or a forced
    one."""
    rows = np.minimum(raw[:, F.HASH_SIZE].astype(np.int64), max_rows)
    if pooling is None:
        pools = np.maximum(1, np.rint(raw[:, F.POOLING]).astype(np.int64))
    else:
        pools = np.full(len(rows), int(pooling), np.int64)
    return rows, pools


def placement_inputs(raw: np.ndarray, assignment: np.ndarray,
                     n_devices: int, *, batch_size: int,
                     pooling: int | None, max_rows: int, seed: int = 0):
    """Yield ``(device, its tables' rows of raw, arena shape, indices)``
    for each used device of a placement, in device order, with the draws
    ``measure_placement`` times: rows capped at ``max_rows``, the arena at
    the placement's widest dim padded to 128 lanes, the indices from one
    numpy stream seeded by the placement's digest ``^ seed``."""
    raw = np.asarray(raw, dtype=np.float64)
    assignment = np.asarray(assignment)
    rng = np.random.default_rng(
        placement_digest(raw, assignment, n_devices) ^ seed)
    dim = max(128, int(np.ceil(raw[:, F.DIM].max() / 128) * 128))
    for d in range(n_devices):
        sub = raw[assignment == d]
        if sub.shape[0] == 0:
            continue
        rows, pools = device_tables(sub, max_rows, pooling)
        n_rows, idx = fused_indices(rng, rows, batch_size, pools)
        yield d, sub, (n_rows, dim), idx


def measure_placement(raw: np.ndarray, assignment: np.ndarray,
                      n_devices: int, *, spec: HardwareSpec = PAPER_GPU,
                      batch_size: int = 64, pooling: int | None = 4,
                      max_rows: int = 4096, repeats: int = 2,
                      seed: int = 0, device=None) -> SimResult:
    """LIVE per-placement measurement.

    Builds each device's arena (rows capped at ``max_rows``), synthesizes
    zipf-ish lookups, and times one fused forward and its backward (K1's
    kernels on a CUDA device) for every device group, on the one device
    given (``placement_inputs`` gives the shapes and indices).
    Communication reuses the simulator's analytic model.
    ``pooling=None`` takes each table's own pooling factor from ``raw``
    (blocks padded to the device's widest pooling with the zero row); an
    int forces that factor everywhere.  Empty devices cost 0.
    """
    dev = resolve_device(device)
    fwd = np.zeros(n_devices)
    bwd = np.zeros(n_devices)
    dim_sums = np.zeros(n_devices)

    for d, sub, shape, idx in placement_inputs(
            raw, assignment, n_devices, batch_size=batch_size,
            pooling=pooling, max_rows=max_rows, seed=seed):
        arena = torch.zeros(shape, dtype=torch.float32, device=dev)
        idx = torch.as_tensor(idx, device=dev)
        g = torch.ones((idx.shape[0], shape[1]), dtype=torch.float32,
                       device=dev)
        fwd[d], bwd[d] = _time_fwd_bwd(arena, idx, g, warmup=1,
                                       repeats=repeats)
        dim_sums[d] = sub[:, F.DIM].sum()
        del arena, idx, g

    comm = CostSimulator(spec, noise_std=0.0).comm_ms(dim_sums, n_devices)
    fwd_comm = (fwd.max() - fwd) + comm
    overall = fwd.max() + 2.0 * comm.max() + bwd.max()
    return SimResult(fwd_comp=fwd, bwd_comp=bwd, fwd_comm=fwd_comm,
                     bwd_comm=comm, overall=float(overall))
