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
time, never a device metric.  The sweeps and the calibration wait for the
measured-oracle slice of the port.
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


def measure_placement(raw: np.ndarray, assignment: np.ndarray,
                      n_devices: int, *, spec: HardwareSpec = PAPER_GPU,
                      batch_size: int = 64, pooling: int | None = 4,
                      max_rows: int = 4096, repeats: int = 2,
                      seed: int = 0, device=None) -> SimResult:
    """LIVE per-placement measurement.

    Builds each device's arena (rows capped at ``max_rows``), synthesizes
    zipf-ish lookups, and times one fused forward and its backward (K1's
    kernels on a CUDA device) for every device group, on the one device
    given.  Communication reuses the simulator's analytic model.
    ``pooling=None`` takes each table's own pooling factor from ``raw``
    (blocks padded to the device's widest pooling with the zero row); an
    int forces that factor everywhere.  Empty devices cost 0.
    """
    dev = resolve_device(device)
    raw = np.asarray(raw, dtype=np.float64)
    assignment = np.asarray(assignment)
    rng = np.random.default_rng(
        placement_digest(raw, assignment, n_devices) ^ seed)
    dim = max(128, int(np.ceil(raw[:, F.DIM].max() / 128) * 128))
    fwd = np.zeros(n_devices)
    bwd = np.zeros(n_devices)
    dim_sums = np.zeros(n_devices)

    for d in range(n_devices):
        sub = raw[assignment == d]
        if sub.shape[0] == 0:
            continue
        rows, pools = device_tables(sub, max_rows, pooling)
        n_rows, idx = fused_indices(rng, rows, batch_size, pools)
        arena = torch.zeros((n_rows, dim), dtype=torch.float32, device=dev)
        idx = torch.as_tensor(idx, device=dev)
        g = torch.ones((idx.shape[0], dim), dtype=torch.float32, device=dev)
        fwd[d], bwd[d] = _time_fwd_bwd(arena, idx, g, warmup=1,
                                       repeats=repeats)
        dim_sums[d] = sub[:, F.DIM].sum()
        del arena, idx, g

    comm = CostSimulator(spec, noise_std=0.0).comm_ms(dim_sums, n_devices)
    fwd_comm = (fwd.max() - fwd) + comm
    overall = fwd.max() + 2.0 * comm.max() + bwd.max()
    return SimResult(fwd_comp=fwd, bwd_comp=bwd, fwd_comm=fwd_comm,
                     bwd_comm=comm, overall=float(overall))
