#!/usr/bin/env python3
"""Drive the PyTorch port of DreamShard once on one NVIDIA GPU.

    python3 chip_smoke.py [--out summary.json]

Phases, each of which fails the run (non-zero exit) on any error:

1. device: the card's name and power limit, as ``nvidia-smi`` reports them;
2. build: K1 (``src/repro_torch/csrc/embedding_bag.cu``) with nvcc for
   sm_90a into ``build/kernels/``;
3. K1 against its plain PyTorch version on the card: the reference's test
   sweep (rows x dim x pool x {f32, bf16}), the all-padding case, and
   arenas of more than 2^31 elements (64-bit row offsets);
4. the main path: place the paper's DLRM-50 (4) test tasks with an
   untrained DreamShard agent (seed 0, 16 candidates) through
   ``as_placer().place_many`` on ``cuda``, run the baseline placers, then
   measure DreamShard's and the experts' placements of two tasks with
   ``measure_placement`` (batch 65536, each table's own pooling, rows
   capped at 2^20) -- one K1 launch per device and repeat;
5. the yardstick: K1, its plain version and ``F.embedding_bag`` timed at
   the largest main-path device shape, beside the memory bound.

It prints the kernel line (one JSON object with a ``kernels`` list) and
then, as its last line, ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOP_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BATCH = 65536                    # the paper's DLRM batch
MAX_ROWS = 2 ** 20
N_MEASURED_TASKS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def allclose_err(out, ref, tol: float) -> float:
    """Max |out - ref|; raises unless |out - ref| <= tol + tol * |ref|."""
    diff = (out - ref).abs()
    check(bool((diff <= tol + tol * ref.abs()).all()),
          f"max |err| {float(diff.max())} over tolerance {tol}")
    return float(diff.max()) if diff.numel() else 0.0


def phase_device() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(line.splitlines()[0] if line else "nvidia-smi: no output")
    check(bool(line), "nvidia-smi printed nothing")
    return line.splitlines()[0]


def phase_build(K) -> float:
    t0 = time.perf_counter()
    path = K.embedding_bag_cuda.build()
    secs = time.perf_counter() - t0
    log(f"[build] {os.path.relpath(path, ROOT)} in {secs:.2f} s")
    for ln in K.embedding_bag_cuda.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            log(f"[build] {ln.strip()}")
    return secs


def phase_kernel_checks(torch, np, K, plain) -> float:
    """K1 against the plain version on the card; returns the max error."""
    worst = 0.0
    cases = 0
    for rows in (8, 100, 1000):
        for dim in (128, 256):
            for pool in (1, 4, 16):
                for dtype, tol in ((torch.float32, 1e-5),
                                   (torch.bfloat16, 3e-2)):
                    rng = np.random.default_rng(rows * dim + pool)
                    arena = torch.as_tensor(
                        rng.normal(size=(rows, dim)), dtype=torch.float32,
                        device="cuda").to(dtype)
                    idx = torch.as_tensor(
                        rng.integers(0, rows, (12, pool)), dtype=torch.int32,
                        device="cuda")
                    out = K.embedding_bag_cuda(arena, idx)
                    ref = plain(arena, idx)
                    torch.cuda.synchronize()
                    worst = max(worst, allclose_err(out, ref, tol))
                    cases += 1
    arena = torch.randn((50, 128), device="cuda")
    arena[0] = 0.0
    out = K.embedding_bag_cuda(arena, torch.zeros((4, 8), dtype=torch.int32,
                                                  device="cuda"))
    torch.cuda.synchronize()
    check(bool((out == 0).all()), "all-padding bags must sum to zero")
    cases += 1
    # arenas past 2^31 elements: row * D overflows 32 bits there
    n_rows = 2 ** 24 + 2 ** 20
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        arena = torch.randn((n_rows, 128), generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype)
        arena[0] = 0
        idx = torch.randint(n_rows - 2 ** 21, n_rows, (8192, 8),
                            generator=gen, device="cuda", dtype=torch.int32)
        idx[:, -1] = 0
        out = K.embedding_bag_cuda(arena, idx)
        ref = plain(arena, idx)
        torch.cuda.synchronize()
        worst = max(worst, allclose_err(out, ref, tol))
        log(f"[kernel] {dtype} arena of {arena.numel()} elements "
            f"({arena.numel() * arena.element_size() / 2**30:.2f} GiB): ok")
        cases += 1
        del arena, idx, out, ref
    torch.cuda.empty_cache()
    log(f"[kernel] K1 == plain on {cases} cases, max |err| {worst:.3g}")
    return worst


def phase_main_path(torch, np, K, summary: dict):
    from repro_torch import telemetry as tele
    from repro_torch.api import (SimOracle, make_baseline_placers,
                                 measure_placements)
    from repro_torch.core.trainer import DreamShard, DreamShardConfig
    from repro_torch.data.synthetic import make_dlrm_pool
    from repro_torch.data.tasks import make_benchmark_suite
    from repro_torch.profiling.microbench import measure_placement

    pool = make_dlrm_pool(seed=0)
    train, test = make_benchmark_suite(pool, n_tables=50, n_devices=4,
                                       n_tasks=20)
    oracle = SimOracle(seed=0)
    tele.reset()
    tele.enable()
    K.embedding_bag_cuda.launches = 0          # counts of the main path only

    agent = DreamShard(train, oracle, DreamShardConfig(seed=0),
                       device="cuda")
    placer = agent.as_placer(n_candidates=16)
    decode = {}
    for run in ("cold", "warm"):
        tele.reset()
        t0 = time.perf_counter()
        placements = placer.place_many(test)
        wall = (time.perf_counter() - t0) * 1e3
        spans = [ev for ev in tele.get_tracer().snapshot_events()
                 if ev[0] == "session.decode"]
        for _name, _ts, dur_us, *_rest, args in spans:
            log(f"[decode] {run}: bucket m_pad={args['m_pad']} "
                f"D={args['n_devices']} tasks={args['tasks']} "
                f"b_pad={args['b_pad']}: {dur_us / 1e3:.2f} ms")
        decode[run] = {"place_many_ms": wall,
                       "bucket_ms": [ev[2] / 1e3 for ev in spans]}
        log(f"[decode] {run}: place_many of {len(test)} tasks {wall:.2f} ms")
    summary["decode"] = decode
    for task, p in zip(test, placements):
        check(p.assignment.shape == (task.n_tables,), "assignment shape")
        check(bool(((p.assignment >= 0) & (p.assignment < 4)).all()),
              "device ids in range")
        check(math.isfinite(p.est_cost_ms), "finite estimated cost")
    # the session equals per-task Algorithm 2, and the card's greedy decode
    # equals the CPU's from the same seed
    cpu_agent = DreamShard(train, oracle, DreamShardConfig(seed=0),
                           device="cpu")
    for task, p in zip(test[:N_MEASURED_TASKS], placements):
        a, est = agent.place_detailed(task.raw_features, task.n_devices)
        check(bool((a == p.assignment).all()), "session == per-task place")
        g_cuda, e_cuda = agent.place_detailed(task.raw_features,
                                              task.n_devices, 1)
        g_cpu, e_cpu = cpu_agent.place_detailed(task.raw_features,
                                                task.n_devices, 1)
        check(bool((g_cuda == g_cpu).all()), "greedy decode cuda == cpu")
        check(abs(e_cuda - e_cpu) <= 1e-4 * abs(e_cpu), "estimate cuda~cpu")
    log("[decode] session == per-task place; greedy cuda == cpu")

    sim_costs = {"dreamshard": measure_placements(oracle, test, placements)}
    by_strategy = {"dreamshard": placements}
    for name, bp in make_baseline_placers(oracle).items():
        by_strategy[name] = bp.place_many(test)
        sim_costs[name] = measure_placements(oracle, test, by_strategy[name])
    for name, c in sim_costs.items():
        check(bool(np.isfinite(c).all()), f"{name}: finite simulated costs")
        log(f"[sim] {name:11s} mean simulated cost over {len(test)} tasks "
            f"{float(np.mean(c)):.3f} ms (2080Ti-fitted model)")
    summary["sim_mean_ms"] = {k: float(np.mean(v))
                              for k, v in sim_costs.items()}

    measured = []
    shapes = []
    for ti, task in enumerate(test[:N_MEASURED_TASKS]):
        for name in ("dreamshard", "size", "dim", "lookup", "size_lookup"):
            a = by_strategy[name][ti].assignment
            t0 = time.perf_counter()
            res = measure_placement(task.raw_features, a, task.n_devices,
                                    batch_size=BATCH, pooling=None,
                                    max_rows=MAX_ROWS, device="cuda")
            wall = time.perf_counter() - t0
            sim = oracle.evaluate(task.raw_features, a, task.n_devices)
            counts = np.bincount(a, minlength=task.n_devices)
            for d in range(task.n_devices):
                used = counts[d] > 0
                check(bool(np.isfinite(res.fwd_comp[d])
                           and np.isfinite(res.bwd_comp[d])), "finite ms")
                check((res.fwd_comp[d] > 0) == used
                      and (res.bwd_comp[d] > 0) == used,
                      "positive times exactly on used devices")
            log(f"[measure] task {ti} {name:11s} tables/dev "
                f"{counts.tolist()} fwd ms "
                f"{np.round(res.fwd_comp, 3).tolist()} bwd ms "
                f"{np.round(res.bwd_comp, 3).tolist()} overall "
                f"{res.overall:.3f} ms | simulated {sim.overall:.3f} ms "
                f"| wall {wall:.1f} s")
            measured.append({
                "task": ti, "strategy": name,
                "tables_per_device": counts.tolist(),
                "fwd_ms": res.fwd_comp.tolist(),
                "bwd_ms": res.bwd_comp.tolist(),
                "overall_ms": res.overall, "sim_overall_ms": sim.overall})
            shapes += [task.raw_features[a == d]
                       for d in range(task.n_devices) if counts[d]]
    launches = K.embedding_bag_cuda.launches
    tele.disable()
    summary["measured"] = measured
    check(launches > 0, "the main path launched K1 no time")
    log(f"[main] K1 launches on the main path: {launches}")
    return launches, shapes


def phase_yardstick(torch, np, K, plain, shapes, summary: dict) -> dict:
    """K1, plain and F.embedding_bag at the largest main-path device."""
    from repro_torch.core import features as FEAT
    from repro_torch.profiling.microbench import (device_tables,
                                                  make_fused_inputs,
                                                  median_time_ms)
    sub = max(shapes, key=lambda s: float(
        device_tables(s, MAX_ROWS, None)[1].max() * len(s)))
    rows, pools = device_tables(sub, MAX_ROWS, None)
    arena, idx, _ = make_fused_inputs(sub[:, FEAT.DIM], rows, BATCH, pools,
                                      seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    arena.normal_(generator=gen)
    arena[0] = 0.0
    n, p = idx.shape
    dim = arena.shape[1]
    with torch.no_grad():
        out = K.embedding_bag_cuda(arena, idx)
        ref = plain(arena, idx)
        torch.cuda.synchronize()
        err = allclose_err(out, ref, 1e-5)
        del out, ref
        ms = median_time_ms(K.embedding_bag_cuda, (arena, idx), warmup=2,
                            repeats=10)
        plain_ms = median_time_ms(plain, (arena, idx), warmup=1, repeats=3)
        lib = torch.nn.functional.embedding_bag
        lib_out = lib(idx, arena, mode="sum")
        allclose_err(lib_out, plain(arena, idx), 1e-4)
        del lib_out
        library_ms = median_time_ms(lambda i, w: lib(i, w, mode="sum"),
                                    (idx, arena), warmup=2, repeats=10)
        seen = torch.zeros(arena.shape[0], dtype=torch.bool, device="cuda")
        seen[idx.reshape(-1).long()] = True
        distinct = int(seen.sum())
        slots = int((idx != 0).sum())
    nbytes = (distinct * dim * arena.element_size() + idx.numel() * 4
              + n * dim * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = slots * dim / F32_FLOP_PER_S * 1e3
    row = {"name": "embedding_bag", "route": "cuda",
           "source": "src/repro_torch/csrc/embedding_bag.cu",
           "replaces": "src/repro/kernels/embedding_bag/kernel.py:50",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms}
    summary["yardstick"] = {
        "tables": int(len(sub)), "arena_rows": int(arena.shape[0]),
        "bags": int(n), "pool": int(p), "dim": int(dim),
        "distinct_rows": distinct, "nonpadding_slots": slots,
        "bytes": int(nbytes), "bytes_ms": bytes_ms, "ops_ms": ops_ms, **row}
    log(f"[yardstick] {len(sub)} tables, arena {arena.shape[0]} x {dim} f32, "
        f"idx {n} x {p}, {distinct} distinct rows: K1 {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, F.embedding_bag {library_ms:.3f} ms, bound "
        f"{row['bound_ms']:.3f} ms ({row['bound_by']})")
    del arena, idx, seen
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write a JSON summary of the run here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.kernels.embedding_bag import kernel as K
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    summary: dict = {"torch": torch.__version__, "cuda": torch.version.cuda}
    summary["nvidia_smi"] = phase_device()
    summary["build_s"] = phase_build(K)
    summary["kernel_check_max_abs_err"] = phase_kernel_checks(
        torch, np, K, embedding_bag_plain)
    launches, shapes = phase_main_path(torch, np, K, summary)
    row = phase_yardstick(torch, np, K, embedding_bag_plain, shapes, summary)
    row = {**row, "launches": launches}
    summary["kernels"] = [row]
    summary["seconds"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    log(f"[done] {summary['seconds']:.1f} s")
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
