#!/usr/bin/env python3
"""Drive the PyTorch port of DreamShard once on one NVIDIA GPU.

    python3 chip_smoke.py [--out summary.json]

Phases, each of which fails the run (non-zero exit) on any error:

1. device: the card's name and power limit, as ``nvidia-smi`` reports them;
2. build: K1 (``src/repro_torch/csrc/embedding_bag.cu``, its forward and
   its backward) and K2 (``src/repro_torch/csrc/flash_attention.cu``) with
   nvcc for sm_90a into ``build/kernels/``, one nvcc per source, started
   together; ptxas must report no spill in any bf16 (tensor-core) K2
   instance;
3. K1's forward against its plain PyTorch version on the card, bit for
   bit: the reference's test sweep (rows x dim x pool x {f32, bf16}),
   padding at arbitrary positions with a zero, a signed-zero and a non-zero
   row 0 at P in {1, 31, 32, 33, 199}, the all-padding case, and arenas of
   more than 2^31 elements (64-bit row offsets);
3b. K1's backward against its plain version (the ``index_add_`` loop): bit
   for bit on integer-valued gradients, and on normal ones within twice the
   plain version's own error against a float64 ``index_add_`` plus 1e-6;
   bit for bit against the plain replay of its own order; two launches
   bit-equal; runs longer than the chunk, all-padding bags, bf16
   ``grad_out`` and a gradient of more than 2^31 elements;
4. the main path: place the paper's DLRM-50 (4) test tasks with an
   untrained DreamShard agent (seed 0, 16 candidates) through
   ``as_placer().place_many`` on ``cuda``, run the baseline placers, then
   measure DreamShard's and the experts' placements of two tasks with
   ``measure_placement`` (batch 65536, each table's own pooling, rows
   capped at 2^20) -- one K1 forward and one K1 backward per device and
   repeat;
5. the yardstick: K1's forward, its plain version and ``F.embedding_bag``,
   then K1's backward, its plain version and the backward of
   ``F.embedding_bag``, timed at the largest main-path device shape, beside
   the memory bound; it fails unless K1's forward beats ``F.embedding_bag``;
6. K2 against its plain PyTorch version on the card -- bf16 through the
   tensor-core kernel, float32 through the CUDA-core one: S x hd x dtype x
   window x GQA group, non-causal attention over ragged key lengths, and
   (after phase 7) layer 0's real q/k/v of the served model at 8192 tokens
   and window 4096, in bf16 and in float32, each held to a limit below a
   typical output;
7. the LM path: serve h2o-danube-1.8b at full width (24 layers, bf16,
   seeded weights) through ``repro_torch.launch.serve.serve``: 2 prompts
   of 8192 tokens, one warm-up prefill, a timed prefill and 31 greedy
   decode steps -- 24 K2 launches per prefill -- then a torch.profiler
   window over one prefill and over 4 decode steps;
8. the same path at full width with 2 layers in float32, on the card (K2)
   and on the CPU (plain): logits and greedy tokens must agree;
9. the yardstick: K2 (bf16, tensor cores), its plain version and
   ``F.scaled_dot_product_attention`` timed at the main-path layer shape,
   beside the operations bound; K2's float32 (CUDA-core) kernel is timed
   on the same values on a line of its own.

It prints each phase's seconds, the kernel line (one JSON object with a
``kernels`` list) and then, as its last line, ``{"ok": true, "device":
{...}}``.  Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOP_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
BATCH = 65536                    # the paper's DLRM batch
MAX_ROWS = 2 ** 20
N_MEASURED_TASKS = 2
ARCH = "h2o-danube-1.8b"
SERVE_BATCH = 2                  # two prompts of two windows each
SERVE_PROMPT = 8192
SERVE_TOKENS = 32


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


def attention_err(out, ref, *, max_abs: float, rel_rms: float) -> dict:
    """An attention output's errors against plain, in float32; raises
    unless max |out - ref| <= max_abs and ||out - ref|| / ||ref|| <=
    rel_rms.  ``mean_abs_ref`` comes back with them, so a limit can be read
    against a typical output: one as large as the output would let a wrong
    mask through."""
    ref = ref.float()
    diff = out.float() - ref
    worst = int(diff.abs().argmax())
    err = {"max_abs_err": float(diff.abs().max()),
           "rel_rms_err": float(diff.norm() / ref.norm()),
           "mean_abs_ref": float(ref.abs().mean()),
           # the query row of the largest error, and |ref| there
           "worst_row": worst // (diff.shape[-1] * diff.shape[-2])
           % diff.shape[1],
           "worst_abs_ref": float(ref.reshape(-1)[worst].abs()),
           "limits": [max_abs, rel_rms]}
    check(err["max_abs_err"] <= max_abs and err["rel_rms_err"] <= rel_rms,
          f"attention against plain: {err}")
    return err


def _err_line(err: dict) -> str:
    return (f"max |err| {err['max_abs_err']:.3g} (limit "
            f"{err['limits'][0]:.3g}; at query row {err['worst_row']}, "
            f"|ref| {err['worst_abs_ref']:.3g}), rms err / rms ref "
            f"{err['rel_rms_err']:.3g} (limit {err['limits'][1]:.3g}), "
            f"mean |ref| {err['mean_abs_ref']:.3g}")


def phase_device() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(line.splitlines()[0] if line else "nvidia-smi: no output")
    check(bool(line), "nvidia-smi printed nothing")
    return line.splitlines()[0]


def ptxas_functions(build_log: str) -> list:
    """(function, spill line, registers line) of each kernel that
    ``ptxas -v`` reports in a build log."""
    lines = build_log.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Function properties for" in ln and i + 2 < len(lines):
            name = ln.split("Function properties for")[-1].strip()
            out.append((name, lines[i + 1].strip(),
                        lines[i + 2].split("ptxas info    :")[-1].strip()))
    return out


def kernel_label(mangled: str) -> str:
    """A kernel instance's name with its template arguments, e.g.
    ``flash_fwd_tc_kernel<80>`` or ``segment_sum_kernel<F32, 1>``."""
    m = re.search(r"\d([a-z][a-z_]*_kernel)I(.*?)EE", mangled)
    if m is None:
        return mangled[:72]
    args = re.findall(r"Li(\d+)|(F32|Bf16)Chunk|Lb([01])", m[2])
    return f"{m[1]}<{', '.join(''.join(a) for a in args)}>"


def _report_build(library, secs: float, no_spill: str | None) -> None:
    """Print a built library's ptxas lines; with ``no_spill``, fail if
    ptxas reports a spill in a function whose name holds it."""
    log(f"[build] {os.path.relpath(library.path(), ROOT)} in {secs:.2f} s")
    funcs = ptxas_functions(library.build_log)
    for name, spill, regs in funcs:
        log(f"[build] {kernel_label(name)}: {spill}; {regs}")
    if no_spill is not None:
        mine = [f for f in funcs if no_spill in f[0]]
        check(bool(mine), f"ptxas reported no {no_spill} instance")
        for name, spill, _ in mine:
            check("0 bytes spill stores, 0 bytes spill loads" in spill,
                  f"{name} spills: {spill}")


def phase_build(builds) -> dict:
    """Build the libraries together, one nvcc each; ``builds`` maps a
    name to ``(library, no_spill)``.  Returns each build's seconds."""

    def timed(library):
        t0 = time.perf_counter()
        library.build()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(timed, lib)
                   for name, (lib, _) in builds.items()}
        secs = {name: f.result() for name, f in futures.items()}
    for name, (lib, no_spill) in builds.items():
        _report_build(lib, secs[name], no_spill)
    return secs


def bits_equal(torch, out, ref) -> bool:
    """Same shape and the same bits (+0 and -0 differ here)."""
    return out.shape == ref.shape and torch.equal(
        out.contiguous().view(torch.int32), ref.contiguous().view(torch.int32))


def _row0(torch, arena, kind: str) -> None:
    """Row 0 as a case needs it: random (left as drawn), +0, -0, or +0
    and -0 mixed."""
    if kind == "+0":
        arena[0] = 0.0
    elif kind == "-0":
        arena[0] = -0.0
    elif kind == "mixed":
        arena[0] = 0.0
        arena[0, ::3] = -0.0


def phase_kernel_checks(torch, np, K, plain) -> int:
    """K1's forward against the plain version on the card, bit for bit;
    returns the number of cases."""
    cases = 0

    def exact(arena, idx, what):
        nonlocal cases
        out = K.embedding_bag_cuda(arena, idx)
        ref = plain(arena, idx)
        torch.cuda.synchronize()
        check(bits_equal(torch, out, ref), f"K1 != plain bit for bit: {what}"
              f", max |err| {float((out - ref).abs().max()):.3g}")
        cases += 1

    for rows in (8, 100, 1000):
        for dim in (128, 256):
            for pool in (1, 4, 16):
                for dtype in (torch.float32, torch.bfloat16):
                    rng = np.random.default_rng(rows * dim + pool)
                    arena = torch.as_tensor(
                        rng.normal(size=(rows, dim)), dtype=torch.float32,
                        device="cuda").to(dtype)
                    idx = torch.as_tensor(
                        rng.integers(0, rows, (12, pool)), dtype=torch.int32,
                        device="cuda")
                    exact(arena, idx, f"sweep {rows} {dim} {pool} {dtype}")
    # padding (index 0) at arbitrary positions, over a row 0 of each kind;
    # the first bags are all padding, padded in front, and padded behind
    for pool in (1, 31, 32, 33, 199):
        for dim in (128, 384):
            for dtype in (torch.float32, torch.bfloat16):
                for kind in ("random", "+0", "-0", "mixed"):
                    rng = np.random.default_rng(7 * pool + dim)
                    arena = torch.as_tensor(
                        rng.normal(size=(500, dim)), dtype=torch.float32,
                        device="cuda").to(dtype)
                    _row0(torch, arena, kind)
                    idx = rng.integers(1, 500, (300, pool))
                    idx[rng.random(idx.shape) < 0.7] = 0
                    idx[0] = 0
                    idx[1, :pool // 2] = 0
                    idx[2, pool // 2:] = 0
                    exact(arena, torch.as_tensor(idx, dtype=torch.int32,
                                                 device="cuda"),
                          f"padding P={pool} D={dim} {dtype} row 0 {kind}")
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
    for dtype in (torch.float32, torch.bfloat16):
        arena = torch.randn((n_rows, 128), generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype)
        arena[0] = 0
        idx = torch.randint(n_rows - 2 ** 21, n_rows, (8192, 8),
                            generator=gen, device="cuda", dtype=torch.int32)
        idx[:, -1] = 0
        exact(arena, idx, f"{dtype} arena of {arena.numel()} elements")
        log(f"[kernel] {dtype} arena of {arena.numel()} elements "
            f"({arena.numel() * arena.element_size() / 2**30:.2f} GiB): ok")
        del arena, idx
    torch.cuda.empty_cache()
    log(f"[kernel] K1 == plain bit for bit on {cases} cases")
    return cases


def grad_f64(torch, arena_shape, idx, grad_out):
    """The arena's gradient by a float64 ``index_add_``: the reference
    both the kernel and the plain version are held to."""
    g = torch.zeros(tuple(arena_shape), dtype=torch.float64,
                    device=grad_out.device)
    src = grad_out.double()
    for j in range(idx.shape[1]):
        g.index_add_(0, idx[:, j], src)
    g[0] = 0.0
    return g


def grad_errs(torch, out, plain_out, ref64) -> tuple:
    """(kernel's, plain's) max |err| against float64; raises unless the
    kernel's is at most twice the plain version's plus 1e-6."""
    err = float(out.double().sub_(ref64).abs_().max())
    plain_err = float(plain_out.double().sub_(ref64).abs_().max())
    check(err <= 2 * plain_err + 1e-6, f"K1 backward max |err| {err:.3g} "
          f"against float64 over 2 x plain's {plain_err:.3g} + 1e-6")
    return err, plain_err


def phase_grad_checks(torch, np, K, grad_plain, replay) -> dict:
    """K1's backward against the plain version (and float64) on the card;
    returns the worst errors."""
    worst = {"max_abs_err_vs_plain": 0.0, "err_vs_f64": 0.0,
             "plain_err_vs_f64": 0.0, "cases": 0}
    # (rows, dim, bags, pool, hot share, padding share): a hot row makes a
    # run longer than the chunk, or past chunk^2 (chunks of sqrt(L) slots)
    for R, D, N, P, hot, pad in ((1000, 128, 512, 8, 0.0, 0.3),
                                 (1000, 384, 4096, 33, 0.5, 0.5),
                                 (300, 128, 20000, 40, 0.9, 0.2),
                                 (70000, 128, 2048, 199, 0.3, 0.9)):
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.default_rng(R + N + P)
            idx = rng.integers(1, R, (N, P))
            idx[rng.random(idx.shape) < hot] = 1 + rng.integers(0, 3)
            idx[rng.random(idx.shape) < pad] = 0
            idx[:3] = 0                            # all-padding bags
            idx = torch.as_tensor(idx, dtype=torch.int32, device="cuda")
            shape = (R, D)
            for integer in (True, False):
                g = (torch.as_tensor(rng.integers(-2, 3, (N, shape[1])))
                     if integer else torch.as_tensor(
                         rng.normal(size=(N, shape[1]))))
                g = g.to(device="cuda", dtype=torch.float32).to(dtype)
                out = K.embedding_bag_grad_cuda(shape, idx, g)
                again = K.embedding_bag_grad_cuda(shape, idx, g)
                ref = grad_plain(shape, idx, g)
                again_plain = replay(shape, idx, g)
                torch.cuda.synchronize()
                what = f"R={R} N={N} P={P} {dtype} integer={integer}"
                check(bits_equal(torch, out, again),
                      f"two backward launches differ: {what}")
                check(bits_equal(torch, out, again_plain),
                      f"backward != its plain replay: {what}")
                check(not bool(out[0].any()), f"row 0 not zero: {what}")
                if integer:
                    check(bits_equal(torch, out, ref),
                          f"backward != plain on integers: {what}")
                else:
                    err, plain_err = grad_errs(
                        torch, out, ref, grad_f64(torch, shape, idx, g))
                    worst["err_vs_f64"] = max(worst["err_vs_f64"], err)
                    worst["plain_err_vs_f64"] = max(
                        worst["plain_err_vs_f64"], plain_err)
                worst["max_abs_err_vs_plain"] = max(
                    worst["max_abs_err_vs_plain"],
                    float((out - ref).abs().max()))
                worst["cases"] += 1
    # a gradient past 2^31 elements: row * D overflows 32 bits there
    n_rows = 2 ** 24 + 2 ** 20
    gen = torch.Generator(device="cuda").manual_seed(3)
    idx = torch.randint(n_rows - 2 ** 21, n_rows, (8192, 8), generator=gen,
                        device="cuda", dtype=torch.int32)
    idx[:, -1] = 0
    g = torch.randint(-2, 3, (8192, 128), generator=gen, device="cuda").float()
    out = K.embedding_bag_grad_cuda((n_rows, 128), idx, g)
    check(bits_equal(torch, out, grad_plain((n_rows, 128), idx, g)),
          "backward != plain on a gradient past 2^31 elements")
    worst["cases"] += 1
    del out
    torch.cuda.empty_cache()
    log(f"[kernel] K1 backward on {worst['cases']} cases: bit-equal to its "
        "plain replay and across launches, to plain on integer gradients; "
        f"max |err| against float64 {worst['err_vs_f64']:.3g} (plain's "
        f"{worst['plain_err_vs_f64']:.3g}), against plain "
        f"{worst['max_abs_err_vs_plain']:.3g}")
    return worst


def phase_main_path(torch, np, K, counters, summary: dict):
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
    for c in counters:                         # counts of this path only
        c.launches = 0

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
    bwd_launches = K.embedding_bag_grad_cuda.launches
    tele.disable()
    summary["measured"] = measured
    check(launches > 0, "the main path launched K1 no time")
    check(bwd_launches > 0, "the main path launched K1's backward no time")
    slowest = [max(m["bwd_ms"]) for m in measured]
    summary["slowest_device_bwd_ms"] = slowest
    log(f"[main] slowest device's bwd ms per measured placement: "
        f"{min(slowest):.3f} to {max(slowest):.3f}")
    log(f"[main] K1 launches on the main path: {launches} forward, "
        f"{bwd_launches} backward")
    return launches, bwd_launches, shapes


def phase_yardstick(torch, np, K, plain, shapes, summary: dict) -> tuple:
    """K1's forward, plain and F.embedding_bag at the largest main-path
    device; returns the kernel's row and the inputs, for the backward."""
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
        check(bits_equal(torch, out, ref), "K1 != plain at the yardstick")
        err = float((out - ref).abs().max())
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
        del seen
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
        "bytes": int(nbytes), "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_share": row["bound_ms"] / ms, **row}
    log(f"[yardstick] {len(sub)} tables, arena {arena.shape[0]} x {dim} f32, "
        f"idx {n} x {p}, {distinct} distinct rows, {slots} non-padding "
        f"slots: K1 {ms:.3f} ms ({row['bound_ms'] / ms:.1%} of the bound), "
        f"plain {plain_ms:.3f} ms, F.embedding_bag {library_ms:.3f} ms, "
        f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}); bit-equal to "
        "plain")
    check(ms < library_ms, f"K1 {ms:.3f} ms is not faster than "
          f"F.embedding_bag {library_ms:.3f} ms")
    return row, (arena, idx, slots)


def phase_grad_yardstick(torch, K, grad_plain, inputs,
                         summary: dict) -> dict:
    """K1's backward, plain and F.embedding_bag's backward on the forward's
    yardstick inputs, beside the memory bound."""
    from repro_torch.profiling.microbench import median_time_ms
    arena, idx, slots = inputs
    shape = tuple(arena.shape)
    n, dim = idx.shape[0], shape[1]
    gen = torch.Generator(device="cuda").manual_seed(4)
    g = torch.randn((n, dim), generator=gen, device="cuda")
    ones = torch.randint(-1, 2, (n, dim), generator=gen,
                         device="cuda").float()
    with torch.no_grad():
        # integer-valued: every sum is exact, so the kernel equals plain
        out = K.embedding_bag_grad_cuda(shape, idx, ones)
        check(bits_equal(torch, out, grad_plain(shape, idx, ones)),
              "K1 backward != plain on integers at the yardstick")
        out = K.embedding_bag_grad_cuda(shape, idx, g)
        check(bits_equal(torch, out, K.embedding_bag_grad_cuda(shape, idx,
                                                               g)),
              "two K1 backward launches differ at the yardstick")
        ref = grad_plain(shape, idx, g)
        err_vs_plain = float((out - ref).abs().max())
        err, plain_err = grad_errs(torch, out, ref,
                                   grad_f64(torch, shape, idx, g))
        del out
        torch.cuda.empty_cache()
        ms = median_time_ms(K.embedding_bag_grad_cuda, (shape, idx, g),
                            warmup=2, repeats=10)
        # its parts: the dense zeros, the plan; the two passes are the rest
        zeros_ms = median_time_ms(
            lambda t: torch.zeros(shape, dtype=torch.float32,
                                  device=t.device), (g,), warmup=2,
            repeats=10)
        plan_ms = median_time_ms(lambda i: K.backward_plan(i, K.CHUNK),
                                 (idx,), warmup=2, repeats=10)
        plain_ms = median_time_ms(grad_plain, (shape, idx, g), warmup=1,
                                  repeats=3)
    weight = arena.requires_grad_()
    lib_out = torch.nn.functional.embedding_bag(idx, weight, mode="sum",
                                                padding_idx=0)

    def lib_grad(grad):
        return torch.autograd.grad(lib_out, weight, grad,
                                   retain_graph=True)[0]
    lib_err = float((lib_grad(g) - ref).abs().max())
    scale = float(ref.abs().max())
    check(lib_err <= 1e-3 * scale, f"F.embedding_bag's backward differs "
          f"from plain by {lib_err:.3g} (max |ref| {scale:.3g})")
    del ref
    torch.cuda.empty_cache()
    library_ms = median_time_ms(lib_grad, (g,), warmup=1, repeats=3)
    del lib_out, weight, arena
    nbytes = (shape[0] * dim * 4 + idx.numel() * 4
              + g.numel() * g.element_size())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = slots * dim / F32_FLOP_PER_S * 1e3
    row = {"name": "embedding_bag_grad", "route": "cuda",
           "source": "src/repro_torch/csrc/embedding_bag.cu",
           "replaces": "src/repro/kernels/embedding_bag/ref.py:15",
           "max_abs_err": err_vs_plain, "max_abs_err_vs_f64": err,
           "plain_max_abs_err_vs_f64": plain_err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms}
    summary["grad_yardstick"] = {
        "bytes": int(nbytes), "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_share": row["bound_ms"] / ms, "zeros_ms": zeros_ms,
        "plan_ms": plan_ms, "library_err_vs_plain": lib_err, **row}
    log(f"[yardstick] K1 backward, grad ({n}, {dim}) f32 into ({shape[0]}, "
        f"{dim}): {ms:.3f} ms (plan included; {row['bound_ms'] / ms:.1%} of "
        f"the bound), plain {plain_ms:.3f} ms, F.embedding_bag backward "
        f"{library_ms:.3f} ms, bound {row['bound_ms']:.3f} ms "
        f"({row['bound_by']})")
    log(f"[yardstick] K1 backward's parts: torch.zeros {zeros_ms:.3f} ms, "
        f"plan {plan_ms:.3f} ms, the two passes the rest "
        f"({ms - zeros_ms - plan_ms:.3f} ms)")
    log(f"[yardstick] K1 backward max |err| against float64 {err:.3g} "
        f"(plain's {plain_err:.3g}; limit 2 x plain's + 1e-6), against plain "
        f"{err_vs_plain:.3g}; bit-equal to plain on integers and across "
        "launches")
    del idx, g, ones
    torch.cuda.empty_cache()
    return row


def _qkv(torch, np, seed, B, S, T, Hq, Hkv, hd, dtype):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.as_tensor(rng.normal(size=shape) * 0.5,
                               dtype=torch.float32, device="cuda").to(dtype)
    return mk(B, S, Hq, hd), mk(B, T, Hkv, hd), mk(B, T, Hkv, hd)


def phase_k2_checks(torch, np, FA, plain) -> float:
    """K2 against the plain version on the card; returns the max error."""
    worst = worst_rel = 0.0
    cases = 0
    tols = ((torch.float32, 2e-4), (torch.bfloat16, 3e-2))
    rel_rms = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    for S in (65, 100, 128, 129, 384, 1000):
        for hd in FA.HEAD_DIMS:
            for dtype, tol in tols:
                for window in (None, 64):
                    for group in (1, 4):
                        q, k, v = _qkv(torch, np, S + hd, 2, S, S, 2 * group,
                                       2, hd, dtype)
                        out = FA.flash_attention_cuda(q, k, v, window=window)
                        ref = plain(q, k, v, window=window)
                        torch.cuda.synchronize()
                        worst = max(worst, allclose_err(out.float(),
                                                        ref.float(), tol))
                        worst_rel = max(worst_rel, attention_err(
                            out, ref, max_abs=math.inf,
                            rel_rms=rel_rms[dtype])["rel_rms_err"])
                        cases += 1
    # non-causal over key lengths that are no tile multiple: masked by T
    for T in (77, 1000):
        for hd in FA.HEAD_DIMS:
            for dtype, tol in tols:
                q, k, v = _qkv(torch, np, T + hd, 1, 300, T, 4, 2, hd, dtype)
                out = FA.flash_attention_cuda(q, k, v, causal=False)
                ref = plain(q, k, v, causal=False)
                torch.cuda.synchronize()
                worst = max(worst, allclose_err(out.float(), ref.float(),
                                                tol))
                worst_rel = max(worst_rel, attention_err(
                    out, ref, max_abs=math.inf,
                    rel_rms=rel_rms[dtype])["rel_rms_err"])
                cases += 1
    log(f"[k2] K2 == plain on {cases} cases, max |err| {worst:.3g}, "
        f"max rms err / rms ref {worst_rel:.3g}")
    return worst


def phase_k2_layer0(torch, FA, plain, res, summary: dict) -> float:
    """K2 on layer 0's real q/k/v of the served model (2 KV groups of 4
    query heads) at the main path's length and window, against the plain
    version: in bf16 as served, and in float32 on the same values."""
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import map_params
    cfg = res.cfg
    lp = map_params(lambda t: t[0], res.params["layers"])
    B, S = res.prompts.shape
    hd, G = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    with torch.no_grad():
        h = L.rms_norm(res.params["embed"][res.prompts.long()], lp["ln1"],
                       cfg.norm_eps)
        pos = torch.arange(S, device="cuda")[None, :]
        q = (h @ lp["wq"]).reshape(B, S, cfg.n_heads, hd)[:, :, :2 * G]
        k = (h @ lp["wk"]).reshape(B, S, cfg.n_kv_heads, hd)[:, :, :2]
        v = (h @ lp["wv"]).reshape(B, S, cfg.n_kv_heads, hd)[:, :, :2]
        q = L.apply_rope(q.contiguous(), pos, cfg.rope_theta)
        k = L.apply_rope(k.contiguous(), pos, cfg.rope_theta)
        v = v.contiguous()
        errs = {}
        for name, limits in (("bfloat16", (4e-3, 1e-2)),
                             ("float32", (2e-4, 1e-4))):
            dt = getattr(torch, name)
            args = (q.to(dt), k.to(dt), v.to(dt))
            out = FA.flash_attention_cuda(*args, window=cfg.sliding_window)
            ref = plain(*args, window=cfg.sliding_window)
            torch.cuda.synchronize()
            errs[name] = attention_err(out, ref, max_abs=limits[0],
                                       rel_rms=limits[1])
            log(f"[k2] layer 0 of {cfg.name}: q {tuple(q.shape)}, k "
                f"{tuple(k.shape)}, window {cfg.sliding_window}, {name}: "
                f"K2 == plain, {_err_line(errs[name])}")
            del out, ref
    summary["k2_layer0"] = errs
    torch.cuda.empty_cache()
    return errs["bfloat16"]["max_abs_err"]


def phase_serve(torch, counters, FA, summary: dict):
    """The LM path: danube at full width, served through the entry point."""
    from repro_torch.launch.serve import serve
    for c in counters:                         # counts of this path only
        c.launches = 0
    t0 = time.perf_counter()
    res = serve(ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                tokens=SERVE_TOKENS, size="full", device="cuda")
    wall = time.perf_counter() - t0
    launches = FA.flash_attention_cuda.launches
    others = {type(c).__name__: c.launches for c in counters
              if c is not FA.flash_attention_cuda}
    cfg = res.cfg
    check(launches == 2 * cfg.n_layers,
          f"K2 launched {launches} times in 2 prefills of {cfg.n_layers} "
          "layers")
    check(not any(others.values()), f"other kernels launched: {others}")
    check(bool(torch.isfinite(res.last_logits.float()).all()),
          "finite logits")
    check(res.tokens.shape == (SERVE_BATCH, SERVE_TOKENS), "token shape")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_padded)).all()),
          "token ids in range")
    check(res.pos == SERVE_PROMPT + SERVE_TOKENS - 1, "cache position")
    n_params = sum(t.numel() for t in _leaves(res.params))
    summary["serve"] = {
        "arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
        "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
        "tokens": SERVE_TOKENS, "prefill_ms": res.prefill_ms,
        "decode_ms_per_token": res.decode_ms_per_token,
        "decode_tokens_per_s": res.decode_tokens_per_s,
        "peak_memory_bytes": res.peak_memory_bytes, "wall_s": wall,
        "k2_launches": launches}
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, {n_params} params, "
        f"bf16; batch {SERVE_BATCH} x {SERVE_PROMPT} tokens")
    log(f"[serve] prefill {res.prefill_ms:.1f} ms; decode "
        f"{res.decode_ms_per_token:.2f} ms/token, "
        f"{res.decode_tokens_per_s:.1f} tokens/s; peak memory "
        f"{res.peak_memory_bytes / 2**30:.2f} GiB; wall {wall:.1f} s")
    log(f"[serve] request 0: {res.tokens[0, :12].tolist()} ...")
    log(f"[main] K2 launches on the LM path: {launches} "
        f"({launches // 2} per prefill)")
    return res, launches


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def phase_profile(torch, res, summary: dict) -> dict:
    """Where the LM path's time goes: torch.profiler over one prefill and
    over 4 decode steps of the served model (weights from phase 7).  The
    busy share is the kernels' summed device time over the window's wall
    time (one stream); the profiler slows the host, so the idle share it
    gives is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import steps as ST
    model = ST.build_model(res.cfg, device="cuda")
    prefill = ST.make_prefill_step(model, capacity=SERVE_PROMPT + 4)
    decode = ST.make_decode_step(model)
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(
            res.params, {"tokens": res.prompts})

    def run_decode():
        tok = state["logits"][:, -1].argmax(-1, keepdim=True)
        for _ in range(4):
            logits, state["cache"] = decode(res.params, state["cache"],
                                            {"tokens": tok})
            tok = logits[:, -1].argmax(-1, keepdim=True)

    out = {}
    for name, fn in (("prefill", run_prefill), ("decode x4", run_decode)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # kernel rows only: an op's row repeats its kernels' device time
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                     "idle_share": 1 - busy / wall_ms if busy else None,
                     "top": [{"name": k[:80], "ms": ms, "calls": n}
                             for k, ms, n in rows[:8]]}
        log(f"[profile] {name}: wall {wall_ms:.1f} ms under the profiler, "
            f"kernels {busy:.1f} ms"
            + (f" (idle share <= {1 - busy / wall_ms:.3f})" if busy
               else " (no device time recorded: not measured)"))
        for k, ms, n in rows[:8]:
            log(f"[profile]   {ms:9.3f} ms {n:5d}x {k[:80]}")
    summary["profile"] = out
    return out


def phase_cross_device(torch, np, summary: dict) -> float:
    """Full width, 2 layers, float32: the card (K2) against the CPU."""
    from repro_torch.configs import get_full
    from repro_torch.models.transformer import LM, map_params
    cfg = dataclasses.replace(get_full(ARCH), n_layers=2).resolve(1)
    gpu = LM(cfg, dtype=torch.float32, device="cuda")
    cpu = LM(cfg, dtype=torch.float32, device="cpu")
    params = gpu.init_params(0)
    cparams = map_params(torch.Tensor.cpu, params)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 1024)), dtype=torch.int32)
    logits, cache = gpu.prefill(params, prompt.cuda(), capacity=1024 + 4)
    clogits, ccache = cpu.prefill(cparams, prompt, capacity=1024 + 4)
    worst = allclose_err(logits.cpu(), clogits, 1e-3)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    ctok = clogits[:, -1].argmax(-1, keepdim=True)
    for _ in range(4):
        check(bool((tok.cpu() == ctok).all()), "greedy tokens cuda == cpu")
        logits, cache = gpu.decode_step(params, cache, tok)
        clogits, ccache = cpu.decode_step(cparams, ccache, ctok)
        worst = max(worst, allclose_err(logits.cpu(), clogits, 1e-3))
        tok = logits[:, -1].argmax(-1, keepdim=True)
        ctok = clogits[:, -1].argmax(-1, keepdim=True)
    check(bool((tok.cpu() == ctok).all()), "greedy tokens cuda == cpu")
    summary["cross_device_max_abs_err"] = worst
    log(f"[cross] {cfg.name} at 2 layers, float32, 1 x 1024 prompt + 4 "
        f"decode steps: cuda (K2) == cpu (plain), max |err| {worst:.3g}, "
        "same greedy tokens")
    return worst


def phase_k2_yardstick(torch, FA, plain, summary: dict) -> dict:
    """K2, plain and SDPA at the main-path layer shape, beside the bound."""
    from repro_torch.kernels.flash_attention.ref import attention_mask
    from repro_torch.profiling.microbench import median_time_ms
    cfg = summary["serve"]
    B, S, Hq, Hkv, hd, W = SERVE_BATCH, SERVE_PROMPT, 32, 8, 80, 4096
    gen = torch.Generator(device="cuda").manual_seed(2)

    def mk(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * 0.5).to(torch.bfloat16)
    q, k, v = mk(B, S, Hq, hd), mk(B, S, Hkv, hd), mk(B, S, Hkv, hd)
    scale = 1.0 / math.sqrt(hd)
    mask = attention_mask(S, S, causal=True, window=W, device="cuda")
    pairs = int(mask.sum())

    def k2(a, b, c):
        return FA.flash_attention_cuda(a, b, c, window=W, scale=scale)

    def pl(a, b, c):
        return plain(a, b, c, window=W, scale=scale)

    def sdpa(a, b, c):
        return torch.nn.functional.scaled_dot_product_attention(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
            attn_mask=mask, scale=scale, enable_gqa=True).transpose(1, 2)

    with torch.no_grad():
        out = k2(q, k, v)
        ref = pl(q, k, v)
        torch.cuda.synchronize()
        check_err = attention_err(out, ref, max_abs=4e-3, rel_rms=1e-2)
        err = check_err["max_abs_err"]
        lib_out = sdpa(q, k, v)
        torch.cuda.synchronize()
        allclose_err(lib_out.float(), ref.float(), 3e-2)
        lib_err = attention_err(lib_out, ref, max_abs=math.inf, rel_rms=5e-2)
        del out, ref, lib_out
        torch.cuda.empty_cache()
        ms = median_time_ms(k2, (q, k, v), warmup=2, repeats=10)
        plain_ms = median_time_ms(pl, (q, k, v), warmup=1, repeats=3)
        torch.cuda.empty_cache()
        library_ms = median_time_ms(sdpa, (q, k, v), warmup=2, repeats=10)
        # the float32 kernel on the same values, as the cross-device path
        # runs it
        f32 = tuple(t.float() for t in (q, k, v))
        f32_ms = median_time_ms(k2, f32, warmup=1, repeats=5)
        del f32
    flops = 4 * hd * pairs * B * Hq
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    ops_ms = flops / BF16_FLOP_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    f32_bound_ms = max(flops / F32_FLOP_PER_S,
                       2 * nbytes / HBM_BYTES_PER_S) * 1e3
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:80",
           "design": "wgmma (bf16 tensor cores, cp.async K/V ring)",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms,
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "library_ms": library_ms}
    tflops = flops / (ms * 1e-3) / 1e12
    summary["k2_yardstick"] = {
        "shape": [B, S, Hq, Hkv, hd], "window": W, "dtype": "bfloat16",
        "unmasked_pairs_per_head": pairs, "flops": flops, "bytes": nbytes,
        "ops_ms": ops_ms, "bytes_ms": bytes_ms, "check": check_err,
        "sdpa_check": lib_err, "tflops": tflops,
        "bound_share": bound_ms / ms, "per_prefill_ms": ms * cfg["layers"],
        "float32_cuda_cores": {
            "ms": f32_ms, "tflops": flops / (f32_ms * 1e-3) / 1e12,
            "bound_ms": f32_bound_ms, "bound_share": f32_bound_ms / f32_ms},
        **row}
    log(f"[k2-yardstick] q ({B}, {S}, {Hq}, {hd}), k/v ({B}, {S}, {Hkv}, "
        f"{hd}) bf16, causal, window {W}, {pairs} pairs per head: K2 "
        f"(wgmma) {ms:.3f} ms ({tflops:.1f} TFLOP/s, {bound_ms / ms:.1%} "
        f"of the bound), plain {plain_ms:.3f} ms, SDPA {library_ms:.3f} ms,"
        f" bound {bound_ms:.3f} ms ({row['bound_by']})")
    log(f"[k2-yardstick] K2 float32 (CUDA cores) on the same values: "
        f"{f32_ms:.3f} ms ({flops / (f32_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
        f"{f32_bound_ms / f32_ms:.1%} of its bound {f32_bound_ms:.3f} ms at "
        f"the float32 peak)")
    log(f"[k2-yardstick] K2 == plain: {_err_line(check_err)}")
    log(f"[k2-yardstick] SDPA == plain: {_err_line(lib_err)}")
    check(ms < library_ms, f"K2 {ms:.3f} ms is not faster than SDPA "
          f"{library_ms:.3f} ms")
    del q, k, v, mask
    torch.cuda.empty_cache()
    return row


def run(name: str, fn, *args, phases: dict):
    t0 = time.perf_counter()
    out = fn(*args)
    phases[name] = time.perf_counter() - t0
    log(f"[phase] {name}: {phases[name]:.1f} s")
    return out


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
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_grad_plain, embedding_bag_grad_replay,
        embedding_bag_plain)
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.flash_attention.ref import attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    counters = (K.embedding_bag_cuda, K.embedding_bag_grad_cuda,
                FA.flash_attention_cuda)
    phases: dict = {}
    summary: dict = {"torch": torch.__version__, "cuda": torch.version.cuda,
                     "phase_s": phases}
    summary["nvidia_smi"] = run("1 device", phase_device, phases=phases)
    summary["build_s"] = run(
        "2 build K1 and K2", phase_build,
        {"K1": (K.LIBRARY, None),
         "K2": (FA.LIBRARY, "flash_fwd_tc_kernel")}, phases=phases)
    summary["kernel_check_cases"] = run(
        "3 K1 checks", phase_kernel_checks, torch, np, K,
        embedding_bag_plain, phases=phases)
    summary["grad_check"] = run(
        "3b K1 backward checks", phase_grad_checks, torch, np, K,
        embedding_bag_grad_plain, embedding_bag_grad_replay, phases=phases)
    k1_launches, bwd_launches, shapes = run(
        "4 DreamShard main path", phase_main_path, torch, np, K, counters,
        summary, phases=phases)
    k1_row, inputs = run("5 K1 yardstick", phase_yardstick, torch, np, K,
                         embedding_bag_plain, shapes, summary, phases=phases)
    bwd_row = run("5b K1 backward yardstick", phase_grad_yardstick, torch, K,
                  embedding_bag_grad_plain, inputs, summary, phases=phases)
    del inputs
    torch.cuda.empty_cache()
    summary["k2_check_max_abs_err"] = run(
        "6 K2 checks", phase_k2_checks, torch, np, FA, attention_plain,
        phases=phases)
    res, k2_launches = run("7 LM serve path", phase_serve, torch, counters,
                           FA, summary, phases=phases)
    summary["k2_layer0_max_abs_err"] = run(
        "6b K2 on layer 0", phase_k2_layer0, torch, FA, attention_plain, res,
        summary, phases=phases)
    run("7b LM profile", phase_profile, torch, res, summary, phases=phases)
    del res
    torch.cuda.empty_cache()
    run("8 cuda vs cpu", phase_cross_device, torch, np, summary,
        phases=phases)
    k2_row = run("9 K2 yardstick", phase_k2_yardstick, torch, FA,
                 attention_plain, summary, phases=phases)
    rows = [{**k1_row, "launches": k1_launches},
            {**bwd_row, "launches": bwd_launches},
            {**k2_row, "launches": k2_launches}]
    summary["kernels"] = rows
    summary["seconds"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    log(f"[done] {summary['seconds']:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
