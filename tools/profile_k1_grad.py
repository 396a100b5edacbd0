#!/usr/bin/env python3
"""Time K1's backward at the yardstick, stage by stage and kernel by kernel.

    python tools/profile_k1_grad.py [--calls 3]

The yardstick is ``chip_smoke.py``'s: the largest device of the baseline
placements of the first two DLRM-50 (4) test tasks (rows capped at 2^20,
batch 65536, each table's own pooling; an arena of 12464046 x 128 and
indices of 1114112 x 199), with a seeded normal ``grad_out``.  Prints
the card's ``nvidia-smi`` name and power limit, the live counts of the
plan, the backward's median ms and its stages' (``plan``, ``pass1``,
``write``) by CUDA events, ``torch.zeros`` of the gradient beside them,
and then the device time of each kernel over ``--calls`` calls, from
``torch.profiler``.  It needs a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.api import SimOracle, make_baseline_placers
    from repro_torch.core import features as FEAT
    from repro_torch.data.synthetic import make_dlrm_pool
    from repro_torch.data.tasks import make_benchmark_suite
    from repro_torch.kernels.embedding_bag import kernel as K
    from repro_torch.profiling.microbench import (device_tables,
                                                  make_fused_inputs,
                                                  median_time_ms)
    if not torch.cuda.is_available():
        sys.exit("profile_k1_grad: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _, test = make_benchmark_suite(make_dlrm_pool(seed=0), n_tables=50,
                                   n_devices=4, n_tasks=20)
    shapes = []
    for placer in make_baseline_placers(SimOracle(seed=0)).values():
        for task, p in zip(test[:2], placer.place_many(test[:2])):
            shapes += [task.raw_features[p.assignment == d]
                       for d in range(task.n_devices)
                       if (p.assignment == d).any()]
    sub = max(shapes, key=lambda s: float(
        device_tables(s, 2 ** 20, None)[1].max() * len(s)))
    rows, pools = device_tables(sub, 2 ** 20, None)
    arena, idx, _ = make_fused_inputs(sub[:, FEAT.DIM], rows, 65536, pools,
                                      seed=0, device="cuda")
    shape = tuple(arena.shape)
    del arena
    g = torch.randn((idx.shape[0], shape[1]), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(4))
    kern = K.embedding_bag_grad_cuda
    plan = kern.plan(shape, idx)
    grad = torch.empty(shape, dtype=torch.float32, device="cuda")
    partials = kern.pass1(grad, plan, g)
    print(f"gradient {shape}, indices {tuple(idx.shape)}; live slots, runs, "
          f"chunks, partials {plan.counts.tolist()}")
    ms = {"backward": median_time_ms(kern, (shape, idx, g), warmup=2,
                                     repeats=10),
          "plan": median_time_ms(lambda i: kern.plan(shape, i), (idx,),
                                 warmup=2, repeats=10),
          "pass1": median_time_ms(lambda x: kern.pass1(grad, plan, x), (g,),
                                  warmup=2, repeats=10),
          "write": median_time_ms(lambda x: kern.write(grad, plan, partials),
                                  (g,), warmup=2, repeats=10),
          "torch.zeros": median_time_ms(
              lambda x: torch.zeros(shape, device=x.device), (g,), warmup=2,
              repeats=10)}
    print("median ms (CUDA events): " + ", ".join(
        f"{k} {v:.4f}" for k, v in ms.items()))
    del plan, partials, grad
    torch.cuda.empty_cache()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(args.calls):
            kern(shape, idx, g)
        torch.cuda.synchronize()
    print(f"device time a call, by kernel (torch.profiler, {args.calls} "
          "calls):")
    for e in sorted(prof.key_averages(), key=lambda e: -e.device_time_total):
        if e.device_time_total > 0:
            print(f"  {e.key[:72]:72s} {e.count:4d} launches "
                  f"{e.device_time_total / args.calls / 1e3:9.4f} ms")


if __name__ == "__main__":
    main()
