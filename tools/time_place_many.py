#!/usr/bin/env python3
"""Time warm placement decode: an untrained DreamShard agent (seed 0, 16
candidates) places the 20 DLRM-50 (4) test tasks with ``place_many``, as
``chip_smoke.py``'s phase 4 does, many times over; with ``--tasks 1``
only test task 0, as a serving miss decodes one task; with ``--place``,
test task 0 by ``DreamShard.place``, the per-task entry point.  With
``--profile``, one more warm call runs under torch.profiler: its device
kernels are counted and summed, the 8 largest by name.

    python tools/time_place_many.py [--src DIR] [--repeats 20]
        [--tasks N] [--place] [--profile] [--device cpu]

``--src`` is the ``src`` directory to import ``repro_torch`` from (default:
this checkout's), so that two trees can be timed in one process order
-- e.g. a parent unpacked with ``git archive`` beside this one.  Prints
one JSON line: the tree, the card's ``nvidia-smi`` name and power limit,
the cold call and each warm call in ms, and the warm median and minimum.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--tasks", type=int, default=20,
                    help="place the first N test tasks a call")
    ap.add_argument("--place", action="store_true",
                    help="time DreamShard.place of test task 0 instead")
    ap.add_argument("--profile", action="store_true",
                    help="also count one warm call's device kernels")
    ap.add_argument("--device", default=None,
                    help="torch device of the agent (default: cuda)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    from repro_torch.api import SimOracle
    from repro_torch.core.trainer import DreamShard, DreamShardConfig
    from repro_torch.data.synthetic import make_dlrm_pool
    from repro_torch.data.tasks import make_benchmark_suite

    pool = make_dlrm_pool(seed=0)
    train, test = make_benchmark_suite(pool, n_tables=50, n_devices=4,
                                       n_tasks=20)
    agent = DreamShard(train, SimOracle(seed=0), DreamShardConfig(seed=0),
                       device=args.device)
    placer = agent.as_placer(n_candidates=16)
    task = test[0]

    def call():
        if args.place:
            agent.place(task.raw_features, task.n_devices, 16)
        else:
            placer.place_many(test[:args.tasks])
    cuda = agent.device.type == "cuda"
    times = []
    for _ in range(args.repeats + 1):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    profile = None
    if args.profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as prof
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            call()
            if cuda:
                torch.cuda.synchronize()
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in p.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda r: -r[1])
        profile = {"kernels": sum(r[2] for r in rows),
                   "device_ms": sum(r[1] for r in rows),
                   "top": [[k[:60], ms, n] for k, ms, n in rows[:8]]}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip() if cuda else None
    print(json.dumps({"src": os.path.relpath(os.path.abspath(args.src), ROOT),
                      "card": card, "call": "place" if args.place
                      else "place_many", "tasks": 1 if args.place
                      else args.tasks, "cold_ms": times[0],
                      "warm_ms": times[1:],
                      "warm_median_ms": float(np.median(times[1:])),
                      "warm_min_ms": float(np.min(times[1:])),
                      "profile": profile}))


if __name__ == "__main__":
    main()
