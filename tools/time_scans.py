#!/usr/bin/env python3
"""Time K3 (the selective scan) and K4 (the WKV-6 scan) of several trees in
turns in one process, at the yardstick shapes of ``chip_smoke.py``'s phase
15 (e): K3 at (2, 8192, 3200, N 16) with bf16 x, K4 at (2, 8192, 32, 64)
with bf16 r, k, v, and each at the decode shape (S 1); then their
backward kernels (K3-bwd, K4-bwd) at phase 16 (e)'s train shapes, (2,
4096, 3200, N 16) and (2, 4096, 32, 64), bf16.

    python tools/time_scans.py --src build/parent/src --src src
        [--rounds 5] [--repeats 10] [--calls 100] [--only fwd|bwd]

Each ``--src`` is a ``src`` directory to import ``repro_torch`` from (e.g.
a parent unpacked with ``git archive`` beside this checkout's); each tree
builds its own kernels under its own ``build/kernels``.  The inputs are
seeded (``torch.Generator``, seed 0) and the same for every tree.  A round
times the trees in order and then in reverse:

- ``ms``: at both shapes, the median of ``--repeats`` calls after 2
  warm-ups, each between two CUDA events.  At S 1 a call's device work is
  shorter than its host work, so this reads the host's time of a call.
- ``host_us`` (S 1): ``--calls`` calls back to back by the host clock,
  then a synchronize; the host's microseconds a call.
- ``op_host_us`` (S 1): as ``host_us``, of the op that the models call
  (``ops.selective_scan``, ``ops.wkv6``: the wrapper behind its own
  checks).
- ``device_us`` (S 1): the same calls queued behind ``torch.cuda._sleep``
  between two events, so that the card runs them back to back; the
  device's microseconds a call.  The sleep is lengthened until the card
  is still asleep when the host has queued the last call.

Each tree's outputs are compared bit for bit with the plain versions (K3's
float32 y and hT on float32 x, K4's sT) at the yardstick and at ragged
shapes.

The backwards (cases ``k3_bwd`` and ``k4_bwd``): each call's median ms as
above (the main kernel and its finish kernel together, as a caller sees
them), each kernel's own device ms a launch by ``torch.profiler`` over
``--repeats`` calls (``split``), and per tree (``checks``) the float64
rule on every gradient at the train shape (``f64_share``: the kernel's
largest error against a float64 run of the plain backward over twice
plain float32's plus 1e-6; at most 1 passes) and whether two calls give
the same bits.  The inputs are the forward's seeded ones at the train
shape, the states saved by each tree's own forward, and a seeded dy.

Prints one JSON line: the card's ``nvidia-smi`` name and power limit,
each tree's readings of every round, their medians, and the checks.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

YARDSTICK = {"k3": (2, 8192, 3200, 16), "k4": (2, 8192, 32)}
TRAIN = {"k3": (2, 4096, 3200, 16), "k4": (2, 4096, 32)}
# ragged shapes for the bit checks: S past a chunk, Di and H odd
RAGGED = {"k3": [(3, 33, 77, 16), (1, 17, 99, 8), (2, 1, 3200, 16)],
          "k4": [(3, 33, 5), (1, 17, 1), (2, 1, 32)]}


def load_tree(src: str) -> dict:
    """The K3 and K4 wrappers (forward and backward), libraries, ops and
    plain versions of the ``repro_torch`` under ``src`` (other trees'
    modules are dropped from ``sys.modules`` first)."""
    for name in [n for n in sys.modules
                 if n == "repro_torch" or n.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(src))
    try:
        mods = {k: importlib.import_module(f"repro_torch.kernels.{m}.kernel")
                for k, m in (("k3", "selective_scan"), ("k4", "wkv6"))}
        plain = {
            "k3": importlib.import_module(
                "repro_torch.kernels.selective_scan.ref").selective_scan_plain,
            "k4": importlib.import_module(
                "repro_torch.kernels.wkv6.ref").wkv6_plain}
        ops = {
            "k3": importlib.import_module(
                "repro_torch.kernels.selective_scan.ops").selective_scan,
            "k4": importlib.import_module(
                "repro_torch.kernels.wkv6.ops").wkv6}
        plain_bwd = {
            "k3": importlib.import_module("repro_torch.kernels.selective_scan"
                                          ".ref").selective_scan_bwd_plain,
            "k4": importlib.import_module(
                "repro_torch.kernels.wkv6.ref").wkv6_bwd_plain}
    finally:
        sys.path.remove(os.path.abspath(src))
    return {"k3": mods["k3"].selective_scan_cuda, "k4": mods["k4"].wkv6_cuda,
            "bwd": {"k3": mods["k3"].selective_scan_grad_cuda,
                    "k4": mods["k4"].wkv6_grad_cuda},
            "lib": {"k3": mods["k3"].LIBRARY, "k4": mods["k4"].LIBRARY},
            "op": ops, "plain": plain, "plain_bwd": plain_bwd}


def inputs(torch, dev, kernel: str, shape, x_dtype):
    """Seeded inputs of K3 (B, S, Di, N) or K4 (B, S, H); x (K3) or r, k,
    v (K4) in ``x_dtype``."""
    g = torch.Generator().manual_seed(0)
    if kernel == "k3":
        B, S, Di, N = shape
        x = torch.randn((B, S, Di), generator=g) * 0.5
        dt = torch.nn.functional.softplus(torch.randn((B, S, Di), generator=g)
                                          - 1.0)
        Bc = torch.randn((B, S, N), generator=g) * 0.3
        Cc = torch.randn((B, S, N), generator=g) * 0.3
        A = -torch.arange(1, N + 1, dtype=torch.float32).expand(Di, N)
        h0 = torch.randn((B, Di, N), generator=g) * 0.1
        ts = [x.to(x_dtype), dt, Bc, Cc, A, h0]
    else:
        B, S, H = shape
        r, k, v = ((torch.randn((B, S, H, 64), generator=g) * 0.5).to(x_dtype)
                   for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn((B, S, H, 64), generator=g)
                                 - 4.0))
        u = torch.randn((H, 64), generator=g) * 0.5
        s0 = torch.randn((B, H, 64, 64), generator=g) * 0.1
        ts = [r, k, v, w, u, s0]
    return [t.contiguous().to(dev) for t in ts]


def bits(torch, a, b) -> bool:
    it = torch.int16 if a.element_size() == 2 else torch.int32
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(
        a.contiguous().view(it), b.contiguous().view(it)))


def host_us(torch, fn, args, calls: int) -> float:
    """Host microseconds a call over ``calls`` calls back to back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def device_us(torch, fn, args, calls: int) -> float:
    """Device microseconds a call: ``calls`` calls queued behind a sleep
    kernel, between two events that the card reaches only after the host
    has queued them all."""
    cycles = 1 << 24
    while True:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn(*args)
        end.record()
        asleep = not start.query()
        torch.cuda.synchronize()
        if asleep:
            return start.elapsed_time(end) * 1e3 / calls
        cycles *= 2


def median(v: list) -> float:
    return sorted(v)[len(v) // 2]


def f64_share(torch, got, plain, ref64) -> float:
    """The float64 rule's largest share over the gradients: the kernel's
    max |err| against float64 over twice plain float32's plus 1e-6."""
    share = 0.0
    for g, p, r in zip(got, plain, ref64):
        e_k = float((g.double() - r).abs().max())
        e_p = float((p.double() - r).abs().max())
        share = max(share, e_k / (2 * e_p + 1e-6))
    return share


def backward_cases(torch, dev, trees: dict, kernel: str, args, out: dict,
                   median_time_ms, kernel_ms):
    """Time each tree's backward of ``kernel`` at the train shape in turns
    (``ms``), split its device time by kernel (``split``), and check the
    float64 rule and two calls' bits (``checks``)."""
    shape = TRAIN[kernel]
    a = inputs(torch, dev, kernel, shape, torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    dy = torch.randn(a[0].shape, generator=g).to(dev)
    if kernel == "k3":
        dy = dy.to(torch.bfloat16)
    calls = {}
    for name, t in trees.items():
        with torch.no_grad():
            hs = t[kernel](*a, save_states=True)[2]
        calls[name] = (t["bwd"][kernel], (*a[:5], hs, dy))
    times = {name: [] for name in calls}
    for fn, cargs in calls.values():                     # warm-up
        median_time_ms(fn, cargs, warmup=2, repeats=args.repeats)
    for _ in range(args.rounds):
        for name in list(calls) + list(calls)[::-1]:
            fn, cargs = calls[name]
            times[name].append(median_time_ms(fn, cargs, warmup=1,
                                              repeats=args.repeats))
    case = f"{kernel}_bwd"
    out["ms"][case] = times
    out["median"].setdefault("ms", {})[case] = {
        n: median(v) for n, v in times.items()}
    out["split"][case] = {name: kernel_ms(fn, cargs, args.repeats)
                          for name, (fn, cargs) in calls.items()}
    # the float64 rule against the last tree's plain backward, as the
    # kernel's caller sees it: bf16 inputs widened, dy in its dtype
    plain_fn = trees[args.src[-1]]["plain_bwd"][kernel]
    wide = [t.float() for t in a]
    with torch.no_grad():
        plain = plain_fn(*wide, dy.float())
        ref64 = plain_fn(*(t.double() for t in a), dy.double())
        del wide
        for name, (fn, cargs) in calls.items():
            one, two = fn(*cargs), fn(*cargs)
            p = [q.to(o.dtype) for q, o in zip(plain, one)]
            out["checks"][f"{case} {name}"] = {
                "f64_share": f64_share(torch, one, p, ref64),
                "same_bits_twice": all(bits(torch, x, y)
                                       for x, y in zip(one, two))}
            del one, two, p
    del plain, ref64, calls
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a tree's src directory (repeat for more trees)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--calls", type=int, default=100,
                    help="calls a reading of host_us, op_host_us and "
                         "device_us (S 1)")
    ap.add_argument("--only", choices=("fwd", "bwd"),
                    help="time only the forwards or only the backwards")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_scans: no CUDA device is available")
    # the timing helpers of the last tree (a parent's may predate them)
    sys.path.insert(0, os.path.abspath(args.src[-1]))
    from repro_torch.profiling.microbench import kernel_ms, median_time_ms
    sys.path.pop(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    trees = {src: load_tree(src) for src in args.src}
    libs = [t["lib"][k] for t in trees.values() for k in ("k3", "k4")]
    with ThreadPoolExecutor(len(libs)) as pool:       # one nvcc each
        list(pool.map(lambda lib: lib.build(), libs))
    dev = torch.device("cuda")
    out = {"device": smi, "torch": torch.__version__, "trees": args.src,
           "rounds": args.rounds, "repeats": args.repeats,
           "calls": args.calls, "ms": {}, "host_us": {}, "op_host_us": {},
           "device_us": {}, "median": {}, "bits": {}, "split": {},
           "checks": {}}
    for kernel in ("k3", "k4") if args.only != "fwd" else ():
        backward_cases(torch, dev, trees, kernel, args, out, median_time_ms,
                       kernel_ms)
    with torch.no_grad():
        for kernel in ("k3", "k4") if args.only != "bwd" else ():
            fns = {src: t[kernel] for src, t in trees.items()}
            full = inputs(torch, dev, kernel, YARDSTICK[kernel],
                          torch.bfloat16)
            decode = [a[:, -1:].contiguous() for a in full[:4]] + full[4:]
            ops = {src: t["op"][kernel] for src, t in trees.items()}
            readings = {(f"{kernel}", "ms"): full,
                        (f"{kernel} decode", "ms"): decode,
                        (f"{kernel} decode", "host_us"): decode,
                        (f"{kernel} decode", "device_us"): decode,
                        (f"{kernel} decode", "op_host_us"): decode}
            for (case, what), a in readings.items():
                measure = {
                    "ms": lambda fn: median_time_ms(
                        fn, a, warmup=2, repeats=args.repeats),
                    "host_us": lambda fn: host_us(torch, fn, a, args.calls),
                    "op_host_us": lambda fn: host_us(torch, fn, a,
                                                     args.calls),
                    "device_us": lambda fn: device_us(torch, fn, a,
                                                      args.calls)}[what]
                cands = ops if what == "op_host_us" else fns
                times = {name: [] for name in cands}
                for fn in cands.values():                # warm-up
                    measure(fn)
                for _ in range(args.rounds):
                    for name in list(cands) + list(cands)[::-1]:
                        times[name].append(measure(cands[name]))
                out[what][case] = times
                out["median"].setdefault(what, {})[case] = {
                    n: median(v) for n, v in times.items()}
            # bits against plain: K3 on float32 x (y and hT), K4 on bf16
            # r, k, v (sT) at the yardstick and the ragged shapes
            plain = trees[args.src[-1]]["plain"][kernel]
            for shape in [YARDSTICK[kernel], *RAGGED[kernel]]:
                a = inputs(torch, dev, kernel, shape,
                           torch.float32 if kernel == "k3"
                           else torch.bfloat16)
                ref = plain(*a)
                for name, fn in fns.items():
                    got = fn(*a)
                    keys = ((0, "y"), (1, "hT")) if kernel == "k3" \
                        else ((1, "sT"),)
                    for i, key in keys:
                        out["bits"].setdefault(f"{kernel} {name}", {})[
                            f"{key} {shape}"] = bits(torch, got[i], ref[i])
            del full, decode
            torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
