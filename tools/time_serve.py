#!/usr/bin/env python3
"""Serve one LM config at full width through ``launch.serve.serve`` (as
``chip_smoke.py``'s phases 7, 14 and 15 do: seeded bf16 weights, one
warm-up prefill, a timed prefill, greedy decode) and print its prefill ms
and decode ms a token.

    python tools/time_serve.py --arch hymba-1.5b [--src DIR] [--repeats 2]
        [--kernels-from OTHER/src]

``--src`` is the ``src`` directory to import ``repro_torch`` from
(default: this checkout's), so that two trees can be timed on one card
in turns, one process each -- e.g. a parent unpacked with ``git archive``
beside this one.  With ``--kernels-from``, K3 and K4 are also built from
that tree's ``csrc`` (their C interface is the same; a ``CudaLibrary``
with that ``source``) and the repeats alternate, in one process, between
the two builds (own, other, other, own, ...), each made the kernel
module's ``LIBRARY`` in turn: the rest of the model and the host are then
the same for both.  Prints one JSON line: the tree, the card's
``nvidia-smi`` name and power limit, and each repeat's kernels, prefill
and decode times.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8192)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--kernels-from", default=None,
                    help="a src directory whose K3 and K4 sources to "
                         "alternate with this tree's")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    from repro_torch.kernels.build import CudaLibrary
    from repro_torch.kernels.selective_scan import kernel as SS
    from repro_torch.kernels.wkv6 import kernel as WK
    from repro_torch.launch.serve import serve
    if not torch.cuda.is_available():
        sys.exit("time_serve: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    mods = (SS, WK)
    builds = {"own": {m: m.LIBRARY for m in mods}}
    if args.kernels_from:
        csrc = Path(args.kernels_from).resolve() / "repro_torch" / "csrc"
        builds["other"] = {m: CudaLibrary(
            f"{m.LIBRARY.name}_other",
            {k: v for k, v in m.LIBRARY.signatures.items()
             if "occupancy" not in k},         # only the launch is needed
            source=csrc / m.LIBRARY.source.name) for m in mods}
    for libs in builds.values():               # built before any timing
        for lib in libs.values():
            lib.load()
    runs = []
    for i in range(args.repeats):
        label = "own" if len(builds) == 1 or i % 4 in (0, 3) else "other"
        for m, lib in builds[label].items():
            m.LIBRARY = lib                    # the wrapper's library
        res = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                    tokens=args.tokens, size="full", device="cuda")
        runs.append({"kernels": label, "prefill_ms": res.prefill_ms,
                     "decode_ms_per_token": res.decode_ms_per_token})
        del res
        torch.cuda.empty_cache()
    print(json.dumps({"src": args.src, "kernels_from": args.kernels_from,
                      "arch": args.arch, "device": smi,
                      "batch": args.batch, "prompt_len": args.prompt_len,
                      "tokens": args.tokens, "runs": runs}))


if __name__ == "__main__":
    main()
