#!/usr/bin/env python3
"""Train the port's DreamShard for several seeds against a calibration
artifact and compare its placements with an untrained agent's, random's,
the RNN baseline's and ``expert_best``'s, by that artifact's
``MeasuredOracle``.

    PYTHONPATH=src python tools/train_margin.py ARTIFACT [--seeds 0,1,2]
        [--device cpu]

``ARTIFACT`` is a calibration ``.npz`` -- e.g. the one ``chip_smoke.py
--artifact`` writes from the card -- priced at batch 65536.  Each seed
runs ``chip_smoke.train_and_place``, phase 8's own training and placing:
DLRM-50 (4), 16 training tasks, the paper's budget, the 20 test tasks,
16 decode candidates.  It prints the three mean costs and the trained
agent's margins; then it trains the RNN baseline of the same seed with
phase 8b's ``chip_smoke.train_rnn`` (Table 1's matched budget: 50
updates of 10 measured episodes) and prints its mean cost and
``expert_best``'s on the test tasks, with the trained agent's margin over
each.  The agents train on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]   # before the imports below

from chip_smoke import (BATCH, TRAIN_TASKS, train_and_place,  # noqa: E402
                        train_rnn)
from repro_torch.api import (  # noqa: E402
    MeasuredOracle, make_baseline_placers, measure_placements)
from repro_torch.data.synthetic import make_dlrm_pool  # noqa: E402
from repro_torch.data.tasks import make_benchmark_suite  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifact")
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--device", default=None,
                    help="torch device of the agents (default: cuda)")
    args = ap.parse_args()
    oracle = MeasuredOracle(args.artifact, batch_size=BATCH)
    pool = make_dlrm_pool(seed=0)
    train, _ = make_benchmark_suite(pool, 50, 4, n_tasks=TRAIN_TASKS)
    _, test = make_benchmark_suite(pool, 50, 4, n_tasks=20)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = train_and_place(oracle, oracle, train, test, seed, args.device)
        mean, margin = out["mean"], out["margin"]
        print(f"seed {seed}: trained {mean['trained']:.4f} ms, untrained "
              f"{mean['untrained']:.4f} ms, random {mean['random']:.4f} ms; "
              f"trained beats untrained by {margin['untrained']:.2%}, random "
              f"by {margin['random']:.2%} (training {out['train_s']:.0f} s)",
              flush=True)
        rnn = train_rnn(oracle, train, seed, args.device)
        expert = make_baseline_placers(oracle, include_portfolio=True)
        base = {"rnn": rnn["rnn"].as_placer().place_many(test),
                "expert_best": expert["expert_best"].place_many(test)}
        base = {k: float(np.mean(measure_placements(oracle, test, v)))
                for k, v in base.items()}
        beats = {k: v / mean["trained"] - 1 for k, v in base.items()}
        print(f"seed {seed}: rnn {base['rnn']:.4f} ms, expert_best "
              f"{base['expert_best']:.4f} ms; trained beats rnn by "
              f"{beats['rnn']:.2%}, expert_best by {beats['expert_best']:.2%} "
              f"(rnn training {rnn['train_s']:.0f} s, {rnn['rows']} oracle "
              "rows)", flush=True)


if __name__ == "__main__":
    main()
