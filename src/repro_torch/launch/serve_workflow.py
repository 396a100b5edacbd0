"""Placement serving workflow: front a trained agent with
``PlacementService`` -- digest-keyed placement cache, micro-batch
admission and drift-triggered re-placement -- and replay a synthetic
drifting request stream through it.

The counterpart of ``examples/serve_workflow.py``, on ``cuda`` unless told
otherwise: the agent trains and decodes on the device, the service's
cache, admission and drift loop are host numpy around it.

  PYTHONPATH=src python -m repro_torch.launch.serve_workflow
  PYTHONPATH=src python -m repro_torch.launch.serve_workflow --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api import PlacementService, ServeConfig, SimOracle
from repro_torch.core.trainer import DreamShard, DreamShardConfig
from repro_torch.data.synthetic import make_dlrm_pool
from repro_torch.data.tasks import sample_tasks, split_pool
from repro_torch.data.traffic import TrafficConfig, make_trace
from repro_torch.device import resolve_device


def run(device=None, *, n_train_tasks: int = 20, n_iterations: int = 3,
        n_collect: int = 6, n_cost: int = 100, n_batch: int = 32,
        n_rl: int = 5, n_episode: int = 10, candidates: int = 8,
        n_jobs: int = 6, n_tables: int = 20,
        n_requests: int = 300, tail_jobs: int = 3) -> dict:
    """Train the example's small agent on ``device`` (``None``: ``cuda``),
    replay its drifting trace through ``PlacementService`` and print the
    example's lines.  Returns the service's ``stats()``.  The sizes
    default to the example's: the agent's training budget
    (``DreamShardConfig``'s fields of the same names, ``candidates`` its
    ``inference_candidates``) and the trace (``TrafficConfig``'s)."""
    dev = resolve_device(device)
    pool = make_dlrm_pool(seed=0)
    oracle = SimOracle(seed=0)
    train_ids, _ = split_pool(pool, seed=0)
    train_tasks = sample_tasks(pool, train_ids, n_train_tasks, 4, 8, seed=0)

    print(f"training a small DreamShard agent on {dev}...")
    agent = DreamShard(train_tasks, oracle, DreamShardConfig(
        n_iterations=n_iterations, n_collect=n_collect, n_cost=n_cost,
        n_batch=n_batch, n_rl=n_rl, n_episode=n_episode,
        inference_candidates=candidates), device=dev)
    agent.train()

    # a few recurring jobs, Zipf-skewed popularity, drifting histograms
    trace = make_trace(pool, TrafficConfig(
        n_jobs=n_jobs, n_tables=n_tables, n_devices=4,
        n_requests=n_requests, drift=0.8, tail_jobs=tail_jobs, seed=0))

    svc = PlacementService(agent, config=ServeConfig(
        max_wait_ms=2.0, max_batch=8,     # micro-batch admission window
        drift_threshold=0.05,             # max per-table TV distance
        ewma_alpha=0.3,                   # traffic-estimate smoothing
        migration_ms_per_gb=25.0,         # moves must pay for transfer
        replace_max_evals=64))

    print(f"replaying {len(trace)} requests...")
    served = []
    for r in trace:
        served += svc.submit(r.raw_features, r.n_devices, tag=r.job)
    served += svc.flush()                 # drain stragglers

    stats = svc.stats()
    hits = [s.latency_ms for s in served
            if s.source == "cache" and not s.replaced]
    decodes = [s.latency_ms for s in served if s.source == "decode"]
    print(f"\nserved {len(served)} requests; "
          f"hit rate {stats['hit_rate']:.1%} "
          f"({stats['coalesced']} coalesced into "
          f"{stats['decode_batches']} decode batches)")
    print(f"warm-hit latency p50 {np.percentile(hits, 50):.3f} ms, "
          f"p99 {np.percentile(hits, 99):.3f} ms; "
          f"decode p50 {np.percentile(decodes, 50):.1f} ms")
    print(f"drift re-placements: {stats['replace_events']} triggers, "
          f"{stats['migrations']} moved tables, "
          f"{stats['bytes_moved_gb']:.3f} GB migrated")

    # every cached entry keeps serving post-re-placement: same digest,
    # fresher placement
    one = max(svc.cache.entries(), key=lambda e: e.replaces)
    print(f"hottest entry: {one.requests} requests, "
          f"{one.replaces} re-placements, "
          f"assignment {one.placement.assignment.tolist()}")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
