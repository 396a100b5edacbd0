"""End-to-end driver: train a DLRM recommender for a few steps over the
table-parallel embedding path, comparing a DreamShard placement against a
random placement end to end.

The counterpart of ``examples/train_dlrm_end2end.py``, on ``cuda`` unless
told otherwise: synthetic click-through data (``DLRMBatchStream`` through
``Prefetcher``) -> ``Placer`` -> ``Placement`` (assignment + physical
plan) -> per-shard arenas looked up with K1 (``lookup_unsharded``) +
dense MLPs -> row-wise Adagrad on the arenas + Adam on the dense nets.
Hash sizes are clipped by ``--max-rows``.

  PYTHONPATH=src python -m repro_torch.launch.train_dlrm --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train_dlrm --steps 200
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import RandomPlacer, SimOracle
from repro_torch.core import features as F
from repro_torch.core.trainer import DreamShard, DreamShardConfig
from repro_torch.data.pipeline import DLRMBatchStream, Prefetcher
from repro_torch.data.synthetic import make_dlrm_pool
from repro_torch.data.tasks import Task, make_benchmark_suite
from repro_torch.device import resolve_device
from repro_torch.embedding import sharded as E
from repro_torch.embedding.plan import build_plan
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.optim import adam, apply_updates, rowwise_adagrad
from repro_torch.optim.optimizers import OptState


def unsharded_lookup(plan):
    """``lookup_fn`` for ``DLRM.forward``: every shard on this device."""
    return lambda arenas, bases, gidx: E.lookup_unsharded(arenas, bases,
                                                          gidx, plan)


def update_arenas(opt, arenas, grads: list, state: OptState) -> OptState:
    """One step of a row-local optimizer (row-wise Adagrad) on each shard's
    arena in turn, in place: no temporary larger than one shard's arena
    exists.  Each gradient in ``grads`` is dropped once it is used.  Equal
    bit for bit to one ``opt.update`` over the list."""
    accs = []
    for s, arena in enumerate(arenas):
        upd, sub = opt.update([grads[s]], OptState(state.step,
                                                   [state.inner[s]]))
        grads[s] = None
        apply_updates([arena], upd)
        del upd
        accs.append(sub.inner[0])
    return OptState(state.step + 1, accs)


def make_train_step(model: DLRM, lookup_fn, emb_opt, dense_opt, *,
                    batch_group=None):
    """``step(emb_state, dense_state, gidx, dense, labels) -> (emb_state,
    dense_state, loss)``: forward, BCE, gradients of the arenas and the
    dense nets, then ``emb_opt`` per shard and ``dense_opt``, applied in
    place.  The loss stays on the device.

    With ``batch_group`` (the one-rank form: ``model`` holds one shard,
    ``lookup_fn`` is ``make_sharded_lookup``'s, the batch split over the
    group's ``n`` ranks) each rank differentiates its own rows' mean loss
    over ``n``, so the arena gradients that the lookup's exchange brings
    back add up to the global mean's; the dense nets' gradients are
    summed over the group (the average of the ranks' own), and the loss
    returned is the global mean.  The row-wise state is the rank's own."""
    arenas = list(model.arenas)
    dense_params = model.dense_parameters()
    n = 1 if batch_group is None else dist.get_world_size(batch_group)

    def step(emb_state, dense_state, gidx, dense, labels):
        loss = DLRM.loss(model(dense, gidx, lookup_fn), labels)
        if n > 1:
            loss = loss / n
        grads = list(torch.autograd.grad(loss, arenas + dense_params))
        g_dense = grads[len(arenas):]
        if n > 1:
            for g in g_dense:
                dist.all_reduce(g, group=batch_group)
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=batch_group)
        del grads[len(arenas):]
        upd, dense_state = dense_opt.update(g_dense, dense_state,
                                            dense_params)
        apply_updates(dense_params, upd)
        del upd, g_dense
        emb_state = update_arenas(emb_opt, arenas, grads, emb_state)
        return emb_state, dense_state, loss.detach()

    return step


def smoke_tables(n_shards: int, max_rows: int):
    """The reference's DLRM test table set (``tests/test_embedding_dlrm.py``):
    the pool's first 8 tables, rows capped at ``max_rows``, table ``t`` on
    shard ``t % n_shards``.  Returns (raw features, plan)."""
    raw = make_dlrm_pool(seed=0)[:8].copy()
    raw[:, F.HASH_SIZE] = np.minimum(raw[:, F.HASH_SIZE], max_rows)
    return raw, build_plan(raw, np.arange(8) % n_shards, n_shards)


def make_trainer(model: DLRM, plan):
    """The driver's optimizers over ``model``, every shard on its device:
    row-wise Adagrad (0.05) on the arenas, Adam (1e-3) on the dense nets.
    Returns ``train(gidx, dense, labels) -> loss``, one step in place;
    ``train.state`` holds ``[emb_state, dense_state]``."""
    emb_opt, dense_opt = rowwise_adagrad(0.05), adam(1e-3)
    state = [emb_opt.init(list(model.arenas)),
             dense_opt.init(model.dense_parameters())]
    step = make_train_step(model, unsharded_lookup(plan), emb_opt, dense_opt)

    def train(gidx, dense, labels):
        state[0], state[1], loss = step(state[0], state[1], gidx, dense,
                                        labels)
        return loss

    train.state = state
    return train


def to_device(batch: dict, plan, device) -> tuple:
    """A ``DLRMBatchStream`` batch on ``device``: (grouped indices, dense,
    labels); the indices are grouped there."""
    idx = torch.from_numpy(batch["indices"]).to(device)
    return (E.group_indices(plan, idx),
            torch.from_numpy(batch["dense"]).to(device),
            torch.from_numpy(batch["labels"]).to(device))


def train_with_placement(name, task, placement, args, oracle):
    """Train ``args.steps`` steps of batch ``args.batch`` on
    ``args.device`` over ``placement``; returns (the oracle's cost of the
    placement, the losses)."""
    dev = resolve_device(args.device)
    plan = placement.plan                     # physical layout, ready-made
    raw = task.raw_features
    cost = oracle.evaluate(raw, placement.assignment,
                           placement.n_devices).overall
    cfg = DLRMConfig(n_dense_features=13, embed_dim=plan.dim,
                     bottom_mlp=(128, 64), top_mlp=(256, 128, 64),
                     n_tables=raw.shape[0])
    model = DLRM(cfg, plan, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    train = make_trainer(model, plan)

    prefetch = Prefetcher(DLRMBatchStream(raw, args.batch, seed=0))
    losses, t0 = [], time.perf_counter()
    try:
        for i in range(args.steps):
            losses.append(float(train(*to_device(prefetch.next(), plan,
                                                 dev))))
            if i % max(args.steps // 5, 1) == 0:
                print(f"  [{name}] step {i:4d} loss "
                      f"{np.mean(losses[-20:]):.4f}")
    finally:
        prefetch.close()
    wall = time.perf_counter() - t0
    print(f"  [{name}] {n_params / 1e6:.1f}M params, "
          f"placement cost {cost:.2f} ms/iter (simulated), "
          f"final loss {np.mean(losses[-20:]):.4f}, wall {wall:.1f}s")
    if not np.isfinite(losses).all():
        raise RuntimeError(f"[{name}] non-finite loss: {losses}")
    return cost, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--tables", type=int, default=24)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--max-rows", type=int, default=20000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    pool = make_dlrm_pool(seed=0)
    oracle = SimOracle(seed=0)
    raw = pool[: args.tables].copy()
    raw[:, F.HASH_SIZE] = np.clip(raw[:, F.HASH_SIZE], 100, args.max_rows)
    raw[:, F.TABLE_SIZE_GB] = F.table_size_gb(raw[:, F.DIM],
                                              raw[:, F.HASH_SIZE])
    task = Task.of(raw, args.shards, name="dlrm-end2end")

    print("training DreamShard placer (small budget)...")
    train_tasks, _ = make_benchmark_suite(pool, args.tables, args.shards,
                                          n_tasks=8)
    agent = DreamShard(train_tasks, oracle,
                       DreamShardConfig(n_iterations=5, n_cost=150, n_rl=10),
                       device=dev)
    agent.train()
    ds_placement = agent.as_placer().place(task)
    rnd_placement = RandomPlacer(oracle, seed=0).place(task)

    print("\n== DLRM end-to-end with DreamShard placement ==")
    c1, _ = train_with_placement("dreamshard", task, ds_placement, args,
                                 oracle)
    print("== DLRM end-to-end with random placement ==")
    c2, _ = train_with_placement("random", task, rnd_placement, args, oracle)
    print(f"\nembedding step cost: dreamshard {c1:.2f} ms vs random "
          f"{c2:.2f} ms  ({(c2 / c1 - 1) * 100:+.1f}%)")


if __name__ == "__main__":
    main()
