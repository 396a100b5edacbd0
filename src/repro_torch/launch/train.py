"""Training launcher: pick an architecture config (``--arch``) and run real
LM train steps (AdamW, chunked cross-entropy) on seeded weights.

The counterpart of ``repro/launch/train.py`` without its ``--dryrun``
(the sharded lowering waits for its slice).  It runs on ``cuda`` unless
told otherwise and raises without a card; batches are the reference's
numpy draws from ``default_rng(0)``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \\
      --smoke --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch h2o-danube-1.8b --smoke --steps 2 --device cpu

Every config in the registry trains here, hymba-1.5b and rwkv6-1.6b too
(their scans' backward is K3-bwd / K4-bwd on the card, e.g. ``--arch
rwkv6-1.6b --steps 3 --seq 4096``).  For a frontend arch (llava-next-34b,
musicgen-large) a step's ``--seq`` positions are ``n_frontend_tokens``
stub embeddings, drawn after the tokens and labels from the same
generator, then tokens (``--arch musicgen-large --smoke --steps 2
--device cpu``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.device import resolve_device
from repro_torch.launch import steps as ST
from repro_torch.models.transformer import tree_leaves


def main(argv: list[str] | None = None) -> list[float]:
    """Run the steps; returns the losses."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (C.get_smoke(args.arch) if args.smoke
           else C.get_full(args.arch)).resolve(1)
    model = ST.build_model(cfg, remat=False, q_chunk=min(args.seq, 512),
                           kv_chunk=min(args.seq, 512), device=dev)
    params = model.init_params(0)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={dev}")

    opt, train_step = ST.make_train_step(model, lr=args.lr)
    opt_state = opt.init(tree_leaves(params))

    rng = np.random.default_rng(0)
    nf = cfg.n_frontend_tokens if cfg.frontend else 0
    B, S = args.batch, args.seq
    if S <= nf:
        raise ValueError(f"--seq {S} leaves no tokens after {cfg.name}'s "
                         f"{nf} frontend embeddings")
    losses = []
    for i in range(args.steps):
        tokens = rng.integers(0, cfg.vocab, (B, S - nf))
        labels = rng.integers(0, cfg.vocab, (B, S))
        batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int32,
                                           device=dev),
                 "labels": torch.as_tensor(labels, dtype=torch.int32,
                                           device=dev),
                 "loss_mask": torch.ones((B, S), dtype=torch.float32,
                                         device=dev)}
        if nf:
            batch["embeds"] = torch.as_tensor(
                rng.normal(0, 0.02, (B, nf, cfg.d_model)),
                device=dev).to(model.dtype)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        print(f"step {i:3d} loss {loss:.4f} "
              f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
        if not np.isfinite(loss):
            raise FloatingPointError(f"step {i}: loss {loss}")
        losses.append(loss)
    return losses


if __name__ == "__main__":
    main()
