"""Offline calibration CLI: the counterpart of
``repro/profiling/calibrate.py``.

  PYTHONPATH=src python -m repro_torch.profiling.calibrate [--smoke]
      [--out PATH] [--device cuda|cpu] [--trace PATH]

Sweeps the embedding-bag kernels (K1's forward and backward on the card,
the default; their plain versions with ``--device cpu``) over a ``(dim,
rows, batch, pooling)`` grid, fits (single device: synthesizes) the
all-to-all alpha-beta model, and persists a versioned ``CalibrationTable``
artifact in the reference's format, which ``MeasuredOracle`` interpolates
at zero kernel launches per ``evaluate``.

If the artifact already exists with the same format version, hardware
fingerprint and grid, the run is a no-op; ``--force`` re-measures.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _ints(csv: str) -> tuple[int, ...]:
    return tuple(int(x) for x in csv.split(",") if x.strip())


def _floats(csv: str) -> tuple[float, ...]:
    return tuple(float(x) for x in csv.split(",") if x.strip())


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.profiling.calibration import default_artifact_path
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.profiling.calibrate",
        description="Measure kernel/collective costs into a calibration "
                    "artifact for MeasuredOracle.")
    ap.add_argument("--out", default=default_artifact_path(),
                    help="artifact path (default: %(default)s, "
                         "override via $REPRO_CALIBRATION)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (K1's kernels; the default) or cpu (their "
                         "plain versions)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny grid + few repeats (CI / smoke testing)")
    ap.add_argument("--dims", type=_ints, default=None)
    ap.add_argument("--rows", type=_ints, default=None)
    ap.add_argument("--batches", type=_ints, default=None)
    ap.add_argument("--poolings", type=_ints, default=None)
    ap.add_argument("--fused-ks", type=_ints, default=None,
                    help="fusion depths for the fused multi-table sweep "
                         "(default 2,4,8; 2,4 in --smoke)")
    ap.add_argument("--fused-per-k", type=int, default=None,
                    help="heterogeneous draws per fusion depth "
                         "(default 4; 3 in --smoke)")
    ap.add_argument("--no-fused", action="store_true",
                    help="skip the fused sweep (additive fusion model, "
                         "like a v1 artifact)")
    ap.add_argument("--shard-fracs", type=_floats, default=None,
                    help="column fractions for the sharded-gather sweep "
                         "(default 0.25,0.5,0.75; 0.5 in --smoke)")
    ap.add_argument("--shard-per-frac", type=int, default=None,
                    help="heterogeneous draws per column fraction "
                         "(default 3; 2 in --smoke)")
    ap.add_argument("--no-sharded", action="store_true",
                    help="skip the sharded-gather sweep (proportional "
                         "partial-table model, like a v2 artifact)")
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=None,
                    help="timing repeats per shape (default 5; 2 in --smoke)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--force", action="store_true",
                    help="re-measure even if a matching artifact exists")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record telemetry during the sweep and export a "
                         "trace on exit (.jsonl -> event log, else Chrome "
                         "trace JSON)")
    ap.add_argument("--quiet", action="store_true")
    return ap


def _resolve_grid(args) -> dict:
    """The grid as measured: dims padded to the kernel's 128 lanes and
    deduplicated (``CalibrationTable.measure`` stores that axis)."""
    from repro_torch.kernels.embedding_bag.ops import pad_dim
    from repro_torch.profiling.calibration import DEFAULT_GRID, SMOKE_GRID
    base = SMOKE_GRID if args.smoke else DEFAULT_GRID
    grid = {k: tuple(getattr(args, k) or base[k])
            for k in ("dims", "rows", "batches", "poolings")}
    grid["dims"] = tuple(sorted({pad_dim(int(d)) for d in grid["dims"]}))
    return grid


def _up_to_date(path: str, grid: dict, fused_cfg: tuple | None,
                shard_cfg: tuple | None, device) -> bool:
    from repro_torch.profiling.calibration import (CALIBRATION_VERSION,
                                                   hardware_fingerprint,
                                                   load_or_none)
    table = load_or_none(path)
    if table is None or table.version != CALIBRATION_VERSION:
        return False
    if table.fingerprint != hardware_fingerprint(device):
        return False
    if fused_cfg is not None:
        # a fused run must find ITS fused sweep in the artifact; --no-fused
        # against a fused artifact stays a no-op (a superset)
        ks, per_k = fused_cfg
        if table.meta.get("fused_ks") != [int(k) for k in ks] \
                or table.meta.get("fused_per_k") != int(per_k):
            return False
    if shard_cfg is not None:
        fracs, per_frac = shard_cfg
        if table.meta.get("shard_fracs") != [float(f) for f in fracs] \
                or table.meta.get("shard_per_frac") != int(per_frac):
            return False
    return all(np.array_equal(getattr(table, k),
                              np.asarray(grid[k], np.float64))
               for k in ("dims", "rows", "batches", "poolings"))


def main(argv=None) -> int:
    from repro_torch import telemetry as tele
    args = build_parser().parse_args(argv)
    with tele.trace_to(args.trace, quiet=args.quiet):
        return _main_impl(args)


def _main_impl(args) -> int:
    import warnings
    from repro_torch import telemetry as tele
    from repro_torch.device import resolve_device
    from repro_torch.profiling.calibration import (CALIBRATION_VERSION,
                                                   CalibrationTable,
                                                   DEFAULT_FUSED_KS,
                                                   DEFAULT_FUSED_PER_K,
                                                   DEFAULT_SHARD_FRACS,
                                                   DEFAULT_SHARD_PER_FRAC,
                                                   load_or_none)
    device = resolve_device(args.device)
    grid = _resolve_grid(args)
    say = (lambda *a: None) if args.quiet else \
        (lambda *a: print(*a, flush=True))

    fused_ks = args.fused_ks or ((2, 4) if args.smoke else DEFAULT_FUSED_KS)
    fused_per_k = args.fused_per_k or (3 if args.smoke
                                       else DEFAULT_FUSED_PER_K)
    fused_cfg = None if args.no_fused else (fused_ks, fused_per_k)
    shard_fracs = args.shard_fracs or ((0.5,) if args.smoke
                                       else DEFAULT_SHARD_FRACS)
    shard_per_frac = args.shard_per_frac or (2 if args.smoke
                                             else DEFAULT_SHARD_PER_FRAC)
    shard_cfg = None if args.no_sharded else (shard_fracs, shard_per_frac)

    with warnings.catch_warnings():   # a stale v1/v2 artifact warns on load;
        warnings.simplefilter("ignore")  # we print our own message below
        up_to_date = _up_to_date(args.out, grid, fused_cfg, shard_cfg,
                                 device)
        stale = None if up_to_date else load_or_none(args.out)
    if not args.force and up_to_date:
        say(f"[calibrate] {args.out} is up to date "
            "(version/fingerprint/grid match); use --force to re-measure")
        return 0
    if stale is not None and stale.version < CALIBRATION_VERSION:
        missing = ("no fused multi-table sweep"
                   if stale.version < 2 else "no sharded-gather sweep")
        say(f"[calibrate] {args.out} is schema v{stale.version} "
            f"(< v{CALIBRATION_VERSION}: {missing}) -- re-measuring")

    repeats = args.repeats if args.repeats is not None \
        else (2 if args.smoke else 5)
    n_shapes = int(np.prod([len(v) for v in grid.values()]))
    say(f"[calibrate] sweeping {n_shapes} kernel shapes on {device} "
        f"(repeats={repeats}) ...")

    def _progress(pt):
        if hasattr(pt, "dims"):                       # FusedBenchPoint
            print(f"  fused k={pt.k} dims={list(pt.dims)} "
                  f"rows={list(pt.rows)} pools={list(pt.poolings)} "
                  f"fwd={pt.fwd_ms:.4f}ms bwd={pt.bwd_ms:.4f}ms", flush=True)
        elif hasattr(pt, "frac"):                     # ShardBenchPoint
            print(f"  shard dim={pt.dim:<4d} width={pt.width:<4d} "
                  f"rows={pt.rows:<7d} pool={pt.pooling:<3d} "
                  f"fwd={pt.fwd_ms:.4f}/{pt.full_fwd_ms:.4f}ms "
                  f"bwd={pt.bwd_ms:.4f}/{pt.full_bwd_ms:.4f}ms", flush=True)
        else:
            print(f"  dim={pt.dim:<4d} rows={pt.rows:<7d} "
                  f"batch={pt.batch:<6d} pool={pt.pooling:<3d} "
                  f"fwd={pt.fwd_ms:.4f}ms bwd={pt.bwd_ms:.4f}ms", flush=True)

    t0 = time.perf_counter()
    with tele.span("calibrate.sweep", shapes=n_shapes, repeats=repeats):
        table = CalibrationTable.measure(
            **grid, warmup=args.warmup, repeats=repeats, seed=args.seed,
            fused=not args.no_fused, fused_ks=fused_ks,
            fused_per_k=fused_per_k, sharded=not args.no_sharded,
            shard_fracs=shard_fracs, shard_per_frac=shard_per_frac,
            progress=None if args.quiet else _progress,
            meta={"cli": True, "smoke": bool(args.smoke)}, device=device)
    path = table.save(args.out)
    say(f"[calibrate] {table.summary()}")
    if not args.no_fused:
        say(f"[calibrate] fusion fwd {table.fusion_fwd.summary()}")
        say(f"[calibrate] fusion bwd {table.fusion_bwd.summary()}")
    if not args.no_sharded:
        say(f"[calibrate] shard fwd {table.shard_fwd.summary()}")
        say(f"[calibrate] shard bwd {table.shard_bwd.summary()}")
    say(f"[calibrate] wrote {path} in {time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
