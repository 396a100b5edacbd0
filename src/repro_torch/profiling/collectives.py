"""Alpha-beta communication model: the counterpart of
``repro/profiling/collectives.py``.

Embedding redistribution cost is dominated by the forward/backward
all-to-all (paper App. A.4).  A measured trace of that collective at a
sweep of payload sizes is fitted to

    t(p) = alpha_ms + beta_ms_per_mb * p          (p = per-device MB sent)

so a measured oracle prices communication with two scalars.
``measure_all_to_all`` times ``all_to_all_single`` over a
``torch.distributed`` process group (the default one unless one is
given): NCCL on the cards, gloo on the CPU (a gloo time is a host
number, not a device one).  With one rank there is no collective to
time: ``calibrate_comm`` takes the reference's single-device branch, a
*seeded synthetic trace* from a ``HardwareSpec``'s analytic bandwidth,
fitted the same way and labelled ``source="synthetic"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.profiling.microbench import median_time_ms
from repro_torch.sim.hardware import HardwareSpec, PAPER_GPU

# per-device payload sizes (MB) swept by default
DEFAULT_PAYLOAD_MB = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0)


@dataclasses.dataclass(frozen=True)
class CommModel:
    """Fitted alpha-beta latency/bandwidth model for one collective."""

    alpha_ms: float          # fixed launch/latency term
    beta_ms_per_mb: float    # inverse effective bandwidth
    n_devices: int           # mesh size the fit was taken on
    source: str = "synthetic"          # "measured" | "synthetic"
    payload_mb: tuple = ()             # the fitted trace, for provenance
    times_ms: tuple = ()

    def comm_ms(self, payload_mb) -> np.ndarray:
        """Predicted per-device all-to-all time; zero payload costs zero
        (a device with no tables never enters the collective)."""
        p = np.asarray(payload_mb, dtype=np.float64)
        return np.where(p > 0.0,
                        self.alpha_ms + self.beta_ms_per_mb * p, 0.0)

    @classmethod
    def from_spec(cls, spec: HardwareSpec = PAPER_GPU,
                  n_devices: int = 0) -> "CommModel":
        """Analytic model from a hardware spec (no measurement): alpha is
        the spec's launch overhead, beta the inverse a2a bandwidth
        (GB/s -> ms/MB is exactly ``1 / bw``)."""
        return cls(alpha_ms=spec.comm_overhead_ms,
                   beta_ms_per_mb=1.0 / spec.a2a_bw_gbs,
                   n_devices=n_devices, source="synthetic")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CommModel":
        d = dict(d)
        d["payload_mb"] = tuple(d.get("payload_mb", ()))
        d["times_ms"] = tuple(d.get("times_ms", ()))
        return cls(**d)


def fit_alpha_beta(payload_mb, times_ms) -> tuple[float, float]:
    """Least-squares fit of ``t = alpha + beta * p`` (both clamped >= 0:
    measurement noise can push the intercept slightly negative)."""
    p = np.asarray(payload_mb, dtype=np.float64)
    t = np.asarray(times_ms, dtype=np.float64)
    A = np.stack([np.ones_like(p), p], axis=1)
    (alpha, beta), *_ = np.linalg.lstsq(A, t, rcond=None)
    return float(max(alpha, 0.0)), float(max(beta, 0.0))


def synthetic_trace(payload_mb, *, spec: HardwareSpec = PAPER_GPU,
                    noise_std: float = 0.03, seed: int = 0) -> np.ndarray:
    """Seeded stand-in trace for hosts with no multi-device mesh: the
    spec's analytic alpha-beta times under log-normal jitter."""
    rng = np.random.default_rng(seed)
    p = np.asarray(payload_mb, dtype=np.float64)
    base = spec.comm_overhead_ms + p / spec.a2a_bw_gbs
    return base * np.exp(rng.normal(0.0, noise_std, size=base.shape))


def payload_rows(payload_mb: float, n: int, dim: int = 128) -> int:
    """Rows of width ``dim`` (float32) that each of ``n`` ranks holds so
    that it sends ``payload_mb`` MB: it keeps 1/n of them (the
    reference's sizing)."""
    send_bytes = payload_mb * 1e6
    rows = max(n, int(send_bytes * n / max(n - 1, 1) / (4 * dim)))
    rows -= rows % n                      # all_to_all splits rows n-ways
    return max(rows, n)


def measure_all_to_all(payload_mb, *, group=None, warmup: int = 1,
                       repeats: int = 5, dim: int = 128) -> np.ndarray:
    """Median ms of ``all_to_all_single`` over ``group`` (every rank calls
    it) at each per-rank payload (MB sent per rank).  Needs >= 2 ranks.
    The tensors live on this rank's card over NCCL, on the CPU otherwise."""
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if n < 2:
        raise ValueError(
            f"all-to-all needs >= 2 ranks, have {n}; use synthetic_trace")
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")

    def exchange(x, out):
        dist.all_to_all_single(out, x, group=group)

    times = []
    for mb in payload_mb:
        x = torch.zeros((payload_rows(mb, n, dim), dim), device=device)
        times.append(median_time_ms(exchange, (x, torch.empty_like(x)),
                                    warmup=warmup, repeats=repeats))
    return np.asarray(times)


def calibrate_comm(*, spec: HardwareSpec = PAPER_GPU, payload_mb=None,
                   group=None, warmup: int = 1, repeats: int = 5,
                   seed: int = 0, device=None) -> CommModel:
    """Measure (a process group of >= 2 ranks, the default group unless
    ``group`` is given) or synthesize (one rank) an all-to-all trace and
    fit the alpha-beta model.  ``device`` (``cuda`` unless told otherwise)
    must exist: a run meant for the card does not go on without one.  On
    the card the trace is measured over NCCL or not at all: a group of
    another backend raises, and so do several cards with no process group
    (a one-rank group takes the synthetic trace)."""
    dev = resolve_device(device)
    payload_mb = DEFAULT_PAYLOAD_MB if payload_mb is None else payload_mb
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if dev.type == "cuda":
        if n >= 2 and dist.get_backend(group) != "nccl":
            raise ValueError(
                f"calibrating for the card over a {dist.get_backend(group)} "
                "group: the cards' all-to-all is measured over NCCL "
                "(init_process_group('nccl', ...))")
        cards = torch.cuda.device_count()
        if not dist.is_initialized() and cards >= 2:
            raise RuntimeError(
                f"{cards} cards and no process group: start one rank a card "
                "with torch.distributed.init_process_group('nccl', ...) to "
                "measure the all-to-all, or a one-rank group to take the "
                "synthetic trace")
    if n >= 2:
        times = measure_all_to_all(payload_mb, group=group, warmup=warmup,
                                   repeats=repeats)
        source = "measured"
    else:
        times = synthetic_trace(payload_mb, spec=spec, seed=seed)
        source = "synthetic"
    alpha, beta = fit_alpha_beta(payload_mb, times)
    return CommModel(alpha_ms=alpha, beta_ms_per_mb=beta,
                     n_devices=n, source=source,
                     payload_mb=tuple(float(p) for p in payload_mb),
                     times_ms=tuple(float(t) for t in times))
