"""Alpha-beta communication model: the counterpart of
``repro/profiling/collectives.py``.

Embedding redistribution cost is dominated by the forward/backward
all-to-all (paper App. A.4).  A measured trace of that collective at a
sweep of payload sizes is fitted to

    t(p) = alpha_ms + beta_ms_per_mb * p          (p = per-device MB sent)

so a measured oracle prices communication with two scalars.  With one
device there is no collective to time: ``calibrate_comm`` takes the
reference's single-device branch, a *seeded synthetic trace* from a
``HardwareSpec``'s analytic bandwidth, fitted the same way and labelled
``source="synthetic"``.  Timing the all-to-all over NCCL across several
cards waits for the sharded-execution slice of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
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


def measure_all_to_all(payload_mb, *, devices=None, warmup: int = 1,
                       repeats: int = 5, dim: int = 128) -> np.ndarray:
    """Time the all-to-all across ``devices`` at each per-device payload
    (MB sent per device).  Needs >= 2 devices; over NCCL it waits for
    ROADMAP queue item 3 (sharded execution over NCCL)."""
    n = 1 if devices is None else len(devices)
    if n < 2:
        raise ValueError(
            f"all-to-all needs >= 2 devices, have {n}; use synthetic_trace")
    raise NotImplementedError(
        "the all-to-all over NCCL waits for ROADMAP queue item 3 "
        "(sharded execution over NCCL)")


def _devices(device) -> list:
    """Every visible card for a CUDA device, else the one device named."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def calibrate_comm(*, spec: HardwareSpec = PAPER_GPU, payload_mb=None,
                   devices=None, warmup: int = 1, repeats: int = 5,
                   seed: int = 0, device=None) -> CommModel:
    """Measure (several devices) or synthesize (one device) an all-to-all
    trace and fit the alpha-beta model.  ``devices`` defaults to every
    card (``device`` cuda, the default) or to the CPU (``device="cpu"``)."""
    payload_mb = DEFAULT_PAYLOAD_MB if payload_mb is None else payload_mb
    devices = _devices(device) if devices is None else list(devices)
    if len(devices) >= 2:
        times = measure_all_to_all(payload_mb, devices=devices,
                                   warmup=warmup, repeats=repeats)
        source = "measured"
    else:
        times = synthetic_trace(payload_mb, spec=spec, seed=seed)
        source = "synthetic"
    alpha, beta = fit_alpha_beta(payload_mb, times)
    return CommModel(alpha_ms=alpha, beta_ms_per_mb=beta,
                     n_devices=len(devices), source=source,
                     payload_mb=tuple(float(p) for p in payload_mb),
                     times_ms=tuple(float(t) for t in times))
