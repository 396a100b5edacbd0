"""Synthetic serving traffic: drifting placement-request traces.

Serving workloads (`repro_torch.serve`) are streams of *requests*, not task
suites: a handful of recurring jobs (one embedding-table subset each)
is requested over and over with skewed popularity, while each job's
per-table access histograms drift as traffic moves between tables.
``make_trace`` generates that shape deterministically from a table
pool:

* each job samples ``n_tables`` structural rows from the pool;
* its histograms interpolate from the sampled tables' own access
  distributions toward an *endpoint* drawn from different pool tables
  (real-looking start and end, not noise), advancing linearly with
  trace progress scaled by ``drift``;
* ``drift=0.0`` yields bitwise-identical features on every repeat of a
  job -- the zero-drift replay the serving tests pin against
  ``PlacementSession.place_many``.

Jobs are requested under a Zipf-like popularity (job ``k`` with weight
``1/(k+1)^zipf``), so traces exercise both hot cached jobs and a cold
tail, plus an optional burst of brand-new one-off jobs at the end
(``tail_jobs``) to exercise eviction.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import features as F
from repro_torch.data.tasks import split_pool


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Shape of one synthetic request trace."""

    n_jobs: int = 8          # distinct recurring jobs
    n_tables: int = 16       # tables per job
    n_devices: int = 4
    n_requests: int = 512    # total requests across all jobs
    drift: float = 0.0       # total histogram drift over the trace [0, 1]
    zipf: float = 1.0        # job-popularity skew (0 = uniform)
    tail_jobs: int = 0       # one-off cold jobs appended at the end
    seed: int = 0


@dataclasses.dataclass
class Request:
    """One serving request: a job's features at one moment in time."""

    job: int                   # stable job id (trace-local)
    raw_features: np.ndarray   # (n_tables, 21); dist columns drift
    n_devices: int
    progress: float            # trace position in [0, 1]


def _job_features(pool: np.ndarray, ids: np.ndarray,
                  rng: np.random.Generator):
    """Structural rows + (base, endpoint) histogram pair for one job."""
    base = np.array(pool[ids], dtype=np.float64)
    others = rng.choice(
        np.setdiff1d(np.arange(pool.shape[0]), ids),
        size=ids.shape[0], replace=False)
    endpoint = np.array(pool[others, F.DIST_START:], dtype=np.float64)
    return base, endpoint


def make_trace(pool: np.ndarray,
               config: TrafficConfig | None = None) -> list[Request]:
    """Deterministic drifting request trace over ``pool`` tables."""
    cfg = config if config is not None else TrafficConfig()
    rng = np.random.default_rng(cfg.seed)
    _, ids = split_pool(pool, seed=cfg.seed)     # serve from the test half

    jobs = []
    for _ in range(cfg.n_jobs):
        picked = rng.choice(ids, size=cfg.n_tables, replace=False)
        jobs.append(_job_features(pool, picked, rng))

    weights = 1.0 / (1.0 + np.arange(cfg.n_jobs)) ** cfg.zipf
    weights /= weights.sum()
    picks = rng.choice(cfg.n_jobs, size=cfg.n_requests, p=weights)

    trace = []
    denom = max(1, cfg.n_requests - 1)
    for i, j in enumerate(picks):
        base, endpoint = jobs[j]
        progress = i / denom
        w = min(1.0, cfg.drift * progress)
        raw = np.array(base)
        if w > 0.0:     # exact branch: drift=0 repeats are bitwise-equal
            raw[:, F.DIST_START:] = (
                (1.0 - w) * base[:, F.DIST_START:] + w * endpoint)
        trace.append(Request(job=int(j), raw_features=raw,
                             n_devices=cfg.n_devices, progress=progress))

    for k in range(cfg.tail_jobs):               # cold one-offs at the end
        picked = rng.choice(ids, size=cfg.n_tables, replace=False)
        base, _ = _job_features(pool, picked, rng)
        trace.append(Request(job=cfg.n_jobs + k, raw_features=base,
                             n_devices=cfg.n_devices, progress=1.0))
    return trace
