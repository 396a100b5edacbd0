"""Batched DreamShard serving: decode many tasks per call.

``PlacementSession`` buckets tasks by padded ``(M_pad, D)`` shape, pads
each task's (sorted) features to the bucket's table count with masked
rows, pads the batch to a power of two with fully masked rows, and
decodes the whole bucket in ONE batched ``decode_candidates`` call on the
agent's device.

The padded decode is exact, not approximate: masked rows contribute
nothing to the policy/cost device sums or memory, and the Gumbel noise of
the sampled candidates is drawn per step and shared by the bucket, so the
session returns the *same* assignments as per-task ``DreamShard.place``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import telemetry as tele
from repro_torch.api.placement import Placement
from repro_torch.core import features as FEAT
from repro_torch.core import rollout as R
from repro_torch.data.tasks import Task
from repro_torch.embedding.plan import build_plan


def pad_feature_batch(entries, m_pad: int, b_pad: int | None = None):
    """Pad per-task ``(feats (m, F), sizes (m,))`` pairs into one dense
    batch: ``(feats (B, m_pad, F), sizes (B, m_pad), tmask (B, m_pad))``.

    Rows beyond each task's table count (and whole batch rows beyond
    ``len(entries)`` when ``b_pad`` over-allocates to a power of two) are
    zero with ``tmask == 0``.
    """
    B = len(entries) if b_pad is None else b_pad
    feats = np.zeros((B, m_pad, FEAT.NUM_FEATURES), np.float32)
    sizes = np.zeros((B, m_pad), np.float32)
    tmask = np.zeros((B, m_pad), np.float32)
    for j, (f, s) in enumerate(entries):
        m = f.shape[0]
        feats[j, :m] = f
        sizes[j, :m] = s
        tmask[j, :m] = 1.0
    return feats, sizes, tmask


def pad_device_mask(device_counts, d_pad: int) -> np.ndarray:
    """(B, d_pad) mask with row b's first ``device_counts[b]`` entries 1."""
    dmask = np.zeros((len(device_counts), d_pad), np.float32)
    for j, d in enumerate(device_counts):
        dmask[j, :d] = 1.0
    return dmask


class PlacementSession:
    """Long-lived serving handle for one DreamShard agent.

    Parameters
    ----------
    agent: a ``DreamShard`` (trained or not; uses its current networks
        on its device).
    n_candidates: candidate placements ranked per task (default: the
        agent's ``inference_candidates``).
    bucket_tables: bucket granularity -- table counts are padded up to the
        next multiple.
    """

    def __init__(self, agent, n_candidates: int | None = None,
                 bucket_tables: int = 8):
        self.agent = agent
        self._n_candidates_override = n_candidates
        self.bucket_tables = max(1, bucket_tables)
        # distinct (bucket, batch) shapes served; the reference compiles
        # one trace per shape, and the counter keeps its name
        self.num_compiles = 0
        self.num_decode_calls = 0
        self._shapes: set[tuple] = set()

    @property
    def n_candidates(self) -> int:
        """Candidates ranked per task -- read live from the agent's config
        (unless overridden) so a config change, e.g. via ``restore``, never
        lets the session drift from per-task ``place``."""
        if self._n_candidates_override is not None:
            return self._n_candidates_override
        return self.agent.cfg.inference_candidates

    def _pad_tables(self, m: int) -> int:
        b = self.bucket_tables
        return int(np.ceil(m / b) * b)

    def bucket_key(self, task: Task) -> tuple[int, int]:
        return (self._pad_tables(task.n_tables), task.n_devices)

    def place_many(self, tasks: list[Task]) -> list[Placement]:
        """Place a suite, decoding each ``(M_pad, D)`` bucket in one call."""
        tasks = list(tasks)
        agent = self.agent
        cfg = agent.cfg
        buckets: dict[tuple, list[int]] = {}
        for i, t in enumerate(tasks):
            buckets.setdefault(self.bucket_key(t), []).append(i)

        out: list[Placement | None] = [None] * len(tasks)
        for (m_pad, n_devices), idxs in buckets.items():
            B = len(idxs)
            b_pad = 1 << max(0, B - 1).bit_length()
            entries, orders = [], []
            for i in idxs:
                f, s, order = agent._inference_inputs(tasks[i].raw_features)
                entries.append((f[order], s[order]))
                orders.append(order)
            feats, sizes, tmask = pad_feature_batch(entries, m_pad, b_pad)
            shape = (m_pad, n_devices, self.n_candidates, b_pad)
            fresh = shape not in self._shapes
            if fresh:
                self._shapes.add(shape)
                self.num_compiles += 1
                tele.count("session.bucket_compiles")
            dev = agent.device
            with tele.span("session.decode", m_pad=m_pad,
                           n_devices=n_devices, tasks=B, b_pad=b_pad,
                           fresh_compile=fresh):
                actions, est = R.decode_candidates(
                    agent.policy_net, agent.cost_net,
                    torch.as_tensor(feats, device=dev),
                    torch.as_tensor(sizes, device=dev),
                    agent.oracle.mem_capacity_gb, n_devices=n_devices,
                    n_candidates=self.n_candidates,
                    tmask=torch.as_tensor(tmask, device=dev),
                    use_cost=cfg.use_cost_features,
                    reward_mode=cfg.reward_mode,
                    log_targets=agent._log_targets)
                actions, est = actions.cpu().numpy(), est.cpu().numpy()
            self.num_decode_calls += 1
            tele.count("session.decode_calls")
            for j, i in enumerate(idxs):
                t, order = tasks[i], orders[j]
                best = int(np.argmin(est[j]))
                assignment = np.empty(t.n_tables, dtype=np.int64)
                assignment[order] = actions[j, best, :t.n_tables]
                out[i] = Placement(
                    assignment=assignment,
                    plan=build_plan(t.raw_features, assignment, n_devices),
                    n_devices=n_devices, strategy="dreamshard",
                    est_cost_ms=float(est[j, best]),
                    candidates=self.n_candidates, oracle_evals=0)
        return out

    def place(self, task: Task) -> Placement:
        return self.place_many([task])[0]
