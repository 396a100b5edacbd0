"""DreamShard inference (paper Algorithm 2): the inference half of
``repro/core/trainer.py``.

``DreamShard`` holds the cost and policy networks on a device, places
tasks by decoding on the estimated MDP (greedy plus sampled candidates,
ranked by the cost network; no hardware in the loop), serves suites
through ``as_placer()``, and saves and restores agents in the JAX
package's checkpoint format.  Training (Algorithm 1: ``collect``,
``update_cost``, ``update_policy``, ``train``) waits for the training
slice of the port.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.api.oracle import CostOracle, ensure_oracle
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.core import features as F
from repro_torch.core import networks as N
from repro_torch.core import rollout as R
from repro_torch.data.tasks import Task
from repro_torch.device import resolve_device
from repro_torch.sim.costsim import CostSimulator


@dataclasses.dataclass
class DreamShardConfig:
    n_iterations: int = 10
    n_collect: int = 10
    n_cost: int = 300
    n_batch: int = 64
    n_rl: int = 10
    n_episode: int = 10
    entropy_weight: float = 1e-3
    lr: float = 5e-4
    cost_scale: float = 0.1      # targets in units of 10ms ('scale' mode)
    # target transform: 'log1p' fits relative error (tasks span 15-150 ms);
    # 'scale' is plain linear scaling
    target_transform: str = "log1p"
    seed: int = 0
    use_cost_features: bool = True   # ablation: 'w/o cost'
    feature_drop: str | None = None  # ablation: zero a feature group
    # episode-reward estimator: "composed" rebuilds the stage decomposition
    # from the per-device q heads; "head" is the paper's max-reduced
    # overall head
    reward_mode: str = "composed"
    # inference: greedy argmax (paper Algorithm 2) plus this many sampled
    # candidate placements, keeping the lowest ESTIMATED cost -- still
    # hardware-free.  1 = paper-faithful pure argmax.
    inference_candidates: int = 16
    # training-loop settings of the reference, kept so configs round-trip
    fused: bool = True
    buffer_capacity: int | None = None


class DreamShard:
    """DreamShard agent bound to a ``CostOracle``, on one device.

    ``device`` defaults to ``cuda`` and raises where there is no card
    (``repro_torch.device.resolve_device``); pass ``device="cpu"`` to run
    on the CPU.  The networks are made from ``config.seed`` through a
    ``torch.Generator``.
    """

    def __init__(self, train_tasks: list[Task],
                 oracle: CostOracle | CostSimulator,
                 config: DreamShardConfig | None = None, *,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.tasks = train_tasks
        self.oracle = ensure_oracle(oracle)
        self.cfg = config or DreamShardConfig()
        gen = torch.Generator().manual_seed(self.cfg.seed)
        self.cost_net = N.CostNet(generator=gen).to(self.device)
        self.policy_net = N.PolicyNet(generator=gen).to(self.device)
        self._placer = None      # cached placer (see as_placer)
        self._placer_sig = None

    @property
    def _log_targets(self) -> bool:
        return self.cfg.target_transform == "log1p"

    # ---- Algorithm 2: inference -------------------------------------------------

    def _sorted_order(self, feats_norm: np.ndarray) -> np.ndarray:
        """Descending predicted single-table cost (App. B.4.2)."""
        with torch.no_grad():
            costs = N.predict_single_table_costs(
                self.cost_net, torch.as_tensor(feats_norm,
                                               device=self.device))
        return np.argsort(-costs.cpu().numpy(), kind="stable")

    def _inference_inputs(self, raw_features: np.ndarray):
        """(feats_norm (M,F), sizes_gb (M,), descending-cost order (M,))."""
        raw = (F.drop_feature_group(raw_features, self.cfg.feature_drop)
               if self.cfg.feature_drop else raw_features)
        feats = F.normalize_features(raw)
        sizes = raw_features[:, F.TABLE_SIZE_GB].astype(np.float32)
        return feats, sizes, self._sorted_order(feats)

    def place_detailed(self, raw_features: np.ndarray, n_devices: int,
                       n_candidates: int | None = None
                       ) -> tuple[np.ndarray, float]:
        """Algorithm 2 (hardware-free inference): greedy argmax decode, plus
        optional sampled candidates ranked by the estimated cost.  Returns
        ``(assignment, estimated_cost_ms_of_the_chosen_candidate)``."""
        feats, sizes, order = self._inference_inputs(raw_features)
        k = self.cfg.inference_candidates if n_candidates is None \
            else n_candidates
        actions, est = R.decode_candidates(
            self.policy_net, self.cost_net,
            torch.as_tensor(feats[order], device=self.device),
            torch.as_tensor(sizes[order], device=self.device),
            self.oracle.mem_capacity_gb, n_devices=n_devices,
            n_candidates=k, use_cost=self.cfg.use_cost_features,
            reward_mode=self.cfg.reward_mode, log_targets=self._log_targets)
        actions, est = actions.cpu().numpy(), est.cpu().numpy()
        best = int(np.argmin(est))
        assignment = np.empty(raw_features.shape[0], dtype=np.int64)
        assignment[order] = actions[best]
        return assignment, float(est[best])

    def place(self, raw_features: np.ndarray, n_devices: int,
              n_candidates: int | None = None) -> np.ndarray:
        return self.place_detailed(raw_features, n_devices, n_candidates)[0]

    def as_placer(self, n_candidates: int | None = None,
                  bucket_tables: int = 8):
        """This agent behind the ``Placer`` protocol (cached: repeated
        calls share one batched ``PlacementSession``)."""
        from repro_torch.api.placers import DreamShardPlacer
        if self._placer is None or \
                (n_candidates, bucket_tables) != self._placer_sig:
            self._placer = DreamShardPlacer(self, n_candidates=n_candidates,
                                            bucket_tables=bucket_tables)
            self._placer_sig = (n_candidates, bucket_tables)
        return self._placer

    # ---- checkpoints (the JAX package's format) --------------------------------

    def _params_tree(self) -> dict:
        return {"cost": N.params_to_jax(self.cost_net),
                "policy": N.params_to_jax(self.policy_net)}

    def save(self, path: str):
        """Checkpoint the agent (both networks + config)."""
        save_pytree(self._params_tree(), path)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(self.cfg), f, indent=2)

    def restore(self, path: str):
        """Restore networks AND config from a checkpoint written by this
        class or by the JAX package's ``DreamShard.save``."""
        cfg_path = os.path.join(path, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                stored = json.load(f)
            known = {fld.name for fld in dataclasses.fields(DreamShardConfig)}
            self.cfg = DreamShardConfig(
                **{k: v for k, v in stored.items() if k in known})
        tree = restore_pytree(self._params_tree(), path)
        self.cost_net = N.params_from_jax(tree["cost"]).to(self.device)
        self.policy_net = N.params_from_jax(tree["policy"]).to(self.device)
        self._placer = None
        self._placer_sig = None
