"""DreamShard training (paper Algorithm 1) and inference (Algorithm 2):
the counterpart of ``repro/core/trainer.py``.

Iteratively: (1) collect ``n_collect`` cost measurements from the
hardware oracle using placements sampled on the estimated MDP by the
current policy; (2) update the cost network ``n_cost`` minibatches of MSE
(Eq. 1); (3) update the policy ``n_rl`` REINFORCE steps purely inside the
estimated MDP (Eq. 2) -- no hardware touched.  Inference decodes on the
estimated MDP (greedy plus sampled candidates, ranked by the cost
network), and agents save and restore in the JAX package's checkpoint
format.

The host ``np.random.default_rng(seed)`` draws task and minibatch indices
in the reference's order, so one seed picks the same tasks and slots as
the JAX trainer.  The sampling noise (the reference's per-task PRNG keys)
is drawn on the host from a ``torch.Generator`` seeded by the config, one
``(m_pad, E, d_pad)`` block per task in key order, so the per-step and
fused paths sample alike and the CPU and the card draw the same noise.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import telemetry as tele
from repro_torch.api.oracle import (CostOracle, ensure_oracle, evaluate_many,
                                    legal_batch)
from repro_torch.api.session import (decode_padded, pad_device_mask,
                                     pad_feature_batch, pad_tables)
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.core import features as F
from repro_torch.core import networks as N
from repro_torch.core import replay as RB
from repro_torch.core import rollout as R
from repro_torch.data.tasks import Task
from repro_torch.device import resolve_device
from repro_torch.optim import adam, linear_decay
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
    # fused loop: device-resident replay ring + one call per stage (every
    # task shape in one padded batch); False runs the per-step
    # Algorithm-1 loop (the numerical reference of the fused one)
    fused: bool = True
    # replay ring capacity; None sizes it to hold every sample the
    # configured run can collect; smaller values overwrite the oldest
    buffer_capacity: int | None = None


@dataclasses.dataclass
class CostSample:
    feats_norm: np.ndarray   # (M, F)
    assignment: np.ndarray   # (M,)
    q: np.ndarray            # (D, 3) scaled
    overall: float           # scaled
    n_devices: int


class DreamShard:
    """DreamShard agent bound to a ``CostOracle``, on one device.

    ``device`` defaults to ``cuda`` and raises where there is no card
    (``repro_torch.device.resolve_device``); pass ``device="cpu"`` to run
    on the CPU.  The networks are made from ``config.seed`` through a
    ``torch.Generator``, which then draws the sampling noise.  The trainer
    touches only the oracle's ``evaluate_many`` / ``mem_capacity_gb`` /
    ``num_evaluations``, so measured (``KernelOracle``,
    ``MeasuredOracle``) and memoized (``CachedOracle``) backends drop in.
    """

    def __init__(self, train_tasks: list[Task],
                 oracle: CostOracle | CostSimulator,
                 config: DreamShardConfig | None = None, *,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.tasks = train_tasks
        self.oracle = ensure_oracle(oracle)
        self.cfg = config or DreamShardConfig()
        self.rng = np.random.default_rng(self.cfg.seed)
        self._gen = torch.Generator().manual_seed(self.cfg.seed)
        self.cost_net = N.CostNet(generator=self._gen).to(self.device)
        self.policy_net = N.PolicyNet(generator=self._gen).to(self.device)

        self._rebuild_opt_and_caches()

        self.buffer: list[CostSample] = []
        self._m_pad = max(t.n_tables for t in train_tasks)
        self._d_pad = max(t.n_devices for t in train_tasks)
        self.history: list[dict] = []
        self._placer = None      # cached placer (see as_placer)
        self._placer_sig = None
        # device computations launched by the trainer loop (one per stage
        # call or eager op sequence), counted as the reference counts them
        self.num_dispatches = 0

    def _rebuild_opt_and_caches(self):
        """(Re)create everything derived from the config: optimizers, their
        states and the update functions.  Called from ``__init__`` and
        again from ``restore``."""
        total_cost_steps = self.cfg.n_iterations * self.cfg.n_cost
        total_rl_steps = self.cfg.n_iterations * self.cfg.n_rl
        self._cost_opt = adam(linear_decay(self.cfg.lr, total_cost_steps))
        self._rl_opt = adam(linear_decay(self.cfg.lr, total_rl_steps))
        self.cost_opt_state = self._cost_opt.init(
            list(self.cost_net.parameters()))
        self.rl_opt_state = self._rl_opt.init(
            list(self.policy_net.parameters()))
        self._rl_updates = {}    # (D, E) -> update (per-step path)
        self._prepared_cache = {}  # task index -> (feats_norm, sizes_gb)
        # fused path: the ring is rebuilt lazily, so a restore with changed
        # target units starts from a clean buffer
        self._ring: RB.ReplayBuffer | None = None
        self._ring_host: tuple | None = None  # _host_sig() at last mirror
        self._fused_cost_update = RB.make_fused_cost_update(self._cost_opt)
        self._fused_rl_update = R.make_fused_rl_update(
            self._rl_opt, n_episodes=self.cfg.n_episode,
            w_entropy=self.cfg.entropy_weight,
            use_cost=self.cfg.use_cost_features,
            reward_mode=self.cfg.reward_mode, log_targets=self._log_targets)

    # ---- feature plumbing -----------------------------------------------------

    def _prepared(self, task: Task):
        raw = task.raw_features
        if self.cfg.feature_drop:
            raw = F.drop_feature_group(raw, self.cfg.feature_drop)
        feats = F.normalize_features(raw)
        sizes = task.raw_features[:, F.TABLE_SIZE_GB].astype(np.float32)
        return feats, sizes

    def _prepared_train(self, task_idx: int):
        """``_prepared`` for a training-set task, memoized (cleared on
        ``restore``: feature_drop may change)."""
        hit = self._prepared_cache.get(task_idx)
        if hit is None:
            hit = self._prepared(self.tasks[task_idx])
            self._prepared_cache[task_idx] = hit
        return hit

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _next_noise(self, n: int, n_episodes: int) -> torch.Tensor:
        """Sampling noise of ``n`` tasks, ``(n, m_pad, E, d_pad)`` on the
        agent's device: one block per task, drawn on the host in the
        order the reference splits one key per task."""
        noise = [R.gumbel_noise((self._m_pad, n_episodes, self._d_pad),
                                self._gen, "cpu") for _ in range(n)]
        return torch.stack(noise).to(self.device)

    def transform_targets(self, ms):
        if self.cfg.target_transform == "log1p":
            return np.log1p(ms)
        return np.asarray(ms) * self.cfg.cost_scale

    @property
    def _log_targets(self) -> bool:
        return self.cfg.target_transform == "log1p"

    # ---- Algorithm 1 stage 1: data collection ---------------------------------

    def _record_sample(self, task: Task, feats_norm: np.ndarray,
                       assignment: np.ndarray) -> CostSample:
        res = self.oracle.evaluate(task.raw_features, assignment,
                                   task.n_devices)
        sample = CostSample(
            feats_norm=feats_norm, assignment=assignment,
            q=self.transform_targets(res.cost_features),
            overall=float(self.transform_targets(res.overall)),
            n_devices=task.n_devices)
        self.buffer.append(sample)
        return sample

    def collect(self):
        if self.cfg.fused:
            return self._collect_fused()
        cap = self.oracle.mem_capacity_gb
        for _ in range(self.cfg.n_collect):
            ti = int(self.rng.integers(len(self.tasks)))
            task = self.tasks[ti]
            feats, sizes = self._prepared_train(ti)
            order = self._sorted_order(feats)
            m, d = task.n_tables, task.n_devices
            noise = self._next_noise(1, 1)[0, :m, :, :d]
            self.num_dispatches += 2          # sort + rollout
            actions, _ = R.rollout(
                self.policy_net, self.cost_net, self._tensor(feats[order]),
                self._tensor(sizes[order]), cap, n_devices=d, n_episodes=1,
                greedy=False, use_cost=self.cfg.use_cost_features,
                reward_mode=self.cfg.reward_mode,
                log_targets=self._log_targets, gumbel=noise)
            assignment = np.empty(m, dtype=np.int64)
            assignment[order] = actions[0].cpu().numpy()
            self._record_sample(task, feats, assignment)

    def _collect_fused(self):
        """All ``n_collect`` rollouts in ONE padded batched call (sort and
        decode on the device, ``rollout.collect_batched``), measured
        through the oracle's batched ``evaluate_many`` path."""
        n = self.cfg.n_collect
        if n == 0:
            return
        idxs = [int(self.rng.integers(len(self.tasks))) for _ in range(n)]
        tasks = [self.tasks[i] for i in idxs]
        noise = self._next_noise(n, 1)
        prepared = [self._prepared_train(i) for i in idxs]
        feats, sizes, tmask = pad_feature_batch(prepared, self._m_pad)
        dmask = pad_device_mask([t.n_devices for t in tasks], self._d_pad)
        actions, _, order = R.collect_batched(
            self.policy_net, self.cost_net, self._tensor(feats),
            self._tensor(sizes), self._tensor(tmask), self._tensor(dmask),
            self.oracle.mem_capacity_gb, noise, n_episodes=1,
            use_cost=self.cfg.use_cost_features,
            reward_mode=self.cfg.reward_mode, log_targets=self._log_targets)
        self.num_dispatches += 1
        actions, order = actions.cpu().numpy(), order.cpu().numpy()
        assignments = []
        for j, task in enumerate(tasks):
            m = task.n_tables
            assignment = np.empty(m, dtype=np.int64)
            assignment[order[j, :m]] = actions[j, 0, :m]
            assignments.append(assignment)
        appended = self._measure_collected(idxs, prepared, assignments)
        self.buffer.extend(appended)
        self._ring_extend(appended)

    def _measure_collected(self, idxs: list[int], prepared: list,
                           assignments: list[np.ndarray]
                           ) -> list[CostSample]:
        """Measure decoded placements through the oracle's batched path.

        Placements of the same training task are stacked into one
        ``evaluate_many`` call, and the samples keep collection order (so
        the buffer layout, and with it the minibatch RNG stream, is the
        per-placement loop's).  A memory-illegal placement is legitimate
        on over-tight tasks (the rollout's no-legal-device fallback) and
        is measured; an illegal row that uses a device id outside the
        task's range means the padding mask is broken, and raises.
        """
        groups: dict[int, list[int]] = {}
        for j, ti in enumerate(idxs):
            groups.setdefault(ti, []).append(j)
        samples: list[CostSample | None] = [None] * len(idxs)
        for ti, js in groups.items():
            task = self.tasks[ti]
            batch = np.stack([assignments[j] for j in js])
            ok = legal_batch(self.oracle, task.raw_features, batch,
                             task.n_devices)
            if not ok.all():
                bad = batch[~ok]
                if ((bad < 0) | (bad >= task.n_devices)).any():
                    raise RuntimeError(
                        "collection decoded a placement onto a padding "
                        f"device for task {ti}: device masking is broken")
            results = evaluate_many(self.oracle, task.raw_features, batch,
                                    task.n_devices)
            for j, res in zip(js, results):
                samples[j] = CostSample(
                    feats_norm=prepared[j][0], assignment=assignments[j],
                    q=self.transform_targets(res.cost_features),
                    overall=float(self.transform_targets(res.overall)),
                    n_devices=task.n_devices)
        return samples

    # ---- Algorithm 1 stage 2: cost network update (Eq. 1) ---------------------

    def _cost_batch(self, samples: list[CostSample]):
        """Pad an explicit sample list into dense cost-net training arrays
        (feats, onehot, tmask, dmask, q_t, c_t).  Pads grow beyond the
        training-suite shape when given larger held-out samples."""
        B = len(samples)
        Mp = max([self._m_pad] + [s.feats_norm.shape[0] for s in samples])
        Dp = max([self._d_pad] + [s.n_devices for s in samples])
        feats = np.zeros((B, Mp, F.NUM_FEATURES), np.float32)
        onehot = np.zeros((B, Dp, Mp), np.float32)
        tmask = np.zeros((B, Mp), np.float32)
        dmask = np.zeros((B, Dp), np.float32)
        q_t = np.zeros((B, Dp, 3), np.float32)
        c_t = np.zeros((B,), np.float32)
        for j, s in enumerate(samples):
            m, d = s.feats_norm.shape[0], s.n_devices
            feats[j, :m] = s.feats_norm
            onehot[j, s.assignment, np.arange(m)] = 1.0
            tmask[j, :m] = 1.0
            dmask[j, :d] = 1.0
            q_t[j, :d] = s.q
            c_t[j] = s.overall
        return feats, onehot, tmask, dmask, q_t, c_t

    # ---- device-resident replay ring (fused path) -----------------------------

    def _ring_capacity(self) -> int:
        if self.cfg.buffer_capacity is not None:
            return max(1, self.cfg.buffer_capacity)
        return max(1, self.cfg.n_iterations * self.cfg.n_collect,
                   len(self.buffer))

    def _host_sig(self):
        """Identity signature of the host buffer the ring mirrors: list
        object, length and tail-sample object (in-place mutation of a
        ``CostSample``'s arrays is not detected: replace the sample)."""
        return (id(self.buffer), len(self.buffer),
                id(self.buffer[-1]) if self.buffer else None)

    def _ring_in_sync(self) -> bool:
        return self._ring is not None and \
            self._ring.count == len(self.buffer) and \
            self._ring_host == self._host_sig()

    def _ring_extend(self, samples: list[CostSample]):
        """Mirror freshly collected samples into the device ring (one
        write); falls back to a full rebuild if the ring is stale.
        ``self.buffer`` already holds ``samples`` as its tail."""
        stale = self._ring is None or \
            self._ring.count != len(self.buffer) - len(samples) or \
            self._ring_host is None or \
            self._ring_host[0] != id(self.buffer) or \
            self._ring_host[1] != len(self.buffer) - len(samples)
        if stale:
            return self._sync_ring()
        self._ring.append_batch(*self._cost_batch(samples))
        self._ring_host = self._host_sig()
        self.num_dispatches += 1

    def _sync_ring(self):
        """(Re)build the device ring from ``self.buffer``.  Normally a
        no-op: ``collect`` appends to both in lockstep.  Needed when the
        host buffer was assigned directly or invalidated by ``restore``."""
        if self._ring_in_sync() and \
                self._ring.capacity >= self._ring_capacity():
            return
        n = len(self.buffer)
        cap = self._ring_capacity()
        if self._ring is not None and cap > self._ring.capacity and \
                self.cfg.buffer_capacity is None:
            # training ran past the configured n_iterations * n_collect
            # budget: grow geometrically, so continued training rebuilds
            # the ring O(log n) times instead of at every step
            cap = max(cap, 2 * self._ring.capacity)
        self._ring = RB.ReplayBuffer(cap, self._m_pad, self._d_pad,
                                     device=self.device)
        self._ring_host = self._host_sig()
        if n:
            kept = self.buffer[-cap:]         # ring semantics: newest wins
            self._ring.count = n - len(kept)  # so slots land at i % cap
            self._ring.append_batch(*self._cost_batch(kept))
            self.num_dispatches += 1

    def update_cost(self, n_steps: int | None = None):
        n_steps = n_steps if n_steps is not None else self.cfg.n_cost
        if self.cfg.fused:
            return self._update_cost_fused(n_steps)
        losses = []
        for _ in range(n_steps):
            idx = self.rng.integers(len(self.buffer),
                                    size=min(self.cfg.n_batch,
                                             len(self.buffer)))
            batch = self._cost_batch([self.buffer[i] for i in idx])
            self.cost_opt_state, loss = RB.cost_step(
                self._cost_opt, self.cost_net, self.cost_opt_state,
                tuple(map(self._tensor, batch)))
            self.num_dispatches += 1
            losses.append(float(loss))
        return float(np.mean(losses)) if losses else 0.0

    def _cost_slots(self, n_steps: int):
        """Minibatch ring slots and weights of ``n_steps`` fused cost
        steps, drawn from the host RNG in the per-step loop's order:
        ``(idx, w)``, each ``(n_steps, n_batch)``."""
        size = self._ring.size
        b = min(self.cfg.n_batch, size)
        idx = np.zeros((n_steps, self.cfg.n_batch), np.int32)
        w = np.zeros((n_steps, self.cfg.n_batch), np.float32)
        for t in range(n_steps):
            idx[t, :b] = self._ring.slots(self.rng.integers(size, size=b))
            w[t, :b] = 1.0
        return idx, w

    def _update_cost_fused(self, n_steps: int):
        """The whole Eq.-1 stage in one call over minibatches gathered on
        the device (``replay.make_fused_cost_update``), with host-drawn
        slots and the padded tail of partially-filled minibatches
        weight-masked."""
        if n_steps == 0 or not self.buffer:
            return 0.0
        self._sync_ring()
        idx, w = self._cost_slots(n_steps)
        _, self.cost_opt_state, losses = self._fused_cost_update(
            self.cost_net, self.cost_opt_state, self._ring.data, idx, w)
        self.num_dispatches += 1
        return float(losses.mean())

    # ---- Algorithm 1 stage 3: policy update on the estimated MDP (Eq. 2) ------

    def _rl_update_fn(self, n_devices: int):
        key = (n_devices, self.cfg.n_episode)
        if key not in self._rl_updates:
            self._rl_updates[key] = R.make_rl_update(
                self._rl_opt, n_devices=n_devices,
                n_episodes=self.cfg.n_episode,
                w_entropy=self.cfg.entropy_weight,
                use_cost=self.cfg.use_cost_features,
                reward_mode=self.cfg.reward_mode,
                log_targets=self._log_targets)
        return self._rl_updates[key]

    def update_policy(self, n_steps: int | None = None):
        n_steps = n_steps if n_steps is not None else self.cfg.n_rl
        if self.cfg.fused:
            return self._update_policy_fused(n_steps)
        cap = self.oracle.mem_capacity_gb
        rewards = []
        for _ in range(n_steps):
            ti = int(self.rng.integers(len(self.tasks)))
            task = self.tasks[ti]
            feats, sizes = self._prepared_train(ti)
            order = self._sorted_order(feats)
            m, d = task.n_tables, task.n_devices
            noise = self._next_noise(1, self.cfg.n_episode)[0, :m, :, :d]
            update = self._rl_update_fn(d)
            self.num_dispatches += 2          # sort + update
            _, self.rl_opt_state, _, reward = update(
                self.policy_net, self.rl_opt_state, self.cost_net,
                self._tensor(feats[order]), self._tensor(sizes[order]), cap,
                noise)
            rewards.append(float(reward.mean()))
        return float(np.mean(rewards)) if rewards else 0.0

    def _update_policy_fused(self, n_steps: int):
        """All ``n_rl`` REINFORCE steps in one call over a pre-sampled
        padded task batch (``rollout.make_fused_rl_update``): tables
        tmask'd to M_pad, devices dmask'd to D_pad, so one function covers
        every (n_tables, n_devices) of the training set."""
        if n_steps == 0:
            return 0.0
        idxs = [int(self.rng.integers(len(self.tasks)))
                for _ in range(n_steps)]
        tasks = [self.tasks[i] for i in idxs]
        noise = self._next_noise(n_steps, self.cfg.n_episode)
        prepared = [self._prepared_train(i) for i in idxs]
        feats, sizes, tmask = pad_feature_batch(prepared, self._m_pad)
        dmask = pad_device_mask([t.n_devices for t in tasks], self._d_pad)
        _, self.rl_opt_state, _, rewards = self._fused_rl_update(
            self.policy_net, self.rl_opt_state, self.cost_net,
            self._tensor(feats), self._tensor(sizes), self._tensor(tmask),
            self._tensor(dmask), self.oracle.mem_capacity_gb, noise)
        self.num_dispatches += 1
        return float(rewards.mean())

    # ---- full loop -------------------------------------------------------------

    def train(self, eval_tasks: list[Task] | None = None,
              log: bool = False):
        for it in range(self.cfg.n_iterations):
            t0 = time.perf_counter()
            d0 = self.num_dispatches
            with tele.span("train.iteration", iteration=it) as sp:
                with tele.span("train.collect", iteration=it):
                    self.collect()
                with tele.span("train.cost_update", iteration=it):
                    cost_loss = self.update_cost()
                with tele.span("train.rl_update", iteration=it):
                    mean_reward = self.update_policy()
                sp.set(cost_loss=cost_loss, mean_est_reward=mean_reward)
            entry = {"iteration": it, "cost_loss": cost_loss,
                     "mean_est_reward": mean_reward,
                     "wall_s": time.perf_counter() - t0,
                     "dispatches": self.num_dispatches - d0,
                     "sim_evals": self.oracle.num_evaluations}
            if eval_tasks is not None:
                entry["eval_cost_ms"] = self.evaluate_tasks(eval_tasks)
            self.history.append(entry)
            if log:
                print(f"[dreamshard] iter={it} cost_loss={cost_loss:.4f} "
                      f"est_reward={mean_reward:.3f} "
                      + (f"eval={entry.get('eval_cost_ms', float('nan')):.2f}ms"
                         if eval_tasks else ""))
        return self.history

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
        ``(assignment, estimated_cost_ms_of_the_chosen_candidate)``.

        The task is decoded as a ``PlacementSession`` of the default
        ``bucket_tables`` decodes it, padded by ``pad_tables`` in a call of
        ``DECODE_BATCH`` tasks, so both give it the same bits on any
        device (a lone task at its own table count runs other GEMM
        shapes, whose sums round differently on the card; so does a
        session of another bucket)."""
        feats, sizes, order = self._inference_inputs(raw_features)
        k = self.cfg.inference_candidates if n_candidates is None \
            else n_candidates
        m = raw_features.shape[0]
        actions, est = decode_padded(
            self, [(feats[order], sizes[order])], pad_tables(m), n_devices,
            k)
        best = int(np.argmin(est[0]))
        assignment = np.empty(m, dtype=np.int64)
        assignment[order] = actions[0, best, :m]
        return assignment, float(est[0, best])

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
        class or by the JAX package's ``DreamShard.save``: a round trip
        reproduces the saved agent's inference behaviour."""
        old_cfg = self.cfg
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
        # everything derived from the old config is now stale: optimizers,
        # update functions and the cached placer's session
        self._rebuild_opt_and_caches()
        self._placer = None
        self._placer_sig = None
        if (old_cfg.target_transform, old_cfg.cost_scale) != \
                (self.cfg.target_transform, self.cfg.cost_scale):
            self.buffer = []     # old samples are in the old target units

    def cost_mse(self, samples: list[CostSample]) -> float:
        """Test MSE of the cost network on held-out cost samples (Fig 7)."""
        with torch.no_grad():
            loss = RB.cost_loss(self.cost_net, *map(
                self._tensor, self._cost_batch(samples)))
        return float(loss)

    def evaluate_tasks(self, tasks: list[Task]) -> float:
        """Mean measured cost over a suite, decoded through the batched
        ``PlacementSession``."""
        from repro_torch.api.placement import evaluate_placer
        return evaluate_placer(self.oracle, tasks, self.as_placer())
