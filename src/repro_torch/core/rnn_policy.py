"""RNN-based device placement baseline (paper App. D.2, after [13]): the
counterpart of ``repro/core/rnn_policy.py``.

Adapted as in the paper: the same 21-feature extraction MLP and
per-device scoring head as DreamShard, but the table representations
pass through an LSTM and a causal content attention before the sum
reduction, there is NO cost network (zeros feed the cost branch), and
training is plain REINFORCE against the hardware oracle's measurements --
which is why it is sample-starved and unstable on harder tasks (Table 1).

The LSTM is an explicit cell loop of float32 matmuls in the reference's
layout (``x @ wx + b + h @ wh``, gates i, f, g, o, one bias), so it runs
no cuDNN kernel and no TF32 whatever cuDNN's global flags say.  Tasks
are drawn by the host ``np.random.default_rng(seed)`` as the reference
draws them, tables decode in the task's own order (no cost net to sort
by), and the sampling noise of each update is one ``(M, E, D)`` block
from a host ``torch.Generator`` (``_next_noise``), so a CPU run and a
card run of one seed sample the same noise.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from repro_torch.api.oracle import CostOracle, ensure_oracle, evaluate_many
from repro_torch.core import features as F
from repro_torch.core import networks as N
from repro_torch.core import rollout as R
from repro_torch.data.tasks import Task
from repro_torch.device import resolve_device
from repro_torch.optim import adam, apply_updates, linear_decay
from repro_torch.sim.costsim import CostSimulator

H = N.HIDDEN

# The cost branch reads zeros, so ``cost_mlp`` adds one vector to every
# device's scoring input: its parameters and the head's bias shift every
# device's logit alike, the softmax over devices cancels them, and their
# gradient is zero but for rounding (which Adam turns into steps of up to
# ``lr``).
LOGIT_SHIFT_PARAMS = ("cost_mlp.layers.0.weight", "cost_mlp.layers.0.bias",
                      "cost_mlp.layers.1.weight", "cost_mlp.layers.1.bias",
                      "head.layers.0.bias")


class LSTM(nn.Module):
    """One LSTM layer with the reference's parameters: ``wx`` (dim_in,
    4 dim_h), ``wh`` (dim_h, 4 dim_h) drawn normal x 1/sqrt(dim_h), and
    one zero bias ``b`` (4 dim_h)."""

    def __init__(self, dim_in: int, dim_h: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        scale = 1.0 / math.sqrt(dim_h)
        self.wx = nn.Parameter(torch.randn((dim_in, 4 * dim_h),
                                           generator=generator) * scale)
        self.wh = nn.Parameter(torch.randn((dim_h, 4 * dim_h),
                                           generator=generator) * scale)
        self.b = nn.Parameter(torch.zeros(4 * dim_h))

    def forward(self, xs):
        """(M, dim_in) -> (M, dim_h) hidden sequence."""
        h = c = xs.new_zeros(self.wh.shape[0])
        hs = []
        for xw in xs @ self.wx + self.b:     # the input terms in one matmul
            i, f, g, o = (xw + h @ self.wh).chunk(4)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs)


def attention(hs):
    """Causal content-based self attention over the hidden sequence
    (M, H); masked scores are -1e9, as in the reference."""
    scores = hs @ hs.T / math.sqrt(hs.shape[-1])
    causal = torch.ones_like(scores, dtype=torch.bool).tril()
    scores = torch.where(causal, scores, -1e9)
    return torch.softmax(scores, dim=-1) @ hs


class RNNPolicyNet(N.PolicyNet):
    """DreamShard's ``PolicyNet`` plus the LSTM over table reprs."""

    def __init__(self, num_features: int = 21,
                 generator: torch.Generator | None = None):
        super().__init__(num_features, generator)
        self.lstm = LSTM(H, H, generator)


def rnn_table_reprs(net: RNNPolicyNet, feats):
    """(M, F) -> (M, H): the shared feature MLP, the LSTM, the attention."""
    return attention(net.lstm(N.policy_table_reprs(net, feats)))


def rnn_params_from_jax(tree: dict) -> RNNPolicyNet:
    """An ``RNNPolicyNet`` (on the CPU) holding the weights of the
    reference's ``rnn_policy_init`` pytree (numpy leaves)."""
    base = N.params_from_jax({k: v for k, v in tree.items() if k != "lstm"})
    net = RNNPolicyNet(base.table_mlp.layers[0].in_features)
    net.load_state_dict(base.state_dict(), strict=False)
    with torch.no_grad():
        for name in ("wx", "wh", "b"):
            p = getattr(net.lstm, name)
            w = torch.from_numpy(np.array(tree["lstm"][name],
                                          dtype=np.float32))
            if w.shape != p.shape:
                raise ValueError(f"lstm.{name} shape {tuple(w.shape)} does "
                                 "not match the paper's widths")
            p.copy_(w)
    return net


def rnn_params_to_jax(net: RNNPolicyNet) -> dict:
    """The reference's parameter pytree (numpy leaves) of an RNN policy."""
    tree = N.params_to_jax(net)
    tree["lstm"] = {name: getattr(net.lstm, name).detach().cpu().numpy()
                    .copy() for name in ("wx", "wh", "b")}
    return tree


@dataclasses.dataclass
class RNNPolicyConfig:
    n_updates: int = 100          # hardware-measured REINFORCE updates
    n_episode: int = 10
    entropy_weight: float = 1e-3
    lr: float = 5e-4
    seed: int = 0
    # estimated-cost head settings, forwarded to the shared rollout core
    # (only consulted when use_cost is enabled, e.g. hybrid ablations)
    reward_mode: str = "composed"
    log_targets: bool = True


class RNNPlacer:
    """REINFORCE on real measurements; matched hardware budget vs DreamShard.

    ``device`` defaults to ``cuda`` and raises where there is no card
    (``repro_torch.device.resolve_device``); pass ``device="cpu"`` to run
    on the CPU.
    """

    def __init__(self, train_tasks: list[Task],
                 oracle: CostOracle | CostSimulator,
                 config: RNNPolicyConfig | None = None, *,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.tasks = train_tasks
        self.oracle = ensure_oracle(oracle)
        self.cfg = config or RNNPolicyConfig()
        self.rng = np.random.default_rng(self.cfg.seed)
        self._gen = torch.Generator().manual_seed(self.cfg.seed)
        self.net = RNNPolicyNet(generator=self._gen).to(self.device)
        self._opt = adam(linear_decay(self.cfg.lr, self.cfg.n_updates))
        self.opt_state = self._opt.init(list(self.net.parameters()))

    def _next_noise(self, n_tables: int, n_devices: int) -> torch.Tensor:
        """One update's sampling noise, ``(M, E, D)`` on the placer's
        device, drawn on the host."""
        return R.gumbel_noise((n_tables, self.cfg.n_episode, n_devices),
                              self._gen, "cpu").to(self.device)

    def _inputs(self, raw_features: np.ndarray):
        feats = torch.as_tensor(F.normalize_features(raw_features),
                                device=self.device)
        sizes = torch.as_tensor(
            raw_features[:, F.TABLE_SIZE_GB].astype(np.float32),
            device=self.device)
        return feats, sizes

    def _rollout(self, feats, sizes, n_devices: int, n_episodes: int,
                 **kw):
        return R.rollout_with_reprs(
            self.net, None, rnn_table_reprs(self.net, feats), feats, sizes,
            self.oracle.mem_capacity_gb, n_devices=n_devices,
            n_episodes=n_episodes, use_cost=False,
            reward_mode=self.cfg.reward_mode,
            log_targets=self.cfg.log_targets, **kw)

    def loss(self, feats, sizes, n_devices: int, actions, adv):
        """The REINFORCE loss of replayed ``actions`` (E, M) with
        advantages ``adv`` (E,) and the entropy bonus."""
        _, sum_logp, sum_ent, _ = self._rollout(
            feats, sizes, n_devices, actions.shape[0], actions_in=actions)
        return (-(adv * sum_logp).mean()
                - self.cfg.entropy_weight * sum_ent.mean())

    def gradient(self, task: Task, noise: torch.Tensor):
        """One update's REINFORCE gradient: ``n_episode`` episodes of
        ``task`` sampled on ``noise`` (M, E, D), priced in ONE batched
        oracle pass, then replayed with advantages ``(r - mean r) / 10``.
        Returns (actions (E, M), rewards (E,), grads by parameter)."""
        feats, sizes = self._inputs(task.raw_features)
        with torch.no_grad():
            actions = self._rollout(feats, sizes, task.n_devices,
                                    self.cfg.n_episode, gumbel=noise)[0]
        results = evaluate_many(self.oracle, task.raw_features,
                                actions.cpu().numpy(), task.n_devices)
        rewards = -np.array([r.overall for r in results])
        adv = (rewards - rewards.mean()) / 10.0   # same 10ms scaling
        loss = self.loss(feats, sizes, task.n_devices, actions,
                         torch.as_tensor(adv, dtype=torch.float32,
                                         device=self.device))
        grads = torch.autograd.grad(loss, list(self.net.parameters()))
        return actions, rewards, grads

    def train(self, log: bool = False):
        params = list(self.net.parameters())
        for step in range(self.cfg.n_updates):
            task = self.tasks[self.rng.integers(len(self.tasks))]
            _, rewards, grads = self.gradient(
                task, self._next_noise(task.n_tables, task.n_devices))
            upd, self.opt_state = self._opt.update(grads, self.opt_state,
                                                   params)
            apply_updates(params, upd)
            if log and step % 20 == 0:
                print(f"[rnn] step={step} mean_cost={-rewards.mean():.2f}ms")

    @torch.no_grad()
    def place(self, raw_features: np.ndarray, n_devices: int) -> np.ndarray:
        """A greedy episode over the task's tables in their own order."""
        feats, sizes = self._inputs(raw_features)
        actions = self._rollout(feats, sizes, n_devices, 1, greedy=True)[0]
        return actions[0].cpu().numpy()

    def as_placer(self):
        """This baseline behind the ``Placer`` protocol."""
        from repro_torch.api.placers import RNNPlacerAdapter
        return RNNPlacerAdapter(self)
