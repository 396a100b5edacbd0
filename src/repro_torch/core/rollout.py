"""Estimated-MDP rollouts (paper §3.1/3.3): the counterpart of
``repro/core/rollout.py``.

The MDP places one table per step.  Because both networks reduce tables with
an elementwise SUM, the entire environment state is carried as running
per-device sums of table representations -- no recomputation per step:

  state = (policy device sums (B,E,D,H), cost device sums (B,E,D,H),
           memory used (B,E,D))

At each step the cost network's per-device heads produce the augmented-state
cost features q_{t,d} from the cost device sums, the policy scores each
device, illegal devices (memory cap) are masked, and an action is taken:
argmax at inference, ``argmax(logits + Gumbel)`` for sampled candidates
(the reference's ``jax.random.categorical``).  The estimated cost is the
cost network's reading of the final device sums.  Each step's
log-probability and entropy under the legal-masked policy are summed per
episode for REINFORCE (Eq. 2); the cost network is read with no gradient,
as the reference's ``stop_gradient``.

The reference's ``lax.scan`` over tables is a Python loop here, and its
``vmap`` over tasks is the leading batch dimension ``B``.  The Gumbel
noise is drawn one step at a time as an ``(E, D)`` tensor shared by every
task of the batch, as the reference splits its key per step and hands
every task of a vmapped bucket the same key: step t's noise then depends
on neither the batch size nor the padded table count, so a padded batch
decodes exactly as its tasks do one by one.  Training passes its own
noise instead (``gumbel``), drawn on the host per task in the order the
reference splits its keys, so every task of a batch samples
independently and a padded batch samples as its tasks do one by one.

The reference's jitted updates are functions here that loop over steps
on the device without a host sync (``make_fused_rl_update``): losses and
rewards stay on the device until the caller reads them.
"""

from __future__ import annotations

import torch

from repro_torch.core import networks as N
from repro_torch.optim import apply_updates

NEG = -1e9


def _legal_mask(mem, size_t, cap, dmask=None):
    """(..., D) legality; if a row has no legal device, everything is legal.

    ``dmask`` (..., D) marks real devices -- padding devices are never
    legal, and the no-legal-device fallback opens only the real ones.
    """
    legal = (mem + size_t) <= cap
    if dmask is not None:
        legal = legal & (dmask > 0)
    any_legal = legal.any(dim=-1, keepdim=True)
    fallback = (dmask > 0) if dmask is not None \
        else torch.ones_like(legal)
    return torch.where(any_legal, legal, fallback)


def estimate_overall(cost_net, dev_cost, reward_mode: str,
                     log_targets: bool = True, dmask=None):
    """Estimated episode cost from final cost-net device sums (..., D, H).

    "head": the paper's max-reduced overall head.
    "composed": rebuild the stage decomposition from the per-device q
    heads -- max_d fwd + max_d bwd + 2 * max_d comm.
    With ``log_targets`` the cost net predicts log1p(ms), mapped back with
    expm1 (clipped at 12) before composing stage times.
    """
    def inv(x):
        return torch.expm1(torch.clamp(x, max=12.0)) if log_targets else x

    if reward_mode == "head":
        return inv(N.cost_overall_head(cost_net, dev_cost, dmask))
    q = N.cost_device_heads(cost_net, dev_cost)           # (..., D, 3)
    if dmask is not None:                 # padding devices must not win max
        q = torch.where(dmask[..., None] > 0, q, NEG)
    mx = inv(q.amax(dim=-2))                              # (..., 3)
    return mx[..., 0] + mx[..., 1] + 2.0 * mx[..., 2]


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(U))``, U uniform on [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _scan_rollout(policy_net, cost_net, h_pol, h_cost, sizes, cap,
                  n_devices, n_episodes, greedy, use_cost, actions_in=None,
                  reward_mode="composed", log_targets=True, tmask=None,
                  dmask=None, gumbel=None, generator=None):
    """Roll out E episodes for each of B tasks, one table per step.

    h_pol / h_cost (B, M, H) table reprs in decode order; sizes (B, M).
    ``tmask`` (B, M) marks valid tables (1.0) vs padding rows (0.0):
    padded steps still run but add nothing to the device sums, memory,
    log-prob or entropy, so a task padded to a bucket shape rolls out
    exactly as its unpadded self.  ``dmask`` (B, D) or (D,) marks real
    devices: padding devices score NEG, stay out of the legality
    fallback and cannot win the device-max of the estimated cost.

    Actions are replayed from ``actions_in`` (B, E, M) when it is given,
    else argmax'd (``greedy``), else sampled: step t's Gumbel noise is
    ``gumbel[t]`` (broadcast to (B, E, D): (M, E, D) shares it across the
    batch, (M, B, E, D) gives every task its own) when it is given, else
    it is drawn from ``generator`` as an (E, D) tensor.  Gradients reach
    the policy network only.  Returns (actions (B, E, M) int64, sum_logp
    (B, E), sum_ent (B, E), est_cost (B, E)).  The log-probability and
    entropy are computed only where they can be used, with ``actions_in``
    or with gradients enabled; the decode path (``no_grad``, no replay)
    gets zeros for both sums and launches none of their kernels.
    """
    B, M, H = h_pol.shape
    E, D = n_episodes, n_devices
    dev = h_pol.device
    dtype = h_pol.dtype
    if dmask is not None:
        dmask = dmask.reshape(-1, 1, D)                    # (B|1, 1, D)
    dev_pol = torch.zeros((B, E, D, H), dtype=dtype, device=dev)
    dev_cost = torch.zeros((B, E, D, H), dtype=dtype, device=dev)
    mem = torch.zeros((B, E, D), dtype=dtype, device=dev)
    no_cost = None if use_cost else torch.zeros(
        (B, E, D, N.NUM_COST_FEATURES), dtype=dtype, device=dev)
    track = actions_in is not None or torch.is_grad_enabled()
    actions, logps, ents = [], [], []
    for t in range(M):
        if use_cost:
            with torch.no_grad():
                q = N.cost_device_heads(cost_net, dev_cost)       # (B,E,D,3)
        else:
            q = no_cost
        logits = N.policy_logits(policy_net, dev_pol, q, dmask)  # (B,E,D)
        size_t = sizes[:, t, None, None]
        legal = _legal_mask(mem, size_t, cap, dmask)
        logits = torch.where(legal, logits, NEG)
        if actions_in is not None:
            a = actions_in[..., t].expand(B, E)
        elif greedy:
            a = logits.detach().argmax(dim=-1)
        else:
            noise = gumbel[t] if gumbel is not None else \
                gumbel_noise((E, D), generator, dev)
            a = (logits.detach() + noise.to(dtype)).argmax(dim=-1)
        onehot = torch.nn.functional.one_hot(a, D).to(dtype)       # (B,E,D)
        if track:
            logp_all = torch.log_softmax(logits, dim=-1)
            logp = logp_all.gather(-1, a[..., None])[..., 0]
            probs = torch.softmax(logits, dim=-1)
            ent = -(probs * torch.where(legal, logp_all, 0.0)).sum(dim=-1)
        if tmask is not None:           # zero padded rows' contributions
            valid = tmask[:, t, None]                              # (B, 1)
            onehot = onehot * valid[..., None]
            if track:
                logp = logp * valid
                ent = ent * valid
        dev_pol = dev_pol + onehot[..., None] * h_pol[:, t, None, None, :]
        dev_cost = dev_cost + onehot[..., None] * h_cost[:, t, None, None, :]
        mem = mem + onehot * size_t
        actions.append(a)
        if track:
            logps.append(logp)
            ents.append(ent)
    acts = torch.stack(actions, dim=-1) if actions else \
        torch.zeros((B, E, 0), dtype=torch.int64, device=dev)
    if logps:
        sum_logp = torch.stack(logps).sum(dim=0)
        sum_ent = torch.stack(ents).sum(dim=0)
    else:
        sum_logp = sum_ent = torch.zeros((B, E), dtype=dtype, device=dev)
    with torch.no_grad():
        if use_cost:
            est = estimate_overall(cost_net, dev_cost, reward_mode,
                                   log_targets, dmask=dmask)
        else:   # no cost network: no estimate available
            est = torch.zeros((B, E), dtype=dtype, device=dev)
    return acts, sum_logp, sum_ent, est


@torch.no_grad()
def decode_candidates(policy_net, cost_net, feats, sizes, cap, *,
                      n_devices, n_candidates, tmask=None, use_cost=True,
                      reward_mode="composed", log_targets=True,
                      gumbel=None):
    """Algorithm-2 inference core: greedy decode + sampled candidates.

    ``feats`` (M, F) or a batch (B, M, F), ALREADY sorted descending by
    predicted single-table cost; ``sizes`` / ``tmask`` (M,) or (B, M).
    Returns ``(actions (k, M), est_cost (k,))`` (with a leading B for a
    batch): one greedy episode followed by ``n_candidates - 1`` sampled
    episodes, all scored by the cost network's estimate.  The sampled
    episodes' noise comes from a ``torch.Generator`` seeded 1 (the
    reference's ``PRNGKey(1)``), or from ``gumbel`` (M, k - 1, D) when
    given.  This is the ONE decode implementation: ``DreamShard.place``
    calls it per task and ``PlacementSession`` per padded bucket.
    """
    single = feats.dim() == 2
    if single:
        feats, sizes = feats[None], sizes[None]
        tmask = None if tmask is None else tmask[None]
    h_pol = N.policy_table_reprs(policy_net, feats)
    h_cost = N.cost_table_reprs(cost_net, feats)
    common = dict(reward_mode=reward_mode, log_targets=log_targets,
                  tmask=tmask)
    a, _, _, est = _scan_rollout(policy_net, cost_net, h_pol, h_cost, sizes,
                                 cap, n_devices, 1, True, use_cost, **common)
    if n_candidates > 1:
        generator = None
        if gumbel is None:
            generator = torch.Generator(device=feats.device)
            generator.manual_seed(1)
        a2, _, _, est2 = _scan_rollout(
            policy_net, cost_net, h_pol, h_cost, sizes, cap, n_devices,
            n_candidates - 1, False, use_cost, gumbel=gumbel,
            generator=generator, **common)
        a = torch.cat([a, a2], dim=1)
        est = torch.cat([est, est2], dim=1)
    if single:
        return a[0], est[0]
    return a, est


def rollout_with_reprs(policy_net, cost_net, h_pol, feats, sizes, cap, *,
                       n_devices, n_episodes, greedy=False, use_cost=True,
                       actions_in=None, reward_mode="composed",
                       log_targets=True, tmask=None, dmask=None,
                       gumbel=None, generator=None):
    """Rollout with externally supplied policy table reprs (RNN baseline).

    ``h_pol`` is (M, H) for one task or (B, M, H) for a batch, with
    ``feats`` (..., M, F), ``sizes`` / ``tmask`` (..., M) and
    ``actions_in`` (..., E, M) alike; a single task's outputs drop the
    batch axis.  The cost branch reads ``cost_table_reprs(cost_net,
    feats)`` (with no gradient) when ``use_cost`` is set, else zeros, and
    then ``cost_net`` may be ``None``.  The rest is ``_scan_rollout``'s:
    returns (actions, sum_logp, sum_ent, est_cost).
    """
    single = h_pol.dim() == 2
    if single:
        h_pol, feats, sizes = h_pol[None], feats[None], sizes[None]
        tmask = None if tmask is None else tmask[None]
        actions_in = None if actions_in is None else actions_in[None]
    if use_cost:
        with torch.no_grad():
            h_cost = N.cost_table_reprs(cost_net, feats)
    else:
        h_cost = torch.zeros_like(h_pol)
    out = _scan_rollout(policy_net, cost_net, h_pol, h_cost, sizes, cap,
                        n_devices, n_episodes, greedy, use_cost,
                        actions_in=actions_in, reward_mode=reward_mode,
                        log_targets=log_targets, tmask=tmask, dmask=dmask,
                        gumbel=gumbel, generator=generator)
    return tuple(x[0] for x in out) if single else out


# ---- batched (padded) table sort ---------------------------------------------

@torch.no_grad()
def sort_tables(cost_net, feats, sizes, tmask):
    """Descending sort by predicted single-table cost (App. B.4.2).

    Batched: feats (..., M, F), sizes/tmask (..., M).  Padding rows
    (tmask == 0) sort last, so the first m sorted slots are exactly the
    task's real tables.  The stable argsort of the negated costs matches
    the host-side ``np.argsort(-costs, kind="stable")`` order used by the
    per-task path.  Returns (order, feats, sizes, tmask), all sorted.
    """
    costs = N.predict_single_table_costs(cost_net, feats)         # (..., M)
    costs = torch.where(tmask > 0, costs, -torch.inf)
    order = torch.argsort(-costs, dim=-1, stable=True)
    feats = torch.take_along_dim(feats, order[..., None], dim=-2)
    sizes = torch.take_along_dim(sizes, order, dim=-1)
    tmask = torch.take_along_dim(tmask, order, dim=-1)
    return order, feats, sizes, tmask


@torch.no_grad()
def rollout(policy_net, cost_net, feats, sizes, cap, *, n_devices: int,
            n_episodes: int, greedy: bool = False, use_cost: bool = True,
            reward_mode: str = "composed", log_targets: bool = True,
            gumbel=None, generator=None):
    """Sample (or greedily decode) placements of one task on the
    estimated MDP.

    feats: (M, F) normalized, ALREADY sorted descending by predicted
    single-table cost; ``gumbel`` (M, E, D) is the sampling noise (else
    drawn from ``generator``).  Returns (actions (E, M), est_cost (E,)).
    """
    h_pol = N.policy_table_reprs(policy_net, feats[None])
    h_cost = N.cost_table_reprs(cost_net, feats[None])
    actions, _, _, est = _scan_rollout(
        policy_net, cost_net, h_pol, h_cost, sizes[None], cap, n_devices,
        n_episodes, greedy, use_cost, reward_mode=reward_mode,
        log_targets=log_targets, gumbel=gumbel, generator=generator)
    return actions[0], est[0]


# ---- batched (padded) collection ---------------------------------------------

@torch.no_grad()
def collect_batched(policy_net, cost_net, feats, sizes, tmask, dmask, cap,
                    gumbel=None, *, n_episodes: int = 1, greedy: bool = False,
                    use_cost: bool = True, reward_mode: str = "composed",
                    log_targets: bool = True):
    """Sample placements for a whole padded task batch in one call.

    feats (B, M_pad, F) normalized but UNSORTED; sizes/tmask (B, M_pad);
    dmask (B, D_pad); ``gumbel`` (B, M_pad, E, D_pad) each task's own
    sampling noise by decode step (the reference's per-task keys).
    Sorting happens on the device.  Returns (actions (B, E, M_pad) in
    sorted space, est (B, E), order (B, M_pad)) -- invert with
    ``assignment[order[b, :m]] = actions[b, e, :m]``.
    """
    order, feats, sizes, tmask = sort_tables(cost_net, feats, sizes, tmask)
    h_pol = N.policy_table_reprs(policy_net, feats)
    h_cost = N.cost_table_reprs(cost_net, feats)
    actions, _, _, est = _scan_rollout(
        policy_net, cost_net, h_pol, h_cost, sizes, cap, dmask.shape[-1],
        n_episodes, greedy, use_cost, reward_mode=reward_mode,
        log_targets=log_targets, tmask=tmask, dmask=dmask,
        gumbel=None if gumbel is None else gumbel.transpose(0, 1))
    return actions, est, order


# ---- REINFORCE on the estimated MDP (Eq. 2) ----------------------------------

def _rl_loss(policy_net, cost_net, feats, sizes, cap, gumbel, n_devices,
             n_episodes, w_entropy, use_cost, reward_mode="composed",
             log_targets=True, tmask=None, dmask=None):
    """REINFORCE loss of E sampled episodes of one task (feats (M, F),
    sorted; ``gumbel`` (M, E, D)), with the mean reward as baseline and an
    entropy bonus.  The reward is detached, and the cost network is read
    with no gradient.  Returns (loss, reward (E,))."""
    h_pol = N.policy_table_reprs(policy_net, feats[None])
    with torch.no_grad():
        h_cost = N.cost_table_reprs(cost_net, feats[None])
    _, sum_logp, sum_ent, est_cost = _scan_rollout(
        policy_net, cost_net, h_pol, h_cost, sizes[None], cap, n_devices,
        n_episodes, False, use_cost, reward_mode=reward_mode,
        log_targets=log_targets, tmask=None if tmask is None else tmask[None],
        dmask=dmask, gumbel=gumbel)
    reward = -est_cost[0].detach()                                # (E,)
    baseline = reward.mean()
    adv = reward - baseline
    loss = -(adv * sum_logp[0]).mean() - w_entropy * sum_ent[0].mean()
    return loss, reward


def _policy_step(optimizer, policy_net, opt_state, loss):
    """One optimizer step of the policy network on ``loss``."""
    params = list(policy_net.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    upd, opt_state = optimizer.update(grads, opt_state, params)
    apply_updates(params, upd)
    return opt_state


def make_rl_update(optimizer, *, n_devices, n_episodes, w_entropy=1e-3,
                   use_cost=True, reward_mode="composed", log_targets=True):
    """A REINFORCE update step bound to one (D, E) shape:
    ``update(policy_net, opt_state, cost_net, feats, sizes, cap, gumbel)
    -> (policy_net, opt_state, loss, reward)``, the policy updated in
    place."""

    def update(policy_net, opt_state, cost_net, feats, sizes, cap, gumbel):
        loss, reward = _rl_loss(policy_net, cost_net, feats, sizes, cap,
                                gumbel, n_devices, n_episodes, w_entropy,
                                use_cost, reward_mode, log_targets)
        opt_state = _policy_step(optimizer, policy_net, opt_state, loss)
        return policy_net, opt_state, loss.detach(), reward

    return update


def make_fused_rl_update(optimizer, *, n_episodes, w_entropy=1e-3,
                         use_cost=True, reward_mode="composed",
                         log_targets=True):
    """REINFORCE over a whole padded task batch in one call.

    ``update(policy_net, opt_state, cost_net, feats (B, M_pad, F), sizes,
    tmask, dmask (B, D_pad), cap, gumbel (B, M_pad, E, D_pad))`` runs B
    sequential update steps, one pre-sampled task each, with no host sync
    between them.  Tables are padded to M_pad (tmask) and devices to
    D_pad (dmask: padding devices illegal), so one function serves every
    task shape of the training set.  Each step re-sorts its task by
    predicted single-table cost (the cost network is frozen during the
    policy stage, so this matches the per-step path).  Returns
    (policy_net, opt_state, losses (B,), mean rewards (B,)) on the
    device.
    """

    def update(policy_net, opt_state, cost_net, feats, sizes, tmask, dmask,
               cap, gumbel):
        n_devices = dmask.shape[-1]
        losses, rewards = [], []
        for b in range(feats.shape[0]):
            _, f, s, tm = sort_tables(cost_net, feats[b], sizes[b], tmask[b])
            loss, reward = _rl_loss(
                policy_net, cost_net, f, s, cap, gumbel[b], n_devices,
                n_episodes, w_entropy, use_cost, reward_mode, log_targets,
                tm, dmask[b])
            opt_state = _policy_step(optimizer, policy_net, opt_state, loss)
            losses.append(loss.detach())
            rewards.append(reward.mean())
        return (policy_net, opt_state, torch.stack(losses),
                torch.stack(rewards))

    return update


# ---- replayed-actions log-prob (REINFORCE with external rewards) -------------

def replay_logp(policy_net, cost_net, feats, sizes, cap, actions, *,
                n_devices: int, use_cost: bool = True):
    """Sum log pi(a_t|s_t) and entropy for fixed action sequences (E, M)
    of one task (feats (M, F), sorted).  Returns (sum_logp (E,), sum_ent
    (E,)), differentiable in the policy network."""
    h_pol = N.policy_table_reprs(policy_net, feats[None])
    with torch.no_grad():
        h_cost = N.cost_table_reprs(cost_net, feats[None])
    actions = torch.as_tensor(actions, device=feats.device).long()
    _, sum_logp, sum_ent, _ = _scan_rollout(
        policy_net, cost_net, h_pol, h_cost, sizes[None], cap, n_devices,
        actions.shape[0], False, use_cost, actions_in=actions[None])
    return sum_logp[0], sum_ent[0]
