"""Estimated-MDP decoding (paper §3.1/3.3, Algorithm 2): the decode half
of ``repro/core/rollout.py``.

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
cost network's reading of the final device sums.

The reference's ``lax.scan`` over tables is a Python loop here, and its
``vmap`` over tasks is the leading batch dimension ``B``.  The Gumbel
noise is drawn one step at a time as an ``(E, D)`` tensor shared by every
task of the batch, as the reference splits its key per step and hands
every task of a vmapped bucket the same key: step t's noise then depends
on neither the batch size nor the padded table count, so a padded batch
decodes exactly as its tasks do one by one.

Training (the RL loss, fused updates, ``collect_batched``,
``replay_logp``) waits for the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.core import networks as N

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
                  n_devices, n_episodes, greedy, use_cost,
                  reward_mode="composed", log_targets=True, tmask=None,
                  dmask=None, gumbel=None, generator=None):
    """Decode E episodes for each of B tasks, one table per step.

    h_pol / h_cost (B, M, H) table reprs in decode order; sizes (B, M).
    ``tmask`` (B, M) marks valid tables (1.0) vs padding rows (0.0):
    padded steps still run but add nothing to the device sums or memory,
    so a task padded to a bucket shape decodes to exactly the placement
    of its unpadded rollout.  ``dmask`` (B, D) or (D,) marks real
    devices: padding devices score NEG, stay out of the legality
    fallback and cannot win the device-max of the estimated cost.

    Sampled episodes (``greedy=False``) take step t's Gumbel noise from
    ``gumbel[t]`` (``gumbel`` of shape (M, E, D)) when it is given, else
    draw it from ``generator``.  Returns (actions (B, E, M) int64,
    est_cost (B, E)).
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
    actions = []
    for t in range(M):
        q = N.cost_device_heads(cost_net, dev_cost) if use_cost else no_cost
        logits = N.policy_logits(policy_net, dev_pol, q, dmask)  # (B,E,D)
        size_t = sizes[:, t, None, None]
        legal = _legal_mask(mem, size_t, cap, dmask)
        logits = torch.where(legal, logits, NEG)
        if not greedy:
            noise = gumbel[t] if gumbel is not None else \
                gumbel_noise((E, D), generator, dev)
            logits = logits + noise.to(dtype)
        a = logits.argmax(dim=-1)                                  # (B,E)
        onehot = torch.nn.functional.one_hot(a, D).to(dtype)       # (B,E,D)
        if tmask is not None:           # zero padded rows' contributions
            onehot = onehot * tmask[:, t, None, None]
        dev_pol = dev_pol + onehot[..., None] * h_pol[:, t, None, None, :]
        dev_cost = dev_cost + onehot[..., None] * h_cost[:, t, None, None, :]
        mem = mem + onehot * size_t
        actions.append(a)
    acts = torch.stack(actions, dim=-1) if actions else \
        torch.zeros((B, E, 0), dtype=torch.int64, device=dev)
    if use_cost:
        est = estimate_overall(cost_net, dev_cost, reward_mode, log_targets,
                               dmask=dmask)
    else:   # no cost network: no estimate available
        est = torch.zeros((B, E), dtype=dtype, device=dev)
    return acts, est


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
    a, est = _scan_rollout(policy_net, cost_net, h_pol, h_cost, sizes, cap,
                           n_devices, 1, True, use_cost, **common)
    if n_candidates > 1:
        generator = None
        if gumbel is None:
            generator = torch.Generator(device=feats.device)
            generator.manual_seed(1)
        a2, est2 = _scan_rollout(
            policy_net, cost_net, h_pol, h_cost, sizes, cap, n_devices,
            n_candidates - 1, False, use_cost, gumbel=gumbel,
            generator=generator, **common)
        a = torch.cat([a, a2], dim=1)
        est = torch.cat([est, est2], dim=1)
    if single:
        return a[0], est[0]
    return a, est


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
