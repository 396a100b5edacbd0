"""The port's estimated-MDP rollouts against the JAX package's.

Converted weights, the same normalized DLRM features.  Greedy decodes
must take identical actions and estimate costs within 1e-5 (relative);
sampled decodes must take identical actions when the port is fed the
Gumbel noise that JAX draws (``split`` per step from the key).  The
training half -- replayed log-probabilities, the REINFORCE loss and its
policy gradient, batched collection and the fused RL update -- must match
within 1e-5 on fixed actions and on sampled rollouts fed JAX's noise, and
the cost network must get no gradient from the RL loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as JF
from repro.core import networks as JN
from repro.core import rollout as JR
from repro.data.synthetic import make_dlrm_pool
from repro_torch.core import networks as N
from repro_torch.core import rollout as R

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)

M, D = 12, 4


@pytest.fixture(scope="module")
def setup():
    jcost = jax.tree.map(np.asarray, JN.cost_net_init(jax.random.PRNGKey(3)))
    jpol = jax.tree.map(np.asarray, JN.policy_net_init(jax.random.PRNGKey(4)))
    raw = make_dlrm_pool(seed=0)[:M]
    feats = JF.normalize_features(raw)
    sizes = raw[:, JF.TABLE_SIZE_GB].astype(np.float32)
    return dict(jcost=jcost, jpol=jpol, cost=N.params_from_jax(jcost),
                pol=N.params_from_jax(jpol), feats=feats, sizes=sizes)


def jax_gumbel(steps: int, E: int, n_dev: int, key=None) -> np.ndarray:
    """JAX's sampling noise: the key (default PRNGKey(1)) split per step,
    then a Gumbel draw of the logits' shape (E, D)."""
    k = jax.random.PRNGKey(1) if key is None else key
    out = []
    for _ in range(steps):
        k, ks = jax.random.split(k)
        out.append(np.asarray(jax.random.gumbel(ks, (E, n_dev))))
    return np.stack(out)


def _pad(s, mode):
    """Inputs of one decode: (feats, sizes, tmask, dmask, n_devices)."""
    feats, sizes = s["feats"], s["sizes"]
    tmask = dmask = None
    n_dev = D
    if mode == "tmask":
        feats = np.concatenate([feats, np.zeros((4, 21), np.float32)])
        sizes = np.concatenate([sizes, np.zeros(4, np.float32)])
        tmask = np.r_[np.ones(M), np.zeros(4)].astype(np.float32)
    elif mode == "dmask":
        n_dev = D + 2
        dmask = np.r_[np.ones(D), np.zeros(2)].astype(np.float32)
    return feats, sizes, tmask, dmask, n_dev


def _both(s, mode, cap, E, greedy, use_cost=True, reward_mode="composed",
          log_targets=True, gumbel=None):
    feats, sizes, tmask, dmask, n_dev = _pad(s, mode)
    jh_pol = JN.policy_table_reprs(s["jpol"], jnp.asarray(feats))
    jh_cost = JN.cost_table_reprs(s["jcost"], jnp.asarray(feats))
    ja, _, _, jest = JR._scan_rollout(
        s["jpol"], s["jcost"], jh_pol, jh_cost, jnp.asarray(sizes), cap,
        jax.random.PRNGKey(1), n_dev, E, greedy, use_cost,
        reward_mode=reward_mode, log_targets=log_targets,
        tmask=None if tmask is None else jnp.asarray(tmask),
        dmask=None if dmask is None else jnp.asarray(dmask))
    f = torch.as_tensor(feats)[None]
    with torch.no_grad():
        a, _, _, est = R._scan_rollout(
            s["pol"], s["cost"], N.policy_table_reprs(s["pol"], f),
            N.cost_table_reprs(s["cost"], f), torch.as_tensor(sizes)[None],
            cap, n_dev, E, greedy, use_cost, reward_mode=reward_mode,
            log_targets=log_targets,
            tmask=None if tmask is None else torch.as_tensor(tmask)[None],
            dmask=None if dmask is None else torch.as_tensor(dmask),
            gumbel=None if gumbel is None else torch.as_tensor(gumbel))
    return (a[0].numpy(), est[0].numpy()), (np.asarray(ja), np.asarray(jest))


CAPS = {"loose": 11.0, "tight": None, "none_legal": 0.0}


def _cap(s, name):
    cap = CAPS[name]
    return float(s["sizes"].sum() / D * 1.05) if cap is None else cap


@pytest.mark.parametrize("mode", ["plain", "tmask", "dmask"])
@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("reward_mode", ["composed", "head"])
def test_greedy_decode_matches(setup, mode, cap, reward_mode):
    (a, est), (ja, jest) = _both(setup, mode, _cap(setup, cap), 1, True,
                                 reward_mode=reward_mode)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_allclose(est, jest, rtol=1e-5)
    assert ((a >= 0) & (a < D)).all()           # never a padding device


@pytest.mark.parametrize("use_cost,log_targets",
                         [(False, True), (True, False)])
def test_greedy_decode_matches_without_cost_or_log(setup, use_cost,
                                                   log_targets):
    (a, est), (ja, jest) = _both(setup, "plain", 11.0, 1, True,
                                 use_cost=use_cost, log_targets=log_targets)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_allclose(est, jest, rtol=1e-5, atol=1e-6)


def test_tmask_padding_decodes_like_the_unpadded_task(setup):
    (a, _), _ = _both(setup, "plain", 11.0, 1, True)
    (ap, _), _ = _both(setup, "tmask", 11.0, 1, True)
    np.testing.assert_array_equal(ap[:, :M], a)


def test_categorical_is_argmax_plus_gumbel():
    """The identity the sampled-decode parity rests on (jax.random)."""
    logits = jnp.asarray(np.random.default_rng(0).normal(size=(7, 5)),
                         jnp.float32)
    k = jax.random.PRNGKey(1)
    for _ in range(20):
        k, ks = jax.random.split(k)
        np.testing.assert_array_equal(
            np.asarray(jax.random.categorical(ks, logits, axis=-1)),
            np.asarray(jnp.argmax(
                logits + jax.random.gumbel(ks, logits.shape), axis=-1)))


@pytest.mark.parametrize("mode", ["plain", "tmask", "dmask"])
@pytest.mark.parametrize("cap", ["loose", "tight"])
def test_sampled_decode_fed_jax_noise_matches(setup, mode, cap):
    E = 6
    n_dev = _pad(setup, mode)[4]
    steps = M + (4 if mode == "tmask" else 0)
    (a, est), (ja, jest) = _both(setup, mode, _cap(setup, cap), E, False,
                                 gumbel=jax_gumbel(steps, E, n_dev))
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_allclose(est, jest, rtol=1e-5)
    assert len({tuple(r) for r in a}) > 1          # the noise did sample


@pytest.mark.parametrize("mode", ["plain", "tmask", "dmask"])
def test_decode_path_skips_the_log_probabilities(setup, mode):
    """Under ``no_grad`` with no replayed actions the sums are zeros and
    the actions and estimates are those of the tracked rollout, whose
    sums match the reference's."""
    E = 6
    feats, sizes, tmask, dmask, n_dev = _pad(setup, mode)
    g = jax_gumbel(len(sizes), E, n_dev)
    cap = _cap(setup, "tight")
    f = torch.as_tensor(feats)[None]
    kw = dict(tmask=None if tmask is None else torch.as_tensor(tmask)[None],
              dmask=None if dmask is None else torch.as_tensor(dmask),
              gumbel=torch.as_tensor(g))
    pol, cost = setup["pol"], setup["cost"]

    def scan():
        return R._scan_rollout(
            pol, cost, N.policy_table_reprs(pol, f),
            N.cost_table_reprs(cost, f), torch.as_tensor(sizes)[None], cap,
            n_dev, E, False, True, **kw)
    tracked = scan()
    with torch.no_grad():
        decoded = scan()
    np.testing.assert_array_equal(decoded[0].numpy(), tracked[0].numpy())
    np.testing.assert_array_equal(decoded[3].numpy(),
                                  tracked[3].detach().numpy())
    assert not decoded[1].any() and not decoded[2].any()
    jh_pol = JN.policy_table_reprs(setup["jpol"], jnp.asarray(feats))
    jh_cost = JN.cost_table_reprs(setup["jcost"], jnp.asarray(feats))
    _, jlogp, jent, _ = JR._scan_rollout(
        setup["jpol"], setup["jcost"], jh_pol, jh_cost, jnp.asarray(sizes),
        cap, jax.random.PRNGKey(1), n_dev, E, False, True,
        tmask=None if tmask is None else jnp.asarray(tmask),
        dmask=None if dmask is None else jnp.asarray(dmask))
    np.testing.assert_allclose(tracked[1][0].detach().numpy(),
                               np.asarray(jlogp), rtol=1e-5)
    np.testing.assert_allclose(tracked[2][0].detach().numpy(),
                               np.asarray(jent), rtol=1e-5)


def test_decode_candidates_matches(setup):
    k = 8
    jcap = _cap(setup, "tight")
    ja, jest = JR.decode_candidates(
        setup["jpol"], setup["jcost"], jnp.asarray(setup["feats"]),
        jnp.asarray(setup["sizes"]), jcap, n_devices=D, n_candidates=k)
    a, est = R.decode_candidates(
        setup["pol"], setup["cost"], torch.as_tensor(setup["feats"]),
        torch.as_tensor(setup["sizes"]), jcap, n_devices=D, n_candidates=k,
        gumbel=torch.as_tensor(jax_gumbel(M, k - 1, D)))
    assert tuple(a.shape) == (k, M) and tuple(est.shape) == (k,)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(est.numpy(), np.asarray(jest), rtol=1e-5)


def test_batched_decode_equals_per_task_decode(setup):
    """Step t's noise is shared by the batch and independent of the padded
    table count, so a padded batch decodes as each task alone."""
    cap = _cap(setup, "tight")
    lens = [M, M - 3, M - 7]
    m_pad = 16
    feats = np.zeros((4, m_pad, 21), np.float32)
    sizes = np.zeros((4, m_pad), np.float32)
    tmask = np.zeros((4, m_pad), np.float32)
    for b, m in enumerate(lens):
        feats[b, :m] = setup["feats"][:m]
        sizes[b, :m] = setup["sizes"][:m]
        tmask[b, :m] = 1.0
    a, est = R.decode_candidates(
        setup["pol"], setup["cost"], torch.as_tensor(feats),
        torch.as_tensor(sizes), cap, n_devices=D, n_candidates=16,
        tmask=torch.as_tensor(tmask))
    for b, m in enumerate(lens):
        a1, est1 = R.decode_candidates(
            setup["pol"], setup["cost"],
            torch.as_tensor(setup["feats"][:m]),
            torch.as_tensor(setup["sizes"][:m]), cap, n_devices=D,
            n_candidates=16)
        np.testing.assert_array_equal(a[b, :, :m].numpy(), a1.numpy())
        np.testing.assert_allclose(est[b].numpy(), est1.numpy(), rtol=1e-6)


def test_sort_tables_matches(setup):
    rng = np.random.default_rng(0)
    feats = np.zeros((3, 16, 21), np.float32)
    sizes = np.zeros((3, 16), np.float32)
    tmask = np.zeros((3, 16), np.float32)
    for b, m in enumerate([M, 9, 5]):
        perm = rng.permutation(M)[:m]
        feats[b, :m] = setup["feats"][perm]
        sizes[b, :m] = setup["sizes"][perm]
        tmask[b, :m] = 1.0
    out = R.sort_tables(setup["cost"], *map(torch.as_tensor,
                                            (feats, sizes, tmask)))
    ref = JR.sort_tables(setup["jcost"], *map(jnp.asarray,
                                              (feats, sizes, tmask)))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("with_dmask", [False, True])
def test_legal_mask_matches(with_dmask):
    rng = np.random.default_rng(1)
    mem = rng.uniform(0, 1, (5, 4)).astype(np.float32)
    mem[0] = 2.0                                    # no legal device
    dmask = np.array([1, 1, 1, 0], np.float32) if with_dmask else None
    out = R._legal_mask(torch.as_tensor(mem), torch.tensor(0.25), 1.0,
                        None if dmask is None else torch.as_tensor(dmask))
    ref = JR._legal_mask(jnp.asarray(mem), jnp.float32(0.25), 1.0,
                         None if dmask is None else jnp.asarray(dmask))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("reward_mode", ["composed", "head"])
@pytest.mark.parametrize("log_targets", [True, False])
def test_estimate_overall_matches(setup, reward_mode, log_targets):
    dev = np.random.default_rng(2).normal(size=(3, 5, 32)).astype(np.float32)
    dmask = np.array([1, 1, 1, 1, 0], np.float32)
    for m in (None, dmask):
        out = R.estimate_overall(
            setup["cost"], torch.as_tensor(dev), reward_mode, log_targets,
            None if m is None else torch.as_tensor(m))
        ref = JR.estimate_overall(
            setup["jcost"], jnp.asarray(dev), reward_mode, log_targets,
            None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)


# ---- the training half ---------------------------------------------------------

def _jax_tree_grads(net) -> dict:
    """The port's gradients in the reference's pytree layout."""
    return {name: [{"w": layer.weight.grad.numpy().T, "b":
                    layer.bias.grad.numpy()} for layer in mlp.layers]
            for name, mlp in net.named_children()}


def _fresh(s):
    return N.params_from_jax(s["jpol"]), N.params_from_jax(s["jcost"])


def _assert_tree_close(got, ref, rtol):
    """Leaf by leaf within ``rtol`` of the reference, relative to the
    largest entry of the whole tree (a leaf whose gradient cancels to
    ~0 is held at the tree's scale, not at its own rounding noise)."""
    scale = max(float(np.abs(np.asarray(r)).max())
                for r in jax.tree.leaves(ref))
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(g, np.asarray(r), rtol=rtol,
                                   atol=rtol * scale)


# leaves whose exact policy gradient is zero: each adds the same amount
# to every device's logit, and the softmax is shift-invariant.  Both
# packages' gradients there are rounding noise (~1e-8), which Adam turns
# into steps of +-lr, so they are held by what they change -- nothing --
# not by their values.
SHIFT_INVARIANT = {"['cost_mlp'][1]['b']", "['head'][0]['b']"}


def _assert_policy_close(s, pol, jp, rtol=1e-5):
    """Updated policies: the leaves with a real gradient within ``rtol``
    (at the tree's scale), and the same log-probabilities and entropies
    of fixed actions (which also covers the shift-invariant leaves)."""
    got = N.params_to_jax(pol)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    keep = [k for k, (path, _) in enumerate(flat)
            if jax.tree_util.keystr(path) not in SHIFT_INVARIANT]
    assert len(keep) == len(flat) - len(SHIFT_INVARIANT)
    leaves, ref = jax.tree.leaves(got), [leaf for _, leaf in flat]
    _assert_tree_close([leaves[k] for k in keep], [ref[k] for k in keep],
                       rtol)
    acts = _fixed_actions(4, seed=9)
    cap = _cap(s, "tight")
    jl, je = JR.replay_logp(jp, s["jcost"], jnp.asarray(s["feats"]),
                            jnp.asarray(s["sizes"]), cap, jnp.asarray(acts),
                            n_devices=D)
    with torch.no_grad():
        lp, ent = R.replay_logp(pol, N.params_from_jax(s["jcost"]),
                                torch.as_tensor(s["feats"]),
                                torch.as_tensor(s["sizes"]), cap, acts,
                                n_devices=D)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jl), rtol=rtol)
    np.testing.assert_allclose(ent.numpy(), np.asarray(je), rtol=rtol)


def _fixed_actions(E, seed=0):
    return np.random.default_rng(seed).integers(0, D, (E, M))


@pytest.mark.parametrize("use_cost", [True, False])
def test_replay_logp_matches(setup, use_cost):
    acts = _fixed_actions(5)
    cap = _cap(setup, "tight")
    jl, je = JR.replay_logp(setup["jpol"], setup["jcost"],
                            jnp.asarray(setup["feats"]),
                            jnp.asarray(setup["sizes"]), cap,
                            jnp.asarray(acts), n_devices=D,
                            use_cost=use_cost)
    pol, cost = _fresh(setup)
    lp, ent = R.replay_logp(pol, cost, torch.as_tensor(setup["feats"]),
                            torch.as_tensor(setup["sizes"]), cap, acts,
                            n_devices=D, use_cost=use_cost)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jl),
                               rtol=1e-5)
    np.testing.assert_allclose(ent.detach().numpy(), np.asarray(je),
                               rtol=1e-5)

    def jloss(p):
        lp_, ent_ = JR.replay_logp(p, setup["jcost"],
                                   jnp.asarray(setup["feats"]),
                                   jnp.asarray(setup["sizes"]), cap,
                                   jnp.asarray(acts), n_devices=D,
                                   use_cost=use_cost)
        return jnp.sum(lp_ * jnp.arange(1.0, 6.0)) + jnp.sum(ent_)
    jg = jax.grad(jloss)(setup["jpol"])
    ((lp * torch.arange(1.0, 6.0)).sum() + ent.sum()).backward()
    _assert_tree_close(_jax_tree_grads(pol), jg, 1e-5)


def _rl_both(s, E, key, mode="plain", w_entropy=1e-3, reward_mode="composed"):
    feats, sizes, tmask, dmask, n_dev = _pad(s, mode)
    steps = feats.shape[0]
    cap = _cap(s, "tight")
    jargs = (jnp.asarray(feats), jnp.asarray(sizes), cap, key, n_dev, E,
             w_entropy, True, reward_mode, True,
             None if tmask is None else jnp.asarray(tmask),
             None if dmask is None else jnp.asarray(dmask))
    (jloss, jrew), jg = jax.value_and_grad(JR._rl_loss, has_aux=True)(
        s["jpol"], s["jcost"], *jargs)
    pol, cost = _fresh(s)
    loss, rew = R._rl_loss(
        pol, cost, torch.as_tensor(feats), torch.as_tensor(sizes), cap,
        torch.as_tensor(jax_gumbel(steps, E, n_dev, key)), n_dev, E,
        w_entropy, True, reward_mode, True,
        None if tmask is None else torch.as_tensor(tmask),
        None if dmask is None else torch.as_tensor(dmask))
    loss.backward()
    return (loss, rew, pol, cost), (jloss, jrew, jg)


@pytest.mark.parametrize("mode", ["plain", "tmask", "dmask"])
@pytest.mark.parametrize("reward_mode", ["composed", "head"])
def test_reinforce_loss_and_gradient_match_on_jax_noise(setup, mode,
                                                        reward_mode):
    (loss, rew, pol, cost), (jloss, jrew, jg) = _rl_both(
        setup, 6, jax.random.PRNGKey(7), mode, reward_mode=reward_mode)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jrew).max()))
    _assert_tree_close(_jax_tree_grads(pol), jg, 1e-5)


def test_rl_loss_gives_the_cost_net_no_gradient(setup):
    (_, _, pol, cost), _ = _rl_both(setup, 4, jax.random.PRNGKey(3))
    assert all(p.grad is None for p in cost.parameters())
    assert all(p.grad is not None for p in pol.parameters())


def test_reinforce_gradient_for_fixed_actions(setup):
    """REINFORCE with external rewards on replayed actions: the gradient
    of -mean(adv * sum log pi) matches the reference's."""
    acts = _fixed_actions(6, seed=3)
    adv = np.random.default_rng(4).normal(size=6).astype(np.float32)
    cap = _cap(setup, "loose")

    def jloss(p):
        lp, _ = JR.replay_logp(p, setup["jcost"], jnp.asarray(setup["feats"]),
                               jnp.asarray(setup["sizes"]), cap,
                               jnp.asarray(acts), n_devices=D)
        return -jnp.mean(jnp.asarray(adv) * lp)
    jl, jg = jax.value_and_grad(jloss)(setup["jpol"])
    pol, cost = _fresh(setup)
    lp, _ = R.replay_logp(pol, cost, torch.as_tensor(setup["feats"]),
                          torch.as_tensor(setup["sizes"]), cap, acts,
                          n_devices=D)
    loss = -(torch.as_tensor(adv) * lp).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _assert_tree_close(_jax_tree_grads(pol), jg, 1e-5)
    assert all(p.grad is None for p in cost.parameters())


def _task_batch(s, lens, m_pad=16, seed=0):
    rng = np.random.default_rng(seed)
    B = len(lens)
    feats = np.zeros((B, m_pad, 21), np.float32)
    sizes = np.zeros((B, m_pad), np.float32)
    tmask = np.zeros((B, m_pad), np.float32)
    for b, m in enumerate(lens):
        perm = rng.permutation(M)[:m]
        feats[b, :m] = s["feats"][perm]
        sizes[b, :m] = s["sizes"][perm]
        tmask[b, :m] = 1.0
    return feats, sizes, tmask


def test_collect_batched_matches_on_jax_keys(setup):
    lens, devs, d_pad, E = [M, 9, 5], [4, 2, 3], 4, 2
    feats, sizes, tmask = _task_batch(setup, lens)
    dmask = np.zeros((3, d_pad), np.float32)
    for b, d in enumerate(devs):
        dmask[b, :d] = 1.0
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    cap = _cap(setup, "tight")
    ja, jest, jorder = JR.collect_batched(
        setup["jpol"], setup["jcost"], jnp.asarray(feats),
        jnp.asarray(sizes), jnp.asarray(tmask), jnp.asarray(dmask), cap,
        keys, n_episodes=E)
    noise = np.stack([jax_gumbel(16, E, d_pad, k) for k in keys])
    a, est, order = R.collect_batched(
        setup["pol"], setup["cost"], *map(torch.as_tensor,
                                          (feats, sizes, tmask, dmask)),
        cap, torch.as_tensor(noise), n_episodes=E)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(est.numpy(), np.asarray(jest), rtol=1e-5)
    for b, d in enumerate(devs):
        assert a[b, :, :lens[b]].max() < d       # never a padding device


def test_fused_rl_update_matches_on_jax_keys(setup):
    """Four sequential REINFORCE steps over a padded batch of tasks with
    different table and device counts, each re-sorted by predicted
    cost, with Adam's linear-decay schedule."""
    from repro import optim as jopt
    from repro_torch import optim as opt
    lens, devs, d_pad, E = [M, 9, 5, 10], [4, 2, 3, 4], 4, 5
    feats, sizes, tmask = _task_batch(setup, lens, seed=1)
    dmask = np.zeros((4, d_pad), np.float32)
    for b, d in enumerate(devs):
        dmask[b, :d] = 1.0
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    cap = _cap(setup, "tight")
    jo = jopt.adam(jopt.linear_decay(1e-2, 10))
    upd = JR.make_fused_rl_update(jo, n_episodes=E)
    jp, _, jl, jr = upd(jax.tree.map(jnp.asarray, setup["jpol"]),
                        jo.init(setup["jpol"]), setup["jcost"],
                        jnp.asarray(feats), jnp.asarray(sizes),
                        jnp.asarray(tmask), jnp.asarray(dmask), cap, keys)
    o = opt.adam(opt.linear_decay(1e-2, 10))
    pol, cost = _fresh(setup)
    noise = np.stack([jax_gumbel(16, E, d_pad, k) for k in keys])
    _, state, losses, rewards = R.make_fused_rl_update(o, n_episodes=E)(
        pol, o.init(list(pol.parameters())), cost,
        *map(torch.as_tensor, (feats, sizes, tmask, dmask)), cap,
        torch.as_tensor(noise))
    assert state.step == 4
    np.testing.assert_allclose(rewards.numpy(), np.asarray(jr), rtol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jr).max()))
    _assert_policy_close(setup, pol, jp)
    assert all(p.grad is None for p in cost.parameters())


def test_make_rl_update_matches_on_jax_noise(setup):
    from repro import optim as jopt
    from repro_torch import optim as opt
    cap, E, key = _cap(setup, "loose"), 4, jax.random.PRNGKey(9)
    jo = jopt.adam(3e-3)
    jp, _, jl, jr = JR.make_rl_update(jo, n_devices=D, n_episodes=E)(
        setup["jpol"], jo.init(setup["jpol"]), setup["jcost"],
        jnp.asarray(setup["feats"]), jnp.asarray(setup["sizes"]), cap, key)
    o = opt.adam(3e-3)
    pol, cost = _fresh(setup)
    _, _, loss, rew = R.make_rl_update(o, n_devices=D, n_episodes=E)(
        pol, o.init(list(pol.parameters())), cost,
        torch.as_tensor(setup["feats"]), torch.as_tensor(setup["sizes"]),
        cap, torch.as_tensor(jax_gumbel(M, E, D, key)))
    np.testing.assert_allclose(rew.numpy(), np.asarray(jr), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jr).max()))
    _assert_policy_close(setup, pol, jp)


def test_rollout_matches(setup):
    cap, E, key = _cap(setup, "tight"), 3, jax.random.PRNGKey(2)
    ja, jest = JR.rollout(setup["jpol"], setup["jcost"],
                          jnp.asarray(setup["feats"]),
                          jnp.asarray(setup["sizes"]), cap, key,
                          n_devices=D, n_episodes=E)
    a, est = R.rollout(setup["pol"], setup["cost"],
                       torch.as_tensor(setup["feats"]),
                       torch.as_tensor(setup["sizes"]), cap, n_devices=D,
                       n_episodes=E,
                       gumbel=torch.as_tensor(jax_gumbel(M, E, D, key)))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(est.numpy(), np.asarray(jest), rtol=1e-5)
