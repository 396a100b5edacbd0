"""The port's RNN baseline (App. D.2) against the JAX package's, on the CPU.

Converted weights and the same normalized DLRM features.  The LSTM, the
causal attention and the table reprs agree within 1e-5; the rollout over
external reprs takes the reference's actions greedily, on JAX's Gumbel
draws and with padding, and its replayed log-probabilities, entropies and
estimated costs agree within 1e-5; the REINFORCE gradient agrees within
1e-4 relative per leaf.  Three training updates fed each update's JAX
noise draw the same tasks, take the same actions, get the same rewards and
end within 1e-4 of the reference's parameters.  The budget (one batched
oracle pass of ``n_episode`` rows per update), the adapter, the weight
conversion and the ``cuda`` default are held as the reference holds them.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.rnn_policy as JRP
from repro.api import SimOracle as JSimOracle
from repro.core import features as JF
from repro.core import networks as JN
from repro.core import rollout as JR
from repro.data.synthetic import make_dlrm_pool
from repro.data.tasks import make_benchmark_suite
from repro_torch import telemetry as tele
from repro_torch.api import SimOracle
from repro_torch.core import networks as N
from repro_torch.core import rnn_policy as RP
from repro_torch.core import rollout as R
from repro_torch.data.tasks import Task

M, D, CAP = 20, 4, 11.0


def _tree(x):
    return jax.tree.map(np.asarray, x)


@pytest.fixture(scope="module")
def setup():
    tree = _tree(JRP.rnn_policy_init(jax.random.PRNGKey(5)))
    raw = make_dlrm_pool(seed=0)[:M]
    feats = JF.normalize_features(raw)
    sizes = raw[:, JF.TABLE_SIZE_GB].astype(np.float32)
    net = RP.rnn_params_from_jax(tree)
    jh = np.asarray(JRP.rnn_table_reprs(tree, jnp.asarray(feats)))
    with torch.no_grad():
        h = RP.rnn_table_reprs(net, torch.as_tensor(feats))
    return dict(tree=tree, net=net, raw=raw, feats=feats, sizes=sizes,
                jh=jh, h=h)


def jax_gumbel(steps: int, E: int, n_dev: int, key) -> np.ndarray:
    """JAX's sampling noise: ``key`` split per step, then a Gumbel draw of
    the logits' shape (E, D)."""
    out = []
    for _ in range(steps):
        key, ks = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(ks, (E, n_dev))))
    return np.stack(out)


def _jax_rollout(s, E, greedy, key=None, actions=None, **kw):
    out = JR.rollout_with_reprs(
        s["tree"], s["tree"], jnp.asarray(s["jh"]), jnp.asarray(s["feats"]),
        jnp.asarray(s["sizes"]), CAP,
        jax.random.PRNGKey(0) if key is None else key, n_devices=D,
        n_episodes=E, greedy=greedy, use_cost=False,
        actions_in=None if actions is None else jnp.asarray(actions), **kw)
    return [np.asarray(x) for x in out]


def _port_rollout(s, E, greedy, **kw):
    with torch.no_grad():
        out = R.rollout_with_reprs(
            s["net"], None, s["h"], torch.as_tensor(s["feats"]),
            torch.as_tensor(s["sizes"]), CAP, n_devices=D, n_episodes=E,
            greedy=greedy, use_cost=False, **kw)
    return [x.numpy() for x in out]


# ---- the networks ----------------------------------------------------------------

def test_lstm_matches_the_reference(setup):
    xs = np.random.default_rng(0).standard_normal((M, N.HIDDEN)).astype(
        np.float32)
    ref = np.asarray(JRP.lstm_apply(setup["tree"]["lstm"], jnp.asarray(xs)))
    with torch.no_grad():
        out = setup["net"].lstm(torch.as_tensor(xs)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_attention_matches_the_reference(setup):
    hs = np.random.default_rng(1).standard_normal((M, N.HIDDEN)).astype(
        np.float32)
    ref = np.asarray(JRP.attention(jnp.asarray(hs)))
    out = RP.attention(torch.as_tensor(hs)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_rnn_table_reprs_match_the_reference(setup):
    np.testing.assert_allclose(setup["h"].numpy(), setup["jh"], rtol=1e-5,
                               atol=1e-5)


def test_params_round_trip_bitwise(setup):
    back = RP.rnn_params_to_jax(setup["net"])
    flat, ref = jax.tree.leaves(back), jax.tree.leaves(setup["tree"])
    assert jax.tree.structure(back) == jax.tree.structure(setup["tree"])
    for a, b in zip(flat, ref):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_lstm_is_initialised_as_the_reference():
    net = RP.RNNPolicyNet(generator=torch.Generator().manual_seed(0))
    wx, wh = net.lstm.wx.detach(), net.lstm.wh.detach()
    assert wx.shape == wh.shape == (N.HIDDEN, 4 * N.HIDDEN)
    assert not net.lstm.b.detach().any()
    for w in (wx, wh):          # normal x 1/sqrt(H)
        assert abs(float(w.std()) * np.sqrt(N.HIDDEN) - 1.0) < 0.1


# ---- rollout_with_reprs --------------------------------------------------------

def test_greedy_rollout_takes_the_reference_actions(setup):
    ja = _jax_rollout(setup, 1, True)[0]
    a = _port_rollout(setup, 1, True)[0]
    np.testing.assert_array_equal(a, ja)


def test_sampled_rollout_on_jax_noise_takes_the_reference_actions(setup):
    key = jax.random.PRNGKey(9)
    ja = _jax_rollout(setup, 6, False, key=key)[0]
    a = _port_rollout(setup, 6, False, gumbel=torch.as_tensor(
        jax_gumbel(M, 6, D, key)))[0]
    np.testing.assert_array_equal(a, ja)


def test_replayed_logp_and_entropy_match_the_reference(setup):
    actions = np.random.default_rng(2).integers(0, D, (5, M))
    _, jlogp, jent, _ = _jax_rollout(setup, 5, False, actions=actions)
    _, logp, ent, est = _port_rollout(setup, 5, False,
                                      actions_in=torch.as_tensor(actions))
    np.testing.assert_allclose(logp, jlogp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ent, jent, rtol=1e-5, atol=1e-5)
    assert not est.any()                       # no cost net, no estimate


@pytest.mark.parametrize("pad", ["tmask", "dmask", "batch"])
def test_padded_rollout_is_the_unpadded_one(setup, pad):
    key = jax.random.PRNGKey(3)
    noise = torch.as_tensor(jax_gumbel(M + 3, 4, D + 2, key))
    h, feats = setup["h"], torch.as_tensor(setup["feats"])
    sizes = torch.as_tensor(setup["sizes"])
    actions = torch.as_tensor(np.random.default_rng(4).integers(0, D, (4, M)))
    kw = dict(n_episodes=4, use_cost=False)
    ref, ref_replay = [R.rollout_with_reprs(
        setup["net"], None, h, feats, sizes, CAP, n_devices=D,
        gumbel=noise[:M, :, :D], actions_in=a, **kw) for a in (None,
                                                              actions)]
    if pad == "tmask":
        z = torch.zeros(3, h.shape[1])
        args = (torch.cat([h, z]), torch.cat([feats, torch.zeros(3, 21)]),
                torch.cat([sizes, torch.zeros(3)]))
        extra = dict(n_devices=D, tmask=torch.cat([torch.ones(M),
                                                    torch.zeros(3)]))
        g, acts = noise[:, :, :D], torch.cat(
            [actions, torch.zeros(4, 3, dtype=actions.dtype)], dim=1)
    elif pad == "dmask":
        args = (h, feats, sizes)
        extra = dict(n_devices=D + 2, dmask=torch.tensor([1.0] * D
                                                         + [0.0] * 2))
        g, acts = noise[:M], actions
    else:                        # two tasks in one batch share the noise
        args = (torch.stack([h, h]), torch.stack([feats, feats]),
                torch.stack([sizes, sizes]))
        extra = dict(n_devices=D)
        g, acts = noise[:M, :, :D], torch.stack([actions, actions])
    with torch.no_grad():
        out = R.rollout_with_reprs(setup["net"], None, *args, CAP, gumbel=g,
                                   **extra, **kw)
    replay = R.rollout_with_reprs(setup["net"], None, *args, CAP,
                                  actions_in=acts, **extra, **kw)
    if pad == "batch":
        out = [x[1] for x in out]
        replay = [x[1] for x in replay]
    np.testing.assert_array_equal(out[0][..., :M], ref[0])
    for x, y in zip(replay[1:3], ref_replay[1:3]):
        torch.testing.assert_close(x.detach(), y.detach(), rtol=1e-6,
                                   atol=1e-5)


@pytest.mark.parametrize("log_targets", [True, False])
def test_reward_mode_reaches_the_estimate_with_cost(setup, log_targets):
    """``tests/test_fused_trainer.py``'s reward-mode plumbing: with
    ``use_cost=True`` the two modes estimate differently, each as the
    reference does."""
    jpol = _tree(JN.policy_net_init(jax.random.PRNGKey(7)))
    jcost = _tree(JN.cost_net_init(jax.random.PRNGKey(8)))
    pol, cost = N.params_from_jax(jpol), N.params_from_jax(jcost)
    feats = setup["feats"]
    jh = JN.policy_table_reprs(jpol, jnp.asarray(feats))
    with torch.no_grad():
        h = N.policy_table_reprs(pol, torch.as_tensor(feats))
    est = {}
    for mode in ("composed", "head"):
        kw = dict(n_devices=D, n_episodes=2, greedy=True, use_cost=True,
                  reward_mode=mode, log_targets=log_targets)
        ja, _, _, jest = JR.rollout_with_reprs(
            jpol, jcost, jh, jnp.asarray(feats), jnp.asarray(setup["sizes"]),
            100.0, jax.random.PRNGKey(0), **kw)
        with torch.no_grad():
            a, _, _, est[mode] = R.rollout_with_reprs(
                pol, cost, h, torch.as_tensor(feats),
                torch.as_tensor(setup["sizes"]), 100.0, **kw)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_allclose(est[mode].numpy(), np.asarray(jest),
                                   rtol=1e-5, atol=1e-6)
    assert not np.allclose(est["composed"].numpy(), est["head"].numpy())


# ---- the placer ------------------------------------------------------------------

@pytest.fixture(scope="module")
def suite():
    return make_benchmark_suite(make_dlrm_pool(seed=0), n_tables=10,
                                n_devices=2, n_tasks=4)


def _grads_tree(net, grads):
    g = copy.deepcopy(net)
    with torch.no_grad():
        for p, x in zip(g.parameters(), grads):
            p.copy_(x)
    return RP.rnn_params_to_jax(g)


# The cost branch reads zeros, so ``cost_mlp`` and the head's bias shift
# every device's logit alike (``rnn_policy.LOGIT_SHIFT_PARAMS``): their
# gradient is zero but for rounding, on both sides, and Adam turns that
# rounding into steps of up to ``lr`` in either direction.
SHIFT_LEAVES = tuple(
    "['cost_mlp']" + f"[{i}]['{k}']" for i in (0, 1) for k in ("w", "b")) \
    + ("['head'][0]['b']",)


def _leaves(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(out, ref, rtol, shift_atol):
    """Every leaf within ``rtol`` of its largest entry, but the logit
    shifts, which must agree within ``shift_atol``."""
    out, ref = _leaves(out), _leaves(ref)
    assert out.keys() == ref.keys()
    for k, b in ref.items():
        atol = shift_atol if k in SHIFT_LEAVES else \
            rtol * max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(out[k], b, rtol=rtol, atol=atol,
                                   err_msg=k)


def test_reinforce_gradient_matches_the_reference(setup):
    cfg = RP.RNNPolicyConfig()
    jp = JRP.RNNPlacer([], JSimOracle(seed=0), JRP.RNNPolicyConfig())
    actions = np.random.default_rng(5).integers(0, D, (10, M))
    adv = np.random.default_rng(6).standard_normal(10).astype(np.float32)
    jg = _tree(jp._grad_fn(D, 10)(
        setup["tree"], jnp.asarray(setup["feats"]),
        jnp.asarray(setup["sizes"]), CAP, jnp.asarray(actions),
        jnp.asarray(adv), cfg.entropy_weight))
    placer = RP.RNNPlacer([], SimOracle(seed=0), cfg, device="cpu")
    placer.net = RP.rnn_params_from_jax(setup["tree"])
    feats, sizes = placer._inputs(setup["raw"])
    loss = placer.loss(feats, sizes, D, torch.as_tensor(actions),
                       torch.as_tensor(adv))
    grads = torch.autograd.grad(loss, list(placer.net.parameters()))
    assert placer.oracle.mem_capacity_gb == CAP
    scale = max(np.abs(v).max() for v in jax.tree.leaves(jg))
    _assert_trees_close(_grads_tree(placer.net, grads), jg, 1e-4,
                        shift_atol=1e-4 * scale)    # zero but for rounding


class RewardLog:
    """Wraps a module's ``evaluate_many``, recording tasks, actions and
    rewards of each update."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, oracle, raw, actions, n_devices):
        results = self.fn(oracle, raw, actions, n_devices)
        self.calls.append((np.asarray(raw), np.asarray(actions).copy(),
                           np.array([r.overall for r in results])))
        return results


@pytest.fixture(scope="module")
def trained_pair(suite):
    """Three updates of the reference and of the port from the same
    initial weights, the port fed each update's JAX noise."""
    train, _ = suite
    cfg = dict(n_updates=3, n_episode=4, seed=0)
    jp = JRP.RNNPlacer(train, JSimOracle(seed=0), JRP.RNNPolicyConfig(**cfg))
    port = RP.RNNPlacer(train, SimOracle(seed=0), RP.RNNPolicyConfig(**cfg),
                        device="cpu")
    port.net = RP.rnn_params_from_jax(_tree(jp.params))
    port.opt_state = port._opt.init(list(port.net.parameters()))
    keys = []
    next_key = jp._next_key
    jp._next_key = lambda: keys.append(next_key()) or keys[-1]
    mp = pytest.MonkeyPatch()
    logs = {}
    for name, mod in (("ref", JRP), ("port", RP)):
        logs[name] = RewardLog(mod.evaluate_many)
        mp.setattr(mod, "evaluate_many", logs[name])
    try:
        jp.train()
        noise = [torch.as_tensor(jax_gumbel(m, 4, d, k))
                 for k, (m, d) in zip(keys, [(c[0].shape[0], 2)
                                             for c in logs["ref"].calls])]
        port._next_noise = lambda m, d: noise.pop(0)
        port.train()
    finally:
        mp.undo()
    return jp, port, logs


def test_three_updates_on_jax_noise_match_the_reference(trained_pair):
    jp, port, logs = trained_pair
    assert len(logs["port"].calls) == len(logs["ref"].calls) == 3
    for (raw, a, r), (jraw, ja, jr) in zip(logs["port"].calls,
                                           logs["ref"].calls):
        np.testing.assert_array_equal(raw, jraw)     # the same task
        np.testing.assert_array_equal(a, ja)         # the same actions
        np.testing.assert_array_equal(r, jr)         # the same rewards
    steps = port.cfg.n_updates * port.cfg.lr     # Adam's largest moves
    _assert_trees_close(RP.rnn_params_to_jax(port.net), _tree(jp.params),
                        1e-4, shift_atol=2 * steps)


def test_rnn_consumes_one_batched_oracle_pass_per_update(suite):
    """``test_rnn_baseline.py`` / ``test_search.py``'s budget: every
    episode is a measurement, in one ``evaluate_many`` per update."""
    train, test = suite
    tele.reset()
    tele.enable()
    try:
        oracle = SimOracle(seed=0)
        placer = RP.RNNPlacer(train, oracle,
                              RP.RNNPolicyConfig(n_updates=3, n_episode=4),
                              device="cpu")
        placer.train()
        assert oracle.num_evaluations == 3 * 4
        assert tele.counter_value("oracle.sim.evaluate_calls") == 0
        assert tele.counter_value("oracle.sim.evaluate_many_calls") == 3
        assert tele.counter_value("oracle.sim.rows") == 3 * 4
    finally:
        tele.reset()
        tele.disable()
    t = test[0]
    a = placer.place(t.raw_features, 2)
    assert a.shape == (10,) and set(np.unique(a)) <= {0, 1}
    assert oracle.sim.legal(t.raw_features, a, 2)


def test_adapter_places_as_the_placer(trained_pair, suite):
    _, port, _ = trained_pair
    placer = port.as_placer()
    for t in suite[1]:
        p = placer.place(t)
        assert p.strategy == "rnn" and p.n_devices == t.n_devices
        np.testing.assert_array_equal(
            p.assignment, port.place(t.raw_features, t.n_devices))
    assert [q.assignment.tolist() for q in placer.place_many(suite[1])] \
        == [placer.place(t).assignment.tolist() for t in suite[1]]


def test_adapter_matches_the_reference_adapter(trained_pair, suite):
    jp, port, _ = trained_pair
    for t in suite[1]:
        jt = Task.of(t.raw_features, t.n_devices)
        assert port.as_placer().place(jt).assignment.tolist() == \
            jp.as_placer().place(t).assignment.tolist()


def test_rnn_defaults_to_cuda(suite):
    train, _ = suite
    if torch.cuda.is_available():
        placer = RP.RNNPlacer(train, SimOracle(seed=0))
        assert next(placer.net.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RP.RNNPlacer(train, SimOracle(seed=0))

