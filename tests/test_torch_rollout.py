"""The port's estimated-MDP decode against the JAX package's.

Converted weights, the same normalized DLRM features.  Greedy decodes
must take identical actions and estimate costs within 1e-5 (relative);
sampled decodes must take identical actions when the port is fed the
Gumbel noise that JAX draws (``split`` per step from ``PRNGKey(1)``).
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


def jax_gumbel(steps: int, E: int, n_dev: int) -> np.ndarray:
    """JAX's sampling noise: the key split per step from PRNGKey(1), then
    a Gumbel draw of the logits' shape (E, D)."""
    k = jax.random.PRNGKey(1)
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
        a, est = R._scan_rollout(
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
