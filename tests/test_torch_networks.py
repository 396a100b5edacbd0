"""The port's cost and policy networks against the JAX package's, with the
same (converted) weights on the same numpy inputs.  Tolerance 1e-5: both
run float32 matrix products that sum in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import networks as JN
from repro_torch.core import networks as N

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def params():
    jcost = JN.cost_net_init(jax.random.PRNGKey(0))
    jpol = JN.policy_net_init(jax.random.PRNGKey(1))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return to_np(jcost), to_np(jpol)


def _inputs(padded: bool, B=3, M=7, D=4, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, M, 21)).astype(np.float32)
    assign = rng.integers(0, D, (B, M))
    onehot = np.zeros((B, D, M), np.float32)
    for b in range(B):
        onehot[b, assign[b], np.arange(M)] = 1.0
    tmask = dmask = None
    if padded:
        tmask = np.ones((B, M), np.float32)
        tmask[:, -2:] = 0.0
        dmask = np.ones((B, D), np.float32)
        dmask[0, -1] = 0.0
        onehot[0, -1] = 0.0
    return feats, onehot, tmask, dmask


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def test_params_round_trip_bitwise(params):
    for tree in params:
        back = N.params_to_jax(N.params_from_jax(tree))
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = jax.tree_util.tree_leaves_with_path(back)
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (_, a), (_, b) in zip(flat_a, flat_b):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_fresh_modules_have_the_reference_layout(params):
    for tree, net in zip(params, (N.CostNet(), N.PolicyNet())):
        ours = jax.tree.map(np.shape, N.params_to_jax(net))
        assert ours == jax.tree.map(np.shape, tree)


def test_init_is_seeded():
    a = N.params_to_jax(N.CostNet(generator=torch.Generator().manual_seed(3)))
    b = N.params_to_jax(N.CostNet(generator=torch.Generator().manual_seed(3)))
    jax.tree.map(np.testing.assert_array_equal, a, b)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("table_reduction", ["sum", "mean", "max"])
@pytest.mark.parametrize("device_reduction", ["max", "sum", "mean"])
def test_cost_net_apply_matches(params, padded, table_reduction,
                                device_reduction):
    jcost, _ = params
    net = N.params_from_jax(jcost)
    feats, onehot, tmask, dmask = _inputs(padded)
    q, overall = N.cost_net_apply(net, _t(feats), _t(onehot), _t(tmask),
                                  _t(dmask), table_reduction,
                                  device_reduction)
    jq, jo = JN.cost_net_apply(jcost, _j(feats), _j(onehot), _j(tmask),
                               _j(dmask), table_reduction, device_reduction)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(overall.detach().numpy(), np.asarray(jo),
                               **TOL)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("table_reduction", ["sum", "mean", "max"])
def test_cost_net_input_gradients_match(params, padded, table_reduction):
    jcost, _ = params
    net = N.params_from_jax(jcost)
    feats, onehot, tmask, dmask = _inputs(padded, seed=1)

    def jloss(f):
        q, o = JN.cost_net_apply(jcost, f, _j(onehot), _j(tmask), _j(dmask),
                                 table_reduction)
        return (q ** 2).sum() + (o ** 2).sum()

    f = torch.as_tensor(feats).requires_grad_()
    q, o = N.cost_net_apply(net, f, _t(onehot), _t(tmask), _t(dmask),
                            table_reduction)
    ((q ** 2).sum() + (o ** 2).sum()).backward()
    jgrad = jax.grad(jloss)(jnp.asarray(feats))
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jgrad), **TOL)


@pytest.mark.parametrize("padded", [False, True])
def test_policy_logits_match(params, padded):
    _, jpol = params
    net = N.params_from_jax(jpol)
    rng = np.random.default_rng(5)
    dev = rng.normal(size=(3, 5, 4, 32)).astype(np.float32)
    q = rng.normal(size=(3, 5, 4, 3)).astype(np.float32)
    dmask = None
    if padded:
        dmask = np.array([1, 1, 1, 0], np.float32)
    out = N.policy_logits(net, _t(dev), _t(q), _t(dmask))
    ref = JN.policy_logits(jpol, _j(dev), _j(q), _j(dmask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    d = torch.as_tensor(dev).requires_grad_()
    N.policy_logits(net, d, _t(q), _t(dmask)).sum().backward()
    jgrad = jax.grad(lambda x: JN.policy_logits(jpol, x, _j(q),
                                                _j(dmask)).sum())(_j(dev))
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jgrad), **TOL)


def test_single_table_costs_and_reprs_match(params):
    jcost, jpol = params
    cost, pol = N.params_from_jax(jcost), N.params_from_jax(jpol)
    feats, *_ = _inputs(False)
    np.testing.assert_allclose(
        N.predict_single_table_costs(cost, _t(feats)).detach().numpy(),
        np.asarray(JN.predict_single_table_costs(jcost, _j(feats))), **TOL)
    np.testing.assert_allclose(
        N.policy_table_reprs(pol, _t(feats)).detach().numpy(),
        np.asarray(JN.policy_table_reprs(jpol, _j(feats))), **TOL)
    dev = N.cost_table_reprs(cost, _t(feats))[:, :4]
    np.testing.assert_allclose(
        N.cost_overall_head(cost, dev).detach().numpy(),
        np.asarray(JN.cost_overall_head(jcost, _j(dev.detach().numpy()))),
        **TOL)


@pytest.mark.parametrize("reduction", ["sum", "mean", "max"])
def test_reductions_match(reduction):
    rng = np.random.default_rng(7)
    h = rng.normal(size=(2, 6, 8)).astype(np.float32)
    onehot = np.zeros((2, 3, 6), np.float32)
    onehot[:, 0, :3] = onehot[:, 1, 3:] = 1.0          # device 2 empty
    np.testing.assert_allclose(
        N.reduce_tables(_t(h), _t(onehot), reduction).numpy(),
        np.asarray(JN.reduce_tables(_j(h), _j(onehot), reduction)), **TOL)
    dmask = np.array([[1, 1, 0], [1, 1, 1]], np.float32)
    dev = rng.normal(size=(2, 3, 8)).astype(np.float32)
    for m in (None, dmask):
        np.testing.assert_allclose(
            N.reduce_devices(_t(dev), _t(m), reduction).numpy(),
            np.asarray(JN.reduce_devices(_j(dev), _j(m), reduction)),
            **TOL)
    with pytest.raises(ValueError):
        N.reduce_tables(_t(h), _t(onehot), "median")
