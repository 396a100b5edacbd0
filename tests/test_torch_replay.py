"""The port's replay ring and fused cost update against the JAX package's.

The ring must hold the same samples in the same slots as
``repro.core.replay.ReplayBuffer`` (wrap-around, an overfull batch, live
window slots), bit for bit.  Fifty fused cost steps (Eq. 1) from
converted weights over the same ring and the same host-drawn slots must
track the reference's losses and params within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.core import features as JF
from repro.core import networks as JN
from repro.core import replay as JRB
from repro_torch import optim as opt
from repro_torch.core import networks as N
from repro_torch.core import replay as RB


def _batch(rng, B, M, D, integer=False):
    feats = rng.normal(size=(B, M, JF.NUM_FEATURES)).astype(np.float32)
    onehot = np.zeros((B, D, M), np.float32)
    for b in range(B):
        onehot[b, rng.integers(0, D, M), np.arange(M)] = 1.0
    tmask = (rng.random((B, M)) < 0.8).astype(np.float32)
    dmask = np.ones((B, D), np.float32)
    dmask[:, D - 1] = rng.random(B) < 0.5
    q = rng.normal(size=(B, D, 3)).astype(np.float32)
    overall = (np.arange(B, dtype=np.float32) if integer
               else rng.normal(size=B).astype(np.float32))
    return feats, onehot, tmask, dmask, q, overall


def _same_ring(ring, jring):
    assert ring.count == jring.count and ring.size == jring.size
    for k, v in jring.data.items():
        np.testing.assert_array_equal(ring.data[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("capacity,batches", [
    (4, [6]),                  # one batch past the ring: wraps
    (3, [8]),                  # overfull batch keeps the newest
    (5, [2, 2, 2, 3]),         # wraps across appends
    (8, [3, 0, 4]),            # partly filled, an empty append
    (2, [1, 5, 1]),
])
def test_ring_matches_the_reference_bit_for_bit(capacity, batches):
    rng = np.random.default_rng(capacity)
    ring = RB.ReplayBuffer(capacity, 5, 3, device="cpu")
    jring = JRB.ReplayBuffer(capacity, 5, 3)
    for B in batches:
        data = _batch(rng, B, 5, 3, integer=True)
        ring.append_batch(*data)
        jring.append_batch(*data)
        _same_ring(ring, jring)
    live = np.arange(ring.size)
    np.testing.assert_array_equal(ring.slots(live), jring.slots(live))


def test_ring_wraps_like_the_reference_example():
    ring = RB.ReplayBuffer(capacity=4, m_pad=3, d_pad=2, device="cpu")
    data = _batch(np.random.default_rng(0), 6, 3, 2, integer=True)
    ring.append_batch(*data)
    np.testing.assert_array_equal(ring.data["overall"].numpy(),
                                  [4.0, 5.0, 2.0, 3.0])
    np.testing.assert_array_equal(ring.slots(np.arange(4)), [2, 3, 0, 1])


def test_ring_accepts_tensors_and_defaults_to_the_card():
    ring = RB.ReplayBuffer(3, 2, 2, device="cpu")
    data = _batch(np.random.default_rng(1), 2, 2, 2)
    ring.append_batch(*map(torch.as_tensor, data))
    np.testing.assert_array_equal(ring.data["q"][:2].numpy(), data[4])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RB.ReplayBuffer(3, 2, 2)


def _fill(rng, n, M=10, D=4):
    return _batch(rng, n, M, D)


@pytest.mark.parametrize("n_batch,n_samples", [(16, 40), (16, 9)])
def test_fifty_fused_cost_steps_track_the_reference(n_batch, n_samples):
    """The same slots (the per-step loop's host draws) and weights, the
    second case with partially-filled, weight-masked minibatches."""
    rng = np.random.default_rng(n_samples)
    jcost = jax.tree.map(np.asarray, JN.cost_net_init(jax.random.PRNGKey(2)))
    data = _fill(rng, n_samples)
    ring = RB.ReplayBuffer(64, 10, 4, device="cpu")
    jring = JRB.ReplayBuffer(64, 10, 4)
    ring.append_batch(*data)
    jring.append_batch(*data)
    steps = 50
    b = min(n_batch, ring.size)
    idx = np.zeros((steps, n_batch), np.int32)
    w = np.zeros((steps, n_batch), np.float32)
    for t in range(steps):
        idx[t, :b] = ring.slots(rng.integers(ring.size, size=b))
        w[t, :b] = 1.0
    jo = jopt.adam(jopt.linear_decay(5e-4, 300))
    jp, _, jlosses = JRB.make_fused_cost_update(jo)(
        jax.tree.map(jnp.asarray, jcost), jo.init(jcost), jring.data,
        jnp.asarray(idx), jnp.asarray(w))
    o = opt.adam(opt.linear_decay(5e-4, 300))
    net = N.params_from_jax(jcost)
    _, state, losses = RB.make_fused_cost_update(o)(
        net, o.init(list(net.parameters())), ring.data, idx, w)
    assert state.step == steps and losses.shape == (steps,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-4)
    assert losses[-1] < losses[0]                   # it did learn
    ported = N.params_to_jax(net)
    for a, r in zip(jax.tree.leaves(ported), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(r), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(r)).max())


def test_unit_weights_give_the_per_step_loss():
    rng = np.random.default_rng(5)
    net = N.CostNet(generator=torch.Generator().manual_seed(0))
    batch = tuple(map(torch.as_tensor, _fill(rng, 6)))
    full = RB.cost_loss(net, *batch)
    weighted = RB.cost_loss(net, *batch, torch.ones(6))
    torch.testing.assert_close(weighted, full, rtol=1e-6, atol=0)
    # a zero weight drops its sample, as a shorter minibatch does
    w = torch.tensor([1, 1, 1, 1, 0, 0], dtype=torch.float32)
    short = RB.cost_loss(net, *(x[:4] for x in batch))
    torch.testing.assert_close(RB.cost_loss(net, *batch, w), short,
                               rtol=1e-6, atol=0)
