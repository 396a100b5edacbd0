"""The port's real placement MDP (``repro_torch.core.mdp``) against
``repro.core.mdp``: the four cases of ``tests/test_mdp.py``, each run
through both packages step by step, with the states, rewards, legal
actions, assignments and measurement counts equal bitwise."""

import numpy as np
import pytest

from repro.core.mdp import RealPlacementMDP as JMDP
from repro.sim.costsim import CostSimulator as JSim
from repro_torch.core.mdp import RealPlacementMDP
from repro_torch.sim.costsim import CostSimulator


def _pair(raw, n_devices, order=None):
    sim, jsim = CostSimulator(seed=0), JSim(seed=0)
    return (RealPlacementMDP(raw, n_devices, sim, order=order), sim,
            JMDP(raw, n_devices, jsim, order=order), jsim)


def _same_state(a, b):
    (pd, q), (jpd, jq) = a, b
    np.testing.assert_array_equal(q, jq)
    assert len(pd) == len(jpd)
    for x, y in zip(pd, jpd):
        np.testing.assert_array_equal(x, y)


def _episode(mdp, jmdp, pick):
    """Step both MDPs to the end with ``pick(legal)``; return the port's
    rewards after holding every step to the reference's."""
    _same_state(mdp.reset(), jmdp.reset())
    rewards = []
    while not mdp.done:
        legal, jlegal = mdp.legal_actions(), jmdp.legal_actions()
        np.testing.assert_array_equal(legal, jlegal)
        a = pick(legal)
        (state, r, done), (jstate, jr, jdone) = mdp.step(a), jmdp.step(a)
        _same_state(state, jstate)
        assert (r, done) == (jr, jdone)
        rewards.append(r)
    assert jmdp.done
    np.testing.assert_array_equal(mdp.assignment, jmdp.assignment)
    np.testing.assert_array_equal(mdp.mem, jmdp.mem)
    return rewards


def test_episode_semantics(dlrm_pool):
    """``test_mdp.py::test_episode_semantics``."""
    mdp, _, jmdp, _ = _pair(dlrm_pool[:8], 2)
    per_device, q = mdp.reset()
    assert len(per_device) == 2 and q.shape == (2, 3) and (q == 0).all()
    rewards = _episode(mdp, jmdp, lambda legal: legal[0])
    assert len(rewards) == 8 and sum(rewards) < 0
    assert (mdp.assignment >= 0).all()


def test_intermediate_rewards_zero(dlrm_pool):
    """``test_mdp.py::test_intermediate_rewards_zero``."""
    mdp, _, jmdp, _ = _pair(dlrm_pool[:5], 2)
    rewards = _episode(mdp, jmdp, lambda legal: 0)
    assert all(r == 0 for r in rewards[:-1]) and rewards[-1] < 0


def test_mdp_consumes_measurements(dlrm_pool):
    """``test_mdp.py::test_mdp_consumes_measurements``: both simulators
    count the same measurements."""
    mdp, sim, jmdp, jsim = _pair(dlrm_pool[:5], 2)
    _episode(mdp, jmdp, lambda legal: 0)
    assert sim.num_evaluations == jsim.num_evaluations >= 5


@pytest.mark.parametrize("order", [[4, 3, 2, 1, 0], [2, 0, 4, 1, 3]])
def test_custom_order(dlrm_pool, order):
    """``test_mdp.py::test_custom_order``, and a whole episode in that
    order."""
    order = np.array(order)
    mdp, _, jmdp, _ = _pair(dlrm_pool[:5], 2, order=order)
    mdp.reset()
    mdp.step(1)
    assert mdp.assignment[order[0]] == 1
    assert (mdp.assignment[order[1:]] == -1).all()
    mdp, _, jmdp, _ = _pair(dlrm_pool[:5], 2, order=order)
    _episode(mdp, jmdp, lambda legal: legal[-1])
