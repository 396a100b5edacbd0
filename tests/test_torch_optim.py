"""The port's optimizers against the JAX package's, on the CPU.

Each optimizer takes 50 steps on the same gradient stream (drawn from a
numpy seed) over params of rank 1, 2 and 3; the params must stay within
1e-6 of the reference's.  The learning-rate schedule is the paper's
linear decay, read at the step after the increment.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as opt

SHAPES = [(7,), (5, 3), (2, 4, 6)]
STEPS = 50


def _run_both(make, steps=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    init = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) * 0.1 for s in SHAPES]
             for _ in range(steps)]
    jo, to = make(jopt), make(opt)
    jp = [jnp.asarray(p) for p in init]
    jst = jo.init(jp)
    tp = [torch.tensor(p) for p in init]
    tst = to.init(tp)
    for g in grads:
        upd, jst = jo.update([jnp.asarray(x) for x in g], jst, jp)
        jp = jopt.apply_updates(jp, upd)
        tupd, tst = to.update([torch.tensor(x) for x in g], tst, tp)
        opt.apply_updates(tp, tupd)
    assert tst.step == int(jst.step) == steps
    return [np.asarray(p) for p in jp], [p.numpy() for p in tp], init


MAKERS = {
    "sgd": lambda m: m.sgd(m.linear_decay(0.05, 40)),
    "sgd_momentum": lambda m: m.sgd(0.01, momentum=0.9),
    "adam": lambda m: m.adam(m.linear_decay(5e-3, 80)),
    "adam_const": lambda m: m.adam(1e-3),
    "adamw": lambda m: m.adamw(m.linear_decay(5e-3, 60), weight_decay=0.1),
    "rowwise_adagrad": lambda m: m.rowwise_adagrad(m.linear_decay(0.1, 50)),
}


@pytest.mark.parametrize("name", list(MAKERS))
def test_fifty_steps_match_the_reference(name):
    jp, tp, init = _run_both(MAKERS[name])
    for j, t, p0 in zip(jp, tp, init):
        assert not np.array_equal(t, p0)             # the params moved
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 7, 39, 40, 41, 100])
def test_linear_decay_is_the_reference_float32(step):
    j = np.asarray(jopt.linear_decay(5e-4, 40)(jnp.int32(step)))
    assert opt.linear_decay(5e-4, 40)(step) == float(j)


def test_rowwise_adagrad_state_is_per_row():
    params = [torch.zeros(4, 3), torch.zeros(5)]
    state = opt.rowwise_adagrad(0.1).init(params)
    assert [tuple(a.shape) for a in state.inner] == [(4,), (5,)]
    jstate = jopt.rowwise_adagrad(0.1).init([jnp.zeros((4, 3)),
                                             jnp.zeros(5)])
    assert [a.shape for a in jstate.inner] == [(4,), (5,)]


def test_state_lives_on_the_params_device():
    params = [torch.zeros(3, 2, dtype=torch.float64)]
    m, v = opt.adam(1e-3).init(params).inner
    assert m[0].dtype == v[0].dtype == torch.float64
    assert m[0].device == params[0].device


def test_apply_updates_is_in_place_and_casts():
    p = torch.ones(3, dtype=torch.float32)
    ptr = p.data_ptr()
    opt.apply_updates([p], [torch.full((3,), 0.5, dtype=torch.float64)])
    assert p.data_ptr() == ptr and p.dtype == torch.float32
    np.testing.assert_array_equal(p.numpy(), np.full(3, 1.5, np.float32))
    jp = jopt.apply_updates([jnp.ones(3)], [jnp.full(3, 0.5)])
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp[0]))


def test_update_does_not_track_gradients():
    p = torch.ones(3, requires_grad=True)
    g = torch.ones(3)
    upd, _ = opt.adam(1e-3).update([g], opt.adam(1e-3).init([p]), [p])
    assert not upd[0].requires_grad
