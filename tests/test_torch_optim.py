"""The port's optimizers against the JAX package's, on the CPU.

Each optimizer takes 50 steps on the same gradient stream (drawn from a
numpy seed) over params of rank 1, 2 and 3; the params must stay within
1e-6 of the reference's.  The learning-rate schedule is the paper's
linear decay, read at the step after the increment.
"""

import jax
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


def _run_both_bf16(make, steps=5, seed=1):
    """Both packages on bfloat16 params and gradients (the LM train step's
    dtypes), the JAX updates run op by op as its train step's are traced:
    each op rounds to bf16."""
    rng = np.random.default_rng(seed)
    shapes = SHAPES + [(64, 64)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 0.1 for s in shapes]
             for _ in range(steps)]
    jo, to = make(jopt), make(opt)
    jp = [jnp.asarray(p, jnp.bfloat16) for p in init]
    jst = jo.init(jp)
    tp = [torch.tensor(p).to(torch.bfloat16) for p in init]
    tst = to.init(tp)
    for g in grads:
        upd, jst = jo.update([jnp.asarray(x, jnp.bfloat16) for x in g], jst,
                             jp)
        jp = jopt.apply_updates(jp, upd)
        tupd, tst = to.update([torch.tensor(x).to(torch.bfloat16)
                               for x in g], tst, tp)
        opt.apply_updates(tp, tupd)
    return jp, jst, tp, tst, init


@pytest.mark.parametrize("name", list(MAKERS))
def test_five_bf16_steps_match_the_reference_bit_for_bit(name):
    """Bit for bit: the port rounds each Python scalar to bf16 before it
    multiplies (JAX's weak types), keeps a schedule's learning rate
    float32 (a strong float32 array in JAX), computes Adam's
    bias-corrected update in float32 and casts once in
    ``apply_updates``."""
    jp, jst, tp, tst, init = _run_both_bf16(MAKERS[name])
    for j, t, p0 in zip(jp, tp, init):
        assert t.dtype == torch.bfloat16
        t16 = t.view(torch.int16).numpy()
        assert not np.array_equal(t.float().numpy(), p0)
        np.testing.assert_array_equal(t16, np.asarray(j).view(np.int16))
    # the state too: moments, momenta and accumulators keep the params'
    # dtype and bits
    jleaves = jax.tree.leaves(jst.inner)
    tleaves = [x for part in (tst.inner if isinstance(tst.inner, tuple)
                              else (tst.inner,)) if part is not None
               for x in part]
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(j).view(np.int16))


@pytest.mark.parametrize("limit", [1, 40])
@pytest.mark.parametrize("name", ["adam", "adam_const", "adamw"])
def test_adam_groups_keep_the_bits(name, limit, monkeypatch):
    """Adam's float32 part runs one bounded group of leaves at a time;
    groups of one leaf (limit 1) or of a few (limit 40) give the same
    params and state, bit for bit, as one group, in bf16 and float32."""
    assert [list(r) for r in opt.optimizers._groups(
        [torch.zeros(s) for s in [(7,), (5, 3), (2, 4, 6), (64, 64)]],
        40)] == [[0, 1], [2], [3]]
    whole = _run_both_bf16(MAKERS[name])
    monkeypatch.setattr(opt.optimizers, "GROUP_ELEMS", limit)
    grouped = _run_both_bf16(MAKERS[name])
    for a, b in zip(whole[2] + [*whole[3].inner[0], *whole[3].inner[1]],
                    grouped[2] + [*grouped[3].inner[0],
                                  *grouped[3].inner[1]]):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    f32 = _run_both(MAKERS[name], steps=5)[1]
    monkeypatch.setattr(opt.optimizers, "GROUP_ELEMS", 1 << 26)
    for a, b in zip(_run_both(MAKERS[name], steps=5)[1], f32):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_adam_slices_a_large_leaf_keeping_the_bits(name, dtype, monkeypatch):
    """A leaf larger than ``GROUP_ELEMS`` is updated in slices of at most
    ``GROUP_ELEMS`` elements along its leading axes: 5 steps of
    ``apply`` on a (6, 5, 7) leaf beside small ones, with the limit at
    40 and 1, give the params and moments of one whole group bit for
    bit; the moments are updated in place, and ``update`` +
    ``apply_updates`` is ``apply``."""
    shapes = [(7,), (6, 5, 7), (5, 3)]
    rng = np.random.default_rng(2)
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 0.1 for s in shapes]
             for _ in range(5)]

    def run(limit, via_update=False):
        monkeypatch.setattr(opt.optimizers, "GROUP_ELEMS", limit)
        o = MAKERS[name](opt)
        params = [torch.tensor(p).to(dtype) for p in init]
        state = o.init(params)
        moments = [t.data_ptr() for part in state.inner for t in part]
        for g in grads:
            g = [torch.tensor(x).to(dtype) for x in g]
            if via_update:
                upd, state = o.update(g, state, params)
                opt.apply_updates(params, upd)
            else:
                state = o.apply(g, state, params)
        assert [t.data_ptr() for part in state.inner
                for t in part] == moments
        return [t.clone() for t in params + [*state.inner[0],
                                             *state.inner[1]]]

    whole = run(1 << 26)
    pieces = opt.optimizers._pieces([torch.zeros(s) for s in shapes], 40)
    assert pieces == [[(0, 0, None)]] + [
        [(1, 1, slice(r, r + 1))] for r in range(6)] + [[(2, 0, None)]]
    for limit in (40, 1):
        assert all(sum(opt.optimizers._piece(torch.zeros(shapes[i]), lead,
                                             rows).numel()
                       for i, lead, rows in g) <= limit
                   for g in opt.optimizers._pieces(
                       [torch.zeros(s) for s in shapes], limit))
        for a, b in zip(whole, run(limit)):
            assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16
                                      else torch.int32),
                               b.view(torch.int16 if dtype == torch.bfloat16
                                      else torch.int32))
    for a, b in zip(whole, run(40, via_update=True)):
        assert torch.equal(a, b)
