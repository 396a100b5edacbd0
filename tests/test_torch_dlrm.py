"""The port's DLRM (``repro_torch.models.dlrm``) against ``repro.models.dlrm``
at the SMOKE config and at FULL's widths over the same 8 tables, with the
reference's weights converted by ``dlrm_params_from_jax``, and the port's
training driver.

- logits and loss within 1e-5, at SMOKE and at FULL's widths (over the
  same 8 tables);
- gradients within 1e-5, at both, except row 0 of each shard's arena: the
  reference trains it by the padded slots, the port (K1's backward) leaves
  it zero (ROADMAP §1, "Reference quirk, not copied");
- 3 steps of row-wise Adagrad (arenas) and Adam (dense nets) within 1e-5,
  with the reference's row-0 gradient zeroed in this harness (at FULL's
  widths the dense nets are held through the losses);
- the per-shard arena update bit-equal to the whole-tensor update;
- ``train_with_placement`` on the CPU: finite, falling loss.
"""

import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm as JCD
from repro.core import features as JF
from repro.data.synthetic import make_dlrm_pool as j_make_dlrm_pool
from repro.embedding import sharded as JE
from repro.embedding.plan import build_plan as j_build_plan
from repro.models.dlrm import DLRM as JDLRM
from repro.optim import adam as j_adam
from repro.optim import apply_updates as j_apply_updates
from repro.optim import rowwise_adagrad as j_rowwise_adagrad
from repro_torch.api import RandomPlacer, SimOracle
from repro_torch.configs import dlrm as CD
from repro_torch.core import features as F
from repro_torch.data.pipeline import DLRMBatchStream
from repro_torch.data.synthetic import make_dlrm_pool
from repro_torch.data.tasks import Task
from repro_torch.embedding.plan import build_plan
from repro_torch.launch import train_dlrm as TD
from repro_torch.models.dlrm import DLRM, dlrm_params_from_jax
from repro_torch.optim import rowwise_adagrad
from repro_torch.optim.optimizers import OptState

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


@functools.lru_cache(maxsize=None)
def _make_setup(name):
    """``name``'s widths (SMOKE, or FULL's over 8 tables) over 8 tables of
    <= 500 rows on 4 shards, batch 64 from the port's ``DLRMBatchStream``
    (bitwise the reference's)."""
    raw, plan = TD.smoke_tables(4, 500)
    jraw = j_make_dlrm_pool(seed=0)[:8].copy()
    jraw[:, JF.HASH_SIZE] = np.clip(jraw[:, JF.HASH_SIZE], 0, 500)
    jplan = j_build_plan(jraw, np.arange(8) % 4, 4)
    cfg = dataclasses.replace(getattr(CD, name), n_tables=8)
    jmodel = JDLRM(dataclasses.replace(getattr(JCD, name), n_tables=8), jplan)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    model = DLRM(cfg, plan, device="cpu")
    model.load_state_dict(dlrm_params_from_jax(tree, plan))
    stream = DLRMBatchStream(raw, CD.SMOKE_BATCH,
                             n_dense=cfg.n_dense_features, seed=0)
    batches = [stream.batch_at(i) for i in range(3)]
    return plan, jplan, jmodel, jparams, model, batches


@pytest.fixture(scope="module")
def setup():
    return _make_setup("SMOKE")


def _jlookup(plan):
    return lambda a, b, i: JE.lookup_unsharded(a, plan.base_rows, i, plan)


def _jloss(jmodel, jplan, batch):
    gidx = jnp.asarray(JE.group_indices(jplan, batch["indices"]))

    def loss(p):
        logits = jmodel.forward(p, jnp.asarray(batch["dense"]), gidx,
                                _jlookup(jplan))
        return JDLRM.loss(logits, jnp.asarray(batch["labels"])), logits
    return loss


def _port_loss(model, plan, batch):
    gidx, dense, labels = TD.to_device(batch, plan, "cpu")
    logits = model(dense, gidx, TD.unsharded_lookup(plan))
    return DLRM.loss(logits, labels), logits


def _state_close(model, tree, plan, what):
    want = dlrm_params_from_jax(jax.tree.map(np.asarray, tree), plan)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], f"{what}: {k}")


def test_configs_are_the_reference():
    for name in ("FULL", "SMOKE"):
        assert dataclasses.asdict(getattr(CD, name)) == \
            dataclasses.asdict(getattr(JCD, name))
    assert (CD.TRAIN_BATCH, CD.SMOKE_BATCH) == (JCD.TRAIN_BATCH,
                                                JCD.SMOKE_BATCH)


def test_converted_params_have_the_port_layout(setup):
    plan, jplan, _, jparams, model, _ = setup
    sd = dlrm_params_from_jax(jax.tree.map(np.asarray, jparams), plan)
    for s, rows in enumerate(plan.shard_rows):
        assert tuple(sd[f"arenas.{s}"].shape) == (int(rows), plan.dim)
        np.testing.assert_array_equal(sd[f"arenas.{s}"],
                                      np.asarray(jparams["arenas"])[s, :rows])
    w = np.asarray(jparams["top"][0]["w"])
    np.testing.assert_array_equal(sd["top.0.weight"], w.T)
    assert [tuple(p.shape) for p in model.top.parameters()] == [
        (64, 164), (64,), (32, 64), (32,), (1, 32), (1,)]


def test_port_init_has_zero_rows_and_he_weights():
    raw = make_dlrm_pool(seed=0)[:8].copy()
    raw[:, F.HASH_SIZE] = np.clip(raw[:, F.HASH_SIZE], 0, 500)
    plan = build_plan(raw, np.arange(8) % 4, 4)
    a, b = (DLRM(CD.SMOKE, plan, seed=3, device="cpu") for _ in range(2))
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)                           # seeded
    for arena in a.arenas:
        assert (arena[0] == 0).all()
    w = a.top[0].weight.detach()
    assert abs(float(w.std()) / np.sqrt(2.0 / w.shape[1]) - 1) < 0.1
    assert all((lin.bias == 0).all() for lin in [*a.bottom, *a.top])


@pytest.mark.parametrize("name", ["SMOKE", "FULL"])
def test_logits_and_loss_match_the_reference(setup, name):
    plan, jplan, jmodel, jparams, model, batches = (
        setup if name == "SMOKE" else _make_setup(name))
    for batch in batches:
        (jl, jlogits) = _jloss(jmodel, jplan, batch)(jparams)
        with torch.no_grad():
            loss, logits = _port_loss(model, plan, batch)
        assert tuple(logits.shape) == (CD.SMOKE_BATCH,)
        _close(logits, jlogits, "logits")
        _close(loss, jl, "loss")


def test_bce_loss_matches_the_reference():
    logits = np.array([-30.0, -5.0, -1e-3, 0.0, 0.7, 5.0, 40.0], np.float32)
    labels = np.array([0, 1, 0, 1, 1, 0, 1], np.float32)
    want = float(JDLRM.loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(DLRM.loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)
    assert 0 < float(DLRM.loss(torch.tensor([-5.0, 0.0, 5.0]),
                               torch.tensor([0.0, 1.0, 1.0]))) < 1.0


@pytest.mark.parametrize("name", ["SMOKE", "FULL"])
def test_gradients_match_the_reference_but_row0(setup, name):
    plan, jplan, jmodel, jparams, model, batches = (
        setup if name == "SMOKE" else _make_setup(name))
    jgrad = jax.grad(lambda p: _jloss(jmodel, jplan, batches[0])(p)[0])(
        jparams)
    loss, _ = _port_loss(model, plan, batches[0])
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    want = dlrm_params_from_jax(jax.tree.map(np.asarray, jgrad), plan)
    for k, g in grads.items():
        if k.startswith("arenas."):
            assert (g[0] == 0).all()
            assert float(want[k][0].abs().max()) > 0     # the quirk
            _close(g[1:], want[k][1:], k)
        else:
            _close(g, want[k], k)


@pytest.mark.parametrize("name", ["SMOKE", "FULL"])
def test_three_steps_match_the_reference_with_row0_masked(setup, name):
    plan, jplan, jmodel, jparams, ported, batches = (
        setup if name == "SMOKE" else _make_setup(name))
    emb_opt, dense_opt = j_rowwise_adagrad(0.05), j_adam(1e-3)
    p = jparams
    emb_state = emb_opt.init({"arenas": p["arenas"]})
    dense_state = dense_opt.init({k: p[k] for k in ("bottom", "top")})
    j_losses = []
    for batch in batches:
        (loss, _), g = jax.value_and_grad(_jloss(jmodel, jplan, batch),
                                          has_aux=True)(p)
        g = {**g, "arenas": g["arenas"].at[:, 0].set(0.0)}   # the quirk
        eu, emb_state = emb_opt.update({"arenas": g["arenas"]}, emb_state)
        du, dense_state = dense_opt.update(
            {k: g[k] for k in ("bottom", "top")}, dense_state)
        p = {**j_apply_updates({k: p[k] for k in ("bottom", "top")}, du),
             **j_apply_updates({"arenas": p["arenas"]}, eu)}
        j_losses.append(float(loss))

    model = DLRM(ported.cfg, plan, device="cpu")
    model.load_state_dict(dlrm_params_from_jax(
        jax.tree.map(np.asarray, jparams), plan))
    train = TD.make_trainer(model, plan)
    losses = [float(train(*TD.to_device(b, plan, "cpu"))) for b in batches]
    _close(losses, j_losses, "losses")
    if name == "SMOKE":
        _state_close(model, p, plan, "after 3 steps")
    else:
        # at FULL's widths Adam's m / sqrt(v) turns the float-order noise
        # of near-zero gradients into up to ~2% of a step on a few dense
        # entries (2 of bottom.1.weight's 131072 by 2.0e-5), so the dense
        # nets are held through the losses of steps 1-2; the arenas
        # (row-wise Adagrad) elementwise
        want = dlrm_params_from_jax(jax.tree.map(np.asarray, p), plan)
        for s, arena in enumerate(model.arenas):
            _close(arena.detach(), want[f"arenas.{s}"], f"arena {s}")
    assert [st.step for st in train.state] == [3, 3]


def test_per_shard_adagrad_is_the_whole_tensor_update_bitwise(setup):
    plan = setup[0]
    rng = np.random.default_rng(5)
    rows = [int(r) for r in plan.shard_rows]
    stack = torch.tensor(rng.normal(size=(4, max(rows), plan.dim)),
                         dtype=torch.float32)
    arenas = [stack[s, :r].clone() for s, r in enumerate(rows)]
    listed = [a.clone() for a in arenas]
    opt = rowwise_adagrad(0.05)
    st_stack, st_shard, st_list = (opt.init([stack]), opt.init(arenas),
                                   opt.init(listed))
    for _ in range(3):
        g = torch.tensor(rng.normal(size=stack.shape), dtype=torch.float32)
        upd, st_stack = opt.update([g], st_stack)
        stack += upd[0]
        st_shard = TD.update_arenas(opt, arenas,
                                    [g[s, :r] for s, r in enumerate(rows)],
                                    st_shard)
        upd, st_list = opt.update([g[s, :r] for s, r in enumerate(rows)],
                                  st_list)
        for a, u in zip(listed, upd):
            a += u
    assert st_shard.step == st_stack.step == 3
    for s, r in enumerate(rows):
        assert torch.equal(arenas[s], stack[s, :r])
        assert torch.equal(arenas[s], listed[s])
        assert torch.equal(st_shard.inner[s], st_stack.inner[0][s, :r])


def test_update_arenas_drops_each_gradient():
    opt = rowwise_adagrad(0.1)
    arenas = [torch.ones((3, 4)), torch.ones((2, 4))]
    grads = [torch.ones((3, 4)), torch.full((2, 4), 2.0)]
    state = TD.update_arenas(opt, arenas, grads, opt.init(arenas))
    assert grads == [None, None]
    assert isinstance(state, OptState) and state.step == 1


def test_train_with_placement_on_the_cpu():
    raw = make_dlrm_pool(seed=0)[:8].copy()
    raw[:, F.HASH_SIZE] = np.clip(raw[:, F.HASH_SIZE], 100, 500)
    raw[:, F.TABLE_SIZE_GB] = F.table_size_gb(raw[:, F.DIM],
                                              raw[:, F.HASH_SIZE])
    task = Task.of(raw, 2, name="dlrm-end2end")
    oracle = SimOracle(seed=0)
    placement = RandomPlacer(oracle, seed=0).place(task)
    args = argparse.Namespace(steps=20, batch=64, device="cpu")
    cost, losses = TD.train_with_placement("random", task, placement, args,
                                           oracle)
    assert cost == oracle.evaluate(raw, placement.assignment, 2).overall
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
