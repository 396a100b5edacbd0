"""The port's table-parallel embedding (``repro_torch.embedding.sharded``)
against ``repro.embedding.sharded``, and its distributed lookup over gloo.

- ``group_indices`` bit for bit;
- ``lookup_unsharded`` (K1 per shard, one arena per shard) against the
  reference's on the same arenas, within 1e-6;
- the reference quirk the port does not copy: the reference trains row 0
  of each shard by the padded slots; the port leaves it zero.  Every other
  row of the gradient agrees within 1e-6;
- ``make_sharded_lookup`` over gloo with 2 and 4 CPU ranks in (1, 2),
  (1, 4) and (2, 2) data x model grids against ``lookup_unsharded``: the
  outputs concatenated in rank order, and each rank's arena gradient,
  within 1e-6; built from a ``DeviceMesh`` (``mesh=``), bit for bit the
  ``grid_groups`` form's;
- the one-rank DLRM step (``DLRM(shard=m)``, ``make_train_step(
  batch_group=)``) over gloo at (1, 2) and (2, 2) against the whole
  model's step on one device, within 1e-6;
- ``measure_all_to_all`` and ``calibrate_comm`` at 2 gloo ranks (host
  times, not device ones); ``calibrate_comm`` for the card refuses a gloo
  group, and several cards with no process group.

Ranks run as subprocesses under one deadline, with a ``file://`` store in
the test's ``tmp_path``, so a hang or a port clash cannot stall the suite.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as JF
from repro.data.synthetic import make_dlrm_pool as j_make_dlrm_pool
from repro.embedding import sharded as JE
from repro.embedding.plan import build_plan as j_build_plan
from repro.profiling import collectives as JCO
from repro.sharding import ShardSpec as JShardSpec
from repro_torch.core import features as F
from repro_torch.data.synthetic import make_dlrm_pool
from repro_torch.embedding import sharded as E
from repro_torch.embedding.plan import build_plan
from repro_torch.profiling import collectives as CO
from repro_torch.sharding import ShardSpec

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
M, B, P = 8, 16, 5
RANK_DEADLINE_S = 120


def _raw():
    raw = make_dlrm_pool(seed=0)[:M].copy()
    raw[:, F.HASH_SIZE] = np.clip(raw[:, F.HASH_SIZE], 0, 500)
    return raw


def _indices(seed=0):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((B, M, P)) < 0.2, -1,
                    rng.integers(0, 400, (B, M, P))).astype(np.int32)


@pytest.fixture(scope="module")
def setup():
    """The reference test's setup (``tests/test_embedding_dlrm.py``): 8
    tables of <= 500 rows on 4 shards, the reference's arenas (row 0
    random, as it draws it) and each shard's cut of them."""
    raw = _raw()
    jraw = j_make_dlrm_pool(seed=0)[:M].copy()
    jraw[:, JF.HASH_SIZE] = np.clip(jraw[:, JF.HASH_SIZE], 0, 500)
    np.testing.assert_array_equal(raw, jraw)
    assign = np.arange(M) % 4
    plan, jplan = build_plan(raw, assign, 4), j_build_plan(jraw, assign, 4)
    stack = np.asarray(JE.init_arenas(jax.random.PRNGKey(0), jplan))
    arenas = [stack[s, :rows] for s, rows in enumerate(plan.shard_rows)]
    idx = _indices()
    gidx = E.group_indices(plan, idx)
    return plan, jplan, stack, arenas, idx, gidx


def test_plan_shard_rows(setup):
    plan, jplan, stack, *_ = setup
    want = [1 + int(plan.table_rows[g].sum()) for g in plan.groups]
    np.testing.assert_array_equal(plan.shard_rows, want)
    assert plan.shard_rows.max() == jplan.rows_max == stack.shape[1]


def test_group_indices_is_the_reference_bitwise(setup):
    plan, jplan, _, _, idx, gidx = setup
    want = JE.group_indices(jplan, idx)
    assert gidx.dtype == want.dtype
    np.testing.assert_array_equal(gidx, want)
    got = E.group_indices(plan, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_arenas_one_per_shard_with_a_zero_row(setup):
    plan = setup[0]
    gen = torch.Generator().manual_seed(0)
    arenas = E.init_arenas(plan, generator=gen, device="cpu")
    assert [tuple(a.shape) for a in arenas] == [
        (int(r), plan.dim) for r in plan.shard_rows]
    for a in arenas:
        assert a.dtype == torch.float32
        assert (a[0] == 0).all() and float(a[1:].abs().max()) > 0
        assert 0.005 < float(a[1:].std()) < 0.015          # scale 0.01


def test_lookup_unsharded_matches_the_reference(setup):
    plan, jplan, stack, arenas, _, gidx = setup
    want = np.asarray(JE.lookup_unsharded(jnp.asarray(stack), jplan.base_rows,
                                          jnp.asarray(gidx), jplan))
    got = E.lookup_unsharded([torch.tensor(a) for a in arenas],
                             torch.as_tensor(plan.base_rows),
                             torch.from_numpy(gidx), plan)
    assert tuple(got.shape) == want.shape == (B, 4 * plan.k_max, plan.dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_row0_gradient_is_the_only_gap_to_the_reference(setup):
    """The reference's autodiff lookup trains row 0 by the padded slots
    (its sum over them of the output gradient); K1's backward leaves row 0
    zero.  Every other row agrees, and the reference's padding rows past a
    shard's own rows get nothing."""
    plan, jplan, stack, arenas, _, gidx = setup
    w = np.random.default_rng(1).normal(
        size=(B, 4 * plan.k_max, plan.dim)).astype(np.float32)

    def jloss(a):
        out = JE.lookup_unsharded(a, jplan.base_rows, jnp.asarray(gidx),
                                  jplan)
        return jnp.sum(out * jnp.asarray(w))

    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(stack)))
    leaves = [torch.tensor(a, requires_grad=True) for a in arenas]
    out = E.lookup_unsharded(leaves, plan.base_rows, torch.from_numpy(gidx),
                             plan)
    (out * torch.from_numpy(w)).sum().backward()
    K = plan.k_max
    for s, leaf in enumerate(leaves):
        rows = int(plan.shard_rows[s])
        g = leaf.grad.numpy()
        assert (g[0] == 0).all()
        np.testing.assert_allclose(g[1:], jgrad[s, 1:rows], rtol=1e-6,
                                   atol=1e-6)
        assert (jgrad[s, rows:] == 0).all()
        own = gidx[:, s * K:(s + 1) * K]                  # (B, K, P)
        pad_sum = np.einsum("bkp,bkd->d", (own < 0).astype(np.float32),
                            w[:, s * K:(s + 1) * K])
        assert np.abs(pad_sum).max() > 0
        np.testing.assert_allclose(jgrad[s, 0], pad_sum, rtol=1e-5,
                                   atol=1e-5)


def test_combine_shard_outputs_matches_the_reference(setup):
    plan, jplan, *_ = setup
    grouped = np.random.default_rng(2).normal(
        size=(3, 4 * plan.k_max, plan.dim)).astype(np.float32)
    want = np.asarray(JE.combine_shard_outputs(jplan, jnp.asarray(grouped)))
    got = E.combine_shard_outputs(plan, torch.from_numpy(grouped))
    np.testing.assert_array_equal(got.numpy(), want)
    # the same tables as column shards that span them (the trivial spec)
    # take the reference's column scatter: the lanes past a table's dim
    # come back zero
    raw = _raw()
    sharded = build_plan(raw, plan.assignment, 4,
                         sharding=ShardSpec.trivial(raw))
    jsharded = j_build_plan(raw, plan.assignment, 4,
                            sharding=JShardSpec.trivial(raw))
    want = np.asarray(JE.combine_shard_outputs(jsharded,
                                               jnp.asarray(grouped)))
    got = E.combine_shard_outputs(sharded, torch.from_numpy(grouped))
    np.testing.assert_array_equal(got.numpy(), want)


_WORKER = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch, torch.distributed as dist
from repro_torch.embedding import sharded as E
from repro_torch.embedding.plan import build_plan
from repro_torch.launch.mesh import make_mesh
from repro_torch.profiling import collectives as CO

rank, n_data, n_model, tmp, mode = (int(sys.argv[2]), int(sys.argv[3]),
                                    int(sys.argv[4]), sys.argv[5],
                                    sys.argv[6])
dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                        rank=rank, world_size=n_data * n_model)
try:
    if mode == "lookup":
        z = np.load(f"{tmp}/inputs.npz")
        plan = build_plan(z["raw"], z["assign"], n_model)
        model_group, data_group = E.grid_groups(n_data, n_model)
        d, m = divmod(rank, n_model)
        b_loc = z["gidx"].shape[0] // n_data
        gidx = torch.from_numpy(z["gidx"][d * b_loc:(d + 1) * b_loc])
        mesh = make_mesh((n_data, n_model), ("data", "model"), device="cpu")
        got = {}
        for form, lookup in (
                ("", E.make_sharded_lookup(plan, model_group=model_group,
                                           data_group=data_group)),
                ("mesh_", E.make_sharded_lookup(plan, mesh=mesh))):
            arena = torch.tensor(z[f"arena{m}"], requires_grad=True)
            out = lookup([arena], plan.base_rows, gidx)
            n = out.shape[0]
            w = torch.from_numpy(z["w"][rank * n:(rank + 1) * n])
            (out * w).sum().backward()
            got.update({form + "out": out.detach().numpy(),
                        form + "grad": arena.grad.numpy()})
        np.savez(f"{tmp}/rank{rank}.npz", **got)
    elif mode == "dlrm":
        from repro_torch.launch.train_dlrm import make_train_step
        from repro_torch.models.dlrm import DLRM, DLRMConfig
        from repro_torch.optim import adam, rowwise_adagrad
        z = np.load(f"{tmp}/inputs.npz")
        plan = build_plan(z["raw"], z["assign"], n_model)
        mesh = make_mesh((n_data, n_model), ("data", "model"), device="cpu")
        d, m = divmod(rank, n_model)
        model = DLRM(DLRMConfig(embed_dim=plan.dim, bottom_mlp=(16,),
                                top_mlp=(16,), n_tables=plan.n_tables),
                     plan, device="cpu", shard=m)
        state = {k: torch.from_numpy(z["w_" + k]) for k in
                 z["state_keys"]}
        state["arenas.0"] = state.pop(f"arenas.{m}")
        model.load_state_dict({k: v for k, v in state.items()
                               if not k.startswith("arenas.") or
                               k == "arenas.0"})
        b_loc = z["gidx"].shape[0] // n_data
        rows = slice(d * b_loc + m * (b_loc // n_model),
                     d * b_loc + (m + 1) * (b_loc // n_model))
        emb_opt, dense_opt = rowwise_adagrad(0.05), adam(1e-3)
        step = make_train_step(model, E.make_sharded_lookup(plan, mesh=mesh),
                               emb_opt, dense_opt,
                               batch_group=dist.group.WORLD)
        _, _, loss = step(emb_opt.init(list(model.arenas)),
                          dense_opt.init(model.dense_parameters()),
                          torch.from_numpy(z["gidx"][d * b_loc:
                                                     (d + 1) * b_loc]),
                          torch.from_numpy(z["dense"][rows]),
                          torch.from_numpy(z["labels"][rows]))
        np.savez(f"{tmp}/rank{rank}.npz", loss=loss.numpy(),
                 **{k: v.detach().numpy()
                    for k, v in model.state_dict().items()})
    else:
        payload = [0.05, 0.2]
        times = CO.measure_all_to_all(payload, warmup=1, repeats=3)
        comm = CO.calibrate_comm(payload_mb=payload, warmup=1, repeats=2,
                                 device="cpu")
        CO.resolve_device = lambda device: torch.device("cuda")
        try:                           # a card calibrated over gloo
            CO.calibrate_comm(payload_mb=payload)
            refused = ""
        except ValueError as e:
            refused = str(e)
        np.savez(f"{tmp}/rank{rank}.npz", times=times,
                 comm_times=np.asarray(comm.times_ms),
                 n_devices=comm.n_devices,
                 measured=comm.source == "measured", refused=refused)
finally:
    dist.destroy_process_group()
"""


def _run_ranks(tmp_path, n_data, n_model, mode):
    """Start one process per rank and wait for all of them within the
    deadline; kill every one that is left when it passes."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, SRC, str(r), str(n_data),
         str(n_model), str(tmp_path), mode],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(n_data * n_model)]
    deadline = time.monotonic() + RANK_DEADLINE_S
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    return [np.load(tmp_path / f"rank{r}.npz")
            for r in range(n_data * n_model)]


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (1, 4), (2, 2)])
def test_sharded_lookup_over_gloo_matches_unsharded(tmp_path, n_data,
                                                    n_model):
    raw = _raw()
    assign = np.arange(M) % n_model
    plan = build_plan(raw, assign, n_model)
    rng = np.random.default_rng(n_data * 10 + n_model)
    arenas = [rng.normal(size=(int(r), plan.dim)).astype(np.float32)
              for r in plan.shard_rows]
    for a in arenas:
        a[0] = 0.0
    gidx = E.group_indices(plan, _indices(seed=n_model))
    w = rng.normal(size=(B, n_model * plan.k_max, plan.dim)).astype(
        np.float32)
    np.savez(tmp_path / "inputs.npz", raw=raw, assign=assign, gidx=gidx,
             w=w, **{f"arena{s}": a for s, a in enumerate(arenas)})

    leaves = [torch.tensor(a, requires_grad=True) for a in arenas]
    want = E.lookup_unsharded(leaves, plan.base_rows, torch.from_numpy(gidx),
                              plan)
    (want * torch.from_numpy(w)).sum().backward()

    ranks = _run_ranks(tmp_path, n_data, n_model, "lookup")
    got = np.concatenate([r["out"] for r in ranks])
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got, want.detach().numpy(), rtol=1e-6,
                               atol=1e-6)
    for rank, r in enumerate(ranks):
        m = rank % n_model
        np.testing.assert_allclose(r["grad"], leaves[m].grad.numpy(),
                                   rtol=1e-6, atol=1e-6)
        # the lookup built from a DeviceMesh: the grid groups' bits
        np.testing.assert_array_equal(r["mesh_out"], r["out"])
        np.testing.assert_array_equal(r["mesh_grad"], r["grad"])
    assert all(float(leaf.grad[1:].abs().max()) > 0 for leaf in leaves)


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2)])
def test_one_rank_dlrm_step_over_gloo_matches_one_device(tmp_path, n_data,
                                                         n_model):
    """``DLRM(shard=m)`` holding its rank's arena, the lookup from a
    ``DeviceMesh`` and ``make_train_step(batch_group=)``: one step of row-
    wise Adagrad and Adam over the ranks against the whole model's step
    on one device from the same weights.  Each rank's logits, and so its
    loss terms, come from the same rows; the loss, the arena gradients
    (summed over the data axis) and the dense nets' (over every rank) add
    in another order, so the updated weights and the loss are held within
    1e-6 of their largest entry, and the ranks of one model place hold the
    same arena bit for bit."""
    from repro_torch.launch.train_dlrm import make_train_step
    from repro_torch.models.dlrm import DLRM, DLRMConfig
    from repro_torch.optim import adam, rowwise_adagrad
    raw = _raw()
    assign = np.arange(M) % n_model
    plan = build_plan(raw, assign, n_model)
    model = DLRM(DLRMConfig(embed_dim=plan.dim, bottom_mlp=(16,),
                            top_mlp=(16,), n_tables=M), plan, seed=3,
                 device="cpu")
    rng = np.random.default_rng(5)
    gidx = E.group_indices(plan, _indices(seed=7))
    dense = rng.normal(size=(B, 13)).astype(np.float32)
    labels = (rng.random(B) < 0.5).astype(np.float32)
    weights = {k: v.detach().numpy().copy()
               for k, v in model.state_dict().items()}
    np.savez(tmp_path / "inputs.npz", raw=raw, assign=assign, gidx=gidx,
             dense=dense, labels=labels, state_keys=np.array(list(weights)),
             **{"w_" + k: v for k, v in weights.items()})
    emb_opt, dense_opt = rowwise_adagrad(0.05), adam(1e-3)
    step = make_train_step(model, lambda a, b, g: E.lookup_unsharded(
        a, b, g, plan), emb_opt, dense_opt)
    _, _, loss = step(emb_opt.init(list(model.arenas)),
                      dense_opt.init(model.dense_parameters()),
                      torch.from_numpy(gidx), torch.from_numpy(dense),
                      torch.from_numpy(labels))
    want = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    ranks = _run_ranks(tmp_path, n_data, n_model, "dlrm")
    for rank, r in enumerate(ranks):
        m = rank % n_model
        np.testing.assert_allclose(r["loss"], loss.numpy(), rtol=1e-6)
        for k, v in want.items():
            key = k
            if k.startswith("arenas."):
                if k != f"arenas.{m}":
                    continue                # another place's arena
                key = "arenas.0"
            scale = float(np.abs(v).max())
            np.testing.assert_allclose(r[key], v, rtol=0, atol=1e-6 * scale,
                                       err_msg=k)
            assert not np.array_equal(v, weights[k]), k     # it moved
        same = ranks[m]                     # the data row 0 of place m
        np.testing.assert_array_equal(r["arenas.0"], same["arenas.0"])


def test_payload_rows_is_the_reference_sizing():
    def reference(mb, n, dim):                # collectives.py:113-120
        send_bytes = mb * 1e6
        rows = max(n, int(send_bytes * n / max(n - 1, 1) / (4 * dim)))
        rows -= rows % n
        return max(rows, n)

    for mb in JCO.DEFAULT_PAYLOAD_MB + (1e-4, 0.05, 0.2):
        for n in (2, 3, 4, 8):
            for dim in (16, 128):
                assert CO.payload_rows(mb, n, dim) == reference(mb, n, dim)


def test_measure_all_to_all_over_gloo(tmp_path):
    ranks = _run_ranks(tmp_path, 1, 2, "a2a")
    for r in ranks:
        assert r["times"].shape == (2,)
        assert np.isfinite(r["times"]).all() and (r["times"] > 0).all()
        assert bool(r["measured"]) and int(r["n_devices"]) == 2
        assert (r["comm_times"] > 0).all()
        assert "gloo group" in str(r["refused"])
    with pytest.raises(ValueError, match=">= 2 ranks"):
        CO.measure_all_to_all([1.0])          # no process group here


def test_calibrate_comm_on_several_cards_needs_a_process_group(monkeypatch):
    monkeypatch.setattr(CO, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="init_process_group"):
        CO.calibrate_comm()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert CO.calibrate_comm().source == "synthetic"    # one card
