"""The port's LM under sharding rules over gloo, against its own
one-device run.

Each mesh is one group of ranks: a subprocess a rank (the ``-c`` script
below), a ``file://`` store in a temporary directory, every rank killed
at a deadline, as ``tests/test_torch_sharded.py`` runs its ranks.  The
group runs every config in turn, each config's outputs (or its error)
saved apart, so a case fails alone: a process spends ~4 s importing and
~7 s on DTensor's first sharding propagations, which the next config
mostly reuses, so a group a config would take several times as long.
For each config every rank builds the same seeded float32 weights,
distributes them by ``LM.param_specs`` over a ``(data, model)``
``DeviceMesh`` and runs:
the forward's logits (and with experts its load-balance loss),
``forward_loss``, the gradient of every leaf (``make_grad_fn``, each
reduced to its parameter's placements), one AdamW step
(``make_train_step``), then a prefill and 4 decode steps on a cache
placed by ``LM.cache_specs``.  Rank 0 also runs the same weights and
inputs on one device with ``NO_SHARDING``.  The ranks sum in another
order, so every output is held within 1e-5 of its largest value.  Adam's
first step moves a parameter by about the learning rate whatever the
size of its gradient (``g / (|g| + eps)``), so where a gradient entry is
small the step turns on the summation order: the step is held where the
gradient decides it (more than 1e-4 of its leaf's largest and 1e-5 in
size), within twice the learning rate elsewhere, and every rank's
parameters equal, bit for bit, one-device AdamW applied to the sharded
run's own gathered gradients.  The meshes are (1, 2), (2, 1) and (2, 2),
the last with the weights also split over the data axis (FSDP), and
danube also at (2, 4), at ``resolve(4)``, whose 2 KV heads do not divide
over the 4 model ranks.

The MoE archs (olmoe-1b-7b, dbrx-132b SMOKE: 4 experts, top-2) run on
every mesh with their experts split over the model axis: a 16-token
sequence is two blocks, one a model rank at (1, 2) and (2, 2), whose rows
the all-to-all carries to the experts and back; a decode token is one
block, routed whole on every model rank, each running its own experts
and gathering the others' outputs.  On (1, 2) olmoe also runs a prompt of
15, which tp = 2 does not divide (one block, replicated in every phase),
and with 3 experts raises ``ValueError``: they do not split over 2
ranks.  On (1, 2) hymba also runs with a vocab of 501, padded to 502, so
that the second rank's vocab shard holds the padding, and danube with 7
query heads over 2 KV heads, padded to 8, raises ``ValueError``: its
query heads 3 and 7 read KV heads that the other rank holds.
"""

import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
RANK_DEADLINE_S = 300.0
LR = 1e-3
ARCHS = ("h2o-danube-1.8b", "granite-34b", "qwen2.5-14b", "hymba-1.5b",
         "rwkv6-1.6b")
MESHES = ((1, 2), (2, 1), (2, 2))

_WORKER = r"""
import dataclasses, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_smoke
from repro_torch.launch import steps as ST
from repro_torch.models.config import MoEConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.sharding import (NO_SHARDING, ShardingRules,
                                         placements)
from repro_torch.models.transformer import LM, map_params, tree_leaves

rank, n_data, n_model, tmp, archs, lr = (
    int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
    sys.argv[6].split(","), float(sys.argv[7]))
torch.manual_seed(0)
dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                        rank=rank, world_size=n_data * n_model)
B, N_DECODE = 2, 4


def full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def run(model, params, shard, S):
    cfg = model.cfg
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                             dtype=torch.int32)
    labels = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                             dtype=torch.int32)
    mask = torch.as_tensor((rng.random((B, S)) < 0.8).astype(np.float32))
    forced = torch.as_tensor(rng.integers(0, cfg.vocab, (N_DECODE, B, 1)),
                             dtype=torch.int32)
    out = {}
    logits, aux = model.forward(params, tokens)
    out["logits"] = full(logits)
    batch = {"tokens": tokens, "labels": labels, "loss_mask": mask}
    grads, loss, grad_aux = ST.make_grad_fn(model)(params, batch)
    out["loss"] = full(loss)
    if cfg.moe:
        out["aux"], out["grad_aux"] = full(aux), full(grad_aux)
    for i, g in enumerate(grads):
        out[f"grad{i}"] = full(g)
    plog, cache = model.prefill(params, tokens, capacity=S + N_DECODE)
    out["prefill"] = full(plog)
    for j in range(N_DECODE):
        dlog, cache = model.decode_step(params, cache, forced[j])
        out[f"decode{j}"] = full(dlog)
    for name, t in cache["layers"].items():
        out[f"cache_{name}"] = full(t)
        if shard:
            want = placements(t.device_mesh,
                              model.cache_specs()["layers"][name])
            assert tuple(t.placements) == want, (name, t.placements, want)
    opt, step = ST.make_train_step(model, lr=lr, weight_decay=0.1)
    state = opt.init(tree_leaves(params))
    params, state, _ = step(params, state, batch)
    for i, p in enumerate(tree_leaves(params)):
        out[f"param{i}"] = full(p)
    return {k: v.float().numpy() for k, v in out.items()}


def case(arch, mesh):
    arch, _, over = arch.partition(":")
    cfg, S = get_smoke(arch), 16
    if over:
        field, _, value = over.partition("=")
        if field == "seq":
            S = int(value)
        elif field in {f.name for f in dataclasses.fields(MoEConfig)}:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, **{field: int(value)}))
        else:
            cfg = dataclasses.replace(cfg, **{field: int(value)})
    # tp 2, or the model axis where it is larger (4 ranks over danube's 2
    # KV heads: the projections whole on ``model`` before the head split)
    cfg = cfg.resolve(max(2, n_model))
    fsdp = ("data",) if n_data > 1 and n_model > 1 else ()
    rules = ShardingRules(fsdp_axes=fsdp)
    kw = dict(dtype=torch.float32, device="cpu", q_chunk=8, kv_chunk=8)
    plain = LM(cfg, NO_SHARDING, **kw)
    params = plain.init_params(0)
    model = LM(cfg, rules, **kw)
    try:
        sharded = model.shard_params(map_params(torch.clone, params), mesh)
    except ValueError as e:
        return {"raised": f"{type(e).__name__}: {e}"}
    got = run(model, sharded, True, S)
    if rank == 0:
        # one-device AdamW on the gathered sharded gradients
        leaves = [p.clone() for p in tree_leaves(params)]
        opt = ST.adamw(lr, weight_decay=0.1)
        opt.apply([torch.as_tensor(got[f"grad{i}"])
                   for i in range(len(leaves))], opt.init(leaves), leaves)
        got.update({f"adam{i}": p.numpy() for i, p in enumerate(leaves)})
        ref = run(plain, params, False, S)
        got.update({"ref_" + k: v for k, v in ref.items()})
    return got


try:
    mesh = make_mesh((n_data, n_model), ("data", "model"), device="cpu")
    for arch in archs:
        try:
            got = case(arch, mesh)
        except Exception:
            import traceback
            got = {"error": traceback.format_exc()}
        np.savez(f"{tmp}/{arch}-rank{rank}.npz", **got)
finally:
    dist.destroy_process_group()
"""


def _run_ranks(tmp_path, n_data, n_model, archs):
    """Start one process per rank and wait for all of them within the
    deadline; kill every one that is left when it passes.  Returns each
    config's outputs a rank, or the ranks' errors as a string."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, SRC, str(r), str(n_data),
         str(n_model), str(tmp_path), ",".join(archs), str(LR)],
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
    errs = [f"rank {r}: {err[-3000:]}"
            for r, (p, (_, err)) in enumerate(zip(procs, outs))
            if p.returncode != 0]
    if errs:
        return {arch: "\n".join(errs) for arch in archs}
    out = {}
    for arch in archs:
        ranks = [dict(np.load(tmp_path / f"{arch}-rank{r}.npz"))
                 for r in range(n_data * n_model)]
        errs = [f"rank {r}: {g['error']}" for r, g in enumerate(ranks)
                if "error" in g]
        out[arch] = "\n".join(errs) if errs else ranks
    return out


# hymba rides along with a vocab of 501, padded to 502 by resolve(2), so
# that the padding falls in the second rank's vocab shard; danube with 7
# query heads over 2 KV heads, padded to 8 by resolve(2), must raise: the
# first rank's query head 3 reads KV head 1 and the padded head 7, on the
# second rank, KV head 0, each held by the other rank; olmoe with a prompt
# of 15, which tp = 2 does not divide, routes one block replicated over
# the model axis in every phase; olmoe with 3 experts must raise: they do
# not split over 2 model ranks
PADDED_VOCAB = "hymba-1.5b:vocab=501"
PADDED_HEADS = "h2o-danube-1.8b:n_heads=7"
MOE_ARCHS = ("olmoe-1b-7b", "dbrx-132b")
MOE_ODD_SEQ = "olmoe-1b-7b:seq=15"
MOE_ODD_EXPERTS = "olmoe-1b-7b:n_experts=3"
# danube at (2, 4), resolve(4): its 2 KV heads do not divide over the 4
# model ranks, with a data axis of 2 (the smallest mesh where the head
# split once met a projection DTensor had left split over ``model``)
KV_REPLICATED = "h2o-danube-1.8b"
GROUPS = {(1, 2): ARCHS + MOE_ARCHS + (PADDED_VOCAB, PADDED_HEADS,
                                       MOE_ODD_SEQ, MOE_ODD_EXPERTS),
          (2, 1): ARCHS + MOE_ARCHS, (2, 2): ARCHS + MOE_ARCHS,
          (2, 4): (KV_REPLICATED,)}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every mesh's group of ranks, all at once: {(arch, mesh): each
    rank's outputs, or the error}."""
    # the directories first, in this thread: the factory's first call
    # creates its base directory, which threads would race to create
    tmp = {mesh: tmp_path_factory.mktemp(f"mesh{mesh[0]}x{mesh[1]}")
           for mesh in GROUPS}

    def one(mesh):
        return mesh, _run_ranks(tmp[mesh], *mesh, GROUPS[mesh])
    with ThreadPoolExecutor(max_workers=len(GROUPS)) as pool:
        done = dict(pool.map(one, GROUPS))
    return {(arch, mesh): res for mesh, by_arch in done.items()
            for arch, res in by_arch.items()}


def _held(got: dict, ref: dict, key: str, lr: float):
    out, want = got[key], ref["ref_" + key]
    assert out.shape == want.shape, key
    scale = max(float(np.abs(want).max()), 1e-30)
    if key.startswith("param"):
        i = key[len("param"):]
        np.testing.assert_array_equal(out, ref["adam" + i], err_msg=key)
        g = np.abs(ref["ref_grad" + i])
        decided = (g > 1e-4 * float(g.max())) & (g > 1e-5)
        err = np.abs(out - want)
        assert err[decided].max(initial=0.0) <= 1e-5 * scale, key
        assert err.max(initial=0.0) <= 2 * lr + 1e-5 * scale, key
        return
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5 * scale,
                               err_msg=key)


def _held_to_one_device(res):
    assert not isinstance(res, str), res
    ref = res[0]
    keys = [k for k in ref if not k.startswith(("ref_", "adam"))]
    assert {"logits", "loss", "prefill", "decode3", "grad0",
            "param0"} <= set(keys)
    for got in res:
        assert set(k for k in got
                   if not k.startswith(("ref_", "adam"))) == set(keys)
        for key in keys:
            _held(got, ref, key, LR)
    return keys


@pytest.mark.parametrize("arch,mesh", [(a, m) for a in ARCHS for m in MESHES],
                         ids=[f"{a}-{m[0]}x{m[1]}" for a in ARCHS
                              for m in MESHES])
def test_sharded_lm_matches_one_device(groups, arch, mesh):
    _held_to_one_device(groups[(arch, mesh)])


@pytest.mark.parametrize("arch,mesh",
                         [(a, m) for a in MOE_ARCHS for m in MESHES],
                         ids=[f"{a}-{m[0]}x{m[1]}" for a in MOE_ARCHS
                              for m in MESHES])
def test_sharded_moe_matches_one_device(groups, arch, mesh):
    """Expert parallelism (SMOKE: 4 experts, top-2, float32) held to the
    port's one-device run at the same ``resolve(2)``: the forward's logits
    and load-balance loss, ``forward_loss``, every gradient, the AdamW
    step, a prefill of 16 (two blocks: on a model axis of two ranks each
    rank routes its own, and the all-to-all carries the rows) and 4
    decode steps (one token: the block replicated over the model axis).

    The chain to the JAX package: the one-device run at ``resolve(2)`` is
    held to the JAX LM at ``resolve(2)``, whose ``moe_apply`` routes the
    same two blocks (``seq_chunks = tp``), by
    ``tests/test_torch_lm_padded_tp2.py``; ``moe_apply`` itself to the
    reference's at ``seq_chunks = 2`` by
    ``tests/test_torch_moe.py::test_output_is_the_reference[chunks2-f32]``
    (and its routing, combine and gradient tests at ``chunks2``).
    """
    keys = _held_to_one_device(groups[(arch, mesh)])
    assert {"aux", "grad_aux"} <= set(keys)


def test_moe_prefill_whose_sequence_tp_does_not_divide(groups):
    """A prompt of 15 at (1, 2): one block, routed whole on both model
    ranks, each running its own experts and gathering the others'
    outputs, in the forward, the gradient, the prefill and decode."""
    keys = _held_to_one_device(groups[(MOE_ODD_SEQ, (1, 2))])
    assert groups[(MOE_ODD_SEQ, (1, 2))][0]["logits"].shape[1] == 15
    assert {"aux", "grad_aux"} <= set(keys)


def test_kv_heads_that_do_not_divide_over_the_model_axis(groups):
    """danube SMOKE at (2, 4), ``resolve(4)``: 8 query heads over 4 model
    ranks, its 2 KV heads whole on every rank and the cache split along
    its sequence, FSDP over ``data``; held to the one-device run as every
    mesh is.  Before the repair its forward raised in the KV head split
    (``Cannot unflatten unevenly sharded tensor``)."""
    keys = _held_to_one_device(groups[(KV_REPLICATED, (2, 4))])
    assert {"cache_k", "cache_v"} <= set(keys)


def test_padded_vocab_splits_over_the_model_axis(groups):
    res = groups[(PADDED_VOCAB, (1, 2))]
    assert not isinstance(res, str), res
    assert res[0]["logits"].shape[-1] == 502
    for got in res:
        for key in (k for k in got if not k.startswith(("ref_", "adam"))):
            _held(got, res[0], key, LR)


def test_experts_that_do_not_split_over_the_model_axis_raise(groups):
    res = groups[(MOE_ODD_EXPERTS, (1, 2))]
    assert not isinstance(res, str), res
    for got in res:
        assert str(got["raised"]).startswith("ValueError"), got
        assert "3 experts do not split evenly over a model axis of 2 " \
            "ranks" in str(got["raised"])


def test_padded_head_reading_another_ranks_kv_head_raises(groups):
    res = groups[(PADDED_HEADS, (1, 2))]
    assert not isinstance(res, str), res
    for got in res:
        assert str(got["raised"]).startswith("ValueError"), got
        assert "query head 3 on model rank 0 of 2 reads KV head 1, which " \
            "that rank does not hold" in str(got["raised"])
