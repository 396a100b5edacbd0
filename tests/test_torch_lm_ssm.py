"""The port's LM with hymba's hybrid block and RWKV-6 against the JAX
package, on the CPU.

Each arch's SMOKE config (``resolve(1)``) runs with the JAX LM's own
weights carried across by ``params_from_jax``, on a 96-token prompt,
longer than hymba's window of 64, so the window shows: forward logits,
prefill logits and every cache leaf (the KV cache, the SSM's float32
state and conv carry; RWKV's float32 WKV state and token-shift rows),
then 8 greedy decode steps, teacher-forced with the JAX tokens in bf16.
The tolerances are ``tests/test_torch_lm.py``'s: 1e-4 in float32 (with
equal greedy tokens), 2e-2 in bf16; a bf16 cache leaf whose values run
larger than the logits' (RWKV's WKV state) is held to two bf16 steps at
its largest magnitude where that is more (``_leaf_tol``).  The
parameter tree is held to the reference's layout, at SMOKE and at full
width (by ``param_layout`` against ``jax.eval_shape``, allocating
nothing), and carried both ways bit for bit.  On the CPU the scans are
the plain time loops, so the blocks train; the train step's loss is held
to the reference's ``forward_loss`` at the same weights, its gradients
leaf by leaf to ``jax.grad`` of it (1e-4 of each leaf's largest entry),
and remat's gradients to those without remat bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models.transformer import LM as JaxLM
from repro_torch import configs as C
from repro_torch.launch import serve as SV
from repro_torch.launch import steps as ST
from repro_torch.models.transformer import (LM, params_from_jax,
                                            params_to_jax, tree_leaves)

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)

ARCHS = ("hymba-1.5b", "rwkv6-1.6b")
PROMPT = 96
N_DECODE = 8


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _tol(dtype):
    return 1e-4 if dtype == "float32" else 2e-2


def _leaf_tol(dtype, ref):
    """A cache leaf's absolute tolerance: ``_tol``, but in bf16 at least
    two bf16 steps at the leaf's largest magnitude.  RWKV's float32 WKV
    state sums bf16-fed k v products over the whole prompt and reaches
    |s| ~ 8 at SMOKE, where the two packages' bf16 runs differ by 0.034
    while each lies 0.065-0.069 from a float32 run of the same weights;
    2e-2 absolute is under one bf16 step there."""
    tol = _tol(dtype)
    if dtype == "float32":
        return tol
    top = float(np.abs(ref).max())
    return max(tol, 2 * 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7))


def _jax_params(arch, dtype):
    model = JaxLM(JC.get_smoke(arch).resolve(1), remat=False, q_chunk=32,
                  kv_chunk=32, dtype=dtype)
    return model, jax.tree.map(np.asarray,
                               model.init_params(jax.random.PRNGKey(0)))


def _leaf_spec(tree):
    """{path: (shape, dtype name)} of a tree of arrays or tensors."""
    return {jax.tree_util.keystr(k): (tuple(v.shape),
                                      str(v.dtype).split(".")[-1])
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_configs_are_the_reference():
    for arch in ARCHS:
        assert arch in C.ARCH_NAMES
        for get, jget in ((C.get_full, JC.get_full),
                          (C.get_smoke, JC.get_smoke)):
            assert dataclasses.asdict(get(arch)) == dataclasses.asdict(
                jget(arch))
        assert C.supports_shape(arch, "long_500k")
    assert len(C.ARCH_NAMES) == 10
    assert C.LONG_CONTEXT_ARCHS == JC.LONG_CONTEXT_ARCHS


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_exactly(arch, dtype):
    """float32 leaves of a bf16 model (``logA``, ``w_bias``) are carried
    as float32, bit for bit."""
    _, tree = _jax_params(arch, getattr(jnp, dtype))
    params = params_from_jax(tree)
    if arch == "hymba-1.5b":
        assert params["layers"]["ssm"]["logA"].dtype == torch.float32
    else:
        assert params["layers"]["rwkv"]["att"]["w_bias"].dtype == \
            torch.float32
    back = params_to_jax(params)
    flat, treedef = jax.tree.flatten(tree)
    flat_back, treedef_back = jax.tree.flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    """Shapes, dtypes and the constants the reference draws none for."""
    _, tree = _jax_params(arch, jnp.bfloat16)
    ours = LM(C.get_smoke(arch).resolve(1), device="cpu").init_params(0)
    assert _leaf_spec(ours) == _leaf_spec(tree)
    lay, ref = ours["layers"], tree["layers"]
    if arch == "hymba-1.5b":
        np.testing.assert_array_equal(lay["ssm"]["dskip"].float().numpy(),
                                      _np(ref["ssm"]["dskip"]))
        # torch's log(1..N) is the correctly rounded one; XLA's is an ulp
        # off at one N
        np.testing.assert_allclose(lay["ssm"]["logA"].numpy(),
                                   ref["ssm"]["logA"], rtol=2e-7, atol=0)
        assert abs(float(lay["ssm"]["conv"].float().std()) - 0.2) < 0.02
    else:
        att = lay["rwkv"]["att"]
        np.testing.assert_array_equal(att["w_bias"].numpy(),
                                      ref["rwkv"]["att"]["w_bias"])
        for w in (att["mu"], att["u"], lay["rwkv"]["ffn"]["mu"]):
            assert abs(float(w.float().std()) - 0.5) < 0.05
        assert abs(float(att["wr"].float().std()) - 0.02) < 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_layout_is_the_reference(arch):
    """``param_layout`` at full width (no allocation) against
    ``jax.eval_shape`` of the reference's ``init_params``."""
    cfg = C.get_full(arch).resolve(1)
    ref = jax.eval_shape(JaxLM(JC.get_full(arch).resolve(1)).init_params,
                         jax.random.PRNGKey(0))
    layout = LM(cfg, device="cpu").param_layout()
    spec = {jax.tree_util.keystr(k): (tuple(s.shape),
                                      str(s.dtype).split(".")[-1])
            for k, s in jax.tree_util.tree_flatten_with_path(
                layout, is_leaf=lambda v: not isinstance(v, dict))[0]}
    assert spec == _leaf_spec(ref)


def _run_both(arch, dtype):
    """The JAX LM and the port's, same weights and prompt: forward,
    prefill (logits, every cache leaf) and N_DECODE decode steps."""
    jdt = getattr(jnp, dtype)
    model, tree = _jax_params(arch, jdt)
    params = jax.tree.map(jnp.asarray, tree)
    prompt = np.random.default_rng(0).integers(
        0, model.cfg.vocab, (2, PROMPT)).astype(np.int32)
    capacity = PROMPT + N_DECODE
    ours = LM(C.get_smoke(arch).resolve(1), dtype=getattr(torch, dtype),
              device="cpu")
    tparams = params_from_jax(tree)
    tprompt = torch.as_tensor(prompt)
    res = {"dtype": dtype, "cfg": model.cfg}
    jlogits, _ = jax.jit(model.forward)(params, prompt)
    tlogits, _ = ours.forward(tparams, tprompt)
    res["forward"] = (_np(jlogits), tlogits.float().numpy())
    jlog, jcache = jax.jit(lambda p, t: model.prefill(
        p, t, capacity=capacity))(params, prompt)
    tlog, tcache = ours.prefill(tparams, tprompt, capacity=capacity)
    res["prefill"] = (_np(jlog), tlog.float().numpy())
    # copies: decode_step writes into the port's cache in place
    res["cache"] = {n: (_np(jcache["layers"][n]),
                        tcache["layers"][n].float().numpy().copy(),
                        str(jcache["layers"][n].dtype),
                        str(tcache["layers"][n].dtype).split(".")[-1])
                    for n in jcache["layers"]}
    res["cache_keys"] = (set(jcache["layers"]), set(tcache["layers"]))
    res["pos"] = (int(jcache["pos"]), tcache["pos"])
    decode = jax.jit(model.decode_step)
    forced = dtype == "bfloat16"
    jtok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
    ttok = tlog[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    steps = []
    for _ in range(N_DECODE):
        jlog, jcache = decode(params, jcache, jtok)
        tin = torch.as_tensor(np.array(jtok)) if forced else ttok
        tlog, tcache = ours.decode_step(tparams, tcache, tin)
        jtok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
        ttok = tlog[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        steps.append((_np(jlog), tlog.float().numpy(), np.asarray(jtok),
                      ttok.numpy()))
    res["decode"] = steps
    res["decode_cache"] = {n: (_np(jcache["layers"][n]),
                               tcache["layers"][n].float().numpy())
                           for n in jcache["layers"]}
    res["decode_pos"] = (int(jcache["pos"]), tcache["pos"])
    return res


@pytest.fixture(scope="module", params=[
    (a, d) for a in ARCHS for d in ("float32", "bfloat16")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def run_both(request):
    return _run_both(*request.param)


def test_forward_logits(run_both):
    ref, out = run_both["forward"]
    assert out.shape == (2, PROMPT, run_both["cfg"].vocab_padded)
    tol = _tol(run_both["dtype"])
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


def test_prefill_logits_and_every_cache_leaf(run_both):
    tol = _tol(run_both["dtype"])
    ref, out = run_both["prefill"]
    assert out.shape == (2, 1, run_both["cfg"].vocab_padded)
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    jkeys, tkeys = run_both["cache_keys"]
    assert jkeys == tkeys
    for name, (ref_c, out_c, jdt, tdt) in run_both["cache"].items():
        assert out_c.shape == ref_c.shape and tdt == jdt, name
        np.testing.assert_allclose(out_c, ref_c, rtol=tol,
                                   atol=_leaf_tol(run_both["dtype"], ref_c),
                                   err_msg=name)
    assert run_both["pos"] == (PROMPT, PROMPT)


def test_greedy_decode(run_both):
    tol = _tol(run_both["dtype"])
    for jlog, tlog, jtok, ttok in run_both["decode"]:
        np.testing.assert_allclose(tlog, jlog, rtol=tol, atol=tol)
        if run_both["dtype"] == "float32":
            np.testing.assert_array_equal(ttok, jtok)
    for name, (ref_c, out_c) in run_both["decode_cache"].items():
        np.testing.assert_allclose(out_c, ref_c, rtol=tol,
                                   atol=_leaf_tol(run_both["dtype"], ref_c),
                                   err_msg=name)
    assert run_both["decode_pos"] == (PROMPT + N_DECODE,) * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_the_cpu(arch):
    res = SV.serve(arch, batch=2, prompt_len=70, tokens=5, device="cpu")
    cfg = C.get_smoke(arch).resolve(1)
    assert res.tokens.shape == (2, 5) and res.pos == 70 + 4
    assert ((res.tokens >= 0) & (res.tokens < cfg.vocab_padded)).all()
    assert torch.isfinite(res.last_logits.float()).all()
    # the same greedy tokens as driving the model by hand
    model = LM(cfg, device="cpu")
    logits, cache = model.prefill(res.params, res.prompts, capacity=75)
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    toks = [tok]
    for _ in range(4):
        logits, cache = model.decode_step(res.params, cache, tok)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(tok)
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(), res.tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_the_cpu(arch):
    """``make_train_step`` runs through the plain scans: the loss at the
    JAX weights is the reference's ``forward_loss`` (float32, 1e-5
    relative), every gradient is finite and the step moves the params."""
    model, tree = _jax_params(arch, jnp.float32)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, model.cfg.vocab, (2, 64)).astype(np.int32)
    labels = rng.integers(0, model.cfg.vocab, (2, 64)).astype(np.int32)
    jloss, _ = jax.jit(lambda p: model.forward_loss(p, tokens, labels))(
        jax.tree.map(jnp.asarray, tree))
    ours = ST.build_model(C.get_smoke(arch).resolve(1), remat=False,
                          dtype=torch.float32, device="cpu")
    params = params_from_jax(tree)
    before = [t.clone() for t in tree_leaves(params)]
    batch = {"tokens": torch.as_tensor(tokens),
             "labels": torch.as_tensor(labels)}
    grads, loss, _ = ST.make_grad_fn(ours)(params, batch)
    assert all(torch.isfinite(g).all() for g in grads)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    opt, step = ST.make_train_step(ours, lr=1e-3)
    state = opt.init(tree_leaves(params))
    params, state, metrics = step(params, state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert all(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(params)))


def _train_batch(vocab):
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, vocab, (2, 64)).astype(np.int32)
    labels = rng.integers(0, vocab, (2, 64)).astype(np.int32)
    return tokens, labels


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_are_the_reference(arch):
    """``make_grad_fn`` at the JAX weights (float32, the plain loops'
    autograd) against ``jax.grad`` of the reference's ``forward_loss``:
    every leaf within 1e-4 of that leaf's largest entry."""
    model, tree = _jax_params(arch, jnp.float32)
    tokens, labels = _train_batch(model.cfg.vocab)
    jgrads = jax.jit(jax.grad(
        lambda p: model.forward_loss(p, tokens, labels)[0]))(
            jax.tree.map(jnp.asarray, tree))
    ours = ST.build_model(C.get_smoke(arch).resolve(1), remat=False,
                          dtype=torch.float32, device="cpu")
    grads, _, _ = ST.make_grad_fn(ours)(
        params_from_jax(tree), {"tokens": torch.as_tensor(tokens),
                                "labels": torch.as_tensor(labels)})
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads)))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        top = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-4 * max(top, 1e-30), top


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradient_bits(arch):
    """Each layer under ``torch.utils.checkpoint`` re-runs its scans in
    the backward: the gradients equal those without remat bit for bit.
    Deterministic algorithms are on: with several CPU threads the
    embedding gather's backward (``index_put_`` with accumulate) adds a
    repeated token's rows in a varying order, so two runs without remat
    differ there too."""
    cfg = C.get_smoke(arch).resolve(1)
    tokens, labels = _train_batch(cfg.vocab)
    batch = {"tokens": torch.as_tensor(tokens),
             "labels": torch.as_tensor(labels)}
    runs = []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for remat in (False, True):
            model = ST.build_model(cfg, remat=remat, dtype=torch.float32,
                                   device="cpu")
            grads, loss, _ = ST.make_grad_fn(model)(model.init_params(0),
                                                    batch)
            runs.append((grads, loss))
    finally:
        torch.use_deterministic_algorithms(was)
    (g0, l0), (g1, l1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
