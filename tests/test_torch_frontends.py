"""The port's frontend archs (llava-next-34b, musicgen-large) against the
JAX package, on the CPU.

Both frontends are stubs in the reference: precomputed patch or frame
embeddings (B, F, D) are cast to the model's dtype and put in front of
the token embeddings (``LM._embed``).  Each SMOKE config (F = 16 frames,
then 48 tokens) runs on both sides from the JAX LM's own weights
(``params_from_jax``), given the same numpy-seeded float32 embeds:
``forward``, ``forward_loss`` and its parameter gradients (labels and a
loss mask over the whole stream, the frames masked), ``prefill`` followed
by ``N_DECODE`` decode steps, and one ``make_train_step`` step (AdamW, lr
1e-3, weight decay 0.1).

Tolerances are those of ``tests/test_torch_lm.py`` and
``tests/test_torch_lm_train_step.py`` for the dense archs: in float32 the
two sides differ by summation order only (logits 1e-4; the loss 1e-6
relative; each gradient leaf within 1e-5 of its largest entry); in bf16
both round every matmul and residual to bf16 at the same places but add
in different orders (logits 2e-2, about two bf16 steps at their size;
the loss 1e-4; gradients 5e-2 of each leaf's largest), and decode is
teacher-forced with the JAX tokens so that a near-tie cannot fork the
sequences.  After the step every param is within 4 lr of the
reference's, and where the gradient decides Adam's step (|g| at least
1e-2, in bf16 0.1, of its leaf's largest) within 1e-5 (bf16: one bf16
step of the param + 0.5 lr).

``input_specs`` is held to the reference's shapes and dtypes for every
arch x ``INPUT_SHAPES``, and the launchers run a frontend arch on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs import shapes as JS
from repro.launch import steps as JST
from repro.models.transformer import LM as JaxLM
from repro_torch import configs as C
from repro_torch.configs import shapes as S
from repro_torch.launch import serve as SV
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import transformer as T

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)

ARCHS = ("llava-next-34b", "musicgen-large")
B, N_TOK, N_DECODE = 2, 48, 6
LR = 1e-3


def _inputs(cfg, seed=0):
    """Seeded tokens, float32 embeds, next-token labels over the whole
    stream and a loss mask that masks the frames and a few tokens."""
    rng = np.random.default_rng(seed)
    nf = cfg.n_frontend_tokens
    tokens = rng.integers(0, cfg.vocab, (B, N_TOK)).astype(np.int32)
    embeds = rng.normal(0, 0.02, (B, nf, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (B, nf + N_TOK)).astype(np.int32)
    mask = (rng.random((B, nf + N_TOK)) > 0.2).astype(np.float32)
    mask[:, :nf] = 0.0
    return {"tokens": tokens, "embeds": embeds, "labels": labels,
            "loss_mask": mask}


@pytest.fixture(scope="module",
                params=[(a, d) for a in ARCHS
                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def both(request):
    return _run_both(*request.param)


def _run_both(arch, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    cfg = JC.get_smoke(arch).resolve(1)
    model = _jax_lm(cfg, jdt)
    tree = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, tree)
    batch = _inputs(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    nf = cfg.n_frontend_tokens
    capacity = nf + N_TOK + N_DECODE

    ours = ST.build_model(C.get_smoke(arch).resolve(1), remat=False,
                          q_chunk=32, kv_chunk=32,
                          dtype=getattr(torch, dtype), device="cpu")
    params = T.params_from_jax(tree)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    res = {"dtype": dtype, "cfg": cfg}

    jlogits, _ = jax.jit(model.forward)(jp, jb["tokens"], jb["embeds"])
    tlogits, _ = ours.forward(params, tb["tokens"], tb["embeds"])
    res["forward"] = (np.asarray(jlogits, np.float32),
                      tlogits.float().numpy())

    def jloss(p):
        return model.forward_loss(p, jb["tokens"], jb["labels"],
                                  loss_mask=jb["loss_mask"],
                                  embeds=jb["embeds"])[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    g, tl, _ = ST.make_grad_fn(ours)(params, tb)
    res["loss"] = (float(jl), float(tl))
    res["grads"] = ([np.asarray(x, np.float32) for x in jax.tree.leaves(jg)],
                    [x.float().numpy() for x in g])

    jlog, jcache = jax.jit(lambda p, t, e: model.prefill(
        p, t, e, capacity=capacity))(jp, jb["tokens"], jb["embeds"])
    tlog, tcache = ST.make_prefill_step(ours, capacity=capacity)(
        params, {"tokens": tb["tokens"], "embeds": tb["embeds"]})
    res["prefill"] = (np.asarray(jlog, np.float32), tlog.float().numpy())
    res["cache"] = [(np.asarray(jcache["layers"][n], np.float32),
                     tcache["layers"][n].float().numpy().copy())
                    for n in "kv"]
    res["pos"] = (int(jcache["pos"]), tcache["pos"])
    decode = jax.jit(model.decode_step)
    tdecode = ST.make_decode_step(ours)
    forced = dtype == "bfloat16"
    jtok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
    ttok = tlog[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    steps = []
    for _ in range(N_DECODE):
        jlog, jcache = decode(jp, jcache, jtok)
        tin = torch.as_tensor(np.array(jtok)) if forced else ttok
        tlog, tcache = tdecode(params, tcache, {"tokens": tin})
        jtok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
        ttok = tlog[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        steps.append((np.asarray(jlog, np.float32), tlog.float().numpy(),
                      np.asarray(jtok), ttok.numpy()))
    res["decode"] = steps
    res["decode_pos"] = (int(jcache["pos"]), tcache["pos"])

    jopt, jstep = JST.make_train_step(model, lr=LR)
    jp_after, _, jm = jax.jit(jstep)(jp, jopt.init(jp), jb)
    opt, step = ST.make_train_step(ours, lr=LR)
    params, _, m = step(params, opt.init(T.tree_leaves(params)), tb)
    res["step_loss"] = (float(jm["loss"]), float(m["loss"]))
    res["step_params"] = (
        [np.asarray(x, np.float32) for x in jax.tree.leaves(jp_after)],
        [x.float().numpy() for x in T.tree_leaves(params)])
    return res


def _jax_lm(cfg, jdt):
    return JaxLM(cfg, remat=False, q_chunk=32, kv_chunk=32, dtype=jdt)


def _tol(res):
    return 1e-4 if res["dtype"] == "float32" else 2e-2


def test_frontend_forward_logits(both):
    ref, out = both["forward"]
    cfg = both["cfg"]
    assert out.shape == (B, cfg.n_frontend_tokens + N_TOK, cfg.vocab_padded)
    np.testing.assert_allclose(out, ref, rtol=_tol(both), atol=_tol(both))


def test_frontend_forward_loss_and_gradients(both):
    (jl, tl), (jg, tg) = both["loss"], both["grads"]
    rtol, limit = ((1e-6, 1e-5) if both["dtype"] == "float32"
                   else (1e-4, 5e-2))
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert len(jg) == len(tg)
    for j, t in zip(jg, tg):
        assert t.shape == j.shape
        assert np.abs(t - j).max() <= limit * np.abs(j).max() + 1e-12


def test_frontend_prefill_counts_the_frames(both):
    ref, out = both["prefill"]
    cfg = both["cfg"]
    nf = cfg.n_frontend_tokens
    assert out.shape == (B, 1, cfg.vocab_padded)
    np.testing.assert_allclose(out, ref, rtol=_tol(both), atol=_tol(both))
    for ref_c, out_c in both["cache"]:
        assert out_c.shape == (cfg.n_layers, B, nf + N_TOK + N_DECODE,
                               cfg.n_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(out_c, ref_c, rtol=_tol(both),
                                   atol=_tol(both))
    assert both["pos"] == (nf + N_TOK,) * 2


def test_frontend_decode_after_prefill(both):
    for jlog, tlog, jtok, ttok in both["decode"]:
        np.testing.assert_allclose(tlog, jlog, rtol=_tol(both),
                                   atol=_tol(both))
        if both["dtype"] == "float32":
            np.testing.assert_array_equal(ttok, jtok)
    nf = both["cfg"].n_frontend_tokens
    assert both["decode_pos"] == (nf + N_TOK + N_DECODE,) * 2


def test_frontend_train_step(both):
    (jl, tl), (jp, tp) = both["step_loss"], both["step_params"]
    f32 = both["dtype"] == "float32"
    np.testing.assert_allclose(tl, jl, rtol=1e-6 if f32 else 1e-4)
    share, close = (1e-2, 1e-5) if f32 else (0.1, 0.5 * LR)
    for g, j, t in zip(both["grads"][0], jp, tp):
        diff = np.abs(t - j)
        assert diff.max() <= 4 * LR
        if not f32:
            diff = diff - 2.0 ** -8 * np.abs(j)
        d = np.abs(g) >= share * np.abs(g).max()
        assert d.any() and diff[d].max() <= close


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_three_steps_losses_match_the_reference(arch):
    """Three AdamW steps (lr 3e-4, no warm-up, as the smoke trains) at
    SMOKE in float32 from the JAX LM's weights, carried across the steps
    on each side, over ``LMBatchStream``'s zipf batches (the same numpy
    arrays to both): every step's loss within 1e-5 relative of the
    reference's.  So the rise of musicgen's and llava's losses after the
    first step on the card is the recipe's, not the port's."""
    from repro_torch.data.pipeline import LMBatchStream
    cfg = JC.get_smoke(arch).resolve(1)
    model = _jax_lm(cfg, jnp.float32)
    tree = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, tree)
    ours = ST.build_model(C.get_smoke(arch).resolve(1), remat=False,
                          q_chunk=32, kv_chunk=32, dtype=torch.float32,
                          device="cpu")
    params = T.params_from_jax(tree)
    nf = cfg.n_frontend_tokens
    stream = LMBatchStream(cfg.vocab, B, nf + N_TOK, n_frontend_tokens=nf,
                           d_model=cfg.d_model, seed=0)
    jopt, jstep = JST.make_train_step(model, lr=3e-4)
    jstep = jax.jit(jstep)
    jstate = jopt.init(jp)
    opt, step = ST.make_train_step(ours, lr=3e-4)
    state = opt.init(T.tree_leaves(params))
    losses = []
    for i in range(3):
        batch = stream.batch_at(i)
        jp, jstate, jm = jstep(jp, jstate,
                               {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = step(params, state, {
            k: torch.as_tensor(v) for k, v in batch.items()})
        losses.append((float(jm["loss"]), float(m["loss"])))
    for jl, tl in losses:
        np.testing.assert_allclose(tl, jl, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_embeds_alone_and_tokens_alone(arch):
    """Either input may be None, as in the reference."""
    cfg = JC.get_smoke(arch).resolve(1)
    model = _jax_lm(cfg, jnp.float32)
    tree = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(1)))
    batch = _inputs(cfg, seed=1)
    ours = ST.build_model(C.get_smoke(arch).resolve(1), q_chunk=32,
                          kv_chunk=32, dtype=torch.float32, device="cpu")
    params = T.params_from_jax(tree)
    for tok, emb in ((None, batch["embeds"]), (batch["tokens"], None)):
        ref, _ = model.forward(jax.tree.map(jnp.asarray, tree), tok, emb)
        out, _ = ours.forward(params, None if tok is None else
                              torch.as_tensor(tok),
                              None if emb is None else torch.as_tensor(emb))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def test_registry_is_the_reference():
    assert C.ARCH_NAMES == JC.ARCH_NAMES
    for arch in ARCHS:
        for get, jget in ((C.get_full, JC.get_full),
                          (C.get_smoke, JC.get_smoke)):
            assert dataclasses.asdict(get(arch)) == dataclasses.asdict(
                jget(arch))
    with pytest.raises(KeyError):
        C.get_smoke("no-such-arch")


# ---- input_specs --------------------------------------------------------------

_DTYPES = {"int32": torch.int32, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("shape", list(JS.INPUT_SHAPES))
@pytest.mark.parametrize("arch", JC.ARCH_NAMES)
def test_input_specs_match_the_reference(arch, shape):
    ref = JS.input_specs(JC.get_full(arch), JS.INPUT_SHAPES[shape])
    ours = S.input_specs(C.get_full(arch), S.INPUT_SHAPES[shape])
    assert list(ours) == list(ref)
    for name, spec in ref.items():
        t = ours[name]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(spec.shape)
        assert t.dtype == _DTYPES[str(spec.dtype)]
    assert dataclasses.asdict(S.INPUT_SHAPES[shape]) == dataclasses.asdict(
        JS.INPUT_SHAPES[shape])


def test_input_specs_take_the_dtype_and_allocate_nothing():
    cfg = C.get_full("llava-next-34b")
    specs = S.input_specs(cfg, S.INPUT_SHAPES["prefill_32k"],
                          dtype=torch.float32)
    assert specs["embeds"].dtype == torch.float32
    assert tuple(specs["embeds"].shape) == (32, 2304, 7168)
    assert tuple(specs["tokens"].shape) == (32, 32768 - 2304)
    t = S.sds((1 << 20, 1 << 20), torch.float32)    # 4 TiB: a stand-in
    assert t.is_meta and t.numel() == 1 << 40
    with pytest.raises(ValueError):
        S.input_specs(cfg, S.InputShape("x", 8, 1, "eval"))


# ---- the launchers --------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_on_a_frontend_arch(arch, capsys):
    losses = TR.main(["--arch", arch, "--smoke", "--steps", "2",
                      "--device", "cpu", "--seq", "64"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "step   1 loss" in out
    with pytest.raises(ValueError, match="frontend"):
        TR.main(["--arch", arch, "--smoke", "--steps", "1", "--device",
                 "cpu", "--seq", "16"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_a_frontend_arch(arch):
    res = SV.serve(arch, batch=2, prompt_len=40, tokens=5, device="cpu")
    nf = res.cfg.n_frontend_tokens
    assert tuple(res.prompts.shape) == (2, 40 - nf)
    assert tuple(res.embeds.shape) == (2, nf, res.cfg.d_model)
    assert res.embeds.dtype == torch.bfloat16
    assert res.tokens.shape == (2, 5)
    assert res.pos == 40 + 5 - 1
    # the host draw: tokens, then embeds, from one default_rng(0)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        res.prompts.numpy(), rng.integers(0, res.cfg.vocab, (2, 40 - nf)))
    ref = torch.as_tensor(rng.normal(0, 0.02, (2, nf, res.cfg.d_model)),
                          dtype=torch.float32).to(torch.bfloat16)
    assert torch.equal(res.embeds, ref)
    with pytest.raises(ValueError, match="frontend"):
        SV.serve(arch, batch=1, prompt_len=nf, tokens=2, device="cpu")
