"""The port's LM substrate against the JAX package, on the CPU.

Layers are fed the same seeded numpy inputs on both sides.  The whole
model is the h2o-danube-1.8b SMOKE config (``resolve(1)``) with the JAX
LM's own weights carried across by ``params_from_jax``, on a 96-token
prompt, past the config's window of 64; the other dense archs
(qwen2.5-14b with QKV biases, made random here, phi4-mini-3.8b with tied
embeddings, granite-34b with one KV head) and the MoE archs (olmoe-1b-7b,
dbrx-132b: routed experts, the load-balance loss beside the logits) are
held the same way.  In float32 the JAX LM runs its blockwise attention
scan and the port its materialized plain attention, so they differ by
float32 summation order only: 1e-4.  In bfloat16 both round every
matmul and residual to bf16 at the same places but accumulate in
different orders.  Logits reach 1.6 in size, where one bf16 step is
0.0078; the two sides stay within 2e-2 (about two steps), and decode is
teacher-forced with the JAX tokens so that a near-tie cannot fork the two
sequences.

In bf16 the MoE archs route each token by float32 router logits of a bf16
stream that the two sides round at different places, so a token whose
k-th and (k+1)-th router probabilities are nearly tied may go to another
expert on each side, which moves its logits by an expert's output.  So
there a row (a position) may differ beyond 2e-2 only where, in some
layer, the port's k-th and (k+1)-th probabilities are within 1e-2
(``NEAR_TIE``), and at most 2% of the forward's rows may (the SMOKE
routers start near uniform, so such near ties are common; flips are
not).  ``tests/test_torch_moe.py`` holds ``moe_apply`` itself to the
reference bit for bit in bf16, on the same input.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import layers as JL
from repro.models.transformer import LM as JaxLM
from repro_torch.configs import get_full, get_smoke
from repro_torch.launch import serve as S
from repro_torch.launch import steps as ST
from repro_torch.models import layers as L
from repro_torch.models.transformer import (LM, params_from_jax,
                                            params_to_jax)

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)

PROMPT = 96
N_DECODE = 8
NEAR_TIE = 1e-2
CFG = get_smoke("h2o-danube-1.8b").resolve(1)


def _rand(seed, *shape):
    return (np.random.default_rng(seed).normal(size=shape) * 0.5).astype(
        np.float32)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm(dtype):
    x, w = _rand(0, 2, 5, 48), 1 + _rand(1, 48)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = JL.rms_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt), 1e-5)
    out = L.rms_norm(torch.as_tensor(x).to(dtype),
                     torch.as_tensor(w).to(dtype), 1e-5)
    assert out.dtype == dtype
    np.testing.assert_allclose(out.float().numpy(), _np(ref),
                               rtol=1e-6 if dtype == torch.float32 else 1e-2,
                               atol=1e-6)


@pytest.mark.parametrize("hd", [32, 80, 128])
def test_rope_freqs_bitwise(hd):
    ref = np.asarray(JL.rope_freqs(hd, 1e4), np.float32)
    np.testing.assert_array_equal(L.rope_freqs(hd, 1e4).numpy(), ref)


def test_apply_rope_split_halves():
    x = _rand(2, 2, 7, 3, 16)
    pos = np.arange(3, 10)[None, :]
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    out = L.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e4)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply(act):
    x = _rand(3, 2, 5, 32)
    p = {"wu": _rand(4, 32, 64) * 0.2, "wo": _rand(5, 64, 32) * 0.2}
    if act == "swiglu":
        p["wg"] = _rand(6, 32, 64) * 0.2
    ref = JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), act)
    out = L.mlp_apply({k: torch.as_tensor(v) for k, v in p.items()},
                      torch.as_tensor(x), act)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["grouped", "expanded", "mapped"])
def test_decode_attention(layout):
    """The port's decode attention (query head h reads KV head
    ``heads[h]``) against the reference's grouped decode: KV heads read as
    they are (``h // G``), expanded one a query head, or read through a
    map that is not ``h // G`` (a padded head reading KV head 0), which
    the reference takes on its KV expanded through that map."""
    B, T, Hq, Hkv, hd = 2, 20, 8, 2, 16
    kv_heads = Hkv if layout == "grouped" else Hq
    heads = np.arange(Hq) // (Hq // kv_heads)
    if layout == "mapped":
        kv_heads, heads = Hkv, np.array([0, 0, 0, 1, 1, 1, 1, 0])
    q = _rand(7, B, 1, Hq, hd)
    kc, vc = _rand(8, B, T, kv_heads, hd), _rand(9, B, T, kv_heads, hd)
    valid = np.arange(T)[None, :] < np.array([[13], [20]])
    kr, vr = ((kc[:, :, heads], vc[:, :, heads]) if layout == "mapped"
              else (kc, vc))
    ref = JL.decode_attention(jnp.asarray(q), jnp.asarray(kr),
                              jnp.asarray(vr), jnp.asarray(valid))
    out = L.decode_attention_partial(
        torch.as_tensor(q), torch.as_tensor(kc), torch.as_tensor(vc),
        torch.as_tensor(valid), heads)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-5, atol=1e-5)


def _jax_params(dtype, arch="h2o-danube-1.8b"):
    """The JAX LM (SMOKE) and its weights as numpy; QKV biases, which the
    reference starts at zero, are drawn at random so that their add
    shows."""
    model = JaxLM(JC.get_smoke(arch).resolve(1), remat=False, q_chunk=32,
                  kv_chunk=32, dtype=dtype)
    tree = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(0)))
    if model.cfg.qkv_bias:
        rng = np.random.default_rng(1)
        for n in ("bq", "bk", "bv"):
            b = tree["layers"][n]
            tree["layers"][n] = (rng.normal(size=b.shape) * 0.02).astype(
                b.dtype)
    return model, tree


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_round_trip_exactly(dtype):
    _, tree = _jax_params(dtype)
    params = params_from_jax(tree)
    assert params["layers"]["wq"].dtype == (
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    back = params_to_jax(params)
    flat, treedef = jax.tree.flatten(tree)
    flat_back, treedef_back = jax.tree.flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_init_params_has_the_reference_layout():
    model, tree = _jax_params(jnp.float32)
    ours = LM(CFG, dtype=torch.float32, device="cpu").init_params(0)
    shapes = jax.tree.map(lambda a: a.shape, tree)
    assert jax.tree.map(lambda t: tuple(t.shape), ours) == shapes
    w = ours["layers"]["wq"]
    assert abs(float(w.std()) - 0.02) < 1e-3 and abs(float(w.mean())) < 1e-3


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def run_both(request):
    """The JAX LM and the port's, same weights, same prompt: forward,
    prefill and N_DECODE decode steps on each side."""
    return _run_both("h2o-danube-1.8b", request.param)


class _Margins:
    """Records, per ``moe_route`` call of the port, each position's margin
    between its k-th and (k+1)-th router probability; ``take()`` returns
    the least over the calls since the last ``take`` (B, S), or None."""

    def __init__(self, monkeypatch):
        self.seen = []
        route = L.moe_route

        def record(x, router, **kw):
            r = route(x, router, **kw)
            p = r.probs.sort(-1, descending=True).values
            k = r.top_e.shape[-1]
            self.seen.append((p[..., k - 1] - p[..., k]).numpy())
            return r
        monkeypatch.setattr(L, "moe_route", record)

    def take(self):
        out = np.min(self.seen, axis=0) if self.seen else None
        self.seen = []
        return out


def _run_both(arch, dtype):
    with pytest.MonkeyPatch.context() as mp:
        return _run_both_recorded(arch, dtype, _Margins(mp))


def _run_both_recorded(arch, dtype, margins):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    model, tree = _jax_params(jdt, arch)
    cfg = model.cfg
    params = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    capacity = PROMPT + N_DECODE

    ours = LM(get_smoke(arch).resolve(1), dtype=getattr(torch, dtype),
              device="cpu")
    tparams = params_from_jax(tree)
    tprompt = torch.as_tensor(prompt)
    res = {"dtype": dtype, "cfg": cfg}
    jlogits, jaux = jax.jit(model.forward)(params, prompt)
    tlogits, taux = ours.forward(tparams, tprompt)
    res["forward"] = (np.asarray(jlogits, np.float32),
                      tlogits.float().numpy())
    res["aux"] = (float(jaux), float(taux))
    res["margin"] = margins.take()

    jlog, jcache = jax.jit(lambda p, t: model.prefill(p, t,
                                                      capacity=capacity))(
        params, prompt)
    tlog, tcache = ours.prefill(tparams, tprompt, capacity=capacity)
    res["prefill"] = (np.asarray(jlog, np.float32), tlog.float().numpy())
    res["prefill_margin"] = margins.take()
    # copies: decode_step writes into the port's cache in place
    res["cache"] = [(np.asarray(jcache["layers"][n], np.float32),
                     tcache["layers"][n].float().numpy().copy())
                    for n in "kv"]
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
        steps.append((np.asarray(jlog, np.float32), tlog.float().numpy(),
                      np.asarray(jtok), ttok.numpy(), margins.take()))
    res["decode"] = steps
    res["decode_pos"] = (int(jcache["pos"]), tcache["pos"])
    return res


def _tol(res):
    return 1e-4 if res["dtype"] == "float32" else 2e-2


def test_lm_forward_logits(run_both):
    ref, out = run_both["forward"]
    assert out.shape == (2, PROMPT, CFG.vocab_padded)
    np.testing.assert_allclose(out, ref, rtol=_tol(run_both),
                               atol=_tol(run_both))


def test_lm_prefill_logits_and_cache(run_both):
    ref, out = run_both["prefill"]
    assert out.shape == (2, 1, CFG.vocab_padded)
    np.testing.assert_allclose(out, ref, rtol=_tol(run_both),
                               atol=_tol(run_both))
    for ref_c, out_c in run_both["cache"]:
        assert out_c.shape == (CFG.n_layers, 2, PROMPT + N_DECODE,
                               CFG.n_kv_heads, CFG.head_dim)
        np.testing.assert_allclose(out_c, ref_c, rtol=_tol(run_both),
                                   atol=_tol(run_both))
    assert run_both["pos"] == (PROMPT, PROMPT)


def test_lm_greedy_decode(run_both):
    for jlog, tlog, jtok, ttok, _ in run_both["decode"]:
        np.testing.assert_allclose(tlog, jlog, rtol=_tol(run_both),
                                   atol=_tol(run_both))
        if run_both["dtype"] == "float32":
            np.testing.assert_array_equal(ttok, jtok)
    assert run_both["decode_pos"] == (PROMPT + N_DECODE,) * 2


@pytest.mark.parametrize("change", [{"n_kv_heads": 3}])
def test_unsupported_blocks_raise(change):
    # 8 query heads over 3 KV heads: resolve(1) cuts the query heads to 6,
    # losing two, which the port refuses (the reference runs it)
    cfg = dataclasses.replace(get_smoke("h2o-danube-1.8b"), **change)
    with pytest.raises(ValueError, match="group evenly"):
        LM(cfg.resolve(1), device="cpu")


@pytest.mark.parametrize("change", [{"qkv_bias": True},
                                    {"tie_embeddings": True}])
def test_qkv_bias_and_tied_embeddings_run(change):
    cfg = dataclasses.replace(get_smoke("h2o-danube-1.8b"),
                              **change).resolve(1)
    model = LM(cfg, dtype=torch.float32, device="cpu")
    params = model.init_params(0)
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    assert ("bq" in params["layers"]) == cfg.qkv_bias
    logits, _ = model.forward(params, torch.zeros((1, 8), dtype=torch.int32))
    assert logits.shape == (1, 8, cfg.vocab_padded)


def test_unresolved_or_sharded_config_raises():
    with pytest.raises(ValueError, match="resolve"):
        LM(get_smoke("h2o-danube-1.8b"), device="cpu")
    # a sharded config runs (tests/test_torch_lm_padded.py) unless its
    # resolve() loses query heads, as hymba-1.5b's does at tp 2
    LM(get_smoke("h2o-danube-1.8b").resolve(2), device="cpu")
    with pytest.raises(ValueError, match="tp=2"):
        LM(get_full("hymba-1.5b").resolve(2), device="cpu")


def test_steps_are_the_model_calls():
    model = ST.build_model(CFG, dtype=torch.float32, device="cpu")
    params = model.init_params(1)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, CFG.vocab, (2, 10)), dtype=torch.int32)
    logits, cache = ST.make_prefill_step(model, capacity=12)(
        params, {"tokens": tokens})
    ref_logits, ref_cache = model.prefill(params, tokens, capacity=12)
    torch.testing.assert_close(logits, ref_logits, rtol=0, atol=0)
    nxt = logits[:, -1].argmax(-1, keepdim=True)
    out, cache = ST.make_decode_step(model)(params, cache, {"tokens": nxt})
    ref_out, _ = model.decode_step(params, ref_cache, nxt)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    assert cache["pos"] == 11
    with pytest.raises(ValueError, match="capacity"):
        model.prefill(params, tokens, capacity=5)


def test_serve_on_the_cpu():
    res = S.serve(batch=2, prompt_len=70, tokens=5, device="cpu")
    assert res.tokens.shape == (2, 5)
    assert ((res.tokens >= 0) & (res.tokens < CFG.vocab_padded)).all()
    assert res.pos == 70 + 4
    assert torch.isfinite(res.last_logits).all()
    assert res.peak_memory_bytes is None
    # the same greedy tokens as driving the model by hand
    model = LM(CFG, device="cpu")
    logits, cache = model.prefill(res.params, res.prompts, capacity=75)
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    toks = [tok]
    for _ in range(4):
        logits, cache = model.decode_step(res.params, cache, tok)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(tok)
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(), res.tokens)


# ---- the other dense archs --------------------------------------------------

OTHER = ("qwen2.5-14b", "phi4-mini-3.8b", "granite-34b")


@pytest.mark.parametrize("arch", OTHER)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_dense_params_round_trip_exactly(arch, dtype):
    _, tree = _jax_params(dtype, arch)
    params = params_from_jax(tree)
    cfg = get_smoke(arch).resolve(1)
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    assert ("bq" in params["layers"]) == cfg.qkv_bias
    back = params_to_jax(params)
    flat, treedef = jax.tree.flatten(tree)
    flat_back, treedef_back = jax.tree.flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", OTHER)
def test_dense_init_params_has_the_reference_layout(arch):
    model, tree = _jax_params(jnp.float32, arch)
    ours = LM(get_smoke(arch).resolve(1), dtype=torch.float32,
              device="cpu").init_params(0)
    assert jax.tree.map(lambda t: tuple(t.shape), ours) == jax.tree.map(
        lambda a: a.shape, tree)
    if model.cfg.qkv_bias:
        assert not ours["layers"]["bq"].any()   # the reference's zeros


@pytest.fixture(scope="module", params=[
    (a, d) for a in OTHER for d in ("float32", "bfloat16")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def run_dense(request):
    return _run_both(*request.param)


def test_dense_forward_logits(run_dense):
    ref, out = run_dense["forward"]
    assert out.shape == (2, PROMPT, run_dense["cfg"].vocab_padded)
    np.testing.assert_allclose(out, ref, rtol=_tol(run_dense),
                               atol=_tol(run_dense))


def test_dense_prefill_logits_and_cache(run_dense):
    cfg = run_dense["cfg"]
    ref, out = run_dense["prefill"]
    np.testing.assert_allclose(out, ref, rtol=_tol(run_dense),
                               atol=_tol(run_dense))
    for ref_c, out_c in run_dense["cache"]:
        assert out_c.shape == (cfg.n_layers, 2, PROMPT + N_DECODE,
                               cfg.n_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(out_c, ref_c, rtol=_tol(run_dense),
                                   atol=_tol(run_dense))
    assert run_dense["pos"] == (PROMPT, PROMPT)


def test_dense_greedy_decode(run_dense):
    for jlog, tlog, jtok, ttok, _ in run_dense["decode"]:
        np.testing.assert_allclose(tlog, jlog, rtol=_tol(run_dense),
                                   atol=_tol(run_dense))
        if run_dense["dtype"] == "float32":
            np.testing.assert_array_equal(ttok, jtok)
    assert run_dense["decode_pos"] == (PROMPT + N_DECODE,) * 2


# ---- the MoE archs ------------------------------------------------------------

MOE = ("olmoe-1b-7b", "dbrx-132b")


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_moe_params_round_trip_exactly(arch, dtype):
    """The float32 router of a bf16 model is carried bit for bit."""
    _, tree = _jax_params(dtype, arch)
    params = params_from_jax(tree)
    assert "mlp" not in params["layers"]
    assert params["layers"]["moe"]["router"].dtype == torch.float32
    assert params["layers"]["moe"]["wg"].dtype == (
        torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    back = params_to_jax(params)
    flat, treedef = jax.tree.flatten(tree)
    flat_back, treedef_back = jax.tree.flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", MOE)
def test_moe_init_params_has_the_reference_layout(arch):
    _, tree = _jax_params(jnp.bfloat16, arch)
    ours = LM(get_smoke(arch).resolve(1), device="cpu").init_params(0)
    assert jax.tree.map(lambda t: tuple(t.shape), ours) == jax.tree.map(
        lambda a: a.shape, tree)
    assert jax.tree.map(lambda t: str(t.dtype).split(".")[-1],
                        ours) == jax.tree.map(lambda a: str(a.dtype), tree)


@pytest.fixture(scope="module", params=[
    (a, d) for a in MOE for d in ("float32", "bfloat16")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def run_moe(request):
    return _run_both(*request.param)


def _moe_close(res, out, ref, margin):
    """``out`` within ``_tol`` of ``ref`` row by row (a row: the trailing
    axes at one (b, s)), but in bf16 at a row where the port's router
    had a near tie (``margin < NEAR_TIE``); returns the share of rows
    beyond the tolerance."""
    tol = _tol(res)
    far = ~np.isclose(out, ref, rtol=tol, atol=tol).reshape(
        *margin.shape, -1).all(-1)
    if res["dtype"] == "float32":
        assert not far.any()
    else:
        assert not (far & (margin >= NEAR_TIE)).any()
    return float(far.mean())


def test_moe_forward_logits_and_aux(run_moe):
    ref, out = run_moe["forward"]
    assert out.shape == (2, PROMPT, run_moe["cfg"].vocab_padded)
    assert _moe_close(run_moe, out, ref, run_moe["margin"]) <= 0.02
    jaux, taux = run_moe["aux"]
    assert taux > 0
    np.testing.assert_allclose(taux, jaux,
                               rtol=1e-5 if run_moe["dtype"] == "float32"
                               else 1e-3)


def test_moe_prefill_logits_and_cache(run_moe):
    cfg = run_moe["cfg"]
    ref, out = run_moe["prefill"]
    margin = run_moe["prefill_margin"]
    _moe_close(run_moe, out, ref, margin[:, -1:])
    for ref_c, out_c in run_moe["cache"]:
        assert out_c.shape == (cfg.n_layers, 2, PROMPT + N_DECODE,
                               cfg.n_kv_heads, cfg.head_dim)
        for layer in range(cfg.n_layers):
            _moe_close(run_moe, out_c[layer, :, :PROMPT],
                       ref_c[layer, :, :PROMPT], margin)
    assert run_moe["pos"] == (PROMPT, PROMPT)


def test_moe_greedy_decode(run_moe):
    for jlog, tlog, jtok, ttok, margin in run_moe["decode"]:
        _moe_close(run_moe, tlog, jlog, margin)
        if run_moe["dtype"] == "float32":
            np.testing.assert_array_equal(ttok, jtok)
    assert run_moe["decode_pos"] == (PROMPT + N_DECODE,) * 2


@pytest.mark.parametrize("arch", MOE)
def test_moe_serve_on_the_cpu(arch):
    res = S.serve(arch, batch=2, prompt_len=40, tokens=4, device="cpu")
    cfg = get_smoke(arch).resolve(1)
    assert res.cfg.moe == cfg.moe and res.tokens.shape == (2, 4)
    assert ((res.tokens >= 0) & (res.tokens < cfg.vocab_padded)).all()
    assert torch.isfinite(res.last_logits).all()
