"""The port's LM at ``resolve(16)`` (padded query heads read through
``kv_map``) on one device with ``NO_SHARDING``, against the JAX LM at the
same ``resolve``, on the CPU in float32; ``resolve(8)`` is
``tests/test_torch_lm_padded_tp8.py``, which runs these checks from here
(the two halves run on two test workers: one JAX compile of the forward,
the gradient and the prefill costs ~3 s a case).

Every arch's SMOKE config runs with the JAX LM's own weights carried
across by ``params_from_jax`` (QKV biases drawn at random, as in
``tests/test_torch_lm.py``), on a 24-token prompt (a frontend arch's 16
stub embeddings in front): the forward's logits, the train step's loss
(``forward_loss``, plus 0.01 x the load-balance loss with experts), the
gradient of every leaf (1e-4 of each leaf's largest entry) and the
prefill's logits and cache, to ``tests/test_torch_lm.py``'s float32
tolerance, 1e-4.  Decode is held to the JAX decode only where no query
head is padded: where one is and the padded heads divide by the KV heads
the reference's decode reads KV head ``h // (Hq_pad / Hkv)`` instead of
``kv_map[h]`` (a reference quirk, pinned below), so the port's decode is
held instead to its own forward over the prompt and the decoded tokens, at
the last position, within 1e-5 of the logits' largest: a decoded token
sees what the forward sees.  An MoE arch's forward drops the tokens its
experts' capacity cannot take, per block of the sequence, where a
one-token decode step drops none; there the capacity factor is raised
to ``n_experts / top_k`` so that nothing is dropped on either side.
hymba-1.5b's FULL config loses a query head at ``resolve(2)`` and
``resolve(4)`` (25 heads cut to 24, a reference quirk), which ``LM``
refuses.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.transformer import LM as JaxLM
from repro_torch import configs as C
from repro_torch.launch import steps as ST
from repro_torch.models.config import MoEConfig
from repro_torch.models.transformer import (LM, params_from_jax,
                                            tree_leaves)

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)

PROMPT = 24
N_DECODE = 4
TOL = 1e-4
# XLA's CPU backend at its lowest optimization: a third less compile time
# (most of these tests' time), the same values within TOL
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def cases(tp: int) -> tuple:
    """(every arch at ``tp``, their ids, those with no padded head)."""
    cs = [(a, tp) for a in C.ARCH_NAMES]
    unpadded = [(a, t) for a, t in cs
                if C.get_smoke(a).resolve(t).n_heads_padded
                == C.get_smoke(a).n_heads]
    return cs, [f"{a}-tp{t}" for a, t in cs], unpadded


CASES, IDS, UNPADDED = cases(16)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _configs(arch, tp, no_drops=False):
    cfg, jcfg = C.get_smoke(arch), JC.get_smoke(arch)
    if no_drops and cfg.moe:
        cf = cfg.moe.n_experts / cfg.moe.top_k
        cfg = dataclasses.replace(cfg, moe=MoEConfig(
            cfg.moe.n_experts, cfg.moe.top_k, cf))
        jcfg = dataclasses.replace(jcfg, moe=JMoEConfig(
            jcfg.moe.n_experts, jcfg.moe.top_k, cf))
    return cfg.resolve(tp), jcfg.resolve(tp)


def _weights(jmodel):
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    if jmodel.cfg.qkv_bias:
        rng = np.random.default_rng(1)
        for n in ("bq", "bk", "bv"):
            b = tree["layers"][n]
            tree["layers"][n] = (rng.normal(size=b.shape) * 0.02).astype(
                b.dtype)
    return tree


def _inputs(cfg):
    rng = np.random.default_rng(0)
    nf = cfg.n_frontend_tokens if cfg.frontend else 0
    tokens = rng.integers(0, cfg.vocab, (2, PROMPT - nf)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    embeds = (rng.normal(0, 0.02, (2, nf, cfg.d_model)).astype(np.float32)
              if nf else None)
    forced = rng.integers(0, cfg.vocab, (N_DECODE, 2, 1)).astype(np.int32)
    return tokens, labels, embeds, forced


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def run_both(request):
    return _run(*request.param)


@functools.lru_cache(maxsize=None)
def _run(arch, tp):
    """The JAX LM and the port's at one ``resolve``, the same weights and
    inputs: forward, loss, gradients, prefill and ``N_DECODE`` decode
    steps on forced tokens (JAX's where no query head is padded)."""
    cfg, jcfg = _configs(arch, tp)
    jmodel = JaxLM(jcfg, remat=False, q_chunk=32, kv_chunk=32,
                   dtype=jnp.float32)
    tree = _weights(jmodel)
    tokens, labels, embeds, forced = _inputs(cfg)
    capacity = PROMPT + N_DECODE

    def jax_all(p):
        logits, _ = jmodel.forward(p, tokens, embeds=embeds)
        def train_loss(q):        # the train step's: with the experts'
            nll, aux = jmodel.forward_loss(q, tokens, labels,  # balance
                                           embeds=embeds)
            return nll + 0.01 * aux if jcfg.moe else nll
        loss, grads = jax.value_and_grad(train_loss)(p)
        plog, cache = jmodel.prefill(p, tokens, embeds=embeds,
                                     capacity=capacity)
        return logits, loss, grads, plog, cache

    jp = jax.tree.map(jnp.asarray, tree)
    jlogits, jloss, jgrads, jplog, jcache = _compiled(jax_all, jp)(jp)
    jcache0 = jcache["layers"]
    jdec = []
    if cfg.n_heads_padded == cfg.n_heads:
        decode = _compiled(jmodel.decode_step, jp, jcache,
                           jnp.asarray(forced[0]))
        for t in forced:
            jd, jcache = decode(jp, jcache, jnp.asarray(t))
            jdec.append(_np(jd))

    model = LM(cfg, dtype=torch.float32, device="cpu", remat=False,
               q_chunk=32, kv_chunk=32)
    params = params_from_jax(tree)
    t_tok = torch.as_tensor(tokens)
    t_emb = None if embeds is None else torch.as_tensor(embeds)
    logits, _ = model.forward(params, t_tok, embeds=t_emb)
    batch = {"tokens": t_tok, "labels": torch.as_tensor(labels)}
    if t_emb is not None:
        batch["embeds"] = t_emb
    grads, loss, _ = ST.make_grad_fn(model)(params, batch)
    plog, cache = model.prefill(params, t_tok, embeds=t_emb,
                                capacity=capacity)
    cache0 = {k: v.clone() for k, v in cache["layers"].items()}
    dec = []
    for t in forced:
        d, cache = model.decode_step(params, cache, torch.as_tensor(t))
        dec.append(d.numpy())
    return {
        "cfg": cfg, "logits": (_np(jlogits), logits.detach().numpy()),
        "loss": (float(jloss), float(loss)),
        "grads": (tree_leaves(params_from_jax(jax.tree.map(
            np.asarray, jgrads))), grads),
        "prefill": (_np(jplog), plog.numpy()),
        "cache": {k: (_np(v), cache0[k].numpy())
                  for k, v in jcache0.items()},
        "decode": (jdec, dec)}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


def test_forward_logits(run_both):
    ref, out = run_both["logits"]
    cfg = run_both["cfg"]
    assert out.shape == (2, PROMPT, cfg.vocab_padded)
    _close(out, ref)


def test_forward_loss(run_both):
    ref, out = run_both["loss"]
    assert abs(out - ref) <= TOL * max(1.0, abs(ref))


def test_gradients(run_both):
    want, got = run_both["grads"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        top = float(w.abs().max())
        assert float((g - w).abs().max()) <= TOL * max(top, 1e-30), top


def test_prefill_logits_and_cache(run_both):
    ref, out = run_both["prefill"]
    assert out.shape == (2, 1, run_both["cfg"].vocab_padded)
    _close(out, ref)
    for name, (ref_c, out_c) in run_both["cache"].items():
        assert out_c.shape == ref_c.shape, name
        _close(out_c, ref_c)


@pytest.mark.parametrize("arch,tp", UNPADDED,
                         ids=[f"{a}-tp{tp}" for a, tp in UNPADDED])
def test_decode_is_the_reference_where_no_head_is_padded(arch, tp):
    check_decode_against_the_reference(arch, tp)


def check_decode_against_the_reference(arch, tp):
    ref, out = _run(arch, tp)["decode"]
    assert len(ref) == len(out) == N_DECODE
    for r, o in zip(ref, out):
        _close(o, r)


@pytest.mark.parametrize("arch,tp", CASES, ids=IDS)
def test_decode_is_the_forward_at_its_last_position(arch, tp):
    check_decode_against_the_forward(arch, tp)


def check_decode_against_the_forward(arch, tp):
    cfg, _ = _configs(arch, tp, no_drops=True)
    model = LM(cfg, dtype=torch.float32, device="cpu", remat=False,
               q_chunk=32, kv_chunk=32)
    params = model.init_params(0)
    tokens, _, embeds, forced = _inputs(cfg)
    t_tok = torch.as_tensor(tokens)
    t_emb = None if embeds is None else torch.as_tensor(embeds)
    _, cache = model.prefill(params, t_tok, embeds=t_emb,
                             capacity=PROMPT + N_DECODE)
    seq = t_tok
    for t in forced:
        dec, cache = model.decode_step(params, cache, torch.as_tensor(t))
        seq = torch.cat([seq, torch.as_tensor(t)], dim=1)
        with torch.no_grad():
            full, _ = model.forward(params, seq, embeds=t_emb)
        want = full[:, -1:]
        top = float(want.abs().max())
        assert float((dec - want).abs().max()) <= 1e-5 * max(top, 1.0)


def test_reference_decode_reads_other_kv_heads_at_padded_heads():
    """A reference quirk, pinned: at ``resolve(16)`` danube's SMOKE pads 8
    query heads to 16 over 2 KV heads, and 16 divides by 2, so the reference's
    decode takes its grouped path (head h reads KV head h // 8) where its
    forward reads ``kv_map`` (h // 4, padded heads KV head 0): its decode
    disagrees with its own forward's last position, and the port's does
    not."""
    jcfg = JC.get_smoke("h2o-danube-1.8b").resolve(16)
    jmodel = JaxLM(jcfg, remat=False, q_chunk=32, kv_chunk=32,
                   dtype=jnp.float32)
    assert jmodel.grouped and list(jmodel.kv_map[:8]) == [0] * 4 + [1] * 4
    tree = _weights(jmodel)
    jp = jax.tree.map(jnp.asarray, tree)
    tokens, _, _, forced = _inputs(jcfg)
    _, cache = jmodel.prefill(jp, tokens, capacity=PROMPT + 1)
    dec, _ = jmodel.decode_step(jp, cache, jnp.asarray(forced[0]))
    full, _ = jmodel.forward(jp, np.concatenate([tokens, forced[0]], 1))
    gap = float(jnp.abs(dec - full[:, -1:]).max())
    assert gap > 0.1, gap
    model = LM(C.get_smoke("h2o-danube-1.8b").resolve(16),
               dtype=torch.float32, device="cpu", q_chunk=32, kv_chunk=32)
    params = params_from_jax(tree)
    _, tcache = model.prefill(params, torch.as_tensor(tokens),
                              capacity=PROMPT + 1)
    tdec, _ = model.decode_step(params, tcache, torch.as_tensor(forced[0]))
    np.testing.assert_allclose(tdec.numpy(), _np(full[:, -1:]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("tp", [2, 4])
def test_a_config_that_loses_query_heads_raises(tp):
    cfg = C.get_full("hymba-1.5b").resolve(tp)
    assert cfg.n_heads_padded == 24 < cfg.n_heads == 25
    with pytest.raises(ValueError, match=f"hymba-1.5b at tp={tp}"):
        LM(cfg, device="cpu")
    assert C.get_full("hymba-1.5b").resolve(16).n_heads_padded == 32
