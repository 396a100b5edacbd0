"""The port's LM training path against the JAX package, on the CPU.

- The flash attention op's gradient: ``dq``/``dk``/``dv`` of the op (plain
  forward on the CPU, the blockwise recompute in its backward) against
  ``jax.grad`` through the reference's blockwise ``L.flash_attention`` on
  KV heads expanded by ``kv_map``: float32, S = 100 (no chunk multiple),
  chunks of 32, groups 1, 4 and 8 (Hkv = 1 among them), window None and
  24.  Both sides differentiate the same float32 scan and differ by
  summation order only: 1e-5.
- ``lm_loss`` and ``LM.forward_loss`` against the reference's, with and
  without a loss mask, for the four dense archs at SMOKE (float32, the
  JAX LM's weights carried across by ``params_from_jax``): 1e-5
  relative.
- The launcher ``launch.train.main`` at SMOKE on the CPU, and its refusal
  to run without a card unless told ``--device cpu``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch.kernels.flash_attention import ops
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)

DENSE = ("h2o-danube-1.8b", "qwen2.5-14b", "phi4-mini-3.8b", "granite-34b")
MOE = ("olmoe-1b-7b", "dbrx-132b")


def _rand(rng, *shape, scale=0.5):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---- the op's gradient ------------------------------------------------------


def _qkv(B, S, Hkv, G, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, S, Hkv * G, hd), _rand(rng, B, S, Hkv, hd),
            _rand(rng, B, S, Hkv, hd), _rand(rng, B, S, Hkv * G, hd,
                                             scale=1.0))


@pytest.mark.parametrize("Hkv, G", [(2, 1), (2, 4), (1, 8), (1, 1)])
@pytest.mark.parametrize("window", [None, 24])
def test_op_gradient_matches_jax_grad(Hkv, G, window):
    q, k, v, dout = _qkv(2, 100, Hkv, G, 16)
    kv_map = np.arange(Hkv * G) // G

    def f(q, k, v):
        out = JL.flash_attention(q, jnp.take(k, kv_map, axis=2),
                                 jnp.take(v, kv_map, axis=2), causal=True,
                                 window=window, q_chunk=32, kv_chunk=32)
        return jnp.sum(out * dout), out

    (_, ref), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, window=window, q_chunk=32,
                              kv_chunk=32)
    out.backward(torch.tensor(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)
    for t, j in zip((tq, tk, tv), jgrads):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("S, chunks", [(100, (32, 32)), (64, (16, 48)),
                                       (37, (64, 8))])
@pytest.mark.parametrize("window", [None, 5, 24])
def test_blockwise_attention_matches_the_reference_scan(S, chunks, window):
    q, k, v, _ = _qkv(2, S, 2, 4, 16, seed=S)
    qc, kc = chunks
    ref = JL.flash_attention(q, jnp.take(k, np.arange(8) // 4, axis=2),
                             jnp.take(v, np.arange(8) // 4, axis=2),
                             window=window, q_chunk=qc, kv_chunk=kc)
    out = L.blockwise_attention(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), window=window, q_chunk=qc,
                                kv_chunk=kc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("window", [None, 1, 7, 40, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_key_range_holds_every_key_a_chunk_may_attend(window, causal):
    from repro_torch.kernels.flash_attention.ref import attention_mask
    S, qc, kc = 100, 32, 16
    mask = attention_mask(S, S, causal=causal, window=window).numpy()
    for q0 in range(0, S, qc):
        q1 = min(S, q0 + qc)
        lo, hi = L.key_range(q0, q1, S, causal=causal, window=window,
                             kv_chunk=kc)
        assert lo % kc == 0 and (hi % kc == 0 or hi == S)
        rows = mask[q0:q1]
        assert not rows[:, :lo].any() and not rows[:, hi:].any()
        # no whole key chunk that the queries cannot attend
        for k0 in range(lo, hi, kc):
            assert rows[:, k0:k0 + kc].any()


def test_op_backward_saves_only_q_k_v():
    """The backward keeps q, k, v (no copies), the output and each row's
    log-sum-exp (B, Hq, S) float32: nothing of S x T."""
    from repro_torch.kernels.flash_attention.ref import attention_plain
    q, k, v, dout = _qkv(1, 40, 1, 2, 16)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, q_chunk=16, kv_chunk=16)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    assert all(s.data_ptr() == t.data_ptr() for s, t in zip(saved,
                                                           (tq, tk, tv)))
    assert torch.equal(saved[3], out)
    _, lse = attention_plain(tq, tk, tv, lse=True)
    assert saved[4].shape == (1, 2, 40) and saved[4].dtype == torch.float32
    assert torch.equal(saved[4], lse)


def test_op_without_grad_is_the_plain_forward():
    from repro_torch.kernels.flash_attention.ref import attention_plain
    q, k, v, _ = _qkv(2, 50, 2, 2, 16)
    args = [torch.tensor(a) for a in (q, k, v)]
    torch.testing.assert_close(ops.flash_attention(*args, window=9),
                               attention_plain(*args, window=9), rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="chunks"):
        ops.flash_attention(*args, q_chunk=0)


# ---- losses -----------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("vocab", [None, 50, 64])
def test_lm_loss_matches_the_reference(masked, vocab):
    rng = np.random.default_rng(3)
    logits = _rand(rng, 2, 9, 64, scale=3.0)
    labels = rng.integers(0, vocab or 64, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32) if masked else None
    ref = JT.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                     None if mask is None else jnp.asarray(mask), vocab)
    out = T.lm_loss(torch.tensor(logits), torch.tensor(labels),
                    None if mask is None else torch.tensor(mask), vocab)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
    s, m = T._chunk_ce(torch.tensor(logits), torch.tensor(labels),
                       torch.ones(2, 9) if mask is None else
                       torch.tensor(mask), vocab)
    js, jm = JT._chunk_ce(jnp.asarray(logits), jnp.asarray(labels),
                          jnp.ones((2, 9)) if mask is None else
                          jnp.asarray(mask), vocab)
    np.testing.assert_allclose(float(s), float(js), rtol=1e-6)
    assert float(m) == float(jm)


def jax_model(arch, dtype=jnp.float32, seed=0):
    """The reference LM (SMOKE, chunks of 32) and its weights as numpy,
    with random QKV biases where the arch has them (the reference starts
    them at zero, which would hide their add)."""
    cfg = JC.get_smoke(arch).resolve(1)
    model = JT.LM(cfg, remat=False, q_chunk=32, kv_chunk=32, dtype=dtype)
    tree = jax.tree.map(np.asarray,
                        model.init_params(jax.random.PRNGKey(seed)))
    if cfg.qkv_bias:
        rng = np.random.default_rng(seed + 100)
        for n in ("bq", "bk", "bv"):
            b = tree["layers"][n]
            tree["layers"][n] = (rng.normal(size=b.shape) * 0.02).astype(
                b.dtype)
    return model, tree


@pytest.mark.parametrize("arch", DENSE)
def test_forward_loss_matches_the_reference(arch):
    """Without and with a loss mask, against one jitted JAX function that
    returns both losses."""
    model, tree = jax_model(arch)
    cfg = model.cfg
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab, (2, 96)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 96)).astype(np.int32)
    mask = (rng.random((2, 96)) > 0.25).astype(np.float32)
    refs = jax.jit(lambda p, t, lab, m: [
        model.forward_loss(p, t, lab, loss_mask=mm, loss_chunk=32)[0]
        for mm in (None, m)])(jax.tree.map(jnp.asarray, tree), tokens,
                              labels, mask)
    ours = ST.build_model(C.get_smoke(arch).resolve(1), q_chunk=32,
                          kv_chunk=32, dtype=torch.float32, device="cpu")
    params = T.params_from_jax(tree)
    targs = (torch.tensor(tokens), torch.tensor(labels))
    logits, _ = ours.forward(params, targs[0])
    for tmask, ref in zip((None, torch.tensor(mask)), refs):
        loss, aux = ours.forward_loss(params, *targs, loss_mask=tmask,
                                      loss_chunk=32)
        assert aux == 0.0
        np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)
        # the chunked loss is lm_loss over the full logits, whatever the
        # chunk
        full = T.lm_loss(logits, targs[1], tmask, cfg.vocab)
        np.testing.assert_allclose(float(loss), float(full), rtol=1e-6)
        np.testing.assert_allclose(
            float(ours.forward_loss(params, *targs, loss_mask=tmask,
                                    loss_chunk=96)[0]), float(loss),
            rtol=1e-6)


def test_forward_loss_rejects_a_ragged_chunk():
    model = ST.build_model(C.get_smoke("h2o-danube-1.8b").resolve(1),
                           dtype=torch.float32, device="cpu")
    params = model.init_params(0)
    tok = torch.zeros((1, 40), dtype=torch.int32)
    with pytest.raises(ValueError, match="loss chunk"):
        model.forward_loss(params, tok, tok, loss_chunk=32)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "phi4-mini-3.8b"])
def test_remat_gives_the_same_gradients(arch):
    cfg = C.get_smoke(arch).resolve(1)
    rng = np.random.default_rng(5)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)),
                          dtype=torch.int32)
    lab = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)),
                          dtype=torch.int32)
    grads = []
    for remat in (False, True):
        model = ST.build_model(cfg, remat=remat, q_chunk=32, kv_chunk=32,
                               dtype=torch.float32, device="cpu")
        params = model.init_params(0)
        g, loss, _ = ST.make_grad_fn(model)(params, {"tokens": tok,
                                                     "labels": lab})
        grads.append((float(loss), g))
    assert grads[0][0] == grads[1][0]
    # the recompute repeats the forward bit for bit; only the order in
    # which autograd accumulates the embedding rows' scatter-add (threads
    # on the CPU) may differ, by float32 rounding
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-8)


# ---- the launcher -----------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_launcher_on_the_cpu(arch, capsys):
    losses = TR.main(["--arch", arch, "--smoke", "--steps", "2",
                      "--device", "cpu", "--seq", "64"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "step   1 loss" in out


def test_launcher_and_train_step_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is the default here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.main(["--arch", "h2o-danube-1.8b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ST.make_train_step(ST.build_model(
            C.get_smoke("qwen2.5-14b").resolve(1)))


def test_configs_registry():
    assert set(DENSE + MOE) <= set(C.ARCH_NAMES)
    for arch in DENSE + MOE:
        for get, jget in ((C.get_full, JC.get_full),
                          (C.get_smoke, JC.get_smoke)):
            assert dataclasses.asdict(get(arch)) == dataclasses.asdict(
                jget(arch))
        for shape in ("train_4k", "long_500k"):
            assert C.supports_shape(arch, shape) == JC.supports_shape(
                arch, shape)
    assert C.LONG_CONTEXT_ARCHS == JC.LONG_CONTEXT_ARCHS
    assert C.ARCH_NAMES == JC.ARCH_NAMES
    with pytest.raises(KeyError, match="unknown arch"):
        C.get_full("no-such-arch")
