"""K2-bwd's plain version and the op's backward against the JAX package,
on the CPU (the kernel itself runs in ``tests/test_torch_gpu.py``, marker
``gpu``).

- ``ref.attention_bwd_plain`` (FA2's backward from the forward's output
  and row log-sum-exp, in float32, one query chunk at a time) against
  ``jax.vjp`` of the reference's blockwise scan
  (``repro.models.layers.flash_attention``) on KV heads expanded by
  ``kv_map``: S = 100 (no multiple of the chunks of 32), groups 1, 4 and 8
  (Hkv = 1 among them), window None, 5 and 24, causal and not (then T =
  128 != S: the reference attends its zero-padded keys when causal is
  off, so T is a multiple of its chunk), hd 16 and 80.  Both sides are
  float32 and differ by summation order: atol 1e-5, as
  ``test_op_gradient_matches_jax_grad``.  The op's gradient goes the same
  way on CPU tensors and is held to the same.
- bf16 inputs (the bf16 forward's output rounded to bf16, as the card's
  train step saves it) against a float64 autograd of ``attention_plain``:
  max |err| / max |ref| and the relative rms error within 1e-2 each, the
  limits the smoke holds K2-bwd to on the card.
- ``attention_plain(..., lse=True)``'s row log-sum-exp against a float64
  ``logsumexp`` of the masked scores, and its output bit-equal to the
  plain forward's without it.
- The stand-ins on fake tensors: the forward without autograd counts
  ``flash_attention_fwd`` only (nothing stores an lse when serving); under
  autograd ``flash_attention_fwd_lse`` and ``flash_attention_bwd`` give
  the shapes of out, lse and dq/dk/dv and count 4 hd and 10 hd FLOPs a
  (query, key) pair and query head.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.models import layers as JL
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (NEG_INF, attention_mask,
                                                     attention_bwd_plain,
                                                     attention_plain)

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)


def _inputs(B, S, T, Hkv, G, hd, seed):
    rng = np.random.default_rng(seed)

    def rand(*shape, scale=0.5):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return (rand(B, S, Hkv * G, hd), rand(B, T, Hkv, hd), rand(B, T, Hkv, hd),
            rand(B, S, Hkv * G, hd, scale=1.0))


# (S, T, causal, Hkv, G, window, hd)
CASES = [(100, 100, True, 2, 1, None, 16),
         (100, 100, True, 2, 4, 5, 16),
         (100, 100, True, 1, 8, 24, 16),
         (100, 100, True, 1, 4, None, 80),
         (100, 100, True, 2, 4, 24, 80),
         (100, 128, False, 2, 4, None, 16),
         (100, 128, False, 1, 8, 24, 16),
         (100, 128, False, 2, 1, 5, 80)]


@pytest.mark.parametrize("S, T, causal, Hkv, G, window, hd", CASES)
def test_bwd_plain_matches_jax_vjp(S, T, causal, Hkv, G, window, hd):
    q, k, v, dout = _inputs(2, S, T, Hkv, G, hd, seed=S + T + G + hd)
    kv_map = np.arange(Hkv * G) // G

    def f(q, k, v):
        return JL.flash_attention(q, jnp.take(k, kv_map, axis=2),
                                  jnp.take(v, kv_map, axis=2), causal=causal,
                                  window=window, q_chunk=32, kv_chunk=32)

    ref, vjp = jax.vjp(f, q, k, v)
    jgrads = vjp(jnp.asarray(dout))
    tq, tk, tv, tg = (torch.tensor(a) for a in (q, k, v, dout))
    out, lse = attention_plain(tq, tk, tv, causal=causal, window=window,
                               lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    grads = attention_bwd_plain(tq, tk, tv, out, tg, lse, causal=causal,
                                window=window, q_chunk=32)
    # the op on CPU tensors: the plain forward, then the plain backward
    args = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    op_out = ops.flash_attention(*args, causal=causal, window=window,
                                 q_chunk=32, kv_chunk=32)
    op_grads = torch.autograd.grad(op_out, args, tg)
    for g, og, j in zip(grads, op_grads, jgrads):
        assert g.shape == og.shape == j.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(og.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("q_chunk", [16, 37, 89])
def test_bwd_plain_query_chunks_change_only_rounding(q_chunk):
    """The chunking changes dq, dk and dv by float32 rounding only: the
    order of the chunks' sums, and the matmuls' own order over a chunk's
    key range (a chunk of one query takes another BLAS path), against
    one chunk of all 90 queries."""
    q, k, v, dout = (torch.tensor(a) for a in _inputs(1, 90, 90, 2, 2, 16,
                                                      seed=4))
    out, lse = attention_plain(q, k, v, window=20, lse=True)
    whole = attention_bwd_plain(q, k, v, out, dout, lse, window=20,
                                q_chunk=90)
    parts = attention_bwd_plain(q, k, v, out, dout, lse, window=20,
                                q_chunk=q_chunk)
    for a, b in zip(whole, parts):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("window, G", [(None, 4), (40, 1), (7, 8)])
def test_bwd_plain_bf16_against_float64(window, G):
    q, k, v, dout = (torch.tensor(a).bfloat16()
                     for a in _inputs(2, 160, 160, 2, G, 64, seed=G))
    out, lse = attention_plain(q, k, v, window=window, lse=True)
    grads = attention_bwd_plain(q, k, v, out, dout, lse, window=window,
                                q_chunk=64)
    args = [t.double().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(attention_plain(*args, window=window), args,
                              dout.double())
    for g, r in zip(grads, ref):
        assert g.dtype == torch.bfloat16
        err = g.double() - r
        assert float(err.abs().max() / r.abs().max()) <= 1e-2
        assert float(err.norm() / r.norm()) <= 1e-2


@pytest.mark.parametrize("causal, T, window", [(True, 70, None),
                                               (True, 70, 9),
                                               (False, 50, 30)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lse_matches_float64_logsumexp(causal, T, window, dtype):
    q, k, v, _ = (torch.tensor(a).to(dtype)
                  for a in _inputs(2, 70, T, 2, 3, 32, seed=T))
    out, lse = attention_plain(q, k, v, causal=causal, window=window,
                               lse=True)
    plain = attention_plain(q, k, v, causal=causal, window=window)
    assert torch.equal(out.view(torch.int16 if dtype == torch.bfloat16 else
                                torch.int32),
                       plain.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))
    assert lse.shape == (2, 6, 70) and lse.dtype == torch.float32
    q64 = q.double().transpose(1, 2)
    k64 = k.double().repeat_interleave(3, dim=2).transpose(1, 2)
    s = q64 @ k64.transpose(-1, -2) / np.sqrt(32)
    mask = attention_mask(70, T, causal=causal, window=window)
    ref = torch.logsumexp(torch.where(mask, s, NEG_INF), dim=-1)
    torch.testing.assert_close(lse.double(), ref, rtol=0, atol=1e-5)


def _pairs(S, T, causal, window):
    return int(attention_mask(S, T, causal=causal, window=window).sum())


@pytest.mark.parametrize("causal, window", [(True, None), (True, 24),
                                            (False, None)])
def test_stand_ins_count_the_kernels(causal, window):
    B, S, T, Hq, Hkv, hd = 2, 100, 100, 8, 2, 16
    pairs = _pairs(S, T, causal, window)
    assert ops.attended_pairs(S, T, causal=causal, window=window) == pairs
    with FakeTensorMode():
        q = torch.empty(B, S, Hq, hd, requires_grad=True)
        k = torch.empty(B, T, Hkv, hd, requires_grad=True)
        v = torch.empty(B, T, Hkv, hd, requires_grad=True)
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
        counts = fc.get_flop_counts()["Global"]
        assert out.shape == q.shape
        assert [str(op) for op in counts] == [
            "repro_torch.flash_attention_fwd"]
        assert fc.get_total_flops() == 4 * hd * B * Hq * pairs
        with FlopCounterMode(display=False) as fc:
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            saved = out.grad_fn.saved_tensors
            grads = torch.autograd.grad(out, (q, k, v),
                                        torch.empty_like(out))
        counts = {str(op): n for op, n in
                  fc.get_flop_counts()["Global"].items()}
    assert counts == {"repro_torch.flash_attention_fwd_lse":
                      4 * hd * B * Hq * pairs,
                      "repro_torch.flash_attention_bwd":
                      10 * hd * B * Hq * pairs}
    assert [tuple(g.shape) for g in grads] == [(B, S, Hq, hd),
                                               (B, T, Hkv, hd),
                                               (B, T, Hkv, hd)]
    assert tuple(saved[4].shape) == (B, Hq, S)
    assert saved[4].dtype == torch.float32
