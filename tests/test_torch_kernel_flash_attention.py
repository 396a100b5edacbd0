"""Flash attention (K2) of the port against the JAX package, on the CPU.

Seeded numpy inputs go to both packages.  The port's op runs its plain
version on CPU tensors; the JAX side is the Pallas kernel in interpret
mode (``ops.flash_attention``, as ``tests/test_kernel_flash_attention.py``
runs it), the blockwise scan of the LM (``models.layers.flash_attention``,
given KV heads expanded by ``kv_map`` where the port takes them grouped),
and ``attention_ref`` where the JAX op's padding would attend to padded
keys (non-causal, ragged T).  Tolerances are the reference sweep's: 2e-4
for float32, 3e-2 for bfloat16 (inputs rounded to bf16 the same way on
both sides; outputs rounded once more).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.layers import flash_attention as jax_model_flash
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                    attention_plain)

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * 0.5).astype(np.float32) for s in shapes]


def _jax(a, dtype):
    return jnp.asarray(a, JNP[dtype])


def _torch(a, dtype):
    return torch.as_tensor(a).to(TORCH[dtype])


def _close(out_torch, ref_jax, tol):
    np.testing.assert_allclose(out_torch.float().numpy(),
                               np.asarray(ref_jax, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("S", [128, 256, 384])
@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas_kernel(S, hd, dtype):
    q, k, v = _arrays(S + hd, *[(1, S, 2, hd)] * 3)
    ref = jops.flash_attention(_jax(q, dtype), _jax(k, dtype),
                               _jax(v, dtype), q_block=128, kv_block=128)
    out = ops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                              _torch(v, dtype))
    assert out.dtype == TORCH[dtype] and out.shape == (1, S, 2, hd)
    _close(out, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sliding_window_matches_pallas_kernel(dtype):
    q, k, v = _arrays(4, *[(1, 256, 1, 128)] * 3)
    ref = jops.flash_attention(_jax(q, dtype), _jax(k, dtype),
                               _jax(v, dtype), window=64, q_block=128,
                               kv_block=128)
    out = ops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                              _torch(v, dtype), window=64)
    _close(out, ref, TOL[dtype])


@pytest.mark.parametrize("hd", [64, 80])
def test_head_dims_the_tpu_op_pads(hd):
    """The JAX op pads hd to 128 lanes (scale from the true hd); the port
    takes hd as it is."""
    q, k, v = _arrays(5 + hd, *[(1, 128, 2, hd)] * 3)
    ref = jops.flash_attention(_jax(q, "float32"), _jax(k, "float32"),
                               _jax(v, "float32"))
    out = ops.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v))
    _close(out, ref, TOL["float32"])


def test_odd_sequence_length():
    q, k, v = _arrays(6, *[(1, 100, 1, 128)] * 3)
    ref = jops.flash_attention(_jax(q, "float32"), _jax(k, "float32"),
                               _jax(v, "float32"), q_block=64, kv_block=64)
    out = ops.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v))
    _close(out, ref, TOL["float32"])


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_kv_matches_model_blockwise_scan(window, dtype):
    """GQA: the port reads KV head h // G from unexpanded k, v; the JAX
    LM expands them by ``kv_map`` first."""
    B, S, Hq, Hkv, hd = 2, 128, 8, 2, 80
    q, k, v = _arrays(7, (B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))
    kv_map = np.arange(Hq) // (Hq // Hkv)
    ref = jax_model_flash(_jax(q, dtype), _jax(k, dtype)[:, :, kv_map],
                          _jax(v, dtype)[:, :, kv_map], causal=True,
                          window=window, q_chunk=32, kv_chunk=32)
    out = ops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                              _torch(v, dtype), window=window)
    _close(out, ref, TOL[dtype])


@pytest.mark.parametrize("window", [None, 30])
def test_non_causal_ragged_keys_mask_by_true_length(window):
    """Non-causal with T unlike any block multiple: the port masks keys by
    their true length, as ``attention_ref`` does (the JAX op would attend
    to its zero-padded keys here)."""
    B, S, T, H, hd = 1, 100, 77, 2, 64
    q, k, v = _arrays(8, (B, S, H, hd), (B, T, H, hd), (B, T, H, hd))

    def fold(a):
        return jnp.moveaxis(jnp.asarray(a), 2, 1).reshape(B * H, -1, hd)

    ref = attention_ref(fold(q), fold(k), fold(v), causal=False,
                        window=window)
    ref = jnp.moveaxis(ref.reshape(B, H, S, hd), 1, 2)
    out = ops.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), causal=False,
                              window=window)
    _close(out, ref, TOL["float32"])


def test_op_on_cpu_is_the_plain_version_with_its_scale():
    q, k, v = _arrays(9, (1, 40, 4, 64), (1, 40, 2, 64), (1, 40, 2, 64))
    q, k, v = map(torch.as_tensor, (q, k, v))
    n0 = flash_attention_cuda.launches
    out = ops.flash_attention(q, k, v, window=16, scale=0.3)
    assert flash_attention_cuda.launches == n0
    torch.testing.assert_close(
        out, attention_plain(q, k, v, window=16, scale=0.3), rtol=0, atol=0)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v),
        attention_plain(q, k, v, scale=1 / 8.0), rtol=0, atol=0)


def test_op_refuses_what_no_version_takes():
    q = torch.zeros((1, 8, 3, 64))
    with pytest.raises(ValueError, match="group"):
        ops.flash_attention(q, torch.zeros((1, 8, 2, 64)),
                            torch.zeros((1, 8, 2, 64)))
    with pytest.raises(ValueError, match="zero keys"):
        ops.flash_attention(q, torch.zeros((1, 0, 3, 64)),
                            torch.zeros((1, 0, 3, 64)))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention_cuda(q, q, q)



def _attention_tc_numerics(q, k, v, *, window, split_edges=True):
    """``attention_plain`` with the bf16 tensor-core kernel's rounding: P
    = exp(s - row max) rounded to bf16 before P . V, the row sum taken
    from the float32 P, and -- with ``split_edges`` -- P kept as bf16(p) +
    bf16(p - bf16(p)) on the key tiles the kernel masks (64 keys a tile,
    32 at hd 256, 64 query rows).  The kernel's running max scales P by
    other factors; the relative rounding is the same."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    keys = 32 if hd == 256 else 64
    mask = attention_mask(S, T, causal=True, window=window)
    q0 = (torch.arange(S)[:, None] // 64) * 64
    k0 = (torch.arange(T)[None, :] // keys) * keys
    edge = (k0 + keys > T) | (k0 + keys - 1 > q0) | (q0 + 63 - k0 >= window)
    out = torch.empty_like(q)
    for b in range(B):
        qb = q[b].float().transpose(0, 1)
        kb = k[b].float().repeat_interleave(Hq // Hkv, dim=1).transpose(0, 1)
        vb = v[b].float().repeat_interleave(Hq // Hkv, dim=1).transpose(0, 1)
        s = torch.matmul(qb, kb.transpose(1, 2)) / hd ** 0.5
        s = torch.where(mask, s, -torch.inf)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        hi = p.bfloat16().float()
        if split_edges:
            hi = torch.where(edge, hi + (p - hi).bfloat16().float(), hi)
        o = torch.matmul(hi, vb) / p.sum(-1, keepdim=True)
        out[b] = o.transpose(0, 1).to(q.dtype)
    return out


def _bf16_inputs(S, Hq, hd, v_std):
    rng = np.random.default_rng(6)
    return (torch.as_tensor(rng.normal(size=shape) * std,
                            dtype=torch.float32).bfloat16()
            for shape, std in (((1, S, Hq, hd), 0.5), ((1, S, 2, hd), 0.5),
                               ((1, S, 2, hd), v_std)))


@pytest.mark.parametrize("S,Hq,hd,window,v_std", [
    (2048, 8, 80, 700, 0.5),    # the GPU tests' long-window case
    (1000, 4, 256, 129, 0.1),   # the GPU sweep's served-scale inputs
])
def test_tensor_core_numerics_fit_the_kernel_limits(S, Hq, hd, window,
                                                    v_std):
    """The bf16 kernel's numerics stay within the limits the card holds it
    to -- max |err| <= 4e-3, rms(err) / rms(ref) <= 1e-2 -- of the plain
    version, which keeps P in float32."""
    q, k, v = _bf16_inputs(S, Hq, hd, v_std)
    ref = attention_plain(q, k, v, window=window).float()
    diff = _attention_tc_numerics(q, k, v, window=window).float() - ref
    assert float(diff.abs().max()) <= 4e-3
    assert float(diff.norm() / ref.norm()) <= 1e-2
    assert float(diff.abs().max()) > 0       # P's rounding does show


def test_bf16_p_alone_breaks_the_limit_on_few_key_rows():
    """Why the kernel splits P on its edge tiles: rounded once to bf16, P
    moves the outputs of the first rows (two or three keys, |out| about 1,
    where a bf16 step is 7.8e-3) across a rounding boundary."""
    q, k, v = _bf16_inputs(2048, 8, 80, 0.5)
    ref = attention_plain(q, k, v, window=700).float()
    diff = (_attention_tc_numerics(q, k, v, window=700, split_edges=False)
            .float() - ref).abs()
    assert float(diff[:, :8].max()) > 4e-3
    assert float(diff[:, 64:].max()) <= 4e-3
