"""Port tests that need an NVIDIA GPU (marker ``gpu``; skipped elsewhere).

This file imports neither ``jax`` nor ``repro``, so it runs on a machine
that has only PyTorch: K1 and K2 against their plain versions on the card
(K2 in bf16 on its tensor-core kernel, in float32 on its CUDA-core one),
K1's autograd op, the wrappers' input checks and launch counts, the LM on
the card against the LM on the CPU, and the default device of the entry
points.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_grad_plain,
                                                   embedding_bag_plain)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("dim", [128, 384])
@pytest.mark.parametrize("pool", [1, 7, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, dim, pool, dtype):
    rng = np.random.default_rng(dim + pool)
    arena = torch.as_tensor(rng.normal(size=(500, dim)), dtype=torch.float32,
                            device=cuda).to(dtype)
    idx = torch.as_tensor(rng.integers(0, 500, (1000, pool)),
                          dtype=torch.int32, device=cuda)
    out = embedding_bag_cuda(arena, idx)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    # same float32 additions in the same order as the plain version
    torch.testing.assert_close(out, embedding_bag_plain(arena, idx),
                               rtol=0, atol=0)


def test_autograd_on_cuda(cuda):
    rng = np.random.default_rng(2)
    arena = torch.as_tensor(rng.normal(size=(30, 128)), dtype=torch.float32,
                            device=cuda).requires_grad_()
    idx = torch.as_tensor(rng.integers(1, 30, (6, 4)), dtype=torch.int32,
                          device=cuda)
    (ops.embedding_bag(arena, idx) ** 2).sum().backward()
    out = embedding_bag_plain(arena.detach(), idx)
    gref = embedding_bag_grad_plain(arena.shape, idx, 2 * out)
    torch.testing.assert_close(arena.grad, gref, rtol=1e-4, atol=1e-4)


def test_fused_lookup_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(1)
    tables = [torch.as_tensor(rng.normal(size=(r, d)), dtype=torch.float32)
              for r, d in [(64, 16), (32, 48), (128, 16), (16, 128)]]
    idx = rng.integers(0, 16, (4, 6, 7))
    idx[rng.random(idx.shape) < 0.25] = -1
    idx = torch.as_tensor(idx, dtype=torch.int32)
    arena, bases = ops.build_arena(tables)
    ref = ops.fused_embedding_lookup(arena, bases, idx)
    out = ops.fused_embedding_lookup(arena.to(cuda), bases, idx.to(cuda))
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-6, atol=1e-6)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    arena = torch.zeros((10, 128), device=cuda)
    idx = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        embedding_bag_cuda(arena, idx.long())
    with pytest.raises(TypeError):
        embedding_bag_cuda(arena.half(), idx)
    with pytest.raises(ValueError):
        embedding_bag_cuda(torch.zeros((10, 64), device=cuda), idx)
    with pytest.raises(ValueError):
        embedding_bag_cuda(arena, idx.t())
    with pytest.raises(ValueError):
        embedding_bag_cuda(arena.cpu(), idx)


def test_launch_count_counts_launches(cuda):
    arena = torch.zeros((10, 128), device=cuda)
    idx = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    n0 = embedding_bag_cuda.launches
    ops.embedding_bag(arena, idx)
    ops.embedding_bag(arena.cpu(), idx.cpu())      # plain version: no launch
    embedding_bag_cuda(arena, idx[:0])             # no bags: no launch
    assert embedding_bag_cuda.launches == n0 + 1


def test_entry_points_default_to_cuda(cuda):
    from repro_torch.api import SimOracle
    from repro_torch.core.trainer import DreamShard
    from repro_torch.data.synthetic import make_dlrm_pool
    from repro_torch.data.tasks import make_benchmark_suite
    from repro_torch.device import resolve_device
    from repro_torch.profiling.microbench import make_inputs

    assert resolve_device().type == "cuda"
    train, test = make_benchmark_suite(make_dlrm_pool(0), 8, 2, n_tasks=2)
    agent = DreamShard(train, SimOracle(seed=0))
    assert next(agent.cost_net.parameters()).is_cuda
    assert agent.as_placer().place(test[0]).assignment.shape == (8,)
    assert all(t.is_cuda for t in make_inputs(128, 100, 4, 2))


def _qkv(seed, B, S, T, Hq, Hkv, hd, dtype, device):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.as_tensor(rng.normal(size=shape) * 0.5,
                               dtype=torch.float32, device=device).to(dtype)
    return mk(B, S, Hq, hd), mk(B, T, Hkv, hd), mk(B, T, Hkv, hd)


@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("S,window,group", [(100, None, 1), (384, 64, 4)])
def test_flash_kernel_matches_plain(cuda, hd, dtype, tol, S, window, group):
    q, k, v = _qkv(S + hd, 2, S, S, 4 * group, 4, hd, dtype, cuda)
    out = flash_attention_cuda(q, k, v, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(),
                               attention_plain(q, k, v,
                                               window=window).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,max_abs,rel_rms", [(torch.float32, 2e-4, 1e-4),
                                                   (torch.bfloat16, 4e-3, 1e-2)])
def test_flash_kernel_long_window(cuda, dtype, max_abs, rel_rms):
    # rows past the window: the limits sit below a typical |out|, so a key
    # let in or left out at the window's edge shows
    q, k, v = _qkv(6, 1, 2048, 2048, 8, 2, 80, dtype, cuda)
    out = flash_attention_cuda(q, k, v, window=700).float()
    ref = attention_plain(q, k, v, window=700).float()
    wide = attention_plain(q, k, v, window=701).float()
    assert float((out - ref).abs().max()) <= max_abs
    assert float((out - ref).norm() / ref.norm()) <= rel_rms
    assert float((wide - ref).abs().max()) > max_abs


def test_flash_kernel_non_causal_ragged_keys(cuda):
    q, k, v = _qkv(3, 1, 100, 77, 4, 2, 80, torch.float32, cuda)
    out = flash_attention_cuda(q, k, v, causal=False)
    torch.testing.assert_close(out, attention_plain(q, k, v, causal=False),
                               rtol=2e-4, atol=2e-4)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(4, 1, 64, 64, 4, 2, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention_cuda(q.cpu(), k, v)
    with pytest.raises(TypeError):
        flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(*_qkv(4, 1, 8, 8, 2, 2, 96, torch.float32,
                                   cuda))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2),
                             k, v)
    with pytest.raises(ValueError, match="match"):
        flash_attention_cuda(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="window"):
        flash_attention_cuda(q, k, v, window=0)
    # the bf16 kernel takes its row max on the unscaled scores
    with pytest.raises(RuntimeError, match="invalid argument"):
        flash_attention_cuda(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                             scale=0.0)


def test_flash_launch_count_counts_launches(cuda):
    q, k, v = _qkv(5, 1, 64, 64, 2, 2, 64, torch.float32, cuda)
    n0 = flash_attention_cuda.launches
    flash_ops.flash_attention(q, k, v)
    flash_ops.flash_attention(q.cpu(), k.cpu(), v.cpu())  # plain: no launch
    flash_attention_cuda(q[:, :0], k, v)                   # no rows: none
    assert flash_attention_cuda.launches == n0 + 1


def _qkv_served(seed, B, S, T, Hq, Hkv, hd, device):
    """bf16 q, k at std 0.5 and v at std 0.1, so |out| < 0.5, where one
    bf16 step is at most 1.95e-3 (the served outputs are smaller still):
    the 4e-3 limit then tests the kernel, not the output's rounding."""
    rng = np.random.default_rng(seed)

    def mk(std, *shape):
        return torch.as_tensor(rng.normal(size=shape) * std,
                               dtype=torch.float32,
                               device=device).to(torch.bfloat16)
    return (mk(0.5, B, S, Hq, hd), mk(0.5, B, T, Hkv, hd),
            mk(0.1, B, T, Hkv, hd))


def _assert_bf16_limits(out, ref):
    """The limits the served shapes are held to: max |err| <= 4e-3 and
    rms(err) / rms(ref) <= 1e-2."""
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    diff = out.float() - ref.float()
    assert float(diff.abs().max()) <= 4e-3
    assert float(diff.norm()) <= 1e-2 * float(ref.float().norm())


@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("S", [1, 63, 65, 127, 129, 1000])
def test_bf16_tensor_cores_ragged_lengths(cuda, hd, S):
    # S = T, no tile multiple (64 keys; 32 at hd 256): the copy zero-fills
    # the tail and the last tile is masked by T
    q, k, v = _qkv_served(7 * S + hd, 2, S, S, 4, 2, hd, cuda)
    _assert_bf16_limits(flash_attention_cuda(q, k, v),
                        attention_plain(q, k, v))


@pytest.mark.parametrize("hd", [64, 80, 256])
@pytest.mark.parametrize("window", [31, 32, 33, 63, 64, 65, 128, 129])
def test_bf16_tensor_cores_window_edges(cuda, hd, window):
    # windows whose edge falls on or beside a key-tile boundary
    q, k, v = _qkv_served(window + hd, 1, 300, 300, 4, 2, hd, cuda)
    _assert_bf16_limits(flash_attention_cuda(q, k, v, window=window),
                        attention_plain(q, k, v, window=window))


@pytest.mark.parametrize("hd", [80, 128])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_bf16_tensor_cores_gqa_groups(cuda, hd, group):
    q, k, v = _qkv_served(group + hd, 2, 257, 257, 2 * group, 2, hd, cuda)
    _assert_bf16_limits(flash_attention_cuda(q, k, v, window=100),
                        attention_plain(q, k, v, window=100))


@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("S,T", [(1, 1000), (65, 63), (129, 127), (300, 77),
                                 (1000, 129)])
def test_bf16_tensor_cores_non_causal_ragged_keys(cuda, hd, S, T):
    q, k, v = _qkv_served(S + T + hd, 1, S, T, 4, 2, hd, cuda)
    _assert_bf16_limits(flash_attention_cuda(q, k, v, causal=False),
                        attention_plain(q, k, v, causal=False))


def test_bf16_causal_does_not_depend_on_tile_order(cuda):
    # the grid runs q tiles heaviest first; a launch over one (b, KV group)
    # at a time schedules the same tiles in another order and on other
    # blocks, and must give the same bits
    q, k, v = _qkv_served(11, 2, 1000, 1000, 8, 2, 80, cuda)
    full = flash_attention_cuda(q, k, v, window=300)
    for b in range(2):
        for g in range(2):
            part = flash_attention_cuda(
                q[b:b + 1, :, 4 * g:4 * g + 4].contiguous(),
                k[b:b + 1, :, g:g + 1].contiguous(),
                v[b:b + 1, :, g:g + 1].contiguous(), window=300)
            assert torch.equal(part, full[b:b + 1, :, 4 * g:4 * g + 4])
    assert torch.equal(flash_attention_cuda(q, k, v, window=300), full)
    _assert_bf16_limits(full, attention_plain(q, k, v, window=300))


def test_lm_on_cuda_matches_cpu(cuda):
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import LM, map_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke("h2o-danube-1.8b").resolve(1)
    gpu = LM(cfg, dtype=torch.float32)
    cpu = LM(cfg, dtype=torch.float32, device="cpu")
    params = gpu.init_params(0)
    cparams = map_params(torch.Tensor.cpu, params)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 96)), dtype=torch.int32)
    n0 = flash_attention_cuda.launches
    logits, cache = gpu.prefill(params, tokens.to(cuda), capacity=100)
    clogits, ccache = cpu.prefill(cparams, tokens, capacity=100)
    assert flash_attention_cuda.launches == n0 + cfg.n_layers
    torch.testing.assert_close(logits.cpu(), clogits, rtol=1e-4, atol=1e-4)
    tok = clogits[:, -1].argmax(-1, keepdim=True)
    for _ in range(3):
        logits, cache = gpu.decode_step(params, cache, tok.to(cuda))
        clogits, ccache = cpu.decode_step(cparams, ccache, tok)
        torch.testing.assert_close(logits.cpu(), clogits, rtol=1e-4,
                                   atol=1e-4)
        tok = clogits[:, -1].argmax(-1, keepdim=True)
