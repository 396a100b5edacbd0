"""Port tests that need an NVIDIA GPU (marker ``gpu``; skipped elsewhere).

This file imports neither ``jax`` nor ``repro``, so it runs on a machine
that has only PyTorch: K1's forward and backward and K2 against their
plain versions on the card (K2 in bf16 on its tensor-core kernel, in
float32 on its CUDA-core one), K1's autograd op, the wrappers' input
checks and launch counts, the LM on the card against the LM on the CPU,
the default device of the entry points, K2-bwd (the attention backward)
against its plain version's float64 run and its bits on two calls, the
flash attention op's backward and the LM train step on the card against
the CPU, a tiny ``KernelOracle``
calibration on the card (it launches K1), one training iteration on
the card against the CPU on the cost stage, the distributed embedding
lookup over NCCL at one rank (bit-equal to ``lookup_unsharded``),
three DLRM training steps on the card against the CPU (1e-5 relative),
a column-sharded lookup against the whole-table plan's, b11's quick
serving regime replayed through ``PlacementService`` on the card against
the CPU, with a JSONL trace of a served replay, and the RNN baseline on
the card against the CPU (its reprs under the default cuDNN flags, one
update's gradient and its greedy placements), K3 and K4 (the SSM's and
RWKV's scans) and their backward kernels (K3-bwd, K4-bwd) against
their plain versions and a float64 run, the scans' ops training through
the kernels, hymba and rwkv at SMOKE on the card against the CPU (serve
and a train step's gradients), the placement decode's batch invariance (a task decoded alone
and in batches of 3, 16 and 20: every step's logits bit-equal), and the
frontend archs (K2 at musicgen-large's and llava-next-34b's head shapes,
their SMOKE prefill, decode and gradients on the card against the CPU).

K1's forward adds in the plain version's order, so the two are held bit
for bit.  Its backward adds in another order (by row, in chunks), so it is
held bit for bit to the plain replay of that order
(``ref.embedding_bag_grad_replay``) and to the plain ``index_add_`` on
integer-valued gradients (every sum exact), and otherwise to a float64
``index_add_``: its max |err| at most twice the plain float32 version's
own plus 1e-6.  The plan it builds on the card equals ``backward_plan``
array for array, and a call makes no host sync.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.kernel import (CHUNK, backward_plan,
                                                     embedding_bag_cuda,
                                                     embedding_bag_grad_cuda)
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_grad_plain,
                                                   embedding_bag_grad_replay,
                                                   embedding_bag_plain)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda, flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_plain,
                                                     attention_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    """float32 matmuls without TF32 for one test, restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


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


def _bits(t):
    return t.contiguous().view(torch.int32)


def _assert_bits_equal(out, ref):
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert torch.equal(_bits(out), _bits(ref))      # +0 and -0 differ here


@pytest.mark.parametrize("pool", [1, 31, 32, 33, 199])
@pytest.mark.parametrize("dim", [128, 384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row0", ["random", "+0", "-0", "mixed"])
def test_kernel_bit_equal_with_padding_anywhere(cuda, pool, dim, dtype, row0):
    # padding slots (index 0) at arbitrary positions, over a non-zero, a
    # zero, a negative-zero and a mixed-sign-zero row 0
    rng = np.random.default_rng(pool * dim)
    arena = torch.as_tensor(rng.normal(size=(400, dim)), dtype=torch.float32,
                            device=cuda).to(dtype)
    if row0 != "random":
        arena[0] = -0.0 if row0 == "-0" else 0.0
    if row0 == "mixed":
        arena[0, ::3] = -0.0
    idx = rng.integers(1, 400, (257, pool))
    idx[rng.random(idx.shape) < 0.6] = 0
    idx[0] = 0                                     # all padding
    idx[1, :pool // 2] = 0                         # padded in front
    idx[2, pool // 2:] = 0                         # padded behind
    idx = torch.as_tensor(idx, dtype=torch.int32, device=cuda)
    _assert_bits_equal(embedding_bag_cuda(arena, idx),
                       embedding_bag_plain(arena, idx))


def _grad_f64(shape, idx, grad_out):
    g = torch.zeros(shape, dtype=torch.float64, device=grad_out.device)
    for j in range(idx.shape[1]):
        g.index_add_(0, idx[:, j], grad_out.double())
    g[0] = 0.0
    return g


def _grad_inputs(seed, rows, bags, pool, hot, pad, dim, dtype, integer,
                 device):
    """Indices with one hot row taking a ``hot`` share of the slots (a
    run longer than the chunk), a ``pad`` share of padding and three
    all-padding bags, and a gradient (integer-valued or normal)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(1, rows, (bags, pool))
    idx[rng.random(idx.shape) < hot] = 1 + rng.integers(0, rows - 1)
    idx[rng.random(idx.shape) < pad] = 0
    idx[:3] = 0
    g = (rng.integers(-2, 3, (bags, dim)) if integer
         else rng.normal(size=(bags, dim)))
    return (torch.as_tensor(idx, dtype=torch.int32, device=device),
            torch.as_tensor(g, dtype=torch.float32, device=device).to(dtype))


GRAD_CASES = [  # rows, bags, pool, hot share, padding share, dim
    (1000, 512, 8, 0.0, 0.3, 128),
    (1000, 4096, 33, 0.5, 0.5, 384),
    (300, 20000, 40, 0.9, 0.2, 128),               # a run past 64^2 slots
    (70000, 2048, 199, 0.3, 0.9, 128),             # the main path's mix
]


def _assert_plan_equal(arena_shape, idx):
    """The plan built on the card equals ``backward_plan``'s, array for
    array."""
    got = embedding_bag_grad_cuda.plan(arena_shape, idx).to_backward_plan()
    ref = backward_plan(idx, CHUNK)
    for name, a, b in zip(ref._fields, got, ref):
        assert a.shape == b.shape and torch.equal(a.long(), b.long()), name


@pytest.mark.parametrize("case", GRAD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("integer", [True, False])
def test_grad_kernel_matches_plain(cuda, case, dtype, integer):
    rows, bags, pool, hot, pad, dim = case
    idx, g = _grad_inputs(sum(case[:3]), rows, bags, pool, hot, pad, dim,
                          dtype, integer, cuda)
    out = embedding_bag_grad_cuda((rows, dim), idx, g)
    ref = embedding_bag_grad_plain((rows, dim), idx, g)
    assert out.dtype == torch.float32 and not out[0].any()
    _assert_bits_equal(out, embedding_bag_grad_replay((rows, dim), idx, g))
    if integer:
        _assert_bits_equal(out, ref)
    else:
        ref64 = _grad_f64((rows, dim), idx, g)
        err = float((out.double() - ref64).abs().max())
        plain_err = float((ref.double() - ref64).abs().max())
        assert err <= 2 * plain_err + 1e-6


@pytest.mark.parametrize("case", GRAD_CASES)
def test_grad_plan_on_the_card_is_backward_plan(cuda, case):
    rows, bags, pool, hot, pad, dim = case
    idx, _ = _grad_inputs(sum(case[:3]), rows, bags, pool, hot, pad, dim,
                          torch.float32, True, cuda)
    _assert_plan_equal((rows, dim), idx)


def test_grad_kernel_is_deterministic(cuda):
    idx, g = _grad_inputs(9, 300, 20000, 40, 0.9, 0.2, 128, torch.float32,
                          False, cuda)
    first = embedding_bag_grad_cuda((300, 128), idx, g)
    _assert_bits_equal(embedding_bag_grad_cuda((300, 128), idx, g), first)


def _past_2_31_inputs(cuda):
    n_rows = 2 ** 24 + 2 ** 20
    gen = torch.Generator(device=cuda).manual_seed(3)
    idx = torch.randint(n_rows - 2 ** 21, n_rows, (8192, 8), generator=gen,
                        device=cuda, dtype=torch.int32)
    idx[:, -1] = 0
    g = torch.randint(-2, 3, (8192, 128), generator=gen, device=cuda).float()
    return n_rows, idx, g


def test_grad_kernel_past_2_31_elements(cuda):
    # row * D overflows 32 bits in the gradient's rows here; R needs 4
    # radix passes
    n_rows, idx, g = _past_2_31_inputs(cuda)
    out = embedding_bag_grad_cuda((n_rows, 128), idx, g)
    _assert_bits_equal(out, embedding_bag_grad_plain((n_rows, 128), idx, g))
    _assert_plan_equal((n_rows, 128), idx)


def test_grad_kernel_makes_no_host_sync(cuda):
    idx, g = _grad_inputs(9, 300, 20000, 40, 0.9, 0.2, 128, torch.float32,
                          True, cuda)
    embedding_bag_grad_cuda((300, 128), idx, g)      # built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = embedding_bag_grad_cuda((300, 128), idx, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_bits_equal(out, embedding_bag_grad_plain((300, 128), idx, g))


def test_grad_kernel_writes_every_row(cuda):
    """The gradient is not zeroed first: a freed block full of NaN, of the
    gradient's size, is handed back by the caching allocator as the output
    (the call's first allocation), and must come back zero in every row
    that no slot touches."""
    rows, dim = 5000, 128
    idx, g = _grad_inputs(4, rows, 64, 3, 0.0, 0.5, dim, torch.float32,
                          True, cuda)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    nan = torch.full((rows, dim), float("nan"), device=cuda)
    ptr = nan.data_ptr()
    del nan
    out = embedding_bag_grad_cuda((rows, dim), idx, g)
    assert out.data_ptr() == ptr
    touched = torch.zeros(rows, dtype=torch.bool, device=cuda)
    touched[idx.reshape(-1).long()] = True
    touched[0] = False
    assert not out.isnan().any()
    assert not out[~touched].any()
    _assert_bits_equal(out, embedding_bag_grad_plain((rows, dim), idx, g))


def test_grad_kernel_all_padding_is_zero_in_one_launch(cuda):
    n0 = embedding_bag_grad_cuda.launches
    out = embedding_bag_grad_cuda((10, 128),
                                  torch.zeros((4, 3), dtype=torch.int32,
                                              device=cuda),
                                  torch.ones((4, 128), device=cuda))
    assert not out.any() and embedding_bag_grad_cuda.launches == n0 + 1


def test_grad_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    idx = torch.ones((4, 2), dtype=torch.int32, device=cuda)
    g = torch.ones((4, 128), device=cuda)
    with pytest.raises(TypeError):
        embedding_bag_grad_cuda((10, 128), idx.long(), g)
    with pytest.raises(TypeError):
        embedding_bag_grad_cuda((10, 128), idx, g.half())
    with pytest.raises(ValueError):
        embedding_bag_grad_cuda((10, 64), idx, g[:, :64].contiguous())
    with pytest.raises(ValueError):
        embedding_bag_grad_cuda((10, 256), idx, g)
    with pytest.raises(ValueError):
        embedding_bag_grad_cuda((10, 128), idx, g.cpu())
    with pytest.raises(ValueError):
        embedding_bag_grad_cuda((10, 128), idx.t().contiguous().t(), g)


def test_autograd_routes_to_both_kernels(cuda):
    rng = np.random.default_rng(5)
    arena = torch.as_tensor(rng.normal(size=(300, 128)), dtype=torch.float32,
                            device=cuda).requires_grad_()
    idx = torch.as_tensor(rng.integers(0, 300, (64, 9)), dtype=torch.int32,
                          device=cuda)
    fwd0, bwd0 = embedding_bag_cuda.launches, embedding_bag_grad_cuda.launches
    (ops.embedding_bag(arena, idx) * 3).sum().backward()
    assert embedding_bag_cuda.launches == fwd0 + 1
    assert embedding_bag_grad_cuda.launches == bwd0 + 1
    grad = torch.full((64, 128), 3.0, device=cuda)  # integer-valued: exact
    _assert_bits_equal(arena.grad,
                       embedding_bag_grad_plain(arena.shape, idx, grad))


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


def test_lm_on_cuda_matches_cpu(cuda, no_tf32):
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import LM, map_params
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


def test_tiny_kernel_oracle_calibration_launches_k1(cuda, tmp_path):
    from repro_torch.api import KernelOracle, MeasuredOracle
    from repro_torch.profiling.calibration import CalibrationTable
    n_fwd = embedding_bag_cuda.launches
    n_bwd = embedding_bag_grad_cuda.launches
    oracle = KernelOracle(batch_size=256, max_rows=2048, max_dim=256)
    table = oracle.measured().table
    # 4 grid points, 6 fused and 9 x 2 sharded shapes, 1 + 2 calls each
    assert embedding_bag_cuda.launches - n_fwd == 84
    assert embedding_bag_grad_cuda.launches - n_bwd == 84
    assert table.fingerprint["device_kind"] == torch.cuda.get_device_name()
    assert table.meta["device"] == "cuda"
    assert (table.fwd_ms > 0).all() and (table.bwd_ms > 0).all()
    raw = np.tile(np.random.default_rng(0).uniform(1, 64, (1, 21)), (6, 1))
    a = np.array([[0, 1, 0, 1, 0, 1]])
    loaded = MeasuredOracle(CalibrationTable.load(
        table.save(str(tmp_path / "art.npz"))))
    assert oracle.evaluate_many(raw, a, 2)[0].overall == \
        loaded.evaluate_many(raw, a, 2)[0].overall


def test_training_iteration_on_cuda_matches_cpu_on_the_cost_stage(cuda,
                                                                  no_tf32):
    """One iteration's collect on each device from the same seed (the
    same host-drawn noise), then the cost stage over the same samples and
    host-drawn slots: losses and weights within 1e-4 relative."""
    from repro_torch.api import SimOracle
    from repro_torch.core import networks as N
    from repro_torch.core.trainer import DreamShard, DreamShardConfig
    from repro_torch.data.synthetic import make_dlrm_pool
    from repro_torch.data.tasks import make_benchmark_suite
    train, _ = make_benchmark_suite(make_dlrm_pool(seed=0), 20, 4,
                                    n_tasks=4)
    cfg = DreamShardConfig(n_iterations=1, n_cost=50, n_rl=2, n_episode=4)
    gpu = DreamShard(train, SimOracle(seed=0), cfg)
    cpu = DreamShard(train, SimOracle(seed=0), cfg, device="cpu")
    for agent in (gpu, cpu):
        agent.collect()
    same = [np.array_equal(a.assignment, b.assignment)
            for a, b in zip(gpu.buffer, cpu.buffer)]
    assert np.mean(same) >= 0.5
    gpu.buffer = list(cpu.buffer)               # one ring for both
    losses = {}
    for name, agent in (("gpu", gpu), ("cpu", cpu)):
        agent._sync_ring()
        idx, w = agent._cost_slots(50)
        _, agent.cost_opt_state, losses[name] = agent._fused_cost_update(
            agent.cost_net, agent.cost_opt_state, agent._ring.data, idx, w)
    torch.testing.assert_close(losses["gpu"].cpu(), losses["cpu"],
                               rtol=1e-4, atol=0)
    for a, b in zip(N.params_to_jax(gpu.cost_net)["table_mlp"],
                    N.params_to_jax(cpu.cost_net)["table_mlp"]):
        np.testing.assert_allclose(a["w"], b["w"], rtol=1e-4,
                                   atol=1e-4 * np.abs(b["w"]).max())
    assert np.isfinite(gpu.update_policy())


def test_sharded_lookup_over_nccl_at_one_rank_is_bit_equal(cuda, tmp_path):
    """NCCL takes one rank a card: at world size 1 the distributed lookup
    (K1 + the all-to-all and its transpose) equals ``lookup_unsharded``
    bit for bit, forward and arena gradient."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import DLRMBatchStream
    from repro_torch.embedding import sharded as E
    from repro_torch.launch.train_dlrm import smoke_tables
    raw, plan = smoke_tables(1, 2 ** 12)
    gen = torch.Generator(device=cuda).manual_seed(0)
    (arena,) = E.init_arenas(plan, generator=gen, device=cuda)
    gidx = E.group_indices(plan, torch.from_numpy(
        DLRMBatchStream(raw, 256, seed=0).batch_at(0)["indices"]).to(cuda))
    w = torch.randn((256, plan.k_max, plan.dim), generator=gen, device=cuda)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        leaf = arena.clone().requires_grad_()
        n0 = embedding_bag_cuda.launches, embedding_bag_grad_cuda.launches
        out = E.make_sharded_lookup(plan, model_group=dist.group.WORLD)(
            [leaf], plan.base_rows, gidx)
        out.backward(w)
        torch.cuda.synchronize()
        assert (embedding_bag_cuda.launches - n0[0],
                embedding_bag_grad_cuda.launches - n0[1]) == (1, 1)
    finally:
        dist.destroy_process_group()
    ref_leaf = arena.clone().requires_grad_()
    ref = E.lookup_unsharded([ref_leaf], plan.base_rows, gidx, plan)
    ref.backward(w)
    assert torch.equal(out, ref)
    assert torch.equal(leaf.grad, ref_leaf.grad)


def test_dlrm_training_on_cuda_matches_cpu(cuda, no_tf32):
    """SMOKE's widths, 8 tables on 4 shards, batch 64: 3 steps of
    row-wise Adagrad and Adam from the same weights and batches on the
    card (K1 forward and backward per shard) and on the CPU (plain):
    losses and parameters within 1e-5 relative to their largest value."""
    from repro_torch.configs import dlrm as CD
    from repro_torch.data.pipeline import DLRMBatchStream
    from repro_torch.launch import train_dlrm as TD
    from repro_torch.models.dlrm import DLRM
    raw, plan = TD.smoke_tables(4, 500)
    stream = DLRMBatchStream(raw, CD.SMOKE_BATCH, n_dense=4, seed=0)
    weights = DLRM(CD.SMOKE, plan, device="cpu").state_dict()
    res = {}
    for dev in (cuda, torch.device("cpu")):
        model = DLRM(CD.SMOKE, plan, device=dev)
        model.load_state_dict(weights)
        train = TD.make_trainer(model, plan)
        n0 = embedding_bag_cuda.launches, embedding_bag_grad_cuda.launches
        losses = [float(train(*TD.to_device(stream.batch_at(i), plan, dev)))
                  for i in range(3)]
        n = (embedding_bag_cuda.launches - n0[0],
             embedding_bag_grad_cuda.launches - n0[1])
        assert n == ((12, 12) if dev.type == "cuda" else (0, 0))
        res[dev.type] = losses, {k: v.cpu() for k, v in
                                 model.state_dict().items()}
    (lg, pg), (lc, pc) = res["cuda"], res["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for k in pc:
        assert float((pg[k] - pc[k]).abs().max()) <= \
            1e-5 * float(pc[k].abs().max()), k


@pytest.mark.parametrize("k", [(1, 3, 1, 2, 1, 1, 2, 1), (4,) * 8],
                         ids=["mixed", "four"])
def test_column_sharded_lookup_on_cuda(cuda, k):
    """What ``chip_smoke.py`` phase 11(c) checks at full batch, at a few
    thousand rows: ``lookup_unsharded`` + ``combine_shard_outputs`` over a
    column-sharded plan equals the whole-table plan's lookup bit for bit
    (K1 pools each lane in bag order either way) and each shard's K1
    output equals plain on its arena and rows; from one upstream
    gradient, K1's backward per shard equals its plain replay bit for bit,
    and every slot's gradient is held to its whole-table plan's float64
    gradient columns by the rule above (twice plain's error + 1e-6), with
    plain's float32 sum taken on the host, in one fixed order, and its
    error capped at the largest of 10 runs in the order of CUDA's atomics
    (in that order alone the limit moved from run to run, and about one
    run in six failed).  The
    column split of the arenas and the per-table gradient references are
    the smoke's own helpers, so this test pins what it checks."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from chip_smoke import split_arenas, table_grad_refs
    from repro_torch.core import features as F
    from repro_torch.data.pipeline import DLRMBatchStream
    from repro_torch.data.synthetic import make_dlrm_pool
    from repro_torch.embedding import sharded as E
    from repro_torch.embedding.plan import build_plan
    from repro_torch.sharding import ShardSpec
    from repro_torch.sharding.placer import pack_shards
    raw = make_dlrm_pool(seed=0)[:8].copy()
    raw[:, F.HASH_SIZE] = np.minimum(raw[:, F.HASH_SIZE], 3000)
    rows = raw[:, F.HASH_SIZE].astype(int)
    dims = raw[:, F.DIM].astype(int)
    spec = ShardSpec.even(raw, np.asarray(k))
    whole_plan = build_plan(raw, np.arange(8) % 4, 4)
    plan = build_plan(raw, pack_shards(raw, spec, 4, 1e9), 4, sharding=spec)
    gen = torch.Generator(device=cuda).manual_seed(0)
    whole = [a.requires_grad_() for a in E.init_arenas(
        whole_plan, generator=gen, device=cuda)]
    arenas = [a.requires_grad_() for a in split_arenas(
        torch, whole_plan, [a.detach() for a in whole], plan, raw)]
    idx = torch.from_numpy(DLRMBatchStream(raw, 1024, seed=0).batch_at(0)[
        "indices"]).to(cuda)
    up = torch.randn((1024, 8, plan.dim), generator=gen, device=cuda)

    gidx_w = E.group_indices(whole_plan, idx)
    out_w = E.combine_shard_outputs(whole_plan, E.lookup_unsharded(
        whole, whole_plan.base_rows, gidx_w, whole_plan))
    grads_w = torch.autograd.grad(out_w, whole, up)
    gidx = E.group_indices(plan, idx)
    n0 = embedding_bag_cuda.launches, embedding_bag_grad_cuda.launches
    grouped = E.lookup_unsharded(arenas, plan.base_rows, gidx, plan)
    out = E.combine_shard_outputs(plan, grouped)
    *grads, g_grouped = torch.autograd.grad(out, [*arenas, grouped], up)
    torch.cuda.synchronize()
    assert (embedding_bag_cuda.launches - n0[0],
            embedding_bag_grad_cuda.launches - n0[1]) == (4, 4)

    lanes = torch.as_tensor(np.arange(plan.dim)[None, :] < dims[:, None],
                            device=cuda)
    _assert_bits_equal(out[:, lanes], out_w[:, lanes])
    assert not out[:, ~lanes].any()

    kk = plan.k_max
    where = {int(t): (s, int(whole_plan.base_rows[s, j]))
             for s, g in enumerate(whole_plan.groups) for j, t in enumerate(g)}
    for s, g in enumerate(plan.groups):
        shape = tuple(grads[s].shape)
        rows_s = E.shard_rows_of(plan.base_rows[s], gidx[:, s * kk:(s + 1) * kk])
        _assert_bits_equal(
            grouped.detach()[:, s * kk:(s + 1) * kk].reshape(
                rows_s.shape[0], -1),
            embedding_bag_plain(arenas[s].detach(), rows_s))
        g_s = g_grouped[:, s * kk:(s + 1) * kk].reshape(rows_s.shape[0], -1)
        _assert_bits_equal(grads[s], embedding_bag_grad_replay(
            shape, rows_s, g_s.contiguous()))
        assert not grads[s][0].any()
        for j in range(len(g)):
            t = int(plan.slot_table[s, j])
            c0, c1 = (int(c) for c in plan.slot_cols[s, j])
            ws, wb = where[t]
            b = int(plan.base_rows[s, j])
            got = grads[s][b:b + rows[t], :c1 - c0]
            whole_cols = grads_w[ws][wb:wb + rows[t], c0:c1]
            ref64, plain_err = table_grad_refs(
                torch, idx[:, t], up[:, t, c0:c1].contiguous(), int(rows[t]))
            for cand in (got, whole_cols):
                err = float((cand.double() - ref64).abs().max())
                assert err <= 2 * plain_err + 1e-6, (s, t, c0, c1)


# ---- placement serving on the card -------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance_ms(self, ms: float) -> None:
        self.t += ms / 1e3


@pytest.fixture(scope="module")
def serve_agents(tmp_path_factory):
    """A tiny port agent with greedy decode, trained on the CPU, saved and
    restored onto the card: ``(cpu agent, cuda agent)``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.api import SimOracle
    from repro_torch.core.trainer import DreamShard, DreamShardConfig
    from repro_torch.data.synthetic import make_dlrm_pool
    from repro_torch.data.tasks import sample_tasks, split_pool
    pool = make_dlrm_pool(seed=0)
    ids, _ = split_pool(pool, seed=0)
    train = sample_tasks(pool, ids, 12, 4, 2, seed=1)
    cfg = DreamShardConfig(n_iterations=1, n_collect=4, n_cost=20,
                           n_batch=16, n_rl=2, n_episode=4,
                           inference_candidates=1)
    cpu = DreamShard(train, SimOracle(seed=0), cfg, device="cpu")
    cpu.train()
    path = str(tmp_path_factory.mktemp("serve_agent"))
    cpu.save(path)
    gpu = DreamShard(train, SimOracle(seed=0), cfg, device="cuda")
    gpu.restore(path)
    return cpu, gpu


def _b11_quick_replay(agent):
    """b11's quick regime (drift policy) on a 1 ms-a-request clock."""
    from repro_torch.api import PlacementService, ServeConfig, SimOracle
    from repro_torch.data.synthetic import make_dlrm_pool
    from repro_torch.data.traffic import TrafficConfig, make_trace
    trace = make_trace(make_dlrm_pool(seed=0), TrafficConfig(
        n_jobs=6, n_tables=16, n_devices=4, n_requests=400, drift=0.8,
        zipf=1.0, tail_jobs=4, seed=0))
    clock = FakeClock()
    svc = PlacementService(agent, oracle=SimOracle(seed=0), clock=clock,
                           config=ServeConfig(
                               max_wait_ms=2.0, max_batch=8, ewma_alpha=0.3,
                               drift_threshold=0.05,
                               migration_ms_per_gb=25.0,
                               replace_max_evals=64, seed=0))
    done = []
    for i, r in enumerate(trace):
        clock.advance_ms(1.0)
        done += svc.submit(r.raw_features, r.n_devices, tag=i)
    done += svc.flush()
    return trace, done, svc


def test_serving_on_cuda_matches_cpu(serve_agents, no_tf32):
    """The b11 quick replay with the agent on the card equals the replay
    on the CPU request for request (source, ``replaced``, ``degraded``,
    assignment).  A greedy decode that flips between the devices must be
    a near tie: the two decoded candidates' cost-net estimates within
    1e-5 relative; that job is then left out of the comparison."""
    cpu, gpu = serve_agents
    trace, cdone, csvc = _b11_quick_replay(cpu)
    _, gdone, gsvc = _b11_quick_replay(gpu)
    assert gsvc.stats()["decode_errors"] == 0
    assert len(gdone) == len(cdone) == len(trace)
    flipped = set()
    for g, c in zip(gdone, cdone):
        assert g.tag == c.tag
        job = trace[g.tag].job
        if job in flipped:
            continue
        if not np.array_equal(g.placement.assignment,
                              c.placement.assignment):
            assert g.source == c.source == "decode", (g.tag, g.source)
            est_g, est_c = g.placement.est_cost_ms, c.placement.est_cost_ms
            assert abs(est_g - est_c) <= 1e-5 * abs(est_c), (est_g, est_c)
            flipped.add(job)
            continue
        assert (g.source, g.replaced, g.degraded) == \
            (c.source, c.replaced, c.degraded)
    if not flipped:
        drop = ("latency",)
        assert {k: v for k, v in gsvc.stats().items() if k not in drop} == \
            {k: v for k, v in csvc.stats().items() if k not in drop}


def test_served_replay_trace_on_cuda(serve_agents, tmp_path):
    """A JSONL trace of a served replay on the card holds the service's
    ``serve.flush`` spans and the session's ``session.decode`` spans."""
    from repro_torch import telemetry as tele
    path = str(tmp_path / "serve.jsonl")
    with tele.trace_to(path, quiet=True):
        _, done, svc = _b11_quick_replay(serve_agents[1])
    tele.reset()
    trace = tele.load_trace(path)
    names = [s["name"] for s in trace["spans"]]
    assert names.count("serve.flush") == svc.decode_batches > 0
    assert names.count("session.decode") >= svc.decode_batches
    assert trace["counters"]["serve.requests"] == len(done)


# ---- the RNN baseline on the card ----------------------------------------------


@pytest.fixture(scope="module")
def rnn_pair():
    """One RNN placer on the card and one on the CPU with the same
    weights, over DLRM-20 (4) tasks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.api import SimOracle
    from repro_torch.core.rnn_policy import RNNPlacer, RNNPolicyConfig
    from repro_torch.data.synthetic import make_dlrm_pool
    from repro_torch.data.tasks import make_benchmark_suite
    train, test = make_benchmark_suite(make_dlrm_pool(seed=0), 20, 4,
                                       n_tasks=4)
    cfg = RNNPolicyConfig(n_updates=2, n_episode=4)
    cpu = RNNPlacer(train, SimOracle(seed=0), cfg, device="cpu")
    cpu.train()
    gpu = RNNPlacer(train, SimOracle(seed=0), cfg)
    gpu.net.load_state_dict(cpu.net.state_dict())
    return cpu, gpu, train, test


def test_rnn_reprs_on_cuda_match_cpu_under_default_flags(rnn_pair):
    """The LSTM runs no cuDNN kernel, so cuDNN's TF32 default (on) does
    not reach it."""
    from repro_torch.core.rnn_policy import rnn_table_reprs
    cpu, gpu, _, test = rnn_pair
    assert torch.backends.cudnn.allow_tf32          # the default flags
    assert not torch.backends.cuda.matmul.allow_tf32
    for t in test:
        f_cpu = cpu._inputs(t.raw_features)[0]
        with torch.no_grad():
            ref = rnn_table_reprs(cpu.net, f_cpu)
            out = rnn_table_reprs(gpu.net, f_cpu.cuda())
        torch.testing.assert_close(out.cpu(), ref, rtol=1e-5, atol=1e-5)


def test_rnn_update_gradient_on_cuda_matches_cpu(rnn_pair):
    from repro_torch.core.rnn_policy import LOGIT_SHIFT_PARAMS
    from repro_torch.core.rollout import gumbel_noise
    cpu, gpu, train, _ = rnn_pair
    task = train[0]
    noise = gumbel_noise((task.n_tables, 4, task.n_devices),
                         torch.Generator().manual_seed(3), "cpu")
    a_c, r_c, g_c = cpu.gradient(task, noise)
    a_g, r_g, g_g = gpu.gradient(task, noise.cuda())
    assert torch.equal(a_g.cpu(), a_c)
    np.testing.assert_array_equal(r_g, r_c)
    scale = max(float(g.abs().max()) for g in g_c)
    for (name, _), x, y in zip(cpu.net.named_parameters(), g_g, g_c):
        atol = 1e-4 * (scale if name in LOGIT_SHIFT_PARAMS
                       else float(y.abs().max()))
        torch.testing.assert_close(x.cpu(), y, rtol=1e-4, atol=atol,
                                   msg=name)


def test_rnn_greedy_placement_on_cuda_matches_cpu(rnn_pair):
    cpu, gpu, train, test = rnn_pair
    for t in train + test:
        np.testing.assert_array_equal(
            gpu.place(t.raw_features, t.n_devices),
            cpu.place(t.raw_features, t.n_devices))
    assert gpu.as_placer().place(test[0]).strategy == "rnn"


# ---- the LM train path: the op's backward and the train step ----------------


def _op_grads(q, k, v, dout, **kw):
    """The flash attention op's output and dq/dk/dv (autograd)."""
    args = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_ops.flash_attention(*args, **kw)
    return (out.detach(), *torch.autograd.grad(out, args, dout))


@pytest.mark.parametrize("hd", [80, 128])
@pytest.mark.parametrize("S,window,group,Hkv", [(100, None, 1, 2),
                                                (300, 64, 4, 2),
                                                (257, None, 8, 1)])
def test_flash_backward_on_cuda_matches_cpu(cuda, no_tf32, hd, S, window,
                                            group, Hkv):
    """float32: the forward is K2's CUDA-core kernel and the backward
    K2-bwd's on the card, both plain on the CPU, with FA2's arithmetic, so
    the gradients differ by float32 summation order: 1e-5."""
    q, k, v = _qkv(S + hd, 2, S, S, Hkv * group, Hkv, hd, torch.float32,
                   cuda)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(S)
                       ).to(cuda)
    kw = {"window": window, "q_chunk": 64, "kv_chunk": 64}
    n0 = flash_attention_cuda.launches
    b0 = flash_attention_bwd_cuda.launches
    on_card = _op_grads(q, k, v, dout, **kw)
    assert flash_attention_cuda.launches == n0 + 1
    assert flash_attention_bwd_cuda.launches == b0 + 1
    on_cpu = _op_grads(q.cpu(), k.cpu(), v.cpu(), dout.cpu(), **kw)
    for a, b in zip(on_card, on_cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd", [80, 128])
def test_flash_backward_bf16_on_cuda(cuda, no_tf32, hd):
    """bf16 as the train step runs it: K2's tensor-core forward within its
    bf16 limits of plain, and K2-bwd's dq/dk/dv (P and dS rounded to bf16
    for their products, float32 sums, rounded once to bf16) within 1e-2
    relative rms of the float32 op's on the same values."""
    q, k, v = _qkv_served(hd, 2, 512, 512, 8, 2, hd, cuda)
    dout = torch.randn(q.shape, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(1))
    kw = {"window": 200, "q_chunk": 128, "kv_chunk": 128}
    bf = _op_grads(q, k, v, dout.bfloat16(), **kw)
    f32 = _op_grads(q.float(), k.float(), v.float(), dout, **kw)
    _assert_bf16_limits(bf[0], attention_plain(q, k, v, window=200))
    for a, b in zip(bf[1:], f32[1:]):
        assert a.dtype == torch.bfloat16
        assert float((a.float() - b).norm() / b.norm()) <= 1e-2


# (B, S, T, Hq, Hkv, causal, window): groups 1, 4 and 48, windows, T != S
BWD_SHAPES = [(2, 200, 200, 4, 4, True, None),
              (2, 300, 300, 8, 2, True, 64),
              (1, 257, 257, 48, 1, True, None),
              (1, 130, 99, 4, 4, False, 40),
              (2, 77, 131, 8, 2, False, None),
              (1, 70, 200, 6, 3, True, None)]


@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "-".join(
    map(str, s)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_kernel_matches_plain(cuda, no_tf32, hd, shape, dtype):
    """K2-bwd from K2's own output and lse against plain's float64 run (a
    float64 forward and ``attention_bwd_plain``): bf16 (tensor cores; P
    and dS rounded to bf16 for their products) within 1e-2 of max |ref|
    and 1e-2 relative rms, float32 (CUDA cores) within 1e-4 and 1e-5; two
    calls give the same bits, and K2's output is the same with and
    without its lse store."""
    B, S, T, Hq, Hkv, causal, window = shape
    q, k, v = _qkv(S + T + hd, B, S, T, Hq, Hkv, hd, dtype, cuda)
    dout = torch.randn(q.shape, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(hd)).to(dtype)
    kw = {"causal": causal, "window": window}
    out, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
    bare = flash_attention_cuda(q, k, v, **kw)
    assert torch.equal(out, bare)
    assert lse.shape == (B, Hq, S) and lse.dtype == torch.float32
    grads = flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    again = flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    q64, k64, v64 = (t.double() for t in (q, k, v))
    o64, l64 = attention_plain(q64, k64, v64, lse=True, **kw)
    torch.testing.assert_close(lse.double(), l64, rtol=0, atol=1e-4)
    ref = attention_bwd_plain(q64, k64, v64, o64, dout.double(), l64, **kw)
    max_rel, rel_rms = (1e-2, 1e-2) if dtype == torch.bfloat16 else (1e-4,
                                                                     1e-5)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for g, g2, r, t in zip(grads, again, ref, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        assert torch.equal(g.view(bits), g2.view(bits))
        d = g.double() - r
        assert float(d.abs().max() / r.abs().max()) <= max_rel
        assert float(d.norm() / r.norm()) <= rel_rms


def test_flash_bwd_wrapper_checks_and_counts(cuda):
    q, k, v = _qkv(5, 1, 64, 64, 4, 2, 64, torch.bfloat16, cuda)
    out, lse = flash_attention_cuda(q, k, v, lse=True)
    dout = torch.ones_like(out)
    n0 = flash_attention_bwd_cuda.launches
    flash_attention_bwd_cuda(q, k, v, out, dout, lse)
    assert flash_attention_bwd_cuda.launches == n0 + 1
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(q, k, v, out, dout, lse[:, :1])
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(q, k, v, out.float(), dout, lse)
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(q.cpu(), k, v, out, dout, lse)
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(q, k, v, out, dout.transpose(1, 2)
                                 .contiguous().transpose(1, 2), lse)
    assert flash_attention_bwd_cuda.launches == n0 + 1
    # the op with a gradient stores lse and launches K2-bwd; without one,
    # neither
    args = [t.detach().requires_grad_(True) for t in (q, k, v)]
    flash_ops.flash_attention(*args).sum().backward()
    assert flash_attention_bwd_cuda.launches == n0 + 2


def test_train_step_on_cuda_matches_cpu(cuda, no_tf32):
    """Two AdamW steps of the SMOKE danube in float32 on the card (K2) and
    on the CPU (plain) from the same weights and batches: losses within
    1e-5 relative, the first step's gradients within 1e-5 of each leaf's
    largest; params within 1e-5 where the gradient decides Adam's step
    (|g| >= 1e-2 of the leaf's largest), within 4 lr elsewhere."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import map_params, tree_leaves
    cfg = get_smoke("h2o-danube-1.8b").resolve(1)
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 96)),
                                          dtype=torch.int32),
                "labels": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 96)),
                                          dtype=torch.int32)}
               for _ in range(2)]
    init = ST.build_model(cfg, dtype=torch.float32).init_params(0)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        model = ST.build_model(cfg, q_chunk=32, kv_chunk=32,
                               dtype=torch.float32, device=dev)
        params = map_params(lambda t: t.to(dev).clone(), init)
        opt, step = ST.make_train_step(model, lr=1e-3)
        state = opt.init(tree_leaves(params))
        grad_fn = ST.make_grad_fn(model)
        losses, grads = [], []
        for b in batches:
            b = {k: v.to(dev) for k, v in b.items()}
            grads.append([g.cpu() for g in grad_fn(params, b)[0]])
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
        runs.append((losses, grads, [p.cpu() for p in tree_leaves(params)]))
    (cl, cg, cp), (hl, hg, hp) = runs
    np.testing.assert_allclose(cl, hl, rtol=1e-5)
    for a, b in zip(cg[0], hg[0]):             # the first step's, same point
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    decided = [(g.abs() >= 1e-2 * g.abs().max()) for g in hg[0]]
    decided = [d & (g.abs() >= 1e-2 * g.abs().max())
               for d, g in zip(decided, hg[1])]
    for d, a, b in zip(decided, cp, hp):
        diff = (a - b).abs()
        assert float(diff.max()) <= 4e-3
        assert float(diff[d].max()) <= 1e-5


def test_train_launcher_defaults_to_cuda(cuda, capsys):
    from repro_torch.launch import train as TR
    n0 = flash_attention_cuda.launches
    losses = TR.main(["--arch", "granite-34b", "--smoke", "--steps", "2",
                      "--seq", "64"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "device=cuda" in capsys.readouterr().out
    assert flash_attention_cuda.launches == n0 + 2 * 2   # 2 layers, 2 steps


# ---- the MoE layer ------------------------------------------------------------


def _moe_inputs(dev, dtype, D=256, F=128, E=4, B=2, S=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, D), generator=g)
    p = {"router": torch.randn((D, E), generator=g) * 2 / D ** 0.5,
         "wg": torch.randn((E, D, F), generator=g) / D ** 0.5,
         "wu": torch.randn((E, D, F), generator=g) / D ** 0.5,
         "wo": torch.randn((E, F, D), generator=g) / F ** 0.5}
    return (x.to(dev, dtype),
            {k: v.to(dev, torch.float32 if k == "router" else dtype)
             for k, v in p.items()})


@pytest.mark.parametrize("E, K", [(4, 2), (64, 8)])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_on_cuda_matches_cpu(cuda, no_tf32, E, K, capacity_factor):
    """float32 ``moe_apply`` on the card and on the CPU: the same routes
    (``top_e``, ``tok_buf``, dropped slots), output and load-balance loss
    within 1e-5 of their largest entries."""
    from repro_torch.models import layers as L
    kw = dict(n_experts=E, top_k=K, capacity_factor=capacity_factor)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        x, p = _moe_inputs(dev, torch.float32, E=E)
        r = L.moe_route(x, p["router"], **kw)
        y, aux = L.moe_apply(p, x, act="swiglu", **kw)
        outs.append((r, y.cpu(), float(aux)))
    (rc, yc, ac), (rh, yh, ah) = outs
    assert torch.equal(rc.top_e.cpu(), rh.top_e)
    assert torch.equal(rc.tok_buf.cpu(), rh.tok_buf)
    assert torch.equal(rc.slot.cpu(), rh.slot)
    assert float((yc - yh).abs().max()) <= 1e-5 * float(yh.abs().max())
    assert abs(ac - ah) <= 1e-5 * abs(ah)


def test_moe_bf16_combine_is_deterministic_on_cuda(cuda):
    """Two card runs of bf16 ``moe_apply`` (output and input gradient,
    the ordered combine and its transpose) are bit-equal."""
    from repro_torch.models import layers as L
    runs = []
    for _ in range(2):
        x, p = _moe_inputs(cuda, torch.bfloat16, E=64, D=512, F=256,
                           S=1024)
        x.requires_grad_(True)
        y, _ = L.moe_apply(p, x, n_experts=64, top_k=8,
                           capacity_factor=1.25, act="swiglu")
        (gx,) = torch.autograd.grad(y.float().square().sum(), x)
        runs.append((y.view(torch.int16), gx.view(torch.int16)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_moe_router_refuses_tf32(cuda):
    from repro_torch.models import layers as L
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(ValueError, match="TF32"):
            L.moe_route(torch.zeros((1, 4, 8), device=cuda),
                        torch.zeros((8, 4), device=cuda), n_experts=4,
                        top_k=2, capacity_factor=1.25)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# ---- K3 and K4: the SSM and RWKV scans --------------------------------------


def _ulp(x):
    """One bfloat16 ulp at |x|; 0 at 0."""
    _, e = torch.frexp(x.float().abs())
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x.float()),
                                                e - 8))


def _f64_rule(out, plain, ref64):
    """The kernel's largest error against float64 at most twice plain
    float32's plus 1e-6 (phase 3b's rule); returns both errors."""
    e_k = float((out.double() - ref64).abs().max())
    e_p = float((plain.double() - ref64).abs().max())
    assert e_k <= 2 * e_p + 1e-6, (e_k, e_p)
    return e_k, e_p


def _scan_inputs(dev, B, S, Di, N, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, Di), generator=g) * 0.5
    dt = torch.nn.functional.softplus(torch.randn((B, S, Di), generator=g)
                                      - 1.0)
    Bc = torch.randn((B, S, N), generator=g) * 0.3
    Cc = torch.randn((B, S, N), generator=g) * 0.3
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(Di, N)
    h0 = torch.randn((B, Di, N), generator=g) * 0.1
    return [t.contiguous().to(dev) for t in (x, dt, Bc, Cc, A, h0)]


def _wkv_inputs(dev, B, S, H, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = (B, S, H, 64)
    r, k, v = (torch.randn(shape, generator=g) * 0.5 for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(shape, generator=g) - 4.0))
    u = torch.randn((H, 64), generator=g) * 0.5
    s0 = torch.randn((B, H, 64, 64), generator=g) * 0.1
    return [t.to(dev) for t in (r, k, v, w, u, s0)]


# SMOKE's widths, a full-width slice of 256 steps, then the kernels'
# edges: S of 1 (decode), one less and one more than a chunk (32 steps
# for K3, 16 for K4), Di not a multiple of a block's channels (128 / N)
# and odd (bf16 rows that start mid-word), N 4, 8 and 16, B 1 and 3, H 1,
# 5 and 32
SCAN_SHAPES = [(2, 96, 512, 8), (2, 256, 3200, 16), (2, 1, 3200, 16),
               (3, 15, 100, 4), (1, 17, 99, 8), (3, 33, 77, 16),
               (1, 256, 200, 4), (3, 17, 3199, 16), (2, 31, 101, 8)]
WKV_SHAPES = [(2, 96, 4), (2, 256, 32), (2, 1, 32), (3, 15, 5), (1, 17, 1),
              (3, 33, 5), (1, 256, 1)]


def _same_bits(a, b):
    """True where two float tensors hold the same bits everywhere."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int16 if a.element_size() == 2
                            else torch.int32),
        b.contiguous().view(torch.int16 if b.element_size() == 2
                            else torch.int32))


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_selective_scan_kernel_matches_plain(cuda, shape):
    """K3 against its plain version and a float64 run: float32 by the
    float64 rule (y and hT); bf16 x: y within one bf16 ulp of plain's."""
    from repro_torch.kernels.selective_scan.kernel import selective_scan_cuda
    from repro_torch.kernels.selective_scan.ref import selective_scan_plain
    ins = _scan_inputs(cuda, *shape)
    n0 = selective_scan_cuda.launches
    y, hT = selective_scan_cuda(*ins)
    torch.cuda.synchronize()
    assert selective_scan_cuda.launches == n0 + 1
    yp, hp = selective_scan_plain(*ins)
    y64, h64 = selective_scan_plain(*(t.double() for t in ins))
    _f64_rule(y, yp, y64)
    _f64_rule(hT, hp, h64)
    xb = ins[0].to(torch.bfloat16)
    yb, hb = selective_scan_cuda(xb, *ins[1:])
    ypb, hpb = selective_scan_plain(xb, *ins[1:])
    assert yb.dtype == torch.bfloat16
    assert bool(((yb.float() - ypb.float()).abs()
                 <= torch.maximum(_ulp(yb), _ulp(ypb))).all())
    _, h64b = selective_scan_plain(xb.double(), *(t.double()
                                                  for t in ins[1:]))
    _f64_rule(hb, hpb, h64b)


@pytest.mark.parametrize("shape", WKV_SHAPES, ids=str)
def test_wkv6_kernel_matches_plain(cuda, shape):
    """K4 against its plain version and a float64 run by the float64 rule
    (y and sT), in float32 and with bf16 r, k, v."""
    from repro_torch.kernels.wkv6.kernel import wkv6_cuda
    from repro_torch.kernels.wkv6.ref import wkv6_plain
    ins = _wkv_inputs(cuda, *shape)
    for dt in (torch.float32, torch.bfloat16):
        args = [t.to(dt) for t in ins[:3]] + ins[3:]
        n0 = wkv6_cuda.launches
        y, sT = wkv6_cuda(*args)
        torch.cuda.synchronize()
        assert wkv6_cuda.launches == n0 + 1 and y.dtype == torch.float32
        yp, sp = wkv6_plain(*args)
        y64, s64 = wkv6_plain(*(t.double() for t in args))
        _f64_rule(y, yp, y64)
        _f64_rule(sT, sp, s64)


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_selective_scan_state_and_y_bits_are_plain(cuda, shape):
    """K3 updates every state with plain's rounded operations in plain's
    order (expf is torch.exp's) and adds y over n from 0 upward: hT and
    float32 y equal plain's bit for bit, and hT on bf16 x too."""
    from repro_torch.kernels.selective_scan.kernel import selective_scan_cuda
    from repro_torch.kernels.selective_scan.ref import selective_scan_plain
    ins = _scan_inputs(cuda, *shape)
    for x in (ins[0], ins[0].to(torch.bfloat16)):
        y, hT = selective_scan_cuda(x, *ins[1:])
        yp, hp = selective_scan_plain(x, *ins[1:])
        assert _same_bits(hT, hp)
        assert _same_bits(y, yp)


@pytest.mark.parametrize("shape", WKV_SHAPES, ids=str)
def test_wkv6_state_bits_are_plain(cuda, shape):
    """K4 updates every state element with plain's rounded operations in
    plain's order: sT equals plain's bit for bit, in float32 and with
    bf16 r, k, v."""
    from repro_torch.kernels.wkv6.kernel import wkv6_cuda
    from repro_torch.kernels.wkv6.ref import wkv6_plain
    ins = _wkv_inputs(cuda, *shape)
    for dt in (torch.float32, torch.bfloat16):
        args = [t.to(dt) for t in ins[:3]] + ins[3:]
        assert _same_bits(wkv6_cuda(*args)[1], wkv6_plain(*args)[1])


def test_scans_give_the_same_bits_twice(cuda):
    """Two launches of K3 and of K4 on one input write the same bits."""
    from repro_torch.kernels.selective_scan.kernel import selective_scan_cuda
    from repro_torch.kernels.wkv6.kernel import wkv6_cuda
    for kern, ins in ((selective_scan_cuda, _scan_inputs(cuda, 2, 257, 3200,
                                                         16)),
                      (wkv6_cuda, _wkv_inputs(cuda, 2, 257, 32))):
        for dt in (torch.float32, torch.bfloat16):
            n = 1 if kern is selective_scan_cuda else 3
            args = [t.to(dt) for t in ins[:n]] + ins[n:]
            a, b = kern(*args), kern(*args)
            assert all(_same_bits(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize("split", ["chunk", "steps"])
def test_scans_carry_the_state_across_calls(cuda, split):
    """A scan cut at chunk boundaries (K4's 16 steps, K3's 32), or run one
    step a call as decode runs it, carries the state as one call does: y
    and the last state bit for bit."""
    from repro_torch.kernels.selective_scan.kernel import selective_scan_cuda
    from repro_torch.kernels.wkv6.kernel import wkv6_cuda
    S = 40
    cuts = [0, 16, 32, S] if split == "chunk" else list(range(S + 1))
    for kern, ins, n_low in (
            (selective_scan_cuda, _scan_inputs(cuda, 2, S, 200, 16), 1),
            (wkv6_cuda, _wkv_inputs(cuda, 2, S, 5), 3)):
        # x (K3), r, k, v (K4) in bf16; 4 inputs along time, then A or u,
        # then the state
        n_seq, state = 4, 5
        ins = [t.to(torch.bfloat16) for t in ins[:n_low]] + ins[n_low:]
        y_all, s_all = kern(*ins)
        s, ys = ins[state], []
        for a, b in zip(cuts, cuts[1:]):
            part = [t[:, a:b].contiguous() for t in ins[:n_seq]]
            y, s = kern(*part, *ins[n_seq:state], s)
            ys.append(y)
        assert _same_bits(torch.cat(ys, 1), y_all)
        assert _same_bits(s, s_all)


def test_wkv6_takes_a_view_off_a_16_byte_boundary(cuda):
    """K4 stages r, k, v and w 16 bytes at a time: the wrapper refuses a
    view that starts between two 16-byte boundaries, launching nothing,
    and the op copies such a view and gives the aligned input's bits."""
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6.kernel import wkv6_cuda
    ins = _wkv_inputs(cuda, 2, 20, 3)
    buf = torch.empty(ins[0].numel() + 1, device=cuda)
    r_off = buf[1:].view(ins[0].shape)             # 4 bytes past a boundary
    r_off.copy_(ins[0])
    n0 = wkv6_cuda.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        wkv6_cuda(r_off, *ins[1:])
    assert wkv6_cuda.launches == n0
    with torch.no_grad():
        got = wkv_ops.wkv6(r_off, *ins[1:])
        want = wkv_ops.wkv6(*ins)
    assert all(_same_bits(a, b) for a, b in zip(got, want))


def _grad_f64_rule(got, plain, ref64):
    """Every gradient by ``_f64_rule``; returns the errors."""
    return [_f64_rule(g, p, r) for g, p, r in zip(got, plain, ref64)]


# a scan cut by the chunks (K3's 32 steps, K4's 16) and one step long;
# then the clusters' edges: K3-bwd's blocks of a batch row not a whole
# number of 8-block clusters (B 3), fewer blocks than one cluster, N 4
# over two chunks; K4-bwd at an odd H with B 2 over several chunks
GRAD_SCAN_SHAPES = [(2, 96, 512, 8), (2, 70, 3200, 16), (2, 1, 3200, 16),
                    (3, 33, 77, 16), (1, 17, 99, 4), (2, 31, 101, 8),
                    (3, 65, 200, 8), (1, 40, 24, 16), (2, 40, 50, 4)]
GRAD_WKV_SHAPES = [(2, 96, 4), (2, 40, 32), (2, 1, 32), (3, 17, 5),
                   (1, 15, 1), (2, 35, 7)]


@pytest.mark.parametrize("shape", GRAD_SCAN_SHAPES, ids=str)
def test_selective_scan_backward_matches_plain(cuda, shape):
    """K3-bwd against the plain backward and a float64 run of it by the
    float64 rule, every gradient, on float32 and bf16 x, from a nonzero
    h0, with dhT given and None; the forward's saved chunk states equal
    plain's bit for bit."""
    from repro_torch.kernels.selective_scan.kernel import (
        selective_scan_cuda, selective_scan_grad_cuda)
    from repro_torch.kernels.selective_scan.ref import (
        selective_scan_bwd_plain, selective_scan_states_plain)
    ins = _scan_inputs(cuda, *shape)
    g = torch.Generator().manual_seed(1)
    dy32 = torch.randn(ins[0].shape, generator=g).to(cuda)
    dhT = torch.randn(ins[5].shape, generator=g).to(cuda)
    for xdt, dh in ((torch.float32, dhT), (torch.bfloat16, None)):
        args = [ins[0].to(xdt)] + ins[1:]
        dy = dy32.to(xdt)
        _, _, hs = selective_scan_cuda(*args, save_states=True)
        assert _same_bits(hs, selective_scan_states_plain(*args)[2])
        n0 = selective_scan_grad_cuda.launches
        got = selective_scan_grad_cuda(*args[:5], hs, dy, dh)
        torch.cuda.synchronize()
        assert selective_scan_grad_cuda.launches == n0 + 1
        assert got[0].dtype == xdt
        plain = selective_scan_bwd_plain(*args, dy, dh)
        ref64 = selective_scan_bwd_plain(
            *(t.double() for t in args), dy.double(),
            None if dh is None else dh.double())
        _grad_f64_rule(got, plain, ref64)


@pytest.mark.parametrize("shape", GRAD_WKV_SHAPES, ids=str)
def test_wkv6_backward_matches_plain(cuda, shape):
    """K4-bwd against the plain backward and a float64 run of it by the
    float64 rule, every gradient, on float32 and bf16 r, k, v, from a
    nonzero s0, with dsT given and None; the forward's saved chunk
    states equal plain's bit for bit."""
    from repro_torch.kernels.wkv6.kernel import wkv6_cuda, wkv6_grad_cuda
    from repro_torch.kernels.wkv6.ref import wkv6_bwd_plain, wkv6_states_plain
    ins = _wkv_inputs(cuda, *shape)
    g = torch.Generator().manual_seed(1)
    dy = torch.randn(ins[0].shape, generator=g).to(cuda)
    dsT = torch.randn(ins[5].shape, generator=g).to(cuda)
    for dt, ds in ((torch.float32, dsT), (torch.bfloat16, None)):
        args = [t.to(dt) for t in ins[:3]] + ins[3:]
        _, _, hs = wkv6_cuda(*args, save_states=True)
        assert _same_bits(hs, wkv6_states_plain(*args)[2])
        n0 = wkv6_grad_cuda.launches
        got = wkv6_grad_cuda(*args[:5], hs, dy, ds)
        torch.cuda.synchronize()
        assert wkv6_grad_cuda.launches == n0 + 1
        assert all(t.dtype == dt for t in got[:3])
        plain = wkv6_bwd_plain(*args, dy, ds)
        ref64 = wkv6_bwd_plain(*(t.double() for t in args), dy.double(),
                               None if ds is None else ds.double())
        _grad_f64_rule(got, plain, ref64)


def test_scan_backwards_give_the_same_bits_twice(cuda):
    """Two launches of K3-bwd and of K4-bwd on one input write the same
    bits: every sum runs in a fixed order, with no atomics."""
    from repro_torch.kernels.selective_scan.kernel import (
        selective_scan_cuda, selective_scan_grad_cuda)
    from repro_torch.kernels.wkv6.kernel import wkv6_cuda, wkv6_grad_cuda
    for fwd, bwd, ins in (
            (selective_scan_cuda, selective_scan_grad_cuda,
             _scan_inputs(cuda, 2, 257, 3200, 16)),
            (wkv6_cuda, wkv6_grad_cuda, _wkv_inputs(cuda, 2, 257, 32))):
        n = 1 if fwd is selective_scan_cuda else 3
        for dt in (torch.float32, torch.bfloat16):
            args = [t.to(dt) for t in ins[:n]] + ins[n:]
            y, last, hs = fwd(*args, save_states=True)
            dy = torch.randn_like(y.float()).to(y.dtype)
            dlast = torch.randn_like(last)
            a = bwd(*args[:5], hs, dy, dlast)
            b = bwd(*args[:5], hs, dy, dlast)
            assert all(_same_bits(p, q) for p, q in zip(a, b))


def test_scan_ops_train_through_the_kernels(cuda):
    """A CUDA input that needs a gradient runs K3 / K4 forward once and
    their backward once, never the plain loops, and autograd gets the
    plain backward's gradients by the float64 rule; K4's op takes a view
    off a 16-byte boundary (copied) and gives the aligned input's bits."""
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.selective_scan.kernel import (
        selective_scan_cuda, selective_scan_grad_cuda)
    from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_plain
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6.kernel import wkv6_cuda, wkv6_grad_cuda
    from repro_torch.kernels.wkv6.ref import wkv6_bwd_plain

    def no_plain(*a, **k):
        raise AssertionError("the plain loop ran on the train path")

    ins = _scan_inputs(cuda, 2, 45, 200, 16)
    dy = torch.randn_like(ins[0])
    counts = (selective_scan_cuda.launches, selective_scan_grad_cuda.launches)
    live = [t.clone().requires_grad_(True) for t in ins]
    orig = scan_ops.selective_scan_plain
    scan_ops.selective_scan_plain = no_plain
    try:
        y, _ = scan_ops.selective_scan(*live)
        got = torch.autograd.grad(y, live, dy)
    finally:
        scan_ops.selective_scan_plain = orig
    assert (selective_scan_cuda.launches - counts[0],
            selective_scan_grad_cuda.launches - counts[1]) == (1, 1)
    _grad_f64_rule(got, selective_scan_bwd_plain(*ins, dy),
                   selective_scan_bwd_plain(*(t.double() for t in ins),
                                            dy.double()))

    ins = _wkv_inputs(cuda, 2, 20, 3)
    buf = torch.empty(ins[0].numel() + 1, device=cuda)
    r_off = buf[1:].view(ins[0].shape)             # 4 bytes past a boundary
    r_off.copy_(ins[0])
    dy = torch.randn_like(ins[0])
    runs = []
    for r in (r_off, ins[0]):
        # detach keeps the view's place in its storage
        live = [t.detach().requires_grad_(True) for t in [r] + ins[1:]]
        counts = (wkv6_cuda.launches, wkv6_grad_cuda.launches)
        y, _ = wkv_ops.wkv6(*live)
        runs.append(torch.autograd.grad(y, live, dy))
        assert (wkv6_cuda.launches - counts[0],
                wkv6_grad_cuda.launches - counts[1]) == (1, 1)
    assert r_off.storage_offset() % 4
    assert all(_same_bits(a, b) for a, b in zip(*runs))
    _grad_f64_rule(runs[1], wkv6_bwd_plain(*ins, dy),
                   wkv6_bwd_plain(*(t.double() for t in ins), dy.double()))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-1.6b"])
@pytest.mark.parametrize("remat", [False, True])
def test_ssm_train_step_on_cuda_matches_cpu(cuda, no_tf32, arch, remat):
    """SMOKE, float32, seeded: ``make_grad_fn`` on the card (K2, K3 / K4
    and their backward) against the CPU's plain autograd: the loss within
    1e-5 and every gradient leaf within 1e-4 of its largest entry; K3-bwd
    / K4-bwd launched once a layer, the forward scan once a layer (twice
    under remat, which re-runs each layer in the backward)."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.selective_scan import kernel as SSK
    from repro_torch.kernels.wkv6 import kernel as WKK
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import map_params
    cfg = get_smoke(arch).resolve(1)
    fwd, bwd = ((SSK.selective_scan_cuda, SSK.selective_scan_grad_cuda)
                if arch == "hymba-1.5b" else
                (WKK.wkv6_cuda, WKK.wkv6_grad_cuda))
    rng = np.random.default_rng(3)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 80)),
                                dtype=torch.int32) for k in ("tokens",
                                                             "labels")}
    gpu = ST.build_model(cfg, remat=remat, dtype=torch.float32, device=cuda)
    cpu = ST.build_model(cfg, remat=remat, dtype=torch.float32, device="cpu")
    params = gpu.init_params(0)
    cparams = map_params(lambda t: t.cpu().clone(), params)
    n0 = (fwd.launches, bwd.launches)
    grads, loss, _ = ST.make_grad_fn(gpu)(
        params, {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert (fwd.launches - n0[0], bwd.launches - n0[1]) == (
        cfg.n_layers * (2 if remat else 1), cfg.n_layers)
    cgrads, closs, _ = ST.make_grad_fn(cpu)(cparams, batch)
    assert abs(float(loss) - float(closs)) <= 1e-5 * abs(float(closs))
    for g, c in zip(grads, cgrads):
        assert float((g.cpu() - c).abs().max()) <= 1e-4 * max(
            float(c.abs().max()), 1e-30)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-1.6b"])
def test_ssm_lm_on_cuda_matches_cpu(cuda, no_tf32, arch):
    """SMOKE, float32, seeded: the card (K2, K3 / K4) against the CPU's
    plain run: prefill logits within 1e-4, 8 greedy tokens equal."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.selective_scan.kernel import selective_scan_cuda
    from repro_torch.kernels.wkv6.kernel import wkv6_cuda
    from repro_torch.models.transformer import LM, map_params
    cfg = get_smoke(arch).resolve(1)
    kern = selective_scan_cuda if arch == "hymba-1.5b" else wkv6_cuda
    n0 = kern.launches
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 80)), dtype=torch.int32)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        model = LM(cfg, dtype=torch.float32, device=dev)
        params = (model.init_params(0) if dev.type == "cuda" else
                  map_params(lambda t: t.cpu(), runs[0][2]))
        logits, cache = model.prefill(params, prompt.to(dev), capacity=88)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        first, toks = logits.cpu(), [tok.cpu()]
        for _ in range(7):
            logits, cache = model.decode_step(params, cache, tok)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks.append(tok.cpu())
        runs.append((first, torch.cat(toks, 1), params))
    assert kern.launches == n0 + cfg.n_layers * 8
    (lg, tg, _), (lc, tc, _) = runs
    assert float((lg - lc).abs().max()) <= 1e-4
    assert torch.equal(tg, tc)


def test_placement_decode_is_batch_invariant_on_cuda(cuda, no_tf32):
    """A DLRM-50 (4) test task decoded alone and in batches of 3, 16 and
    20 (``PlacementSession.place_many``): every step's policy logits of
    its row and its assignment bit-equal."""
    from repro_torch.api import PlacementSession, SimOracle
    from repro_torch.api.session import DECODE_BATCH
    from repro_torch.core.trainer import DreamShard, DreamShardConfig
    from repro_torch.data.synthetic import make_dlrm_pool
    from repro_torch.data.tasks import make_benchmark_suite
    _, test = make_benchmark_suite(make_dlrm_pool(seed=0), n_tables=50,
                                   n_devices=4, n_tasks=20)
    agent = DreamShard(test[:4], SimOracle(seed=0), DreamShardConfig(seed=0),
                       device=cuda)
    session = PlacementSession(agent, n_candidates=16)
    logits = []
    hook = agent.policy_net.head.register_forward_hook(
        lambda _m, _a, out: logits.append(out.detach().clone()))

    def decode(tasks, pos):
        logits.clear()
        out = session.place_many(tasks)[pos].assignment
        call = pos // DECODE_BATCH
        per = len(logits) // -(-len(tasks) // DECODE_BATCH)
        rows = [t[pos % DECODE_BATCH]
                for t in logits[call * per:(call + 1) * per]]
        return out, rows
    try:
        alone, rows = decode([test[0]], 0)
        for n, pos in ((3, 2), (16, 7), (20, 17)):
            others = test[1:n]
            a, r = decode(others[:pos] + [test[0]] + others[pos:], pos)
            assert np.array_equal(a, alone)
            assert len(r) == len(rows)
            assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(r, rows))
    finally:
        hook.remove()


def test_place_equals_place_many_on_cuda(cuda, no_tf32):
    """``DreamShard.place`` (Algorithm 2, one task) and
    ``PlacementSession.place_many`` of the 20 DLRM-50 (4) test tasks on
    the card give each task the same assignment and the same estimated
    cost, bit for bit (the reference's promise, ``tests/test_api.py``),
    greedy and with 16 sampled candidates."""
    from repro_torch.api import PlacementSession, SimOracle
    from repro_torch.core.trainer import DreamShard, DreamShardConfig
    from repro_torch.data.synthetic import make_dlrm_pool
    from repro_torch.data.tasks import make_benchmark_suite
    _, test = make_benchmark_suite(make_dlrm_pool(seed=0), n_tables=50,
                                   n_devices=4, n_tasks=20)
    agent = DreamShard(test[:4], SimOracle(seed=0), DreamShardConfig(seed=0),
                       device=cuda)
    for k in (1, 16):
        served = PlacementSession(agent, n_candidates=k).place_many(test)
        for t, p in zip(test, served):
            a, est = agent.place_detailed(t.raw_features, t.n_devices, k)
            assert np.array_equal(p.assignment, a)
            assert np.float32(p.est_cost_ms).view(np.int32) == \
                np.float32(est).view(np.int32)


@pytest.mark.parametrize("Hq, Hkv, hd", [(32, 32, 64), (56, 8, 128)],
                         ids=["musicgen", "llava"])
@pytest.mark.parametrize("S", [257, 1000])
def test_bf16_tensor_cores_frontend_head_shapes(cuda, Hq, Hkv, hd, S):
    """K2 at musicgen-large's heads (hd 64, group 1, no window) and
    llava-next-34b's (hd 128, 56 query over 8 KV heads: group 7)."""
    q, k, v = _qkv_served(Hq + hd + S, 1, S, S, Hq, Hkv, hd, cuda)
    n0 = flash_attention_cuda.launches
    out = flash_attention_cuda(q, k, v)
    assert flash_attention_cuda.launches == n0 + 1
    _assert_bf16_limits(out, attention_plain(q, k, v))


@pytest.mark.parametrize("arch", ["llava-next-34b", "musicgen-large"])
def test_frontend_lm_on_cuda_matches_cpu(cuda, no_tf32, arch):
    """SMOKE, float32, seeded embeds and tokens: the card's prefill (K2)
    against the CPU's (plain), logits within 1e-4 and the cache position
    counting the frames; then 3 decode steps and one train step's loss
    and gradients (1e-5 / 1e-4 of each leaf's largest)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import map_params
    cfg = get_smoke(arch).resolve(1)
    nf = cfg.n_frontend_tokens
    rng = np.random.default_rng(4)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 48)),
                             dtype=torch.int32)
    embeds = torch.as_tensor(rng.normal(0, 0.02, (2, nf, cfg.d_model)),
                             dtype=torch.float32)
    labels = torch.as_tensor(rng.integers(0, cfg.vocab, (2, nf + 48)),
                             dtype=torch.int32)
    gpu = ST.build_model(cfg, remat=False, dtype=torch.float32, device=cuda)
    cpu = ST.build_model(cfg, remat=False, dtype=torch.float32, device="cpu")
    params = gpu.init_params(0)
    cparams = map_params(lambda t: t.cpu().clone(), params)
    n0 = flash_attention_cuda.launches
    logits, cache = gpu.prefill(params, tokens.to(cuda), embeds.to(cuda),
                                capacity=nf + 48 + 3)
    clogits, ccache = cpu.prefill(cparams, tokens, embeds,
                                  capacity=nf + 48 + 3)
    assert flash_attention_cuda.launches == n0 + cfg.n_layers
    assert cache["pos"] == ccache["pos"] == nf + 48
    torch.testing.assert_close(logits.cpu(), clogits, rtol=1e-4, atol=1e-4)
    tok = clogits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    for _ in range(3):
        logits, cache = gpu.decode_step(params, cache, tok.to(cuda))
        clogits, ccache = cpu.decode_step(cparams, ccache, tok)
        torch.testing.assert_close(logits.cpu(), clogits, rtol=1e-4,
                                   atol=1e-4)
        tok = clogits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    batch = {"tokens": tokens, "labels": labels, "embeds": embeds}
    grads, loss, _ = ST.make_grad_fn(gpu)(
        params, {k: v.to(cuda) for k, v in batch.items()})
    cgrads, closs, _ = ST.make_grad_fn(cpu)(cparams, batch)
    assert abs(float(loss) - float(closs)) <= 1e-5 * abs(float(closs))
    for g, c in zip(grads, cgrads):
        assert float((g.cpu() - c).abs().max()) <= 1e-4 * max(
            float(c.abs().max()), 1e-30)


def _launched(counter, fn):
    """``fn()``'s result and how many launches it added to ``counter``."""
    n0 = counter.launches
    out = fn()
    torch.cuda.synchronize()
    return out, counter.launches - n0


def test_ops_on_cuda_launch_as_before_and_a_trace_launches_nothing(cuda):
    """Each kernel op on CUDA tensors launches its kernel once a call, and
    its output (and each gradient) is the kernel wrapper's own bits: the
    stand-in of a fake trace (``kernels/fake``) is not on this path.  The
    same ops on fake CUDA tensors under ``launch/dryrun``'s ``TraceMode``
    give the kernels' shapes and launch nothing."""
    from repro_torch.kernels.selective_scan import kernel as SSK
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.wkv6 import kernel as WKK
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.launch.dryrun import TraceMode
    counters = (embedding_bag_cuda, embedding_bag_grad_cuda,
                flash_attention_cuda, SSK.selective_scan_cuda,
                SSK.selective_scan_grad_cuda, WKK.wkv6_cuda,
                WKK.wkv6_grad_cuda)
    g = torch.Generator(device="cuda").manual_seed(0)
    # K2
    q, k, v = (torch.randn((1, 256, 4, 64), generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    out, n = _launched(flash_attention_cuda,
                       lambda: flash_ops.flash_attention(q, k, v))
    assert n == 1
    assert _same_bits(out, flash_attention_cuda(q, k, v, causal=True))
    # K1 and K1-bwd
    arena = torch.randn((300, 128), generator=g, device=cuda)
    arena[0] = 0.0
    idx = torch.randint(0, 300, (64, 7), generator=g, device=cuda,
                        dtype=torch.int32)
    leaf = arena.clone().requires_grad_(True)
    out, n = _launched(embedding_bag_cuda,
                       lambda: ops.embedding_bag(leaf, idx))
    assert n == 1 and _same_bits(out, embedding_bag_cuda(arena, idx))
    dout = torch.randn(out.shape, generator=g, device=cuda)
    _, n = _launched(embedding_bag_grad_cuda,
                     lambda: out.backward(dout))
    assert n == 1
    assert _same_bits(leaf.grad, embedding_bag_grad_cuda(
        tuple(arena.shape), idx, dout))
    # K3 and K3-bwd
    x, dt, Bc, Cc, A, h0 = _scan_inputs(cuda, 2, 40, 96, 16)
    x = x.to(torch.bfloat16)
    with torch.no_grad():
        (y, hT), n = _launched(SSK.selective_scan_cuda,
                               lambda: scan_ops.selective_scan(
                                   x, dt, Bc, Cc, A, h0))
    assert n == 1
    y0, hT0, hs = SSK.selective_scan_cuda(x, dt, Bc, Cc, A, h0,
                                          save_states=True)
    assert _same_bits(y, y0) and _same_bits(hT, hT0)
    xl = x.clone().requires_grad_(True)
    (y, _), n = _launched(SSK.selective_scan_cuda,
                          lambda: scan_ops.selective_scan(
                              xl, dt, Bc, Cc, A, h0))
    assert n == 1 and _same_bits(y, y0)
    dy = torch.randn(y.shape, generator=g, device=cuda).to(y.dtype)
    _, n = _launched(SSK.selective_scan_grad_cuda, lambda: y.backward(dy))
    assert n == 1
    assert _same_bits(xl.grad, SSK.selective_scan_grad_cuda(
        x, dt, Bc, Cc, A, hs, dy)[0])
    # K4 and K4-bwd
    r, kk, vv, w, u, s0 = _wkv_inputs(cuda, 2, 40, 4)
    r, kk, vv = (t.to(torch.bfloat16) for t in (r, kk, vv))
    with torch.no_grad():
        (y, sT), n = _launched(WKK.wkv6_cuda, lambda: wkv_ops.wkv6(
            r, kk, vv, w, u, s0))
    assert n == 1
    y0, sT0, hs = WKK.wkv6_cuda(r, kk, vv, w, u, s0, save_states=True)
    assert _same_bits(y, y0) and _same_bits(sT, sT0)
    rl = r.clone().requires_grad_(True)
    (y, _), n = _launched(WKK.wkv6_cuda, lambda: wkv_ops.wkv6(
        rl, kk, vv, w, u, s0))
    assert n == 1 and _same_bits(y, y0)
    dy = torch.randn(y.shape, generator=g, device=cuda)
    _, n = _launched(WKK.wkv6_grad_cuda, lambda: y.backward(dy))
    assert n == 1
    assert _same_bits(rl.grad, WKK.wkv6_grad_cuda(
        r, kk, vv, w, u, hs, dy)[0])

    # the same ops on fake CUDA tensors: shapes, and no launch
    before = [c.launches for c in counters]
    with TraceMode():
        def fake(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device=cuda)
        q = fake(1, 256, 4, 64, dtype=torch.bfloat16)
        assert flash_ops.flash_attention(q, q, q).shape == q.shape
        leaf = fake(300, 128).requires_grad_(True)
        out = ops.embedding_bag(leaf, fake(64, 7, dtype=torch.int32))
        out.sum().backward()
        assert out.shape == (64, 128) and leaf.grad.shape == leaf.shape
        xl = fake(2, 40, 96, dtype=torch.bfloat16).requires_grad_(True)
        y, _ = scan_ops.selective_scan(xl, fake(2, 40, 96), fake(2, 40, 16),
                                       fake(2, 40, 16), fake(96, 16),
                                       fake(2, 96, 16))
        y.float().sum().backward()
        assert xl.grad.shape == xl.shape
        rl = fake(2, 40, 4, 64, dtype=torch.bfloat16).requires_grad_(True)
        y, _ = wkv_ops.wkv6(rl, rl, rl, fake(2, 40, 4, 64), fake(4, 64),
                            fake(2, 4, 64, 64))
        y.sum().backward()
        assert rl.grad.shape == rl.shape
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before
