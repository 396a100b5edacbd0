"""Port tests that need an NVIDIA GPU (marker ``gpu``; skipped elsewhere).

This file imports neither ``jax`` nor ``repro``, so it runs on a machine
that has only PyTorch: K1 against its plain version and the autograd op on
the card, the wrapper's input checks, its launch count, and the default
device of the entry points.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_grad_plain,
                                                   embedding_bag_plain)

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
