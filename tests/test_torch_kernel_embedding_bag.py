"""K1's plain PyTorch version and op layer against the JAX package.

The same numpy inputs go through the Pallas kernel (interpret mode, as
the JAX package's own tests run it on the CPU) and through the port's
plain version, which the port's CUDA kernel is held against on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).  Tolerances are those of
``tests/test_kernel_embedding_bag.py``: 1e-5 for float32, 3e-2 for
bfloat16 (the two sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ops as jops
from repro.kernels.embedding_bag.kernel import embedding_bag_fused
from repro.kernels.embedding_bag.ref import embedding_bag_grad_ref
from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_grad_plain,
                                                   embedding_bag_plain)


def to_torch(x) -> torch.Tensor:
    """A JAX array as a torch tensor with the same bits (bf16 included)."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("rows", [8, 100, 1000])
@pytest.mark.parametrize("dim", [128, 256])
@pytest.mark.parametrize("pool", [1, 4, 16])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_matches_pallas_kernel(rows, dim, pool, dtype):
    rng = np.random.default_rng(rows * dim + pool)
    arena = jnp.asarray(rng.normal(size=(rows, dim)), dtype)
    idx = jnp.asarray(rng.integers(0, rows, (12, pool)), jnp.int32)
    ref = embedding_bag_fused(arena, idx, interpret=True)
    out = embedding_bag_plain(to_torch(arena), to_torch(idx))
    assert out.dtype == torch.float32
    tol = 1e-5 if dtype == jnp.float32 else 3e-2
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


def test_zero_row_padding():
    rng = np.random.default_rng(0)
    arena = torch.as_tensor(rng.normal(size=(50, 128)), dtype=torch.float32)
    arena[0] = 0.0
    out = embedding_bag_plain(arena, torch.zeros((4, 8), dtype=torch.int32))
    assert (out == 0).all()


def test_arena_layout_and_base_rows():
    tables = [torch.ones((10, 16)), torch.ones((5, 64))]
    arena, bases = ops.build_arena(tables)
    jarena, jbases = jops.build_arena([jnp.ones((10, 16)), jnp.ones((5, 64))])
    assert tuple(arena.shape) == (16, 128)          # 1 zero row + 10 + 5
    np.testing.assert_array_equal(bases, [1, 11])
    np.testing.assert_array_equal(bases, jbases)
    np.testing.assert_array_equal(arena.numpy(), np.asarray(jarena))
    assert (arena[0] == 0).all()
    assert (arena[1, :16] == 1).all() and (arena[1, 16:] == 0).all()


def test_rebase_indices_with_padding():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 16, (3, 5, 4))
    idx[rng.random(idx.shape) < 0.3] = -1
    bases = np.array([1, 17, 40])
    out = ops.rebase_indices(torch.as_tensor(idx, dtype=torch.int32), bases)
    ref = jops.rebase_indices(jnp.asarray(idx, jnp.int32), bases)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out.numpy()[idx < 0] == 0).all()


def test_multi_table_lookup_matches_jax():
    rng = np.random.default_rng(1)
    shapes = [(64, 16), (32, 48), (128, 16), (16, 128)]
    tables = [rng.normal(size=s).astype(np.float32) for s in shapes]
    idx = rng.integers(0, 16, (4, 6, 7))
    idx[rng.random(idx.shape) < 0.25] = -1
    arena, bases = ops.build_arena([torch.as_tensor(t) for t in tables])
    out = ops.fused_embedding_lookup(arena, bases,
                                     torch.as_tensor(idx, dtype=torch.int32))
    jarena, jbases = jops.build_arena([jnp.asarray(t) for t in tables])
    ref = jops.fused_embedding_lookup(jarena, jbases,
                                      jnp.asarray(idx, jnp.int32))
    assert tuple(out.shape) == (4, 6, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    plain = ops.fused_embedding_lookup_ref(
        arena, bases, torch.as_tensor(idx, dtype=torch.int32))
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


def test_autograd_gradient_matches_jax_grad_ref():
    rng = np.random.default_rng(2)
    arena_np = rng.normal(size=(30, 128)).astype(np.float32)
    idx_np = rng.integers(0, 30, (6, 4)).astype(np.int32)   # row 0 included
    arena = torch.as_tensor(arena_np).requires_grad_()
    idx = torch.as_tensor(idx_np)
    (ops.embedding_bag(arena, idx) ** 2).sum().backward()

    def loss(a):
        return (jops.embedding_bag(a, jnp.asarray(idx_np)) ** 2).sum()

    jgrad = jax.grad(loss)(jnp.asarray(arena_np))
    np.testing.assert_allclose(arena.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-4)
    out = embedding_bag_plain(torch.as_tensor(arena_np), idx)
    gref = embedding_bag_grad_ref(arena_np.shape, idx_np,
                                  2 * out.numpy())
    np.testing.assert_allclose(arena.grad.numpy(), np.asarray(gref),
                               rtol=1e-4, atol=1e-4)
    assert (arena.grad[0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_plain_matches_jax_grad_ref(dtype):
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 40, (50, 6)).astype(np.int32)
    g = rng.normal(size=(50, 128)).astype(np.float32)
    out = embedding_bag_grad_plain((40, 128), torch.as_tensor(idx),
                                   torch.as_tensor(g).to(dtype))
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    ref = embedding_bag_grad_ref((40, 128), jnp.asarray(idx),
                                 jnp.asarray(g, jdtype))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
