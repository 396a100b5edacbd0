"""K1's plain PyTorch version and op layer against the JAX package.

The same numpy inputs go through the Pallas kernel (interpret mode, as
the JAX package's own tests run it on the CPU) and through the port's
plain version, which the port's CUDA kernel is held against on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).  Tolerances are those of
``tests/test_kernel_embedding_bag.py``: 1e-5 for float32, 3e-2 for
bfloat16 (the two sum in different orders).

The backward kernel's arithmetic is replayed here in plain torch
(``ref.embedding_bag_grad_replay``): its plan (``kernel.backward_plan``:
padding dropped, a stable sort by row, runs cut into chunks) and its two
passes.  The replay is held to the plain ``index_add_`` version and to the
JAX
``embedding_bag_grad_ref``: bit for bit on integer-valued gradients (every
sum exact, whatever the order), and otherwise against a float64
``index_add_``, where its max |err| must be at most twice the float32
plain version's own plus 1e-6 (the two add in different orders, so they
cannot be bit-equal).

On the card the backward builds that plan itself, with launches sized
from N, P and R alone; the pure-Python helpers that size them
(``radix_passes``, ``chunk_size``, ``partial_bound``, ``grad_sizes``) are
held here to ``backward_plan``.
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
from repro_torch.kernels.embedding_bag import kernel as K
from repro_torch.kernels.embedding_bag.kernel import backward_plan
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_grad_plain,
                                                   embedding_bag_grad_replay,
                                                   embedding_bag_plain,
                                                   segment_sums_plain)


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


def _grad_inputs(seed, integer, rows=60, bags=400, pool=11, dim=128):
    """Zipf-ish indices (row 1 of the table takes ~40% of the slots: a run
    far longer than the chunk), 40% padding, the first bag all padding,
    and an integer-valued or a normal gradient."""
    rng = np.random.default_rng(seed)
    idx = (1 + rng.zipf(1.5, (bags, pool)) % (rows - 1)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.4] = 0
    idx[0] = 0
    g = (rng.integers(-3, 4, (bags, dim)) if integer
         else rng.normal(size=(bags, dim))).astype(np.float32)
    return idx, g


def _f64(shape, idx, g):
    out = torch.zeros(shape, dtype=torch.float64)
    for j in range(idx.shape[1]):
        out.index_add_(0, idx[:, j].long(), g.double())
    out[0] = 0.0
    return out


@pytest.mark.parametrize("chunk", [1, 4, 64])
@pytest.mark.parametrize("integer", [True, False])
def test_backward_replay_matches_plain_and_jax(chunk, integer):
    idx_np, g_np = _grad_inputs(11 + chunk, integer)
    shape = (60, 128)
    idx, g = torch.as_tensor(idx_np), torch.as_tensor(g_np)
    out = embedding_bag_grad_replay(shape, idx, g, chunk)
    plain = embedding_bag_grad_plain(shape, idx, g)
    jref = to_torch(embedding_bag_grad_ref(shape, jnp.asarray(idx_np),
                                           jnp.asarray(g_np)))
    assert (out[0] == 0).all()
    if integer:
        torch.testing.assert_close(out, plain, rtol=0, atol=0)
        torch.testing.assert_close(out, jref, rtol=0, atol=0)
    else:
        ref64 = _f64(shape, idx, g)

        def err(x):
            return float((x.double() - ref64).abs().max())
        assert err(out) <= 2 * err(plain) + 1e-6
        assert err(out) <= 2 * err(jref) + 1e-6


@pytest.mark.parametrize("chunk", [1, 4, 64])
def test_backward_plan_boundaries(chunk):
    idx_np, _ = _grad_inputs(5, True, rows=40, bags=900, pool=13)
    idx = torch.as_tensor(idx_np)
    plan = backward_plan(idx, chunk)
    flat = idx.reshape(-1)
    real = torch.nonzero(flat).squeeze(1)
    assert plan.bags.dtype == torch.int32
    assert plan.bags.numel() == real.numel() == plan.chunk_bounds[-1]
    # the runs: distinct non-zero rows in order, each with its slot count
    rows, counts = torch.unique(flat[real], return_counts=True)
    torch.testing.assert_close(plan.run_rows, rows.long())
    assert plan.run_bounds[0] == 0
    assert plan.run_bounds[-1] == plan.chunk_bounds.numel() - 1
    sizes = plan.chunk_bounds.diff()
    assert (sizes > 0).all()
    for r, (row, count) in enumerate(zip(rows.tolist(), counts.tolist())):
        first, last = plan.run_bounds[r], plan.run_bounds[r + 1]
        lo, hi = plan.chunk_bounds[first], plan.chunk_bounds[last]
        assert hi - lo == count                    # the run's slots
        bags = plan.bags[lo:hi].long()
        # stable: the run's bags in slot order, each slot of this row
        slots = real[flat[real] == row]
        torch.testing.assert_close(bags, slots // idx.shape[1])
        # at most max(chunk, ceil(sqrt(count))) slots a chunk, all but the
        # last of a run full
        limit = max(chunk, int(np.ceil(np.sqrt(count))))
        run_sizes = sizes[first:last]
        assert (run_sizes[:-1] == limit).all() and run_sizes[-1] <= limit
    assert len(rows) < len(sizes)                  # some runs were cut


def test_backward_plan_of_all_padding_is_empty():
    plan = backward_plan(torch.zeros((5, 3), dtype=torch.int32))
    assert plan.bags.numel() == plan.run_rows.numel() == 0
    assert plan.chunk_bounds.tolist() == plan.run_bounds.tolist() == [0]


def test_segment_sums_plain_adds_in_order():
    src = torch.tensor([[1e8], [1.0], [-1e8], [1.0]], dtype=torch.float32)
    bounds = torch.tensor([0, 4, 4])               # an empty segment too
    out = segment_sums_plain(src, None, bounds)
    # ((1e8 + 1) - 1e8) + 1 in float32: the 1 is lost in the first add
    assert out[:, 0].tolist() == [1.0, 0.0]
    ids = torch.tensor([3, 1, 0, 2], dtype=torch.int32)
    assert segment_sums_plain(src, ids, bounds)[:, 0].tolist() == [0.0, 0.0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_op_on_cpu_is_the_plain_version(dtype):
    idx_np, g_np = _grad_inputs(8, False)
    idx, g = torch.as_tensor(idx_np), torch.as_tensor(g_np).to(dtype)
    out = ops.embedding_bag_grad((60, 128), idx, g)
    torch.testing.assert_close(
        out, embedding_bag_grad_plain((60, 128), idx, g), rtol=0, atol=0)


@pytest.mark.parametrize("n_rows,passes", [
    (1, 1), (2, 1), (256, 1), (257, 2), (70000, 3), (12464046, 3),
    (2 ** 24, 3), (2 ** 24 + 1, 4), (2 ** 24 + 2 ** 20, 4), (2 ** 32, 4)])
def test_radix_passes_cover_the_rows(n_rows, passes):
    assert K.radix_passes(n_rows) == passes
    assert (n_rows - 1) >> (K.RADIX_BITS * passes) == 0


@pytest.mark.parametrize("chunk", [1, 4, 64])
def test_chunk_size_is_backward_plans_rule_up_to_2_31(chunk):
    roots = np.arange(1, 46342, dtype=np.int64)
    lengths = np.unique(np.concatenate([
        np.arange(1, 100001), roots ** 2 - 1, roots ** 2, roots ** 2 + 1,
        [2 ** 31 - 1, 2 ** 31]]))
    lengths = lengths[(lengths >= 1) & (lengths <= 2 ** 31)]
    ref = torch.as_tensor(lengths).double().sqrt().ceil().long().clamp(
        min=chunk)
    got = [K.chunk_size(int(n), chunk) for n in lengths]
    assert got == ref.tolist()


@pytest.mark.parametrize("chunk", [1, 2, 4, 64])
def test_partial_bound_over_run_lengths(chunk):
    # a run of L slots has n = ceil(L / chunk_size(L)) chunks; those of
    # more than one chunk are the partials
    for length in range(1, 20001):
        n = -(-length // K.chunk_size(length, chunk))
        assert n == 1 or n * (chunk + 1) <= 2 * length


@pytest.mark.parametrize("seed", [5, 11, 12, 75])
@pytest.mark.parametrize("chunk", [4, 64])
def test_grad_sizes_bound_backward_plan(seed, chunk):
    idx_np, _ = _grad_inputs(seed, True, rows=40 + seed, bags=900, pool=13)
    idx = torch.as_tensor(idx_np)
    plan = backward_plan(idx, chunk)
    z = K.grad_sizes(900, 13, 40 + seed, sms=2, chunk=chunk)
    n_chunks = plan.run_bounds.diff()
    assert plan.bags.numel() <= z.slots
    assert plan.run_rows.numel() <= z.max_runs
    assert plan.chunk_bounds.numel() - 1 <= z.max_chunks
    assert int(n_chunks[n_chunks > 1].sum()) <= z.max_partials
    assert z.passes == K.radix_passes(40 + seed)
    assert z.tiles * K.SLOT_TILE >= z.slots > (z.tiles - 1) * K.SLOT_TILE
    assert 1 <= z.radix_grid <= K.BLOCKS_PER_SM * 2


def test_grad_sizes_of_no_slots():
    z = K.grad_sizes(0, 7, 100, sms=132)
    assert (z.slots, z.tiles, z.max_runs, z.max_partials, z.max_chunks) == (
        0, 0, 0, 0, 0)
    assert z.radix_grid == 1
    assert K.scratch_bytes(z, 128) > 0
