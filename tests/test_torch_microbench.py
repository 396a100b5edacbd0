"""The port's micro-benchmark harness against the JAX package's, on the CPU.

The synthesized indices must be bitwise the reference's.  Times taken
here are host-clock CPU times: the tests check only their shape and sign.
"""

import numpy as np
import pytest
import torch

from repro.data.synthetic import make_dlrm_pool
from repro.profiling import microbench as jmb
from repro.sim.costsim import placement_digest
from repro_torch.profiling import microbench as mb


@pytest.mark.parametrize("dim,rows,batch,pooling",
                         [(128, 100, 16, 4), (16, 5000, 64, 1)])
def test_make_inputs_indices_are_the_reference(dim, rows, batch, pooling):
    arena, idx, g = mb.make_inputs(dim, rows, batch, pooling, seed=3,
                                   device="cpu")
    jarena, jidx, jg = jmb.make_inputs(dim, rows, batch, pooling, seed=3)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(arena.numpy(), np.asarray(jarena))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def test_make_fused_inputs_indices_are_the_reference():
    args = ([16, 64, 16], [50, 300, 7], 32, [3, 1, 9])
    arena, idx, g = mb.make_fused_inputs(*args, seed=5, device="cpu")
    jarena, jidx, jg = jmb.make_fused_inputs(*args, seed=5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert tuple(arena.shape) == tuple(jarena.shape) == (358, 128)
    assert tuple(g.shape) == tuple(jg.shape)


def test_measure_placement_on_cpu():
    raw = make_dlrm_pool(seed=0)[:9]
    a = np.array([0, 2, 0, 2, 2, 0, 0, 2, 0])         # device 1 empty
    kw = dict(batch_size=8, pooling=None, max_rows=300, repeats=1)
    res = mb.measure_placement(raw, a, 3, device="cpu", **kw)
    ref = jmb.measure_placement(raw, a, 3, use_pallas=False, **kw)
    assert res.fwd_comp[1] == 0 and res.bwd_comp[1] == 0
    assert (res.fwd_comp[[0, 2]] > 0).all() and \
        (res.bwd_comp[[0, 2]] > 0).all()
    np.testing.assert_array_equal(res.bwd_comm, ref.bwd_comm)
    assert res.overall == pytest.approx(
        res.fwd_comp.max() + 2 * res.bwd_comm.max() + res.bwd_comp.max())


def test_measure_placement_indices_follow_the_reference_stream(monkeypatch):
    """Each device's fused op sees the indices the JAX harness draws (its
    per-device synthesis, ``repro/profiling/microbench.py:377-393``)."""
    raw = make_dlrm_pool(seed=1)[:6]
    a = np.array([1, 0, 1, 1, 0, 0])
    seen = []
    monkeypatch.setattr(mb, "_time_fwd_bwd",
                        lambda arena, idx, g, **kw: (seen.append(
                            (arena.shape[0], idx.numpy().copy()))
                            or (1.0, 1.0)))
    mb.measure_placement(raw, a, 2, batch_size=4, pooling=None,
                         max_rows=100, device="cpu")
    assert len(seen) == 2
    rng = np.random.default_rng(placement_digest(raw, a, 2) ^ 0)
    for d, (n_rows, idx) in enumerate(seen):
        sub = raw[a == d]
        rows = np.minimum(sub[:, 1].astype(np.int64), 100)
        pools = np.maximum(1, np.rint(sub[:, 2]).astype(np.int64))
        bases = np.concatenate([[1], 1 + np.cumsum(rows)[:-1]])
        ref = np.zeros((4 * len(rows), int(pools.max())), np.int32)
        for k, (b, r, p) in enumerate(zip(bases, rows, pools)):
            draws = rng.zipf(1.5, size=(4, int(p)))
            ref[k * 4:k * 4 + 4, :int(p)] = b + draws % r
        assert n_rows == 1 + rows.sum()
        np.testing.assert_array_equal(idx, ref)


def test_measure_placement_times_the_ops_backward(monkeypatch):
    """The backward timed is the op's (the kernel on a card), not the
    plain ``index_add_`` loop."""
    calls = []
    op = mb.embedding_bag_grad
    monkeypatch.setattr(mb, "embedding_bag_grad",
                        lambda *a: calls.append(a[0]) or op(*a))
    raw = make_dlrm_pool(seed=0)[:5]
    a = np.array([0, 1, 0, 1, 1])
    mb.measure_placement(raw, a, 2, batch_size=8, pooling=None, max_rows=50,
                         repeats=2, device="cpu")
    assert len(calls) == 2 * (1 + 2)               # devices x (warm-up + 2)
    assert not hasattr(mb, "embedding_bag_grad_plain")


def test_bench_shapes_on_cpu():
    pt = mb.bench_shape(16, 200, 8, 3, repeats=1, device="cpu")
    assert pt.dim == 128 and pt.fwd_ms > 0 and pt.bwd_ms > 0
    fpt = mb.bench_fused_shape([16, 16], [50, 60], 8, [2, 5], repeats=1,
                               device="cpu")
    assert fpt.k == 2 and fpt.fwd_ms > 0 and fpt.bwd_ms > 0


def test_median_time_ms_on_host_clock():
    calls = []
    ms = mb.median_time_ms(lambda x: calls.append(x), (1,), warmup=2,
                           repeats=3)
    assert len(calls) == 5 and ms >= 0
