"""The port's data pipeline against ``repro.data.pipeline``: the streams
give the reference's arrays bit for bit at each ``(seed, step)``, and the
reference's hash-bound and prefetch cases hold."""

import numpy as np
import pytest

from repro.data import pipeline as JP
from repro_torch.data import pipeline as TP


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250)])
def test_dlrm_stream_is_the_reference_bitwise(dlrm_pool, seed, step):
    raw = dlrm_pool[:9]
    for kw in ({}, {"n_dense": 4, "pool_slots": 6}):
        _assert_same(TP.DLRMBatchStream(raw, 16, seed=seed, **kw)
                     .batch_at(step),
                     JP.DLRMBatchStream(raw, 16, seed=seed, **kw)
                     .batch_at(step))


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 13), (2, 99)])
@pytest.mark.parametrize("nf", [0, 4])
def test_lm_stream_is_the_reference_bitwise(seed, step, nf):
    kw = dict(vocab=1000, batch=4, seq=32, n_frontend_tokens=nf,
              d_model=8, seed=seed)
    _assert_same(TP.LMBatchStream(**kw).batch_at(step),
                 JP.LMBatchStream(**kw).batch_at(step))


def test_dlrm_stream_respects_hash_bounds(dlrm_pool):
    s = TP.DLRMBatchStream(dlrm_pool[:6], batch=8, seed=0)
    b = s.batch_at(3)
    assert b["indices"].shape == (8, 6, 16)
    for t in range(6):
        live = b["indices"][:, t][b["indices"][:, t] >= 0]
        assert (live < dlrm_pool[t, 1]).all()


@pytest.mark.parametrize("depth", [1, 2])
def test_prefetcher_matches_direct(dlrm_pool, depth):
    s = TP.LMBatchStream(vocab=100, batch=2, seq=8, seed=1)
    p = TP.Prefetcher(s, depth=depth)
    try:
        got = [p.next() for _ in range(5)]
    finally:
        p.close()
    assert not p._thread.is_alive()
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["tokens"], s.batch_at(i)["tokens"])
    d = TP.DLRMBatchStream(dlrm_pool[:4], batch=4, seed=2)
    p = TP.Prefetcher(d, depth=depth, start_step=3)
    try:
        got = [p.next() for _ in range(3)]
    finally:
        p.close()
    for i, b in enumerate(got):
        _assert_same(b, JP.DLRMBatchStream(dlrm_pool[:4], batch=4, seed=2)
                     .batch_at(3 + i))
