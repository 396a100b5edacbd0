"""The port's request traces (``repro_torch.data.traffic``) against
``repro.data.traffic``: ``make_trace`` is host numpy drawing in the same
order (``split_pool``, then one ``rng.choice`` per job, the popularity
draw, the tail jobs), so every request must be bitwise the reference's."""

import numpy as np
import pytest

from repro.data.synthetic import make_dlrm_pool as j_make_dlrm_pool
from repro.data.traffic import TrafficConfig as JTrafficConfig
from repro.data.traffic import make_trace as j_make_trace
from repro_torch.data.synthetic import make_dlrm_pool
from repro_torch.data.traffic import Request, TrafficConfig, make_trace

# b11's quick and paper regimes (``benchmarks/b11_serve.py``), b12's quick
# regime at 8 devices, a zero-drift trace and a uniform-popularity one
CONFIGS = {
    "b11-quick": dict(n_jobs=6, n_tables=16, n_devices=4, n_requests=400,
                      drift=0.8, zipf=1.0, tail_jobs=4, seed=0),
    "b11-paper": dict(n_jobs=12, n_tables=50, n_devices=4, n_requests=1500,
                      drift=0.8, zipf=1.0, tail_jobs=8, seed=0),
    "b12-quick": dict(n_jobs=6, n_tables=16, n_devices=8, n_requests=400,
                      drift=0.8, zipf=1.0, tail_jobs=4, seed=0),
    "zero-drift": dict(n_jobs=4, n_tables=12, n_devices=4, n_requests=24,
                       drift=0.0, seed=3),
    "uniform": dict(n_jobs=3, n_tables=12, n_devices=4, n_requests=48,
                    drift=1.0, zipf=0.0, seed=5),
}


@pytest.fixture(scope="module")
def pools():
    pool, jpool = make_dlrm_pool(seed=0), j_make_dlrm_pool(seed=0)
    np.testing.assert_array_equal(pool, jpool)
    return pool, jpool


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_make_trace_is_bitwise_the_reference(pools, name):
    pool, jpool = pools
    kw = CONFIGS[name]
    trace = make_trace(pool, TrafficConfig(**kw))
    ref = j_make_trace(jpool, JTrafficConfig(**kw))
    assert len(trace) == len(ref) == kw["n_requests"] + kw.get("tail_jobs",
                                                               0)
    for r, j in zip(trace, ref):
        assert isinstance(r, Request)
        assert (r.job, r.n_devices, r.progress) == \
            (j.job, j.n_devices, j.progress)
        assert r.raw_features.dtype == j.raw_features.dtype
        np.testing.assert_array_equal(r.raw_features, j.raw_features)


def test_zero_drift_repeats_are_bitwise_equal(pools):
    trace = make_trace(pools[0], TrafficConfig(**CONFIGS["zero-drift"]))
    first = {}
    for r in trace:
        ref = first.setdefault(r.job, r.raw_features)
        np.testing.assert_array_equal(r.raw_features, ref)
    assert len(first) == CONFIGS["zero-drift"]["n_jobs"]


def test_tail_jobs_are_one_off_and_last(pools):
    kw = CONFIGS["b11-quick"]
    trace = make_trace(pools[0], TrafficConfig(**kw))
    tail = trace[kw["n_requests"]:]
    assert [r.job for r in tail] == list(range(kw["n_jobs"],
                                               kw["n_jobs"] + kw["tail_jobs"]))
    assert all(r.progress == 1.0 for r in tail)
    assert all(r.job < kw["n_jobs"] for r in trace[:kw["n_requests"]])
