"""``DreamShard.place`` decodes a task as ``PlacementSession.place_many``
does (padded to its bucket of tables, in a call of ``DECODE_BATCH``
tasks), so the two give it the same bits: assignment and estimated cost,
greedy and with sampled candidates (on the CPU here; the card's pin is
``test_place_equals_place_many_on_cuda``)."""

import numpy as np
import pytest
import torch

from repro_torch.api import PlacementSession, SimOracle
from repro_torch.api.session import pad_tables
from repro_torch.core.trainer import DreamShard, DreamShardConfig
from repro_torch.data.synthetic import make_dlrm_pool
from repro_torch.data.tasks import make_benchmark_suite

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    _, test = make_benchmark_suite(make_dlrm_pool(seed=0), n_tables=20,
                                   n_devices=4, n_tasks=6)
    agent = DreamShard(test[:2], SimOracle(seed=0), DreamShardConfig(seed=0),
                       device="cpu")
    return agent, test


@pytest.mark.parametrize("k", [1, 16])
def test_place_is_place_many_bit_for_bit(world, k):
    agent, test = world
    served = PlacementSession(agent, n_candidates=k).place_many(test)
    for t, p in zip(test, served):
        a, est = agent.place_detailed(t.raw_features, t.n_devices, k)
        assert np.array_equal(p.assignment, a)
        assert np.float32(p.est_cost_ms).view(np.int32) == \
            np.float32(est).view(np.int32)
        assert np.array_equal(agent.place(t.raw_features, t.n_devices, k), a)


@pytest.mark.parametrize("m, bucket, padded", [
    (1, 8, 8), (8, 8, 8), (9, 8, 16), (20, 8, 24), (20, 4, 20), (21, 4, 24),
    (5, 1, 5),
])
def test_session_and_place_pad_tables_by_one_rule(world, m, bucket, padded):
    agent, test = world
    assert pad_tables(m, bucket) == padded
    task = test[0]
    session = PlacementSession(agent, bucket_tables=bucket)
    assert session.bucket_key(task) == (pad_tables(task.n_tables, bucket),
                                        task.n_devices)
