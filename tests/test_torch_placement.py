"""The slice end to end: a JAX DreamShard agent, saved and restored into the
port, places the paper's DLRM-50 (4) test tasks exactly as JAX does.

The JAX agent trains one short iteration (``n_iterations=1``) with
``inference_candidates=1`` (greedy decode), so the comparison does not
depend on random draws.  The port's own 16-candidate session must equal
its per-task ``place``; the baseline placers, the simulated costs and the
checkpoint format must be bitwise the JAX package's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import SimOracle as JSimOracle
from repro.api import evaluate_placer as j_evaluate_placer
from repro.api import make_baseline_placers as j_make_baseline_placers
from repro.api import measure_placements as j_measure_placements
from repro.core.trainer import DreamShard as JDreamShard
from repro.core.trainer import DreamShardConfig as JConfig
from repro.data.synthetic import make_dlrm_pool as j_make_dlrm_pool
from repro.data.tasks import make_benchmark_suite as j_make_suite
from repro_torch import telemetry as tele
from repro_torch.api import (SimOracle, evaluate_placer,
                             make_baseline_placers, measure_placements)
from repro_torch.core import networks as N
from repro_torch.core.trainer import DreamShard, DreamShardConfig
from repro_torch.data.synthetic import make_dlrm_pool
from repro_torch.data.tasks import make_benchmark_suite

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)

N_TASKS = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jtrain, jtest = j_make_suite(j_make_dlrm_pool(seed=0), 50, 4,
                                 n_tasks=N_TASKS)
    train, test = make_benchmark_suite(make_dlrm_pool(seed=0), 50, 4,
                                       n_tasks=N_TASKS)
    cfg = JConfig(n_iterations=1, inference_candidates=1, n_collect=4,
                  n_cost=20, n_rl=2)
    jagent = JDreamShard(jtrain, JSimOracle(seed=0), cfg)
    jagent.train()
    path = str(tmp_path_factory.mktemp("jax_agent"))
    jagent.save(path)
    agent = DreamShard(train, SimOracle(seed=0), device="cpu")
    agent.restore(path)
    return dict(jagent=jagent, agent=agent, jtest=jtest, test=test,
                train=train, path=path)


def test_pools_and_tasks_are_bitwise_the_reference():
    np.testing.assert_array_equal(make_dlrm_pool(seed=0),
                                  j_make_dlrm_pool(seed=0))
    for mine, ref in zip(*(f(p, 50, 4, n_tasks=3) for f, p in (
            (make_benchmark_suite, make_dlrm_pool(0)),
            (j_make_suite, j_make_dlrm_pool(0))))):
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a.raw_features, b.raw_features)
            np.testing.assert_array_equal(a.table_ids, b.table_ids)
            assert (a.n_devices, a.name) == (b.n_devices, b.name)


def test_restore_reads_the_jax_checkpoint(world):
    agent, jagent = world["agent"], world["jagent"]
    assert dataclasses.asdict(agent.cfg) == dataclasses.asdict(jagent.cfg)
    for ours, ref in ((agent.cost_net, jagent.cost_params),
                      (agent.policy_net, jagent.policy_params)):
        jax.tree.map(np.testing.assert_array_equal, N.params_to_jax(ours),
                     jax.tree.map(np.asarray, ref))


def test_place_many_matches_jax(world):
    ours = world["agent"].as_placer().place_many(world["test"])
    ref = world["jagent"].as_placer().place_many(world["jtest"])
    for p, r in zip(ours, ref):
        np.testing.assert_array_equal(p.assignment, r.assignment)
        np.testing.assert_allclose(p.est_cost_ms, r.est_cost_ms, rtol=1e-5)
        np.testing.assert_array_equal(p.plan.base_rows, r.plan.base_rows)
        np.testing.assert_array_equal(p.plan.slot_table, r.plan.slot_table)
        assert (p.strategy, p.candidates, p.n_devices) == \
            (r.strategy, r.candidates, r.n_devices)


def test_place_detailed_matches_jax(world):
    for t, jt in zip(world["test"], world["jtest"]):
        a, est = world["agent"].place_detailed(t.raw_features, t.n_devices)
        ja, jest = world["jagent"].place_detailed(jt.raw_features,
                                                  jt.n_devices)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_allclose(est, jest, rtol=1e-5)


def test_session_equals_per_task_place_at_16_candidates(world):
    agent = world["agent"]
    placer = agent.as_placer(n_candidates=16)
    tele.reset()
    tele.enable()
    try:
        placements = placer.place_many(world["test"])
        placer.place_many(world["test"][:3])
        snap = tele.snapshot()
    finally:
        tele.disable()
        tele.reset()
    for t, p in zip(world["test"], placements):
        a, est = agent.place_detailed(t.raw_features, t.n_devices, 16)
        np.testing.assert_array_equal(p.assignment, a)
        assert p.candidates == 16 and p.est_cost_ms == pytest.approx(est)
    # one bucket (56, 4); batches padded to 4 tasks both times
    assert snap["counters"]["session.decode_calls"] == 2
    assert snap["counters"]["session.bucket_compiles"] == 1
    assert snap["spans"]["session.decode"]["count"] == 2


def test_baseline_placers_match_jax(world):
    ours = make_baseline_placers(SimOracle(seed=0), seed=3,
                                 include_portfolio=True)
    ref = j_make_baseline_placers(JSimOracle(seed=0), seed=3,
                                  include_portfolio=True)
    assert list(ours) == list(ref)
    for name in ours:
        for p, r in zip(ours[name].place_many(world["test"]),
                        ref[name].place_many(world["jtest"])):
            np.testing.assert_array_equal(p.assignment, r.assignment)
            assert p.strategy == r.strategy and \
                p.est_cost_ms == r.est_cost_ms


def test_simulated_costs_are_bitwise_equal(world):
    placements = world["agent"].as_placer().place_many(world["test"])
    ours = measure_placements(SimOracle(seed=0), world["test"], placements)
    ref = j_measure_placements(JSimOracle(seed=0), world["jtest"],
                               placements)
    np.testing.assert_array_equal(ours, ref)
    expert = make_baseline_placers(SimOracle(seed=0))["lookup"]
    jexpert = j_make_baseline_placers(JSimOracle(seed=0))["lookup"]
    assert evaluate_placer(SimOracle(seed=0), world["test"], expert) == \
        j_evaluate_placer(JSimOracle(seed=0), world["jtest"], jexpert)


def test_port_checkpoint_restores_in_jax(world, tmp_path):
    agent = DreamShard(world["train"], SimOracle(seed=0),
                       DreamShardConfig(seed=5, inference_candidates=3),
                       device="cpu")
    agent.save(str(tmp_path))
    jagent = JDreamShard(world["train"], JSimOracle(seed=0),
                         JConfig(n_iterations=1))
    jagent.restore(str(tmp_path))
    assert jagent.cfg.seed == 5 and jagent.cfg.inference_candidates == 3
    for ours, ref in ((agent.cost_net, jagent.cost_params),
                      (agent.policy_net, jagent.policy_params)):
        jax.tree.map(np.testing.assert_array_equal, N.params_to_jax(ours),
                     jax.tree.map(np.asarray, ref))
    again = DreamShard(world["train"], SimOracle(seed=0), device="cpu")
    again.restore(str(tmp_path))
    t = world["test"][0]
    np.testing.assert_array_equal(again.place(t.raw_features, 4),
                                  agent.place(t.raw_features, 4))
