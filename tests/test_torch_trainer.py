"""The port's Algorithm-1 trainer against the JAX package's, on the CPU.

* The host RNG draws the same task and minibatch indices as the JAX
  trainer for one seed, on the fused and on the per-step path.
* The per-step and the fused paths agree, as ``tests/test_fused_trainer``
  holds them in JAX (here they sample the same noise, so they collect the
  same placements).
* The device ring follows the host buffer (wrap, geometric growth,
  reassignment), and ``restore`` rebuilds the optimizers.
* Trained from scratch, the port lands in the JAX trainer's seed-to-seed
  spread: the median of three port seeds lies within the range of three
  JAX seeds widened by that range on each side (DLRM-20 (4), 4 tasks, 3
  iterations, the analytic simulator).
"""

import numpy as np
import pytest
import torch

from repro.core.trainer import DreamShard as JDreamShard
from repro.core.trainer import DreamShardConfig as JConfig
from repro.data.synthetic import make_dlrm_pool
from repro.data.tasks import make_benchmark_suite
from repro.sim.costsim import CostSimulator
from repro_torch.api import SimOracle
from repro_torch.core.trainer import CostSample, DreamShard, DreamShardConfig

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)


def _cfg(**kw):
    base = dict(n_iterations=2, n_collect=6, n_cost=30, n_batch=8, n_rl=4,
                n_episode=4)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def suite():
    return make_benchmark_suite(make_dlrm_pool(seed=0), n_tables=12,
                                n_devices=4, n_tasks=6)


def _port(train, **kw):
    return DreamShard(train, SimOracle(seed=0), DreamShardConfig(**_cfg(**kw)),
                      device="cpu")


class Recorder:
    """Wraps a numpy Generator and records every ``integers`` draw."""

    def __init__(self, rng):
        self.rng, self.calls = rng, []

    def integers(self, *args, **kw):
        out = self.rng.integers(*args, **kw)
        self.calls.append((args, tuple(sorted(kw.items())),
                           np.asarray(out).tolist()))
        return out


@pytest.fixture(scope="module")
def seed_runs():
    """Three JAX and three port agents trained from scratch on DLRM-20
    (4), 4 tasks, 3 iterations (fused path), each scored on the test
    tasks; seed 0's host-RNG draws are recorded on both sides."""
    pool = make_dlrm_pool(seed=0)
    train, test = make_benchmark_suite(pool, 20, 4, n_tasks=4)
    kw = dict(n_iterations=3, n_collect=10, n_cost=100, n_rl=10,
              n_episode=10)
    out = {"ref": [], "port": []}
    calls = {}
    for name in ("ref", "port"):
        for seed in range(3):
            if name == "ref":
                agent = JDreamShard(train, CostSimulator(seed=0),
                                    JConfig(seed=seed, **kw))
            else:
                agent = DreamShard(train, SimOracle(seed=0),
                                   DreamShardConfig(seed=seed, **kw),
                                   device="cpu")
            if seed == 0:
                agent.rng = Recorder(agent.rng)
            agent.train()
            if seed == 0:
                calls[name] = agent.rng.calls
            out[name].append(agent.evaluate_tasks(test))
    out["untrained"] = DreamShard(train, SimOracle(seed=0),
                                  DreamShardConfig(seed=0, **kw),
                                  device="cpu").evaluate_tasks(test)
    out["calls"] = calls
    return out


def test_same_seed_draws_the_reference_indices_fused(seed_runs):
    ref, port = seed_runs["calls"]["ref"], seed_runs["calls"]["port"]
    # 3 x (10 task draws, 100 minibatch draws, 10 task draws)
    assert len(port) == len(ref) == 360
    assert port == ref


def test_same_seed_draws_the_reference_indices_per_step(suite):
    train, _ = suite
    cfg = _cfg(fused=False, seed=3, n_cost=12)
    port = DreamShard(train, SimOracle(seed=0), DreamShardConfig(**cfg),
                      device="cpu")
    ref = JDreamShard(train, CostSimulator(seed=0), JConfig(**cfg))
    for agent in (port, ref):
        agent.rng = Recorder(agent.rng)
        agent.train()
    assert len(port.rng.calls) == len(ref.rng.calls) == 2 * (6 + 12 + 4)
    assert port.rng.calls == ref.rng.calls
    assert len(port.buffer) == len(ref.buffer)


@pytest.fixture(scope="module")
def both_paths(suite):
    train, test = suite
    runs = {}
    for fused in (True, False):
        ds = _port(train, fused=fused)
        ds.train(eval_tasks=test[:3])
        runs[fused] = ds
    return runs


def test_fused_matches_per_step_loop(both_paths):
    f, s = both_paths[True], both_paths[False]
    assert len(f.buffer) == len(s.buffer)
    for a, b in zip(f.buffer, s.buffer):     # the same sampled placements
        np.testing.assert_array_equal(a.assignment, b.assignment)
    for hf, hs in zip(f.history, s.history):
        assert np.isclose(hf["cost_loss"], hs["cost_loss"], rtol=1e-4)
        assert np.isclose(hf["mean_est_reward"], hs["mean_est_reward"],
                          rtol=1e-4)
        assert np.isclose(hf["eval_cost_ms"], hs["eval_cost_ms"],
                          rtol=1e-4)
    assert f.oracle.num_evaluations == s.oracle.num_evaluations


def test_dispatch_counts_match_the_reference(both_paths):
    assert both_paths[True].history[-1]["dispatches"] == 4
    assert both_paths[False].history[-1]["dispatches"] >= 30


def test_fused_collect_decodes_legal_placements_on_mixed_devices():
    pool = make_dlrm_pool(seed=0)
    a, _ = make_benchmark_suite(pool, 10, 2, n_tasks=3)
    b, _ = make_benchmark_suite(pool, 14, 4, n_tasks=3, seed=1)
    ds = _port(a + b, n_collect=12)
    ds.collect()
    assert len(ds.buffer) == 12
    for s in ds.buffer:
        assert s.assignment.max() < s.n_devices
        assert np.isfinite(s.overall)
    assert ds._ring.size == 12
    ds.update_cost(3)
    ds.update_policy(2)
    for t in a + b:
        assert ds.place(t.raw_features, t.n_devices).max() < t.n_devices


def test_ring_grows_geometrically_past_budget(suite):
    train, _ = suite
    ds = _port(train, n_iterations=1, n_collect=4, n_cost=4)
    ds.train()
    assert ds._ring.capacity == 4
    caps = []
    for _ in range(5):
        ds.collect()
        ds.update_cost()
        caps.append(ds._ring.capacity)
    assert len(ds.buffer) == 24
    assert ds._ring.size == len(ds.buffer)
    assert set(caps) == {8, 16, 32}
    assert np.isfinite(ds.update_cost())


def test_same_length_buffer_reassignment_resyncs(suite):
    train, _ = suite
    ds = _port(train)
    ds.collect()
    ds.update_cost(2)
    old = ds._ring.data["overall"].numpy().copy()
    ds.buffer = [CostSample(feats_norm=s.feats_norm, assignment=s.assignment,
                            q=s.q + 1.0, overall=s.overall + 1.0,
                            n_devices=s.n_devices) for s in ds.buffer]
    ds.update_cost(2)
    new = ds._ring.data["overall"].numpy()
    live = new != 0
    assert np.allclose(new[live], old[live] + 1.0)


def test_update_cost_after_direct_buffer_assignment(suite):
    train, _ = suite
    donor = _port(train)
    donor.collect()
    losses = []
    for fused in (True, False):
        ds = _port(train, n_collect=0, n_iterations=1, fused=fused, seed=1)
        ds.buffer = list(donor.buffer)
        losses.append(ds.update_cost(10))
    assert np.isfinite(losses[0]) and losses[0] > 0
    assert np.isclose(losses[0], losses[1], rtol=1e-4)


def test_cost_mse_matches_the_reference_on_converted_weights(suite):
    """The same samples and the same weights give the reference's MSE."""
    from repro_torch.core import networks as N
    train, _ = suite
    ds = _port(train)
    ds.collect()
    ref = JDreamShard(train, CostSimulator(seed=0), JConfig(**_cfg()))
    ref.cost_params = N.params_to_jax(ds.cost_net)
    before = list(ds.buffer)
    mse = ds.cost_mse(ds.buffer[:4])
    assert ds.buffer == before
    assert np.isclose(mse, ref.cost_mse(ds.buffer[:4]), rtol=1e-5)


def test_restore_rebuilds_optimizers_and_clears_stale_targets(suite,
                                                               tmp_path):
    train, _ = suite
    ds = _port(train)
    ds.train()
    other = _port(train, target_transform="scale", n_cost=7)
    other.save(str(tmp_path / "ckpt"))
    ds.restore(str(tmp_path / "ckpt"))
    assert ds.cfg.n_cost == 7 and ds.cfg.target_transform == "scale"
    assert ds.buffer == []                       # old units dropped
    assert ds.cost_opt_state.step == 0 and ds.rl_opt_state.step == 0
    ds.train()
    assert len(ds.buffer) == ds.cfg.n_iterations * ds.cfg.n_collect


def test_train_records_the_reference_spans(suite):
    from repro_torch import telemetry as tele
    train, _ = suite
    tele.reset()
    tele.enable()
    try:
        _port(train, n_iterations=1).train()
        names = [ev[0] for ev in tele.get_tracer().snapshot_events()]
    finally:
        tele.reset()
        tele.disable()
    for name in ("train.iteration", "train.collect", "train.cost_update",
                 "train.rl_update"):
        assert names.count(name) == 1


def test_port_trained_agent_lands_in_the_jax_seed_spread(seed_runs):
    ref, port = seed_runs["ref"], seed_runs["port"]
    assert min(ref) <= float(np.median(port)) <= max(ref), (ref, port)
    assert float(np.median(port)) < seed_runs["untrained"], seed_runs
