"""The port's placement serving (``repro_torch.serve``) against
``repro.serve``: digest helpers, the placement cache, drift primitives,
micro-batch admission and the drift re-placement loop.

Each test of ``tests/test_serve.py`` has a counterpart here (named in its
docstring), run on the port and, where the outcome is a number or a
placement, held to the reference's on the same numpy inputs.  The agent is
a tiny JAX DreamShard with greedy decode (``inference_candidates=1``),
saved and restored into the port, so the two packages decode the same
placements; everything around decode is host numpy and is held bit for
bit.  Admission and latency run on a ``FakeClock`` in both packages.
"""

import hashlib

import numpy as np
import pytest

from repro import telemetry as jtele
from repro.api import PlacementSession as JPlacementSession
from repro.api import SimOracle as JSimOracle
from repro.api import placement_key as j_placement_key
from repro.api import task_key as j_task_key
from repro.core.trainer import DreamShard as JDreamShard
from repro.core.trainer import DreamShardConfig as JConfig
from repro.data.tasks import Task as JTask
from repro.data.tasks import sample_tasks as j_sample_tasks
from repro.data.tasks import split_pool as j_split_pool
from repro.data.traffic import TrafficConfig as JTrafficConfig
from repro.data.traffic import make_trace as j_make_trace
from repro.serve import MigrationCostOracle as JMigrationCostOracle
from repro.serve import PlacementService as JPlacementService
from repro.serve import ServeConfig as JServeConfig
from repro.serve import dist_divergence as j_dist_divergence
from repro.sim.costsim import CostSimulator as JSim
from repro_torch import telemetry as tele
from repro_torch.api import (PlacementService, PlacementSession,
                             ServeConfig, SimOracle, legal_sharded,
                             placement_key, placement_keys, task_key)
from repro_torch.api.digest import DIGEST_SIZE
from repro_torch.core import features as F
from repro_torch.core.trainer import DreamShard
from repro_torch.data.tasks import Task, sample_tasks, split_pool
from repro_torch.data.traffic import TrafficConfig, make_trace
from repro_torch.serve import (CacheEntry, DriftTracker, MigrationCostOracle,
                               PlacementCache, dist_divergence)
from repro_torch.sim.costsim import (CostSimulator, assignments_legal,
                                     placement_bytes)


@pytest.fixture(scope="module")
def agents(dlrm_pool, tmp_path_factory):
    """``test_serve.py``'s agent at a tiny budget with greedy decode: a JAX
    DreamShard trained on 12-table tasks, saved and restored into the
    port.  Returns ``(port agent, JAX agent)``."""
    jids, _ = j_split_pool(dlrm_pool, seed=0)
    jagent = JDreamShard(
        j_sample_tasks(dlrm_pool, jids, 12, 4, 2, seed=1), JSim(seed=0),
        JConfig(n_iterations=1, n_collect=4, n_cost=20, n_batch=16, n_rl=2,
                n_episode=4, inference_candidates=1))
    jagent.train()
    path = str(tmp_path_factory.mktemp("serve_agent"))
    jagent.save(path)
    ids, _ = split_pool(dlrm_pool, seed=0)
    agent = DreamShard(sample_tasks(dlrm_pool, ids, 12, 4, 2, seed=1),
                       CostSimulator(seed=0), device="cpu")
    agent.restore(path)
    assert agent.cfg.inference_candidates == 1
    return agent, jagent


@pytest.fixture()
def agent(agents):
    return agents[0]


@pytest.fixture()
def both_telemetry():
    for t in (tele, jtele):
        t.reset()
        t.enable()
    yield
    for t in (tele, jtele):
        t.reset()
        t.disable()


class FakeClock:
    """Deterministic seconds-valued clock for admission tests."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance_ms(self, ms: float) -> None:
        self.t += ms / 1e3


def _request(pool, ids, n_devices=4):
    return np.array(pool[ids], dtype=np.float64), n_devices


def _serve_trace(svc, trace, clock=None):
    """Submit every request (a clock, when given, advances 1 ms before
    each, as b12's virtual clock does), then drain."""
    done = []
    for i, r in enumerate(trace):
        if clock is not None:
            clock.advance_ms(1.0)
        done += svc.submit(r.raw_features, r.n_devices, tag=i)
    done += svc.flush()
    return done


def _serve_counters(t) -> dict:
    return {k: v for k, v in t.snapshot()["counters"].items()
            if k.startswith("serve.")}


def _without_latency(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k != "latency"}


def assert_same_serving(done, jdone):
    """Per request, in completion order: the same tag, source, replaced,
    degraded, error code and assignment."""
    assert len(done) == len(jdone)
    for r, j in zip(done, jdone):
        assert (r.tag, r.source, r.replaced, r.degraded) == \
            (j.tag, j.source, j.replaced, j.degraded)
        assert (r.error.code if r.error else None) == \
            (j.error.code if j.error else None)
        assert (r.placement is None) == (j.placement is None)
        if r.placement is not None:
            assert r.placement.n_devices == j.placement.n_devices
            np.testing.assert_array_equal(r.placement.assignment,
                                          j.placement.assignment)


def test_api_exports_the_serving_names():
    """``repro_torch.api`` re-exports, lazily, every serving name that
    ``repro.api`` does, and each resolves to ``repro_torch.serve``'s."""
    import repro.api as japi
    import repro.serve as jserve
    import repro_torch.api as api
    import repro_torch.serve as serve
    names = {k for k, v in japi._LAZY.items() if v == "repro.serve"}
    assert len(names) == 12
    assert names <= set(api.__all__)
    for name in names:
        assert api._LAZY[name] == "repro_torch.serve"
        assert getattr(api, name) is getattr(serve, name)
    assert set(serve.__all__) == set(jserve.__all__)


# ---- digest helpers (shared CachedOracle / serving key machinery) ------------

def test_placement_key_matches_legacy_inline(dlrm_pool):
    """``test_serve.py::test_placement_key_matches_legacy_inline``: the
    key is blake2b-128 over ``placement_bytes``, the reference's key."""
    raw, a = dlrm_pool[:6], np.array([0, 1, 2, 3, 0, 1])
    legacy = hashlib.blake2b(placement_bytes(raw, a, 4),
                             digest_size=DIGEST_SIZE).digest()
    assert placement_key(raw, a, 4) == legacy == j_placement_key(raw, a, 4)
    assert len(legacy) == DIGEST_SIZE


def test_placement_keys_bitwise_equals_per_row(dlrm_pool, rng):
    """``test_serve.py::test_placement_keys_bitwise_equals_per_row``."""
    raw = dlrm_pool[:8]
    A = rng.integers(0, 4, size=(7, 8))
    batch = placement_keys(raw, A, 4)
    assert batch == [placement_key(raw, a, 4) for a in A]
    assert len(set(batch)) == len({a.tobytes() for a in A})


def test_task_key_distribution_policy(dlrm_pool):
    """``test_serve.py::test_task_key_distribution_policy``, every key
    equal to the reference's."""
    a = np.array(dlrm_pool[:5], dtype=np.float64)
    drifted = np.array(a)
    drifted[:, F.DIST_START:] = np.roll(a[:, F.DIST_START:], 1, axis=-1)
    assert task_key(a, 4) != task_key(drifted, 4)
    assert (task_key(a, 4, include_distribution=False)
            == task_key(drifted, 4, include_distribution=False))
    structural = np.array(a)
    structural[0, F.DIM] += 1
    for kw in (dict(), dict(include_distribution=False)):
        assert task_key(a, 4, **kw) != task_key(a, 2, **kw)
        assert task_key(a, 4, **kw) != task_key(structural, 4, **kw)
        for raw in (a, drifted, structural):
            for d in (2, 4):
                assert task_key(raw, d, **kw) == j_task_key(raw, d, **kw)


# ---- placement cache ---------------------------------------------------------

def test_placement_cache_lru(both_telemetry):
    """``test_serve.py::test_placement_cache_lru``, with its
    ``serve.cache.*`` counters."""
    cache = PlacementCache(max_entries=2)
    k1, k2, k3 = b"k1", b"k2", b"k3"
    for k in (k1, k2):
        assert cache.get(k) is None
        cache.put(k, CacheEntry(object(), np.zeros((4, 17))))
    assert cache.get(k1).requests == 1          # k1 becomes most-recent
    cache.put(k3, CacheEntry(object(), np.zeros((4, 17))))
    assert cache.get(k1) is not None            # survived: k2 was LRU
    assert cache.get(k2) is None                # evicted
    assert (cache.hits, cache.misses, cache.evictions) == (2, 3, 1)
    assert cache.hit_rate == pytest.approx(2 / 5)
    assert len(cache) == 2
    assert _serve_counters(tele) == {"serve.cache.hits": 2,
                                     "serve.cache.misses": 3,
                                     "serve.cache.evictions": 1}


# ---- drift primitives --------------------------------------------------------

def test_dist_divergence_is_max_per_table_tv(rng):
    """``test_serve.py::test_dist_divergence_is_max_per_table_tv``, and
    bitwise the reference's on random histograms."""
    p = np.zeros((3, 17))
    p[:, 0] = 1.0
    q = np.array(p)
    assert dist_divergence(p, q) == 0.0
    q[1, 0], q[1, 1] = 0.8, 0.2                 # table 1 moves 0.2 mass
    assert dist_divergence(p, q) == pytest.approx(0.2)
    q[2, 0], q[2, 5] = 0.0, 1.0                 # table 2 moves everything
    assert dist_divergence(p, q) == pytest.approx(1.0)   # max, not mean
    assert dist_divergence(q, p) == dist_divergence(p, q)
    for _ in range(5):
        x, y = rng.dirichlet(np.ones(17), 6), rng.dirichlet(np.ones(17), 6)
        assert dist_divergence(x, y) == j_dist_divergence(x, y)


def test_drift_tracker_ewma():
    """``test_serve.py::test_drift_tracker_ewma``."""
    d0, d1 = np.zeros((2, 17)), np.ones((2, 17)) / 17.0
    pinned = DriftTracker(alpha=0.0)
    pinned.observe(b"k", d0)
    assert np.array_equal(pinned.observe(b"k", d1), d0)   # never moves
    latest = DriftTracker(alpha=1.0)
    latest.observe(b"k", d0)
    assert np.array_equal(latest.observe(b"k", d1), d1)   # tracks last
    ewma = DriftTracker(alpha=0.5)
    assert np.array_equal(ewma.observe(b"k", d0), d0)     # seeded exactly
    np.testing.assert_allclose(ewma.observe(b"k", d1), 0.5 * d1)
    assert ewma.estimate(b"missing") is None


def test_migration_oracle_penalty(dlrm_pool):
    """``test_serve.py::test_migration_oracle_penalty``, every price
    bitwise the reference wrapper's over its ``CostSimulator``."""
    raw = dlrm_pool[:6]
    incumbent = np.array([0, 1, 2, 3, 0, 1])
    inner = CostSimulator(seed=0)
    oracle = MigrationCostOracle.wrap(inner, incumbent, ms_per_gb=100.0)
    joracle = JMigrationCostOracle.wrap(JSim(seed=0), incumbent,
                                        ms_per_gb=100.0)
    base = inner.evaluate(raw, incumbent, 4)
    assert oracle.evaluate(raw, incumbent, 4).overall == base.overall
    moved = np.array(incumbent)
    moved[2] = 0
    expect = (inner.evaluate(raw, moved, 4).overall
              + 100.0 * float(raw[2, F.TABLE_SIZE_GB]))
    assert oracle.evaluate(raw, moved, 4).overall == pytest.approx(expect)
    gb = oracle.migration_gb(raw, np.stack([incumbent, moved]))
    np.testing.assert_allclose(gb, [0.0, raw[2, F.TABLE_SIZE_GB]])
    assert oracle.legal(raw, incumbent, 4)
    assert oracle.mem_capacity_gb == inner.spec.mem_capacity_gb
    A = np.stack([incumbent, moved, np.roll(incumbent, 1)])
    assert [r.overall for r in oracle.evaluate_many(raw, A, 4)] == \
        [r.overall for r in joracle.evaluate_many(raw, A, 4)]
    np.testing.assert_array_equal(oracle.legal_batch(raw, A, 4),
                                  joracle.legal_batch(raw, A, 4))


# ---- micro-batch admission ---------------------------------------------------

def test_admission_flushes_on_batch_size(dlrm_pool, agent):
    """``test_serve.py::test_admission_flushes_on_batch_size``."""
    svc = PlacementService(agent, clock=FakeClock(), config=ServeConfig(
        max_wait_ms=1e6, max_batch=3))
    done = []
    for i in range(2):
        raw, d = _request(dlrm_pool, range(10 * i, 10 * i + 12))
        done += svc.submit(raw, d, tag=f"r{i}")
    assert done == [] and svc.pending == 2      # below batch, below deadline
    raw, d = _request(dlrm_pool, range(30, 42))
    done = svc.submit(raw, d, tag="r2")
    assert [r.tag for r in done] == ["r0", "r1", "r2"]   # batch-size flush
    assert all(r.source == "decode" for r in done)
    assert svc.pending == 0 and svc.decode_batches == 1
    assert svc.stats()["decoded_tasks"] == 3


def test_admission_flushes_on_wait_deadline(dlrm_pool, agent):
    """``test_serve.py::test_admission_flushes_on_wait_deadline``."""
    clock = FakeClock()
    svc = PlacementService(agent, clock=clock, config=ServeConfig(
        max_wait_ms=5.0, max_batch=64))
    raw, d = _request(dlrm_pool, range(12))
    assert svc.submit(raw, d, tag="r0") == []
    clock.advance_ms(4.0)
    assert svc.poll() == []                     # deadline not reached
    clock.advance_ms(2.0)
    done = svc.poll()                           # 6ms > 5ms: due
    assert [r.tag for r in done] == ["r0"]
    assert done[0].queue_wait_ms == pytest.approx(6.0)
    assert done[0].latency_ms >= done[0].queue_wait_ms


def test_admission_coalesces_duplicate_keys(dlrm_pool, agent):
    """``test_serve.py::test_admission_coalesces_duplicate_keys``."""
    svc = PlacementService(agent, clock=FakeClock(), config=ServeConfig(
        max_wait_ms=1e6, max_batch=64))
    raw, d = _request(dlrm_pool, range(12))
    svc.submit(raw, d, tag="a")
    drifted = np.array(raw)
    drifted[:, F.DIST_START:] = np.roll(raw[:, F.DIST_START:], 1, axis=-1)
    svc.submit(drifted, d, tag="b")             # same structural key
    assert svc.pending == 1 and svc.coalesced == 1
    done = svc.flush()
    assert sorted(r.tag for r in done) == ["a", "b"]
    assert svc.decoded_tasks == 1               # ONE decode served both
    assert done[0].placement is done[1].placement


def test_hits_skip_admission_entirely(dlrm_pool, agent):
    """``test_serve.py::test_hits_skip_admission_entirely``."""
    svc = PlacementService(agent, clock=FakeClock(), config=ServeConfig(
        max_wait_ms=1e6, max_batch=1, drift_threshold=None))
    raw, d = _request(dlrm_pool, range(12))
    first = svc.submit(raw, d, tag="cold")
    assert first[0].source == "decode"          # max_batch=1: instant flush
    again = svc.submit(raw, d, tag="warm")
    assert again[0].source == "cache" and again[0].queue_wait_ms == 0.0
    assert again[0].placement is first[0].placement
    assert svc.cache.hits == 1 and svc.pending == 0


# ---- end-to-end serving ------------------------------------------------------

def test_zero_drift_replay_bitwise_identical(dlrm_pool, agents):
    """``test_serve.py::test_zero_drift_replay_bitwise_identical``: the
    port's service returns ``PlacementSession.place_many``'s assignments,
    and the reference service's, request for request."""
    agent, jagent = agents
    kw = dict(n_jobs=4, n_tables=12, n_devices=4, n_requests=24,
              drift=0.0, seed=3)
    trace = make_trace(dlrm_pool, TrafficConfig(**kw))
    cfg = dict(max_wait_ms=0.0, max_batch=8, drift_threshold=0.05)
    svc = PlacementService(agent, config=ServeConfig(**cfg))
    done = _serve_trace(svc, trace)
    assert len(done) == len(trace)
    assert svc.replace_events == 0 and svc.bytes_moved_gb == 0.0

    first = {}
    for i, r in enumerate(trace):
        first.setdefault(r.job, i)
    jobs = sorted(first)
    reference = PlacementSession(agent).place_many(
        [Task.of(trace[first[j]].raw_features, 4) for j in jobs])
    by_tag = {r.tag: r.placement for r in done}
    for j, ref in zip(jobs, reference):
        np.testing.assert_array_equal(by_tag[first[j]].assignment,
                                      ref.assignment)
    for i, r in enumerate(trace):
        np.testing.assert_array_equal(by_tag[i].assignment,
                                      by_tag[first[r.job]].assignment)

    jtrace = j_make_trace(dlrm_pool, JTrafficConfig(**kw))
    jdone = _serve_trace(JPlacementService(jagent, config=JServeConfig(
        **cfg)), jtrace)
    jby_tag = {r.tag: r.placement for r in jdone}
    for i in range(len(trace)):
        np.testing.assert_array_equal(by_tag[i].assignment,
                                      jby_tag[i].assignment)
    jref = JPlacementSession(jagent).place_many(
        [JTask.of(jtrace[first[j]].raw_features, 4) for j in jobs])
    for p, j in zip(reference, jref):
        np.testing.assert_array_equal(p.assignment, j.assignment)


def test_drift_triggers_incremental_replacement(dlrm_pool, agents):
    """``test_serve.py::test_drift_triggers_incremental_replacement``, both
    services replaying the trace on one clock: the same requests re-place,
    onto the same placements."""
    agent, jagent = agents
    kw = dict(n_jobs=3, n_tables=12, n_devices=4, n_requests=48, drift=1.0,
              zipf=0.0, seed=5)
    trace = make_trace(dlrm_pool, TrafficConfig(**kw))
    cfg = dict(max_wait_ms=0.0, max_batch=8, drift_threshold=0.05,
               ewma_alpha=0.5, replace_max_evals=24)
    svc = PlacementService(agent, oracle=SimOracle(seed=0),
                           clock=FakeClock(), config=ServeConfig(**cfg))
    done = _serve_trace(svc, trace)
    assert svc.replace_events > 0               # the loop fired
    assert any(r.replaced for r in done if r.source == "cache")
    assert svc.cache.hits > 0 and len(svc.cache) == kw["n_jobs"]
    jsvc = JPlacementService(jagent, oracle=JSimOracle(seed=0),
                             clock=FakeClock(), config=JServeConfig(**cfg))
    jdone = _serve_trace(jsvc, j_make_trace(dlrm_pool, JTrafficConfig(**kw)))
    assert_same_serving(done, jdone)
    assert svc.bytes_moved_gb == jsvc.bytes_moved_gb
    off = PlacementService(agent, config=ServeConfig(
        max_wait_ms=0.0, max_batch=8, drift_threshold=None))
    _serve_trace(off, trace)
    assert off.replace_events == 0 and off.bytes_moved_gb == 0.0


def test_serve_telemetry_counters(dlrm_pool, agents, both_telemetry):
    """``test_serve.py::test_serve_telemetry_counters``: the port's
    ``serve.*`` counters are the reference's, name for name."""
    agent, jagent = agents
    kw = dict(n_jobs=2, n_tables=12, n_devices=4, n_requests=8, drift=0.0,
              seed=7)
    svc = PlacementService(agent, config=ServeConfig(max_wait_ms=0.0,
                                                     max_batch=4))
    _serve_trace(svc, make_trace(dlrm_pool, TrafficConfig(**kw)))
    counters = tele.snapshot()["counters"]
    assert counters["serve.requests"] == 8
    assert counters["serve.cache.hits"] == svc.cache.hits > 0
    assert counters["serve.cache.misses"] == svc.cache.misses
    assert counters["serve.flushes"] == svc.decode_batches
    assert counters["serve.decoded"] == svc.decoded_tasks == 2
    _serve_trace(JPlacementService(jagent, config=JServeConfig(
        max_wait_ms=0.0, max_batch=4)),
        j_make_trace(dlrm_pool, JTrafficConfig(**kw)))
    assert _serve_counters(tele) == _serve_counters(jtele)
    spans = tele.snapshot()["spans"]
    assert spans["serve.flush"]["count"] == svc.decode_batches
    assert spans["session.decode"]["count"] >= svc.decode_batches


# ---- opt-in sharded fallback -------------------------------------------------

def test_shard_oversized_off_by_default_serves_decode(dlrm_pool, agent):
    """``test_serve.py::test_shard_oversized_off_by_default_serves_decode``."""
    raw, d = _request(dlrm_pool, range(12))
    raw[0, F.TABLE_SIZE_GB] = 30.0              # > one device's HBM
    svc = PlacementService(agent, clock=FakeClock(), config=ServeConfig(
        max_wait_ms=0.0, max_batch=1))
    out = svc.submit(raw, d, tag="big")
    assert len(out) == 1 and out[0].source == "decode"
    p = out[0].placement
    assert not p.is_sharded
    assert not bool(assignments_legal(raw[:, F.TABLE_SIZE_GB],
                                      p.assignment[None], d,
                                      svc.oracle.mem_capacity_gb)[0])
    assert svc.shard_fallbacks == 0


def test_shard_oversized_serves_sharded_placement(dlrm_pool, agents):
    """``test_serve.py::test_shard_oversized_serves_sharded_placement``,
    with the reference service's sharded answer."""
    agent, jagent = agents
    raw, d = _request(dlrm_pool, range(12))
    raw[0, F.TABLE_SIZE_GB] = 30.0
    cfg = dict(max_wait_ms=0.0, max_batch=1, shard_oversized=True)
    svc = PlacementService(agent, clock=FakeClock(),
                           config=ServeConfig(**cfg))
    out = svc.submit(raw, d, tag="big")
    assert len(out) == 1 and out[0].error is None
    assert out[0].source == "fallback" and out[0].degraded == "shard"
    p = out[0].placement
    assert p.is_sharded and p.sharding.shard_counts[0] >= 3
    assert bool(legal_sharded(svc.oracle, raw, p.sharding,
                              p.shard_assignment[None], d)[0])
    assert svc.shard_fallbacks == 1
    again = svc.submit(raw, d, tag="big2")
    assert again[0].source == "cache" and again[0].placement is p
    jp = JPlacementService(jagent, clock=FakeClock(), config=JServeConfig(
        **cfg)).submit(raw, d, tag="big")[0].placement
    np.testing.assert_array_equal(p.sharding.shard_counts,
                                  jp.sharding.shard_counts)
    np.testing.assert_array_equal(p.shard_assignment, jp.shard_assignment)


# ---- b11's quick regime through both services --------------------------------

B11_QUICK = dict(n_jobs=6, n_tables=16, n_devices=4, n_requests=400,
                 drift=0.8, zipf=1.0, tail_jobs=4, seed=0)


@pytest.mark.parametrize("policy", ["drift", "never", "always"])
def test_b11_quick_replay_matches_the_reference(dlrm_pool, agents,
                                                both_telemetry, policy):
    """``benchmarks/b11_serve.py``'s quick regime (6 jobs x 16 tables, 4
    devices, 400 requests + 4 tail jobs, drift 0.8) under each of its
    three policies through both services over ``SimOracle(seed=0)`` on a
    1 ms-a-request clock: per request the same source, ``replaced``,
    ``degraded`` and assignment; ``stats()`` equal but for latencies
    (``bytes_moved_gb`` bitwise); the same ``serve.*`` counters."""
    agent, jagent = agents
    threshold = {"drift": 0.05, "never": None, "always": 0.0}[policy]
    cfg = dict(max_wait_ms=2.0, max_batch=8, ewma_alpha=0.3,
               drift_threshold=threshold,
               migration_ms_per_gb=0.0 if policy == "always" else 25.0,
               replace_max_evals=64, replace_budget_ms=None, seed=0)
    clock, jclock = FakeClock(), FakeClock()
    svc = PlacementService(agent, oracle=SimOracle(seed=0), clock=clock,
                           config=ServeConfig(**cfg))
    jsvc = JPlacementService(jagent, oracle=JSimOracle(seed=0), clock=jclock,
                             config=JServeConfig(**cfg))
    done = _serve_trace(svc, make_trace(dlrm_pool,
                                        TrafficConfig(**B11_QUICK)), clock)
    jdone = _serve_trace(jsvc, j_make_trace(
        dlrm_pool, JTrafficConfig(**B11_QUICK)), jclock)
    assert len(done) == 404
    assert_same_serving(done, jdone)
    stats = svc.stats()
    assert _without_latency(stats) == _without_latency(jsvc.stats())
    assert stats["latency"]["count"] == jsvc.stats()["latency"]["count"]
    assert stats["hit_rate"] >= 0.5 and stats["decode_errors"] == 0
    if policy == "never":
        assert stats["replace_events"] == 0
    else:
        assert stats["replace_events"] > 0
    assert _serve_counters(tele) == _serve_counters(jtele)
