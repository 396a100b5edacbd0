"""The port's resilient serving (``repro_torch.serve``'s fault layer,
latency ledger and warm restarts) against ``repro.serve``.

Each test of ``tests/test_resilience.py`` has a counterpart here (named in
its docstring), run on the port and, where the outcome is a number, a
schedule or a placement, held to the reference's on the same inputs.  On
top: ``FaultSchedule.generate`` event for event with its JSON read by the
other package, b12's quick regime replayed through both services at 8
devices, and warm restarts across the packages (a JAX ``save`` restored by
the port and the other way round).  The agent is a tiny JAX DreamShard
with greedy decode, saved and restored into the port; every service runs
on a clock that advances 1 ms a request.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from repro import checkpoint as jcheckpoint
from repro import telemetry as jtele
from repro.api import SimOracle as JSimOracle
from repro.core.trainer import DreamShard as JDreamShard
from repro.core.trainer import DreamShardConfig as JConfig
from repro.data.tasks import sample_tasks as j_sample_tasks
from repro.data.tasks import split_pool as j_split_pool
from repro.data.traffic import TrafficConfig as JTrafficConfig
from repro.data.traffic import make_trace as j_make_trace
from repro.serve import FaultEvent as JFaultEvent
from repro.serve import FaultInjector as JFaultInjector
from repro.serve import FaultSchedule as JFaultSchedule
from repro.serve import LatencyReservoir as JLatencyReservoir
from repro.serve import PlacementService as JPlacementService
from repro.serve import ServeConfig as JServeConfig
from repro.serve import repair_assignment as j_repair_assignment
from repro.sim.costsim import CostSimulator as JSim
from repro_torch import checkpoint
from repro_torch import telemetry as tele
from repro_torch.api import SimOracle
from repro_torch.core import features as F
from repro_torch.core.trainer import DreamShard
from repro_torch.data.tasks import sample_tasks, split_pool
from repro_torch.data.traffic import TrafficConfig, make_trace
from repro_torch.serve import (CacheEntry, CapacityError, DecodeTimeout,
                               DegradedMeshOracle, FaultEvent, FaultInjector,
                               FaultSchedule, FaultyOracle, IllegalTaskError,
                               LatencyReservoir, PlacementCache,
                               PlacementService, ServeConfig, ServeError,
                               TransientOracleError, repair_assignment)
from repro_torch.sim.costsim import CostSimulator


@pytest.fixture(scope="module")
def agents(dlrm_pool, tmp_path_factory):
    """``test_resilience.py``'s agent at a tiny budget with greedy decode:
    a JAX DreamShard, saved and restored into the port.  Returns ``(port
    agent, JAX agent)``."""
    jids, _ = j_split_pool(dlrm_pool, seed=0)
    jagent = JDreamShard(
        j_sample_tasks(dlrm_pool, jids, 12, 4, 2, seed=1), JSim(seed=0),
        JConfig(n_iterations=1, n_collect=4, n_cost=20, n_batch=16, n_rl=2,
                n_episode=4, inference_candidates=1))
    jagent.train()
    path = str(tmp_path_factory.mktemp("resilience_agent"))
    jagent.save(path)
    ids, _ = split_pool(dlrm_pool, seed=0)
    agent = DreamShard(sample_tasks(dlrm_pool, ids, 12, 4, 2, seed=1),
                       CostSimulator(seed=0), device="cpu")
    agent.restore(path)
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
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance_ms(self, ms: float) -> None:
        self.t += ms / 1e3


def _request(pool, ids, n_devices=4):
    return np.array(pool[ids], dtype=np.float64), n_devices


def _drain(svc, trace, clock, tag0=0):
    done = []
    for i, r in enumerate(trace):
        clock.advance_ms(1.0)
        done += svc.submit(r.raw_features, r.n_devices, tag=tag0 + i)
    done += svc.flush()
    return done


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
            np.testing.assert_array_equal(r.placement.assignment,
                                          j.placement.assignment)


def _without_latency(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k != "latency"}


# ---- fault schedule ----------------------------------------------------------

def test_fault_event_validation():
    """``test_resilience.py::test_fault_event_validation``."""
    with pytest.raises(ValueError):
        FaultEvent(at=0, kind="meteor_strike")
    with pytest.raises(ValueError):
        FaultEvent(at=0, kind="device_loss")            # needs device=
    with pytest.raises(ValueError):
        FaultEvent(at=0, kind="capacity_shrink", factor=1.5)
    with pytest.raises(ValueError):
        FaultEvent(at=0, kind="oracle_error", count=0)
    with pytest.raises(ValueError):
        FaultEvent(at=0, kind="decode_spike", spike_ms=-1.0)


def test_schedule_sorts_roundtrips_and_generates_deterministically():
    """``test_resilience.py::
    test_schedule_sorts_roundtrips_and_generates_deterministically``."""
    sched = FaultSchedule((
        FaultEvent(at=9, kind="decode_spike", spike_ms=10.0),
        FaultEvent(at=2, kind="device_loss", device=1),
        FaultEvent(at=5, kind="device_recovery", device=1)))
    assert [e.at for e in sched] == [2, 5, 9]           # sorted by index
    assert FaultSchedule.from_json(sched.to_json()) == sched
    a = FaultSchedule.generate(seed=7, n_requests=100, n_devices=4)
    assert a == FaultSchedule.generate(seed=7, n_requests=100, n_devices=4)
    assert a != FaultSchedule.generate(seed=8, n_requests=100, n_devices=4)
    losses = [e for e in a if e.kind == "device_loss"]
    assert losses and all(25 <= e.at < 50 for e in losses)


@pytest.mark.parametrize("seed,n_requests,n_devices,kw", [
    (7, 100, 4, {}), (8, 100, 4, {}), (0, 400, 8, {}),
    (3, 1500, 8, dict(n_losses=3, recover=False, n_oracle_errors=5,
                      n_spikes=4, spike_ms=12.5))])
def test_generate_is_the_reference_event_for_event(seed, n_requests,
                                                   n_devices, kw):
    """``generate`` seeds ``default_rng([seed, n_requests, n_devices])``
    and draws in the reference's order: the same events, and each
    package's JSON read by the other into the same schedule."""
    mine = FaultSchedule.generate(seed, n_requests, n_devices, **kw)
    ref = JFaultSchedule.generate(seed, n_requests, n_devices, **kw)
    assert [e.to_dict() for e in mine] == [e.to_dict() for e in ref]
    assert mine.to_json() == ref.to_json()
    assert FaultSchedule.from_json(ref.to_json()) == mine
    assert JFaultSchedule.from_json(mine.to_json()) == ref


def test_injector_state_machine_and_checkpoint_roundtrip():
    """``test_resilience.py::
    test_injector_state_machine_and_checkpoint_roundtrip``, the state
    loaded by the reference's injector as well."""
    events = [dict(at=0, kind="device_loss", device=1),
              dict(at=1, kind="oracle_error", count=2),
              dict(at=1, kind="decode_spike", spike_ms=30.0),
              dict(at=2, kind="device_recovery", device=1),
              dict(at=3, kind="capacity_shrink", factor=0.5)]
    inj = FaultInjector(FaultSchedule(tuple(FaultEvent(**e)
                                            for e in events)))
    assert [e.kind for e in inj.advance()] == ["device_loss"]
    assert inj.degraded and inj.down == {1} and inj.epoch == 1
    assert list(inj.allowed_mask(4)) == [True, False, True, True]
    fired = inj.advance()
    assert {e.kind for e in fired} == {"oracle_error", "decode_spike"}
    assert inj.epoch == 1                       # no topology change
    assert inj.take_error() and inj.take_error() and not inj.take_error()
    assert inj.take_spike_ms() == 30.0 and inj.take_spike_ms() == 0.0
    inj.advance()                               # recovery
    assert not inj.degraded and inj.epoch == 2
    inj.advance()                               # shrink
    assert inj.degraded and inj.capacity_gb(8.0) == 4.0 and inj.epoch == 3
    state = json.loads(json.dumps(inj.state_dict()))
    clone = FaultInjector(inj.schedule)
    clone.load_state_dict(state)
    assert clone.state_dict() == inj.state_dict()
    jclone = JFaultInjector(JFaultSchedule(tuple(JFaultEvent(**e)
                                                 for e in events)))
    jclone.load_state_dict(state)
    assert jclone.state_dict() == inj.state_dict()
    assert inj.advance() == [] and inj.tick == 5


def test_faulty_oracle_raises_but_legality_never_faults(dlrm_pool):
    """``test_resilience.py::
    test_faulty_oracle_raises_but_legality_never_faults``."""
    raw = dlrm_pool[:4]
    a = np.array([0, 1, 2, 3])
    inj = FaultInjector(FaultSchedule((
        FaultEvent(at=0, kind="oracle_error", count=2),)))
    inj.advance()
    oracle = FaultyOracle(CostSimulator(seed=0), inj)
    legal = oracle.legal(raw, a, 4)             # armed, but never faults
    assert oracle.legal_batch(raw, a[None, :], 4)[0] == legal
    with pytest.raises(TransientOracleError):
        oracle.evaluate(raw, a, 4)
    with pytest.raises(TransientOracleError):
        oracle.evaluate_many(raw, a[None, :], 4)
    assert oracle.evaluate(raw, a, 4).overall == \
        JSim(seed=0).evaluate(raw, a, 4).overall      # errors drained


def test_degraded_mesh_oracle_narrows_legality(dlrm_pool):
    """``test_resilience.py::test_degraded_mesh_oracle_narrows_legality``."""
    raw = np.array(dlrm_pool[:4], dtype=np.float64)
    raw[:, F.TABLE_SIZE_GB] = 1.0
    inner = CostSimulator(seed=0)
    allowed = np.array([True, False, True, True])
    oracle = DegradedMeshOracle(inner, allowed, capacity_gb=2.0)
    A = np.array([[0, 2, 3, 0],                 # survivors only: legal
                  [0, 1, 2, 3],                 # touches lost device 1
                  [0, 0, 0, 2],                 # 3 GB on device 0 > 2 GB
                  [0, 2, 3, 9]])                # out of range: illegal
    np.testing.assert_array_equal(
        oracle.legal_batch(raw, A, 4), [True, False, False, False])
    assert oracle.legal(raw, A[0], 4) and not oracle.legal(raw, A[1], 4)
    assert oracle.mem_capacity_gb == 2.0
    assert oracle.evaluate(raw, A[0], 4).overall == \
        inner.evaluate(raw, A[0], 4).overall


def test_repair_assignment_moves_only_what_it_must(rng):
    """``test_resilience.py::test_repair_assignment_moves_only_what_it_must``,
    and the reference's repair on random meshes."""
    sizes = np.array([3.0, 1.0, 2.0, 1.0])
    allowed = np.array([True, False, True])
    a = repair_assignment(sizes, np.array([0, 1, 2, 2]), allowed, 8.0)
    np.testing.assert_array_equal(a, [0, 0, 2, 2])
    a = repair_assignment(sizes, np.array([0, 0, 0, 0]), allowed, 4.0)
    assert a is not None
    assert a[0] != 0                      # 3 GB table shed first
    loads = np.bincount(a, weights=sizes, minlength=3)
    assert (loads <= 4.0).all() and not (a == 1).any()
    a = repair_assignment(sizes, np.full(4, -1), allowed, 8.0)
    assert a is not None and not (a == 1).any()
    assert repair_assignment(sizes, np.array([0, 1, 2, 2]),
                             np.zeros(3, dtype=bool), 8.0) is None
    assert repair_assignment(sizes, np.array([0, 1, 2, 2]),
                             allowed, 0.0) is None
    assert repair_assignment(sizes, np.full(4, -1), allowed, 2.5) is None
    for _ in range(20):
        sizes = rng.uniform(0.1, 3.0, 12)
        start = rng.integers(-1, 8, 12)
        allowed = rng.random(8) < 0.7
        cap = float(rng.uniform(2.0, 8.0))
        mine = repair_assignment(sizes, start, allowed, cap)
        ref = j_repair_assignment(sizes, start, allowed, cap)
        assert (mine is None) == (ref is None)
        if mine is not None:
            np.testing.assert_array_equal(mine, ref)


# ---- cache invalidation ------------------------------------------------------

def _entry(assignment) -> CacheEntry:
    return CacheEntry(
        placement=SimpleNamespace(assignment=np.asarray(assignment)),
        snapshot=np.zeros((len(assignment), F.NUM_DIST_BINS)))


def test_cache_invalidate_predicate_and_devices():
    """``test_resilience.py::test_cache_invalidate_predicate_and_devices``."""
    cache = PlacementCache(max_entries=8)
    cache.put(b"a", _entry([0, 1, 2]))
    cache.put(b"b", _entry([0, 2, 2]))
    cache.put(b"c", _entry([1, 1, 1]))
    cache.put(b"d", _entry([3, 0, 3]))
    assert cache.get(b"a") is not None          # refresh a's LRU position
    hits, misses = cache.hits, cache.misses
    assert cache.invalidate_devices([1]) == 2   # a and c touch device 1
    assert cache.invalidations == 2
    assert cache.get(b"a") is None and cache.get(b"c") is None
    assert cache.invalidate_devices([]) == 0
    assert [k for k, _ in cache.items()] == [b"b", b"d"]
    assert cache.invalidate(lambda k, e: k == b"missing") == 0
    assert cache.invalidate(lambda k, e: True) == 2
    assert len(cache) == 0 and cache.invalidations == 4
    assert (cache.hits, cache.misses) == (hits, misses + 2)


# ---- typed errors ------------------------------------------------------------

def test_serve_error_hierarchy_and_describe():
    """``test_resilience.py::test_serve_error_hierarchy_and_describe``."""
    for cls, code in ((IllegalTaskError, "illegal_task"),
                      (CapacityError, "capacity"),
                      (DecodeTimeout, "decode_timeout"),
                      (TransientOracleError, "transient_oracle")):
        err = cls("boom")
        assert isinstance(err, ServeError)
        assert err.describe() == {"code": code, "message": "boom"}


def test_submit_never_raises_on_malformed_requests(dlrm_pool, agent):
    """``test_resilience.py::test_submit_never_raises_on_malformed_requests``."""
    svc = PlacementService(agent, clock=FakeClock(), config=ServeConfig(
        max_wait_ms=0.0, max_batch=1))
    bad = [
        (np.zeros((2, 5)), 4),                        # wrong feature width
        (np.zeros((0, F.NUM_FEATURES)), 4),           # no tables
        (np.full((2, F.NUM_FEATURES), np.nan), 4),    # non-finite
        (_request(dlrm_pool, range(4))[0], 0),        # bad device count
        (_request(dlrm_pool, range(4))[0], "two"),
    ]
    for raw, d in bad:
        out = svc.submit(raw, d, tag="bad")
        assert len(out) == 1 and out[0].source == "error"
        assert out[0].placement is None
        assert isinstance(out[0].error, IllegalTaskError)
    assert svc.rejected == len(bad) and svc.typed_errors == len(bad)
    raw, d = _request(dlrm_pool, range(12))
    ok = svc.submit(raw, d, tag="good")
    assert ok[0].placement is not None and ok[0].error is None
    assert svc.stats()["rejected"] == len(bad)


def test_unplaceable_mesh_is_a_typed_capacity_error(dlrm_pool, agent):
    """``test_resilience.py::test_unplaceable_mesh_is_a_typed_capacity_error``."""
    faults = FaultInjector(FaultSchedule(tuple(
        FaultEvent(at=0, kind="device_loss", device=d) for d in range(4))))
    svc = PlacementService(agent, faults=faults, clock=FakeClock(),
                           config=ServeConfig(max_wait_ms=0.0, max_batch=1))
    raw, d = _request(dlrm_pool, range(12))
    out = svc.submit(raw, d, tag="doomed")
    assert len(out) == 1 and out[0].source == "error"
    assert isinstance(out[0].error, CapacityError)
    assert svc.typed_errors == 1 and len(svc.cache) == 0


# ---- degraded-mode fallbacks -------------------------------------------------

def test_deadline_spike_degrades_to_expert(dlrm_pool, agent):
    """``test_resilience.py::test_deadline_spike_degrades_to_expert``."""
    faults = FaultInjector(FaultSchedule((
        FaultEvent(at=0, kind="decode_spike", spike_ms=50.0),)))
    svc = PlacementService(agent, faults=faults, clock=FakeClock(),
                           config=ServeConfig(max_wait_ms=0.0, max_batch=1,
                                              decode_deadline_ms=25.0))
    raw, d = _request(dlrm_pool, range(12))
    out = svc.submit(raw, d, tag="spiked")
    assert out[0].source == "fallback" and out[0].degraded == "expert"
    assert out[0].placement.strategy == "serve.fallback.expert"
    assert svc.deadline_skips == 1 and svc.fallbacks["expert"] == 1
    assert svc.oracle.legal(raw, out[0].placement.assignment, d)
    raw2, _ = _request(dlrm_pool, range(10, 22))
    assert svc.submit(raw2, d, tag="calm")[0].source == "decode"


def test_deadline_with_empty_chain_is_decode_timeout(dlrm_pool, agent):
    """``test_resilience.py::test_deadline_with_empty_chain_is_decode_timeout``."""
    faults = FaultInjector(FaultSchedule((
        FaultEvent(at=0, kind="decode_spike", spike_ms=50.0),)))
    svc = PlacementService(agent, faults=faults, clock=FakeClock(),
                           config=ServeConfig(max_wait_ms=0.0, max_batch=1,
                                              decode_deadline_ms=25.0,
                                              fallback_chain=()))
    raw, d = _request(dlrm_pool, range(12))
    out = svc.submit(raw, d, tag="spiked")
    assert out[0].source == "error"
    assert isinstance(out[0].error, DecodeTimeout)
    with pytest.raises(ValueError):
        ServeConfig(fallback_chain=("expert", "prayer"))


def test_transient_errors_retry_with_bounded_budget(agent):
    """``test_resilience.py::test_transient_errors_retry_with_bounded_budget``."""
    svc = PlacementService(agent, clock=FakeClock(),
                           config=ServeConfig(oracle_retries=2))
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise TransientOracleError("blip")
        return "ok"

    assert svc._with_retries(flaky) == "ok"
    assert len(calls) == 2 and svc.retries == 1 and svc.retry_exhausted == 0

    def always():
        raise TransientOracleError("down")

    assert svc._with_retries(always) is None
    assert svc.retries == 1 + 3                 # 1 + (retries + 1) attempts
    assert svc.retry_exhausted == 1


# ---- failover re-placement ---------------------------------------------------

def test_device_loss_evacuates_cache_onto_survivors(dlrm_pool, agents,
                                                    both_telemetry):
    """``test_resilience.py::
    test_device_loss_evacuates_cache_onto_survivors``, the evacuated
    placements and ``serve.*`` counters the reference's."""
    agent, jagent = agents
    lost = 1
    events = [dict(at=2, kind="device_loss", device=lost),
              dict(at=4, kind="device_recovery", device=lost)]
    cfg = dict(max_wait_ms=0.0, max_batch=1, failover_max_evals=8)
    faults = FaultInjector(FaultSchedule(tuple(FaultEvent(**e)
                                               for e in events)))
    svc = PlacementService(agent, faults=faults, clock=FakeClock(),
                           config=ServeConfig(**cfg))
    jsvc = JPlacementService(
        jagent, faults=JFaultInjector(JFaultSchedule(tuple(
            JFaultEvent(**e) for e in events))), clock=FakeClock(),
        config=JServeConfig(**cfg))
    jobs = [_request(dlrm_pool, range(10 * i, 10 * i + 12))
            for i in range(3)]
    done, jdone = [], []
    for i, (raw, d) in enumerate(jobs[:2]):
        done += svc.submit(raw, d, tag=i)
        jdone += jsvc.submit(raw, d, tag=i)
        assert done[-1].placement is not None
    out = svc.submit(*jobs[2], tag=2)           # absorbs the loss
    jdone += jsvc.submit(*jobs[2], tag=2)
    done += out
    assert out[0].placement is not None
    assert not (out[0].placement.assignment == lost).any()
    for _, entry in svc.cache.items():
        a = entry.placement.assignment
        assert not (a == lost).any()
        assert svc.oracle.legal(entry.raw, a, entry.placement.n_devices)
    assert svc.fault_events["device_loss"] == 1
    assert svc.evacuations + svc.evacuation_failures >= 1 or \
        svc.failover_bytes_gb == 0.0            # nothing was on the device
    assert tele.snapshot()["counters"]["serve.faults.device_loss"] == 1
    again = svc.submit(*jobs[0], tag="warm")
    done += again
    jdone += jsvc.submit(*jobs[0], tag="warm")
    assert again[0].source == "cache"
    assert not (again[0].placement.assignment == lost).any()
    done += svc.submit(*jobs[1], tag="after")
    jdone += jsvc.submit(*jobs[1], tag="after")
    assert not faults.degraded and svc.fault_events["device_recovery"] == 1
    assert_same_serving(done, jdone)
    assert svc.failover_bytes_gb == jsvc.failover_bytes_gb
    serve = {k: v for k, v in tele.snapshot()["counters"].items()
             if k.startswith("serve.")}
    assert serve == {k: v for k, v in jtele.snapshot()["counters"].items()
                     if k.startswith("serve.")}


# ---- latency ledger ----------------------------------------------------------

def test_latency_reservoir_quantiles_and_bound():
    """``test_resilience.py::test_latency_reservoir_quantiles_and_bound``,
    each summary bitwise the reference reservoir's."""
    r = LatencyReservoir(capacity=256, seed=0)
    assert r.summary() == {"count": 0, "mean_ms": None, "p50_ms": None,
                           "p99_ms": None}
    values = [float(v) for v in range(1, 101)]
    for v in values:
        r.record(v)
    assert r.count == 100 and sorted(r.values()) == values
    s = r.summary()
    assert s["p50_ms"] == pytest.approx(np.quantile(values, 0.5))
    assert s["p99_ms"] == pytest.approx(np.quantile(values, 0.99))
    assert s["mean_ms"] == pytest.approx(np.mean(values))
    small = LatencyReservoir(capacity=16, seed=1)
    for v in range(1000):
        small.record(float(v))
    assert small.count == 1000 and len(small.values()) == 16
    assert small.mean == pytest.approx(np.mean(np.arange(1000.0)))


@pytest.mark.parametrize("capacity,seed", [(16, 1), (64, 3), (4096, 0)])
def test_latency_reservoir_samples_as_the_reference(rng, capacity, seed):
    """Algorithm R on ``default_rng(seed)``: the same records give the
    same sample and the same quantiles, bit for bit."""
    mine = LatencyReservoir(capacity=capacity, seed=seed)
    ref = JLatencyReservoir(capacity=capacity, seed=seed)
    for v in rng.exponential(3.0, 5000):
        mine.record(v)
        ref.record(v)
    np.testing.assert_array_equal(mine.values(), ref.values())
    assert mine.summary() == ref.summary()
    for q in (0.01, 0.5, 0.9, 0.99):
        assert mine.quantile(q) == ref.quantile(q)


def test_latency_reservoir_checkpoint_is_seamless():
    """``test_resilience.py::test_latency_reservoir_checkpoint_is_seamless``,
    with the state handed across the packages both ways."""
    a = LatencyReservoir(capacity=8, seed=3)
    ja = JLatencyReservoir(capacity=8, seed=3)
    for v in range(40):
        a.record(float(v))
        ja.record(float(v))
    b = LatencyReservoir(capacity=8, seed=999)
    b.load_state_dict(json.loads(json.dumps(ja.state_dict())))
    jb = JLatencyReservoir(capacity=8, seed=999)
    jb.load_state_dict(json.loads(json.dumps(a.state_dict())))
    for v in range(40, 80):
        for r in (a, b, jb):
            r.record(float(v))
    np.testing.assert_array_equal(a.values(), b.values())
    np.testing.assert_array_equal(a.values(), jb.values())
    assert a.count == b.count == jb.count
    with pytest.raises(ValueError):
        LatencyReservoir(capacity=4).load_state_dict(a.state_dict())


def test_service_stats_ledger_is_bounded(dlrm_pool, agent):
    """``test_resilience.py::test_service_stats_ledger_is_bounded``."""
    svc = PlacementService(agent, clock=FakeClock(), config=ServeConfig(
        max_wait_ms=0.0, max_batch=1, reservoir_size=4))
    raw, d = _request(dlrm_pool, range(12))
    for i in range(10):
        svc.submit(raw, d, tag=i)
    lat = svc.stats()["latency"]
    assert lat["count"] == 10 and len(svc.latency.values()) == 4


# ---- warm-restart checkpoints ------------------------------------------------

def test_warm_restart_matches_uninterrupted_run(dlrm_pool, agent, tmp_path):
    """``test_resilience.py::test_warm_restart_matches_uninterrupted_run``."""
    cfg = TrafficConfig(n_jobs=3, n_tables=12, n_devices=4, n_requests=24,
                        drift=1.0, zipf=0.0, seed=5)
    trace = make_trace(dlrm_pool, cfg)
    sched = FaultSchedule((
        FaultEvent(at=8, kind="device_loss", device=2),
        FaultEvent(at=20, kind="device_recovery", device=2)))
    scfg = ServeConfig(max_wait_ms=2.0, max_batch=4, drift_threshold=0.05,
                       ewma_alpha=0.5, replace_max_evals=8,
                       failover_max_evals=8)
    clock = FakeClock()
    base = PlacementService(agent, faults=FaultInjector(sched), clock=clock,
                            config=scfg)
    expect = _drain(base, trace, clock)

    clock = FakeClock()
    svc = PlacementService(agent, faults=FaultInjector(sched), clock=clock,
                           config=scfg)
    done = []
    cut = 13                    # mid-outage, with requests still queued
    for i, r in enumerate(trace[:cut]):
        clock.advance_ms(1.0)
        done += svc.submit(r.raw_features, r.n_devices, tag=i)
    path = os.path.join(tmp_path, "ckpt")
    svc.save(path)
    restored = PlacementService.restore(path, agent=agent, config=scfg,
                                        faults=FaultInjector(sched),
                                        clock=clock)
    assert restored.pending == svc.pending      # queued tickets survive
    assert restored.faults.down == {2}
    done += _drain(restored, trace[cut:], clock, tag0=cut)

    by_tag = {r.tag: r for r in expect}
    assert len(done) == len(expect) == len(trace)
    for r in done:
        ref = by_tag[r.tag]
        assert (r.placement is None) == (ref.placement is None)
        if r.placement is not None:
            np.testing.assert_array_equal(r.placement.assignment,
                                          ref.placement.assignment)
    assert restored.stats()["fault_epoch"] == base.stats()["fault_epoch"]


def test_checkpoint_rejects_future_state_version(tmp_path):
    """``test_resilience.py::test_checkpoint_rejects_future_state_version``,
    and a state written by either package loads in the other."""
    for save, load in ((checkpoint.save_state, checkpoint.load_state),
                       (checkpoint.save_state, jcheckpoint.load_state),
                       (jcheckpoint.save_state, checkpoint.load_state)):
        path = os.path.join(tmp_path, "state")
        save(path, {"x": np.arange(3), "y": np.eye(2)}, {"meta": 1})
        arrays, meta = load(path)
        np.testing.assert_array_equal(arrays["x"], np.arange(3))
        np.testing.assert_array_equal(arrays["y"], np.eye(2))
        assert meta == {"meta": 1}
    assert checkpoint.STATE_VERSION == jcheckpoint.STATE_VERSION
    envelope = json.load(open(os.path.join(path, "state.json")))
    envelope["state_version"] = checkpoint.STATE_VERSION + 1
    json.dump(envelope, open(os.path.join(path, "state.json"), "w"))
    with pytest.raises(ValueError, match="checkpoint version"):
        checkpoint.load_state(path)


def test_empty_schedule_matches_no_injector(dlrm_pool, agent):
    """``test_resilience.py::test_empty_schedule_matches_no_injector``."""
    cfg = TrafficConfig(n_jobs=2, n_tables=12, n_devices=4, n_requests=10,
                        drift=0.5, seed=9)
    trace = make_trace(dlrm_pool, cfg)
    scfg = ServeConfig(max_wait_ms=0.0, max_batch=4)
    clock = FakeClock()
    plain = _drain(PlacementService(agent, clock=clock, config=scfg),
                   trace, clock)
    clock = FakeClock()
    faulted = _drain(PlacementService(agent, faults=FaultInjector(),
                                      clock=clock, config=scfg),
                     trace, clock)
    for a, b in zip(plain, faulted):
        assert a.tag == b.tag and a.source == b.source
        np.testing.assert_array_equal(a.placement.assignment,
                                      b.placement.assignment)


# ---- b12's quick regime through both services --------------------------------

B12_TRAFFIC = dict(n_jobs=6, n_tables=16, n_devices=8, n_requests=400,
                   drift=0.8, zipf=1.0, tail_jobs=4, seed=0)
B12_SERVE = dict(max_wait_ms=2.0, max_batch=8, ewma_alpha=0.3,
                 drift_threshold=0.05, migration_ms_per_gb=25.0,
                 replace_max_evals=64, failover_max_evals=64,
                 decode_deadline_ms=25.0, oracle_retries=2, seed=0)
B12_EVENTS = [dict(at=200, kind="device_loss", device=1),
              dict(at=320, kind="device_recovery", device=1),
              dict(at=120, kind="oracle_error", count=2),
              dict(at=240, kind="oracle_error", count=2),
              dict(at=80, kind="decode_spike", spike_ms=50.0),
              dict(at=360, kind="decode_spike", spike_ms=50.0)]
B12_CHECKPOINT = 260


class Package:
    """One package's serving stack for the b12 replays."""

    def __init__(self, agent, jax: bool):
        self.agent = agent
        if jax:
            self.service, self.config = JPlacementService, JServeConfig
            self.schedule = JFaultSchedule(tuple(JFaultEvent(**e)
                                                 for e in B12_EVENTS))
            self.injector, self.oracle = JFaultInjector, JSimOracle
        else:
            self.service, self.config = PlacementService, ServeConfig
            self.schedule = FaultSchedule(tuple(FaultEvent(**e)
                                                for e in B12_EVENTS))
            self.injector, self.oracle = FaultInjector, SimOracle

    def start(self, clock):
        return self.service(self.agent, oracle=self.oracle(seed=0),
                            config=self.config(**B12_SERVE),
                            faults=self.injector(self.schedule), clock=clock)

    def restore(self, path, clock):
        return self.service.restore(path, agent=self.agent,
                                    oracle=self.oracle(seed=0),
                                    config=self.config(**B12_SERVE),
                                    faults=self.injector(self.schedule),
                                    clock=clock)


def _b12_replay(first: Package, trace, path=None, then: Package = None):
    """b12's ``_replay``: one tick a request, served on ``first``; with
    ``path`` the service is saved at the checkpoint and ``then`` restores
    it and finishes the trace.  Returns (results, final service)."""
    clock = FakeClock()
    svc = first.start(clock)
    done = []
    for i, r in enumerate(trace):
        if path is not None and i == B12_CHECKPOINT:
            svc.save(path)
            svc = then.restore(path, clock)
        clock.advance_ms(1.0)
        done += svc.submit(r.raw_features, r.n_devices, tag=i)
    done += svc.flush()
    return done, svc


@pytest.fixture(scope="module")
def b12_runs(dlrm_pool, agents):
    """The uninterrupted b12 quick replay in each package."""
    agent, jagent = agents
    trace = make_trace(dlrm_pool, TrafficConfig(**B12_TRAFFIC))
    jtrace = j_make_trace(dlrm_pool, JTrafficConfig(**B12_TRAFFIC))
    port, ref = Package(agent, jax=False), Package(jagent, jax=True)
    return {"trace": trace, "jtrace": jtrace, "port": port, "ref": ref,
            "mine": _b12_replay(port, trace),
            "theirs": _b12_replay(ref, jtrace)}


def test_b12_quick_replay_matches_the_reference(b12_runs):
    """``benchmarks/b12_resilience.py``'s quick regime (8 devices, device 1
    lost at 200 and back at 320, oracle errors at 120 and 240, 50 ms
    spikes at 80 and 360 against a 25 ms deadline) through both services:
    per request the same source, ``replaced``, ``degraded`` and
    assignment; ``stats()`` equal but for latencies; every request served
    and none on the lost device during the outage."""
    (done, svc), (jdone, jsvc) = b12_runs["mine"], b12_runs["theirs"]
    assert_same_serving(done, jdone)
    stats = svc.stats()
    assert _without_latency(stats) == _without_latency(jsvc.stats())
    assert len(done) == len(b12_runs["trace"])
    assert all(r.placement is not None or r.error is not None for r in done)
    assert stats["fault_events"]["device_loss"] == 1
    # a spike waits for the next flush, and spikes pending together merge
    assert 1 <= stats["deadline_skips"] <= 2 and stats["decode_errors"] == 0
    assert stats["evacuations"] > 0 and stats["retries"] > 0
    oracle = SimOracle(seed=0)
    for r in done:
        if r.placement is None:
            continue
        req = b12_runs["trace"][r.tag]
        assert oracle.legal(req.raw_features, r.placement.assignment, 8)
        if 200 <= r.tag < 320:
            assert not (r.placement.assignment == 1).any()


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_warm_restart_across_packages(b12_runs, tmp_path, direction):
    """b12's warm restart at request 260 (mid-outage, tickets queued),
    saved by one package and restored by the other: the finished trace
    serves what the uninterrupted run served, request for request."""
    port, ref = b12_runs["port"], b12_runs["ref"]
    first, then = (ref, port) if direction == "jax-to-port" else (port, ref)
    trace = b12_runs["jtrace"] if first is ref else b12_runs["trace"]
    done, svc = _b12_replay(first, trace, str(tmp_path / "ckpt"), then)
    expect, base = b12_runs["mine"]
    assert_same_serving(done, expect)
    assert _without_latency(svc.stats()) == _without_latency(base.stats())
    assert svc.stats()["latency"]["count"] == len(trace)
