"""The port's numpy copies are bitwise the JAX package's: features, pools,
the cost simulator, the expert and random baselines, placement plans,
digests, and the telemetry core."""

import numpy as np
import pytest

from repro.api import digest as jdigest
from repro.core import baselines as JB
from repro.core import features as JF
from repro.embedding.plan import build_plan as j_build_plan
from repro.sim import costsim as JC
from repro.sim import hardware as JH
from repro_torch import telemetry as tele
from repro_torch.api import digest
from repro_torch.core import baselines as B
from repro_torch.core import features as F
from repro_torch.data.synthetic import make_prod_pool
from repro_torch.embedding.plan import build_plan
from repro_torch.sim import costsim as C
from repro_torch.sim import hardware as H


def _assignments(raw, n_devices, P=6, seed=0):
    return np.random.default_rng(seed).integers(0, n_devices,
                                                (P, raw.shape[0]))


def test_prod_pool_and_features_are_bitwise(prod_pool):
    np.testing.assert_array_equal(make_prod_pool(seed=1), prod_pool)
    np.testing.assert_array_equal(F.normalize_features(prod_pool),
                                  JF.normalize_features(prod_pool))
    for group in ("dim", "hash_size", "pooling", "table_size",
                  "distribution"):
        np.testing.assert_array_equal(F.drop_feature_group(prod_pool, group),
                                      JF.drop_feature_group(prod_pool, group))
    np.testing.assert_array_equal(F.BIN_MEAN_COUNT, JF.BIN_MEAN_COUNT)


def test_hardware_specs_are_the_reference():
    assert {k: v.__dict__ for k, v in H.SPECS.items()} == \
        {k: v.__dict__ for k, v in JH.SPECS.items()}


@pytest.mark.parametrize("spec", ["2080ti-calibrated", "v100-calibrated"])
@pytest.mark.parametrize("n_devices", [2, 4])
def test_simulator_is_bitwise(dlrm_pool, prod_pool, spec, n_devices):
    for raw in (dlrm_pool[:40], prod_pool[100:130]):
        A = _assignments(raw, n_devices)
        ours = C.CostSimulator(H.SPECS[spec], seed=3).evaluate_batch(
            raw, A, n_devices)
        ref = JC.CostSimulator(JH.SPECS[spec], seed=3).evaluate_batch(
            raw, A, n_devices)
        for o, r in zip(ours, ref):
            for f in ("fwd_comp", "bwd_comp", "fwd_comm", "bwd_comm"):
                np.testing.assert_array_equal(getattr(o, f), getattr(r, f))
            assert o.overall == r.overall
        sim, jsim = C.CostSimulator(H.SPECS[spec]), \
            JC.CostSimulator(JH.SPECS[spec])
        assert sim.fused_op_ms(raw[:7]) == jsim.fused_op_ms(raw[:7])
        np.testing.assert_array_equal(sim.single_table_ms(raw),
                                      jsim.single_table_ms(raw))
        np.testing.assert_array_equal(sim.legal_batch(raw, A, n_devices),
                                      jsim.legal_batch(raw, A, n_devices))
        np.testing.assert_array_equal(
            C.placement_digests(raw, A, n_devices),
            JC.placement_digests(raw, A, n_devices))


@pytest.mark.parametrize("strategy", B.EXPERT_STRATEGIES)
def test_expert_and_random_baselines_are_bitwise(dlrm_pool, strategy):
    raw = dlrm_pool[200:260]
    for cap in (11.0, 0.3):
        np.testing.assert_array_equal(
            B.expert_place(raw, 4, cap, strategy),
            JB.expert_place(raw, 4, cap, strategy))
        np.testing.assert_array_equal(
            B.random_place(raw, 4, cap, np.random.default_rng(1)),
            JB.random_place(raw, 4, cap, np.random.default_rng(1)))


def test_build_plan_matches(dlrm_pool):
    raw = dlrm_pool[:20]
    a = _assignments(raw, 3, P=1)[0]
    ours, ref = build_plan(raw, a, 3), j_build_plan(raw, a, 3)
    for f in ("n_shards", "dim", "k_max", "rows_max"):
        assert getattr(ours, f) == getattr(ref, f)
    for f in ("base_rows", "slot_table", "table_rows"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    np.testing.assert_array_equal(ours.grouped_index_order(),
                                  ref.grouped_index_order())
    with pytest.raises(ValueError):
        build_plan(raw, a[:-1], 3)


def test_digests_match(dlrm_pool):
    raw = dlrm_pool[:12]
    A = _assignments(raw, 4)
    assert digest.placement_keys(raw, A, 4) == \
        jdigest.placement_keys(raw, A, 4)
    assert digest.placement_key(raw, A[0], 4) == \
        jdigest.placement_key(raw, A[0], 4)
    for inc in (True, False):
        assert digest.task_key(raw, 4, include_distribution=inc) == \
            jdigest.task_key(raw, 4, include_distribution=inc)


def test_telemetry_counts_and_spans():
    tele.reset()
    assert tele.span("x") is tele.NOOP_SPAN
    tele.count("c")                       # disabled: dropped
    tele.enable()
    try:
        with tele.span("outer", a=1) as sp:
            with tele.span("inner"):
                tele.count("c", 2)
            sp.set(b=2)
        tele.gauge("g", 7)
        snap = tele.snapshot()
        events = tele.get_tracer().snapshot_events()
    finally:
        tele.disable()
        tele.reset()
    assert snap["counters"] == {"c": 2} and snap["gauges"] == {"g": 7}
    assert snap["spans"]["outer"]["count"] == 1
    inner = next(e for e in events if e[0] == "inner")
    outer = next(e for e in events if e[0] == "outer")
    assert inner[5] == outer[4] and outer[6] == {"a": 1, "b": 2}
