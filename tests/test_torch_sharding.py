"""Column-wise sharding in the port (``repro_torch.sharding``, the sharded
oracle paths, plans and lookup) against ``repro.sharding`` and the rest of
the reference, case by case after ``tests/test_sharding.py`` (each test
names the reference test it mirrors).

- ``ShardSpec``: tiling, validation, split/merge, sizes and projection,
  the canonical bytes equal the reference's;
- K = 1: sharded costs, legality, digests and cache entries are bitwise
  the whole-table paths' and the reference's keys;
- mixed K: ``evaluate_sharded`` bitwise the reference's over
  ``SimOracle`` and over ``MeasuredOracle`` on one artifact that both
  packages load;
- ``build_plan(sharding=)`` array for array the reference's;
- the column-sharded lookup (``lookup_unsharded`` + ``combine_shard_
  outputs`` through K1's plain version) equal to the whole-table plan's
  bit for bit and within 1e-6 of the reference's; its arena gradients
  against ``jax.grad`` of the reference's with row 0 of each shard masked
  (the reference trains row 0 by the padded slots; the port keeps it 0);
- ``pack_shards``, ``ShardingPlacer`` and ``refine_sharded`` return the
  reference's placements.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import telemetry as jtele
from repro import api as japi
from repro.embedding import sharded as JE
from repro.embedding.plan import build_plan as j_build_plan
from repro.profiling import calibration as JC
from repro.search import SearchConfig as JSearchConfig
from repro.search import SearchPlacer as JSearchPlacer
from repro.sharding import ShardingConfig as JShardingConfig
from repro.sharding import ShardingPlacer as JShardingPlacer
from repro.sharding import ShardSpec as JShardSpec
from repro.sharding import refine_sharded as j_refine_sharded
from repro.sharding.placer import pack_shards as j_pack_shards
from repro_torch import api
from repro_torch import telemetry as tele
from repro_torch.api import (CachedOracle, KernelOracle, MeasuredOracle,
                             SimOracle, evaluate_many, evaluate_sharded,
                             legal_batch, legal_sharded, measure_placements,
                             placement_key, placement_keys,
                             sharded_placement_key, sharded_placement_keys)
from repro_torch.core import features as F
from repro_torch.core.baselines import (EXPERT_STRATEGIES, expert_place,
                                        random_place)
from repro_torch.data.tasks import Task
from repro_torch.embedding import sharded as E
from repro_torch.embedding.plan import build_plan
from repro_torch.profiling.calibration import CalibrationTable
from repro_torch.search import SearchConfig, SearchPlacer
from repro_torch.sharding import (ShardingConfig, ShardingPlacer, ShardSpec,
                                  project_assignment, refine_sharded,
                                  shard_features, shard_sizes_gb)
from repro_torch.sharding.placer import pack_shards

MIXED_K = np.array([1, 3, 1, 2, 1, 1, 2, 1])


@pytest.fixture(scope="module")
def raw8(dlrm_pool):
    return np.array(dlrm_pool[:8], dtype=np.float64)


@pytest.fixture(scope="module")
def mixed_spec(raw8):
    return ShardSpec.even(raw8, MIXED_K)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """One synthetic calibration artifact (fitted fusion and shard models)
    written by the port and loaded by both packages."""
    path = CalibrationTable.synthetic().save(
        str(tmp_path_factory.mktemp("calib") / "synthetic.npz"))
    return CalibrationTable.load(path), JC.CalibrationTable.load(path)


def _oracle_pairs(artifact):
    port, ref = artifact
    return [(SimOracle(seed=3), japi.SimOracle(seed=3)),
            (CachedOracle(SimOracle(seed=3)),
             japi.CachedOracle(japi.SimOracle(seed=3))),
            (MeasuredOracle(port), japi.MeasuredOracle(ref))]


ORACLES = ["sim", "cached", "measured"]


def _same_results(got, want):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.overall == y.overall
        np.testing.assert_array_equal(x.cost_features, y.cost_features)


def _same_placement(p, jp):
    np.testing.assert_array_equal(p.assignment, jp.assignment)
    assert p.est_cost_ms == jp.est_cost_ms
    assert (p.strategy, p.candidates, p.oracle_evals, p.is_sharded,
            p.n_shards) == (jp.strategy, jp.candidates, jp.oracle_evals,
                            jp.is_sharded, jp.n_shards)
    if p.is_sharded:
        assert p.sharding.to_bytes() == jp.sharding.to_bytes()
        np.testing.assert_array_equal(p.shard_assignment,
                                      jp.shard_assignment)
    _same_plan(p.plan, jp.plan)


def _same_plan(plan, jplan):
    for f in ("assignment", "base_rows", "slot_table", "table_rows"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(jplan, f))
    assert (plan.n_shards, plan.dim, plan.k_max, plan.rows_max,
            plan.n_tables, plan.is_sharded) == \
        (jplan.n_shards, jplan.dim, jplan.k_max, jplan.rows_max,
         jplan.n_tables, jplan.is_sharded)
    for g, jg in zip(plan.groups, jplan.groups, strict=True):
        np.testing.assert_array_equal(g, jg)
    if plan.slot_cols is None:
        assert jplan.slot_cols is None
    else:
        np.testing.assert_array_equal(plan.slot_cols, jplan.slot_cols)
    assert plan.shard_rows.max() == plan.rows_max


# ---- ShardSpec ----------------------------------------------------------------


def test_trivial_spec_expands_byte_identically(raw8):
    """``test_sharding.py::test_trivial_spec_expands_byte_identically``."""
    spec = ShardSpec.trivial(raw8)
    assert spec.is_trivial and spec.n_shards == spec.n_tables == 8
    assert shard_features(raw8, spec).tobytes() == raw8.tobytes()
    assert spec.to_bytes() == JShardSpec.trivial(raw8).to_bytes()


@pytest.mark.parametrize("k", [MIXED_K, 2, np.arange(8) % 4 + 1, 64],
                         ids=["mixed", "two", "ramp", "clamped"])
def test_even_split_tiles_columns(raw8, k):
    """``test_sharding.py::test_even_split_tiles_columns``, the spec's
    bytes, expansion and sizes the reference's."""
    spec, jspec = ShardSpec.even(raw8, k), JShardSpec.even(raw8, k)
    assert spec.to_bytes() == jspec.to_bytes()
    dims = raw8[:, F.DIM].astype(np.int64)
    for t in range(8):
        rows = np.flatnonzero(spec.table == t)
        assert spec.col_start[rows[0]] == 0
        assert spec.col_end[rows[-1]] == dims[t]
        np.testing.assert_array_equal(spec.col_start[rows[1:]],
                                      spec.col_end[rows[:-1]])
    np.testing.assert_array_equal(spec.shard_counts, jspec.shard_counts)
    np.testing.assert_array_equal(spec.first_shard, jspec.first_shard)
    from repro.sharding import shard_features as j_shard_features
    assert shard_features(raw8, spec).tobytes() == \
        j_shard_features(raw8, jspec).tobytes()


def _bad_specs(dims):
    d0 = int(dims[0])
    return {
        "start at col 0": dict(table=[0], col_start=[1], col_end=[d0],
                               dims=dims[:1]),
        "end at its dim": dict(table=[0], col_start=[0], col_end=[d0 - 1],
                               dims=dims[:1]),
        "positive column width": dict(table=[0, 0], col_start=[0, 0],
                                      col_end=[d0, 0], dims=dims[:1]),
        "cover": dict(table=[0], col_start=[0], col_end=[d0],
                      dims=dims[:2]),
        "contiguous": dict(table=[0, 0], col_start=[0, 2],
                           col_end=[1, d0], dims=dims[:1]),
    }


@pytest.mark.parametrize("match", ["start at col 0", "end at its dim",
                                   "positive column width", "cover",
                                   "contiguous"])
def test_spec_validation_rejects_bad_tilings(raw8, match):
    """``test_sharding.py::test_spec_validation_rejects_bad_tilings``: the
    port and the reference reject the same tilings with the same words."""
    kw = {k: np.asarray(v) for k, v in _bad_specs(
        raw8[:, F.DIM].astype(np.int64))[match].items()}
    for cls in (ShardSpec, JShardSpec):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


def test_split_merge_roundtrip(raw8):
    """``test_sharding.py::test_split_merge_roundtrip``."""
    spec = ShardSpec.trivial(raw8)
    split = spec.split(2)
    assert split.shard_counts[2] == 2 and split.n_shards == 9
    assert split.to_bytes() == JShardSpec.trivial(raw8).split(2).to_bytes()
    assert split.merge(2).to_bytes() == spec.to_bytes()
    tiny = ShardSpec.even(raw8, raw8[:, F.DIM].astype(int))
    assert tiny.split(0).to_bytes() == tiny.to_bytes()
    assert spec.merge(0).to_bytes() == spec.to_bytes()


def test_shard_sizes_sum_to_table_sizes(raw8, mixed_spec):
    """``test_sharding.py::test_shard_sizes_sum_to_table_sizes``."""
    from repro.sharding import shard_sizes_gb as j_shard_sizes_gb
    sizes = shard_sizes_gb(raw8, mixed_spec)
    assert sizes.tobytes() == j_shard_sizes_gb(
        raw8, JShardSpec.even(raw8, MIXED_K)).tobytes()
    per_table = np.bincount(mixed_spec.table, weights=sizes, minlength=8)
    np.testing.assert_allclose(per_table, raw8[:, F.TABLE_SIZE_GB],
                               rtol=1e-12)


def test_project_assignment_takes_first_shard(mixed_spec):
    """``test_sharding.py::test_project_assignment_takes_first_shard``."""
    a = np.arange(mixed_spec.n_shards) % 4
    np.testing.assert_array_equal(project_assignment(mixed_spec, a),
                                  a[mixed_spec.first_shard])
    A = np.stack([a, a[::-1].copy()])
    assert project_assignment(mixed_spec, A).shape == (2, 8)


# ---- K = 1 bitwise guarantee --------------------------------------------------


@pytest.mark.parametrize("which", ORACLES)
def test_k1_costs_bitwise_across_oracles(raw8, artifact, which):
    """``test_sharding.py::test_k1_costs_bitwise_across_oracles``, and the
    reference's costs."""
    oracle, joracle = _oracle_pairs(artifact)[ORACLES.index(which)]
    spec = ShardSpec.trivial(raw8)
    A = np.random.default_rng(0).integers(0, 4, (6, 8))
    legacy = evaluate_many(oracle, raw8, A, 4)
    sharded = evaluate_sharded(oracle, raw8, spec, A, 4)
    _same_results(sharded, legacy)
    _same_results(sharded, japi.evaluate_sharded(
        joracle, raw8, JShardSpec.trivial(raw8), A, 4))
    np.testing.assert_array_equal(legal_batch(oracle, raw8, A, 4),
                                  legal_sharded(oracle, raw8, spec, A, 4))


def test_k1_bitwise_kernel_oracle(raw8):
    """``test_sharding.py::test_k1_bitwise_kernel_oracle``: its legality
    never calibrates; its K = 1 costs are the whole-table ones (the plain
    K1 times K1 on the CPU here)."""
    oracle = KernelOracle(batch_size=8, pooling=2, max_rows=256, repeats=1,
                          device="cpu")
    spec = ShardSpec.trivial(raw8)
    a = np.array([0, 1, 0, 1, 1, 0, 1, 0])
    np.testing.assert_array_equal(
        legal_batch(oracle, raw8, a[None], 2),
        legal_sharded(oracle, raw8, spec, a[None], 2))
    assert oracle._measured is None
    legacy = evaluate_many(oracle, raw8, a[None], 2)
    _same_results(evaluate_sharded(oracle, raw8, spec, a[None], 2), legacy)


def test_k1_digests_equal_legacy(raw8):
    """``test_sharding.py::test_k1_digests_equal_legacy``, and the
    reference's keys."""
    spec = ShardSpec.trivial(raw8)
    a = np.array([0, 1, 2, 3, 0, 1, 2, 3])
    key = sharded_placement_key(raw8, spec, a, 4)
    assert key == placement_key(raw8, a, 4) == japi.sharded_placement_key(
        raw8, JShardSpec.trivial(raw8), a, 4)
    A = np.stack([a, a[::-1].copy()])
    assert sharded_placement_keys(raw8, spec, A, 4) == \
        placement_keys(raw8, A, 4) == japi.placement_keys(raw8, A, 4)


def test_k1_shares_cache_entries_with_legacy(raw8):
    """``test_sharding.py::test_k1_shares_cache_entries_with_legacy``."""
    oracle = CachedOracle(SimOracle(seed=3))
    spec = ShardSpec.trivial(raw8)
    a = np.array([0, 1, 0, 1, 1, 0, 1, 0])
    evaluate_many(oracle, raw8, a[None], 2)
    assert (oracle.hits, oracle.misses) == (0, 1)
    evaluate_sharded(oracle, raw8, spec, a[None], 2)
    assert (oracle.hits, oracle.misses) == (1, 1)
    evaluate_many(oracle, raw8, a[None], 2)
    assert (oracle.hits, oracle.misses) == (2, 1)


def test_k1_sharded_search_refine_matches_legacy(raw8):
    """``test_sharding.py::test_k1_sharded_search_refine_matches_legacy``,
    and the reference's sharded search."""
    task = Task.of(raw8, 4)
    kw = dict(strategy="lns", budget_ms=None, max_evals=120, seed=5)
    a0 = expert_place(raw8, 4, SimOracle(seed=3).mem_capacity_gb, "size")
    placer = SearchPlacer(SimOracle(seed=3), config=SearchConfig(**kw))
    legacy = placer.refine(task, placer._wrap(task, a0))
    spec = ShardSpec.trivial(raw8)
    placer = SearchPlacer(SimOracle(seed=3), config=SearchConfig(**kw))
    sharded = placer.refine(task, placer._wrap(task, a0, sharding=spec))
    np.testing.assert_array_equal(legacy.assignment, sharded.assignment)
    assert legacy.est_cost_ms == sharded.est_cost_ms
    jplacer = JSearchPlacer(japi.SimOracle(seed=3),
                            config=JSearchConfig(**kw))
    jsharded = jplacer.refine(task, jplacer._wrap(
        task, a0, sharding=JShardSpec.trivial(raw8)))
    _same_placement(sharded, jsharded)


# ---- mixed-K pricing ----------------------------------------------------------


@pytest.mark.parametrize("which", ORACLES)
def test_mixed_k_batch_matches_loop(raw8, mixed_spec, artifact, which):
    """``test_sharding.py::test_mixed_k_batch_matches_loop``, each result
    and verdict bitwise the reference's (the measured pair prices from one
    artifact loaded by both packages)."""
    oracle, joracle = _oracle_pairs(artifact)[ORACLES.index(which)]
    jspec = JShardSpec.even(raw8, MIXED_K)
    A = np.random.default_rng(1).integers(0, 4, (5, mixed_spec.n_shards))
    batched = evaluate_sharded(oracle, raw8, mixed_spec, A, 4)
    _same_results(batched, japi.evaluate_sharded(joracle, raw8, jspec, A, 4))
    for i in range(A.shape[0]):
        _same_results([batched[i]], evaluate_sharded(
            oracle, raw8, mixed_spec, A[i][None], 4))
    legal = legal_sharded(oracle, raw8, mixed_spec, A, 4)
    np.testing.assert_array_equal(
        legal, japi.legal_sharded(joracle, raw8, jspec, A, 4))
    sizes = shard_sizes_gb(raw8, mixed_spec)
    for i in range(A.shape[0]):
        per_dev = np.bincount(A[i], weights=sizes, minlength=4)
        assert legal[i] == bool((per_dev <= oracle.mem_capacity_gb).all())


def test_measured_oracle_shard_model_prices_sublinearly(raw8, artifact):
    """``test_sharding.py::test_measured_oracle_shard_model_prices_
    sublinearly``."""
    oracle = MeasuredOracle(artifact[0])
    raw1 = raw8[:1]
    whole = evaluate_many(oracle, raw1, np.zeros((1, 1), np.int64), 2)[0]
    halves = evaluate_sharded(oracle, raw1, ShardSpec.even(raw1, 2),
                              np.array([[0, 1]]), 2)[0]
    for d in range(2):
        assert whole.fwd_comp[0] / 2 < halves.fwd_comp[d] < whole.fwd_comp[0]


def test_sharded_digest_stability(raw8, mixed_spec):
    """``test_sharding.py::test_sharded_digest_stability``, the keys the
    reference's."""
    a = np.arange(mixed_spec.n_shards) % 4
    k1 = sharded_placement_key(raw8, mixed_spec, a, 4)
    assert k1 == japi.sharded_placement_key(
        raw8, JShardSpec.even(raw8, MIXED_K), a, 4)
    assert sharded_placement_key(raw8, ShardSpec.even(raw8, MIXED_K.copy()),
                                 a, 4) == k1
    spec3 = ShardSpec.even(raw8, np.array([1, 2, 1, 3, 1, 1, 2, 1]))
    assert sharded_placement_key(raw8, spec3,
                                 np.arange(spec3.n_shards) % 4, 4) != k1
    a2 = a.copy()
    a2[0] = (a2[0] + 1) % 4
    assert sharded_placement_key(raw8, mixed_spec, a2, 4) != k1


# ---- sharded plans + the column-sharded lookup ----------------------------------


@pytest.mark.parametrize("assign", ["cyclic", "packed"])
def test_sharded_plan_layout(raw8, mixed_spec, assign):
    """``test_sharding.py::test_sharded_plan_layout``: the plan's fields
    equal the reference's array for array, its slots the spec's shards."""
    a = (np.arange(mixed_spec.n_shards) % 4 if assign == "cyclic" else
         pack_shards(raw8, mixed_spec, 4, SimOracle(seed=0).mem_capacity_gb))
    plan = build_plan(raw8, a, 4, sharding=mixed_spec)
    _same_plan(plan, j_build_plan(raw8, a, 4,
                                  sharding=JShardSpec.even(raw8, MIXED_K)))
    order, cols = plan.grouped_index_order(), plan.slot_cols.reshape(-1, 2)
    seen = sorted((int(order[s]), int(cols[s, 0]), int(cols[s, 1]))
                  for s in np.flatnonzero(order >= 0))
    assert seen == sorted(zip(mixed_spec.table.tolist(),
                              mixed_spec.col_start.tolist(),
                              mixed_spec.col_end.tolist()))
    slots = E.table_slots(plan)
    assert slots.shape == (mixed_spec.n_shards,)
    np.testing.assert_array_equal(order[slots], mixed_spec.table)
    np.testing.assert_array_equal(cols[slots, 0], mixed_spec.col_start)
    with pytest.raises(ValueError, match="shards"):
        build_plan(raw8, np.zeros(8, np.int64), 4, sharding=mixed_spec)


LOOKUP_M, LOOKUP_B, LOOKUP_P = 8, 4, 5


def _lookup_setup(raw8, spec):
    """The reference test's weights and indices: 8 tables of <= 300 rows,
    the whole-table and the column-sharded plan's arenas filled from the
    same weights (each shard's columns in lanes [0, width))."""
    raw = raw8.copy()
    raw[:, F.HASH_SIZE] = np.clip(raw[:, F.HASH_SIZE], 0, 300)
    rng = np.random.default_rng(2)
    rows = raw[:, F.HASH_SIZE].astype(np.int64)
    dims = raw[:, F.DIM].astype(np.int64)
    weights = [rng.normal(size=(rows[t], dims[t])) for t in range(LOOKUP_M)]
    idx = np.where(rng.random((LOOKUP_B, LOOKUP_M, LOOKUP_P)) < 0.3, -1,
                   rng.integers(0, 200, (LOOKUP_B, LOOKUP_M, LOOKUP_P))
                   ).astype(np.int32)

    def arenas(plan):
        out = np.zeros((plan.n_shards, plan.rows_max, plan.dim))
        for s, g in enumerate(plan.groups):
            for j, i in enumerate(g):
                t = int(plan.slot_table[s, j])
                c0, c1 = ((0, dims[t]) if plan.sharding is None else
                          (int(spec.col_start[i]), int(spec.col_end[i])))
                base = int(plan.base_rows[s, j])
                out[s, base:base + rows[t], :c1 - c0] = weights[t][:, c0:c1]
        return out.astype(np.float32)

    whole = build_plan(raw, np.arange(LOOKUP_M) % 4, 4)
    sharded = build_plan(raw, np.arange(spec.n_shards) % 4, 4,
                         sharding=spec)
    jsharded = j_build_plan(raw, np.arange(spec.n_shards) % 4, 4,
                            sharding=JShardSpec(spec.table, spec.col_start,
                                                spec.col_end, spec.dims))
    return raw, idx, whole, sharded, jsharded, arenas


def _port_lookup(plan, stack, idx):
    arenas = [torch.tensor(stack[s, :int(r)], requires_grad=True)
              for s, r in enumerate(plan.shard_rows)]
    grouped = E.lookup_unsharded(arenas, plan.base_rows,
                                 torch.as_tensor(E.group_indices(plan, idx)),
                                 plan)
    return arenas, E.combine_shard_outputs(plan, grouped)


@pytest.mark.parametrize("k", [MIXED_K, 2], ids=["mixed", "two"])
def test_combine_shard_outputs_matches_whole_table(raw8, k):
    """``test_sharding.py::test_combine_shard_outputs_matches_whole_table``:
    the column-sharded lookup equals the whole-table plan's bit for bit
    (K1 pools each lane in bag order either way) and the reference's
    within 1e-6."""
    spec = ShardSpec.even(raw8, k)
    _, idx, whole, sharded, jsharded, arenas = _lookup_setup(raw8, spec)
    _, out_w = _port_lookup(whole, arenas(whole), idx)
    _, out_s = _port_lookup(sharded, arenas(sharded), idx)
    assert out_w.shape == out_s.shape == (LOOKUP_B, LOOKUP_M, whole.dim)
    dims = raw8[:, F.DIM].astype(np.int64)
    lanes = np.arange(whole.dim)[None, :] < dims[:, None]      # (M, D)
    np.testing.assert_array_equal(out_s.detach().numpy()[:, lanes],
                                  out_w.detach().numpy()[:, lanes])
    assert not out_s.detach().numpy()[:, ~lanes].any()
    jgrouped = JE.lookup_unsharded(
        jnp.asarray(arenas(jsharded)), jsharded.base_rows,
        jnp.asarray(JE.group_indices(jsharded, idx)), jsharded)
    want = np.asarray(JE.combine_shard_outputs(jsharded, jgrouped))
    np.testing.assert_allclose(out_s.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("k", [MIXED_K, 2], ids=["mixed", "two"])
def test_combine_shard_outputs_gradient_matches_jax(raw8, k):
    """The gradient through ``combine_shard_outputs`` reaches K1's
    backward per shard: each shard's arena gradient equals ``jax.grad`` of
    the reference's lookup within 1e-6 on every row but row 0 (the
    reference trains row 0 by the padded slots, the port leaves it 0), and
    the lanes past a shard's width get no gradient."""
    spec = ShardSpec.even(raw8, k)
    _, idx, _, sharded, jsharded, arenas = _lookup_setup(raw8, spec)
    stack = arenas(sharded)
    upstream = np.random.default_rng(3).normal(
        size=(LOOKUP_B, LOOKUP_M, sharded.dim)).astype(np.float32)
    mine, out = _port_lookup(sharded, stack, idx)
    (out * torch.as_tensor(upstream)).sum().backward()
    jidx = jnp.asarray(JE.group_indices(jsharded, idx))

    def loss(a):
        g = JE.lookup_unsharded(a, jsharded.base_rows, jidx, jsharded)
        return jnp.sum(JE.combine_shard_outputs(jsharded, g) * upstream)

    jgrad = np.asarray(jax.grad(loss)(jnp.asarray(stack)))
    width = np.zeros((sharded.n_shards,), np.int64)
    for s, g in enumerate(sharded.groups):
        width[s] = int(spec.widths[g].max()) if len(g) else 0
    for s, a in enumerate(mine):
        got = a.grad.numpy()
        assert not got[0].any()
        np.testing.assert_allclose(got[1:], jgrad[s, 1:got.shape[0]],
                                   rtol=1e-6, atol=1e-6)
        assert not got[:, width[s]:].any()


# ---- packing + ShardingPlacer -------------------------------------------------


@pytest.fixture(scope="module")
def infeasible_task(dlrm_pool):
    """``test_sharding.py``'s oversized task: its largest table is 2.5x
    one device's HBM."""
    raw = np.array(dlrm_pool[:8], dtype=np.float64)
    raw[0, F.TABLE_SIZE_GB] = 2.5 * SimOracle(seed=0).mem_capacity_gb
    return Task.of(raw, 4, name="oversized")


@pytest.mark.parametrize("k", [MIXED_K, 2, 4], ids=["mixed", "two", "four"])
def test_pack_distinct_devices_per_table(raw8, k):
    """``test_sharding.py::test_pack_distinct_devices_per_table``, the
    packing the reference's."""
    spec = ShardSpec.even(raw8, k)
    cap = SimOracle(seed=0).mem_capacity_gb
    seed = expert_place(raw8, 4, cap, "size")
    for table_seed in (None, seed):
        a = pack_shards(raw8, spec, 4, cap, table_seed=table_seed)
        np.testing.assert_array_equal(a, j_pack_shards(
            raw8, JShardSpec.even(raw8, k), 4, cap, table_seed=table_seed))
        assert a.shape == (spec.n_shards,) and (a >= 0).all()
        for t in range(8):
            devs = a[spec.table == t]
            assert len(set(devs.tolist())) == devs.size


def test_whole_table_placers_all_illegal_on_oversized(infeasible_task):
    """``test_sharding.py::test_whole_table_placers_all_illegal_on_
    oversized``, with every baseline placer of the port."""
    task = infeasible_task
    oracle = SimOracle(seed=0)
    raw = task.raw_features
    for s in EXPERT_STRATEGIES:
        a = expert_place(raw, 4, oracle.mem_capacity_gb, s)
        assert not bool(legal_batch(oracle, raw, a[None], 4)[0])
    a = random_place(raw, 4, oracle.mem_capacity_gb,
                     np.random.default_rng(0))
    assert not bool(legal_batch(oracle, raw, a[None], 4)[0])
    for name, placer in api.make_baseline_placers(
            oracle, include_portfolio=True).items():
        p = placer.place(task)
        assert not bool(legal_batch(oracle, raw, p.assignment[None], 4)[0]), \
            name
    assert float(raw[0, F.TABLE_SIZE_GB]) > oracle.mem_capacity_gb


def test_sharding_placer_makes_oversized_legal(infeasible_task):
    """``test_sharding.py::test_sharding_placer_makes_oversized_legal``,
    the placement the reference's."""
    task = infeasible_task
    oracle = SimOracle(seed=0)
    placement = ShardingPlacer(oracle).place(task)
    _same_placement(placement,
                    JShardingPlacer(japi.SimOracle(seed=0)).place(task))
    assert placement.is_sharded and placement.plan.is_sharded
    assert placement.sharding.shard_counts[0] >= 3      # 2.5x capacity
    assert bool(legal_sharded(oracle, task.raw_features, placement.sharding,
                              placement.shard_assignment[None], 4)[0])
    np.testing.assert_array_equal(
        placement.assignment,
        project_assignment(placement.sharding, placement.shard_assignment))
    assert np.isfinite(placement.est_cost_ms)


def test_sharding_placer_passes_through_feasible(raw8):
    """``test_sharding.py::test_sharding_placer_passes_through_feasible``."""
    task = Task.of(raw8, 4)
    oracle = SimOracle(seed=0)
    placement = ShardingPlacer(oracle).place(task)
    assert not placement.is_sharded
    assert placement.strategy == "sharding(expert)"
    np.testing.assert_array_equal(
        placement.assignment,
        expert_place(raw8, 4, oracle.mem_capacity_gb, "size"))
    _same_placement(placement,
                    JShardingPlacer(japi.SimOracle(seed=0)).place(task))


@pytest.mark.parametrize("hottest", [1, 2, 3])
def test_sharding_placer_split_hottest(raw8, hottest):
    """``test_sharding.py::test_sharding_placer_split_hottest``."""
    task = Task.of(raw8, 4)
    placement = ShardingPlacer(SimOracle(seed=0), config=ShardingConfig(
        split_hottest=hottest)).place(task)
    _same_placement(placement, JShardingPlacer(
        japi.SimOracle(seed=0),
        config=JShardingConfig(split_hottest=hottest)).place(task))
    traffic = raw8[:, F.DIM] * raw8[:, F.POOLING]
    hot = np.argsort(-traffic, kind="stable")[:hottest]
    assert placement.is_sharded
    assert (placement.sharding.shard_counts[hot] >= 2).all()


def test_sharding_placer_with_refine(infeasible_task):
    """``ShardingConfig(refine=)``: the packed placement refined by shard
    moves, as the reference refines it."""
    kw = dict(strategy="evolution", budget_ms=None, max_evals=64, seed=4)
    placement = ShardingPlacer(SimOracle(seed=0), config=ShardingConfig(
        refine=SearchConfig(**kw))).place(infeasible_task)
    _same_placement(placement, JShardingPlacer(
        japi.SimOracle(seed=0), config=JShardingConfig(
            refine=JSearchConfig(**kw))).place(infeasible_task))


@pytest.mark.parametrize("strategy,split_rounds,max_evals", [
    ("lns", 1, 150), ("lns", 2, 96), ("evolution", 2, 120)])
def test_refine_sharded_improves_or_keeps(infeasible_task, strategy,
                                          split_rounds, max_evals):
    """``test_sharding.py::test_refine_sharded_improves_or_keeps``, the
    refined placement the reference's."""
    task = infeasible_task
    oracle = SimOracle(seed=0)
    seed = ShardingPlacer(oracle).place(task)
    kw = dict(strategy=strategy, budget_ms=None, max_evals=max_evals, seed=7)
    refined = refine_sharded(oracle, task, seed, SearchConfig(**kw),
                             split_rounds=split_rounds)
    joracle = japi.SimOracle(seed=0)
    jrefined = j_refine_sharded(joracle, task,
                                JShardingPlacer(joracle).place(task),
                                JSearchConfig(**kw), split_rounds=split_rounds)
    _same_placement(refined, jrefined)
    assert refined.is_sharded
    assert bool(legal_sharded(oracle, task.raw_features, refined.sharding,
                              refined.shard_assignment[None], 4)[0])
    assert refined.est_cost_ms <= seed.est_cost_ms


def test_refine_sharded_upgrades_a_whole_table_seed(raw8):
    """A whole-table seed enters ``refine_sharded`` as the trivial spec."""
    task = Task.of(raw8, 4)
    kw = dict(strategy="lns", budget_ms=None, max_evals=80, seed=1)
    oracle, joracle = SimOracle(seed=0), japi.SimOracle(seed=0)
    seed = api.ExpertPlacer(oracle, "size").place(task)
    refined = refine_sharded(oracle, task, seed, SearchConfig(**kw))
    jrefined = j_refine_sharded(
        joracle, task, japi.ExpertPlacer(joracle, "size").place(task),
        JSearchConfig(**kw))
    _same_placement(refined, jrefined)
    assert refined.is_sharded


def test_sharding_config_rejects_beam_refine():
    """``test_sharding.py::test_sharding_config_rejects_beam_refine``."""
    with pytest.raises(ValueError, match="beam"):
        ShardingConfig(refine=SearchConfig(strategy="beam"))
    with pytest.raises(ValueError, match="headroom"):
        ShardingConfig(headroom=0.0)


def test_beam_refuses_sharded_placement(raw8):
    """``test_sharding.py::test_beam_refuses_sharded_placement``."""
    oracle = SimOracle(seed=0)
    task = Task.of(raw8, 4)
    spec = ShardSpec.even(raw8, 2)
    seed = SearchPlacer(oracle)._wrap(task, np.zeros(spec.n_shards, np.int64),
                                      sharding=spec)
    beam = SearchPlacer(oracle, config=SearchConfig(strategy="beam"),
                        agent=object())
    with pytest.raises(ValueError, match="whole-table"):
        beam.refine(task, seed)


def test_measure_placements_groups_sharded(raw8, mixed_spec):
    """``test_sharding.py::test_measure_placements_groups_sharded``."""
    oracle = SimOracle(seed=0)
    task = Task.of(raw8, 4)
    placer = SearchPlacer(oracle)
    whole = placer._wrap(task, np.arange(8) % 4)
    shard = placer._wrap(task, np.arange(mixed_spec.n_shards) % 4,
                         sharding=mixed_spec)
    costs = measure_placements(oracle, [task, task, task],
                               [whole, shard, whole])
    single_w = evaluate_many(oracle, raw8,
                             (np.arange(8) % 4)[None], 4)[0].overall
    single_s = evaluate_sharded(
        oracle, raw8, mixed_spec,
        (np.arange(mixed_spec.n_shards) % 4)[None], 4)[0].overall
    np.testing.assert_array_equal(costs, [single_w, single_s, single_w])
    assert oracle.num_evaluations == 5      # 2 rows grouped, 1, then 2 more


def test_dlrm_refuses_a_column_sharded_plan(raw8, mixed_spec):
    """The reference's DLRM drops column shards (``grouped_index_order``);
    the port's says so instead of mis-shaping its interaction."""
    from repro_torch.configs.dlrm import SMOKE
    from repro_torch.models.dlrm import DLRM
    plan = build_plan(raw8, np.arange(mixed_spec.n_shards) % 4, 4,
                      sharding=mixed_spec)
    with pytest.raises(ValueError, match="whole-table"):
        DLRM(dataclasses.replace(SMOKE, n_tables=8), plan, device="cpu")


# ---- telemetry ----------------------------------------------------------------


def test_sharded_telemetry_counters(raw8, mixed_spec):
    """``test_sharding.py::test_sharded_telemetry_counters``: the port
    counts what the reference counts, under the same names."""
    A = np.stack([np.arange(mixed_spec.n_shards) % 4] * 2)
    snaps = []
    for t, run in ((tele, lambda: evaluate_sharded(
            CachedOracle(SimOracle(seed=0)), raw8, mixed_spec, A, 4)),
                   (jtele, lambda: japi.evaluate_sharded(
                       japi.CachedOracle(japi.SimOracle(seed=0)), raw8,
                       JShardSpec.even(raw8, MIXED_K), A, 4))):
        t.reset()
        t.enable()
        try:
            run()
            snap = t.snapshot()
        finally:
            t.reset()
            t.disable()
        snaps.append((snap["counters"],
                      {k: v["count"] for k, v in snap["spans"].items()}))
    assert snaps[0] == snaps[1]
    counters = snaps[0][0]
    assert counters["oracle.cache.batched_calls"] == 1
    assert counters["oracle.cache.misses"] == 1
    assert counters["oracle.cache.hits"] == 1
    assert counters["oracle.sim.evaluate_sharded_calls"] == 1
