"""The port's search (``repro_torch.search``) against ``repro.search``.

lns and evolution are host numpy drawing from the same
``np.random.default_rng([seed, placement_digest])`` stream, so over
``SimOracle`` they must return the reference's assignments, costs,
``evals`` and ``hardware_evals`` bitwise, on the grids of
``tests/test_search.py`` (each case names the reference test it
mirrors).  Beam scores partial placements with the cost network, so it is
held with converted weights: a tiny JAX agent, trained and saved, is
restored into the port; beam must score the same leaves and return the
same placement, and the leaves' cost-net estimates agree within 1e-5
relative.  Every search here is bounded by ``max_evals`` (``budget_ms=
None``): a wall-clock budget would make the comparison depend on timing.
"""

import numpy as np
import pytest
import torch

from repro import telemetry as jtele
from repro.api import CachedOracle as JCachedOracle
from repro.api import DreamShardPlacer as JDreamShardPlacer
from repro.api import PlacementSession as JPlacementSession
from repro.api import SimOracle as JSimOracle
from repro.api import make_baseline_placers as j_make_baseline_placers
from repro.core import networks as JN
from repro.core import rollout as JR
from repro.core.trainer import DreamShard as JDreamShard
from repro.core.trainer import DreamShardConfig as JConfig
from repro.data.tasks import sample_tasks as j_sample_tasks
from repro.data.tasks import split_pool as j_split_pool
from repro.search import SearchConfig as JSearchConfig
from repro.search import SearchPlacer as JSearchPlacer
from repro.search import SearchScorer as JSearchScorer
from repro.sim.costsim import CostSimulator as JSim
from repro_torch import telemetry as tele
from repro_torch.api import (CachedOracle, DreamShardPlacer,
                             PlacementSession, SearchConfig, SearchPlacer,
                             SearchScorer, SimOracle, make_baseline_placers)
from repro_torch.core import features as F
from repro_torch.core import networks as N
from repro_torch.core import rollout as R
from repro_torch.core.trainer import DreamShard
from repro_torch.data.tasks import Task, sample_tasks, split_pool


def _tasks(pool, n_tables, n_devices, n_tasks, seed):
    """The reference test's ``_tasks``, drawn by each package."""
    _, ids = split_pool(pool, seed=0)
    _, jids = j_split_pool(pool, seed=0)
    mine = sample_tasks(pool, ids, n_tables, n_devices, n_tasks, seed=seed)
    ref = j_sample_tasks(pool, jids, n_tables, n_devices, n_tasks, seed=seed)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.raw_features, b.raw_features)
    return mine, ref


def _cost(task, assignment):
    return JSim(seed=0).evaluate(task.raw_features, assignment,
                                 task.n_devices).overall


def _same(p, jp):
    """A port placement and the reference's, field for field."""
    np.testing.assert_array_equal(p.assignment, jp.assignment)
    assert p.est_cost_ms == jp.est_cost_ms
    assert (p.strategy, p.candidates, p.oracle_evals, p.n_devices) == \
        (jp.strategy, jp.candidates, jp.oracle_evals, jp.n_devices)
    np.testing.assert_array_equal(p.plan.base_rows, jp.plan.base_rows)
    np.testing.assert_array_equal(p.plan.slot_table, jp.plan.slot_table)


def _same_scorer(s, js):
    assert (s.evals, s.batches, s.hardware_evals) == \
        (js.evals, js.batches, js.hardware_evals)
    assert s._seen == js._seen


def _search_pair(oracles, seed_placers=(None, None), **cfg):
    cfg.setdefault("budget_ms", None)
    return (SearchPlacer(oracles[0], seed_placer=seed_placers[0],
                         config=SearchConfig(**cfg)),
            JSearchPlacer(oracles[1], seed_placer=seed_placers[1],
                          config=JSearchConfig(**cfg)))


GRID = [dict(strategy=s, n_tables=m, n_devices=d, task_seed=ts, cfg_seed=cs)
        for s in ("lns", "evolution")
        for m, d, ts, cs in ((6, 2, 3, 0), (10, 4, 17, 5), (14, 4, 42, 9))]


@pytest.mark.parametrize("case", GRID, ids=lambda c: "-".join(
    str(v) for v in c.values()))
def test_refined_never_worse_than_seed(dlrm_pool, case):
    """``test_search.py::test_refined_never_worse_than_seed``'s grid, each
    run bitwise the reference's."""
    (task,), (jtask,) = _tasks(dlrm_pool, case["n_tables"],
                               case["n_devices"], 1, case["task_seed"])
    oracles = (SimOracle(seed=0), JSimOracle(seed=0))
    seeds = (make_baseline_placers(oracles[0])["size_lookup"],
             j_make_baseline_placers(oracles[1])["size_lookup"])
    sp, jsp = _search_pair(oracles, seeds, strategy=case["strategy"],
                           max_evals=48, seed=case["cfg_seed"])
    refined, jrefined = sp.place(task), jsp.place(jtask)
    _same(refined, jrefined)
    _same_scorer(sp.last_scorer, jsp.last_scorer)
    assert oracles[0].num_evaluations == oracles[1].num_evaluations
    assert _cost(task, refined.assignment) <= \
        _cost(task, seeds[0].place(task).assignment)


@pytest.mark.parametrize("strategy,cfg_seed", [
    (s, cs) for s in ("lns", "evolution") for cs in (0, 23)])
def test_legality_preserved_under_tight_capacity(dlrm_pool, strategy,
                                                 cfg_seed):
    """``test_search.py::test_legality_preserved_under_tight_capacity``."""
    raw = np.array(dlrm_pool[:8])
    raw[:, F.TABLE_SIZE_GB] = 5.0        # 40 GB on 4 x 11 GB: tight
    task = Task.of(raw, 4)
    sp, jsp = _search_pair((SimOracle(seed=0), JSimOracle(seed=0)),
                           strategy=strategy, max_evals=64, seed=cfg_seed)
    refined = sp.place(task)
    _same(refined, jsp.place(task))
    sizes = np.bincount(refined.assignment, weights=raw[:, F.TABLE_SIZE_GB],
                        minlength=4)
    assert (sizes <= sp.oracle.mem_capacity_gb).all()


@pytest.mark.parametrize("strategy,task_seed,cfg_seed", [
    (s, ts, cs) for s in ("lns", "evolution") for ts, cs in ((2, 0), (19, 7))])
def test_anytime_monotonicity(dlrm_pool, strategy, task_seed, cfg_seed):
    """``test_search.py::test_anytime_monotonicity``: the budgets' costs
    are the reference's, and never rise with the budget."""
    (task,), (jtask,) = _tasks(dlrm_pool, 10, 4, 1, task_seed)
    costs, jcosts = [], []
    for max_evals in (0, 4, 16, 64):
        sp, jsp = _search_pair((SimOracle(seed=0), JSimOracle(seed=0)),
                               strategy=strategy, max_evals=max_evals,
                               seed=cfg_seed)
        costs.append(_cost(task, sp.place(task).assignment))
        jcosts.append(_cost(task, jsp.place(jtask).assignment))
    assert costs == jcosts
    assert all(b <= a for a, b in zip(costs, costs[1:]))


@pytest.mark.parametrize("zero,n_tables,task_seed", [
    (z, m, ts) for z in ("budget_ms", "max_evals")
    for m, ts in ((5, 1), (12, 31))])
def test_zero_budget_returns_seed_bitwise(dlrm_pool, zero, n_tables,
                                          task_seed):
    """``test_search.py::test_zero_budget_returns_seed_bitwise``: the
    seed's own assignment array and plan object come back, with no
    oracle evaluation."""
    (task,), _ = _tasks(dlrm_pool, n_tables, 4, 1, task_seed)
    oracle = SimOracle(seed=0)
    seed = make_baseline_placers(oracle)["size"].place(task)
    kw = ({"max_evals": 0, "budget_ms": None} if zero == "max_evals"
          else {"budget_ms": 0.0})
    sp = SearchPlacer(oracle, config=SearchConfig(**kw))
    refined = sp.refine(task, seed)
    assert refined.assignment is seed.assignment
    assert refined.plan is seed.plan
    assert oracle.num_evaluations == 0
    assert refined.strategy == sp.name == "search[lns](expert)"


def test_refine_is_deterministic(dlrm_pool):
    """``test_search.py::test_refine_is_deterministic``, and the
    reference's result."""
    (task,), (jtask,) = _tasks(dlrm_pool, 12, 4, 1, 9)
    out = []
    for _ in range(2):
        sp, jsp = _search_pair((SimOracle(seed=0), JSimOracle(seed=0)),
                               strategy="lns+evolution", max_evals=96,
                               seed=3)
        out.append(sp.place(task))
        _same(out[-1], jsp.place(jtask))
    np.testing.assert_array_equal(out[0].assignment, out[1].assignment)


def test_single_device_returns_seed(dlrm_pool):
    """``test_search.py::test_single_device_returns_seed``."""
    (task,), _ = _tasks(dlrm_pool, 6, 1, 1, 0)
    oracle = SimOracle(seed=0)
    sp = SearchPlacer(oracle, config=SearchConfig(budget_ms=None,
                                                  max_evals=32))
    assert (sp.place(task).assignment == 0).all()
    assert oracle.num_evaluations == 0


@pytest.mark.parametrize("strategy,match", [("anneal", "unknown search"),
                                            ("beam", "beam"), ("", "no stages")])
def test_config_validation(strategy, match):
    """``test_search.py::test_config_validation``."""
    with pytest.raises(ValueError, match=match):
        SearchPlacer(SimOracle(seed=0),
                     config=SearchConfig(strategy=strategy))


# ---- scorer -------------------------------------------------------------------


def test_scorer_caps_rows_and_dedups(dlrm_pool, rng):
    """``test_search.py::test_scorer_caps_rows_and_dedups``, the costs
    the reference's."""
    (task,), (jtask,) = _tasks(dlrm_pool, 8, 4, 1, 2)
    scorer = SearchScorer(SimOracle(seed=0), task, max_evals=5)
    jscorer = JSearchScorer(JSimOracle(seed=0), jtask, max_evals=5)
    A = rng.integers(0, 4, size=(8, 8))
    kept = scorer.filter_new(A)
    np.testing.assert_array_equal(kept, jscorer.filter_new(A))
    assert scorer.filter_new(kept).shape[0] == 0        # all seen now
    costs, results = scorer.score(A)
    jcosts, _ = jscorer.score(A)
    np.testing.assert_array_equal(costs, jcosts)
    assert np.isfinite(costs[:5]).all() and np.isinf(costs[5:]).all()
    assert results[5] is None
    assert scorer.evals == 5 and scorer.out_of_budget()
    assert scorer.remaining_evals() == 0


@pytest.mark.parametrize("strategy", ["lns", "evolution", "lns+evolution"])
def test_hardware_evals_exact_per_strategy(dlrm_pool, strategy):
    """``test_search.py::test_hardware_evals_exact_per_strategy``."""
    (task,), (jtask,) = _tasks(dlrm_pool, 10, 4, 1, 6)
    oracles = (SimOracle(seed=0), JSimOracle(seed=0))
    sp, jsp = _search_pair(oracles, strategy=strategy, max_evals=48, seed=0)
    _same(sp.place(task), jsp.place(jtask))
    scorer = sp.last_scorer
    _same_scorer(scorer, jsp.last_scorer)
    assert scorer.hardware_evals == oracles[0].num_evaluations
    assert scorer.hardware_evals == scorer.evals
    assert 0 < scorer.evals <= 48


def test_hardware_evals_ignore_foreign_traffic(dlrm_pool, rng):
    """``test_search.py::test_hardware_evals_ignore_foreign_traffic``."""
    (task,), _ = _tasks(dlrm_pool, 8, 4, 1, 7)
    oracle = SimOracle(seed=0)
    scorer = SearchScorer(oracle, task, max_evals=16)
    oracle.evaluate_many(task.raw_features,
                         rng.integers(0, 4, size=(5, 8)), 4)
    A = scorer.filter_new(rng.integers(0, 4, size=(4, 8)))
    scorer.score(A)
    assert scorer.hardware_evals == A.shape[0]   # 5 foreign rows excluded
    assert oracle.num_evaluations == 5 + A.shape[0]


def test_search_cache_locality(dlrm_pool):
    """``test_search.py::test_search_cache_locality``: the same hit and
    miss counts as the reference's cache."""
    (task,), (jtask,) = _tasks(dlrm_pool, 10, 4, 1, 4)
    oracles = (CachedOracle(SimOracle(seed=0)),
               JCachedOracle(JSim(seed=0)))
    for _ in range(2):
        sp, jsp = _search_pair(oracles, strategy="lns", max_evals=64,
                               seed=0)
        _same(sp.place(task), jsp.place(jtask))
    ours, ref = oracles
    assert (ours.batch_hits, ours.batch_misses) == \
        (ref.batch_hits, ref.batch_misses)
    assert ours.batch_hits / (ours.batch_hits + ours.batch_misses) >= 0.45
    assert sp.last_scorer.hardware_evals == 0


@pytest.fixture()
def both_telemetry():
    for t in (tele, jtele):
        t.reset()
        t.enable()
    yield
    for t in (tele, jtele):
        t.reset()
        t.disable()


def _tele_view(t):
    snap = t.snapshot()
    names = ("search.refine", "search.round", "search.score",
             "search.beam_expand", "oracle.sim.evaluate_many")
    return ({k: v for k, v in snap["counters"].items()
             if k != "jit.retraces"},
            {k: snap["spans"][k]["count"] for k in names
             if k in snap["spans"]})


def test_search_telemetry_matches_the_reference(dlrm_pool, both_telemetry):
    """``test_search.py::test_search_never_calls_single_evaluate``: one
    ``evaluate_many`` per scored round, no single ``evaluate``; the port's
    spans and counters are the reference's, name for name and count for
    count."""
    (task,), (jtask,) = _tasks(dlrm_pool, 10, 4, 1, 5)
    sp, jsp = _search_pair((SimOracle(seed=0), JSimOracle(seed=0)),
                           strategy="lns+evolution", max_evals=128, seed=0)
    sp.place(task)
    jsp.place(jtask)
    counters, spans = _tele_view(tele)
    assert (counters, spans) == _tele_view(jtele)
    assert counters.get("oracle.sim.evaluate_calls", 0) == 0
    assert 1 <= counters["oracle.sim.evaluate_many_calls"] == \
        sp.last_scorer.batches == spans["search.score"]
    assert counters["search.scored_rows"] == sp.last_scorer.evals


# ---- beam and the session, with a converted JAX agent ----------------------------


@pytest.fixture(scope="module")
def agents(dlrm_pool, tmp_path_factory):
    """A tiny JAX DreamShard (``test_search.py``'s ``tiny_agent`` budget,
    greedy decode), saved and restored into the port."""
    _, jtrain = _tasks(dlrm_pool, 10, 4, 4, 11)
    jagent = JDreamShard(jtrain, JSim(seed=0), JConfig(
        n_iterations=1, n_collect=4, n_cost=20, n_batch=16, n_rl=2,
        n_episode=4, inference_candidates=1))
    jagent.train()
    path = str(tmp_path_factory.mktemp("tiny_agent"))
    jagent.save(path)
    train, _ = _tasks(dlrm_pool, 10, 4, 4, 11)
    agent = DreamShard(train, SimOracle(seed=0), device="cpu")
    agent.restore(path)
    return agent, jagent


def _leaf_estimates(agent, raw, leaves):
    """Each full leaf's cost-net estimate, its device sums accumulated in
    the beam's table order, with the port's networks."""
    feats, _, order = agent._inference_inputs(raw)
    with torch.no_grad():
        h = N.cost_table_reprs(agent.cost_net,
                               torch.as_tensor(feats[order])).numpy()
    dev = _device_sums(h, leaves[:, order], agent)
    with torch.no_grad():
        return R.estimate_overall(agent.cost_net, torch.as_tensor(dev),
                                  agent.cfg.reward_mode,
                                  agent._log_targets).numpy()


def _j_leaf_estimates(jagent, raw, leaves):
    import jax.numpy as jnp
    feats, _, order = jagent._inference_inputs(raw)
    h = np.asarray(JN.cost_table_reprs(jagent.cost_params,
                                       jnp.asarray(feats[order])), np.float32)
    dev = _device_sums(h, leaves[:, order], jagent)
    return np.asarray(JR.estimate_overall(
        jagent.cost_params, jnp.asarray(dev), jagent.cfg.reward_mode,
        jagent._log_targets))


def _device_sums(h, sorted_leaves, agent):
    D = 4
    dev = np.zeros((sorted_leaves.shape[0], D, h.shape[1]), np.float32)
    rows = np.arange(sorted_leaves.shape[0])
    for t in range(sorted_leaves.shape[1]):
        dev[rows, sorted_leaves[:, t]] += h[t]
    return dev


@pytest.mark.parametrize("strategy", ["beam", "beam+lns"])
def test_beam_matches_the_reference_with_converted_weights(dlrm_pool, agents,
                                                           strategy):
    """``test_search.py::test_beam_refines_and_respects_budget`` with the
    reference's weights: per task the same seed, the same scored leaves
    (the scorer's seen set), the same refined placement and budget; the
    leaves' estimates within 1e-5 relative; never worse than the seed."""
    agent, jagent = agents
    tasks, jtasks = _tasks(dlrm_pool, 10, 4, 3, 21)
    oracles = (SimOracle(seed=0), JSimOracle(seed=0))
    ds, jds = agent.as_placer(), jagent.as_placer()
    cfg = dict(strategy=strategy, budget_ms=None, max_evals=32, seed=1)
    sp = SearchPlacer(oracles[0], seed_placer=ds, agent=agent,
                      config=SearchConfig(**cfg))
    jsp = JSearchPlacer(oracles[1], seed_placer=jds, agent=jagent,
                        config=JSearchConfig(**cfg))
    for t, jt, seed, jseed in zip(tasks, jtasks, ds.place_many(tasks),
                                  jds.place_many(jtasks)):
        np.testing.assert_array_equal(seed.assignment, jseed.assignment)
        refined, jrefined = sp.refine(t, seed), jsp.refine(jt, jseed)
        _same(refined, jrefined)
        _same_scorer(sp.last_scorer, jsp.last_scorer)
        assert sp.last_scorer.evals <= 32
        assert _cost(t, refined.assignment) <= _cost(t, seed.assignment)
        leaves = np.stack([np.frombuffer(k, np.int64)
                           for k in sorted(sp.last_scorer._seen)])
        np.testing.assert_allclose(
            _leaf_estimates(agent, t.raw_features, leaves),
            _j_leaf_estimates(jagent, jt.raw_features, leaves), rtol=1e-5)


def test_session_refiner_pass(dlrm_pool, agents):
    """``test_search.py::test_session_refiner_pass``, against the
    reference's session with the same weights: the refined placements,
    their provenance and ``place_and_measure``'s costs."""
    agent, jagent = agents
    tasks, jtasks = _tasks(dlrm_pool, 10, 4, 4, 13)
    cfg = dict(strategy="lns", budget_ms=None, max_evals=32, seed=0)
    refiner = SearchPlacer(SimOracle(seed=0), config=SearchConfig(**cfg))
    jrefiner = JSearchPlacer(JSimOracle(seed=0), config=JSearchConfig(**cfg))
    plain = PlacementSession(agent).place_many(tasks)
    session = PlacementSession(agent, refiner=refiner)
    refined, costs = session.place_and_measure(tasks, SimOracle(seed=0))
    jrefined, jcosts = JPlacementSession(
        jagent, refiner=jrefiner).place_and_measure(jtasks, JSimOracle(seed=0))
    np.testing.assert_array_equal(costs, jcosts)
    for t, p, r, jr in zip(tasks, plain, refined, jrefined):
        _same(r, jr)
        assert r.strategy == refiner.name
        assert _cost(t, r.assignment) <= _cost(t, p.assignment)


def test_dreamshard_placer_refiner(dlrm_pool, agents):
    """``DreamShardPlacer(refiner=)`` (``repro/api/placers.py:32-39``): its
    name and placements are the reference's."""
    agent, jagent = agents
    tasks, jtasks = _tasks(dlrm_pool, 10, 4, 2, 14)
    cfg = dict(strategy="evolution", budget_ms=None, max_evals=40, seed=2)
    placer = DreamShardPlacer(agent, refiner=SearchPlacer(
        SimOracle(seed=0), config=SearchConfig(**cfg)))
    jplacer = JDreamShardPlacer(jagent, refiner=JSearchPlacer(
        JSimOracle(seed=0), config=JSearchConfig(**cfg)))
    assert placer.name == jplacer.name == "dreamshard+search[evolution](expert)"
    for p, jp in zip(placer.place_many(tasks), jplacer.place_many(jtasks)):
        _same(p, jp)
    _same(placer.place(tasks[0]), jplacer.place(jtasks[0]))
