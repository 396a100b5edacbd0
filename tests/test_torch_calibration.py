"""The port's measured-cost stack against the JAX package's, on the CPU.

Everything here is numpy on both sides, so it is held bit for bit:
``CalibrationTable`` interpolation, the ``FusionModel`` / ``ShardModel`` /
alpha-beta fits, ``MeasuredOracle`` pricing (whole tables and shards),
``CachedOracle``'s hit and miss counts, the sweeps' shape and seed
streams, and the artifact format (either package's artifact loads in the
other and prices the same).  A small ``KernelOracle(device="cpu")``
calibration runs through K1's plain versions (the CUDA wrappers launch
nothing on CPU tensors).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.profiling import calibration as JC
from repro.profiling import collectives as JCO
from repro.profiling import microbench as JMB
from repro.sharding import ShardSpec
from repro_torch import api
from repro_torch.data.synthetic import make_prod_pool
from repro_torch.data.tasks import make_benchmark_suite
from repro_torch.profiling import calibration as C
from repro_torch.profiling import collectives as CO
from repro_torch.profiling import microbench as MB

ROOT = Path(__file__).resolve().parents[1]


def _grids(seed=0):
    rng = np.random.default_rng(seed)
    g = dict(dims=(128, 256, 768), rows=(64, 4096, 1 << 20),
             batches=(1024, 65536), poolings=(1, 4, 32))
    shape = tuple(len(v) for v in g.values())
    return g, rng.uniform(0.05, 5.0, shape), rng.uniform(0.2, 9.0, shape)


def _tables(seed=0):
    """The same measured-looking table in both packages, with fitted
    fusion and shard models."""
    g, fwd, bwd = _grids(seed)
    kw = dict(dims=np.asarray(g["dims"], float),
              rows=np.asarray(g["rows"], float),
              batches=np.asarray(g["batches"], float),
              poolings=np.asarray(g["poolings"], float),
              fwd_ms=fwd, bwd_ms=bwd,
              fingerprint={"device_kind": "test"}, meta={"seed": seed})
    fus = dict(overhead_ms=0.07, pipeline_coef=0.4, pipeline_cap=3.0,
               source="measured")
    sh = dict(overhead_ms=0.05, exponent=1.2, source="measured")
    port = C.CalibrationTable(comm=CO.CommModel(0.3, 0.02, 1), **kw,
                              fusion_fwd=C.FusionModel(**fus),
                              fusion_bwd=C.FusionModel(**fus),
                              shard_fwd=C.ShardModel(**sh),
                              shard_bwd=C.ShardModel(**sh))
    ref = JC.CalibrationTable(comm=JCO.CommModel(0.3, 0.02, 1), **kw,
                              fusion_fwd=JC.FusionModel(**fus),
                              fusion_bwd=JC.FusionModel(**fus),
                              shard_fwd=JC.ShardModel(**sh),
                              shard_bwd=JC.ShardModel(**sh))
    return port, ref


def _queries(n=500, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(16, 1000, n), np.exp(rng.uniform(2, 15, n)),
            rng.choice([512.0, 2048.0, 65536.0, 1e5], n),
            rng.uniform(0.5, 60, n))


def test_lookup_ms_is_the_reference_bitwise():
    port, ref = _tables()
    q = _queries()
    for a, b in zip(port.lookup_ms(*q), ref.lookup_ms(*q)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.fwd_lookup_ms(*q),
                                  ref.fwd_lookup_ms(*q))
    np.testing.assert_array_equal(port.comm_ms([0.0, 1.5, 40.0]),
                                  ref.comm_ms([0.0, 1.5, 40.0]))


def test_fits_are_the_reference_bitwise():
    rng = np.random.default_rng(2)
    singles = [rng.uniform(0.1, 3.0, k) for k in (2, 2, 4, 4, 8, 8)]
    fused = np.array([s.sum() * rng.uniform(0.4, 0.9) for s in singles])
    assert C.FusionModel.fit(singles, fused).to_dict() == \
        JC.FusionModel.fit(singles, fused).to_dict()
    full = rng.uniform(0.5, 4.0, 9)
    frac = rng.choice([0.25, 0.5, 0.75], 9)
    meas = full * frac + rng.uniform(0.05, 0.2, 9)
    assert C.ShardModel.fit(full, frac, meas).to_dict() == \
        JC.ShardModel.fit(full, frac, meas).to_dict()
    p = [0.25, 0.5, 1.0, 2.0, 4.0, 8.0]
    t = JCO.synthetic_trace(p, seed=4)
    np.testing.assert_array_equal(CO.synthetic_trace(p, seed=4), t)
    assert CO.fit_alpha_beta(p, t) == JCO.fit_alpha_beta(p, t)
    assert CO.calibrate_comm(device="cpu").to_dict() == \
        JCO.calibrate_comm(devices=[None]).to_dict()


def test_fusion_model_device_ms_is_the_reference_bitwise():
    rng = np.random.default_rng(3)
    per = rng.uniform(0.1, 2.0, 12)
    a = rng.integers(0, 4, (7, 12))
    m = C.FusionModel(0.1, 0.5, 2.0)
    np.testing.assert_array_equal(
        m.device_ms(per, a, 4), JC.FusionModel(0.1, 0.5, 2.0).device_ms(
            per, a, 4))


def test_synthetic_table_is_the_reference():
    port, ref = C.CalibrationTable.synthetic(), JC.CalibrationTable.synthetic()
    np.testing.assert_array_equal(port.fwd_ms, ref.fwd_ms)
    np.testing.assert_array_equal(port.bwd_ms, ref.bwd_ms)
    assert port.fusion_fwd.to_dict() == ref.fusion_fwd.to_dict()
    assert port.shard_bwd.to_dict() == ref.shard_bwd.to_dict()


@pytest.fixture(scope="module")
def tasks():
    pool = make_prod_pool(seed=1)
    train, _ = make_benchmark_suite(pool, 30, 4, n_tasks=3)
    return train


@pytest.mark.parametrize("fusion", [True, False])
def test_measured_oracle_evaluate_many_is_the_reference(tasks, fusion):
    port, ref = _tables()
    po = api.MeasuredOracle(port, batch_size=65536, fusion=fusion)
    ro = japi.MeasuredOracle(ref, batch_size=65536, fusion=fusion)
    rng = np.random.default_rng(5)
    for t in tasks:
        a = rng.integers(0, t.n_devices, (6, t.n_tables))
        for x, y in zip(po.evaluate_many(t.raw_features, a, t.n_devices),
                        ro.evaluate_many(t.raw_features, a, t.n_devices)):
            assert x.overall == y.overall
            np.testing.assert_array_equal(x.cost_features, y.cost_features)
            np.testing.assert_array_equal(x.fwd_comm, y.fwd_comm)
        one = po.evaluate(t.raw_features, a[0], t.n_devices)
        assert one.overall == ro.evaluate(t.raw_features, a[0],
                                          t.n_devices).overall
        np.testing.assert_array_equal(
            po.legal_batch(t.raw_features, a, t.n_devices),
            ro.legal_batch(t.raw_features, a, t.n_devices))
    assert po.num_evaluations == ro.num_evaluations == 21


def test_measured_oracle_prices_shards_as_the_reference(tasks):
    port, ref = _tables(seed=2)
    t = tasks[0]
    spec = ShardSpec.even(t.raw_features, np.where(
        np.arange(t.n_tables) % 3 == 0, 2, 1))
    a = np.random.default_rng(6).integers(0, 4, (5, spec.n_shards))
    got = api.MeasuredOracle(port).evaluate_sharded(t.raw_features, spec,
                                                    a, 4)
    want = japi.MeasuredOracle(ref).evaluate_sharded(t.raw_features, spec,
                                                     a, 4)
    for x, y in zip(got, want):
        assert x.overall == y.overall
        np.testing.assert_array_equal(x.cost_features, y.cost_features)


def test_sharded_helpers_wait_for_the_sharding_spec(tasks):
    """The sharded helpers no longer wait for the spec: over the
    reference's ``ShardSpec`` (duck-typed) they price and bound-check as
    the reference's do, bitwise, and a trivial spec gives the whole-table
    answers."""
    t = tasks[0]
    spec = ShardSpec.trivial(t.raw_features)
    a = np.random.default_rng(8).integers(0, 4, (3, t.n_tables))
    port, ref = _tables()
    oracle, joracle = api.MeasuredOracle(port), japi.MeasuredOracle(ref)
    for got, want in (
            (api.evaluate_sharded(oracle, t.raw_features, spec, a, 4),
             japi.evaluate_sharded(joracle, t.raw_features, spec, a, 4)),
            (api.CachedOracle(oracle).evaluate_sharded(
                t.raw_features, spec, a, 4),
             oracle.evaluate_many(t.raw_features, a, 4))):
        for x, y in zip(got, want, strict=True):
            assert x.overall == y.overall
            np.testing.assert_array_equal(x.cost_features, y.cost_features)
    for legal in (api.legal_sharded(oracle, t.raw_features, spec, a, 4),
                  oracle.legal_sharded(t.raw_features, spec, a, 4)):
        np.testing.assert_array_equal(
            legal, japi.legal_sharded(joracle, t.raw_features, spec, a, 4))
        np.testing.assert_array_equal(
            legal, oracle.legal_batch(t.raw_features, a, 4))
    with pytest.raises(ValueError, match=">= 2 ranks"):
        CO.measure_all_to_all([1.0])           # one rank: no process group


def test_artifacts_load_across_packages_and_price_alike(tasks, tmp_path):
    port, ref = _tables(seed=3)
    port.fusion_sweep = {"k": np.array([2.0, 4.0])}
    a = np.random.default_rng(7).integers(0, 4, (4, tasks[1].n_tables))
    raw = tasks[1].raw_features
    for table, loader in ((port, JC.CalibrationTable.load),
                          (ref, C.CalibrationTable.load)):
        path = table.save(str(tmp_path / f"{type(table).__module__}.npz"))
        other = loader(path)
        assert other.version == table.version == C.CALIBRATION_VERSION
        assert other.fingerprint == table.fingerprint
        same = (japi.MeasuredOracle(other) if loader is
                JC.CalibrationTable.load else api.MeasuredOracle(other))
        mine = (api.MeasuredOracle(table) if same.__class__ is
                japi.MeasuredOracle else japi.MeasuredOracle(table))
        for x, y in zip(same.evaluate_many(raw, a, 4),
                        mine.evaluate_many(raw, a, 4)):
            assert x.overall == y.overall
            np.testing.assert_array_equal(x.cost_features, y.cost_features)
    assert C.load_or_none(str(tmp_path / "missing.npz")) is None


def test_v1_artifact_falls_back_to_additive(tmp_path, save_v1_calibration):
    port, _ = _tables()
    save_v1_calibration(port, str(tmp_path / "v1.npz"))
    with pytest.warns(UserWarning) as seen:
        loaded = C.CalibrationTable.load(str(tmp_path / "v1.npz"))
    assert [("pre-fusion" in str(w.message), "pre-sharding" in
             str(w.message)) for w in seen] == [(True, False), (False, True)]
    assert loaded.fusion_fwd.is_additive and loaded.version == 1


def test_cached_oracle_counts_are_the_reference(tasks):
    port, ref = _tables(seed=4)
    po = api.CachedOracle(api.MeasuredOracle(port), max_entries=5)
    ro = japi.CachedOracle(japi.MeasuredOracle(ref), max_entries=5)
    rng = np.random.default_rng(8)
    t = tasks[2]
    for _ in range(6):
        a = rng.integers(0, 2, (4, t.n_tables))     # repeats within + across
        a[:, 2:] = 0
        got = po.evaluate_many(t.raw_features, a, 4)
        want = ro.evaluate_many(t.raw_features, a, 4)
        assert [x.overall for x in got] == [y.overall for y in want]
        assert po.evaluate(t.raw_features, a[0], 4).overall == \
            ro.evaluate(t.raw_features, a[0], 4).overall
    for k in ("hits", "misses", "evictions", "batched_calls", "batch_hits",
              "batch_misses", "last_batch", "num_evaluations"):
        assert getattr(po, k) == getattr(ro, k), k


def _recorded(monkeypatch, module, name):
    calls = []

    def fake(*args, **kw):
        calls.append((args, {k: v for k, v in kw.items()
                             if k in ("seed",)}))
        return calls[-1]
    monkeypatch.setattr(module, name, fake)
    return calls


def _norm(calls):
    return [(tuple(np.asarray(a).tolist() if not np.isscalar(a) else int(a)
                   for a in args), kw) for args, kw in calls]


def test_sweeps_draw_the_reference_shapes_and_seeds(monkeypatch):
    grid = (np.array([128, 256, 768]), np.array([64, 1 << 20]),
            np.array([1, 4, 32]))
    mine = _recorded(monkeypatch, MB, "bench_fused_shape")
    ref = _recorded(monkeypatch, JMB, "bench_fused_shape")
    MB.sweep_fused(*grid, 65536, ks=(2, 4), per_k=3, seed=7, device="cpu")
    JMB.sweep_fused(*grid, 65536, ks=(2, 4), per_k=3, seed=7)
    assert len(mine) == 6 and _norm(mine) == _norm(ref)
    points = {}
    for name, mod in (("port", MB), ("ref", JMB)):
        calls = []
        monkeypatch.setattr(mod, "bench_shape", lambda d, r, b, p, seed=0,
                            calls=calls, **kw: calls.append(
                                (d, r, b, p, seed)) or JMB.BenchPoint(
                                    int(np.ceil(d / 128) * 128), r, b, p,
                                    1.0, 2.0))
        kw = {"device": "cpu"} if mod is MB else {"use_pallas": True}
        out = mod.sweep_sharded(*grid, 65536, seed=3, **kw)
        points[name] = (calls, [(p.dim, p.width, p.frac) for p in out])
    assert points["port"] == points["ref"]
    assert len(points["port"][0]) == 18


@pytest.fixture
def plain_counts(monkeypatch):
    """Counts the plain versions' calls; the CUDA wrappers must not
    launch."""
    from repro_torch.kernels.embedding_bag import kernel as K
    from repro_torch.kernels.embedding_bag import ops
    counts = {"fwd": 0, "bwd": 0}
    f0, g0 = ops.embedding_bag_plain, ops.embedding_bag_grad_plain

    def fwd(*a):
        counts["fwd"] += 1
        return f0(*a)

    def bwd(*a):
        counts["bwd"] += 1
        return g0(*a)
    monkeypatch.setattr(ops, "embedding_bag_plain", fwd)
    monkeypatch.setattr(ops, "embedding_bag_grad_plain", bwd)
    K.embedding_bag_cuda.launches = K.embedding_bag_grad_cuda.launches = 0
    yield counts
    assert K.embedding_bag_cuda.launches == 0
    assert K.embedding_bag_grad_cuda.launches == 0


def test_small_kernel_oracle_calibrates_through_the_plain_versions(
        plain_counts, tasks):
    oracle = api.KernelOracle(batch_size=16, max_rows=256, max_dim=256,
                              device="cpu")
    assert plain_counts["fwd"] == 0              # calibration is lazy
    t = tasks[0]
    a = np.random.default_rng(9).integers(0, 4, (3, t.n_tables))
    assert oracle.legal_batch(t.raw_features, a, 4).shape == (3,)
    assert plain_counts["fwd"] == 0              # a memory probe is free
    res = oracle.evaluate_many(t.raw_features, a, 4)
    table = oracle.measured().table
    # 4 grid points, 6 fused and 9 x 2 sharded shapes, 1 + 2 calls each
    assert plain_counts == {"fwd": 84, "bwd": 84}
    assert table.dims.tolist() == [128.0, 256.0]
    assert table.rows.tolist() == [64.0, 256.0]
    assert table.meta["device"] == "cpu"
    assert table.fingerprint["n_devices"] == 1
    assert np.isfinite(table.fwd_ms).all() and (table.bwd_ms > 0).all()
    assert all(np.isfinite(r.overall) for r in res)
    assert oracle.num_evaluations == 3


def test_kernel_oracle_needs_a_card_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.KernelOracle()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.hardware_fingerprint()


def test_calibrate_cli_on_the_cpu(tmp_path):
    out = tmp_path / "art.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.profiling.calibrate",
           "--device", "cpu", "--smoke", "--dims", "128", "--rows",
           "64,512", "--batches", "8", "--poolings", "2", "--fused-ks",
           "2", "--fused-per-k", "1", "--shard-per-frac", "1", "--repeats",
           "1", "--out", str(out)]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "wrote" in proc.stdout
    table = JC.CalibrationTable.load(str(out))      # the reference loads it
    assert table.fwd_ms.shape == (1, 2, 1, 1)
    again = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=300)
    assert again.returncode == 0 and "up to date" in again.stdout
