"""The port stands alone: it imports neither ``jax`` nor the JAX package
``repro``, and its entry points do not fall back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PORT_FILES)


def _imported_names(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_modules_found():
    assert "repro_torch.core.rollout" in MODULES
    assert "repro_torch.kernels.embedding_bag.ops" in MODULES
    assert "repro_torch.kernels.flash_attention.ops" in MODULES
    assert "repro_torch.launch.serve" in MODULES
    assert "repro_torch.optim.optimizers" in MODULES
    assert "repro_torch.core.replay" in MODULES
    assert "repro_torch.profiling.calibration" in MODULES
    for m in ("configs.dlrm", "data.pipeline", "embedding.sharded",
              "models.dlrm", "launch.train_dlrm", "profiling.collectives",
              "core.mdp", "search", "search.scoring", "search.strategies",
              "search.placer", "sharding", "sharding.spec",
              "sharding.placer", "serve", "serve.cache", "serve.drift",
              "serve.errors", "serve.faults", "serve.ledger",
              "serve.service", "data.traffic", "telemetry.sinks",
              "telemetry.report", "launch.serve_workflow",
              "core.rnn_policy", "launch.train", "configs.qwen2p5_14b",
              "configs.phi4_mini_3p8b", "configs.granite_34b",
              "configs.hymba_1p5b", "configs.rwkv6_1p6b", "models.ssm",
              "kernels.selective_scan.ops", "kernels.selective_scan.kernel",
              "kernels.selective_scan.ref", "kernels.wkv6.ops",
              "kernels.wkv6.kernel", "kernels.wkv6.ref",
              "models.sharding", "launch.mesh"):
        assert f"repro_torch.{m}" in MODULES
    assert len(MODULES) >= 30


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    bad = [n for n in _imported_names(path) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_resolve_device():
    from repro_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def _dreamshard(**kw):
    from repro_torch.api import SimOracle
    from repro_torch.core.trainer import DreamShard
    from repro_torch.data.synthetic import make_pool
    from repro_torch.data.tasks import make_benchmark_suite
    train, _ = make_benchmark_suite(make_pool(16, seed=0), 4, 2, n_tasks=1)
    return DreamShard(train, SimOracle(seed=0), **kw)


def _rnn_placer(**kw):
    from repro_torch.api import SimOracle
    from repro_torch.core.rnn_policy import RNNPlacer
    from repro_torch.data.synthetic import make_pool
    from repro_torch.data.tasks import make_benchmark_suite
    train, _ = make_benchmark_suite(make_pool(16, seed=0), 4, 2, n_tasks=1)
    return RNNPlacer(train, SimOracle(seed=0), **kw)


def _measure_placement(**kw):
    from repro_torch.data.synthetic import make_pool
    from repro_torch.profiling.microbench import measure_placement
    raw = make_pool(4, seed=0)
    return measure_placement(raw, np.array([0, 1, 0, 1]), 2, batch_size=4,
                             max_rows=64, **kw)


def _small_pool(n):
    from repro_torch.core import features as F
    from repro_torch.data.synthetic import make_pool
    raw = make_pool(n, seed=0)
    raw[:, F.HASH_SIZE] = 64
    return raw


def _train_dlrm(**kw):
    import argparse
    from repro_torch.api import RandomPlacer, SimOracle
    from repro_torch.data.tasks import Task
    from repro_torch.launch.train_dlrm import train_with_placement
    task = Task.of(_small_pool(4), 2)
    oracle = SimOracle(seed=0)
    args = argparse.Namespace(steps=1, batch=4, device=kw.get("device"))
    return train_with_placement("random", task,
                                RandomPlacer(oracle, seed=0).place(task),
                                args, oracle)


def _dlrm(**kw):
    from repro_torch.configs.dlrm import SMOKE
    from repro_torch.embedding.plan import build_plan
    from repro_torch.models.dlrm import DLRM
    return DLRM(SMOKE, build_plan(_small_pool(8), np.arange(8) % 2, 2), **kw)


def _with_process_group(world: int, make, **kw):
    """``make(**kw)`` under a process group of ``world`` ranks (torch's
    fake one: it runs no collective) when given the CPU; without a device
    ``make`` must raise before it needs one."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if kw.get("device") != "cpu":
        return make(**kw)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = make(**kw)
        assert mesh.device_type == "cpu" and mesh.size() == world
    finally:
        dist.destroy_process_group()


def _entry(name):
    from repro_torch.api import KernelOracle
    from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                         production_rules)
    from repro_torch.configs import get_smoke
    from repro_torch.core.replay import ReplayBuffer
    from repro_torch.launch.serve import serve
    from repro_torch.launch.serve_workflow import run as serve_workflow
    from repro_torch.profiling.collectives import calibrate_comm
    from repro_torch.launch.steps import build_model
    from repro_torch.models.transformer import LM
    from repro_torch.profiling import microbench as mb
    cfg = get_smoke("h2o-danube-1.8b").resolve(1)
    return {
        "DreamShard": _dreamshard,
        "RNNPlacer": _rnn_placer,
        "measure_placement": _measure_placement,
        "make_inputs": lambda **kw: mb.make_inputs(128, 10, 4, 2, **kw),
        "make_fused_inputs": lambda **kw: mb.make_fused_inputs(
            [16, 16], [10, 20], 4, [2, 3], **kw),
        "bench_shape": lambda **kw: mb.bench_shape(16, 10, 4, 2, repeats=1,
                                                   **kw),
        "bench_fused_shape": lambda **kw: mb.bench_fused_shape(
            [16], [10], 4, [2], repeats=1, **kw),
        "KernelOracle": lambda **kw: KernelOracle(**kw),
        "ReplayBuffer": lambda **kw: ReplayBuffer(2, 3, 2, **kw),
        "calibrate_comm": lambda **kw: calibrate_comm(**kw),
        "build_model": lambda **kw: build_model(cfg, **kw),
        "build_model(rules=...)": lambda **kw: build_model(
            get_smoke("h2o-danube-1.8b").resolve(2),
            rules=production_rules(), **kw),
        "make_mesh": lambda **kw: _with_process_group(
            4, make_mesh, shape=(2, 2), axes=("data", "model"), **kw),
        "make_production_mesh": lambda **kw: _with_process_group(
            256, make_production_mesh, **kw),
        "LM.init_params": lambda **kw: LM(cfg, **kw).init_params(0),
        "serve": lambda **kw: serve(batch=1, prompt_len=4, tokens=2, **kw),
        "train_with_placement": _train_dlrm,
        "DLRM": _dlrm,
        # the smallest sizes that still train, serve (ten recurring jobs
        # fill an admission batch, so later requests hit the cache) and
        # print: the example's own sizes take minutes on the CPU
        "serve_workflow": lambda **kw: serve_workflow(
            n_train_tasks=2, n_iterations=1, n_collect=1, n_cost=1,
            n_batch=2, n_rl=1, n_episode=1, candidates=1, n_jobs=10,
            n_tables=8, n_requests=100, tail_jobs=1, **kw),
    }[name]


@pytest.mark.parametrize("name", ["DreamShard", "measure_placement",
                                  "make_inputs", "make_fused_inputs",
                                  "bench_shape", "bench_fused_shape",
                                  "KernelOracle", "ReplayBuffer",
                                  "calibrate_comm", "build_model",
                                  "build_model(rules=...)", "make_mesh",
                                  "make_production_mesh",
                                  "LM.init_params", "serve",
                                  "train_with_placement", "DLRM",
                                  "serve_workflow", "RNNPlacer"])
def test_entry_points_raise_without_a_card_unless_given_cpu(name):
    entry = _entry(name)
    entry(device="cpu")                        # runs on the CPU when asked
    if torch.cuda.is_available():
        return                                 # the default is the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    with pytest.raises(ValueError, match="CUDA tensors only"):
        embedding_bag_cuda(torch.zeros((4, 128)),
                           torch.zeros((2, 2), dtype=torch.int32))
    q = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention_cuda(q, q, q)
