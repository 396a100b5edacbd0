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
    assert len(MODULES) >= 25


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


def _measure_placement(**kw):
    from repro_torch.data.synthetic import make_pool
    from repro_torch.profiling.microbench import measure_placement
    raw = make_pool(4, seed=0)
    return measure_placement(raw, np.array([0, 1, 0, 1]), 2, batch_size=4,
                             max_rows=64, **kw)


def _entry(name):
    from repro_torch.profiling import microbench as mb
    return {
        "DreamShard": _dreamshard,
        "measure_placement": _measure_placement,
        "make_inputs": lambda **kw: mb.make_inputs(128, 10, 4, 2, **kw),
        "make_fused_inputs": lambda **kw: mb.make_fused_inputs(
            [16, 16], [10, 20], 4, [2, 3], **kw),
        "bench_shape": lambda **kw: mb.bench_shape(16, 10, 4, 2, repeats=1,
                                                   **kw),
        "bench_fused_shape": lambda **kw: mb.bench_fused_shape(
            [16], [10], 4, [2], repeats=1, **kw),
    }[name]


@pytest.mark.parametrize("name", ["DreamShard", "measure_placement",
                                  "make_inputs", "make_fused_inputs",
                                  "bench_shape", "bench_fused_shape"])
def test_entry_points_raise_without_a_card_unless_given_cpu(name):
    entry = _entry(name)
    entry(device="cpu")                        # runs on the CPU when asked
    if torch.cuda.is_available():
        return                                 # the default is the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
    with pytest.raises(ValueError, match="CUDA tensors only"):
        embedding_bag_cuda(torch.zeros((4, 128)),
                           torch.zeros((2, 2), dtype=torch.int32))
