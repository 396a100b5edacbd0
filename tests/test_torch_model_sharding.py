"""The port's sharding rules, meshes and partition specs against the JAX
package's, compared as tuples for exact equality.

``ShardingRules.spec`` over logical tuples (the default rules,
``production_rules`` "tp" and "fsdp", single- and multi-pod, and rules
with no batch axes), ``fsdp_dim``, ``for_batch``,
``batch_specs_partition`` for every arch and input shape, and
``LM.param_specs`` / ``LM.cache_specs`` for every arch's SMOKE and FULL
config at ``resolve(16)`` are pure functions of the config and the
rules.  ``make_production_mesh`` builds its 256- and 512-rank meshes in
a subprocess under torch's fake process group, which runs no
collective.
"""

import dataclasses
import os
import subprocess
import sys
import types

import pytest
import torch

from repro import configs as JC
from repro.configs import shapes as JS
from repro.launch import mesh as JM
from repro.models import sharding as JSH
from repro.models.transformer import LM as JaxLM
from repro_torch import configs as C
from repro_torch.configs import shapes as S
from repro_torch.launch import mesh as M
from repro_torch.models import sharding as SH
from repro_torch.models.transformer import LM

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

LOGICAL = [(), ("batch",), ("model",), (None,), ("batch", None),
           ("batch", "model", None), ("batch", None, "model"),
           ("batch", None, "model", None), (None, "batch", "model", None),
           (None, "batch", None, "model", None), ("model", "batch"),
           (None, None, None)]

RULES = {
    "default": (SH.ShardingRules(), JSH.ShardingRules()),
    "no sharding": (SH.NO_SHARDING, JSH.NO_SHARDING),
    "tp": (M.production_rules(), JM.production_rules()),
    "tp multi-pod": (M.production_rules(multi_pod=True),
                     JM.production_rules(multi_pod=True)),
    "fsdp": (M.production_rules(strategy="fsdp"),
             JM.production_rules(strategy="fsdp")),
    "fsdp multi-pod": (M.production_rules(multi_pod=True, strategy="fsdp"),
                       JM.production_rules(multi_pod=True, strategy="fsdp")),
    "no batch axes": (SH.ShardingRules(batch_axes=()),
                      JSH.ShardingRules(batch_axes=())),
}


def _plain(tree):
    """Specs (either package's) as plain nested tuples and dicts."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("name", list(RULES))
def test_rules_equal_the_reference(name):
    ours, ref = RULES[name]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for logical in LOGICAL:
        spec = ours.spec(*logical)
        assert isinstance(spec, tuple) and isinstance(spec, SH.P)
        assert tuple(spec) == tuple(ref.spec(*logical)), logical
    assert ours.fsdp_dim == ref.fsdp_dim


@pytest.mark.parametrize("name", [n for n in RULES if n != "no sharding"])
@pytest.mark.parametrize("global_batch", [1, 2, 16, 32, 128, 256, 512])
def test_for_batch_equals_the_reference(name, global_batch):
    ours, ref = RULES[name]
    axes = {"pod": 2, "data": 16, "model": 16}
    mesh = types.SimpleNamespace(shape=axes)
    assert dataclasses.asdict(ours.for_batch(global_batch, mesh)) == \
        dataclasses.asdict(ref.for_batch(global_batch, mesh))


def test_constrain_is_a_no_op_when_disabled():
    x = torch.ones(3)
    assert SH.NO_SHARDING.constrain(x, "batch") is x
    with pytest.raises(TypeError, match="DTensor"):
        SH.ShardingRules().constrain(x, "batch")


@pytest.mark.parametrize("arch", C.ARCH_NAMES)
@pytest.mark.parametrize("rules", ["tp", "fsdp multi-pod", "no batch axes"])
def test_batch_specs_partition_equals_the_reference(arch, rules):
    ours, ref = RULES[rules]
    for name, shape in S.INPUT_SHAPES.items():
        got = S.batch_specs_partition(C.get_full(arch).resolve(16), shape,
                                      ours)
        want = JS.batch_specs_partition(JC.get_full(arch).resolve(16),
                                        JS.INPUT_SHAPES[name], ref)
        assert _plain(got) == _plain(want), name


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", C.ARCH_NAMES)
def test_param_and_cache_specs_equal_the_reference(arch, size):
    get = {"smoke": (C.get_smoke, JC.get_smoke),
           "full": (C.get_full, JC.get_full)}[size]
    cfg, jcfg = get[0](arch).resolve(16), get[1](arch).resolve(16)
    for name in ("tp", "fsdp", "no sharding", "no batch axes"):
        ours_rules, ref_rules = RULES[name]
        ours = LM(cfg, ours_rules, device="cpu")
        ref = JaxLM(jcfg, ref_rules)
        for fsdp in (None, True, False):
            assert _plain(ours.param_specs(fsdp=fsdp)) == _plain(
                ref.param_specs(fsdp=fsdp)), (name, fsdp)
        assert _plain(ours.cache_specs()) == _plain(ref.cache_specs())
        other_ours, other_ref = RULES["tp multi-pod"]
        assert _plain(ours.cache_specs(other_ours)) == _plain(
            ref.cache_specs(other_ref))
    # the spec tree has the parameter tree's layout
    layout = LM(cfg, RULES["tp"][0], device="cpu").param_layout()
    specs = LM(cfg, RULES["tp"][0], device="cpu").param_specs()

    def same(a, b):
        assert isinstance(a, dict) == isinstance(b, dict)
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        else:
            assert len(b) == len(a.shape)
    same(layout, specs)


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert SH.placements(mesh, SH.P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert SH.placements(mesh, SH.P()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        SH.placements(mesh, SH.P(("data", "pod")))
    with pytest.raises(ValueError, match="no axis"):
        SH.placements(mesh, SH.P("expert"))
    with pytest.raises(ValueError, match="twice"):
        SH.placements(mesh, SH.P("model", "model"))
    tree = SH.tree_named_shardings(mesh, {"a": SH.P(None, "model"),
                                          "b": {"c": SH.P("data")}})
    assert tree == {"a": (Replicate(), Replicate(), Shard(1)),
                    "b": {"c": (Replicate(), Shard(0), Replicate())}}


_MESHES = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard, Replicate
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import mesh as M
from repro_torch.models import sharding as SH

for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    mesh = M.make_production_mesh(multi_pod=multi, device="cpu")
    print("mesh", world, tuple(mesh.shape), tuple(mesh.mesh_dim_names),
          mesh.device_type)
    rules = M.production_rules(multi_pod=multi)
    print("batch", world, SH.placements(mesh, rules.spec("batch", None)))
    print("for_batch", world, rules.for_batch(1, mesh).batch_axes,
          rules.for_batch(512, mesh).batch_axes)
    try:
        M.make_mesh((4, 4), ("data", "model"), device="cpu")
    except ValueError as e:
        print("mismatch", world, e)
    dist.destroy_process_group()
"""


def test_production_meshes_under_the_fake_process_group():
    out = subprocess.run([sys.executable, "-c", _MESHES, SRC],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "mesh 256 (16, 16) ('data', 'model') cpu" in lines
    assert "mesh 512 (2, 16, 16) ('pod', 'data', 'model') cpu" in lines
    assert ("batch 256 (Shard(dim=0), Replicate())" in lines)
    assert ("batch 512 (Shard(dim=0), Shard(dim=0), Replicate())" in lines)
    assert "for_batch 256 () ('data',)" in lines
    assert "for_batch 512 () ('pod', 'data')" in lines
    for world in (256, 512):
        assert any(line.startswith(f"mismatch {world} a (4, 4) mesh needs 16 "
                                   f"ranks; the process group has {world}")
                   for line in lines), lines


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        M.make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        M.make_mesh((1, 1), ("data",), device="cpu")
