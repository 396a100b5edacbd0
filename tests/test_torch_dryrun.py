"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's, and the kernels' path through a fake trace.

- ``iter_combos`` lists the reference's combos, and ``model_flops`` of
  every LM combo is the reference's bit for bit.
- On a ``(data 2, model 4)`` mesh of torch's fake process group, at SMOKE
  widths (``resolve(16)``) and a 64-token batch of 8:
  - ``arg_bytes_per_dev`` of a train, a prefill and a decode step equals
    the reference's ``memory_analysis().argument_size_in_bytes`` for the
    same step lowered on 8 forced host devices (one subprocess), less the
    reference's int32 AdamW step counter (4 bytes), which the port keeps
    on the host.  Uneven shards: rank 0 holds the largest shard, the size
    XLA pads every shard to, so both count it;
  - the FLOPs a device lie within [0.5, 4] of the reference's
    ``cost_analysis()`` flops: the port counts every op it runs at its
    ``flop_counter`` formula, the one-hot embedding's matmul, remat's
    forward again and the attention backward's blockwise recompute
    included, where XLA counts its fused, optimized module;
  - the FLOPs and wire bytes of a 1- and a 2-layer trace, extrapolated
    to 3 layers, equal the 3-layer trace's, and so do a prefill's and a
    decode step's bytes; a train step's bytes grow as L^2 (each layer's
    slice gradient of a stacked leaf is the whole leaf's size), so the
    extrapolation falls short of them, by under 2%;
  - every arch traces a train, a prefill and a decode step (the fault of
    a model axis larger than the KV heads, with a data axis of 2, is
    repaired), and the FLOPs counted on rank 0, times the 8 devices, are
    at least ``model_flops``, less the embedding's share (``mult x
    emb x tokens``, ``emb`` the table and an untied head) where the step
    takes the embedding by a gather and the head on one position
    (prefill, decode): at SMOKE widths the vocab is a large part of N.
    For rwkv6 it is also less what ``param_count`` (the reference's,
    copied) counts in its channel mix beyond what it holds: a GLU's three
    d x ff matrices where the block has two and a d x d one.
- Every arch's full-width ``resolve(16)`` config, cut to one layer,
  traces a train, a prefill and a decode step on the (16, 16) production
  mesh of the fake group (in a subprocess).
- ``--arch dlrm`` writes a record with the reference's keys
  (``fits_80gb_hbm`` in place of ``fits_16gb_hbm``).
- Each kernel op on fake tensors returns its output's shape and dtype,
  counts its kernel's FLOPs by its bound's formula, and neither launches
  nor runs its plain version.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as JC
from repro.configs.shapes import INPUT_SHAPES as J_SHAPES
from repro.launch import roofline as JR
from repro_torch import configs as C
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.sharding import ShardingRules

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
KINDS = ("train", "prefill", "decode")
REF_ARCHS = ("h2o-danube-1.8b", "olmoe-1b-7b")
FLOP_BAND = (0.5, 4.0)


def _shape(kind):
    return InputShape(f"smoke_{kind}", 64, 8, kind)


@pytest.fixture(scope="module")
def reference_dryrun():
    """``repro.launch.dryrun`` imported with the environment it sets (its
    512 forced host devices) put back, so no later test inherits it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as JD
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return JD


def test_iter_combos_is_the_references(reference_dryrun):
    JD = reference_dryrun
    for archs in (list(C.ARCH_NAMES) + ["dlrm"], ["hymba-1.5b"], ["dlrm"]):
        for meshes in (["single", "multi"], ["single"]):
            got = list(D.iter_combos(archs, list(INPUT_SHAPES), meshes))
            want = list(JD.iter_combos(archs, list(J_SHAPES), meshes))
            assert got == want
    assert (D.TP, D.LONG_DECODE_WINDOW) == (JD.TP, JD.LONG_DECODE_WINDOW)


def test_model_flops_of_every_combo_is_the_references():
    n = 0
    for arch, shape, _ in D.iter_combos(C.ARCH_NAMES, list(INPUT_SHAPES),
                                        ["single"]):
        got = R.model_flops(C.get_full(arch).resolve(D.TP),
                            INPUT_SHAPES[shape])
        want = JR.model_flops(JC.get_full(arch).resolve(D.TP),
                              J_SHAPES[shape])
        assert np.float64(got).tobytes() == np.float64(want).tobytes()
        n += 1
    assert n == 33


_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, sys.argv[1])
import contextlib
import numpy as np, jax
from jax.sharding import Mesh
from repro import configs as JC
from repro.configs.shapes import InputShape
from repro.launch import steps as JST
from repro.models.sharding import ShardingRules

fast = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
out = {}
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
rules = ShardingRules(batch_axes=("data",), model_axis="model")
lower = {"train": JST.lower_train, "prefill": JST.lower_prefill,
         "decode": JST.lower_decode}
for arch in sys.argv[2].split(","):
    for kind in ("train", "prefill", "decode"):
        cfg = JC.get_smoke(arch).resolve(16)
        shape = InputShape(f"smoke_{kind}", 64, 8, kind)
        ctx = (jax.set_mesh(mesh) if hasattr(jax, "set_mesh")
               else contextlib.nullcontext())
        with ctx:
            lw, _ = lower[kind](cfg, shape, mesh, rules,
                                layer_loop="unrolled")
            cp = lw.compile(fast)
        ca = cp.cost_analysis()
        ca = ca[0] if isinstance(ca, list) else ca
        out[f"{arch}/{kind}"] = {
            "arg": int(cp.memory_analysis().argument_size_in_bytes),
            "flops": float(ca.get("flops", 0.0))}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_steps():
    """The reference's SMOKE steps lowered on a (2, 4) mesh of 8 forced
    host devices, at XLA's lowest optimization (one subprocess)."""
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, SRC, ",".join(REF_ARCHS)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def mesh():
    """A (data 2, model 4) mesh over torch's fake process group."""
    with D.fake_world(8):
        yield make_mesh((2, 4), ("data", "model"), device="cpu")


def _trace(mesh, arch, kind, n_layers=None):
    cfg = C.get_smoke(arch).resolve(D.TP)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg, D.trace_lm_step(cfg, _shape(kind), mesh, ShardingRules(),
                                device="cpu")


@pytest.fixture(scope="module")
def traces(mesh):
    """Every arch's train, prefill and decode step traced on the mesh,
    or the error it raised (so a case fails alone)."""
    out = {}
    for arch in C.ARCH_NAMES:
        for kind in KINDS:
            try:
                out[(arch, kind)] = _trace(mesh, arch, kind)
            except Exception as e:          # raised again by its cases
                out[(arch, kind)] = e
    return out


def _traced(traces, arch, kind):
    got = traces[(arch, kind)]
    if isinstance(got, Exception):
        raise got
    return got


@pytest.mark.parametrize("arch,kind", [(a, k) for a in REF_ARCHS
                                       for k in KINDS])
def test_arg_bytes_are_the_references(traces, reference_steps, arch, kind):
    _, t = _traced(traces, arch, kind)
    want = reference_steps[f"{arch}/{kind}"]["arg"]
    # the int32 scalar the reference holds on the device and the port on
    # the host: AdamW's step count, the cache's position
    assert t.arg_bytes == want - (0 if kind == "prefill" else 4)


@pytest.mark.parametrize("arch,kind", [(a, k) for a in REF_ARCHS
                                       for k in KINDS])
def test_flops_a_device_lie_in_the_band_of_the_references(
        traces, reference_steps, arch, kind):
    _, t = _traced(traces, arch, kind)
    want = reference_steps[f"{arch}/{kind}"]["flops"]
    assert FLOP_BAND[0] <= t.flops / want <= FLOP_BAND[1], (t.flops, want)


@pytest.mark.parametrize("arch,kind", [
    ("h2o-danube-1.8b", "train"), ("h2o-danube-1.8b", "prefill"),
    ("h2o-danube-1.8b", "decode"), ("olmoe-1b-7b", "train"),
    ("hymba-1.5b", "train"), ("rwkv6-1.6b", "train")])
def test_two_point_extrapolation_is_the_full_depth_count(mesh, arch, kind):
    depths = (1, 2, 3, 4) if kind == "train" else (1, 2, 3)
    metrics = {}
    for k in depths:
        _, t = _trace(mesh, arch, kind, n_layers=k)
        metrics[k] = {"flops": float(t.flops), "bytes": float(t.bytes),
                      "wire": t.wire}
    terms = D.extrapolated_terms({k: metrics[k] for k in (1, 2)}, 3, 0.0, 8)
    assert terms.hlo_flops == metrics[3]["flops"]
    assert terms.wire_by_kind == metrics[3]["wire"]
    assert metrics[3]["flops"] > metrics[2]["flops"] > metrics[1]["flops"]
    if kind != "train":
        assert terms.hlo_bytes == metrics[3]["bytes"]
        return
    # the gradient of each layer's slice of a stacked leaf is the whole
    # leaf's size (zeros, then the slice added), so a train step's bytes
    # grow as a + b L + c L^2 and the extrapolation from 1 and 2 layers
    # falls short by that term alone, c (L - 1) (L - 2): 2 c at 3 layers,
    # 6 c at 4 (exactly for danube, olmoe and hymba; rwkv6's 4-layer step
    # moves 5120 bytes more, 1.2e-3 of its 3-layer shortfall)
    short = {L: metrics[L]["bytes"] - D.extrapolated_terms(
        {k: metrics[k] for k in (1, 2)}, L, 0.0, 8).hlo_bytes
        for L in (3, 4)}
    assert short[3] > 0
    assert abs(short[4] / short[3] - 3) < 2e-3, short


@pytest.mark.parametrize("arch", C.ARCH_NAMES)
def test_every_arch_traces_and_counts_at_least_model_flops(traces, arch):
    for kind in KINDS:
        cfg, t = _traced(traces, arch, kind)
        shape = _shape(kind)
        want = R.model_flops(cfg, shape)
        tokens = shape.global_batch * (1 if kind == "decode"
                                       else shape.seq_len)
        mult = 6.0 if kind == "train" else 2.0
        if kind != "train":                      # a gather, one position
            emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
            want -= mult * emb * tokens
        if cfg.block == "rwkv":
            # param_count (the reference's) counts RWKV's channel mix as a
            # three-matrix GLU, d x ff each; it has wk, wv (d x ff) and wr
            # (d x d)
            ff = cfg.d_model * cfg.d_ff - cfg.d_model ** 2
            want -= mult * cfg.n_layers * ff * tokens
        assert t.flops * 8 >= want, (kind, t.flops * 8, want)
        assert t.peak_bytes >= t.arg_bytes > 0
        assert sum(t.wire.values()) > 0
    # the KV heads do not divide over tp: the projections are placed whole
    # on ``model`` before the head split, over a model axis of 4 ranks
    assert cfg.n_kv_heads % D.TP or cfg.block == "rwkv"


_PRODUCTION = r"""
import dataclasses, json, logging, sys
sys.path.insert(0, sys.argv[1])
logging.disable(logging.WARNING)
import torch
torch.set_num_threads(1)
from repro_torch import configs as C
from repro_torch.configs.shapes import INPUT_SHAPES
from repro_torch.launch import dryrun as D

mesh_kind = sys.argv[2]
out = {}
with D.fake_world(512 if mesh_kind == "multi" else 256):
    mesh, rules = D._mesh_and_rules(mesh_kind)
    for arch in C.ARCH_NAMES:
        cfg = dataclasses.replace(C.get_full(arch).resolve(D.TP), n_layers=1)
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            try:
                t = D.trace_lm_step(cfg, INPUT_SHAPES[shape], mesh, rules)
                out[f"{arch}/{shape}"] = {"flops": t.flops,
                                          "peak": t.peak_bytes}
            except Exception as e:
                out[f"{arch}/{shape}"] = {"error": f"{type(e).__name__}: {e}"}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def production_traces():
    """Every arch's ``resolve(16)`` config cut to one layer, traced at
    ``train_4k``, ``prefill_32k`` and ``decode_32k`` on the (16, 16)
    production mesh of the fake group, in a subprocess (~50 s; the (2,
    16, 16) mesh takes ~3x as long, so the CLI's full-depth run covers
    it, PERF.md §6)."""
    out = subprocess.run([sys.executable, "-c", _PRODUCTION, SRC, "single"],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("arch", C.ARCH_NAMES)
def test_every_arch_traces_on_the_production_mesh(production_traces, arch):
    """Full width at ``resolve(16)``, one layer, on the (16, 16) mesh: six
    archs have KV heads that 16 does not divide, which the LM once failed
    to split there (ROADMAP §3)."""
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        got = production_traces[f"{arch}/{shape}"]
        assert "error" not in got, (shape, got)
        assert got["flops"] > 0 and got["peak"] > 0


def test_the_dlrm_record_has_the_references_keys(tmp_path):
    out = tmp_path / "dryrun.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "dlrm",
         "--mesh", "single", "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"))
    assert run.returncode == 0, run.stderr[-3000:]
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok", rec
    assert set(rec) == {
        "arch", "shape", "mesh", "n_devices", "status", "lower_s",
        "compile_s", "arg_bytes_per_dev", "out_bytes_per_dev",
        "temp_bytes_per_dev", "alias_bytes_per_dev", "peak_bytes_per_dev",
        "fits_80gb_hbm", "roofline"}
    assert (rec["arch"], rec["shape"], rec["n_devices"]) == ("dlrm",
                                                             "train_65k", 256)
    assert set(rec["roofline"]["wire_by_kind"]) == set(D.KINDS)
    # the lookup's exchange, the arena's sum over data, the dense nets'
    # average over every rank
    wire = rec["roofline"]["wire_by_kind"]
    assert wire["all-to-all"] > 0 and wire["all-reduce"] > 0
    assert rec["roofline"]["hlo_flops_per_dev"] > 0
    assert rec["peak_bytes_per_dev"] >= rec["arg_bytes_per_dev"] > 0


# ---- the kernels' stand-ins ----------------------------------------------

def _no_compute(monkeypatch):
    """Make every kernel wrapper and plain version raise."""
    from repro_torch.kernels.embedding_bag import ops as K1
    from repro_torch.kernels.flash_attention import ops as K2
    from repro_torch.kernels.selective_scan import ops as K3
    from repro_torch.kernels.wkv6 import ops as K4

    def boom(*args, **kwargs):
        raise AssertionError("a kernel or a plain version ran in a trace")
    for mod, names in ((K1, ("embedding_bag_cuda", "embedding_bag_grad_cuda",
                             "embedding_bag_plain",
                             "embedding_bag_grad_plain")),
                       (K2, ("flash_attention_cuda", "attention_plain")),
                       (K3, ("selective_scan_cuda", "selective_scan_grad_cuda",
                             "selective_scan_plain")),
                       (K4, ("wkv6_cuda", "wkv6_grad_cuda", "wkv6_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    return K1, K2, K3, K4


def _count(fn):
    with FlopCounterMode(display=False) as fc:
        out = fn()
    return out, fc.get_total_flops()


def test_the_kernels_stand_ins_give_shapes_and_their_bounds_flops(
        monkeypatch):
    K1, K2, K3, K4 = _no_compute(monkeypatch)
    with D.TraceMode():
        # K2: the bound's count of PERF.md's yardstick, 5.154e11
        q = torch.empty(2, 8192, 32, 80, dtype=torch.bfloat16)
        kv = torch.empty(2, 8192, 8, 80, dtype=torch.bfloat16)
        o, n = _count(lambda: K2.flash_attention(q, kv, kv, window=4096))
        assert (o.shape, o.dtype) == (q.shape, torch.bfloat16)
        assert n == 4 * 80 * 2 * 32 * K2.attended_pairs(
            8192, 8192, causal=True, window=4096)
        assert round(n / 1e11, 3) == 5.154
        # K1 and K1-bwd: one add a slot and column
        arena = torch.empty(1000, 128, requires_grad=True)
        idx = torch.empty(300, 7, dtype=torch.int32)
        o, n = _count(lambda: K1.embedding_bag(arena, idx))
        assert (o.shape, o.dtype) == ((300, 128), torch.float32)
        assert n == 300 * 7 * 128
        _, n = _count(lambda: o.sum().backward())
        assert arena.grad.shape == arena.shape and n == 300 * 7 * 128
        # K3 and K3-bwd: 7 N + 1 a channel step, 18 N back
        B, S, Di, N = 2, 100, 64, 16
        x = torch.empty(B, S, Di, dtype=torch.bfloat16, requires_grad=True)
        dt = torch.empty(B, S, Di)
        Bc = torch.empty(B, S, N)
        A = torch.empty(Di, N)
        h0 = torch.empty(B, Di, N)
        (y, hT), n = _count(lambda: K3.selective_scan(x, dt, Bc, Bc, A, h0))
        assert (y.shape, y.dtype, hT.shape) == (x.shape, x.dtype, h0.shape)
        assert n == B * S * Di * (7 * N + 1)
        _, n = _count(lambda: y.float().sum().backward())
        assert x.grad.shape == x.shape and n == 18 * B * S * Di * N
        # K4 and K4-bwd: 7 a state element and step, 14 back
        r = torch.empty(2, 50, 4, 64, dtype=torch.bfloat16,
                        requires_grad=True)
        w = torch.empty(2, 50, 4, 64)
        u = torch.empty(4, 64)
        s0 = torch.empty(2, 4, 64, 64)
        (y, sT), n = _count(lambda: K4.wkv6(r, r, r, w, u, s0))
        assert (y.shape, y.dtype, sT.shape) == (r.shape, torch.float32,
                                                s0.shape)
        assert n == 7 * 2 * 50 * 4 * 64 * 64
        _, n = _count(lambda: y.sum().backward())
        assert r.grad.shape == r.shape and n == 14 * 2 * 50 * 4 * 64 * 64


def test_the_stand_ins_take_meta_tensors_and_refuse_real_ones():
    from repro_torch.kernels.flash_attention import ops as K2
    q = torch.empty(1, 16, 2, 32, device="meta")
    assert K2.flash_attention(q, q, q).shape == q.shape
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.flash_attention_fwd(
            torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 2, 32),
            torch.zeros(1, 4, 2, 32), True, None, None)
