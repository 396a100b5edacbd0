"""Multi-pod dry-run on fake tensors: prove that every (architecture x
input shape x mesh) step traces on the production mesh, and record each
one's per-device footprint and roofline terms.

The counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each step for 256 or 512 forced host devices; the port has no
compiler to ask, so it traces the step instead, as one rank of the mesh:

  * **How it traces** (the rule for a meta trace).  A process group of
    torch's ``fake`` backend with the mesh's world size (this process is
    rank 0; a collective moves nothing), ``make_production_mesh`` over
    it, and every parameter, optimizer state, cache and input a fake
    tensor (``TraceMode``, a ``FakeTensorMode``) of rank 0's local shard,
    wrapped as a DTensor placed by the model's specs.  Nothing is
    allocated and nothing launched, card or no card: a fake tensor has a
    shape, a dtype and a device and no storage, and each kernel op hands
    such tensors to its stand-in (``kernels/fake``).  The tensors' device
    is ``cuda`` where torch sees a card, else ``cpu`` (a torch built
    without CUDA cannot differentiate a fake CUDA tensor); on a ``cpu``
    mesh DTensor would trade an all-to-all for an all-gather and a chunk,
    as gloo has no all-to-all, so the trace gives it the all-to-all the
    card's mesh runs (``_card_collectives``).  ``resolve_device`` is not
    widened: the trace's device is one it already hands out.
  * **What it counts.**  ``TraceMode`` sees every op that runs on a fake
    local tensor once, at the outermost level (the ops a DTensor op runs
    on its local shards, a ``local_map`` body's ops, a kernel's
    stand-in), and never the DTensor op itself, so each count is rank
    0's own work:
      - FLOPs: ``torch.utils.flop_counter``'s formula of each op (the
        kernels' stand-ins register their bounds' counts);
      - bytes (the stand-in for XLA's "bytes accessed"): each op that is
        not a view, an allocation or a collective reads each tensor
        argument's distinct elements once and writes each output once;
      - collectives: each one's kind, its result's bytes a device and its
        group's size, turned into wire bytes by the ring formulas of
        ``roofline.ring_wire_bytes``;
      - memory: the bytes of live local storage (each output's storage
        counted when an op makes it, released when the last tensor on it
        dies, as the caching allocator's ``memory_allocated`` moves);
        ``peak_bytes_per_dev`` is the largest over the step, arguments
        included, and ``arg_bytes_per_dev`` the parameters, optimizer
        state, cache and batch at rank 0's local shard sizes (the largest
        shard where a dim does not split evenly, as XLA pads every shard
        to it).  A kernel's scratch inside its stand-in is not counted.
  * **Depth.**  Memory comes from the full-depth trace; FLOPs, bytes and
    wire bytes from 1- and 2-layer traces extrapolated to the full depth
    (``roofline.extrapolate``), as the reference does.

Results append to a JSON file so partial runs resume (``--skip-done``);
``launch/report`` turns it into tables.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dlrm
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import configs as C
from repro_torch.configs.shapes import INPUT_SHAPES, input_specs
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import make_production_mesh, production_rules
from repro_torch.models.sharding import placements

TP = 16
# decode cache capacity for sliding-window archs on the 500k shape
LONG_DECODE_WINDOW = {"h2o-danube-1.8b": 4096, "hymba-1.5b": 1024,
                      "rwkv6-1.6b": None}
HBM_BYTES = 80e9               # H100 80GB HBM3
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def trace_device() -> str:
    """The fake tensors' device: ``cuda`` where torch sees a card."""
    return "cuda" if torch.cuda.is_available() else "cpu"


# ---- collectives ---------------------------------------------------------

def _ops(ns: str, *names):
    space = getattr(torch.ops, ns)
    return [getattr(space, n).default for n in names if hasattr(space, n)]


def _collective_table() -> dict:
    """op -> (kind, where its result is: "out" or an argument index, where
    its group is: an argument index)."""
    table = {}
    for op in _ops("c10d", "allreduce_"):
        table[op] = ("all-reduce", 0, 1)
    for op in _ops("c10d", "broadcast_"):
        table[op] = ("collective-permute", 0, 1)
    for op in _ops("c10d", "alltoall_base_", "alltoall_"):
        table[op] = ("all-to-all", 0, 2)
    for op in _ops("c10d", "_allgather_base_", "allgather_"):
        table[op] = ("all-gather", 0, 2)
    for op in _ops("c10d", "_reduce_scatter_base_", "reduce_scatter_"):
        table[op] = ("reduce-scatter", 0, 2)
    for ns in ("_c10d_functional", "_c10d_functional_autograd"):
        for op in _ops(ns, "all_reduce", "all_reduce_", "broadcast",
                       "all_reduce_coalesced"):
            kind = ("collective-permute" if "broadcast" in op.name()
                    else "all-reduce")
            table[op] = (kind, "out", 2)
        for op in _ops(ns, "all_gather_into_tensor",
                       "all_gather_into_tensor_coalesced"):
            table[op] = ("all-gather", "out", 1)
        for op in _ops(ns, "reduce_scatter_tensor",
                       "reduce_scatter_tensor_coalesced"):
            table[op] = ("reduce-scatter", "out", 2)
        for op in _ops(ns, "all_to_all_single"):
            table[op] = ("all-to-all", "out", 3)
    for op in _ops("_dtensor", "shard_dim_alltoall"):
        table[op] = ("all-to-all", "out", 3)
    return table


def _group_size(g) -> int:
    if isinstance(g, int):
        return g
    if isinstance(g, str):
        return dist.distributed_c10d._resolve_process_group(g).size()
    from torch._C._distributed_c10d import ProcessGroup
    return ProcessGroup.unbox(g).size()


# ---- the trace -------------------------------------------------------------

def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storages(tree) -> dict:
    """The distinct storages under ``tree``'s tensors (a DTensor's local
    one), by their address."""
    out = {}
    for t in _tensors(tree):
        st = (t._local_tensor if isinstance(t, DTensor) else t
              ).untyped_storage()
        out[st._cdata] = st
    return out


def _span_bytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements (a broadcast view reads its
    source once)."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride())
                   if s > 1)
    return min(span, t.numel()) * t.element_size()


class TraceMode(FakeTensorMode):
    """A ``FakeTensorMode`` that accounts for every op on its fake local
    tensors once: FLOPs, bytes, collectives, live storage and its peak
    (module docstring).  ``reset()`` zeroes the counts (not the live
    bytes); ``reset_peak()`` sets the peak to the live bytes."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self._depth = 0
        self._quiet = 0
        self._coll = _collective_table()
        self._storages: dict = {}
        self.live = self.peak = 0
        self.reset()

    def reset(self) -> None:
        self.flops = 0
        self.bytes = 0
        self.wire = dict.fromkeys(KINDS, 0.0)
        self.collectives: dict = {}          # op name -> calls

    def reset_peak(self) -> None:
        self.peak = self.live

    def dispatch(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._depth += 1
        try:
            out = super().dispatch(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if self._depth == 0 and not self._quiet and out is not NotImplemented:
            self._account(func, args, kwargs, out)
        return out

    @contextlib.contextmanager
    def local_only(self):
        """Leave out what DTensor's sharding propagation runs on global
        shapes under this mode (it runs each op once on fake tensors of
        the global shapes to learn its output's)."""
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator as SP)
        saved = {}
        for name in ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta"):
            fn = SP.__dict__.get(name)
            if fn is None or not callable(fn):
                continue

            def quiet(*args, _fn=fn, **kwargs):
                self._quiet += 1
                try:
                    return _fn(*args, **kwargs)
                finally:
                    self._quiet -= 1
            saved[name] = fn
            setattr(SP, name, quiet)
        try:
            yield
        finally:
            for name, fn in saved.items():
                setattr(SP, name, fn)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def step_trace(self, build_s: float, trace_s: float, args, out
                   ) -> "StepTrace":
        """The counts since ``reset()``, and the bytes of ``args``, of the
        step's outputs ``out`` and of those outputs that are arguments."""
        ins, outs = _storages(args), _storages(out)
        return StepTrace(build_s, trace_s,
                         sum(st.nbytes() for st in ins.values()),
                         sum(st.nbytes() for st in outs.values()),
                         sum(st.nbytes() for k, st in outs.items()
                             if k in ins), self.peak,
                         self.flops, self.bytes, dict(self.wire),
                         dict(self.collectives))

    def _account(self, func, args, kwargs, out) -> None:
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if func in self._coll:
            kind, res, grp = self._coll[func]
            size = sum(t.numel() * t.element_size() for t in (
                outs if res == "out" else _tensors(args[res])))
            name = func.name().split("::")[-1].split(".")[0]
            self.collectives[name] = self.collectives.get(name, 0) + 1
            self.wire[kind] += R.ring_wire_bytes(kind, size,
                                                 _group_size(args[grp]))
            return
        if func.namespace in ("_c10d_functional", "c10d"):
            return                                   # waits, barriers
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if func.is_view or "empty" in func.name():
            return
        self.bytes += sum(_span_bytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_span_bytes(t) for t in outs)


@contextlib.contextmanager
def _card_collectives(mesh):
    """On a ``cpu`` mesh, DTensor's shard-to-shard redistribution runs the
    all-to-all that a ``cuda`` mesh runs (on a ``cpu`` mesh it would
    gather and chunk, because gloo has no all-to-all; the fake backend
    moves nothing either way)."""
    from torch.distributed.tensor import placement_types as PT
    if mesh.device_type != "cpu" or not hasattr(PT, "shard_dim_alltoall"):
        yield
        return
    from torch.distributed._functional_collectives import _resolve_group_name

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        name = _resolve_group_name((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim,
                                                     shard_dim, name)

    saved = PT.shard_dim_alltoall
    PT.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        PT.shard_dim_alltoall = saved


@contextlib.contextmanager
def fake_world(world: int):
    """A process group of torch's ``fake`` backend with ``world`` ranks,
    this process rank 0 (an existing one of that size is reused)."""
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_backend() != "fake":
            raise RuntimeError("another process group is running")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_dtensor(shape, dtype, mesh, spec, device) -> DTensor:
    """A DTensor of global ``shape`` placed by ``spec`` on ``mesh`` whose
    local tensor is rank 0's shard, made under the active ``TraceMode``
    (no global tensor is made)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    pl = placements(mesh, spec)
    shape = tuple(int(s) for s in shape)
    with unset_fake_temporarily():       # it reads the mesh's real tensor
        local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    t = torch.empty(tuple(local), dtype=dtype, device=device)
    stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def fake_params(model, mesh, device) -> dict:
    """``model``'s parameters by ``param_layout`` as fake DTensors placed
    by ``param_specs``."""
    specs = model.param_specs()

    def build(layout, spec):
        if isinstance(layout, dict):
            return {k: build(layout[k], spec[k]) for k in layout}
        return fake_dtensor(layout.shape, layout.dtype, mesh, spec, device)
    return build(model.param_layout(), specs)


def fake_batch(cfg, shape, mesh, rules, device) -> dict:
    """``input_specs``' inputs as fake DTensors, batch over the data axes."""
    out = {}
    for name, t in input_specs(cfg, shape).items():
        spec = rules.spec("batch", *([None] * (t.dim() - 1)))
        out[name] = fake_dtensor(t.shape, t.dtype, mesh, spec, device)
    return out


@dataclasses.dataclass
class StepTrace:
    """One traced step: seconds to build its arguments and to trace it;
    the bytes of its arguments, outputs (and of those, the ones that are
    arguments), and the peak; the counts."""
    build_s: float
    trace_s: float
    arg_bytes: int
    out_bytes: int
    alias_bytes: int
    peak_bytes: int
    flops: int
    bytes: int
    wire: dict
    collectives: dict


def trace_lm_step(cfg, shape, mesh, rules, device=None, remat=True,
                  n_microbatches=1, mode: TraceMode | None = None
                  ) -> StepTrace:
    """Trace one step of ``cfg`` at ``shape`` under ``rules`` on ``mesh``
    as rank 0: a train step (``make_train_step``: gradients and AdamW), a
    prefill (capacity ``shape.seq_len``) or a decode step against a full
    cache (``LONG_DECODE_WINDOW``'s capacity on long_500k)."""
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import LM, tree_leaves
    device = device or trace_device()
    rules = rules.for_batch(shape.global_batch, mesh)
    mode = mode or TraceMode()
    with mode, mode.local_only(), _card_collectives(mesh):
        t0 = time.perf_counter()
        model = LM(cfg, rules, dtype=torch.bfloat16, device=device,
                   remat=remat)
        model.check_mesh(mesh)
        params = fake_params(model, mesh, device)
        batch = fake_batch(cfg, shape, mesh, rules, device)
        args = [params, batch]
        if shape.kind == "train":
            opt, step = ST.make_train_step(model,
                                           n_microbatches=n_microbatches)
            state = opt.init(tree_leaves(params))
            args.append(state)
        elif shape.kind == "decode":
            cap = shape.seq_len
            if shape.name == "long_500k":
                cap = LONG_DECODE_WINDOW.get(cfg.name.split("-smoke")[0],
                                             None) or cap
            cache = model.init_cache(shape.global_batch, cap, mesh)
            cache["pos"] = cap - 1
            args.append(cache)
        build_s = time.perf_counter() - t0
        mode.reset()
        mode.reset_peak()
        t0 = time.perf_counter()
        if shape.kind == "train":
            out = step(params, state, batch)
        elif shape.kind == "prefill":
            out = ST.make_prefill_step(model, capacity=shape.seq_len)(
                params, batch)
        else:
            out = ST.make_decode_step(model)(params, cache, batch)
        return mode.step_trace(build_s, time.perf_counter() - t0, args, out)


def _record(rec: dict, full: StepTrace) -> None:
    peak = full.peak_bytes
    rec.update({
        "lower_s": round(full.build_s, 2), "compile_s": round(full.trace_s, 2),
        "arg_bytes_per_dev": int(full.arg_bytes),
        "out_bytes_per_dev": int(full.out_bytes),
        "temp_bytes_per_dev": int(peak - full.arg_bytes - full.out_bytes
                                  + full.alias_bytes),
        "alias_bytes_per_dev": int(full.alias_bytes),
        "peak_bytes_per_dev": int(peak),
        "fits_80gb_hbm": bool(peak < HBM_BYTES)})


def _mesh_and_rules(mesh_kind: str, strategy: str = "tp"):
    multi = mesh_kind == "multi"
    mesh = make_production_mesh(multi_pod=multi, device=trace_device())
    return mesh, production_rules(multi_pod=multi, strategy=strategy)


def run_combo(arch: str, shape_name: str, mesh_kind: str,
              skip_metrics: bool = False, strategy: str = "tp",
              n_microbatches: int = 1) -> dict:
    if arch == "dlrm":
        return run_dlrm(mesh_kind)
    shape = INPUT_SHAPES[shape_name]
    world = 512 if mesh_kind == "multi" else 256
    with fake_world(world):
        mesh, rules = _mesh_and_rules(mesh_kind, strategy)
        cfg = C.get_full(arch).resolve(1 if strategy == "fsdp" else TP)
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "n_devices": mesh.size(), "status": "ok",
               "strategy": strategy, "n_microbatches": n_microbatches}
        t0 = time.perf_counter()
        # 1) full depth: the proof that it traces, and the footprint
        full = trace_lm_step(cfg, shape, mesh, rules,
                             n_microbatches=n_microbatches)
        _record(rec, full)
        if skip_metrics:
            return rec
        # 2) depth 1 and 2, extrapolated to L
        metrics = {}
        for k in (1, 2):
            t = trace_lm_step(dataclasses.replace(cfg, n_layers=k), shape,
                              mesh, rules, n_microbatches=n_microbatches)
            metrics[k] = {"flops": float(t.flops), "bytes": float(t.bytes),
                          "wire": t.wire}
        terms = extrapolated_terms(metrics, cfg.n_layers,
                                   R.model_flops(cfg, shape), mesh.size())
        rec["roofline"] = terms.as_dict()
        rec["total_s"] = round(time.perf_counter() - t0, 2)
    return rec


def extrapolated_terms(metrics: dict, n_layers: int, model_flops: float,
                       n_devices: int) -> R.RooflineTerms:
    """``RooflineTerms`` from the 1- and 2-layer traces' counts."""
    L = n_layers
    flops = R.extrapolate(metrics[1]["flops"], metrics[2]["flops"], L)
    bytes_ = R.extrapolate(metrics[1]["bytes"], metrics[2]["bytes"], L)
    wire = {k: R.extrapolate(metrics[1]["wire"][k], metrics[2]["wire"][k], L)
            for k in metrics[1]["wire"]}
    return R.RooflineTerms(hlo_flops=flops, hlo_bytes=bytes_,
                           wire_bytes=sum(wire.values()), wire_by_kind=wire,
                           model_flops=model_flops, n_devices=n_devices)


# ---- the paper's DLRM ------------------------------------------------------

def dlrm_plan(n_shards: int, n_tables: int = 160):
    """``_lower_dlrm``'s plan: the pool's first ``n_tables`` tables, hash
    sizes clipped to [1e4, 4e6] rows, placed by the size expert on
    ``n_shards``, arenas at the native dim 16."""
    from repro_torch.core import baselines as B
    from repro_torch.core import features as F
    from repro_torch.data.synthetic import make_dlrm_pool
    from repro_torch.embedding.plan import build_plan
    pool = make_dlrm_pool(seed=0)[:n_tables].copy()
    pool[:, F.HASH_SIZE] = np.clip(pool[:, F.HASH_SIZE], 1e4, 4e6)
    pool[:, F.TABLE_SIZE_GB] = F.table_size_gb(pool[:, F.DIM],
                                               pool[:, F.HASH_SIZE])
    assign = B.expert_place(pool, n_shards, 1e9, "size")
    return build_plan(pool, assign, n_shards, pad_dim_to=16)


def trace_dlrm_step(mesh, rules, batch: int = 65536, n_tables: int = 160,
                    pool_slots: int = 16, device=None,
                    mode: TraceMode | None = None) -> StepTrace:
    """One rank's DLRM train step as ``_lower_dlrm`` builds it: 160
    tables, batch 65536 split over the data axes, table-parallel arenas
    over ``model`` (the one-rank ``DLRM``: its shard's arena),
    ``make_sharded_lookup`` from the mesh, bf16, row-wise Adagrad (0.05)
    on the arena and Adam (1e-3) on the dense nets, averaged over every
    rank."""
    from repro_torch.embedding import sharded as E
    from repro_torch.launch.train_dlrm import make_train_step
    from repro_torch.models.dlrm import DLRM, DLRMConfig
    from repro_torch.optim import adam, rowwise_adagrad
    device = device or trace_device()
    model_axis = rules.model_axis
    data_axes = rules.batch_axes or ("data",)
    m = mesh.get_local_rank(model_axis)
    tp = mesh.size(mesh.mesh_dim_names.index(model_axis))
    plan = dlrm_plan(tp, n_tables)
    mode = mode or TraceMode()
    with mode, mode.local_only(), _card_collectives(mesh):
        t0 = time.perf_counter()
        cfg = DLRMConfig(n_dense_features=13, embed_dim=plan.dim,
                         bottom_mlp=(512, 256), top_mlp=(1024, 512, 256),
                         n_tables=n_tables)
        model = DLRM(cfg, plan, device=device, dtype=torch.bfloat16,
                     shard=m)
        lookup = E.make_sharded_lookup(plan, mesh=mesh, data_axes=data_axes,
                                       model_axis=model_axis)
        emb_opt, dense_opt = rowwise_adagrad(0.05), adam(1e-3)
        emb_state = emb_opt.init(list(model.arenas))
        dense_state = dense_opt.init(model.dense_parameters())
        n_data = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                           for a in data_axes)
        b_loc = batch // n_data
        gidx = torch.empty((b_loc, plan.n_shards * plan.k_max, pool_slots),
                           dtype=torch.int32, device=device)
        # the dense features and labels of this rank's rows after the
        # exchange: the dense nets see batch / (data x model) rows
        dense = torch.empty((b_loc // tp, 13), device=device)
        labels = torch.empty((b_loc // tp,), device=device)
        step = make_train_step(model, lookup, emb_opt, dense_opt,
                               batch_group=dist.group.WORLD)
        args = [list(model.parameters()), emb_state.inner, dense_state.inner,
                gidx, dense, labels]
        build_s = time.perf_counter() - t0
        mode.reset()
        mode.reset_peak()
        t0 = time.perf_counter()
        out = step(emb_state, dense_state, gidx, dense, labels)
        return mode.step_trace(build_s, time.perf_counter() - t0, args, out)


def run_dlrm(mesh_kind: str) -> dict:
    world = 512 if mesh_kind == "multi" else 256
    with fake_world(world):
        mesh, rules = _mesh_and_rules(mesh_kind)
        rec = {"arch": "dlrm", "shape": "train_65k", "mesh": mesh_kind,
               "n_devices": mesh.size(), "status": "ok"}
        t = trace_dlrm_step(mesh, rules)
        _record(rec, t)
        terms = R.RooflineTerms(
            hlo_flops=float(t.flops), hlo_bytes=float(t.bytes),
            wire_bytes=sum(t.wire.values()), wire_by_kind=t.wire,
            model_flops=0.0, n_devices=mesh.size())
        rec["roofline"] = terms.as_dict()
    return rec


def iter_combos(archs, shapes, meshes):
    for arch in archs:
        if arch == "dlrm":          # paper's own arch: one training shape
            for mesh in meshes:
                yield arch, "train_65k", mesh
            continue
        for shape in shapes:
            if not C.supports_shape(arch, shape):
                continue
            for mesh in meshes:
                yield arch, shape, mesh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--strategy", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--skip-metrics", action="store_true")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip combos already in the output file")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(C.ARCH_NAMES)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]

    try:
        results = json.load(open(args.out))
    except (FileNotFoundError, json.JSONDecodeError):
        results = []
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") == "ok"} if args.skip_done else set()

    for arch, shape, mesh in iter_combos(archs, shapes, meshes):
        if (arch, shape, mesh) in done:
            continue
        print(f"== {arch} x {shape} x {mesh} ==", flush=True)
        try:
            rec = run_combo(arch, shape, mesh,
                            skip_metrics=args.skip_metrics,
                            strategy=args.strategy,
                            n_microbatches=args.microbatches)
            rl = rec.get("roofline", {})
            print(f"   ok trace={rec['compile_s']}s "
                  f"peak={rec['peak_bytes_per_dev']/1e9:.2f}GB/dev "
                  f"dominant={rl.get('dominant', '-')}", flush=True)
        except Exception as e:
            rec = {"arch": arch, "shape": shape, "mesh": mesh,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"   ERROR {type(e).__name__}: {e}", flush=True)
        results = [r for r in results if (r["arch"], r["shape"], r["mesh"])
                   != (arch, shape, mesh)]
        results.append(rec)
        json.dump(results, open(args.out, "w"), indent=1)

    n_ok = sum(r.get("status") == "ok" for r in results)
    print(f"done: {n_ok}/{len(results)} combos ok")


if __name__ == "__main__":
    main()
