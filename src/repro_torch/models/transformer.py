"""Decoder-only LM: the dense decoders (h2o-danube-1.8b, qwen2.5-14b,
phi4-mini-3.8b, granite-34b), the MoE ones (olmoe-1b-7b, dbrx-132b),
hymba's hybrid block (hymba-1.5b), RWKV-6 (rwkv6-1.6b) and the frontend
archs (llava-next-34b, musicgen-large).

The counterpart of ``repro/models/transformer.py`` at any ``resolve(tp)``:
GQA and MQA, QKV biases, tied embeddings, top-k routed
experts (``layers.moe_apply``) in place of the MLP, whose load-balance
losses ``forward`` and ``forward_loss`` return averaged over the layers;
``block="hybrid"`` adds a selective SSM (``ssm.ssm_apply``) to attention
on the same normed input; ``block="rwkv"`` is RWKV-6 time mixing, then
channel mixing, with no attention.  Parameters are a nested dict of
tensors in the reference's pytree layout, with each layer's weights
stacked along a leading ``L`` axis; the layer loop is a Python loop over
that axis (the reference's ``layer_loop="unrolled"``), each layer under
``torch.utils.checkpoint`` when ``remat`` is on and autograd records.
A frontend arch's encoder is a stub, as in the reference: ``forward``,
``forward_loss`` and ``prefill`` take precomputed ``embeds`` (B, F, D),
cast to the model's dtype and put in front of the token embeddings
(``_embed``); the positions, the labels, the loss mask and the cache
count the frames too.  ``decode_step`` embeds tokens only.

Entry points:
  * ``forward``      -- train/eval logits over a full sequence
  * ``forward_loss`` -- the chunked cross-entropy, with no ``(B, S, Vp)``
    logits
  * ``prefill``      -- forward + a populated cache
  * ``decode_step``  -- one token against the (circular) cache

Padded heads: ``resolve(tp)`` pads the query heads to a multiple of tp,
and query head h reads KV head ``kv_map[h]`` (``h // G`` for a real
head, KV head 0 for a padded one).  Where that map is ``h // G`` K2
reads the KV heads unexpanded; elsewhere they are expanded through it
first and K2 runs at one query head a KV head.  Decode reads the cache
through the same map (the reference's decode does not where the padded
heads divide by the KV heads: ROADMAP, kept divergences).

Sharding: under enabled ``ShardingRules`` (``models/sharding``) the
parameters are DTensors over a ``DeviceMesh`` placed by ``param_specs``
(``shard_params``), and the activations are pinned by ``rules.constrain``
at the reference's sites, with the residual stream sequence-parallel over
the model axis; DTensor inserts the collectives.  Every kernel (K2, K3,
K3-bwd, K4, K4-bwd) runs through ``sharding.local_apply`` on the rank's
own heads or channels.  MoE layers split their experts over the model
axis (expert parallelism, ``_ffn``): the rows go to the experts and back
by an all-to-all over the model group, or, where the sequence's blocks do
not split over its ranks, each rank runs its own experts on the whole
block and gathers the others' outputs.  The cross-entropy over a vocab
shard and decode over a cache split along its sequence run in
``local_apply`` with an explicit all-reduce of their running max.
Inputs may be plain tensors (every rank passes the global batch) or
DTensors; outputs are DTensors.

Train and prefill attention run through the flash attention op (K2 on
the card, and its backward through K2-bwd; on the CPU the plain backward
walks ``q_chunk`` blocks of queries); the SSM's and RWKV's scans over time
run through K3 and K4 on the card, and their backward through K3-bwd and
K4-bwd (under ``remat`` each layer's scan runs again in the backward,
with the same bits).  The cache (KV, and the SSM's state and conv carry,
or RWKV's WKV state and token-shift rows) is updated in place:
``prefill`` allocates it and ``decode_step`` writes its token into the
tensors it is given, returning them with ``pos`` advanced.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed import tensor as dtensor
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ArchConfig
from repro_torch.models.sharding import (NO_SHARDING, P, ShardingRules,
                                         Summed, distribute_tree,
                                         local_apply, model_coords,
                                         placements, shard_start)


class ParamSpec(NamedTuple):
    """One leaf of ``LM.param_layout``: its shape and dtype, and how
    ``init_params`` fills it: ``"normal"`` (x ``value``), ``"full"`` (at
    ``value``) or ``"log_range"`` (log(1..N) along the last axis)."""
    shape: tuple
    dtype: torch.dtype
    init: str
    value: float = 0.0


class LM:
    def __init__(self, cfg: ArchConfig, rules: ShardingRules = NO_SHARDING,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None,
                 remat: bool = True, q_chunk: int = 1024,
                 kv_chunk: int = 1024):
        if cfg.tp < 1 or not cfg.head_dim:
            raise ValueError("config must be resolve()d")
        if cfg.block not in ("attn", "hybrid", "rwkv"):
            raise ValueError(f"{cfg.name}: unknown block {cfg.block!r}")
        if cfg.n_heads and cfg.n_heads_padded < cfg.n_heads:
            raise ValueError(
                f"{cfg.name} at tp={cfg.tp}: resolve() cuts its "
                f"{cfg.n_heads} query heads to {cfg.n_heads_padded}, a "
                f"multiple of {cfg.n_kv_padded} padded KV heads: the query "
                "heads do not group evenly over the KV heads")
        self.cfg = cfg
        self.rules = rules
        self.dtype = dtype
        self.device = resolve_device(device)
        self.remat = remat
        self.q_chunk = q_chunk
        self.kv_chunk = kv_chunk
        if cfg.n_heads:
            # map (padded) q head -> true kv head; padded heads reuse head 0
            g = max(1, cfg.n_heads // cfg.n_kv_heads)
            self.kv_map = np.array(
                [min(i // g, cfg.n_kv_heads - 1) if i < cfg.n_heads else 0
                 for i in range(cfg.n_heads_padded)])
        else:
            self.kv_map = None
        # KV heads split over the model axis; otherwise replicated, and the
        # cache split along its sequence instead
        self.kv_shardable = bool(cfg.n_kv_heads
                                 and cfg.n_kv_heads % cfg.tp == 0)

    # ---- parameters ----------------------------------------------------------

    def param_layout(self) -> dict:
        """The parameter tree, each leaf a ``ParamSpec`` (shape, dtype and
        how ``init_params`` draws it), allocating nothing: shapes as in
        the reference (``wq`` (d, Hq_pad x hd) and ``wo`` (Hq_pad x hd, d)
        over the padded query heads, ``wk``/``wv`` over the true KV heads,
        the vocab padded; no ``lm_head`` with tied embeddings; QKV biases
        at zero; on MoE layers a float32 ``router`` and stacked experts in
        place of the ``mlp``; on hybrid layers an ``ssm`` subtree with
        ``conv`` at 0.2, ``logA = log(1..N)`` in float32 and ``dskip`` at
        1; on RWKV layers the ``ln1``/``ln2``/``rwkv`` layout, ``mu`` and
        ``u`` at 0.5 and ``w_bias`` at -6 in float32), every other weight
        normal x 0.02 and every norm at 1."""
        cfg, dt = self.cfg, self.dtype
        n, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff

        def normal(*shape, scale=0.02, dtype=dt):
            return ParamSpec(shape, dtype, "normal", scale)

        def full(*shape, value=1.0, dtype=dt):
            return ParamSpec(shape, dtype, "full", value)

        params = {"embed": normal(cfg.vocab_padded, d), "final_norm": full(d)}
        if not cfg.tie_embeddings:
            params["lm_head"] = normal(d, cfg.vocab_padded)
        lay = params["layers"] = {"ln1": full(n, d), "ln2": full(n, d)}
        if cfg.block == "rwkv":
            H = d // SSM.RWKV_HEAD_DIM
            lay["rwkv"] = {
                "att": {"mu": normal(n, 5, d, scale=0.5),
                        **{w: normal(n, d, d) for w in
                           ("wr", "wk", "wv", "wg", "ww", "wo")},
                        "w_bias": full(n, d, value=-6.0,
                                       dtype=torch.float32),
                        "u": normal(n, H, SSM.RWKV_HEAD_DIM, scale=0.5)},
                "ffn": {"mu": normal(n, 2, d, scale=0.5),
                        "wk": normal(n, d, f), "wv": normal(n, f, d),
                        "wr": normal(n, d, d)}}
            return params
        hd, Hq, Hkv = cfg.head_dim, cfg.n_heads_padded, cfg.n_kv_heads
        lay.update({"wq": normal(n, d, Hq * hd), "wk": normal(n, d, Hkv * hd),
                    "wv": normal(n, d, Hkv * hd),
                    "wo": normal(n, Hq * hd, d)})
        if cfg.qkv_bias:
            for b, width in (("bq", Hq * hd), ("bk", Hkv * hd),
                             ("bv", Hkv * hd)):
                lay[b] = full(n, width, value=0.0)
        if cfg.block == "hybrid":
            di, N = cfg.ssm.expand * d, cfg.ssm.state_dim
            lay["ssm"] = {"in_proj": normal(n, d, 2 * di),
                          "conv": normal(n, cfg.ssm.conv_width, di,
                                         scale=0.2),
                          "wdt": normal(n, di),
                          "wB": normal(n, di, N), "wC": normal(n, di, N),
                          "logA": ParamSpec((n, di, N), torch.float32,
                                            "log_range"),
                          "out_proj": normal(n, di, d),
                          "dskip": full(n, di)}
        if cfg.moe:
            E = cfg.moe.n_experts
            lay["moe"] = {"router": normal(n, d, E, dtype=torch.float32),
                          "wg": normal(n, E, d, f), "wu": normal(n, E, d, f),
                          "wo": normal(n, E, f, d)}
        else:
            lay["mlp"] = {"wu": normal(n, d, f), "wo": normal(n, f, d)}
            if cfg.act == "swiglu":
                lay["mlp"]["wg"] = normal(n, d, f)
        return params

    def init_params(self, seed: int) -> dict:
        """Weights by ``param_layout``, the normal ones drawn by a generator
        on the model's device seeded with ``seed``.  A stacked leaf is
        drawn one layer at a time, so the float32 temporary is one
        layer's slice, never a whole leaf."""
        generator = torch.Generator(device=self.device).manual_seed(seed)

        def make(spec: ParamSpec) -> torch.Tensor:
            if spec.init == "full":
                return torch.full(spec.shape, spec.value, dtype=spec.dtype,
                                  device=self.device)
            if spec.init == "log_range":     # log(1..N) along the last axis
                r = torch.arange(1, spec.shape[-1] + 1, dtype=spec.dtype,
                                 device=self.device)
                return torch.log(r).expand(spec.shape).contiguous()
            out = torch.empty(spec.shape, dtype=spec.dtype,
                              device=self.device)
            for part in (out if len(spec.shape) > 2 else (out,)):
                part.copy_(torch.randn(part.shape, generator=generator,
                                       device=self.device).mul_(spec.value))
            return out

        return map_params(make, self.param_layout())

    # ---- parameter partition specs ------------------------------------------

    def param_specs(self, fsdp: bool | None = None) -> dict:
        """Parameter PartitionSpecs, the reference's.  With ``fsdp``
        (default: on when sharding is enabled), each weight's d_model-like
        dim is additionally sharded over the data axis (ZeRO-3)."""
        cfg = self.cfg
        m = self.rules.model_axis          # None = pure-FSDP (no TP)
        fsdp = self.rules.enabled if fsdp is None else fsdp
        d = self.rules.fsdp_dim if fsdp else None
        kv = P(None, d, m) if self.kv_shardable else P(None, d, None)
        kvb = P(None, m) if self.kv_shardable else P(None, None)
        if cfg.block == "rwkv":
            lay = {"ln1": P(None, None), "ln2": P(None, None),
                   "rwkv": {
                       "att": {"mu": P(None, None, None),
                               "wr": P(None, d, m), "wk": P(None, d, m),
                               "wv": P(None, d, m), "wg": P(None, d, m),
                               "ww": P(None, d, m),
                               "w_bias": P(None, None),
                               "u": P(None, m, None),
                               "wo": P(None, m, d)},
                       "ffn": {"mu": P(None, None, None),
                               "wk": P(None, d, m),
                               "wv": P(None, m, d),
                               "wr": P(None, d, None)}}}
        else:
            lay = {"ln1": P(None, None), "ln2": P(None, None),
                   "wq": P(None, d, m), "wk": kv, "wv": kv,
                   "wo": P(None, m, d)}
            if cfg.qkv_bias:
                lay.update({"bq": P(None, m), "bk": kvb, "bv": kvb})
            if cfg.block == "hybrid":
                lay["ssm"] = {"in_proj": P(None, d, m),
                              "conv": P(None, None, m),
                              "wdt": P(None, m),
                              "wB": P(None, m, None), "wC": P(None, m, None),
                              "logA": P(None, m, None),
                              "out_proj": P(None, m, d),
                              "dskip": P(None, m)}
            if cfg.moe:
                lay["moe"] = {"router": P(None, None, None),
                              "wg": P(None, m, d, None),
                              "wu": P(None, m, d, None),
                              "wo": P(None, m, None, d)}
            else:
                mlp = {"wu": P(None, d, m), "wo": P(None, m, d)}
                if cfg.act == "swiglu":
                    mlp["wg"] = P(None, d, m)
                lay["mlp"] = mlp
        specs = {"embed": P(m, d), "final_norm": P(None), "layers": lay}
        if not cfg.tie_embeddings:
            specs["lm_head"] = P(d, m)
        return specs

    def cache_specs(self, rules: ShardingRules | None = None) -> dict:
        """PartitionSpecs for the cache tree: KV heads over the model axis
        where they divide, else the cache's sequence."""
        r = rules or self.rules
        cfg = self.cfg
        kv = (r.spec(None, "batch", None, "model", None) if self.kv_shardable
              else r.spec(None, "batch", "model", None, None))
        c = {}
        if cfg.block in ("attn", "hybrid"):
            c["k"] = kv
            c["v"] = kv
        if cfg.block == "hybrid":
            c["ssm_state"] = r.spec(None, "batch", "model", None)
            c["conv"] = r.spec(None, "batch", None, "model")
        if cfg.block == "rwkv":
            c["wkv"] = r.spec(None, "batch", "model", None, None)
            c["sx_att"] = r.spec(None, "batch", None)
            c["sx_ffn"] = r.spec(None, "batch", None)
        return {"layers": c, "pos": P()}

    def check_mesh(self, mesh) -> None:
        """Raise ``ValueError`` where this model cannot run on ``mesh``
        under its rules: experts that do not split evenly over the model
        axis, or a query head whose KV head another model rank holds."""
        _, n_model, _ = model_coords(self.rules, mesh)
        self._check_experts(n_model)
        if self.kv_map is not None:
            for c in range(n_model):
                self._rank_heads(c, n_model, True, self.kv_shardable)

    def _check_experts(self, n_model: int) -> None:
        moe = self.cfg.moe
        if moe and moe.n_experts % n_model:
            raise ValueError(
                f"{self.cfg.name} at tp={self.cfg.tp}: {moe.n_experts} "
                f"experts do not split evenly over a model axis of "
                f"{n_model} ranks")

    def shard_params(self, params: dict, mesh) -> dict:
        """``params`` (the same values on every rank) as DTensors on
        ``mesh`` placed by ``param_specs``."""
        if not self.rules.enabled:
            raise ValueError("shard_params needs enabled sharding rules")
        self.check_mesh(mesh)
        return distribute_tree(params, self.param_specs(), mesh)

    # ---- sharding helpers ----------------------------------------------------

    def _local(self, fn, out_specs, in_specs, *args, gathers=()):
        return local_apply(self.rules, fn, out_specs, in_specs, *args,
                           gathers=gathers)

    def _mesh(self, params):
        return self._mesh_of(params["final_norm"])

    def _mesh_of(self, t):
        return t.device_mesh if self.rules.enabled else None

    def _input(self, t, mesh, *logical):
        """A model input under the rules: a plain tensor (the global
        batch, the same on every rank) distributed by ``logical``; a
        DTensor pinned to it."""
        if t is None or not self.rules.enabled:
            return t
        if isinstance(t, DTensor):
            return self.rules.constrain(t, *logical)
        return dtensor.distribute_tensor(
            t.to(self.device), mesh, self.rules.placements(mesh, *logical))

    def _zeros(self, mesh, shape, dtype, *logical):
        if not self.rules.enabled:
            return torch.zeros(shape, dtype=dtype, device=self.device)
        return dtensor.zeros(shape, dtype=dtype, device_mesh=mesh,
                             placements=self.rules.placements(mesh, *logical))

    def _store(self, dst, src) -> None:
        """``dst.copy_(src)``, ``src`` first placed as ``dst`` is."""
        if isinstance(dst, DTensor) and tuple(src.placements) != tuple(
                dst.placements):
            src = src.redistribute(dst.device_mesh, dst.placements)
        dst.copy_(src)

    def _local_heads(self, mesh, q_split: bool, kv_split: bool):
        """This rank's query heads and the map of each to a KV head of
        its local KV tensor (``_rank_heads``)."""
        c, n, _ = model_coords(self.rules, mesh)
        return self._rank_heads(c, n, q_split, kv_split)

    def _rank_heads(self, c: int, n: int, q_split: bool, kv_split: bool):
        """Model rank ``c`` of ``n``'s query heads ``[q0, q0 + nq)`` and
        the map of each to a KV head of its local KV tensor; ``ValueError``
        where a head's KV head lies on another rank (a padded head, which
        reads KV head 0, past the first rank's KV heads)."""
        Hq, Hkv = self.cfg.n_heads_padded, self.cfg.n_kv_heads
        q0 = shard_start(Hq, n, c) if q_split else 0
        nq = (shard_start(Hq, n, c + 1) - q0) if q_split else Hq
        k0 = shard_start(Hkv, n, c) if kv_split else 0
        nk = (shard_start(Hkv, n, c + 1) - k0) if kv_split else Hkv
        heads = self.kv_map[q0:q0 + nq] - k0
        bad = np.flatnonzero((heads < 0) | (heads >= nk))
        if bad.size:
            h = q0 + int(bad[0])
            raise ValueError(
                f"{self.cfg.name} at tp={self.cfg.tp}: query head {h} on "
                f"model rank {c} of {n} reads KV head {self.kv_map[h]}, "
                f"which that rank does not hold (it holds KV heads "
                f"[{k0}, {k0 + nk}))")
        return heads

    # ---- sublayers -------------------------------------------------------------

    def _attend(self, q, k, v, heads: np.ndarray):
        """q (B, S, nq, hd) local query heads; k, v (B, S, nk, hd) local
        KV heads; ``heads[h]`` the KV head of query head h.  Where it is
        ``h // G`` K2 reads the KV heads as they are; elsewhere they are
        expanded through ``heads`` first (one query head a KV head)."""
        k, v = L.expand_kv(k, v, heads)
        return L.flash_attention(q, k, v, causal=True,
                                 window=self.cfg.sliding_window,
                                 q_chunk=self.q_chunk, kv_chunk=self.kv_chunk)

    def _attn(self, lp, h, positions, cache=None, pos=None):
        cfg, rules = self.cfg, self.rules
        B, Sq, _ = h.shape
        hd, Hq, Hkv = cfg.head_dim, cfg.n_heads_padded, cfg.n_kv_heads
        q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        kv_ax = "model" if self.kv_shardable else None
        # k and v placed as their weights before the head split: DTensor
        # may leave a projection split over the model axis where the KV
        # heads do not divide over it, which the reshape cannot unflatten
        k = rules.constrain(k, "batch", None, kv_ax)
        v = rules.constrain(v, "batch", None, kv_ax)
        q = q.reshape(B, Sq, Hq, hd)
        k = k.reshape(B, Sq, Hkv, hd)
        v = v.reshape(B, Sq, Hkv, hd)
        mesh = q.device_mesh if rules.enabled else None
        q_spec = ("batch", None, "model", None)
        kv_spec = ("batch", None, kv_ax, None)
        q = rules.constrain(q, *q_spec)
        theta = cfg.rope_theta

        if cache is None or Sq > 1:                     # forward / prefill
            heads = self._local_heads(mesh, True, self.kv_shardable)
            T0 = self._cache_t0(mesh, cache)

            def attend(q, k, v, kc, vc):
                q = L.apply_rope(q, positions, theta)
                k = L.apply_rope(k, positions, theta)
                if kc is not None:
                    _write(kc, k, 0, T0)
                    _write(vc, v, 0, T0)
                return (self._attend(q, k, v, heads),)

            c_spec = None if cache is None else self._kv_cache_spec()
            (out,) = self._local(attend, (q_spec,),
                                 (q_spec, kv_spec, kv_spec, c_spec, c_spec),
                                 q, k, v, *((None, None) if cache is None
                                            else (cache["k"], cache["v"])))
        else:                                           # single-token decode
            out = self._decode_attn(mesh, q, k, v, cache, positions, pos)
        out = rules.constrain(out.reshape(B, Sq, Hq * hd), "batch", None,
                              "model")
        return out @ lp["wo"]

    def _kv_cache_spec(self):
        return ("batch", None, "model", None) if self.kv_shardable else (
            "batch", "model", None, None)

    def _cache_t0(self, mesh, cache):
        """Where this rank's slice of a sequence-split cache starts."""
        if cache is None or self.kv_shardable:
            return 0
        c, n, _ = model_coords(self.rules, mesh)
        return shard_start(cache["k"].shape[1], n, c)

    def _decode_attn(self, mesh, q, k, v, cache, positions, pos):
        """One token against the cache, every query head through
        ``kv_map``.  With the KV heads split, each rank attends its own
        heads; with the cache split along its sequence, each rank scores
        every query head against its slice of the keys, and the running
        max and the softmax's two sums are all-reduced over the model
        axis (``layers.decode_attention_partial``)."""
        cfg, rules = self.cfg, self.rules
        T = cache["k"].shape[1]
        idx = pos % T                                   # circular buffer
        # the reference masks by n_valid only: with capacity > window
        # decode attends past the sliding window (ROADMAP, LM module)
        n_valid = min(pos + 1, T)
        theta = cfg.rope_theta
        heads_ax = "model" if self.kv_shardable else None
        heads = self._local_heads(mesh, self.kv_shardable, self.kv_shardable)
        t0 = self._cache_t0(mesh, cache)
        _, n, group = model_coords(rules, mesh)
        # a sequence-split cache over more than one rank: the softmax's
        # max and sums all-reduced
        reduce_group = group if n > 1 and not self.kv_shardable else None
        c_spec = self._kv_cache_spec()

        def attend(q, k, v, kc, vc):
            q = L.apply_rope(q, positions, theta)
            k = L.apply_rope(k, positions, theta)
            _write(kc, k, idx, t0)
            _write(vc, v, idx, t0)
            valid = (t0 + torch.arange(kc.shape[1], device=kc.device)
                     ) < n_valid
            return (L.decode_attention_partial(
                q, kc, vc, valid[None, :].expand(q.shape[0], -1), heads,
                group=reduce_group),)

        spec = ("batch", None, heads_ax, None)
        (out,) = self._local(attend, (spec,), (spec, spec, spec, c_spec,
                                               c_spec),
                             q, k, v, cache["k"], cache["v"])
        return out

    def _ffn(self, lp, h):
        """The MLP, or on MoE layers the routed experts; returns (y, the
        load-balance loss, 0.0 without experts).

        The experts split over the model axis' ``m`` ranks (``param_specs``)
        and each sequence into the reference's ``n`` blocks (``tp`` where
        the sequence divides, else 1), counted on the whole sequence, as
        ``moe_apply`` routes on one device.  Where the blocks split over
        the ranks (``n % m == 0``), each rank routes its own slice of the
        sequence and an all-to-all over the model group carries its rows
        to the experts and back; otherwise (over two or more ranks: a
        decode step, a prompt that ``tp`` does not divide) every rank
        routes the whole block, runs its own experts' slice of the grid
        and gathers the others' outputs (``layers.moe_experts``).  Either
        way each token's rows are combined on the rank that routed them
        in one-device slot order, so a one-rank mesh gives
        ``NO_SHARDING``'s bits.  The load-balance
        loss is over every token: each rank's two factors of it
        (``layers.moe_balance_terms``), weighted by its share of the
        tokens, are summed over the axes that split the tokens before the
        product.  With the rules off this is ``moe_apply``'s computation,
        with no group and no exchange."""
        cfg = self.cfg
        if not cfg.moe:
            return L.mlp_apply(lp["mlp"], h, cfg.act), 0.0
        moe = cfg.moe
        B, S, _ = h.shape
        n = cfg.tp if S % cfg.tp == 0 else 1       # blocks of the sequence
        _, n_model, group = model_coords(self.rules, self._mesh_of(h))
        self._check_experts(n_model)
        split = n % n_model == 0            # the blocks split over ranks

        def experts(x, router, wg, wu, wo):
            r = L.moe_route(x, router, n_experts=moe.n_experts,
                            top_k=moe.top_k,
                            capacity_factor=moe.capacity_factor,
                            seq_chunks=n // n_model if split else n)
            y = L.moe_experts({"wg": wg, "wu": wu, "wo": wo}, x, r,
                              act=cfg.act, group=group,
                              replicated=not split)
            T = x.shape[0] * x.shape[1]
            frac, prob = L.moe_balance_terms(
                r.probs.reshape(T, moe.n_experts),
                r.top_e.reshape(T, moe.top_k), moe.n_experts)
            share = T / (B * S)             # this rank's share of the tokens
            return y, frac * share, prob * share

        x_spec = ("batch", "model", None) if split else ("batch", None, None)
        terms = Summed((None,), over=("batch", "model") if split
                       else ("batch",))
        leaves = [lp["moe"][k] for k in ("router", "wg", "wu", "wo")]
        y, frac, prob = self._local(
            experts, (x_spec, terms, terms),
            (x_spec, (None, None), *[("model", None, None)] * 3),
            h, *leaves, gathers=() if split else ("model",))
        frac = self.rules.constrain(frac, None)
        prob = self.rules.constrain(prob, None)
        return y, moe.n_experts * (frac * prob).sum()

    def _layer(self, lp, x, positions, cache=None, pos=None):
        """One block. Returns (x, aux); the layer's cache, when given, is
        updated in place."""
        cfg = self.cfg
        if cfg.block == "rwkv":
            return self._rwkv_layer(lp, x, cache), 0.0
        h = self._normed(x, lp["ln1"])
        mix = self._attn(lp, h, positions, cache=cache, pos=pos)
        if cfg.block == "hybrid":        # the SSM heads on the same input
            st = (None, None) if cache is None else (cache["ssm_state"],
                                                      cache["conv"])
            y, (state, conv) = SSM.ssm_apply(lp["ssm"], h, state=st[0],
                                             conv_carry=st[1],
                                             scan=self._ssm_scan)
            mix = mix + y
            if cache is not None:
                self._store(cache["ssm_state"], state)
                self._store(cache["conv"], conv)
        # the (partial-sum) sublayer output pinned to the stream's spec
        # before the residual add, as the reference does
        x = x + self._constrain_stream(mix)
        y, aux = self._ffn(lp, self._normed(x, lp["ln2"]))
        return self._constrain_stream(x + self._constrain_stream(y)), aux

    def _ssm_scan(self, x, dt, Bc, Cc, A, h0):
        """K3 on this rank's SSM channels."""
        ch = ("batch", None, "model")
        rep = ("batch", None, None)
        st = ("batch", "model", None)
        return self._local(scan_ops.selective_scan, (ch, st),
                           (ch, ch, rep, rep, ("model", None), st),
                           x, dt, Bc, Cc, A, h0)

    def _wkv_scan(self, r, k, v, w, u, s0):
        """K4 on this rank's RWKV heads."""
        hs = ("batch", None, "model", None)
        st = ("batch", "model", None, None)
        return self._local(wkv_ops.wkv6, (hs, st),
                           (hs, hs, hs, hs, ("model", None), st),
                           r, k, v, w, u, s0)

    def _rwkv_layer(self, lp, x, cache=None):
        """RWKV-6: time mixing, then channel mixing, each on its own normed
        input and token-shift row."""
        cfg = self.cfg
        B, d = x.shape[0], cfg.d_model
        H, hd = d // SSM.RWKV_HEAD_DIM, SSM.RWKV_HEAD_DIM
        if cache is None:
            mesh = x.device_mesh if self.rules.enabled else None
            sx0 = sx1 = self._zeros(mesh, (B, d), x.dtype, "batch", None)
            st0 = self._zeros(mesh, (B, H, hd, hd), torch.float32,
                              "batch", "model", None, None)
        else:
            sx0, sx1, st0 = cache["sx_att"], cache["sx_ffn"], cache["wkv"]
        h = self._normed(x, lp["ln1"])
        y, sx_att, wkv = SSM.rwkv_time_mix(lp["rwkv"]["att"], h, sx0, st0,
                                           scan=self._wkv_scan)
        x = x + self._constrain_stream(y)
        h = self._normed(x, lp["ln2"])
        y, sx_ffn = SSM.rwkv_channel_mix(lp["rwkv"]["ffn"], h, sx1)
        if cache is not None:
            self._store(cache["wkv"], wkv)
            self._store(cache["sx_att"], sx_att)
            self._store(cache["sx_ffn"], sx_ffn)
        return self._constrain_stream(x + self._constrain_stream(y))

    def _normed(self, x, weight):
        """A sublayer's input: the stream normed, and gathered along the
        sequence where the stream is split over it (Megatron-SP's
        all-gather before the column-parallel matmuls)."""
        h = L.rms_norm(x, weight, self.cfg.norm_eps)
        return self.rules.constrain(h, "batch", None, None)

    def _constrain_stream(self, x):
        """Residual stream: sequence-parallel over the model axis when the
        sequence divides (Megatron-SP), else batch-split only."""
        if x.shape[1] > 1 and x.shape[1] % self.cfg.tp == 0:
            return self.rules.constrain(x, "batch", "model", None)
        return self.rules.constrain(x, "batch", None, None)

    def _layers(self, params, x, positions, cache=None, pos=None):
        """The layer stack. Returns (x, the mean of the layers' aux)."""
        auxs = []
        for i in range(self.cfg.n_layers):
            lp = map_params(lambda t: t[i], params["layers"])
            if cache is None and self.remat and torch.is_grad_enabled():
                x, aux = checkpoint(self._layer, lp, x, positions,
                                    use_reentrant=False)
            else:
                cl = None if cache is None else map_params(
                    lambda t: t[i], cache["layers"])
                x, aux = self._layer(lp, x, positions, cache=cl, pos=pos)
            auxs.append(aux)
        return x, (torch.stack(auxs).mean() if self.cfg.moe else 0.0)

    # ---- embeddings / logits ----------------------------------------------------

    def _embed(self, params, tokens, embeds):
        """``[embeds (cast to the model's dtype), token embeddings]``
        along the sequence; either may be None.  Under the rules while
        autograd records the lookup is the reference's one-hot matmul,
        whose backward stays vocab-sharded; otherwise a gather
        (``_gather_rows`` under the rules)."""
        mesh = self._mesh(params)
        xs = []
        if embeds is not None:
            xs.append(self._input(embeds, mesh, "batch", None, None).to(
                self.dtype))
        if tokens is not None:
            tokens = self._input(tokens, mesh, "batch", None).long()
            table = params["embed"]
            if not self.rules.enabled:
                xs.append(table[tokens])
            elif torch.is_grad_enabled():
                xs.append(self._one_hot(tokens, table.shape[0]) @ table)
            else:
                xs.append(self._gather_rows(mesh, table, tokens))
        x = torch.cat(xs, dim=1) if len(xs) > 1 else xs[0]
        return self._constrain_stream(x)

    def _one_hot(self, tokens, vocab: int):
        """``(B, S, vocab)`` one-hot of the tokens, built in the model's
        dtype on each rank's batch shard (the reference's
        ``jax.nn.one_hot(..., dtype=self.dtype)``): ones scattered into
        zeros, exact in bf16, with no int64 ``(B, S, vocab)`` tensor."""
        def one_hot(tok):
            out = torch.zeros((*tok.shape, vocab), dtype=self.dtype,
                              device=tok.device)
            return (out.scatter_(-1, tok[..., None], 1),)

        (x,) = self._local(one_hot, (("batch", None, None),),
                           (("batch", None),), tokens)
        return x

    def _gather_rows(self, mesh, table, tokens):
        """``table[tokens]`` from a table split over the vocab: each rank
        reads the rows its shard holds (zeros elsewhere), a partial sum
        over the model axis that DTensor adds when the stream is pinned
        (DTensor's own embedding rule fails on a batch split over another
        mesh dim)."""
        c, n, _ = model_coords(self.rules, mesh)
        v0 = shard_start(table.shape[0], n, c)

        def rows(tab, tok):
            tok = tok - v0
            here = (tok >= 0) & (tok < tab.shape[0])
            out = tab[tok.clamp(0, tab.shape[0] - 1)]
            return (torch.where(here[..., None], out, 0),)

        (x,) = self._local(rows, (Summed(("batch", None, None)),),
                           (("model", None), ("batch", None)), table, tokens)
        return x

    def _head(self, params):
        """(D, Vp): ``embed.T`` with tied embeddings, else ``lm_head``."""
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])

    def _logits(self, params, x):
        x = L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self.rules.constrain(x @ self._head(params), "batch", None,
                                    "model")

    # ---- entry points -------------------------------------------------------------

    def _backbone(self, params, tokens=None, embeds=None):
        """Embed + layer stack + final norm. Returns (x (B, S, D), aux)."""
        x = self._embed(params, tokens, embeds)
        positions = torch.arange(x.shape[1], device=self.device)[None, :]
        x, aux = self._layers(params, x, positions)
        return L.rms_norm(x, params["final_norm"], self.cfg.norm_eps), aux

    def forward(self, params: dict, tokens: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None):
        """Train/eval forward (differentiable). Returns (logits (B, S,
        Vp) over the frames and the tokens, moe aux loss: the layers'
        mean, a float32 scalar; 0.0 without experts)."""
        x, aux = self._backbone(params, tokens, embeds)
        x = self.rules.constrain(x, "batch", None, None)
        return self.rules.constrain(x @ self._head(params), "batch", None,
                                    "model"), aux

    def forward_loss(self, params: dict, tokens: torch.Tensor | None,
                     labels: torch.Tensor,
                     loss_mask: torch.Tensor | None = None,
                     embeds: torch.Tensor | None = None,
                     loss_chunk: int = 512):
        """Fused chunked cross-entropy: never materializes (B, S, Vp)
        logits.  The head matmul and the CE run one sequence chunk at a
        time under ``torch.utils.checkpoint``, so the backward recomputes
        each chunk's logits instead of saving them.  ``labels`` and
        ``loss_mask`` span the whole stream, frames included.  Under the
        rules a chunk's logits stay split over the vocab
        (``_vocab_nll``).  Returns (mean masked NLL, moe aux loss as
        ``forward``'s)."""
        x, aux = self._backbone(params, tokens, embeds)
        mesh = self._mesh(params)
        head = self._head(params)
        S = x.shape[1]
        c = min(loss_chunk, S)
        if S % c:
            raise ValueError(f"sequence {S} is not a multiple of the loss "
                             f"chunk {c}")
        x = self.rules.constrain(x, "batch", None, None)
        labels = self._input(labels, mesh, "batch", None)
        if loss_mask is None:
            loss_mask = torch.ones(labels.shape, dtype=torch.float32,
                                   device=self.device)
        loss_mask = self._input(loss_mask, mesh, "batch", None)

        def body(xc, lc, mc):
            if not self.rules.enabled:
                return _chunk_ce(xc @ head, lc, mc, self.cfg.vocab)
            logits = self.rules.constrain(xc @ head, "batch", None, "model")
            mc = mc.float()
            return (self._vocab_nll(mesh, logits, lc) * mc).sum(), mc.sum()

        nll = msum = 0.0
        for s0 in range(0, S, c):
            part = (x[:, s0:s0 + c], labels[:, s0:s0 + c],
                    loss_mask[:, s0:s0 + c])
            n, m = (checkpoint(body, *part, use_reentrant=False)
                    if torch.is_grad_enabled() else body(*part))
            nll, msum = nll + n, msum + m
        return nll / torch.clamp(msum, min=1.0), aux

    def _vocab_nll(self, mesh, logits, labels):
        """Each position's NLL from logits split over the vocab: each rank
        takes its shard's ``torch.logsumexp`` (padding at -1e9) and its
        label's logit (0 off its shard); the shards' log-sum-exps combine
        as ``m + log(sum_r exp(lse_r - m))``, ``m`` their largest
        (all-reduced, MAX, over the model axis) and the sum a partial sum
        that DTensor adds, as is the label's logit.  On one rank this is
        ``torch.logsumexp`` to the bit (``exp(0)`` is 1, ``log(1)`` 0)."""
        c, n, group = model_coords(self.rules, mesh)
        v0 = shard_start(self.cfg.vocab_padded, n, c)
        vocab = self.cfg.vocab

        def part(lg, lab):
            lg = lg.float()
            col = v0 + torch.arange(lg.shape[-1], device=lg.device)
            lg = torch.where(col < vocab, lg, -1e9)
            lse = torch.logsumexp(lg, dim=-1)
            m = lse.detach().clone()
            if group is not None:
                dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
            lab = lab.long() - v0
            here = (lab >= 0) & (lab < lg.shape[-1])
            ll = torch.gather(lg, -1, lab.clamp(0, lg.shape[-1] - 1)[
                ..., None])[..., 0]
            return m, torch.exp(lse - m), torch.where(here, ll, 0.0)

        row = ("batch", None)
        m, s, ll = self._local(part, (row, Summed(row), Summed(row)),
                               (("batch", None, "model"), row),
                               logits, labels)
        return torch.log(s) + m - ll

    def init_cache(self, batch: int, capacity: int, mesh=None) -> dict:
        """Zeros: the KV cache (attention blocks), the SSM's float32 state
        and conv carry (hybrid), or RWKV's float32 WKV state and its two
        token-shift rows (rwkv), each stacked over the layers; under the
        rules DTensors on ``mesh`` placed by ``cache_specs``."""
        cfg, n = self.cfg, self.cfg.n_layers
        specs = self.cache_specs()["layers"]

        def zeros(name, *shape, dtype=self.dtype):
            shape = (n, batch, *shape)
            if not self.rules.enabled:
                return torch.zeros(shape, dtype=dtype, device=self.device)
            return dtensor.zeros(shape, dtype=dtype, device_mesh=mesh,
                                 placements=placements(mesh, specs[name]))

        c = {}
        if cfg.block in ("attn", "hybrid"):
            c["k"] = zeros("k", capacity, cfg.n_kv_heads, cfg.head_dim)
            c["v"] = zeros("v", capacity, cfg.n_kv_heads, cfg.head_dim)
        if cfg.block == "hybrid":
            di = cfg.ssm.expand * cfg.d_model
            c["ssm_state"] = zeros("ssm_state", di, cfg.ssm.state_dim,
                                   dtype=torch.float32)
            c["conv"] = zeros("conv", cfg.ssm.conv_width - 1, di)
        if cfg.block == "rwkv":
            H, hd = cfg.d_model // SSM.RWKV_HEAD_DIM, SSM.RWKV_HEAD_DIM
            c["wkv"] = zeros("wkv", H, hd, hd, dtype=torch.float32)
            c["sx_att"] = zeros("sx_att", cfg.d_model)
            c["sx_ffn"] = zeros("sx_ffn", cfg.d_model)
        return {"layers": c, "pos": 0}

    @torch.no_grad()
    def prefill(self, params: dict, tokens: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None,
                capacity: int | None = None):
        """Forward pass that also populates the cache. Returns (logits of
        the last position (B, 1, Vp), cache); the prompt is the frames
        and the tokens, so the capacity and ``pos`` count both."""
        x = self._embed(params, tokens, embeds)
        B, Sq = x.shape[0], x.shape[1]
        capacity = capacity or Sq
        if capacity < Sq:
            raise ValueError(f"cache capacity {capacity} < prompt {Sq}")
        cache = self.init_cache(B, capacity, self._mesh(params))
        positions = torch.arange(Sq, device=self.device)[None, :]
        x, _ = self._layers(params, x, positions, cache=cache, pos=0)
        cache["pos"] = Sq
        x = self.rules.constrain(x, "batch", None, None)
        return self._logits(params, x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """One decode step. tokens: (B, 1). Returns (logits (B, 1, Vp),
        cache), the cache's tensors updated in place."""
        x = self._embed(params, tokens, None)
        pos = int(cache["pos"])
        # (1, 1): broadcast over each rank's own share of the batch
        positions = torch.full((1, 1), pos, device=self.device)
        x, _ = self._layers(params, x, positions, cache=cache, pos=pos)
        return self._logits(params, x), {"layers": cache["layers"],
                                         "pos": pos + 1}


def _write(cache: torch.Tensor, new: torch.Tensor, at: int, t0: int) -> None:
    """Write ``new`` (B, S, H, hd), positions ``at..at+S``, into the
    slice of a cache that holds positions ``t0..t0 + len`` (the whole
    cache where ``t0`` is 0 and the cache is not split)."""
    lo, hi = max(at, t0), min(at + new.shape[1], t0 + cache.shape[1])
    if lo < hi:
        cache[:, lo - t0:hi - t0] = new[:, lo - at:hi - at]


# ---- loss -------------------------------------------------------------------

def _live_logits(logits: torch.Tensor, vocab: int | None) -> torch.Tensor:
    """float32 logits with the vocab padding at -1e9."""
    logits = logits.float()
    if vocab is not None and vocab < logits.shape[-1]:
        live = torch.arange(logits.shape[-1], device=logits.device) < vocab
        logits = torch.where(live, logits, -1e9)
    return logits


def _nll(logits, labels, vocab):
    logits = _live_logits(logits, vocab)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - ll


def _chunk_ce(logits, labels, mask, vocab: int | None):
    """Summed masked CE over one chunk. Returns (sum_nll, sum_mask)."""
    mask = mask.float()
    return (_nll(logits, labels, vocab) * mask).sum(), mask.sum()


def lm_loss(logits, labels, mask=None, vocab: int | None = None):
    """Mean next-token cross-entropy. logits: (B, S, Vp), labels: (B, S)."""
    nll = _nll(logits, labels, vocab)
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


# ---- parameter trees --------------------------------------------------------

def map_params(fn, tree: dict) -> dict:
    """``fn`` applied to every leaf of a parameter (or cache) tree."""
    return {k: map_params(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def tree_leaves(tree: dict) -> list:
    """The leaves in the reference's pytree order (dict keys sorted)."""
    return [x for k in sorted(tree) for x in (
        tree_leaves(tree[k]) if isinstance(tree[k], dict) else (tree[k],))]


def tree_unflatten(tree: dict, leaves) -> dict:
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}
    return build(tree)


# ---- weights from and to the JAX package ------------------------------------------

def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":           # ml_dtypes: carry the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                      # only where JAX's dtypes are
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree: dict, device: str | torch.device = "cpu") -> dict:
    """The port's parameters from a JAX ``LM`` parameter pytree (leaves as
    numpy arrays), bit for bit, in the same layout and dtypes."""
    return map_params(lambda a: _leaf_to_torch(a, device), tree)


def params_to_jax(params: dict) -> dict:
    """The JAX parameter pytree (numpy leaves) of the port's parameters;
    inverse of ``params_from_jax``."""
    return map_params(_leaf_to_numpy, params)
