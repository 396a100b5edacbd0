"""DLRM recommender model (paper App. A.1, after Naumov et al. 2019).

The counterpart of ``repro/models/dlrm.py``.  Dense features -> bottom
MLP; sparse features -> the table-wise model-parallel embedding lookup
(DreamShard-placed, ``repro_torch.embedding.sharded``) -> pairwise dot
interaction with the dense representation -> top MLP -> CTR logit.

The MLPs and the interaction are plain ``torch`` matmuls in float32 (the
reference leaves them to XLA, outside any Pallas kernel); the lookup is
K1 per shard.  Arenas are one ``nn.Parameter`` per shard, or, in the
one-rank form (``shard=m``) of the distributed step, the arena of shard
``m`` alone: a rank of a ``(data, model)`` mesh holds its model place's
arena, as the reference's ``P(model, None, None)`` arenas place one on
each device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn

from repro_torch.device import resolve_device
from repro_torch.embedding import sharded as E
from repro_torch.embedding.plan import PlacementPlan


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    n_dense_features: int = 13
    embed_dim: int = 128            # padded feature dim (plan.dim)
    bottom_mlp: tuple = (512, 256)
    top_mlp: tuple = (1024, 512, 256)
    n_tables: int = 50


def _mlp(sizes, generator, device, dtype) -> nn.ModuleList:
    """Linear layers with He-normal weights and zero biases."""
    layers = nn.ModuleList()
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        lin = nn.Linear(n_in, n_out, device=device, dtype=dtype)
        with torch.no_grad():
            lin.weight.copy_(torch.randn((n_out, n_in), generator=generator,
                                         device=device, dtype=dtype)
                             * float(np.sqrt(2.0 / n_in)))
            lin.bias.zero_()
        layers.append(lin)
    return layers


def _run_mlp(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for i, lin in enumerate(layers):
        x = lin(x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


class DLRM(nn.Module):
    """``forward(dense, gidx, lookup_fn)`` -> CTR logits (B,).

    ``arenas`` holds one arena per shard (``E.init_arenas``: row 0 zero),
    or with ``shard`` that shard's alone (drawn first, so the dense nets'
    draws differ from the whole model's); ``bottom`` and ``top`` are the
    dense nets.  Weights are drawn from ``seed`` on ``device`` (``cuda``
    unless told otherwise)."""

    def __init__(self, cfg: DLRMConfig, plan: PlacementPlan, *,
                 seed: int = 0, device=None, dtype=torch.float32,
                 shard: int | None = None):
        super().__init__()
        if plan.slot_cols is not None:
            raise ValueError(
                "DLRM takes a whole-table plan; the reference's model "
                "cannot consume column shards either")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        self.plan = plan
        self.dtype = dtype
        self.arenas = nn.ParameterList(E.init_arenas(
            plan, generator=gen, device=dev, dtype=dtype,
            shards=None if shard is None else [shard]))
        n_inter = cfg.n_tables + 1          # tables + dense rep
        inter_dim = n_inter * (n_inter - 1) // 2 + cfg.embed_dim
        self.bottom = _mlp((cfg.n_dense_features, *cfg.bottom_mlp,
                            cfg.embed_dim), gen, dev, dtype)
        self.top = _mlp((inter_dim, *cfg.top_mlp, 1), gen, dev, dtype)
        self.register_buffer("bases", torch.as_tensor(
            plan.base_rows, dtype=torch.int32, device=dev), persistent=False)
        self.register_buffer("slots", torch.as_tensor(
            E.table_slots(plan), device=dev), persistent=False)
        iu, ju = np.triu_indices(n_inter, k=1)
        self.register_buffer("triu", torch.as_tensor(iu * n_inter + ju,
                                                     device=dev),
                             persistent=False)

    def dense_parameters(self) -> list[nn.Parameter]:
        return [*self.bottom.parameters(), *self.top.parameters()]

    def _interact(self, dense_rep, sparse):
        """Pairwise dot interaction. sparse: (B, T, D); dense: (B, D)."""
        feats = torch.cat([dense_rep[:, None, :], sparse], dim=1)
        z = torch.bmm(feats, feats.transpose(1, 2))
        z = z.reshape(z.shape[0], -1).index_select(1, self.triu)
        return torch.cat([dense_rep, z], dim=-1)

    def forward(self, dense, gidx, lookup_fn):
        """dense: (B, n_dense); gidx: (B, S*K, P) (plan layout).

        lookup_fn(arenas, bases, gidx): the sharded (or unsharded)
        embedding lookup.  Returns CTR logits (B,).
        """
        sparse_all = lookup_fn(list(self.arenas), self.bases, gidx)
        # drop padded slots, keep true tables in original order
        sparse = sparse_all.index_select(1, self.slots)
        dense_rep = _run_mlp(self.bottom, dense.to(self.dtype))
        x = self._interact(dense_rep, sparse.to(self.dtype))
        return _run_mlp(self.top, x)[:, 0]

    @staticmethod
    def loss(logits, labels):
        """Binary cross-entropy with logits."""
        logits = logits.float()
        return torch.mean(torch.clamp(logits, min=0) - logits * labels
                          + torch.log1p(torch.exp(-torch.abs(logits))))


def dlrm_params_from_jax(tree: dict, plan: PlacementPlan) -> dict:
    """A ``DLRM`` state dict (CPU tensors) from the reference's parameter
    tree as numpy arrays: ``{"arenas": (S, rows_max, D), "bottom": [{"w",
    "b"}], "top": [...]}``.  Each arena is cut to its shard's rows and each
    ``w`` transposed for ``nn.Linear``."""
    arenas = np.asarray(tree["arenas"])
    out = {f"arenas.{s}": torch.tensor(arenas[s, :int(rows)])
           for s, rows in enumerate(plan.shard_rows)}
    for name in ("bottom", "top"):
        for i, layer in enumerate(tree[name]):
            out[f"{name}.{i}.weight"] = torch.tensor(
                np.ascontiguousarray(np.asarray(layer["w"]).T))
            out[f"{name}.{i}.bias"] = torch.tensor(np.asarray(layer["b"]))
    return out
