"""DreamShard's cost network and policy network (paper §3.2/3.3, App. B.1/B.2).

The counterpart of ``repro/core/networks.py`` as ``nn.Module``s built from
``nn.Linear``, at the paper's widths:

Cost network f_cost:
  * shared table MLP 21-128-32 (ReLU)
  * device repr = elementwise SUM of table reprs on the device
  * three per-device heads 32-64-1: fwd-compute / bwd-compute / bwd-comm
  * overall repr = elementwise MAX over device reprs; overall head 32-64-1

Policy network pi:
  * independent shared table MLP 21-128-32
  * device repr = SUM of table reprs (incrementally maintainable)
  * cost-feature MLP 3-64-32 on q_{t,d}
  * shared scoring head 64-1 on concat(device repr, cost repr), softmax over
    devices -> works for any number of devices.

The functions mirror the reference's, with the network module in place
of the parameter pytree.  ``params_from_jax`` / ``params_to_jax``
convert to and from the reference's pytree of numpy arrays: a JAX layer
``w`` is ``(n_in, n_out)``, so ``nn.Linear.weight`` is ``w.T``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

HIDDEN = 32
NUM_COST_FEATURES = 3  # [fwd_comp, bwd_comp, bwd_comm]


# ---- generic MLP -------------------------------------------------------------

class MLP(nn.Module):
    """Linear layers with ReLU between them (none after the last)."""

    def __init__(self, sizes, generator: torch.Generator | None = None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(n_in, n_out) for n_in, n_out in zip(sizes[:-1],
                                                          sizes[1:]))
        with torch.no_grad():      # He-normal weights, zero biases
            for layer in self.layers:
                n_in = layer.in_features
                w = torch.randn((n_in, layer.out_features),
                                generator=generator) * math.sqrt(2.0 / n_in)
                layer.weight.copy_(w.T)
                layer.bias.zero_()

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


# ---- cost network ------------------------------------------------------------

class CostNet(nn.Module):

    def __init__(self, num_features: int = 21,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.table_mlp = MLP([num_features, 128, HIDDEN], generator)
        self.head_fwd = MLP([HIDDEN, 64, 1], generator)
        self.head_bwd = MLP([HIDDEN, 64, 1], generator)
        self.head_comm = MLP([HIDDEN, 64, 1], generator)
        self.head_overall = MLP([HIDDEN, 64, 1], generator)


def cost_table_reprs(net: CostNet, feats):
    """(..., M, F) -> (..., M, HIDDEN)."""
    return net.table_mlp(feats)


def cost_device_heads(net: CostNet, dev_repr):
    """Per-device cost features from device reprs: (..., D, H) -> (..., D, 3)."""
    return torch.cat([net.head_fwd(dev_repr), net.head_bwd(dev_repr),
                      net.head_comm(dev_repr)], dim=-1)


def cost_overall_head(net: CostNet, dev_repr, dev_mask=None):
    """MAX-reduce device reprs -> overall cost scalar (..., )."""
    if dev_mask is not None:
        neg = torch.finfo(dev_repr.dtype).min
        dev_repr = torch.where(dev_mask[..., None] > 0, dev_repr, neg)
    overall_repr = dev_repr.amax(dim=-2)
    return net.head_overall(overall_repr)[..., 0]


def reduce_tables(h, assign_onehot, reduction: str = "sum"):
    """Reduce table reprs (..., M, H) into device reprs (..., D, H)."""
    if reduction == "sum":
        return assign_onehot @ h
    if reduction == "mean":
        counts = assign_onehot.sum(-1, keepdim=True)
        return (assign_onehot @ h) / torch.clamp(counts, min=1.0)
    if reduction == "max":
        neg = torch.finfo(h.dtype).min
        masked = torch.where(assign_onehot[..., None] > 0,
                             h[..., None, :, :], neg)
        out = masked.amax(dim=-2)
        return torch.where(assign_onehot.sum(-1, keepdim=True) > 0, out, 0.0)
    raise ValueError(reduction)


def reduce_devices(dev, dev_mask=None, reduction: str = "max"):
    """Reduce device reprs (..., D, H) into the overall repr (..., H)."""
    if reduction == "max":
        if dev_mask is not None:
            neg = torch.finfo(dev.dtype).min
            dev = torch.where(dev_mask[..., None] > 0, dev, neg)
        return dev.amax(dim=-2)
    if dev_mask is not None:
        dev = dev * dev_mask[..., None]
    if reduction == "sum":
        return dev.sum(dim=-2)
    if reduction == "mean":
        n = (torch.clamp(dev_mask.sum(-1, keepdim=True), min=1.0)
             if dev_mask is not None else max(dev.shape[-2], 1))
        return dev.sum(dim=-2) / n
    raise ValueError(reduction)


def cost_net_apply(net: CostNet, feats, assign_onehot, table_mask=None,
                   dev_mask=None, table_reduction: str = "sum",
                   device_reduction: str = "max"):
    """Full forward pass on a (possibly padded) placement.

    feats: (..., M, F) normalized features
    assign_onehot: (..., D, M) -- row d selects tables on device d
    table_mask: (..., M) 1 for real tables; dev_mask: (..., D)
    returns (q (..., D, 3), overall (...,))
    """
    h = cost_table_reprs(net, feats)
    if table_mask is not None:
        h = h * table_mask[..., None]
    dev = reduce_tables(h, assign_onehot, table_reduction)
    q = cost_device_heads(net, dev)
    if dev_mask is not None:
        q = q * dev_mask[..., None]
    overall_repr = reduce_devices(dev, dev_mask, device_reduction)
    overall = net.head_overall(overall_repr)[..., 0]
    return q, overall


def predict_single_table_costs(net: CostNet, feats):
    """Per-table 'alone on a device' scalar cost -- used for the descending
    sort before each episode (App. B.4.2)."""
    h = cost_table_reprs(net, feats)              # (M, H)
    return cost_device_heads(net, h).sum(dim=-1)  # (M,)


# ---- policy network ----------------------------------------------------------

class PolicyNet(nn.Module):

    def __init__(self, num_features: int = 21,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.table_mlp = MLP([num_features, 128, HIDDEN], generator)
        self.cost_mlp = MLP([NUM_COST_FEATURES, 64, HIDDEN], generator)
        self.head = MLP([2 * HIDDEN, 1], generator)


def policy_table_reprs(net: PolicyNet, feats):
    return net.table_mlp(feats)


def policy_logits(net: PolicyNet, dev_repr, q, dev_mask=None):
    """(..., D, H) device sums + (..., D, 3) cost features -> (..., D) logits.

    ``dev_mask`` (..., D) marks real devices; padding devices score a large
    negative logit, so one decode padded to D_pad serves any device count.
    """
    hc = net.cost_mlp(q)
    x = torch.cat([dev_repr, hc], dim=-1)
    logits = net.head(x)[..., 0]
    if dev_mask is not None:
        logits = torch.where(dev_mask > 0, logits, -1e9)
    return logits


# ---- conversion to and from the JAX pytree -----------------------------------

def _mlp_to_jax(mlp: MLP) -> list[dict]:
    return [{"w": layer.weight.detach().cpu().numpy().T.copy(),
             "b": layer.bias.detach().cpu().numpy().copy()}
            for layer in mlp.layers]


def _mlp_from_jax(mlp: MLP, layers) -> None:
    if len(layers) != len(mlp.layers):
        raise ValueError(f"expected {len(mlp.layers)} layers, got "
                         f"{len(layers)}")
    with torch.no_grad():
        for layer, p in zip(mlp.layers, layers):
            w = torch.from_numpy(np.array(p["w"], dtype=np.float32))
            if tuple(w.shape) != (layer.in_features, layer.out_features):
                raise ValueError(f"layer shape {tuple(w.shape)} does not "
                                 "match the paper's widths")
            layer.weight.copy_(w.T)
            layer.bias.copy_(torch.from_numpy(np.array(p["b"],
                                                       dtype=np.float32)))


def params_from_jax(tree: dict) -> CostNet | PolicyNet:
    """A ``CostNet`` or ``PolicyNet`` (on the CPU) holding the weights of
    a JAX parameter pytree (``cost_net_init`` / ``policy_net_init``
    layout, leaves as numpy arrays)."""
    n_features = np.asarray(tree["table_mlp"][0]["w"]).shape[0]
    net = CostNet(n_features) if "head_overall" in tree \
        else PolicyNet(n_features)
    for name, mlp in net.named_children():
        _mlp_from_jax(mlp, tree[name])
    return net


def params_to_jax(net: CostNet | PolicyNet) -> dict:
    """The JAX parameter pytree (numpy leaves) of a network."""
    return {name: _mlp_to_jax(mlp) for name, mlp in net.named_children()}
