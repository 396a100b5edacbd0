"""Model and step constructors: the train step (loss + AdamW), prefill and
decode.

The counterpart of ``build_model``, ``make_train_step``,
``make_prefill_step`` and ``make_decode_step`` in
``repro/launch/steps.py``.  PyTorch runs eagerly, so a serve step is the
model call itself, and the train step is autograd through
``LM.forward_loss`` followed by the optimizer.  Parameters are updated in
place.

Under enabled ``ShardingRules`` the parameters are DTensors
(``LM.shard_params``): each gradient is reduced to its parameter's
placements, and AdamW runs the same ``_foreach`` ops on each rank's
local shards, its moments sharded as the parameters are (ZeRO-3 where
the rules shard the weights over the data axes).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.config import ArchConfig
from repro_torch.models.sharding import NO_SHARDING, ShardingRules
from repro_torch.models.transformer import LM, tree_leaves, tree_unflatten
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import Optimizer


def build_model(cfg: ArchConfig, rules: ShardingRules = NO_SHARDING,
                remat: bool = True, q_chunk: int = 1024,
                kv_chunk: int = 1024, dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device | None = None) -> LM:
    """An ``LM`` under ``rules`` on ``device`` (default ``cuda``; raises
    without a card)."""
    return LM(cfg, rules, dtype=dtype, device=device, remat=remat,
              q_chunk=q_chunk, kv_chunk=kv_chunk)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _replicated(t):
    """A DTensor scalar as a plain tensor (its sum reduced first)."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh,
                          [Replicate()] * t.device_mesh.ndim).to_local()


def on_local_shards(opt: Optimizer) -> Optimizer:
    """``opt`` over DTensor parameters: ``init``, ``update`` and ``apply``
    see each rank's local shards (an elementwise optimizer computes the
    same numbers shard by shard), so the state is local tensors."""
    def init(params):
        return opt.init([_local(p) for p in params])

    @torch.no_grad()
    def update(grads, state, params=None):
        return opt.update([_local(g) for g in grads], state,
                          None if params is None else
                          [_local(p) for p in params])

    @torch.no_grad()
    def apply(grads, state, params):
        return opt.apply([_local(g) for g in grads], state,
                         [_local(p) for p in params])

    return Optimizer(init, update, apply)


def make_grad_fn(model: LM, moe_aux_weight: float = 0.01,
                 n_microbatches: int = 1):
    """``(params, batch) -> (grads, loss, aux)``: the gradients (a list in
    ``tree_leaves(params)`` order, in the params' dtypes) of the batch's
    mean loss, which with experts includes ``moe_aux_weight`` x the
    load-balance loss ``aux`` (a float32 scalar; 0.0 without experts).

    With ``n_microbatches > 1`` the batch is split along its first axis
    and the gradients accumulate as in the reference: in float32 up to 4
    microbatches and in bf16 beyond (where the reference's param-sized
    float32 buffer dominates its temp memory), then divided by the count
    and cast to the params' dtypes.

    Under the rules the gradients are DTensors placed as their params,
    and the loss and ``aux`` plain tensors (the same on every rank).
    """
    cfg = model.cfg

    def one(params, batch):
        leaves = tree_leaves(params)
        # leaves of their own that share the params' storage, so the
        # caller's tensors gain no requires_grad
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, aux = model.forward_loss(
            tree_unflatten(params, live), batch.get("tokens"),
            batch["labels"], loss_mask=batch.get("loss_mask"),
            embeds=batch.get("embeds"))
        if cfg.moe:
            loss = loss + moe_aux_weight * aux
            aux = _replicated(aux.detach())
        if isinstance(loss, DTensor):
            loss = loss.redistribute(loss.device_mesh,
                                     [Replicate()] * loss.device_mesh.ndim)
        grads = torch.autograd.grad(loss, live)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if isinstance(g, DTensor) else g
                 for g, p in zip(grads, leaves)]
        return grads, _replicated(loss.detach()), aux

    def grad_fn(params, batch):
        n = n_microbatches
        if n == 1:
            return one(params, batch)
        acc_dt = torch.float32 if n <= 4 else torch.bfloat16
        acc = [torch.zeros_like(p, dtype=acc_dt)
               for p in tree_leaves(params)]
        loss = aux = 0.0
        for i in range(n):
            mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                  for k, v in batch.items()}
            g, loss_b, aux_b = one(params, mb)
            torch._foreach_add_(acc, [gi.to(acc_dt) for gi in g])
            loss, aux = loss + loss_b, aux + aux_b
        grads = [(a / n).to(p.dtype)
                 for a, p in zip(acc, tree_leaves(params))]
        return grads, loss / n, aux / n

    return grad_fn


def make_train_step(model: LM, lr: float = 3e-4, weight_decay: float = 0.1,
                    moe_aux_weight: float = 0.01, n_microbatches: int = 1):
    """Returns ``(opt, train_step)``; ``train_step(params, opt_state,
    batch) -> (params, opt_state, {"loss", "moe_aux"})``, the params
    updated in place by AdamW.  ``opt.init(tree_leaves(params))`` makes
    the state.  ``batch`` holds ``tokens`` (B, S - F) and ``labels`` (B,
    S), optionally ``loss_mask`` (B, S) and, for a frontend arch,
    ``embeds`` (B, F, D), on the model's device.

    The step holds the params, their gradients and one copy of AdamW's
    moments: ``opt.apply`` updates the moments in place and adds each
    bounded group's update to the params before it computes the next
    (``optim.adam``), so no whole update is ever allocated.  Under the
    rules ``opt`` runs on each rank's local shards (``on_local_shards``)."""
    opt = adamw(lr, weight_decay=weight_decay)
    if model.rules.enabled:
        opt = on_local_shards(opt)
    grad_fn = make_grad_fn(model, moe_aux_weight=moe_aux_weight,
                           n_microbatches=n_microbatches)

    def train_step(params, opt_state, batch):
        grads, loss, aux = grad_fn(params, batch)
        opt_state = opt.apply(grads, opt_state, tree_leaves(params))
        return params, opt_state, {"loss": loss, "moe_aux": aux}

    return opt, train_step


def make_prefill_step(model: LM, capacity: int | None = None):
    def prefill_step(params, batch):
        return model.prefill(params, batch.get("tokens"),
                             embeds=batch.get("embeds"), capacity=capacity)
    return prefill_step


def make_decode_step(model: LM):
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch["tokens"])
    return decode_step
