"""Optax-style optimizers over lists of tensors, with the reference's
arithmetic (``repro/optim/optimizers.py``).

Each optimizer is a pair ``init(params) -> state`` and ``update(grads,
state, params) -> (updates, state)``; ``apply_updates`` adds updates to
the params in place.  ``params`` and ``grads`` are sequences of tensors
(``list(module.parameters())`` and the matching gradients); the moments
live on the params' device and the step count on the host, so a step
never waits for the device.

The reference's order of operations is kept, since ``torch.optim.Adam``
with ``LambdaLR`` differs from it: the step is incremented before the
learning rate is read, the schedule and the bias corrections are float32
(``1 - b ** float32(step)``), and the update is ``-lr * m_hat /
(sqrt(v_hat) + eps)``.  The learning rate may be a float or a callable
``step -> lr`` (the paper's linear decay).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence, Union

import numpy as np
import torch

Schedule = Union[float, Callable[[int], float]]


class OptState(NamedTuple):
    step: int
    inner: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Sequence[torch.Tensor]], OptState]
    update: Callable[..., tuple[list, OptState]]


def _lr_at(lr: Schedule, step: int) -> float:
    """The learning rate at ``step`` as a float32 value."""
    return float(np.float32(lr(step) if callable(lr) else lr))


def linear_decay(base_lr: float, total_steps: int) -> Callable[[int], float]:
    """``base_lr * clip(1 - step / total, 0, 1)``, in float32."""
    total = np.float32(max(total_steps, 1))

    def sched(step: int) -> float:
        frac = np.clip(np.float32(1.0) - np.float32(step) / total,
                       np.float32(0.0), np.float32(1.0))
        return float(np.float32(base_lr) * frac)
    return sched


def _zeros(params) -> list[torch.Tensor]:
    return [torch.zeros_like(p) for p in params]


def sgd(lr: Schedule, momentum: float = 0.0) -> Optimizer:
    def init(params):
        return OptState(0, _zeros(params) if momentum else None)

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state.step + 1
        lrv = _lr_at(lr, step)
        if momentum:
            mu = [momentum * m + g for m, g in zip(state.inner, grads)]
            return [-lrv * m for m in mu], OptState(step, mu)
        return [-lrv * g for g in grads], OptState(step, None)

    return Optimizer(init, update)


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return OptState(0, (_zeros(params), _zeros(params)))

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state.step + 1
        m, v = state.inner
        grads = list(grads)
        m = torch._foreach_add(torch._foreach_mul(m, b1),
                               torch._foreach_mul(grads, 1 - b1))
        v = torch._foreach_add(
            torch._foreach_mul(v, b2),
            torch._foreach_mul(torch._foreach_mul(grads, 1 - b2), grads))
        lrv = _lr_at(lr, step)
        bc1 = float(1 - np.float32(b1) ** np.float32(step))
        bc2 = float(1 - np.float32(b2) ** np.float32(step))
        upd = torch._foreach_div(
            torch._foreach_mul(torch._foreach_div(m, bc1), -lrv),
            torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_div(v, bc2)), eps))
        if weight_decay and params is not None:
            upd = torch._foreach_sub(
                upd, torch._foreach_mul(list(params), lrv * weight_decay))
        return upd, OptState(step, (m, v))

    return Optimizer(init, update)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    return adam(lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


def rowwise_adagrad(lr: Schedule, eps: float = 1e-8) -> Optimizer:
    """Row-wise Adagrad for embedding tables: one accumulator per row
    (the row-mean squared gradient over the last axis); full Adagrad for
    tensors of rank < 2."""

    def init(params):
        return OptState(0, [torch.zeros(p.shape[:-1], dtype=p.dtype,
                                        device=p.device)
                            if p.dim() >= 2 else torch.zeros_like(p)
                            for p in params])

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state.step + 1
        lrv = _lr_at(lr, step)
        acc, upd = [], []
        for a, g in zip(state.inner, grads):
            if g.dim() >= 2:
                a = a + (g * g).mean(dim=-1)
                scale = 1.0 / (torch.sqrt(a) + eps)
                upd.append(-lrv * g * scale[..., None])
            else:
                a = a + g * g
                upd.append(-lrv * g / (torch.sqrt(a) + eps))
            acc.append(a)
        return upd, OptState(step, acc)

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates) -> None:
    """``p += u`` for each param, in place (``u`` cast to ``p``'s dtype)."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))
