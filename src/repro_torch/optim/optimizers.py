"""Optax-style optimizers over lists of tensors, with the reference's
arithmetic (``repro/optim/optimizers.py``).

Each optimizer is a triple: ``init(params) -> state``, ``update(grads,
state, params) -> (updates, state)`` and ``apply(grads, state, params) ->
state``, which adds the step to the params in place; ``apply_updates``
adds updates to the params in place.  ``params`` and ``grads`` are sequences of tensors
(``list(module.parameters())`` and the matching gradients); the moments
live on the params' device and the step count on the host, so a step
never waits for the device.

The reference's order of operations is kept, since ``torch.optim.Adam``
with ``LambdaLR`` differs from it: the step is incremented before the
learning rate is read, the schedule and the bias corrections are float32
(``1 - b ** float32(step)``), and the update is ``-lr * m_hat /
(sqrt(v_hat) + eps)``.  The learning rate may be a float or a callable
``step -> lr`` (the paper's linear decay).

On bfloat16 params the reference's dtype rules are kept too, so the two
agree bit for bit: a Python scalar (``b1``, ``1 - b1``, ``momentum``, a
constant learning rate) is weakly typed in JAX and is rounded to the
tensor's dtype before it multiplies; a schedule's learning rate is a
float32 array and promotes the product to float32; Adam's bias-corrected
update is float32, one bounded group of leaves at a time; the update is
cast to the param's dtype once.  On float32 params these
rules change nothing.

Adam updates its moments in place, and its ``apply`` adds each bounded
group's update to the params before the next group is computed, so a
step holds one copy of the moments and never a whole update.
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
    apply: Callable[..., OptState]


def _applying(update) -> Callable[..., OptState]:
    """``apply`` as ``update`` followed by ``apply_updates``."""
    def apply(grads, state, params):
        params = list(params)
        upd, state = update(grads, state, params)
        apply_updates(params, upd)
        return state
    return apply


def _lr_at(lr: Schedule, step: int) -> tuple[float, bool]:
    """The learning rate at ``step`` as a float32 value, and whether it is
    strongly typed: a schedule's is (the reference's ``linear_decay``
    returns a float32 array), a constant's is not (``jnp.asarray(lr)`` is
    weak)."""
    return float(np.float32(lr(step) if callable(lr) else lr)), callable(lr)


def _coef(x: float, t: torch.Tensor) -> float:
    """A Python scalar as JAX applies it to ``t``: a weakly typed scalar
    takes ``t``'s dtype, so it is rounded to that dtype before it
    multiplies (bf16 rounds; float32 and float64 are what torch's own
    scalar arithmetic gives)."""
    return float(torch.tensor(x, dtype=t.dtype)) if t.dtype in (
        torch.bfloat16, torch.float16) else x


def _coefs(x: float, ts) -> list[float]:
    return [_coef(x, t) for t in ts]


def _scale(ts, lrv: float, strong: bool) -> list[torch.Tensor]:
    """``lrv * t`` for each tensor: in float32 for a strong learning rate
    (the product promotes), in ``t``'s dtype for a weak one."""
    if strong:
        return torch._foreach_mul([t.float() for t in ts], lrv)
    return torch._foreach_mul(list(ts), _coefs(lrv, ts))


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
        lrv, strong = _lr_at(lr, step)
        grads = list(grads)
        if momentum:
            mu = list(torch._foreach_add(
                torch._foreach_mul(state.inner, _coefs(momentum, grads)),
                grads))
            return _scale(mu, -lrv, strong), OptState(step, mu)
        return _scale(grads, -lrv, strong), OptState(step, None)

    return Optimizer(init, update, _applying(update))


def _groups(ts, limit: int) -> list[range]:
    """Consecutive index ranges of ``ts``, each of at most ``limit``
    elements (a larger tensor is a group of its own)."""
    out, start, n = [], 0, 0
    for i, t in enumerate(ts):
        if i > start and n + t.numel() > limit:
            out.append(range(start, i))
            start, n = i, 0
        n += t.numel()
    return out + [range(start, len(ts))] if len(ts) else out


def _pieces(ts, limit: int) -> list[list[tuple]]:
    """``_groups`` of ``ts`` as lists of pieces ``(i, lead, rows)``: leaf
    ``i`` whole (``rows`` None) or, for a leaf of more than ``limit``
    elements, a slice ``rows`` of its first ``lead`` axes flattened into
    rows, at most ``limit`` elements a piece."""
    out = []
    for idx in _groups(ts, limit):
        t = ts[idx[0]]
        if len(idx) > 1 or t.numel() <= limit:
            out.append([(i, 0, None) for i in idx])
            continue
        lead, row = 0, t.numel()
        while row > limit and lead < t.dim():
            row //= t.shape[lead]
            lead += 1
        per = max(1, limit // row)
        out += [[(idx[0], lead, slice(r, r + per))]
                for r in range(0, t.numel() // row, per)]
    return out


def _piece(t: torch.Tensor, lead: int, rows) -> torch.Tensor:
    """The piece of ``t`` that ``_pieces`` names, as a view (``view``
    raises where ``t`` has no flat layout, so an in-place write never
    lands in a copy)."""
    return t if rows is None else t.view(-1, *t.shape[lead:])[rows]


# Adam's float32 temporaries (m_hat, its denominator, the decay term) live
# for one group of leaves at a time (at most 2^26 elements; a larger leaf
# in slices of its leading axes), never as model-sized lists.  A small
# model is one group, so its launches are as before.
GROUP_ELEMS = 1 << 26


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """The moments keep the params' dtype and are updated in place (the
    state handed in is the state returned); the bias-corrected update is
    float32 (the reference's ``bc1``/``bc2`` are float32 arrays) and comes
    back cast to the params' dtype, as ``apply_updates`` would cast it.
    Every op is elementwise, so the groups (``GROUP_ELEMS``) change no
    bit.  ``update`` returns the whole update; ``apply`` adds each group's
    to the params before it computes the next, so no whole update exists."""

    def init(params):
        return OptState(0, (_zeros(params), _zeros(params)))

    @torch.no_grad()
    def run(grads, state, params, sink) -> OptState:
        """One step; ``sink(piece, update)`` takes each piece's update."""
        step = state.step + 1
        m_all, v_all = state.inner
        lrv, strong = _lr_at(lr, step)
        bc1 = float(1 - np.float32(b1) ** np.float32(step))
        bc2 = float(1 - np.float32(b2) ** np.float32(step))
        decay = None
        if weight_decay and params is not None:
            if any(p.dtype in (torch.bfloat16, torch.float16)
                   for p in params):
                # the reference's ``lrv * weight_decay`` is a float32
                # product before it is rounded to the param's dtype
                decay = float(np.float32(lrv) * np.float32(weight_decay))
            else:
                # float32 params keep the float64 product (within one
                # float32 ulp of the reference's)
                decay = lrv * weight_decay
        for group in _pieces(grads, GROUP_ELEMS):
            g = [_piece(grads[i].contiguous(), lead, rows)
                 for i, lead, rows in group]
            mg = [_piece(m_all[i], lead, rows) for i, lead, rows in group]
            vg = [_piece(v_all[i], lead, rows) for i, lead, rows in group]
            torch._foreach_mul_(mg, _coefs(b1, mg))
            torch._foreach_add_(mg, torch._foreach_mul(g, _coefs(1 - b1, g)))
            torch._foreach_mul_(vg, _coefs(b2, vg))
            torch._foreach_add_(vg, torch._foreach_mul(
                torch._foreach_mul(g, _coefs(1 - b2, g)), g))
            # fresh float32 lists, so the in-place steps below never touch
            # the moments (``.float()`` of a float32 moment is the moment)
            u = torch._foreach_div([t.float() for t in mg], bc1)
            torch._foreach_mul_(u, -lrv)
            den = torch._foreach_div([t.float() for t in vg], bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(u, den)
            del den
            if decay is not None:
                u = torch._foreach_sub(u, _scale(
                    [_piece(params[i], lead, rows)
                     for i, lead, rows in group], decay, strong))
            for piece, x, t in zip(group, u, mg):
                sink(piece, x.to(t.dtype))
        return OptState(step, (m_all, v_all))

    def update(grads, state, params=None):
        grads = list(grads)
        params = None if params is None else list(params)
        upd = [None] * len(grads)

        def keep(piece, u):
            i, lead, rows = piece
            if rows is None:
                upd[i] = u
                return
            if upd[i] is None:
                upd[i] = torch.empty(grads[i].shape, dtype=u.dtype,
                                     device=u.device)
            _piece(upd[i], lead, rows).copy_(u)
        return upd, run(grads, state, params, keep)

    def apply(grads, state, params):
        params = list(params)

        def add(piece, u):
            _piece(params[piece[0]], *piece[1:]).add_(u)
        return run(list(grads), state, params, add)

    return Optimizer(init, update, apply)


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
        lrv, strong = _lr_at(lr, step)
        acc, upd = [], []
        for a, g in zip(state.inner, grads):
            step_g = g.float() * -lrv if strong else g * _coef(-lrv, g)
            if g.dim() >= 2:
                # jnp.mean sums a low-precision tensor in float32
                a = a + (g * g).float().mean(dim=-1).to(g.dtype)
                scale = 1.0 / (torch.sqrt(a) + _coef(eps, a))
                upd.append(step_g * scale[..., None])
            else:
                a = a + g * g
                upd.append(step_g / (torch.sqrt(a) + _coef(eps, a)))
            acc.append(a)
        return upd, OptState(step, acc)

    return Optimizer(init, update, _applying(update))


@torch.no_grad()
def apply_updates(params, updates) -> None:
    """``p += u`` for each param, in place (``u`` cast to ``p``'s dtype)."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))
