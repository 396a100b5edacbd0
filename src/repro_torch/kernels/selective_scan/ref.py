"""Plain PyTorch versions of the selective scan (K3) and its backward.

The recurrence of the reference's ``_ssm_recurrence``
(``repro/models/ssm.py``), which is a ``lax.scan`` there, written in its
order: at each step ``decay = exp(dt * A)``, then ``h = h * decay + (dt *
x) * B``, then ``y = sum_n h * C`` added over n from 0 upward, one add at
a time, as K3 adds it.  Everything is float32; ``y`` is rounded to x's
dtype once, at the end.  It is differentiable, so the CPU
path trains through it.

``selective_scan_bwd_plain`` is the backward written out as the
reverse-time loop that K3's backward kernel runs: the state at every
chunk's start from the forward (``selective_scan_states_plain``), then,
from the last chunk to the first, the chunk's states recomputed from its
start with the forward's own operations and walked back.  The reference
differentiates its scan by autodiff; this is the same gradient.
"""

from __future__ import annotations

import torch

CHUNK = 32          # K3's time chunk: the forward saves a state a chunk


def selective_scan_plain(x: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                         Cc: torch.Tensor, A: torch.Tensor,
                         h0: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """x: (B, S, Di) in the model's dtype; dt: (B, S, Di), Bc and Cc: (B,
    S, N), A: (Di, N) and h0: (B, Di, N), float32 (or all float64) ->
    (y (B, S, Di) in x's dtype, hT (B, Di, N))."""
    h = h0
    ys = []
    for t in range(x.shape[1]):
        dt_t = dt[:, t]                                        # (B, Di)
        decay = torch.exp(dt_t[..., None] * A)                 # (B, Di, N)
        u = dt_t * x[:, t].to(dt.dtype)
        h = h * decay + u[..., None] * Bc[:, t, None, :]
        hc = h * Cc[:, t, None, :]
        y = hc[..., 0]
        for n in range(1, hc.shape[-1]):       # n from 0 upward, as K3
            y = y + hc[..., n]
        ys.append(y)
    if not ys:
        return torch.empty_like(x), h
    return torch.stack(ys, dim=1).to(x.dtype), h


def selective_scan_states_plain(x, dt, Bc, Cc, A, h0, chunk: int = CHUNK):
    """``selective_scan_plain`` run a chunk at a time -> (y, hT, hs): hs
    (B, ceil(S / chunk), Di, N) holds the state at each chunk's start
    (``hs[:, 0]`` is h0), as K3's forward saves it for training."""
    ys, hs, h = [], [], h0
    for c0 in range(0, x.shape[1], chunk):
        hs.append(h)
        y, h = selective_scan_plain(
            *(t[:, c0:c0 + chunk] for t in (x, dt, Bc, Cc)), A, h)
        ys.append(y)
    return torch.cat(ys, dim=1), h, torch.stack(hs, dim=1)


def selective_scan_bwd_plain(x, dt, Bc, Cc, A, h0, dy,
                             dhT: torch.Tensor | None = None,
                             chunk: int = CHUNK):
    """The gradients of ``selective_scan_plain`` given dy (B, S, Di) and
    dhT (B, Di, N) or None (zero) -> (dx in x's dtype, ddt, dB, dC, dA,
    dh0), the rest in dt's dtype (float32, or all float64).

    With a_t = exp(dt_t A), u_t = dt_t x_t and g_t = dL/dh_t (from dhT at
    the end): g_t = dy_t C_t + a_{t+1} g_{t+1}; dC_t = sum_d dy_t h_t;
    dB_t = sum_d g_t u_t; du_t = sum_n g_t B_t; z_t = g_t h_{t-1} a_t;
    ddt_t = sum_n z_t A + du_t x_t; dA = sum_{b,t} z_t dt_t; dx_t = du_t
    dt_t; dh0 = a_1 g_1."""
    f = dt.dtype
    S = x.shape[1]
    _, _, hs = selective_scan_states_plain(x, dt, Bc, Cc, A, h0, chunk)
    xs, dys = x.to(f), dy.to(f)
    dx = torch.empty(x.shape, dtype=f, device=x.device)
    ddt, dB, dC = (torch.empty_like(t) for t in (dt, Bc, Cc))
    dA = torch.zeros_like(A)
    g = torch.zeros_like(h0) if dhT is None else dhT.to(f)
    for c in reversed(range(hs.shape[1])):
        t0, t1 = c * chunk, min(c * chunk + chunk, S)
        h, hist, decs = hs[:, c], [hs[:, c]], []
        for t in range(t0, t1):                # the forward, recomputed
            a = torch.exp(dt[:, t, :, None] * A)
            u = dt[:, t] * xs[:, t]
            h = h * a + u[..., None] * Bc[:, t, None, :]
            hist.append(h)
            decs.append(a)
        for t in reversed(range(t0, t1)):      # then walked back
            i = t - t0
            dy_t, u = dys[:, t], dt[:, t] * xs[:, t]
            G = dy_t[..., None] * Cc[:, t, None, :] + g
            dC[:, t] = (dy_t[..., None] * hist[i + 1]).sum(1)
            dB[:, t] = (G * u[..., None]).sum(1)
            du = (G * Bc[:, t, None, :]).sum(-1)
            z = G * hist[i] * decs[i]
            ddt[:, t] = (z * A).sum(-1) + du * xs[:, t]
            dA += (z * dt[:, t, :, None]).sum(0)
            dx[:, t] = du * dt[:, t]
            g = decs[i] * G
    return dx.to(x.dtype), ddt, dB, dC, dA, g
