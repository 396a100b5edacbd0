"""Plain PyTorch versions of the RWKV-6 WKV scan (K4) and its backward.

The scan inside the reference's ``rwkv_time_mix`` (``repro/models/
ssm.py``), which is a ``lax.scan`` there, written in its order and
grouping: at each step ``kv = k^T v``, then ``y = r (s + u * kv)``, then
``s = w * s + kv``, all in float32.  It is differentiable, so the CPU
path trains through it.

``wkv6_bwd_plain`` is the backward written out as the reverse-time loop
that K4's backward kernel runs: the state at every chunk's start from the
forward (``wkv6_states_plain``), then, from the last chunk to the first,
the chunk's states recomputed from its start with the forward's own
operations and walked back (never by dividing by w, which can be tiny).
The reference differentiates its scan by autodiff; this is the same
gradient.
"""

from __future__ import annotations

import torch

CHUNK = 16          # K4's time chunk: the forward saves a state a chunk


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B, S, H, hd) in the model's dtype; w: (B, S, H, hd)
    float32; u: (H, hd); s0: (B, H, hd, hd) float32 (or all float64) ->
    (y (B, S, H, hd), sT (B, H, hd, hd)) in s0's dtype."""
    dt = s0.dtype
    s = s0
    bonus = u.to(dt)[None, :, :, None]                    # (1, H, hd, 1)
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t].to(dt)[..., :, None] * v[:, t].to(dt)[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].to(dt),
                               s + bonus * kv))
        s = w[:, t].to(dt)[..., None] * s + kv
    if not ys:
        return torch.zeros(r.shape, dtype=dt, device=r.device), s
    return torch.stack(ys, dim=1), s


def wkv6_states_plain(r, k, v, w, u, s0, chunk: int = CHUNK):
    """``wkv6_plain`` run a chunk at a time -> (y, sT, hs): hs (B, H,
    ceil(S / chunk), hd, hd) holds the state at each chunk's start
    (``hs[:, :, 0]`` is s0), as K4's forward saves it for training."""
    ys, hs, s = [], [], s0
    for c0 in range(0, r.shape[1], chunk):
        hs.append(s)
        y, s = wkv6_plain(*(t[:, c0:c0 + chunk] for t in (r, k, v, w)), u,
                          s)
        ys.append(y)
    return torch.cat(ys, dim=1), s, torch.stack(hs, dim=2)


def wkv6_bwd_plain(r, k, v, w, u, s0, dy, dsT: torch.Tensor | None = None,
                   chunk: int = CHUNK):
    """The gradients of ``wkv6_plain`` given dy (B, S, H, hd) and dsT (B,
    H, hd, hd) or None (zero) -> (dr, dk, dv in r's dtype; dw, du, ds0 in
    s0's dtype: float32, or all float64).

    With G_t = dL/ds_t (dsT at the end), i the key and j the value
    channel: G_{t-1} = w_t G_t (by rows) + r_t dy_t^T; dr_t[i] = sum_j
    dy_t[j] (s_{t-1}[i][j] + u[i] k_t[i] v_t[j]); dw_t[i] = sum_j G_t[i][j]
    s_{t-1}[i][j]; with dkv = G_t + (r_t u) dy_t^T, dk_t = dkv v_t and
    dv_t = dkv^T k_t; du[i] = sum_{b,t} r_t[i] k_t[i] (dy_t . v_t);
    ds0 = G_0."""
    f = s0.dtype
    S = r.shape[1]
    _, _, hs = wkv6_states_plain(r, k, v, w, u, s0, chunk)
    rf, kf, vf, wf, dyf = (t.to(f) for t in (r, k, v, w, dy))
    uf = u.to(f)
    dr, dk, dv, dw = (torch.empty(r.shape, dtype=f, device=r.device)
                      for _ in range(4))
    du = torch.zeros(u.shape, dtype=f, device=r.device)
    G = torch.zeros_like(s0) if dsT is None else dsT.to(f)
    for c in reversed(range(hs.shape[2])):
        t0, t1 = c * chunk, min(c * chunk + chunk, S)
        s, prev = hs[:, :, c], []
        for t in range(t0, t1):                # the forward, recomputed
            prev.append(s)
            kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
            s = wf[:, t, :, :, None] * s + kv
        for t in reversed(range(t0, t1)):      # then walked back
            sp = prev[t - t0]
            rt, kt, vt, wt, dyt = (a[:, t] for a in (rf, kf, vf, wf, dyf))
            dyv = (dyt * vt).sum(-1, keepdim=True)             # (B, H, 1)
            ruk = (rt * uf * kt).sum(-1, keepdim=True)
            dr[:, t] = torch.einsum("bhij,bhj->bhi", sp, dyt) + uf * kt * dyv
            dw[:, t] = (G * sp).sum(-1)
            dk[:, t] = torch.einsum("bhij,bhj->bhi", G, vt) + rt * uf * dyv
            dv[:, t] = torch.einsum("bhij,bhi->bhj", G, kt) + dyt * ruk
            du += (rt * kt * dyv).sum(0)
            G = wt[..., None] * G + rt[..., None] * dyt[..., None, :]
    return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du, G
