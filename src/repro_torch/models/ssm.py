"""State-space sequence mixers: the selective SSM of hymba's hybrid heads
and RWKV-6 "Finch" time mixing with data-dependent decay.

The counterpart of ``repro/models/ssm.py``, plain torch functions on
tensors in the reference's dtypes and rounding points: the projections
in the model's dtype; ``dt``, ``B``, ``C`` and the scans' states in
float32; the silu gates in float32, cast back.  Both mixers take and
return their recurrent state, so one function serves the full sequence
(train, prefill) and a single decode step.

Each scan over time is one op: the selective scan (K3) and the WKV scan
(K4), hand-written kernels on the card, their plain time loops on the
CPU (``kernels/selective_scan``, ``kernels/wkv6``).  Both train on the
card: where an input needs a gradient the op's forward saves the state
at every chunk's start and its backward is a hand-written kernel too
(K3-bwd, K4-bwd) that recomputes each chunk from it and walks it back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.wkv6 import ops as wkv_ops


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))`` (``F.softplus`` differs from it by ulps)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


# ---- selective SSM (Mamba-style) --------------------------------------------

def _ssm_recurrence(params: dict, x: torch.Tensor, h0: torch.Tensor,
                    scan=None):
    """x: (B, S, Di) post-conv activations; h0: (B, Di, N). -> (y, hT).
    ``scan`` is the op (``selective_scan``'s signature), by default
    ``selective_scan`` itself; a sharded model passes it on its own
    channels."""
    A = -torch.exp(params["logA"])                              # (Di, N)
    dt = softplus((x * params["wdt"]).float())
    Bc = (x @ params["wB"]).float()
    Cc = (x @ params["wC"]).float()
    return (scan or scan_ops.selective_scan)(x, dt, Bc, Cc, A, h0)


def _causal_conv(x: torch.Tensor, conv: torch.Tensor,
                 carry: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B, S, Di), conv: (W, Di), carry: (B, W-1,
    Di). Returns (out, the next carry)."""
    W = conv.shape[0]
    if carry is None:
        carry = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([carry, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * conv[i] for i in range(W))
    return out, xp[:, -(W - 1):]


def ssm_apply(params: dict, x: torch.Tensor, state: torch.Tensor | None = None,
              conv_carry: torch.Tensor | None = None, scan=None):
    """x: (B, S, D). Returns (y (B, S, D), (state, conv_carry)); ``scan``
    as ``_ssm_recurrence``'s."""
    di = params["out_proj"].shape[0]
    xi, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    xi, conv_carry = _causal_conv(xi, params["conv"], conv_carry)
    xi = F.silu(xi.float()).to(x.dtype)
    if state is None:
        state = torch.zeros((x.shape[0], di, params["wB"].shape[1]),
                            dtype=torch.float32, device=x.device)
    y, state = _ssm_recurrence(params, xi, state, scan=scan)
    y = y + xi * params["dskip"]
    y = y * F.silu(z.float()).to(x.dtype)
    return y @ params["out_proj"], (state, conv_carry)


# ---- RWKV-6 (Finch) ---------------------------------------------------------

RWKV_HEAD_DIM = 64


def _token_shift(x: torch.Tensor, sx: torch.Tensor):
    """x: (B, S, D); sx: (B, D) last token of the previous chunk ->
    (shifted x, the next sx)."""
    prev = torch.cat([sx[:, None, :], x[:, :-1]], dim=1)
    return prev, x[:, -1]


def rwkv_time_mix(p: dict, x: torch.Tensor, sx: torch.Tensor,
                  state: torch.Tensor, scan=None):
    """RWKV6 time mixing. state: (B, H, hd, hd) f32; sx: (B, D). Returns
    (y, sx', state').  ``scan`` is the op (``wkv6``'s signature), by
    default ``wkv6`` itself; a sharded model passes it on its own
    heads."""
    B, S, D = x.shape
    H, hd = D // RWKV_HEAD_DIM, RWKV_HEAD_DIM
    prev, sx_new = _token_shift(x, sx)

    def mix(i):
        return x + (prev - x) * p["mu"][i]

    r = (mix(0) @ p["wr"]).reshape(B, S, H, hd)
    k = (mix(1) @ p["wk"]).reshape(B, S, H, hd)
    v = (mix(2) @ p["wv"]).reshape(B, S, H, hd)
    # data-dependent decay (Finch): w in (0, 1) per channel per step
    wlog = (mix(3) @ p["ww"]).float()
    w = torch.exp(-torch.exp(wlog + p["w_bias"])).reshape(B, S, H, hd)
    g = F.silu((mix(4) @ p["wg"]).float())
    y, state = (scan or wkv_ops.wkv6)(r, k, v, w, p["u"], state)
    y = (y.reshape(B, S, D) * g).to(x.dtype)
    return y @ p["wo"], sx_new, state


def rwkv_channel_mix(p: dict, x: torch.Tensor, sx: torch.Tensor):
    """RWKV channel mixing (squared-ReLU key, sigmoid receptance).
    Returns (y, sx')."""
    prev, sx_new = _token_shift(x, sx)
    xk = x + (prev - x) * p["mu"][0]
    xr = x + (prev - x) * p["mu"][1]
    k = torch.square(torch.relu((xk @ p["wk"]).float())).to(x.dtype)
    kv = k @ p["wv"]
    r = torch.sigmoid((xr @ p["wr"]).float())
    return (r * kv.float()).to(x.dtype), sx_new


def rwkv_state_init(batch: int, d_model: int,
                    device: str | torch.device) -> dict:
    """Zero recurrent state of one RWKV layer: the WKV state (float32) and
    the two token-shift rows (bf16, as in the reference)."""
    H = d_model // RWKV_HEAD_DIM
    return {
        "wkv": torch.zeros((batch, H, RWKV_HEAD_DIM, RWKV_HEAD_DIM),
                           dtype=torch.float32, device=device),
        "sx_att": torch.zeros((batch, d_model), dtype=torch.bfloat16,
                              device=device),
        "sx_ffn": torch.zeros((batch, d_model), dtype=torch.bfloat16,
                              device=device),
    }
