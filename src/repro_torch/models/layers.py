"""Core transformer layers: RMSNorm, RoPE, attention (GQA + sliding
window) and the SwiGLU/GELU MLP.

The counterpart of ``repro/models/layers.py``, with its casts: float32
inside rms_norm, rope and the activations, then back to the stream dtype.
Prefill attention goes to the flash attention op (K2 on the card, its
plain version on the CPU) with KV heads unexpanded; decode attends a KV
cache with position masking.  ``moe_apply`` waits for the MoE slice.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


# ---- rotary embeddings --------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: str | torch.device | None = None) -> torch.Tensor:
    """(head_dim / 2,) float32 frequencies, computed in float64 on
    ``device`` as the reference computes them in numpy (no host-to-device
    copy, which would synchronise the stream on every call)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float64,
                            device=device) / head_dim
    return (1.0 / theta ** exponent).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), positions: broadcastable to (..., S); split
    halves (not interleaved)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * freqs                  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---- attention ------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd), KV heads unexpanded ->
    (B, S, Hq, hd).  At ``tp = 1`` query head h reads KV head h // G,
    which is the reference's ``kv_map`` expansion."""
    return flash_ops.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     valid_mask: torch.Tensor) -> torch.Tensor:
    """Single-token attention over a cache.

    q: (B, 1, Hq, hd); caches: (B, T, Hkv, hd); valid_mask: (B, T) bool.
    """
    B, _, Hq, hd = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    scale = 1.0 / np.sqrt(hd)
    qr = q.reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qr.float(), k_cache.float()) * scale
    s = torch.where(valid_mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, Hq, hd).to(q.dtype)


# ---- MLP ----------------------------------------------------------------------

def mlp_apply(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        gate = x @ params["wg"]
        up = x @ params["wu"]
        h = F.silu(gate.float()).to(x.dtype) * up
    else:
        h = x @ params["wu"]
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ params["wo"]
